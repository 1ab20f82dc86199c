"""PEFT LoRA adapter -> 'ggla' v1 converter (a copy of
ggllm_tpu/io/convert_lora.py; convert-lora-to-ggml.py analogue).

Reads a HuggingFace PEFT directory (adapter_config.json +
adapter_model.safetensors / .bin) and writes a ggla file whose base tensor
names match the GGCC Falcon tensor names, so ``--lora`` resolves them
directly. PEFT names look like::

  base_model.model.transformer.h.7.self_attention.query_key_value.lora_A.weight

which maps to base name ``transformer.h.7.self_attention.query_key_value.weight``.
The safetensors file is read by io/safetensors.py (no `safetensors`
package; bf16 widened to f32 exactly).

A LLaMA adapter (``model.layers.N.self_attn.q_proj`` ...) is refused: its
names would need the model converter's mapping to GGJT names
(io/convert_hf_llama.py _LAYER_MAP) and its q / k loraB rows that
converter's permute_rope, which this converter does not apply. The
query_key_value loraB rows are written in HF's order, which is the GGCC
order only for a multi-query (Falcon-7B) model: a grouped-query (40B)
adapter's rows would need convert_hf.py's deinterleave_qkv.

    python -m ggllm_tpu_torch.io.convert_lora PEFT_DIR [out.ggla]
"""

from __future__ import annotations

import json
import os
import re
import sys

import numpy as np

from ggllm_tpu_torch.io import safetensors
from ggllm_tpu_torch.io.lora import write_lora

_NAME_RE = re.compile(r"^base_model\.model\.(.+)\.lora_(A|B)\.weight$")
LLAMA_REFUSAL = (
    "a LLaMA adapter (model.layers.* names) needs the GGJT tensor names of"
    " io/convert_hf_llama.py and permute_rope on its q_proj / k_proj lora_B rows; this"
    " converter maps Falcon adapters only")


def load_peft_tensors(path: str) -> dict[str, np.ndarray]:
    st = os.path.join(path, "adapter_model.safetensors")
    bin_ = os.path.join(path, "adapter_model.bin")
    if os.path.exists(st):
        return safetensors.load_file(st)
    import torch

    d = torch.load(bin_, map_location="cpu", weights_only=True)
    return {k: v.to(torch.float32).numpy() for k, v in d.items()}


def convert(path: str, out_path: str | None = None) -> str:
    with open(os.path.join(path, "adapter_config.json")) as f:
        cfg = json.load(f)
    if cfg.get("peft_type", "LORA") != "LORA":
        raise ValueError(f"unsupported adapter type {cfg.get('peft_type')}")
    r = int(cfg["r"])
    alpha = int(cfg["lora_alpha"])

    tensors: dict[str, dict[str, np.ndarray]] = {}
    for name, arr in load_peft_tensors(path).items():
        m = _NAME_RE.match(name)
        if not m:
            print(f"skipping unrecognized tensor {name}", file=sys.stderr)
            continue
        if m.group(1).startswith("model.layers."):
            raise ValueError(f"{name}: {LLAMA_REFUSAL}")
        base = m.group(1) + ".weight"
        suffix = "loraA" if m.group(2) == "A" else "loraB"
        tensors.setdefault(base, {})[suffix] = np.asarray(arr, dtype=np.float32)

    out_path = out_path or os.path.join(path, "ggml-adapter-model.bin")
    write_lora(out_path, r, alpha, tensors)
    return out_path


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) not in (1, 2):
        print("usage: python -m ggllm_tpu_torch.io.convert_lora <peft_dir> [out.ggla]")
        return 1
    try:
        out = convert(argv[0], argv[1] if len(argv) == 2 else None)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
