"""PEFT LoRA adapter -> 'ggla' v1 converter (convert-lora-to-ggml.py
analogue; ggllm_tpu/io/convert_lora.py, with the base model's head counts).

Reads a HuggingFace PEFT directory (adapter_config.json +
adapter_model.safetensors / .bin) and writes a ggla file whose base tensor
names are the converted model's, so ``--lora`` resolves them directly. PEFT
names look like::

  base_model.model.transformer.h.7.self_attention.query_key_value.lora_A.weight
  base_model.model.model.layers.7.self_attn.q_proj.lora_B.weight

A Falcon name maps to its GGCC name (``transformer.h.7.self_attention.
query_key_value.weight``); a LLaMA name to its GGJT name through
io/convert_hf_llama.py _LAYER_MAP (``layers.7.attention.wq.weight``).

The model converters reorder some weight rows, and an adapter's lora_B rows
(its output rows) must follow them, so the converter takes the base model
(`base`: an HF config.json, its directory, or the converted GGCC / GGJT
file) for its head counts:

* Falcon query_key_value: io/convert_hf.py deinterleave_qkv (HF's
  per-KV-group [q...; k; v] rows -> [Q; K; V]), the identity when
  n_head_kv = 1 (Falcon-7B);
* LLaMA q_proj / k_proj: io/convert_hf_llama.py permute_rope (HF's
  half-split rotary rows -> ggml's interleaved pairs).

An adapter with a query_key_value or a LLaMA q_proj / k_proj pair and no
base is an error. lora_A is never reordered. The safetensors file is read by
io/safetensors.py (no `safetensors` package; bf16 widened to f32 exactly).

    python -m ggllm_tpu_torch.io.convert_lora PEFT_DIR [out.ggla] [--base CONFIG_OR_MODEL]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

import numpy as np

from ggllm_tpu_torch.io import safetensors
from ggllm_tpu_torch.io.convert_hf import deinterleave_qkv
from ggllm_tpu_torch.io.convert_hf_llama import _LAYER_MAP, permute_rope
from ggllm_tpu_torch.io.lora import write_lora

_NAME_RE = re.compile(r"^base_model\.model\.(.+)\.lora_(A|B)\.weight$")
_LLAMA_RE = re.compile(r"^model\.layers\.(\d+)\.(.+)$")
_ROPE_ROWS = ("self_attn.q_proj", "self_attn.k_proj")


def load_peft_tensors(path: str) -> dict[str, np.ndarray]:
    st = os.path.join(path, "adapter_model.safetensors")
    bin_ = os.path.join(path, "adapter_model.bin")
    if os.path.exists(st):
        return safetensors.load_file(st)
    import torch

    d = torch.load(bin_, map_location="cpu", weights_only=True)
    return {k: v.to(torch.float32).numpy() for k, v in d.items()}


def base_heads(base: str) -> tuple[int, int]:
    """(n_head, n_head_kv) of the base model: an HF config.json or its
    directory (the key fallbacks of io/convert_hf.py convert and
    convert_hf_llama.py convert), or a converted GGCC / GGJT file."""
    cfg_path = os.path.join(base, "config.json") if os.path.isdir(base) else base
    if cfg_path.endswith(".json"):
        with open(cfg_path) as f:
            config = json.load(f)
        n_head = config.get("num_attention_heads", config.get("n_head"))
        if config.get("model_type") == "llama":
            return n_head, n_head
        return n_head, config.get("num_kv_heads", config.get("n_head_kv", 1)) or 1
    from ggllm_tpu_torch.io.ggcc import read_model

    hp = read_model(base).hparams
    return hp.n_head, getattr(hp, "n_head_kv", hp.n_head)


def _target(name: str) -> tuple[str, str | None]:
    """A PEFT module name -> (the converted model's tensor name, the row
    reorder its lora_B needs: "qkv", "rope" or None)."""
    m = _LLAMA_RE.match(name)
    if m:
        mapped = _LAYER_MAP.get(m.group(2) + ".weight")
        if mapped is None:
            raise ValueError(f"{name}: not a LLaMA weight matrix the model converter maps")
        return f"layers.{m.group(1)}.{mapped}", "rope" if m.group(2) in _ROPE_ROWS else None
    return name + ".weight", "qkv" if name.endswith("query_key_value") else None


def convert(path: str, out_path: str | None = None, base: str | None = None) -> str:
    with open(os.path.join(path, "adapter_config.json")) as f:
        cfg = json.load(f)
    if cfg.get("peft_type", "LORA") != "LORA":
        raise ValueError(f"unsupported adapter type {cfg.get('peft_type')}")
    r = int(cfg["r"])
    alpha = int(cfg["lora_alpha"])

    tensors: dict[str, dict[str, np.ndarray]] = {}
    reorder: dict[str, str] = {}
    for name, arr in load_peft_tensors(path).items():
        m = _NAME_RE.match(name)
        if not m:
            print(f"skipping unrecognized tensor {name}", file=sys.stderr)
            continue
        target, how = _target(m.group(1))
        if how is not None:
            reorder[target] = how
        suffix = "loraA" if m.group(2) == "A" else "loraB"
        tensors.setdefault(target, {})[suffix] = np.asarray(arr, dtype=np.float32)

    if reorder:
        if base is None:
            raise ValueError(
                f"{sorted(reorder)[0]}: its lora_B rows follow the model converter's row order"
                " (Falcon query_key_value: deinterleave_qkv by n_head / n_head_kv; LLaMA"
                " q_proj / k_proj: permute_rope by n_head), which needs the base model's head"
                " counts: pass base= (--base), its config.json or the converted model")
        n_head, n_head_kv = base_heads(base)
        for target, how in reorder.items():
            pair = tensors[target]
            if "loraB" not in pair:
                continue
            b = pair["loraB"]
            if how == "qkv":
                pair["loraB"] = deinterleave_qkv(b, n_head, n_head_kv, b.shape[0] // (
                    n_head + 2 * n_head_kv))
            else:
                pair["loraB"] = permute_rope(b, n_head)

    out_path = out_path or os.path.join(path, "ggml-adapter-model.bin")
    write_lora(out_path, r, alpha, tensors)
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ggllm_tpu_torch.io.convert_lora")
    ap.add_argument("peft_dir")
    ap.add_argument("out", nargs="?", default=None)
    ap.add_argument("--base", default=None,
                    help="the base model: its HF config.json (or directory) or the converted"
                         " GGCC / GGJT file, for the head counts that reorder lora_B rows")
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    try:
        out = convert(args.peft_dir, args.out, base=args.base)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
