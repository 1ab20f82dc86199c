"""HF Falcon checkpoint -> GGCC v10 converter (a copy of
ggllm_tpu/io/convert_hf.py; falcon_convert.py equivalent).

Emits GGCC v10 directly (with the BPE merges of tokenizer.json embedded), so
the result loads without the tokenizer.json fallback. Safetensors shards
are read by io/safetensors.py (no `safetensors` package; bf16 widened to f32
exactly), torch .bin shards by torch.load.

The critical transform is the fused-QKV de-interleave
(falcon_convert.py:155-179): HF stores n_head_kv groups of
[group queries..., key, value] rows; the engine expects
[all Q; all K; all V] rows.

    python -m ggllm_tpu_torch.io.convert_hf HF_DIR out.ggcc [--ftype f16|f32]
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

from ggllm_tpu_torch.core.config import FalconHParams
from ggllm_tpu_torch.core.dtypes import FType, GGMLType
from ggllm_tpu_torch.io import safetensors
from ggllm_tpu_torch.io.ggcc import GGCCWriter
from ggllm_tpu_torch.tokenizer.bpe import Vocab, unicode_to_bytes

KCACHE_NOTE = "--kcache: the port keeps no .kcache sidecar (its load is a copy); nothing written"


def deinterleave_qkv(data: np.ndarray, n_head: int, n_head_kv: int, head_dim: int) -> np.ndarray:
    """HF fused-QKV layout -> [Q; K; V] rows. data: ((H+2KV)*D, E)."""
    n_embd = data.shape[1]
    qkv = data.reshape(n_head_kv, n_head // n_head_kv + 2, head_dim, n_embd)
    q = qkv[:, :-2].reshape(n_head * head_dim, n_embd)
    k = qkv[:, -2].reshape(n_head_kv * head_dim, n_embd)
    v = qkv[:, -1].reshape(n_head_kv * head_dim, n_embd)
    return np.concatenate([q, k, v], axis=0)


def vocab_from_tokenizer_json(path: str | Path, n_vocab: int) -> Vocab:
    """Build the engine Vocab from an HF tokenizer.json."""
    with open(path, "r", encoding="utf-8") as f:
        tj = json.load(f)
    model = tj["model"]
    dec = unicode_to_bytes()

    def decode(tok: str) -> bytes:
        out = bytearray()
        for c in tok:
            b = dec.get(c)
            if b is not None:
                out.append(b)
            else:  # multibyte special-token characters pass through as utf-8
                out.extend(c.encode("utf-8"))
        return bytes(out)

    id_to_token: list[bytes] = [b""] * n_vocab
    seen = set()
    for tok, tid in model["vocab"].items():
        if tid < n_vocab:
            id_to_token[tid] = decode(tok)
            seen.add(tid)
    for at in tj.get("added_tokens", []):
        if at["id"] < n_vocab:
            id_to_token[at["id"]] = at["content"].encode("utf-8")
            seen.add(at["id"])
    for i in range(n_vocab):
        if i not in seen:
            id_to_token[i] = f"[PAD{i}]".encode()

    merges = []
    for m in model["merges"]:
        if isinstance(m, str):
            a, b = m.split(" ", 1)
        else:
            a, b = m
        merges.append((a, b))
    return Vocab(id_to_token=id_to_token, scores=[0.0] * n_vocab, merges=merges)


def _iter_checkpoint_tensors(dir_model: Path):
    """Yield (name, numpy array) from safetensors or torch .bin shards."""
    st_parts = sorted(dir_model.glob("*.safetensors"))
    if st_parts:
        for part in st_parts:
            yield from safetensors.iter_tensors(part)
        return
    bin_parts = sorted(dir_model.glob("pytorch_model*.bin"))
    if not bin_parts:
        raise FileNotFoundError(f"no safetensors or pytorch .bin shards in {dir_model}")
    import torch

    for part in bin_parts:
        sd = torch.load(str(part), map_location="cpu", weights_only=True)
        for name, t in sd.items():
            if t.dtype not in (torch.float16, torch.float32):
                t = t.to(torch.float32)
            yield name, t.numpy()


def convert(dir_model: str, out_path: str, ftype: str = "f16", log=print) -> FalconHParams:
    """Convert an HF Falcon checkpoint directory to GGCC v10."""
    dir_model = Path(dir_model)
    with open(dir_model / "config.json", "r") as f:
        config = json.load(f)

    n_head = config.get("num_attention_heads", config.get("n_head"))
    n_head_kv = config.get("num_kv_heads", config.get("n_head_kv", 1)) or 1
    n_layer = config.get("num_hidden_layers", config.get("n_layer"))
    n_embd = config.get("hidden_size")
    n_vocab = config.get("vocab_size")
    head_dim = n_embd // n_head
    is_40b = ("num_kv_heads" in config) or ("n_head_kv" in config) or n_head_kv > 1

    vocab = vocab_from_tokenizer_json(dir_model / "tokenizer.json", n_vocab)
    hp = FalconHParams(
        n_vocab=n_vocab, n_embd=n_embd, n_head=n_head, n_head_kv=n_head_kv,
        n_layer=n_layer, n_falcon_type=40 if is_40b else 7,
        ftype=int(FType.MOSTLY_F16 if ftype == "f16" else FType.ALL_F32),
        n_bpe_merges=len(vocab.merges),
    )
    writer = GGCCWriter(out_path, hp, vocab)

    written: set[str] = set()
    embeddings = None
    for name, data in _iter_checkpoint_tensors(dir_model):
        data = np.asarray(data)
        if "query_key_value" in name:
            data = deinterleave_qkv(data.astype(np.float32), n_head, n_head_kv, head_dim)
        data = np.squeeze(data)
        n_dims = data.ndim
        if ftype == "f16" and n_dims == 2 and name.endswith(".weight"):
            gtype = GGMLType.F16
        else:
            gtype = GGMLType.F32
        # strip the HF "transformer." module prefix variations
        out_name = name
        if out_name.startswith("model."):
            out_name = out_name[len("model."):]
        if out_name == "transformer.word_embeddings.weight":
            embeddings = (data, gtype)
        writer.write_array(out_name, data.astype(np.float32), gtype)
        written.add(out_name)
        log(f"  | {out_name} {tuple(data.shape)} -> {gtype.name}")
    if "lm_head.weight" not in written and embeddings is not None:
        # tied-embedding HF checkpoints omit lm_head; the GGCC runtime (and
        # the reference's loader) require it: materialize the tie
        data, gtype = embeddings
        writer.write_array("lm_head.weight", data.astype(np.float32), gtype)
        log(f"  | lm_head.weight {tuple(data.shape)} -> {gtype.name} (tied to word_embeddings)")
    writer.close()
    return hp


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="HF Falcon -> GGCC v10")
    ap.add_argument("dir_model")
    ap.add_argument("out_path")
    ap.add_argument("--ftype", choices=["f16", "f32"], default="f16")
    ap.add_argument("--kcache", action="store_true",
                    help="accepted for the JAX converter's command line; the port writes no"
                         " .kcache")
    args = ap.parse_args(argv)
    convert(args.dir_model, args.out_path, args.ftype)
    if args.kcache:
        print(KCACHE_NOTE, file=sys.stderr)


if __name__ == "__main__":
    main()
