"""LLaMA checkpoint -> GGJT v3 converter (a copy of
ggllm_tpu/io/convert_hf_llama.py; convert.py equivalent).

Accepts both input layouts the reference converter does:

* **HF directories** (config.json + .safetensors / pytorch_model*.bin):
  wq/wk need the rope permutation: HF applies rotary embedding over
  half-split dims; ggml uses interleaved adjacent pairs, so the q/k
  projection rows are permuted ``(H, 2, D/2, E) -> (H, D/2, 2, E)``;
  tensor names are mapped model.layers.N.self_attn.q_proj ->
  layers.N.attention.wq etc. Safetensors shards are read by
  io/safetensors.py (no `safetensors` package; bf16 widened exactly).
* **Original Meta directories** (params.json + consolidated.NN.pth),
  the scope of the reference's convert.py:91-160 / convert-pth-to-ggml.py:
  tensor names already match ggml, NO rope permutation (Meta's rotary
  code uses the interleaved-pair view ggml inherited), and the
  model-parallel shards are concatenated per tensor family (column-
  parallel wq/wk/wv/w1/w3/output on axis 0, row-parallel wo/w2 and the
  ParallelEmbedding tok_embeddings on axis 1, norms duplicated).

Vocab comes from tokenizer.model (SentencePiece ModelProto, parsed with a
minimal built-in protobuf reader: pieces field 1 {piece=1, score=2}),
falling back to tokenizer.json with rank-derived scores.

    python -m ggllm_tpu_torch.io.convert_hf_llama DIR out.ggjt [--ftype f16|f32]
"""

from __future__ import annotations

import json
import struct
import sys
from pathlib import Path

import numpy as np

from ggllm_tpu_torch.core.config import LlamaHParams
from ggllm_tpu_torch.core.dtypes import FType, GGMLType
from ggllm_tpu_torch.io.convert_hf import KCACHE_NOTE, _iter_checkpoint_tensors
from ggllm_tpu_torch.io.ggcc import GGJTWriter
from ggllm_tpu_torch.tokenizer.bpe import Vocab

_NAME_MAP = {
    "embed_tokens.weight": "tok_embeddings.weight",
    "norm.weight": "norm.weight",
    "lm_head.weight": "output.weight",
}
_LAYER_MAP = {
    "input_layernorm.weight": "attention_norm.weight",
    "post_attention_layernorm.weight": "ffn_norm.weight",
    "self_attn.q_proj.weight": "attention.wq.weight",
    "self_attn.k_proj.weight": "attention.wk.weight",
    "self_attn.v_proj.weight": "attention.wv.weight",
    "self_attn.o_proj.weight": "attention.wo.weight",
    "mlp.gate_proj.weight": "feed_forward.w1.weight",
    "mlp.down_proj.weight": "feed_forward.w2.weight",
    "mlp.up_proj.weight": "feed_forward.w3.weight",
}


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    v = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7


# SentencePiece ModelProto piece types (sentencepiece_model.proto)
SP_NORMAL, SP_UNKNOWN, SP_CONTROL, SP_USER_DEFINED, SP_UNUSED, SP_BYTE = 1, 2, 3, 4, 5, 6


def parse_sentencepiece_model(
        path: str | Path) -> tuple[list[bytes], list[float], list[int]]:
    """Minimal ModelProto reader: repeated field 1 = SentencePiece
    { piece: string = 1, score: float = 2, type: enum = 3 }."""
    data = Path(path).read_bytes()
    pieces: list[bytes] = []
    scores: list[float] = []
    types: list[int] = []
    i = 0
    while i < len(data):
        tag, i = _read_varint(data, i)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # a SentencePiece submessage
            ln, i = _read_varint(data, i)
            sub = data[i : i + ln]
            i += ln
            piece, score, ptype = b"", 0.0, SP_NORMAL
            j = 0
            while j < len(sub):
                t2, j = _read_varint(sub, j)
                f2, w2 = t2 >> 3, t2 & 7
                if f2 == 1 and w2 == 2:
                    l2, j = _read_varint(sub, j)
                    piece = sub[j : j + l2]
                    j += l2
                elif f2 == 2 and w2 == 5:
                    score = struct.unpack("<f", sub[j : j + 4])[0]
                    j += 4
                elif f2 == 3 and w2 == 0:
                    ptype, j = _read_varint(sub, j)
                elif w2 == 0:
                    _, j = _read_varint(sub, j)
                elif w2 == 2:
                    l2, j = _read_varint(sub, j)
                    j += l2
                elif w2 == 5:
                    j += 4
                else:
                    j += 8
            pieces.append(piece)
            scores.append(score)
            types.append(ptype)
        elif wire == 0:
            _, i = _read_varint(data, i)
        elif wire == 2:
            ln, i = _read_varint(data, i)
            i += ln
        elif wire == 5:
            i += 4
        else:
            i += 8
    return pieces, scores, types


def _piece_to_bytes(piece: bytes, ptype: int = SP_NORMAL) -> bytes:
    """SentencePiece piece -> raw bytes, matching reference convert.py:180-191:
    control pieces (<s>, </s>, ...) -> b'' so they never detokenize as literal
    markup or greedily match user text; unknown -> ' ⁇ '; <0xNN> byte
    pieces -> the byte; U+2581 -> space."""
    if ptype == SP_CONTROL:
        return b""
    if ptype == SP_UNKNOWN:
        return " ⁇ ".encode("utf-8")
    if piece.startswith(b"<0x") and piece.endswith(b">") and len(piece) == 6:
        try:
            return bytes([int(piece[3:5], 16)])
        except ValueError:
            pass
    return piece.replace("▁".encode(), b" ")


_FALLBACK_CONTROL = {b"<s>": SP_CONTROL, b"</s>": SP_CONTROL, b"<pad>": SP_CONTROL,
                     b"<unk>": SP_UNKNOWN}


def build_vocab(dir_model: Path, n_vocab: int) -> Vocab:
    sp = dir_model / "tokenizer.model"
    if sp.exists():
        pieces, scores, types = parse_sentencepiece_model(sp)
        toks = [_piece_to_bytes(p, t) for p, t in zip(pieces, types)]
    else:  # fast-tokenizer fallback: rank-derived scores
        with open(dir_model / "tokenizer.json", encoding="utf-8") as f:
            tj = json.load(f)
        vocab_map = tj["model"]["vocab"]
        toks = [b""] * len(vocab_map)
        scores = [0.0] * len(vocab_map)
        for tok, tid in vocab_map.items():
            raw = tok.encode()
            toks[tid] = _piece_to_bytes(raw, _FALLBACK_CONTROL.get(raw, SP_NORMAL))
            scores[tid] = -float(tid)
    while len(toks) < n_vocab:
        toks.append(f"<extra_{len(toks)}>".encode())
        scores.append(-1e6)
    return Vocab(id_to_token=toks[:n_vocab], scores=scores[:n_vocab], merges=[])


def permute_rope(w: np.ndarray, n_head: int) -> np.ndarray:
    """HF half-split rotary rows -> ggml interleaved-pair rows."""
    O, E = w.shape
    return (w.reshape(n_head, 2, O // n_head // 2, E)
            .swapaxes(1, 2).reshape(O, E))


def convert(dir_model: str, out_path: str, ftype: str = "f16", log=print) -> LlamaHParams:
    dir_model = Path(dir_model)
    with open(dir_model / "config.json") as f:
        config = json.load(f)
    n_embd = config["hidden_size"]
    n_head = config["num_attention_heads"]
    n_layer = config["num_hidden_layers"]
    n_vocab = config["vocab_size"]
    n_ff = config["intermediate_size"]
    # recover n_mult such that the loader's n_ff formula reproduces n_ff
    n_mult = 256
    for cand in (32, 64, 128, 256, 512, 1024):
        base = 2 * (4 * n_embd) // 3
        if ((base + cand - 1) // cand) * cand == n_ff:
            n_mult = cand
            break
    hp = LlamaHParams(
        n_vocab=n_vocab, n_embd=n_embd, n_mult=n_mult, n_head=n_head,
        n_layer=n_layer, n_rot=n_embd // n_head,
        ftype=int(FType.MOSTLY_F16 if ftype == "f16" else FType.ALL_F32),
    )
    if hp.n_ff != n_ff:
        raise ValueError(f"cannot express intermediate_size {n_ff} via n_mult")

    vocab = build_vocab(dir_model, n_vocab)
    writer = GGJTWriter(out_path, hp, vocab)
    for name, data in _iter_checkpoint_tensors(dir_model):
        data = np.asarray(data, dtype=np.float32)
        key = name
        if key.startswith("model."):
            key = key[len("model."):]
        if key.startswith("layers."):
            pre, rest = key.split(".", 2)[1], key.split(".", 2)[2]
            mapped = _LAYER_MAP.get(rest)
            if mapped is None:
                log(f"  | skipping {name}")
                continue
            out_name = f"layers.{pre}.{mapped}"
            if rest.startswith("self_attn.q_proj") or rest.startswith("self_attn.k_proj"):
                data = permute_rope(data, n_head)
        else:
            mapped = _NAME_MAP.get(key)
            if mapped is None:
                log(f"  | skipping {name}")
                continue
            out_name = mapped
        gtype = GGMLType.F16 if (ftype == "f16" and data.ndim == 2) else GGMLType.F32
        writer.write_array(out_name, data, gtype)
        log(f"  | {out_name} {tuple(data.shape)} -> {gtype.name}")
    writer.close()
    return hp


def _meta_shard_axis(name: str) -> int | None:
    """Concat axis for Meta model-parallel shards (None = duplicated)."""
    if name == "tok_embeddings.weight":
        return 1  # ParallelEmbedding splits the embedding dim
    if name == "output.weight" or name.endswith((
            "attention.wq.weight", "attention.wk.weight",
            "attention.wv.weight", "feed_forward.w1.weight",
            "feed_forward.w3.weight")):
        return 0  # column-parallel
    if name.endswith(("attention.wo.weight", "feed_forward.w2.weight")):
        return 1  # row-parallel
    return None


def convert_pth(dir_model: str, out_path: str, ftype: str = "f16",
                log=print) -> LlamaHParams:
    """Original Meta LLaMA checkpoint dir -> GGJT v3.

    Expects params.json + consolidated.NN.pth (+ tokenizer.model in the
    directory or its parent, where Meta distributions keep the shared one).
    """
    import torch

    dir_model = Path(dir_model)
    with open(dir_model / "params.json") as f:
        params = json.load(f)
    parts = sorted(dir_model.glob("consolidated.*.pth"))
    if not parts:
        raise FileNotFoundError(f"no consolidated.*.pth shards in {dir_model}")
    shards = [torch.load(str(p), map_location="cpu", weights_only=True)
              for p in parts]

    n_embd = params["dim"]
    n_head = params["n_heads"]
    n_layer = params["n_layers"]
    n_mult = params.get("multiple_of", 256)
    n_vocab = params.get("vocab_size", -1)
    if n_vocab <= 0:  # llama-1 params.json says -1; the embedding knows
        n_vocab = shards[0]["tok_embeddings.weight"].shape[0]
    hp = LlamaHParams(
        n_vocab=n_vocab, n_embd=n_embd, n_mult=n_mult, n_head=n_head,
        n_layer=n_layer, n_rot=n_embd // n_head,
        ftype=int(FType.MOSTLY_F16 if ftype == "f16" else FType.ALL_F32),
    )

    sp_dir = dir_model if (dir_model / "tokenizer.model").exists() \
        else dir_model.parent
    vocab = build_vocab(sp_dir, n_vocab)
    writer = GGJTWriter(out_path, hp, vocab)
    for name in shards[0]:
        if name == "rope.freqs":  # recomputed at runtime
            continue
        axis = _meta_shard_axis(name)
        if len(shards) == 1 or axis is None:
            t = shards[0][name]
        else:
            t = torch.cat([sd[name] for sd in shards], dim=axis)
        data = np.asarray(t.to(torch.float32).numpy())
        if name.endswith("feed_forward.w1.weight") and data.shape[0] != hp.n_ff:
            raise ValueError(
                f"checkpoint n_ff {data.shape[0]} != {hp.n_ff} derived from "
                f"multiple_of={n_mult} (not expressible in a GGJT v1 header)")
        gtype = GGMLType.F16 if (ftype == "f16" and data.ndim == 2) else GGMLType.F32
        writer.write_array(name, data, gtype)
        log(f"  | {name} {tuple(data.shape)} -> {gtype.name}")
    writer.close()
    return hp


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="LLaMA (HF or Meta .pth) -> GGJT v3")
    ap.add_argument("dir_model")
    ap.add_argument("out_path")
    ap.add_argument("--ftype", choices=["f16", "f32"], default="f16")
    ap.add_argument("--kcache", action="store_true",
                    help="accepted for the JAX converter's command line; the port writes no"
                         " .kcache")
    args = ap.parse_args(argv)
    if Path(args.dir_model, "params.json").exists():
        convert_pth(args.dir_model, args.out_path, args.ftype)
    else:
        convert(args.dir_model, args.out_path, args.ftype)
    if args.kcache:
        print(KCACHE_NOTE, file=sys.stderr)


if __name__ == "__main__":
    main()
