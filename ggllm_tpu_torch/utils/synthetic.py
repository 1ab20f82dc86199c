"""Small synthetic models (the counterpart of ggllm_tpu/utils/synthetic.py):
a structurally faithful Falcon GGCC v10 file or LLaMA GGJT v3 file (real
header, vocab, merges or scores, and tensor records) with random weights,
written with the port's own writers. Q4_0 and Q8_0 weights go through the
port's quantizer; the other formats (whose quantizers are not ported) get
seeded random codes and scales (utils/benchgen.py random_quant), packed into
ggml's blocks."""

from __future__ import annotations

import numpy as np
import torch

from ggllm_tpu_torch.core.config import FalconHParams, LlamaHParams
from ggllm_tpu_torch.core.dtypes import GGMLType
from ggllm_tpu_torch.io.ggcc import GGCCWriter, GGJTWriter
from ggllm_tpu_torch.quant import planar, registry
from ggllm_tpu_torch.tokenizer.bpe import Vocab


def make_tiny_vocab(n_vocab: int = 512) -> Vocab:
    """Vocab: 12 specials, 256 byte tokens, simple merge-derived tokens."""
    assert n_vocab >= 12 + 256
    toks: list[bytes] = [f">>SPECIAL_{i}<<".encode() for i in range(11)]
    toks.append(b"<|endoftext|>")  # id 11, BOS/EOS
    toks += [bytes([b]) for b in range(256)]
    merges: list[tuple[str, str]] = []
    pairs = [("t", "h"), ("h", "e"), ("i", "n"), ("e", "r"), ("a", "n"),
             ("Ġ", "t"), ("Ġ", "a"), ("th", "e"), ("Ġt", "he"), ("a", "n"),
             ("in", "g"), ("o", "u")]
    for l, r in pairs:
        if len(toks) >= n_vocab:
            break
        merged = (l + r).replace("Ġ", " ").replace("Ċ", "\n")
        if merged.encode() in toks:
            continue
        merges.append((l, r))
        toks.append(merged.encode())
    while len(toks) < n_vocab:
        toks.append(f"<filler_{len(toks)}>".encode())
    return Vocab(id_to_token=toks, scores=[0.0] * len(toks), merges=merges)


def random_falcon_weights(hp: FalconHParams, seed: int = 0) -> dict[str, np.ndarray]:
    """Numpy-convention (out, in) float32 weights with sane magnitudes."""
    rng = np.random.default_rng(seed)
    E, H, KV, D = hp.n_embd, hp.n_head, hp.n_head_kv, hp.head_dim
    V, F, L = hp.n_vocab, hp.n_ff, hp.n_layer

    def w(*shape, scale=None):
        scale = scale or (1.0 / np.sqrt(shape[-1]))
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    ws = {
        "transformer.word_embeddings.weight": w(V, E, scale=0.02),
        "transformer.ln_f.weight": np.ones(E, np.float32) + w(E, scale=0.02),
        "transformer.ln_f.bias": w(E, scale=0.02),
        "lm_head.weight": w(V, E),
    }
    for i in range(L):
        p = f"transformer.h.{i}"
        norms = ("ln_mlp", "ln_attn") if hp.n_falcon_type >= 40 else ("input_layernorm",)
        for n in norms:
            ws[f"{p}.{n}.weight"] = np.ones(E, np.float32) + w(E, scale=0.02)
            ws[f"{p}.{n}.bias"] = w(E, scale=0.02)
        ws[f"{p}.self_attention.query_key_value.weight"] = w((H + 2 * KV) * D, E)
        ws[f"{p}.self_attention.dense.weight"] = w(E, H * D)
        ws[f"{p}.mlp.dense_h_to_4h.weight"] = w(F, E)
        ws[f"{p}.mlp.dense_4h_to_h.weight"] = w(E, F)
    return ws


def _write_weights(writer, ws: dict[str, np.ndarray], ftype_2d: GGMLType, seed: int):
    """Every array of ws into the open writer: 1-D as F32, 2-D in ftype_2d
    (through the quantizer where the port has one, else as random blocks of
    the same spread, 1/sqrt(cols)); then close it."""
    from ggllm_tpu_torch.utils.benchgen import random_quant

    gen = torch.Generator().manual_seed(seed)
    for name, arr in ws.items():
        if arr.ndim == 1 or registry.can_quantize(ftype_2d):
            writer.write_array(name, arr, ftype_2d if arr.ndim == 2 else GGMLType.F32)
            continue
        rows, cols = arr.shape
        w = random_quant(ftype_2d, rows, cols, gen, "cpu", scale=float(np.sqrt(3.0 / cols)))
        blob = planar.from_planes(ftype_2d, {k: v.numpy() for k, v in w.planes.items()})
        writer.write_tensor(name, ftype_2d, (cols, rows), blob)
    writer.close()


def write_tiny_model(path: str, hp: FalconHParams | None = None,
                     ftype_2d: GGMLType = GGMLType.Q4_0, seed: int = 0) -> FalconHParams:
    """Write a complete GGCC v10 file with random weights, 2-D tensors in
    ftype_2d (any of the ten block formats, F16 or F32)."""
    hp = hp or FalconHParams.tiny()
    vocab = make_tiny_vocab(hp.n_vocab)
    hp.n_bpe_merges = len(vocab.merges)
    _write_weights(GGCCWriter(path, hp, vocab), random_falcon_weights(hp, seed), ftype_2d, seed)
    return hp


def make_tiny_sp_vocab(n_vocab: int = 512) -> Vocab:
    """SentencePiece-style scored vocab: <unk>/<s>/</s>, 256 byte tokens,
    then multi-char pieces with descending scores (llama vocab shape)."""
    assert n_vocab >= 3 + 256
    toks: list[bytes] = [b"<unk>", b"<s>", b"</s>"] + [bytes([b]) for b in range(256)]
    scores: list[float] = [0.0, 0.0, 0.0] + [-1e6] * 256  # byte pieces: lowest priority
    pieces = [" t", "th", "he", " a", "an", "in", "er", " the", "the",
              " an", "ing", "ou", " o", "re", " s", "nd", " and"]
    score = -1.0
    for pc in pieces:
        if len(toks) >= n_vocab:
            break
        if pc.encode() in toks:
            continue
        toks.append(pc.encode())
        scores.append(score)
        score -= 1.0
    while len(toks) < n_vocab:
        toks.append(f"<extra_{len(toks)}>".encode())
        scores.append(-1e6)
    return Vocab(id_to_token=toks, scores=scores, merges=[])


def random_llama_weights(hp: LlamaHParams, seed: int = 0) -> dict[str, np.ndarray]:
    """Numpy-convention (out, in) float32 LLaMA weights (llama.cpp names)."""
    rng = np.random.default_rng(seed)
    E, V, F, L = hp.n_embd, hp.n_vocab, hp.n_ff, hp.n_layer

    def w(*shape, scale=None):
        scale = scale or (1.0 / np.sqrt(shape[-1]))
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    ws = {
        "tok_embeddings.weight": w(V, E, scale=0.02),
        "norm.weight": np.ones(E, np.float32) + w(E, scale=0.02),
        "output.weight": w(V, E),
    }
    for i in range(L):
        p = f"layers.{i}"
        ws[f"{p}.attention_norm.weight"] = np.ones(E, np.float32) + w(E, scale=0.02)
        ws[f"{p}.ffn_norm.weight"] = np.ones(E, np.float32) + w(E, scale=0.02)
        for k in ("wq", "wk", "wv", "wo"):
            ws[f"{p}.attention.{k}.weight"] = w(E, E)
        ws[f"{p}.feed_forward.w1.weight"] = w(F, E)
        ws[f"{p}.feed_forward.w2.weight"] = w(E, F)
        ws[f"{p}.feed_forward.w3.weight"] = w(F, E)
    return ws


def write_tiny_llama(path: str, hp: LlamaHParams | None = None,
                     ftype_2d: GGMLType = GGMLType.Q4_0, seed: int = 0) -> LlamaHParams:
    """Write a complete GGJT v3 LLaMA file with random weights, 2-D tensors
    in ftype_2d (any of the ten block formats, F16 or F32)."""
    hp = hp or LlamaHParams.tiny()
    vocab = make_tiny_sp_vocab(hp.n_vocab)
    _write_weights(GGJTWriter(path, hp, vocab), random_llama_weights(hp, seed), ftype_2d, seed)
    return hp
