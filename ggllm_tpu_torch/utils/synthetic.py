"""Small synthetic models (the counterpart of ggllm_tpu/utils/synthetic.py):
a structurally faithful Falcon GGCC v10 file or LLaMA GGJT v3 file (real
header, vocab, merges or scores, and tensor records) with random weights,
written with the port's own writers. Every 2-D weight goes through the
port's quantizer (quant/registry.py), as the JAX writer's do."""

from __future__ import annotations

import numpy as np

from ggllm_tpu_torch.core.config import FalconHParams, LlamaHParams
from ggllm_tpu_torch.core.dtypes import GGMLType
from ggllm_tpu_torch.io.ggcc import GGCCWriter, GGJTWriter
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


def weight_specs(hp: FalconHParams | LlamaHParams) -> list[tuple[str, tuple, float, float]]:
    """Every tensor of a model of either family in file order, as (name,
    numpy-convention (out, in) shape, scale, offset): its random values are
    offset + scale * standard normal (the scale 1/sqrt(in) where none is
    given), the norms' weights centred on 1."""
    E, V, L = hp.n_embd, hp.n_vocab, hp.n_layer

    def w(name, *shape, scale=None, offset=0.0):
        return name, shape, scale or 1.0 / np.sqrt(shape[-1]), offset

    if hp.arch == "llama":
        F = hp.n_ff
        specs = [w("tok_embeddings.weight", V, E, scale=0.02),
                 w("norm.weight", E, scale=0.02, offset=1.0), w("output.weight", V, E)]
        for i in range(L):
            p = f"layers.{i}"
            specs += [w(f"{p}.attention_norm.weight", E, scale=0.02, offset=1.0),
                      w(f"{p}.ffn_norm.weight", E, scale=0.02, offset=1.0)]
            specs += [w(f"{p}.attention.{k}.weight", E, E) for k in ("wq", "wk", "wv", "wo")]
            specs += [w(f"{p}.feed_forward.w1.weight", F, E),
                      w(f"{p}.feed_forward.w2.weight", E, F),
                      w(f"{p}.feed_forward.w3.weight", F, E)]
        return specs
    H, KV, D, F = hp.n_head, hp.n_head_kv, hp.head_dim, hp.n_ff
    specs = [w("transformer.word_embeddings.weight", V, E, scale=0.02),
             w("transformer.ln_f.weight", E, scale=0.02, offset=1.0),
             w("transformer.ln_f.bias", E, scale=0.02), w("lm_head.weight", V, E)]
    for i in range(L):
        p = f"transformer.h.{i}"
        for n in ("ln_mlp", "ln_attn") if hp.n_falcon_type >= 40 else ("input_layernorm",):
            specs += [w(f"{p}.{n}.weight", E, scale=0.02, offset=1.0),
                      w(f"{p}.{n}.bias", E, scale=0.02)]
        specs += [w(f"{p}.self_attention.query_key_value.weight", (H + 2 * KV) * D, E),
                  w(f"{p}.self_attention.dense.weight", E, H * D),
                  w(f"{p}.mlp.dense_h_to_4h.weight", F, E),
                  w(f"{p}.mlp.dense_4h_to_h.weight", E, F)]
    return specs


def random_weights(hp: FalconHParams | LlamaHParams, seed: int = 0) -> dict[str, np.ndarray]:
    """Numpy-convention (out, in) float32 weights of weight_specs, drawn in
    file order from one seed (the JAX package's random_falcon_weights /
    random_llama_weights values)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape, scale, offset in weight_specs(hp):
        x = (rng.standard_normal(shape) * scale).astype(np.float32)
        out[name] = np.float32(offset) + x if offset else x
    return out


def _write_weights(writer, ws: dict[str, np.ndarray], ftype_2d: GGMLType):
    """Every array of ws into the open writer: 1-D as F32, 2-D quantized to
    ftype_2d; then close it."""
    for name, arr in ws.items():
        writer.write_array(name, arr, ftype_2d if arr.ndim == 2 else GGMLType.F32)
    writer.close()


def write_tiny_model(path: str, hp: FalconHParams | None = None,
                     ftype_2d: GGMLType = GGMLType.Q4_0, seed: int = 0) -> FalconHParams:
    """Write a complete GGCC v10 file with random weights, 2-D tensors in
    ftype_2d (any of the ten block formats, F16 or F32)."""
    hp = hp or FalconHParams.tiny()
    vocab = make_tiny_vocab(hp.n_vocab)
    hp.n_bpe_merges = len(vocab.merges)
    _write_weights(GGCCWriter(path, hp, vocab), random_weights(hp, seed), ftype_2d)
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


def write_tiny_llama(path: str, hp: LlamaHParams | None = None,
                     ftype_2d: GGMLType = GGMLType.Q4_0, seed: int = 0) -> LlamaHParams:
    """Write a complete GGJT v3 LLaMA file with random weights, 2-D tensors
    in ftype_2d (any of the ten block formats, F16 or F32)."""
    hp = hp or LlamaHParams.tiny()
    vocab = make_tiny_sp_vocab(hp.n_vocab)
    _write_weights(GGJTWriter(path, hp, vocab), random_weights(hp, seed), ftype_2d)
    return hp
