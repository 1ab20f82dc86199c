"""Small synthetic models (the counterpart of ggllm_tpu/utils/synthetic.py):
a structurally faithful Falcon GGCC v10 file or LLaMA GGJT v3 file (real
header, vocab, merges or scores, and tensor records) with random weights,
written with the port's own writers. Every 2-D weight goes through the
port's quantizer (quant/registry.py), as the JAX writer's do.

Also the inputs of the converters, at any width and without `transformers`
or `safetensors`: an HF Falcon or LLaMA checkpoint directory (config.json,
a tokenizer.json or tokenizer.model of the model's whole vocabulary, one
safetensors file, bf16 by default; write_hf_model) and a PEFT LoRA adapter
directory (write_peft_adapter)."""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

from ggllm_tpu_torch.core.config import FalconHParams, LlamaHParams
from ggllm_tpu_torch.core.dtypes import GGMLType
from ggllm_tpu_torch.io.ggcc import GGCCWriter, GGJTWriter
from ggllm_tpu_torch.tokenizer.bpe import Vocab, bytes_to_unicode


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


# ------------------------------------------------------- converter inputs

def bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 values -> bf16 bit patterns (uint16), rounded to nearest even."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((b + 0x7FFF + ((b >> 16) & 1)) >> 16).astype(np.uint16)


def write_safetensors(path: str | Path, specs: list[tuple[str, tuple]], draw,
                      dtype: str = "BF16") -> None:
    """A safetensors file of the tensors `specs` lists as (name, shape), in
    that order: the JSON header, then each tensor's values draw(name, shape)
    (f32) stored as `dtype` ("BF16", rounded to nearest even, or "F32")."""
    header, off = {}, 0
    for name, shape in specs:
        n = int(np.prod(shape)) * {"BF16": 2, "F32": 4}[dtype]
        header[name] = {"dtype": dtype, "shape": list(shape), "data_offsets": [off, off + n]}
        off += n
    head = json.dumps({"__metadata__": {"format": "pt"}, **header}).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for name, shape in specs:
            x = np.asarray(draw(name, tuple(shape)), dtype=np.float32).reshape(shape)
            f.write((bf16_bits(x) if dtype == "BF16" else x).tobytes())


def numpy_draw(seed: int, scales: dict[str, tuple[float, float]]):
    """draw(name, shape) for write_safetensors: offset + scale * standard
    normal from one numpy generator, `scales` giving (scale, offset) a name
    (the scale 1/sqrt(in) for names it lacks)."""
    rng = np.random.default_rng(seed)

    def draw(name, shape):
        scale, offset = scales.get(name, (1.0 / np.sqrt(shape[-1]), 0.0))
        return offset + rng.standard_normal(shape).astype(np.float32) * np.float32(scale)

    return draw


# GGJT LLaMA names -> HF names (the inverse of ggllm_tpu_torch/io/
# convert_hf_llama.py's maps)
_HF_LLAMA = {"tok_embeddings.weight": "model.embed_tokens.weight", "norm.weight": "model.norm.weight",
             "output.weight": "lm_head.weight"}
_HF_LLAMA_LAYER = {"attention_norm.weight": "input_layernorm.weight",
                   "ffn_norm.weight": "post_attention_layernorm.weight",
                   "attention.wq.weight": "self_attn.q_proj.weight",
                   "attention.wk.weight": "self_attn.k_proj.weight",
                   "attention.wv.weight": "self_attn.v_proj.weight",
                   "attention.wo.weight": "self_attn.o_proj.weight",
                   "feed_forward.w1.weight": "mlp.gate_proj.weight",
                   "feed_forward.w2.weight": "mlp.down_proj.weight",
                   "feed_forward.w3.weight": "mlp.up_proj.weight"}


def hf_name(hp: FalconHParams | LlamaHParams, name: str) -> str:
    """A GGCC / GGJT tensor name -> its name in an HF checkpoint (Falcon's
    are the same)."""
    if hp.arch != "llama":
        return name
    if name in _HF_LLAMA:
        return _HF_LLAMA[name]
    _, i, rest = name.split(".", 2)
    return f"model.layers.{i}.{_HF_LLAMA_LAYER[rest]}"


def hf_config(hp: FalconHParams | LlamaHParams, tied: bool) -> dict:
    """config.json of an HF checkpoint of hp's shape (Falcon-7B's without
    num_kv_heads, whose presence the converter reads as the 40B layout)."""
    if hp.arch == "llama":
        return {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
                "hidden_size": hp.n_embd, "intermediate_size": hp.n_ff,
                "num_attention_heads": hp.n_head, "num_hidden_layers": hp.n_layer,
                "vocab_size": hp.n_vocab, "rms_norm_eps": 1e-6, "tie_word_embeddings": tied}
    cfg = {"architectures": ["FalconForCausalLM"], "model_type": "falcon",
           "hidden_size": hp.n_embd, "num_attention_heads": hp.n_head,
           "num_hidden_layers": hp.n_layer, "vocab_size": hp.n_vocab, "parallel_attn": True,
           "bias": False, "alibi": False, "tie_word_embeddings": tied,
           "multi_query": hp.n_falcon_type < 40,
           "new_decoder_architecture": hp.n_falcon_type >= 40}
    if hp.n_falcon_type >= 40:
        cfg["num_kv_heads"] = hp.n_head_kv
    return cfg


def write_tokenizer_json(path: str | Path, vocab: Vocab) -> None:
    """An HF byte-level BPE tokenizer.json of `vocab`: every id's token in
    the byte-to-unicode alphabet, the merges, the end-of-text id (11) an
    added token."""
    b2u = bytes_to_unicode()
    ids = {"".join(b2u[b] for b in tok): i for i, tok in enumerate(vocab.id_to_token)}
    added = [{"id": i, "content": tok.decode(), "special": True}
             for i, tok in enumerate(vocab.id_to_token) if tok == b"<|endoftext|>"]
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"model": {"type": "BPE", "vocab": ids,
                             "merges": [f"{a} {b}" for a, b in vocab.merges]},
                   "added_tokens": added}, f)


def _varint(v: int) -> bytes:
    out = b""
    while True:
        b, v = v & 0x7F, v >> 7
        if not v:
            return out + bytes([b])
        out += bytes([b | 0x80])


def write_sp_model(path: str | Path, vocab: Vocab) -> None:
    """A SentencePiece ModelProto (tokenizer.model) of `vocab`'s pieces:
    <unk> UNKNOWN, <s> and </s> CONTROL, single bytes as <0xNN> BYTE pieces,
    the rest NORMAL with spaces as U+2581; each with its score."""
    out = bytearray()
    for tok, score in zip(vocab.id_to_token, vocab.scores):
        if tok == b"<unk>":
            piece, ptype = tok, 2
        elif tok in (b"<s>", b"</s>"):
            piece, ptype = tok, 3
        elif len(tok) == 1:
            piece, ptype = f"<0x{tok[0]:02X}>".encode(), 6
        else:
            piece, ptype = tok.replace(b" ", "\u2581".encode()), 1
        sub = (b"\x0a" + _varint(len(piece)) + piece + b"\x15" + struct.pack("<f", score)
               + b"\x18" + _varint(ptype))
        out += b"\x0a" + _varint(len(sub)) + sub
    Path(path).write_bytes(bytes(out))


def write_hf_model(d: str | Path, hp: FalconHParams | LlamaHParams, seed: int = 0,
                   tied: bool | None = None, draw=None, dtype: str = "BF16") -> list[tuple]:
    """An HF checkpoint directory of hp's shape: config.json, the tokenizer
    (Falcon: tokenizer.json of make_tiny_vocab; LLaMA: tokenizer.model of
    make_tiny_sp_vocab, both of hp.n_vocab ids) and model.safetensors in
    `dtype`, with weight_specs' tensors under their HF names (Falcon's fused
    QKV rows in HF's order, which random values do not tell apart). tied
    (default: Falcon) leaves lm_head out, as tied-embedding checkpoints do.
    draw(name, shape) gives the f32 values (default numpy_draw(seed) with
    weight_specs' spreads). Returns the (HF name, shape) list written."""
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    tied = hp.arch != "llama" if tied is None else tied
    head = "output.weight" if hp.arch == "llama" else "lm_head.weight"
    specs = [(hf_name(hp, name), shape, scale, offset)
             for name, shape, scale, offset in weight_specs(hp) if not (tied and name == head)]
    draw = draw or numpy_draw(seed, {name: (scale, offset) for name, _, scale, offset in specs})
    (d / "config.json").write_text(json.dumps(hf_config(hp, tied)))
    if hp.arch == "llama":
        write_sp_model(d / "tokenizer.model", make_tiny_sp_vocab(hp.n_vocab))
    else:
        write_tokenizer_json(d / "tokenizer.json", make_tiny_vocab(hp.n_vocab))
    written = [(name, shape) for name, shape, _, _ in specs]
    write_safetensors(d / "model.safetensors", written, draw, dtype)
    return written


def write_peft_adapter(d: str | Path, targets: dict[str, tuple[int, int]], r: int = 8,
                       alpha: int = 16, seed: int = 0, draw=None, dtype: str = "BF16") -> None:
    """A PEFT LoRA directory: adapter_config.json and
    adapter_model.safetensors with lora_A (r, in) and lora_B (out, r) for
    each base weight name of `targets` ({name: (out, in)}), under PEFT's
    names (base_model.model.<name without .weight>.lora_A.weight); values
    from draw(name, shape) (default numpy_draw(seed), spread 1/sqrt(in))."""
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    specs = []
    for name, (out, cols) in targets.items():
        p = "base_model.model." + name.removesuffix(".weight")
        specs += [(f"{p}.lora_A.weight", (r, cols)), (f"{p}.lora_B.weight", (out, r))]
    modules = sorted({name.removesuffix(".weight").rsplit(".", 1)[1] for name in targets})
    (d / "adapter_config.json").write_text(json.dumps(
        {"peft_type": "LORA", "r": r, "lora_alpha": alpha, "target_modules": modules,
         "lora_dropout": 0.0, "bias": "none", "task_type": "CAUSAL_LM"}))
    write_safetensors(d / "adapter_model.safetensors", specs, draw or numpy_draw(seed, {}), dtype)
