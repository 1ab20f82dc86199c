"""Synthetic parameters at real model scale, made on the device (the
counterpart of ggllm_tpu/utils/benchgen.py make_bench_params:151).

Benchmarks need Falcon-7B/40B- or LLaMA-7B-sized quantized weights but no
pretrained values, and the repository holds no weights. This builds the merged
parameter tree (io/loader.py layout) directly on the device from a seeded
generator: random codes, and fp16-exact scales of one magnitude per
format with random signs (the kernels' speed does not depend on the
values), random embeddings. Every layer gets its own buffers, as a real
checkpoint would.

The scales are chosen so that every block's expected weight is about zero.
Uniform codes are not centred (Q4_0's w = (q - 8) * d has mean -d / 2), and
with one positive d for every block (as the JAX package's benchgen does; it
suits timing only) each layer adds the same large offset to every residual
feature, the bf16 residual loses its signal to rounding within a few
layers, and two summation orders of the same model diverge. ggml's
quantizers give real files signed scales (Q4_0, Q5_0, Q8_0, Q6_K's sc) or
mins near the block's low end, so here:
  Q4_0, Q5_0, Q8_0  d = +-scale/8, +-scale/16, +-scale/128
  Q4_1, Q5_1        m = -d * 7.5, -d * 15.5 (the code's mean)
  Q4_K, Q5_K        dmin * scm = d * sc * 7.5 / 15.5 to within rounding
                    (dmin = 8d / 16d, scm = round(sc * 15/16 / 31/32))
  Q6_K              sc = +-(1..63)
  Q3_K              sc = +-(1..31): the sign cancels the mean -0.5 of (q - 4)
  Q2_K              d signed, dmin = d, scale nibble 1..10 and min nibble
                    round(1.5 * scale nibble) (the 2-bit code's mean is 1.5)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ggllm_tpu_torch.core.config import FalconHParams, LlamaHParams, named_hparams
from ggllm_tpu_torch.core.device import resolve_device
from ggllm_tpu_torch.core.dtypes import GGMLType, TYPE_TRAITS
from ggllm_tpu_torch.ops.linear import QuantTensor

# elements of one f32 draw of the embedding (2 GiB): Falcon-7B's, 40B's and
# LLaMA-7B's embeddings are one draw; Falcon-180B's (65024 x 14848, 3.9 GB in
# f32) is drawn in two beside the 58 GB of its Q2_K layers
EMB_DRAW = 1 << 29


def random_quant(gtype: GGMLType, out: int, cols: int, gen: torch.Generator, device,
                 scale: float = 0.02) -> QuantTensor:
    """QuantTensor of format gtype with random codes; every format's
    weights have a spread of about 0.58 * scale and a mean near zero."""
    gtype = GGMLType(gtype)
    bs = TYPE_TRAITS[gtype].block_size
    if cols % bs:
        raise ValueError(f"{gtype.name}: width {cols} not divisible by its block of {bs}")
    nb = cols // bs

    def rbytes(*shape):
        return torch.randint(0, 256, (out, nb, *shape), generator=gen, dtype=torch.uint8,
                             device=device)

    def rint(lo, hi, *shape):
        return torch.randint(lo, hi, (out, nb, *shape), generator=gen, device=device)

    def signed(v):  # (out, nb) fp16 of magnitude v with random signs
        return ((rint(0, 2) * 2 - 1) * float(np.float16(v))).to(torch.float16)

    f16 = torch.float16
    if gtype in (GGMLType.Q4_0, GGMLType.Q4_1):
        qs = rbytes(16)  # drawn before d, so a seed gives the same Q4_0 weights as before
        d = signed(scale / 8)
        planes = {"d": d, "qs": qs}
        if gtype == GGMLType.Q4_1:
            planes["m"] = (-7.5 * d.float()).to(f16)
    elif gtype in (GGMLType.Q5_0, GGMLType.Q5_1):
        d = signed(scale / 16)
        planes = {"d": d, "qs": rbytes(16), "qh": rbytes(4).view(torch.int32).reshape(out, nb)}
        if gtype == GGMLType.Q5_1:
            planes["m"] = (-15.5 * d.float()).to(f16)
    elif gtype == GGMLType.Q8_0:
        planes = {"d": signed(scale / 128), "qs": rint(-127, 128, 32).to(torch.int8)}
    elif gtype in (GGMLType.Q4_K, GGMLType.Q5_K):
        q5 = gtype == GGMLType.Q5_K
        d = signed(scale / (16 if q5 else 8) / 32)
        sc = rint(1, 64, 8)
        planes = {"d": d, "dmin": ((16 if q5 else 8) * d.float()).to(f16), "qs": rbytes(128),
                  "sc": sc.to(torch.int8),
                  "scm": torch.round(sc * (31 / 32 if q5 else 15 / 16)).to(torch.int8)}
        if q5:
            planes["qh"] = rbytes(32)
    elif gtype == GGMLType.Q6_K:
        sc = rint(1, 64, 16) * (rint(0, 2, 16) * 2 - 1)
        planes = {"d": torch.full((out, nb), float(np.float16(scale / 32 / 32)), dtype=f16,
                                  device=device),
                  "sc": sc.to(torch.int8), "ql": rbytes(128), "qh": rbytes(64)}
    elif gtype == GGMLType.Q3_K:
        sc = rint(1, 32, 16) * (rint(0, 2, 16) * 2 - 1)
        planes = {"hmask": rbytes(32), "qs": rbytes(64), "sc": sc.to(torch.int8),
                  "d": torch.full((out, nb), float(np.float16(scale / 4 / 18)), dtype=f16,
                                  device=device)}
    elif gtype == GGMLType.Q2_K:
        d = signed(scale / 12)
        lo = rint(1, 11, 16)
        hi = torch.round(lo * 1.5).to(lo.dtype)  # 2..15
        planes = {"scb": (lo | (hi << 4)).to(torch.uint8), "qs": rbytes(64), "d": d,
                  "dmin": d.clone()}
    else:
        raise NotImplementedError(f"random_quant: no planes for {gtype.name}")
    return QuantTensor(gtype, (out, cols), planes)


def bench_hparams(name: str, n_layer: int | None = None) -> FalconHParams | LlamaHParams:
    """named_hparams(name) as the tools build a model (cut to n_layer layers
    where given): a LLaMA at n_rot = head_dim, what llama.cpp's files hold
    (n_embd / n_head: 128 for LLaMA-7B), where the preset keeps the JAX
    package's 64."""
    hp = named_hparams(name)
    if n_layer is not None:
        hp = dataclasses.replace(hp, n_layer=n_layer)
    if hp.arch == "llama":
        hp = dataclasses.replace(hp, n_rot=hp.head_dim)
    return hp


def make_bench_params(hp: FalconHParams | LlamaHParams, compute_dtype=torch.bfloat16,
                      device=None, seed: int = 42, gtype: GGMLType = GGMLType.Q4_0) -> dict:
    """Full Falcon or LLaMA parameter tree (io/loader.py's merged layout) at
    hp's scale with gtype 2-D weights, norms of ones."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    E, H, D, F, V = hp.n_embd, hp.n_head, hp.head_dim, hp.n_ff, hp.n_vocab

    def quant(out, cols):
        return random_quant(gtype, out, cols, gen, device)

    def ones():
        return torch.ones(E, dtype=torch.float32, device=device)

    def zeros():
        return torch.zeros(E, dtype=torch.float32, device=device)

    layers = []
    for _ in range(hp.n_layer):
        if hp.arch == "llama":
            layers.append({"attn_norm": ones(), "ffn_norm": ones(), "wqkv": quant(3 * E, E),
                           "wo": quant(E, E), "w13": quant(2 * F, E), "w2": quant(E, F)})
            continue
        n_qkv = (H + 2 * hp.n_head_kv) * D
        lw = {"input_ln_w": ones(), "input_ln_b": zeros(), "w_od": quant(E, H * D + F)}
        if hp.n_falcon_type >= 40:
            lw.update(attn_ln_w=ones(), attn_ln_b=zeros(), wqkv=quant(n_qkv, E),
                      ffn_up=quant(F, E))
        else:
            lw["wqkvu"] = quant(n_qkv + F, E)
        layers.append(lw)
    # the embedding, drawn in f32 in row chunks of at most EMB_DRAW elements
    # (one draw, as before, wherever V * E fits in one)
    emb = torch.empty(V, E, dtype=compute_dtype, device=device)
    step = max(1, EMB_DRAW // E)
    for r in range(0, V, step):
        n = min(step, V - r)
        emb[r:r + n] = torch.randn(n, E, generator=gen, dtype=torch.float32,
                                   device=device).mul_(0.02)
    params = {"tok_embeddings": emb, "output_norm": ones(),
              "lm_head": quant(V, E), "layers": layers}
    if hp.arch != "llama":
        params["output_norm_b"] = zeros()
    return params
