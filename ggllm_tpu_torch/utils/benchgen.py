"""Synthetic parameters at real model scale, made on the device (the
counterpart of ggllm_tpu/utils/benchgen.py make_bench_params:151).

Benchmarks need Falcon-7B-sized Q4_0 weights but no pretrained values, and
the repository holds no weights. This builds the merged parameter tree
(io/loader.py layout) directly on the device from a seeded generator:
random nibble codes and fp16-exact scales of one magnitude with random
signs (the kernels' speed does not depend on the values), random
embeddings. Every layer gets its own buffers, as a real checkpoint would.

The scale signs matter for the numbers: uniform codes have mean 7.5, so
w = (q - 8) * d has mean -d / 2. With one positive d for every block
(as the JAX package's benchgen does; it suits timing only) each layer adds the
same large offset to every residual feature, the bf16 residual loses its
signal to rounding within a few layers, and two summation orders of the
same model diverge. ggml's quantizer sets d = max / -8 with the sign of
the block's largest element, so real Q4_0 scales have random signs too.
"""

from __future__ import annotations

import numpy as np
import torch

from ggllm_tpu_torch.core.config import FalconHParams
from ggllm_tpu_torch.core.device import resolve_device
from ggllm_tpu_torch.core.dtypes import GGMLType
from ggllm_tpu_torch.ops.linear import QuantTensor


def random_q4_0(out: int, cols: int, gen: torch.Generator, device, scale: float = 0.02) -> QuantTensor:
    """Q4_0 QuantTensor with random codes and fp16 scales of +-scale/8."""
    assert cols % 32 == 0, f"width {cols} not divisible by the Q4_0 block of 32"
    nb = cols // 32
    qs = torch.randint(0, 256, (out, nb, 16), generator=gen, dtype=torch.uint8, device=device)
    sign = torch.randint(0, 2, (out, nb), generator=gen, device=device) * 2 - 1
    d = (sign * float(np.float16(scale / 8))).to(torch.float16)
    return QuantTensor(GGMLType.Q4_0, (out, cols), qs, d)


def make_bench_params(hp: FalconHParams, compute_dtype=torch.bfloat16, device=None,
                      seed: int = 42) -> dict:
    """Full Falcon parameter tree at hp's scale with Q4_0 2-D weights."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    E, H, KV, D, F, V = hp.n_embd, hp.n_head, hp.n_head_kv, hp.head_dim, hp.n_ff, hp.n_vocab
    n_qkv = (H + 2 * KV) * D

    def ones():
        return torch.ones(E, dtype=torch.float32, device=device)

    def zeros():
        return torch.zeros(E, dtype=torch.float32, device=device)

    layers = []
    for _ in range(hp.n_layer):
        lw = {"input_ln_w": ones(), "input_ln_b": zeros(),
              "w_od": random_q4_0(E, H * D + F, gen, device)}
        if hp.n_falcon_type >= 40:
            lw.update(attn_ln_w=ones(), attn_ln_b=zeros(),
                      wqkv=random_q4_0(n_qkv, E, gen, device),
                      ffn_up=random_q4_0(F, E, gen, device))
        else:
            lw["wqkvu"] = random_q4_0(n_qkv + F, E, gen, device)
        layers.append(lw)
    emb = torch.randn(V, E, generator=gen, dtype=torch.float32, device=device) * 0.02
    return {
        "tok_embeddings": emb.to(compute_dtype),
        "output_norm": ones(),
        "output_norm_b": zeros(),
        "lm_head": random_q4_0(V, E, gen, device),
        "layers": layers,
    }
