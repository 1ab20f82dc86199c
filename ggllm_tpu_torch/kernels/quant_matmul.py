"""Fused dequant x matmul (y = x @ W^T from Q4_0 planes) and per-group sums
of x, each a hand-written CUDA kernel (csrc/quant_matmul.cu) with its plain
PyTorch version beside it.

Replaces the Pallas kernels ggllm_tpu/kernels/quant_matmul.py `_kern`
(launched by fused_matmul_2d) and `_xg_kern` (launched by _group_sums).
Both keep the TPU kernel's correction form: the affine part of the Q4_0
dequant (w = (q - 8) * d) never touches the per-element path,
  y = sum_g d_g * (sum_{j in g} q_j x_j  -  8 * xg_g),   xg_g = sum_{j in g} x_j
so the inner loop is an unsigned-nibble dot and each 32-group pays one
scale multiply and one correction.

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ggllm_tpu_torch.core.dtypes import GGMLType
from ggllm_tpu_torch.kernels import build

GROUP = 32
# prefill rows from which the group sums run as their own kernel (below,
# a plain torch reduce, as the JAX package leaves it to XLA below 256 rows)
GROUP_SUMS_MIN_S = 256
_DTYPES = (torch.bfloat16, torch.float32)


def quant_matmul_plain(w, x: torch.Tensor, out_dtype) -> torch.Tensor:
    """Plain version: dequantize W to f32, then one f32 matmul."""
    O, K = w.shape
    lead = x.shape[:-1]
    y = torch.matmul(x.reshape(-1, K).to(torch.float32), w.dequantize(torch.float32).t())
    return y.reshape(*lead, O).to(out_dtype)


def group_sums_plain(x2: torch.Tensor) -> torch.Tensor:
    """(S, K) -> (S, K/32) f32 per-group sums."""
    S, K = x2.shape
    return x2.reshape(S, K // GROUP, GROUP).to(torch.float32).sum(-1)


def _check_x(x2: torch.Tensor, K: int):
    if x2.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x2.dtype} not supported (bfloat16, float32)")
    if x2.shape[-1] != K or K % GROUP:
        raise ValueError(f"x width {x2.shape[-1]} does not match K={K} (a multiple of {GROUP})")


def _aligned(x2: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned base (the kernels load x rows in
    16-byte vectors)."""
    x2 = x2.contiguous()
    return x2 if x2.data_ptr() % 16 == 0 else x2.clone()


def group_sums(x2: torch.Tensor) -> torch.Tensor:
    """(S, K) bf16/f32 -> (S, K/32) f32 per-group sums of x."""
    if x2.device.type == "cpu":
        return group_sums_plain(x2)
    S, K = x2.shape
    _check_x(x2, K)
    x2 = _aligned(x2)
    xg = torch.empty(S, K // GROUP, dtype=torch.float32, device=x2.device)
    build.launch("gq_group_sums", "group_sums", x2.data_ptr(),
                 int(x2.dtype == torch.bfloat16), xg.data_ptr(), S, K,
                 build.stream_ptr(x2.device))
    return xg


def quant_matmul(w, x: torch.Tensor, out_dtype) -> torch.Tensor:
    """y = x @ W^T for a QuantTensor W; x (..., K) -> (..., O) in out_dtype.

    S = 1 (decode) runs the GEMV variant, which forms its own group sums;
    S > 1 runs the tiled variant fed by group_sums (S >= 256) or the plain
    reduce (S < 256)."""
    if x.device.type == "cpu":
        return quant_matmul_plain(w, x, out_dtype)
    if w.gtype != GGMLType.Q4_0:
        raise NotImplementedError(f"quant_matmul kernel: {w.gtype.name} is not ported (Q4_0 only)")
    if out_dtype not in _DTYPES:
        raise TypeError(f"out dtype {out_dtype} not supported")
    O, K = w.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    _check_x(x2, K)
    if w.qs.device != x2.device:
        raise ValueError(f"weight on {w.qs.device}, x on {x2.device}")
    if w.qs.data_ptr() % 16:
        raise ValueError("Q4_0 qs plane must be 16-byte aligned")
    x2 = _aligned(x2)
    S = x2.shape[0]
    if S == 1:
        xg = None
    elif S < GROUP_SUMS_MIN_S:
        xg = group_sums_plain(x2)
    else:
        xg = group_sums(x2)
    y = torch.empty(S, O, dtype=out_dtype, device=x2.device)
    build.launch("gq_q4_0_matmul", "quant_matmul", x2.data_ptr(),
                 int(x2.dtype == torch.bfloat16), w.qs.data_ptr(), w.d.data_ptr(),
                 None if xg is None else xg.data_ptr(), y.data_ptr(),
                 int(out_dtype == torch.bfloat16), S, K, O,
                 build.stream_ptr(x2.device))
    return y.reshape(*lead, O)
