"""Fused dequant x matmul (y = x @ W^T from the planes of a QuantTensor) and
per-group sums of x, each a hand-written CUDA kernel (csrc/quant_matmul.cu)
with its plain PyTorch version beside it.

Replaces the Pallas kernels ggllm_tpu/kernels/quant_matmul.py `_kern`
(launched by fused_matmul_2d) and `_xg_kern` (launched by _group_sums), for
all ten block formats (Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, Q2_K, Q3_K, Q4_K, Q5_K,
Q6_K). Both keep the TPU kernel's correction form: with w = s_g * q - c_g in
each scale group g,
  y = sum_g s_g * (sum_{j in g} q_j x_j)  -  sum_g c_g * xg_g,
  xg_g = sum_{j in g} x_j,
so the inner loop is an unsigned-code dot and each group pays one scale
multiply and one correction. Per family:
  legacy (32-groups)   s = d;      c = 8d (Q4_0), 16d (Q5_0), -m (Q4_1, Q5_1), none (Q8_0)
  K-quants (32-groups) s = d * sc; c = dmin * scm (Q4_K, Q5_K)
  Q6_K (16-groups)     s = d * sc; c = 32 * s
  Q3_K (16-groups)     s = d * sc; c = 4 * s  (code = two | hmask bit << 2, sc signed)
  Q2_K (16-groups)     s = d * (scb & 15); c = dmin * (scb >> 4)
(the K-quant products formed in f32 exactly as the reference does).

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ggllm_tpu_torch.core.dtypes import GGMLType
from ggllm_tpu_torch.kernels import build

# prefill rows from which the group sums run as their own kernel (below,
# a plain torch reduce, as the JAX package leaves it to XLA below 256 rows)
GROUP_SUMS_MIN_S = 256
_DTYPES = (torch.bfloat16, torch.float32)

# formats the kernel covers -> (scale group width, has a correction term)
KERNEL_FORMATS = {
    GGMLType.Q4_0: (32, True),
    GGMLType.Q4_1: (32, True),
    GGMLType.Q5_0: (32, True),
    GGMLType.Q5_1: (32, True),
    GGMLType.Q8_0: (32, False),
    GGMLType.Q2_K: (16, True),
    GGMLType.Q3_K: (16, True),
    GGMLType.Q4_K: (32, True),
    GGMLType.Q5_K: (32, True),
    GGMLType.Q6_K: (16, True),
}
K_QUANTS = (GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K)
# the kernel's plane arguments, in order; per format the plane passed there
_ARGS = ("qs", "qh", "d", "m", "sc", "scm")
_ARG_PLANE = {GGMLType.Q6_K: {"qs": "ql"}, GGMLType.Q4_K: {"m": "dmin"},
              GGMLType.Q5_K: {"m": "dmin"}, GGMLType.Q2_K: {"m": "dmin", "sc": "scb"},
              GGMLType.Q3_K: {"qh": "hmask"}}


def quant_matmul_plain(w, x: torch.Tensor, out_dtype) -> torch.Tensor:
    """Plain version: dequantize W to f32, then one f32 matmul."""
    O, K = w.shape
    lead = x.shape[:-1]
    y = torch.matmul(x.reshape(-1, K).to(torch.float32), w.dequantize(torch.float32).t())
    return y.reshape(*lead, O).to(out_dtype)


def group_sums_plain(x2: torch.Tensor, g: int = 32) -> torch.Tensor:
    """(S, K) -> (S, K/g) f32 per-group sums."""
    S, K = x2.shape
    return x2.reshape(S, K // g, g).to(torch.float32).sum(-1)


def _check_x(x2: torch.Tensor, K: int):
    if x2.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x2.dtype} not supported (bfloat16, float32)")
    if x2.shape[-1] != K or K % 32:
        raise ValueError(f"x width {x2.shape[-1]} does not match K={K} (a multiple of 32)")


def _aligned(x2: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned base (the kernels load x rows in
    16-byte vectors)."""
    x2 = x2.contiguous()
    return x2 if x2.data_ptr() % 16 == 0 else x2.clone()


def group_sums(x2: torch.Tensor, g: int = 32) -> torch.Tensor:
    """(S, K) bf16/f32 -> (S, K/g) f32 per-group sums of x, g in {16, 32}."""
    if x2.device.type == "cpu":
        return group_sums_plain(x2, g)
    if g not in (16, 32):
        raise ValueError(f"group_sums kernel: group {g} (16 or 32)")
    S, K = x2.shape
    _check_x(x2, K)
    x2 = _aligned(x2)
    xg = torch.empty(S, K // g, dtype=torch.float32, device=x2.device)
    build.launch("gq_group_sums", "group_sums", x2.data_ptr(),
                 int(x2.dtype == torch.bfloat16), xg.data_ptr(), S, K, g,
                 build.stream_ptr(x2.device))
    return xg


def _plane_ptrs(w, device) -> list:
    """The kernel's six plane pointers (None where the format has no such
    plane), each checked to lie on `device` and be 16-byte aligned."""
    rename = _ARG_PLANE.get(w.gtype, {})
    planes = w.planes
    ptrs = []
    for arg in _ARGS:
        p = planes.get(rename.get(arg, arg))
        if p is None:
            ptrs.append(None)
            continue
        if p.device != device:
            raise ValueError(f"weight on {p.device}, x on {device}")
        if not p.is_contiguous() or p.data_ptr() % 16:
            raise ValueError(f"{w.gtype.name} plane {arg} must be contiguous and 16-byte aligned")
        ptrs.append(p.data_ptr())
    return ptrs


def quant_matmul(w, x: torch.Tensor, out_dtype) -> torch.Tensor:
    """y = x @ W^T for a QuantTensor W; x (..., K) -> (..., O) in out_dtype.

    S = 1 (decode) runs the GEMV variant, which forms its own group sums;
    S > 1 runs the tiled variant fed by group_sums (S >= 256) or the plain
    reduce (S < 256)."""
    if x.device.type == "cpu":
        return quant_matmul_plain(w, x, out_dtype)
    if w.gtype not in KERNEL_FORMATS:
        raise NotImplementedError(f"quant_matmul kernel: no {GGMLType(w.gtype).name} variant")
    if out_dtype not in _DTYPES:
        raise TypeError(f"out dtype {out_dtype} not supported")
    O, K = w.shape
    group, corr = KERNEL_FORMATS[w.gtype]
    if w.gtype in K_QUANTS and K % 256:
        raise ValueError(f"{w.gtype.name}: K={K} is not a multiple of the 256-element super-block")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    _check_x(x2, K)
    ptrs = _plane_ptrs(w, x2.device)
    x2 = _aligned(x2)
    S = x2.shape[0]
    if S == 1 or not corr:  # the GEMV forms its own group sums
        xg = None
    elif S < GROUP_SUMS_MIN_S:
        xg = group_sums_plain(x2, group)
    else:
        xg = group_sums(x2, group)
    y = torch.empty(S, O, dtype=out_dtype, device=x2.device)
    build.launch("gq_quant_matmul", ("quant_matmul", f"quant_matmul.{w.gtype.name.lower()}"),
                 int(w.gtype), x2.data_ptr(),
                 int(x2.dtype == torch.bfloat16), *ptrs,
                 None if xg is None else xg.data_ptr(), y.data_ptr(),
                 int(out_dtype == torch.bfloat16), S, K, O,
                 build.stream_ptr(x2.device))
    return y.reshape(*lead, O)
