"""Linear op over dense or quantized weights.

`QuantTensor` holds the planar planes of one quantized 2-D weight as torch
buffers on a device (quant/planar.py's layout, which is also the Hopper
kernel layout). `linear` dispatches:

* dense tensor -> torch.matmul with f32 accumulation;
* QuantTensor  -> the fused dequant x matmul kernel (kernels/quant_matmul),
  or, with kernels=False, the plain dequantize-then-matmul version.
"""

from __future__ import annotations

import torch
from torch import nn

from ggllm_tpu_torch.core.dtypes import GGMLType
from ggllm_tpu_torch.kernels import quant_matmul as qm


class QuantTensor(nn.Module):
    """Quantized 2-D weight (out, in) as planar buffers:
    qs (out, nb, 16) uint8 for Q4_0 or (out, nb, 32) int8 for Q8_0,
    d (out, nb) float16."""

    def __init__(self, gtype: GGMLType, shape: tuple, qs: torch.Tensor, d: torch.Tensor):
        super().__init__()
        if gtype not in (GGMLType.Q4_0, GGMLType.Q8_0):
            raise NotImplementedError(f"QuantTensor: {GGMLType(gtype).name} is not ported")
        self.gtype = GGMLType(gtype)
        self.shape = tuple(shape)
        self.register_buffer("qs", qs.contiguous())
        self.register_buffer("d", d.to(torch.float16).contiguous())

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return dequant(self.gtype, self.qs, self.d, self.shape, dtype)


def _nib(qs: torch.Tensor) -> torch.Tensor:
    """(..., nbytes) packed nibbles -> (..., 2*nbytes) in ggml half-split order."""
    return torch.cat([qs & 0xF, qs >> 4], dim=-1)


def dequant(gtype: GGMLType, qs: torch.Tensor, d: torch.Tensor, shape: tuple,
            dtype=torch.float32) -> torch.Tensor:
    """Plain dequantize from planes to a dense (out, in) tensor
    (ggllm_tpu/ops/linear.py dequant_jnp:67 for Q4_0/Q8_0)."""
    out, cols = shape
    if gtype == GGMLType.Q4_0:
        q = _nib(qs).to(torch.float32) - 8.0  # (out, nb, 32)
    elif gtype == GGMLType.Q8_0:
        q = qs.to(torch.float32)
    else:
        raise NotImplementedError(f"dequant: {GGMLType(gtype).name}")
    w = q * d.to(torch.float32)[..., None]
    return w.reshape(out, cols).to(dtype)


def linear(w, x: torch.Tensor, out_dtype=None, kernels: bool = True) -> torch.Tensor:
    """y = x @ W^T with f32 accumulation. W shape (out, in); x (..., in)."""
    out_dtype = out_dtype if out_dtype is not None else x.dtype
    if isinstance(w, QuantTensor):
        fn = qm.quant_matmul if kernels else qm.quant_matmul_plain
        return fn(w, x, out_dtype)
    y = torch.matmul(x.to(torch.float32), w.to(torch.float32).t())
    return y.to(out_dtype)
