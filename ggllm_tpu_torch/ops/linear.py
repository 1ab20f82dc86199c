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
from ggllm_tpu_torch.quant.planar import PLANES


class QuantTensor(nn.Module):
    """Quantized 2-D weight (out, in) as a dict of named planar buffers
    (quant/planar.py PLANES gives each format's names, dtypes and shapes;
    d / m / dmin are float16)."""

    def __init__(self, gtype: GGMLType, shape: tuple, planes: dict):
        super().__init__()
        if gtype not in PLANES:
            raise NotImplementedError(f"QuantTensor: {GGMLType(gtype).name} is not ported")
        self.gtype = GGMLType(gtype)
        self.shape = tuple(shape)
        if set(planes) != set(PLANES[self.gtype]):
            raise ValueError(f"{self.gtype.name} planes {sorted(planes)}, "
                             f"expected {sorted(PLANES[self.gtype])}")
        for name in PLANES[self.gtype]:
            p = planes[name]
            if name in ("d", "m", "dmin") and p.dtype != torch.float16:
                raise TypeError(f"{self.gtype.name} plane {name} must be float16, not {p.dtype}")
            self.register_buffer(name, p.contiguous())

    @property
    def planes(self) -> dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in PLANES[self.gtype]}

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return dequant(self.gtype, self.planes, self.shape, dtype)


def _nib(qs: torch.Tensor) -> torch.Tensor:
    """(..., nbytes) packed nibbles -> (..., 2*nbytes) in ggml half-split order."""
    return torch.cat([qs & 0xF, qs >> 4], dim=-1)


def _bits(v: torch.Tensor, n: int) -> torch.Tensor:
    """(...,) int -> (..., n) bits 0..n-1 as uint8."""
    shifts = torch.arange(n, dtype=v.dtype, device=v.device)
    return ((v[..., None] >> shifts) & 1).to(torch.uint8)


def dequant(gtype: GGMLType, p: dict, shape: tuple, dtype=torch.float32) -> torch.Tensor:
    """Plain dequantize from planes to a dense (out, in) tensor; f32
    arithmetic in the order of ggllm_tpu/ops/linear.py dequant_jnp:67, so
    the f32 result is bit-identical to it."""
    out, cols = shape
    f32 = torch.float32

    def f(name):  # a scale plane broadcast over its group's elements
        return p[name].to(f32)[..., None]

    if gtype == GGMLType.Q4_0:
        w = (_nib(p["qs"]).to(f32) - 8.0) * f("d")  # (out, nb, 32)
    elif gtype == GGMLType.Q4_1:
        w = _nib(p["qs"]).to(f32) * f("d") + f("m")
    elif gtype in (GGMLType.Q5_0, GGMLType.Q5_1):
        q = (_nib(p["qs"]) | (_bits(p["qh"], 32) << 4)).to(f32)
        w = (q - 16.0) * f("d") if gtype == GGMLType.Q5_0 else q * f("d") + f("m")
    elif gtype == GGMLType.Q8_0:
        w = p["qs"].to(f32) * f("d")
    elif gtype in (GGMLType.Q2_K, GGMLType.Q3_K):
        # per 128-half, strip j (32 elements) is bits 2j of the half's 32 bytes
        shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8, device=p["qs"].device)[:, None]
        two = (p["qs"].reshape(out, -1, 2, 1, 32) >> shifts & 3).reshape(out, -1, 16, 16).to(f32)
        if gtype == GGMLType.Q2_K:
            dl = f("d") * (p["scb"] & 0xF).to(f32)  # (out, nb, 16)
            ml = f("dmin") * (p["scb"] >> 4).to(f32)
            w = two * dl[..., None] - ml[..., None]
        else:
            # the high bit of element 32m + i is bit m of hmask byte i
            hbits = torch.arange(8, dtype=torch.uint8, device=two.device)[:, None]
            hm = (p["hmask"][..., None, :] >> hbits & 1).reshape(out, -1, 16, 16).to(f32)
            q = two + 4.0 * hm - 4.0
            dl = f("d") * p["sc"].to(f32)
            w = q * dl[..., None]
    elif gtype in (GGMLType.Q4_K, GGMLType.Q5_K):
        qs = p["qs"].reshape(out, -1, 4, 32)  # 4 chunks of 64 elements
        lo, hi = qs & 0xF, qs >> 4
        if gtype == GGMLType.Q5_K:
            # chunk j takes qh bit 2j (low 32 elements) and 2j+1 (high 32)
            hb = _bits(p["qh"], 8).permute(0, 1, 3, 2)  # (out, nb, 8, 32)
            lo, hi = lo | (hb[:, :, 0::2] << 4), hi | (hb[:, :, 1::2] << 4)
        q = torch.cat([lo, hi], dim=-1).reshape(out, -1, 8, 32).to(f32)
        dl = f("d") * p["sc"].to(f32)  # (out, nb, 8)
        ml = f("dmin") * p["scm"].to(f32)
        w = q * dl[..., None] - ml[..., None]
    elif gtype == GGMLType.Q6_K:
        ql = p["ql"].reshape(out, -1, 2, 2, 32)  # (out, nb, half, lo/hi byte strip, 32)
        h = p["qh"].reshape(out, -1, 2, 1, 32) >> torch.tensor(
            [0, 2, 4, 6], dtype=torch.uint8, device=ql.device)[:, None] & 3  # (out, nb, 2, 4, 32)
        # strips within a 128-half: q1=lo&0xF|h0, q2=hi&0xF|h1, q3=lo>>4|h2, q4=hi>>4|h3
        low = torch.stack([ql[..., 0, :] & 0xF, ql[..., 1, :] & 0xF,
                           ql[..., 0, :] >> 4, ql[..., 1, :] >> 4], dim=-2)
        q = (low | (h << 4)).reshape(out, -1, 16, 16).to(f32)
        dl = f("d") * p["sc"].to(f32)  # (out, nb, 16)
        w = (q - 32.0) * dl[..., None]
    else:
        raise NotImplementedError(f"dequant: {GGMLType(gtype).name}")
    return w.reshape(out, cols).to(dtype)


def linear(w, x: torch.Tensor, out_dtype=None, kernels: bool = True) -> torch.Tensor:
    """y = x @ W^T with f32 accumulation. W shape (out, in); x (..., in).

    A dense W is multiplied in the operands' dtype, promoted as JAX promotes
    them (ggllm_tpu/ops/linear.py:154-160): the loader holds dense weights
    in the compute dtype, so bf16 x bf16 runs as one bf16 product (the card
    accumulates in f32) and the weight is never copied. Where the result is
    asked for in f32 from 16-bit operands (the logits), the f32 accumulator
    is kept: on the card by the product's f32 output, on the CPU in f32."""
    out_dtype = out_dtype if out_dtype is not None else x.dtype
    if isinstance(w, QuantTensor):
        fn = qm.quant_matmul if kernels else qm.quant_matmul_plain
        return fn(w, x, out_dtype)
    ct = torch.promote_types(x.dtype, w.dtype)
    x, w = x.to(ct), w.to(ct)  # no-ops for the loader's weights
    if ct == torch.float32 or out_dtype != torch.float32:
        return torch.matmul(x, w.t()).to(out_dtype)
    if x.is_cuda:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[0])
    return torch.matmul(x.float(), w.float().t())
