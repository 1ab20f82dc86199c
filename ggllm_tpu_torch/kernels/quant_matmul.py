"""Fused dequant x matmul (y = x @ W^T from the planes of a QuantTensor) and
per-group sums of x, each a hand-written CUDA kernel (csrc/quant_matmul.cu,
csrc/quant_gemv_legacy.cu, csrc/quant_gemv_kq.cu, csrc/quant_gemm_tc.cuh) with
its plain PyTorch version beside it.

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

Four kernels serve a CUDA tensor (`route`): one row of x runs a GEMV
(`gemv_kernel`), csrc/quant_gemv_kq.cu for Q2_K-Q6_K and
csrc/quant_gemv_legacy.cu for Q4_0-Q8_0, one kernel loop (csrc/gemv.cuh) over
each family's traits (`gemv_lane_table` and `gemv_emulated` state its lanes
and sums for the CPU tests); more rows of bf16 x run the tensor-core tile
(csrc/quant_gemm_tc.cuh: `wgmma` on weights decoded into registers,
w = q s - c by one f32 FMA, rounded once to bf16, no group sums); more rows
of f32 x run the f32 SIMT tile fed by group_sums, which keeps the correction
form above and f32 accuracy. `tc_fragment_table` states the tile's
per-thread decode as a table the CPU tests can check.

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
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


TC_ROWS = (16, 64, 128, 256)  # x rows per block the tensor-core tile is built for
TC_BLOCK_O = 128               # W rows per block (two warpgroups of 64)
N_SM = 132


def route(S: int, x_dtype, gtype) -> str:
    """The kernel that serves S rows of x in `x_dtype` on the card: "gemv"
    (S == 1), "tc" (bf16, S > 1: tensor cores), "simt" (f32, S > 1: the f32
    tile with group sums). Raises for what no kernel takes."""
    if gtype not in KERNEL_FORMATS:
        raise NotImplementedError(f"quant_matmul kernel: no {GGMLType(gtype).name} variant")
    if x_dtype not in _DTYPES:
        raise TypeError(f"x dtype {x_dtype} not supported (bfloat16, float32)")
    if S < 1:
        raise ValueError(f"quant_matmul: {S} rows")
    if S == 1:
        return "gemv"
    return "tc" if x_dtype == torch.bfloat16 else "simt"


def gemv_kernel(gtype) -> str:
    """The GEMV that serves one row of x in `gtype`: "kq" (the K-quants:
    csrc/quant_gemv_kq.cu) or "legacy" (Q4_0 ... Q8_0:
    csrc/quant_gemv_legacy.cu); fixed by the format."""
    return "kq" if gtype in K_QUANTS else "legacy"


def tc_rows(S: int, O: int) -> int:
    """x rows per block of the tensor-core tile: the narrowest width that
    holds a short S; from 129 rows the 256-wide tile (each weight decoded once
    per 256 rows, one block an SM) unless its blocks need more rounds over
    the card's SMs than 1.4 times those of the 128-wide tile, which pads S
    less, fits two blocks an SM, and takes 0.7 of the time per block (as
    measured on an H100: a Falcon-40B wqkv at S = 300 is 144 blocks of 256
    rows, two rounds, or 216 of 128, one)."""
    for nt in TC_ROWS[:3]:
        if S <= nt:
            return nt
    row_blocks = -(-O // TC_BLOCK_O)
    rounds256 = -(-row_blocks * -(-S // 256) // N_SM)
    rounds128 = -(-row_blocks * -(-S // 128) // (2 * N_SM))
    return 256 if rounds256 <= 1.4 * rounds128 else 128


def tc_fragment_table(gtype, K: int) -> dict:
    """The tensor-core tile's decode as a table over the elements k of a row
    (the index arithmetic of csrc/quant_gemm_tc.cuh, by 32-group gi, lane
    t = lane % 4 and slot e; slot e of lane t is element 2t + (e & 1) +
    8 (e >> 1) of the group): for each k, the byte of the code plane it reads
    (an offset into the row's plane bytes), the shift and mask that cut its
    code out, the same for the high-bit plane (with the left shift that puts
    the bits in place) and its scale group. Returns {"k", "plane", "byte",
    "shift", "mask", "hplane", "hbyte", "hshift", "hmask", "hlshift",
    "group", "group_width", "signed"}; arrays are ordered by (gi, t, e)."""
    if gtype not in KERNEL_FORMATS:
        raise NotImplementedError(f"no tensor-core decode for {GGMLType(gtype).name}")
    gi, t, e = np.meshgrid(np.arange(K // 32), np.arange(4), np.arange(8), indexing="ij")
    gi, t, e = gi.ravel(), t.ravel(), e.ravel()
    i = 2 * t + (e & 1) + 8 * (e >> 1)  # element of the group
    run = 2 * t + (e & 1) + 8 * ((e >> 1) & 1) + 16 * (e >> 2)  # ld_run32: the byte of a 32-byte run it holds
    sb, sub, half, strip = gi >> 3, gi & 7, (gi >> 2) & 1, gi & 3
    zero = np.zeros_like(gi)
    tab = {"k": 32 * gi + i, "plane": "qs", "hplane": None, "hbyte": zero, "hshift": zero,
           "hmask": 0, "hlshift": 0, "group_width": KERNEL_FORMATS[gtype][0],
           "signed": gtype == GGMLType.Q8_0}
    if gtype in (GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1):
        tab.update(byte=gi * 16 + 2 * t + (e & 1) + 8 * ((e >> 1) & 1), shift=4 * (e >> 2), mask=15,
                   group=gi)
        if gtype in (GGMLType.Q5_0, GGMLType.Q5_1):  # bit i of the block's little-endian u32
            tab.update(hplane="qh", hbyte=gi * 4 + (i >> 3), hshift=i & 7, hmask=1, hlshift=4)
    elif gtype == GGMLType.Q8_0:
        tab.update(byte=gi * 32 + run, shift=zero, mask=255, group=gi)
    elif gtype in (GGMLType.Q4_K, GGMLType.Q5_K):
        tab.update(byte=sb * 128 + (sub >> 1) * 32 + run, shift=4 * (gi & 1), mask=15, group=gi)
        if gtype == GGMLType.Q5_K:
            tab.update(hplane="qh", hbyte=sb * 32 + run, hshift=sub, hmask=1, hlshift=4)
    elif gtype == GGMLType.Q6_K:
        tab.update(plane="ql", byte=sb * 128 + half * 64 + (strip & 1) * 32 + run,
                   shift=4 * (strip >> 1), mask=15, hplane="qh", hbyte=sb * 64 + half * 32 + run,
                   hshift=2 * strip, hmask=3, hlshift=4, group=2 * gi + (e >> 2))
    else:  # Q2_K, Q3_K
        tab.update(byte=sb * 64 + half * 32 + run, shift=2 * strip, mask=3,
                   group=2 * gi + (e >> 2))
        if gtype == GGMLType.Q3_K:
            tab.update(hplane="hmask", hbyte=sb * 32 + run, hshift=sub, hmask=1, hlshift=2)
    return tab


def tc_group_scales(w) -> tuple[torch.Tensor, torch.Tensor]:
    """(s, c), each (O, K / group width) f32: every scale group's scale and
    correction as the tensor-core tile forms them (w = q * s - c)."""
    p, f32 = w.planes, torch.float32
    d = p["d"].to(f32)
    g = w.gtype
    if g in (GGMLType.Q4_0, GGMLType.Q5_0):
        return d, d * (8.0 if g == GGMLType.Q4_0 else 16.0)
    if g in (GGMLType.Q4_1, GGMLType.Q5_1):
        return d, -p["m"].to(f32)
    if g == GGMLType.Q8_0:
        return d, torch.zeros_like(d)
    O = d.shape[0]
    if g in (GGMLType.Q4_K, GGMLType.Q5_K):
        s = d[..., None] * p["sc"].to(f32)
        c = p["dmin"].to(f32)[..., None] * p["scm"].to(f32)
    elif g == GGMLType.Q2_K:
        s = d[..., None] * (p["scb"] & 0xF).to(f32)
        c = p["dmin"].to(f32)[..., None] * (p["scb"] >> 4).to(f32)
    else:  # Q3_K, Q6_K
        s = d[..., None] * p["sc"].to(f32)
        c = s * (4.0 if g == GGMLType.Q3_K else 32.0)
    return s.reshape(O, -1), c.reshape(O, -1)


def tc_dequant_emulated(w, kernel_arithmetic: bool = False) -> torch.Tensor:
    """(O, K) bf16: W as the tensor-core tile's threads decode it, gathered
    through tc_fragment_table: code from the plane bytes, w = q * s - c in
    f32, rounded once to bf16. With `kernel_arithmetic` the value is formed as
    the kernel forms it, fma(1 + q / 128, 128 s, -(c + 128 s)) with c + 128 s
    rounded to f32 (Q8_0: (q + 128 - 128) * d, which is exact): at most
    2^-17 |s| from q * s - c before the rounding to bf16."""
    O, K = w.shape
    tab = tc_fragment_table(w.gtype, K)

    def bytes_of(name):
        return w.planes[name].contiguous().view(torch.uint8).reshape(O, -1).to(torch.int64)

    def idx(a):
        return torch.as_tensor(np.broadcast_to(a, tab["k"].shape).copy(), dtype=torch.int64)

    q = (bytes_of(tab["plane"])[:, idx(tab["byte"])] >> idx(tab["shift"])) & tab["mask"]
    if tab["hplane"] is not None:
        hb = (bytes_of(tab["hplane"])[:, idx(tab["hbyte"])] >> idx(tab["hshift"])) & tab["hmask"]
        q = q | (hb << tab["hlshift"])
    if tab["signed"]:
        q = torch.where(q >= 128, q - 256, q)
    s, c = tc_group_scales(w)
    group = idx(tab["group"])
    if kernel_arithmetic and not tab["signed"]:
        s128 = 128.0 * s
        c128 = (c + s128).to(torch.float64)[:, group]  # c + 128 s, rounded to f32
        # the FMA is exact before its one rounding: float64 holds the 8-bit by
        # 24-bit product and the difference
        vals = ((1.0 + q.to(torch.float64) / 128.0) * s128.to(torch.float64)[:, group]
                - c128).to(torch.float32)
    else:
        vals = q.to(torch.float32) * s[:, group] - c[:, group]
    out = torch.empty(O, K, dtype=torch.float32)
    out[:, idx(tab["k"])] = vals
    return out.to(torch.bfloat16)


class GemvLayout(NamedTuple):
    """How the decode GEMVs' lanes cut a row of one format (csrc/gemv.cuh)."""

    lanes: int   # lanes that share a block, each loading 16 distinct code bytes a step
    qb: int      # code bytes a block
    runs: int    # runs of 16 elements in a lane's 16 bytes (one a nibble, bit pair or byte)
    offset: int  # the integer taken off a code before its product
    qk: int      # elements a block


# the decode GEMVs: the legacy formats' (csrc/quant_gemv_legacy.cu; 32-element
# blocks) and the K-quants' (csrc/quant_gemv_kq.cu; 256-element super-blocks),
# one kernel loop (csrc/gemv.cuh). A warp covers 32 / lanes blocks a step.
# Offsets fold a correction into the code exactly and need no sum of x: Q4_0's
# 8 d, Q5_0's 16 d, Q3_K's 4 s, Q6_K's 32 s, and Q8_0's 128 after its sign bit
# is flipped (a signed byte s becomes s + 128); offset 0 pays c * sum x
GEMV_LAYOUT = {
    GGMLType.Q4_0: GemvLayout(1, 16, 2, 8, 32), GGMLType.Q4_1: GemvLayout(1, 16, 2, 0, 32),
    GGMLType.Q5_0: GemvLayout(1, 16, 2, 16, 32), GGMLType.Q5_1: GemvLayout(1, 16, 2, 0, 32),
    GGMLType.Q8_0: GemvLayout(2, 32, 1, 128, 32),
    GGMLType.Q2_K: GemvLayout(4, 64, 4, 0, 256), GGMLType.Q3_K: GemvLayout(4, 64, 4, 4, 256),
    GGMLType.Q4_K: GemvLayout(8, 128, 2, 0, 256), GGMLType.Q5_K: GemvLayout(8, 128, 2, 0, 256),
    GGMLType.Q6_K: GemvLayout(8, 128, 2, 32, 256)}
LEGACY = (GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_0)
# W rows a warp walks at once (the kernels are built for 1 and 2), as measured on
# an H100 (PERF.md): two rows share x's loads, conversion and sums, which pays
# where the lane's work is mostly instructions; Q8_0 and Q6_K, the most bytes a
# weight, and Q5_1, whose two rows need more registers than the rest, keep
# more loads in flight with one
GEMV_ROWS = {GGMLType.Q4_0: 2, GGMLType.Q4_1: 2, GGMLType.Q5_0: 2, GGMLType.Q5_1: 1,
             GGMLType.Q8_0: 1, GGMLType.Q2_K: 2, GGMLType.Q3_K: 2, GGMLType.Q4_K: 2,
             GGMLType.Q5_K: 2, GGMLType.Q6_K: 1}
MAGIC = 0x4B000000  # the bits of 2^23: OR a code below 2^23 into it, subtract 2^23


def gemv_lane_table(gtype, K: int) -> dict:
    """The decode GEMVs' index arithmetic (csrc/gemv.cuh with the format
    traits of csrc/quant_gemv_legacy.cu and csrc/quant_gemv_kq.cu) as arrays
    over (step, lane, byte, slot): lane l of a warp takes block
    sb = step * (32 / lanes) + l // lanes of its row (a 32-element block of a
    legacy format, a 256-element super-block of a K-quant) and code bytes
    [16 p, 16 p + 16) of it, p = l % lanes; byte i holds one code per slot,
    and slot u of the lane's 16 bytes is one run of 16 elements in one scale
    group. For each entry: "sb", the element "k" of the row, "group" (its
    scale group: 32 wide for the legacy formats, Q4_K and Q5_K, else 16) and
    "scale" (the index into the row's scale plane that the kernel reads: d
    for the legacy formats, the sub-scales for the K-quants), "byte" (offset
    into the row's code plane, qs or Q6_K's ql), "shift" / "mask" of the code
    in it, the high-bit plane's "hbyte", "hshift", "hmask" and "hlshift" (the
    left shift that puts the bits in place; Q5_0 / Q5_1: bit 16 u + i of the
    block's little-endian u32 qh), and "valid" (False past the last block).
    Also "plane", "hplane", "offset" (taken off every code), "signed" (Q8_0:
    the byte's sign bit is flipped before the offset of 128 comes off),
    "corr" (the group pays c * sum x), "group_width" and "qk"."""
    if gtype not in GEMV_LAYOUT:
        raise NotImplementedError(f"no decode GEMV for {GGMLType(gtype).name}")
    lanes, qb, nrun, offset, qk = GEMV_LAYOUT[gtype]
    if K % qk:
        raise ValueError(f"{GGMLType(gtype).name}: K={K} is not whole {qk}-element blocks")
    nb, bps = K // qk, 32 // lanes
    steps = -(-nb // bps)
    t, l, i, u = np.meshgrid(np.arange(steps), np.arange(32), np.arange(16), np.arange(nrun),
                             indexing="ij")
    sb, p = t * bps + l // lanes, l % lanes
    zero = np.zeros_like(t)
    tab = {"plane": "qs", "hplane": None, "hbyte": zero, "hshift": zero, "hmask": 0,
           "hlshift": 0, "offset": offset, "corr": offset == 0, "signed": gtype == GGMLType.Q8_0,
           "group_width": 16 if gtype in (GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q6_K) else 32,
           "qk": qk, "sb": sb, "byte": sb * qb + 16 * p + i, "valid": sb < nb}
    if gtype == GGMLType.Q8_0:  # two lanes a block, 16 signed bytes each
        tab.update(k=sb * 32 + 16 * p + i, shift=zero, mask=255, scale=sb)
    elif gtype in LEGACY:  # byte i: element i (low nibble, run 0) and 16 + i (high, run 1)
        tab.update(k=sb * 32 + 16 * u + i, shift=4 * u, mask=15, scale=sb)
        if gtype in (GGMLType.Q5_0, GGMLType.Q5_1):  # qh bit 16 u + i
            bit = 16 * u + i
            tab.update(hplane="qh", hbyte=sb * 4 + (bit >> 3), hshift=bit & 7, hmask=1, hlshift=4)
    elif gtype in (GGMLType.Q4_K, GGMLType.Q5_K):  # chunk j's byte b0 + i: element 64j + 32u + b0 + i
        j, b0 = p >> 1, 16 * (p & 1)
        tab.update(k=sb * 256 + 64 * j + 32 * u + b0 + i, shift=4 * u, mask=15,
                   scale=sb * 8 + 2 * j + u)
        if gtype == GGMLType.Q5_K:  # qh byte b0 + i, bit 2j + u
            tab.update(hplane="qh", hbyte=sb * 32 + b0 + i, hshift=2 * j + u, hmask=1, hlshift=4)
    elif gtype == GGMLType.Q6_K:  # half's strip part + 2u (low / high nibble)
        half, part, i0 = p >> 2, (p >> 1) & 1, 16 * (p & 1)
        strip = part + 2 * u
        tab.update(plane="ql", k=sb * 256 + 128 * half + 32 * strip + i0 + i, shift=4 * u,
                   mask=15, scale=sb * 16 + 8 * half + 2 * strip + (i0 >> 4), hplane="qh",
                   hbyte=sb * 64 + 32 * half + i0 + i, hshift=2 * strip, hmask=3, hlshift=4)
    else:  # Q2_K, Q3_K: the half's strip u, bits 2u of the byte
        half, i0 = p >> 1, 16 * (p & 1)
        tab.update(k=sb * 256 + 128 * half + 32 * u + i0 + i, shift=2 * u, mask=3,
                   scale=sb * 16 + 8 * half + 2 * u + (i0 >> 4))
        if gtype == GGMLType.Q3_K:  # hmask byte i0 + i, bit 4 half + u
            tab.update(hplane="hmask", hbyte=sb * 32 + i0 + i, hshift=4 * half + u, hmask=1,
                       hlshift=2)
    tab["group"] = tab["k"] // tab["group_width"]
    for key in ("k", "byte", "hbyte", "scale", "group", "shift", "hshift"):
        tab[key] = np.where(tab["valid"], tab[key], 0)  # past the last block: unused
    return tab


def _gemv_codes(w, tab) -> torch.Tensor:
    """(O, steps, 32, 16, runs) int64 codes of W gathered as the table says
    (Q8_0: the raw bytes, 0-255)."""
    O = w.shape[0]

    def bytes_of(name, index):
        b = w.planes[name].contiguous().view(torch.uint8).reshape(O, -1).to(torch.int64)
        return b[:, torch.as_tensor(index, dtype=torch.int64)]

    q = (bytes_of(tab["plane"], tab["byte"]) >> torch.as_tensor(tab["shift"])) & tab["mask"]
    if tab["hplane"] is not None:
        hb = bytes_of(tab["hplane"], tab["hbyte"]) >> torch.as_tensor(tab["hshift"])
        q = q | ((hb & tab["hmask"]) << tab["hlshift"])
    return q


def _magic_f32(q: torch.Tensor, offset: int) -> torch.Tensor:
    """q (< 2^23, integer) as f32 the kernel's way, without a conversion:
    the bits of 2^23 + q, less 2^23 + offset (both steps exact)."""
    return (q.to(torch.int32) | MAGIC).view(torch.float32) - float(2 ** 23 + offset)


def _gemv_decode(w, tab) -> torch.Tensor:
    """The table's codes as the kernel decodes them: code - offset in f32,
    Q8_0's byte with its sign bit flipped first."""
    q = _gemv_codes(w, tab)
    return _magic_f32(q ^ 0x80 if tab["signed"] else q, tab["offset"])


def gemv_dequant_emulated(w) -> torch.Tensor:
    """(O, K) f32: W as the decode GEMV decodes it through gemv_lane_table,
    s * (q - offset) - c in f32 (the plain dequantize's arithmetic)."""
    O, K = w.shape
    tab = gemv_lane_table(w.gtype, K)
    s, c = tc_group_scales(w)
    scale = torch.as_tensor(tab["scale"])
    vals = _gemv_decode(w, tab) * s[:, scale]
    if tab["corr"]:
        vals = vals - c[:, scale]
    valid = torch.as_tensor(tab["valid"])
    out = torch.zeros(O, K, dtype=torch.float32)
    out[:, torch.as_tensor(tab["k"])[valid]] = vals[:, valid]
    return out


def gemv_emulated(w, x: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """y (1, O) = x (1, K) @ W^T computed as the decode GEMV computes it, in
    f32 through gemv_lane_table: each lane's codes as 2^23-decoded floats,
    its run of 16 summed as q x (and x, where the format pays a correction),
    then acc += s * dot - c * sum x per run, over the lane's steps; the 32
    lanes' sums combined by the kernel's butterfly (xor 16, 8, 4, 2, 1)."""
    O, K = w.shape
    tab = gemv_lane_table(w.gtype, K)
    xf = x.reshape(-1, K).to(torch.float32)
    if xf.shape[0] != 1:
        raise ValueError(f"the GEMV takes one row of x, not {xf.shape[0]}")
    valid = torch.as_tensor(tab["valid"])[:, :, 0, 0]  # (steps, 32)
    xv = xf[0, torch.as_tensor(tab["k"])]  # (steps, 32, 16, runs)
    f = _gemv_decode(w, tab)  # (O, steps, 32, 16, runs)
    dot = (f * xv).sum(dim=3)  # (O, steps, 32, runs)
    s, c = tc_group_scales(w)
    scale = torch.as_tensor(tab["scale"])[:, :, 0, :]  # (steps, 32, runs)
    term = s[:, scale] * dot
    if tab["corr"]:
        term = term - c[:, scale] * xv.sum(dim=2)
    term = torch.where(valid[None, :, :, None], term, torch.zeros(()))
    acc = torch.zeros(O, 32, dtype=torch.float32)
    for step in range(term.shape[1]):
        for u in range(term.shape[3]):
            acc = acc + term[:, step, :, u]
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lane ^ off]
    return acc[:, 0].reshape(1, O).to(out_dtype)


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

    S = 1 (decode) runs a GEMV, which forms its own sums of x: the K-quant
    GEMV for the K-quants (counted as "quant_matmul.gemv.kq"), the legacy
    GEMV for the others ("quant_matmul.gemv"); S > 1 rows of bf16 x run the
    tensor-core tile; S > 1 rows of f32 x the f32 tile fed by group_sums
    (S >= 256) or the plain reduce (S < 256). See `route`."""
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
    fmt_counter = f"quant_matmul.{w.gtype.name.lower()}"
    y = torch.empty(S, O, dtype=out_dtype, device=x2.device)
    path = route(S, x2.dtype, w.gtype)
    if path == "tc":
        build.launch("gq_quant_matmul_tc", ("quant_matmul", fmt_counter, "quant_matmul.tc"),
                     int(w.gtype), x2.data_ptr(), *ptrs, y.data_ptr(),
                     int(out_dtype == torch.float32), S, K, O, tc_rows(S, O),
                     build.stream_ptr(x2.device))
        return y.reshape(*lead, O)
    if path == "gemv":  # the GEMVs form their own sums of x
        kq = gemv_kernel(w.gtype) == "kq"
        build.launch("gq_quant_gemv_kq" if kq else "gq_quant_gemv_legacy",
                     ("quant_matmul", fmt_counter, "quant_matmul.gemv" + (".kq" if kq else "")),
                     int(w.gtype), x2.data_ptr(), int(x2.dtype == torch.bfloat16), *ptrs,
                     y.data_ptr(), int(out_dtype == torch.bfloat16), K, O, GEMV_ROWS[w.gtype],
                     build.stream_ptr(x2.device))
        return y.reshape(*lead, O)
    if not corr:
        xg = None
    elif S < GROUP_SUMS_MIN_S:
        xg = group_sums_plain(x2, group)
    else:
        xg = group_sums(x2, group)
    build.launch("gq_quant_matmul", ("quant_matmul", fmt_counter, f"quant_matmul.{path}"),
                 int(w.gtype), x2.data_ptr(),
                 int(x2.dtype == torch.bfloat16), *ptrs,
                 None if xg is None else xg.data_ptr(), y.data_ptr(),
                 int(out_dtype == torch.bfloat16), S, K, O,
                 build.stream_ptr(x2.device))
    return y.reshape(*lead, O)
