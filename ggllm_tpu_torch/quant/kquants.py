"""K-quant super-block codecs (Q2_K..Q6_K, Q8_K; a copy of
ggllm_tpu/quant/kquants.py, which the port does not import, plus
_q3k_pack_scales for quant/planar.py).

Bit-faithful, vectorized numpy re-implementations of the reference scalar
codecs (k_quants.c:50-949). 256-element super-blocks with two-level scale
quantization; byte layouts match k_quants.h:20-83 exactly.

The reference's iterative scale searches (make_qx_quants / make_q3_quants /
make_qkx1_quants) contain data-dependent convergence loops. We vectorize
across blocks (the batch axis) while looping sequentially over the 16/32
elements *within* a group so that float32 accumulation order — and therefore
every rounding decision — matches the C code bit for bit. Convergence
early-exits become per-block "active" masks.
"""

from __future__ import annotations

import numpy as np

QK_K = 256

F32 = np.float32


def _nearest_int(x: np.ndarray) -> np.ndarray:
    """Reference nearest_int (k_quants.c:50-55) == IEEE round-half-to-even."""
    return np.rint(x).astype(np.int32)


def _signed_absmax(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(amax, signed max) per row, first-occurrence tie-break like the C scan."""
    ax = np.abs(x)
    idx = np.argmax(ax, axis=-1)
    rows = np.arange(x.shape[0])
    return ax[rows, idx], x[rows, idx]


def _fp16_round(x: np.ndarray) -> np.ndarray:
    """fp32 -> fp16 -> fp32 round-trip (values are *stored* as fp16)."""
    return x.astype(np.float16).astype(np.float32)


# --------------------------------------------------------------------------
# Scale-search helpers
# --------------------------------------------------------------------------

def make_qx_quants(x: np.ndarray, nmax: int, rmse_type: int = 1):
    """Vectorized make_qx_quants (k_quants.c:57-161) for rmse_type==1.

    x: (B, n) float32. Returns (scale (B,), L (B, n) int in [0, 2*nmax-1]).
    """
    assert rmse_type == 1, "only the weighted-RMSE path used by q6_K is implemented"
    B, n = x.shape
    x = x.astype(F32)
    amax, smax = _signed_absmax(x)
    nonzero = amax != 0

    L = np.zeros((B, n), dtype=np.int32)
    scale = np.zeros(B, dtype=F32)

    with np.errstate(divide="ignore", invalid="ignore"):
        iscale = np.where(nonzero, F32(-nmax) / smax, F32(0)).astype(F32)

    w = (x * x).astype(F32)  # weight_type == 1

    def _clipped(isc):
        l = _nearest_int(isc[:, None] * x)
        return np.clip(l, -nmax, nmax - 1)

    Ls = _clipped(iscale)  # signed levels
    # sequential accumulation over elements to match C summation order
    sumlx = np.zeros(B, dtype=F32)
    suml2 = np.zeros(B, dtype=F32)
    for i in range(n):
        li = Ls[:, i].astype(F32)
        sumlx = (sumlx + w[:, i] * x[:, i] * li).astype(F32)
        suml2 = (suml2 + w[:, i] * li * li).astype(F32)

    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(suml2 != 0, sumlx / suml2, F32(0)).astype(F32)
    best = (scale * sumlx).astype(F32)

    active = nonzero.copy()
    for _ in range(3):
        if not active.any():
            break
        with np.errstate(divide="ignore", invalid="ignore"):
            isc = np.where(scale != 0, F32(1) / scale, F32(0)).astype(F32)
        newL = _clipped(isc)
        changed = (newL != Ls).any(axis=1)
        slx = np.zeros(B, dtype=F32)
        sl2 = np.zeros(B, dtype=F32)
        for i in range(n):
            li = newL[:, i].astype(F32)
            slx = (slx + w[:, i] * x[:, i] * li).astype(F32)
            sl2 = (sl2 + w[:, i] * li * li).astype(F32)
        stop = (~changed) | (sl2 == 0) | (slx * slx <= best * sl2)
        upd = active & ~stop
        Ls = np.where(upd[:, None], newL, Ls)
        sumlx = np.where(upd, slx, sumlx)
        suml2 = np.where(upd, sl2, suml2)
        with np.errstate(divide="ignore", invalid="ignore"):
            new_scale = np.where(sl2 != 0, slx / sl2, F32(0)).astype(F32)
        scale = np.where(upd, new_scale, scale)
        best = np.where(upd, (new_scale * slx).astype(F32), best)
        active = upd

    # greedy per-element refinement (5 sweeps, sequential over elements)
    active = nonzero.copy()
    for _ in range(5):
        if not active.any():
            break
        n_changed = np.zeros(B, dtype=np.int32)
        for i in range(n):
            wi = w[:, i]
            xi = x[:, i]
            li = Ls[:, i].astype(F32)
            slx = (sumlx - wi * xi * li).astype(F32)
            cond = active & (slx > 0)
            sl2 = (suml2 - wi * li * li).astype(F32)
            with np.errstate(divide="ignore", invalid="ignore"):
                cand = _nearest_int(np.where(cond, xi * sl2 / slx, F32(0)))
            cand = np.clip(cand, -nmax, nmax - 1)
            cond &= cand != Ls[:, i]
            cf = cand.astype(F32)
            slx2 = (slx + wi * xi * cf).astype(F32)
            sl22 = (sl2 + wi * cf * cf).astype(F32)
            cond &= (sl22 > 0) & (slx2 * slx2 * suml2 > sumlx * sumlx * sl22)
            Ls[:, i] = np.where(cond, cand, Ls[:, i])
            sumlx = np.where(cond, slx2, sumlx)
            suml2 = np.where(cond, sl22, suml2)
            n_changed += cond.astype(np.int32)
        with np.errstate(divide="ignore", invalid="ignore"):
            scale_upd = np.where(suml2 != 0, sumlx / suml2, F32(0)).astype(F32)
        scale = np.where(active & (n_changed > 0), scale_upd, scale)
        active &= n_changed > 0

    # recompute final scale for blocks that took any greedy step: the C code
    # updates scale inside the accept branch, so scale == sumlx/suml2 whenever
    # any update happened; for blocks with none it's the pre-greedy value.
    L = np.where(nonzero[:, None], Ls + nmax, 0)
    return scale.astype(F32), L


def make_q3_quants(x: np.ndarray, nmax: int):
    """Vectorized make_q3_quants(do_rmse=True) (k_quants.c:163-220).

    x: (B, n). Returns (scale (B,), L (B, n) in [0, 2*nmax-1]).
    """
    B, n = x.shape
    x = x.astype(F32)
    amax, smax = _signed_absmax(x)
    nonzero = amax != 0

    with np.errstate(divide="ignore", invalid="ignore"):
        iscale = np.where(nonzero, F32(-nmax) / smax, F32(0)).astype(F32)

    Ls = np.clip(_nearest_int(iscale[:, None] * x), -nmax, nmax - 1)
    w = (x * x).astype(F32)
    sumlx = np.zeros(B, dtype=F32)
    suml2 = np.zeros(B, dtype=F32)
    for i in range(n):
        li = Ls[:, i].astype(F32)
        sumlx = (sumlx + w[:, i] * x[:, i] * li).astype(F32)
        suml2 = (suml2 + w[:, i] * li * li).astype(F32)

    active = nonzero.copy()
    for _ in range(5):
        if not active.any():
            break
        n_changed = np.zeros(B, dtype=np.int32)
        for i in range(n):
            wi = w[:, i]
            xi = x[:, i]
            li = Ls[:, i].astype(F32)
            slx = (sumlx - wi * xi * li).astype(F32)
            cond = active & (slx > 0)
            sl2 = (suml2 - wi * li * li).astype(F32)
            with np.errstate(divide="ignore", invalid="ignore"):
                cand = _nearest_int(np.where(cond, xi * sl2 / slx, F32(0)))
            cand = np.clip(cand, -nmax, nmax - 1)
            cond &= cand != Ls[:, i]
            cf = cand.astype(F32)
            slx2 = (slx + wi * xi * cf).astype(F32)
            sl22 = (sl2 + wi * cf * cf).astype(F32)
            cond &= (sl22 > 0) & (slx2 * slx2 * suml2 > sumlx * sumlx * sl22)
            Ls[:, i] = np.where(cond, cand, Ls[:, i])
            sumlx = np.where(cond, slx2, sumlx)
            suml2 = np.where(cond, sl22, suml2)
            n_changed += cond.astype(np.int32)
        active &= n_changed > 0

    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(suml2 != 0, sumlx / suml2, F32(0)).astype(F32)
    scale = np.where(nonzero, scale, F32(0))
    L = np.where(nonzero[:, None], Ls + nmax, 0)
    return scale, L


def make_qkx1_quants(x: np.ndarray, nmax: int, ntry: int):
    """Vectorized make_qkx1_quants (k_quants.c:222-262).

    x: (B, n). Returns (scale (B,), the_min (B,), L (B, n) uint in [0, nmax]).
    """
    B, n = x.shape
    x = x.astype(F32)
    mn = x.min(axis=1)
    mx = x.max(axis=1)
    degenerate = mx == mn

    mn = np.where(mn > 0, F32(0), mn).astype(F32)
    with np.errstate(divide="ignore", invalid="ignore"):
        iscale = np.where(degenerate, F32(0), F32(nmax) / (mx - mn)).astype(F32)
        scale = np.where(degenerate, F32(0), F32(1) / iscale).astype(F32)

    L = np.zeros((B, n), dtype=np.int32)
    active = ~degenerate
    for _ in range(ntry):
        if not active.any():
            break
        newL = np.clip(_nearest_int(iscale[:, None] * (x - mn[:, None])), 0, nmax)
        did_change = (newL != L).any(axis=1)
        L = np.where(active[:, None], newL, L)
        sumlx = np.zeros(B, dtype=F32)
        suml2 = np.zeros(B, dtype=np.int64)  # C uses int — exact
        for i in range(n):
            li = newL[:, i]
            sumlx = (sumlx + (x[:, i] - mn) * li.astype(F32)).astype(F32)
            suml2 = suml2 + li.astype(np.int64) * li
        with np.errstate(divide="ignore", invalid="ignore"):
            new_scale = (sumlx / suml2.astype(F32)).astype(F32)
        scale = np.where(active, new_scale, scale)
        ssum = np.zeros(B, dtype=F32)
        for i in range(n):
            ssum = (ssum + (x[:, i] - scale * newL[:, i].astype(F32))).astype(F32)
        new_min = (ssum / F32(n)).astype(F32)
        new_min = np.where(new_min > 0, F32(0), new_min)
        mn = np.where(active, new_min, mn)
        with np.errstate(divide="ignore", invalid="ignore"):
            iscale = np.where(scale != 0, F32(1) / scale, F32(0)).astype(F32)
        active &= did_change

    the_min = np.where(degenerate, F32(0), -mn).astype(F32)
    scale = np.where(degenerate, F32(0), scale).astype(F32)
    return scale, the_min, L


# --------------------------------------------------------------------------
# Q2_K
# --------------------------------------------------------------------------

def quantize_q2_K(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=F32)
    assert x.size % QK_K == 0
    xb = x.reshape(-1, QK_K)
    nb = xb.shape[0]
    groups = xb.reshape(nb, 16, 16)  # 16 groups of 16

    scale, gmin, _L0 = make_qkx1_quants(groups.reshape(-1, 16), nmax=3, ntry=5)
    scales = scale.reshape(nb, 16)
    mins = gmin.reshape(nb, 16)

    max_scale = scales.max(axis=1)
    max_min = mins.max(axis=1)

    q4scale = F32(15.0)
    sc_packed = np.zeros((nb, 16), dtype=np.uint8)
    has_scale = max_scale > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        isc = np.where(has_scale, q4scale / max_scale, F32(0)).astype(F32)
    ls = _nearest_int(isc[:, None] * scales)
    sc_packed = np.where(has_scale[:, None], ls.astype(np.uint8), 0).astype(np.uint8)
    d = np.where(has_scale, max_scale / q4scale, F32(0)).astype(np.float16)

    has_min = max_min > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        imn = np.where(has_min, q4scale / max_min, F32(0)).astype(F32)
    lm = _nearest_int(imn[:, None] * mins)
    sc_packed = sc_packed | np.where(has_min[:, None], (lm.astype(np.uint8) << 4), 0).astype(np.uint8)
    dmin = np.where(has_min, max_min / q4scale, F32(0)).astype(np.float16)

    # requantize with the fp16-rounded super scales
    df = d.astype(F32)[:, None] * (sc_packed & 0xF).astype(F32)  # (nb,16)
    dmf = dmin.astype(F32)[:, None] * (sc_packed >> 4).astype(F32)
    with np.errstate(divide="ignore", invalid="ignore"):
        lq = _nearest_int((groups + dmf[:, :, None]) / df[:, :, None])
    L = np.clip(lq, 0, 3)
    L = np.where((df != 0)[:, :, None], L, 0).astype(np.uint8)
    Lf = L.reshape(nb, QK_K)

    # pack: for each 128-element half, byte l holds elements {l, l+32, l+64, l+96}
    qs = np.zeros((nb, 64), dtype=np.uint8)
    for half in range(2):
        seg = Lf[:, half * 128:(half + 1) * 128]
        qs[:, half * 32:(half + 1) * 32] = (
            seg[:, 0:32] | (seg[:, 32:64] << 2) | (seg[:, 64:96] << 4) | (seg[:, 96:128] << 6)
        )

    out = np.empty((nb, 84), dtype=np.uint8)
    out[:, 0:16] = sc_packed
    out[:, 16:80] = qs
    out[:, 80:82] = d[:, None].view(np.uint8)
    out[:, 82:84] = dmin[:, None].view(np.uint8)
    return out.reshape(-1)


def dequantize_q2_K(buf: np.ndarray, n: int) -> np.ndarray:
    b = np.asarray(buf, dtype=np.uint8).reshape(-1, 84)
    nb = b.shape[0]
    sc = b[:, 0:16]
    qs = b[:, 16:80]
    d = b[:, 80:82].copy().view(np.float16).astype(F32)  # (nb,1)
    dmin = b[:, 82:84].copy().view(np.float16).astype(F32)

    dl = d * (sc & 0xF).astype(F32)  # (nb,16)
    ml = dmin * (sc >> 4).astype(F32)

    y = np.empty((nb, QK_K), dtype=F32)
    for half in range(2):
        q = qs[:, half * 32:(half + 1) * 32]
        for j in range(4):
            two = (q >> (2 * j)) & 3  # (nb, 32)
            g = half * 8 + 2 * j
            y[:, half * 128 + j * 32: half * 128 + j * 32 + 16] = (
                dl[:, g, None] * two[:, :16].astype(F32) - ml[:, g, None]
            )
            y[:, half * 128 + j * 32 + 16: half * 128 + (j + 1) * 32] = (
                dl[:, g + 1, None] * two[:, 16:].astype(F32) - ml[:, g + 1, None]
            )
    return y.reshape(-1)[:n]


# --------------------------------------------------------------------------
# Q3_K
# --------------------------------------------------------------------------

def quantize_q3_K(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=F32)
    assert x.size % QK_K == 0
    xb = x.reshape(-1, QK_K)
    nb = xb.shape[0]
    groups = xb.reshape(nb, 16, 16)

    scale, _L0 = make_q3_quants(groups.reshape(-1, 16), nmax=4)
    scales = scale.reshape(nb, 16)

    # signed max-abs scale, first occurrence
    aidx = np.argmax(np.abs(scales), axis=1)
    max_scale = scales[np.arange(nb), aidx]
    amax = np.abs(max_scale)
    has = amax != 0

    sc_bytes = np.zeros((nb, 12), dtype=np.uint8)
    with np.errstate(divide="ignore", invalid="ignore"):
        isc = np.where(has, F32(-32.0) / max_scale, F32(0)).astype(F32)
    lq = np.clip(_nearest_int(isc[:, None] * scales), -32, 31) + 32  # (nb,16) in [0,63]
    lq = np.where(has[:, None], lq, 0)
    low = (lq & 0xF).astype(np.uint8)
    hi = (lq >> 4).astype(np.uint8)
    sc_bytes[:, 0:8] = low[:, 0:8] | (low[:, 8:16] << 4)
    for j in range(16):
        sc_bytes[:, 8 + j % 4] |= (hi[:, j] << (2 * (j // 4))).astype(np.uint8)
    with np.errstate(divide="ignore", invalid="ignore"):
        dval = np.where(has, F32(1) / isc, F32(0)).astype(np.float16)

    # decode 6-bit scales back (as the C requantization does)
    sc_dec = np.empty((nb, 16), dtype=np.int32)
    for j in range(16):
        if j < 8:
            s4 = sc_bytes[:, j] & 0xF
        else:
            s4 = sc_bytes[:, j - 8] >> 4
        s2 = (sc_bytes[:, 8 + j % 4] >> (2 * (j // 4))) & 3
        sc_dec[:, j] = (s4 | (s2 << 4)).astype(np.int8) - 32

    df = dval.astype(F32)[:, None] * sc_dec.astype(F32)  # (nb,16)
    with np.errstate(divide="ignore", invalid="ignore"):
        lr = _nearest_int(groups / df[:, :, None])
    L = np.clip(lr, -4, 3) + 4
    L = np.where((df != 0)[:, :, None], L, 0).astype(np.int32)
    Lf = L.reshape(nb, QK_K)

    # hmask: bit (j // 32) of byte (j % 32) marks L[j] > 3
    high = (Lf > 3).astype(np.uint8)
    Lf = np.where(Lf > 3, Lf - 4, Lf).astype(np.uint8)
    hmask = np.zeros((nb, 32), dtype=np.uint8)
    for seg in range(8):
        hmask |= high[:, seg * 32:(seg + 1) * 32] << seg

    qs = np.zeros((nb, 64), dtype=np.uint8)
    for half in range(2):
        segd = Lf[:, half * 128:(half + 1) * 128]
        qs[:, half * 32:(half + 1) * 32] = (
            segd[:, 0:32] | (segd[:, 32:64] << 2) | (segd[:, 64:96] << 4) | (segd[:, 96:128] << 6)
        )

    out = np.empty((nb, 110), dtype=np.uint8)
    out[:, 0:32] = hmask
    out[:, 32:96] = qs
    out[:, 96:108] = sc_bytes
    out[:, 108:110] = dval[:, None].view(np.uint8)
    return out.reshape(-1)


def _q3k_decode_scales(sc_bytes: np.ndarray) -> np.ndarray:
    """(nb,12) packed 6-bit scales -> (nb,16) int32 (bias-32 applied)."""
    nb = sc_bytes.shape[0]
    out = np.empty((nb, 16), dtype=np.int32)
    for j in range(16):
        if j < 8:
            s4 = sc_bytes[:, j] & 0xF
        else:
            s4 = sc_bytes[:, j - 8] >> 4
        s2 = (sc_bytes[:, 8 + j % 4] >> (2 * (j // 4))) & 3
        out[:, j] = (s4 | (s2 << 4)).astype(np.int8) - 32
    return out


def _q3k_pack_scales(sc: np.ndarray) -> np.ndarray:
    """The inverse of _q3k_decode_scales: (nb,16) signed scales in -32..31
    -> (nb,12) packed bytes (low nibbles of 0-7 and 8-15 share bytes 0-7;
    the high two bits of scale j sit at bits 2*(j//4) of byte 8 + j%4)."""
    lq = (np.asarray(sc).astype(np.int32) + 32).astype(np.uint8)  # 0..63
    low, hi = lq & 0xF, lq >> 4
    out = np.zeros((lq.shape[0], 12), dtype=np.uint8)
    out[:, 0:8] = low[:, 0:8] | (low[:, 8:16] << 4)
    for j in range(16):
        out[:, 8 + j % 4] |= hi[:, j] << (2 * (j // 4))
    return out


def dequantize_q3_K(buf: np.ndarray, n: int) -> np.ndarray:
    b = np.asarray(buf, dtype=np.uint8).reshape(-1, 110)
    nb = b.shape[0]
    hmask = b[:, 0:32]
    qs = b[:, 32:96]
    sc = _q3k_decode_scales(b[:, 96:108])
    d = b[:, 108:110].copy().view(np.float16).astype(F32)  # (nb,1)

    y = np.empty((nb, QK_K), dtype=F32)
    # scale index is = consumed in order; hmask bit m advances every 32 elements
    for half in range(2):
        q = qs[:, half * 32:(half + 1) * 32]
        for j in range(4):
            two = ((q >> (2 * j)) & 3).astype(np.int32)
            mbit = half * 4 + j
            hb = ((hmask >> mbit) & 1).astype(np.int32)
            vals = two - np.where(hb == 0, 4, 0)
            g = half * 8 + 2 * j
            dl1 = d[:, 0] * sc[:, g].astype(F32)
            dl2 = d[:, 0] * sc[:, g + 1].astype(F32)
            base = half * 128 + j * 32
            y[:, base:base + 16] = dl1[:, None] * vals[:, :16]
            y[:, base + 16:base + 32] = dl2[:, None] * vals[:, 16:]
    return y.reshape(-1)[:n]


# --------------------------------------------------------------------------
# Q4_K / Q5_K shared 6-bit scale packing (get_scale_min_k4, k_quants.c:264-271)
# --------------------------------------------------------------------------

def _pack_scales_k4(ls: np.ndarray, lm: np.ndarray) -> np.ndarray:
    """(nb,8),(nb,8) 6-bit values -> (nb,12) packed bytes."""
    nb = ls.shape[0]
    sc = np.zeros((nb, 12), dtype=np.uint8)
    for j in range(8):
        if j < 4:
            sc[:, j] = ls[:, j]
            sc[:, j + 4] = lm[:, j]
        else:
            sc[:, j + 4] = (ls[:, j] & 0xF) | ((lm[:, j] & 0xF) << 4)
            sc[:, j - 4] |= (ls[:, j] >> 4) << 6
            sc[:, j - 0] |= (lm[:, j] >> 4) << 6
    return sc


def _unpack_scales_k4(sc: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(nb,12) -> ((nb,8) scales, (nb,8) mins)."""
    nb = sc.shape[0]
    d = np.empty((nb, 8), dtype=np.uint8)
    m = np.empty((nb, 8), dtype=np.uint8)
    for j in range(8):
        if j < 4:
            d[:, j] = sc[:, j] & 63
            m[:, j] = sc[:, j + 4] & 63
        else:
            d[:, j] = (sc[:, j + 4] & 0xF) | ((sc[:, j - 4] >> 6) << 4)
            m[:, j] = (sc[:, j + 4] >> 4) | ((sc[:, j] >> 6) << 4)
    return d, m


def _quantize_q45_K(x: np.ndarray, nmax: int):
    """Shared Q4_K/Q5_K scale path. Returns (d, dmin, sc_bytes, L)."""
    xb = x.reshape(-1, QK_K)
    nb = xb.shape[0]
    groups = xb.reshape(nb, 8, 32)

    scale, gmin, _ = make_qkx1_quants(groups.reshape(-1, 32), nmax=nmax, ntry=5)
    scales = scale.reshape(nb, 8)
    mins = gmin.reshape(nb, 8)

    max_scale = scales.max(axis=1)
    max_min = mins.max(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_scale = np.where(max_scale > 0, F32(63.0) / max_scale, F32(0)).astype(F32)
        inv_min = np.where(max_min > 0, F32(63.0) / max_min, F32(0)).astype(F32)
    ls = np.minimum(63, _nearest_int(inv_scale[:, None] * scales)).astype(np.uint8)
    lm = np.minimum(63, _nearest_int(inv_min[:, None] * mins)).astype(np.uint8)
    sc_bytes = _pack_scales_k4(ls, lm)
    d = (max_scale / F32(63.0)).astype(np.float16)
    dmin = (max_min / F32(63.0)).astype(np.float16)

    sd, sm = _unpack_scales_k4(sc_bytes)
    df = d.astype(F32)[:, None] * sd.astype(F32)  # (nb,8)
    dmf = dmin.astype(F32)[:, None] * sm.astype(F32)
    with np.errstate(divide="ignore", invalid="ignore"):
        lq = _nearest_int((groups + dmf[:, :, None]) / df[:, :, None])
    L = np.clip(lq, 0, nmax)
    L = np.where((df != 0)[:, :, None], L, 0).astype(np.int32).reshape(nb, QK_K)
    return d, dmin, sc_bytes, L


def quantize_q4_K(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=F32)
    assert x.size % QK_K == 0
    d, dmin, sc_bytes, L = _quantize_q45_K(x, nmax=15)
    nb = L.shape[0]
    qs = np.empty((nb, 128), dtype=np.uint8)
    for j in range(4):  # 64-element chunks: low nibble = first 32, high = next 32
        seg = L[:, j * 64:(j + 1) * 64]
        qs[:, j * 32:(j + 1) * 32] = (seg[:, :32] | (seg[:, 32:] << 4)).astype(np.uint8)
    out = np.empty((nb, 144), dtype=np.uint8)
    out[:, 0:2] = d[:, None].view(np.uint8)
    out[:, 2:4] = dmin[:, None].view(np.uint8)
    out[:, 4:16] = sc_bytes
    out[:, 16:144] = qs
    return out.reshape(-1)


def dequantize_q4_K(buf: np.ndarray, n: int) -> np.ndarray:
    b = np.asarray(buf, dtype=np.uint8).reshape(-1, 144)
    nb = b.shape[0]
    d = b[:, 0:2].copy().view(np.float16).astype(F32)
    dmin = b[:, 2:4].copy().view(np.float16).astype(F32)
    sd, sm = _unpack_scales_k4(b[:, 4:16])
    qs = b[:, 16:144]
    y = np.empty((nb, QK_K), dtype=F32)
    for j in range(4):
        q = qs[:, j * 32:(j + 1) * 32]
        d1 = d[:, 0] * sd[:, 2 * j].astype(F32)
        m1 = dmin[:, 0] * sm[:, 2 * j].astype(F32)
        d2 = d[:, 0] * sd[:, 2 * j + 1].astype(F32)
        m2 = dmin[:, 0] * sm[:, 2 * j + 1].astype(F32)
        y[:, j * 64:j * 64 + 32] = d1[:, None] * (q & 0xF) - m1[:, None]
        y[:, j * 64 + 32:(j + 1) * 64] = d2[:, None] * (q >> 4) - m2[:, None]
    return y.reshape(-1)[:n]


def quantize_q5_K(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=F32)
    assert x.size % QK_K == 0
    d, dmin, sc_bytes, L = _quantize_q45_K(x, nmax=31)
    nb = L.shape[0]
    ql = np.empty((nb, 128), dtype=np.uint8)
    qh = np.zeros((nb, 32), dtype=np.uint8)
    for j in range(4):  # per 64-element chunk; qh bit pairs (2j, 2j+1)
        seg = L[:, j * 64:(j + 1) * 64]
        l1 = seg[:, :32]
        l2 = seg[:, 32:]
        qh |= ((l1 > 15).astype(np.uint8) << (2 * j)) | ((l2 > 15).astype(np.uint8) << (2 * j + 1))
        ql[:, j * 32:(j + 1) * 32] = ((l1 & 0xF) | ((l2 & 0xF) << 4)).astype(np.uint8)
    out = np.empty((nb, 176), dtype=np.uint8)
    out[:, 0:2] = d[:, None].view(np.uint8)
    out[:, 2:4] = dmin[:, None].view(np.uint8)
    out[:, 4:16] = sc_bytes
    out[:, 16:48] = qh
    out[:, 48:176] = ql
    return out.reshape(-1)


def dequantize_q5_K(buf: np.ndarray, n: int) -> np.ndarray:
    b = np.asarray(buf, dtype=np.uint8).reshape(-1, 176)
    nb = b.shape[0]
    d = b[:, 0:2].copy().view(np.float16).astype(F32)
    dmin = b[:, 2:4].copy().view(np.float16).astype(F32)
    sd, sm = _unpack_scales_k4(b[:, 4:16])
    qh = b[:, 16:48]
    ql = b[:, 48:176]
    y = np.empty((nb, QK_K), dtype=F32)
    for j in range(4):
        q = ql[:, j * 32:(j + 1) * 32]
        h1 = ((qh >> (2 * j)) & 1).astype(F32) * 16
        h2 = ((qh >> (2 * j + 1)) & 1).astype(F32) * 16
        d1 = d[:, 0] * sd[:, 2 * j].astype(F32)
        m1 = dmin[:, 0] * sm[:, 2 * j].astype(F32)
        d2 = d[:, 0] * sd[:, 2 * j + 1].astype(F32)
        m2 = dmin[:, 0] * sm[:, 2 * j + 1].astype(F32)
        y[:, j * 64:j * 64 + 32] = d1[:, None] * ((q & 0xF) + h1) - m1[:, None]
        y[:, j * 64 + 32:(j + 1) * 64] = d2[:, None] * ((q >> 4) + h2) - m2[:, None]
    return y.reshape(-1)[:n]


# --------------------------------------------------------------------------
# Q6_K
# --------------------------------------------------------------------------

def quantize_q6_K(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=F32)
    assert x.size % QK_K == 0
    xb = x.reshape(-1, QK_K)
    nb = xb.shape[0]
    groups = xb.reshape(nb, 16, 16)

    scale, _ = make_qx_quants(groups.reshape(-1, 16), nmax=32, rmse_type=1)
    scales = scale.reshape(nb, 16)

    aidx = np.argmax(np.abs(scales), axis=1)
    max_scale = scales[np.arange(nb), aidx]
    nonzero = np.abs(max_scale) != 0

    with np.errstate(divide="ignore", invalid="ignore"):
        iscale = np.where(nonzero, F32(-128.0) / max_scale, F32(0)).astype(F32)
        dval = np.where(nonzero, F32(1) / iscale, F32(0)).astype(np.float16)
    sc8 = np.minimum(127, _nearest_int(iscale[:, None] * scales)).astype(np.int8)
    sc8 = np.where(nonzero[:, None], sc8, 0).astype(np.int8)

    df = dval.astype(F32)[:, None] * sc8.astype(F32)  # (nb,16)
    with np.errstate(divide="ignore", invalid="ignore"):
        lr = _nearest_int(groups / df[:, :, None])
    L = np.clip(lr, -32, 31) + 32
    L = np.where((df != 0)[:, :, None], L, 0).astype(np.int32).reshape(nb, QK_K)

    ql = np.empty((nb, 128), dtype=np.uint8)
    qh = np.empty((nb, 64), dtype=np.uint8)
    for half in range(2):  # 128-element halves
        seg = L[:, half * 128:(half + 1) * 128]
        q1, q2, q3, q4 = seg[:, 0:32], seg[:, 32:64], seg[:, 64:96], seg[:, 96:128]
        ql[:, half * 64:half * 64 + 32] = ((q1 & 0xF) | ((q3 & 0xF) << 4)).astype(np.uint8)
        ql[:, half * 64 + 32:(half + 1) * 64] = ((q2 & 0xF) | ((q4 & 0xF) << 4)).astype(np.uint8)
        qh[:, half * 32:(half + 1) * 32] = (
            (q1 >> 4) | ((q2 >> 4) << 2) | ((q3 >> 4) << 4) | ((q4 >> 4) << 6)
        ).astype(np.uint8)

    out = np.empty((nb, 210), dtype=np.uint8)
    out[:, 0:128] = ql
    out[:, 128:192] = qh
    out[:, 192:208] = sc8.view(np.uint8)
    out[:, 208:210] = dval[:, None].view(np.uint8)
    return out.reshape(-1)


def dequantize_q6_K(buf: np.ndarray, n: int) -> np.ndarray:
    b = np.asarray(buf, dtype=np.uint8).reshape(-1, 210)
    nb = b.shape[0]
    ql = b[:, 0:128]
    qh = b[:, 128:192]
    sc = b[:, 192:208].copy().view(np.int8)
    d = b[:, 208:210].copy().view(np.float16).astype(F32)

    y = np.empty((nb, QK_K), dtype=F32)
    for half in range(2):
        l_lo = ql[:, half * 64:half * 64 + 32]
        l_hi = ql[:, half * 64 + 32:(half + 1) * 64]
        h = qh[:, half * 32:(half + 1) * 32]
        q1 = ((l_lo & 0xF) | (((h >> 0) & 3) << 4)).astype(np.int32) - 32
        q2 = ((l_hi & 0xF) | (((h >> 2) & 3) << 4)).astype(np.int32) - 32
        q3 = ((l_lo >> 4) | (((h >> 4) & 3) << 4)).astype(np.int32) - 32
        q4 = ((l_hi >> 4) | (((h >> 6) & 3) << 4)).astype(np.int32) - 32
        base = half * 128
        sbase = half * 8
        for li, q in enumerate((q1, q2, q3, q4)):
            # scale index: groups of 16 within each 32-lane strip
            s_a = sc[:, sbase + 2 * li].astype(F32)
            s_b = sc[:, sbase + 2 * li + 1].astype(F32)
            y[:, base + li * 32: base + li * 32 + 16] = d * s_a[:, None] * q[:, :16]
            y[:, base + li * 32 + 16: base + (li + 1) * 32] = d * s_b[:, None] * q[:, 16:]
    return y.reshape(-1)[:n]


# --------------------------------------------------------------------------
# Q8_K (activation format for K-quant dot products)
# --------------------------------------------------------------------------

def quantize_q8_K(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=F32)
    assert x.size % QK_K == 0
    xb = x.reshape(-1, QK_K)
    nb = xb.shape[0]
    amax, smax = _signed_absmax(xb)
    nonzero = amax != 0
    with np.errstate(divide="ignore", invalid="ignore"):
        iscale = np.where(nonzero, F32(-128.0) / smax, F32(0)).astype(F32)
    qs = np.minimum(127, _nearest_int(iscale[:, None] * xb)).astype(np.int8)
    qs = np.where(nonzero[:, None], qs, 0).astype(np.int8)
    bsums = qs.reshape(nb, 16, 16).astype(np.int32).sum(axis=2).astype(np.int16)
    with np.errstate(divide="ignore", invalid="ignore"):
        d = np.where(nonzero, F32(1) / iscale, F32(0)).astype(F32)

    out = np.empty((nb, 292), dtype=np.uint8)
    out[:, 0:4] = d[:, None].view(np.uint8)
    out[:, 4:260] = qs.view(np.uint8)
    out[:, 260:292] = bsums.view(np.uint8)
    return out.reshape(-1)


def dequantize_q8_K(buf: np.ndarray, n: int) -> np.ndarray:
    b = np.asarray(buf, dtype=np.uint8).reshape(-1, 292)
    d = b[:, 0:4].copy().view(np.float32)
    qs = b[:, 4:260].copy().view(np.int8).astype(F32)
    return (qs * d).reshape(-1)[:n]
