"""K-quant super-block dequantizers: Q4_K, Q5_K and Q6_K (a copy of that
subset of ggllm_tpu/quant/kquants.py; the quantizers, Q2_K and Q3_K are not
ported).

256-element super-blocks with two-level scales; byte layouts match
k_quants.h:20-83 exactly. All arithmetic is float32, in the reference's
order (k_quants.c), so the values are bit-identical to it.
"""

from __future__ import annotations

import numpy as np

QK_K = 256

F32 = np.float32


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
