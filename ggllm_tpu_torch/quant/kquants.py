"""K-quant super-block dequantizers: Q2_K, Q3_K, Q4_K, Q5_K and Q6_K (a copy
of that subset of ggllm_tpu/quant/kquants.py; the quantizers are not ported).

256-element super-blocks with two-level scales; byte layouts match
k_quants.h:20-83 exactly. All arithmetic is float32, in the reference's
order (k_quants.c), so the values are bit-identical to it.
"""

from __future__ import annotations

import numpy as np

QK_K = 256

F32 = np.float32


# --------------------------------------------------------------------------
# Q2_K
# --------------------------------------------------------------------------

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
    # hmask bit m covers elements 32m..32m+31; one scale per 16 elements
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
