"""Legacy 32-element block quantization codecs (Q4_0/Q4_1/Q5_0/Q5_1/Q8_0/Q8_1;
a copy of ggllm_tpu/quant/legacy.py, which the port does not import).

Bit-faithful, vectorized numpy re-implementations of the reference scalar
codecs (ggml.c:927-1131 quantize, ggml.c:1447-1586 dequantize). The packed
byte layout matches the reference block structs exactly (ggml.c:879-924), so
GGCC files are interchangeable. All float arithmetic is float32 to match C
semantics (strict IEEE, no FMA contraction).

Layout conventions shared by all 32-wide formats:
  * a block holds 32 consecutive elements of one row;
  * 4-bit packing splits the block in two halves: byte j holds element j in its
    low nibble and element j+16 in its high nibble;
  * 5-bit formats store the 5th bit of element j at bit j of a 32-bit mask.
"""

from __future__ import annotations

import numpy as np

QK = 32  # all legacy formats use 32-element blocks


def _f32(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32)
    assert x.size % QK == 0, f"size {x.size} not a multiple of {QK}"
    return x.reshape(-1, QK)


def _signed_absmax(x: np.ndarray) -> np.ndarray:
    """Per-block value with the largest magnitude (first occurrence, like C)."""
    idx = np.argmax(np.abs(x), axis=1)
    return x[np.arange(x.shape[0]), idx]


def _trunc_u8(x: np.ndarray) -> np.ndarray:
    """C-style (int8_t) cast: truncation toward zero; inputs here are >= 0."""
    return x.astype(np.int32).astype(np.uint8)


def _roundf(x: np.ndarray) -> np.ndarray:
    """C roundf: round half away from zero (numpy rint is half-to-even)."""
    return np.trunc(x + np.copysign(np.float32(0.5), x)).astype(np.int32)


def _safe_inv(d: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore"):
        return np.where(d != 0, np.float32(1.0) / d, np.float32(0.0)).astype(np.float32)


# ---------------------------------------------------------------- Q4_0

def quantize_q4_0(x: np.ndarray) -> np.ndarray:
    x = _f32(x)
    nb = x.shape[0]
    maxv = _signed_absmax(x)
    d = (maxv / np.float32(-8.0)).astype(np.float32)
    idv = _safe_inv(d)
    xi = np.minimum(15, (x * idv[:, None] + np.float32(8.5)).astype(np.int32)).astype(np.uint8)
    out = np.empty((nb, 18), dtype=np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:18] = xi[:, :16] | (xi[:, 16:] << 4)
    return out.reshape(-1)


def dequantize_q4_0(buf: np.ndarray, n: int) -> np.ndarray:
    b = np.asarray(buf, dtype=np.uint8).reshape(-1, 18)
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)  # (nb,1)
    qs = b[:, 2:18]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    y = np.concatenate([lo, hi], axis=1).astype(np.float32) * d
    return y.reshape(-1)[:n]


# ---------------------------------------------------------------- Q4_1

def quantize_q4_1(x: np.ndarray) -> np.ndarray:
    x = _f32(x)
    nb = x.shape[0]
    mn = x.min(axis=1)
    mx = x.max(axis=1)
    d = ((mx - mn) / np.float32(15.0)).astype(np.float32)
    idv = _safe_inv(d)
    xi = np.minimum(
        15, ((x - mn[:, None]) * idv[:, None] + np.float32(0.5)).astype(np.int32)
    ).astype(np.uint8)
    out = np.empty((nb, 20), dtype=np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:4] = mn.astype(np.float16)[:, None].view(np.uint8)
    out[:, 4:20] = xi[:, :16] | (xi[:, 16:] << 4)
    return out.reshape(-1)


def dequantize_q4_1(buf: np.ndarray, n: int) -> np.ndarray:
    b = np.asarray(buf, dtype=np.uint8).reshape(-1, 20)
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)
    m = b[:, 2:4].copy().view(np.float16).astype(np.float32)
    qs = b[:, 4:20]
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    y = np.concatenate([lo, hi], axis=1) * d + m
    return y.reshape(-1)[:n]


# ---------------------------------------------------------------- Q5_0

def _pack_qh(xi: np.ndarray) -> np.ndarray:
    """Pack bit 4 of each of the 32 block elements into a little-endian u32."""
    bits = ((xi >> 4) & 1).astype(np.uint32)  # (nb, 32)
    shifts = np.arange(32, dtype=np.uint32)
    qh = (bits << shifts[None, :]).sum(axis=1, dtype=np.uint32)
    return qh


def _unpack_qh(qh_bytes: np.ndarray) -> np.ndarray:
    """(nb,4) uint8 -> (nb,32) uint8 of 5th bits."""
    qh = qh_bytes.copy().view(np.uint32).reshape(-1)  # (nb,)
    shifts = np.arange(32, dtype=np.uint32)
    return ((qh[:, None] >> shifts[None, :]) & 1).astype(np.uint8)


def quantize_q5_0(x: np.ndarray) -> np.ndarray:
    x = _f32(x)
    nb = x.shape[0]
    maxv = _signed_absmax(x)
    d = (maxv / np.float32(-16.0)).astype(np.float32)
    idv = _safe_inv(d)
    xi = np.minimum(31, (x * idv[:, None] + np.float32(16.5)).astype(np.int32)).astype(np.uint8)
    out = np.empty((nb, 22), dtype=np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    # bit j of qh <- 5th bit of element j (first half), bit j+16 <- second half
    out[:, 2:6] = _pack_qh(xi)[:, None].view(np.uint8)
    out[:, 6:22] = (xi[:, :16] & 0x0F) | ((xi[:, 16:] & 0x0F) << 4)
    return out.reshape(-1)


def dequantize_q5_0(buf: np.ndarray, n: int) -> np.ndarray:
    b = np.asarray(buf, dtype=np.uint8).reshape(-1, 22)
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)
    hb = _unpack_qh(b[:, 2:6])  # (nb, 32)
    qs = b[:, 6:22]
    lo = ((qs & 0x0F) | (hb[:, :16] << 4)).astype(np.int16) - 16
    hi = ((qs >> 4) | (hb[:, 16:] << 4)).astype(np.int16) - 16
    y = np.concatenate([lo, hi], axis=1).astype(np.float32) * d
    return y.reshape(-1)[:n]


# ---------------------------------------------------------------- Q5_1

def quantize_q5_1(x: np.ndarray) -> np.ndarray:
    x = _f32(x)
    nb = x.shape[0]
    mn = x.min(axis=1)
    mx = x.max(axis=1)
    d = ((mx - mn) / np.float32(31.0)).astype(np.float32)
    idv = _safe_inv(d)
    xi = ((x - mn[:, None]) * idv[:, None] + np.float32(0.5)).astype(np.int32).astype(np.uint8)
    out = np.empty((nb, 24), dtype=np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:4] = mn.astype(np.float16)[:, None].view(np.uint8)
    out[:, 4:8] = _pack_qh(xi)[:, None].view(np.uint8)
    out[:, 8:24] = (xi[:, :16] & 0x0F) | ((xi[:, 16:] & 0x0F) << 4)
    return out.reshape(-1)


def dequantize_q5_1(buf: np.ndarray, n: int) -> np.ndarray:
    b = np.asarray(buf, dtype=np.uint8).reshape(-1, 24)
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)
    m = b[:, 2:4].copy().view(np.float16).astype(np.float32)
    hb = _unpack_qh(b[:, 4:8])
    qs = b[:, 8:24]
    lo = ((qs & 0x0F) | (hb[:, :16] << 4)).astype(np.float32)
    hi = ((qs >> 4) | (hb[:, 16:] << 4)).astype(np.float32)
    y = np.concatenate([lo, hi], axis=1) * d + m
    return y.reshape(-1)[:n]


# ---------------------------------------------------------------- Q8_0

def quantize_q8_0(x: np.ndarray) -> np.ndarray:
    x = _f32(x)
    nb = x.shape[0]
    amax = np.abs(x).max(axis=1)
    d = (amax / np.float32(127.0)).astype(np.float32)
    idv = _safe_inv(d)
    qs = _roundf(x * idv[:, None]).astype(np.int8)
    out = np.empty((nb, 34), dtype=np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:34] = qs.view(np.uint8)
    return out.reshape(-1)


def dequantize_q8_0(buf: np.ndarray, n: int) -> np.ndarray:
    b = np.asarray(buf, dtype=np.uint8).reshape(-1, 34)
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)
    qs = b[:, 2:34].copy().view(np.int8).astype(np.float32)
    return (qs * d).reshape(-1)[:n]


# ---------------------------------------------------------------- Q8_1

def quantize_q8_1(x: np.ndarray) -> np.ndarray:
    x = _f32(x)
    nb = x.shape[0]
    amax = np.abs(x).max(axis=1)
    d = (amax / np.float32(127.0)).astype(np.float32)
    idv = _safe_inv(d)
    qs = _roundf(x * idv[:, None]).astype(np.int8)
    s = (qs.astype(np.int32).sum(axis=1).astype(np.float32) * d).astype(np.float32)
    out = np.empty((nb, 40), dtype=np.uint8)
    out[:, 0:4] = d[:, None].view(np.uint8)
    out[:, 4:8] = s[:, None].view(np.uint8)
    out[:, 8:40] = qs.view(np.uint8)
    return out.reshape(-1)


def dequantize_q8_1(buf: np.ndarray, n: int) -> np.ndarray:
    b = np.asarray(buf, dtype=np.uint8).reshape(-1, 40)
    d = b[:, 0:4].copy().view(np.float32)
    qs = b[:, 8:40].copy().view(np.int8).astype(np.float32)
    return (qs * d).reshape(-1)[:n]
