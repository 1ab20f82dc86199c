"""Planar (struct-of-arrays) device layout for quantized weights (the port
of ggllm_tpu/quant/planar.py, all ten block formats).

Each quantized 2-D weight splits into contiguous planes in ggml's own
row-major block order, `rows` = output features by `nb` blocks along the
input (contraction) axis:

| format | planes |
|---|---|
| Q4_0 | d (rows, nb) f16; qs (rows, nb, 16) u8 nibbles, ggml's half-split order |
| Q4_1 | d, m f16; qs as Q4_0 (w = q*d + m) |
| Q5_0 | d f16; qh (rows, nb) int32 (bit j = 5th bit of element j); qs as Q4_0 |
| Q5_1 | d, m f16; qh; qs |
| Q8_0 | d f16; qs (rows, nb, 32) int8 |
| Q2_K | scb (rows, nb, 16) u8 (low nibble = scale, high nibble = min, per 16); qs (rows, nb, 64) u8 2-bit codes; d, dmin f16 |
| Q3_K | hmask (rows, nb, 32) u8 (bit j of byte i = high bit of element 32j + i); qs (rows, nb, 64) u8; sc (rows, nb, 16) int8, -32…31 (the 12 packed bytes decoded); d f16 |
| Q4_K | d, dmin (rows, nb) f16 per 256; sc, scm (rows, nb, 8) int8 6-bit sub-scales; qs (rows, nb, 128) u8 |
| Q5_K | Q4_K's planes and qh (rows, nb, 32) u8 |
| Q6_K | d f16; sc (rows, nb, 16) int8; ql (rows, nb, 128) u8; qh (rows, nb, 64) u8 |

A warp walking K along one output row reads every plane coalesced, so this
is also the Hopper kernel layout: loading a file is a copy with no repack.
The K-quant scale hierarchy stays two-level (the kernel forms d*sc in f32,
the reference's effective scale). The JAX package keeps fp16 scales as f32
(legacy) or int16 bit patterns (K-quants) because Mosaic has no f16, and
repacks into TPU bit-planes (kernels/layout.py); neither is needed here.
"""

from __future__ import annotations

import numpy as np

from ggllm_tpu_torch.core.dtypes import GGMLType, TYPE_TRAITS
from ggllm_tpu_torch.quant.kquants import (_pack_scales_k4, _q3k_decode_scales, _q3k_pack_scales,
                                            _unpack_scales_k4)

PLANES = {  # plane names per format, in block byte order
    GGMLType.Q4_0: ("d", "qs"),
    GGMLType.Q4_1: ("d", "m", "qs"),
    GGMLType.Q5_0: ("d", "qh", "qs"),
    GGMLType.Q5_1: ("d", "m", "qh", "qs"),
    GGMLType.Q8_0: ("d", "qs"),
    GGMLType.Q2_K: ("scb", "qs", "d", "dmin"),
    GGMLType.Q3_K: ("hmask", "qs", "sc", "d"),
    GGMLType.Q4_K: ("d", "dmin", "sc", "scm", "qs"),
    GGMLType.Q5_K: ("d", "dmin", "sc", "scm", "qh", "qs"),
    GGMLType.Q6_K: ("ql", "qh", "sc", "d"),
}

# (plane, first byte, last byte + 1) of each plane in the on-disk block;
# Q4_K/Q5_K's 12 packed scale bytes (4:16) hold both sc and scm, Q3_K's
# (96:108) its 16 signed 6-bit scales
_BYTES = {
    GGMLType.Q4_0: {"d": (0, 2), "qs": (2, 18)},
    GGMLType.Q4_1: {"d": (0, 2), "m": (2, 4), "qs": (4, 20)},
    GGMLType.Q5_0: {"d": (0, 2), "qh": (2, 6), "qs": (6, 22)},
    GGMLType.Q5_1: {"d": (0, 2), "m": (2, 4), "qh": (4, 8), "qs": (8, 24)},
    GGMLType.Q8_0: {"d": (0, 2), "qs": (2, 34)},
    GGMLType.Q2_K: {"scb": (0, 16), "qs": (16, 80), "d": (80, 82), "dmin": (82, 84)},
    GGMLType.Q3_K: {"hmask": (0, 32), "qs": (32, 96), "d": (108, 110)},
    GGMLType.Q4_K: {"d": (0, 2), "dmin": (2, 4), "qs": (16, 144)},
    GGMLType.Q5_K: {"d": (0, 2), "dmin": (2, 4), "qh": (16, 48), "qs": (48, 176)},
    GGMLType.Q6_K: {"ql": (0, 128), "qh": (128, 192), "sc": (192, 208), "d": (208, 210)},
}
_F16 = ("d", "m", "dmin")


def _check(gtype: GGMLType):
    if gtype not in PLANES:
        raise NotImplementedError(f"no planar layout for {GGMLType(gtype).name} in the port")


def to_planes(gtype: GGMLType, blob: np.ndarray, rows: int, cols: int) -> dict[str, np.ndarray]:
    """Packed row-major blob -> dict of planes. cols = input dim (blocked)."""
    _check(gtype)
    ts = TYPE_TRAITS[gtype].type_size
    b = np.asarray(blob, dtype=np.uint8).reshape(rows, -1, ts)
    nb = b.shape[1]
    if nb * TYPE_TRAITS[gtype].block_size != cols:
        raise ValueError(f"{GGMLType(gtype).name}: {nb} blocks do not cover {cols} columns")
    out = {}
    for name, (lo, hi) in _BYTES[gtype].items():
        p = b[:, :, lo:hi].copy()
        if name in _F16:
            out[name] = p.view(np.float16)[..., 0]
        elif name == "qh" and hi - lo == 4:  # legacy 5th bits: one u32 per block
            out[name] = p.view(np.int32)[..., 0]
        elif name == "sc" or (name == "qs" and gtype == GGMLType.Q8_0):
            out[name] = p.view(np.int8)
        else:
            out[name] = p
    if gtype in (GGMLType.Q4_K, GGMLType.Q5_K):
        sd, sm = _unpack_scales_k4(b[:, :, 4:16].reshape(-1, 12))
        out["sc"] = sd.reshape(rows, nb, 8).astype(np.int8)
        out["scm"] = sm.reshape(rows, nb, 8).astype(np.int8)
    elif gtype == GGMLType.Q3_K:
        sc = _q3k_decode_scales(b[:, :, 96:108].reshape(-1, 12))
        out["sc"] = sc.reshape(rows, nb, 16).astype(np.int8)
    return out


def from_planes(gtype: GGMLType, planes: dict[str, np.ndarray]) -> np.ndarray:
    """The inverse of to_planes: dict of planes -> (rows, nb * type_size)
    uint8 blob in the on-disk block layout."""
    _check(gtype)
    d = np.asarray(planes["d"])
    rows, nb = d.shape
    b = np.zeros((rows, nb, TYPE_TRAITS[gtype].type_size), np.uint8)
    for name, (lo, hi) in _BYTES[gtype].items():
        p = np.ascontiguousarray(planes[name])
        if name in _F16:
            p = p.astype(np.float16)
        b[:, :, lo:hi] = p.view(np.uint8).reshape(rows, nb, hi - lo)
    if gtype in (GGMLType.Q4_K, GGMLType.Q5_K):
        sc = np.asarray(planes["sc"]).astype(np.uint8).reshape(-1, 8)
        scm = np.asarray(planes["scm"]).astype(np.uint8).reshape(-1, 8)
        b[:, :, 4:16] = _pack_scales_k4(sc, scm).reshape(rows, nb, 12)
    elif gtype == GGMLType.Q3_K:
        sc = np.asarray(planes["sc"]).reshape(-1, 16)
        b[:, :, 96:108] = _q3k_pack_scales(sc).reshape(rows, nb, 12)
    return b.reshape(rows, -1)


def planes_from_codes(gtype: GGMLType, codes: np.ndarray) -> dict[str, np.ndarray]:
    """(rows, cols) combined unsigned codes (signed for Q8_0), in ggml element
    order -> the code planes of gtype (qs / qh / ql); the inverse of the
    JAX package's kernels/layout.py extract_codes."""
    _check(gtype)
    rows, cols = codes.shape
    c = np.asarray(codes)
    if gtype == GGMLType.Q8_0:
        return {"qs": c.astype(np.int8).reshape(rows, -1, 32)}
    c = c.astype(np.uint32)
    if gtype in (GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1):
        c = c.reshape(rows, -1, 32)
        out = {"qs": ((c[..., :16] & 0xF) | ((c[..., 16:] & 0xF) << 4)).astype(np.uint8)}
        if gtype in (GGMLType.Q5_0, GGMLType.Q5_1):
            bits = ((c >> 4) & 1) << np.arange(32, dtype=np.uint32)
            out["qh"] = bits.sum(axis=-1, dtype=np.uint32).view(np.int32)
        return out
    if gtype in (GGMLType.Q4_K, GGMLType.Q5_K):
        c = c.reshape(rows, -1, 4, 64)  # 64-element chunks: low nibbles 0-31, high 32-63
        lo, hi = c[..., :32], c[..., 32:]
        out = {"qs": ((lo & 0xF) | ((hi & 0xF) << 4)).astype(np.uint8).reshape(rows, -1, 128)}
        if gtype == GGMLType.Q5_K:  # chunk j: qh bit 2j (low half), 2j+1 (high half)
            j2 = 2 * np.arange(4, dtype=np.uint32)[:, None]
            qh = (((lo >> 4) & 1) << j2) | (((hi >> 4) & 1) << (j2 + 1))
            out["qh"] = qh.sum(axis=-2, dtype=np.uint32).astype(np.uint8)
        return out
    if gtype in (GGMLType.Q2_K, GGMLType.Q3_K):
        # per 128-half, strip j of 32 elements in bits 2j of the half's 32 qs
        # bytes; Q3_K's third bit of element 32m + i is bit m of hmask byte i
        c = c.reshape(rows, -1, 2, 4, 32)
        sh = 2 * np.arange(4, dtype=np.uint32)[:, None]
        out = {"qs": ((c & 3) << sh).sum(axis=-2, dtype=np.uint32).astype(np.uint8)
               .reshape(rows, -1, 64)}
        if gtype == GGMLType.Q3_K:
            hb = ((c >> 2) & 1).reshape(rows, -1, 8, 32) << np.arange(8, dtype=np.uint32)[:, None]
            out["hmask"] = hb.sum(axis=-2, dtype=np.uint32).astype(np.uint8)
        return out
    # Q6_K: per 128-half, strips q1..q4 of 32; ql = [q1|q3<<4, q2|q4<<4]
    c = c.reshape(rows, -1, 2, 4, 32)
    q1, q2, q3, q4 = (c[..., i, :] for i in range(4))
    ql = np.stack([(q1 & 0xF) | ((q3 & 0xF) << 4), (q2 & 0xF) | ((q4 & 0xF) << 4)], axis=-2)
    qh = (q1 >> 4) | ((q2 >> 4) << 2) | ((q3 >> 4) << 4) | ((q4 >> 4) << 6)
    return {"ql": ql.astype(np.uint8).reshape(rows, -1, 128),
            "qh": qh.astype(np.uint8).reshape(rows, -1, 64)}
