"""Dispatch over the ported quantization codecs (a subset of
ggllm_tpu/quant/registry.py): F32 and F16; Q4_0 and Q8_0 both ways; the
dequantizers of Q4_1, Q5_0, Q5_1, Q2_K, Q3_K, Q4_K, Q5_K and Q6_K. Any other
type or direction raises NotImplementedError."""

from __future__ import annotations

import numpy as np

from ggllm_tpu_torch.core.dtypes import GGMLType
from ggllm_tpu_torch.quant import kquants, legacy

_QUANTIZE = {
    GGMLType.Q4_0: legacy.quantize_q4_0,
    GGMLType.Q8_0: legacy.quantize_q8_0,
}

_DEQUANTIZE = {
    GGMLType.Q4_0: legacy.dequantize_q4_0,
    GGMLType.Q4_1: legacy.dequantize_q4_1,
    GGMLType.Q5_0: legacy.dequantize_q5_0,
    GGMLType.Q5_1: legacy.dequantize_q5_1,
    GGMLType.Q8_0: legacy.dequantize_q8_0,
    GGMLType.Q2_K: kquants.dequantize_q2_K,
    GGMLType.Q3_K: kquants.dequantize_q3_K,
    GGMLType.Q4_K: kquants.dequantize_q4_K,
    GGMLType.Q5_K: kquants.dequantize_q5_K,
    GGMLType.Q6_K: kquants.dequantize_q6_K,
}


def can_quantize(gtype: GGMLType) -> bool:
    return gtype in (GGMLType.F32, GGMLType.F16) or gtype in _QUANTIZE


def quantize(gtype: GGMLType, x: np.ndarray) -> np.ndarray:
    """float32 array -> packed uint8 blob in the on-disk block layout."""
    if gtype == GGMLType.F32:
        return np.ascontiguousarray(x, dtype=np.float32).reshape(-1).view(np.uint8)
    if gtype == GGMLType.F16:
        return np.ascontiguousarray(x, dtype=np.float32).astype(np.float16).reshape(-1).view(np.uint8)
    if gtype not in _QUANTIZE:
        raise NotImplementedError(f"quantize: {GGMLType(gtype).name} is not ported")
    return _QUANTIZE[gtype](np.asarray(x))


def dequantize(gtype: GGMLType, blob: np.ndarray, n: int) -> np.ndarray:
    """packed uint8 blob -> float32 array of n elements."""
    blob = np.asarray(blob, dtype=np.uint8)
    if gtype == GGMLType.F32:
        return blob.copy().view(np.float32)[:n]
    if gtype == GGMLType.F16:
        return blob.copy().view(np.float16).astype(np.float32)[:n]
    if gtype not in _DEQUANTIZE:
        raise NotImplementedError(f"dequantize: {GGMLType(gtype).name} is not ported")
    return _DEQUANTIZE[gtype](blob, n)
