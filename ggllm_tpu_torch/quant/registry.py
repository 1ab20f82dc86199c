"""Dispatch over the quantization codecs (port of
ggllm_tpu/quant/registry.py's numpy codecs): F32, F16 and every quantized
format both ways (Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, Q8_1, Q2_K … Q6_K, Q8_K),
bit for bit the JAX package's numpy codecs. quantize(native=True) takes the
multithreaded C++ codecs instead (quant/native.py, the same bytes), which
raise where they cannot be built."""

from __future__ import annotations

import numpy as np

from ggllm_tpu_torch.core.dtypes import GGMLType
from ggllm_tpu_torch.quant import kquants, legacy

_QUANTIZE = {
    GGMLType.Q4_0: legacy.quantize_q4_0,
    GGMLType.Q4_1: legacy.quantize_q4_1,
    GGMLType.Q5_0: legacy.quantize_q5_0,
    GGMLType.Q5_1: legacy.quantize_q5_1,
    GGMLType.Q8_0: legacy.quantize_q8_0,
    GGMLType.Q8_1: legacy.quantize_q8_1,
    GGMLType.Q2_K: kquants.quantize_q2_K,
    GGMLType.Q3_K: kquants.quantize_q3_K,
    GGMLType.Q4_K: kquants.quantize_q4_K,
    GGMLType.Q5_K: kquants.quantize_q5_K,
    GGMLType.Q6_K: kquants.quantize_q6_K,
    GGMLType.Q8_K: kquants.quantize_q8_K,
}

_DEQUANTIZE = {
    GGMLType.Q4_0: legacy.dequantize_q4_0,
    GGMLType.Q4_1: legacy.dequantize_q4_1,
    GGMLType.Q5_0: legacy.dequantize_q5_0,
    GGMLType.Q5_1: legacy.dequantize_q5_1,
    GGMLType.Q8_0: legacy.dequantize_q8_0,
    GGMLType.Q8_1: legacy.dequantize_q8_1,
    GGMLType.Q2_K: kquants.dequantize_q2_K,
    GGMLType.Q3_K: kquants.dequantize_q3_K,
    GGMLType.Q4_K: kquants.dequantize_q4_K,
    GGMLType.Q5_K: kquants.dequantize_q5_K,
    GGMLType.Q6_K: kquants.dequantize_q6_K,
    GGMLType.Q8_K: kquants.dequantize_q8_K,
}


def can_quantize(gtype: GGMLType) -> bool:
    return gtype in (GGMLType.F32, GGMLType.F16) or gtype in _QUANTIZE


def quantize(gtype: GGMLType, x: np.ndarray, native: bool = False) -> np.ndarray:
    """float32 array -> packed uint8 blob in the on-disk block layout
    (native: through the C++ codecs)."""
    if gtype == GGMLType.F32:
        return np.ascontiguousarray(x, dtype=np.float32).reshape(-1).view(np.uint8)
    if gtype == GGMLType.F16:
        return np.ascontiguousarray(x, dtype=np.float32).astype(np.float16).reshape(-1).view(np.uint8)
    if gtype not in _QUANTIZE:
        raise NotImplementedError(f"quantize: {GGMLType(gtype).name} has no quantizer")
    if native:
        from ggllm_tpu_torch.quant import native as native_mod

        return native_mod.quantize(int(gtype), x)
    return _QUANTIZE[gtype](np.asarray(x))


def dequantize(gtype: GGMLType, blob: np.ndarray, n: int) -> np.ndarray:
    """packed uint8 blob -> float32 array of n elements."""
    blob = np.asarray(blob, dtype=np.uint8)
    if gtype == GGMLType.F32:
        return blob.copy().view(np.float32)[:n]
    if gtype == GGMLType.F16:
        return blob.copy().view(np.float16).astype(np.float32)[:n]
    if gtype not in _DEQUANTIZE:
        raise NotImplementedError(f"dequantize: {GGMLType(gtype).name} has no dequantizer")
    return _DEQUANTIZE[gtype](blob, n)
