"""Quantization type registry (a copy of ggllm_tpu/core/dtypes.py).

The enum values and block geometry mirror the reference's on-disk format
(ggml.h:246-266, ggml.c:879-924, k_quants.h:20-83) so that GGCC model files
are interoperable; the device representation is planar (struct-of-arrays)
rather than interleaved blocks — see ggllm_tpu_torch.quant.planar.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

# Block sizes
QK4_0 = 32
QK4_1 = 32
QK5_0 = 32
QK5_1 = 32
QK8_0 = 32
QK8_1 = 32
QK_K = 256  # K-quant super-block size


class GGMLType(enum.IntEnum):
    """On-disk tensor dtypes; values match ggml.h:246-266."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    # 4, 5: removed upstream (Q4_2 / Q4_3)
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    I8 = 16
    I16 = 17
    I32 = 18


class FType(enum.IntEnum):
    """Model-file-level ftype; values match llama_ftype (libfalcon.h:103-120)."""

    ALL_F32 = 0
    MOSTLY_F16 = 1
    MOSTLY_Q4_0 = 2
    MOSTLY_Q4_1 = 3
    MOSTLY_Q4_1_SOME_F16 = 4
    MOSTLY_Q8_0 = 7
    MOSTLY_Q5_0 = 8
    MOSTLY_Q5_1 = 9
    MOSTLY_Q2_K = 10
    MOSTLY_Q3_K_S = 11
    MOSTLY_Q3_K_M = 12
    MOSTLY_Q3_K_L = 13
    MOSTLY_Q4_K_S = 14
    MOSTLY_Q4_K_M = 15
    MOSTLY_Q5_K_S = 16
    MOSTLY_Q5_K_M = 17
    MOSTLY_Q6_K = 18


@dataclass(frozen=True)
class TypeTraits:
    """Block geometry for one quant type."""

    name: str
    block_size: int  # elements per block
    type_size: int  # bytes per block
    is_quantized: bool

    @property
    def bits_per_weight(self) -> float:
        return 8.0 * self.type_size / self.block_size


# byte sizes follow the reference block structs exactly:
#   q4_0: fp16 d + 16B nibbles                      = 18
#   q4_1: fp16 d + fp16 m + 16B                     = 20
#   q5_0: fp16 d + 4B qh + 16B                      = 22
#   q5_1: fp16 d + fp16 m + 4B qh + 16B             = 24
#   q8_0: fp16 d + 32B                              = 34
#   q8_1: f32 d + f32 s + 32B                       = 40
#   q2_K: 16B scales + 64B qs + fp16 d + fp16 dmin  = 84
#   q3_K: 32B hmask + 64B qs + 12B scales + fp16 d  = 110
#   q4_K: fp16 d + fp16 dmin + 12B scales + 128B qs = 144
#   q5_K: q4_K + 32B qh                             = 176
#   q6_K: 128B ql + 64B qh + 16B scales + fp16 d    = 210
#   q8_K: f32 d + 256B qs + 16x i16 bsums           = 292
TYPE_TRAITS: dict[GGMLType, TypeTraits] = {
    GGMLType.F32: TypeTraits("f32", 1, 4, False),
    GGMLType.F16: TypeTraits("f16", 1, 2, False),
    GGMLType.Q4_0: TypeTraits("q4_0", QK4_0, 18, True),
    GGMLType.Q4_1: TypeTraits("q4_1", QK4_1, 20, True),
    GGMLType.Q5_0: TypeTraits("q5_0", QK5_0, 22, True),
    GGMLType.Q5_1: TypeTraits("q5_1", QK5_1, 24, True),
    GGMLType.Q8_0: TypeTraits("q8_0", QK8_0, 34, True),
    GGMLType.Q8_1: TypeTraits("q8_1", QK8_1, 40, True),
    GGMLType.Q2_K: TypeTraits("q2_K", QK_K, 84, True),
    GGMLType.Q3_K: TypeTraits("q3_K", QK_K, 110, True),
    GGMLType.Q4_K: TypeTraits("q4_K", QK_K, 144, True),
    GGMLType.Q5_K: TypeTraits("q5_K", QK_K, 176, True),
    GGMLType.Q6_K: TypeTraits("q6_K", QK_K, 210, True),
    GGMLType.Q8_K: TypeTraits("q8_K", QK_K, 292, True),
    GGMLType.I8: TypeTraits("i8", 1, 1, False),
    GGMLType.I16: TypeTraits("i16", 1, 2, False),
    GGMLType.I32: TypeTraits("i32", 1, 4, False),
}

_BY_NAME = {t.name.lower(): g for g, t in TYPE_TRAITS.items()}


def type_from_name(name: str) -> GGMLType:
    return _BY_NAME[name.lower()]


def row_nbytes(gtype: GGMLType, n: int) -> int:
    """Bytes needed to store a row of n elements of this type."""
    tt = TYPE_TRAITS[gtype]
    assert n % tt.block_size == 0, f"{n} not divisible by block size {tt.block_size} of {tt.name}"
    return (n // tt.block_size) * tt.type_size
