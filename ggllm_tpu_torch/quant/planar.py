"""Planar (struct-of-arrays) device layout for quantized weights (the
Q4_0/Q8_0 subset of ggllm_tpu/quant/planar.py).

Each quantized 2-D weight splits into contiguous planes in ggml's own
row-major block order: `qs` (rows, nb, 16) uint8 nibbles in ggml's
half-split order (Q4_0) or (rows, nb, 32) int8 codes (Q8_0), and `d`
(rows, nb) float16 scales. A warp walking K along one output row reads
both planes coalesced, so this is also the Hopper kernel layout: loading a
file is a copy with no repack. (The JAX package keeps `d` as float32 and
repacks into TPU bit-planes, kernels/layout.py; neither is needed here.)
"""

from __future__ import annotations

import numpy as np

from ggllm_tpu_torch.core.dtypes import GGMLType, TYPE_TRAITS


def to_planes(gtype: GGMLType, blob: np.ndarray, rows: int, cols: int) -> dict[str, np.ndarray]:
    """Packed row-major blob -> dict of planes. cols = input dim (blocked)."""
    if gtype not in (GGMLType.Q4_0, GGMLType.Q8_0):
        raise NotImplementedError(f"no planar layout for {GGMLType(gtype).name} in the port")
    ts = TYPE_TRAITS[gtype].type_size
    b = np.asarray(blob, dtype=np.uint8).reshape(rows, -1, ts)
    nb = b.shape[1]
    assert nb * TYPE_TRAITS[gtype].block_size == cols, (gtype, rows, cols, nb)
    d = b[:, :, 0:2].copy().view(np.float16)[..., 0]
    if gtype == GGMLType.Q4_0:
        return {"d": d, "qs": b[:, :, 2:18].copy()}
    return {"d": d, "qs": b[:, :, 2:34].copy().view(np.int8)}
