"""Memory-fit planning for `-ts auto` (port of ggllm_tpu/parallel/plan.py):
the reference's VRAM auto-offload simulation (libfalcon.cpp:1813-1890) as
the choice of the smallest tensor-parallel mesh whose per-card footprint
fits.

The JAX module's figures were taken on its TPU (15.75 GiB of HBM, a 1.06
layout overhead) and do not carry over: the card's memory comes from
torch.cuda.get_device_properties (the host's memory for CPU ranks), and the
overhead is the port's own loaded layout (quant/planar.py planes, dense
tensors in the compute dtype, norms in f32) over the file's bytes. Both can
be passed in, which is how the tests hold this module to the JAX plans.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from ggllm_tpu_torch.core.config import EngineConfig
from ggllm_tpu_torch.core.dtypes import GGMLType, TYPE_TRAITS

HEADROOM_FRACTION = 0.10  # activations, workspaces and fragmentation
_EMBEDDINGS = ("transformer.word_embeddings.weight", "tok_embeddings.weight")  # loaded dense


def device_memory(device="cuda") -> int:
    """Bytes of memory of `device`: the card's total, or the host's for the
    CPU."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def model_bytes(mf) -> int:
    """The file's tensor bytes (the mmap'd footprint the reference counts)."""
    return sum(t.nbytes for t in mf.tensors.values())


@lru_cache(maxsize=None)
def _planar_block_bytes(gtype: int) -> int:
    from ggllm_tpu_torch.quant import planar

    tr = TYPE_TRAITS[GGMLType(gtype)]
    planes = planar.to_planes(GGMLType(gtype), np.zeros(tr.type_size, np.uint8), 1,
                              tr.block_size)
    return sum(p.nbytes for p in planes.values())


def loaded_bytes(mf, cfg: EngineConfig | None = None) -> int:
    """Bytes of the port's loaded tree of mf: quantized matrices as planar
    planes, the embeddings (whatever their type) and other 2-D tensors in the
    compute dtype, 1-D ones in f32."""
    cfg = cfg or EngineConfig()
    dense = 4 if cfg.compute_dtype == "float32" else 2
    total = 0
    for name, t in mf.tensors.items():
        gt = GGMLType(t.gtype)
        if gt.name.startswith("Q") and name not in _EMBEDDINGS:
            total += t.n_elements // TYPE_TRAITS[gt].block_size * _planar_block_bytes(int(gt))
        else:
            total += t.n_elements * (dense if len(t.shape) == 2 else 4)
    return total


def kernel_overhead(mf, cfg: EngineConfig | None = None) -> float:
    """The port's loaded bytes over the file's."""
    return loaded_bytes(mf, cfg) / max(1, model_bytes(mf))


def kv_bytes(hp, cfg: EngineConfig, batch: int = 1) -> int:
    """The cache's bytes, (L, 2, B, kv_T, KV, D) at the engine's kv_T."""
    from ggllm_tpu_torch.engine.engine import kv_len

    kv_T = kv_len(cfg)
    per = {"int8": 1 + 4 / hp.head_dim, "float32": 4}.get(str(cfg.kv_dtype), 2)
    return int(hp.n_layer * 2 * batch * kv_T * hp.n_head_kv * hp.head_dim * per)


@dataclass
class FitPlan:
    model_axis: int  # suggested mesh model-axis size (1 = one card)
    kv_shard: str  # "heads" (TP) or "sequence"
    per_chip_bytes: int
    hbm_bytes: int

    @property
    def fits(self) -> bool:
        return self.per_chip_bytes <= self.hbm_bytes * (1 - HEADROOM_FRACTION)


def suggest_tensor_split(mf, cfg: EngineConfig | None = None, batch: int = 1,
                         hbm_bytes: int | None = None, max_chips: int = 64,
                         overhead: float | None = None) -> FitPlan:
    """Smallest power-of-two model axis whose per-card footprint fits
    (suggest_tensor_split:52): weights split over the axis, the cache too
    for GQA; when the heads divide no further and it still does not fit,
    sequence sharding (weights whole, the cache split along time).
    hbm_bytes: default device_memory(); overhead: default
    kernel_overhead(mf, cfg)."""
    cfg = cfg or EngineConfig()
    hp = mf.hparams
    hbm_bytes = device_memory() if hbm_bytes is None else hbm_bytes
    overhead = kernel_overhead(mf, cfg) if overhead is None else overhead
    wb = int(model_bytes(mf) * overhead)
    limit = hbm_bytes * (1 - HEADROOM_FRACTION)

    mp = 1
    while mp <= max_chips:
        kvb = kv_bytes(hp, cfg, batch)
        if hp.n_head_kv > 1 and hp.n_head_kv % mp == 0:
            kvb //= mp
        plan = FitPlan(mp, "heads", int(wb // mp + kvb), hbm_bytes)
        if plan.fits:
            return plan
        nxt = mp * 2
        if hp.n_head_kv > 1 and (hp.n_head % nxt or hp.n_head_kv % nxt):
            break
        if hp.n_ff % nxt:
            break
        mp = nxt

    kvb = kv_bytes(hp, cfg, batch)
    mp_seq = 1
    while mp_seq < max_chips and wb + kvb // mp_seq > limit:
        mp_seq *= 2
    return FitPlan(mp_seq, "sequence", int(wb + kvb // mp_seq), hbm_bytes)


@dataclass
class MeshPlan:
    """A mesh for n cards: the smallest fitting TP axis, the remaining
    cards as data-parallel replicas (suggest_mesh:108)."""

    data: int
    model: int
    kv_shard: str
    per_chip_bytes: int
    hbm_bytes: int

    @property
    def fits(self) -> bool:
        return self.per_chip_bytes <= self.hbm_bytes * (1 - HEADROOM_FRACTION)


def suggest_mesh(mf, n_chips: int, cfg: EngineConfig | None = None, batch: int = 1,
                 hbm_bytes: int | None = None, overhead: float | None = None) -> MeshPlan:
    plan = suggest_tensor_split(mf, cfg, batch, hbm_bytes, max_chips=n_chips,
                                overhead=overhead)
    model = min(plan.model_axis, n_chips)
    data = max(1, n_chips // model)
    return MeshPlan(data, model, plan.kv_shard, plan.per_chip_bytes, plan.hbm_bytes)
