"""Tensor-parallel weight shards (port of ggllm_tpu/parallel/tp.py).

Every rank runs the single-card forward on its own weight blocks, with one
all-reduce a Falcon layer (two a LLaMA layer), as the JAX shard_map path
does. The merged layouts make this natural (Falcon, rank d of mp):

* "wqkvu": [Q_d; K; V; up_d] rows. Each rank owns h_local = ceil(H / mp)
  query heads (the last rank's missing heads zero rows when mp does not
  divide H: Falcon-7B's 71 heads at mp = 2 give 36 and 35 + one zero head)
  and F / mp FFN rows; the K / V rows are whole on every rank for MQA and
  split by K/V head for GQA (mp | n_head_kv, mp | n_head);
* "w_od": the contraction splits into the rank's [wo cols of its heads |
  down cols of its FFN slice]; the partial outputs add up in one psum, which
  also completes the parallel attention + FFN residual;
* 40B-style models (separate norms) keep "wqkv" and "ffn_up" apart;
* LLaMA (KV = H): heads and the FFN width split; "wqkv" [q_d; k_d; v_d],
  "w13" [w1_d; w3_d], and wo / w2 each split along the contraction.

Embeddings, norms and lm_head are whole on every rank; so is the KV cache
for MQA, while GQA and LLaMA ranks hold their own K/V heads. A rank reads
only its shard's rows and block columns from the memory-mapped file, in the
port's planar layout (quant/planar.py: planes are (rows, blocks, ...), so a
row range and a block range are slices); it builds no stacked device axis,
since a rank holds one block, and the JAX package's int16 scale-plane
workaround has no counterpart. What the plan cannot take (a non-quantized
weight, mixed quant types in a layer, shard widths that are not whole
blocks) raises NotImplementedError here, and io/loader.py then builds the
fallback tree (parallel/sharding.py) for Falcon.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from ggllm_tpu_torch.core.dtypes import GGMLType, TYPE_TRAITS
from ggllm_tpu_torch.quant import planar

class TpPlan:
    """Static TP geometry of one model (either family) at mp ranks."""

    def __init__(self, hp, mp: int):
        self.mp = mp
        self.H, self.KV, self.D, self.F = hp.n_head, hp.n_head_kv, hp.head_dim, hp.n_ff
        if self.KV > 1:
            if self.KV % mp or self.H % mp:
                raise ValueError(f"grouped-query tensor parallelism needs mp | n_head_kv and"
                                 f" mp | n_head: {self.H} heads, {self.KV} K/V heads, mp {mp}")
            self.h_local, self.kv_local = self.H // mp, self.KV // mp
        else:
            self.h_local, self.kv_local = -(-self.H // mp), 1  # pad q heads
        if self.F % mp:
            raise ValueError(f"tensor parallelism needs mp | n_ff: n_ff {self.F}, mp {mp}")
        self.f_local = self.F // mp

    def local_static(self, st):
        """The model's Static at one rank's shard (either family)."""
        return replace(st, n_head=self.h_local, n_head_kv=self.kv_local, n_ff=self.f_local)

    def q_rows(self, rank: int) -> tuple[int, int]:
        """The global Q rows [lo, hi) rank owns (hi - lo < h_local * D on a
        rank with padded heads)."""
        q = self.H * self.D
        return min(q, rank * self.h_local * self.D), min(q, (rank + 1) * self.h_local * self.D)

    def kv_heads(self, rank: int) -> tuple[int, int]:
        """The global K/V heads [lo, hi) rank's cache holds."""
        if self.KV == 1:
            return 0, 1
        return rank * self.kv_local, (rank + 1) * self.kv_local


class Shard:
    """One quantized weight matrix read from a model file: its planar planes
    for a row range and a block-column range (nothing else is read)."""

    def __init__(self, mf, name: str):
        t = mf.tensors[name]
        self.gtype = GGMLType(t.gtype)
        if not self.gtype.name.startswith("Q"):
            raise NotImplementedError(f"{name} is {self.gtype.name}: tensor parallelism takes"
                                      " quantized weights")
        self.rows, self.cols = t.shape
        self.bs = TYPE_TRAITS[self.gtype].block_size
        self._mf, self._name = mf, name

    def planes(self, rows=None, blocks=None, pad_rows: int = 0, pad_blocks: int = 0) -> dict:
        r0, r1 = rows or (0, self.rows)
        b0, b1 = blocks or (0, self.cols // self.bs)
        ts = TYPE_TRAITS[self.gtype].type_size
        blob = self._mf.tensor_blob(self._name).reshape(self.rows, -1, ts)[r0:r1, b0:b1]
        out = planar.to_planes(self.gtype, np.ascontiguousarray(blob).reshape(-1), r1 - r0,
                               (b1 - b0) * self.bs)
        if pad_rows > r1 - r0 or pad_blocks > b1 - b0:  # zero rows / blocks: zero weights
            out = {k: np.pad(v, [(0, max(0, pad_rows - (r1 - r0))),
                                 (0, max(0, pad_blocks - (b1 - b0)))] + [(0, 0)] * (v.ndim - 2))
                   for k, v in out.items()}
        return out


def _cat(parts: list[dict], axis: int) -> dict:
    return {k: np.concatenate([p[k] for p in parts], axis) for k in parts[0]}


def _uniform(shards: dict) -> GGMLType:
    gts = {s.gtype for s in shards.values()}
    if len(gts) != 1:
        raise NotImplementedError(
            f"tensor parallelism merges a layer's weights: one quant type a layer, not"
            f" {sorted(g.name for g in gts)}")
    gt = gts.pop()
    return gt


def _check_blocks(plan: TpPlan, gt: GGMLType) -> int:
    bs = TYPE_TRAITS[gt].block_size
    if (plan.h_local * plan.D) % bs or plan.f_local % bs:
        raise NotImplementedError(
            f"{gt.name} blocks of {bs} do not divide the shard widths {plan.h_local * plan.D}"
            f" and {plan.f_local} at mp {plan.mp}")
    return bs


def falcon_layer(mf, names: dict, plan: TpPlan, rank: int, merge_up: bool) -> dict:
    """Rank's Falcon layer blocks as {key: (gtype, (out, in), planes)}
    (build_tp_layer:106 for one device)."""
    sh = {k: Shard(mf, names[k]) for k in ("qkv", "ffn_up", "wo", "ffn_down")}
    gt = _uniform(sh)
    bs = _check_blocks(plan, gt)
    D, E = plan.D, sh["qkv"].cols
    q_rows, k_rows = plan.H * D, plan.KV * D
    q_lo, q_hi = plan.q_rows(rank)
    h0, h1 = plan.kv_heads(rank)
    kv_lo, kv_hi = q_rows + h0 * D, q_rows + h1 * D
    hq, fl = plan.h_local * D, plan.f_local
    parts = [sh["qkv"].planes((q_lo, q_hi), pad_rows=hq),
             sh["qkv"].planes((kv_lo, kv_hi)),
             sh["qkv"].planes((kv_lo + k_rows, kv_hi + k_rows))]
    up = sh["ffn_up"].planes((rank * fl, (rank + 1) * fl))
    n_qkv = hq + 2 * (kv_hi - kv_lo)
    out = {}
    if merge_up:
        out["wqkvu"] = (gt, (n_qkv + fl, E), _cat(parts + [up], 0))
    else:
        out["wqkv"] = (gt, (n_qkv, E), _cat(parts, 0))
        out["ffn_up"] = (gt, (fl, E), up)
    od = [sh["wo"].planes(blocks=(q_lo // bs, q_hi // bs), pad_blocks=hq // bs),
          sh["ffn_down"].planes(blocks=(rank * fl // bs, (rank + 1) * fl // bs))]
    out["w_od"] = (gt, (sh["wo"].rows, hq + fl), _cat(od, 1))
    return out


def llama_layer(mf, names: dict, plan: TpPlan, rank: int) -> dict:
    """Rank's LLaMA layer blocks as {key: (gtype, (out, in), planes)}
    (build_tp_llama_layer:212 for one device)."""
    sh = {k: Shard(mf, names[k]) for k in ("wq", "wk", "wv", "wo", "w1", "w2", "w3")}
    gt = _uniform(sh)
    bs = _check_blocks(plan, gt)
    hD, fl, E = plan.h_local * plan.D, plan.f_local, sh["wq"].cols
    h, f = (rank * hD, (rank + 1) * hD), (rank * fl, (rank + 1) * fl)
    return {
        "wqkv": (gt, (3 * hD, E), _cat([sh[k].planes(h) for k in ("wq", "wk", "wv")], 0)),
        "w13": (gt, (2 * fl, E), _cat([sh[k].planes(f) for k in ("w1", "w3")], 0)),
        "wo": (gt, (E, hD), sh["wo"].planes(blocks=(h[0] // bs, h[1] // bs))),
        "w2": (gt, (E, fl), sh["w2"].planes(blocks=(f[0] // bs, f[1] // bs))),
    }
