"""The split rules of the fallback tree and the arithmetic of split
products (port of ggllm_tpu/parallel/sharding.py).

Where the fused tensor-parallel plan (parallel/tp.py) cannot take a model
(a LoRA-densified key, mixed quant types in a layer, weight_mode "dequant",
dense f16 / f32 weights, heads or blocks the plan does not divide, a data
axis), the JAX package splits the planar tree by GSPMD annotations. Here a
rank holds the same splits and runs the collectives itself (models/falcon.py
SplitFalcon). Each weight (out, in), dense or a QuantTensor, is split along
one dim over the mesh's `model` ranks:

* "out": this rank's rows (the product's output columns), as a Megatron
  column-parallel layer;
* "in": this rank's contraction slice (whole blocks, so a quantized weight's
  planes are sliced, nothing repacked); the partial products add up in a
  psum, as a row-parallel layer;
* None: the whole weight (replicated).

The rules are the JAX ones: wq / ffn_up / lm_head prefer "out", wo /
ffn_down "in"; a quantized weight falls back in -> out -> replicated by its
row and block counts, a dense one to the other dim or replicated; wk / wv
and the cache's K/V heads split only where mp | n_head_kv and n_head_kv >=
mp; the embedding splits its width where mp divides it; the cache's batch
rows split over `data` only where data | B and B >= data.

A product's result on a rank is a Part: the whole output ("full"), the
columns [lo, hi) of it ("slice"), or a partial sum awaiting the psum
("partial"); `columns` turns any Part into the columns a consumer needs with
the fewest collectives.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ggllm_tpu_torch.core.dtypes import TYPE_TRAITS, GGMLType
from ggllm_tpu_torch.ops.linear import linear

OUT, IN = "out", "in"


def qt_spec(rows: int, nb: int, axis_for: str, mp: int) -> str | None:
    """The split of a quantized weight of `rows` rows and `nb` blocks a row
    (_qt_spec:33): the preferred dim where it divides, else "out", else
    "in", else None."""
    out_ok, nb_ok = rows % mp == 0, nb % mp == 0
    if axis_for == IN and nb_ok:
        return IN
    if out_ok:
        return OUT
    return IN if nb_ok else None


def mat_spec(w, axis_for: str, mp: int) -> str | None:
    """The split of one weight (_mat_spec:61): anything with `shape` (out,
    in) and, if quantized, `gtype` (a QuantTensor, or a description of one)."""
    O, K = w.shape
    gtype = getattr(w, "gtype", None)
    if gtype is not None:
        return qt_spec(O, K // TYPE_TRAITS[GGMLType(gtype)].block_size, axis_for, mp)
    size = {OUT: O, IN: K}
    if size[axis_for] % mp == 0:
        return axis_for
    other = IN if axis_for == OUT else OUT
    return other if size[other] % mp == 0 else None


def kv_split(hp, mp: int) -> bool:
    """K/V heads (wk, wv and the cache) split over the model ranks."""
    return hp.n_head_kv % mp == 0 and hp.n_head_kv >= mp


def param_specs(params: dict, hp, mp: int) -> dict:
    """The split of every weight of a Falcon fallback tree (param_specs:78),
    a tree of the same keys ("tok_embeddings", "lm_head" and a dict a layer
    of wq / wk / wv / wo / ffn_up / ffn_down); norms are whole everywhere.
    Leaves of `params` need only `shape` (and `gtype` where quantized)."""
    kv = kv_split(hp, mp)

    def layer(lw):
        return {"wq": mat_spec(lw["wq"], OUT, mp),
                "wk": mat_spec(lw["wk"], OUT, mp) if kv else None,
                "wv": mat_spec(lw["wv"], OUT, mp) if kv else None,
                "wo": mat_spec(lw["wo"], IN, mp),
                "ffn_up": mat_spec(lw["ffn_up"], OUT, mp),
                "ffn_down": mat_spec(lw["ffn_down"], IN, mp)}

    return {"tok_embeddings": IN if params["tok_embeddings"].shape[1] % mp == 0 else None,
            "lm_head": mat_spec(params["lm_head"], OUT, mp),
            "layers": [layer(lw) for lw in params["layers"]]}


def kv_specs(hp, model: int, data: int, batch: int) -> tuple[str | None, str | None]:
    """(the cache's batch split, its K/V heads split) (kv_specs:118):
    "data" where data | batch and batch >= data, "model" where kv_split."""
    rows = "data" if batch % data == 0 and batch >= data else None
    return rows, "model" if kv_split(hp, model) else None


def span(n: int, mp: int, rank: int) -> tuple[int, int]:
    """Rank's [lo, hi) of n split evenly over mp ranks (mp | n)."""
    return rank * (n // mp), (rank + 1) * (n // mp)


# ------------------------------------------------------- split products


class Part(NamedTuple):
    """A product's result on this rank: y is the whole output ("full"), its
    columns [lo, hi) ("slice") or a partial sum ("partial") of n columns."""

    y: torch.Tensor
    form: str
    lo: int
    hi: int
    n: int


def full(y: torch.Tensor) -> Part:
    n = y.shape[-1]
    return Part(y, "full", 0, n, n)


def columns(p: Part, lo: int, hi: int, comm) -> torch.Tensor:
    """The output's columns [lo, hi) from any Part (every rank of the comm
    calls it with the same Part form): a slice of its own as it is, a
    partial sum after the psum, another slice after an all_gather."""
    if p.form == "slice" and (p.lo, p.hi) == (lo, hi):
        return p.y
    if p.form == "partial":
        y = comm.psum(p.y) if comm.size > 1 else p.y
    elif p.form == "slice":
        y = comm.all_gather(p.y, -1) if comm.size > 1 else p.y
    else:
        y = p.y
    return y if (lo, hi) == (0, p.n) else y[..., lo:hi]


def whole(p: Part, comm) -> torch.Tensor:
    return columns(p, 0, p.n, comm)


def split_linear(w, spec: str | None, x: Part, comm, kernels: bool = True,
                 out_dtype=None) -> Part:
    """x W^T for this rank's split of W (spec) and an input Part, by
    ops/linear.py: "out" a local product on the whole x, giving this rank's
    output columns; "in" the product of this rank's slice of x, a partial
    sum; None the whole product."""
    O, K = w.shape
    mp, r = comm.size, comm.rank
    if spec == OUT:
        y = linear(w, whole(x, comm), out_dtype, kernels)
        return Part(y, "slice", *span(O * mp, mp, r), O * mp)
    if spec == IN:
        lo, hi = span(K * mp, mp, r)
        return Part(linear(w, columns(x, lo, hi, comm), out_dtype, kernels), "partial", 0, O, O)
    return full(linear(w, whole(x, comm), out_dtype, kernels))


def combine(parts: list[Part], comm) -> torch.Tensor:
    """The sum of whole outputs of several Parts with one psum for all the
    partial sums (a row-parallel pair's one all-reduce)."""
    partial = [p.y for p in parts if p.form == "partial"]
    out = None
    if partial:
        out = sum(partial[1:], partial[0])
        if comm.size > 1:
            out = comm.psum(out)
    for p in parts:
        if p.form != "partial":
            y = whole(p, comm)
            out = y if out is None else out + y
    return out
