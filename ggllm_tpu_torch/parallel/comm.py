"""Collectives of one mesh axis on torch.distributed: the counterparts of
the JAX axis primitives the parallel engines use (jax.lax.psum, pmax,
all_gather(tiled=True) and the ring shift of ppermute).

Under NCCL every collective runs on the card, in the caller's stream, so a
CUDA graph captures it. Gloo has no CUDA path the engines can rely on (and
none for point-to-point): a CUDA tensor under gloo is copied to host memory
in f32, reduced or exchanged there, and copied back; `STAGED` counts each
such collective by name, so a run can say how many it staged. The
arithmetic around the collectives stays on the card. A CPU tensor under
gloo goes as it is (in f32 where its dtype is another).

A Comm over no process group (a mesh of one rank made without
init_distributed) is the identity.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

STAGED: collections.Counter = collections.Counter()  # host-staged collectives, by name


class Comm:
    """The collectives of one group of `size` ranks; `rank` is this rank's
    index in it and `ranks` their global ranks, in order."""

    def __init__(self, group, ranks: list[int], rank: int, backend: str | None):
        self.group, self.ranks, self.rank = group, list(ranks), rank
        self.size = len(self.ranks)
        self.backend = backend  # None: no process group

    def _host(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """The tensor a gloo collective takes for t: t itself where it is an
        f32 CPU tensor, else an f32 host copy (counted as staged when t is
        on the card)."""
        if t.is_cuda:
            STAGED[name] += 1
        if t.is_cuda or t.dtype != torch.float32:
            return t.detach().to("cpu", torch.float32)
        return t

    def _reduce(self, t: torch.Tensor, op, name: str) -> torch.Tensor:
        if self.backend is None:
            return t
        if self.backend == "nccl":
            dist.all_reduce(t, op=op, group=self.group)
            return t
        h = self._host(t, name)
        dist.all_reduce(h, op=op, group=self.group)
        if h is not t:
            t.copy_(h)
        return t

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the group, in place (jax.lax.psum); returns t."""
        return self._reduce(t, dist.ReduceOp.SUM, "psum")

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """Maximum over the group, in place (jax.lax.pmax); returns t."""
        return self._reduce(t, dist.ReduceOp.MAX, "pmax")

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's t concatenated along dim in rank order
        (jax.lax.all_gather(..., tiled=True))."""
        if self.backend is None:
            return t
        t = t.contiguous()
        if self.backend == "nccl":
            parts = [torch.empty_like(t) for _ in range(self.size)]
            dist.all_gather(parts, t, group=self.group)
            return torch.cat(parts, dim)
        h = self._host(t, "all_gather")
        parts = [torch.empty_like(h) for _ in range(self.size)]
        dist.all_gather(parts, h.contiguous(), group=self.group)
        return torch.cat(parts, dim).to(t.device, t.dtype)

    def ring_shift(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each tensor sent one hop around the ring (to rank + 1) and the
        previous rank's received in its place (jax.lax.ppermute with the
        permutation i -> i + 1 mod n), through one batch_isend_irecv."""
        if self.backend is None or self.size == 1:
            return tensors
        nxt = self.ranks[(self.rank + 1) % self.size]
        prv = self.ranks[(self.rank - 1) % self.size]
        staged = self.backend != "nccl"
        send = [self._host(t, "ring_shift") if staged else t.contiguous() for t in tensors]
        recv = [torch.empty_like(s) for s in send]
        ops = [dist.P2POp(dist.isend, s, nxt, self.group) for s in send]
        ops += [dist.P2POp(dist.irecv, r, prv, self.group) for r in recv]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return [r.to(t.device, t.dtype) if staged else r for r, t in zip(recv, tensors)]

    def broadcast_object(self, obj, src: int = 0):
        """obj of the group's rank src, on every rank."""
        if self.backend is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=self.ranks[src], group=self.group)
        return box[0]
