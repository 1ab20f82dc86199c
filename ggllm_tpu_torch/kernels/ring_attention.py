"""Ring attention: causal attention over a time-sharded KV cache (port of
ggllm_tpu/kernels/ring_attention.py, which is jnp plus collectives: no
Pallas kernel, so none here either; plain torch plus torch.distributed).

Rank i of n holds query block i (its Sl positions of the chunk) and cache
block i (positions [i * Tl, (i + 1) * Tl)). Each step folds the K/V block
it holds into an online-softmax accumulator in f32, then the blocks move
one hop around the ring (parallel/comm.py ring_shift, batch_isend_irecv),
so a rank never holds more than O(T / n) of the cache: at step s rank i
holds block (i - s) mod n, the JAX order. Semantics match the single-card
attention (models/falcon.py _attention).
"""

from __future__ import annotations

import torch

from ggllm_tpu_torch.kernels import build

NEG_INF = -1e30


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, comm,
                   n_past=0) -> torch.Tensor:
    """q (B, Sl, H, D) this rank's query block; k / v (B, Tl, KV, D) its
    cache block; n_past an int or a (1,) / (B,) int tensor, the global
    position before the chunk (a position a row in the batcher's prefill).
    Returns this rank's (B, Sl, H, D) output block in q's dtype."""
    build.no_grad_inputs("ring_attention", q, k, v)
    B, Sl, H, D = q.shape
    Tl, KV = k.shape[1], k.shape[2]
    G = H // KV
    idx, n = comm.rank, comm.size
    dev = q.device
    npv = torch.as_tensor(n_past, dtype=torch.long, device=dev).reshape(-1).expand(B)
    qf = q.reshape(B, Sl, KV, G, D).to(torch.float32)
    q_pos = npv[:, None] + idx * Sl + torch.arange(Sl, device=dev)[None, :]  # (B, Sl)
    scale = 1.0 / D ** 0.5
    acc = torch.zeros(B, Sl, H, D, dtype=torch.float32, device=dev)
    m = torch.full((B, KV, G, Sl, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(B, KV, G, Sl, 1, dtype=torch.float32, device=dev)
    k, v = k.to(torch.float32), v.to(torch.float32)
    for step in range(n):
        owner = (idx - step) % n  # whose cache block this rank holds now
        k_pos = owner * Tl + torch.arange(Tl, device=dev)
        s = torch.einsum("bskgd,btkd->bkgst", qf, k) * scale
        mask = k_pos[None, None, :] <= q_pos[:, :, None]  # (B, Sl, Tl)
        s = torch.where(mask[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        upd = torch.einsum("bkgst,btkd->bskgd", p, v)
        acc = acc * alpha.permute(0, 3, 1, 2, 4).reshape(B, Sl, H, 1) + upd.reshape(B, Sl, H, D)
        m = m_new
        if step < n - 1:  # the block moves one hop around the ring
            k, v = comm.ring_shift([k, v])
    l_full = l.clamp_min(1e-30).permute(0, 3, 1, 2, 4).reshape(B, Sl, H, 1)
    return (acc / l_full).to(q.dtype)
