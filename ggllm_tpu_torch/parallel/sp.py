"""Sequence-parallel Falcon (port of ggllm_tpu/parallel/sp.py): the KV
cache split along time over the mesh's ranks, the weights whole on each.

Rank i of mp holds cache positions [i * Tl, (i + 1) * Tl), Tl = kv_T / mp
(the engine rounds kv_T up to a multiple of mp), so a context's cache costs
each rank 1 / mp of it.

* prefill (S > 1): the chunk is padded to a multiple of mp (the padded
  positions write beyond the prompt, where attention never reads before a
  later write), each rank embeds and projects its Sl = S / mp block, the new
  K/V rows of every block are all-gathered (small: S x KV x D) and each rank
  writes those that fall in its time window; attention is ring attention
  (kernels/ring_attention.py); the last position's logits (or hidden state)
  come from the rank whose block holds it, by a psum over zeros elsewhere;
  logits_all gathers every rank's rows;
* decode (S == 1): every rank runs the whole token; the rank whose window
  holds the position writes its K/V; each rank attends over its window and
  the partial softmax sums merge by a pmax and two psums (merged_attention).
  With a decode chunk's `pending` buffer (the batcher's int8 rows,
  chunk-deferred as on one card) the cache is read-only and [current token;
  pending] is appended on rank 0 only, so the merge counts it once.

SpModel wraps the single-card Falcon module with this forward and the same
call contract, so the engine drives it as it drives the model.
"""

from __future__ import annotations

import torch
from torch import nn

from ggllm_tpu_torch.kernels.ring_attention import ring_attention
from ggllm_tpu_torch.models.falcon import _positions, layer_norm, select_last
from ggllm_tpu_torch.ops import kvcache
from ggllm_tpu_torch.ops.linear import linear
from ggllm_tpu_torch.ops.rope import rope_cos_sin

NEG_HALF = -5e29  # a running max below this saw no valid key


def _leaves(kv, kv_new: torch.Tensor):
    """(cache leaf, its new values) pairs: (codes, q), (scales, s) for an
    int8 cache, else (cache, kv_new)."""
    if kvcache.is_quantized(kv):
        q, s = kvcache.quantize_new(kv_new)
        return ((kv[0], q), (kv[1], s))
    return ((kv, kv_new),)


def write_layer_local(kv, kv_new: torch.Tensor, l: int, n_past, idx: int, Tl: int):
    """Write kv_new (2, B, S, KV, D), at global positions [n_past, n_past +
    S), into layer l of this rank's window [idx * Tl, (idx + 1) * Tl);
    positions outside it are dropped (write_layer_local:66). n_past: an int,
    or a (1,) / (B,) device tensor; with S == 1 the write stays on the
    device (a decode step a graph can capture: the rows outside the window
    write back their old values), else the positions are read on the host."""
    B, S = kv_new.shape[1], kv_new.shape[2]
    if isinstance(n_past, torch.Tensor) and S == 1:
        pos = n_past.reshape(-1).to(torch.long) - idx * Tl
        valid = (pos >= 0) & (pos < Tl)
        at = kvcache._flat_index(pos.clamp(0, Tl - 1), B, Tl, 1)
        for leaf, new in _leaves(kv, kv_new):
            flat = leaf[l].view(2, B * Tl, *leaf.shape[4:])
            old = flat.index_select(1, at)
            val = new.reshape(2, B, *new.shape[3:]).to(flat.dtype)
            flat.index_copy_(1, at, torch.where(valid.reshape(1, -1, 1, 1), val, old))
        return kv
    starts = ([int(n_past)] * B if not isinstance(n_past, torch.Tensor)
              else [int(p) for p in n_past.reshape(-1).expand(B).tolist()])
    for leaf, new in _leaves(kv, kv_new):
        for b, p in enumerate(starts):
            lo = p - idx * Tl  # the chunk's first position in this window
            s0, s1 = max(0, -lo), min(S, Tl - lo)
            if s0 < s1:
                leaf[l, :, b, lo + s0:lo + s1] = new[:, b, s0:s1].to(leaf.dtype)
    return kv


def merged_attention(q, k, v, n_past, idx: int, Tl: int, comm, append=None,
                     append_valid: int | None = None):
    """Decode attention over the time-sharded cache (merged_attention:106):
    this rank's partial softmax statistics in f32 over its window, merged by
    a pmax and two psums. append (2, B, A, KV, D) with append_valid:
    chunk-deferred K/V not in the cache, counted on rank 0 only; the cache is
    then valid strictly below n_past - (append_valid - 1)."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    dev = q.device
    scale = 1.0 / D ** 0.5
    qg = q.reshape(B, S, KV, G, D).to(torch.float32)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.to(torch.float32)) * scale
    q_pos = _positions(n_past, B, S, dev)  # (B, S) global
    k_pos = idx * Tl + torch.arange(Tl, device=dev)
    v = v.to(torch.float32)
    if append is not None:
        cache_start = q_pos[:, 0] - (append_valid - 1)
        mask = (k_pos[None, None, :] < cache_start[:, None, None]).expand(B, S, Tl)
    else:
        mask = k_pos[None, None, :] <= q_pos[:, :, None]
    s = torch.where(mask[:, None, None], s, -1e30)
    if append is not None:
        A = append.shape[2]
        sa = torch.einsum("bskgd,btkd->bkgst", qg, append[0].to(torch.float32)) * scale
        amask = (torch.arange(A, device=dev) < append_valid) & (idx == 0)
        sa = torch.where(amask, sa, -1e30)
        s = torch.cat([s, sa], dim=-1)
        v = torch.cat([v, append[1].to(torch.float32)], dim=1)
    m_loc = s.amax(dim=-1, keepdim=True)  # (B, KV, G, S, 1)
    seen = m_loc > NEG_HALF
    p = torch.where(seen, torch.exp(s - m_loc), 0.0)
    l_loc = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgst,btkd->bskgd", p, v)  # (B, S, KV, G, D)
    m_glob = comm.pmax(m_loc.clone())
    coef = torch.where(seen, torch.exp(m_loc - m_glob), 0.0)
    l_glob = comm.psum(l_loc * coef)
    acc_glob = comm.psum(acc * coef.permute(0, 3, 1, 2, 4))
    out = acc_glob / l_glob.permute(0, 3, 1, 2, 4).clamp_min(1e-30)
    return out.reshape(B, S, H, D).to(q.dtype)


class SpModel(nn.Module):
    """A Falcon module run sequence-parallel over `comm` (the mesh's model
    axis): Falcon.forward's contract on a time-sharded cache."""

    def __init__(self, model: nn.Module, comm):
        super().__init__()
        self.model, self.comm, self.st = model, comm, model.st

    def forward(self, tokens: torch.Tensor, kv, n_past, inv_freq: torch.Tensor,
                logits_all: bool = False, last_pos=None, pending: torch.Tensor | None = None,
                n_pend: int = 0, output_hidden: bool = False):
        if tokens.shape[1] == 1:
            return self._decode(tokens, kv, n_past, inv_freq, pending, n_pend, output_hidden)
        return self._prefill(tokens, kv, n_past, inv_freq, logits_all, last_pos, output_hidden)

    def write_all_layers(self, kv, pending: torch.Tensor, n_past: torch.Tensor):
        """The one write that ends a chunk-deferred decode chunk:
        pending (L, 2, B, n, KV, D) at each row's positions [n_past, n_past +
        n), into this rank's window (the local scatter of the JAX engine's
        sequence-parallel rows loop), on the device."""
        Tl = (kv[0] if kvcache.is_quantized(kv) else kv).shape[3]
        for l in range(pending.shape[0]):
            for j in range(pending.shape[3]):
                write_layer_local(kv, pending[l, :, :, j:j + 1], l, n_past + j, self.comm.rank,
                                  Tl)
        return kv

    def _head(self, x, output_hidden: bool):
        """The final norm, then the f32 hidden state or the logits."""
        m = self.model
        x = layer_norm(x, m.output_norm, m.output_norm_b)
        if output_hidden:
            return x.to(torch.float32)
        return linear(m.lm_head, x, torch.float32, kernels=self.st.kernels)

    def _prefill(self, tokens, kv, n_past, inv_freq, logits_all, last_pos, output_hidden):
        """sp_prefill:166 on the chunk `tokens` (B, S)."""
        m, st, comm = self.model, self.st, self.comm
        mp, idx = comm.size, comm.rank
        B, S = tokens.shape
        Sl = -(-S // mp)
        if Sl * mp != S:  # pad the chunk to a multiple of the ranks
            tokens = torch.cat([tokens, tokens.new_zeros(B, Sl * mp - S)], dim=1)
        Tl = (kv[0] if kvcache.is_quantized(kv) else kv).shape[3]
        dev = tokens.device
        npv = torch.as_tensor(n_past, dtype=torch.long, device=dev).reshape(-1).expand(B)
        x = m.tok_embeddings[tokens[:, idx * Sl:(idx + 1) * Sl]]
        pos = npv[:, None] + idx * Sl + torch.arange(Sl, device=dev)[None, :]
        rope = rope_cos_sin(pos, inv_freq)
        for l, layer in enumerate(m.layers):
            q, kv_new, gf = layer.pre(x, rope, st)
            write_layer_local(kv, comm.all_gather(kv_new, 2), l, n_past, idx, Tl)
            k, v = kvcache.read_layer(kv, l, q.dtype)
            x = layer.post(x, ring_attention(q, k, v, comm, n_past), gf, st)
        if logits_all:
            return comm.all_gather(self._head(x, output_hidden), 1)[:, :S]
        lp = torch.as_tensor(S - 1 if last_pos is None else last_pos, dtype=torch.long,
                             device=dev).reshape(-1).expand(B)
        mine = (lp // Sl == idx).reshape(B, 1, 1)
        xl = select_last(x, (lp - idx * Sl).clamp(0, Sl - 1))
        return comm.psum(torch.where(mine, self._head(xl, output_hidden), 0.0))

    def _decode(self, tokens, kv, n_past, inv_freq, pending, n_pend, output_hidden):
        """sp_decode:240 (cache written each step) or, with `pending`,
        sp_decode_rows:211 (chunk-deferred, [current; pending] appended)."""
        m, st, comm = self.model, self.st, self.comm
        idx = comm.rank
        B = tokens.shape[0]
        Tl = (kv[0] if kvcache.is_quantized(kv) else kv).shape[3]
        x = m.tok_embeddings[tokens]
        rope = rope_cos_sin(_positions(n_past, B, 1, tokens.device), inv_freq)
        deferred = []
        for l, layer in enumerate(m.layers):
            q, kv_new, gf = layer.pre(x, rope, st)
            if pending is None:
                write_layer_local(kv, kv_new, l, n_past, idx, Tl)
                k, v = kvcache.read_layer(kv, l, q.dtype)
                attn = merged_attention(q, k, v, n_past, idx, Tl, comm)
            else:
                k, v = kvcache.read_layer(kv, l, q.dtype)
                app = torch.cat([kv_new, pending[l, :, :, :n_pend].to(kv_new.dtype)], dim=2)
                attn = merged_attention(q, k, v, n_past, idx, Tl, comm, append=app,
                                        append_valid=1 + n_pend)
                deferred.append(kv_new)
            x = layer.post(x, attn, gf, st)
        out = self._head(x, output_hidden)
        return (out, torch.stack(deferred)) if pending is not None else out
