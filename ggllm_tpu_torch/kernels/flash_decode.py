"""Flash-decode attention: one-token-step attention over the valid prefix of
one layer of the stacked KV cache, with an optional deferred-append block.

`cache_partials` is the hand-written CUDA kernel (csrc/flash_decode.cu),
which replaces the Pallas kernel ggllm_tpu/kernels/flash_decode.py `_kern`
(launched by cache_partials) for bf16/f32 caches; `cache_partials_plain`
is its plain PyTorch version. `flash_decode` has the JAX function's
arguments and merges the small [current; pending] append block in plain
torch, as the JAX package does in XLA.
"""

from __future__ import annotations

import torch

from ggllm_tpu_torch.kernels import build

NEG_INF = -1e30
CHUNK = 64  # cache positions per kernel block (csrc/flash_decode.cu CT)
KERNEL_HEAD_DIMS = (32, 64)


def _valid_vec(cache_valid, B: int, device) -> torch.Tensor:
    return torch.as_tensor(cache_valid, dtype=torch.int32, device=device).reshape(-1).expand(B)


def cache_partials_plain(kv: torch.Tensor, KV: int, layer: int, qg: torch.Tensor,
                         cache_valid):
    """Plain version. kv (L, 2, B, T, KV, D); qg (B, KV, G, D).
    Returns (acc (B,KV,G,D), m (B,KV,G,1), l (B,KV,G,1)), all f32."""
    _, _, B, T, _, D = kv.shape
    k = kv[layer, 0].to(torch.float32)  # (B, T, KV, D)
    v = kv[layer, 1].to(torch.float32)
    s = torch.einsum("bkgd,btkd->bkgt", qg.to(torch.float32), k) * (1.0 / D ** 0.5)
    valid = _valid_vec(cache_valid, B, kv.device)
    mask = torch.arange(T, device=kv.device)[None, :] < valid[:, None]  # (B, T)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    # rows with nothing valid: p = exp(0) = 1 everywhere; zero them so the
    # partial is (acc 0, m -1e30, l 0) like the kernel's empty partial
    p = torch.where(mask[:, None, None, :], p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgt,btkd->bkgd", p, v)
    return acc, m, l


def cache_partials(kv: torch.Tensor, KV: int, layer: int, qg: torch.Tensor, cache_valid):
    """Online-softmax partials of qg against layer `layer`'s cache rows
    t < cache_valid[b]. kv (L, 2, B, T, KV, D) bf16/f32; qg (B, KV, G, D);
    cache_valid an int, a sequence of ints, or a (B,) int tensor.
    Returns (acc (B,KV,G,D), m (B,KV,G,1), l (B,KV,G,1)), all f32."""
    if kv.device.type == "cpu":
        return cache_partials_plain(kv, KV, layer, qg, cache_valid)
    L, _, B, T, KV_, D = kv.shape
    G = qg.shape[2]
    if KV_ != KV or qg.shape != (B, KV, G, D):
        raise ValueError(f"cache_partials: cache {tuple(kv.shape)} q {tuple(qg.shape)} KV={KV}")
    if kv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"cache_partials kernel: cache dtype {kv.dtype} (int8 is not ported)")
    if D not in KERNEL_HEAD_DIMS or G > 128:
        raise NotImplementedError(f"cache_partials kernel: head_dim {D}, group {G}")
    if not kv.is_contiguous():
        raise ValueError("cache_partials kernel: the cache must be contiguous")
    qg = qg.to(kv.dtype).contiguous()
    if isinstance(cache_valid, torch.Tensor):
        vv, valid, top = _valid_vec(cache_valid, B, kv.device).contiguous(), 0, T
    else:
        vals = [int(cache_valid)] if isinstance(cache_valid, int) else [int(c) for c in cache_valid]
        top = max(vals)
        if len(vals) == 1:
            vv, valid = None, vals[0]
        else:
            vv, valid = _valid_vec(vals, B, kv.device).contiguous(), 0
    if not 0 <= top <= T:
        raise ValueError(f"cache_valid {top} outside the cache length {T}")
    n_chunks = -(-top // CHUNK)
    dev, f32 = kv.device, torch.float32
    acc = torch.empty(B, KV, G, D, dtype=f32, device=dev)
    m = torch.empty(B, KV, G, 1, dtype=f32, device=dev)
    l = torch.empty(B, KV, G, 1, dtype=f32, device=dev)
    part_acc = torch.empty(B, KV, max(n_chunks, 1), G, D, dtype=f32, device=dev)
    part_ml = torch.empty(B, KV, max(n_chunks, 1), G, 2, dtype=f32, device=dev)
    build.launch("gq_cache_partials", "flash_decode", kv.data_ptr(),
                 int(kv.dtype == torch.bfloat16), layer, qg.data_ptr(),
                 None if vv is None else vv.data_ptr(), valid, acc.data_ptr(),
                 m.data_ptr(), l.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
                 L, B, T, KV, G, D, n_chunks, build.stream_ptr(dev))
    return acc, m, l


def flash_decode(kv: torch.Tensor, KV: int, layer: int, q: torch.Tensor, n_past,
                 kv_append: torch.Tensor | None = None, append_valid=None) -> torch.Tensor:
    """Attention at S == 1 (decode), the port of ggllm_tpu flash_decode.

    kv: the stacked cache (L, 2, B, T, KV, D); layer: which layer to
    attend. q: (B, 1, H, D). n_past: an int or a (B,) int tensor.
    kv_append: (2, B, A, KV, D) unwritten block ([current token; pending]);
    append_valid: count of valid append entries (None -> all A). The cache
    is valid strictly below n_past - (append_valid - 1) when appending with
    append_valid, strictly below n_past when appending without it, and
    strictly below n_past + 1 otherwise (the current token is already
    written). Returns (B, 1, H, D) in q.dtype."""
    B, S, H, D = q.shape
    assert S == 1, "flash_decode is the S=1 path"
    G = H // KV
    if kv_append is None:
        shift = 1
    elif append_valid is not None:
        shift = -(int(append_valid) - 1)
    else:
        shift = 0
    if isinstance(n_past, int):
        cache_valid = n_past + shift
    else:
        cache_valid = _valid_vec(n_past, B, q.device) + shift

    qg = q.reshape(B, KV, G, D)
    acc, m, l = cache_partials(kv, KV, layer, qg, cache_valid)

    if kv_append is not None:
        A = kv_append.shape[2]
        ka = kv_append[0].to(torch.float32)  # (B, A, KV, D)
        va = kv_append[1].to(torch.float32)
        s2 = torch.einsum("bkgd,bakd->bkga", qg.to(torch.float32), ka) * (1.0 / D ** 0.5)
        if append_valid is not None:
            amask = torch.arange(A, device=q.device) < int(append_valid)
            s2 = torch.where(amask[None, None, None, :], s2, NEG_INF)
        m2 = s2.amax(dim=-1, keepdim=True)
        p2 = torch.exp(s2 - m2)
        l2 = p2.sum(dim=-1, keepdim=True)
        acc2 = torch.einsum("bkga,bakd->bkgd", p2, va)
        m_t = torch.maximum(m, m2)
        w1 = torch.exp(m - m_t)
        w2 = torch.exp(m2 - m_t)
        acc = acc * w1 + acc2 * w2
        l = l * w1 + l2 * w2

    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, 1, H, D).to(q.dtype)
