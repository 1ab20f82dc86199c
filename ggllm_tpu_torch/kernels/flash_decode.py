"""Flash-decode attention: one-token-step attention over the valid prefix of
one layer of the stacked KV cache, with an optional deferred-append block.

The hand-written CUDA kernels (csrc/flash_decode.cu) replace the Pallas
kernels of ggllm_tpu/kernels/flash_decode.py: `_kern` (launched by
cache_partials; query heads grouped over K/V heads, Falcon) and `_kern_mha`
(launched by _cache_partials_mha; G == 1 over several K/V heads, LLaMA), each
for bf16/f32 caches and, as its quant=True variant, for the int8 cache
(codes, scales) of ops/kvcache.py. G == 1 and KV > 1 takes the one-head-per-block
kernel (head dims 32, 64, 128; launch counters "flash_decode.mha" and
"flash_decode.mha.int8"), every other shape the grouped one (head dims 32,
64; "flash_decode", "flash_decode.int8"). `cache_partials` returns the
un-normalized partials (acc, m, l) as the JAX function does; `flash_decode`
has the JAX function's arguments and runs the same partials kernel followed
by a finishing kernel that merges the small [current; pending] append block
(which the JAX package merges in XLA) and normalizes. Beside each its plain
PyTorch version, `cache_partials_plain` and `flash_decode_plain`, which a
CPU tensor gets.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from ggllm_tpu_torch.kernels import build

NEG_INF = -1e30
CHUNK = 64  # cache positions per kernel block (csrc/flash_decode.cu CT)
KERNEL_HEAD_DIMS = (32, 64)  # the grouped kernel's
MHA_HEAD_DIMS = (32, 64, 128)  # the G == 1 kernel's
_DTYPES = (torch.bfloat16, torch.float32)


def _valid_vec(cache_valid, B: int, device) -> torch.Tensor:
    return torch.as_tensor(cache_valid, dtype=torch.int32, device=device).reshape(-1).expand(B)


def cache_partials_plain(kv, KV: int, layer: int, qg: torch.Tensor, cache_valid):
    """Plain version. kv (L, 2, B, T, KV, D), or the int8 pair (codes, scales
    (L, 2, B, T, KV, 1)), read as codes * scales in f32; qg (B, KV, G, D).
    Returns (acc (B,KV,G,D), m (B,KV,G,1), l (B,KV,G,1)), all f32."""
    if isinstance(kv, tuple):
        codes, scales = kv
        k = codes[layer, 0].to(torch.float32) * scales[layer, 0]  # (B, T, KV, D)
        v = codes[layer, 1].to(torch.float32) * scales[layer, 1]
        kv = codes
    else:
        k = kv[layer, 0].to(torch.float32)
        v = kv[layer, 1].to(torch.float32)
    _, _, B, T, _, D = kv.shape
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


def _kernel_call(kv, KV: int, layer: int, qg: torch.Tensor, cache_valid) -> SimpleNamespace:
    """Check a CUDA call's operands and lay out what both C entry points
    share: `head` (cache, kind, scales, layer, q, q_is_bf16, valid_vec,
    valid) and `tail` (scratch, sizes, stream), `qg` as the kernel takes it
    (a dense cache's dtype; as it is, bf16/f32, for an int8 cache) and the
    launch counter's name. The namespace holds the scratch tensors, so it
    must outlive the launch."""
    quant = isinstance(kv, tuple)
    kv, scales = kv if quant else (kv, None)
    L, _, B, T, KV_, D = kv.shape
    G = qg.shape[2]
    if KV_ != KV or qg.shape != (B, KV, G, D):
        raise ValueError(f"flash_decode: cache {tuple(kv.shape)} q {tuple(qg.shape)} KV={KV}")
    if quant:
        if kv.dtype != torch.int8 or scales.dtype != torch.float32:
            raise TypeError(f"flash_decode kernel: int8 cache with {kv.dtype} codes and "
                            f"{scales.dtype} scales")
        if scales.shape != (L, 2, B, T, KV, 1) or scales.device != kv.device:
            raise ValueError(f"flash_decode kernel: scales {tuple(scales.shape)} on "
                             f"{scales.device} for codes {tuple(kv.shape)} on {kv.device}")
        if qg.dtype not in _DTYPES:
            raise TypeError(f"flash_decode kernel: q dtype {qg.dtype} (bfloat16, float32)")
        if not scales.is_contiguous():
            raise ValueError("flash_decode kernel: the scales must be contiguous")
    elif kv.dtype not in _DTYPES:
        raise TypeError(f"flash_decode kernel: cache dtype {kv.dtype}")
    mha = G == 1 and KV > 1
    if D not in (MHA_HEAD_DIMS if mha else KERNEL_HEAD_DIMS) or G > 128:
        raise NotImplementedError(f"flash_decode kernel: head_dim {D}, group {G}, KV {KV}")
    if not kv.is_contiguous():
        raise ValueError("flash_decode kernel: the cache must be contiguous")
    qg = (qg if quant else qg.to(kv.dtype)).contiguous()
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
    part_acc = torch.empty(B, KV, max(n_chunks, 1), G, D, dtype=torch.float32, device=kv.device)
    part_ml = torch.empty(B, KV, max(n_chunks, 1), G, 2, dtype=torch.float32, device=kv.device)
    kind = 2 if quant else int(kv.dtype == torch.bfloat16)
    return SimpleNamespace(
        head=(kv.data_ptr(), kind, scales.data_ptr() if quant else None, layer, qg.data_ptr(),
              int(qg.dtype == torch.bfloat16), None if vv is None else vv.data_ptr(), valid),
        tail=(part_acc.data_ptr(), part_ml.data_ptr(), L, B, T, KV, G, D, n_chunks,
              build.stream_ptr(kv.device)),
        qg=qg, counter="flash_decode" + (".mha" if mha else "") + (".int8" if quant else ""),
        scratch=(vv, part_acc, part_ml))


def cache_partials(kv, KV: int, layer: int, qg: torch.Tensor, cache_valid):
    """Online-softmax partials of qg against layer `layer`'s cache rows
    t < cache_valid[b]. kv (L, 2, B, T, KV, D) bf16/f32, or the int8 pair
    (codes int8, scales f32 (L, 2, B, T, KV, 1)); qg (B, KV, G, D), cast to a
    dense cache's dtype and left in its own (bf16/f32) for an int8 cache;
    cache_valid an int, a sequence of ints, or a (B,) int tensor.
    Returns (acc (B,KV,G,D), m (B,KV,G,1), l (B,KV,G,1)), all f32."""
    if qg.device.type == "cpu":
        return cache_partials_plain(kv, KV, layer, qg, cache_valid)
    call = _kernel_call(kv, KV, layer, qg, cache_valid)
    B, _, G, D = qg.shape
    acc = torch.empty(B, KV, G, D, dtype=torch.float32, device=qg.device)
    m = torch.empty(B, KV, G, 1, dtype=torch.float32, device=qg.device)
    l = torch.empty(B, KV, G, 1, dtype=torch.float32, device=qg.device)
    build.launch("gq_cache_partials", call.counter, *call.head, acc.data_ptr(), m.data_ptr(),
                 l.data_ptr(), *call.tail)
    return acc, m, l


def _cache_valid(n_past, B: int, device, kv_append, append_valid):
    """Rows of the cache to attend: strictly below n_past - (append_valid -
    1) when appending with append_valid, below n_past when appending
    without it, below n_past + 1 otherwise (the current token is written)."""
    if kv_append is None:
        shift = 1
    elif append_valid is not None:
        shift = -(int(append_valid) - 1)
    else:
        shift = 0
    if isinstance(n_past, int):
        return n_past + shift
    return _valid_vec(n_past, B, device) + shift


def flash_decode_plain(kv, KV: int, layer: int, q: torch.Tensor, n_past,
                       kv_append: torch.Tensor | None = None, append_valid=None) -> torch.Tensor:
    """Plain version of flash_decode: the plain partials, then the append
    block's partial merged in with the partial-softmax algebra, as
    ggllm_tpu/kernels/flash_decode.py flash_decode:405-427."""
    B, _, H, D = q.shape
    G = H // KV
    qg = q.reshape(B, KV, G, D)
    acc, m, l = cache_partials_plain(kv, KV, layer, qg,
                                     _cache_valid(n_past, B, q.device, kv_append, append_valid))
    if kv_append is not None:
        A = kv_append.shape[2]
        ka = kv_append[0].to(torch.float32)  # (B, A, KV, D)
        va = kv_append[1].to(torch.float32)
        s2 = torch.einsum("bkgd,bakd->bkga", qg.to(torch.float32), ka) * (1.0 / D ** 0.5)
        if append_valid is not None and int(append_valid) < A:  # else every entry is real
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


def flash_decode(kv, KV: int, layer: int, q: torch.Tensor, n_past,
                 kv_append: torch.Tensor | None = None, append_valid=None) -> torch.Tensor:
    """Attention at S == 1 (decode), the port of ggllm_tpu flash_decode.

    kv: the stacked cache (L, 2, B, T, KV, D), or the int8 pair (codes,
    scales); layer: which layer to attend. q: (B, 1, H, D). n_past: an int
    or a (B,) int tensor. kv_append: (2, B, A, KV, D) unwritten block
    ([current token; pending]); append_valid: count of valid append entries
    (None -> all A). The cache is valid strictly below n_past -
    (append_valid - 1) when appending with append_valid, strictly below
    n_past when appending without it, and strictly below n_past + 1
    otherwise (the current token is already written). Returns (B, 1, H, D)
    in q.dtype."""
    B, S, H, D = q.shape
    assert S == 1, "flash_decode is the S=1 path"
    if q.device.type == "cpu":
        return flash_decode_plain(kv, KV, layer, q, n_past, kv_append, append_valid)
    call = _kernel_call(kv, KV, layer, q.reshape(B, KV, H // KV, D),
                        _cache_valid(n_past, B, q.device, kv_append, append_valid))
    app, A, n_real = None, 0, 0
    if kv_append is not None:
        A = kv_append.shape[2]
        n_real = A if append_valid is None else int(append_valid)
        if kv_append.shape != (2, B, A, KV, D) or kv_append.device != q.device:
            raise ValueError(f"flash_decode: append block {tuple(kv_append.shape)} on "
                             f"{kv_append.device}")
        if not 1 <= n_real <= A:
            raise ValueError(f"flash_decode: append_valid {n_real} outside 1..{A}")
        app = kv_append.to(call.qg.dtype).contiguous()
    out = torch.empty(B, 1, H, D, dtype=call.qg.dtype, device=q.device)
    build.launch("gq_flash_decode", call.counter, *call.head,
                 None if app is None else app.data_ptr(), A, n_real, out.data_ptr(), *call.tail)
    return out.to(q.dtype)
