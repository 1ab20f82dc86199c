"""Flash-decode attention: one-token-step attention over the valid prefix of
one layer of the stacked KV cache, with an optional deferred-append block.

The hand-written CUDA kernels replace the Pallas kernels of
ggllm_tpu/kernels/flash_decode.py: `_kern` (launched by cache_partials; query
heads grouped over K/V heads, Falcon) and `_kern_mha` (launched by
_cache_partials_mha; G == 1 over several K/V heads, LLaMA), each for dense
caches and, as its quant=True variant, for the int8 cache (codes, scales) of
ops/kvcache.py. `route` picks the kernel:

* "tc"   grouped heads, bf16 q on a bf16 or int8 cache, head_dim 64 / 128:
         csrc/flash_decode_tc.cu, the products on the tensor cores;
* "mha"  G == 1 and KV > 1, any cache, head_dim 32 / 64 / 128:
         csrc/flash_decode.cu decode_mha_kernel;
* "simt" grouped heads with f32 q (f32 or int8 cache) or head_dim 32:
         csrc/flash_decode.cu partials_kernel.

Each is ONE launch per call: the time axis is cut into splits (decode_plan),
every block writes its (acc, m, l) partial to a workspace that is allocated
once per shape and stream and reused (calls of one shape on one stream run
in order; see _workspace for CUDA graphs), and the last block of each (row, K/V head) to
finish merges the splits and the [current; pending] append block (which the
JAX package merges in XLA, flash_decode:405-427) and writes the output (or,
for cache_partials, the merged partials). A Python-int `valid` goes in as a
scalar; a (B,) int32 device tensor is read on the device with a grid fixed
by the cache length, so a call allocates only its output and can be
captured in a CUDA graph. Launch counters: "flash_decode" (+ ".mha") (+
".int8") as before, and the route's "flash_decode_tc" (+ ".int8") or
"flash_decode.simt". Beside the kernels their plain PyTorch versions,
`cache_partials_plain` and `flash_decode_plain`, which a CPU tensor gets, and
`partials_emulated` / `decode_emulated`, the kernels' split / merge
arithmetic in PyTorch.
"""

from __future__ import annotations

import math

import torch

from ggllm_tpu_torch.kernels import build

NEG_INF = -1e30
SIMT_CHUNK = 64  # cache positions per block of the SIMT kernel (csrc/flash_decode.cu CT)
MAX_GROUP = 128  # query heads per K/V head that a block takes
MIN_KEYS = 32  # keys a split gets at least
WAVES = 4  # blocks per SM that the split count aims at
# The merging block reads the partials from L2; a split reads its keys from
# device memory. Splits are balanced so that the partials the merge reads
# cost no more than the keys one split reads, at this ratio of the two rates.
MERGE_RATE = 4
_DTYPES = (torch.bfloat16, torch.float32)
_CACHES = ("bfloat16", "float32", "int8")


def route(KV: int, G: int, D: int, cache: str, compute: str = "bfloat16") -> str:
    """Which kernel takes a (KV, G, D) head shape on a `cache` ("bfloat16",
    "float32" or "int8") with `compute` queries (a dense cache takes q in its
    own dtype, the int8 cache in the compute dtype): "tc", "mha" or "simt".
    Raises NotImplementedError with the reason for a shape none takes."""
    if cache not in _CACHES or compute not in ("bfloat16", "float32"):
        raise NotImplementedError(f"a {cache} cache with {compute} queries")
    if not 1 <= G <= MAX_GROUP or KV < 1:
        raise NotImplementedError(f"{G} query heads per K/V head (the kernels take 1..{MAX_GROUP})")
    q = compute if cache == "int8" else cache
    if G == 1 and KV > 1:
        if D in (32, 64, 128):
            return "mha"
        raise NotImplementedError(f"head_dim {D} (the G == 1 kernel takes 32, 64, 128)")
    if q == "bfloat16" and D in (64, 128):
        return "tc"
    if D in (32, 64):
        return "simt"
    raise NotImplementedError(
        f"head_dim {D} with grouped heads and {q} queries (the tensor-core kernel takes bf16"
        " queries at head_dim 64 or 128, the SIMT kernel head_dim 32 or 64)")


def supports(KV: int, G: int, D: int, cache: str, compute: str = "bfloat16") -> tuple[bool, str]:
    """(True, route) where a decode kernel takes the head shape, else
    (False, the reason); see `route`."""
    try:
        return True, route(KV, G, D, cache, compute)
    except NotImplementedError as e:
        return False, str(e)


def _rows(G: int, rt: str) -> int:
    """Rows of one (batch row, K/V head)'s partial: the tensor-core kernel
    pads the G query heads to a multiple of 16 (its m16 tiles)."""
    return 16 * -(-G // 16) if rt == "tc" else G


def _splits(valid: int, B: int, KV: int, G: int, D: int, cache: str, n_sm: int, rt: str) -> int:
    if rt == "simt":
        return max(1, -(-valid // SIMT_CHUNK))
    elem = {"bfloat16": 2, "float32": 4, "int8": 1}[cache]
    key_bytes = 2 * D * elem + (8 if cache == "int8" else 0)  # K and V of a position and head
    part_bytes = _rows(G, rt) * (D + 2) * 4
    fill = -(-n_sm * WAVES // (B * KV))
    by_keys = valid // MIN_KEYS
    by_merge = math.isqrt(MERGE_RATE * valid * key_bytes // part_bytes)
    return max(1, min(fill, by_keys, by_merge))


def decode_plan(valid: int, B: int, KV: int, G: int, D: int, cache: str = "bfloat16",
                n_sm: int = 132, rt: str | None = None) -> tuple[int, int]:
    """(n_split, chunk): the blocks per (batch row, K/V head) along the time
    axis and the keys each takes, for `valid` keys (the cache length T when
    the lengths lie on the device). Enough splits that B * KV * n_split fills
    WAVES blocks an SM, at least MIN_KEYS keys a split, and no more splits
    than the merge can read back in the time a split reads its keys
    (MERGE_RATE); the SIMT kernel keeps its fixed 64-position chunks."""
    rt = rt or route(KV, G, D, cache)
    if rt == "simt":
        return max(1, -(-valid // SIMT_CHUNK)), SIMT_CHUNK
    s = _splits(valid, B, KV, G, D, cache, n_sm, rt)
    chunk = max(16, 16 * -(-valid // (16 * s)))
    return max(1, -(-valid // chunk)), chunk


_n_sm: dict = {}
_workspaces: dict = {}


def _sm_count(device) -> int:
    if device.index not in _n_sm:
        _n_sm[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return _n_sm[device.index]


def _workspace(device, stream: int, rt: str, B: int, KV: int, G: int, D: int, T: int,
               cache: str):
    """(part_acc, part_ml, counters, splits): the partials of up to `splits`
    splits per (batch row, K/V head) and one arrival counter each (zero
    between calls: the merging block resets its own), allocated once per
    (device, stream, route, B, KV, G, D, T, cache) and reused by every call.
    A call's blocks use it until the last of them has merged, so calls that
    share one must not overlap: calls on one stream run in order, and each
    stream has its own. A CUDA graph keeps the workspace of the stream it
    was captured on: replays of graphs captured on one stream must not
    overlap each other or eager calls on that stream."""
    key = (device.index, stream, rt, B, KV, G, D, T, cache)
    if key not in _workspaces:
        n = _splits(T, B, KV, G, D, cache, _sm_count(device), rt)
        R = _rows(G, rt)
        _workspaces[key] = (
            torch.empty(B * KV * n * R * D, dtype=torch.float32, device=device),
            torch.empty(B * KV * n * R * 2, dtype=torch.float32, device=device),
            torch.zeros(B * KV, dtype=torch.int32, device=device), n)
    return _workspaces[key]


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


def _launch(kv, KV: int, layer: int, qg: torch.Tensor, cache_valid, *, valid_add: int = 0,
            app=None, app_valid: int = 0, out=None, partials=None) -> None:
    """Check a CUDA call's operands and make its one launch. qg (B, KV, G,
    D); cache_valid a Python int (then valid_add is 0), a sequence of ints,
    or a (B,) int tensor on the device to which the kernel adds valid_add.
    Writes `out` (B, 1, H, D) in q's dtype, or `partials` (acc, m, l) f32."""
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
        cache = "int8"
    elif kv.dtype in _DTYPES:
        cache = str(kv.dtype).removeprefix("torch.")
    else:
        raise TypeError(f"flash_decode kernel: cache dtype {kv.dtype}")
    if not kv.is_contiguous():
        raise ValueError("flash_decode kernel: the cache must be contiguous")
    qg = (qg if quant else qg.to(kv.dtype)).contiguous()
    rt = route(KV, G, D, cache, str(qg.dtype).removeprefix("torch."))
    if isinstance(cache_valid, torch.Tensor):
        vv, valid, top = _valid_vec(cache_valid, B, kv.device), valid_add, T
        if vv.device != kv.device:
            raise ValueError(f"flash_decode: valid lengths on {vv.device}, cache on {kv.device}")
        vv = vv.contiguous()  # no copy for a (B,) int32 tensor
    else:
        vals = [int(cache_valid)] if isinstance(cache_valid, int) else [int(c) for c in cache_valid]
        top = max(vals)
        if len(vals) == 1:
            vv, valid = None, vals[0]
        else:
            vv, valid = _valid_vec(vals, B, kv.device).contiguous(), 0
    if not 0 <= top <= T:
        raise ValueError(f"cache_valid {top} outside the cache length {T}")
    n_split, chunk = decode_plan(top, B, KV, G, D, cache, _sm_count(kv.device), rt)
    stream = build.stream_ptr(kv.device)
    part_acc, part_ml, counters, ws_splits = _workspace(kv.device, stream, rt, B, KV, G, D, T,
                                                        cache)
    n_app = 0 if app is None else app.shape[2]
    acc, m, l = partials if partials is not None else (None, None, None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    name = "gq_decode_tc" if rt == "tc" else "gq_decode"
    base = "flash_decode" + (".mha" if rt == "mha" else "") + (".int8" if quant else "")
    counters_ = (base, {"tc": "flash_decode_tc" + (".int8" if quant else ""),
                        "simt": "flash_decode.simt", "mha": base}[rt])
    build.launch(name, tuple(dict.fromkeys(counters_)),
                 kv.data_ptr(), 2 if quant else int(kv.dtype == torch.bfloat16), ptr(scales),
                 layer, qg.data_ptr(), int(qg.dtype == torch.bfloat16), ptr(vv), valid, ptr(app),
                 n_app, app_valid, ptr(out), ptr(acc), ptr(m), ptr(l), part_acc.data_ptr(),
                 part_ml.data_ptr(), counters.data_ptr(), L, B, T, KV, G, D, n_split, chunk,
                 ws_splits, stream)


def cache_partials(kv, KV: int, layer: int, qg: torch.Tensor, cache_valid):
    """Online-softmax partials of qg against layer `layer`'s cache rows
    t < cache_valid[b]. kv (L, 2, B, T, KV, D) bf16/f32, or the int8 pair
    (codes int8, scales f32 (L, 2, B, T, KV, 1)); qg (B, KV, G, D), cast to a
    dense cache's dtype and left in its own (bf16/f32) for an int8 cache;
    cache_valid an int, a sequence of ints, or a (B,) int tensor.
    Returns (acc (B,KV,G,D), m (B,KV,G,1), l (B,KV,G,1)), all f32."""
    if qg.device.type == "cpu":
        return cache_partials_plain(kv, KV, layer, qg, cache_valid)
    B, _, G, D = qg.shape
    acc = torch.empty(B, KV, G, D, dtype=torch.float32, device=qg.device)
    m = torch.empty(B, KV, G, 1, dtype=torch.float32, device=qg.device)
    l = torch.empty(B, KV, G, 1, dtype=torch.float32, device=qg.device)
    _launch(kv, KV, layer, qg, cache_valid, partials=(acc, m, l))
    return acc, m, l


def _shift(kv_append, append_valid) -> int:
    """Rows of the cache to attend, relative to n_past: strictly below
    n_past - (append_valid - 1) when appending with append_valid, below
    n_past when appending without it, below n_past + 1 otherwise (the
    current token is written)."""
    if kv_append is None:
        return 1
    if append_valid is not None:
        return -(int(append_valid) - 1)
    return 0


def _cache_valid(n_past, B: int, device, kv_append, append_valid):
    if isinstance(n_past, int):
        return n_past + _shift(kv_append, append_valid)
    return _valid_vec(n_past, B, device) + _shift(kv_append, append_valid)


def _merge_append(qg, acc, m, l, kv_append, append_valid):
    """The append block's partial merged into (acc, m, l) with the
    partial-softmax algebra of ggllm_tpu/kernels/flash_decode.py:405-427."""
    A, D = kv_append.shape[2], qg.shape[-1]
    ka = kv_append[0].to(torch.float32)  # (B, A, KV, D)
    va = kv_append[1].to(torch.float32)
    s2 = torch.einsum("bkgd,bakd->bkga", qg.to(torch.float32), ka) * (1.0 / D ** 0.5)
    if append_valid is not None and int(append_valid) < A:  # else every entry is real
        amask = torch.arange(A, device=qg.device) < int(append_valid)
        s2 = torch.where(amask[None, None, None, :], s2, NEG_INF)
    m2 = s2.amax(dim=-1, keepdim=True)
    p2 = torch.exp(s2 - m2)
    l2 = p2.sum(dim=-1, keepdim=True)
    acc2 = torch.einsum("bkga,bakd->bkgd", p2, va)
    m_t = torch.maximum(m, m2)
    w1 = torch.exp(m - m_t)
    w2 = torch.exp(m2 - m_t)
    return acc * w1 + acc2 * w2, m_t, l * w1 + l2 * w2


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
        acc, m, l = _merge_append(qg, acc, m, l, kv_append, append_valid)
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, 1, H, D).to(q.dtype)


def _kernel_warps(G: int, rt: str) -> int:
    """Warps that share each 64-key tile of a split: the tensor-core
    kernel's warps_per_tile (csrc/flash_decode_tc.cu) for its ceil(G / 16)
    row tiles; one for the other kernels, whose order of f32 sums the
    emulation does not follow."""
    if rt != "tc":
        return 1
    mt = -(-G // 16)
    return 4 if mt == 1 else 2 if mt == 2 else 1


def partials_emulated(kv, KV: int, layer: int, qg: torch.Tensor, cache_valid,
                      n_sm: int = 132, rt: str | None = None,
                      round_p: bool | None = None):
    """cache_partials' arithmetic as the one-launch kernels run it, in
    PyTorch, for the tests. decode_plan's splits for route `rt` (default:
    the one the operands take; the plan is made for the largest length, or
    for the cache length T when cache_valid is a tensor, as the wrapper
    makes it); in each split, the keys of each 64-key tile shared between
    the warps of a row tile, every warp with its own running maximum in
    base-2 units (scores times log2(e) / sqrt(D), exponent by one fused
    multiply-add, as the kernel); with round_p (the default on the "tc"
    route) P times V's int8 scale rounded to bf16 before the P V product,
    at each tile's running maximum; then the warps merged in order, and
    the splits as the last block merges them. Returns (acc, m, l) f32."""
    quant = isinstance(kv, tuple)
    codes = kv[0] if quant else kv
    _, _, B, T, _, D = codes.shape
    G = qg.shape[2]
    cache = "int8" if quant else str(codes.dtype).removeprefix("torch.")
    rt = rt or route(KV, G, D, cache, str(qg.dtype).removeprefix("torch."))
    round_p = rt == "tc" if round_p is None else round_p
    if isinstance(cache_valid, torch.Tensor):
        lens, top = _valid_vec(cache_valid, B, codes.device).tolist(), T
    else:
        lens = [int(cache_valid)] * B if isinstance(cache_valid, int) else [int(c) for c in cache_valid]
        top = max(lens)
    n_split, chunk = decode_plan(top, B, KV, G, D, cache, n_sm, rt)
    n_warps = _kernel_warps(G, rt)
    kpw = 64 // n_warps
    dev, f32 = codes.device, torch.float32
    sl2 = torch.tensor(math.log2(math.e), dtype=f32) / torch.tensor(float(D), dtype=f32).sqrt()
    scale = 1.0 / torch.tensor(float(D), dtype=f32).sqrt()
    q32 = qg.to(f32)
    k, v = codes[layer, 0].to(f32), codes[layer, 1].to(f32)  # (B, T, KV, D)
    if quant:
        ks, vs = kv[1][layer, 0, ..., 0], kv[1][layer, 1, ..., 0]  # (B, T, KV)
    acc = torch.zeros(B, KV, G, D, dtype=f32, device=dev)
    m_out = torch.full((B, KV, G, 1), NEG_INF, dtype=f32, device=dev)
    l_out = torch.zeros(B, KV, G, 1, dtype=f32, device=dev)
    for b in range(B):
        parts = []
        for s in range(n_split):
            k0, k1 = s * chunk, min(lens[b], (s + 1) * chunk)
            if k1 <= k0:
                continue
            warps = []
            for w in range(n_warps):
                m = torch.full((KV, G, 1), NEG_INF, dtype=f32, device=dev)
                o = torch.zeros(KV, G, D, dtype=f32, device=dev)
                l = torch.zeros(KV, G, 1, dtype=f32, device=dev)
                for t0 in range(k0 + w * kpw, k1, 64):
                    t1 = min(t0 + kpw, k1)
                    sc = torch.einsum("kgd,tkd->kgt", q32[b], k[b, t0:t1])
                    if quant:
                        sc = sc * ks[b, t0:t1].t()[:, None, :]
                    mx = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
                    alpha = torch.exp2((m - mx) * sl2)
                    ms = (mx * sl2).double()
                    p = torch.exp2((sc.double() * sl2.double() - ms).to(f32))
                    l = l * alpha + p.sum(dim=-1, keepdim=True)
                    pv = p * vs[b, t0:t1].t()[:, None, :] if quant else p
                    if round_p:
                        pv = pv.to(torch.bfloat16).to(f32)
                    o = o * alpha + torch.einsum("kgt,tkd->kgd", pv, v[b, t0:t1])
                    m = mx
                warps.append((o, m, l))
            o, m, l = warps[0]
            for o2, m2, l2 in warps[1:]:
                M = torch.maximum(m, m2)
                wa, wb = torch.exp2((m - M) * sl2), torch.exp2((m2 - M) * sl2)
                o, l, m = o * wa + o2 * wb, l * wa + l2 * wb, M
            parts.append((o, m * scale, l))
        if parts:
            M = torch.stack([m for _, m, _ in parts]).amax(dim=0)
            wts = [torch.exp(m - M) for _, m, _ in parts]
            acc[b] = sum(a * wi for (a, _, _), wi in zip(parts, wts))
            l_out[b] = sum(li * wi for (_, _, li), wi in zip(parts, wts))
            m_out[b] = M
    return acc, m_out, l_out


def decode_emulated(kv, KV: int, layer: int, q: torch.Tensor, n_past,
                    kv_append: torch.Tensor | None = None, append_valid=None,
                    n_sm: int = 132, rt: str | None = None,
                    round_p: bool | None = None) -> torch.Tensor:
    """flash_decode's arithmetic as the kernels run it, in PyTorch, for the
    tests: partials_emulated over the cache rows of a Python-int n_past,
    then the append block merged in as the last block merges it, and the
    output normalized."""
    B, _, H, D = q.shape
    G = H // KV
    quant = isinstance(kv, tuple)
    codes = kv[0] if quant else kv
    qg = (q if quant else q.to(codes.dtype)).reshape(B, KV, G, D)
    valid = _cache_valid(int(n_past), B, q.device, kv_append, append_valid)
    acc, M, l = partials_emulated(kv, KV, layer, qg, valid, n_sm, rt, round_p)
    if kv_append is not None:
        acc, M, l = _merge_append(qg.to(torch.float32), acc, M, l, kv_append, append_valid)
    return (acc / torch.clamp(l, min=1e-30)).reshape(B, 1, H, D).to(q.dtype)


def flash_decode(kv, KV: int, layer: int, q: torch.Tensor, n_past,
                 kv_append: torch.Tensor | None = None, append_valid=None) -> torch.Tensor:
    """Attention at S == 1 (decode), the port of ggllm_tpu flash_decode.

    kv: the stacked cache (L, 2, B, T, KV, D), or the int8 pair (codes,
    scales); layer: which layer to attend. q: (B, 1, H, D). n_past: an int
    or a (B,) int tensor (int32 on the device: no copy). kv_append: (2, B,
    A, KV, D) unwritten block ([current token; pending]); append_valid:
    count of valid append entries (None -> all A). The cache is valid
    strictly below n_past - (append_valid - 1) when appending with
    append_valid, strictly below n_past when appending without it, and
    strictly below n_past + 1 otherwise (the current token is already
    written). Returns (B, 1, H, D) in q.dtype."""
    B, S, H, D = q.shape
    assert S == 1, "flash_decode is the S=1 path"
    if q.device.type == "cpu":
        return flash_decode_plain(kv, KV, layer, q, n_past, kv_append, append_valid)
    quant = isinstance(kv, tuple)
    cdtype = q.dtype if quant else kv.dtype
    app, n_real = None, 0
    if kv_append is not None:
        A = kv_append.shape[2]
        n_real = A if append_valid is None else int(append_valid)
        if kv_append.shape != (2, B, A, KV, D) or kv_append.device != q.device:
            raise ValueError(f"flash_decode: append block {tuple(kv_append.shape)} on "
                             f"{kv_append.device}")
        if not 1 <= n_real <= A:
            raise ValueError(f"flash_decode: append_valid {n_real} outside 1..{A}")
        app = kv_append.to(cdtype).contiguous()
    shift = _shift(kv_append, append_valid)
    out = torch.empty(B, 1, H, D, dtype=cdtype, device=q.device)
    if isinstance(n_past, torch.Tensor):
        _launch(kv, KV, layer, q.reshape(B, KV, H // KV, D), n_past, valid_add=shift, app=app,
                app_valid=n_real, out=out)
    else:
        _launch(kv, KV, layer, q.reshape(B, KV, H // KV, D),
                _cache_valid(n_past, B, q.device, kv_append, append_valid), app=app,
                app_valid=n_real, out=out)
    return out.to(q.dtype)
