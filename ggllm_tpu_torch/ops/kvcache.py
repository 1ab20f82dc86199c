"""KV cache storage: one dense tensor, or int8 codes with f32 scales (port
of ggllm_tpu/ops/kvcache.py).

A cache is one tensor (L, 2, B, T, KV, D) or, in int8 mode
(EngineConfig.kv_dtype = "int8"), a tuple (codes int8 (L, 2, B, T, KV, D),
scales f32 (L, 2, B, T, KV, 1)): each cached (position, head) vector carries
one scale, absmax / 127. Quantization happens at the write, dequantization
at the attention read (or inside the flash-decode kernel, which reads the
codes and scales as they lie here: the JAX package transposes the scales to
(L, 2, B, KV, T) for its kernel, which this layout does not need).

Unlike the JAX package, whose arrays are immutable, the port updates the
cache IN PLACE: the write functions copy the new block into the existing
tensors and return the same cache.
"""

from __future__ import annotations

import torch

from ggllm_tpu_torch.core.device import resolve_device


def is_quantized(kv) -> bool:
    return isinstance(kv, tuple)


def new(shape: tuple, kv_dtype, device):
    """Allocate a cache. shape = (L, 2, B, T, KV, D). Codes start at zero and
    scales at one, as in the JAX package."""
    if kv_dtype == "int8":
        return (torch.zeros(shape, dtype=torch.int8, device=device),
                torch.ones(tuple(shape[:-1]) + (1,), dtype=torch.float32, device=device))
    return torch.zeros(shape, dtype=getattr(torch, str(kv_dtype)), device=device)


def quantize_new(kv_new: torch.Tensor):
    """(..., D) float -> (int8 codes, f32 scales (..., 1)): scale =
    max(absmax over D, 1e-8) / 127, code = round-half-even(f / scale) clipped
    to [-127, 127], all in f32 (ggllm_tpu/ops/kvcache.py quantize_new:29)."""
    f = kv_new.to(torch.float32)
    amax = f.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(f / scale), -127, 127).to(torch.int8)
    return q, scale


def _flat_index(n_past: torch.Tensor, B: int, T: int, S: int) -> torch.Tensor:
    """Positions [n_past[b], n_past[b] + S) of every row b of a (1,) or (B,)
    device n_past as one int64 index into the cache's (B * T) rows-by-time
    axis, built on the device (no host value: a write by this index can be
    captured in a CUDA graph). One row (the single stream) is its time axis:
    one cast at S = 1."""
    dev = n_past.device
    if B == 1:
        idx = n_past.reshape(-1)[:1].to(torch.int64)
    else:  # int64 row starts + int32 positions: one add, promoted to int64
        idx = torch.arange(0, B * T, T, device=dev) + n_past.reshape(-1)
    return idx if S == 1 else (idx[:, None] + torch.arange(S, device=dev)).reshape(-1)


def _write_rows(dst: torch.Tensor, axis: int, idx: torch.Tensor, new: torch.Tensor) -> None:
    """Copy new (..., B, S, ...) into dst (..., B, T, ...) at the flat
    (B * T) index idx, where B and T are dst's axes `axis` and `axis + 1`."""
    shape = dst.shape
    flat = dst.view(*shape[:axis], shape[axis] * shape[axis + 1], *shape[axis + 2:])
    ns = new.shape
    flat.index_copy_(axis, idx, new.reshape(*ns[:axis], ns[axis] * ns[axis + 1],
                                            *ns[axis + 2:]).to(dst.dtype))


def write_layer(kv, kv_new: torch.Tensor, l: int, n_past):
    """Write kv_new (2, B, S, KV, D) into layer l at positions
    [n_past, n_past + S), in place (quantized for an int8 cache); returns kv.
    n_past: a Python int (prefill, every row at one position), or a (1,) or
    (B,) int tensor on the cache's device, each row at its own position
    (ggllm_tpu/ops/kvcache.py write_layer:55), written by an indexed copy,
    so that one captured write serves any positions."""
    S = kv_new.shape[2]
    if isinstance(n_past, torch.Tensor):
        codes = kv[0] if is_quantized(kv) else kv
        idx = _flat_index(n_past, codes.shape[2], codes.shape[3], S)
        if is_quantized(kv):
            q, scale = quantize_new(kv_new)
            _write_rows(kv[0][l], 1, idx, q)
            _write_rows(kv[1][l], 1, idx, scale)
        else:
            _write_rows(kv[l], 1, idx, kv_new)
    elif is_quantized(kv):
        q, scale = quantize_new(kv_new)
        kv[0][l, :, :, n_past:n_past + S] = q
        kv[1][l, :, :, n_past:n_past + S] = scale
    else:
        kv[l, :, :, n_past:n_past + S] = kv_new.to(kv.dtype)
    return kv


def write_all_layers(kv, kv_new: torch.Tensor, n_past):
    """Write every layer's kv_new (L, 2, B, S, KV, D) at positions
    [n_past, n_past + S), in place: the one write that ends a chunk-deferred
    decode chunk (ggllm_tpu/ops/kvcache.py write_all_layers:79; n_past an int
    or a (1,) / (B,) device tensor, each row at its own position, as
    write_layer); returns kv."""
    S = kv_new.shape[3]
    if isinstance(n_past, torch.Tensor):
        codes = kv[0] if is_quantized(kv) else kv
        idx = _flat_index(n_past, codes.shape[2], codes.shape[3], S)
        if is_quantized(kv):
            q, scale = quantize_new(kv_new)
            _write_rows(kv[0], 2, idx, q)
            _write_rows(kv[1], 2, idx, scale)
        else:
            _write_rows(kv, 2, idx, kv_new)
    elif is_quantized(kv):
        q, scale = quantize_new(kv_new)
        kv[0][:, :, :, n_past:n_past + S] = q
        kv[1][:, :, :, n_past:n_past + S] = scale
    else:
        kv[:, :, :, n_past:n_past + S] = kv_new.to(kv.dtype)
    return kv


def zero_(kv):
    """Reset a cache in place to what `new` allocates (codes 0, scales 1):
    its storage, which captured CUDA graphs point at, is kept."""
    if is_quantized(kv):
        kv[0].zero_()
        kv[1].fill_(1.0)
    else:
        kv.zero_()
    return kv


def read_layer(kv, l: int, compute_dtype=torch.bfloat16):
    """Layer l's (k, v), each (B, T, KV, D): views of a dense cache, or the
    int8 cache dequantized (codes * scales in f32) to compute_dtype."""
    if is_quantized(kv):
        codes, scales = kv
        deq = (codes[l].to(torch.float32) * scales[l]).to(compute_dtype)
        return deq[0], deq[1]
    return kv[l, 0], kv[l, 1]


def from_jax_cache(kv, device=None):
    """A JAX cache as numpy (a dense array, or the int8 pair (codes, scales
    (L, 2, B, T, KV, 1))) -> the port's cache on `device` (None: the card,
    as every entry point resolves it)."""
    device = resolve_device(device)
    if isinstance(kv, (tuple, list)):
        return tuple(torch.from_numpy(a.copy()).to(device) for a in kv)
    return torch.from_numpy(kv.copy()).to(device)
