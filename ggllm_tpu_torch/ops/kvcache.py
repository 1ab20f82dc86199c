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


def write_layer(kv, kv_new: torch.Tensor, l: int, n_past: int):
    """Write kv_new (2, B, S, KV, D) into layer l at positions
    [n_past, n_past + S), in place (quantized for an int8 cache); returns kv."""
    S = kv_new.shape[2]
    if is_quantized(kv):
        q, scale = quantize_new(kv_new)
        kv[0][l, :, :, n_past:n_past + S] = q
        kv[1][l, :, :, n_past:n_past + S] = scale
    else:
        kv[l, :, :, n_past:n_past + S] = kv_new.to(kv.dtype)
    return kv


def write_all_layers(kv, kv_new: torch.Tensor, n_past: int):
    """Write every layer's kv_new (L, 2, B, S, KV, D) at positions
    [n_past, n_past + S), in place: the one write that ends a chunk-deferred
    decode chunk (single stream: one n_past for all rows); returns kv."""
    S = kv_new.shape[3]
    if is_quantized(kv):
        q, scale = quantize_new(kv_new)
        kv[0][:, :, :, n_past:n_past + S] = q
        kv[1][:, :, :, n_past:n_past + S] = scale
    else:
        kv[:, :, :, n_past:n_past + S] = kv_new.to(kv.dtype)
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
