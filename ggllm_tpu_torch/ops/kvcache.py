"""Dense KV cache (port of the dense part of ggllm_tpu/ops/kvcache.py).

A cache is one tensor (L, 2, B, T, KV, D). Unlike the JAX package, whose
arrays are immutable, the port updates the cache IN PLACE: `write_layer`
copies the new block into the existing tensor and returns that same tensor.
The int8 cache mode is not ported.
"""

from __future__ import annotations

import torch


def new(shape: tuple, kv_dtype, device) -> torch.Tensor:
    """Allocate a zeroed cache. shape = (L, 2, B, T, KV, D)."""
    if kv_dtype == "int8":
        raise NotImplementedError("the int8 KV cache is not ported")
    return torch.zeros(shape, dtype=getattr(torch, str(kv_dtype)), device=device)


def write_layer(kv: torch.Tensor, kv_new: torch.Tensor, l: int, n_past: int) -> torch.Tensor:
    """Write kv_new (2, B, S, KV, D) into layer l at positions
    [n_past, n_past + S), in place; returns kv."""
    S = kv_new.shape[2]
    kv[l, :, :, n_past:n_past + S] = kv_new.to(kv.dtype)
    return kv


def read_layer(kv: torch.Tensor, l: int):
    """Layer l's (k, v), each (B, T, KV, D): views, no copy."""
    return kv[l, 0], kv[l, 1]
