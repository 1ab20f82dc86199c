"""Causal MQA/GQA prefill attention: the hand-written CUDA kernel
(csrc/flash_attention.cu) and its plain PyTorch version.

Replaces the Pallas kernel ggllm_tpu/kernels/flash_attention.py `_kern`
(launched by flash_mqa). Key t is visible to query i of row b iff
t <= n_past[b] + i; f32 softmax; output in q's dtype. Head dims 32, 64 and
128; query heads that share a K/V head (Falcon) run the block layout of 8
heads x 16 positions, G == 1 (LLaMA) or D == 128 the one-head-per-block
layout (csrc/flash_attention.cu flash_mha_kernel).
"""

from __future__ import annotations

import torch

from ggllm_tpu_torch.kernels import build

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (32, 64, 128)


def _n_past_vec(n_past, B: int, device) -> torch.Tensor:
    return torch.as_tensor(n_past, dtype=torch.int32, device=device).reshape(-1).expand(B)


def flash_mqa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_past) -> torch.Tensor:
    """Plain version: masked f32 softmax over the whole (S, T) score block."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    q_pos = _n_past_vec(n_past, B, q.device)[:, None] + torch.arange(S, device=q.device)
    mask = torch.arange(T, device=q.device)[None, None, :] <= q_pos[:, :, None]  # (B,S,T)
    qg = q.reshape(B, S, KV, G, D).to(torch.float32)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.to(torch.float32)) * (1.0 / D ** 0.5)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.to(torch.float32))
    return out.reshape(B, S, H, D).to(q.dtype)


def flash_mqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_past) -> torch.Tensor:
    """Causal MQA/GQA attention. q (B,S,H,D); k/v (B,T,KV,D) (views of the
    cache are fine: the time and batch strides are passed through); n_past
    an int, or a (B,) int tensor. Returns (B,S,H,D) in q.dtype."""
    if q.device.type == "cpu":
        return flash_mqa_plain(q, k, v, n_past)
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_mqa kernel: q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(f"flash_mqa kernel: head_dim {D} (supported {KERNEL_HEAD_DIMS})")
    if H % KV or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_mqa: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if k.stride() != v.stride() or k.stride(3) != 1 or k.stride(2) != D:
        raise ValueError("flash_mqa kernel: k/v need contiguous heads and equal strides")
    if (k.data_ptr() | v.data_ptr() | (k.stride(1) * k.element_size())) % 16:
        raise ValueError("flash_mqa kernel: k/v rows must be 16-byte aligned")
    q = q.contiguous()
    out = torch.empty_like(q)
    if isinstance(n_past, int):
        npv, np_scalar = None, n_past
    else:
        npv = _n_past_vec(n_past, B, q.device).contiguous()
        np_scalar = 0
    build.launch("gq_flash_mqa", "flash_mqa", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), int(q.dtype == torch.bfloat16),
                 None if npv is None else npv.data_ptr(), np_scalar,
                 B, S, H, T, KV, D, k.stride(0), k.stride(1), build.stream_ptr(q.device))
    return out
