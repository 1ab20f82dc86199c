"""Rotary position embedding: NeoX-style with NTK-aware dynamic scaling
(port of ggllm_tpu/ops/rope.py) for Falcon, and ggml's classic adjacent-pair
form for LLaMA (ggllm_tpu/models/llama.py apply_rope_classic:64).

Matches the reference rope op in NeoX mode with Falcon's settings
(ggml.c:12875-12990, invoked from libfalcon.cpp:2229-2234 with mode=2,
dynamic NTK mode on and scale=2):

* dynamic alpha: ``alpha = ((n_ctx // 2048 - 1) * scale + 1) ** (d / (d - 2))``
  for n_ctx >= 2048 (integer division, exactly like the C code), else 1;
* static NTK: ``alpha = ntk_alpha ** (d / (d - 2))``;
* ``theta_scale = (alpha * freq_base) ** (-2 / d)``; pair (j, j + d/2) of each
  head rotates by ``theta_j = p * ang_scale * theta_scale**j``.

Angles are computed in float32; applied to any dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from ggllm_tpu_torch.core.config import RopeConfig


def ntk_alpha(cfg: RopeConfig, n_ctx: int, head_dim: int, arch: str = "falcon") -> float:
    """Effective alpha for a given max context (host-side, static)."""
    d = float(head_dim)
    dynamic = cfg.dynamic_ntk
    if dynamic is None:
        dynamic = arch == "falcon"  # llama.cpp applies no NTK scaling
    if dynamic:
        if n_ctx < cfg.trained_ctx:
            return 1.0
        # integer division replicates the reference's int arithmetic
        k = (n_ctx // cfg.trained_ctx - 1) * cfg.ntk_alpha + 1
        return float(k) ** (d / (d - 2.0))
    if cfg.dynamic_ntk is not None and cfg.ntk_alpha != 0.0:
        # static NTK only when explicitly configured (dynamic_ntk=False)
        return float(cfg.ntk_alpha) ** (d / (d - 2.0))
    return 1.0


def rope_angles(cfg: RopeConfig, n_ctx: int, head_dim: int,
                arch: str = "falcon") -> np.ndarray:
    """Per-dimension inverse frequencies, shape (head_dim//2,) float32."""
    alpha = ntk_alpha(cfg, n_ctx, head_dim, arch)
    theta_scale = (alpha * cfg.freq_base) ** (-2.0 / head_dim)
    j = np.arange(head_dim // 2, dtype=np.float32)
    return (theta_scale**j).astype(np.float32)  # theta_scale < 1


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor,
                 ang_scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of the rotation angles, each (..., seq, 1, head_dim/2):
    computed once per forward and shared by every layer."""
    theta = positions.to(torch.float32)[..., None] * float(ang_scale) * inv_freq  # (..., seq, d2)
    return torch.cos(theta)[..., None, :], torch.sin(theta)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor,
               ang_scale: float = 1.0) -> torch.Tensor:
    """Rotate x of shape (..., seq, n_head, head_dim) at given positions.

    positions: (..., seq) int. NeoX pairing: (x[j], x[j + d/2])."""
    return rotate(x, *rope_cos_sin(positions, inv_freq, ang_scale))


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """apply_rope with precomputed rope_cos_sin angles."""
    d2 = x.shape[-1] // 2
    x0 = x[..., :d2].to(torch.float32)
    x1 = x[..., d2:].to(torch.float32)
    r0 = x0 * cos - x1 * sin
    r1 = x0 * sin + x1 * cos
    return torch.cat([r0, r1], dim=-1).to(x.dtype)


def rotate_classic(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                   n_rot: int) -> torch.Tensor:
    """ggml rope mode 0 with precomputed rope_cos_sin angles: rotate the
    adjacent pairs (2j, 2j+1) of the first n_rot dims of x (B, S, H, D) by
    the first n_rot/2 angles; f32 inside, one cast back to x's dtype."""
    xr = x[..., :n_rot].to(torch.float32)
    cos, sin = cos[..., :n_rot // 2], sin[..., :n_rot // 2]
    x0, x1 = xr[..., 0::2], xr[..., 1::2]
    rot = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    rot = rot.reshape(xr.shape).to(x.dtype)
    if n_rot == x.shape[-1]:
        return rot
    return torch.cat([rot, x[..., n_rot:]], dim=-1)


def apply_rope_classic(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor,
                       n_rot: int) -> torch.Tensor:
    """rotate_classic at the given positions (B, S)."""
    return rotate_classic(x, *rope_cos_sin(positions, inv_freq), n_rot)
