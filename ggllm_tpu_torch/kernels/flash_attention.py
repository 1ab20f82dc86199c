"""Causal MQA/GQA prefill attention: the hand-written CUDA kernels
(csrc/flash_attention_tc.cu, csrc/flash_attention.cu) and their plain
PyTorch version.

Replaces the Pallas kernel ggllm_tpu/kernels/flash_attention.py `_kern`
(launched by flash_mqa). Key t is visible to query i of row b iff
t <= n_past[b] + i; f32 softmax; output in q's dtype. bf16 q/k/v with head
dim 64 or 128 run the tensor-core kernel (`mma.sync` for both products; a
block is 64 (position, head) rows of one K/V head, position-major:
`tc_block_plan`). f32, and head dim 32, run the f32 kernels: query heads that
share a K/V head (Falcon) the block layout of 8 heads x 16 positions, G == 1
(LLaMA) or D == 128 the one-head-per-block layout (flash_mha_kernel).
"""

from __future__ import annotations

import torch

from ggllm_tpu_torch.kernels import build

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (32, 64, 128)
TC_HEAD_DIMS = (64, 128)  # the tensor-core kernel's, bf16 only
TC_BLOCK_ROWS = 64        # query rows of a block
TC_TILE_KEYS = 64         # keys of a staged K/V tile


def route(dtype, D: int) -> str:
    """The kernel that serves q/k/v of `dtype` and head dim D on the card:
    "tc" (bf16, D 64 or 128) or "simt" (f32; D = 32). Raises for what neither
    takes."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_mqa kernel: dtype {dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(f"flash_mqa kernel: head_dim {D} (supported {KERNEL_HEAD_DIMS})")
    return "tc" if dtype == torch.bfloat16 and D in TC_HEAD_DIMS else "simt"


def tc_block_plan(S: int, G: int, n_past: int, T: int, block: int) -> dict:
    """What block `block` of one (batch row, K/V head) does in the
    tensor-core kernel (the index arithmetic of csrc/flash_attention_tc.cu).
    The S * G query rows of a K/V head are ordered position-major, row
    r = position * G + head; the block owns rows [64 block, 64 block + 64).
    Returns {"rows": [(position, head), ...], "tiles": the number of 64-key
    tiles it visits (from key 0), "masked": the visited tiles on which it
    tests every score against its row's last visible key (the others lie
    wholly below every row's diagonal), "last_key": per row, the last key it
    may see (also capped by T in the kernel)}."""
    nrows = S * G
    r0 = block * TC_BLOCK_ROWS
    rows = [(r // G, r % G) for r in range(r0, min(r0 + TC_BLOCK_ROWS, nrows))]
    p_lo, p_hi = r0 // G, min(r0 + TC_BLOCK_ROWS - 1, nrows - 1) // G
    t_end = min(T, n_past + p_hi + 1)
    t_full = n_past + p_lo + 1
    tiles = -(-t_end // TC_TILE_KEYS)
    masked = [i for i in range(tiles)
              if (i + 1) * TC_TILE_KEYS > t_full or (i + 1) * TC_TILE_KEYS > T]
    return {"rows": rows, "tiles": tiles, "masked": masked,
            "last_key": [n_past + pos for pos, _ in rows]}


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
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_mqa kernel: q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    path = route(q.dtype, D)
    if H % KV or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_mqa: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if k.stride() != v.stride() or k.stride(3) != 1 or k.stride(2) != D:
        raise ValueError("flash_mqa kernel: k/v need contiguous heads and equal strides")
    if (k.data_ptr() | v.data_ptr() | (k.stride(1) * k.element_size())) % 16:
        raise ValueError("flash_mqa kernel: k/v rows must be 16-byte aligned")
    q = q.contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    out = torch.empty_like(q)
    if isinstance(n_past, int):
        npv, np_scalar = None, n_past
    else:
        npv = _n_past_vec(n_past, B, q.device).contiguous()
        np_scalar = 0
    npv_ptr = None if npv is None else npv.data_ptr()
    if path == "tc":
        build.launch("gq_flash_mqa_tc", ("flash_mqa", "flash_mqa.tc"), q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), out.data_ptr(), npv_ptr, np_scalar, B, S, H, T, KV, D,
                     k.stride(0), k.stride(1), build.stream_ptr(q.device))
    else:
        build.launch("gq_flash_mqa", ("flash_mqa", "flash_mqa.simt"), q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), out.data_ptr(), int(q.dtype == torch.bfloat16), npv_ptr,
                     np_scalar, B, S, H, T, KV, D, k.stride(0), k.stride(1),
                     build.stream_ptr(q.device))
    return out
