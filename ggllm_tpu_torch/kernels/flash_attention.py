"""Causal MQA/GQA prefill attention: the hand-written CUDA kernels
(csrc/flash_attention_tc.cu, csrc/flash_attention_f32.cu) and their plain
PyTorch version.

Replaces the Pallas kernel ggllm_tpu/kernels/flash_attention.py `_kern`
(launched by flash_mqa). Key t is visible to query i of row b iff
t <= n_past[b] + i; f32 softmax; output in q's dtype. bf16 q/k/v (head dim
32, 64 or 128) run the bf16 tensor-core kernel (`mma.sync` for both
products; a block is 64 (position, head) rows of one K/V head,
position-major: `tc_block_plan`; its shared-memory swizzle:
`tc_smem_offset`). f32 q/k/v (head dim 32, 64 or 128) run the f32
tensor-core kernel on the same block plan, each product as three split-TF32
products at f32 accuracy (`flash_mqa_f32_emulated` restates its
arithmetic). `flash_mqa` is also the op ggllm::flash_mqa
(kernels/library.py), which a tracer gets (torch.compiler.is_compiling()):
its CUDA implementation is `flash_mqa_cuda`, its CPU implementation the
plain version; an eager call goes to them directly.
"""

from __future__ import annotations

import torch

from ggllm_tpu_torch.kernels import build

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (32, 64, 128)
TC_HEAD_DIMS = (32, 64, 128)  # the bf16 tensor-core kernel's
TC_BLOCK_ROWS = 64        # query rows of a block (both tensor-core kernels)
TC_TILE_KEYS = {32: 128, 64: 64, 128: 64}  # the bf16 kernel's keys a staged tile, by head dim
F32_TILE_KEYS = {32: 64, 64: 64, 128: 32}  # the f32 kernel's, by head dim


def route(dtype, D: int) -> str:
    """The kernel that serves q/k/v of `dtype` and head dim D on the card:
    "tc" (bf16) or "f32" (f32: split TF32 on the tensor cores), each at D 32,
    64 or 128. Raises for what neither takes."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_mqa kernel: dtype {dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(f"flash_mqa kernel: head_dim {D} (supported {KERNEL_HEAD_DIMS})")
    return "f32" if dtype == torch.float32 else "tc"


def tc_block_plan(S: int, G: int, n_past: int, T: int, block: int, keys: int) -> dict:
    """What block `block` of one (batch row, K/V head) does in a
    tensor-core kernel (the index arithmetic of csrc/flash_attention_tc.cu
    with keys = TC_TILE_KEYS[D], and of csrc/flash_attention_f32.cu with
    keys = F32_TILE_KEYS[D]).
    The S * G query rows of a K/V head are ordered position-major, row
    r = position * G + head; the block owns rows [64 block, 64 block + 64).
    Returns {"rows": [(position, head), ...], "tiles": the number of
    `keys`-key tiles it visits (from key 0), "masked": the visited tiles on
    which it tests every score against its row's last visible key (the
    others lie wholly below every row's diagonal), "last_key": per row, the
    last key it may see (also capped by T in the kernel)}."""
    nrows = S * G
    r0 = block * TC_BLOCK_ROWS
    rows = [(r // G, r % G) for r in range(r0, min(r0 + TC_BLOCK_ROWS, nrows))]
    p_lo, p_hi = r0 // G, min(r0 + TC_BLOCK_ROWS - 1, nrows - 1) // G
    t_end = min(T, n_past + p_hi + 1)
    t_full = n_past + p_lo + 1
    tiles = -(-t_end // keys)
    masked = [i for i in range(tiles) if (i + 1) * keys > t_full or (i + 1) * keys > T]
    return {"rows": rows, "tiles": tiles, "masked": masked,
            "last_key": [n_past + pos for pos, _ in rows]}


def tc_smem_offset(D: int, row: int, c: int) -> int:
    """Byte offset of 16-byte chunk c of row `row` in a staged Q, K or V tile
    of the bf16 tensor-core kernel (csrc/flash_attention_tc.cu smem_off):
    rows of 2 D bytes, chunk c at chunk c ^ (row & 7) of its row for D >= 64
    (a row fills a 128-byte line or two), c ^ ((row >> 1) & 3) at D = 32 (two
    rows a line), so that the 8 rows of an ldmatrix phase fall on 8 distinct
    16-byte slots of a line."""
    x = (row & 7) if D >= 64 else ((row >> 1) & 3)
    return row * D * 2 + ((c ^ x) << 4)


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


def tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 (10 mantissa bits) as the kernel's `cvt.rna.tf32.f32`
    rounds: to the nearest TF32 value, ties away from zero, by adding half a
    unit of the kept bits to the magnitude's bit pattern and masking the 13
    dropped bits (a carry moves into the exponent, as it should). Finite
    inputs below the largest TF32. A subnormal input keeps its bits from
    2^-136 up, as the conversion does: its 13 low bits are masked too."""
    bits = a.to(torch.float32).view(torch.int32)
    return ((bits + 0x1000) & -8192).view(torch.float32)


def split_tf32(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) = (tf32(a), tf32(a - hi)), both as f32. hi is the nearest
    TF32 value of a, ties away from zero, and
        |hi + lo - a| <= max(|a| 2^-21, 2^-137):
    the relative term wherever the remainder a - hi is a normal float; the
    absolute term covers a remainder below 2^-126, whose bits under 2^-136
    the conversion drops (tf32_rna)."""
    hi = tf32_rna(a)
    return hi, tf32_rna(a.to(torch.float32) - hi)


def mm_split_tf32(a: torch.Tensor, b: torch.Tensor, eq: str, terms: int = 3) -> torch.Tensor:
    """einsum(eq, a, b) from the split-TF32 terms, the small products first:
    lo x hi + hi x lo + hi x hi (terms = 3), or hi x hi alone (terms = 1, a
    negative control), each product summed in f32."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    hh = torch.einsum(eq, ah, bh)
    if terms == 1:
        return hh
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) + hh


def flash_mqa_f32_emulated(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_past,
                           terms: int = 3) -> torch.Tensor:
    """(B, S, H, D) f32: causal attention as the f32 kernel computes it: per
    tile of F32_TILE_KEYS[D] keys from key 0, S = Q K^T as three split-TF32
    products (tf32_rna), masked scores -1e30, the online softmax in base 2
    (p = 2^(s sl2 - m sl2), sl2 = log2(e) / sqrt(D)), then P, split after the
    softmax, times V the same way; out = acc / max(l, 1e-30). terms = 1 keeps
    the hi x hi products alone."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G, BT = H // KV, F32_TILE_KEYS[D]
    f32 = torch.float32
    q_pos = _n_past_vec(n_past, B, q.device)[:, None] + torch.arange(S, device=q.device)
    qg = q.reshape(B, S, KV, G, D).to(f32)
    sl2 = (1.0 / D ** 0.5) * 1.4426950408889634
    m = torch.full((B, KV, G, S), NEG_INF, dtype=f32)
    lsum = torch.zeros(B, KV, G, S, dtype=f32)
    acc = torch.zeros(B, KV, G, S, D, dtype=f32)
    for t0 in range(0, T, BT):
        kt, vt = k[:, t0:t0 + BT].to(f32), v[:, t0:t0 + BT].to(f32)
        s = mm_split_tf32(qg, kt, "bskgd,btkd->bkgst", terms)
        keys = t0 + torch.arange(kt.shape[1])
        s = torch.where((keys[None, None, :] <= q_pos[:, :, None])[:, None, None], s, NEG_INF)
        mx = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - mx) * sl2)
        p = torch.exp2(s * sl2 - (mx * sl2)[..., None])
        lsum = lsum * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + mm_split_tf32(p, vt, "bkgst,btkd->bkgsd", terms)
        m = mx
    out = acc / torch.clamp(lsum, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D)


def flash_mqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_past) -> torch.Tensor:
    """Causal MQA/GQA attention. q (B,S,H,D); k/v (B,T,KV,D) (views of the
    cache are fine: the time and batch strides are passed through); n_past
    an int, or a (B,) int tensor. Returns (B,S,H,D) in q.dtype (the op
    ggllm::flash_mqa under a tracer)."""
    build.no_grad_inputs("flash_mqa", q, k, v)
    if torch.compiler.is_compiling():
        vec, scalar = (n_past, 0) if isinstance(n_past, torch.Tensor) else (None, int(n_past))
        return torch.ops.ggllm.flash_mqa.default(q, k, v, vec, scalar)
    if q.device.type == "cpu":
        return flash_mqa_plain(q, k, v, n_past)
    return flash_mqa_cuda(q, k, v, n_past)


def flash_mqa_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_past) -> torch.Tensor:
    """ggllm::flash_mqa on CUDA tensors: one launch of the kernel `route`
    picks. n_past an int or a (B,) int tensor."""
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
    entry = {"tc": "gq_flash_mqa_tc", "f32": "gq_flash_mqa_f32"}[path]
    build.launch(entry, ("flash_mqa", f"flash_mqa.{path}"), q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), npv_ptr, np_scalar, B, S, H, T, KV, D,
                 k.stride(0), k.stride(1), build.stream_ptr(q.device))
    return out
