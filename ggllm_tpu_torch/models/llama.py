"""LLaMA forward pass as a torch nn.Module (port of ggllm_tpu/models/llama.py,
which re-implements llama_eval_internal, llama.cpp:1368-1660), in the same
engine framework as the Falcon model: same KV-cache layout, same kernels.

* RMSNorm (eps 1e-6, ggml_rms_norm) instead of layernorm;
* classic RoPE (ggml rope mode 0: adjacent pairs (2j, 2j+1)) on the first
  n_rot dims of Q and K;
* sequential residuals: x += wo(attn(rmsnorm(x))); x += ffn(rmsnorm(x));
* SwiGLU FFN: w2(silu(w1 h) * w3 h), SiLU in f32, cast back, then the product;
* no GQA: n_head_kv == n_head, so decode attention is the G == 1 kernel of
  kernels/flash_decode.

Weight layouts as io/loader.py builds them: [wq; wk; wv] rows merged as
"wqkv" and [w1; w3] rows as "w13" where the formats allow (both pairs share
an input), else the split keys; wo and w2 stay separate (sequential
dependency). The KV write and the attention dispatch are models/falcon.py
`attend`: a dense cache is written in place each step, an int8 cache decodes
chunk-deferred through `pending` / `n_pend`. The JAX module's tensor-parallel
psum and its lax.scan layer loop have no counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ggllm_tpu_torch.core.config import LlamaHParams
from ggllm_tpu_torch.models.falcon import _attach, _positions, attend, select_last
from ggllm_tpu_torch.ops.linear import linear
from ggllm_tpu_torch.ops.rope import rope_cos_sin, rotate_classic

RMS_EPS = 1e-6  # ggml_rms_norm epsilon


@dataclass(frozen=True)
class LlamaStatic:
    """Static model description (the fields FalconStatic has, plus n_rot)."""

    n_layer: int
    n_head: int
    n_head_kv: int
    head_dim: int
    n_embd: int
    n_ff: int
    n_vocab: int
    n_rot: int
    parallel_norms: bool = False  # interface parity with FalconStatic
    flash: bool = True  # attention through the flash kernels
    kernels: bool = True  # quantized matmuls through the fused kernel

    @classmethod
    def from_hparams(cls, hp: LlamaHParams, flash: bool = True,
                     kernels: bool = True) -> "LlamaStatic":
        return cls(
            n_layer=hp.n_layer, n_head=hp.n_head, n_head_kv=hp.n_head,
            head_dim=hp.head_dim, n_embd=hp.n_embd, n_ff=hp.n_ff,
            n_vocab=hp.n_vocab, n_rot=hp.n_rot, flash=flash, kernels=kernels,
        )


def rms_norm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 RMS norm (eps 1e-6), result in x's dtype."""
    y = F.rms_norm(x.to(torch.float32), x.shape[-1:], w.to(torch.float32), RMS_EPS)
    return y.to(x.dtype)


class LlamaLayer(nn.Module):
    """One decoder block. Norm vectors are buffers; each 2-D weight is a
    QuantTensor submodule or a dense buffer, under its JAX tree key."""

    def __init__(self, lw: dict):
        super().__init__()
        for name, val in lw.items():
            _attach(self, name, val)

    def pre(self, x, rope, st: LlamaStatic):
        """RMSNorm, QKV projection, RoPE on [Q; K] (rope = rope_cos_sin of
        the positions). Returns (q (B,S,H,D), kv_new (2,B,S,H,D)); V is not
        rotated."""
        B, S, _ = x.shape
        H, D = st.n_head, st.head_dim
        h = rms_norm(x, self.attn_norm)
        if hasattr(self, "wqkv"):
            qkv = linear(self.wqkv, h, kernels=st.kernels).reshape(B, S, 3 * H, D)
        else:
            qkv = torch.cat([linear(w, h, kernels=st.kernels).reshape(B, S, H, D)
                             for w in (self.wq, self.wk, self.wv)], dim=2)
        qk = rotate_classic(qkv[:, :, :2 * H], *rope, st.n_rot)
        return qk[:, :, :H], torch.stack([qk[:, :, H:], qkv[:, :, 2 * H:]], dim=0)

    def ffn(self, x, st: LlamaStatic):
        """SwiGLU: w2(silu(w1 h) * w3 h) of h = rmsnorm(x)."""
        h = rms_norm(x, self.ffn_norm)
        if hasattr(self, "w13"):
            g = linear(self.w13, h, kernels=st.kernels)
            gate, up = g[..., :st.n_ff], g[..., st.n_ff:]
        else:
            gate = linear(self.w1, h, kernels=st.kernels)
            up = linear(self.w3, h, kernels=st.kernels)
        act = F.silu(gate.to(torch.float32)).to(gate.dtype) * up
        return linear(self.w2, act, kernels=st.kernels)


class Llama(nn.Module):
    """The full model over a parameter tree from io/loader.py."""

    def __init__(self, st: LlamaStatic, params: dict):
        super().__init__()
        self.st = st
        for name in ("tok_embeddings", "output_norm", "lm_head"):
            _attach(self, name, params[name])
        self.layers = nn.ModuleList(LlamaLayer(lw) for lw in params["layers"])

    def forward(self, tokens: torch.Tensor, kv, n_past: int, inv_freq: torch.Tensor,
                logits_all: bool = False, last_pos: int | None = None,
                pending: torch.Tensor | None = None, n_pend: int = 0,
                output_hidden: bool = False):
        """Same contract as models/falcon.py Falcon.forward (the engine
        calls either), including the chunk-deferred decode mode (pending /
        n_pend: the new K/V block (L, 2, B, 1, H, D) is returned beside the
        logits instead of written). output_hidden returns the final normed
        hidden state in f32 in place of the logits."""
        st = self.st
        B, S = tokens.shape
        x = self.tok_embeddings[tokens]
        rope = rope_cos_sin(_positions(n_past, B, S, tokens.device), inv_freq)
        deferred = []
        for l, layer in enumerate(self.layers):
            q, kv_new = layer.pre(x, rope, st)
            attn = attend(kv, l, q, kv_new, n_past, st, pending, n_pend)
            if pending is not None:
                deferred.append(kv_new)
            x = x + linear(layer.wo, attn.reshape(B, S, st.n_head * st.head_dim),
                           kernels=st.kernels)
            x = x + layer.ffn(x, st)
        x = rms_norm(x, self.output_norm)
        if not logits_all:
            x = select_last(x, last_pos)
        if output_hidden:
            out = x.to(torch.float32)
        else:
            out = linear(self.lm_head, x, torch.float32, kernels=st.kernels)
        return (out, torch.stack(deferred)) if pending is not None else out
