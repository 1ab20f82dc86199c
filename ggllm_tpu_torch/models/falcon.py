"""Falcon (7B/40B) forward pass as a torch nn.Module (port of
ggllm_tpu/models/falcon.py, merged-weight layout only).

* NeoX RoPE with dynamic NTK scaling on Q and K (libfalcon.cpp:2229-2234);
* multi-query / grouped-query attention: n_head query heads share
  n_head_kv KV heads (libfalcon.cpp:2285-2356);
* parallel attention + FFN residual: ``x = x + attn(ln_a(x)) + mlp(ln_m(x))``
  (libfalcon.cpp:2399-2403). Falcon-7B has ONE input layernorm feeding both;
  40B-style models have separate ln_attn / ln_mlp (``parallel_norms``);
* tanh-GELU FFN (4x expansion), final layernorm, lm_head.

Weights are merged as the JAX kernel path merges them (io/loader.py): the
file's fused QKV stays one matrix; with a shared input norm FFN-up joins it
as extra output rows ("wqkvu"), and wo / FFN-down merge along the
contraction dim ("w_od", fed concat([attn, gelu(ff)])).

Each layer writes its new K/V into the cache in place before attending
(quantized, for an int8 cache: ops/kvcache.py), unless the caller passes a
decode chunk's `pending` buffer: then the cache stays untouched, attention
reads the cache below the chunk's start plus the unquantized [current token;
pending] block, and the new K/V go back to the caller (chunk-deferred decode,
ggllm_tpu/models/falcon.py falcon_forward:305-377). Prefill attention runs
kernels/flash_attention (on the dequantized K/V of an int8 cache), decode
(S == 1) runs kernels/flash_decode over the valid cache prefix; with
st.flash False both use the plain einsum `_attention`, and with st.kernels
False the quantized matmuls use the plain dequantize-then-matmul version.

With kv None the forward is cacheless: each position attends to the
tokens' own K/V through `_attention`, writing nothing in place, so autograd
runs through it (tools/train_demo.py). SplitFalcon runs a rank's fallback
tree under a mesh (parallel/sharding.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ggllm_tpu_torch.core.config import FalconHParams
from ggllm_tpu_torch.kernels.flash_attention import flash_mqa
from ggllm_tpu_torch.kernels.flash_decode import flash_decode
from ggllm_tpu_torch.ops import kvcache
from ggllm_tpu_torch.ops.linear import linear
from ggllm_tpu_torch.ops.rope import rope_cos_sin, rotate
from ggllm_tpu_torch.parallel import sharding as sh

NORM_EPS = 1e-5  # ggml_norm epsilon (ggml.c, const eps = 1e-5f)


@dataclass(frozen=True)
class FalconStatic:
    """Static model description."""

    n_layer: int
    n_head: int
    n_head_kv: int
    head_dim: int
    n_embd: int
    n_ff: int
    n_vocab: int
    parallel_norms: bool  # True for 40B/180B (separate ln_attn/ln_mlp)
    flash: bool = True  # attention through the flash kernels
    kernels: bool = True  # quantized matmuls through the fused kernel

    @classmethod
    def from_hparams(cls, hp: FalconHParams, flash: bool = True,
                     kernels: bool = True) -> "FalconStatic":
        return cls(
            n_layer=hp.n_layer, n_head=hp.n_head, n_head_kv=hp.n_head_kv,
            head_dim=hp.head_dim, n_embd=hp.n_embd, n_ff=hp.n_ff,
            n_vocab=hp.n_vocab, parallel_norms=hp.n_falcon_type >= 40,
            flash=flash, kernels=kernels,
        )


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 layer norm (biased variance, eps 1e-5), result in x's dtype."""
    y = F.layer_norm(x.to(torch.float32), x.shape[-1:], w.to(torch.float32),
                     b.to(torch.float32), NORM_EPS)
    return y.to(x.dtype)


def _positions(n_past, B: int, S: int, device) -> torch.Tensor:
    """Per-row query positions (B, S). n_past: an int (a host value, for
    prefill) or a (1,) / (B,) int tensor on the device (a decode step: the
    positions are computed on the device, with no copy from the host)."""
    np_vec = torch.as_tensor(n_past, dtype=torch.long, device=device).reshape(-1).expand(B)
    return np_vec[:, None] + torch.arange(S, device=device)[None, :]


def _attention(q, k, v, n_past, st, kv_append=None, append_valid=None):
    """Plain causal MQA/GQA attention over a prefix-valid KV cache, f32
    softmax (the einsum reference, ggllm_tpu models/falcon.py _attention:92).

    q (B, S, H, D); k/v (B, T, KV, D); kv_append (2, B, A, KV, D): a block
    not yet written to the cache, appended after it with the cache masked
    strictly before n_past (or, with append_valid at S == 1, strictly before
    n_past - (append_valid - 1), and only the first append_valid entries of
    the block real)."""
    B, S, H, D = q.shape
    T = k.shape[1]
    KV = st.n_head_kv
    G = H // KV
    dev = q.device
    q_pos = _positions(n_past, B, S, dev)  # (B, S)
    t_pos = torch.arange(T, device=dev)
    if kv_append is not None:
        A = kv_append.shape[2]
        k = torch.cat([k, kv_append[0].to(k.dtype)], dim=1)
        v = torch.cat([v, kv_append[1].to(v.dtype)], dim=1)
        np_vec = q_pos[:, 0]
        if append_valid is not None:
            cache_start = np_vec - (int(append_valid) - 1)
            cache_mask = (t_pos[None, None, :] < cache_start[:, None, None]).expand(B, S, T)
            app_mask = (torch.arange(A, device=dev)[None, None, :] < int(append_valid)).expand(B, S, A)
        else:
            cache_mask = (t_pos[None, None, :] < np_vec[:, None, None]).expand(B, S, T)
            j = torch.arange(S, device=dev)
            app_mask = (j[None, None, :] <= j[None, :, None]).expand(B, S, S)
        mask = torch.cat([cache_mask, app_mask], dim=-1)
    else:
        # key position t visible to query i iff t <= n_past + i
        mask = t_pos[None, None, :] <= q_pos[:, :, None]  # (B, S, T)

    qg = q.reshape(B, S, KV, G, D).to(torch.float32)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.to(torch.float32)) * (1.0 / D ** 0.5)
    scores = torch.where(mask[:, None, None], scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.to(torch.float32))
    return out.reshape(B, S, H, D).to(q.dtype)


def attend(kv, l: int, q, kv_new, n_past, st, pending=None, n_pend: int = 0):
    """Layer l's attention of q (B, S, H, D) for either model family (st is
    its Static). Without `pending` the new K/V (2, B, S, KV, D) go into the
    cache in place first, then S == 1 runs flash_decode over the valid prefix
    and prefill runs flash_mqa (the plain `_attention` with st.flash False).
    With `pending` (chunk-deferred decode) the cache stays untouched and
    attention reads it below n_past - n_pend plus [kv_new; pending[l, :n_pend]].
    n_past: an int or a device tensor (see Falcon.forward); n_pend is a
    Python int, the step's index within a captured chunk."""
    if pending is not None:
        app = torch.cat([kv_new, pending[l, :, :, :n_pend].to(kv_new.dtype)], dim=2)
        if st.flash:
            return flash_decode(kv, st.n_head_kv, l, q, n_past, kv_append=app,
                                append_valid=1 + n_pend)
        k, v = kvcache.read_layer(kv, l, q.dtype)
        return _attention(q, k, v, n_past, st, kv_append=app, append_valid=1 + n_pend)
    kvcache.write_layer(kv, kv_new, l, n_past)
    if st.flash and q.shape[1] == 1:
        return flash_decode(kv, st.n_head_kv, l, q, n_past)
    k, v = kvcache.read_layer(kv, l, q.dtype)
    if st.flash:
        # q and a dense cache in another dtype (an f32 cache under bf16
        # compute, --memory-f32, or a bf16 cache under f32 compute) meet in
        # the wider of the two, since the kernels take one dtype: the JAX
        # kernel computes in f32 over both
        dt = torch.promote_types(q.dtype, k.dtype)
        return flash_mqa(q.to(dt), k.to(dt), v.to(dt), n_past).to(q.dtype)
    return _attention(q, k, v, n_past, st)


def select_last(x: torch.Tensor, last_pos) -> torch.Tensor:
    """(B, S, E) -> (B, 1, E) at position last_pos: None (the last one), an
    int, or a (B,) int tensor on x's device, a position a row (the JAX
    `_forward_rows_fn`'s last_pos_vec, ggllm_tpu/engine/engine.py:921)."""
    if isinstance(last_pos, torch.Tensor):
        B, _, E = x.shape
        return x.gather(1, last_pos.reshape(B, 1, 1).to(torch.int64).expand(B, 1, E))
    lp = x.shape[1] - 1 if last_pos is None else last_pos
    return x[:, lp:lp + 1]


class FalconLayer(nn.Module):
    """One decoder block. Norm vectors are buffers; each 2-D weight is a
    QuantTensor submodule or a dense buffer, under its JAX tree key."""

    def __init__(self, lw: dict):
        super().__init__()
        for name, val in lw.items():
            _attach(self, name, val)

    def pre(self, x, rope, st: FalconStatic):
        """Norms, projections, RoPE (rope = rope_cos_sin of the positions).
        Returns (q (B,S,H,D), kv_new (2,B,S,KV,D), gelu'd ff)."""
        B, S, _ = x.shape
        H, KV, D = st.n_head, st.n_head_kv, st.head_dim
        ln_mlp = layer_norm(x, self.input_ln_w, self.input_ln_b)
        ln_attn = layer_norm(x, self.attn_ln_w, self.attn_ln_b) if st.parallel_norms else ln_mlp
        if hasattr(self, "wqkvu"):  # 7B merged: one launch for QKV + FFN-up
            n_qkv = (H + 2 * KV) * D
            proj = linear(self.wqkvu, ln_attn, kernels=st.kernels)
            qkv, ff = proj[..., :n_qkv], proj[..., n_qkv:]
        else:  # separate norms: fused QKV, separate up
            qkv = linear(self.wqkv, ln_attn, kernels=st.kernels)
            ff = linear(self.ffn_up, ln_mlp, kernels=st.kernels)
        qkv = qkv.reshape(B, S, H + 2 * KV, D)
        # RoPE over the contiguous [Q; K] head block, V untouched
        qk = rotate(qkv[:, :, :H + KV], *rope)
        q = qk[:, :, :H]
        kv_new = torch.stack([qk[:, :, H:], qkv[:, :, H + KV:]], dim=0)
        gf = F.gelu(ff.to(torch.float32), approximate="tanh").to(ff.dtype)
        return q, kv_new, gf

    def post(self, x, attn, gf, st: FalconStatic, reduce=None):
        """Output projection + parallel residual. Under tensor parallelism
        (parallel/tp.py) the projection's contraction is split over the
        ranks and `reduce` (the mesh's psum) adds the partial outputs before
        the residual: the layer's one collective."""
        B, S, _ = x.shape
        attn = attn.reshape(B, S, st.n_head * st.head_dim)
        if hasattr(self, "w_od"):  # merged wo + down along K, fed [attn; gelu]
            out = linear(self.w_od, torch.cat([attn, gf], dim=-1), kernels=st.kernels)
        else:
            out = (linear(self.wo, attn, kernels=st.kernels)
                   + linear(self.ffn_down, gf, kernels=st.kernels))
        if reduce is not None:
            out = reduce(out)
        return x + out


def _attach(module: nn.Module, name: str, val):
    if isinstance(val, nn.Module):
        module.add_module(name, val)
    else:
        module.register_buffer(name, val)


class Falcon(nn.Module):
    """The full model over a parameter tree from io/loader.py. `reduce`
    (None, or a tensor-parallel mesh's psum, set by the engine) runs after
    each layer's output projection; `layer(i, lw)` makes layer i's module."""

    reduce = None

    def __init__(self, st: FalconStatic, params: dict, layer=None):
        super().__init__()
        self.st = st
        for name in ("tok_embeddings", "output_norm", "output_norm_b", "lm_head"):
            _attach(self, name, params[name])
        layer = layer or (lambda i, lw: FalconLayer(lw))
        self.layers = nn.ModuleList(layer(i, lw) for i, lw in enumerate(params["layers"]))

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.tok_embeddings[tokens]

    def head(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self.lm_head, x, torch.float32, kernels=self.st.kernels)

    def forward(self, tokens: torch.Tensor, kv, n_past, inv_freq: torch.Tensor,
                logits_all: bool = False, last_pos=None,
                pending: torch.Tensor | None = None, n_pend: int = 0,
                output_hidden: bool = False):
        """tokens (B, S) int64 on the model's device; kv the stacked cache
        (L, 2, B, T, KV, D) or the int8 pair (codes, scales), updated in place
        at [n_past, n_past + S). n_past: a Python int, or a (1,) or (B,) int
        tensor on the model's device (a position a row) that RoPE, the cache
        write and the attention kernels read there (a decode step captured in
        a CUDA graph holds no host value). Returns f32 logits (B, S, V) if
        logits_all, else (B, 1, V) at position last_pos (default S - 1; an
        int, or a (B,) device tensor, a position a row).

        kv None: a cacheless causal forward, each position attending to the
        tokens' own K/V through the plain `_attention` (T = S), which writes
        nothing in place, so autograd can run through it (the JAX training
        loss's fresh cache, tools/train_demo.py).

        pending / n_pend (chunk-deferred decode, S == 1): `pending` is the
        decode chunk's K/V buffer (L, 2, B, P, KV, D) whose first n_pend
        entries hold the chunk's earlier positions, not yet in the cache.
        Attention reads the cache strictly below n_past - n_pend plus
        [current token; pending[:n_pend]]; the cache is left untouched and
        the return value is (logits, kv_new (L, 2, B, 1, KV, D)) for the
        caller to put into `pending`."""
        st = self.st
        B, S = tokens.shape
        x = self.embed(tokens)
        rope = rope_cos_sin(_positions(n_past, B, S, tokens.device), inv_freq)
        deferred = []
        for l, layer in enumerate(self.layers):
            q, kv_new, gf = layer.pre(x, rope, st)
            if kv is None:
                attn = _attention(q, kv_new[0], kv_new[1], n_past, st)
            else:
                attn = attend(kv, l, q, kv_new, n_past, st, pending, n_pend)
            if pending is not None:
                deferred.append(kv_new)
            x = layer.post(x, attn, gf, st, self.reduce)
        x = layer_norm(x, self.output_norm, self.output_norm_b)
        if not logits_all:
            x = select_last(x, last_pos)
        out = x.to(torch.float32) if output_hidden else self.head(x)
        return (out, torch.stack(deferred)) if pending is not None else out


class SplitLayer(FalconLayer):
    """A layer of the fallback tree (parallel/sharding.py): each of wq / wk /
    wv / wo / ffn_up / ffn_down holds this rank's split as `specs` says, and
    the collectives run on `comm` (the mesh's model row): a head reshape or
    a whole-width consumer gathers an "out" split, an "in" split takes its
    slice of x and the partial products meet in one psum a layer. With K/V
    split by heads (sharding.kv_split) the rank computes and attends only its
    own K/V heads and their query groups (st is then the local Static);
    otherwise every rank attends all heads. `whole` is the model's Static."""

    def __init__(self, lw: dict, specs: dict, comm, whole: FalconStatic):
        super().__init__(lw)
        self.specs, self.comm, self.whole = specs, comm, whole

    def _proj(self, key: str, x, st):
        return sh.split_linear(getattr(self, key), self.specs[key], x, self.comm, st.kernels)

    def pre(self, x, rope, st: FalconStatic):
        B, S, _ = x.shape
        H, D, c = st.n_head, st.head_dim, self.comm
        ln_mlp = layer_norm(x, self.input_ln_w, self.input_ln_b)
        ln_attn = layer_norm(x, self.attn_ln_w, self.attn_ln_b) if st.parallel_norms else ln_mlp
        split = st.n_head_kv != self.whole.n_head_kv  # this rank's heads only
        heads = {}
        for key, n in (("wq", H), ("wk", st.n_head_kv), ("wv", st.n_head_kv)):
            lo = c.rank * n * D if split else 0
            heads[key] = sh.columns(self._proj(key, sh.full(ln_attn), st), lo, lo + n * D,
                                    c).reshape(B, S, n, D)
        q, k = rotate(heads["wq"], *rope), rotate(heads["wk"], *rope)
        up = self._proj("ffn_up", sh.full(ln_mlp), st)
        if up.form == "partial":  # GELU needs the whole sum
            up = sh.full(sh.whole(up, c))
        gf = up._replace(y=F.gelu(up.y.to(torch.float32), approximate="tanh").to(up.y.dtype))
        return q, torch.stack([k, heads["wv"]], dim=0), gf

    def post(self, x, attn, gf, st: FalconStatic, reduce=None):
        B, S, _ = x.shape
        n, c = st.n_head * st.head_dim, self.comm
        attn = attn.reshape(B, S, n)
        whole = self.whole.n_head * self.whole.head_dim
        ap = (sh.full(attn) if n == whole else
              sh.Part(attn, "slice", c.rank * n, (c.rank + 1) * n, whole))
        return x + sh.combine([self._proj("wo", ap, st), self._proj("ffn_down", gf, st)], c)


class SplitFalcon(Falcon):
    """The model over a rank's fallback tree (io/loader.py under a mesh the
    tensor-parallel plan cannot take): SplitLayers, the embedding's columns
    split where `specs` says (gathered after the lookup) and lm_head split
    as its spec says (the logits gathered). st is the local Static (its
    K/V heads and query groups where K/V split), whole the model's."""

    def __init__(self, st: FalconStatic, params: dict, specs: dict, comm, whole: FalconStatic):
        super().__init__(st, params,
                         lambda i, lw: SplitLayer(lw, specs["layers"][i], comm, whole))
        self.specs, self.comm = specs, comm

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.tok_embeddings[tokens]
        if self.specs["tok_embeddings"] is None or self.comm.size == 1:
            return x
        return self.comm.all_gather(x, -1)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        return sh.whole(sh.split_linear(self.lm_head, self.specs["lm_head"], sh.full(x),
                                        self.comm, self.st.kernels, torch.float32), self.comm)
