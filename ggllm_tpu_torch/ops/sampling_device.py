"""On-device sampling for the decode loop (port of the single-stream part
of ggllm_tpu/ops/sampling_device.py): logit bias and repetition/frequency/
presence penalties against a device ring buffer of recent tokens, then
greedy or top-k -> top-p -> temperature -> categorical, on uniforms
drawn from an explicit torch.Generator. Nothing here synchronizes with the
host or copies from it, so the engine captures these functions in its
decode graph. A captured step is keyed on the sampler's shape alone
(sampler_key: greedy or not, the candidate count, whether top-p cuts,
whether a penalty applies, the ring length, the bias count); temperature,
top-p, the penalty values and the bias are device tensors (SamplerValues)
written before each replay, so one graph serves every value.
`device_samplable` says which sampler settings this covers; the engine
routes the rest to the host cascade (ops/sampling.py).

A grammar's mask (ops/grammar.py GrammarSampler.valid_bits: ceil(V/8)
little-endian packed bytes) is applied on the device by apply_grammar_mask,
first of all, before the bias and the penalties (llama.cpp's order, and the
JAX engine's, ggllm_tpu/engine/engine.py:761-775 and :1120-1127), where
the key says `masked`; the bits are a static device buffer of the key's
values (SamplerValues.bits, RowValues.bits), written before each replay.

The draw takes its uniforms as an input: the engine draws a whole chunk's
((n_steps,), one a token, one launch from the engine's torch.Generator)
into a static buffer before each replay of the captured chunk, the
`sample_rows_u` idea of ggllm_tpu/ops/sampling_device.py:275. The graph
holds no generator state, and the graph and the eager step
body draw the same numbers for one seed, so they give the same ids."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def device_samplable(sampler) -> bool:
    """True if SamplerParams is within the device cascade's coverage (a copy
    of ggllm_tpu/ops/sampling_device.py:17).

    Covers bias -> repeat/frequency/presence penalties (ring buffer of the
    last repeat_last_n tokens lives on device) -> top-k -> top-p -> temp ->
    categorical; mirostat and the tfs/typical truncations stay host-only."""
    return (
        sampler.mirostat == 0
        and sampler.tfs_z >= 1.0
        and sampler.typical_p >= 1.0
        # top_k <= 0 means full-vocab in the reference cascade
        # (falcon_main.cpp sampling); the device path caps at 1024, so
        # route those to the host for exact semantics (greedy exempt)
        and (sampler.temp <= 0.0 or 0 < sampler.top_k <= 1024)
    )


def _bias(sampler, n_vocab: int) -> tuple:
    """The logit bias's in-vocabulary entries, sorted: ((id, value), ...)."""
    return tuple(sorted((int(t), float(b)) for t, b in sampler.logit_bias.items()
                        if 0 <= int(t) < n_vocab))


def penalty_spec(sampler, n_vocab: int, nl_token: int) -> tuple:
    """The penalty/bias stage's settings (ggllm_tpu/ops/sampling_device.py
    penalty_spec, plus the vocabulary's newline id, tokenizer.nl_id, which
    penalize_nl=False restores)."""
    return (
        float(sampler.repeat_penalty), int(sampler.repeat_last_n),
        float(sampler.frequency_penalty), float(sampler.presence_penalty),
        bool(sampler.penalize_nl), _bias(sampler, n_vocab), int(nl_token),
    )


def apply_grammar_mask(logits: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Logits (..., V) with every token whose bit is 0 in `bits` (..., nb)
    uint8, little-endian packed (np.packbits(valid, bitorder="little"),
    nb >= ceil(V / 8)), set to -inf: the bits unpacked on the device (the
    JAX engine's jnp.repeat / shift unpack, engine.py:761-766), then one
    masked_fill. -inf survives the bias and the penalties that follow."""
    V = logits.shape[-1]
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    valid = ((bits[..., None] >> shifts) & 1).flatten(-2)[..., :V]
    return logits.masked_fill(valid == 0, float("-inf"))


def mask_bytes(n_vocab: int) -> int:
    """Bytes of a packed grammar mask over n_vocab tokens."""
    return (n_vocab + 7) // 8


class SamplerKey(NamedTuple):
    """What a captured decode step's shapes and branches depend on, and
    nothing else (sampler_key). `masked`: a grammar's mask applies (the
    masked chunks of engine.decode_chunk_masked); an unmasked key's step is
    the step without it."""

    greedy: bool
    n_cand: int  # candidates the draw chooses among (0 when greedy)
    top_p_cuts: bool
    penalized: bool  # a repeat, frequency or presence penalty applies
    penalize_nl: bool
    ring: int  # the penalty ring's length
    n_bias: int
    nl_token: int
    masked: bool = False


def sampler_key(sampler, n_vocab: int, nl_token: int, masked: bool = False) -> SamplerKey:
    """The sampler's shape: samplers that differ only in their values
    (temperature, top-p, the penalty values, the bias values) share a key,
    and the values go to the step as device tensors (SamplerValues)."""
    rp, rln, fp, pp, penalize_nl, bias, nl = penalty_spec(sampler, n_vocab, nl_token)
    greedy = sampler.temp <= 0.0
    return SamplerKey(greedy, 0 if greedy else n_candidates(int(sampler.top_k), n_vocab),
                      not greedy and sampler.top_p < 1.0,
                      rln > 0 and (rp != 1.0 or fp != 0.0 or pp != 0.0),
                      penalize_nl, max(rln, 1), len(bias), nl, masked)


class SamplerValues:
    """The values a SamplerKey leaves out, as device tensors: `vals` =
    (temp, top_p, repeat, frequency, presence penalty) in f32, the bias
    as (ids int64, values f32) and, under a masked key, the grammar's
    packed mask `bits` (mask_bytes(n_vocab),) uint8. `set` and `set_mask`
    write them by non-blocking copies from pinned memory, outside any
    capture; the step reads them on the device."""

    def __init__(self, key: SamplerKey, device, n_vocab: int = 0):
        device = torch.device(device)
        self.pin = device.type == "cuda"
        self.vals = torch.zeros(5, dtype=torch.float32, device=device)
        self.bias_ids = torch.zeros(key.n_bias, dtype=torch.long, device=device)
        self.bias_vals = torch.zeros(key.n_bias, dtype=torch.float32, device=device)
        self.bits = (torch.full((mask_bytes(n_vocab),), 255, dtype=torch.uint8, device=device)
                     if key.masked else None)

    def set(self, sampler, n_vocab: int) -> "SamplerValues":
        bias = _bias(sampler, n_vocab)
        if len(bias) != self.bias_ids.numel():
            raise ValueError(f"{len(bias)} bias entries for a key of {self.bias_ids.numel()}")
        host = (torch.tensor([sampler.temp, sampler.top_p, sampler.repeat_penalty,
                              sampler.frequency_penalty, sampler.presence_penalty],
                             dtype=torch.float32),
                torch.tensor([t for t, _ in bias], dtype=torch.long),
                torch.tensor([b for _, b in bias], dtype=torch.float32))
        for dst, src in zip((self.vals, self.bias_ids, self.bias_vals), host):
            dst.copy_(src.pin_memory() if self.pin else src, non_blocking=True)
        return self

    def set_mask(self, bits) -> "SamplerValues":
        """Write a grammar state's packed mask (numpy uint8, the key's
        mask_bytes long)."""
        _copy_bits(self.bits, bits, self.pin)
        return self


def _copy_bits(dst: torch.Tensor, bits, pin: bool) -> None:
    src = torch.from_numpy(np.ascontiguousarray(bits, dtype=np.uint8))
    if src.shape != dst.shape:
        raise ValueError(f"grammar mask of {tuple(src.shape)} bytes for a buffer of"
                         f" {tuple(dst.shape)}")
    dst.copy_(src.pin_memory() if pin else src, non_blocking=True)


def apply_penalties(logits: torch.Tensor, ring: torch.Tensor, key: SamplerKey,
                    sv: SamplerValues) -> torch.Tensor:
    """Logit bias + repetition/frequency/presence penalties against a ring
    buffer of recent token ids (ids >= n_vocab are empty slots); sv holds
    the values of the sampler whose key is `key`. Under a masked key the
    grammar's mask (sv.bits) comes first of all.

    Mirrors the host cascade head (falcon_main.cpp:899-946): bias first,
    then penalties over the last-n window, then the optional newline
    restore. The key decides whether any penalty applies (the JAX module's
    `rp == 1 and fp == pp == 0` early return, and `rln <= 0`); inside, a
    neutral value (rp 1, fp or pp 0) is an exact no-op: x * 1, x / 1 and
    x - 0 * c are x in f32."""
    V, nl_token = logits.shape[-1], key.nl_token
    if key.masked:
        logits = apply_grammar_mask(logits, sv.bits)
    if key.n_bias:
        logits = logits.index_add(0, sv.bias_ids, sv.bias_vals)
    if not key.penalized:
        return logits
    rp, fp, pp = sv.vals[2], sv.vals[3], sv.vals[4]
    nl_logit = logits[nl_token] if V > nl_token else None
    # occurrence counts of the window tokens; empty slots land in bin V
    counts = torch.zeros(V + 1, dtype=torch.float32, device=logits.device)
    counts = counts.index_add(0, ring.clamp(max=V).long(),
                              torch.ones(ring.shape, dtype=torch.float32, device=logits.device))[:V]
    hit = counts > 0
    logits = torch.where(hit, torch.where(logits <= 0, logits * rp, logits / rp), logits)
    logits = logits - counts * fp - hit.to(torch.float32) * pp
    if not key.penalize_nl and nl_logit is not None:
        logits = logits.clone()
        logits[nl_token] = nl_logit
    return logits


def n_candidates(top_k: int, n_vocab: int) -> int:
    """Tokens the draw chooses among: top_k, capped at 1024 when off or too
    large (device_samplable keeps such settings off this path at temp > 0)."""
    return top_k if 0 < top_k < n_vocab else min(n_vocab, 1024)


def cascade_slice(logits: torch.Tensor, key: SamplerKey, sv: SamplerValues):
    """The single stream's distribution at temp > 0: the rows' cascade at
    B = 1 (cascade_mask_probs) over the top-k slice of (n_vocab,) logits
    (the key's candidate count): top-p on the unscaled distribution where
    the key says it cuts, the token whose mass crosses top_p dropped, then
    the temperature, with the temperature and top-p read from sv on the
    device. Returns (probs (1, k), mask (1, k), ids (k,) of the slice,
    descending)."""
    vals, idx = torch.topk(logits, key.n_cand)  # descending
    k = torch.full((1,), key.n_cand, dtype=torch.long, device=logits.device)
    probs, mask = cascade_mask_probs(vals[None], sv.vals[0:1],
                                     sv.vals[1:2] if key.top_p_cuts else None, k)
    return probs, mask, idx


def sample_logits(logits: torch.Tensor, key: SamplerKey, sv: SamplerValues,
                  u: torch.Tensor | None) -> torch.Tensor:
    """One token id (0-d int64 tensor) from (n_vocab,) f32 logits: greedy
    when the key says so, else one inverse-CDF draw (_draw) on the uniform u
    over cascade_slice's distribution. That is the host cascade's order
    (ops/sampling.py sample) and the rows' draw, so one uniform gives one id
    on the single stream, the rows and the host. u: this draw's uniform in
    [0, 1), 0-d or (1,) (unused, and may be None, when greedy).

    The JAX single stream (ggllm_tpu/ops/sampling_device.py sample_logits:
    333) is not copied: it divides by the temperature before top-p and keeps
    the crossing token (Gumbel-max over the candidates), so it draws from
    another distribution than the JAX host cascade and rows it sits beside."""
    if key.greedy:
        return torch.argmax(logits)
    probs, mask, idx = cascade_slice(logits, key, sv)
    pick = _draw(probs, mask, u.reshape(1))
    return idx.gather(0, pick).reshape(())  # a tensor index would read it on the host


# ---------------------------------------------------------------------------
# Rows: per-row sampling for B streams decoding together (the batched decode
# loop of ggllm_tpu/ops/sampling_device.py:78-313). Every per-row knob is a
# (B,) device tensor (RowValues), so one captured B-row decode step serves
# every mix of samplers; only RowKey (the candidate cap, the ring length, the
# bias width, whether a mirostat row is present) shapes the step. Unlike the
# JAX rows, which have no newline restore (its batched server refuses
# penalize_nl=false), a row with penalize_nl False keeps the logit of the
# family's newline id (tokenizer.nl_id) unpenalized, as the host cascade
# (ops/sampling.py sample) does.


def apply_penalties_rows(logits: torch.Tensor, rings: torch.Tensor, rp: torch.Tensor,
                         fp: torch.Tensor, pp: torch.Tensor,
                         penalize_nl: torch.Tensor | None = None,
                         nl_token: int = -1) -> torch.Tensor:
    """Per-row repetition / frequency / presence penalties
    (ggllm_tpu/ops/sampling_device.py apply_penalties_rows:78): logits (B, V),
    rings (B, L) recent ids (>= V: an empty slot), rp / fp / pp (B,). A row at
    rp 1, fp = pp = 0 passes through exactly (x * 1, x / 1 and x - 0 are x in
    f32). Rows whose penalize_nl (B,) bool is False get the logit of
    `nl_token` back as it came in."""
    B, V = logits.shape
    counts = torch.zeros(B, V + 1, dtype=torch.float32, device=logits.device)
    counts = counts.scatter_add(1, rings.clamp(max=V).long(),
                                torch.ones(rings.shape, dtype=torch.float32,
                                           device=logits.device))[:, :V]
    hit = counts > 0
    rp_ = rp[:, None]
    out = torch.where(hit, torch.where(logits <= 0, logits * rp_, logits / rp_), logits)
    out = out - counts * fp[:, None] - hit.to(torch.float32) * pp[:, None]
    if penalize_nl is not None and 0 <= nl_token < V:
        out[:, nl_token] = torch.where(penalize_nl, out[:, nl_token], logits[:, nl_token])
    return out


def apply_bias_rows(logits: torch.Tensor, bias_ids: torch.Tensor,
                    bias_vals: torch.Tensor) -> torch.Tensor:
    """Per-row sparse logit bias (apply_bias_rows:98): bias_ids (B, NB) ids
    (>= V: an empty slot, dropped), bias_vals (B, NB); before the penalties,
    as the host cascade applies it."""
    B, V = logits.shape
    padded = torch.cat([logits, logits.new_zeros(B, 1)], dim=1)
    return padded.scatter_add(1, bias_ids.clamp(max=V).long(), bias_vals)[:, :V]


def _masked_softmax(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Row softmax over the kept entries; dropped entries 0 (:108)."""
    neg = torch.where(mask, vals, float("-inf"))
    m = neg.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(neg - m), 0.0)
    return e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-38)


def _first(b: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 where none)."""
    return torch.argmax(b.to(torch.uint8), dim=-1)


def _draw(probs: torch.Tensor, mask: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draw over the kept entries (:116), ops/sampling.py
    sample_token's semantics: the first kept index whose cumulative mass
    exceeds u times the total, else the last kept one."""
    k = probs.shape[1]
    cum = torch.cumsum(probs, dim=-1)
    sel = (cum > u[:, None] * cum[:, -1:]) & mask
    last_kept = (k - 1) - _first(mask.flip(-1))
    return torch.where(sel.any(dim=-1), _first(sel), last_kept)


def cascade_mask_probs(vals: torch.Tensor, temp: torch.Tensor, top_p: torch.Tensor | None,
                       top_k_rows: torch.Tensor, tfs_z: torch.Tensor | None = None,
                       typical_p: torch.Tensor | None = None):
    """The truncations and the temperature of cascade_rows without the draw
    (cascade_mask_probs:129): (probs, mask) over the descending top-k slice
    `vals` (B, k), in the host order top-k -> tail-free -> typical -> top-p
    (on the unscaled distribution; None: no row cuts) -> temperature."""
    B, k = vals.shape
    rank = torch.arange(k, device=vals.device)[None, :]
    mask = rank < torch.clamp(top_k_rows, min=1)[:, None]
    if tfs_z is not None and k > 2:
        # tail-free: the normalized second derivative of the sorted
        # probabilities, cut at the first index (>= 1) whose cumulative sum
        # exceeds z; only where all three source entries are kept (so never
        # on a slice of fewer than three candidates)
        probs = _masked_softmax(vals, mask)
        first = probs[:, :-1] - probs[:, 1:]
        second = torch.abs(first[:, :-1] - first[:, 1:])
        second = torch.where(mask[:, 2:], second, 0.0)
        ssum = second.sum(dim=-1, keepdim=True)
        second = torch.where(ssum != 0, second / torch.clamp(ssum, min=1e-38), second)
        cum = torch.cumsum(second, dim=-1)
        over = (cum > tfs_z[:, None]) & (rank[:, :k - 2] >= 1)
        n_kept = mask.sum(dim=-1)
        lastx = torch.clamp(torch.where(over.any(dim=-1), _first(over), n_kept), min=1)
        apply = (tfs_z < 1.0) & (n_kept > 2)
        mask = mask & torch.where(apply[:, None], rank < lastx[:, None], True)
    if typical_p is not None:
        # typical: candidates by |-log p - H| ascending, kept until the
        # cumulative probability exceeds p (a keep set that need not be a prefix)
        probs = _masked_softmax(vals, mask)
        logp = torch.log(torch.clamp(probs, min=1e-38))
        entropy = -torch.where(mask, probs * logp, 0.0).sum(dim=-1, keepdim=True)
        shifted = torch.where(mask, torch.abs(-logp - entropy), float("inf"))
        order = torch.argsort(shifted, dim=-1, stable=True)
        cum = torch.cumsum(probs.gather(1, order), dim=-1)
        over = cum > typical_p[:, None]
        lastx = torch.where(over.any(dim=-1), _first(over) + 1, k)
        keep = torch.zeros_like(mask).scatter(1, order, rank < lastx[:, None])
        mask = mask & torch.where((typical_p < 1.0)[:, None], keep, True)
    if top_p is not None:
        probs = _masked_softmax(vals, mask)
        cum = torch.cumsum(probs, dim=-1)
        is_first = torch.cumsum(mask.to(torch.int32), dim=-1) == 1
        mask = mask & torch.where((top_p < 1.0)[:, None], is_first | (cum <= top_p[:, None]),
                                  True)
    scaled = vals / torch.clamp(temp, min=1e-6)[:, None]
    return _masked_softmax(scaled, mask), mask


def cascade_rows(vals: torch.Tensor, u: torch.Tensor, temp: torch.Tensor, top_p: torch.Tensor,
                 top_k_rows: torch.Tensor, tfs_z: torch.Tensor | None = None,
                 typical_p: torch.Tensor | None = None) -> torch.Tensor:
    """Per-row cascade over a descending top-k slice (cascade_rows:199):
    vals (B, k), u (B,) uniforms, the knobs (B,). Returns (B,) ranks into the
    slice; a row at temp <= 0 takes rank 0 (greedy)."""
    probs, mask = cascade_mask_probs(vals, temp, top_p, top_k_rows, tfs_z, typical_p)
    return torch.where(temp <= 0.0, 0, _draw(probs, mask, u))


def mirostat_rows(vals: torch.Tensor, u: torch.Tensor, temp: torch.Tensor, mode: torch.Tensor,
                  tau: torch.Tensor, eta: torch.Tensor, mu: torch.Tensor, lse: torch.Tensor,
                  n_vocab: int):
    """Per-row mirostat v1 / v2 (mirostat_rows:217) over a descending slice
    of the temperature-scaled logits, vals (B, k); lse (B,) the logsumexp of
    the whole scaled row, so that the slice's probabilities are the host's
    full-vocabulary ones. Exact while the host's keep set lies within the
    slice. Returns (ranks, new mu); rows off mirostat or at temp <= 0 keep
    their mu."""
    B, k = vals.shape
    dev = vals.device
    rank = torch.arange(k, device=dev)[None, :]
    probs = torch.exp(vals - lse[:, None])
    # v1: a Zipf exponent fitted over the first 100 probability ratios
    n = min(100 - 1, k - 1)
    i = torch.arange(n, dtype=torch.float32, device=dev)
    t_i = torch.log((i + 2.0) / (i + 1.0))
    b_i = torch.log(torch.clamp(probs[:, :n], min=1e-38)
                    / torch.clamp(probs[:, 1:n + 1], min=1e-38))
    s_hat = (t_i * b_i).sum(dim=-1) / (t_i * t_i).sum()
    eps_hat = s_hat - 1.0
    # a Python-number base: no host tensor to copy (a captured step can't)
    k_dyn = ((eps_hat * torch.exp2(mu)) / (1.0 - torch.pow(float(n_vocab), -eps_hat))
             ) ** (1.0 / s_hat)
    k1 = torch.clamp(k_dyn.to(torch.int32), 1, k)

    def drawn(mask):
        p = torch.where(mask, probs, 0.0)
        p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-38)
        c = _draw(p, mask, u)
        return c, -torch.log2(torch.clamp(p.gather(1, c[:, None])[:, 0], min=1e-38))

    c1, s1 = drawn(rank < k1[:, None])
    # v2: cut at the first candidate whose surprise exceeds mu
    over = -torch.log2(torch.clamp(probs, min=1e-38)) > mu[:, None]
    lastx = torch.where(over.any(dim=-1), torch.clamp(_first(over), min=1), k)
    c2, s2 = drawn(rank < lastx[:, None])
    is1 = mode == 1
    new_mu = mu - eta * (torch.where(is1, s1, s2) - tau)
    active = (mode > 0) & (temp > 0.0)
    return torch.where(temp <= 0.0, 0, torch.where(is1, c1, c2)), torch.where(active, new_mu, mu)


def sample_rows_u(logits: torch.Tensor, u: torch.Tensor, temp: torch.Tensor,
                  top_p: torch.Tensor, top_k: int, top_k_rows: torch.Tensor | None = None,
                  tfs_z: torch.Tensor | None = None, typical_p: torch.Tensor | None = None,
                  miro_mode: torch.Tensor | None = None, miro_tau: torch.Tensor | None = None,
                  miro_eta: torch.Tensor | None = None, miro_mu: torch.Tensor | None = None,
                  miro_k: int = 512, n_vocab: int | None = None):
    """Per-row sampling from explicit uniforms u (B,) (sample_rows_u:275):
    the cascade over each row's top `top_k` (the static cap; top_k_rows
    (B,) tightens it), or with miro_mode given, mirostat for rows whose mode
    is 1 or 2, over the top miro_k of the scaled logits. Returns ((B,) ids,
    new mu); mu passes through without miro_mode."""
    B, V = logits.shape
    k = min(max(top_k, 1), V)
    vals, idx = torch.topk(logits, k)  # descending
    tkr = top_k_rows if top_k_rows is not None else torch.full(
        (B,), k, dtype=torch.int64, device=logits.device)
    choice = cascade_rows(vals, u, temp, top_p, tkr, tfs_z, typical_p)
    toks = idx.gather(1, choice[:, None])[:, 0]
    if miro_mode is None:
        return toks, miro_mu
    scaled = logits / torch.clamp(temp, min=1e-6)[:, None]
    mvals, midx = torch.topk(scaled, min(miro_k, V))
    mchoice, new_mu = mirostat_rows(mvals, u, temp, miro_mode, miro_tau, miro_eta, miro_mu,
                                    torch.logsumexp(scaled, dim=-1), n_vocab or V)
    return torch.where(miro_mode > 0, midx.gather(1, mchoice[:, None])[:, 0], toks), new_mu


class RowKey(NamedTuple):
    """What a captured B-row decode step's shapes depend on (the batched
    counterpart of SamplerKey): the candidate cap, the penalty ring's
    length, the bias width, whether a mirostat row is present, and whether
    the rows take grammar masks."""

    top_k: int
    ring: int
    n_bias: int
    miro: bool
    masked: bool = False


ROW_FIELDS = (  # (name, dtype, the value of an idle row)
    ("temp", torch.float32, 0.0), ("top_p", torch.float32, 1.0), ("top_k", torch.int64, 0),
    ("repeat_penalty", torch.float32, 1.0), ("frequency_penalty", torch.float32, 0.0),
    ("presence_penalty", torch.float32, 0.0), ("tfs_z", torch.float32, 1.0),
    ("typical_p", torch.float32, 1.0), ("penalize_nl", torch.bool, True),
    ("mirostat", torch.int64, 0), ("mirostat_tau", torch.float32, 5.0),
    ("mirostat_eta", torch.float32, 0.1))


class RowValues:
    """The per-row sampler values of a B-row decode step as device tensors:
    one (B,) tensor a ROW_FIELDS entry (`v[name]`), the bias as (B, n_bias)
    ids (>= n_vocab: empty) and values, mirostat's mu, which the step
    updates, and under a masked key the rows' packed grammar masks `bits`
    (B, mask_bytes(n_vocab)) uint8. `set` writes them by non-blocking copies
    from pinned memory, outside any capture."""

    def __init__(self, key: RowKey, B: int, device, n_vocab: int = 0):
        device = torch.device(device)
        self.pin = device.type == "cuda"
        self.v = {name: torch.full((B,), idle, dtype=dt, device=device)
                  for name, dt, idle in ROW_FIELDS}
        self.bias_ids = torch.zeros(B, key.n_bias, dtype=torch.long, device=device)
        self.bias_vals = torch.zeros(B, key.n_bias, dtype=torch.float32, device=device)
        self.mu = torch.full((B,), 10.0, dtype=torch.float32, device=device)
        self.bits = (torch.full((B, mask_bytes(n_vocab)), 255, dtype=torch.uint8, device=device)
                     if key.masked else None)

    def set(self, host: dict, bias_ids, bias_vals, mu, bits=None) -> "RowValues":
        """host: name -> (B,) numpy values (missing names: the idle value);
        bits: the rows' packed masks (B, nb) uint8 under a masked key."""
        B = self.mu.shape[0]
        pairs = [(self.v[name], torch.from_numpy(np.ascontiguousarray(
            host.get(name, np.full(B, idle)), dtype=np.dtype(str(dt).removeprefix("torch.")))))
            for name, dt, idle in ROW_FIELDS]
        pairs += [(self.bias_ids, torch.as_tensor(np.asarray(bias_ids, np.int64))),
                  (self.bias_vals, torch.as_tensor(np.asarray(bias_vals, np.float32))),
                  (self.mu, torch.as_tensor(np.asarray(mu, np.float32)))]
        for dst, src in pairs:
            dst.copy_(src.reshape(dst.shape).pin_memory() if self.pin else src.reshape(dst.shape),
                      non_blocking=True)
        if (bits is None) != (self.bits is None):
            raise ValueError("grammar masks go with a masked RowKey, and only with one")
        if bits is not None:
            _copy_bits(self.bits, bits, self.pin)
        return self


def sample_rows_step(logits: torch.Tensor, rings: torch.Tensor, key: RowKey, rv: RowValues,
                     u: torch.Tensor, nl_token: int) -> torch.Tensor:
    """One B-row decode step's sampling (the body of the JAX engine's
    _decode_rows_fn:1106-1146): under a masked key the rows' grammar masks
    first, then bias, penalties with the per-row newline restore, then
    sample_rows_u on uniforms u (B,); mirostat rows update rv.mu in place.
    Returns the (B,) ids. Reads and writes only device tensors."""
    v = rv.v
    if key.masked:
        logits = apply_grammar_mask(logits, rv.bits)
    lg = apply_bias_rows(logits, rv.bias_ids, rv.bias_vals) if key.n_bias else logits
    lg = apply_penalties_rows(lg, rings, v["repeat_penalty"], v["frequency_penalty"],
                              v["presence_penalty"], v["penalize_nl"], nl_token)
    miro = key.miro
    nxt, mu = sample_rows_u(lg, u, v["temp"], v["top_p"], key.top_k, v["top_k"], v["tfs_z"],
                            v["typical_p"], v["mirostat"] if miro else None,
                            v["mirostat_tau"], v["mirostat_eta"], rv.mu, n_vocab=logits.shape[1])
    if miro:
        rv.mu.copy_(mu)
    return nxt
