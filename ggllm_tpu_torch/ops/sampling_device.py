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

The categorical draw takes its uniforms as an input: the engine draws a
whole chunk's ((n_steps, n_candidates), one launch from the engine's
torch.Generator) into a static buffer before each replay of the
captured chunk, the `sample_rows_u` idea of ggllm_tpu/ops/sampling_device.py
:275. The graph holds no generator state, and the graph and the eager step
body draw the same numbers for one seed, so they give the same ids."""

from __future__ import annotations

from typing import NamedTuple

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


class SamplerKey(NamedTuple):
    """What a captured decode step's shapes and branches depend on, and
    nothing else (sampler_key)."""

    greedy: bool
    n_cand: int  # candidates the draw chooses among (0 when greedy)
    top_p_cuts: bool
    penalized: bool  # a repeat, frequency or presence penalty applies
    penalize_nl: bool
    ring: int  # the penalty ring's length
    n_bias: int
    nl_token: int


def sampler_key(sampler, n_vocab: int, nl_token: int) -> SamplerKey:
    """The sampler's shape: samplers that differ only in their values
    (temperature, top-p, the penalty values, the bias values) share a key,
    and the values go to the step as device tensors (SamplerValues)."""
    rp, rln, fp, pp, penalize_nl, bias, nl = penalty_spec(sampler, n_vocab, nl_token)
    greedy = sampler.temp <= 0.0
    return SamplerKey(greedy, 0 if greedy else n_candidates(int(sampler.top_k), n_vocab),
                      not greedy and sampler.top_p < 1.0,
                      rln > 0 and (rp != 1.0 or fp != 0.0 or pp != 0.0),
                      penalize_nl, max(rln, 1), len(bias), nl)


class SamplerValues:
    """The values a SamplerKey leaves out, as device tensors: `vals` =
    (temp, top_p, repeat, frequency, presence penalty) in f32 and the bias
    as (ids int64, values f32). `set` writes a sampler's values by
    non-blocking copies from pinned memory, outside any capture; the step
    reads them on the device."""

    def __init__(self, key: SamplerKey, device):
        device = torch.device(device)
        self.pin = device.type == "cuda"
        self.vals = torch.zeros(5, dtype=torch.float32, device=device)
        self.bias_ids = torch.zeros(key.n_bias, dtype=torch.long, device=device)
        self.bias_vals = torch.zeros(key.n_bias, dtype=torch.float32, device=device)

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


def apply_penalties(logits: torch.Tensor, ring: torch.Tensor, key: SamplerKey,
                    sv: SamplerValues) -> torch.Tensor:
    """Logit bias + repetition/frequency/presence penalties against a ring
    buffer of recent token ids (ids >= n_vocab are empty slots); sv holds
    the values of the sampler whose key is `key`.

    Mirrors the host cascade head (falcon_main.cpp:899-946): bias first,
    then penalties over the last-n window, then the optional newline
    restore. The key decides whether any penalty applies (the JAX module's
    `rp == 1 and fp == pp == 0` early return, and `rln <= 0`); inside, a
    neutral value (rp 1, fp or pp 0) is an exact no-op: x * 1, x / 1 and
    x - 0 * c are x in f32."""
    V, nl_token = logits.shape[-1], key.nl_token
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


def sample_logits(logits: torch.Tensor, key: SamplerKey, sv: SamplerValues,
                  u: torch.Tensor | None) -> torch.Tensor:
    """One token id (0-d int64 tensor) from (n_vocab,) f32 logits: greedy
    when the key says so, else top-k (the key's candidate count) ->
    temperature -> top-p (where the key says it cuts) -> categorical, with
    the temperature and top-p read from sv on the device. u: this draw's
    (n_candidates,) uniforms in [0, 1) (unused, and may be None, when
    greedy)."""
    if key.greedy:
        return torch.argmax(logits)
    vals, idx = torch.topk(logits, key.n_cand)  # descending
    vals = vals / sv.vals[0]
    if key.top_p_cuts:
        cum = torch.cumsum(torch.softmax(vals, dim=-1), dim=-1)
        # keep tokens while the cumulative mass BEFORE them is < top_p
        # (the reference keeps at least one, llama_sample_top_p libfalcon.cpp:3122)
        keep = torch.cat([torch.ones(1, dtype=torch.bool, device=vals.device),
                          cum[:-1] < sv.vals[1]])
        vals = torch.where(keep, vals, float("-inf"))
    # categorical draw as Gumbel-max (as jax.random.categorical does);
    # torch.multinomial would synchronize with the host every token
    pick = torch.argmax(vals - torch.log(-torch.log(u)))
    return idx.gather(0, pick.reshape(1)).reshape(())  # a tensor index would read it on the host
