"""On-device sampling for the decode loop (port of the single-stream part
of ggllm_tpu/ops/sampling_device.py): logit bias and repetition/frequency/
presence penalties against a device ring buffer of recent tokens, then
greedy or top-k -> top-p -> temperature -> categorical, on uniforms
drawn from an explicit torch.Generator. Nothing here synchronizes with the host or
copies from it once `bias_tensors` has been built, so the engine captures
these functions in its decode graph. `device_samplable` says which sampler
settings this covers; the engine routes the rest to the host cascade
(ops/sampling.py).

The categorical draw takes its uniforms as an input: the engine draws a
whole chunk's ((n_steps, n_candidates), one launch from the engine's
torch.Generator) into a static buffer before each replay of the
captured chunk, the `sample_rows_u` idea of ggllm_tpu/ops/sampling_device.py
:275. The graph holds no generator state, and the graph and the eager step
body draw the same numbers for one seed, so they give the same ids."""

from __future__ import annotations

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


def penalty_spec(sampler, n_vocab: int, nl_token: int) -> tuple:
    """Static spec of the penalty/bias stage; nl_token is the vocabulary's
    newline id (tokenizer.nl_id), which penalize_nl=False
    restores."""
    return (
        float(sampler.repeat_penalty), int(sampler.repeat_last_n),
        float(sampler.frequency_penalty), float(sampler.presence_penalty),
        bool(sampler.penalize_nl),
        tuple(sorted((int(t), float(b)) for t, b in sampler.logit_bias.items()
                     if 0 <= int(t) < n_vocab)),
        int(nl_token),
    )


def bias_tensors(spec: tuple, device) -> tuple[torch.Tensor, torch.Tensor] | None:
    """The logit bias of a penalty_spec as (ids int64, values f32) on
    `device`, or None without a bias: built once per spec, before a capture
    (a host-to-device copy cannot be captured)."""
    bias = spec[5]
    if not bias:
        return None
    return (torch.tensor([t for t, _ in bias], dtype=torch.long, device=device),
            torch.tensor([b for _, b in bias], dtype=torch.float32, device=device))


def apply_penalties(logits: torch.Tensor, ring: torch.Tensor, spec: tuple,
                    bias: tuple[torch.Tensor, torch.Tensor] | None) -> torch.Tensor:
    """Logit bias + repetition/frequency/presence penalties against a ring
    buffer of recent token ids (ids >= n_vocab are empty slots). bias: the
    spec's `bias_tensors`.

    Mirrors the host cascade head (falcon_main.cpp:899-946): bias first,
    then penalties over the last-n window, then the optional newline
    restore."""
    rp, rln, fp, pp, penalize_nl, _, nl_token = spec
    if rln <= 0:  # empty penalty window: only bias applies
        rp, fp, pp = 1.0, 0.0, 0.0
    V = logits.shape[-1]
    if bias is not None:
        logits = logits.index_add(0, *bias)
    if rp == 1.0 and fp == 0.0 and pp == 0.0:
        return logits
    nl_logit = logits[nl_token] if V > nl_token else None
    # occurrence counts of the window tokens; empty slots land in bin V
    counts = torch.zeros(V + 1, dtype=torch.float32, device=logits.device)
    counts = counts.index_add(0, ring.clamp(max=V).long(),
                              torch.ones(ring.shape, dtype=torch.float32, device=logits.device))[:V]
    hit = counts > 0
    if rp != 1.0:
        logits = torch.where(hit, torch.where(logits <= 0, logits * rp, logits / rp), logits)
    if fp != 0.0 or pp != 0.0:
        logits = logits - counts * fp - hit.to(torch.float32) * pp
    if not penalize_nl and nl_logit is not None:
        logits = logits.clone()
        logits[nl_token] = nl_logit
    return logits


def n_candidates(top_k: int, n_vocab: int) -> int:
    """Tokens the draw chooses among: top_k, capped at 1024 when off or too
    large (device_samplable keeps such settings off this path at temp > 0)."""
    return top_k if 0 < top_k < n_vocab else min(n_vocab, 1024)


def sample_logits(logits: torch.Tensor, temp: float, top_k: int, top_p: float,
                  u: torch.Tensor | None) -> torch.Tensor:
    """One token id (0-d int64 tensor) from (n_vocab,) f32 logits.
    temp <= 0 -> greedy. Top-k is capped at 1024 when off or too large
    (device_samplable keeps such settings off this path at temp > 0).
    u: this draw's (n_candidates,) uniforms in [0, 1) (unused, and may be
    None, when greedy)."""
    if temp <= 0.0:
        return torch.argmax(logits)
    V = logits.shape[-1]
    vals, idx = torch.topk(logits, n_candidates(top_k, V))  # descending
    vals = vals / float(temp)
    if top_p < 1.0:
        cum = torch.cumsum(torch.softmax(vals, dim=-1), dim=-1)
        # keep tokens while the cumulative mass BEFORE them is < top_p
        # (the reference keeps at least one, llama_sample_top_p libfalcon.cpp:3122)
        keep = torch.cat([torch.ones(1, dtype=torch.bool, device=vals.device), cum[:-1] < top_p])
        vals = torch.where(keep, vals, float("-inf"))
    # categorical draw as Gumbel-max (as jax.random.categorical does);
    # torch.multinomial would synchronize with the host every token
    pick = torch.argmax(vals - torch.log(-torch.log(u)))
    return idx.gather(0, pick.reshape(1)).reshape(())  # a tensor index would read it on the host
