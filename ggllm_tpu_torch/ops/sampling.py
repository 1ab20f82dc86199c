"""Sampling suite: softmax/top-k/top-p/tail-free/typical/temperature,
repetition + frequency/presence penalties, mirostat v1/v2, greedy.

The port's own copy of ggllm_tpu/ops/sampling.py (numpy only): host-side
re-implementation of the reference samplers (libfalcon.cpp:3038-3462)
operating on a Candidates pool, plus the falcon_main sampling cascade
(falcon_main.cpp:899-986). Logits arrive as one (n_vocab,) float32 vector per
step. The engine routes here whatever the device cascade
(ops/sampling_device.py) does not cover (device_samplable), and always draws
the first token after prefill here. Unlike the JAX module, `sample` and
`cascade_probs` take the newline id of the model's vocabulary (`nl_token`,
tokenizer.nl_id: 193 for Falcon's BPE vocab, 13 for LLaMA's), not Falcon's
193 for both.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Candidates:
    """Mutable candidate pool (falcon_token_data_array analogue)."""

    ids: np.ndarray  # int32
    logits: np.ndarray  # float32
    probs: np.ndarray | None = None
    sorted: bool = False

    @classmethod
    def from_logits(cls, logits: np.ndarray) -> "Candidates":
        logits = np.asarray(logits, dtype=np.float32).reshape(-1)
        return cls(ids=np.arange(logits.size, dtype=np.int32), logits=logits.copy())

    @property
    def size(self) -> int:
        return self.ids.size

    def _sort(self):
        if not self.sorted:
            order = np.argsort(-self.logits, kind="stable")
            self.ids = self.ids[order]
            self.logits = self.logits[order]
            self.sorted = True

    def truncate(self, k: int):
        self.ids = self.ids[:k]
        self.logits = self.logits[:k]
        if self.probs is not None:
            self.probs = self.probs[:k]


def softmax(c: Candidates):
    c._sort()
    # exp in float64 rounded to f32 ≈ correctly-rounded expf (np.exp on f32
    # is 1-2 ulp off, which flips cutoff comparisons at exact boundaries)
    p = np.exp((c.logits - c.logits[0]).astype(np.float64)).astype(np.float32)
    # sequential f32 accumulation matches the reference's running cum_sum
    # (pairwise np.sum flips comparisons at exact cutoff boundaries)
    c.probs = p / np.cumsum(p, dtype=np.float32)[-1]


def top_k(c: Candidates, k: int, min_keep: int = 1):
    k = max(k, min_keep)
    k = min(k, c.size)
    c._sort()
    c.truncate(k)


def top_p(c: Candidates, p: float, min_keep: int = 1):
    if p >= 1.0:
        return
    softmax(c)
    cum = np.cumsum(c.probs)
    # keep tokens until cumulative prob exceeds p (inclusive of the crossing one)
    last = c.size
    over = np.nonzero((cum > p) & (np.arange(c.size) >= min_keep))[0]
    if over.size:
        last = int(over[0])
    c.truncate(max(last, 1))


def tail_free(c: Candidates, z: float, min_keep: int = 1):
    if z >= 1.0 or c.size <= 2:
        return
    softmax(c)
    first = c.probs[:-1] - c.probs[1:]
    second = np.abs(first[:-1] - first[1:])
    s = second.sum()
    second = second / s if s != 0 else second
    cum = np.cumsum(second)
    last = c.size
    over = np.nonzero((cum > z) & (np.arange(second.size) >= min_keep))[0]
    if over.size:
        last = int(over[0])
    c.truncate(max(last, 1))


def typical(c: Candidates, p: float, min_keep: int = 1):
    if p >= 1.0:
        return
    softmax(c)
    entropy = float(-(c.probs * np.log(c.probs)).sum())
    shifted = np.abs(-np.log(c.probs) - entropy)
    order = np.argsort(shifted, kind="stable")
    cum = np.cumsum(c.probs[order])
    last = order.size
    over = np.nonzero((cum > p) & (np.arange(order.size) >= min_keep - 1))[0]
    if over.size:
        last = int(over[0]) + 1
    keep = order[:last]
    c.ids = c.ids[keep]
    c.logits = c.logits[keep]
    c.probs = c.probs[keep]
    c.sorted = False


def temperature(c: Candidates, temp: float):
    c.logits = c.logits / np.float32(temp)


def repetition_penalty(c: Candidates, last_tokens: np.ndarray, penalty: float):
    if last_tokens.size == 0 or penalty == 1.0:
        return
    hit = np.isin(c.ids, last_tokens)
    neg = c.logits <= 0
    c.logits = np.where(
        hit, np.where(neg, c.logits * penalty, c.logits / penalty), c.logits
    ).astype(np.float32)
    c.sorted = False


def frequency_presence_penalties(
    c: Candidates, last_tokens: np.ndarray, alpha_frequency: float, alpha_presence: float
):
    if last_tokens.size == 0 or (alpha_frequency == 0.0 and alpha_presence == 0.0):
        return
    uniq, counts = np.unique(last_tokens, return_counts=True)
    idx = np.searchsorted(uniq, c.ids)
    idx = np.clip(idx, 0, uniq.size - 1)
    match = uniq[idx] == c.ids
    cnt = np.where(match, counts[idx], 0)
    c.logits = (c.logits - cnt * alpha_frequency - (cnt > 0) * alpha_presence).astype(np.float32)
    c.sorted = False


def greedy(c: Candidates) -> int:
    return int(c.ids[int(np.argmax(c.logits))])


def sample_token(c: Candidates, rng: np.random.Generator) -> int:
    softmax(c)
    # std::discrete_distribution draw == inverse-CDF over normalized weights
    r = rng.random()
    cum = np.cumsum(c.probs)
    idx = int(np.searchsorted(cum, r * cum[-1], side="right"))
    idx = min(idx, c.size - 1)
    return int(c.ids[idx])


def mirostat_v1(
    c: Candidates, rng: np.random.Generator, tau: float, eta: float, m: int, mu: float, n_vocab: int
) -> tuple[int, float]:
    softmax(c)
    n = min(m - 1, c.size - 1)
    i = np.arange(n, dtype=np.float32)
    t_i = np.log((i + 2) / (i + 1))
    b_i = np.log(c.probs[:n] / c.probs[1 : n + 1])
    s_hat = float((t_i * b_i).sum() / (t_i * t_i).sum())
    epsilon_hat = s_hat - 1.0
    k = ((epsilon_hat * (2.0**mu)) / (1 - float(n_vocab) ** (-epsilon_hat))) ** (1 / s_hat)
    top_k(c, int(k), 1)
    x = sample_token(c, rng)
    x_idx = int(np.nonzero(c.ids == x)[0][0])
    observed_surprise = -np.log2(c.probs[x_idx])
    mu = mu - eta * (observed_surprise - tau)
    return x, float(mu)


def mirostat_v2(
    c: Candidates, rng: np.random.Generator, tau: float, eta: float, mu: float
) -> tuple[int, float]:
    softmax(c)
    surprise = -np.log2(c.probs)
    over = np.nonzero(surprise > mu)[0]
    if over.size:
        c.truncate(max(int(over[0]), 1))
    softmax(c)
    x = sample_token(c, rng)
    x_idx = int(np.nonzero(c.ids == x)[0][0])
    observed_surprise = -np.log2(c.probs[x_idx])
    mu = mu - eta * (observed_surprise - tau)
    return x, float(mu)


# --------------------------------------------------------------------------
# The falcon_main cascade
# --------------------------------------------------------------------------


@dataclass
class SamplerParams:
    """Sampling knobs (gpt_params subset, falcon_common.h:47-66 defaults)."""

    top_k: int = 40
    top_p: float = 0.95
    tfs_z: float = 1.0
    typical_p: float = 1.0
    temp: float = 0.8
    repeat_penalty: float = 1.1
    repeat_last_n: int = 64
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    mirostat: int = 0
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    penalize_nl: bool = True
    logit_bias: dict = field(default_factory=dict)
    seed: int = -1


@dataclass
class SamplerState:
    rng: np.random.Generator
    mu: float

    @classmethod
    def init(cls, params: SamplerParams) -> "SamplerState":
        seed = params.seed if params.seed >= 0 else np.random.SeedSequence().entropy % (2**32)
        return cls(rng=np.random.default_rng(int(seed)), mu=2.0 * params.mirostat_tau)


def sample(
    logits: np.ndarray,
    last_tokens: list[int],
    params: SamplerParams,
    state: SamplerState,
    n_ctx: int = 2048,
    *,
    nl_token: int,
) -> int:
    """One step of the falcon_main sampling cascade (falcon_main.cpp:899-986);
    nl_token: the vocabulary's newline id (tokenizer.nl_id)."""
    logits = np.asarray(logits, dtype=np.float32).reshape(-1).copy()
    for tid, bias in params.logit_bias.items():
        logits[tid] += bias

    c = Candidates.from_logits(logits)
    nl_logit = logits[nl_token] if logits.size > nl_token else 0.0

    last_n = np.asarray(
        last_tokens[-min(len(last_tokens), params.repeat_last_n, n_ctx):], dtype=np.int32
    )
    repetition_penalty(c, last_n, params.repeat_penalty)
    frequency_presence_penalties(c, last_n, params.frequency_penalty, params.presence_penalty)
    if not params.penalize_nl and logits.size > nl_token:
        # the reference restores into the raw logits array, which has no
        # effect on the candidate pool (upstream bug); we restore properly
        c.logits[c.ids == nl_token] = nl_logit

    if params.temp <= 0:
        return greedy(c)
    if params.mirostat == 1:
        temperature(c, params.temp)
        tok, state.mu = mirostat_v1(
            c, state.rng, params.mirostat_tau, params.mirostat_eta, 100, state.mu, logits.size
        )
        return tok
    if params.mirostat == 2:
        temperature(c, params.temp)
        tok, state.mu = mirostat_v2(
            c, state.rng, params.mirostat_tau, params.mirostat_eta, state.mu
        )
        return tok
    top_k(c, params.top_k, 1)
    tail_free(c, params.tfs_z, 1)
    typical(c, params.typical_p, 1)
    top_p(c, params.top_p, 1)
    temperature(c, params.temp)
    return sample_token(c, state.rng)


def cascade_probs(
    logits: np.ndarray,
    last_tokens: list[int],
    params: SamplerParams,
    n_ctx: int = 2048,
    *,
    nl_token: int,
) -> np.ndarray:
    """Full-vocab probability vector AFTER the sampling cascade (bias,
    penalties, top-k/tfs/typical/top-p, temperature) but BEFORE the draw —
    i.e. the modified distribution `sample()` draws from. Filtered tokens get
    probability 0; greedy (temp<=0) returns a one-hot argmax.

    This is the distribution speculative decoding needs for both the draft
    proposal q and the target p (the JAX package's engine/speculative.py,
    not ported yet). Mirostat is
    excluded: its truncation depends on the drawn token, so it does not
    define a per-step distribution the accept/resample identity can use.
    """
    if params.mirostat:
        raise ValueError("mirostat does not define a static per-step "
                         "distribution; unsupported in speculative mode")
    logits = np.asarray(logits, dtype=np.float32).reshape(-1).copy()
    for tid, bias in params.logit_bias.items():
        logits[tid] += bias

    c = Candidates.from_logits(logits)
    nl_logit = logits[nl_token] if logits.size > nl_token else 0.0
    last_n = np.asarray(
        last_tokens[-min(len(last_tokens), params.repeat_last_n, n_ctx):],
        dtype=np.int32)
    repetition_penalty(c, last_n, params.repeat_penalty)
    frequency_presence_penalties(c, last_n, params.frequency_penalty,
                                 params.presence_penalty)
    if not params.penalize_nl and logits.size > nl_token:
        c.logits[c.ids == nl_token] = nl_logit

    out = np.zeros(logits.size, dtype=np.float32)
    if params.temp <= 0:
        c._sort()
        out[c.ids[0]] = 1.0
        return out
    top_k(c, params.top_k, 1)
    tail_free(c, params.tfs_z, 1)
    typical(c, params.typical_p, 1)
    top_p(c, params.top_p, 1)
    temperature(c, params.temp)
    softmax(c)
    out[c.ids] = c.probs
    return out
