"""The port's device sampling cascade against the JAX package's, on the CPU.

Penalties are deterministic and compared value for value. Draws cannot match
(jax threefry and torch's generator differ), so the sampled distribution is
compared with the one JAX's cascade defines: top-k, then temperature, then
the top-p keep rule of ggllm_tpu/ops/sampling_device.py:344-347.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ggllm_tpu.ops import sampling_device as jsd
from ggllm_tpu.ops.sampling import SamplerParams

from ggllm_tpu_torch.ops import sampling_device as tsd
from ggllm_tpu_torch.ops.sampling import SamplerParams as TSamplerParams

V = 300


@pytest.mark.parametrize("kw", [
    {},
    {"repeat_penalty": 1.3, "frequency_penalty": 0.2, "presence_penalty": 0.5},
    {"repeat_penalty": 1.1, "penalize_nl": False, "logit_bias": {3: 2.5, 250: -1.0}},
    {"repeat_last_n": 0, "logit_bias": {7: 4.0}},
], ids=["default", "freq_presence", "no_nl_bias", "bias_only"])
def test_apply_penalties_matches_jax(kw):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal(V) * 3).astype(np.float32)
    ring = np.concatenate([rng.integers(0, V, 40), [193, 193, 5], np.full(21, V)]).astype(np.int64)
    jspec = jsd.penalty_spec(SamplerParams(**kw), V)
    tspec = tsd.penalty_spec(TSamplerParams(**kw), V, nl_token=193)  # the JAX default's id
    assert tspec == jspec + (193,)
    ref = np.asarray(jsd.apply_penalties(jnp.asarray(logits), jnp.asarray(ring, jnp.int32), jspec))
    got = tsd.apply_penalties(torch.from_numpy(logits), torch.from_numpy(ring), tspec).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def _cascade_probs(logits, temp, top_k, top_p):
    """The distribution jax sample_logits draws from, over the vocab."""
    k = top_k if 0 < top_k < logits.size else min(logits.size, 1024)
    idx = np.argsort(-logits, kind="stable")[:k]
    vals = logits[idx] / temp
    if top_p < 1.0:
        p = np.exp(vals - vals.max())
        cum = np.cumsum(p / p.sum())
        keep = np.concatenate([[True], cum[:-1] < top_p])
        vals = np.where(keep, vals, -np.inf)
    p = np.exp(vals - vals.max())
    out = np.zeros(logits.size)
    out[idx] = p / p.sum()
    return out


@pytest.mark.parametrize("temp,top_k,top_p", [(0.7, 10, 0.8), (1.0, 0, 1.0), (0.5, 40, 0.95)])
def test_sample_logits_distribution(temp, top_k, top_p):
    logits = (np.random.default_rng(1).standard_normal(V) * 2).astype(np.float32)
    expected = _cascade_probs(logits.astype(np.float64), temp, top_k, top_p)
    gen = torch.Generator().manual_seed(3)
    t = torch.from_numpy(logits)
    n = 20000
    draws = np.array([int(tsd.sample_logits(t, gen, temp, top_k, top_p)) for _ in range(n)])
    freq = np.bincount(draws, minlength=V) / n
    assert np.all(freq[expected == 0] == 0)
    np.testing.assert_allclose(freq, expected, atol=0.015)


def test_greedy_is_argmax_like_jax():
    logits = np.random.default_rng(2).standard_normal(V).astype(np.float32)
    ref = int(jsd.sample_logits(jnp.asarray(logits), None, 0.0, 40, 0.95))
    assert int(tsd.sample_logits(torch.from_numpy(logits), None, 0.0, 40, 0.95)) == ref


# ---- the host cascade (ops/sampling.py) against ggllm_tpu/ops/sampling.py

from ggllm_tpu.ops import sampling as jsm  # noqa: E402
from ggllm_tpu.ops.sampling_device import device_samplable as jdevice_samplable  # noqa: E402

from ggllm_tpu_torch.ops import sampling as tsm  # noqa: E402


def _pools(seed, n=V):
    logits = (np.random.default_rng(seed).standard_normal(n) * 2.5).astype(np.float32)
    return jsm.Candidates.from_logits(logits), tsm.Candidates.from_logits(logits)


def _same(jc, tc):
    np.testing.assert_array_equal(tc.ids, jc.ids)
    np.testing.assert_array_equal(tc.logits, jc.logits)
    assert (tc.probs is None) == (jc.probs is None)
    if jc.probs is not None:
        np.testing.assert_array_equal(tc.probs, jc.probs)
    assert tc.sorted == jc.sorted


@pytest.mark.parametrize("step", [
    ("softmax", ()), ("top_k", (17,)), ("top_k", (0,)), ("top_p", (0.8,)), ("top_p", (1.0,)),
    ("tail_free", (0.9,)), ("typical", (0.7,)), ("temperature", (0.6,)),
])
def test_host_cascade_steps_bit_exact(step):
    """Every truncation / transform on a seeded pool equals the JAX module's
    bit for bit (ids, logits, probabilities), also after a top-k first."""
    name, args = step
    for pre in (False, True):
        jc, tc = _pools(5)
        if pre:
            jsm.top_k(jc, 60)
            tsm.top_k(tc, 60)
        getattr(jsm, name)(jc, *args)
        getattr(tsm, name)(tc, *args)
        _same(jc, tc)


def test_host_penalties_and_draws_bit_exact():
    """Repetition and frequency/presence penalties, greedy, and draws from
    equal default_rng seeds."""
    last = np.random.default_rng(3).integers(0, V, 50).astype(np.int32)
    jc, tc = _pools(6)
    jsm.repetition_penalty(jc, last, 1.3)
    tsm.repetition_penalty(tc, last, 1.3)
    jsm.frequency_presence_penalties(jc, last, 0.2, 0.4)
    tsm.frequency_presence_penalties(tc, last, 0.2, 0.4)
    _same(jc, tc)
    assert tsm.greedy(tc) == jsm.greedy(jc)
    jr, tr = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(20):
        assert tsm.sample_token(tc, tr) == jsm.sample_token(jc, jr)
    _same(jc, tc)


@pytest.mark.parametrize("version", [1, 2])
def test_mirostat_bit_exact_over_steps(version):
    """Mirostat 1 and 2: token and mu equal at each of 12 steps, one rng each."""
    jr, tr = np.random.default_rng(21), np.random.default_rng(21)
    jmu = tmu = 10.0
    for step in range(12):
        jc, tc = _pools(100 + step)
        jsm.temperature(jc, 0.8)
        tsm.temperature(tc, 0.8)
        if version == 1:
            jt, jmu = jsm.mirostat_v1(jc, jr, 5.0, 0.1, 100, jmu, V)
            tt, tmu = tsm.mirostat_v1(tc, tr, 5.0, 0.1, 100, tmu, V)
        else:
            jt, jmu = jsm.mirostat_v2(jc, jr, 5.0, 0.1, jmu)
            tt, tmu = tsm.mirostat_v2(tc, tr, 5.0, 0.1, tmu)
        assert (tt, tmu) == (jt, jmu)


SAMPLERS = [
    {}, {"temp": 0.0}, {"top_k": 0, "temp": 0.8}, {"top_k": 2000}, {"tfs_z": 0.9},
    {"typical_p": 0.8}, {"mirostat": 1}, {"mirostat": 2, "mirostat_tau": 4.0},
    {"repeat_penalty": 1.3, "frequency_penalty": 0.3, "presence_penalty": 0.2},
    {"penalize_nl": False, "logit_bias": {3: 1.5, 193: 2.0}}, {"repeat_last_n": 0},
    {"top_p": 0.5, "top_k": 10, "temp": 1.3},
]


@pytest.mark.parametrize("kw", SAMPLERS)
def test_sample_and_cascade_probs_bit_exact(kw):
    """The whole cascade: 8 steps of `sample` with one SamplerState each
    (mu carried for mirostat), and `cascade_probs` where it is defined, at
    Falcon's newline id (the JAX module's only one)."""
    jp, tp = SamplerParams(seed=7, **kw), TSamplerParams(seed=7, **kw)
    js, ts = jsm.SamplerState.init(jp), tsm.SamplerState.init(tp)
    history = [int(t) for t in np.random.default_rng(8).integers(0, V, 40)] + [193, 193]
    for step in range(8):
        logits = (np.random.default_rng(200 + step).standard_normal(V) * 2).astype(np.float32)
        tok = tsm.sample(logits, history, tp, ts, nl_token=193)
        assert tok == jsm.sample(logits, history, jp, js)
        assert ts.mu == js.mu
        if not kw.get("mirostat"):
            np.testing.assert_array_equal(tsm.cascade_probs(logits, history, tp, nl_token=193),
                                          jsm.cascade_probs(logits, history, jp))
        history.append(tok)


def test_newline_id_is_the_vocabularys():
    """penalize_nl=False restores the logit of the id it is given: LLaMA's
    13, where the JAX module restores Falcon's 193 for every vocabulary."""
    logits = np.zeros(V, np.float32)
    logits[[13, 193]] = 2.0
    p = TSamplerParams(temp=0.0, repeat_penalty=4.0, penalize_nl=False)
    state = tsm.SamplerState.init(p)
    assert tsm.sample(logits, [13, 193], p, state, nl_token=13) == 13
    assert tsm.sample(logits, [13, 193], p, state, nl_token=193) == 193
    ring = torch.tensor([13, 193])
    out = tsd.apply_penalties(torch.from_numpy(logits), ring, tsd.penalty_spec(p, V, 13))
    assert float(out[13]) == 2.0 and float(out[193]) == 0.5


@pytest.mark.parametrize("kw", SAMPLERS + [{"top_k": 1024}, {"top_k": 1025}, {"top_k": -1},
                                          {"top_k": 0, "temp": 0.0}, {"tfs_z": 1.0}])
def test_device_samplable_matches_jax(kw):
    assert (tsd.device_samplable(TSamplerParams(**kw))
            == jdevice_samplable(SamplerParams(**kw)))
