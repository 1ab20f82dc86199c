"""The port's device sampling cascade against the JAX package's, on the CPU.

Penalties are deterministic and compared value for value. Draws cannot match
(jax threefry and torch's generator differ), so the single stream's
distribution over its top-k slice is compared with the JAX rows' cascade
(cascade_mask_probs: top-k, top-p on the unscaled distribution, then the
temperature, the host cascade's order), and its draw on an explicit uniform
with the rows' and the host cascade's. The JAX single stream's own cascade
(sample_logits, temperature before top-p) is not the reference: it disagrees
with the JAX host cascade and rows.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ggllm_tpu.ops import sampling_device as jsd
from ggllm_tpu.ops.sampling import SamplerParams

from ggllm_tpu_torch.ops import sampling_device as tsd
from ggllm_tpu_torch.ops.sampling import SamplerParams as TSamplerParams

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)

V = 300


def _device_sampler(params, nl_token=193):
    """A sampler as the decode step takes it: its shape key and its values
    as (CPU) tensors."""
    key = tsd.sampler_key(params, V, nl_token)
    return key, tsd.SamplerValues(key, "cpu").set(params, V)


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
    got = tsd.apply_penalties(torch.from_numpy(logits), torch.from_numpy(ring),
                              *_device_sampler(TSamplerParams(**kw))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_neutral_penalty_values_are_exact_no_ops():
    """Under a key whose penalties are on, the neutral values (repeat 1,
    frequency 0, presence 0) leave every logit as it was, bit for bit, zeros
    and negative values included: a program keyed on "penalties on" serves
    every penalty value without changing what the sampler computes."""
    rng = np.random.default_rng(6)
    logits = torch.from_numpy((rng.standard_normal(V) * 3).astype(np.float32))
    logits[:4] = torch.tensor([0.0, -0.0, -5.0, float("-inf")])
    ring = torch.from_numpy(np.concatenate([np.arange(8), rng.integers(0, V, 30)]))
    key = tsd.sampler_key(TSamplerParams(repeat_penalty=1.3), V, 193)
    assert key.penalized
    sv = tsd.SamplerValues(key, "cpu").set(TSamplerParams(repeat_penalty=1.0), V)
    assert torch.equal(tsd.apply_penalties(logits, ring, key, sv), logits)
    assert torch.equal(torch.signbit(tsd.apply_penalties(logits, ring, key, sv)),
                       torch.signbit(logits))


@pytest.mark.parametrize("temp,top_k,top_p", [(0.7, 10, 0.8), (1.0, 0, 1.0), (0.5, 40, 0.95)])
def test_sample_logits_distribution(temp, top_k, top_p):
    """The single stream's probabilities over its top-k slice equal the JAX
    cascade_mask_probs' on the same slice within 1e-6, and 20000 draws on
    uniforms from a seed follow them within 0.015 (none outside the kept
    set)."""
    logits = (np.random.default_rng(1).standard_normal(V) * 2).astype(np.float32)
    k = tsd.n_candidates(top_k, V)
    key, sv = _device_sampler(TSamplerParams(temp=temp, top_k=top_k, top_p=top_p))
    assert key.n_cand == k
    t = torch.from_numpy(logits)
    probs, mask, idx = tsd.cascade_slice(t, key, sv)
    vals = t[idx].numpy()
    jprobs, jmask = jsd.cascade_mask_probs(
        jnp.asarray(vals)[None], jnp.asarray([temp], jnp.float32),
        jnp.asarray([top_p], jnp.float32), jnp.asarray([k], jnp.int32))
    assert mask.numpy().tolist() == np.asarray(jmask).tolist()
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=0, atol=1e-6)
    expected = np.zeros(V)
    expected[idx.numpy()] = np.asarray(jprobs, np.float64)[0]
    gen = torch.Generator().manual_seed(3)
    n = 20000
    draws = np.array([int(tsd.sample_logits(t, key, sv, torch.rand(1, generator=gen)))
                      for _ in range(n)])
    freq = np.bincount(draws, minlength=V) / n
    assert np.all(freq[expected == 0] == 0)
    np.testing.assert_allclose(freq, expected, atol=0.015)


class _Replay:
    """np.random.Generator stand-in replaying preset uniforms."""

    def __init__(self, us):
        self.us = list(us)

    def random(self):
        return self.us.pop(0)


@pytest.mark.parametrize("temp,top_k,top_p", [(0.7, 10, 0.8), (1.0, 200, 1.0), (0.5, 40, 0.95),
                                              (1.3, 64, 0.9)])
def test_single_stream_draw_is_the_rows_and_the_hosts(temp, top_k, top_p):
    """For the same logits, knobs and uniform u, the single stream's id
    equals cascade_rows' at B = 1 and the host cascade's (ops/sampling.py
    sample) replaying u, at eleven uniforms (knobs the device path takes:
    top_k <= 0 goes to the host, device_samplable)."""
    logits = (np.random.default_rng(4).standard_normal(V) * 3).astype(np.float32)
    t = torch.from_numpy(logits)
    params = TSamplerParams(temp=temp, top_k=top_k, top_p=top_p, repeat_penalty=1.0,
                            repeat_last_n=0)
    assert tsd.device_samplable(params)
    key, sv = _device_sampler(params)
    vals, idx = torch.topk(t, key.n_cand)
    for u in np.linspace(0.01, 0.99, 11).astype(np.float32):
        got = int(tsd.sample_logits(t, key, sv, torch.tensor(u)))
        rank = tsd.cascade_rows(vals[None], torch.tensor([u]), torch.tensor([temp]),
                                torch.tensor([top_p]), torch.tensor([key.n_cand]))
        assert got == int(idx[rank[0]]), u
        state = tsm.SamplerState(rng=_Replay([float(u)]), mu=10.0)
        assert got == tsm.sample(logits, [], params, state, nl_token=193), u


def test_greedy_is_argmax_like_jax():
    logits = np.random.default_rng(2).standard_normal(V).astype(np.float32)
    ref = int(jsd.sample_logits(jnp.asarray(logits), None, 0.0, 40, 0.95))
    key, sv = _device_sampler(TSamplerParams(temp=0.0, top_k=40, top_p=0.95))
    assert int(tsd.sample_logits(torch.from_numpy(logits), key, sv, None)) == ref


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
    out = tsd.apply_penalties(torch.from_numpy(logits), ring, *_device_sampler(p, 13))
    assert float(out[13]) == 2.0 and float(out[193]) == 0.5


@pytest.mark.parametrize("kw", SAMPLERS + [{"top_k": 1024}, {"top_k": 1025}, {"top_k": -1},
                                          {"top_k": 0, "temp": 0.0}, {"tfs_z": 1.0}])
def test_device_samplable_matches_jax(kw):
    assert (tsd.device_samplable(TSamplerParams(**kw))
            == jdevice_samplable(SamplerParams(**kw)))
