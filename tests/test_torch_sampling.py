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
    tspec = tsd.penalty_spec(TSamplerParams(**kw), V)
    assert jspec == tspec
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
