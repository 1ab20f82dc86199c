"""The port's row sampler (ggllm_tpu_torch/ops/sampling_device.py
apply_bias_rows, apply_penalties_rows, cascade_rows, mirostat_rows,
sample_rows_u, sample_rows_step) against the JAX package's
(ggllm_tpu/ops/sampling_device.py:78-313), on the CPU.

The same logits, rings and knobs, made from numpy seeds, and the same
explicit uniforms go to both sides: the ids must be equal exactly and
mirostat's new mu within 1e-6 (relative). The per-row newline restore is the
port's own (the JAX rows have none): it is held against the port's host
cascade, not against JAX."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ggllm_tpu.ops import sampling_device as jsd

from ggllm_tpu_torch.ops import sampling as tsampling
from ggllm_tpu_torch.ops import sampling_device as tsd

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)

V = 2000
MU_RTOL = 1e-6


def _logits(seed, rows, v=V):
    return (np.random.default_rng(seed).standard_normal((rows, v)) * 3.0).astype(np.float32)


def _t(x, dtype=None):
    return torch.from_numpy(np.asarray(x, dtype=dtype))


class _Replay:
    """np.random.Generator stand-in replaying preset uniforms."""

    def __init__(self, us):
        self.us = list(us)

    def random(self):
        return self.us.pop(0)


CASES = [
    dict(temp=0.0),                                   # greedy
    dict(temp=0.8, top_k=40, top_p=1.0),              # top-k only
    dict(temp=0.7, top_k=40, top_p=0.6),              # + top-p
    dict(temp=1.3, top_k=64, top_p=0.9),              # temp > 1 after top-p
    dict(temp=0.8, top_k=50, top_p=1.0, tfs_z=0.7),   # tail-free
    dict(temp=0.8, top_k=50, top_p=1.0, typical_p=0.6),  # typical
    dict(temp=0.9, top_k=60, top_p=0.8, tfs_z=0.85, typical_p=0.85),
]


def _knobs(cases, k):
    return {name: np.asarray([c.get(name, d) for c in cases], dt) for name, d, dt in (
        ("temp", 0.8, np.float32), ("top_p", 1.0, np.float32), ("top_k", k, np.int32),
        ("tfs_z", 1.0, np.float32), ("typical_p", 1.0, np.float32))}


def test_cascade_rows_matches_jax_and_the_host_cascade():
    """Ranks of cascade_rows over each row's top 64 equal the JAX
    cascade_rows' on the same uniforms, and the ids they pick equal the
    port's host cascade (ops/sampling.py sample) replaying the uniform."""
    B, k = len(CASES), 64
    logits = _logits(0, B)
    us = np.linspace(0.05, 0.95, B).astype(np.float32)
    kn = _knobs(CASES, k)
    vals, idx = torch.topk(_t(logits), k)
    got = tsd.cascade_rows(vals, _t(us), _t(kn["temp"]), _t(kn["top_p"]),
                           _t(kn["top_k"]).long(), _t(kn["tfs_z"]), _t(kn["typical_p"]))
    jvals = jnp.asarray(vals.numpy())
    want = jsd.cascade_rows(jvals, jnp.asarray(us), *(jnp.asarray(kn[n]) for n in (
        "temp", "top_p", "top_k", "tfs_z", "typical_p")))
    assert got.tolist() == np.asarray(want).tolist()
    toks = idx.gather(1, got[:, None])[:, 0].tolist()
    for b, c in enumerate(CASES):
        params = tsampling.SamplerParams(
            temp=c.get("temp", 0.8), top_k=c.get("top_k", k), top_p=c.get("top_p", 1.0),
            tfs_z=c.get("tfs_z", 1.0), typical_p=c.get("typical_p", 1.0), repeat_penalty=1.0,
            repeat_last_n=0)
        state = tsampling.SamplerState(rng=_Replay([float(us[b])]), mu=10.0)
        assert toks[b] == tsampling.sample(logits[b], [], params, state, nl_token=193), (b, c)


@pytest.mark.parametrize("mode", [1, 2])
def test_mirostat_rows_matches_jax(mode):
    """Mirostat v1 / v2 ranks over the top 512 of the scaled logits equal
    the JAX mirostat_rows' on the same uniforms, and mu within 1e-6."""
    B = 4
    logits = _logits(7 + mode, B)
    us = np.asarray([0.12, 0.4, 0.73, 0.91], np.float32)
    temp = np.asarray([0.8, 1.0, 1.2, 0.9], np.float32)
    tau = np.asarray([5.0, 3.0, 5.0, 4.0], np.float32)
    eta = np.asarray([0.1, 0.2, 0.05, 0.1], np.float32)
    mu = np.asarray([10.0, 6.0, 8.0, 7.5], np.float32)
    modes = np.full(B, mode, np.int32)
    scaled = _t(logits) / _t(temp)[:, None]
    mvals, _ = torch.topk(scaled, 512)
    got, got_mu = tsd.mirostat_rows(mvals, _t(us), _t(temp), _t(modes), _t(tau), _t(eta),
                                    _t(mu), torch.logsumexp(scaled, dim=-1), V)
    want, want_mu = jsd.mirostat_rows(
        jnp.asarray(mvals.numpy()), jnp.asarray(us), jnp.asarray(temp), jnp.asarray(modes),
        jnp.asarray(tau), jnp.asarray(eta), jnp.asarray(mu),
        jnp.asarray(torch.logsumexp(scaled, dim=-1).numpy()), V)
    assert got.tolist() == np.asarray(want).tolist()
    np.testing.assert_allclose(got_mu.numpy(), np.asarray(want_mu), rtol=MU_RTOL)


# two mixes of four rows: (knobs, penalties (rp, fp, pp), bias {id: value})
MIXES = {
    "greedy_bias.topk_topp_penalties.tfs_typical.miro2": [
        (dict(temp=0.0), (1.0, 0.0, 0.0), {7: 8.0, 19: 6.5}),
        (dict(temp=0.7, top_k=30, top_p=0.9), (1.15, 0.0, 0.0), {}),
        (dict(temp=0.85, top_k=40, top_p=0.95, tfs_z=0.8, typical_p=0.85), (1.0, 0.0, 0.0), {}),
        (dict(temp=0.9, mirostat=2, mirostat_tau=4.0, mirostat_eta=0.15), (1.1, 0.0, 0.0), {}),
    ],
    "miro1.typical_presence.greedy_penalties.temp_frequency_bias": [
        (dict(temp=0.8, mirostat=1, mirostat_tau=3.0), (1.0, 0.0, 0.0), {}),
        (dict(temp=0.9, top_k=50, typical_p=0.7), (1.0, 0.0, 0.6), {}),
        (dict(temp=0.0), (1.3, 0.2, 0.0), {3: -2.0}),
        (dict(temp=1.1, top_k=64, top_p=0.8), (1.05, 0.3, 0.0), {11: 4.0, 500: 3.0}),
    ],
}


def _mix(name, seed):
    rows = MIXES[name]
    B, k, nb, ring = len(rows), 64, 8, 64
    rng = np.random.default_rng(seed)
    logits = _logits(seed, B)
    rings = rng.integers(0, V, (B, ring))
    rings[:, 40:] = V  # 40 filled slots, the rest empty
    us = rng.random(B).astype(np.float32)
    bias_ids = np.full((B, nb), V, np.int64)
    bias_vals = np.zeros((B, nb), np.float32)
    for b, (_, _, bias) in enumerate(rows):
        for i, (t, v) in enumerate(sorted(bias.items())):
            bias_ids[b, i], bias_vals[b, i] = t, v
    kn = {n: np.asarray([c.get(n, d) for c, _, _ in rows], dt) for n, d, dt in (
        ("temp", 0.8, np.float32), ("top_p", 1.0, np.float32), ("top_k", k, np.int64),
        ("tfs_z", 1.0, np.float32), ("typical_p", 1.0, np.float32),
        ("mirostat", 0, np.int64), ("mirostat_tau", 5.0, np.float32),
        ("mirostat_eta", 0.1, np.float32))}
    pen = np.asarray([p for _, p, _ in rows], np.float32)
    mu = 2.0 * kn["mirostat_tau"]
    return rows, logits, rings, us, bias_ids, bias_vals, kn, pen, mu


@pytest.mark.parametrize("name", list(MIXES))
def test_sample_rows_u_matches_jax_and_the_host_cascade(name):
    """Bias, penalties, then sample_rows_u over four rows that mix greedy,
    top-k / top-p / temperature, tail-free, typical, repetition / frequency
    / presence penalties, a logit bias and mirostat 1 or 2: the biased and
    penalized logits equal the JAX apply_bias_rows / apply_penalties_rows'
    bit for bit, the ids the JAX sample_rows_u's on the same uniforms, mu
    within 1e-6; each row's id also equals the port's host cascade replaying
    its uniform over the row's window, and so does sample_rows_step on
    RowValues (the decode graph's sampling)."""
    rows, logits, rings, us, bias_ids, bias_vals, kn, pen, mu = _mix(name, 3)
    B = len(rows)
    biased = tsd.apply_bias_rows(_t(logits), _t(bias_ids), _t(bias_vals))
    penal = tsd.apply_penalties_rows(biased, _t(rings), *(_t(pen[:, i]) for i in range(3)))
    jb = jsd.apply_bias_rows(jnp.asarray(logits), jnp.asarray(bias_ids, jnp.int32),
                             jnp.asarray(bias_vals))
    jp = jsd.apply_penalties_rows(jb, jnp.asarray(rings, jnp.int32),
                                  *(jnp.asarray(pen[:, i]) for i in range(3)))
    assert np.array_equal(biased.numpy(), np.asarray(jb))
    assert np.array_equal(penal.numpy(), np.asarray(jp))
    miro = dict(miro_mode=_t(kn["mirostat"]), miro_tau=_t(kn["mirostat_tau"]),
                miro_eta=_t(kn["mirostat_eta"]), miro_mu=_t(mu), n_vocab=V)
    got, got_mu = tsd.sample_rows_u(penal, _t(us), _t(kn["temp"]), _t(kn["top_p"]), 64,
                                    _t(kn["top_k"]), _t(kn["tfs_z"]), _t(kn["typical_p"]), **miro)
    want, want_mu = jsd.sample_rows_u(
        jp, jnp.asarray(us), jnp.asarray(kn["temp"]), jnp.asarray(kn["top_p"]), 64,
        jnp.asarray(kn["top_k"], jnp.int32), jnp.asarray(kn["tfs_z"]),
        jnp.asarray(kn["typical_p"]), miro_mode=jnp.asarray(kn["mirostat"], jnp.int32),
        miro_tau=jnp.asarray(kn["mirostat_tau"]), miro_eta=jnp.asarray(kn["mirostat_eta"]),
        miro_mu=jnp.asarray(mu), n_vocab=V)
    assert got.tolist() == np.asarray(want).tolist()
    np.testing.assert_allclose(got_mu.numpy(), np.asarray(want_mu), rtol=MU_RTOL)
    assert len(set(got.tolist())) > 1
    # the host cascade, one row at a time, replaying the row's uniform
    for b, (c, (rp, fp, pp), bias) in enumerate(rows):
        params = tsampling.SamplerParams(
            temp=c.get("temp", 0.8), top_k=c.get("top_k", 64), top_p=c.get("top_p", 1.0),
            tfs_z=c.get("tfs_z", 1.0), typical_p=c.get("typical_p", 1.0), repeat_penalty=rp,
            frequency_penalty=fp, presence_penalty=pp, repeat_last_n=64,
            mirostat=c.get("mirostat", 0), mirostat_tau=c.get("mirostat_tau", 5.0),
            mirostat_eta=c.get("mirostat_eta", 0.1), logit_bias=dict(bias))
        state = tsampling.SamplerState(rng=_Replay([float(us[b])]), mu=float(mu[b]))
        hist = [int(t) for t in rings[b] if t < V]
        assert int(got[b]) == tsampling.sample(logits[b], hist, params, state,
                                               nl_token=193), (b, c)
    # the decode step's sampling on RowValues
    key = tsd.RowKey(64, rings.shape[1], bias_ids.shape[1], True)
    rv = tsd.RowValues(key, B, "cpu")
    host = {n: kn[n] for n in kn}
    host.update(repeat_penalty=pen[:, 0], frequency_penalty=pen[:, 1],
                presence_penalty=pen[:, 2])
    rv.set(host, bias_ids, bias_vals, mu)
    step = tsd.sample_rows_step(_t(logits), _t(rings), key, rv, _t(us), nl_token=193)
    assert step.tolist() == got.tolist()
    np.testing.assert_array_equal(rv.mu.numpy(), got_mu.numpy())


def test_bias_rows_drops_empty_slots():
    logits = torch.zeros(2, V)
    ids = torch.tensor([[3, 7, V], [1, V, V]])
    out = tsd.apply_bias_rows(logits, ids, torch.tensor([[2.0, 5.0, 9.0], [4.0, 9.0, 9.0]]))
    assert out[0, 3] == 2.0 and out[0, 7] == 5.0 and out[1, 1] == 4.0 and out.sum() == 11.0


@pytest.mark.parametrize("nl_token", [193, 13], ids=["falcon_nl", "llama_nl"])
def test_penalize_nl_false_keeps_the_family_newline_logit(nl_token):
    """The port's per-row newline restore (the JAX rows have none): a row
    with penalize_nl False keeps the family's newline logit as the bias left
    it, a row with True has it penalized; every other logit is the same in
    both rows. The restored row's greedy id equals the host cascade's under
    penalize_nl=False."""
    logits = _logits(5, 1)
    logits[0, nl_token] = 9.5  # the newline is the best token before the penalty
    logits[0, 77] = 9.0
    two = _t(np.repeat(logits, 2, axis=0))
    rings = torch.tensor([[nl_token, 77, V, V]] * 2)
    rp, fp, pp = torch.full((2,), 1.3), torch.full((2,), 0.1), torch.full((2,), 0.2)
    pnl = torch.tensor([False, True])
    out = tsd.apply_penalties_rows(two, rings, rp, fp, pp, pnl, nl_token)
    assert out[0, nl_token] == logits[0, nl_token] and out[1, nl_token] < logits[0, nl_token]
    others = torch.ones(V, dtype=torch.bool)
    others[nl_token] = False
    assert torch.equal(out[0, others], out[1, others])
    assert out[0, 77] < 9.0  # the other ring entries are penalized
    ids, _ = tsd.sample_rows_u(out, torch.full((2,), 0.5), torch.zeros(2), torch.ones(2), 64)
    assert ids.tolist() == [nl_token, int(out[1].argmax())] and ids[1] != nl_token
    for penalize_nl, row in ((False, 0), (True, 1)):
        params = tsampling.SamplerParams(temp=0.0, repeat_penalty=1.3, frequency_penalty=0.1,
                                         presence_penalty=0.2, penalize_nl=penalize_nl)
        host = tsampling.sample(logits[0], [nl_token, 77], params,
                                tsampling.SamplerState.init(params), nl_token=nl_token)
        assert host == int(ids[row])
