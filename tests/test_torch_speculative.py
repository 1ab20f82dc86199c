"""The port's speculative decoding (ggllm_tpu_torch/engine/speculative.py)
against the JAX package's and against target-only decoding, on the CPU in
f32.

Tiny Falcon (Q8_0) and LLaMA files written by the JAX package, a target and
another random model each (the JAX tests/test_speculative.py models). The
JAX package's target-only greedy ids and its fused stochastic rounds are
computed once a module. Greedy ids of the fused rounds and of the host
rounds equal the port's and the JAX package's target-only greedy ids with a
bad draft (the other model), a perfect draft (the target's weights) and a
depth-truncated self-draft, on dense and int8 caches; penalties take the
host path; after generation both engines stand at the committed stream with
their caches equal to target-only ones; the port's stochastic rounds fed the
JAX rounds' uniforms emit the JAX rounds' ids and n_acc (top-k, top-p,
tail-free and typical truncations); a round's accept / resample on the
device equals a float64 replay over its p and q; the accept / resample
identity holds exactly; mirostat is refused; two temperatures share one
round key."""

import dataclasses

import numpy as np
import pytest
import torch

from ggllm_tpu.core.config import EngineConfig, FalconHParams
from ggllm_tpu.core.dtypes import GGMLType
from ggllm_tpu.engine import speculative as jspec
from ggllm_tpu.engine.engine import FalconEngine
from ggllm_tpu.io.ggcc import read_model
from ggllm_tpu.io.loader import load_params
from ggllm_tpu.ops import sampling as jsampling
from ggllm_tpu.utils.synthetic import write_tiny_llama, write_tiny_model

from ggllm_tpu_torch.core.config import EngineConfig as TEngineConfig
from ggllm_tpu_torch.engine.engine import FalconEngine as TFalconEngine
from ggllm_tpu_torch.engine.speculative import (SpeculativeDecoder, accept_round, replay_round,
                                                resample_dist, spec_accept, spec_resample,
                                                truncate_params)
from ggllm_tpu_torch.io.loader import load_model as tload_model
from ggllm_tpu_torch.ops import sampling
from ggllm_tpu_torch.ops.sampling import SamplerParams

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)

PROMPT = [5, 9, 2, 14, 3]
N = 20
GREEDY = dict(temp=0.0, repeat_penalty=1.0)
STOCH = dict(temp=0.9, top_k=40, top_p=0.95, repeat_penalty=1.0, seed=7)
TRUNC = dict(temp=0.8, top_k=64, top_p=0.9, tfs_z=0.92, typical_p=0.85, repeat_penalty=1.0,
             seed=13)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("spec")
    out = {}
    for which, seed in (("target", 3), ("other", 11)):
        out["falcon", which] = str(d / f"falcon-{which}.ggcc")
        write_tiny_model(out["falcon", which], FalconHParams.tiny(), ftype_2d=GGMLType.Q8_0,
                         seed=seed)
    for which, seed in (("target", 7), ("other", 19)):
        out["llama", which] = str(d / f"llama-{which}.ggjt")
        write_tiny_llama(out["llama", which], seed=seed)
    return out


def _cfg(kvd):
    return dict(n_ctx=96, n_batch=32, kv_dtype=kvd, compute_dtype="float32")


@pytest.fixture(scope="module")
def make(files):
    """make(family, kv_dtype, which): a fresh port engine ("target", "other",
    or "self": the target's first layer, its weights aliased)."""
    loaded = {}

    def _make(family, kvd, which):
        cfg = TEngineConfig(**_cfg(kvd))
        src = "target" if which == "self" else which
        if (family, kvd, src) not in loaded:
            loaded[family, kvd, src] = tload_model(files[family, src], cfg, device="cpu")
        mf, params = loaded[family, kvd, src]
        if which == "self":
            return TFalconEngine(dataclasses.replace(mf.hparams, n_layer=1),
                                 truncate_params(params, 1), cfg, device="cpu")
        return TFalconEngine(mf.hparams, params, cfg, device="cpu")

    return _make


def _jax_engine(files, family, kvd, which="target"):
    mf = read_model(files[family, which])
    cfg = EngineConfig(**_cfg(kvd), kernel_layout=True)
    return FalconEngine(mf.hparams, load_params(mf, cfg), cfg)


@pytest.fixture(scope="module")
def jax_greedy(files):
    """The JAX engines' target-only greedy ids of PROMPT, a family and cache."""
    return {(family, kvd): [int(t) for t in _jax_engine(files, family, kvd).generate(
        PROMPT, N, jsampling.SamplerParams(**GREEDY), stop_ids=set())]
        for family in ("falcon", "llama") for kvd in ("float32", "int8")}


@pytest.fixture(scope="module")
def jax_rounds(files):
    """The JAX fused stochastic rounds (k 3, 2 rounds a dispatch) of 16 ids
    with the other model as the draft: last_rounds and the ids."""
    out = {}
    for name, family, kw in (("stoch", "falcon", STOCH), ("trunc", "falcon", TRUNC),
                             ("stoch", "llama", STOCH)):
        spec = jspec.SpeculativeDecoder(_jax_engine(files, family, "float32"),
                                        _jax_engine(files, family, "float32", "other"),
                                        k=3, rounds_per_dispatch=2)
        assert spec._fused_ok(jsampling.SamplerParams(**kw))
        ids = spec.generate(PROMPT, 16, jsampling.SamplerParams(**kw))
        out[name, family] = spec.last_rounds, ids
    return out


def _target_only(eng, prompt, sampler, n):
    """Host-cascade target-only decoding (one eval and one draw a token)."""
    state = sampling.SamplerState.init(sampler)
    logits, last, out = eng.eval(prompt), list(prompt), []
    for _ in range(n):
        tok = sampling.sample(logits, last, sampler, state, eng.cfg.n_ctx, nl_token=eng.nl_token)
        out.append(tok)
        last.append(tok)
        logits = eng.eval([tok])
    return out


@pytest.mark.parametrize("path", ["fused", "host"])
@pytest.mark.parametrize("draft", ["other", "target", "self"])
@pytest.mark.parametrize("kvd", ["float32", "int8"])
@pytest.mark.parametrize("family", ["falcon", "llama"])
def test_greedy_ids_equal_target_only(make, jax_greedy, family, kvd, draft, path):
    """Whatever the draft (another model, the target itself, its first
    layer), speculative greedy ids are the target-only greedy ids of the
    port and of the JAX package, on the fused and on the host rounds, and
    both engines end at the committed stream."""
    ref = make(family, kvd, "target").generate(PROMPT, N, SamplerParams(**GREEDY))
    assert ref == jax_greedy[family, kvd]
    tgt, dr = make(family, kvd, "target"), make(family, kvd, draft)
    spec = SpeculativeDecoder(tgt, dr, k=4)
    if path == "host":
        spec._fused_ok = lambda sampler: False
    assert spec.generate(PROMPT, N, SamplerParams(**GREEDY)) == ref
    assert tgt.n_past == dr.n_past == len(PROMPT) + N - 1
    assert spec.stats.n_rounds > 0 and bool(spec._programs) == (path == "fused")
    if draft == "target":
        assert spec.stats.acceptance == 1.0


@pytest.mark.parametrize("family", ["falcon", "llama"])
def test_penalties_take_the_host_path_and_keep_target_only_ids(make, family):
    sampler = SamplerParams(temp=0.0, repeat_penalty=1.3, repeat_last_n=8)
    ref = _target_only(make(family, "float32", "target"), PROMPT, sampler, N)
    spec = SpeculativeDecoder(make(family, "float32", "target"),
                              make(family, "float32", "other"), k=4)
    assert not spec._fused_ok(sampler)
    assert spec.generate(PROMPT, N, sampler) == ref
    assert not spec._programs and spec.stats.n_rounds > 0


@pytest.mark.parametrize("sampler", [GREEDY, STOCH], ids=["greedy", "stochastic"])
@pytest.mark.parametrize("path", ["fused", "host"])
def test_both_caches_hold_the_committed_stream(make, path, sampler):
    """After generation the target and the draft stand at the committed
    stream, and their caches on it equal a target-only (draft-only) eval of
    the stream; the next step's logits equal a fresh engine's."""
    tgt, dr = make("falcon", "float32", "target"), make("falcon", "float32", "other")
    spec = SpeculativeDecoder(tgt, dr, k=4)
    if path == "host":
        spec._fused_ok = lambda sampler: False
    out = spec.generate(PROMPT, 13, SamplerParams(**sampler))
    stream = PROMPT + out
    n = len(stream) - 1
    assert len(out) == 13 and tgt.n_past == dr.n_past == n
    for eng, which in ((tgt, "target"), (dr, "other")):
        fresh = make("falcon", "float32", which)
        fresh.eval(stream[:-1])
        np.testing.assert_allclose(eng.kv[:, :, :, :n], fresh.kv[:, :, :, :n], atol=2e-5)
    np.testing.assert_allclose(tgt.eval(stream[-1:]),
                               make("falcon", "float32", "target").eval(stream), atol=2e-4)


@pytest.mark.parametrize("name,family", [("stoch", "falcon"), ("trunc", "falcon"),
                                         ("stoch", "llama")])
def test_stochastic_rounds_replay_the_jax_rounds(make, jax_rounds, name, family):
    """Fed the JAX rounds' uniforms, the port's fused stochastic rounds emit
    the JAX rounds' ids and n_acc, round for round."""
    rounds, ids = jax_rounds[name, family]
    spec = SpeculativeDecoder(make(family, "float32", "target"),
                              make(family, "float32", "other"), k=3, rounds_per_dispatch=2)
    out = spec.generate(PROMPT, 16, SamplerParams(**(STOCH if name == "stoch" else TRUNC)),
                        uniforms=np.stack([us for _, _, us in rounds]))
    assert out == [int(t) for t in ids]
    assert len(spec.last_rounds) == len(rounds)
    for (e, a, us), (je, ja, jus) in zip(spec.last_rounds, rounds):
        assert (e, a) == ([int(t) for t in je], int(ja))
        np.testing.assert_array_equal(us, jus)
    assert any(a < 3 for _, a, _ in rounds) and any(a > 0 for _, a, _ in rounds)


@pytest.mark.parametrize("kw", [STOCH, TRUNC], ids=["stoch", "trunc"])
def test_a_round_equals_its_float64_replay(make, kw):
    """Each round's accept / resample on the device equals a float64 host
    replay over the round's own p, q and drafts on its uniforms, and its
    drafts are inverse-CDF draws from q in token-id order."""
    spec = SpeculativeDecoder(make("falcon", "float32", "target"),
                              make("falcon", "float32", "other"), k=3, rounds_per_dispatch=2)
    spec.record = []
    spec.generate(PROMPT, 24, SamplerParams(**kw))
    assert len(spec.record) >= len(spec.last_rounds) > 3
    for rec, (emitted, n_acc, us) in zip(spec.record, spec.last_rounds):
        p, q, xs = rec["p"].double().numpy(), rec["q"].double().numpy(), rec["xs"].tolist()
        assert replay_round(p, q, xs, us) == (emitted, n_acc)
        for j, x in enumerate(xs):
            cum = np.cumsum(q[j])
            assert x == int(np.flatnonzero(cum > us[j] * cum[-1])[0])


def test_the_accept_resample_identity_holds_exactly():
    """Accepting x ~ q w.p. min(1, p/q) and else drawing from
    resample_dist(p, q) commits each token with probability p, for any q;
    accept_round on the device equals its float64 replay on random rounds."""
    rng = np.random.default_rng(0)
    V = 8
    for trial in range(6):
        p = rng.dirichlet(np.ones(V))
        q = rng.dirichlet(np.ones(V) * (0.3 + trial))
        if trial % 2:
            p[rng.integers(V)] = 0.0
            q[rng.integers(V)] = 0.0
            p, q = p / p.sum(), q / q.sum()
        acc = q * np.minimum(1.0, p / np.maximum(q, 1e-300))
        committed = acc + (1.0 - acc.sum()) * resample_dist(p, q)
        np.testing.assert_allclose(committed, p, rtol=0, atol=1e-12)
    k = 4
    for _ in range(200):
        p = rng.dirichlet(np.ones(V) * 0.5, size=k + 1)
        q = rng.dirichlet(np.ones(V) * 0.5, size=k + 1)
        xs = [int(rng.choice(V, p=q[j])) for j in range(k)]
        us = rng.random(2 * k + 2)
        tp, tq, txs, tu = (torch.from_numpy(a) for a in (p, q, np.array(xs), us))
        toks, n_acc, _ = accept_round(tp, tq, txs, tu[k + 1:2 * k + 1], tu[2 * k + 1])
        emitted, want = replay_round(p, q, xs, us)
        assert int(n_acc) == want and toks[:want + 1].tolist() == emitted
    p = np.array([0.1, 0.7, 0.2])
    q = np.array([0.5, 0.4, 0.1])
    assert spec_accept(p, q, 1, rng, greedy=True) and not spec_accept(p, q, 0, rng, greedy=True)
    assert spec_resample(p, q, rng, greedy=True) == 1


def test_mirostat_is_refused(make):
    spec = SpeculativeDecoder(make("falcon", "float32", "target"),
                              make("falcon", "float32", "other"), k=2)
    with pytest.raises(ValueError, match="mirostat"):
        spec.generate(PROMPT, 4, SamplerParams(temp=0.8, mirostat=2))


def test_two_temperatures_share_one_round_key(make):
    """The round key is the sampler's shape: other temperatures and top-p
    values reuse the program, another top-k makes another."""
    spec = SpeculativeDecoder(make("falcon", "float32", "target"),
                              make("falcon", "float32", "other"), k=3)
    for temp, top_p in ((0.7, 0.95), (0.9, 0.8)):
        spec.target.reset()
        spec.draft.reset()
        spec.generate(PROMPT, 8, SamplerParams(temp=temp, top_p=top_p, repeat_penalty=1.0))
    assert len(spec._programs) == 1
    spec.target.reset()
    spec.draft.reset()
    spec.generate(PROMPT, 8, SamplerParams(temp=0.7, top_k=20, repeat_penalty=1.0))
    assert len(spec._programs) == 2


def test_a_stop_ends_the_stream_and_both_engines_follow(make):
    """on_token returning False and a stop id end the stream there; both
    engines stand at the committed ids, all but the last forwarded."""
    ref = make("falcon", "float32", "target").generate(PROMPT, N, SamplerParams(**GREEDY))
    spec = SpeculativeDecoder(make("falcon", "float32", "target"),
                              make("falcon", "float32", "target"), k=4)
    seen = []
    out = spec.generate(PROMPT, N, SamplerParams(**GREEDY),
                        on_token=lambda t: (seen.append(t), len(seen) < 7)[1])
    assert out == seen == ref[:7]
    assert spec.target.n_past == spec.draft.n_past == len(PROMPT) + 6
    spec.target.reset()
    spec.draft.reset()
    out = spec.generate(PROMPT, N, SamplerParams(**GREEDY), stop_ids={ref[9]})
    assert out == ref[:ref.index(ref[9]) + 1]
