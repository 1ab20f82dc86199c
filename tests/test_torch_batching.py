"""Continuous batching in the port (ggllm_tpu_torch/engine/batching.py over
FalconEngine(batch_size=B) prefill_rows / decode_rows) against the port's
single stream and the JAX package's batcher, on the CPU.

The cases of tests/test_batching.py, on tiny files written by the JAX
package (f32 compute): batched greedy ids equal the port's sequential ids
and the JAX ContinuousBatcher's (computed once a module), on Falcon and
LLaMA, dense and int8 caches; stop ids and streaming; more requests than
rows; chunked admission interleaving decode; sampled rows whose consumed
uniforms, replayed through the port's host cascade, give the batched ids; a
request whose stream raises fails alone; the single-stream entry points
refuse on a B-row engine (grammar rows: tests/test_torch_batching_grammar.py). Also the per-row cache
writes (ops/kvcache.py write_layer / write_all_layers with a (B,) n_past)
against the JAX kvcache functions, and prefill_rows' logits against the JAX
engine's."""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ggllm_tpu.core.config import EngineConfig, FalconHParams, LlamaHParams
from ggllm_tpu.core.dtypes import GGMLType
from ggllm_tpu.engine.batching import ContinuousBatcher as JBatcher, Request as JRequest
from ggllm_tpu.engine.engine import FalconEngine as JEngine
from ggllm_tpu.io.ggcc import read_model
from ggllm_tpu.io.loader import load_params
from ggllm_tpu.ops import kvcache as jkvcache
from ggllm_tpu.utils import synthetic as jsynthetic

from ggllm_tpu_torch.core.config import EngineConfig as TEngineConfig
from ggllm_tpu_torch.engine.batching import ContinuousBatcher, Request
from ggllm_tpu_torch.engine.engine import FalconEngine
from ggllm_tpu_torch.io.loader import load_model
from ggllm_tpu_torch.ops import kvcache, sampling

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)

PROMPTS = [
    [5, 17, 130, 42],
    [300, 301, 302, 303, 304, 305, 306, 307, 308, 309],
    [7, 8],
    [100, 200, 300, 400, 150],
    [42],
]
GREEDY = sampling.SamplerParams(temp=0.0, repeat_penalty=1.0)


def _cfg(kv_dtype="float32"):
    return TEngineConfig(n_ctx=96, n_batch=16, kv_dtype=kv_dtype, compute_dtype="float32")


def _jcfg(kv_dtype="float32"):
    return EngineConfig(n_ctx=96, n_batch=16, kv_dtype=kv_dtype, compute_dtype="float32")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("batching")
    falcon, llama = str(d / "falcon.ggcc"), str(d / "llama.ggjt")
    jsynthetic.write_tiny_model(falcon, FalconHParams.tiny(), ftype_2d=GGMLType.Q8_0, seed=17)
    jsynthetic.write_tiny_llama(llama, LlamaHParams.tiny(), ftype_2d=GGMLType.Q8_0, seed=23)
    return {"falcon": falcon, "llama": llama}


_MODELS = {}


def _model(files, family, kv_dtype="float32"):
    """(hparams, params) of a family's file on the CPU, loaded once."""
    if (family, kv_dtype) not in _MODELS:
        mf, params = load_model(files[family], _cfg(kv_dtype), device="cpu")
        _MODELS[family, kv_dtype] = (mf.hparams, params)
    return _MODELS[family, kv_dtype]


def _engine(files, family, kv_dtype="float32", batch_size=1):
    hp, params = _model(files, family, kv_dtype)
    return FalconEngine(hp, params, _cfg(kv_dtype), device="cpu", batch_size=batch_size)


_SEQUENTIAL = {}


def _sequential(files, family, prompt, n_predict, kv_dtype="float32"):
    """The port's single stream, greedy without penalties."""
    key = (family, kv_dtype, tuple(prompt), n_predict)
    if key not in _SEQUENTIAL:
        _SEQUENTIAL[key] = _engine(files, family, kv_dtype).generate(prompt, n_predict, GREEDY)
    return _SEQUENTIAL[key]


# (family, B, chunk, prompts, n_predict): the JAX tests' two greedy runs
RUNS = {"falcon": (3, 8, PROMPTS, 20), "llama": (2, 4, PROMPTS[:3], 12)}


@pytest.fixture(scope="module")
def jax_ids(files):
    """The JAX ContinuousBatcher's greedy ids of RUNS on dense and int8
    caches, by (family, kv_dtype), once a module."""
    out = {}
    for family, (B, chunk, prompts, n_predict) in RUNS.items():
        mf = read_model(files[family])
        for kv_dtype in ("float32", "int8"):
            cfg = _jcfg(kv_dtype)
            eng = JEngine(mf.hparams, load_params(mf, cfg), cfg, batch_size=B)
            cb = JBatcher(eng, chunk=chunk)
            reqs = [cb.submit(JRequest(list(p), n_predict=n_predict)) for p in prompts]
            cb.run()
            out[family, kv_dtype] = [r.out for r in reqs]
    return out


def _batched(eng, prompts, n_predict, chunk, **kw):
    cb = ContinuousBatcher(eng, chunk=chunk, **kw)
    reqs = [cb.submit(Request(list(p), n_predict=n_predict)) for p in prompts]
    cb.run()
    assert all(r.done and r.error is None for r in reqs) and not cb.active
    return [r.out for r in reqs]


@pytest.mark.parametrize("family", ["falcon", "llama"])
def test_batched_greedy_matches_sequential_and_jax(files, jax_ids, family):
    """Greedy ids of the batcher (more prompts than rows, admissions while
    rows decode, rows ending mid-chunk) equal the port's single stream and
    the JAX batcher, request by request."""
    B, chunk, prompts, n_predict = RUNS[family]
    got = _batched(_engine(files, family, batch_size=B), prompts, n_predict, chunk)
    assert got == [_sequential(files, family, p, n_predict) for p in prompts]
    assert got == jax_ids[family, "float32"]


@pytest.mark.parametrize("family", ["falcon", "llama"])
def test_batched_int8_cache_matches_sequential(files, jax_ids, family):
    """On an int8 cache (chunk-deferred decode: one quantizing per-row write
    a chunk) the batched greedy ids equal the port's single stream on the
    same cache and the JAX batcher on an int8 cache."""
    B, chunk, prompts, n_predict = RUNS[family]
    got = _batched(_engine(files, family, "int8", batch_size=B), prompts, n_predict, chunk)
    assert got == [_sequential(files, family, p, n_predict, "int8") for p in prompts]
    assert got == jax_ids[family, "int8"]


def test_stop_ids_and_streaming(files):
    ref = _sequential(files, "falcon", PROMPTS[0], 24)
    stop = ref[6]
    cb = ContinuousBatcher(_engine(files, "falcon", batch_size=2), chunk=8)
    seen = []
    r = cb.submit(Request(PROMPTS[0], n_predict=24, stop_ids=frozenset({stop}),
                          stream=seen.append))
    cb.run()
    assert r.done and r.out == ref[:ref.index(stop) + 1] and seen == r.out


def test_slot_reuse_more_requests_than_rows(files):
    """Ten requests through two rows: each freed row parks, is reused, and
    every request's ids equal its single stream."""
    prompts = PROMPTS * 2
    got = _batched(_engine(files, "falcon", batch_size=2), prompts, 12, 8)
    assert got == [_sequential(files, "falcon", p, 12) for p in prompts]


def test_chunked_admission_interleaves_decode(files):
    """With prefill_chunk 4 a 16-token prompt is admitted over 4 steps while
    the live row keeps decoding, and its ids equal a whole-prompt admission."""
    cb = ContinuousBatcher(_engine(files, "falcon", batch_size=2), chunk=2, prefill_chunk=4)
    r1 = cb.submit(Request(PROMPTS[0], n_predict=30))
    cb.step()
    assert not cb.prefilling and len(r1.out) >= 1
    long_prompt = (PROMPTS[1] * 8)[:16]
    r2 = cb.submit(Request(long_prompt, n_predict=4))
    progress = []
    while r2.row < 0 or cb.prefilling:
        before = len(r1.out)
        cb.step()
        if cb.prefilling:
            progress.append(len(r1.out) - before)
    assert len(progress) == 3 and sum(progress) > 0, progress
    cb.run()
    assert len(r2.out) == 4 and r1.done
    assert r1.out == _sequential(files, "falcon", PROMPTS[0], 30)
    whole = _batched(_engine(files, "falcon", batch_size=2), [long_prompt], 4, 2,
                     prefill_chunk=512)
    assert whole == [r2.out] == [_sequential(files, "falcon", long_prompt, 4)]


class _Replay:
    """np.random.Generator stand-in replaying the uniforms a row consumed."""

    def __init__(self, us):
        self.us = list(us)

    def random(self):
        return self.us.pop(0)


def _replay(files, req: Request, n: int, kv_dtype="float32"):
    """The single stream with the host cascade consuming req.us."""
    eng = _engine(files, "falcon", kv_dtype)
    params = sampling.SamplerParams(
        temp=req.temp, top_k=req.top_k if req.top_k > 0 else 64, top_p=req.top_p,
        tfs_z=req.tfs_z, typical_p=req.typical_p, repeat_penalty=req.repeat_penalty,
        repeat_last_n=64, frequency_penalty=req.frequency_penalty,
        presence_penalty=req.presence_penalty, mirostat=req.mirostat,
        mirostat_tau=req.mirostat_tau, mirostat_eta=req.mirostat_eta,
        penalize_nl=req.penalize_nl, logit_bias=dict(req.logit_bias))
    state = sampling.SamplerState(rng=_Replay(req.us), mu=2.0 * req.mirostat_tau)
    hist, out = list(req.prompt_ids), []
    logits = eng.eval(req.prompt_ids)
    while True:
        tok = sampling.sample(logits, hist, params, state, n_ctx=96, nl_token=eng.nl_token)
        out.append(tok)
        hist.append(tok)
        if len(out) >= n:
            return out, state
        logits = eng.eval([tok])


def test_sampled_rows_replay_through_the_host_cascade(files):
    """Mirostat v1 / v2, a logit bias, tail-free and typical, top-k / top-p
    with a penalty, and penalize_nl False in one batch of three rows: each
    request's ids equal the single stream's host cascade replaying the
    uniforms the row consumed (req.us), token for token."""
    nl = _engine(files, "falcon").nl_token
    specs = [
        Request(PROMPTS[0], n_predict=14, temp=0.0, logit_bias={7: 8.0, 19: 6.5}),
        Request(PROMPTS[1], n_predict=14, temp=0.9, mirostat=2, mirostat_tau=4.0,
                mirostat_eta=0.15),
        Request(PROMPTS[2], n_predict=14, temp=0.8, mirostat=1, mirostat_tau=3.0),
        Request(PROMPTS[3], n_predict=14, temp=0.85, top_k=40, tfs_z=0.8, typical_p=0.85,
                top_p=0.95),
        Request(PROMPTS[4], n_predict=14, temp=0.7, top_k=30, top_p=0.9, repeat_penalty=1.15),
        Request([nl, 5, nl, 9], n_predict=14, temp=0.8, top_k=40, repeat_penalty=1.5,
                penalize_nl=False, logit_bias={nl: 3.0}),
    ]
    cb = ContinuousBatcher(_engine(files, "falcon", batch_size=3), chunk=5, seed=11)
    reqs = [cb.submit(r) for r in specs]
    cb.run()
    for req in reqs:
        assert len(req.out) == 14 and req.error is None
        want, _ = _replay(files, req, len(req.out))
        assert req.out == want, (req.rid, req.out, want)
    # the newline row is decided by the restore: penalized, the same
    # uniforms give other ids
    nl_row = reqs[-1]
    assert nl in nl_row.out
    flipped, _ = _replay(files, dataclasses.replace(nl_row, penalize_nl=True), 14)
    assert flipped != nl_row.out


def test_a_failing_row_leaves_the_other_rows_running(files):
    """A stream callback that raises fails its request alone (Request.error
    set, its row freed); the other rows and a queued request finish with
    their single-stream ids."""
    def boom(tok):
        if boom.n == 3:
            raise RuntimeError("client went away")
        boom.n += 1
    boom.n = 0
    cb = ContinuousBatcher(_engine(files, "falcon", batch_size=2), chunk=4)
    bad = cb.submit(Request(PROMPTS[0], n_predict=20, stream=boom))
    good = [cb.submit(Request(p, n_predict=12)) for p in PROMPTS[1:3]]
    cb.run()
    assert isinstance(bad.error, RuntimeError) and bad.done and len(bad.out) == 4
    assert [r.out for r in good] == [_sequential(files, "falcon", p, 12) for p in PROMPTS[1:3]]
    assert all(r.error is None for r in good) and not cb.active


def test_single_stream_entry_points_refuse_on_a_row_engine(files):
    eng = _engine(files, "falcon", batch_size=2)
    for call in (lambda: eng.eval(PROMPTS[0]), lambda: eng.generate(PROMPTS[0], 4, GREEDY),
                 lambda: eng.decode_chunk(5, 4, GREEDY), lambda: eng.embed(PROMPTS[0]),
                 lambda: eng.eval_logprobs(PROMPTS[1])):
        with pytest.raises(ValueError, match="prefill_rows / decode_rows"):
            call()


def test_top_k_zero_clamps_to_the_cap(files):
    outs = []
    for tk in (0, 64):
        cb = ContinuousBatcher(_engine(files, "falcon", batch_size=2), chunk=4, seed=9)
        req = cb.submit(Request(PROMPTS[0], n_predict=8, temp=0.9, top_k=tk))
        cb.run()
        outs.append(req.out)
    assert outs[0] == outs[1]


def test_prefill_rows_logits_match_jax(files):
    """prefill_rows of two rows at their own positions (one at 0, one after
    an earlier prompt, a third row parked at n_ctx) against the JAX engine's
    prefill_rows, over two 16-wide forwards, then prefill_row of one row
    against the JAX prefill_row: the returned logits within 1e-4 of max
    |logit|."""
    mf = read_model(files["falcon"])
    jeng = JEngine(mf.hparams, load_params(mf, _jcfg()), _jcfg(), batch_size=3)
    teng = _engine(files, "falcon", batch_size=3)
    first = ([0, 1], [PROMPTS[1], PROMPTS[0]], np.asarray([0, 0, 96]))
    second = ([1, 0], [(PROMPTS[3] * 5)[:21], PROMPTS[2]], np.asarray([10, 4, 96]))
    for rows, prompts, npv in (first, second):
        want = jeng.prefill_rows(rows, prompts, npv)
        got = teng.prefill_rows(rows, prompts, npv)
        assert sorted(got) == sorted(want) == sorted(rows)
        for r in rows:
            scale = np.abs(want[r]).max()
            np.testing.assert_allclose(got[r] / scale, want[r] / scale, atol=1e-4)
    # prefill_row: one row's prompt from its own position, as the JAX one
    npv = np.asarray([14, 31, 96])
    want = jeng.prefill_row(0, PROMPTS[4], npv)
    got = teng.prefill_row(0, PROMPTS[4], npv)
    np.testing.assert_allclose(got / np.abs(want).max(), want / np.abs(want).max(), atol=1e-4)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_per_row_cache_writes_match_jax(kv_dtype):
    """write_layer and write_all_layers with a (B,) n_past (a parked row at
    the scratch region among them) land each row at its own position, as the
    JAX kvcache functions do; the int8 cache's codes and scales too."""
    L, B, T, KV, D, S = 3, 3, 48, 2, 8, 5
    rng = np.random.default_rng(2)
    n_past = np.asarray([0, 17, 33], np.int32)
    new_l = rng.standard_normal((2, B, S, KV, D)).astype(np.float32)
    new_all = rng.standard_normal((L, 2, B, S, KV, D)).astype(np.float32)
    jkv = jkvcache.new((L, 2, B, T, KV, D), kv_dtype if kv_dtype == "int8" else jnp.float32)
    tkv = kvcache.new((L, 2, B, T, KV, D), kv_dtype, "cpu")
    jkv = jkvcache.write_layer(jkv, jnp.asarray(new_l), 1, jnp.asarray(n_past))
    kvcache.write_layer(tkv, torch.from_numpy(new_l), 1, torch.from_numpy(n_past))
    jkv = jkvcache.write_all_layers(jkv, jnp.asarray(new_all), jnp.asarray(n_past + S))
    kvcache.write_all_layers(tkv, torch.from_numpy(new_all), torch.from_numpy(n_past + S))
    for j, t in zip(jkv if kv_dtype == "int8" else (jkv,),
                    tkv if kv_dtype == "int8" else (tkv,)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    codes = tkv[0] if kv_dtype == "int8" else tkv
    for b in range(B):  # nothing outside the rows' [n_past, n_past + 2 S)
        outside = torch.ones(T, dtype=torch.bool)
        outside[n_past[b]:n_past[b] + 2 * S] = False
        assert not codes[:, :, b, outside].any()
