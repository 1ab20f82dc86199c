"""The port's sequence-parallel Falcon (parallel/sp.py,
kernels/ring_attention.py; EngineConfig(kv_shard="sequence")) on gloo CPU
ranks against the JAX package's (kernels/ring_attention.py, parallel/sp.py
and the engine's sequence-parallel mode, as tests/test_ring_attention.py
and test_seq_parallel.py run them), in f32.

ring_attention at the JAX test's head layouts on 2 and 4 ranks, with and
without an n_past offset, and merged_attention with and without the
append block, each rank's output block against the JAX shard_map's; the
engine's prefill and decode-step logits at mp 2 and 4, logits_all, a
prefill of several n_batch chunks and embed() against the JAX SP engine's
within 5e-5 of max |logit|; every rank's cache holds kv_T / mp positions.
Decoding: tests/test_torch_sp_decode.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from tests import torch_parallel_jobs as J
from tests import torch_parallel_ref as R
from ggllm_tpu.kernels.ring_attention import ring_attention as jring
from ggllm_tpu.parallel import sp as jsp
from ggllm_tpu_torch.parallel.mesh import RankPool

torch.set_num_threads(1)

SP = {"kv_shard": "sequence"}
PROMPT = [5, 17, 130, 42, 99, 260, 31, 7, 12, 77]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return R.write_models(tmp_path_factory.mktemp("sp"), ("tiny",))


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(4, workdir=str(tmp_path_factory.mktemp("ranks"))) as p:
        yield p


def _shard_map(fn, n_dev, in_specs, out_spec):
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("seq",))
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_spec,
                                 check_vma=False))


@pytest.mark.parametrize("H,KV,n_dev,n_past", [(8, 1, 4, 0), (8, 2, 4, 0), (4, 4, 2, 0),
                                               (4, 1, 4, 48), (8, 2, 2, 32)])
def test_ring_attention(pool, H, KV, n_dev, n_past):
    """Each rank's output block = the JAX ring_attention's for that device;
    n_past > 0: the queries are the last S - n_past positions."""
    B, T, D = 1, 64, 32
    S = T - n_past
    rng = np.random.default_rng(H + KV + n_past)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, D)).astype(np.float32)
    ref = np.asarray(_shard_map(lambda q, k, v: jring(q, k, v, "seq", n_past=n_past), n_dev,
                                (P(None, "seq"),) * 3, P(None, "seq"))(q, k, v))
    got = pool.run(J.ring, q, k, v, n_dev, n_past)
    np.testing.assert_allclose(np.concatenate(got[:n_dev], axis=1), ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("append", [False, True])
@pytest.mark.parametrize("n_dev", [2, 4])
def test_merged_attention(pool, append, n_dev):
    """Decode attention over the time-sharded cache, merged by pmax / psum:
    rows at their own positions; with the append block [current; pending]
    (3 of 4 valid) counted on rank 0 only."""
    B, T, H, KV, D, A = 2, 32, 8, 2, 32, 4
    rng = np.random.default_rng(7 + n_dev)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, D)).astype(np.float32)
    n_past = np.array([9, 27], np.int32)
    app = rng.standard_normal((2, B, A, KV, D)).astype(np.float32) if append else None
    valid = 3 if append else None

    def body(q, k, v, app=None):
        idx = jax.lax.axis_index("seq")
        return jsp.merged_attention(q, k, v, jnp.asarray(n_past), idx, T // n_dev, "seq",
                                    append=app, append_valid=valid)

    specs = (P(), P(None, "seq"), P(None, "seq")) + ((P(),) if append else ())
    args = (q, k, v) + ((app,) if append else ())
    ref = np.asarray(_shard_map(body, n_dev, specs, P())(*args))
    got = pool.run(J.merged, q, k, v, n_dev, n_past, app, valid)
    for r in got[:n_dev]:
        np.testing.assert_allclose(r, ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("mp", [2, 4])
def test_prefill_and_step_match(files, pool, mp):
    got1, got2, shape = R.same_on_ranks(
        pool.run(J.prefill_step, files["tiny"], mp, SP, PROMPT), mp)
    je = R.jax_engine(files["tiny"], mp, **SP)
    ref1 = np.asarray(je.eval(PROMPT))
    R.close(got1, ref1)
    R.close(got2, np.asarray(je.eval([int(np.argmax(ref1))])))
    assert shape[3] == je.kv_T // mp  # each rank holds kv_T / mp positions


def test_logits_all(files, pool):
    ids = [5, 17, 130, 42, 99, 260, 31, 7] * 2
    got = R.same_on_ranks(pool.run(J.logits_all, files["tiny"], 4, SP, ids), 4)
    R.close(got, np.asarray(R.jax_engine(files["tiny"], 4, **SP).eval(ids, logits_all=True)))


def test_multi_chunk_prefill(files, pool):
    """40 tokens at n_batch 16: three chunks, each padded to the ranks and
    written to the windows that own its positions."""
    ids = np.random.default_rng(0).integers(0, 512, size=40).tolist()
    got = R.same_on_ranks(pool.run(J.prefill_only, files["tiny"], 2, SP, ids), 2)
    R.close(got, np.asarray(R.jax_engine(files["tiny"], 2, **SP).eval(ids)))


def test_embed(files, pool):
    got = R.same_on_ranks(pool.run(J.embed, files["tiny"], 2, SP, PROMPT[:7]), 2)
    R.close(got, R.jax_engine(files["tiny"], 2, **SP).embed(PROMPT[:7]))
