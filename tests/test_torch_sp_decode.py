"""Decoding on the port's sequence-parallel engine (gloo CPU ranks, f32)
against the JAX sequence-parallel engine (tests/test_seq_parallel.py's
set-up): greedy generate, chained decode_chunk and decode_pipelined, the
continuous batcher at B = 2 (per-row ring-attention prefill; the int8 rows
chunk-deferred, the appended block counted on rank 0), and the int8 cache
at mp 2 and 4. The ids are the JAX engine's exactly and the same on every
rank."""

import numpy as np
import pytest
import torch

from tests import torch_parallel_jobs as J
from tests import torch_parallel_ref as R
from ggllm_tpu.engine.batching import ContinuousBatcher as JBatcher, Request as JRequest
from ggllm_tpu.ops import sampling as jsampling
from ggllm_tpu_torch.parallel.mesh import RankPool

torch.set_num_threads(1)

JGREEDY = jsampling.SamplerParams(temp=0.0, repeat_penalty=1.0)
SP = {"kv_shard": "sequence"}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return R.write_models(tmp_path_factory.mktemp("spd"), ("tiny",))


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(4, workdir=str(tmp_path_factory.mktemp("ranks"))) as p:
        yield p


def test_greedy_generate(files, pool):
    got = R.same_on_ranks(pool.run(J.generate, files["tiny"], 2, SP, [5, 17, 130], 12), 2)
    assert got == R.jax_engine(files["tiny"], 2, **SP).generate([5, 17, 130], n_predict=12,
                                                                  sampler=JGREEDY)


def test_decode_chunk_and_pipelined(files, pool):
    prompt = [5, 17, 130, 42]
    chained, piped = R.same_on_ranks(
        pool.run(J.decode_chunks, files["tiny"], 2, SP, prompt, 12, 4), 2)
    je = R.jax_engine(files["tiny"], 2, **SP)
    first = int(np.argmax(je.eval(prompt)))
    ref, _ = je.decode_pipelined(first, 12, 4, JGREEDY, last_tokens=prompt + [first])
    assert chained == piped == [int(t) for t in ref]


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_batcher(files, pool, kv_dtype):
    prompts = [[5, 17, 130, 42], [300, 301, 302, 303, 304, 305], [7]]
    kw = {**SP, "kv_dtype": kv_dtype}
    got = R.same_on_ranks(pool.run(J.batcher, files["tiny"], 2, kw, prompts, 14, 6, 2), 2)
    b = JBatcher(R.jax_engine(files["tiny"], 2, batch=2, **kw), chunk=6)
    reqs = [b.submit(JRequest(p, n_predict=14)) for p in prompts]
    b.run()
    assert got == [r.out for r in reqs]


@pytest.mark.parametrize("mp", [2, 4])
def test_int8_cache(files, pool, mp):
    """Codes and scales both split along time: prefill logits and greedy
    ids against the JAX SP int8 engine."""
    kw = {**SP, "kv_dtype": "int8"}
    prompt = [5, 17, 130, 42, 99, 260, 31, 7, 12, 77]
    got_l, _, shape = R.same_on_ranks(pool.run(J.prefill_step, files["tiny"], mp, kw, prompt),
                                      mp)
    got = R.same_on_ranks(pool.run(J.generate, files["tiny"], mp, kw, prompt[:3], 12), mp)
    je = R.jax_engine(files["tiny"], mp, **kw)
    R.close(got_l, np.asarray(je.eval(prompt)))
    assert shape[3] == je.kv_T // mp
    je.reset()
    assert got == je.generate(prompt[:3], n_predict=12, sampler=JGREEDY)
