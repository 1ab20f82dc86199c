"""Decoding on the port's tensor-parallel engine (gloo CPU ranks, f32)
against the JAX tensor-parallel engine (tests/test_tp_fused.py's set-up):
greedy generate on Falcon MQA and LLaMA, chained decode_chunk and
decode_pipelined, the continuous batcher at B = 2 (prefill_rows /
decode_rows), and the int8 cache at mp 2 and 4 and with GQA. The ids are
the JAX engine's exactly and the same on every rank."""

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


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return R.write_models(tmp_path_factory.mktemp("tpd"), ("tiny", "tiny_gqa", "llama"))


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(4, workdir=str(tmp_path_factory.mktemp("ranks"))) as p:
        yield p


@pytest.mark.parametrize("name", ["tiny", "llama"])
def test_greedy_generate(files, pool, name):
    got = R.same_on_ranks(pool.run(J.generate, files[name], 2, {}, [5, 17, 130], 12), 2)
    assert got == R.jax_engine(files[name], 2).generate([5, 17, 130], n_predict=12,
                                                          sampler=JGREEDY)


def test_decode_chunk_and_pipelined(files, pool):
    """Chained 4-step decode_chunk calls and decode_pipelined give the JAX TP
    engine's decode_pipelined ids."""
    prompt = [5, 17, 130, 42]
    chained, piped = R.same_on_ranks(
        pool.run(J.decode_chunks, files["tiny"], 2, {}, prompt, 12, 4), 2)
    je = R.jax_engine(files["tiny"], 2)
    first = int(np.argmax(je.eval(prompt)))
    ref, _ = je.decode_pipelined(first, 12, 4, JGREEDY, last_tokens=prompt + [first])
    assert chained == piped == [int(t) for t in ref]


def test_batcher(files, pool):
    prompts = [[5, 17, 130], [42, 99], [260, 31, 7, 12]]
    got = R.same_on_ranks(pool.run(J.batcher, files["tiny"], 2, {}, prompts, 7, 4, 2), 2)
    b = JBatcher(R.jax_engine(files["tiny"], 2, batch=2), chunk=4)
    reqs = [b.submit(JRequest(prompt_ids=p, n_predict=7)) for p in prompts]
    b.run()
    assert got == [r.out for r in reqs]


@pytest.mark.parametrize("name,mp", [("tiny", 2), ("tiny", 4), ("tiny_gqa", 2)])
def test_int8_cache(files, pool, name, mp):
    """An int8 cache (codes and scales both split by K/V head for GQA):
    prefill logits and greedy ids against the JAX TP int8 engine."""
    prompt = [5, 17, 130]
    got_l = R.same_on_ranks(pool.run(J.prefill_only, files[name], mp, {"kv_dtype": "int8"},
                                     prompt), mp)
    got = R.same_on_ranks(pool.run(J.generate, files[name], mp, {"kv_dtype": "int8"},
                                   prompt, 12), mp)
    je = R.jax_engine(files[name], mp, kv_dtype="int8")
    R.close(got_l, np.asarray(je.eval(prompt)))
    je.reset()
    assert got == je.generate(prompt, n_predict=12, sampler=JGREEDY)


@pytest.mark.parametrize("extra", [
    ["--temp", "0.8", "--mirostat", "2", "-p", "the thing"],
    ["--temp", "0.8", "--top-k", "0", "--random-prompt"]], ids=["mirostat", "random_prompt"])
def test_cli_unseeded_host_draws_agree_on_ranks(files, pool, extra):
    """With no --seed, the host cascade's draws (mirostat, --top-k 0) and
    --random-prompt's choice are rank 0's on every rank: each rank prints
    the same text under one seed."""
    argv = ["-c", "64", "-b", "16", "--kv-dtype", "float32", "--compute-dtype", "float32",
            "--decode-chunk", "4", "--ignore-eos", "-n", "12", *extra]
    rc, text, seed = R.same_on_ranks(pool.run(J.cli_text, files["tiny"], 2, argv), 2)
    assert rc == 0 and seed >= 0 and len(text) > 0
