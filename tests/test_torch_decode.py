"""The port's decode path (engine/engine.py decode_chunk, decode_pipelined,
generate) against the JAX engine's fused decode loop, on the CPU.

Tiny files of both families written by the JAX package go through both
engines (JAX: f32 compute, Pallas kernels in interpret mode; the port: the
kernels' plain versions). On the CPU the port runs the step body that the
card captures in a CUDA graph: n_past, the ring position and the first
token lie in device tensors, the cache is written by indexed copies, the
draw's uniforms come from one launch a chunk. Greedy ids must equal the
JAX engine's exactly, on dense and int8 caches, across a chunk boundary and
after a rollback. decode_pipelined must equal chained decode_chunk calls
(greedy and sampled on the port's own generator; the tests/
test_engine_fused.py:112 and :142 cases), and its greedy ids the JAX
decode_pipelined ids. reset() must keep the cache's storage."""

import numpy as np
import pytest
import torch

from ggllm_tpu.core.config import EngineConfig, FalconHParams, LlamaHParams
from ggllm_tpu.core.dtypes import GGMLType
from ggllm_tpu.engine.engine import FalconEngine
from ggllm_tpu.io.ggcc import read_model
from ggllm_tpu.io.loader import load_params
from ggllm_tpu.ops.sampling import SamplerParams
from ggllm_tpu.utils import synthetic as jsynthetic

from ggllm_tpu_torch.core.config import EngineConfig as TEngineConfig
from ggllm_tpu_torch.engine.engine import FalconEngine as TFalconEngine
from ggllm_tpu_torch.io.loader import load_model as tload_model
from ggllm_tpu_torch.kernels import build
from ggllm_tpu_torch.ops import kvcache
from ggllm_tpu_torch.ops.sampling import SamplerParams as TSamplerParams

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)

PROMPT = [5, 17, 130, 42, 99, 260, 31, 7]


def _jax_cfg(kv_dtype):
    return EngineConfig(n_ctx=96, n_batch=32, kv_dtype=kv_dtype, compute_dtype="float32",
                        kernel_layout=True, flash_attention=True)


def _torch_cfg(kv_dtype):
    return TEngineConfig(n_ctx=96, n_batch=32, kv_dtype=kv_dtype, compute_dtype="float32")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("decode")
    falcon, llama = str(d / "falcon.ggcc"), str(d / "llama.ggjt")
    jsynthetic.write_tiny_model(falcon, FalconHParams.tiny(), ftype_2d=GGMLType.Q8_0, seed=11)
    jsynthetic.write_tiny_llama(llama, LlamaHParams.tiny(), ftype_2d=GGMLType.Q4_0, seed=21)
    return {"falcon": falcon, "llama": llama}


_JAX_ENGINES = {}  # (path, kv_dtype) -> one JAX engine, so each of its programs compiles once


def _engines(files, family, kv_dtype, jax_too=True):
    """A fresh port engine and (jax_too) the module's JAX engine of the same
    file and cache, reset."""
    path = files[family]
    tmf, params = tload_model(path, _torch_cfg(kv_dtype), device="cpu")
    teng = TFalconEngine(tmf.hparams, params, _torch_cfg(kv_dtype), device="cpu")
    if not jax_too:
        return None, teng
    if (path, kv_dtype) not in _JAX_ENGINES:
        mf = read_model(path)
        _JAX_ENGINES[path, kv_dtype] = FalconEngine(mf.hparams, load_params(mf, _jax_cfg(kv_dtype)),
                                                    _jax_cfg(kv_dtype))
    jeng = _JAX_ENGINES[path, kv_dtype]
    jeng.reset()
    return jeng, teng


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("family", ["falcon", "llama"])
def test_decode_chunks_match_jax_across_a_boundary_and_a_rollback(files, family, kv_dtype):
    """Two chained 8-token chunks, then a rollback into the second chunk and
    another chunk from there: the greedy ids (default penalties, applied on
    the device) and n_past equal the JAX engine's decode_chunk."""
    jeng, teng = _engines(files, family, kv_dtype)
    first = int(np.argmax(jeng.eval(PROMPT)))
    assert int(np.argmax(teng.eval(PROMPT))) == first
    greedy, tgreedy = SamplerParams(temp=0.0), TSamplerParams(temp=0.0)
    hist, ref, got = PROMPT + [first], [], []
    tok = first
    for _ in range(2):
        r, _ = jeng.decode_chunk(tok, 8, greedy, last_tokens=hist)
        g, _ = teng.decode_chunk(tok, 8, tgreedy, last_tokens=hist)
        ref.append([int(t) for t in r])
        got.append([int(t) for t in g])
        hist = hist + ref[-1]
        tok = ref[-1][-1]
    assert got == ref and teng.n_past == jeng.n_past == len(PROMPT) + 16
    back = len(PROMPT) + 12  # forwarded: the prompt, first, 8 ids, 3 of the second chunk
    jeng.rollback(back)
    teng.rollback(back)
    hist = PROMPT + [first] + ref[0] + ref[1][:4]
    r, _ = jeng.decode_chunk(ref[1][3], 8, greedy, last_tokens=hist)
    g, _ = teng.decode_chunk(ref[1][3], 8, tgreedy, last_tokens=hist)
    assert [int(t) for t in g] == [int(t) for t in r]
    assert r[:4].tolist() == ref[1][4:] and teng.n_past == jeng.n_past == back + 8


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_pipelined_matches_chained_chunks(files, kv_dtype):
    """decode_pipelined == chained decode_chunk calls exactly (same ids, same
    final n_past), greedy and sampled on the port's own generator (tests/
    test_engine_fused.py:112)."""
    prompt = [5, 17, 130, 42, 99]
    for sampler in (TSamplerParams(temp=0.0, repeat_penalty=1.0),
                    TSamplerParams(temp=0.9, top_k=40, seed=7)):
        _, eng_a = _engines(files, "falcon", kv_dtype, jax_too=False)
        first = int(np.argmax(eng_a.eval(prompt)))
        chained, tok, gen, window = [], first, None, prompt + [first]
        for _ in range(4):
            toks, gen = eng_a.decode_chunk(tok, 4, sampler, gen, last_tokens=window)
            chained.extend(int(t) for t in toks)
            window.extend(int(t) for t in toks)
            tok = int(toks[-1])

        _, eng_b = _engines(files, "falcon", kv_dtype, jax_too=False)
        eng_b.eval(prompt)
        chunks = []
        piped, gen_b = eng_b.decode_pipelined(first, 16, 4, sampler, last_tokens=prompt + [first],
                                              on_tokens=lambda a: chunks.append(a))
        assert [int(t) for t in piped] == chained
        assert [len(c) for c in chunks] == [4, 4, 4, 4]
        assert eng_b.n_past == eng_a.n_past == len(prompt) + 16
        assert torch.equal(gen_b.get_state(), gen.get_state())
    assert len(set(chained)) > 1


def test_samplers_differing_in_values_share_one_chunk_key(files):
    """Samplers that differ only in temperature, top-p, penalty or bias
    values map to one chunk key (one program: one CUDA graph on the card),
    and each gives, through that one shared program, the ids of a fresh
    engine's eager run with that sampler alone. What changes the step's
    shapes or branches makes another key: greedy, the candidate count, top-p
    cutting or not, a penalty on or off, penalize_nl, the ring length, the
    bias count."""
    from ggllm_tpu_torch.engine import engine as tengine

    base = dict(temp=0.7, top_k=40, top_p=0.9, repeat_penalty=1.1, logit_bias={3: 1.5}, seed=5)
    variants = [base, {**base, "temp": 0.95}, {**base, "top_p": 0.6},
                {**base, "repeat_penalty": 1.4, "frequency_penalty": 0.3,
                 "presence_penalty": 0.2},
                {**base, "logit_bias": {9: -3.0}}]
    prompt = [5, 17, 130, 42, 99]
    _, eng = _engines(files, "falcon", "float32", jax_too=False)
    keys = {eng._key(8, TSamplerParams(**kw)) for kw in variants}
    assert len(keys) == 1
    for change in ({"temp": 0.0}, {"top_k": 20}, {"top_p": 1.0}, {"repeat_penalty": 1.0},
                   {"penalize_nl": False}, {"repeat_last_n": 32}, {"logit_bias": {}}):
        assert eng._key(8, TSamplerParams(**{**base, **change})) not in keys, change
    first = int(np.argmax(eng.eval(prompt)))
    start, runs = eng.n_past, []
    for kw in variants:
        eng.rollback(start)
        ids, _ = eng.decode_pipelined(first, 16, 8, TSamplerParams(**kw),
                                      last_tokens=prompt + [first])
        _, fresh = _engines(files, "falcon", "float32", jax_too=False)
        fresh.eval(prompt)
        ref, gen = [], None
        for _ in range(2):
            toks, gen = fresh.decode_chunk(([first] + ref)[-1], 8, TSamplerParams(**kw), gen,
                                           last_tokens=prompt + [first] + ref, eager=True)
            ref += [int(t) for t in toks]
        assert ids.tolist() == ref, kw
        runs.append(tuple(ref))
    assert len(eng._chunks) == 1 and len(set(runs)) == len(runs)
    # at most MAX_CHUNKS programs are kept, the least recently used out
    for top_k in range(1, tengine.MAX_CHUNKS + 2):
        eng.rollback(start)
        eng.decode_chunk(first, 1, TSamplerParams(**{**base, "top_k": top_k}),
                         last_tokens=prompt + [first])
    assert len(eng._chunks) == tengine.MAX_CHUNKS and next(iter(keys)) not in eng._chunks
    assert eng._key(1, TSamplerParams(**{**base, "top_k": 1})) not in eng._chunks


def test_pipelined_early_stop_advances_then_rolls_back(files):
    """on_tokens returning False after the first fetched chunk: two chunks
    were enqueued, so n_past has advanced by two; rollback discards the
    second (tests/test_engine_fused.py:142). The generator is set back to
    its state after the consumed chunk's draw."""
    prompt = [5, 17, 130, 42]
    _, eng = _engines(files, "falcon", "float32", jax_too=False)
    first = int(np.argmax(eng.eval(prompt)))
    base = eng.n_past
    seen = []

    def on_tokens(a):
        seen.append(a)
        return False

    sampler = TSamplerParams(temp=0.8, top_k=40, seed=3)
    gen = eng.new_generator(sampler)
    ref_gen = eng.new_generator(sampler)
    ref_gen.set_state(gen.get_state())
    out, gen = eng.decode_pipelined(first, 16, 4, sampler, gen, last_tokens=prompt + [first],
                                    on_tokens=on_tokens)
    assert len(out) == 4 and len(seen) == 1
    assert eng.n_past == base + 8
    eng.rollback(base + 4)
    assert eng.n_past == base + 4
    torch.empty(4).uniform_(generator=ref_gen)  # the one consumed chunk's draw: a uniform a token
    assert torch.equal(gen.get_state(), ref_gen.get_state())


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_pipelined_tail_runs_a_whole_chunk_and_drops_the_surplus(files, kv_dtype):
    """n_total = 10 in chunks of 4: the third chunk runs all 4 steps through
    the same chunk key and its last 2 ids are dropped. Greedy ids and n_past
    equal chained decode_chunk calls of 4, 4 and 2 steps (also on an int8
    cache, where a chunk's end quantizes its K/V), and so does the next
    chunk, which overwrites the surplus positions. Sampled ids are the first
    10 of a 12-token run on the same seed. An early stop leaves n_past at
    most n_total past the start, and a surplus past the cache raises."""
    greedy = TSamplerParams(temp=0.0, repeat_penalty=1.0)
    _, eng_a = _engines(files, "falcon", kv_dtype, jax_too=False)
    first = int(np.argmax(eng_a.eval(PROMPT)))
    chained, tok = [], first
    for n in (4, 4, 2, 4):
        toks, _ = eng_a.decode_chunk(tok, n, greedy, last_tokens=PROMPT + [first] + chained)
        chained += [int(t) for t in toks]
        tok = chained[-1]

    _, eng_b = _engines(files, "falcon", kv_dtype, jax_too=False)
    eng_b.eval(PROMPT)
    chunks = []
    piped, _ = eng_b.decode_pipelined(first, 10, 4, greedy, last_tokens=PROMPT + [first],
                                      on_tokens=chunks.append)
    assert [len(c) for c in chunks] == [4, 4, 2] and eng_b.n_past == len(PROMPT) + 10
    nxt, _ = eng_b.decode_chunk(int(piped[-1]), 4, greedy,
                                last_tokens=PROMPT + [first] + piped.tolist())
    assert piped.tolist() + nxt.tolist() == chained and len(eng_b._chunks) == 1

    sampler = TSamplerParams(temp=0.9, top_k=40, seed=7)
    runs = []
    for n_total in (10, 12):
        eng_b.rollback(len(PROMPT))
        runs.append(eng_b.decode_pipelined(first, n_total, 4, sampler,
                                           last_tokens=PROMPT + [first])[0].tolist())
    assert runs[0] == runs[1][:10] and len(set(runs[1])) > 1

    eng_b.rollback(len(PROMPT))
    out, _ = eng_b.decode_pipelined(first, 6, 4, greedy, last_tokens=PROMPT + [first],
                                    on_tokens=lambda a: False)
    assert out.tolist() == chained[:4] and eng_b.n_past == len(PROMPT) + 6
    with pytest.raises(ValueError, match="run past the cache"):
        eng_b.decode_pipelined(first, 1, eng_b.kv_T, greedy)


@pytest.mark.parametrize("family", ["falcon", "llama"])
def test_pipelined_greedy_matches_jax(files, family):
    """Greedy ids of decode_pipelined (16 tokens in chunks of 4, default
    penalties) equal the JAX engine's decode_pipelined ids."""
    jeng, teng = _engines(files, family, "float32")
    first = int(np.argmax(jeng.eval(PROMPT)))
    teng.eval(PROMPT)
    ref, _ = jeng.decode_pipelined(first, 16, 4, SamplerParams(temp=0.0),
                                   last_tokens=PROMPT + [first])
    got, _ = teng.decode_pipelined(first, 16, 4, TSamplerParams(temp=0.0),
                                   last_tokens=PROMPT + [first])
    assert got.tolist() == [int(t) for t in ref] and teng.n_past == jeng.n_past


def test_generate_stops_and_rolls_back_like_jax(files):
    """generate routes device-samplable settings through decode_pipelined:
    with a stop id inside the second chunk the ids end at it and n_past
    counts only the forwarded tokens, as the JAX engine's generate."""
    jeng, teng = _engines(files, "falcon", "float32")
    free = jeng.generate(PROMPT, 24, SamplerParams(temp=0.0))
    stop = free[6]
    jeng.reset()
    ref = jeng.generate(PROMPT, 24, SamplerParams(temp=0.0), stop_ids={stop})
    got = teng.generate(PROMPT, 24, TSamplerParams(temp=0.0), stop_ids={stop})
    assert got == ref and got[-1] == stop and len(got) < 24
    assert teng.n_past == len(PROMPT) + len(got) - 1


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_reset_keeps_the_cache_storage(files, kv_dtype):
    """reset() zeroes the cache in place (codes 0, scales 1): the data
    pointers that captured graphs hold stay valid, and a decode after it
    gives a fresh engine's ids. Assigning a new cache drops the chunks."""
    _, eng = _engines(files, "falcon", kv_dtype, jax_too=False)
    tensors = eng.kv if isinstance(eng.kv, tuple) else (eng.kv,)
    ptrs = [t.data_ptr() for t in tensors]
    ids = eng.generate(PROMPT, 12, TSamplerParams(temp=0.0))
    assert eng._chunks and any(bool(t.any()) for t in tensors[:1])
    eng.reset()
    assert [t.data_ptr() for t in tensors] == ptrs and eng.n_past == 0
    assert not bool(tensors[0].any())
    if kv_dtype == "int8":
        assert bool((tensors[1] == 1).all())
    assert eng.generate(PROMPT, 12, TSamplerParams(temp=0.0)) == ids
    eng.kv = kvcache.new(tuple(tensors[0].shape), kv_dtype, "cpu")
    assert not eng._chunks


def test_device_position_writes_match_int_writes():
    """write_layer / write_all_layers at a (1,) device n_past write what the
    int form writes, dense and int8."""
    g = torch.Generator().manual_seed(0)
    shape = (3, 2, 1, 20, 2, 8)
    for kv_dtype in ("float32", "int8"):
        a, b = kvcache.new(shape, kv_dtype, "cpu"), kvcache.new(shape, kv_dtype, "cpu")
        new1 = torch.randn(2, 1, 1, 2, 8, generator=g)
        new4 = torch.randn(3, 2, 1, 4, 2, 8, generator=g)
        kvcache.write_layer(a, new1, 1, 7)
        kvcache.write_layer(b, new1, 1, torch.tensor([7], dtype=torch.int32))
        kvcache.write_all_layers(a, new4, 11)
        kvcache.write_all_layers(b, new4, torch.tensor([11], dtype=torch.int32))
        for x, y in zip(a if kv_dtype == "int8" else (a,), b if kv_dtype == "int8" else (b,)):
            assert torch.equal(x, y)


def test_graph_credits_its_counts_per_replay(monkeypatch):
    """build.Graph takes the launches counted while it captured back off
    launch_counts (a capture launches nothing) and adds them once per
    replay, under the same names."""
    replays = []

    class FakeGraph:
        def __init__(self, keep_graph=False):
            pass

        def instantiate(self):
            pass

        def replay(self):
            replays.append(1)

    class FakeCapture:
        def __init__(self, graph, pool=None, stream=None):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", FakeCapture)
    monkeypatch.setattr(build, "launch_counts", build.launch_counts.__class__({"gemv": 5}))
    graph = build.Graph()
    with graph.capture():
        build.launch_counts.update({"gemv": 3, "flash_decode": 2})
    assert graph.counts == {"gemv": 3, "flash_decode": 2}
    assert dict(build.launch_counts) == {"gemv": 5}
    graph.replay()
    graph.replay()
    assert len(replays) == 2 and dict(build.launch_counts) == {"gemv": 11, "flash_decode": 4}
