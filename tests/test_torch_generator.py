"""The port's Generator (engine/generator.py), stop-string stream
(utils/stream.py) and finetune templates (utils/finetune.py) against the
JAX package's, on the CPU (the cases of tests/test_generator.py).

A tiny Falcon Q8_0 file written by the JAX package goes through both
engines at f32 (n_ctx 96): the port's Generator must give the JAX
Generator's ids exactly, through pipelined device chunks, through the host
route, across a context swap and over two turns; the device penalties must
give the host cascade's greedy ids. The host-code copies must agree with
the originals on the same inputs."""

import numpy as np
import pytest
import torch

from ggllm_tpu.core.config import EngineConfig, FalconHParams
from ggllm_tpu.core.dtypes import GGMLType
from ggllm_tpu.engine.engine import FalconEngine
from ggllm_tpu.engine.generator import Generator as JGenerator
from ggllm_tpu.io.ggcc import read_model
from ggllm_tpu.io.loader import load_params
from ggllm_tpu.ops.sampling import SamplerParams
from ggllm_tpu.utils import finetune as jfinetune
from ggllm_tpu.utils import stream as jstream
from ggllm_tpu.utils.synthetic import write_tiny_model

from ggllm_tpu_torch.core.config import EngineConfig as TEngineConfig
from ggllm_tpu_torch.engine.engine import FalconEngine as TFalconEngine
from ggllm_tpu_torch.engine.generator import Generator
from ggllm_tpu_torch.io.loader import load_model as tload_model
from ggllm_tpu_torch.ops import sampling as tsampling
from ggllm_tpu_torch.ops.sampling import SamplerParams as TSamplerParams
from ggllm_tpu_torch.tokenizer.bpe import Vocab as TVocab
from ggllm_tpu_torch.utils import finetune, stream
from ggllm_tpu_torch.utils.stream import StopStream

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("gen") / "tiny.ggcc")
    write_tiny_model(p, FalconHParams.tiny(), ftype_2d=GGMLType.Q8_0, seed=3)
    return p


@pytest.fixture(scope="module")
def make(path):
    """make("jax") / make("torch"): an engine of that package in its initial
    state (a fresh port engine; the module's one JAX engine, reset, so that
    each of its programs compiles once)."""
    mf = read_model(path)
    jcfg = EngineConfig(n_ctx=96, n_batch=32, kv_dtype="float32", compute_dtype="float32")
    tcfg = TEngineConfig(n_ctx=96, n_batch=32, kv_dtype="float32", compute_dtype="float32")
    tmf, tparams = tload_model(path, tcfg, device="cpu")
    jeng = FalconEngine(mf.hparams, load_params(mf, jcfg), jcfg)

    def _make(which):
        if which == "jax":
            jeng.reset()
            return jeng
        return TFalconEngine(tmf.hparams, tparams, tcfg, device="cpu")

    return _make


def _run(gen_cls, eng, sampler, turns, n, n_keep=0, fused_ok=True, stop_after=None):
    """Generate n tokens after each turn's prefill; returns (ids per turn,
    the generator)."""
    gen = gen_cls(eng, sampler, eos_id=-1, n_keep=n_keep, fused_ok=fused_ok)
    out = []
    for ids in turns:
        got = []

        def on_token(t):
            got.append(t)
            return stop_after is None or len(got) < stop_after

        gen.generate(gen.prefill(ids), n, on_token)
        out.append(got)
    return out, gen


PENALTY_SAMPLERS = [
    dict(temp=0.0),  # default penalties (rp=1.1)
    dict(temp=0.0, repeat_penalty=1.4, repeat_last_n=8),
    dict(temp=0.0, repeat_penalty=1.0, frequency_penalty=0.7, presence_penalty=0.4),
    dict(temp=0.0, penalize_nl=False),
    dict(temp=0.0, repeat_penalty=1.0, logit_bias={7: 100.0, 3: float("-inf")}),
]


@pytest.mark.parametrize("idx", range(len(PENALTY_SAMPLERS)))
def test_device_penalties_match_host_greedy_and_jax(make, idx):
    """The device cascade's penalties and bias give the host cascade's
    greedy ids (ops/sampling.py) and the JAX engine's."""
    kw = PENALTY_SAMPLERS[idx]
    prompt = [5, 17, 130, 42, 99]
    got = make("torch").generate(prompt, 20, TSamplerParams(**kw))
    assert got == make("jax").generate(prompt, 20, SamplerParams(**kw))
    eng, sampler = make("torch"), TSamplerParams(**kw)
    state, logits, hist, host = tsampling.SamplerState.init(sampler), None, list(prompt), []
    logits = eng.eval(prompt)
    for _ in range(20):
        tok = tsampling.sample(logits, hist, sampler, state, eng.cfg.n_ctx, nl_token=193)
        host.append(tok)
        hist.append(tok)
        logits = eng.eval([tok])
    assert got == host


def test_generator_matches_engine_generate(make):
    """Generator ids equal the engine's generate ids and the JAX
    Generator's; the last sampled token is pending, all else in the cache."""
    prompt = [5, 17, 130, 42]
    ref = make("torch").generate(prompt, 16, TSamplerParams(temp=0.0))
    eng = make("torch")
    (got,), gen = _run(Generator, eng, TSamplerParams(temp=0.0), [prompt], 16)
    (jgot,), _ = _run(JGenerator, make("jax"), SamplerParams(temp=0.0), [prompt], 16)
    assert got == ref == jgot
    assert gen.pending_feed == [got[-1]]
    assert eng.n_past == len(prompt) + len(got) - 1


@pytest.mark.parametrize("fused", [True, False], ids=["pipelined", "host_route"])
def test_generator_context_swap_continues_with_jax_ids(make, fused):
    """Generation far past n_ctx (96) continues through context swaps with
    n_keep 2, and the ids equal the JAX Generator's, on the pipelined device
    route and on the per-token host route (fused_ok=False)."""
    eng = make("torch")
    (got,), gen = _run(Generator, eng, TSamplerParams(temp=0.0), [list(range(5, 85))], 60,
                       n_keep=2, fused_ok=fused)
    jeng = make("jax")
    (ref,), jgen = _run(JGenerator, jeng, SamplerParams(temp=0.0), [list(range(5, 85))], 60,
                        n_keep=2, fused_ok=fused)
    assert got == ref and len(got) == 60
    assert gen.swapped and jgen.swapped
    assert eng.n_past == jeng.n_past <= eng.cfg.n_ctx
    assert gen.all_tokens == jgen.all_tokens


def test_generator_multi_turn_prefill(make):
    """Generate, prefill more input, generate again: the JAX Generator's ids,
    and the ids of one flat host run over the same history."""
    turns = [[5, 17, 130], [42, 99]]
    got, _ = _run(Generator, make("torch"), TSamplerParams(temp=0.0), turns, 6)
    ref, _ = _run(JGenerator, make("jax"), SamplerParams(temp=0.0), turns, 6)
    assert got == ref
    eng, sampler = make("torch"), TSamplerParams(temp=0.0)
    state, hist, flat = tsampling.SamplerState.init(sampler), [], []
    for ids in turns:
        hist.extend(ids)
        logits = eng.eval(ids)
        for _ in range(6):
            tok = tsampling.sample(logits, hist, sampler, state, eng.cfg.n_ctx, nl_token=193)
            flat.append(tok)
            hist.append(tok)
            logits = eng.eval([tok])
    assert got[0] + got[1] == flat


def test_generator_callback_stop_uncommits_like_jax(make):
    """on_token returning False inside a pipelined chunk: the ids, the
    stop reason and n_past (positions never consumed rolled back) equal the
    JAX Generator's; a second turn then continues identically."""
    turns = [[5, 17, 130, 42], [99]]
    got, gen = _run(Generator, make("torch"), TSamplerParams(temp=0.0), turns, 24, stop_after=7)
    ref, jgen = _run(JGenerator, make("jax"), SamplerParams(temp=0.0), turns, 24, stop_after=7)
    assert got == ref and [len(g) for g in got] == [7, 7]
    assert gen.eng.n_past == jgen.eng.n_past and gen.pending_feed == jgen.pending_feed


# ---------------------------------------------------------------- StopStream


def test_stopstream_holds_back_partial_stop():
    ss = StopStream(stops=[b"<|endoftext|>"])
    assert ss.push(b"hello ") == b"hello "
    assert ss.push(b"<|endo") == b""  # held: could become the stop string
    assert ss.push(b"world") == b"<|endoworld"  # not the stop after all
    assert not ss.stopped


def test_stopstream_suppresses_stopword():
    ss = StopStream(stops=[b"STOP"])
    assert ss.push(b"abc ST") == b"abc "
    assert ss.push(b"OP xyz") == b""
    assert ss.stop_reason == "stopword"
    assert ss.flush() == b""


def test_stopstream_antiprompt_is_emitted():
    ss = StopStream(antiprompts=[b"User:"])
    out = ss.push(b"hello User:")
    assert out == b"hello User:"
    assert ss.stop_reason == "antiprompt"


def test_stopstream_flush_releases_tail():
    ss = StopStream(stops=[b"XYZ"])
    assert ss.push(b"abcX") == b"abc"
    assert ss.flush() == b"X"


@pytest.mark.parametrize("seed", range(4))
def test_stream_matches_the_original(seed):
    """Random byte pieces over a small alphabet through both StopStreams
    (stopwords and antiprompts) and partial_stop: the same releases, stop
    reasons, matches and flushes."""
    rng = np.random.default_rng(seed)
    alpha = b"ab: XY"

    def word(n):
        return bytes(rng.choice(list(alpha), n))

    stops = [word(int(rng.integers(2, 4))) for _ in range(2)]
    antis = [word(int(rng.integers(2, 5)))]
    a, b = StopStream(stops, antis), jstream.StopStream(stops, antis)
    for _ in range(40):
        piece = word(int(rng.integers(0, 3)))
        assert a.push(piece) == b.push(piece)
        assert (a.stop_reason, a.stop_match) == (b.stop_reason, b.stop_match)
        assert stream.partial_stop(a.text, stops) == jstream.partial_stop(b.text, stops)
    assert a.flush() == b.flush()


def test_finetune_matches_the_original():
    """detect_finetune on paths and vocabularies of each flavor, every
    template with and without a system prompt, and every stopword list."""
    vocabs = [TVocab(id_to_token=[bytes([65 + i % 26]) for i in range(n)], scores=[0.0] * n,
                     merges=[]) for n in (512, 70144)]
    vocabs.append(TVocab(id_to_token=[b"<|prompter|>"] + [b"x"] * 40, scores=[0.0] * 41,
                         merges=[]))
    for p in ("m/falcon-7b.bin", "wizard-7b.ggcc", "oasst1-falcon.bin", "falcon-7b-instruct.bin"):
        for v in vocabs:
            assert finetune.detect_finetune(p, v) == jfinetune.detect_finetune(p, v)
    assert finetune.TEMPLATES == jfinetune.TEMPLATES
    assert finetune.SYSTEM_TEMPLATES == jfinetune.SYSTEM_TEMPLATES
    for name in list(jfinetune.TEMPLATES) + ["unknown"]:
        for system in (None, "", "be brief"):
            assert (finetune.build_prompt(name, "hi there", system)
                    == jfinetune.build_prompt(name, "hi there", system))
        assert finetune.finetune_stopwords(name) == jfinetune.finetune_stopwords(name)
