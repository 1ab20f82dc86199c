"""Grammar rows in the port's continuous batcher (engine/batching.py over
FalconEngine(batch_size=B) decode_rows with per-row masks) against the
port's sequential Generator and the JAX package's batcher, on the CPU.

The case of tests/test_batching.py:212 on tiny Falcon and LLaMA files
written by the JAX package (f32): grammar rows and a plain row in one
batch give, greedy, the ids of the sequential Generator under the same
grammar (its masked device chunks and its host route) and the JAX
ContinuousBatcher's (computed once a module); the batch decodes one
masked step a chunk while a grammar row is live and whole chunks after.
A row whose grammar raises fails alone: the other rows finish with their
ids, which the JAX scheduler, dying on the first GrammarError
(ggllm_tpu/engine/batching.py:371), does not give."""

import pytest
import torch

from ggllm_tpu.core.config import EngineConfig, FalconHParams, LlamaHParams
from ggllm_tpu.core.dtypes import GGMLType
from ggllm_tpu.engine.batching import ContinuousBatcher as JBatcher, Request as JRequest
from ggllm_tpu.engine.engine import FalconEngine as JEngine
from ggllm_tpu.io.ggcc import read_model
from ggllm_tpu.io.loader import load_params
from ggllm_tpu.ops import grammar as jgrammar
from ggllm_tpu.utils import synthetic as jsynthetic

from ggllm_tpu_torch.core.config import EngineConfig as TEngineConfig
from ggllm_tpu_torch.engine.batching import ContinuousBatcher, Request
from ggllm_tpu_torch.engine.engine import FalconEngine
from ggllm_tpu_torch.engine.generator import Generator
from ggllm_tpu_torch.io.loader import load_model
from ggllm_tpu_torch.ops import grammar
from ggllm_tpu_torch.ops.sampling import SamplerParams

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)

PROMPTS = [[5, 17, 130, 42], [300, 301, 302, 303, 304, 305, 306, 307, 308, 309], [7, 8],
           [100, 200, 300, 400, 150]]
DIGITS = "root ::= [0-9]+"
EOS = {"falcon": 11, "llama": 2}
N_PREDICT = 10
# rows 0 and 2 under the digit grammar, row 1 plain, row 3 (queued behind
# them) plain: it is admitted while a grammar row is live
GRAMMAR_ROWS = (0, 2)


def _cfg(cls):
    return cls(n_ctx=96, n_batch=16, kv_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("batching_grammar")
    falcon, llama = str(d / "falcon.ggcc"), str(d / "llama.ggjt")
    jsynthetic.write_tiny_model(falcon, FalconHParams.tiny(), ftype_2d=GGMLType.Q8_0, seed=17)
    jsynthetic.write_tiny_llama(llama, LlamaHParams.tiny(), ftype_2d=GGMLType.Q8_0, seed=23)
    return {"falcon": falcon, "llama": llama}


def _bias(family):
    return {EOS[family]: float("-inf")}  # digit runs as long as n_predict


def _requests(req_cls, g_mod, vocab, family):
    out = []
    for i, p in enumerate(PROMPTS):
        gs = (g_mod.GrammarSampler(g_mod.parse_gbnf(DIGITS), vocab.id_to_token, EOS[family])
              if i in GRAMMAR_ROWS else None)
        out.append(req_cls(list(p), n_predict=N_PREDICT, temp=0.0, repeat_penalty=1.0,
                           logit_bias=_bias(family), grammar_sampler=gs))
    return out


@pytest.fixture(scope="module")
def jax_ids(files):
    """The JAX ContinuousBatcher's greedy ids (3 rows, chunk 4), once a
    module per family."""
    out = {}
    for family, path in files.items():
        mf = read_model(path)
        cfg = _cfg(EngineConfig)
        cb = JBatcher(JEngine(mf.hparams, load_params(mf, cfg), cfg, batch_size=3), chunk=4)
        reqs = [cb.submit(r) for r in _requests(JRequest, jgrammar, mf.vocab, family)]
        cb.run()
        out[family] = [r.out for r in reqs]
    return out


def _sequential(mf, params, family, i, device: bool):
    """Request i through the port's single-stream Generator."""
    eng = FalconEngine(mf.hparams, params, _cfg(TEngineConfig), device="cpu")
    gs = (grammar.GrammarSampler(grammar.parse_gbnf(DIGITS), mf.vocab.id_to_token, EOS[family])
          if i in GRAMMAR_ROWS else None)
    gen = Generator(eng, SamplerParams(temp=0.0, repeat_penalty=1.0, logit_bias=_bias(family)),
                    EOS[family], grammar=gs)
    gen.grammar_device = gen.grammar_device and device
    toks = []
    gen.generate(gen.prefill(PROMPTS[i]), N_PREDICT, lambda t: toks.append(t) or True)
    return toks


@pytest.mark.parametrize("family", ["falcon", "llama"])
def test_grammar_rows_match_sequential_and_jax(files, jax_ids, family):
    """Grammar rows and plain rows through 3 rows (chunk 4): every request's
    ids equal the sequential Generator's (masked device chunks and host
    route) and the JAX batcher's; the grammar rows' ids are digits; the
    batch ran masked 1-step chunks and unmasked 4-step ones."""
    mf, params = load_model(files[family], _cfg(TEngineConfig), device="cpu")
    eng = FalconEngine(mf.hparams, params, _cfg(TEngineConfig), device="cpu", batch_size=3)
    cb = ContinuousBatcher(eng, chunk=4)
    reqs = [cb.submit(r) for r in _requests(Request, grammar, mf.vocab, family)]
    cb.run()
    assert all(r.done and r.error is None and len(r.out) == N_PREDICT for r in reqs)
    got = [r.out for r in reqs]
    assert got == jax_ids[family]
    for i, ids in enumerate(got):
        assert ids == _sequential(mf, params, family, i, True)
        if i in GRAMMAR_ROWS:
            assert ids == _sequential(mf, params, family, i, False)
            assert all(mf.vocab.id_to_token[t].isdigit() for t in ids)
    keys = {(k[1], k[2].masked) for k in eng._chunks if k[0] == "rows"}
    assert keys == {(1, True), (4, False)}, keys


class _FailsOnThirdAccept(grammar.GrammarSampler):
    """A grammar whose third accepted id raises, as when a mask let through
    an id the grammar refuses."""

    n = 0

    def accept(self, token_id):
        self.n += 1
        if self.n == 3:
            raise grammar.GrammarError(f"token {token_id} violates the grammar")
        super().accept(token_id)


class _DeadEnd(grammar.GrammarSampler):
    """A grammar that reaches a state no token extends after two ids."""

    n = 0

    def accept(self, token_id):
        self.n += 1
        super().accept(token_id)

    def valid_bits(self):
        if self.n >= 2:
            raise grammar.GrammarError("no vocabulary token can extend the grammar")
        return super().valid_bits()


@pytest.mark.parametrize("cls", [_FailsOnThirdAccept, _DeadEnd])
def test_a_row_whose_grammar_raises_fails_alone(files, cls):
    """A grammar that raises (in accept or in valid_bits) fails its request
    alone: Request.error is the GrammarError, its slot is freed, and the
    other rows (a grammar row and a plain row) and a queued request finish
    with their ids of the batch without the failing row."""
    mf, params = load_model(files["falcon"], _cfg(TEngineConfig), device="cpu")
    vocab = mf.vocab

    def run(bad: bool):
        eng = FalconEngine(mf.hparams, params, _cfg(TEngineConfig), device="cpu", batch_size=3)
        cb = ContinuousBatcher(eng, chunk=4)
        reqs = _requests(Request, grammar, vocab, "falcon")
        if bad:
            reqs[0].grammar_sampler = cls(grammar.parse_gbnf(DIGITS), vocab.id_to_token, 11)
        reqs = [cb.submit(r) for r in reqs]
        cb.run()
        assert not cb.active and not cb.queue
        return reqs

    bad, ref = run(True), run(False)
    assert isinstance(bad[0].error, grammar.GrammarError) and bad[0].done
    assert len(bad[0].out) == 2 and bad[0].out == ref[0].out[:2]
    assert [r.out for r in bad[1:]] == [r.out for r in ref[1:]]
    assert all(r.error is None for r in bad[1:])
