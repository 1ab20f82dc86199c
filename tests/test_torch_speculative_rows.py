"""The port's batched speculative rounds (ggllm_tpu_torch/engine/speculative.py
SpeculativeDecoder.generate_rows) on the CPU in f32, on tiny Falcon (Q8_0)
and LLaMA files written by the JAX package, a target and another random
model each, B = 3 rows, k = 3, R = 2 rounds a dispatch; the target on a
dense f32 cache, the draft on a dense or an int8 cache.

Each row's ids equal the port's single-stream speculative ids for that
prompt with the same draft, and the JAX engine's target-only greedy ids
(the JAX generate_rows, which stops every row at once, is not the
reference); a perfect draft is accepted throughout; a row that meets a stop
id or its context end ends alone, the other rows' ids unchanged, and every
cache write stays inside the cache; R rounds of the body equal the body
run R times from the same state."""

import numpy as np
import pytest
import torch

from ggllm_tpu.core.config import EngineConfig, FalconHParams
from ggllm_tpu.core.dtypes import GGMLType
from ggllm_tpu.engine.engine import FalconEngine
from ggllm_tpu.io.ggcc import read_model
from ggllm_tpu.io.loader import load_params
from ggllm_tpu.ops import sampling as jsampling
from ggllm_tpu.utils.synthetic import write_tiny_llama, write_tiny_model

from ggllm_tpu_torch.core.config import EngineConfig as TEngineConfig
from ggllm_tpu_torch.engine.engine import FalconEngine as TFalconEngine
from ggllm_tpu_torch.engine.speculative import SpeculativeDecoder
from ggllm_tpu_torch.io.loader import load_model as tload_model
from ggllm_tpu_torch.ops import kvcache
from ggllm_tpu_torch.ops.sampling import SamplerParams

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)

PROMPTS = [[5, 9, 2, 14, 3], [7], list(range(20, 31))]
B, K, R, N = 3, 3, 2, 16
GREEDY = dict(temp=0.0, repeat_penalty=1.0)
FAMILIES = ("falcon", "llama")
CACHES = ("float32", "int8")  # the draft's; the target's is float32


def _cfg(kvd, n_ctx=96):
    return dict(n_ctx=n_ctx, n_batch=16, kv_dtype=kvd, compute_dtype="float32")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("spec_rows")
    out = {}
    for which, seed in (("target", 3), ("other", 11)):
        out["falcon", which] = str(d / f"falcon-{which}.ggcc")
        write_tiny_model(out["falcon", which], FalconHParams.tiny(), ftype_2d=GGMLType.Q8_0,
                         seed=seed)
    for which, seed in (("target", 7), ("other", 19)):
        out["llama", which] = str(d / f"llama-{which}.ggjt")
        write_tiny_llama(out["llama", which], seed=seed)
    return out


@pytest.fixture(scope="module")
def make(files):
    """make(family, kv_dtype, which, batch=1, n_ctx=96): a fresh port engine
    over the loaded file ("target" or "other")."""
    loaded = {}

    def _make(family, kvd, which, batch=1, n_ctx=96):
        cfg = TEngineConfig(**_cfg(kvd, n_ctx))
        if (family, kvd, which) not in loaded:
            loaded[family, kvd, which] = tload_model(files[family, which], cfg, device="cpu")
        mf, params = loaded[family, kvd, which]
        return TFalconEngine(mf.hparams, params, cfg, device="cpu", batch_size=batch)

    return _make


@pytest.fixture(scope="module")
def jax_greedy(files):
    """The JAX engine's target-only greedy ids of each prompt (f32 cache),
    one engine a family."""
    out = {}
    for family in FAMILIES:
        mf = read_model(files[family, "target"])
        cfg = EngineConfig(**_cfg("float32"), kernel_layout=True)
        eng = FalconEngine(mf.hparams, load_params(mf, cfg), cfg)
        for i, p in enumerate(PROMPTS):
            eng.reset()
            out[family, i] = [int(t) for t in eng.generate(
                p, N, jsampling.SamplerParams(**GREEDY), stop_ids=set())]
    return out


def _pair(make, family, kvd, draft, batch=1, n_ctx=96):
    """(target on an f32 cache, draft on a `kvd` cache)."""
    return (make(family, "float32", "target", batch, n_ctx),
            make(family, kvd, draft, batch, n_ctx))


def _single(make, family, kvd, draft, prompt, n=N, n_ctx=96, stop_ids=None):
    """The port's single-stream speculative greedy ids of one prompt."""
    spec = SpeculativeDecoder(*_pair(make, family, kvd, draft, n_ctx=n_ctx), k=K,
                              rounds_per_dispatch=R)
    return spec.generate(prompt, n, SamplerParams(**GREEDY), stop_ids=stop_ids)


def _rows(make, family, kvd, draft, n_ctx=96):
    return SpeculativeDecoder(*_pair(make, family, kvd, draft, B, n_ctx), k=K,
                              rounds_per_dispatch=R)


@pytest.mark.parametrize("draft", ["other", "target"])
@pytest.mark.parametrize("kvd", CACHES)
@pytest.mark.parametrize("family", FAMILIES)
def test_rows_equal_single_stream_and_jax_greedy(make, jax_greedy, family, kvd, draft):
    """Every row's ids are the single stream's speculative ids of its prompt
    with the same draft and the JAX engine's target-only greedy ids; the
    target as its own draft on the same (f32) cache is accepted at every
    position."""
    spec = _rows(make, family, kvd, draft)
    got = spec.generate_rows(PROMPTS, N)
    for i, p in enumerate(PROMPTS):
        assert got[i] == _single(make, family, kvd, draft, p) == jax_greedy[family, i]
    st = spec.stats
    assert st.n_emitted == B * N and st.n_rounds > 0 and st.n_drafted == K * sum(
        len(a) for a in spec.last_rows["n_acc"])
    assert spec.target.timings.n_decode == B * N
    if draft == "target" and kvd == "float32":
        assert st.acceptance == 1.0
    assert spec._programs and spec.rows_graph() is None  # the CPU runs the body


@pytest.mark.parametrize("family", FAMILIES)
def test_a_row_at_a_stop_id_ends_alone(make, jax_greedy, family):
    """A stop id that only row 0's ids hold ends row 0 there (the id
    emitted); the other rows run on to N ids, unchanged, where the JAX
    generate_rows would have carried every row on or stopped them all."""
    refs = [jax_greedy[family, i] for i in range(B)]
    others = set(refs[1]) | set(refs[2])
    j, stop = next((j, t) for j, t in enumerate(refs[0]) if t not in others and j > 2)
    got = _rows(make, family, "float32", "other").generate_rows(PROMPTS, N, stop_ids={stop})
    assert got[0] == refs[0][:j + 1]
    assert got[1:] == refs[1:]
    assert got[0] == _single(make, family, "float32", "other", PROMPTS[0], stop_ids={stop})


@pytest.mark.parametrize("kvd", CACHES)
@pytest.mark.parametrize("family", FAMILIES)
def test_a_row_at_its_context_end_ends_alone(make, family, kvd):
    """With a 60-token context, a 44-token prompt can take fewer than N ids
    (a row stops where its position plus 2 R (k + 1) would pass the
    context, as the single stream's fused rounds do) while the short rows
    take N, unchanged; every row's device position ends inside the context
    and its writes inside the cache."""
    n_ctx = 60
    long = [int(t) for t in np.random.default_rng(5).integers(12, 500, 44)]
    prompts = [PROMPTS[0], long, PROMPTS[1]]
    spec = _rows(make, family, kvd, "other", n_ctx=n_ctx)
    got = spec.generate_rows(prompts, N)
    ref_long = _single(make, family, kvd, "other", long, n_ctx=n_ctx)
    assert 0 < len(got[1]) < N and got[1] == ref_long
    for i in (0, 2):
        assert got[i] == _single(make, family, kvd, "other", prompts[i], n_ctx=n_ctx)
        assert len(got[i]) == N
    n_past = spec.last_rows["n_past"]
    assert n_past.max() <= n_ctx and n_past.max() + K + 1 <= spec.target.kv_T
    lives = np.stack(spec.last_rows["live"])
    assert not lives[-1, 1] and lives[:, 0].sum() > lives[:, 1].sum()  # row 1 froze first


def _snapshot(spec, c):
    kv = [e.kv for e in (spec.target, spec.draft)]
    flat = [t.clone() for x in kv for t in (x if kvcache.is_quantized(x) else (x,))]
    return flat + [c.tok.clone(), c.n_past.clone(), c.live.clone()]


def _restore(spec, c, snap):
    kv = [e.kv for e in (spec.target, spec.draft)]
    dst = [t for x in kv for t in (x if kvcache.is_quantized(x) else (x,))]
    dst += [c.tok, c.n_past, c.live]
    for d, s in zip(dst, snap):
        d.copy_(s)


@pytest.mark.parametrize("kvd", CACHES)
@pytest.mark.parametrize("family", FAMILIES)
def test_rounds_equal_the_body_run_round_by_round(make, family, kvd):
    """From the same state (rows prefilled, one row frozen), R rounds of the
    body give the ids, n_acc, positions, tokens and both caches of the body
    run one round at a time R times; the frozen row moves nothing."""
    spec = _rows(make, family, kvd, "other")
    tgt, dr = spec.target, spec.draft
    for eng in (tgt, dr):
        eng.prefill_rows([0, 2], [PROMPTS[0][:-1], PROMPTS[2][:-1]], np.zeros(B, np.int64),
                         fetch_rows=set())
    c = spec._row_program()
    npv = np.asarray([len(p) - 1 for p in PROMPTS])
    spec._start_rows(c, [p[-1] for p in PROMPTS], npv, eager=True)
    c.live.copy_(torch.tensor([1, 0, 1], dtype=torch.int32))
    snap = _snapshot(spec, c)
    spec._rounds_rows(c, R)
    whole = _snapshot(spec, c) + [c.toks.clone(), c.n_acc.clone()]
    _restore(spec, c, snap)
    toks, n_acc = [], []
    for _ in range(R):
        spec._rounds_rows(c, 1)
        toks.append(c.toks[0].clone())
        n_acc.append(c.n_acc[0].clone())
    stepped = _snapshot(spec, c) + [torch.stack(toks), torch.stack(n_acc)]
    for a, b in zip(whole, stepped):
        assert torch.equal(a, b)
    assert int(c.n_past[1]) == npv[1] and int(c.tok[1]) == PROMPTS[1][-1]
    assert (c.n_acc[0, 1] == 0).all()
    assert (c.n_past[[0, 2]] > torch.from_numpy(npv[[0, 2]]).int()).all()


def test_rows_refuse_a_prompt_count_other_than_the_batch(make):
    spec = _rows(make, "falcon", "float32", "other")
    with pytest.raises(ValueError, match="one prompt a row"):
        spec.generate_rows(PROMPTS[:2], N)
    with pytest.raises(ValueError, match="needs a prompt"):
        spec.generate_rows([[1], [], [2]], N)
