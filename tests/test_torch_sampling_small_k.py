"""The port's stochastic cascade at top-k caps of 1 and 2, on the CPU.

A candidate slice of one or two entries leaves the tail-free step nothing to
cut (it needs three kept entries), so the port skips it there. The JAX
package's row sampler and its speculative rounds raise at these caps
(ggllm_tpu/ops/sampling_device.py takes an argmax over a zero-width slice);
the reference is the JAX host cascade (ops/sampling.py cascade_probs), which
handles them. Held here:
  * cascade_mask_probs at widths 1 and 2 (one or two candidates a row), with
    and without tail-free, typical and top-p, against cascade_probs at the
    same top_k within 1e-6;
  * speculative decoding at temp 0.8 and top-k 1 (fused and host rounds)
    gives the JAX engine's greedy ids, on tiny Falcon and LLaMA files;
  * at top-k 2 each fused round equals its float64 replay (replay_round);
  * a ContinuousBatcher with cap 1 gives the JAX engine's greedy single
    streams.
"""

import numpy as np
import pytest
import torch

from ggllm_tpu.core.config import EngineConfig, FalconHParams
from ggllm_tpu.core.dtypes import GGMLType
from ggllm_tpu.engine.engine import FalconEngine as JEngine
from ggllm_tpu.io.ggcc import read_model
from ggllm_tpu.io.loader import load_params
from ggllm_tpu.ops import sampling as jsampling
from ggllm_tpu.utils.synthetic import write_tiny_llama, write_tiny_model

from ggllm_tpu_torch.core.config import EngineConfig as TEngineConfig
from ggllm_tpu_torch.engine.batching import ContinuousBatcher, Request
from ggllm_tpu_torch.engine.engine import FalconEngine
from ggllm_tpu_torch.engine.speculative import SpeculativeDecoder, replay_round
from ggllm_tpu_torch.io.loader import load_model
from ggllm_tpu_torch.ops.sampling import SamplerParams
from ggllm_tpu_torch.ops.sampling_device import cascade_mask_probs, cascade_rows

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)

V = 64
PROMPT = [5, 9, 2, 14, 3]
N = 16
# every truncation on, at a temperature: the settings that reached the
# zero-width tail-free slice
CUTS = dict(temp=0.8, top_p=0.9, tfs_z=0.9, typical_p=0.9, repeat_penalty=1.0)

KNOBS = {
    "none": dict(),
    "tfs": dict(tfs_z=0.5),
    "typical": dict(typical_p=0.3),
    "top_p": dict(top_p=0.4),
    "all": dict(tfs_z=0.5, typical_p=0.6, top_p=0.5),
}


@pytest.mark.parametrize("temp", [0.6, 1.3])
@pytest.mark.parametrize("knobs", list(KNOBS), ids=list(KNOBS))
@pytest.mark.parametrize("width", [1, 2])
def test_cascade_matches_the_host_cascade(width, knobs, temp):
    """Rows of one and of two candidates over a slice of width 1 or 2: the
    port's probabilities over the slice equal the JAX host cascade's at the
    same top_k (0 off the slice), with the tail-free knob passed as a tensor
    (on or off) or as None."""
    rng = np.random.default_rng(width * 100 + len(knobs))
    kw = dict(temp=temp, repeat_penalty=1.0, top_p=1.0, tfs_z=1.0, typical_p=1.0)
    kw.update(KNOBS[knobs])
    for row_k in range(1, width + 1):
        for trial in range(4):
            logits = (rng.standard_normal(V) * (1 + trial)).astype(np.float32)
            ids = np.argsort(-logits, kind="stable")[:width]
            vals = torch.from_numpy(logits[ids].copy())[None]
            want = jsampling.cascade_probs(logits, [], jsampling.SamplerParams(top_k=row_k, **kw))
            assert np.count_nonzero(want) <= row_k
            one = torch.ones(1)
            top_p, typ = one * kw["top_p"], one * kw["typical_p"]
            for tfs in (one * kw["tfs_z"], None):
                probs, mask = cascade_mask_probs(vals, one * temp, top_p,
                                                 torch.tensor([row_k]), tfs, typ)
                assert probs.shape == mask.shape == (1, width)
                np.testing.assert_allclose(probs[0].numpy(), want[ids], rtol=0, atol=1e-6)
                assert want.sum() == pytest.approx(float(probs.sum()), abs=1e-6)
                assert mask[0].tolist() == [bool(p > 0) for p in want[ids]]


@pytest.mark.parametrize("width", [1, 2])
def test_cascade_rows_draws_at_small_widths(width):
    """cascade_rows over a slice of width 1 or 2 with every truncation on
    draws by inverse CDF over the kept candidates of cascade_mask_probs,
    and rank 0 at temp 0."""
    rng = np.random.default_rng(width)
    B = 6
    vals = torch.sort(torch.from_numpy(rng.standard_normal((B, width)).astype(np.float32)),
                      dim=-1, descending=True).values
    u = torch.from_numpy(rng.random(B).astype(np.float32))
    temp = torch.tensor([0.8, 0.8, 0.0, 1.2, 0.5, 0.8])
    knob = torch.full((B,), 0.9)
    top_k = torch.tensor([1, width] * 3)
    ranks = cascade_rows(vals, u, temp, knob, top_k, knob, knob)
    probs, mask = cascade_mask_probs(vals, temp, knob, top_k, knob, knob)
    for b in range(B):
        if temp[b] <= 0:
            assert ranks[b] == 0
            continue
        cum = np.cumsum(probs[b].numpy())
        sel = np.flatnonzero((cum > float(u[b]) * cum[-1]) & mask[b].numpy())
        assert int(ranks[b]) == int(sel[0])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("small_k")
    out = {}
    for which, seed in (("target", 3), ("other", 11)):
        out["falcon", which] = str(d / f"falcon-{which}.ggcc")
        write_tiny_model(out["falcon", which], FalconHParams.tiny(), ftype_2d=GGMLType.Q8_0,
                         seed=seed)
    for which, seed in (("target", 7), ("other", 19)):
        out["llama", which] = str(d / f"llama-{which}.ggjt")
        write_tiny_llama(out["llama", which], seed=seed)
    return out


def _cfg():
    return dict(n_ctx=96, n_batch=32, kv_dtype="float32", compute_dtype="float32")


_LOADED = {}


def _engine(files, family, which="target", batch_size=1):
    cfg = TEngineConfig(**_cfg())
    if (family, which) not in _LOADED:
        _LOADED[family, which] = load_model(files[family, which], cfg, device="cpu")
    mf, params = _LOADED[family, which]
    return FalconEngine(mf.hparams, params, cfg, device="cpu", batch_size=batch_size)


BATCH_PROMPTS = [PROMPT, [40, 41, 42], [7]]


@pytest.fixture(scope="module")
def jax_greedy(files):
    """The JAX engine's greedy single streams: PROMPT on both families (N
    ids), and each of BATCH_PROMPTS on Falcon (12 ids)."""
    out = {}
    for family in ("falcon", "llama"):
        mf = read_model(files[family, "target"])
        cfg = EngineConfig(**_cfg(), kernel_layout=True)
        eng = JEngine(mf.hparams, load_params(mf, cfg), cfg)
        greedy = jsampling.SamplerParams(temp=0.0, repeat_penalty=1.0)
        out[family] = [int(t) for t in eng.generate(PROMPT, N, greedy, stop_ids=set())]
        if family == "falcon":
            for p in BATCH_PROMPTS:
                eng.reset()
                out[family, tuple(p)] = [int(t) for t in eng.generate(p, 12, greedy,
                                                                       stop_ids=set())]
    return out


@pytest.mark.parametrize("path", ["fused", "host"])
@pytest.mark.parametrize("family", ["falcon", "llama"])
def test_speculative_top_k_1_gives_greedy_ids(files, jax_greedy, family, path):
    """At temp 0.8 and top-k 1 (tail-free, typical and top-p on) one
    candidate leaves no choice: the rounds commit the JAX engine's greedy
    ids."""
    spec = SpeculativeDecoder(_engine(files, family), _engine(files, family, "other"), k=3,
                              rounds_per_dispatch=2)
    if path == "host":
        spec._fused_ok = lambda sampler: False
    out = spec.generate(PROMPT, N, SamplerParams(top_k=1, seed=5, **CUTS))
    assert out == jax_greedy[family]
    assert bool(spec._programs) == (path == "fused") and spec.stats.n_rounds > 0


@pytest.mark.parametrize("knobs", ["cuts", "top_k_only"])
def test_speculative_top_k_2_rounds_replay(files, knobs):
    """At top-k 2 each fused round's ids and n_acc equal the float64 replay
    over the round's own p and q on its uniforms, and the drafts are
    inverse-CDF draws from q; p and q keep at most two tokens a position."""
    kw = CUTS if knobs == "cuts" else dict(temp=0.8, top_p=1.0, repeat_penalty=1.0)
    spec = SpeculativeDecoder(_engine(files, "falcon"), _engine(files, "falcon", "other"), k=3,
                              rounds_per_dispatch=2)
    spec.record = []
    out = spec.generate(PROMPT, 24, SamplerParams(top_k=2, seed=9, **kw))
    assert len(out) == 24
    assert len(spec.record) >= len(spec.last_rounds) > 3
    for rec, (emitted, n_acc, us) in zip(spec.record, spec.last_rounds):
        p, q, xs = rec["p"].double().numpy(), rec["q"].double().numpy(), rec["xs"].tolist()
        assert (np.count_nonzero(p, axis=-1) <= 2).all()
        assert (np.count_nonzero(q, axis=-1) <= 2).all()
        assert replay_round(p, q, xs, us) == (emitted, n_acc)
        for j, x in enumerate(xs):
            cum = np.cumsum(q[j])
            assert x == int(np.flatnonzero(cum > us[j] * cum[-1])[0])


def test_batcher_with_cap_1_gives_greedy_ids(files, jax_greedy):
    """ContinuousBatcher(top_k=1) with sampled requests (every truncation
    on) decodes without raising, and each row's ids are the JAX engine's
    greedy single stream."""
    cb = ContinuousBatcher(_engine(files, "falcon", batch_size=2), chunk=4, top_k=1, seed=3)
    reqs = [cb.submit(Request(list(p), n_predict=12, **CUTS)) for p in BATCH_PROMPTS]
    cb.run()
    for p, req in zip(BATCH_PROMPTS, reqs):
        assert req.done and req.error is None
        assert req.out == jax_greedy["falcon", tuple(p)]
