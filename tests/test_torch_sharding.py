"""The fallback tree and the data axis (ggllm_tpu_torch/parallel/sharding.py,
io/loader.py _load_split, models/falcon.py SplitFalcon, the engine's data
rows) on gloo CPU ranks, against the JAX package's GSPMD path
(parallel/sharding.py, tests/test_sharding.py's set-up) in f32.

* The split rules: the port's split of every weight equals the JAX
  param_specs of the JAX GSPMD tree, and its cache split the JAX kv_specs,
  at model 2 and 4 (data 1 and 2, batch 1, 2, 4): tiny, tiny_gqa, tiny_pad,
  a 256-wide Q4_K model (whose one- and four-block rows take the in -> out
  -> replicated fallbacks), an F32 file, a layer of mixed Q4_K / Q6_K, a
  LoRA adapter's dense keys and weight_mode "dequant".
* Each case the JAX loader sends to GSPMD (a LoRA adapter, dequant, F32,
  mixed types, undivided Q4_K blocks, tiny_gqa at mp 4): prefill and
  decode-step logits within TOL of the JAX mesh engine's and the JAX
  single-device engine's, every rank equal; greedy ids the JAX engine's.
* The data axis: prefill_rows / decode_rows of 2 x 2 and 2 x 1 meshes at
  B = 4 and 2 (each data row of ranks its B / 2 cache rows) and B = 1 (the
  rows replicated) give the JAX mesh engine's logits and ids
  (FalconEngine(mesh=make_mesh(data=2, model=2), batch_size=B)); sampled
  rows the single process's (one generator); a ContinuousBatcher over them
  gives the JAX batcher's ids.
The JAX engines run in the pytest process on the 8-device CPU mesh of
tests/conftest.py; the port's in one pool of 4 ranks (RankPool)."""

import numpy as np
import pytest
import torch

from tests import torch_parallel_jobs as J
from tests import torch_parallel_ref as R
from ggllm_tpu.engine.batching import ContinuousBatcher as JBatcher, Request as JRequest
from ggllm_tpu.engine.engine import FalconEngine as JEngine
from ggllm_tpu.io.ggcc import read_model as jread_model
from ggllm_tpu.io.loader import load_params as jload_params
from ggllm_tpu.ops.sampling import SamplerParams as JSampler
from ggllm_tpu.parallel import sharding as jshd
from ggllm_tpu.parallel.mesh import make_mesh as jmake_mesh
from ggllm_tpu_torch.core.config import FalconHParams
from ggllm_tpu_torch.core.dtypes import GGMLType
from ggllm_tpu_torch.io.ggcc import GGCCWriter, read_model
from ggllm_tpu_torch.io.loader import split_specs
from ggllm_tpu_torch.io.lora import write_lora
from ggllm_tpu_torch.parallel import sharding
from ggllm_tpu_torch.parallel.mesh import RankPool
from ggllm_tpu_torch.utils.synthetic import make_tiny_vocab, random_weights, write_tiny_model

torch.set_num_threads(1)

PROMPT = [5, 17, 130, 42, 99, 260]
N_IDS = 8
ROW_PROMPTS = [[5, 17, 130], [42, 99, 260, 7, 8], [300, 2], [12, 13, 14, 15]]


def _write_mixed(path: str, hp: FalconHParams, seed: int):
    """Q4_K query_key_value / dense_h_to_4h / embeddings, Q6_K dense /
    dense_4h_to_h / lm_head: every layer mixes two quant types."""
    vocab = make_tiny_vocab(hp.n_vocab)
    hp.n_bpe_merges = len(vocab.merges)
    w = GGCCWriter(path, hp, vocab)
    for name, arr in random_weights(hp, seed).items():
        six = any(k in name for k in ("dense.weight", "4h_to_h", "lm_head"))
        w.write_array(name, arr, GGMLType.F32 if arr.ndim == 1 else
                      GGMLType.Q6_K if six else GGMLType.Q4_K)
    w.close()


def _wide(**kw) -> FalconHParams:
    """256 wide (K-quant rows of one super-block), 8 heads of 32, 2 layers."""
    return FalconHParams(n_vocab=512, n_embd=256, n_head=8, n_layer=2, n_bpe_merges=0, **kw)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("split")
    out = R.write_models(d, ("tiny", "tiny_gqa", "tiny_pad"))
    out["f32"] = str(d / "f32.bin")
    write_tiny_model(out["f32"], FalconHParams.tiny(), ftype_2d=GGMLType.F32, seed=5)
    out["q4k"] = str(d / "q4k.bin")  # 256 wide: qkv / wo rows one super-block
    write_tiny_model(out["q4k"], _wide(n_head_kv=1, n_falcon_type=7), ftype_2d=GGMLType.Q4_K,
                     seed=6)
    out["mixed"] = str(d / "mixed.bin")
    _write_mixed(out["mixed"], _wide(n_head_kv=2, n_falcon_type=40), seed=7)
    out["adapter"] = str(d / "a.ggla")
    rng = np.random.default_rng(8)
    hp = FalconHParams.tiny()
    n_qkv = (hp.n_head + 2 * hp.n_head_kv) * hp.head_dim
    write_lora(out["adapter"], 4, 8, {
        name: {"loraA": rng.standard_normal((4, cols)).astype(np.float32) * 0.1,
               "loraB": rng.standard_normal((rows, 4)).astype(np.float32) * 0.1}
        for i in range(hp.n_layer)
        for name, rows, cols in ((f"transformer.h.{i}.self_attention.query_key_value.weight",
                                  n_qkv, hp.n_embd),
                                 (f"transformer.h.{i}.mlp.dense_4h_to_h.weight", hp.n_embd,
                                  hp.n_ff))})
    return out


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(4, workdir=str(tmp_path_factory.mktemp("ranks"))) as p:
        yield p


def _jax_dim(spec, stacked: bool = True):
    """A JAX PartitionSpec (or a QuantTensor of them, one a plane) as the
    port's split: "out", "in" or None."""
    if hasattr(spec, "planes"):
        dims = {_jax_dim(s, stacked) for s in spec.planes.values()}
        assert len(dims) == 1, dims
        return dims.pop()
    off = 1 if stacked else 0
    axes = [i - off for i, a in enumerate(spec) if a == "model"]
    return {(): None, (0,): "out", (1,): "in"}[tuple(axes)]


SPEC_CASES = [("tiny", {}, False), ("tiny_gqa", {}, False), ("tiny_pad", {}, False),
              ("q4k", {}, False), ("f32", {}, False), ("mixed", {}, False),
              ("tiny", {}, True), ("tiny_gqa", {"weight_mode": "dequant"}, False)]


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("name,cfg_kw,lora", SPEC_CASES,
                         ids=[f"{n}{'-lora' if lo else ''}{'-dequant' if kw else ''}"
                              for n, kw, lo in SPEC_CASES])
def test_split_rules_equal_jax(files, name, cfg_kw, lora, mp):
    path, adapter = files[name], files["adapter"] if lora else None
    got = split_specs(read_model(path), J.cfg_of(**cfg_kw), mp, lora=adapter)
    jmf = jread_model(path)
    jtree = jload_params(jmf, R.jcfg(**cfg_kw), lora=adapter)  # the planar GSPMD tree
    ref = jshd.param_specs(jtree, jmf.hparams, jmake_mesh(data=1, model=mp))
    assert got["tok_embeddings"] == _jax_dim(ref["tok_embeddings"], stacked=False)
    assert got["lm_head"] == _jax_dim(ref["lm_head"], stacked=False)
    for key in ("wq", "wk", "wv", "wo", "ffn_up", "ffn_down"):
        want = _jax_dim(ref["layers"][key])
        assert all(lw[key] == want for lw in got["layers"]), (key, want, got["layers"])
    hp = read_model(path).hparams
    for data in (1, 2):
        mesh = jmake_mesh(data=data, model=mp)
        for batch in (1, 2, 4):
            spec = jshd.kv_specs(jmf.hparams, mesh, batch)
            assert sharding.kv_specs(hp, mp, data, batch) == (spec[2], spec[4])


def test_the_rules_fall_back_in_jax_order():
    """_qt_spec:33's in -> out -> replicated, _mat_spec:61's other dim."""
    assert [sharding.qt_spec(r, nb, ax, 2) for r, nb, ax in (
        (4, 4, "in"), (4, 3, "in"), (3, 4, "in"), (3, 3, "in"), (4, 4, "out"), (3, 4, "out"))] \
        == ["in", "out", "in", None, "out", "in"]
    dense = lambda o, k: type("W", (), {"shape": (o, k)})()  # noqa: E731
    assert [sharding.mat_spec(dense(o, k), ax, 2) for o, k, ax in (
        (4, 4, "in"), (4, 3, "in"), (3, 3, "out"), (3, 4, "out"))] == ["in", "out", None, "in"]


FALLBACK = [("lora", "tiny", 2, {}), ("dequant", "tiny_gqa", 2, {"weight_mode": "dequant"}),
            ("f32", "f32", 4, {}), ("mixed", "mixed", 2, {}), ("q4k", "q4k", 2, {}),
            ("gqa_mp4", "tiny_gqa", 4, {})]


@pytest.mark.parametrize("case,name,mp,cfg_kw", FALLBACK, ids=[c[0] for c in FALLBACK])
def test_fallback_matches_jax(files, pool, case, name, mp, cfg_kw):
    """Every rank the same; prefill and decode-step logits within TOL of the
    JAX GSPMD engine's and the JAX single-device engine's; greedy ids the
    JAX engine's; each rank holds its split of each weight and the cache's
    K/V heads kv_specs gives it."""
    path, adapter = files[name], files["adapter"] if case == "lora" else None
    l1, l2, ids, kv_shape, shapes = R.same_on_ranks(
        pool.run(J.split_run, path, mp, cfg_kw, PROMPT, N_IDS, lora=adapter), mp)
    jmf = jread_model(path)
    cfg = R.jcfg(**cfg_kw)
    mesh = jmake_mesh(data=1, model=mp)
    je = JEngine(jmf.hparams, jload_params(jmf, cfg, mesh=mesh, lora=adapter), cfg, mesh=mesh)
    ref1 = np.asarray(je.eval(PROMPT))
    ref2 = np.asarray(je.eval([int(np.argmax(ref1))]))
    R.close(l1, ref1)
    R.close(l2, ref2)
    one = JEngine(jmf.hparams, jload_params(jmf, cfg, lora=adapter), cfg)
    R.close(l1, one.eval(PROMPT))
    one.reset()
    ref_ids = one.generate(PROMPT, n_predict=N_IDS,
                           sampler=JSampler(temp=0.0, repeat_penalty=1.0))
    assert ids == [int(t) for t in ref_ids]
    hp = read_model(path).hparams
    specs = split_specs(read_model(path), J.cfg_of(**cfg_kw), mp, lora=adapter)["layers"][0]
    rows = {"wq": hp.n_head * hp.head_dim, "wk": hp.n_head_kv * hp.head_dim,
            "wv": hp.n_head_kv * hp.head_dim, "wo": hp.n_embd, "ffn_up": hp.n_ff,
            "ffn_down": hp.n_embd}
    cols = {"wq": hp.n_embd, "wk": hp.n_embd, "wv": hp.n_embd, "wo": hp.n_head * hp.head_dim,
            "ffn_up": hp.n_embd, "ffn_down": hp.n_ff}
    for k, spec in specs.items():
        want = (rows[k] // (mp if spec == "out" else 1), cols[k] // (mp if spec == "in" else 1))
        assert shapes[k] == want, (k, spec, shapes[k])
    heads = sharding.kv_specs(hp, mp, 1, 1)[1]
    assert kv_shape[4] == hp.n_head_kv // (mp if heads else 1)


@pytest.fixture(scope="module")
def jax_rows(files):
    """The JAX mesh engine at data 2 x model 2, B = 4 and 2 (one prompt a row
    at position 0): prefill_rows logits and 4 greedy decode_rows ids; and
    the JAX batcher's ids over B = 2 rows for the four prompts."""
    jmf = jread_model(files["tiny"])
    cfg = R.jcfg()
    mesh = jmake_mesh(data=2, model=2)
    out = {}
    for B in (4, 2, 1):
        eng = JEngine(jmf.hparams, jload_params(jmf, cfg, mesh=mesh), cfg, batch_size=B,
                      mesh=mesh)
        if B > 1:
            got = eng.prefill_rows(list(range(B)), ROW_PROMPTS[:B], np.zeros(B, np.int32))
            toks = np.array([int(np.argmax(got[r])) for r in range(B)])
            ids, _ = eng.decode_rows(toks, np.array([len(p) for p in ROW_PROMPTS[:B]]), 4,
                                     temp=np.zeros(B), top_p=np.ones(B))
            out[B] = ({r: np.asarray(v) for r, v in got.items()}, np.asarray(ids))
        if B <= 2:
            cb = JBatcher(eng, chunk=4)
            reqs = [cb.submit(JRequest(list(p), n_predict=6)) for p in ROW_PROMPTS]
            cb.run()
            out["batcher", B] = [list(map(int, r.out)) for r in reqs]
    return out


@pytest.mark.parametrize("mp,B", [(2, 4), (2, 2), (1, 4), (1, 2)])
def test_data_axis_rows_match_jax(files, pool, jax_rows, mp, B):
    """prefill_rows / decode_rows of a 2 x mp mesh: each data row of ranks
    holds B / 2 cache rows; the logits and ids of all B rows the JAX mesh
    engine's, on every rank, and the timings count all B rows' tokens."""
    res = pool.run(J.rows_run, files["tiny"], mp, 2, {}, B, ROW_PROMPTS)
    got, ids, rows, counts = R.same_on_ranks(res, 2 * mp)
    ref, ref_ids = jax_rows[B]
    assert sorted(got) == sorted(ref) and rows == B // 2
    assert counts == (sum(len(p) for p in ROW_PROMPTS[:B]), 4 * B)
    for r in ref:
        R.close(got[r], ref[r])
    np.testing.assert_array_equal(ids, ref_ids)


def test_data_axis_sampled_rows_match_one_process(files, pool):
    """Sampled decode_rows (temp 0.8) of a 2 x 1 mesh at B = 4: each data row
    of ranks samples its rows from its columns of all B rows' uniforms, so
    the ids are the single process's B-row engine's (the same generator)."""
    res = pool.run(J.rows_run, files["tiny"], 1, 2, {}, 4, ROW_PROMPTS, temp=0.8)
    _, ids, _, _ = R.same_on_ranks(res, 2)
    _, ref, _, _ = J.rows_run(files["tiny"], 0, 1, {}, 4, ROW_PROMPTS, temp=0.8)
    np.testing.assert_array_equal(ids, ref)


@pytest.mark.parametrize("mp,B", [(2, 2), (2, 1), (1, 2), (1, 1)])
def test_data_axis_batcher_matches_jax(files, pool, jax_rows, mp, B):
    """A ContinuousBatcher over the 2 x mp engine (B = 2: a row a data row
    of ranks; B = 1: replicated) gives the JAX batcher's ids."""
    res = pool.run(J.batcher, files["tiny"], mp, {}, ROW_PROMPTS, 6, 4, batch=B, data=2)
    assert R.same_on_ranks(res, 2 * mp) == jax_rows["batcher", B]
