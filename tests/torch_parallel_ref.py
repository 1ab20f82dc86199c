"""Shared set-up of the port's sharded-engine tests (test_torch_tp*.py,
test_torch_sp*.py): the tiny model files, the JAX mesh engines they are
held against (in the pytest process, on the 8-device CPU mesh of
tests/conftest.py, as tests/test_tp_fused.py and test_seq_parallel.py run
them), and the port's rank pool (parallel/mesh.py RankPool: 4 gloo CPU
ranks over a file:// rendezvous under the test's temporary directory, one
world a test module, fed jobs from tests/torch_parallel_jobs.py)."""

from __future__ import annotations

import numpy as np

from ggllm_tpu.core.config import EngineConfig, FalconHParams, LlamaHParams
from ggllm_tpu.core.dtypes import GGMLType
from ggllm_tpu.engine.engine import FalconEngine as JEngine
from ggllm_tpu.io.ggcc import read_model
from ggllm_tpu.io.loader import load_params
from ggllm_tpu.parallel.mesh import make_mesh
from ggllm_tpu.utils.synthetic import write_tiny_llama, write_tiny_model

MODELS = {  # name -> (hparams, writer, seed)
    "tiny": (FalconHParams.tiny, write_tiny_model, 23),
    "tiny_gqa": (FalconHParams.tiny_gqa, write_tiny_model, 23),
    # 5 query heads: at mp 2 a rank holds 3, the second one padded head
    "tiny_pad": (lambda: FalconHParams(n_vocab=512, n_embd=160, n_head=5, n_head_kv=1,
                                       n_layer=2, n_falcon_type=7, n_bpe_merges=0),
                 write_tiny_model, 23),
    # n_mult 64 -> n_ff 384: a rank's FFN slice (192) is whole Q8_0 blocks
    "llama": (lambda: LlamaHParams(n_vocab=512, n_embd=128, n_mult=64, n_head=4, n_layer=2,
                                   n_rot=32), write_tiny_llama, 31),
}
TOL = 5e-5  # of max |logit|, the JAX package's TP / SP tolerance


def write_models(d, names=MODELS) -> dict:
    out = {}
    for name in names:
        hp, writer, seed = MODELS[name]
        out[name] = str(d / f"{name}.bin")
        writer(out[name], hp(), ftype_2d=GGMLType.Q8_0, seed=seed)
    return out


def jcfg(**kw) -> EngineConfig:
    kw.setdefault("n_ctx", 64)
    kw.setdefault("n_batch", 16)
    kw.setdefault("kv_dtype", "float32")
    kw.setdefault("compute_dtype", "float32")
    return EngineConfig(**kw)


def jax_engine(path: str, mp: int, batch: int = 1, **cfg_kw) -> JEngine:
    """The JAX mesh engine: tensor-parallel (kv_shard "heads", params from
    load_params(mesh=)) or sequence-parallel (single-chip params)."""
    mf = read_model(path)
    mesh = make_mesh(data=1, model=mp)
    if cfg_kw.get("kv_shard") == "sequence":
        cfg = jcfg(kernel_layout=True, **cfg_kw)
        params = load_params(mf, cfg)
    else:
        cfg = jcfg(**cfg_kw)
        params = load_params(mf, cfg, mesh=mesh)
    return JEngine(mf.hparams, params, cfg, batch_size=batch, mesh=mesh)


def close(got, ref, tol=TOL):
    scale = np.abs(ref).max() + 1e-6
    np.testing.assert_allclose(np.asarray(got) / scale, np.asarray(ref) / scale, atol=tol)


def same_on_ranks(results, mp: int):
    """The first mp ranks' results (the rest, outside the mesh, are None),
    asserted equal on every rank; returns rank 0's."""
    got = results[:mp]
    assert all(r is None for r in results[mp:])
    for r in got[1:]:
        assert _equal(r, got[0]), "ranks disagree"
    return got[0]


def _equal(a, b) -> bool:
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return np.array_equal(np.asarray(a), np.asarray(b))
