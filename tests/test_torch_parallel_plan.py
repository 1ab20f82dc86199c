"""The port's memory-fit planner (ggllm_tpu_torch/parallel/plan.py) against
the JAX package's (tests/test_plan.py's cases): given the JAX module's
memory and layout overhead, suggest_tensor_split and suggest_mesh choose the
same model axis, kv_shard, data axis and per-card bytes; the port's own
overhead is its planar layout over the file's bytes. The port's own presets
plan as the JAX presets do."""

import dataclasses
from dataclasses import dataclass

import pytest
import torch

from ggllm_tpu.core.config import EngineConfig as JConfig, FalconHParams
from ggllm_tpu.parallel import plan as jplan
from ggllm_tpu_torch.core.config import EngineConfig
from ggllm_tpu_torch.core.config import FalconHParams as TFalconHParams
from ggllm_tpu_torch.core.dtypes import GGMLType
from ggllm_tpu_torch.io.ggcc import read_model
from ggllm_tpu_torch.parallel import plan
from ggllm_tpu_torch.utils.synthetic import write_tiny_model

torch.set_num_threads(1)


@dataclass
class _T:
    nbytes: int


@dataclass
class _MF:
    hparams: object
    tensors: dict


def _mf(hp, bits_per_weight: float) -> _MF:
    E, H, KV, D, F, V, L = (hp.n_embd, hp.n_head, hp.n_head_kv, hp.head_dim,
                            hp.n_ff, hp.n_vocab, hp.n_layer)
    total = L * ((H + 2 * KV) * D * E + E * H * D + 2 * F * E) + 2 * V * E
    return _MF(hp, {"all": _T(int(total * bits_per_weight / 8))})


SAME = dict(hbm_bytes=jplan.DEFAULT_HBM_BYTES, overhead=jplan.KERNEL_OVERHEAD)
CASES = [("falcon7b", {}), ("falcon40b", {}), ("falcon180b", {}),
         ("falcon7b", {"n_ctx": 1 << 21, "kv_dtype": "float32"}),
         ("falcon40b", {"n_ctx": 1 << 16, "kv_dtype": "int8"}),
         ("falcon40b", {"n_ctx": 1 << 20, "kv_dtype": "bfloat16"})]


@pytest.mark.parametrize("model,cfg", CASES)
def test_tensor_split_matches_jax(model, cfg):
    mf = _mf(getattr(FalconHParams, model)(), 4.5)
    got = plan.suggest_tensor_split(mf, EngineConfig(**cfg), **SAME)
    ref = jplan.suggest_tensor_split(mf, JConfig(**cfg))
    assert dataclasses.astuple(got) == dataclasses.astuple(ref)


@pytest.mark.parametrize("chips", [1, 2, 8, 16, 32])
@pytest.mark.parametrize("model", ["falcon40b", "falcon180b"])
def test_mesh_matches_jax(model, chips):
    mf = _mf(getattr(FalconHParams, model)(), 4.5)
    got = plan.suggest_mesh(mf, chips, **SAME)
    ref = jplan.suggest_mesh(mf, chips)
    assert (got.data, got.model, got.kv_shard, got.per_chip_bytes) == \
        (ref.data, ref.model, ref.kv_shard, ref.per_chip_bytes)


@pytest.mark.parametrize("model,cfg", CASES)
def test_tensor_split_on_port_preset(model, cfg):
    """The port's own presets (falcon180b among them) plan as the JAX
    presets do."""
    got = plan.suggest_tensor_split(_mf(getattr(TFalconHParams, model)(), 4.5),
                                    EngineConfig(**cfg), **SAME)
    ref = jplan.suggest_tensor_split(_mf(getattr(FalconHParams, model)(), 4.5), JConfig(**cfg))
    assert dataclasses.astuple(got) == dataclasses.astuple(ref)


@pytest.mark.parametrize("chips", [1, 2, 8, 16, 32])
@pytest.mark.parametrize("model", ["falcon40b", "falcon180b"])
def test_mesh_on_port_preset(model, chips):
    got = plan.suggest_mesh(_mf(getattr(TFalconHParams, model)(), 4.5), chips, **SAME)
    ref = jplan.suggest_mesh(_mf(getattr(FalconHParams, model)(), 4.5), chips)
    assert (got.data, got.model, got.kv_shard, got.per_chip_bytes) == \
        (ref.data, ref.model, ref.kv_shard, ref.per_chip_bytes)


def test_kv_bytes_match_jax():
    hp = FalconHParams.falcon40b()
    for kv in ("bfloat16", "float32", "int8"):
        assert plan.kv_bytes(hp, EngineConfig(kv_dtype=kv), 4) == \
            jplan.kv_bytes(hp, JConfig(kv_dtype=kv), 4)


@pytest.mark.parametrize("ftype,compute", [(GGMLType.Q4_0, "bfloat16"),
                                           (GGMLType.Q4_K, "bfloat16"),
                                           (GGMLType.Q8_0, "float32")])
def test_own_overhead_is_the_loaded_tree(tmp_path, ftype, compute):
    """loaded_bytes = the bytes of the tree io/loader.py builds."""
    from ggllm_tpu_torch.io.loader import load_model

    path = str(tmp_path / "m.bin")
    from ggllm_tpu_torch.core.config import FalconHParams as THParams

    hp = THParams(n_vocab=512, n_embd=256, n_head=8, n_head_kv=1, n_layer=2, n_falcon_type=7,
                  n_bpe_merges=0)  # K-quant rows: whole 256-element super-blocks
    write_tiny_model(path, hp, ftype_2d=ftype, seed=1)
    cfg = EngineConfig(compute_dtype=compute)
    _, params = load_model(path, cfg, device="cpu")
    # the loader merges matrices but keeps their bytes; buffers hold everything
    held = sum(t.numel() * t.element_size() for t in _tensors(params))
    assert plan.loaded_bytes(read_model(path), cfg) == held
    assert plan.kernel_overhead(read_model(path), cfg) == held / plan.model_bytes(
        read_model(path))


def _tensors(tree):
    from ggllm_tpu_torch.ops.linear import QuantTensor

    for v in tree.values():
        if isinstance(v, list):
            for lw in v:
                yield from _tensors(lw)
        elif isinstance(v, QuantTensor):
            yield from v.planes.values()
        else:
            yield v


def test_fits_and_memory():
    assert plan.FitPlan(1, "heads", 10 * 2**30, 16 * 2**30).fits
    assert not plan.FitPlan(1, "heads", 15 * 2**30, 16 * 2**30).fits
    assert plan.device_memory("cpu") > 2**30
