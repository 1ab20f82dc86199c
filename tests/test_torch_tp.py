"""The port's tensor-parallel engine (parallel/mesh.py, parallel/tp.py,
io/loader.py load_params(mesh=), the models' psum hook) on gloo CPU ranks,
against the JAX tensor-parallel engine (tests/test_tp_fused.py's set-up)
and the port's single-process engine, in f32.

Each rank builds only its own blocks; the prefill and decode-step logits of
every rank equal each other and the JAX TP engine's and the single-process
engine's within 5e-5 of max |logit|: Falcon MQA at mp 2 and 4 (and with 5
query heads, one padded at mp 2), GQA at mp 2, LLaMA at mp 2. Each rank's
merged wqkvu / w_od (LLaMA: wqkv, w13, wo, w2) block, decoded to f32,
equals the JAX build_tp_layer's block of that device. embed() equals the
JAX TP engine's. LLaMA without the plan raises with the JAX loader's
words; the Falcon cases the JAX loader sends to its GSPMD fallback run the
fallback tree (tests/test_torch_sharding.py). Decoding:
tests/test_torch_tp_decode.py."""

import numpy as np
import pytest
import torch

from tests import torch_parallel_jobs as J
from tests import torch_parallel_ref as R
from ggllm_tpu.io.ggcc import read_model
from ggllm_tpu.io.loader import load_params
from ggllm_tpu.parallel.mesh import make_mesh
from ggllm_tpu_torch.io.loader import _weight_from_jax
from ggllm_tpu_torch.parallel.mesh import RankPool

torch.set_num_threads(1)

PROMPT = [5, 17, 130, 42, 99, 260]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return R.write_models(tmp_path_factory.mktemp("tp"))


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(4, workdir=str(tmp_path_factory.mktemp("ranks"))) as p:
        yield p


@pytest.mark.parametrize("name,mp", [("tiny", 2), ("tiny", 4), ("tiny_gqa", 2),
                                     ("tiny_pad", 2), ("llama", 2)])
def test_prefill_and_step_match(files, pool, name, mp):
    """Prefill logits and one decode step's against the JAX TP engine and
    the port's single-process engine; the cache holds the rank's K/V heads."""
    got1, got2, shape = R.same_on_ranks(pool.run(J.prefill_step, files[name], mp, {}, PROMPT),
                                        mp)
    je = R.jax_engine(files[name], mp)
    ref1 = np.asarray(je.eval(PROMPT))
    t = int(np.argmax(ref1))
    ref2 = np.asarray(je.eval([t]))
    R.close(got1, ref1)
    R.close(got2, ref2)
    one = J.single_engine(files[name], {})
    R.close(got1, one.eval(PROMPT))
    R.close(got2, one.eval([t]))
    hp = read_model(files[name]).hparams
    kv = hp.n_head_kv // mp if hp.n_head_kv > 1 else 1
    assert shape[4] == kv and shape[3] == one.kv_T


def _jax_block(w, d: int) -> np.ndarray:
    """Device d's block of a JAX device-stacked KernelQuant, decoded to f32
    through the port's reader of the JAX layout."""
    from types import SimpleNamespace

    local = SimpleNamespace(gtype=w.gtype, shape=w.shape, ck=w.ck,
                            planes={k: np.asarray(v)[d] for k, v in w.planes.items()})
    return _weight_from_jax(local, "cpu", torch.float32).dequantize(torch.float32).numpy()


@pytest.mark.parametrize("name,mp,keys", [
    ("tiny", 2, ("wqkvu", "w_od")), ("tiny_pad", 2, ("wqkvu", "w_od")),
    ("tiny_gqa", 2, ("wqkv", "ffn_up", "w_od")), ("llama", 2, ("wqkv", "w13", "wo", "w2"))])
def test_blocks_equal_jax(files, pool, name, mp, keys):
    """Each rank's layer-0 blocks = the JAX TP loader's block of that device
    (parallel/tp.py build_tp_layer / build_tp_llama_layer), in f32."""
    got = pool.run(J.blocks, files[name], mp, {}, keys)
    jp = load_params(read_model(files[name]), R.jcfg(), mesh=make_mesh(data=1, model=mp))
    for d in range(mp):
        for k in keys:
            ref = _jax_block(jp["layers"][0][k], d)
            assert got[d][k].shape == ref.shape, k
            np.testing.assert_allclose(got[d][k], ref, atol=1e-6, err_msg=f"{k} rank {d}")


def test_embed_matches(files, pool):
    got = R.same_on_ranks(pool.run(J.embed, files["tiny"], 2, {}, PROMPT[:4]), 2)
    ref = R.jax_engine(files["tiny"], 2).embed(PROMPT[:4])
    np.testing.assert_allclose(got, ref, atol=5e-5)


def test_llama_without_the_plan_raises(files, pool, tmp_path):
    """LLaMA where the JAX loader gives up its TP plan (here a LoRA
    adapter) raises with the JAX loader's words, as the JAX package has no
    LLaMA fallback; the Falcon cases go to the fallback tree
    (tests/test_torch_sharding.py)."""
    msgs = pool.run(J.load_error, files["llama"], 2, {}, lora=_llama_adapter(tmp_path))
    for msg in msgs[:2]:
        assert msg is not None and msg.startswith(
            "multi-chip LLaMA needs the TP plan (uniform quant type, mp | n_head, no LoRA,"
            " no data axis)"), msg
        assert "item" not in msg and "ROADMAP" not in msg


def _llama_adapter(tmp_path) -> str:
    from ggllm_tpu_torch.io.lora import write_lora

    path = str(tmp_path / "l.ggla")
    write_lora(path, 2, 4, {"layers.0.attention.wq.weight": {
        "loraA": np.ones((2, 128), np.float32), "loraB": np.ones((128, 2), np.float32)}})
    return path


def test_ranks_import_no_jax(files, pool):
    """After the jobs above, no rank process has imported jax or the JAX
    package."""
    pool.run(J.prefill_only, files["tiny"], 4, {}, PROMPT)
    assert pool.run(J.imported_jax) == [[]] * 4
