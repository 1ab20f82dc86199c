"""The hand kernels as torch library ops (ggllm_tpu_torch/kernels/library.py)
and the exported forward (FalconEngine.export, the CLI's --export), on the
CPU, where every op runs its plain version.

* torch.library.opcheck on each op's CPU and fake implementations:
  quant_matmul in all ten formats at S = 1 and 5 in bf16 and f32, group_sums
  at g 16 / 32, flash_mqa with an int and a (B,) n_past, flash_decode on a
  dense and an int8 cache, with and without an append block;
* each op against the JAX function on the same numpy inputs, Pallas in
  interpret mode, at the tolerances of tests/test_kernels.py:45 (2e-5 of
  max |ref| in f32, 2e-2 in bf16) and tests/test_torch_kernels.py (atol
  1e-5 for attention, 1e-4 for the group sums);
* the exported program of tiny Falcon (MQA, 7B-style merged weights; GQA,
  40B-style) and LLaMA engines on f32, bf16 and int8 caches, at S = 1 and
  7: run from the cache state the eager engine.eval starts from, its logits
  and the cache afterwards equal the eager ones exactly (the same plain
  ops), at two n_past values from one program, and the logits are within
  1e-4 (f32 compute) or 2e-2 (bf16) of max |logit| of the JAX engine's on
  the same file (its plain XLA path); the graph names ggllm.quant_matmul
  at the model's count (2, 3 or 4 a layer, and lm_head), ggllm.flash_mqa
  (S > 1) or ggllm.flash_decode (S = 1) once a layer;
* the CLI's --export PATH on a tiny file: exit 0, the program's text."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggllm_tpu.core.config import EngineConfig, FalconHParams, LlamaHParams
from ggllm_tpu.core.dtypes import GGMLType
from ggllm_tpu.engine.engine import FalconEngine
from ggllm_tpu.io.ggcc import read_model
from ggllm_tpu.io.loader import load_params
from ggllm_tpu.kernels import flash_decode as jfd
from ggllm_tpu.kernels import layout as jlayout
from ggllm_tpu.kernels import quant_matmul as jqm
from ggllm_tpu.kernels.flash_attention import flash_mqa as jflash_mqa
from ggllm_tpu.ops import kvcache as jkvcache
from ggllm_tpu.quant import planar as jplanar
from ggllm_tpu.quant import registry as jregistry
from ggllm_tpu.utils.synthetic import write_tiny_llama, write_tiny_model

from ggllm_tpu_torch.core.config import EngineConfig as TEngineConfig
from ggllm_tpu_torch.core.dtypes import GGMLType as TGGMLType
from ggllm_tpu_torch.engine.engine import FalconEngine as TFalconEngine
from ggllm_tpu_torch.io.loader import load_model as tload_model
from ggllm_tpu_torch.kernels import build, library
from ggllm_tpu_torch.kernels import quant_matmul as tqm
from ggllm_tpu_torch.ops import kvcache as tkvcache
from ggllm_tpu_torch.ops.linear import QuantTensor
from ggllm_tpu_torch.quant import planar as tplanar
from ggllm_tpu_torch.tools import main as cli

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)

OPS = torch.ops.ggllm
FORMATS = [GGMLType.Q4_0, GGMLType.Q8_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1,
           GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K, GGMLType.Q2_K, GGMLType.Q3_K]
O, K = 64, 512


def _weights(gtype, seed):
    """The JAX kernel operand of a random quantized (O, K) weight and the
    port's QuantTensor over the planes of the same blocks."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((O, K)) * 0.1).astype(np.float32)
    blob = np.stack([jregistry.quantize(gtype, w[i]) for i in range(O)]).reshape(O, -1)
    kq = jlayout.to_kernel(gtype, jplanar.to_planes(gtype, blob, O, K), (O, K))
    tplanes = tplanar.to_planes(TGGMLType(int(gtype)), blob, O, K)
    return kq, QuantTensor(TGGMLType(int(gtype)), (O, K),
                           {k: torch.from_numpy(v) for k, v in tplanes.items()})


def _matmul_args(tq, x, out_dtype):
    return (x, *tqm.plane_args(tq), None, int(tq.gtype), O, K, out_dtype)


def _opcheck(op, args):
    assert all(v == "SUCCESS" for v in torch.library.opcheck(op, args).values())


def test_ops_exist_and_import_once():
    """Importing ggllm_tpu_torch.kernels defines the five ops; a second
    import of the library module registers nothing again."""
    for name in ("quant_matmul", "quant_matmul_tc", "group_sums", "flash_mqa", "flash_decode"):
        assert hasattr(OPS, name), name
    importlib.reload(library)
    x = torch.randn(3, 64)
    assert torch.equal(OPS.group_sums.default(x, 32), tqm.group_sums_plain(x, 32))


@pytest.mark.parametrize("gtype", FORMATS, ids=[f.name.lower() for f in FORMATS])
@pytest.mark.parametrize("S", [1, 5])
@pytest.mark.parametrize("xdtype", ["bfloat16", "float32"])
def test_quant_matmul_op(gtype, S, xdtype):
    """opcheck, then the op's CPU result against the JAX Pallas kernel."""
    kq, tq = _weights(gtype, seed=S)
    x = np.random.default_rng(1).standard_normal((S, K)).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, xdtype))
    _opcheck(OPS.quant_matmul.default, _matmul_args(tq, tx, torch.float32))
    _opcheck(OPS.quant_matmul.default, _matmul_args(tq, tx.reshape(1, S, K), torch.bfloat16))
    ref = np.asarray(jqm.fused_matmul(kq, jnp.asarray(x, jnp.dtype(xdtype)), jnp.float32,
                                      interpret=True))
    got = OPS.quant_matmul.default(*_matmul_args(tq, tx, torch.float32)).numpy()
    scale = np.abs(ref).max() + 1e-6
    np.testing.assert_allclose(got / scale, ref / scale,
                               atol=2e-5 if xdtype == "float32" else 2e-2)


@pytest.mark.parametrize("gtype", [GGMLType.Q4_1, GGMLType.Q2_K], ids=["q4_1", "q2_k"])
def test_quant_matmul_op_takes_group_sums(gtype):
    """opcheck with the f32 tile's group sums passed in as xg (S = 300 f32
    rows, the op's operand under a tracer); the CPU result is the one
    without them."""
    _, tq = _weights(gtype, seed=2)
    group = tqm.KERNEL_FORMATS[TGGMLType(int(gtype))][0]
    tx = torch.from_numpy(np.random.default_rng(4).standard_normal((300, K)).astype(np.float32))
    args = list(_matmul_args(tq, tx, torch.float32))
    args[7] = tqm.group_sums_plain(tx, group)
    _opcheck(OPS.quant_matmul.default, tuple(args))
    assert torch.equal(OPS.quant_matmul.default(*args),
                       OPS.quant_matmul.default(*_matmul_args(tq, tx, torch.float32)))


def test_quant_matmul_tc_is_cuda_only():
    """The tile's op has a fake implementation (the (..., O) shape in
    out_dtype) and no CPU one."""
    _, tq = _weights(GGMLType.Q4_0, seed=0)
    x = torch.randn(1, 20, K).to(torch.bfloat16)
    args = (x, *tqm.plane_args(tq), int(tq.gtype), O, K, torch.float32)
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        y = OPS.quant_matmul_tc.default(*(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                                          else a for a in args))
    assert tuple(y.shape) == (1, 20, O) and y.dtype == torch.float32
    with pytest.raises(NotImplementedError, match="CPU"):
        OPS.quant_matmul_tc.default(*args)


@pytest.mark.parametrize("g", [16, 32])
def test_group_sums_op(g):
    """S = 300 runs the JAX _xg_kern; compare its real (unpadded) groups."""
    S, Kg = 300, 256
    x = np.random.default_rng(3).standard_normal((S, Kg)).astype(np.float32)
    tx = torch.from_numpy(x)
    _opcheck(OPS.group_sums.default, (tx, g))
    out = np.asarray(jqm._group_sums(jnp.asarray(x), 1, Kg, g, 256, interpret=True))
    ref = out.reshape(S, 1, -1)[:, :, : Kg // g].reshape(S, Kg // g)
    np.testing.assert_allclose(OPS.group_sums.default(tx, g).numpy(), ref, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("past", ["int", "rows"])
def test_flash_mqa_op(past):
    B, S, T, H, KV, D = 2, 16, 64, 8, 2, 32
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, D)).astype(np.float32)
    n_past = np.asarray([7, 30], np.int32) if past == "rows" else np.int32(11)
    vec = torch.from_numpy(n_past) if past == "rows" else None
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), vec,
            0 if past == "rows" else int(n_past))
    _opcheck(OPS.flash_mqa.default, args)
    ref = np.asarray(jflash_mqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(n_past), block_s=16, block_t=32, interpret=True))
    np.testing.assert_allclose(OPS.flash_mqa.default(*args).numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("cache", ["dense", "int8"])
@pytest.mark.parametrize("append", [False, True], ids=["no_append", "append"])
def test_flash_decode_op(cache, append):
    """The op on the stacked cache (layer 1 of 2) at per-row lengths, against
    the JAX flash_decode; the int8 cache is the JAX package's quantization
    of the same values."""
    L, B, T, KV, H, D, A = 2, 2, 64, 2, 6, 8, 5
    rng = np.random.default_rng(7 + append)
    dense = rng.standard_normal((L, 2, B, T, KV, D)).astype(np.float32)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    app = rng.standard_normal((2, B, A, KV, D)).astype(np.float32)
    n_past = np.asarray([40, 9], np.int32)
    kw = {"kv_append": jnp.asarray(app), "append_valid": jnp.int32(3)} if append else {}
    if cache == "int8":
        codes, scales = (np.asarray(a) for a in jkvcache.quantize_new(jnp.asarray(dense)))
        jkv = (jnp.asarray(codes.reshape(L, 2, B, T, KV * D)),
               jnp.asarray(np.moveaxis(scales[..., 0], 3, 4)))
        kv, sc = tkvcache.from_jax_cache((codes, scales), device="cpu")
    else:
        jkv, kv, sc = jnp.asarray(dense.reshape(L, 2, B, T, KV * D)), torch.from_numpy(dense), None
    args = (kv, sc, KV, 1, torch.from_numpy(q), torch.from_numpy(n_past), 0,
            torch.from_numpy(app) if append else None, 3 if append else None)
    _opcheck(OPS.flash_decode.default, args)
    ref = np.asarray(jfd.flash_decode(jkv, KV, 1, jnp.asarray(q), jnp.asarray(n_past),
                                      interpret=True, **kw))
    np.testing.assert_allclose(OPS.flash_decode.default(*args).numpy(), ref, atol=1e-5)


def test_cpu_ops_count_no_launch():
    """The CPU implementations are the plain versions: no launch counted."""
    build.launch_counts.clear()
    _, tq = _weights(GGMLType.Q4_K, seed=2)
    x = torch.randn(300, K)
    assert torch.equal(tqm.quant_matmul(tq, x, torch.float32),
                       tqm.quant_matmul_plain(tq, x, torch.float32))
    assert tqm.f32_sums(tq, x) is None  # group sums as their own op only on the card
    assert not build.launch_counts


# ------------------------------------------------------------ the export

# name -> (hparams, quant_matmul nodes a layer): Falcon-7B-style merged wqkvu
# and w_od, Falcon-40B-style wqkv, ffn_up and w_od, LLaMA wqkv, wo, w13, w2
MODELS = {"mqa": (FalconHParams.tiny, 2), "gqa": (FalconHParams.tiny_gqa, 3),
          "llama": (LlamaHParams.tiny, 4)}
CACHES = {"float32": "float32", "bfloat16": "bfloat16", "int8": "float32"}  # cache -> compute
JAX_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # of max |logit|, by compute dtype
PREFIX = {5: [9, 200, 31, 77, 4], 12: [3, 150, 88, 16, 402, 61, 7, 290, 45, 11, 500, 2]}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("export")
    out = {}
    for name, (mk_hp, _) in MODELS.items():
        if name == "llama":
            out[name] = str(d / "llama.ggjt")
            write_tiny_llama(out[name], mk_hp(), ftype_2d=GGMLType.Q4_0, seed=3)
        else:
            out[name] = str(d / f"{name}.ggcc")
            write_tiny_model(out[name], mk_hp(), ftype_2d=GGMLType.Q4_0, seed=3)
    return out


@pytest.fixture(scope="module")
def engines(files):
    """(model, cache) -> (the port's engine, the JAX engine on its plain
    XLA path) on the same file, made on first use."""
    made = {}

    def get(name, cache):
        if (name, cache) not in made:
            kw = dict(n_ctx=64, n_batch=16, kv_dtype=cache, compute_dtype=CACHES[cache])
            tmf, params = tload_model(files[name], TEngineConfig(**kw), device="cpu")
            assert isinstance(params["lm_head"], QuantTensor)
            jcfg = EngineConfig(**kw, kernel_layout=False, flash_attention=False)
            mf = read_model(files[name])
            made[name, cache] = (TFalconEngine(tmf.hparams, params, TEngineConfig(**kw),
                                               device="cpu"),
                                 FalconEngine(mf.hparams, load_params(mf, jcfg), jcfg))
        return made[name, cache]

    return get


def _leaves(kv):
    return kv if isinstance(kv, tuple) else (kv,)


def _clone(kv):
    return tuple(t.clone() for t in kv) if isinstance(kv, tuple) else kv.clone()


@pytest.mark.parametrize("S", [1, 7])
@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("name", list(MODELS))
def test_export_matches_eager_and_jax(engines, name, cache, S):
    """One program at two positions: from the cache state engine.eval
    starts from, the same logits and the same cache afterwards as the eager
    forward, exactly; the logits within JAX_TOL of the JAX engine's."""
    eng, jeng = engines(name, cache)
    eng.reset()
    before = _clone(eng.kv)
    ep = eng.export(S)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(eng.kv), _leaves(before)))
    program = ep.module()
    rng = np.random.default_rng(S)
    for n_past, prefix in PREFIX.items():
        toks = rng.integers(0, eng.hp.n_vocab, S)
        eng.reset()
        eng.eval(prefix)
        kv = _clone(eng.kv)
        want = eng.eval(toks)
        got = program(torch.from_numpy(toks).reshape(1, S), kv,
                      torch.tensor([n_past], dtype=torch.int32))
        assert got.shape == (1, 1, eng.hp.n_vocab) and got.dtype == torch.float32
        np.testing.assert_array_equal(got[0, 0].numpy(), want)
        for a, b in zip(_leaves(kv), _leaves(eng.kv)):
            assert torch.equal(a, b)
        jeng.reset()
        jeng.eval_tokens(prefix)
        ref = jeng.eval_tokens(toks)
        scale = np.abs(ref).max()
        np.testing.assert_allclose(want / scale, ref / scale, atol=JAX_TOL[CACHES[cache]])


@pytest.mark.parametrize("S", [1, 7])
@pytest.mark.parametrize("name", list(MODELS))
def test_graph_names_the_kernels(engines, name, S):
    """The program's text names each hand kernel at the model's count: its
    quantized matmuls (a layer's and lm_head), one attention op a layer
    (flash_decode at S = 1, flash_mqa at S > 1), the weights as buffers
    under their tree keys and n_past as an input."""
    eng, _ = engines(name, "int8")
    text = str(eng.export(S))
    L, per_layer = eng.hp.n_layer, MODELS[name][1]
    assert text.count("torch.ops.ggllm.quant_matmul.default(") == per_layer * L + 1
    assert text.count("torch.ops.ggllm.flash_decode.default(") == (L if S == 1 else 0)
    assert text.count("torch.ops.ggllm.flash_mqa.default(") == (0 if S == 1 else L)
    assert "target='layers.0.wqkv" in text and "target='lm_head.qs'" in text
    assert "target='inv_freq'" in text and "n_past: USER_INPUT" in text


def test_export_refuses_a_batched_engine(files):
    cfg = TEngineConfig(n_ctx=64, n_batch=16, kv_dtype="float32", compute_dtype="float32")
    tmf, params = tload_model(files["mqa"], cfg, device="cpu")
    eng = TFalconEngine(tmf.hparams, params, cfg, device="cpu", batch_size=2)
    with pytest.raises(ValueError, match="serves one stream"):
        eng.export(4)


def test_cli_export_writes_the_graph(files, tmp_path, capsys):
    """--export PATH after the model load: exit 0 before any generation, the
    program's text at PATH (one -b 16 chunk of the tiny Falcon: flash_mqa
    a layer), the JAX CLI's line on stderr with the port's name of it."""
    out = tmp_path / "fwd.txt"
    rc = cli.main(["-m", files["mqa"], "-c", "64", "-b", "16", "--device", "cpu",
                   "--export", str(out), "-p", "never read"])
    assert rc == 0
    cap = capsys.readouterr()
    assert f"forward graph (torch.export) exported to {out}" in cap.err and cap.out == ""
    text = out.read_text()
    assert text.startswith("ExportedProgram:") and "Graph signature" in text
    assert text.count("torch.ops.ggllm.quant_matmul.default(") == 2 * 2 + 1
    assert text.count("torch.ops.ggllm.flash_mqa.default(") == 2
    assert '"i64[1, 16]"' in text
