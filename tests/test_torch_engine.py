"""The PyTorch port's whole slice against the JAX package, on the CPU: tiny
GGCC files (Q4_0 at n_embd 128; Q4_1, Q5_0, Q5_1, Q8_0 7B-style and Q2_K,
Q3_K, Q4_K, Q5_K, Q6_K 40B-style at n_embd 256) go through both loaders and
engines (JAX with its Pallas kernels in interpret mode, f32 compute, an f32
or an int8 cache; the port with its plain kernel versions), plus the
tokenizer, the loader bridge and the port's hygiene rules."""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ggllm_tpu.core.config import EngineConfig, FalconHParams
from ggllm_tpu.core.dtypes import GGMLType
from ggllm_tpu.engine.engine import FalconEngine
from ggllm_tpu.io.ggcc import read_model
from ggllm_tpu.io.loader import load_params
from ggllm_tpu.ops.sampling import SamplerParams
from ggllm_tpu.tokenizer import bpe as jbpe
from ggllm_tpu.utils.synthetic import write_tiny_model

from ggllm_tpu_torch.core.config import EngineConfig as TEngineConfig
from ggllm_tpu_torch.core.config import FalconHParams as TFalconHParams
from ggllm_tpu_torch.engine.engine import FalconEngine as TFalconEngine
from ggllm_tpu_torch.io.ggcc import read_model as tread_model
from ggllm_tpu_torch.io.loader import from_jax_params, load_model as tload_model
from ggllm_tpu_torch.ops.sampling import SamplerParams as TSamplerParams
from ggllm_tpu_torch.tokenizer import bpe as tbpe

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)

PROMPT = [5, 17, 130, 42, 99, 260, 31, 7]
N_GEN = 16


def _jax_cfg(kernel_layout=True, kv_dtype="float32"):
    return EngineConfig(n_ctx=64, n_batch=16, kv_dtype=kv_dtype, compute_dtype="float32",
                        kernel_layout=kernel_layout, flash_attention=True)


def _torch_cfg(kv_dtype="float32"):
    return TEngineConfig(n_ctx=64, n_batch=16, kv_dtype=kv_dtype, compute_dtype="float32")


# name -> (hparams, 2-D weight format); the n_embd-256 geometries are those of
# tests/test_reference_e2e.py:157-162 (K-quants need widths divisible by 256)
def _hp_7b_256():
    return FalconHParams(n_vocab=512, n_embd=256, n_head=4, n_head_kv=1, n_layer=2,
                         n_falcon_type=7, n_bpe_merges=0)


def _hp_40b_256():
    return FalconHParams(n_vocab=512, n_embd=256, n_head=8, n_head_kv=2, n_layer=2,
                         n_falcon_type=40, n_bpe_merges=0)


MODELS = {
    "tiny": (FalconHParams.tiny, GGMLType.Q4_0),
    "tiny_gqa": (FalconHParams.tiny_gqa, GGMLType.Q4_0),
    "7b_q4_1": (_hp_7b_256, GGMLType.Q4_1),
    "7b_q5_0": (_hp_7b_256, GGMLType.Q5_0),
    "7b_q5_1": (_hp_7b_256, GGMLType.Q5_1),
    "7b_q8_0": (_hp_7b_256, GGMLType.Q8_0),
    "40b_q2_k": (_hp_40b_256, GGMLType.Q2_K),
    "40b_q3_k": (_hp_40b_256, GGMLType.Q3_K),
    "40b_q4_k": (_hp_40b_256, GGMLType.Q4_K),
    "40b_q5_k": (_hp_40b_256, GGMLType.Q5_K),
    "40b_q6_k": (_hp_40b_256, GGMLType.Q6_K),
}


@pytest.fixture(scope="module")
def tiny_files(tmp_path_factory):
    """name -> path of a GGCC file written by the JAX package (on first use)."""
    d = tmp_path_factory.mktemp("tiny")
    paths = {}

    class Files:
        def __getitem__(self, name):
            if name not in paths:
                mk_hp, ftype = MODELS[name]
                paths[name] = str(d / f"{name}.ggcc")
                write_tiny_model(paths[name], mk_hp(), ftype_2d=ftype, seed=17)
            return paths[name]

    return Files()


@pytest.fixture(scope="module")
def jax_engines(tiny_files):
    """jax_engines(name, kv_dtype): one JAX engine a model and cache for the
    module (reset on each call), so each of its programs compiles once."""
    engines = {}

    def get(name, kv_dtype="float32"):
        if (name, kv_dtype) not in engines:
            mf = read_model(tiny_files[name])
            cfg = _jax_cfg(kv_dtype=kv_dtype)
            engines[name, kv_dtype] = FalconEngine(mf.hparams, load_params(mf, cfg), cfg)
        engines[name, kv_dtype].reset()
        return engines[name, kv_dtype]

    return get


def slice_matches_jax_engine(path, jeng):
    """Prefill logits within 1e-4 of max |logit| of the JAX engine's, and
    N_GEN greedy ids equal (tests/test_torch_engine_kquants.py runs it on
    the 40B-style K-quant files)."""
    ref = jeng.eval(PROMPT)
    jeng.reset()
    ref_ids = jeng.generate(PROMPT, N_GEN, SamplerParams(temp=0.0))

    tmf, params = tload_model(path, _torch_cfg(), device="cpu")
    teng = TFalconEngine(tmf.hparams, params, _torch_cfg(), device="cpu")
    got = teng.eval(PROMPT)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, atol=1e-4)
    teng.reset()
    assert teng.generate(PROMPT, N_GEN, TSamplerParams(temp=0.0)) == ref_ids


@pytest.mark.parametrize("hp_name", ["tiny", "tiny_gqa", "7b_q4_1", "7b_q5_1"])
def test_slice_matches_jax_engine(tiny_files, jax_engines, hp_name):
    slice_matches_jax_engine(tiny_files[hp_name], jax_engines(hp_name))


@pytest.mark.parametrize("hp_name", ["tiny", "tiny_gqa"])
def test_int8_cache_matches_jax_engine(tiny_files, jax_engines, hp_name):
    """kv_dtype="int8", f32 compute, 7B-style and GQA 40B-style: prefill and
    single-token eval logits within 1e-4 of max |logit| of the JAX engine's
    (both read the quantized cache back dequantized); greedy ids equal over
    three decode chunks (40 tokens at decode_chunk 16: the last one
    partial), which holds only if a chunk's own tokens are attended unquantized and
    the chunk is quantized once at its end; then the caches agree: scales to
    1e-6, and codes exactly but for rounding ties (the two packages' f32 K/V
    differ in their last bits, so a value within those of a half may round
    to the neighbouring code: at most one step, in under 0.1 % of the codes;
    on equal inputs the quantizer is exact, tests/test_torch_kernels.py)."""
    path = tiny_files[hp_name]
    jeng = jax_engines(hp_name, "int8")
    tmf, params = tload_model(path, _torch_cfg("int8"), device="cpu")
    teng = TFalconEngine(tmf.hparams, params, _torch_cfg("int8"), device="cpu")
    assert isinstance(teng.kv, tuple) and teng.kv[0].dtype == torch.int8

    ref, got = jeng.eval(PROMPT), teng.eval(PROMPT)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, atol=1e-4)
    ref1, got1 = jeng.eval([int(ref.argmax())]), teng.eval([int(ref.argmax())])
    np.testing.assert_allclose(got1 / scale, ref1 / scale, atol=1e-4)

    jeng.reset()
    teng.reset()
    ref_ids = jeng.generate(PROMPT, 40, SamplerParams(temp=0.0))
    assert teng.generate(PROMPT, 40, TSamplerParams(temp=0.0)) == ref_ids
    assert teng.n_past == jeng.n_past == len(PROMPT) + 39
    jcodes, jscales = (np.asarray(a) for a in jeng.kv)
    n = teng.n_past
    step = np.abs(teng.kv[0].numpy()[:, :, :, :n].astype(np.int32) - jcodes[:, :, :, :n])
    assert step.max() <= 1 and (step != 0).mean() < 1e-3
    np.testing.assert_allclose(teng.kv[1].numpy()[:, :, :, :n], jscales[:, :, :, :n],
                               rtol=0, atol=1e-6)
    assert teng.kv[1].shape == jscales.shape


def test_multi_chunk_prefill_matches_jax(tiny_files, jax_engines):
    """A prompt longer than n_batch prefills in chunks (16 + 16 + 8)."""
    prompt = [int(t) for t in np.random.default_rng(4).integers(12, 500, 40)]
    ref = jax_engines("tiny").eval(prompt)
    tmf, params = tload_model(tiny_files["tiny"], _torch_cfg(), device="cpu")
    got = TFalconEngine(tmf.hparams, params, _torch_cfg(), device="cpu").eval(prompt)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, atol=1e-4)


@pytest.mark.parametrize("kernel_layout", [True, False], ids=["kernel", "planar"])
@pytest.mark.parametrize("hp_name", list(MODELS))
def test_from_jax_params_bit_identical(tiny_files, kernel_layout, hp_name):
    """The JAX loader's tree (merged KernelQuant or stacked planar form)
    converts to exactly the port loader's weights and logits."""
    path = tiny_files[hp_name]
    mf = read_model(path)
    jtree = jax.tree.map(np.asarray, load_params(mf, _jax_cfg(kernel_layout=kernel_layout)))
    tmf, own = tload_model(path, _torch_cfg(), device="cpu")
    bridged = from_jax_params(jtree, dtype=torch.float32, device="cpu")
    for a, b in zip(own["layers"], bridged["layers"]):
        assert a.keys() == b.keys()
        for key in a:
            if isinstance(a[key], torch.Tensor):
                assert torch.equal(a[key], b[key]), key
            else:
                assert a[key].gtype == b[key].gtype and a[key].shape == b[key].shape, key
                assert a[key].planes.keys() == b[key].planes.keys(), key
                for name, plane in a[key].planes.items():
                    assert plane.dtype == b[key].planes[name].dtype, (key, name)
                    assert torch.equal(plane, b[key].planes[name]), (key, name)
    outs = []
    for params in (own, bridged):
        eng = TFalconEngine(tmf.hparams, params, _torch_cfg(), device="cpu")
        outs.append(eng.eval(PROMPT))
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("n_ctx", [2048, 8192])
def test_rope_matches_jax(n_ctx):
    """NeoX RoPE with dynamic NTK (alpha > 1 from n_ctx 4096 on)."""
    from ggllm_tpu.core.config import RopeConfig
    from ggllm_tpu.ops import rope as jrope
    from ggllm_tpu_torch.core.config import RopeConfig as TRopeConfig
    from ggllm_tpu_torch.ops import rope as trope

    inv = jrope.rope_angles(RopeConfig(), n_ctx, 64)
    np.testing.assert_array_equal(trope.rope_angles(TRopeConfig(), n_ctx, 64), inv)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 3, 64)).astype(np.float32)
    pos = np.arange(1000, 1014).reshape(2, 7)
    ref = np.asarray(jrope.apply_rope(x, pos, inv))
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(inv))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-5)


def test_tokenizer_matches_jax(tiny_files):
    text = "Hello wörld — the thing's 123 ünïcödé\n\tπ≈3.14 日本語 <|endoftext|>!"
    jv = read_model(tiny_files["tiny"]).vocab
    tv = tread_model(tiny_files["tiny"]).vocab
    ids = tbpe.tokenize(tv, text, bos=True)
    assert ids == jbpe.tokenize(jv, text, bos=True)
    assert tbpe.detokenize(tv, ids) == jbpe.detokenize(jv, ids)


def test_cli_generates_on_cpu(tiny_files, capsysbinary):
    from ggllm_tpu_torch.tools import main as tmain

    rc = tmain.main(["-m", tiny_files["tiny"], "-p", "the thing", "-n", "6", "--temp", "0",
                     "--device", "cpu", "--ignore-eos"])
    assert rc == 0
    out = capsysbinary.readouterr()
    assert out.out.startswith(b"the thing") and b"eval time" in out.err


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import ggllm_tpu_torch\n"
        "for m in pkgutil.walk_packages(ggllm_tpu_torch.__path__, 'ggllm_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'ggllm_tpu' or m.startswith('ggllm_tpu.')]\n"
        "for m in ('models.llama', 'models.falcon', 'tokenizer.spm', 'utils.synthetic',\n"
        "          'utils.benchgen', 'tools.main', 'tools.profile_decode',\n"
        "          'tools.time_kernels', 'engine.generator', 'utils.stream',\n"
        "          'utils.finetune', 'engine.perplexity', 'tools.perplexity',\n"
        "          'tools.embedding', 'server.app', 'server.__main__', 'engine.batching',\n"
        "          'ops.grammar', 'engine.session', 'engine.speculative',\n"
        "          'tools.quantize', 'tools.quantize_stats', 'utils.traceview',\n"
        "          'quant.native', 'io.lora', 'io.safetensors', 'io.convert_hf',\n"
        "          'io.convert_hf_llama', 'io.convert_lora', 'parallel.mesh', 'parallel.comm',\n"
        "          'parallel.tp', 'parallel.sp', 'parallel.plan', 'kernels.ring_attention',\n"
        "          'kernels.library'):\n"
        "    assert 'ggllm_tpu_torch.' + m in sys.modules, m\n"
        "print(len([m for m in sys.modules if m.startswith('ggllm_tpu_torch.')]), bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True,
                         cwd=Path(__file__).resolve().parents[1]).stdout.split(maxsplit=1)
    assert int(out[0]) > 20 and out[1].strip() == "[]"


def test_engine_defaults_to_cuda(monkeypatch):
    """No device given: the engine asks for the card and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TFalconEngine(TFalconHParams.tiny(), {}, _torch_cfg())


@pytest.fixture(scope="module")
def tiny_engines(tiny_files, jax_engines):
    """The JAX engine and the port's (CPU) on the same tiny f32 model."""
    tmf, params = tload_model(tiny_files["tiny"], _torch_cfg(), device="cpu")
    return jax_engines("tiny"), TFalconEngine(tmf.hparams, params, _torch_cfg(), device="cpu")


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_host_route_generate_matches_jax_engine(tiny_engines, seed):
    """top_k = 0 at temp 0.8 is the whole vocabulary, which the device
    cascade does not serve: both engines sample every token through the host
    cascade with one SamplerState, and the 16 ids are equal."""
    from ggllm_tpu_torch.ops.sampling_device import device_samplable

    jeng, teng = tiny_engines
    kw = dict(temp=0.8, top_k=0, top_p=0.95, seed=seed)
    assert not device_samplable(TSamplerParams(**kw))
    jeng.reset()
    teng.reset()
    ref = jeng.generate(PROMPT, N_GEN, SamplerParams(**kw))
    assert teng.generate(PROMPT, N_GEN, TSamplerParams(**kw)) == ref
    assert teng.timings.n_sample >= N_GEN


def test_first_sampled_token_matches_jax_engine(tiny_engines):
    """The first token after prefill is drawn by the host cascade on the
    device route too (the JAX engine's engine.py:1359): equal for 20 seeds."""
    jeng, teng = tiny_engines
    got, ref = [], []
    for seed in range(20):
        kw = dict(temp=0.8, top_k=40, top_p=0.95, repeat_penalty=1.1, seed=seed)
        jeng.reset()
        teng.reset()
        ref.append(jeng.generate(PROMPT, 1, SamplerParams(**kw))[0])
        got.append(teng.generate(PROMPT, 1, TSamplerParams(**kw))[0])
    assert got == ref and len(set(ref)) > 1


def test_unsupported_head_shape_raises_when_the_engine_is_built(monkeypatch):
    """On the card with flash attention on, a head shape that no decode
    kernel takes (grouped heads at head_dim 256) raises in
    FalconEngine.__init__, with the shape and the reason; flash_attention=
    False (the plain route) is not refused."""
    from ggllm_tpu_torch.kernels import flash_decode as tfd

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    hp = TFalconHParams(n_vocab=64, n_embd=2048, n_head=8, n_head_kv=2, n_layer=1,
                        n_falcon_type=40, n_bpe_merges=0)
    assert hp.head_dim == 256
    cfg = TEngineConfig(n_ctx=64, kv_dtype="float32", compute_dtype="float32")
    assert tfd.supports(2, 4, 256, "float32", "float32")[0] is False
    assert tfd.supports(2, 4, 128, "float32", "float32")[0] is True  # the f32 kernel's
    assert tfd.supports(2, 4, 128, "bfloat16")[0] is True
    with pytest.raises(NotImplementedError, match="head_dim 256"):
        TFalconEngine(hp, {}, cfg)
    calls = []
    monkeypatch.setattr(tfd, "supports", lambda *a: calls.append(a) or (False, "refused"))
    with pytest.raises(Exception) as e:  # gets past the check; no card to put the model on
        TFalconEngine(hp, {}, TEngineConfig(n_ctx=64, flash_attention=False))
    assert not isinstance(e.value, NotImplementedError) and calls == []


def test_engine_takes_the_newline_id_of_its_family(tiny_engines):
    """The newline id that penalize_nl=False restores is the model family's
    vocabulary's (Falcon's BPE "\u010a" = 193, LLaMA's byte token <0x0A> =
    13), one source for the engine and the tokenizer module."""
    from ggllm_tpu_torch.core.config import LlamaHParams as TLlamaHParams
    from ggllm_tpu_torch.tokenizer import bpe, nl_id, spm

    assert tiny_engines[1].nl_token == 193
    assert nl_id(TLlamaHParams.tiny().arch) == 13 and nl_id(TFalconHParams.tiny().arch) == 193
    assert bpe.bytes_to_unicode()[ord("\n")] == "\u010a" and spm.NL_ID == spm.BYTE_OFFSET + 10


SAMPLER_FLAGS = ["--tfs", "--typical", "--repeat-last-n", "--frequency-penalty",
                 "--presence-penalty", "--mirostat", "--mirostat-tau", "--mirostat-ent",
                 "--mirostat-eta", "--mirostat-lr", "--no-penalize-nl", "--top-k", "--top-p",
                 "--temp", "--repeat-penalty", "--seed"]


def test_cli_sampler_flags_match_the_jax_cli():
    """The port's CLI has the JAX CLI's sampler flags, with their names,
    destinations and defaults (ggllm_tpu/tools/main.py:106-122)."""
    from ggllm_tpu.tools.main import build_argparser

    from ggllm_tpu_torch.tools.main import build_parser

    def flags(ap):
        return {o: (a.dest, a.default) for a in ap._actions for o in a.option_strings
                if o in SAMPLER_FLAGS}

    got = flags(build_parser())
    assert got == flags(build_argparser()) and set(got) == set(SAMPLER_FLAGS)


@pytest.mark.parametrize("extra", [["--top-k", "0"], ["--tfs", "0.9", "--typical", "0.9"],
                                   ["--mirostat", "2", "--mirostat-ent", "4"]],
                         ids=["top_k_0", "tfs_typical", "mirostat"])
def test_cli_host_route_generates_on_cpu(tiny_files, capsysbinary, extra):
    """Settings the device cascade does not cover sample through the host
    cascade: one draw per token."""
    from ggllm_tpu_torch.tools import main as tmain

    rc = tmain.main(["-m", tiny_files["tiny"], "-p", "the thing", "-n", "6", "--temp", "0.8",
                     "--seed", "5", "--device", "cpu", "--ignore-eos", *extra])
    assert rc == 0
    out = capsysbinary.readouterr()
    assert out.out.startswith(b"the thing") and b"sample time     =" in out.err
    assert b"/ 6 runs" in out.err.split(b"sample time")[1].split(b"\n")[0]
