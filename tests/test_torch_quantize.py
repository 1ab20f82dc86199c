"""The port's quantizers and quantize tools against the JAX package's, on the
CPU: every format the JAX registry quantizes (ggllm_tpu_torch/quant/
registry.py, legacy.py, kquants.py) bit for bit the JAX numpy codec on
random rows, degenerate blocks (zeros, constants, one large outlier) and
hypothesis draws; the C++ codecs (quant/native.py) bit for bit the numpy
ones; tools/quantize.py quantize_file writing the JAX tool's bytes on a
tiny Falcon (legacy types) and a tiny LLaMA (K-quants under the mixed
policy), with its refusals; tools/quantize_stats.py printing the JAX
tool's report; utils/synthetic.py writing every format through the
quantizer."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ggllm_tpu.core.config import FalconHParams, LlamaHParams
from ggllm_tpu.core.dtypes import GGMLType
from ggllm_tpu.quant import registry as jregistry
from ggllm_tpu.tools import quantize as jquantize
from ggllm_tpu.tools import quantize_stats as jstats
from ggllm_tpu.utils import synthetic as jsynthetic

from ggllm_tpu_torch.core.config import LlamaHParams as TLlamaHParams
from ggllm_tpu_torch.core.dtypes import TYPE_TRAITS
from ggllm_tpu_torch.io.ggcc import read_model
from ggllm_tpu_torch.quant import native, registry
from ggllm_tpu_torch.tools import quantize, quantize_stats
from ggllm_tpu_torch.utils import synthetic

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)

FORMATS = [GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_0,
           GGMLType.Q8_1, GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K, GGMLType.Q5_K,
           GGMLType.Q6_K, GGMLType.Q8_K]
IDS = [g.name for g in FORMATS]
LLAMA = LlamaHParams(n_vocab=512, n_embd=256, n_mult=256, n_head=4, n_layer=2, n_rot=64)


def _degenerate(bs: int) -> np.ndarray:
    """Blocks the scale searches special-case: all zeros, a constant (either
    sign), one large outlier among small values, a single non-zero, a tiny
    spread, equal magnitudes of both signs."""
    rng = np.random.default_rng(1)
    blocks = [np.zeros(bs), np.full(bs, 0.75), np.full(bs, -3.0),
              np.concatenate([[1e4], rng.standard_normal(bs - 1) * 1e-3]),
              np.eye(1, bs, bs // 2)[0] * -2.5,
              1.0 + rng.standard_normal(bs) * 1e-6,
              np.tile([1.0, -1.0], bs // 2)]
    return np.concatenate(blocks).astype(np.float32)


def test_every_jax_quantizer_is_ported():
    assert set(registry._QUANTIZE) == set(jregistry._QUANTIZE)
    assert all(registry.can_quantize(g) for g in FORMATS)


@pytest.mark.parametrize("gtype", FORMATS, ids=IDS)
def test_quantizer_bit_exact_with_jax(gtype):
    """Random rows of three spreads and the degenerate blocks: the port's
    blob is the JAX numpy codec's byte for byte, and so is its dequant."""
    bs = TYPE_TRAITS[gtype].block_size
    rng = np.random.default_rng(int(gtype))
    x = np.concatenate([rng.standard_normal(8 * bs), rng.standard_normal(4 * bs) * 40.0,
                        rng.uniform(0, 1e-3, 4 * bs), _degenerate(bs)]).astype(np.float32)
    got = registry.quantize(gtype, x)
    ref = jregistry.quantize(gtype, x, native=False)
    assert got.dtype == np.uint8 and np.array_equal(got, ref)
    np.testing.assert_array_equal(registry.dequantize(gtype, got, x.size),
                                  jregistry.dequantize(gtype, ref, x.size, native=False))


@settings(max_examples=5, deadline=None)
@given(st.sampled_from(FORMATS), st.integers(0, 2**32 - 1),
       st.floats(1e-6, 1e4, allow_nan=False), st.integers(1, 3))
def test_quantizer_bit_exact_on_draws(gtype, seed, scale, blocks):
    bs = TYPE_TRAITS[gtype].block_size
    x = (np.random.default_rng(seed).standard_normal(blocks * bs) * scale).astype(np.float32)
    assert np.array_equal(registry.quantize(gtype, x), jregistry.quantize(gtype, x, native=False))


@pytest.mark.parametrize("gtype", FORMATS, ids=IDS)
def test_native_codec_equals_numpy(gtype):
    """The C++ codecs (built with g++ into build/) give the numpy codecs'
    bytes, and dequantize them to the same floats."""
    bs = TYPE_TRAITS[gtype].block_size
    x = np.concatenate([np.random.default_rng(7).standard_normal(2048 * bs),
                        _degenerate(bs)]).astype(np.float32)
    blob = registry.quantize(gtype, x, native=True)
    assert np.array_equal(blob, registry.quantize(gtype, x))
    np.testing.assert_array_equal(native.dequantize(int(gtype), blob, x.size),
                                  registry.dequantize(gtype, blob, x.size))


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """f16 source files written by the JAX package: a tiny Falcon (128 wide)
    and a tiny LLaMA 256 wide (K-quants need widths divisible by 256)."""
    d = tmp_path_factory.mktemp("quantize")
    falcon, llama = str(d / "falcon-f16.ggcc"), str(d / "llama-f16.ggjt")
    jsynthetic.write_tiny_model(falcon, FalconHParams.tiny(), ftype_2d=GGMLType.F16, seed=21)
    jsynthetic.write_tiny_llama(llama, LLAMA, ftype_2d=GGMLType.F16, seed=22)
    return {"falcon": falcon, "llama": llama, "dir": d}


def _quiet(*a):
    pass


@pytest.mark.parametrize("family, ftype, native_codec", [
    ("falcon", "q4_0", True), ("falcon", "q4_1", True), ("falcon", "q5_0", True),
    ("falcon", "q5_1", True), ("falcon", "q8_0", False),
    ("llama", "q4_k_m", True), ("llama", "q3_k_s", True), ("llama", "q6_k", False),
], ids=lambda v: str(v))
def test_quantize_file_writes_the_jax_tools_bytes(sources, tmp_path, family, ftype,
                                                  native_codec):
    """quantize_file (the C++ or the numpy codecs) writes the JAX tool's file
    byte for byte: GGCC stays GGCC, GGJT is rewritten as v3, LLaMA's
    K-quants under the mixed policy (wv / w2 of the last layer upgraded)."""
    src = sources[family]
    got, ref = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    stats = quantize.quantize_file(src, got, ftype, log=_quiet, native=native_codec)
    jstats_ = jquantize.quantize_file(src, ref, ftype, log=_quiet)
    assert stats == jstats_ and stats["total_new"] < stats["total_org"]
    assert open(got, "rb").read() == open(ref, "rb").read()
    mf = read_model(got)
    assert mf.arch == family
    if ftype == "q4_k_m":
        types = {n: GGMLType(t.gtype) for n, t in mf.tensors.items()}
        assert types["layers.0.attention.wv.weight"] == GGMLType.Q4_K
        assert types["layers.1.attention.wv.weight"] == GGMLType.Q6_K
        assert types["output.weight"] == GGMLType.F16  # kept without --quantize-output


def test_quantize_main_and_the_output_flag(sources, tmp_path, capsys):
    """The tool's command line: --quantize-output takes lm_head too; its file
    is the JAX tool's."""
    got, ref = str(tmp_path / "port.ggcc"), str(tmp_path / "jax.ggcc")
    assert quantize.main([sources["falcon"], got, "q8_0", "--quantize-output"]) == 0
    out = capsys.readouterr().out
    assert "quantize time" in out and "lm_head.weight" in out
    jquantize.main([sources["falcon"], ref, "q8_0", "--quantize-output", "--no-kcache"])
    assert open(got, "rb").read() == open(ref, "rb").read()
    assert GGMLType(read_model(got).tensors["lm_head.weight"].gtype) == GGMLType.Q8_0


def test_quantize_file_takes_numpy_where_the_cpp_codecs_do_not_build(sources, tmp_path,
                                                                    monkeypatch):
    """With no C++ build (here: lib() raising as a failed g++ does), the tool
    says so and writes the same bytes through the numpy codecs."""
    def no_build():
        raise RuntimeError("building quants.cpp failed")

    monkeypatch.setattr(native, "lib", no_build)
    said = []
    got, ref = str(tmp_path / "port.ggcc"), str(tmp_path / "jax.ggcc")
    quantize.quantize_file(sources["falcon"], got, "q5_1", log=said.append)
    jquantize.quantize_file(sources["falcon"], ref, "q5_1", log=_quiet)
    assert "numpy codecs" in said[0] and open(got, "rb").read() == open(ref, "rb").read()


def test_quantize_refusals_are_the_jax_tools(sources, tmp_path):
    """K-quants on widths not divisible by 256 (Falcon-7B's 4544, here the
    tiny Falcon's 128) and requantizing without --allow-requantize raise as
    the JAX tool does; with the flag, the requantized file is the JAX one."""
    assert not quantize._kquant_ok(GGMLType.Q4_K, (4544, 4672))
    assert quantize._kquant_ok(GGMLType.Q4_K, (4096, 11008))  # LLaMA-7B w1
    assert quantize._kquant_ok(GGMLType.Q4_0, (4544, 4672))
    for tool in (quantize, jquantize):
        with pytest.raises(ValueError, match="not divisible by 256"):
            tool.quantize_file(sources["falcon"], str(tmp_path / "k.ggcc"), "q4_k", log=_quiet)
    q4 = str(tmp_path / "q4.ggcc")
    quantize.quantize_file(sources["falcon"], q4, "q4_0", log=_quiet)
    for tool in (quantize, jquantize):
        with pytest.raises(ValueError, match="allow-requantize"):
            tool.quantize_file(q4, str(tmp_path / "r.ggcc"), "q8_0", log=_quiet)
    got, ref = str(tmp_path / "r_port.ggcc"), str(tmp_path / "r_jax.ggcc")
    quantize.quantize_file(q4, got, "q8_0", allow_requantize=True, log=_quiet)
    jquantize.quantize_file(q4, ref, "q8_0", allow_requantize=True, log=_quiet)
    assert open(got, "rb").read() == open(ref, "rb").read()


@pytest.mark.parametrize("family, extra", [
    ("falcon", []), ("falcon", ["--per-tensor"]),
    ("llama", ["--types", "q4_0,q5_1,q4_K,q6_K,q2_K", "--per-tensor"]),
])
def test_quantize_stats_prints_the_jax_report(sources, capsys, family, extra):
    argv = ["-m", sources[family], *extra]
    assert quantize_stats.main(argv) == 0
    got = capsys.readouterr().out
    jstats.main(argv)
    assert got == capsys.readouterr().out and "rmse" in got


@pytest.mark.parametrize("gtype", [GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q3_K, GGMLType.Q6_K],
                         ids=lambda g: g.name)
def test_synthetic_files_go_through_the_quantizer(tmp_path, gtype):
    """utils/synthetic.py writes every format through the quantizer: the
    port's file is the JAX writer's byte for byte."""
    got, ref = str(tmp_path / "port.ggjt"), str(tmp_path / "jax.ggjt")
    synthetic.write_tiny_llama(got, TLlamaHParams(**vars(LLAMA)), gtype, seed=4)
    jsynthetic.write_tiny_llama(ref, LLAMA, gtype, seed=4)
    assert open(got, "rb").read() == open(ref, "rb").read()
