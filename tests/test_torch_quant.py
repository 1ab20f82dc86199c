"""The port's quantization formats against the JAX package, on the CPU.

For each of the ten block formats (Q4_0 … Q8_0, Q2_K … Q6_K), the same
weights, quantized once by the JAX package's codecs, go through both
packages: codec output, planes and the f32 dequant must be bit-identical.
Q2_K and Q3_K also get rows of random blocks (every scale and min nibble,
negative 6-bit scales, every code). (The plain quant_matmul of every format
is held against the JAX Pallas kernel in tests/test_torch_kernels.py.) Also:
the 16-wide group sums, and what the port still refuses.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ggllm_tpu.core.dtypes import GGMLType
from ggllm_tpu.kernels import layout as jlayout
from ggllm_tpu.kernels import quant_matmul as jqm
from ggllm_tpu.ops.linear import dequant_jnp
from ggllm_tpu.quant import planar as jplanar
from ggllm_tpu.quant import registry as jregistry

from ggllm_tpu_torch.core.dtypes import GGMLType as TGGMLType
from ggllm_tpu_torch.kernels import quant_matmul as tqm
from ggllm_tpu_torch.ops.linear import QuantTensor
from ggllm_tpu_torch.quant import planar as tplanar
from ggllm_tpu_torch.quant import registry as tregistry

ALL = [GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_0,
       GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K]
# bytes of the fp16 fields in a block, for the formats that get random blocks
_F16_BYTES = {GGMLType.Q2_K: (80, 84), GGMLType.Q3_K: (108, 110)}


def _ids(ts):
    return [t.name.lower() for t in ts]


def _blob(gtype, O, K, seed=0):
    """(O, K) random weights quantized row by row by the JAX codecs; a few
    constant and zero rows exercise the degenerate paths. The last two rows
    of a Q2_K / Q3_K blob are random bytes (fp16 fields set to small finite
    values), which no quantizer would write: all 16 values of both Q2_K
    nibbles and the whole signed range of Q3_K's packed 6-bit scales."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((O, K)) * 0.1).astype(np.float32)
    w[1:2] = 0.0
    w[2:3] = 0.25
    blob = np.stack([jregistry.quantize(gtype, w[i]) for i in range(O)])
    if gtype in _F16_BYTES:
        lo, hi = _F16_BYTES[gtype]
        rows = blob[-2:].reshape(2, K // 256, -1)
        rows[:] = rng.integers(0, 256, rows.shape, dtype=np.uint8)
        f16 = (rng.uniform(-1, 1, (2, K // 256, (hi - lo) // 2)) * 0.01).astype(np.float16)
        rows[:, :, lo:hi] = f16.view(np.uint8)
        blob[-2:] = rows.reshape(2, -1)
    return blob


def _port_weight(gtype, blob, O, K) -> QuantTensor:
    planes = tplanar.to_planes(TGGMLType(int(gtype)), blob, O, K)
    return QuantTensor(TGGMLType(int(gtype)), (O, K),
                       {k: torch.from_numpy(v) for k, v in planes.items()})


def _as_jax_dtype(port_plane: np.ndarray, jax_plane: np.ndarray) -> np.ndarray:
    """The port's plane in the JAX package's representation: fp16 scales as
    f32 values (legacy) or int16 bit patterns (K-quants), 5th-bit words as
    uint32."""
    if port_plane.dtype == np.float16:
        return port_plane.view(np.int16) if jax_plane.dtype == np.int16 else port_plane.astype(np.float32)
    if port_plane.dtype == np.int32:
        return port_plane.view(np.uint32)
    return port_plane


@pytest.mark.parametrize("gtype", ALL, ids=_ids(ALL))
def test_codec_matches_jax(gtype):
    """Dequantizing a file blob: the port's codec == the JAX package's."""
    K = 512
    blob = _blob(gtype, 4, K).reshape(-1)
    ref = jregistry.dequantize(gtype, blob, 4 * K, native=False)
    got = tregistry.dequantize(TGGMLType(int(gtype)), blob, 4 * K)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("gtype", ALL, ids=_ids(ALL))
def test_planes_match_jax(gtype):
    """to_planes: the same planes as the JAX package (scales in fp16), and
    from_planes gives back the file's blocks."""
    O, K = 6, 512
    blob = _blob(gtype, O, K)
    ref = jplanar.to_planes(gtype, blob, O, K)
    got = tplanar.to_planes(TGGMLType(int(gtype)), blob, O, K)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(_as_jax_dtype(got[k], ref[k]), ref[k], err_msg=k)
        assert _as_jax_dtype(got[k], ref[k]).dtype == ref[k].dtype, k
    np.testing.assert_array_equal(tplanar.from_planes(TGGMLType(int(gtype)), got), blob)


@pytest.mark.parametrize("gtype", ALL, ids=_ids(ALL))
def test_dequant_matches_jax(gtype):
    """The plain f32 dequant is bit-identical to dequant_jnp."""
    O, K = 6, 512
    blob = _blob(gtype, O, K)
    ref = np.asarray(dequant_jnp(gtype, jplanar.to_planes(gtype, blob, O, K), (O, K),
                                 jnp.float32))
    got = _port_weight(gtype, blob, O, K).dequantize(torch.float32).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("gtype", ALL, ids=_ids(ALL))
def test_planes_from_codes_inverts_extract_codes(gtype):
    """planes_from_codes (used to undo the JAX kernel layout) packs the JAX
    package's per-element codes back into exactly the file's code planes."""
    O, K = 5, 512
    blob = _blob(gtype, O, K)
    jp = jplanar.to_planes(gtype, blob, O, K)
    codes, _, _ = jlayout.extract_codes(gtype, jp, O, K)
    got = tplanar.planes_from_codes(TGGMLType(int(gtype)), codes)
    want = tplanar.to_planes(TGGMLType(int(gtype)), blob, O, K)
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
        assert v.dtype == want[k].dtype, k


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
def test_group_sums_16_match_jax(xdtype):
    """Q6_K's 16-wide group sums: S = 300 runs the JAX _xg_kern."""
    S, K, g = 300, 512, 16
    x = np.random.default_rng(3).standard_normal((S, K)).astype(np.float32)
    out = np.asarray(jqm._group_sums(jnp.asarray(x, jnp.dtype(xdtype)), 1, K, g, 256,
                                     interpret=True))
    ref = out.reshape(S, 1, -1)[:, :, : K // g].reshape(S, K // g)
    got = tqm.group_sums(torch.from_numpy(x).to(getattr(torch, xdtype)), g).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("gtype", [GGMLType.Q2_K, GGMLType.Q3_K], ids=["q2_k", "q3_k"])
def test_unported_formats_raise(gtype):
    """What the port still refuses: the Q2_K and Q3_K quantizers (the port
    reads and multiplies both formats but cannot write them from floats),
    and planes or a QuantTensor of a type that is no weight format."""
    x = np.zeros(256, np.float32)
    assert not tregistry.can_quantize(TGGMLType(int(gtype)))
    with pytest.raises(NotImplementedError):
        tregistry.quantize(TGGMLType(int(gtype)), x)
    with pytest.raises(NotImplementedError):
        tplanar.to_planes(TGGMLType.Q8_K, np.zeros(292, np.uint8), 1, 256)
    with pytest.raises(NotImplementedError):
        QuantTensor(TGGMLType.Q8_1, (1, 32), {})


def test_q3k_scale_packing_round_trips():
    """Every signed 6-bit scale value in every one of the 16 slots packs into
    the 12 bytes the JAX package's decoder reads back."""
    from ggllm_tpu.quant.kquants import _q3k_decode_scales as jdecode
    from ggllm_tpu_torch.quant.kquants import _q3k_decode_scales, _q3k_pack_scales

    sc = np.random.default_rng(5).integers(-32, 32, (400, 16))
    sc[:64] = (np.arange(64) - 32)[:, None]
    packed = _q3k_pack_scales(sc)
    assert packed.shape == (400, 12) and packed.dtype == np.uint8
    np.testing.assert_array_equal(jdecode(packed), sc)
    np.testing.assert_array_equal(_q3k_decode_scales(packed), sc)


def test_k_quant_width_must_be_whole_super_blocks():
    """A K-quant weight's planes cannot describe a width that is not a
    multiple of 256."""
    blob = _blob(GGMLType.Q4_K, 2, 512)
    with pytest.raises(ValueError):
        tplanar.to_planes(TGGMLType.Q4_K, blob, 2, 500)
