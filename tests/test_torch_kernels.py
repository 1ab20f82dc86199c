"""The PyTorch port's kernel modules against the JAX package, on the CPU
(quant_matmul in every ported format).

The same numpy inputs (fixed seeds) go through the JAX function (Pallas in
interpret mode) and through the port's wrapper, which on a CPU tensor runs
the kernel's plain version. Tolerances are those of tests/test_kernels.py:45
(2e-5 of max |ref| in f32, 2e-2 in bf16) and test_flash_*.py (atol 1e-5).
The int8 KV cache: quantize_new must equal the JAX function exactly, and the
flash-decode functions take the same (codes, scales) in both packages.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ggllm_tpu.core.dtypes import GGMLType
from ggllm_tpu.kernels import flash_decode as jfd
from ggllm_tpu.kernels import layout as jlayout
from ggllm_tpu.kernels import quant_matmul as jqm
from ggllm_tpu.kernels.flash_attention import flash_mqa as jflash_mqa
from ggllm_tpu.ops import kvcache as jkvcache
from ggllm_tpu.quant import planar as jplanar
from ggllm_tpu.quant import registry as jregistry

from ggllm_tpu_torch.core.dtypes import GGMLType as TGGMLType
from ggllm_tpu_torch.kernels import build
from ggllm_tpu_torch.kernels import flash_decode as tfd
from ggllm_tpu_torch.kernels import quant_matmul as tqm
from ggllm_tpu_torch.kernels.flash_attention import flash_mqa, flash_mqa_plain
from ggllm_tpu_torch.ops import kvcache as tkvcache
from ggllm_tpu_torch.ops.linear import QuantTensor
from ggllm_tpu_torch.quant import planar as tplanar


def _weights(gtype, O, K, seed=0):
    """JAX planar planes of a random quantized (O, K) weight, and the port's
    QuantTensor over the planes of the same blocks."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((O, K)) * 0.1).astype(np.float32)
    blob = np.stack([jregistry.quantize(gtype, w[i]) for i in range(O)]).reshape(O, -1)
    planes = jplanar.to_planes(gtype, blob, O, K)
    tplanes = tplanar.to_planes(TGGMLType(int(gtype)), blob, O, K)
    tq = QuantTensor(TGGMLType(int(gtype)), (O, K),
                     {k: torch.from_numpy(v) for k, v in tplanes.items()})
    return planes, tq


FORMATS = [GGMLType.Q4_0, GGMLType.Q8_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1,
           GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K, GGMLType.Q2_K, GGMLType.Q3_K]


@pytest.mark.parametrize("gtype", FORMATS, ids=[f.name.lower() for f in FORMATS])
@pytest.mark.parametrize("S", [1, 4, 300])
@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
def test_quant_matmul_matches_jax(gtype, S, xdtype):
    O, K = 64, 512
    planes, tq = _weights(gtype, O, K, seed=S)
    kq = jlayout.to_kernel(gtype, planes, (O, K))
    x = np.random.default_rng(1).standard_normal((S, K)).astype(np.float32)
    ref = np.asarray(jqm.fused_matmul(kq, jnp.asarray(x, jnp.dtype(xdtype)), jnp.float32,
                                      interpret=True))
    got = tqm.quant_matmul(tq, torch.from_numpy(x).to(getattr(torch, xdtype)),
                           torch.float32).numpy()
    tol = 2e-5 if xdtype == "float32" else 2e-2
    scale = np.abs(ref).max() + 1e-6
    np.testing.assert_allclose(got / scale, ref / scale, atol=tol)


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
def test_group_sums_match_jax(xdtype):
    """S = 300 runs the JAX _xg_kern; compare its real (unpadded) groups."""
    S, K, g = 300, 256, 32
    x = np.random.default_rng(3).standard_normal((S, K)).astype(np.float32)
    out = np.asarray(jqm._group_sums(jnp.asarray(x, jnp.dtype(xdtype)), 1, K, g, 256,
                                     interpret=True))
    ref = out.reshape(S, 1, -1)[:, :, : K // g].reshape(S, K // g)
    got = tqm.group_sums(torch.from_numpy(x).to(getattr(torch, xdtype))).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("H,KV", [(8, 1), (8, 2)], ids=["mqa", "gqa"])
@pytest.mark.parametrize("n_past", [0, 7])
def test_flash_mqa_matches_jax(H, KV, n_past):
    B, S, T, D = 1, 32, 128, 64
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = np.zeros((B, T, KV, D), np.float32)
    v = np.zeros((B, T, KV, D), np.float32)
    fill = n_past + S + 4
    k[:, :fill] = rng.standard_normal((B, fill, KV, D))
    v[:, :fill] = rng.standard_normal((B, fill, KV, D))
    ref = np.asarray(jflash_mqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.int32(n_past), block_s=16, block_t=64, interpret=True))
    got = flash_mqa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), n_past)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


CASES = [  # tests/test_flash_decode.py CASES
    ("mqa", 1, 5),
    ("gqa", 2, 6),
    ("mha", 4, 4),
]


def _decode_inputs(B, T, KV, H, D, A, seed):
    rng = np.random.default_rng(seed)
    kv = rng.standard_normal((3, 2, B, T, KV, D)).astype(np.float32)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    app = rng.standard_normal((2, B, A, KV, D)).astype(np.float32)
    return kv, q, app


@pytest.mark.parametrize("name,KV,H", CASES)
@pytest.mark.parametrize("variant", ["no_append", "append", "append_valid"])
def test_flash_decode_matches_jax(name, KV, H, variant):
    B, T, D, l = 2, 64, 8, 1
    A = 1 if variant == "append" else 9
    kv, q, app = _decode_inputs(B, T, KV, H, D, A, seed=len(name) + A)
    n_past = np.asarray([33, 4], np.int32)
    kw_j, kw_t = {}, {}
    if variant != "no_append":
        kw_j["kv_append"], kw_t["kv_append"] = jnp.asarray(app), torch.from_numpy(app)
    if variant == "append_valid":
        kw_j["append_valid"], kw_t["append_valid"] = jnp.int32(5), 5
    L = kv.shape[0]
    ref = np.asarray(jfd.flash_decode(jnp.asarray(kv.reshape(L, 2, B, T, KV * D)), KV, l,
                                      jnp.asarray(q), jnp.asarray(n_past), interpret=True,
                                      **kw_j))
    got = tfd.flash_decode(torch.from_numpy(kv), KV, l, torch.from_numpy(q),
                           torch.from_numpy(n_past), **kw_t)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def _int8_cache(L, B, T, KV, D, seed):
    """A random cache quantized by the JAX package: its (codes, scales
    (L, 2, B, T, KV, 1)) as numpy."""
    dense = np.random.default_rng(seed).standard_normal((L, 2, B, T, KV, D)).astype(np.float32)
    codes, scales = jkvcache.quantize_new(jnp.asarray(dense))
    return np.asarray(codes), np.asarray(scales)


def _jax_int8_view(codes, scales):
    """The JAX kernel's operand: merged codes and (L, 2, B, KV, T) scales."""
    L, _, B, T, KV, D = codes.shape
    return (jnp.asarray(codes.reshape(L, 2, B, T, KV * D)),
            jnp.asarray(np.moveaxis(scales[..., 0], 3, 4)))


@pytest.mark.parametrize("shape", [(2, 1, 5, 1, 64), (3, 2, 2, 7, 4, 8)], ids=["kv_new", "stacked"])
def test_quantize_new_matches_jax(shape):
    """Codes and f32 scales equal the JAX function's exactly, including an
    all-zero vector (scale 1e-8 / 127, codes 0), ties (round half to even)
    and the clip at +-127."""
    x = (np.random.default_rng(2).standard_normal(shape) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[-1, -1, -1, ..., :4] = [127.0, 63.5, -0.5, 2.5]  # absmax 127: scale 1, exact ties
    ref_q, ref_s = jkvcache.quantize_new(jnp.asarray(x))
    got_q, got_s = tkvcache.quantize_new(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    assert float(got_s.reshape(-1, got_s.shape[-2], 1)[0, 0, 0]) == np.float32(1e-8) / np.float32(127.0)


INT8_CASES = [(1, 5, 8), (2, 6, 8)]  # tests/test_flash_decode.py:132, the cases with G > 1


@pytest.mark.parametrize("KV,H,D", INT8_CASES, ids=["mqa", "gqa"])
def test_int8_cache_partials_match_jax(KV, H, D):
    """The plain partials on the int8 pair against the JAX Pallas kernel with
    quant=True (interpret mode); rtol/atol 1e-5 in f32."""
    B, T, L, l = 2, 96, 2, 1
    codes, scales = _int8_cache(L, B, T, KV, D, seed=21)
    q = np.random.default_rng(22).standard_normal((B, KV, H // KV, D)).astype(np.float32)
    valid = np.asarray([60, 9], np.int32)
    ref = jfd.cache_partials(_jax_int8_view(codes, scales), KV, l, jnp.asarray(q),
                             jnp.asarray(valid), interpret=True)
    got = tfd.cache_partials(tkvcache.from_jax_cache((codes, scales), device="cpu"), KV, l,
                             torch.from_numpy(q), torch.from_numpy(valid))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("KV,H,D", INT8_CASES, ids=["mqa", "gqa"])
@pytest.mark.parametrize("variant", ["no_append", "append_valid"])
def test_int8_flash_decode_matches_jax(KV, H, D, variant):
    """flash_decode over an int8 cache, with and without the unquantized
    [current; pending] append block, against the JAX function (atol 1e-5)."""
    B, T, L, l = 2, 96, 2, 1
    codes, scales = _int8_cache(L, B, T, KV, D, seed=23)
    rng = np.random.default_rng(24)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    app = rng.standard_normal((2, B, 5, KV, D)).astype(np.float32)
    n_past = np.asarray([60, 9], np.int32)
    kw_j, kw_t = {}, {}
    if variant == "append_valid":
        kw_j = {"kv_append": jnp.asarray(app), "append_valid": jnp.int32(3)}
        kw_t = {"kv_append": torch.from_numpy(app), "append_valid": 3}
    ref = np.asarray(jfd.flash_decode(_jax_int8_view(codes, scales), KV, l, jnp.asarray(q),
                                      jnp.asarray(n_past), interpret=True, **kw_j))
    got = tfd.flash_decode(tkvcache.from_jax_cache((codes, scales), device="cpu"), KV, l,
                           torch.from_numpy(q), torch.from_numpy(n_past), **kw_t)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


MHA_CASES = [(2, 64), (16, 8), (4, 32)]  # (KV, D) with G == 1 and KV * D % 128 == 0


def _mha_operands(KV, D, cache, seed):
    """A 3-layer random cache (B = 2, T = 96), dense f32 or quantized by the
    JAX package, as both packages take it; the JAX side gets the merged
    (L, 2, B, T, KV*D) view (and, int8, scales transposed to (L, 2, B, KV, T))."""
    B, T, L = 2, 96, 3
    if cache == "int8":
        codes, scales = _int8_cache(L, B, T, KV, D, seed)
        return _jax_int8_view(codes, scales), tkvcache.from_jax_cache((codes, scales), device="cpu")
    kv = np.random.default_rng(seed).standard_normal((L, 2, B, T, KV, D)).astype(np.float32)
    return jnp.asarray(kv.reshape(L, 2, B, T, KV * D)), torch.from_numpy(kv)


@pytest.mark.parametrize("KV,D", MHA_CASES)
@pytest.mark.parametrize("cache", ["dense", "int8"])
def test_mha_cache_partials_match_jax(KV, D, cache, monkeypatch):
    """G == 1: the plain partials against the JAX `_cache_partials_mha`
    Pallas kernel (interpret mode), per-row cache_valid with one row below a
    time tile and one empty; rtol/atol 1e-5 in f32."""
    taken = []
    real = jfd._cache_partials_mha
    monkeypatch.setattr(jfd, "_cache_partials_mha",
                        lambda *a, **k: taken.append(1) or real(*a, **k))
    jkv, tkv = _mha_operands(KV, D, cache, seed=31)
    q = np.random.default_rng(32).standard_normal((2, KV, 1, D)).astype(np.float32)
    for valid in ([70, 9], [96, 0]):
        valid = np.asarray(valid, np.int32)
        ref = jfd.cache_partials(jkv, KV, 1, jnp.asarray(q), jnp.asarray(valid), interpret=True)
        got = tfd.cache_partials(tkv, KV, 1, torch.from_numpy(q), torch.from_numpy(valid))
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
    assert len(taken) == 2  # the JAX side did run the G == 1 kernel


@pytest.mark.parametrize("KV,D", MHA_CASES)
@pytest.mark.parametrize("cache", ["dense", "int8"])
@pytest.mark.parametrize("variant", ["no_append", "append", "append_valid", "empty_cache"])
def test_mha_flash_decode_matches_jax(KV, D, cache, variant):
    """G == 1 flash_decode against the JAX function (atol 1e-5): the current
    token already written; a one-entry append; a chunked append of which 4 of
    9 entries are valid; and nothing valid in the cache yet (row 0: n_past 2
    with 3 valid append entries), per-row n_past throughout."""
    A = 1 if variant == "append" else 9
    jkv, tkv = _mha_operands(KV, D, cache, seed=33 + A)
    rng = np.random.default_rng(34)
    q = rng.standard_normal((2, 1, KV, D)).astype(np.float32)
    app = rng.standard_normal((2, 2, A, KV, D)).astype(np.float32)
    n_past = np.asarray([70, 9], np.int32)
    kw_j, kw_t = {}, {}
    if variant != "no_append":
        kw_j["kv_append"], kw_t["kv_append"] = jnp.asarray(app), torch.from_numpy(app)
    if variant == "append_valid":
        kw_j["append_valid"], kw_t["append_valid"] = jnp.int32(4), 4
    if variant == "empty_cache":
        n_past = np.asarray([2, 40], np.int32)
        kw_j["append_valid"], kw_t["append_valid"] = jnp.int32(3), 3
    ref = np.asarray(jfd.flash_decode(jkv, KV, 1, jnp.asarray(q), jnp.asarray(n_past),
                                      interpret=True, **kw_j))
    got = tfd.flash_decode(tkv, KV, 1, torch.from_numpy(q), torch.from_numpy(n_past), **kw_t)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("n_past", [0, 7])
def test_flash_mqa_matches_jax_at_llama_heads(n_past):
    """G == 1 at D = 128 (LLaMA's head shape), atol 1e-5."""
    B, S, T, H, D = 1, 32, 128, 4, 128
    rng = np.random.default_rng(8)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, H, D)).astype(np.float32)
    v = rng.standard_normal((B, T, H, D)).astype(np.float32)
    ref = np.asarray(jflash_mqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.int32(n_past), block_s=16, block_t=64, interpret=True))
    got = flash_mqa_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), n_past)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_cache_partials_empty_row():
    """cache_valid = 0 gives m = -1e30, l = 0, acc = 0 (as the JAX kernel)."""
    kv, q, _ = _decode_inputs(1, 16, 1, 3, 8, 1, seed=4)
    acc, m, l = tfd.cache_partials(torch.from_numpy(kv), 1, 0,
                                   torch.from_numpy(q).reshape(1, 1, 3, 8), 0)
    assert torch.all(m == -1e30) and torch.all(l == 0) and torch.all(acc == 0)


def test_cpu_wrappers_run_plain_and_count_nothing():
    """A wrapper given CPU tensors runs the plain version and leaves its
    launch counter unchanged."""
    before = dict(build.launch_counts)
    _, tq = _weights(GGMLType.Q4_0, 32, 64)
    x = torch.randn(3, 64, generator=torch.Generator().manual_seed(0))
    assert torch.equal(tqm.quant_matmul(tq, x, torch.float32),
                       tqm.quant_matmul_plain(tq, x, torch.float32))
    assert torch.equal(tqm.group_sums(x), tqm.group_sums_plain(x))
    q = torch.randn(1, 4, 2, 32)
    k = torch.randn(1, 8, 1, 32)
    assert torch.equal(flash_mqa(q, k, k, 2), flash_mqa_plain(q, k, k, 2))
    kv = torch.randn(2, 2, 1, 8, 1, 32)
    qg = torch.randn(1, 1, 2, 32)
    for a, b in zip(tfd.cache_partials(kv, 1, 1, qg, 5), tfd.cache_partials_plain(kv, 1, 1, qg, 5)):
        assert torch.equal(a, b)
    kv8 = tkvcache.quantize_new(kv)
    for a, b in zip(tfd.cache_partials(kv8, 1, 1, qg, 5), tfd.cache_partials_plain(kv8, 1, 1, qg, 5)):
        assert torch.equal(a, b)
    assert dict(build.launch_counts) == before


# ---- dense linear: the weight's own dtype, f32 accumulation

@pytest.mark.parametrize("wdtype", ["float16", "bfloat16", "float32"])
@pytest.mark.parametrize("out", [None, "float32"], ids=["x_dtype", "f32_out"])
def test_dense_linear_matches_jax(wdtype, out):
    """ops/linear.py linear on a dense weight against the JAX function: the
    product in the operands' (promoted) dtype with f32 accumulation, the
    output in out_dtype (default x's). bf16 x with a bf16 weight rounds
    only the output (1e-2 of max |ref| for a bf16 output, 1e-5 in f32);
    bf16 x with an F16 weight promotes to f32 in both packages."""
    from ggllm_tpu.ops.linear import linear as jlinear

    from ggllm_tpu_torch.ops.linear import linear

    rng = np.random.default_rng(3)
    w = (rng.standard_normal((96, 256)) * 0.1).astype(wdtype)
    x = rng.standard_normal((5, 256)).astype(np.float32)
    xdtype = "float32" if wdtype == "float32" else "bfloat16"
    jx = jnp.asarray(x, dtype=xdtype)
    ref = np.asarray(jlinear(jnp.asarray(w), jx, None if out is None else jnp.float32))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, xdtype))
    got = linear(torch.from_numpy(w) if wdtype != "bfloat16"
                 else torch.from_numpy(w.astype(np.float32)).to(torch.bfloat16), tx,
                 None if out is None else torch.float32)
    assert str(got.dtype).removeprefix("torch.") == str(ref.dtype)
    scale = float(np.abs(ref.astype(np.float32)).max())
    tol = 1e-2 if got.dtype == torch.bfloat16 else 1e-5
    np.testing.assert_allclose(got.float().numpy() / scale, ref.astype(np.float32) / scale, atol=tol)


# ---- one-launch flash-decode: the split plan and the in-launch merge

PLAN_SHAPES = [(1, 1, 71, 64, "bfloat16"), (1, 8, 16, 64, "bfloat16"), (1, 32, 1, 128, "bfloat16"),
               (1, 1, 71, 64, "int8"), (1, 32, 1, 128, "int8"), (2, 2, 4, 128, "bfloat16"),
               (4, 8, 16, 64, "int8")]


@pytest.mark.parametrize("B,KV,G,D,cache", PLAN_SHAPES)
def test_decode_plan(B, KV, G, D, cache):
    """Every split holds keys, the splits cover the length, at least MIN_KEYS
    keys a split (16 at the least), no more blocks than WAVES an SM, and
    the workspace sized for the cache length T holds every shorter plan."""
    T = 2560
    ws = tfd._splits(T, B, KV, G, D, cache, 132, tfd.route(KV, G, D, cache))
    prev = 0
    for valid in [0, 1, 15, 16, 31, 32, 33, 64, 100, 300, 1000, 2047, 2048, 2560]:
        n, chunk = tfd.decode_plan(valid, B, KV, G, D, cache)
        assert chunk % 16 == 0 and chunk >= 16 and 1 <= n <= ws
        assert n * chunk >= valid and (n - 1) * chunk < max(valid, 1)
        assert n == 1 or chunk >= tfd.MIN_KEYS
        assert B * KV * n < tfd.WAVES * 132 + B * KV
        assert n >= prev
        prev = n
    assert tfd.decode_plan(300, B, KV, G, 32, "float32", rt="simt") == (5, 64)


def _emulation_case(KV, H, D, cache, seed, A=9):
    B, T, L = 1, 512, 2  # T: a whole number of the JAX G == 1 kernel's 256-position tiles
    rng = np.random.default_rng(seed)
    if cache == "int8":
        codes, scales = _int8_cache(L, B, T, KV, D, seed)
        jkv = _jax_int8_view(codes, scales)
        tkv = tkvcache.from_jax_cache((codes, scales), device="cpu")
    else:
        kv = rng.standard_normal((L, 2, B, T, KV, D)).astype(np.float32)
        jkv, tkv = jnp.asarray(kv.reshape(L, 2, B, T, KV * D)), torch.from_numpy(kv)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    app = rng.standard_normal((2, B, A, KV, D)).astype(np.float32)
    return jkv, tkv, q, app


@pytest.mark.parametrize("KV,H,D,rt", [(1, 40, 64, "tc"), (2, 8, 128, "tc"), (4, 4, 32, "mha"),
                                       (1, 5, 32, "simt")])
@pytest.mark.parametrize("cache", ["float32", "int8"])
@pytest.mark.parametrize("n_past,append", [(299, False), (40, False), (0, False), (250, True),
                                           (3, True)])
def test_one_launch_merge_matches_jax(KV, H, D, rt, cache, n_past, append):
    """decode_emulated (the kernels' splits, each split's partial, the last
    block's merge of the splits and the append block) in f32 against
    flash_decode_plain and the JAX flash_decode, atol 1e-5; 4 of the 9
    append entries are valid, so the cache is valid below n_past - 3."""
    jkv, tkv, q, app = _emulation_case(KV, H, D, cache, seed=n_past + D)
    kw_j, kw_t = {}, {}
    if append:
        kw_j = {"kv_append": jnp.asarray(app), "append_valid": jnp.int32(4)}
        kw_t = {"kv_append": torch.from_numpy(app), "append_valid": 4}
    tq = torch.from_numpy(q)
    if rt == "simt" or n_past < 5:  # a small group: give the splits a few keys each
        n_sm = 4
    else:
        n_sm = 132
    got = tfd.decode_emulated(tkv, KV, 1, tq, n_past, **kw_t, n_sm=n_sm, rt=rt, round_p=False)
    plain = tfd.flash_decode_plain(tkv, KV, 1, tq, n_past, **kw_t)
    ref = np.asarray(jfd.flash_decode(jkv, KV, 1, jnp.asarray(q), jnp.int32(n_past),
                                      interpret=True, **kw_j))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    valid = n_past + (1 if not append else -3)
    n, _ = tfd.decode_plan(max(valid, 0), 1, KV, H // KV, D, cache, n_sm, rt)
    assert n > 1 or valid < 64


@pytest.mark.parametrize("KV,H,D,rt", [(1, 40, 64, "tc"), (2, 8, 128, "tc"), (4, 4, 32, "mha"),
                                       (1, 5, 32, "simt")])
@pytest.mark.parametrize("valid", [[200, 7], [0, 65], "tensor"])
@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_partials_emulated_per_row_lengths(KV, H, D, rt, valid, cache):
    """partials_emulated with a length per row (a list, or an int32 tensor,
    for which the splits are planned by the cache length as the wrapper
    plans them) in f32 against cache_partials_plain: acc and l within 1e-5
    of max |ref|, m to 1e-6; an empty row is (0, -1e30, 0)."""
    L, B, T = 2, 2, 256
    g = torch.Generator().manual_seed(H * D + len(str(valid)))
    kv = torch.randn(L, 2, B, T, KV, D, generator=g)
    if cache == "int8":
        kv = tkvcache.quantize_new(kv)
    qg = torch.randn(B, KV, H // KV, D, generator=g)
    lens = torch.tensor([300 - 100, 9], dtype=torch.int32) if valid == "tensor" else valid
    got = tfd.partials_emulated(kv, KV, 1, qg, lens, n_sm=8, rt=rt, round_p=False)
    ref = tfd.cache_partials_plain(kv, KV, 1, qg, lens)
    for a, r, tol in zip(got, ref, (1e-5, 1e-6, 1e-5)):
        assert float((a - r).abs().max()) <= tol * max(1.0, float(r.abs().max()))
    if valid != [0, 65]:  # the rows' lengths cut across several splits
        n, _ = tfd.decode_plan(T if valid == "tensor" else 200, B, KV, H // KV, D, cache, 8, rt)
        assert n > 1


@pytest.mark.parametrize("KV,H,D", [(1, 71, 64), (8, 128, 64), (2, 8, 128)])
@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
def test_bf16_p_emulation_within_tolerance(KV, H, D, cache):
    """The tensor-core route rounds P (times V's int8 scale) to bf16 before
    the P V product: with bf16 q and K/V, the emulation stays within 2e-2 of
    max |ref| of the f32 plain version, at several split counts."""
    L, B, T = 2, 1, 2100
    g = torch.Generator().manual_seed(H + D)
    kv = torch.randn(L, 2, B, T, KV, D, generator=g)
    kv = tkvcache.quantize_new(kv) if cache == "int8" else kv.to(torch.bfloat16)
    q = torch.randn(B, 1, H, D, generator=g).to(torch.bfloat16)
    app = torch.randn(2, B, 16, KV, D, generator=g).to(torch.bfloat16)
    for n_past, kw in ((2046, {}), (299, {}), (0, {}), (304, {"kv_append": app, "append_valid": 5})):
        ref = tfd.flash_decode_plain(kv, KV, 0, q.float(), n_past, **kw).float()
        got = tfd.decode_emulated(kv, KV, 0, q, n_past, **kw).float()
        assert float((got - ref).abs().max()) <= 2e-2 * float(ref.abs().max())
