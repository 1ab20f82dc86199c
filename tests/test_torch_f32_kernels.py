"""The arithmetic of the port's f32 prefill kernels, checked on the CPU.

The kernels (csrc/quant_gemm_f32.cuh, csrc/flash_attention_f32.cu) run only
on the card. What they compute is restated in the wrapper modules and held
here against the JAX package's Pallas kernels in interpret mode, on f32
inputs, at 2e-5 of max |ref| (the f32 tolerance of the card tests):
 * the f32 tile cuts x into three bf16 terms that sum to x exactly
   (`split_bf16x3`, a property over floats) and multiplies them by the exact
   codes (`f32_tile_emulated`): all ten formats;
 * the f32 attention kernel rounds to TF32 as its `cvt.rna` does
   (`tf32_rna`) and forms each product from three split-TF32 products
   (`flash_mqa_f32_emulated`): Falcon's grouped heads at D = 64 and LLaMA's
   G == 1 at D = 128, with and without cached positions;
 * negative controls: with one bf16 term of x, or one TF32 product, the same
   restatements land outside 2e-5, so the tolerance tells f32 accuracy from
   bf16 or TF32 accuracy;
 * the f32 attention kernel's block plan at its own tile widths.
"""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from ggllm_tpu.core.dtypes import GGMLType
from ggllm_tpu.kernels import flash_attention as jfa
from ggllm_tpu.kernels import layout as jlayout
from ggllm_tpu.kernels import quant_matmul as jqm
from ggllm_tpu.quant import planar as jplanar
from ggllm_tpu.quant import registry as jregistry

from ggllm_tpu_torch.core.dtypes import GGMLType as TGGMLType
from ggllm_tpu_torch.kernels import flash_attention as tfa
from ggllm_tpu_torch.kernels import quant_matmul as tqm
from ggllm_tpu_torch.ops.linear import QuantTensor
from ggllm_tpu_torch.quant import planar as tplanar

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)

TOL = 2e-5  # of max |ref|: tests/test_torch_cuda.py's f32 tolerance
FORMATS = [GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_0,
           GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K]
IDS = [f.name.lower() for f in FORMATS]
ATTN = [(8, 1, 64, 0), (8, 1, 64, 37), (4, 4, 128, 0), (4, 4, 128, 37)]
ATTN_IDS = [f"H{h}_KV{kv}_D{d}_past{p}" for h, kv, d, p in ATTN]


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _f32(bits: int) -> torch.Tensor:
    return torch.tensor([bits], dtype=torch.int32).view(torch.float32)


# ---------------------------------------------------------------- the splits

@settings(max_examples=300, deadline=None)
@given(st.floats(width=32, allow_nan=False, allow_infinity=False, allow_subnormal=False))
def test_bf16_split_is_exact(v):
    """x0 + x1 + x2 == x bit for bit wherever |x| >= 2^-110, each term a
    bf16 value (low 16 bits zero), no term larger than x; below 2^-110 the
    sum is within 2^-133 of x."""
    x = torch.tensor([v], dtype=torch.float32)
    terms = tqm.split_bf16x3(x)
    for t in terms:
        assert int(t.view(torch.int32)) & 0xFFFF == 0
        assert abs(float(t)) <= abs(v)
    total = (terms[0] + terms[1]) + terms[2]  # the pairwise sums are exact
    if v == 0:
        assert float(total) == 0
    elif abs(v) >= 2.0 ** -110:
        assert torch.equal(total.view(torch.int32), x.view(torch.int32))
    else:
        assert abs(float(total) - v) <= 2.0 ** -133


def test_bf16_split_edges():
    """The largest finite float (a rounding split would overflow to inf
    there), 2^-110 with its last bit set (the smallest exponent that stays
    exact), the smallest normal (within 2^-133), -0, and a value whose three
    terms are all nonzero."""
    for bits, exact in ((0x7F7FFFFF, True), (0x08800001, True), (0x00800001, False),
                        (-0x80000000, True), (0x3F812345, True)):
        x = _f32(bits)
        x0, x1, x2 = tqm.split_bf16x3(x)
        total = (x0 + x1) + x2
        assert torch.isfinite(x0).all()
        if exact:
            assert float(total) == float(x)
        else:
            assert abs(float(total) - float(x)) <= 2.0 ** -133
    x0, x1, x2 = tqm.split_bf16x3(_f32(0x3F812345))
    assert float(x1) != 0 and float(x2) != 0


def _tf32_split_error(v: float) -> tuple[float, bool]:
    """(|hi + lo - v|, whether the remainder v - hi is a normal float) of
    split_tf32, after checking that hi and lo are TF32 values and that hi
    is the nearest one (the dropped part at most half a unit)."""
    x = torch.tensor([v], dtype=torch.float32)
    hi, lo = tfa.split_tf32(x)
    for t in (hi, lo):
        assert int(t.view(torch.int32)) & 0x1FFF == 0
    ulp = 2.0 ** (np.floor(np.log2(abs(v))) - 10) if v else 0.0
    assert abs(float(hi) - v) <= ulp / 2 * (1 + 1e-12)
    rem = float(x - hi)  # exact: hi holds the leading bits of x
    return abs((float(hi) + float(lo)) - v), rem == 0 or abs(rem) >= 2.0 ** -126


@settings(max_examples=200, deadline=None)
@given(st.floats(width=32, min_value=-2.0 ** 127, max_value=2.0 ** 127, allow_nan=False,
                 allow_subnormal=False))
@example(2.2522432626291517e-38)
def test_tf32_split_keeps_22_bits(v):
    """tf32_rna keeps 10 mantissa bits, rounding to nearest with ties away
    from zero; hi + lo is within 2^-21 |x| of x wherever the remainder
    x - hi is a normal float, and within max(2^-21 |x|, 2^-137) where it is
    subnormal: the conversion drops its bits below 2^-136 (split_tf32's
    contract). The example is a draw whose remainder is -2.2e-43."""
    err, normal = _tf32_split_error(v)
    if normal:
        assert err <= abs(v) * 2.0 ** -21
    else:
        assert err <= max(abs(v) * 2.0 ** -21, 2.0 ** -137)


def test_tf32_split_edges():
    """The smallest normal (exact), 2.2522432626291517e-38 (a subnormal
    remainder: within 2^-137 but not within 2^-21 |x|), a value whose
    remainder is normal (the relative bound, with lo nonzero) and 2^127
    (exact, no overflow)."""
    err, normal = _tf32_split_error(2.0 ** -126)
    assert err == 0 and normal
    v = 2.2522432626291517e-38
    err, normal = _tf32_split_error(v)
    assert not normal and abs(v) * 2.0 ** -21 < err <= 2.0 ** -137
    v = float(_f32(0x3F812345))
    err, normal = _tf32_split_error(v)
    assert normal and err <= abs(v) * 2.0 ** -21
    assert float(tfa.split_tf32(_f32(0x3F812345))[1]) != 0
    err, normal = _tf32_split_error(2.0 ** 127)
    assert err == 0 and normal


def test_tf32_rounds_ties_away_from_zero():
    """1 + 2^-11 lies halfway between two TF32 values: .rna takes the one
    farther from zero (round-to-even would keep 1)."""
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11)], dtype=torch.float32)
    assert tfa.tf32_rna(tie).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10)]


# -------------------------------------------------------------- the f32 tile

@functools.lru_cache(maxsize=None)
def _tile_case(gtype):
    """(port QuantTensor, x, the Pallas kernel's y in interpret mode) for one
    format: O = 64 rows quantized from a seed, K = 512, S = 17 rows of f32 x."""
    O, K, S = 64, 512, 17
    rng = np.random.default_rng(100 + int(gtype))
    dense = (rng.standard_normal((O, K)) * 0.1).astype(np.float32)
    blob = np.stack([jregistry.quantize(gtype, dense[i]) for i in range(O)]).reshape(O, -1)
    kq = jlayout.to_kernel(gtype, jplanar.to_planes(gtype, blob, O, K), (O, K))
    tg = TGGMLType(int(gtype))
    w = QuantTensor(tg, (O, K), {k: torch.from_numpy(v)
                                 for k, v in tplanar.to_planes(tg, blob, O, K).items()})
    x = rng.standard_normal((S, K)).astype(np.float32)
    ref = np.asarray(jqm.fused_matmul(kq, jnp.asarray(x), jnp.float32, interpret=True))
    return w, torch.from_numpy(x), ref


@pytest.mark.parametrize("gtype", FORMATS, ids=IDS)
def test_f32_tile_restatement_matches_jax_kernel(gtype):
    """Exact codes times the three bf16 terms of x, f32 group partials, then
    s P - c xg: within 2e-5 of the Pallas kernel's f32 product."""
    w, x, ref = _tile_case(gtype)
    got = tqm.f32_tile_emulated(w, x)
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert _rel(got.numpy(), ref) <= TOL


@pytest.mark.parametrize("gtype", FORMATS, ids=IDS)
def test_f32_tile_with_one_bf16_term_misses_the_tolerance(gtype):
    """The negative control: x0 alone (bf16 x) lands outside 2e-5, and two
    terms land between one and three."""
    w, x, ref = _tile_case(gtype)
    errs = [_rel(tqm.f32_tile_emulated(w, x, terms=n).numpy(), ref) for n in (1, 2, 3)]
    assert errs[0] > TOL and errs[2] <= TOL
    assert errs[2] <= errs[1] <= errs[0]


@pytest.mark.parametrize("gtype", FORMATS, ids=IDS)
def test_tile_codes_times_scales_are_the_dequant(gtype):
    """The raw codes the f32 tile multiplies (tc_codes), scaled as its
    epilogue scales them (q s - c), are the plain f32 dequantize."""
    w, _, _ = _tile_case(gtype)
    s, c = tqm.tc_group_scales(w)
    width = tqm.KERNEL_FORMATS[w.gtype][0]
    group = torch.arange(w.shape[1]) // width
    q = tqm.tc_codes(w).to(torch.float32)
    assert torch.allclose(q * s[:, group] - c[:, group], w.dequantize(torch.float32),
                          rtol=0, atol=1e-6 * float(s.abs().max()))


@pytest.mark.parametrize("S,O,want", [(2, 200, 32), (32, 22848, 32), (33, 200, 64),
                                      (64, 22848, 64), (65, 200, 64), (300, 22848, 64),
                                      (512, 22848, 128), (512, 4544, 64), (300, 4544, 128),
                                      (300, 9216, 64), (512, 9216, 128)])
def test_f32_rows(S, O, want):
    """The narrowest tile that holds a short S; from 65 rows 128, unless
    64-row blocks need at most 0.8 of its rounds over the SMs (Falcon-7B's
    w_od, O = 4544, at S = 512: 144 blocks of 128 rows, two rounds, or 288
    of 64, three half rounds)."""
    assert tqm.f32_rows(S, O) == want and want in tqm.F32_ROWS


# ----------------------------------------------------------- f32 attention

@functools.lru_cache(maxsize=None)
def _attn_case(H, KV, D, n_past):
    """(q, k, v, the Pallas kernel's out in interpret mode): B = 2, S = 40
    query rows, a cache of n_past + S + 24 positions, f32 from a seed."""
    B, S = 2, 40
    T = n_past + S + 24
    rng = np.random.default_rng(H * D + n_past)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, D)).astype(np.float32)
    ref = np.asarray(jfa.flash_mqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), n_past,
                                   interpret=True))
    return torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), ref


@pytest.mark.parametrize("H,KV,D,n_past", ATTN, ids=ATTN_IDS)
def test_f32_attention_restatement_matches_jax_kernel(H, KV, D, n_past):
    """Split-TF32 products in the kernel's key tiles and online softmax:
    within 2e-5 of the Pallas kernel on f32 inputs."""
    q, k, v, ref = _attn_case(H, KV, D, n_past)
    got = tfa.flash_mqa_f32_emulated(q, k, v, n_past)
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert _rel(got.numpy(), ref) <= TOL


@pytest.mark.parametrize("H,KV,D,n_past", ATTN, ids=ATTN_IDS)
def test_f32_attention_with_one_tf32_product_misses_the_tolerance(H, KV, D, n_past):
    """The negative control: hi x hi alone (TF32 accuracy) lands outside
    2e-5."""
    q, k, v, ref = _attn_case(H, KV, D, n_past)
    assert _rel(tfa.flash_mqa_f32_emulated(q, k, v, n_past, terms=1).numpy(), ref) > TOL


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("H,KV", [(71, 1), (32, 32)], ids=["g71", "g1"])
def test_f32_attention_block_plan_covers_every_visible_key(D, H, KV):
    """At the f32 kernel's tile widths (32 keys at D = 128, else 64) every
    block visits every key its rows may see, and the tiles it leaves
    unmasked are visible to all of its rows."""
    S, T, G, n_past = 150, 300, H // KV, 37
    keys = tfa.F32_TILE_KEYS[D]
    mask = torch.arange(T)[None, :] <= n_past + torch.arange(S)[:, None]
    owned = []
    for block in range(-(-S * G // tfa.TC_BLOCK_ROWS)):
        plan = tfa.tc_block_plan(S, G, n_past, T, block, keys)
        owned += plan["rows"]
        for pos, _ in plan["rows"]:
            assert int(mask[pos].nonzero().max()) < plan["tiles"] * keys
            for i in set(range(plan["tiles"])) - set(plan["masked"]):
                assert bool(mask[pos, i * keys:(i + 1) * keys].all())
    assert sorted(owned) == [(p, g) for p in range(S) for g in range(G)]


TILE_SASS = """
        Function : _ZN53_GLOBAL__N__0_20_quant_gemm_f32_kq_cu_014quant_gemm_f32ILi14ELi128EEEvPKfNS_6PlanesES2_Pviiii
        /*0000*/                   S2R R0, SR_TID.X ;                     /* 0x0000000000007919 */
        /*0010*/                   LDS.64 R2, [R4] ;                      /* 0x0000000004027984 */
        /*0020*/                   PRMT R5, R2, 0x7632, R3 ;              /* 0x0000763202057816 */
        /*0030*/                   HMMA.16816.F32.BF16 R8, R12, R5, RZ ;  /* 0x000000050c08723c */
        /*0040*/                   HMMA.16816.F32.BF16 R8, R12, R6, R8 ;  /* 0x000000060c08723c */
        /*0050*/                   FFMA R20, R8, R21, R20 ;               /* 0x0000001508147223 */
        /*0060*/               @P0 BRA 0x10 ;                             /* 0xfffffffc00000947 */
        /*0070*/                   EXIT ;                                 /* 0x000000000000794d */
        Function : _ZN53_GLOBAL__N__0_20_quant_gemm_tc_kq_cu_013quant_gemm_tcILi14ELi128EEEvPK13__nv_bfloat16NS_6PlanesEPviiii
        /*0000*/                   EXIT ;                                 /* 0x000000000000794d */
"""


def test_tile_sass_report_reads_cuobjdump_text():
    """The f32 tile's SASS report (tools/sass_report.py parse_tile_sass) on text
    shaped as cuobjdump prints it: only quant_gemm_f32 instantiations, named
    by format and x rows a block; its loop from the backward branch's target
    to the branch, with the HMMA count and instructions a HMMA."""
    from ggllm_tpu_torch.tools.sass_report import parse_tile_sass

    (row,) = parse_tile_sass(TILE_SASS)
    assert (row["kernel"], row["format"], row["rows"], row["instructions"]) == (
        "quant_gemm_f32", "q6_k", 128, 8)
    assert row["loop_instructions"] == 6 and row["loop_HMMA"] == 2
    assert row["loop_instructions_per_HMMA"] == 3.0
    assert row["loop_opcodes"]["LDS"] == 1
