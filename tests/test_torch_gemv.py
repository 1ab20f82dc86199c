"""What the port's decode GEMVs compute, checked on the CPU.

The kernels (csrc/quant_gemv_legacy.cu for Q4_0-Q8_0, csrc/quant_gemv_kq.cu
for Q2_K-Q6_K, both around the loop of csrc/gemv.cuh) run only on the card.
Their index arithmetic is stated once more in Python (kernels/quant_matmul.py
gemv_lane_table) and their sums in gemv_emulated, and both are held here for
all ten formats:
 * every element of a row is one (step, lane, byte, slot) of the table, the
   32 lanes of a step load 512 distinct code bytes, and a lane's run of 16
   lies in one scale group;
 * the table's codes are the JAX package's codes bit for bit, and the
   2^23 decode (offsets 8, 16, 128 after a sign flip, 4, 32 folded in) with
   the table's scales reproduces dequantize(f32) bit for bit;
 * gemv_emulated agrees with the JAX package's Pallas kernel (interpret mode)
   within 1e-5 of max |ref| for f32 x and 2e-2 for bf16 x, and with the plain
   version;
 * one row of x still routes to the GEMV, and which GEMV serves a format is
   fixed by the format.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ggllm_tpu.core.dtypes import GGMLType
from ggllm_tpu.kernels import layout as jlayout
from ggllm_tpu.kernels import quant_matmul as jqm
from ggllm_tpu.quant import planar as jplanar
from ggllm_tpu.quant import registry as jregistry

from ggllm_tpu_torch.core.dtypes import GGMLType as TGGMLType
from ggllm_tpu_torch.kernels import quant_matmul as tqm
from ggllm_tpu_torch.ops.linear import QuantTensor
from ggllm_tpu_torch.quant import planar as tplanar
from ggllm_tpu_torch.utils.benchgen import random_quant

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)

KQ = [GGMLType.Q4_K, GGMLType.Q3_K, GGMLType.Q5_K, GGMLType.Q2_K, GGMLType.Q6_K]
LEGACY = [GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_0]
ALL = LEGACY + KQ
IDS = [f.name.lower() for f in ALL]
# widths per family: one block and a ragged count, whose last step leaves
# lanes idle (legacy: 3 and 33 blocks, 32 a step, 16 for Q8_0; K-quants: 1 and
# 3 super-blocks, 4 or 8 a step)
WIDTHS = {**{g: (96, 1056) for g in LEGACY}, **{g: (256, 768) for g in KQ}}
FORMAT_WIDTHS = [pytest.param(g, K, id=f"{g.name.lower()}-K{K}") for g in ALL for K in WIDTHS[g]]


def _weight(gtype, O, K, source, seed):
    """(port QuantTensor, JAX planes) of the same blocks: random blocks reach
    every code, scale and min; quantized rows are what a file holds."""
    tg = TGGMLType(int(gtype))
    if source == "random_blocks":
        w = random_quant(tg, O, K, torch.Generator().manual_seed(seed), "cpu", scale=0.2)
        blob = tplanar.from_planes(tg, {k: v.numpy() for k, v in w.planes.items()})
    else:
        rng = np.random.default_rng(seed)
        dense = (rng.standard_normal((O, K)) * 0.1).astype(np.float32)
        blob = np.stack([jregistry.quantize(gtype, dense[i]) for i in range(O)]).reshape(O, -1)
        w = QuantTensor(tg, (O, K), {k: torch.from_numpy(v)
                                     for k, v in tplanar.to_planes(tg, blob, O, K).items()})
    return w, jplanar.to_planes(gtype, blob, O, K)


@pytest.mark.parametrize("gtype,K", FORMAT_WIDTHS)
def test_lane_table_covers_each_element_once(gtype, K):
    """At the ragged width the last step leaves lanes idle."""
    tab = tqm.gemv_lane_table(TGGMLType(int(gtype)), K)
    valid = tab["valid"]
    assert sorted(tab["k"][valid].tolist()) == list(range(K))
    assert (tab["group"][valid] == tab["k"][valid] // tab["group_width"]).all()
    assert (tab["scale"][valid] == tab["group"][valid]).all()  # the kernel's own scale index
    lanes, qb, runs, _, qk = tqm.GEMV_LAYOUT[TGGMLType(int(gtype))]
    nb = K // qk
    # a step's lanes load consecutive 16-byte pieces: 512 distinct bytes, or
    # what is left of the row's code plane
    for step in range(tab["byte"].shape[0]):
        got = np.unique(tab["byte"][step][valid[step]])
        lo = step * (32 // lanes) * qb
        assert got.tolist() == list(range(lo, min(lo + 512, nb * qb)))
    for step in range(tab["byte"].shape[0]):
        for lane in range(32):
            if not valid[step, lane, 0, 0]:
                continue
            b = tab["byte"][step, lane]
            assert (b == b[0, 0] + np.arange(16)[:, None]).all()  # 16 contiguous bytes
            for u in range(runs):  # a run is 16 consecutive elements of one group
                k = tab["k"][step, lane, :, u]
                assert (k == k[0] + np.arange(16)).all() and k[0] % 16 == 0
                assert len(set(tab["group"][step, lane, :, u].tolist())) == 1
    hb = tab["hbyte"][valid.all(axis=(2, 3))]
    if tab["hplane"] is not None and gtype in KQ:  # 16 contiguous high-bit bytes a lane
        assert (hb == hb[:, :1, :] + np.arange(16)[None, :, None]).all()
    elif tab["hplane"] is not None:  # Q5_0 / Q5_1: the lane's block's u32, bit 16 u + i
        assert (hb // 4 == tab["sb"][valid.all(axis=(2, 3))]).all()
        bit = 8 * (hb % 4) + tab["hshift"][valid.all(axis=(2, 3))]
        assert (bit == 16 * np.arange(runs)[None, None, :] + np.arange(16)[None, :, None]).all()


@pytest.mark.parametrize("gtype,K", FORMAT_WIDTHS)
@pytest.mark.parametrize("source", ["random_blocks", "quantized"])
def test_lane_table_decodes_like_dequant(gtype, K, source):
    """Ragged O = 37. The gathered codes equal the JAX package's
    extract_codes (Q8_0's signed); q as 2^23 + q less 2^23 + offset is
    q - offset exactly; s * (q - offset) - c is the plain dequantize bit for
    bit."""
    O = 37
    w, jplanes = _weight(gtype, O, K, source, K)
    tab = tqm.gemv_lane_table(w.gtype, K)
    codes = tqm._gemv_codes(w, tab)
    if tab["signed"]:
        codes = torch.where(codes >= 128, codes - 256, codes)
    valid = torch.as_tensor(tab["valid"])
    ref_codes = torch.from_numpy(jlayout.extract_codes(gtype, jplanes, O, K)[0].astype(np.int64))
    got = torch.zeros(O, K, dtype=torch.int64)
    got[:, torch.as_tensor(tab["k"])[valid]] = codes[:, valid]
    assert torch.equal(got, ref_codes)
    deq = tqm.gemv_dequant_emulated(w)
    ref = w.dequantize(torch.float32)
    assert torch.equal((deq + 0.0).view(torch.int32), (ref + 0.0).view(torch.int32))


@pytest.mark.parametrize("offset", [0, 4, 8, 16, 32, 128])
def test_magic_decode_is_exact(offset):
    """Every code a format can hold (Q8_0: every byte, its sign bit flipped
    before the offset of 128 comes off: the signed value)."""
    q = torch.arange(256 if offset == 128 else 64)
    if offset == 128:
        signed = torch.where(q >= 128, q - 256, q).to(torch.float32)
        assert torch.equal(tqm._magic_f32(q ^ 0x80, offset), signed)
    else:
        assert torch.equal(tqm._magic_f32(q, offset), (q - offset).to(torch.float32))


@pytest.mark.parametrize("gtype", ALL, ids=IDS)
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_emulated_matches_jax_kernel_and_plain(gtype, xdtype):
    """K = 512 for the K-quants (two super-blocks: a warp's first step is
    partly idle for every format), O = 40; K = 1056 for the legacy formats (33
    blocks: a second step with one block), O = 37. Against the Pallas kernel
    in interpret mode: 1e-5 of max |ref| for f32 x, 2e-2 for bf16 x
    (tests/test_kernels.py:45); against the plain version, on the same
    bf16-rounded x, 1e-5."""
    O, K = (37, 1056) if gtype in LEGACY else (40, 512)
    w, jplanes = _weight(gtype, O, K, "random_blocks", int(gtype))
    kq = jlayout.to_kernel(gtype, jplanes, (O, K))
    x = np.random.default_rng(int(gtype)).standard_normal((1, K)).astype(np.float32)
    jdtype = jnp.float32 if xdtype == torch.float32 else jnp.bfloat16
    ref = np.asarray(jqm.fused_matmul(kq, jnp.asarray(x, jdtype), jnp.float32, interpret=True))
    xt = torch.from_numpy(x).to(xdtype)
    got = tqm.gemv_emulated(w, xt).numpy()
    scale = np.abs(ref).max() + 1e-6
    np.testing.assert_allclose(got / scale, ref / scale,
                               atol=1e-5 if xdtype == torch.float32 else 2e-2)
    plain = tqm.quant_matmul_plain(w, xt, torch.float32).numpy()
    np.testing.assert_allclose(got / scale, plain / scale, atol=1e-5)


@pytest.mark.parametrize("gtype", list(tqm.KERNEL_FORMATS), ids=lambda g: g.name.lower())
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_one_row_routes_to_the_gemv(gtype, xdtype):
    """S = 1 is the GEMV's; the K-quants take the K-quant GEMV and the
    legacy formats the other, by format alone."""
    assert tqm.route(1, xdtype, gtype) == "gemv"
    assert tqm.gemv_kernel(gtype) == ("kq" if gtype in tqm.K_QUANTS else "legacy")
    assert set(tqm.GEMV_LAYOUT) == set(tqm.GEMV_ROWS) == set(tqm.KERNEL_FORMATS)
    assert set(tqm.GEMV_ROWS.values()) <= {1, 2}  # the rows a warp the kernels are built for


SASS = """
        Function : _ZN49_GLOBAL__N__0_16_quant_gemv_kq_cu_013quant_gemv_kqILi12ELi2ELi2E13__nv_bfloat16S1_EEvPKT2_N2gq10GemvPlanesEPT3_i
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
        /*0010*/                   S2R R0, SR_TID.X ;                     /* 0x0000000000007919 */
        /*0020*/                   PRMT R2, R3, 0x4550, R4 ;              /* 0x0000455003027816 */
        /*0030*/                   FADD R5, R2, -8388608 ;                /* 0x4b00000002057421 */
        /*0040*/              @!P0 BRA 0x20 ;                             /* 0xfffffffc00008947 */
        /*0050*/                   EXIT ;                                 /* 0x000000000000794d */
        Function : _ZN49_GLOBAL__N__0_16_quant_gemv_kq_cu_013quant_gemv_kqILi11ELi1ELi2Ef13__nv_bfloat16EEvPKT2_N2gq10GemvPlanesEPT3_i
        /*0000*/                   I2F R1, R2 ;                           /* 0x0000000200017306 */
        /*0010*/                   EXIT ;                                 /* 0x000000000000794d */
        Function : _ZN49_GLOBAL__N__0_16_quant_matmul_cu_010quant_gemvILi2EffEEvPKT0_NS_6PlanesEPT1_ii
        /*0000*/                   EXIT ;                                 /* 0x000000000000794d */
        Function : _ZN53_GLOBAL__N__0_20_quant_gemv_legacy_cu_017quant_gemv_legacyILi8ELi1ELi4EffEEvPKT2_N2gq10GemvPlanesEPT3_i
        /*0000*/                   PRMT R2, R3, 0x4550, R4 ;              /* 0x0000455003027816 */
        /*0010*/                   FADD R5, R2, -8388736 ;                /* 0x4b00008002057421 */
        /*0020*/                   FFMA R6, R5, R7, R6 ;                  /* 0x0000000705067223 */
        /*0030*/               @P0 BRA 0x0 ;                              /* 0xfffffffc00000947 */
        /*0040*/                   EXIT ;                                 /* 0x000000000000794d */
"""


def test_sass_report_reads_cuobjdump_text():
    """The card run's I2F check and instruction counts (tools/sass_report.py)
    on text shaped as cuobjdump prints it: only the decode GEMVs' kernels
    (legacy and K-quant; not another kernel of that name), named by kernel,
    format, rows a warp, depth and dtypes; the loop runs from the backward
    branch's target to the branch (depth steps: 2 * 2 rows * 32 weights of a
    Q4_K lane at depth 2, 4 * 1 row * 16 of a Q8_0 lane at depth 4)."""
    from ggllm_tpu_torch.tools.sass_report import parse_sass

    q4k, q3k, q8 = parse_sass(SASS)
    assert (q4k["kernel"], q4k["format"], q4k["rows"], q4k["x"], q4k["y"]) == (
        "kq", "q4_k", 2, "bfloat16", "bfloat16")
    assert q4k["instructions"] == 6 and q4k["I2F"] == 0 and q4k["loop_instructions"] == 3
    assert q4k["loop_instructions_per_weight"] == 3 / 128
    assert (q3k["format"], q3k["rows"], q3k["x"], q3k["y"]) == ("q3_k", 1, "float32", "bfloat16")
    assert q3k["I2F"] == 1 and q3k["loop_instructions"] is None
    assert (q8["kernel"], q8["format"], q8["rows"], q8["depth"], q8["x"], q8["y"]) == (
        "legacy", "q8_0", 1, 4, "float32", "float32")
    assert q8["I2F"] == 0 and q8["loop_instructions"] == 4
    assert q8["loop_instructions_per_weight"] == 4 / 64


def test_gemv_emulated_refuses_more_rows():
    """More than one row of x, a type with no GEMV (Q8_K is no weight
    format), a width that is not whole blocks."""
    w = random_quant(TGGMLType.Q4_K, 8, 256, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError):
        tqm.gemv_emulated(w, torch.randn(2, 256))
    with pytest.raises(NotImplementedError):
        tqm.gemv_lane_table(TGGMLType.Q8_K, 256)
    with pytest.raises(ValueError):
        tqm.gemv_lane_table(TGGMLType.Q4_K, 320)
    with pytest.raises(ValueError):
        tqm.gemv_lane_table(TGGMLType.Q4_0, 80)
