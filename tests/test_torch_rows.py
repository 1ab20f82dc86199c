"""What the port's rows kernel (2 to 16 rows of bf16 x) computes, checked on
the CPU.

The kernel (csrc/quant_mmv.cuh, built from csrc/quant_mmv_legacy.cu and
csrc/quant_mmv_kq.cu) runs only on the card. Its fragment decode is the
tensor-core tiles' (tc_fragment_table, held bit for bit by
tests/test_torch_tc.py); its sums are stated once more in Python
(kernels/quant_matmul.py rows_emulated) and held here for all ten formats:
 * at S = 2, 5, 8, 9 and 16 rows of bf16 x, a ragged O and a K of several
   groups (legacy: 33 32-groups, a partial last unit; K-quants: two
   super-blocks), f32 and bf16 y: within 1e-5 of max |plain| of the plain
   version (exact products summed in f32), and within 2e-2 of the JAX
   package's Pallas kernel in interpret mode, which rounds its decoded
   weights to bf16 for bf16 x (ggllm_tpu/kernels/quant_matmul.py:262);
 * a negative control: each group's scale taken from the next group lands
   outside 1e-5;
 * a row's y does not depend on the other rows (S = 16 against S = 2 with a
   zero row, bit for bit), and the K split (a block's warps, a cluster's
   blocks) is the kernel's stated order;
 * `route` sends 2 to 16 bf16 rows to the kernel, and `rows_cluster` picks
   the K split across a cluster at the three model families' decode shapes.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ggllm_tpu.core.dtypes import GGMLType
from ggllm_tpu.kernels import layout as jlayout
from ggllm_tpu.kernels import quant_matmul as jqm
from ggllm_tpu.quant import planar as jplanar

from ggllm_tpu_torch.core.dtypes import GGMLType as TGGMLType
from ggllm_tpu_torch.kernels import quant_matmul as tqm
from ggllm_tpu_torch.quant import planar as tplanar
from ggllm_tpu_torch.utils.benchgen import random_quant

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)

LEGACY = [GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_0]
KQ = [GGMLType.Q4_K, GGMLType.Q3_K, GGMLType.Q5_K, GGMLType.Q2_K, GGMLType.Q6_K]
ALL = LEGACY + KQ
IDS = [f.name.lower() for f in ALL]
O = 37  # no multiple of the kernel's 16 W rows an m-tile or 64 a block
S_MAX = tqm.ROWS_MAX_S
TOL_PLAIN = 1e-5  # of max |plain|: exact products, f32 sums (tests/test_torch_gemv.py:160)
TOL_JAX = 2e-2    # of max |ref|: the Pallas kernel's bf16-rounded weights (test_torch_gemv.py:145)


def _width(gtype):
    return 1056 if gtype in LEGACY else 512


@pytest.fixture(scope="module")
def cases():
    """Per format: the port's weight, 16 rows of bf16 x from a numpy seed,
    and the Pallas kernel's y (f32) of all 16 rows in interpret mode (one
    JAX call a format; row s of its y depends on row s of x alone)."""
    out = {}

    def get(gtype):
        if gtype not in out:
            K = _width(gtype)
            tg = TGGMLType(int(gtype))
            w = random_quant(tg, O, K, torch.Generator().manual_seed(int(gtype)), "cpu", scale=0.2)
            blob = tplanar.from_planes(tg, {k: v.numpy() for k, v in w.planes.items()})
            kq = jlayout.to_kernel(gtype, jplanar.to_planes(gtype, blob, O, K), (O, K))
            x = np.random.default_rng(int(gtype)).standard_normal((S_MAX, K)).astype(np.float32)
            xb = jnp.asarray(x, jnp.bfloat16)
            ref = np.asarray(jqm.fused_matmul(kq, xb, jnp.float32, interpret=True))
            out[gtype] = (w, torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16),
                          ref)
        return out[gtype]

    return get


@pytest.mark.parametrize("gtype", ALL, ids=IDS)
@pytest.mark.parametrize("S", [2, 5, 8, 9, 16])
@pytest.mark.parametrize("ydtype", [torch.float32, torch.bfloat16], ids=["y_f32", "y_bf16"])
def test_rows_emulated_matches_plain_and_jax_kernel(cases, gtype, S, ydtype):
    """Against the plain version on the same bf16 x: f32 y within 1e-5 of
    max |plain|, bf16 y within one bf16 rounding of it; against the Pallas
    kernel within 2e-2 of max |ref|."""
    w, x, ref = cases(gtype)
    got = tqm.rows_emulated(w, x[:S], ydtype)
    assert got.dtype == ydtype and got.shape == (S, O)
    plain = tqm.quant_matmul_plain(w, x[:S], torch.float32)
    scale = float(plain.abs().max())
    err = float((got.float() - plain).abs().max()) / scale
    assert err <= (TOL_PLAIN if ydtype == torch.float32 else 2.0 ** -8), err
    jscale = np.abs(ref[:S]).max() + 1e-6
    np.testing.assert_allclose(got.float().numpy() / jscale, ref[:S] / jscale, atol=TOL_JAX)


@pytest.mark.parametrize("gtype", ALL, ids=IDS)
def test_a_scale_from_the_next_group_lands_outside_the_tolerance(cases, gtype):
    """The negative control: every scale group's s (and c) taken from the
    next group, as a kernel that read the wrong group's scale would: far
    outside 1e-5 of max |plain|."""
    w, x, _ = cases(gtype)
    s, c = tqm.tc_group_scales(w)
    got = tqm.rows_emulated(w, x[:4], scales=(s.roll(-1, dims=1), c.roll(-1, dims=1)))
    plain = tqm.quant_matmul_plain(w, x[:4], torch.float32)
    assert float((got - plain).abs().max()) / float(plain.abs().max()) > 100 * TOL_PLAIN


@pytest.mark.parametrize("gtype", ALL, ids=IDS)
def test_a_rows_y_does_not_depend_on_the_other_rows(cases, gtype):
    """Row s of 16 rows equals, bit for bit, row 0 of two rows holding row s
    and a zero row, and row s of 16 rows whose other rows were redrawn."""
    w, x, _ = cases(gtype)
    full = tqm.rows_emulated(w, x)
    other = torch.from_numpy(np.random.default_rng(99).standard_normal(x.shape).astype(
        np.float32)).to(torch.bfloat16)
    for s in (0, 7, 8, 15):
        pair = torch.stack([x[s], torch.zeros_like(x[s])])
        assert torch.equal(tqm.rows_emulated(w, pair)[0], full[s])
        mixed = other.clone()
        mixed[s] = x[s]
        assert torch.equal(tqm.rows_emulated(w, mixed)[s], full[s])


@pytest.mark.parametrize("gtype", ALL, ids=IDS)
@pytest.mark.parametrize("cluster", [1, 2])
def test_k_split_is_the_kernels_order(cases, gtype, cluster):
    """rows_emulated equals, bit for bit, the order csrc/quant_mmv.cuh
    states, written out here: block r of the cluster takes the units r,
    r + cluster, ... of 8 32-groups, its warp w of 8 their 32-group w, in
    order (each 16-wide scale group of a 32-group in turn), from 0, by
    fma(s, P, acc) and, for the formats with a correction, fma(-c, xg, acc);
    then warp 0 + ... + warp 7 in a block, block 0 + block 1 in a cluster."""
    w, x, _ = cases(gtype)
    x = x[:9].to(torch.float64)
    K = w.shape[1]
    width = tqm.KERNEL_FORMATS[w.gtype][0]
    q = (tqm.tc_codes(w) - tqm.ROWS_OFFSET.get(w.gtype, 0)).to(torch.float64)
    s, c = tqm.tc_group_scales(w)
    assert tqm.ROWS_WARPS == 8

    def fma(a, b, acc):
        return (a.double() * b.double() + acc.double()).float()

    y = None
    for rank in range(cluster):
        block = None
        for warp in range(8):
            acc = torch.zeros(9, O)
            for gi in range(K // 32):
                if gi % 8 != warp or (gi // 8) % cluster != rank:
                    continue
                for sg in range(gi * 32 // width, (gi + 1) * 32 // width):
                    cols = slice(sg * width, (sg + 1) * width)
                    P = (x[:, cols] @ q[:, cols].t()).float()
                    acc = fma(s[None, :, sg], P, acc)
                    if w.gtype in tqm.ROWS_CORR:
                        acc = fma(-c[None, :, sg], x[:, cols].float().sum(1)[:, None], acc)
            block = acc if block is None else block + acc
        y = block if y is None else y + block
    assert torch.equal(tqm.rows_emulated(w, x.to(torch.bfloat16), cluster=cluster), y)


def test_folded_offsets_and_corrections_cover_every_format():
    """Each format either folds its offset into the code (no correction),
    pays the correction, or is Q8_0's signed bytes; the offsets are the
    GEMVs' own."""
    for g in tqm.KERNEL_FORMATS:
        kinds = [g in tqm.ROWS_OFFSET, g in tqm.ROWS_CORR, g == TGGMLType.Q8_0]
        assert sum(kinds) == 1, g
        if g in tqm.ROWS_OFFSET:
            assert tqm.ROWS_OFFSET[g] == tqm.GEMV_LAYOUT[g].offset
            assert 0 < tqm.ROWS_OFFSET[g] < 128  # the bf16 constant's mantissa holds it


@pytest.mark.parametrize("gtype", list(tqm.KERNEL_FORMATS), ids=lambda g: g.name.lower())
def test_route_sends_2_to_16_bf16_rows_to_the_rows_kernel(gtype):
    assert tqm.route(1, torch.bfloat16, gtype) == "gemv"
    for S in range(2, 17):
        assert tqm.route(S, torch.bfloat16, gtype) == "rows"
    assert tqm.route(17, torch.bfloat16, gtype) == "tc"
    assert tqm.route(2, torch.float32, gtype) == "f32"
    assert tqm.route(16, torch.float32, gtype) == "f32"


# decode weights (O) of the three model families and the cluster size
# rows_cluster gives them: two blocks split K where the row blocks are few
CLUSTER_SHAPES = [
    ("falcon7b.wqkvu", 22848, 1), ("falcon7b.w_od", 4544, 2), ("falcon7b.lm_head", 65024, 1),
    ("falcon40b.wqkv", 9216, 2), ("falcon40b.w_od", 8192, 2), ("falcon40b.ffn_up", 32768, 1),
    ("falcon40b.lm_head", 65024, 1), ("llama7b.wqkv", 12288, 1), ("llama7b.w13", 22016, 1),
    ("llama7b.wo", 4096, 2), ("llama7b.w2", 4096, 2), ("llama7b.lm_head", 32000, 1),
    ("ragged", 37, 2)]


@pytest.mark.parametrize("name,O,cluster", CLUSTER_SHAPES, ids=[m[0] for m in CLUSTER_SHAPES])
def test_rows_cluster(name, O, cluster):
    assert tqm.rows_cluster(O) == cluster and cluster in tqm.ROWS_CLUSTERS


ROWS_SASS = """
        Function : _ZN55_GLOBAL__N__0_18_quant_mmv_legacy_cu_014quant_mmv_rowsILi2ELi1ELi2EEEvPK13__nv_bfloat16NS_6PlanesEPviiii
        /*0000*/                   S2R R0, SR_TID.X ;                     /* 0x0000000000007919 */
        /*0010*/                   PRMT R2, R3, 0x4140, R4 ;              /* 0x0000414003027816 */
        /*0020*/                   HFMA2.BF16_V2 R5, R2, 1, 1, R6 ;       /* 0x0000000602057431 */
        /*0030*/                   HMMA.16816.F32.BF16 R8, R12, R16, RZ ; /* 0x000000100c08723c */
        /*0040*/                   FFMA R6, R5, R7, R6 ;                  /* 0x0000000705067223 */
        /*0050*/               @P0 BRA 0x10 ;                             /* 0xfffffffc00000947 */
        /*0060*/                   EXIT ;                                 /* 0x000000000000794d */
        Function : _ZN51_GLOBAL__N__0_14_quant_mmv_kq_cu_014quant_mmv_rowsILi12ELi2ELi1EEEvPK13__nv_bfloat16NS_6PlanesEPviiii
        /*0000*/                   I2F.S8 R1, R2 ;                        /* 0x0000000200017306 */
        /*0010*/                   EXIT ;                                 /* 0x000000000000794d */
        Function : _ZN55_GLOBAL__N__0_18_quant_gemm_tc_legacy_cu_013quant_gemm_tcILi2ELi64EEEvPK13__nv_bfloat16NS_6PlanesEPviiii
        /*0000*/                   I2F R1, R2 ;                           /* 0x0000000200017306 */
        /*0010*/                   EXIT ;                                 /* 0x000000000000794d */
"""


def test_rows_sass_report_reads_cuobjdump_text():
    """The card run's I2F check of the rows kernel (tools/sass_report.py
    parse_rows_sass) on text shaped as cuobjdump prints it: only the rows
    kernel's instantiations, named by format, n-tiles and cluster size, an I2F
    with any modifier counted, the main loop's HMMA counted."""
    from ggllm_tpu_torch.tools.sass_report import parse_rows_sass

    q4_0, q4_k = parse_rows_sass(ROWS_SASS)
    assert (q4_0["format"], q4_0["ntiles"], q4_0["cluster"], q4_0["I2F"]) == ("q4_0", 1, 2, 0)
    assert (q4_0["instructions"], q4_0["loop_instructions"], q4_0["loop_HMMA"]) == (7, 5, 1)
    assert (q4_k["format"], q4_k["ntiles"], q4_k["cluster"], q4_k["I2F"]) == ("q4_k", 2, 1, 1)
