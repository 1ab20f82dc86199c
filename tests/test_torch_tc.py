"""What the port's tensor-core kernels compute, checked on the CPU.

The kernels themselves (csrc/quant_gemm_tc.cuh, csrc/flash_attention_tc.cu)
run only on the card. Their index arithmetic is stated once more in Python
(kernels/quant_matmul.py tc_fragment_table, kernels/flash_attention.py
tc_block_plan) and held here against the plain versions:
 * the tile's per-thread fragment decode reproduces dequantize(f32) rounded
   once to bf16, bit for bit, for all ten formats;
 * `route` and `tc_rows`, the rules that pick a kernel and its tile width;
 * x @ bf16(dequant(W))^T in f32, the value the tile accumulates, stays
   within the bf16 tolerance of the JAX package's Pallas kernel (interpret
   mode), which is the tolerance the card check uses;
 * the attention kernel's blocks own every (position, head) row once, visit
   every key their rows may see, and skip the mask only where every row sees
   the whole tile.
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
from ggllm_tpu_torch.kernels import flash_attention as tfa
from ggllm_tpu_torch.kernels import quant_matmul as tqm
from ggllm_tpu_torch.ops.linear import QuantTensor
from ggllm_tpu_torch.quant import planar as tplanar
from ggllm_tpu_torch.utils.benchgen import random_quant

FORMATS = [GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_0,
           GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K]
IDS = [f.name.lower() for f in FORMATS]


def _bits(t: torch.Tensor) -> torch.Tensor:
    """bf16 bit patterns, with -0 folded onto +0: q * s - c yields +0 where
    (q - 8) * d yields -0 for a negative d, and the product cannot tell."""
    return (t + 0.0).view(torch.int16)


@pytest.mark.parametrize("gtype", FORMATS, ids=IDS)
@pytest.mark.parametrize("K", [256, 512])
@pytest.mark.parametrize("source", ["random_blocks", "quantized"])
def test_fragment_decode_is_dequant_rounded_once(gtype, K, source):
    """Ragged O = 37. Random blocks reach every code, scale and min; the
    quantized rows are what a file holds."""
    O = 37
    tg = TGGMLType(int(gtype))
    if source == "random_blocks":
        w = random_quant(tg, O, K, torch.Generator().manual_seed(K), "cpu")
    else:
        rng = np.random.default_rng(K)
        dense = (rng.standard_normal((O, K)) * 0.1).astype(np.float32)
        blob = np.stack([jregistry.quantize(gtype, dense[i]) for i in range(O)]).reshape(O, -1)
        w = QuantTensor(tg, (O, K), {k: torch.from_numpy(v)
                                     for k, v in tplanar.to_planes(tg, blob, O, K).items()})
    got = tqm.tc_dequant_emulated(w)
    ref = w.dequantize(torch.float32).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (O, K)
    assert torch.equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("gtype", FORMATS, ids=IDS)
def test_kernel_arithmetic_is_within_one_rounding(gtype):
    """The kernel feeds the code to its FMA as 1 + q / 128 and rounds
    c + 128 s to f32 first: against q * s - c that moves a weight by at most
    2^-17 |s| before the rounding to bf16, so nearly every weight keeps its
    bits, the others move one bf16 step, and Q4_0 / Q5_0 / Q3_K / Q6_K / Q8_0
    (c a multiple of s, or none) keep all of theirs."""
    tg = TGGMLType(int(gtype))
    w = random_quant(tg, 64, 1024, torch.Generator().manual_seed(3), "cpu")
    ideal = tqm.tc_dequant_emulated(w)
    kernel = tqm.tc_dequant_emulated(w, kernel_arithmetic=True)
    differ = _bits(ideal) != _bits(kernel)
    exact = gtype in (GGMLType.Q4_0, GGMLType.Q5_0, GGMLType.Q3_K, GGMLType.Q6_K, GGMLType.Q8_0)
    assert float(differ.float().mean()) <= (0.0 if exact else 2e-3)
    s, _ = tqm.tc_group_scales(w)
    width = tqm.KERNEL_FORMATS[tg][0]
    bound = s.abs().repeat_interleave(width, dim=1) * 2.0 ** -8  # a bf16 step of a weight near s
    assert bool(((ideal.float() - kernel.float()).abs() <= bound + 1e-30).all())


@pytest.mark.parametrize("gtype", FORMATS, ids=IDS)
def test_fragment_table_covers_each_element_once(gtype):
    """Every element of a row is one (group, lane, slot) of the table; a
    thread's slots 0-3 feed the first k step of its 32-group, 4-7 the second;
    scale groups are as wide as the format says."""
    K = 768
    tab = tqm.tc_fragment_table(TGGMLType(int(gtype)), K)
    k = np.asarray(tab["k"])
    assert sorted(k.tolist()) == list(range(K))
    gi, t, e = np.meshgrid(np.arange(K // 32), np.arange(4), np.arange(8), indexing="ij")
    i = k.reshape(gi.shape) - 32 * gi
    assert ((i >= 16) == (e >= 4)).all()
    # the A fragment of m64k16: register pairs at k = 2t, 2t+1 and 2t+8, 2t+9
    assert (i % 16 == 2 * t + (e & 1) + 8 * ((e >> 1) & 1)).all()
    width = tab["group_width"]
    assert (np.asarray(tab["group"]) == k // width).all()


@pytest.mark.parametrize("gtype", FORMATS, ids=IDS)
@pytest.mark.parametrize("S", [1, 2, 300, 512])
@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_route(gtype, S, xdtype):
    want = "gemv" if S == 1 else "tc" if xdtype == torch.bfloat16 else "simt"
    assert tqm.route(S, xdtype, TGGMLType(int(gtype))) == want


def test_route_refuses():
    with pytest.raises(NotImplementedError):
        tqm.route(4, torch.bfloat16, TGGMLType.Q8_K)
    with pytest.raises(TypeError):
        tqm.route(4, torch.float16, TGGMLType.Q4_0)
    with pytest.raises(ValueError):
        tqm.route(0, torch.bfloat16, TGGMLType.Q4_0)
    with pytest.raises(TypeError):
        tfa.route(torch.float16, 64)
    with pytest.raises(NotImplementedError):
        tfa.route(torch.bfloat16, 256)


@pytest.mark.parametrize("S,O,want", [(2, 100, 16), (16, 100, 16), (17, 100, 64), (64, 4544, 64),
                                      (65, 4544, 128), (128, 4544, 128), (129, 4544, 256),
                                      (300, 22848, 256), (300, 9216, 128), (512, 22848, 256),
                                      (512, 4544, 256), (512, 4096, 256), (513, 65024, 256),
                                      (1024, 65024, 256)])
def test_tc_rows(S, O, want):
    """The narrowest tile that holds a short S; from 129 rows 256, unless its
    blocks need more rounds over the SMs than 1.4 times the 128-wide tile's
    (Falcon-40B's wqkv, O = 9216, at S = 300: 144 blocks against 216 that fit
    the card two an SM)."""
    nt = tqm.tc_rows(S, O)
    assert nt == want and nt in tqm.TC_ROWS


@pytest.mark.parametrize("dtype,D,want", [(torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"),
                                          (torch.bfloat16, 32, "simt"), (torch.float32, 64, "simt"),
                                          (torch.float32, 128, "simt"), (torch.float32, 32, "simt")])
def test_attention_route(dtype, D, want):
    assert tfa.route(dtype, D) == want


@pytest.mark.parametrize("gtype", FORMATS, ids=IDS)
def test_bf16_weight_product_within_tolerance_of_jax_kernel(gtype):
    """The tile's value, bf16 x times W rounded once to bf16, summed in f32,
    against the Pallas kernel in interpret mode: 2e-2 of max |ref|, the bf16
    tolerance of tests/test_kernels.py and of the card check."""
    O, K, S = 64, 512, 17
    rng = np.random.default_rng(int(gtype))
    dense = (rng.standard_normal((O, K)) * 0.1).astype(np.float32)
    blob = np.stack([jregistry.quantize(gtype, dense[i]) for i in range(O)]).reshape(O, -1)
    kq = jlayout.to_kernel(gtype, jplanar.to_planes(gtype, blob, O, K), (O, K))
    tg = TGGMLType(int(gtype))
    w = QuantTensor(tg, (O, K), {k: torch.from_numpy(v)
                                 for k, v in tplanar.to_planes(tg, blob, O, K).items()})
    x = rng.standard_normal((S, K)).astype(np.float32)
    ref = np.asarray(jqm.fused_matmul(kq, jnp.asarray(x, jnp.bfloat16), jnp.float32,
                                      interpret=True))
    xb = torch.from_numpy(x).to(torch.bfloat16).to(torch.float32)
    got = (xb @ tqm.tc_dequant_emulated(w).to(torch.float32).t()).numpy()
    scale = np.abs(ref).max() + 1e-6
    np.testing.assert_allclose(got / scale, ref / scale, atol=2e-2)


def _plain_mask(S, n_past, T):
    """(S, T) visibility as flash_mqa_plain builds it."""
    return torch.arange(T)[None, :] <= n_past + torch.arange(S)[:, None]


@pytest.mark.parametrize("H,KV", [(71, 1), (128, 8), (32, 32)], ids=["g71", "g16", "g1"])
@pytest.mark.parametrize("n_past", [0, 37, "rows"])
def test_attention_block_plan_matches_plain_mask(H, KV, n_past):
    """S = 150 (a ragged last block in every layout), T = 256. Per batch row
    (a per-row n_past gives each its own) the blocks own every (position,
    head) exactly once; per row, the keys the plain mask shows lie in the
    visited tiles and equal what the kernel's test `t <= last_key and t < T`
    leaves; a tile that skips the test is visible to every row of its block;
    blocks span the fewest positions their 64 rows allow."""
    S, T, G = 150, 256, H // KV
    tile = tfa.TC_TILE_KEYS
    for past in ([3, 120] if n_past == "rows" else [n_past]):
        mask = _plain_mask(S, past, T)
        n_blocks = -(-S * G // tfa.TC_BLOCK_ROWS)
        owned = []
        for block in range(n_blocks):
            plan = tfa.tc_block_plan(S, G, past, T, block)
            owned += plan["rows"]
            positions = sorted({pos for pos, _ in plan["rows"]})
            assert len(positions) <= -(-len(plan["rows"]) // G) + 1
            keys = torch.arange(plan["tiles"] * tile)
            for (pos, _), last in zip(plan["rows"], plan["last_key"]):
                visible = mask[pos].nonzero().flatten()
                assert int(visible.max()) < plan["tiles"] * tile
                kernel_sees = keys[(keys <= last) & (keys < T)]
                assert torch.equal(kernel_sees, visible)
                for i in range(plan["tiles"]):
                    if i not in plan["masked"]:
                        assert bool(mask[pos, i * tile:(i + 1) * tile].all())
            # no tile is visited that no row of the block can see
            last_tile_keys = mask[positions[-1], (plan["tiles"] - 1) * tile:plan["tiles"] * tile]
            assert bool(last_tile_keys.any())
        assert sorted(owned) == [(p, g) for p in range(S) for g in range(G)]
