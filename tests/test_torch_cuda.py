"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda` and skipped without one. These cover what chip_smoke.py's
full-width checks do not: every quant format with f32 and bf16 inputs
(bf16 rows through the tensor-core tile at each of its four widths, f32 rows
through the SIMT tile, counted as such), ragged tiles (odd S, O and query
tiles), 16- and 32-wide group sums, per-row
n_past / valid vectors, head_dim 32, Falcon-40B's 16 query heads per K/V
head, LLaMA's G == 1 head layouts (head_dim 32, 64, 128; head counts that do
not fill a block) in both attention kernels, the int8 cache's partials with
bf16 and f32 queries, refusals of what the kernels do not take, and tiny
Falcon and LLaMA models (some on an int8 cache) end to end on the card
against the CPU. They import no JAX, so they run on a
machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ggllm_tpu_torch.core.config import EngineConfig, FalconHParams, LlamaHParams
from ggllm_tpu_torch.core.dtypes import GGMLType
from ggllm_tpu_torch.kernels import build
from ggllm_tpu_torch.kernels import flash_decode as fd
from ggllm_tpu_torch.kernels import quant_matmul as qm
from ggllm_tpu_torch.kernels.flash_attention import flash_mqa, flash_mqa_plain
from ggllm_tpu_torch.ops import kvcache
from ggllm_tpu_torch.ops.linear import QuantTensor
from ggllm_tpu_torch.utils.benchgen import random_quant

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # of max |ref| (tests/test_kernels.py:45)
# the tensor-core decode kernel against partials_emulated, which rounds P to
# bf16 where the kernel does. The kernel sums S in another order, which moves
# P by a few f32 steps; where that crosses a bf16 rounding boundary one P
# rounds the other way. On an H100 the tests' tensor-core cases read at most
# 2.7e-4 of max |ref| against the emulation, 2.4e-3 against the same splits
# without the rounding: a split or merge that is off shows far above this.
TOL_EMULATED = 1e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _close(got, ref, dtype):
    got, ref = got.float().cpu(), ref.float().cpu()
    scale = ref.abs().max().item() + 1e-6
    assert got.isfinite().all()
    assert (got - ref).abs().max().item() / scale <= TOL[dtype]


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


FORMATS = [GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_0,
           GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K, GGMLType.Q2_K, GGMLType.Q3_K]


@pytest.mark.parametrize("gtype", FORMATS, ids=[f.name.lower() for f in FORMATS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("S", [1, 3, 300, 2, 17, 513])
def test_quant_matmul(dev, gtype, dtype, S):
    """O = 100 (ragged GEMV, 64- and 128-row tiles) at K = 320 (legacy: one
    and a quarter of the tile's 256-column units) or 512; S = 513 adds O = 301
    and K = 768. One launch counts
    under the wrapper, the format and the route: one row of a K-quant runs
    the K-quant GEMV, of a legacy format the legacy one; bf16 rows > 1 run
    the tensor-core tile, f32 rows the SIMT tile, neither the other's."""
    O, K = (301, 768) if S == 513 else (100, 512 if gtype in qm.K_QUANTS else 320)
    w = random_quant(gtype, O, K, _gen(S), dev, scale=0.2)
    x = torch.randn(S, K, generator=_gen(S + 1), device=dev).to(dtype)
    path = "gemv" if S == 1 else "tc" if dtype == torch.bfloat16 else "simt"
    if path == "gemv" and gtype in qm.K_QUANTS:
        path = "gemv.kq"
    names = ["quant_matmul", f"quant_matmul.{gtype.name.lower()}", "quant_matmul.gemv",
             "quant_matmul.gemv.kq", "quant_matmul.tc", "quant_matmul.simt"]
    before = {n: build.launch_counts[n] for n in names}
    got = qm.quant_matmul(w, x, dtype)
    for n in names:
        ran = n in ("quant_matmul", f"quant_matmul.{gtype.name.lower()}", f"quant_matmul.{path}")
        assert build.launch_counts[n] == before[n] + int(ran), n
    _close(got, qm.quant_matmul_plain(w, x, dtype), dtype)


@pytest.mark.parametrize("gtype", [GGMLType.Q4_0, GGMLType.Q5_1, GGMLType.Q8_0, GGMLType.Q6_K],
                         ids=["q4_0", "q5_1", "q8_0", "q6_k"])
@pytest.mark.parametrize("nt", qm.TC_ROWS)
def test_quant_matmul_tc_every_tile_width(dev, gtype, nt, monkeypatch):
    """Each of the tile's four widths on the same ragged problem (S = 300,
    O = 200; f32 output as lm_head asks), whatever width the rule would pick."""
    monkeypatch.setattr(qm, "tc_rows", lambda S, O: nt)
    O, K, S = 200, 1024, 300
    w = random_quant(gtype, O, K, _gen(nt), dev, scale=0.2)
    x = torch.randn(S, K, generator=_gen(nt + 1), device=dev).to(torch.bfloat16)
    before = build.launch_counts["quant_matmul.tc"]
    got = qm.quant_matmul(w, x, torch.float32)
    assert build.launch_counts["quant_matmul.tc"] == before + 1 and got.dtype == torch.float32
    _close(got, qm.quant_matmul_plain(w, x, torch.float32), torch.bfloat16)


@pytest.mark.parametrize("gtype", FORMATS[:5], ids=[f.name.lower() for f in FORMATS[:5]])
@pytest.mark.parametrize("K", [96, 352])
def test_quant_matmul_tc_odd_group_count(dev, gtype, K):
    """A legacy K that is an odd number of 32-groups: the tile's last
    64-column slab is half empty and decodes zero-filled records."""
    O, S = 70, 33
    w = random_quant(gtype, O, K, _gen(K), dev, scale=0.2)
    x = torch.randn(S, K, generator=_gen(K + 1), device=dev).to(torch.bfloat16)
    before = build.launch_counts["quant_matmul.tc"]
    got = qm.quant_matmul(w, x, torch.bfloat16)
    assert build.launch_counts["quant_matmul.tc"] == before + 1
    _close(got, qm.quant_matmul_plain(w, x, torch.bfloat16), torch.bfloat16)


def test_quant_matmul_refuses_what_is_not_ported(dev):
    """On a CUDA tensor a type that is no weight format, a K-quant width
    that is not whole super-blocks, or an f16 x raises; nothing falls back
    to the plain version."""
    x = torch.randn(1, 256, device=dev)
    q8k = SimpleNamespace(gtype=GGMLType.Q8_K, shape=(64, 256), planes={})
    with pytest.raises(NotImplementedError):
        qm.quant_matmul(q8k, x, torch.float32)
    for gtype in (GGMLType.Q4_K, GGMLType.Q3_K):
        w = random_quant(gtype, 64, 512, _gen(0), dev)
        bad = QuantTensor(gtype, (64, 320), w.planes)  # 320 % 256 != 0
        with pytest.raises(ValueError):
            qm.quant_matmul(bad, torch.randn(1, 320, device=dev), torch.float32)
        with pytest.raises(TypeError):
            qm.quant_matmul(w, torch.randn(1, 512, device=dev).half(), torch.float32)
        with pytest.raises(TypeError):  # the tensor-core route takes bf16 rows only
            qm.quant_matmul(w, torch.randn(4, 512, device=dev).half(), torch.float32)
        with pytest.raises(ValueError):  # and whole super-blocks
            qm.quant_matmul(bad, torch.randn(4, 320, device=dev).to(torch.bfloat16), torch.bfloat16)
        with pytest.raises(TypeError):
            qm.quant_matmul(w, torch.randn(4, 512, device=dev).to(torch.bfloat16), torch.float16)
    # the C entry points refuse what their kernels are not built for
    w = random_quant(GGMLType.Q4_0, 64, 256, _gen(0), dev)
    x = torch.randn(4, 256, device=dev).to(torch.bfloat16)
    y = torch.empty(4, 64, device=dev, dtype=torch.bfloat16)
    ptrs = qm._plane_ptrs(w, x.device)
    with pytest.raises(RuntimeError):  # a tile width that is not built
        build.launch("gq_quant_matmul_tc", "quant_matmul.refused", int(w.gtype), x.data_ptr(), *ptrs,
                     y.data_ptr(), 0, 4, 256, 64, 32, build.stream_ptr(x.device))
    with pytest.raises(RuntimeError):  # bf16 rows > 1 on the SIMT tile
        build.launch("gq_quant_matmul", "quant_matmul.refused", int(w.gtype), x.data_ptr(), 1,
                     *ptrs, None, y.data_ptr(), 1, 4, 256, 64, build.stream_ptr(x.device))
    assert build.launch_counts["quant_matmul.refused"] == 0


KQ = [GGMLType.Q4_K, GGMLType.Q3_K, GGMLType.Q5_K, GGMLType.Q2_K, GGMLType.Q6_K]


@pytest.mark.parametrize("gtype", KQ, ids=[f.name.lower() for f in KQ])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["x_f32", "x_bf16"])
@pytest.mark.parametrize("ydtype", [torch.float32, torch.bfloat16], ids=["y_f32", "y_bf16"])
@pytest.mark.parametrize("K", [256, 40960])
@pytest.mark.parametrize("rows", [1, 2])
def test_gemv_kq(dev, gtype, xdtype, ydtype, K, rows, monkeypatch):
    """The K-quant GEMV at O = 37 (no multiple of the 4 or 8 rows a block),
    K = 256 (one super-block: most lanes of the warp idle) and 40960
    (Falcon-40B w_od), one and two rows a warp: against gemv_emulated, which
    sums as the kernel does, 1e-5 of max |ref| for f32 y (a bf16 y adds its
    rounding, 2^-8 of a value), and against the plain version at the
    tolerance of x's dtype. One launch, counted as the K-quant GEMV and
    never as the legacy one."""
    monkeypatch.setitem(qm.GEMV_ROWS, gtype, rows)
    O = 37
    w = random_quant(gtype, O, K, _gen(K + rows), dev, scale=0.2)
    x = torch.randn(1, K, generator=_gen(K + 7), device=dev).to(xdtype)
    names = ("quant_matmul", f"quant_matmul.{gtype.name.lower()}", "quant_matmul.gemv.kq",
             "quant_matmul.gemv", "quant_matmul.tc", "quant_matmul.simt")
    before = {n: build.launch_counts[n] for n in names}
    got = qm.quant_matmul(w, x, ydtype)
    torch.cuda.synchronize()
    for n in names:
        assert build.launch_counts[n] == before[n] + int(n in names[:3]), n
    assert got.shape == (1, O) and got.dtype == ydtype
    w_cpu = QuantTensor(w.gtype, w.shape, {k: v.cpu() for k, v in w.planes.items()})
    emu = qm.gemv_emulated(w_cpu, x.cpu())
    scale = emu.abs().max().item()
    err = (got.float().cpu() - emu).abs().max().item() / scale
    assert got.isfinite().all() and err <= (1e-5 if ydtype == torch.float32 else 2 ** -8)
    _close(got, qm.quant_matmul_plain(w, x, ydtype), xdtype)


def test_gemv_kq_refuses(dev):
    """The K-quant GEMV's entry point refuses a legacy format, a width that
    is not whole super-blocks, a rows-a-warp it is not built for and a
    missing plane; the legacy GEMV no longer takes a K-quant row."""
    w = random_quant(GGMLType.Q4_K, 64, 512, _gen(0), dev)
    x = torch.randn(1, 512, device=dev).to(torch.bfloat16)
    y = torch.empty(1, 64, device=dev)
    ptrs = qm._plane_ptrs(w, x.device)
    st = build.stream_ptr(x.device)
    for gtype, K, rows, planes in ((int(GGMLType.Q4_0), 512, 2, ptrs),
                                   (int(w.gtype), 320, 2, ptrs), (int(w.gtype), 512, 3, ptrs),
                                   (int(w.gtype), 512, 2, [None] + ptrs[1:])):
        with pytest.raises(RuntimeError):
            build.launch("gq_quant_gemv_kq", "quant_matmul.refused", gtype, x.data_ptr(), 1,
                         *planes, y.data_ptr(), 0, K, 64, rows, st)
    with pytest.raises(RuntimeError):
        build.launch("gq_quant_matmul", "quant_matmul.refused", int(w.gtype), x.data_ptr(), 1,
                     *ptrs, None, y.data_ptr(), 0, 1, 512, 64, st)
    assert build.launch_counts["quant_matmul.refused"] == 0


LEGACY = [GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_0]


@pytest.mark.parametrize("gtype", LEGACY, ids=[f.name.lower() for f in LEGACY])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["x_f32", "x_bf16"])
@pytest.mark.parametrize("ydtype", [torch.float32, torch.bfloat16], ids=["y_f32", "y_bf16"])
@pytest.mark.parametrize("K", [96, 4544, 22720])
@pytest.mark.parametrize("rows", [1, 2])
def test_gemv_legacy(dev, gtype, xdtype, ydtype, K, rows, monkeypatch):
    """The legacy GEMV at O = 37 (no multiple of the 4 or 8 rows a block),
    K = 96 (three blocks: most lanes of the warp idle), 4544 (Falcon-7B's
    width, 142 blocks: a last step of 14 blocks, or 14 of 16 for Q8_0) and
    22720 (Falcon-7B w_od), one and two rows a warp: against gemv_emulated,
    which sums as the kernel does, 1e-5 of max |ref| for f32 y (a bf16 y adds
    its rounding, 2^-8 of a value), and against the plain version at the
    tolerance of x's dtype. One launch, counted as the legacy GEMV and never
    as the K-quant one."""
    monkeypatch.setitem(qm.GEMV_ROWS, gtype, rows)
    O = 37
    w = random_quant(gtype, O, K, _gen(K + rows), dev, scale=0.2)
    x = torch.randn(1, K, generator=_gen(K + 7), device=dev).to(xdtype)
    names = ("quant_matmul", f"quant_matmul.{gtype.name.lower()}", "quant_matmul.gemv",
             "quant_matmul.gemv.kq", "quant_matmul.tc", "quant_matmul.simt")
    before = {n: build.launch_counts[n] for n in names}
    got = qm.quant_matmul(w, x, ydtype)
    torch.cuda.synchronize()
    for n in names:
        assert build.launch_counts[n] == before[n] + int(n in names[:3]), n
    assert got.shape == (1, O) and got.dtype == ydtype
    w_cpu = QuantTensor(w.gtype, w.shape, {k: v.cpu() for k, v in w.planes.items()})
    emu = qm.gemv_emulated(w_cpu, x.cpu())
    scale = emu.abs().max().item()
    err = (got.float().cpu() - emu).abs().max().item() / scale
    assert got.isfinite().all() and err <= (1e-5 if ydtype == torch.float32 else 2 ** -8)
    _close(got, qm.quant_matmul_plain(w, x, ydtype), xdtype)


def test_gemv_legacy_refuses(dev):
    """The legacy GEMV's entry point refuses a K-quant format, a width that
    is not whole blocks, a rows-a-warp it is not built for and a missing
    plane (Q5_1's qh, its m); the SIMT tile's entry point takes no single
    row, of either dtype."""
    w = random_quant(GGMLType.Q5_1, 64, 512, _gen(0), dev)
    y = torch.empty(1, 64, device=dev)
    st = build.stream_ptr(y.device)
    ptrs = qm._plane_ptrs(w, y.device)
    for xdtype in (torch.bfloat16, torch.float32):
        x = torch.randn(1, 512, device=dev).to(xdtype)
        xb = int(xdtype == torch.bfloat16)
        for gtype, K, rows, planes in ((int(GGMLType.Q4_K), 512, 2, ptrs),
                                       (int(w.gtype), 496, 2, ptrs), (int(w.gtype), 512, 3, ptrs),
                                       (int(w.gtype), 512, 2, ptrs[:1] + [None] + ptrs[2:]),
                                       (int(w.gtype), 512, 2, ptrs[:3] + [None] + ptrs[4:])):
            with pytest.raises(RuntimeError):
                build.launch("gq_quant_gemv_legacy", "quant_matmul.refused", gtype, x.data_ptr(),
                             xb, *planes, y.data_ptr(), 0, K, 64, rows, st)
        xg = torch.zeros(1, 16, device=dev)
        with pytest.raises(RuntimeError):
            build.launch("gq_quant_matmul", "quant_matmul.refused", int(w.gtype), x.data_ptr(), xb,
                         *ptrs, xg.data_ptr(), y.data_ptr(), 0, 1, 512, 64, st)
    assert build.launch_counts["quant_matmul.refused"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("g", [32, 16])
def test_group_sums(dev, dtype, g):
    x = torch.randn(300, 320, generator=_gen(0), device=dev).to(dtype)
    _close(qm.group_sums(x, g), qm.group_sums_plain(x, g), torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("H,KV,D", [(8, 1, 64), (6, 2, 64), (5, 1, 32), (128, 8, 64),
                                    (4, 4, 128), (32, 32, 128), (6, 6, 64), (5, 5, 32),
                                    (8, 2, 128)])
@pytest.mark.parametrize("n_past", [0, 37, "rows"])
def test_flash_mqa(dev, dtype, H, KV, D, n_past):
    """bf16 at D 64 / 128 runs the tensor-core kernel, f32 and D = 32 the f32
    kernels (G == 1 and D == 128: one head per block), counted as such; 45
    query rows are a ragged last block in every layout."""
    _flash_mqa_case(dev, dtype, H, KV, D, n_past, S=45)


def _flash_mqa_case(dev, dtype, H, KV, D, n_past, S):
    B, T = 2, 160 + 64 * (S // 64)
    g = _gen(H * D)
    q = torch.randn(B, S, H, D, generator=g, device=dev).to(dtype)
    kv = torch.randn(1, 2, B, T, KV, D, generator=g, device=dev).to(dtype)
    if n_past == "rows":
        n_past = torch.tensor([3, 90], dtype=torch.int32, device=dev)
    tc = dtype == torch.bfloat16 and D in (64, 128)
    before = {n: build.launch_counts[n] for n in ("flash_mqa", "flash_mqa.tc", "flash_mqa.simt")}
    got = flash_mqa(q, kv[0, 0], kv[0, 1], n_past)
    assert build.launch_counts["flash_mqa"] == before["flash_mqa"] + 1
    assert build.launch_counts["flash_mqa.tc"] == before["flash_mqa.tc"] + int(tc)
    assert build.launch_counts["flash_mqa.simt"] == before["flash_mqa.simt"] + int(not tc)
    _close(got, flash_mqa_plain(q, kv[0, 0], kv[0, 1], n_past), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("H,KV,D", [(71, 1, 64), (16, 2, 64), (6, 6, 128)])
@pytest.mark.parametrize("n_past", [0, "rows"])
@pytest.mark.parametrize("S", [2, 17, 300, 513])
def test_flash_mqa_row_counts(dev, dtype, H, KV, D, n_past, S):
    """Short, ragged and multi-block query counts (513 rows of 71 heads are
    570 blocks of one K/V head) at the three head layouts."""
    _flash_mqa_case(dev, dtype, H, KV, D, n_past, S)


def _decode_counter(KV, H, int8):
    return "flash_decode" + (".mha" if H == KV and KV > 1 else "") + (".int8" if int8 else "")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, "int8"],
                         ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("KV,H,D", [(1, 71, 64), (2, 6, 64), (1, 5, 32), (8, 128, 64),
                                    (32, 32, 128), (6, 6, 64), (3, 3, 32)])
@pytest.mark.parametrize("valid", [0, 1, 63, 64, 65, [200, 7]])
def test_cache_partials(dev, dtype, KV, H, D, valid):
    """int8: the cache is the (codes, scales) pair of a quantized random
    cache, q is bf16, and the launch counts under the int8 variant's name;
    H == KV > 1 counts under the G == 1 kernel's. m and l to f32 accuracy;
    acc too, but on the tensor-core route (bf16 q, grouped heads, D 64 / 128),
    which rounds P to bf16 for the P V product, to bf16 accuracy, and there
    the splits and their merge are held to partials_emulated, which rounds
    P where the kernel does."""
    B, T, L, l = 2, 256, 3, 2
    g = _gen(H)
    kv = torch.randn(L, 2, B, T, KV, D, generator=g, device=dev)
    qg = torch.randn(B, KV, H // KV, D, generator=g, device=dev)
    if dtype == "int8":
        kv, qg = kvcache.quantize_new(kv), qg.to(torch.bfloat16)
    else:
        kv, qg = kv.to(dtype), qg.to(dtype)
    counter = _decode_counter(KV, H, dtype == "int8")
    before = build.launch_counts[counter]
    acc, m, lsum = fd.cache_partials(kv, KV, l, qg, valid)
    assert build.launch_counts[counter] == before + 1
    acc_p, m_p, l_p = fd.cache_partials_plain(kv, KV, l, qg, valid)
    _close(m, m_p, torch.float32)
    _close(lsum, l_p, torch.float32)
    cache = "int8" if dtype == "int8" else str(dtype).removeprefix("torch.")
    tc = fd.route(KV, H // KV, D, cache, str(qg.dtype).removeprefix("torch.")) == "tc"
    _close(acc, acc_p, torch.bfloat16 if tc else torch.float32)
    if tc:
        _close_emulated((acc, m, lsum), kv, KV, l, qg, valid)


def _close_emulated(got, kv, KV, layer, qg, cache_valid):
    """cache_partials' (acc, m, l) against partials_emulated at this card's
    SM count (so with the kernel's splits): acc to TOL_EMULATED of max
    |ref|, m and l to f32 accuracy."""
    acc_e, m_e, l_e = fd.partials_emulated(kv, KV, layer, qg, cache_valid,
                                           n_sm=fd._sm_count(qg.device))
    acc, m, lsum = got
    _close(m, m_e, torch.float32)
    _close(lsum, l_e, torch.float32)
    got, ref = acc.float().cpu(), acc_e.cpu()
    err = (got - ref).abs().max().item() / (ref.abs().max().item() + 1e-6)
    assert err <= TOL_EMULATED, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, "int8"],
                         ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("KV,H,D", [(1, 71, 64), (1, 5, 32), (8, 128, 64),
                                    (32, 32, 128), (6, 6, 64), (3, 3, 32)])
@pytest.mark.parametrize("variant", ["no_append", "append", "append_valid", "append_only"])
def test_flash_decode(dev, dtype, KV, H, D, variant):
    """The whole decode attention (partials, then the finishing kernel with
    the [current; pending] append block) against its plain version; per-row
    n_past; "append_only": nothing valid in the cache yet."""
    B, T, L, l, A = 2, 256, 3, 1, 17
    g = _gen(H + len(variant))
    kv = torch.randn(L, 2, B, T, KV, D, generator=g, device=dev)
    cdtype = torch.bfloat16 if dtype == "int8" else dtype
    q = torch.randn(B, 1, H, D, generator=g, device=dev).to(cdtype)
    app = torch.randn(2, B, A, KV, D, generator=g, device=dev).to(cdtype)
    kv = kvcache.quantize_new(kv) if dtype == "int8" else kv.to(dtype)
    n_past = torch.tensor([130, 9], dtype=torch.int32, device=dev)
    kw = {}
    if variant == "append":
        kw = {"kv_append": app[:, :, :1]}
    elif variant == "append_valid":
        kw = {"kv_append": app, "append_valid": 6}
    elif variant == "append_only":
        n_past, kw = 4, {"kv_append": app, "append_valid": 5}
    counter = _decode_counter(KV, H, dtype == "int8")
    before = build.launch_counts[counter]
    got = fd.flash_decode(kv, KV, l, q, n_past, **kw)
    assert build.launch_counts[counter] == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, fd.flash_decode_plain(kv, KV, l, q, n_past, **kw), cdtype)


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16], ids=["qf32", "qbf16"])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("valid", [1, 300, 2047, [2047, 300]])
def test_mha_decode_at_llama7b_heads(dev, qdtype, cache, valid):
    """KV = 32, D = 128, T = 2560 (3 of LLaMA-7B's 32 layers): partials and the
    whole decode with a 16-entry append block of which 5 are valid. A dense
    cache takes q in its own dtype; an int8 cache leaves q as it is."""
    B = 2 if isinstance(valid, list) else 1
    L, l, T, KV, D = 3, 2, 2560, 32, 128
    g = _gen(B + len(cache))
    kv = torch.randn(L, 2, B, T, KV, D, generator=g, device=dev)
    q = torch.randn(B, 1, KV, D, generator=g, device=dev).to(qdtype)
    app = torch.randn(2, B, 16, KV, D, generator=g, device=dev).to(qdtype)
    kv = kvcache.quantize_new(kv) if cache == "int8" else kv.to(torch.bfloat16)
    tol = torch.bfloat16 if cache == "bf16" or qdtype == torch.bfloat16 else torch.float32
    counter = _decode_counter(KV, KV, cache == "int8")
    before = build.launch_counts[counter]
    got = fd.cache_partials(kv, KV, l, q.reshape(B, KV, 1, D), valid)
    ref = fd.cache_partials_plain(kv, KV, l, q.reshape(B, KV, 1, D).to(
        torch.bfloat16 if cache == "bf16" else qdtype), valid)
    for a, b in zip(got, ref):
        _close(a, b, tol)
    n_past = torch.tensor(valid, dtype=torch.int32, device=dev) + 4 if B == 2 else valid + 4
    out = fd.flash_decode(kv, KV, l, q, n_past, kv_append=app, append_valid=5)
    assert build.launch_counts[counter] == before + 2
    assert out.dtype == qdtype and out.shape == q.shape
    _close(out, fd.flash_decode_plain(kv, KV, l, q, n_past, kv_append=app, append_valid=5), tol)


def test_flash_decode_refuses_head_shapes_it_does_not_take(dev):
    """D = 128 with grouped query heads on an f32 cache (the SIMT route),
    and D = 256, raise on the card."""
    for KV, H, D in ((2, 8, 128), (4, 4, 256), (1, 1, 128)):
        kv = torch.zeros(1, 2, 1, 64, KV, D, device=dev)
        with pytest.raises(NotImplementedError):
            fd.flash_decode(kv, KV, 0, torch.zeros(1, 1, H, D, device=dev), 5)
    with pytest.raises(NotImplementedError):
        flash_mqa(torch.zeros(1, 4, 2, 256, device=dev), torch.zeros(1, 8, 2, 256, device=dev),
                  torch.zeros(1, 8, 2, 256, device=dev), 0)
    bf = torch.bfloat16
    with pytest.raises(NotImplementedError):  # the tensor-core route too
        flash_mqa(torch.zeros(1, 4, 2, 256, device=dev, dtype=bf),
                  torch.zeros(1, 8, 2, 256, device=dev, dtype=bf),
                  torch.zeros(1, 8, 2, 256, device=dev, dtype=bf), 0)
    with pytest.raises(TypeError):  # a bf16 q on an f32 cache
        flash_mqa(torch.zeros(1, 4, 2, 64, device=dev, dtype=bf),
                  torch.zeros(1, 8, 2, 64, device=dev), torch.zeros(1, 8, 2, 64, device=dev), 0)
    with pytest.raises(TypeError):
        flash_mqa(torch.zeros(1, 4, 2, 64, device=dev).half(),
                  torch.zeros(1, 8, 2, 64, device=dev).half(),
                  torch.zeros(1, 8, 2, 64, device=dev).half(), 0)
    with pytest.raises(ValueError):  # heads that are not contiguous
        k = torch.zeros(1, 8, 2, 128, device=dev, dtype=bf)[..., :64]
        flash_mqa(torch.zeros(1, 4, 2, 64, device=dev, dtype=bf), k, k, 0)


def _decode_case(dev, cache, KV, H, D, valid, append, T=2560, L=2, seed=0):
    """A random L-layer cache (bf16, or int8 codes and scales), a bf16 q and
    flash_decode's arguments for `valid` cache positions ("rows": B = 2 with
    lengths [2047, 300] as an int32 device tensor), with or without a
    16-entry append block of which 5 are valid."""
    B = 2 if valid == "rows" else 1
    g = _gen(seed)
    kv = torch.randn(L, 2, B, T, KV, D, generator=g, device=dev)
    kv = kvcache.quantize_new(kv) if cache == "int8" else kv.to(torch.bfloat16)
    q = torch.randn(B, 1, H, D, generator=g, device=dev).to(torch.bfloat16)
    lens = (torch.tensor([2047, 300], dtype=torch.int32, device=dev) if valid == "rows"
            else valid)
    if append:  # the cache is valid below n_past - 4
        app = torch.randn(2, B, 16, KV, D, generator=g, device=dev).to(torch.bfloat16)
        return kv, q, lens + 4, {"kv_append": app, "append_valid": 5}
    return kv, q, lens - 1, {}


@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("KV,H,D", [(1, 71, 64), (8, 128, 64), (32, 32, 128)],
                         ids=["falcon7b", "falcon40b", "llama7b"])
@pytest.mark.parametrize("valid", [1, 300, 2047, "rows"])
@pytest.mark.parametrize("append", [False, True], ids=["cache", "append"])
def test_decode_at_main_path_shapes(dev, cache, KV, H, D, valid, append):
    """The one-launch kernels at the main paths' head layouts against the
    plain version (2e-2 of max |ref|): grouped heads on the tensor-core
    kernel, G == 1 on decode_mha_kernel; bf16 and int8 caches, with and
    without the append block, one length or one per row."""
    kv, q, n_past, kw = _decode_case(dev, cache, KV, H, D, valid, append)
    counter = ("flash_decode_tc" + (".int8" if cache == "int8" else "") if H > KV
               else _decode_counter(KV, H, cache == "int8"))
    before = build.launch_counts[counter]
    got = fd.flash_decode(kv, KV, 1, q, n_past, **kw)
    assert build.launch_counts[counter] == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, fd.flash_decode_plain(kv, KV, 1, q, n_past, **kw), torch.bfloat16)
    qg = q.reshape(q.shape[0], KV, H // KV, D)
    lens = n_past - 3 if append else n_past + 1  # the cache rows attended
    acc, m, lsum = fd.cache_partials(kv, KV, 1, qg, lens)
    acc_p, m_p, l_p = fd.cache_partials_plain(kv, KV, 1, qg, lens)
    _close(acc / lsum, acc_p / l_p, torch.bfloat16)
    _close(m, m_p, torch.bfloat16)
    if H > KV:  # the tensor-core route: its splits and merge as partials_emulated's
        _close_emulated((acc, m, lsum), kv, KV, 1, qg, lens)


@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("KV,H", [(2, 8), (1, 71)])
def test_grouped_decode_at_head_dim_128(dev, cache, KV, H):
    """Grouped heads at D = 128 take the tensor-core kernel (the SIMT kernel
    stops at 64), with per-row lengths and the append block."""
    ok, rt = fd.supports(KV, H // KV, 128, "int8" if cache == "int8" else "bfloat16")
    assert ok and rt == "tc"
    for append in (False, True):
        kv, q, n_past, kw = _decode_case(dev, cache, KV, H, 128, "rows", append, seed=3)
        _close(fd.flash_decode(kv, KV, 0, q, n_past, **kw),
               fd.flash_decode_plain(kv, KV, 0, q, n_past, **kw), torch.bfloat16)


@pytest.mark.parametrize("cache,KV,H,D", [("bf16", 1, 71, 64), ("int8", 8, 128, 64),
                                          ("bf16", 32, 32, 128), ("int8", 32, 32, 128)])
def test_decode_graph_replays_at_new_lengths(dev, cache, KV, H, D):
    """32 calls (one per layer of a 4-layer cache, in turn) captured in one
    CUDA graph with the lengths in an int32 device tensor, replayed at two
    sets of lengths: every output equals the plain version's."""
    L, T, B = 4, 2304, 2
    g = _gen(KV + H)
    kv = torch.randn(L, 2, B, T, KV, D, generator=g, device=dev)
    kv = kvcache.quantize_new(kv) if cache == "int8" else kv.to(torch.bfloat16)
    qs = [torch.randn(B, 1, H, D, generator=g, device=dev).to(torch.bfloat16) for _ in range(32)]
    n_past = torch.tensor([300, 7], dtype=torch.int32, device=dev)

    def step():
        return [fd.flash_decode(kv, KV, i % L, q, n_past) for i, q in enumerate(qs)]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up: the library, the workspace
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    for lens in ([300, 7], [2000, 64]):
        n_past.copy_(torch.tensor(lens, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        for i, (q, out) in enumerate(zip(qs, outs)):
            _close(out, fd.flash_decode_plain(kv, KV, i % L, q, n_past), torch.bfloat16)


@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("KV,H,D", [(1, 71, 64), (32, 32, 128)], ids=["grouped", "mha"])
def test_decode_is_one_launch_that_allocates_only_its_output(dev, cache, KV, H, D):
    """The profiler sees one kernel a call (no merge_kernel or
    finish_kernel), the allocator one allocation (the output), and the
    workspace is the same memory across calls of one shape."""
    from torch.profiler import ProfilerActivity, profile

    kv, q, n_past, kw = _decode_case(dev, cache, KV, H, D, "rows", True, seed=9)
    fd.flash_decode(kv, KV, 0, q, n_past, **kw)  # warm-up
    torch.cuda.synchronize()
    ws = {k: v[0].data_ptr() for k, v in fd._workspaces.items()}
    later = n_past + 30
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    fd.flash_decode(kv, KV, 1, q, later, **kw)
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == before + 1
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fd.flash_decode(kv, KV, 0, q, n_past, **kw)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1, kernels
    assert not any("merge_kernel" in k or "finish_kernel" in k for k in kernels)
    assert {k: v[0].data_ptr() for k, v in fd._workspaces.items()} == ws


@pytest.mark.parametrize("cache,KV,H,D", [("bf16", 1, 71, 64), ("int8", 8, 128, 64),
                                          ("int8", 32, 32, 128)])
def test_decode_on_two_streams_at_once(dev, cache, KV, H, D):
    """Calls of one shape issued in turn on two streams, with nothing between
    them, run at once: each stream has its own workspace, and every output
    equals the plain version's."""
    kv, q, n_past, _ = _decode_case(dev, cache, KV, H, D, 2047, False, seed=5)
    g = _gen(11)
    qs = [torch.randn(q.shape, generator=g, device=dev).to(torch.bfloat16) for _ in range(32)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = []
    for i, qi in enumerate(qs):
        with torch.cuda.stream(streams[i % 2]):
            outs.append(fd.flash_decode(kv, KV, i % 2, qi, n_past))
    torch.cuda.synchronize()
    assert {st.cuda_stream for st in streams} <= {k[1] for k in fd._workspaces}
    for i, (qi, out) in enumerate(zip(qs, outs)):
        _close(out, fd.flash_decode_plain(kv, KV, i % 2, qi, n_past), torch.bfloat16)


def test_dense_linear_keeps_the_f32_accumulator(dev):
    """A dense bf16 weight (how the loader holds an F16 tensor) times bf16 x:
    one bf16 product with no f32 copy of the weight, f32 logits within 1e-5
    of the f32 product of the same values, bf16 outputs as bf16."""
    from ggllm_tpu_torch.ops.linear import linear

    w = (torch.randn(4096, 1024, generator=_gen(1), device=dev) * 0.05).to(torch.bfloat16)
    x = torch.randn(3, 1024, generator=_gen(2), device=dev).to(torch.bfloat16)
    ref = x.float() @ w.float().t()
    y = linear(w, x, torch.float32)
    assert y.dtype == torch.float32
    assert (y - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    yb = linear(w, x)
    assert yb.dtype == torch.bfloat16
    _close(yb, ref, torch.bfloat16)


def test_cache_partials_refuses_a_bad_int8_pair(dev):
    """int8 codes with scales of another shape or dtype, or an f16 q, raise."""
    codes, scales = kvcache.quantize_new(torch.randn(2, 2, 1, 64, 1, 64, device=dev))
    qg = torch.randn(1, 1, 4, 64, device=dev)
    with pytest.raises(ValueError):
        fd.cache_partials((codes, scales[..., 0]), 1, 0, qg, 5)
    with pytest.raises(TypeError):
        fd.cache_partials((codes, scales.half()), 1, 0, qg, 5)
    with pytest.raises(TypeError):
        fd.cache_partials((codes, scales), 1, 0, qg.half(), 5)
    q = torch.randn(1, 1, 4, 64, device=dev)
    with pytest.raises(ValueError):  # an append block of another head layout
        fd.flash_decode((codes, scales), 1, 0, q, 5, kv_append=torch.randn(2, 1, 3, 2, 64, device=dev))
    with pytest.raises(ValueError):
        fd.flash_decode((codes, scales), 1, 0, q, 5, kv_append=torch.randn(2, 1, 3, 1, 64, device=dev),
                        append_valid=4)


@pytest.mark.parametrize("gtype,kv_dtype", [(GGMLType.Q4_0, "float32"), (GGMLType.Q4_1, "float32"),
                                            (GGMLType.Q4_K, "float32"), (GGMLType.Q6_K, "float32"),
                                            (GGMLType.Q2_K, "float32"), (GGMLType.Q3_K, "int8")],
                         ids=["q4_0", "q4_1", "q4_k", "q6_k", "q2_k", "q3_k_int8"])
def test_tiny_model_on_card_matches_cpu(dev, tmp_path, gtype, kv_dtype):
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.io.loader import load_model
    from ggllm_tpu_torch.ops.sampling import SamplerParams
    from ggllm_tpu_torch.utils.synthetic import write_tiny_model

    path = str(tmp_path / "tiny.ggcc")
    hp = FalconHParams.tiny() if gtype not in qm.K_QUANTS else FalconHParams(
        n_vocab=512, n_embd=256, n_head=8, n_head_kv=2, n_layer=2, n_falcon_type=40,
        n_bpe_merges=0)
    write_tiny_model(path, hp, gtype, seed=5)
    cfg = EngineConfig(n_ctx=64, n_batch=16, kv_dtype=kv_dtype, compute_dtype="float32")
    prompt = [int(t) for t in np.random.default_rng(4).integers(12, 500, 40)]  # 3 chunks
    logits, ids = [], []
    for device in ("cpu", "cuda"):
        mf, params = load_model(path, cfg, device=device)
        eng = FalconEngine(mf.hparams, params, cfg, device=device)
        logits.append(eng.eval(prompt))
        eng.reset()
        ids.append(eng.generate(prompt, 12, SamplerParams(temp=0.0)))
    scale = np.abs(logits[0]).max()
    np.testing.assert_allclose(logits[1] / scale, logits[0] / scale, atol=1e-4)
    assert ids[0] == ids[1]


@pytest.mark.parametrize("gtype,kv_dtype,compute", [
    (GGMLType.Q4_0, "float32", "float32"), (GGMLType.Q8_0, "int8", "float32"),
    (GGMLType.Q4_K, "float32", "float32"), (GGMLType.Q4_K, "int8", "float32"),
    (GGMLType.Q4_0, "bfloat16", "bfloat16")],
    ids=["q4_0", "q8_0_int8", "q4_k", "q4_k_int8", "q4_0_bf16"])
def test_tiny_llama_on_card_matches_cpu(dev, tmp_path, gtype, kv_dtype, compute):
    """A tiny GGJT LLaMA file (head_dim 32; 64 for Q4_K) through the kernels
    on the card against the plain versions on the CPU: logits of a 3-chunk
    prefill, then greedy ids over two decode chunks, with the G == 1 decode
    kernel counted. f32 on a dense cache: logits within 1e-4 of max |logit|,
    ids equal. f32 on an int8 cache: 2e-3 (the two devices' f32 K/V differ in
    their last bits, a code at a rounding tie lands one step apart, and later
    chunks and layers attend it), ids not compared. bf16: 2e-2."""
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.io.loader import load_model
    from ggllm_tpu_torch.ops.sampling import SamplerParams
    from ggllm_tpu_torch.utils.synthetic import write_tiny_llama

    path = str(tmp_path / "tiny.ggjt")
    hp = LlamaHParams.tiny() if gtype not in qm.K_QUANTS else LlamaHParams(
        n_vocab=512, n_embd=256, n_mult=256, n_head=4, n_layer=2, n_rot=64)
    write_tiny_llama(path, hp, gtype, seed=5)
    cfg = EngineConfig(n_ctx=64, n_batch=16, kv_dtype=kv_dtype, compute_dtype=compute)
    prompt = [int(t) for t in np.random.default_rng(4).integers(3, 500, 40)]  # 3 chunks
    counter = _decode_counter(hp.n_head, hp.n_head, kv_dtype == "int8")
    before = build.launch_counts[counter]
    logits, ids = [], []
    for device in ("cpu", "cuda"):
        mf, params = load_model(path, cfg, device=device)
        eng = FalconEngine(mf.hparams, params, cfg, device=device)
        logits.append(eng.eval(prompt))
        eng.reset()
        ids.append(eng.generate(prompt, 20, SamplerParams(temp=0.0)))
    assert build.launch_counts[counter] == before + 19 * hp.n_layer
    scale = np.abs(logits[0]).max()
    exact = compute == "float32" and kv_dtype != "int8"
    atol = 1e-4 if exact else 2e-3 if compute == "float32" else 2e-2
    np.testing.assert_allclose(logits[1] / scale, logits[0] / scale, atol=atol)
    assert len(ids[0]) == len(ids[1]) == 20 and (ids[0] == ids[1] or not exact)
