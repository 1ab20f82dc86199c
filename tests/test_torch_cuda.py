"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda` and skipped without one. These cover what chip_smoke.py's
full-width checks do not: every quant format with f32 and bf16 inputs
(2 to 16 bf16 rows through the rows kernel at each of its cluster sizes,
bit for bit independent of the other rows and held at f32 accuracy, more
through the bf16 tensor-core tile at each of its three widths,
f32 rows through the f32 tensor-core tile at each of its three widths and
at f32 accuracy, counted as such), ragged tiles (odd S, O and query tiles),
16- and 32-wide group sums, the f32 attention kernel at head dim 32, 64 and
128 with 1, 8 and 71 query heads a K/V head, per-row
n_past / valid vectors, head_dim 32, Falcon-40B's 16 query heads per K/V
head, Falcon-180B's 29 (prefill and decode) and its four Q2_K matrices at
one and 300 rows, LLaMA's G == 1 head layouts (head_dim 32, 64, 128; head counts that do
not fill a block) in both attention kernels, the int8 cache's partials with
bf16 and f32 queries, the f32 decode kernel (split TF32) at the main paths'
head layouts on f32 and int8 caches held to f32 accuracy and to
partials_emulated, refusals of what the kernels do not take, tiny
Falcon and LLaMA models (some on an int8 cache) end to end on the card
against the CPU, and decode as replayed CUDA graphs: the same ids as the
eager step body, at several positions and after reset and rollback, no
host synchronization inside a replay, launch counts credited per replay,
one graph for samplers that differ only in their values, replays from
another thread than the capturing one; and eval_logprobs through the
kernels against the plain versions at n_past 1536. They import no JAX, so
they run on a machine without it:

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
    the K-quant GEMV, of a legacy format the legacy one; 2 and 3 bf16 rows
    run the rows kernel, more the bf16 tensor-core tile, f32 rows the f32
    one, none of them another's."""
    O, K = (301, 768) if S == 513 else (100, 512 if gtype in qm.K_QUANTS else 320)
    w = random_quant(gtype, O, K, _gen(S), dev, scale=0.2)
    x = torch.randn(S, K, generator=_gen(S + 1), device=dev).to(dtype)
    path = ("gemv" if S == 1 else "f32" if dtype == torch.float32
            else "rows" if S <= qm.ROWS_MAX_S else "tc")
    if path == "gemv" and gtype in qm.K_QUANTS:
        path = "gemv.kq"
    names = ["quant_matmul", f"quant_matmul.{gtype.name.lower()}", "quant_matmul.gemv",
             "quant_matmul.gemv.kq", "quant_matmul.rows", "quant_matmul.tc", "quant_matmul.f32"]
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


@pytest.mark.parametrize("gtype", FORMATS, ids=[f.name.lower() for f in FORMATS])
@pytest.mark.parametrize("S", [2, 8, 9, 16])
@pytest.mark.parametrize("O", [100, 301])
@pytest.mark.parametrize("ydtype", [torch.float32, torch.bfloat16], ids=["y_f32", "y_bf16"])
def test_quant_matmul_rows(dev, gtype, S, O, ydtype):
    """2 to 16 bf16 rows through the rows kernel (one and two n-tiles; O no
    multiple of its 16 W rows an m-tile) at K = 320 (legacy: a partial last
    unit) or 512, counted as such: f32 y within 2e-5 of max |plain| (exact
    products summed in f32; the tile, which rounds each weight to bf16, met
    only 2e-2), bf16 y within the bf16 tolerance."""
    K = 512 if gtype in qm.K_QUANTS else 320
    w = random_quant(gtype, O, K, _gen(S + O), dev, scale=0.2)
    x = torch.randn(S, K, generator=_gen(S + O + 1), device=dev).to(torch.bfloat16)
    before = {n: build.launch_counts[n] for n in ("quant_matmul.rows", "quant_matmul.tc")}
    got = qm.quant_matmul(w, x, ydtype)
    assert build.launch_counts["quant_matmul.rows"] == before["quant_matmul.rows"] + 1
    assert build.launch_counts["quant_matmul.tc"] == before["quant_matmul.tc"]
    assert got.dtype == ydtype and got.shape == (S, O)
    _close(got, qm.quant_matmul_plain(w, x, torch.float32), ydtype)


@pytest.mark.parametrize("gtype", [GGMLType.Q4_0, GGMLType.Q5_1, GGMLType.Q8_0, GGMLType.Q2_K,
                                   GGMLType.Q6_K], ids=["q4_0", "q5_1", "q8_0", "q2_k", "q6_k"])
@pytest.mark.parametrize("cl", qm.ROWS_CLUSTERS)
@pytest.mark.parametrize("S", [5, 12])
@pytest.mark.parametrize("K", [256, 2304])
def test_quant_matmul_rows_every_cluster_size(dev, gtype, cl, S, K, monkeypatch):
    """The rows kernel with and without a cluster of two blocks splitting K,
    whatever the rule would pick, on a ragged problem (O = 200), at K of one
    unit (the cluster's second block has none) and of 9 units (it takes one
    fewer): within 2e-5 of the plain version, and y the same on a second
    call, bit for bit."""
    O = 200
    w = random_quant(gtype, O, K, _gen(7), dev, scale=0.2)
    x = torch.randn(S, K, generator=_gen(8), device=dev).to(torch.bfloat16)
    monkeypatch.setattr(qm, "rows_cluster", lambda O_: cl)
    before = build.launch_counts["quant_matmul.rows"]
    got = qm.quant_matmul(w, x, torch.float32)
    assert build.launch_counts["quant_matmul.rows"] == before + 1
    _close(got, qm.quant_matmul_plain(w, x, torch.float32), torch.float32)
    assert torch.equal(qm.quant_matmul(w, x, torch.float32), got)


@pytest.mark.parametrize("gtype", FORMATS[:5], ids=[f.name.lower() for f in FORMATS[:5]])
@pytest.mark.parametrize("K", [96, 352])
@pytest.mark.parametrize("S", [5, 12])
def test_quant_matmul_rows_odd_group_count(dev, gtype, K, S):
    """A legacy K that is an odd number of 32-groups: the rows kernel's last
    unit is partial, and the fp16 scales, whose rows then start 2-byte
    aligned, go through registers instead of cp.async."""
    O = 70
    w = random_quant(gtype, O, K, _gen(K + S), dev, scale=0.2)
    x = torch.randn(S, K, generator=_gen(K + S + 1), device=dev).to(torch.bfloat16)
    before = build.launch_counts["quant_matmul.rows"]
    got = qm.quant_matmul(w, x, torch.float32)
    assert build.launch_counts["quant_matmul.rows"] == before + 1
    _close(got, qm.quant_matmul_plain(w, x, torch.float32), torch.float32)


@pytest.mark.parametrize("gtype", FORMATS, ids=[f.name.lower() for f in FORMATS])
def test_rows_kernel_row_is_independent_of_the_other_rows(dev, gtype):
    """Row s of 16 rows equals, bit for bit, row 0 of two rows holding row s
    and a zero row, and row s of 16 rows whose other rows were redrawn (an
    output element sums over k alone, and the K split's order is fixed), at
    Falcon-7B-like proportions cut small (O = 300, K of several units)."""
    O, K = 300, 2048
    w = random_quant(gtype, O, K, _gen(11), dev, scale=0.2)
    x = torch.randn(16, K, generator=_gen(12), device=dev).to(torch.bfloat16)
    other = torch.randn(16, K, generator=_gen(13), device=dev).to(torch.bfloat16)
    full = qm.quant_matmul(w, x, torch.float32)
    for s in (0, 5, 8, 15):
        pair = torch.stack([x[s], torch.zeros_like(x[s])])
        assert torch.equal(qm.quant_matmul(w, pair, torch.float32)[0], full[s])
        mixed = other.clone()
        mixed[s] = x[s]
        assert torch.equal(qm.quant_matmul(w, mixed, torch.float32)[s], full[s])


def test_rows_kernel_refuses_what_it_is_not_built_for(dev):
    """The C entry point refuses 1 or 17 rows and a cluster size it is not
    built for; the wrapper raises and counts nothing."""
    w = random_quant(GGMLType.Q4_0, 64, 256, _gen(0), dev)
    for S, cl in ((1, 1), (17, 1), (17, 2), (4, 0), (4, 3), (4, 4)):
        x = torch.randn(S, 256, device=dev).to(torch.bfloat16)
        ptrs = qm._plane_ptrs(qm.plane_args(w), x.device)
        y = torch.empty(S, 64, device=dev, dtype=torch.float32)
        with pytest.raises(RuntimeError, match="gq_quant_matmul_rows failed to launch"):
            build.launch("gq_quant_matmul_rows", "quant_matmul.refused", int(w.gtype),
                         x.data_ptr(), *ptrs, y.data_ptr(), 1, S, 256, 64, cl,
                         build.stream_ptr(dev))
    assert build.launch_counts["quant_matmul.refused"] == 0


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


@pytest.mark.parametrize("gtype", FORMATS, ids=[f.name.lower() for f in FORMATS])
@pytest.mark.parametrize("S", [2, 17, 300, 512])
def test_quant_matmul_f32(dev, gtype, S):
    """The f32 tensor-core tile in every format at the prefill row counts
    (the 32-, 64- and 128-row tiles; 300 and 512 rows take the group_sums
    kernel, shorter ones the plain reduce), O = 200 (no multiple of the
    128-row block), K = 768 (legacy: 24 groups; K-quants: 3 super-blocks):
    f32 y within 2e-5 of max |plain|, bf16 y within the bf16 tolerance; one
    launch under "quant_matmul.f32" a call and none of another route."""
    O, K = 200, 768
    w = random_quant(gtype, O, K, _gen(S + 7), dev, scale=0.2)
    x = torch.randn(S, K, generator=_gen(S + 8), device=dev)
    names = ("quant_matmul.f32", "quant_matmul.tc", "quant_matmul.gemv", "quant_matmul.gemv.kq",
             "group_sums")
    for ydtype in (torch.float32, torch.bfloat16):
        before = {n: build.launch_counts[n] for n in names}
        got = qm.quant_matmul(w, x, ydtype)
        want = {"quant_matmul.f32": 1, "group_sums": int(S >= qm.GROUP_SUMS_MIN_S
                                                         and gtype != GGMLType.Q8_0)}
        for n in names:
            assert build.launch_counts[n] == before[n] + want.get(n, 0), n
        assert got.dtype == ydtype
        _close(got, qm.quant_matmul_plain(w, x, ydtype), ydtype)


@pytest.mark.parametrize("gtype", [GGMLType.Q4_1, GGMLType.Q2_K], ids=["q4_1", "q2_k"])
def test_quant_matmul_op_checks_given_group_sums(dev, gtype):
    """The op ggllm::quant_matmul with the f32 tile's group sums passed in
    as xg (S = 300 f32 rows): the entry's y, also from a strided xg; an xg
    of another group width, dtype or device raises ValueError before any
    launch."""
    O, K, S = 200, 768, 300
    group = qm.KERNEL_FORMATS[gtype][0]
    w = random_quant(gtype, O, K, _gen(21), dev, scale=0.2)
    x = torch.randn(S, K, generator=_gen(22), device=dev)
    args = (qm.plane_args(w), int(gtype), O, K, torch.float32)

    def op(xg):
        planes, *rest = args
        return torch.ops.ggllm.quant_matmul.default(x, *planes, xg, *rest)

    xg = qm.group_sums(x, group)
    want = qm.quant_matmul(w, x, torch.float32)
    assert torch.equal(op(xg), want)
    assert torch.equal(op(xg.t().contiguous().t()), want)
    before = dict(build.launch_counts)
    for bad in (qm.group_sums_plain(x, 48 - group), xg.to(torch.bfloat16), xg.cpu()):
        with pytest.raises(ValueError, match="the f32 tile reads"):
            op(bad)
    assert dict(build.launch_counts) == before


@pytest.mark.parametrize("gtype", [GGMLType.Q4_0, GGMLType.Q5_1, GGMLType.Q8_0, GGMLType.Q6_K,
                                   GGMLType.Q2_K], ids=["q4_0", "q5_1", "q8_0", "q6_k", "q2_k"])
@pytest.mark.parametrize("nt", qm.F32_ROWS)
def test_quant_matmul_f32_every_tile_width(dev, gtype, nt, monkeypatch):
    """Each of the f32 tile's three widths on the same ragged problem (S =
    300, O = 200, K = 1024), whatever width the rule would pick."""
    monkeypatch.setattr(qm, "f32_rows", lambda S, O: nt)
    O, K, S = 200, 1024, 300
    w = random_quant(gtype, O, K, _gen(nt), dev, scale=0.2)
    x = torch.randn(S, K, generator=_gen(nt + 1), device=dev)
    before = build.launch_counts["quant_matmul.f32"]
    got = qm.quant_matmul(w, x, torch.float32)
    assert build.launch_counts["quant_matmul.f32"] == before + 1
    _close(got, qm.quant_matmul_plain(w, x, torch.float32), torch.float32)


@pytest.mark.parametrize("gtype", FORMATS[:5], ids=[f.name.lower() for f in FORMATS[:5]])
@pytest.mark.parametrize("K", [96, 352])
def test_quant_matmul_f32_odd_group_count(dev, gtype, K):
    """A legacy K that is an odd number of 32-groups: the f32 tile's last
    64-column slab holds one group."""
    O, S = 70, 33
    w = random_quant(gtype, O, K, _gen(K), dev, scale=0.2)
    x = torch.randn(S, K, generator=_gen(K + 1), device=dev)
    before = build.launch_counts["quant_matmul.f32"]
    got = qm.quant_matmul(w, x, torch.float32)
    assert build.launch_counts["quant_matmul.f32"] == before + 1
    _close(got, qm.quant_matmul_plain(w, x, torch.float32), torch.float32)


@pytest.mark.parametrize("gtype", [GGMLType.Q4_0, GGMLType.Q4_K, GGMLType.Q6_K],
                         ids=["q4_0", "q4_k", "q6_k"])
def test_quant_matmul_f32_holds_f32_accuracy(dev, gtype):
    """At Falcon-7B's width (K = 4544; 40B's 8192 for the K-quants), S = 300,
    with x spread over 2^-20 .. 2^20 (three bf16 terms that all matter):
    the tile's product within 2e-5 of max |y| of the plain f32 product and
    of a float64 product of the same values."""
    K = 8192 if gtype in qm.K_QUANTS else 4544
    O, S = 256, 300
    w = random_quant(gtype, O, K, _gen(1), dev, scale=0.2)
    g = _gen(2)
    x = torch.randn(S, K, generator=g, device=dev) * torch.exp2(
        torch.randint(-20, 21, (S, K), generator=g, device=dev).float())
    got = qm.quant_matmul(w, x, torch.float32)
    plain = qm.quant_matmul_plain(w, x, torch.float32)
    exact = (x.double() @ w.dequantize(torch.float32).double().t())
    _close(got, plain, torch.float32)
    _close(got.double(), exact, torch.float32)


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("G", [1, 8, 71])
@pytest.mark.parametrize("n_past", [0, 300, "rows"])
def test_flash_mqa_f32(dev, D, G, n_past):
    """The f32 attention kernel at every head dim with 1, 8 and 71 query
    heads a K/V head (2 K/V heads, B = 2, S = 300, a ragged last block),
    n_past 0, 300 and a per-row (B,) vector (300, 7): within 2e-5 of max
    |plain|, one launch under "flash_mqa.f32" a call; the same shapes in
    bf16 never reach it."""
    KV, B, S = 2, 2, 300
    H, T = KV * G, 700
    g = _gen(D * G)
    q = torch.randn(B, S, H, D, generator=g, device=dev)
    kv = torch.randn(2, B, T, KV, D, generator=g, device=dev)
    if n_past == "rows":
        n_past = torch.tensor([300, 7], dtype=torch.int32, device=dev)
    before = build.launch_counts["flash_mqa.f32"]
    got = flash_mqa(q, kv[0], kv[1], n_past)
    assert build.launch_counts["flash_mqa.f32"] == before + 1
    _close(got, flash_mqa_plain(q, kv[0], kv[1], n_past), torch.float32)
    bf = torch.bfloat16
    flash_mqa(q.to(bf), kv[0].to(bf), kv[1].to(bf), n_past)
    assert build.launch_counts["flash_mqa.f32"] == before + 1


def test_f32_kernels_take_no_bf16_input(dev):
    """bf16 x at S > 1 runs the bf16 tile and bf16 attention its own
    kernels: neither f32 counter moves."""
    w = random_quant(GGMLType.Q4_0, 128, 512, _gen(3), dev)
    before = {n: build.launch_counts[n] for n in ("quant_matmul.f32", "flash_mqa.f32")}
    qm.quant_matmul(w, torch.randn(300, 512, device=dev).to(torch.bfloat16), torch.float32)
    for D in (32, 64, 128):
        q = torch.zeros(1, 40, 8, D, device=dev, dtype=torch.bfloat16)
        k = torch.zeros(1, 64, 1, D, device=dev, dtype=torch.bfloat16)
        flash_mqa(q, k, k, 3)
    assert {n: build.launch_counts[n] for n in before} == before


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
    ptrs = qm._plane_ptrs(qm.plane_args(w), x.device)
    with pytest.raises(RuntimeError):  # a tile width that is not built
        build.launch("gq_quant_matmul_tc", "quant_matmul.refused", int(w.gtype), x.data_ptr(), *ptrs,
                     y.data_ptr(), 0, 4, 256, 64, 32, build.stream_ptr(x.device))
    xf = x.float()
    xg = torch.zeros(4, 8, device=dev)
    with pytest.raises(RuntimeError):  # an f32 tile width that is not built
        build.launch("gq_quant_matmul_f32", "quant_matmul.refused", int(w.gtype), xf.data_ptr(),
                     *ptrs, xg.data_ptr(), y.data_ptr(), 0, 4, 256, 64, 16,
                     build.stream_ptr(x.device))
    with pytest.raises(RuntimeError):  # Q4_0 on the f32 tile without its group sums
        build.launch("gq_quant_matmul_f32", "quant_matmul.refused", int(w.gtype), xf.data_ptr(),
                     *ptrs, None, y.data_ptr(), 0, 4, 256, 64, 32, build.stream_ptr(x.device))
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
             "quant_matmul.gemv", "quant_matmul.tc", "quant_matmul.f32")
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
    missing plane; the legacy GEMV no longer takes a K-quant row, nor the
    f32 tile a single row."""
    w = random_quant(GGMLType.Q4_K, 64, 512, _gen(0), dev)
    x = torch.randn(1, 512, device=dev).to(torch.bfloat16)
    y = torch.empty(1, 64, device=dev)
    ptrs = qm._plane_ptrs(qm.plane_args(w), x.device)
    st = build.stream_ptr(x.device)
    for gtype, K, rows, planes in ((int(GGMLType.Q4_0), 512, 2, ptrs),
                                   (int(w.gtype), 320, 2, ptrs), (int(w.gtype), 512, 3, ptrs),
                                   (int(w.gtype), 512, 2, [None] + ptrs[1:])):
        with pytest.raises(RuntimeError):
            build.launch("gq_quant_gemv_kq", "quant_matmul.refused", gtype, x.data_ptr(), 1,
                         *planes, y.data_ptr(), 0, K, 64, rows, st)
    xg = torch.zeros(1, 32, device=dev)
    with pytest.raises(RuntimeError):
        build.launch("gq_quant_matmul_f32", "quant_matmul.refused", int(w.gtype),
                     x.float().data_ptr(), *ptrs, xg.data_ptr(), y.data_ptr(), 1, 1, 512, 64, 32,
                     st)
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
             "quant_matmul.gemv.kq", "quant_matmul.tc", "quant_matmul.f32")
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
    plane (Q5_1's qh, its m); the f32 tile's entry point takes no single
    row."""
    w = random_quant(GGMLType.Q5_1, 64, 512, _gen(0), dev)
    y = torch.empty(1, 64, device=dev)
    st = build.stream_ptr(y.device)
    ptrs = qm._plane_ptrs(qm.plane_args(w), y.device)
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
            build.launch("gq_quant_matmul_f32", "quant_matmul.refused", int(w.gtype),
                         x.float().data_ptr(), *ptrs, xg.data_ptr(), y.data_ptr(), 1, 1, 512, 64,
                         32, st)
    assert build.launch_counts["quant_matmul.refused"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("g", [32, 16])
def test_group_sums(dev, dtype, g):
    """f32 x against the plain version, and bit for bit against
    group_sums_emulated (the kernel's order of sums), at S K not a multiple
    of a warp's 512-float step; bf16 x, which no path gives the kernel, is
    refused."""
    x = torch.randn(300, 320, generator=_gen(0), device=dev).to(dtype)
    if dtype == torch.bfloat16:
        with pytest.raises(TypeError):
            qm.group_sums(x, g)
        return
    got = qm.group_sums(x, g)
    _close(got, qm.group_sums_plain(x, g), torch.float32)
    assert torch.equal(got, qm.group_sums_emulated(x, g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("H,KV,D", [(8, 1, 64), (6, 2, 64), (5, 1, 32), (128, 8, 64),
                                    (4, 4, 128), (32, 32, 128), (6, 6, 64), (5, 5, 32),
                                    (8, 2, 128)])
@pytest.mark.parametrize("n_past", [0, 37, "rows"])
def test_flash_mqa(dev, dtype, H, KV, D, n_past):
    """bf16 runs the bf16 tensor-core kernel, f32 the f32 one, at every head
    dim, each counted as such; 45 query rows are a ragged last block in every
    layout."""
    _flash_mqa_case(dev, dtype, H, KV, D, n_past, S=45)


def _flash_mqa_case(dev, dtype, H, KV, D, n_past, S, T=None):
    B, T = 2, T or 160 + 64 * (S // 64)
    g = _gen(H * D)
    q = torch.randn(B, S, H, D, generator=g, device=dev).to(dtype)
    kv = torch.randn(1, 2, B, T, KV, D, generator=g, device=dev).to(dtype)
    if n_past == "rows":
        n_past = torch.tensor([3, 90], dtype=torch.int32, device=dev)
    path = "f32" if dtype == torch.float32 else "tc"
    names = ("flash_mqa", "flash_mqa.tc", "flash_mqa.f32")
    before = {n: build.launch_counts[n] for n in names}
    got = flash_mqa(q, kv[0, 0], kv[0, 1], n_past)
    for n in names:
        assert build.launch_counts[n] == before[n] + int(n in ("flash_mqa", f"flash_mqa.{path}"))
    _close(got, flash_mqa_plain(q, kv[0, 0], kv[0, 1], n_past), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("H,KV,D", [(71, 1, 64), (16, 2, 64), (6, 6, 128), (232, 8, 64)])
@pytest.mark.parametrize("n_past", [0, "rows"])
@pytest.mark.parametrize("S", [2, 17, 300, 513])
def test_flash_mqa_row_counts(dev, dtype, H, KV, D, n_past, S):
    """Short, ragged and multi-block query counts (513 rows of 71 heads are
    570 blocks of one K/V head) at the three head layouts and Falcon-180B's
    (29 query heads a K/V head: a 64-row block holds 2.2 positions)."""
    _flash_mqa_case(dev, dtype, H, KV, D, n_past, S)


@pytest.mark.parametrize("H,KV", [(4, 1), (1, 1), (6, 2), (71, 1), (5, 5)])
@pytest.mark.parametrize("n_past", [0, 211, "rows"])
@pytest.mark.parametrize("S,T", [(1, 300), (45, 233), (130, 419), (513, 797)])
def test_flash_mqa_bf16_head_dim_32(dev, H, KV, n_past, S, T):
    """bf16 at D = 32 on the tensor-core kernel (two 64-byte rows a 128-byte
    line in its swizzle): S G query rows not a multiple of 64, T not a
    multiple of 64 (past the last visible key, or before it at S = 45 and
    n_past 211), per-row n_past, G = 1 and G > 1, at the bf16 tolerance of
    flash_mqa_plain."""
    _flash_mqa_case(dev, torch.bfloat16, H, KV, 32, n_past, S, T)


# Falcon-180B's Q2_K matrices, (O, K): wqkv, ffn_up, w_od (K = E + F, the
# parallel residual: 1.10 G weights) and the lm_head
SHAPES_180B = {"wqkv": (15872, 14848), "ffn_up": (59392, 14848), "w_od": (14848, 74240),
               "lm_head": (65024, 14848)}


@pytest.mark.parametrize("S", [1, 300])
@pytest.mark.parametrize("wname", list(SHAPES_180B))
def test_quant_matmul_at_180b_shapes(dev, wname, S):
    """Q2_K at Falcon-180B's four matrices, bf16 x: one row on the K-quant
    GEMV, 300 on the bf16 tensor-core tile, each one launch counted as
    such, against the plain version at 2e-2 of max |ref| (the lm_head's y in
    f32, as the engine asks for it)."""
    O, K = SHAPES_180B[wname]
    w = random_quant(GGMLType.Q2_K, O, K, _gen(O + S), dev)
    x = torch.randn(S, K, generator=_gen(K + S), device=dev).to(torch.bfloat16)
    ydtype = torch.float32 if wname == "lm_head" else torch.bfloat16
    path = "gemv.kq" if S == 1 else "tc"
    names = ("quant_matmul.q2_k", "quant_matmul.gemv.kq", "quant_matmul.gemv",
             "quant_matmul.rows", "quant_matmul.tc", "quant_matmul.f32")
    before = {n: build.launch_counts[n] for n in names}
    got = qm.quant_matmul(w, x, ydtype)
    for n in names:
        assert build.launch_counts[n] == before[n] + int(n in ("quant_matmul.q2_k",
                                                               f"quant_matmul.{path}")), n
    assert got.shape == (S, O) and got.dtype == ydtype
    _close(got, qm.quant_matmul_plain(w, x, ydtype), torch.bfloat16)


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
    P where the kernel does; on the f32 route (grouped heads otherwise) to
    partials_emulated at f32 accuracy."""
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
    rt = fd.route(KV, H // KV, D, cache, str(qg.dtype).removeprefix("torch."))
    _close(acc, acc_p, torch.bfloat16 if rt == "tc" else torch.float32)
    if rt != "mha":
        _close_emulated((acc, m, lsum), kv, KV, l, qg, valid)


def _close_emulated(got, kv, KV, layer, qg, cache_valid):
    """cache_partials' (acc, m, l) against partials_emulated at this card's
    SM count (so with the kernel's splits): acc to TOL_EMULATED of max
    |ref| on the tensor-core route, to f32 accuracy on the f32 route; m and
    l to f32 accuracy."""
    acc_e, m_e, l_e = fd.partials_emulated(kv, KV, layer, qg, cache_valid,
                                           n_sm=fd._sm_count(qg.device))
    acc, m, lsum = got
    _close(m, m_e, torch.float32)
    _close(lsum, l_e, torch.float32)
    got, ref = acc.float().cpu(), acc_e.cpu()
    err = (got - ref).abs().max().item() / (ref.abs().max().item() + 1e-6)
    quant = isinstance(kv, tuple)
    cache = "int8" if quant else str(kv.dtype).removeprefix("torch.")
    rt = fd.route(KV, qg.shape[2], qg.shape[3], cache, str(qg.dtype).removeprefix("torch."))
    assert err <= (TOL_EMULATED if rt == "tc" else TOL[torch.float32]), err


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
    """D = 256 and more than 128 query heads a K/V head raise on the card
    (grouped f32 at D = 128, which the CUDA-core kernel refused, runs on the
    f32 kernel since it replaced it: test_grouped_decode_at_head_dim_128)."""
    for KV, H, D in ((4, 4, 256), (1, 130, 64)):
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


# long context: EngineConfig(n_ctx=16384, n_batch=2048), a cache of
# 16384 + 2048 = 18432 positions
LONG_T = 18432
# one valid length a row, as an int32 device tensor
ROW_LENGTHS = {"rows": [2047, 300], "rows16k": [16383, 8192]}


def _decode_case(dev, cache, KV, H, D, valid, append, T=None, L=2, seed=0):
    """A random L-layer cache (bf16, f32, or int8 codes and scales: "int8"
    with bf16 q, "int8f32" with f32 q; "bf16f32q": a bf16 cache with f32 q),
    q in the cache's dtype (bf16 or f32) or f32 and flash_decode's arguments
    for `valid` cache positions (a ROW_LENGTHS key: B = 2 with those lengths
    as an int32 device tensor), with or without a 16-entry append block of
    which 5 are valid. T defaults to 2560, or to LONG_T where a length
    passes 2560 (the decode plan made for the 16k context's cache)."""
    rows = ROW_LENGTHS.get(valid) if isinstance(valid, str) else None
    B = 2 if rows else 1
    T = T or (LONG_T if max(rows or [valid]) > 2560 else 2560)
    g = _gen(seed)
    qd = torch.float32 if cache in ("f32", "int8f32", "bf16f32q") else torch.bfloat16
    kv = torch.randn(L, 2, B, T, KV, D, generator=g, device=dev)
    kv = (kvcache.quantize_new(kv) if cache.startswith("int8")
          else kv.to(torch.bfloat16) if cache == "bf16f32q" else kv.to(qd))
    q = torch.randn(B, 1, H, D, generator=g, device=dev).to(qd)
    lens = torch.tensor(rows, dtype=torch.int32, device=dev) if rows else valid
    if append:  # the cache is valid below n_past - 4
        app = torch.randn(2, B, 16, KV, D, generator=g, device=dev).to(qd)
        return kv, q, lens + 4, {"kv_append": app, "append_valid": 5}
    return kv, q, lens - 1, {}


@pytest.mark.parametrize("cache", ["bf16", "int8", "f32", "int8f32", "bf16f32q"])
@pytest.mark.parametrize("KV,H,D", [(1, 71, 64), (8, 128, 64), (32, 32, 128), (8, 232, 64)],
                         ids=["falcon7b", "falcon40b", "llama7b", "falcon180b"])
@pytest.mark.parametrize("valid", [1, 300, 2047, "rows", 16383, "rows16k"])
@pytest.mark.parametrize("append", [False, True], ids=["cache", "append"])
def test_decode_at_main_path_shapes(dev, cache, KV, H, D, valid, append):
    """The one-launch kernels at the main paths' head layouts (Falcon-180B:
    29 query heads a K/V head, padded to 32 rows), at n_ctx 2048 and at the
    16k context's lengths (valid 16383 and rows of 16383 and 8192 over a
    cache of LONG_T positions, the device lengths' plan made for T), against
    the plain version (2e-2 of max |ref| with bf16 q, 2e-5 with f32 q): grouped
    heads on the tensor-core kernel (bf16 q) or the f32 kernel (f32 q, also
    over a bf16 cache, where q stays f32), G == 1 on decode_mha_kernel (f32
    q over a bf16 cache meets it as bf16: held at 2e-2); bf16, f32 and int8
    caches, with and without the append block, one length or one per row;
    grouped heads' splits and merge also against partials_emulated."""
    kv, q, n_past, kw = _decode_case(dev, cache, KV, H, D, valid, append)
    tol = torch.bfloat16 if (cache == "bf16f32q" and H == KV) else q.dtype
    int8 = cache.startswith("int8")
    if H == KV:
        counter = _decode_counter(KV, H, int8)
    elif q.dtype == torch.float32:
        counter = "flash_decode.f32"
    else:
        counter = "flash_decode_tc" + (".int8" if int8 else "")
    before = build.launch_counts[counter]
    got = fd.flash_decode(kv, KV, 1, q, n_past, **kw)
    assert build.launch_counts[counter] == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, fd.flash_decode_plain(kv, KV, 1, q, n_past, **kw), tol)
    qg = q.reshape(q.shape[0], KV, H // KV, D)
    lens = n_past - 3 if append else n_past + 1  # the cache rows attended
    acc, m, lsum = fd.cache_partials(kv, KV, 1, qg, lens)
    acc_p, m_p, l_p = fd.cache_partials_plain(kv, KV, 1, qg, lens)
    _close(acc / lsum, acc_p / l_p, tol)
    _close(m, m_p, tol)
    if H > KV:  # the grouped routes: their splits and merge as partials_emulated's
        _close_emulated((acc, m, lsum), kv, KV, 1, qg, lens)


@pytest.mark.parametrize("cache", ["bf16", "int8", "f32", "int8f32"])
@pytest.mark.parametrize("KV,H", [(2, 8), (1, 71), (1, 1)])
def test_grouped_decode_at_head_dim_128(dev, cache, KV, H):
    """Grouped heads (and one query head over one K/V head) at D = 128 take
    the tensor-core kernel with bf16 q and the f32 kernel with f32 q (the
    CUDA-core kernel this one replaced stopped at 64), with per-row lengths
    and the append block."""
    qd = "float32" if cache in ("f32", "int8f32") else "bfloat16"
    ok, rt = fd.supports(KV, H // KV, 128, "int8" if cache.startswith("int8") else qd, qd)
    assert ok and rt == ("f32" if qd == "float32" else "tc")
    for append in (False, True):
        kv, q, n_past, kw = _decode_case(dev, cache, KV, H, 128, "rows", append, seed=3)
        _close(fd.flash_decode(kv, KV, 0, q, n_past, **kw),
               fd.flash_decode_plain(kv, KV, 0, q, n_past, **kw), q.dtype)


@pytest.mark.parametrize("cache,KV,H,D", [("bf16", 1, 71, 64), ("int8", 8, 128, 64),
                                          ("bf16", 32, 32, 128), ("int8", 32, 32, 128),
                                          ("f32", 1, 71, 64), ("int8f32", 8, 128, 64)])
def test_decode_graph_replays_at_new_lengths(dev, cache, KV, H, D):
    """32 calls (one per layer of a 4-layer cache, in turn) captured in one
    CUDA graph with the lengths in an int32 device tensor, replayed at two
    sets of lengths: every output equals the plain version's."""
    L, T, B = 4, 2304, 2
    g = _gen(KV + H)
    qd = torch.float32 if cache in ("f32", "int8f32") else torch.bfloat16
    kv = torch.randn(L, 2, B, T, KV, D, generator=g, device=dev)
    kv = kvcache.quantize_new(kv) if cache.startswith("int8") else kv.to(qd)
    qs = [torch.randn(B, 1, H, D, generator=g, device=dev).to(qd) for _ in range(32)]
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
            _close(out, fd.flash_decode_plain(kv, KV, i % L, q, n_past), qd)


@pytest.mark.parametrize("cache", ["bf16", "int8", "f32", "int8f32"])
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


def test_memory_f32_tiny_model_on_card_matches_cpu(dev, tmp_path):
    """An f32 cache under bf16 compute (the CLI's --memory-f32): prefill
    attention takes q in the cache's f32 (the f32 attention kernel), decode
    the f32 decode kernel, and the logits of a 3-chunk prompt and a decode
    step stay within bf16 accuracy of the CPU's plain versions."""
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.io.loader import load_model
    from ggllm_tpu_torch.utils.synthetic import write_tiny_model

    path = str(tmp_path / "tiny.ggcc")
    write_tiny_model(path, FalconHParams.tiny(), GGMLType.Q4_0, seed=5)
    cfg = EngineConfig(n_ctx=64, n_batch=16, kv_dtype="float32", compute_dtype="bfloat16")
    prompt = [int(t) for t in np.random.default_rng(4).integers(12, 500, 40)]  # 3 chunks
    logits = []
    for device in ("cpu", "cuda"):
        mf, params = load_model(path, cfg, device=device)
        eng = FalconEngine(mf.hparams, params, cfg, device=device)
        build.launch_counts.clear()
        logits.append(np.concatenate([eng.eval(prompt)[None], eng.eval([7])[None]]))
    counts = dict(build.launch_counts)
    assert counts.get("flash_mqa.f32", 0) > 0 and counts.get("flash_decode.f32", 0) > 0
    assert not counts.get("flash_mqa.tc", 0) and not counts.get("flash_decode_tc", 0)
    scale = np.abs(logits[0]).max()
    np.testing.assert_allclose(logits[1] / scale, logits[0] / scale, atol=2e-2)


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
    # 19 decode tokens as two replays of one 16-step graph (the second's 13
    # surplus steps dropped), plus the one eager step that warms it up
    captures = sum(c.graph is not None for c in eng._chunks.values())
    assert captures == 1 and build.launch_counts[counter] == before + (32 + captures) * hp.n_layer
    scale = np.abs(logits[0]).max()
    exact = compute == "float32" and kv_dtype != "int8"
    atol = 1e-4 if exact else 2e-3 if compute == "float32" else 2e-2
    np.testing.assert_allclose(logits[1] / scale, logits[0] / scale, atol=atol)
    assert len(ids[0]) == len(ids[1]) == 20 and (ids[0] == ids[1] or not exact)


# ---------------------------------------------------------------- decode graphs


def _graph_engine(tmp_path, family, kv_dtype, compute="bfloat16"):
    """A tiny model at head_dim 64 on the card (Falcon: 4 heads over one K/V
    head, the tensor-core decode kernel; LLaMA: the G == 1 kernel) after a
    20-token prefill; returns (engine, first token, prompt)."""
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.io.loader import load_model
    from ggllm_tpu_torch.utils.synthetic import write_tiny_llama, write_tiny_model

    if family == "llama":
        path = str(tmp_path / "tiny.ggjt")
        write_tiny_llama(path, LlamaHParams(n_vocab=512, n_embd=256, n_mult=256, n_head=4,
                                            n_layer=2, n_rot=64), GGMLType.Q4_0, seed=5)
    else:
        path = str(tmp_path / "tiny.ggcc")
        write_tiny_model(path, FalconHParams(n_vocab=512, n_embd=256, n_head=4, n_head_kv=1,
                                             n_layer=2, n_falcon_type=7, n_bpe_merges=0),
                         GGMLType.Q4_0, seed=5)
    cfg = EngineConfig(n_ctx=256, n_batch=64, kv_dtype=kv_dtype, compute_dtype=compute)
    mf, params = load_model(path, cfg, device="cuda")
    eng = FalconEngine(mf.hparams, params, cfg)
    prompt = [int(t) for t in np.random.default_rng(4).integers(3, 500, 20)]
    first = int(np.argmax(eng.eval(prompt)))
    return eng, first, prompt


def _chunks(eng, first, hist, n_chunks, n_steps, sampler, eager):
    """n_chunks chained decode_chunk calls from the engine's n_past, one
    generator throughout; returns the ids."""
    ids, tok, gen = [], first, None
    for _ in range(n_chunks):
        toks, gen = eng.decode_chunk(tok, n_steps, sampler, gen, last_tokens=hist + ids,
                                     eager=eager)
        ids += [int(t) for t in toks]
        tok = ids[-1]
    return ids


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("family", ["falcon", "llama"])
def test_graph_and_eager_ids_are_identical(dev, tmp_path, family, kv_dtype):
    """From the same state, 64 greedy ids (four 16-step chunks) and 32
    sampled ids (temp 0.8, top-k 40, top-p 0.95, repeat penalty 1.1, seed
    1234) of the replayed graphs equal the eager step body's, and n_past
    agrees; pipelined replays give the same greedy ids."""
    from ggllm_tpu_torch.ops.sampling import SamplerParams

    eng, first, prompt = _graph_engine(tmp_path, family, kv_dtype)
    start = eng.n_past
    for sampler, n_chunks in ((SamplerParams(temp=0.0), 4),
                              (SamplerParams(temp=0.8, top_k=40, top_p=0.95, repeat_penalty=1.1,
                                             seed=1234), 2)):
        got = {}
        for eager in (False, True):
            eng.rollback(start)
            got[eager] = _chunks(eng, first, prompt + [first], n_chunks, 16, sampler, eager)
            assert eng.n_past == start + 16 * n_chunks
        assert got[False] == got[True] and len(set(got[False])) > 1
    eng.rollback(start)
    piped, _ = eng.decode_pipelined(first, 64, 16, SamplerParams(temp=0.0),
                                    last_tokens=prompt + [first])
    eng.rollback(start)
    assert piped.tolist() == _chunks(eng, first, prompt + [first], 4, 16,
                                     SamplerParams(temp=0.0), True)
    assert all(c.graph is not None for c in eng._chunks.values())


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_graph_replays_at_new_positions_and_after_reset_and_rollback(dev, tmp_path, kv_dtype):
    """One captured 8-step chunk replayed at three n_past values, after a
    rollback into an earlier chunk and after reset() and a new prefill:
    every replay gives the eager body's ids from the same state, and no
    second graph is captured."""
    from ggllm_tpu_torch.ops.sampling import SamplerParams

    eng, first, prompt = _graph_engine(tmp_path, "falcon", kv_dtype)
    greedy = SamplerParams(temp=0.0)

    def both(tok, hist):
        at = eng.n_past
        g, _ = eng.decode_chunk(tok, 8, greedy, last_tokens=hist)
        eng.rollback(at)
        e, _ = eng.decode_chunk(tok, 8, greedy, last_tokens=hist, eager=True)
        assert g.tolist() == e.tolist() and eng.n_past == at + 8
        return g.tolist()

    hist = prompt + [first]
    ids = both(first, hist)
    for _ in range(2):  # n_past 28, 36
        ids += both(ids[-1], hist + ids)
    eng.rollback(len(prompt) + 5)  # into the first chunk
    both(ids[4], hist + ids[:5])
    eng.reset()
    first = int(np.argmax(eng.eval(prompt[:9])))
    both(first, prompt[:9] + [first])
    assert len(eng._chunks) == 1


def test_no_host_synchronization_inside_a_replayed_chunk(dev, tmp_path):
    """A chunk's launch (its inputs written on the device, the uniforms
    drawn, the graph replayed, the ids copied to pinned memory) makes no
    synchronizing call: set_sync_debug_mode("error") raises on one."""
    from ggllm_tpu_torch.ops.sampling import SamplerParams

    eng, first, prompt = _graph_engine(tmp_path, "falcon", "int8")
    sampler = SamplerParams(temp=0.8, top_k=40, top_p=0.95, seed=3)
    eng.decode_chunk(first, 8, sampler, last_tokens=prompt + [first])  # capture
    c = next(iter(eng._chunks.values()))
    gen = eng.new_generator(sampler)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            eng._launch(c, 3, gen, 0, eager=False)
            c.graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert 0 <= int(c.out.min()) and int(c.out.max()) < 512


def test_launch_counts_are_credited_per_replay(dev, tmp_path):
    """The capture's launches (the GEMV of every weight and the decode
    kernel of every layer, 8 steps) are credited once per replay and only
    then: three replays count three times the graph's record."""
    from ggllm_tpu_torch.ops.sampling import SamplerParams

    eng, first, prompt = _graph_engine(tmp_path, "falcon", "bfloat16")
    start = eng.n_past
    eng.decode_chunk(first, 8, SamplerParams(temp=0.0), last_tokens=prompt + [first])
    c = next(iter(eng._chunks.values()))
    L = eng.hp.n_layer
    assert c.graph.counts["flash_decode_tc"] == 8 * L
    n_quant = sum(isinstance(m, QuantTensor) for m in eng.model.modules())
    assert n_quant >= 2 * L and c.graph.counts["quant_matmul.gemv"] == 8 * n_quant
    build.launch_counts.clear()
    for _ in range(3):
        eng.rollback(start)
        eng.decode_chunk(first, 8, SamplerParams(temp=0.0), last_tokens=prompt + [first])
    assert dict(build.launch_counts) == {k: 3 * v for k, v in c.graph.counts.items()}


def test_a_failed_capture_raises_naming_the_step(dev, tmp_path, monkeypatch):
    """A step that reads a value on the host cannot be captured: the engine
    raises with the step and the reason, and runs no eager fallback."""
    from ggllm_tpu_torch.ops import sampling_device
    from ggllm_tpu_torch.ops.sampling import SamplerParams

    eng, first, prompt = _graph_engine(tmp_path, "falcon", "bfloat16")
    real = sampling_device.sample_logits

    def synced(logits, *a, **kw):
        float(logits.max())  # a host read
        return real(logits, *a, **kw)

    monkeypatch.setattr(sampling_device, "sample_logits", synced)
    with pytest.raises(RuntimeError, match="failed at step 0"):
        eng.decode_chunk(first, 4, SamplerParams(temp=0.0), last_tokens=prompt + [first])


def test_one_graph_per_sampler_shape(dev, tmp_path):
    """Two sampled decode_pipelined runs from one state at temperature 0.7
    and 0.9 (with another top-p and repeat penalty too): one sampled chunk
    key, captured once (t_compile_us grows in the first run only), and each
    run's ids are the eager step body's with its own sampler."""
    from ggllm_tpu_torch.ops.sampling import SamplerParams

    eng, first, prompt = _graph_engine(tmp_path, "falcon", "bfloat16")
    start, grew, runs = eng.n_past, [], []
    for temp, top_p, rp in ((0.7, 0.9, 1.1), (0.9, 0.8, 1.3)):
        sampler = SamplerParams(temp=temp, top_k=40, top_p=top_p, repeat_penalty=rp, seed=5)
        eng.rollback(start)
        before = eng.timings.t_compile_us
        ids, _ = eng.decode_pipelined(first, 32, 16, sampler, last_tokens=prompt + [first])
        grew.append(eng.timings.t_compile_us > before)
        eng.rollback(start)
        runs.append(_chunks(eng, first, prompt + [first], 2, 16, sampler, True))
        assert ids.tolist() == runs[-1]
    sampled = [k for k in eng._chunks if not k[1].greedy]
    assert len(sampled) == 1 and eng._chunks[sampled[0]].graph is not None
    assert grew == [True, False] and runs[0] != runs[1]


def test_a_replay_from_another_thread_gives_the_capturing_threads_ids(dev, tmp_path):
    """Graphs captured on one thread replay on another (as the server's
    handler threads replay them): a greedy graph captured here gives the
    same ids when a second thread replays it, and a sampled graph captured
    by the second thread gives the eager body's ids when replayed here; no
    graph is captured twice."""
    import threading

    from ggllm_tpu_torch.ops.sampling import SamplerParams

    eng, first, prompt = _graph_engine(tmp_path, "falcon", "bfloat16")
    start, hist = eng.n_past, prompt + [first]
    greedy = SamplerParams(temp=0.0)
    sampled = SamplerParams(temp=0.8, top_k=40, top_p=0.95, repeat_penalty=1.1, seed=9)
    here, _ = eng.decode_pipelined(first, 32, 16, greedy, last_tokens=hist)
    out = {}

    def other():
        try:
            for name, sampler in (("greedy", greedy), ("sampled", sampled)):
                eng.rollback(start)
                out[name] = eng.decode_pipelined(first, 32, 16, sampler, last_tokens=hist)[0]
        except BaseException as e:  # reported on the main thread
            out["error"] = e

    t = threading.Thread(target=other)
    t.start()
    t.join()
    assert "error" not in out, out.get("error")
    assert out["greedy"].tolist() == here.tolist()
    captured = eng.timings.t_compile_us
    eng.rollback(start)
    again, _ = eng.decode_pipelined(first, 32, 16, sampled, last_tokens=hist)
    eng.rollback(start)
    assert again.tolist() == out["sampled"].tolist() == _chunks(eng, first, hist, 2, 16,
                                                                sampled, True)
    assert eng.timings.t_compile_us == captured and len(eng._chunks) == 2


def test_eval_logprobs_through_the_kernels_at_n_past_1536(dev, tmp_path):
    """eval_logprobs of a 2048-token chunk (four 512-row pieces, the last at
    n_past 1536) through the tensor-core tile and flash_mqa.tc, against the
    plain versions on the same weights: every log-prob within 2 * 5e-2 of
    max |logit| (chip_smoke.py's LOGIT_TOL; a log-softmax moves by at most
    twice the largest logit change), the last piece's too."""
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.io.loader import load_model
    from ggllm_tpu_torch.utils.synthetic import write_tiny_model

    path = str(tmp_path / "tiny.ggcc")
    write_tiny_model(path, FalconHParams(n_vocab=512, n_embd=256, n_head=4, n_head_kv=1,
                                         n_layer=2, n_falcon_type=7, n_bpe_merges=0),
                     GGMLType.Q4_0, seed=5)
    cfg = EngineConfig(n_ctx=2048, n_batch=512)
    mf, params = load_model(path, cfg, device="cuda")
    eng = FalconEngine(mf.hparams, params, cfg)
    plain = FalconEngine(mf.hparams, params, EngineConfig(n_ctx=2048, n_batch=512,
                                                          kernel_layout=False,
                                                          flash_attention=False))
    ids = [int(t) for t in np.random.default_rng(6).integers(3, 500, 2048)]
    before = build.launch_counts["flash_mqa.tc"]
    lp = eng.eval_logprobs(ids)
    assert build.launch_counts["flash_mqa.tc"] == before + 4 * mf.hparams.n_layer
    lp_plain = plain.eval_logprobs(ids)
    plain.reset()
    scale = float(np.abs(plain.eval(ids, logits_all=True)).max())
    assert lp.shape == lp_plain.shape == (2047,) and np.isfinite(lp).all()
    err = np.abs(lp - lp_plain)
    assert err.max() <= 2 * 5e-2 * scale and err[1536:].max() <= 2 * 5e-2 * scale


def test_f32_compute_on_a_bf16_cache_matches_cpu(dev, tmp_path):
    """f32 compute on the default bf16 cache (`--compute-dtype float32`):
    decode keeps q in f32 on the grouped route (the f32 decode kernel, not
    the bf16 tensor-core one), and the logits of a 3-chunk prefill and a
    decode step, and 20 greedy ids through the decode graphs, agree with
    the CPU's plain versions within the f32 route's 1e-4 of max |logit|."""
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.io.loader import load_model
    from ggllm_tpu_torch.ops.sampling import SamplerParams
    from ggllm_tpu_torch.utils.synthetic import write_tiny_model

    path = str(tmp_path / "tiny.ggcc")
    write_tiny_model(path, FalconHParams(n_vocab=512, n_embd=256, n_head=4, n_head_kv=1,
                                         n_layer=2, n_falcon_type=7, n_bpe_merges=0),
                     GGMLType.Q4_0, seed=5)
    cfg = EngineConfig(n_ctx=64, n_batch=16, kv_dtype="bfloat16", compute_dtype="float32")
    assert fd.route(1, 4, 64, "bfloat16", "float32") == "f32"
    prompt = [int(t) for t in np.random.default_rng(4).integers(12, 500, 40)]  # 3 chunks
    logits, ids = [], []
    for device in ("cpu", "cuda"):
        mf, params = load_model(path, cfg, device=device)
        eng = FalconEngine(mf.hparams, params, cfg, device=device)
        build.launch_counts.clear()
        logits.append(np.concatenate([eng.eval(prompt)[None], eng.eval([7])[None]]))
        eng.reset()
        ids.append(eng.generate(prompt, 20, SamplerParams(temp=0.0)))
    counts = dict(build.launch_counts)
    assert counts.get("flash_decode.f32", 0) > 0 and not counts.get("flash_decode_tc", 0)
    scale = np.abs(logits[0]).max()
    np.testing.assert_allclose(logits[1] / scale, logits[0] / scale, atol=1e-4)
    assert ids[0] == ids[1]


# ---------------------------------------------------------------- B-row decode


ROW_PROMPTS = [[5, 17, 130, 42, 99, 260, 31], [300, 301, 302], [7, 8, 9, 10, 11, 12, 13, 14, 15]]


def _row_run(eng, n_chunks: int, eager: bool, seed: int = 3):
    """The three rows' prompts prefilled together (row 2 then parked: it
    decodes in n_ctx's scratch region), then n_chunks chained 8-step
    decode_rows chunks: rows 0 and 2 greedy (row 0 with a logit bias), row 1
    sampled by mirostat 2 (temp 0.8, repeat penalty 1.1, penalize_nl False)
    on a generator seeded `seed`, its mu carried across the chunks. Returns
    the ids by row and the prefill logits."""
    B, V = eng.batch, eng.hp.n_vocab
    first = eng.prefill_rows(list(range(B)), ROW_PROMPTS, np.zeros(B, np.int64))
    npv = np.asarray([len(p) for p in ROW_PROMPTS], np.int64)
    npv[2] = eng.cfg.n_ctx  # parked
    last = np.asarray([int(np.argmax(first[r])) for r in range(B)])
    gen = torch.Generator(device=eng.device).manual_seed(seed)
    hist = [list(p) + [int(t)] for p, t in zip(ROW_PROMPTS, last)]
    knobs = dict(temp=np.asarray([0.0, 0.8, 0.0]), top_p=np.asarray([1.0, 0.95, 1.0]),
                 top_k=np.full(B, 40), repeat_penalty=np.asarray([1.0, 1.1, 1.0]),
                 penalize_nl=np.asarray([True, False, True]), mirostat=np.asarray([0, 2, 0]),
                 mirostat_tau=np.full(B, 4.0), mirostat_eta=np.full(B, 0.15))
    bias_ids = np.asarray([[7, V], [V, V], [V, V]])
    bias_vals = np.asarray([[2.5, 0.0], [0.0, 0.0], [0.0, 0.0]])
    mu = np.full(B, 8.0, np.float32)
    out = [[] for _ in range(B)]
    for _ in range(n_chunks):
        rings = np.full((B, 64), V, np.int64)
        for r in range(B):
            rings[r, :len(hist[r][-64:])] = hist[r][-64:]
        fill = np.asarray([len(h[-64:]) for h in hist])
        toks, _, mu = eng.decode_rows(last, npv, 8, knobs, rings, fill, bias_ids, bias_vals, mu,
                                      generator=gen, eager=eager)
        for r in range(B):
            out[r] += toks[:, r].tolist()
            hist[r] += toks[:, r].tolist()
        last = toks[-1]
        npv = npv + 8
    return out, np.stack([first[r] for r in range(B)])


@pytest.mark.parametrize("kv_dtype,compute", [("bfloat16", "float32"), ("int8", "float32"),
                                               ("float32", "float32"), ("bfloat16", "bfloat16")])
def test_row_graph_equals_the_eager_rows_and_the_cpu(dev, tmp_path, kv_dtype, compute):
    """A tiny Falcon (4 heads over one K/V head, head_dim 64) at 3 rows, f32
    compute on a bf16, int8 or f32 cache, and bf16 compute on a bf16 cache:
    two 8-step chunks of decode_rows replayed as one captured CUDA graph give
    the eager B-row body's ids on every row, greedy and sampled; the graph's
    S = 3 rows ran the f32 tensor-core tile and the f32 decode kernel in
    f32, the rows kernel and the bf16 decode kernel in bf16, never a GEMV or
    (its capture record) the bf16 tile, which in bf16 the admission's 27
    rows may run. Against the CPU's plain versions: prefill logits within 1e-4
    of max |logit| on the dense f32-compute caches, 2e-3 on the int8 one (its
    codes may round the other way at a tie) and 2e-2 in bf16; on the dense
    f32-compute caches the greedy rows' ids equal."""
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.io.loader import load_model
    from ggllm_tpu_torch.utils.synthetic import write_tiny_model

    path = str(tmp_path / "tiny.ggcc")
    write_tiny_model(path, FalconHParams(n_vocab=512, n_embd=256, n_head=4, n_head_kv=1,
                                         n_layer=2, n_falcon_type=7, n_bpe_merges=0),
                     GGMLType.Q4_0, seed=5)
    cfg = EngineConfig(n_ctx=64, n_batch=16, kv_dtype=kv_dtype, compute_dtype=compute)
    f32 = compute == "float32"
    runs = {}
    for device in ("cpu", "cuda"):
        mf, params = load_model(path, cfg, device=device)
        eng = FalconEngine(mf.hparams, params, cfg, device=device, batch_size=3)
        if device == "cuda":
            build.launch_counts.clear()
            runs["graph"] = _row_run(eng, 2, eager=False)
            counts = dict(build.launch_counts)
            assert len(eng._chunks) == 1 and next(iter(eng._chunks.values())).graph is not None
            record = next(iter(eng._chunks.values())).graph.counts
            matmul, attn = ("quant_matmul.f32", "flash_decode.f32") if f32 else (
                "quant_matmul.rows", "flash_decode_tc")
            assert record.get(matmul, 0) > 0 and record.get(attn, 0) > 0, record
            others = ("quant_matmul.gemv", "quant_matmul.tc",
                      "flash_decode_tc" if f32 else "quant_matmul.f32")
            assert not any(record.get(n, 0) for n in others), record
            assert not counts.get("quant_matmul.gemv", 0), counts
            if f32:
                assert not any(counts.get(n, 0) for n in others), counts
        runs["eager" if device == "cuda" else "cpu"] = _row_run(eng, 2, eager=True)
    assert runs["graph"][0] == runs["eager"][0] and len(set(runs["graph"][0][1])) > 1
    scale = np.abs(runs["cpu"][1]).max()
    np.testing.assert_allclose(runs["eager"][1] / scale, runs["cpu"][1] / scale,
                               atol=2e-2 if not f32 else 2e-3 if kv_dtype == "int8" else 1e-4)
    if kv_dtype != "int8" and f32:
        assert [runs["graph"][0][r] for r in (0, 2)] == [runs["cpu"][0][r] for r in (0, 2)]


def test_a_failed_row_capture_raises_naming_the_step(dev, tmp_path, monkeypatch):
    """A B-row step that reads a value on the host cannot be captured:
    decode_rows raises, naming the rows, the step and the reason, and runs
    no eager fallback."""
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.io.loader import load_model
    from ggllm_tpu_torch.ops import sampling_device
    from ggllm_tpu_torch.utils.synthetic import write_tiny_model

    path = str(tmp_path / "tiny.ggcc")
    write_tiny_model(path, FalconHParams.tiny(), GGMLType.Q4_0, seed=5)
    cfg = EngineConfig(n_ctx=64, n_batch=16)
    mf, params = load_model(path, cfg, device="cuda")
    eng = FalconEngine(mf.hparams, params, cfg, batch_size=2)
    eng.prefill_rows([0, 1], ROW_PROMPTS[:2], np.zeros(2, np.int64))
    real = sampling_device.sample_rows_u

    def synced(logits, *a, **kw):
        float(logits.max())  # a host read
        return real(logits, *a, **kw)

    monkeypatch.setattr(sampling_device, "sample_rows_u", synced)
    with pytest.raises(RuntimeError, match="2-row decode chunk .* failed at step 0"):
        eng.decode_rows([5, 6], [len(p) for p in ROW_PROMPTS[:2]], 4)
    assert next(iter(eng._chunks.values())).graph is None


def _grammar_run(eng, text, eager: bool, n: int = 24):
    """n greedy ids (the end of text banned) under `text` through the
    Generator's masked chunks on `eng` from ROW_PROMPTS[0]."""
    from ggllm_tpu_torch.engine.generator import Generator
    from ggllm_tpu_torch.ops.grammar import GrammarSampler, parse_gbnf
    from ggllm_tpu_torch.ops.sampling import SamplerParams
    from ggllm_tpu_torch.utils.synthetic import make_tiny_vocab

    pieces = make_tiny_vocab(eng.hp.n_vocab).id_to_token
    eng.reset()
    gen = Generator(eng, SamplerParams(temp=0.0, repeat_penalty=1.1,
                                       logit_bias={11: float("-inf")}), 11,
                    grammar=GrammarSampler(parse_gbnf(text), pieces, 11))
    gen.eager = eager
    toks = []
    gen.generate(gen.prefill(ROW_PROMPTS[0]), n, lambda t: toks.append(t) or True)
    assert len(toks) == n
    return toks, dict(gen.masked_stats)


@pytest.mark.parametrize("kv_dtype,compute", [("float32", "float32"), ("int8", "float32"),
                                               ("bfloat16", "bfloat16")])
def test_masked_graphs_equal_the_eager_masked_body_and_the_cpu(dev, tmp_path, kv_dtype,
                                                               compute):
    """Grammar-constrained greedy decode through the masked chunk graphs
    (1-step and 16-step, the latter rolled back at the run's end) gives the
    eager masked step body's ids, and on the dense f32 cache the CPU's; a
    second grammar (another mask on the same keys) captures nothing."""
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.io.loader import load_model
    from ggllm_tpu_torch.utils.synthetic import write_tiny_model

    path = str(tmp_path / "tiny.ggcc")
    write_tiny_model(path, FalconHParams(n_vocab=512, n_embd=256, n_head=4, n_head_kv=1,
                                         n_layer=2, n_falcon_type=7, n_bpe_merges=0),
                     GGMLType.Q4_0, seed=5)
    cfg = EngineConfig(n_ctx=64, n_batch=16, kv_dtype=kv_dtype, compute_dtype=compute)
    runs = {}
    for device in ("cpu", "cuda"):
        mf, params = load_model(path, cfg, device=device)
        eng = FalconEngine(mf.hparams, params, cfg, device=device)
        if device == "cuda":
            runs["graph"] = _grammar_run(eng, "root ::= [0-9]+", eager=False)
            assert runs["graph"][1]["chunks"] and runs["graph"][1]["rolled_back"]
            masked = [c for c in eng._chunks.values() if c.key.masked]
            assert sorted(c.n_steps for c in masked) == [1, 16]
            assert all(c.graph is not None for c in masked)
            compile_us = eng.timings.t_compile_us
            _grammar_run(eng, 'root ::= [0-9] [0-9a-f]*', eager=False)
            assert eng.timings.t_compile_us == compile_us and len(eng._chunks) == len(masked)
        runs["eager" if device == "cuda" else "cpu"] = _grammar_run(
            eng, "root ::= [0-9]+", eager=True)
    assert runs["graph"][0] == runs["eager"][0]
    if kv_dtype == "float32":
        assert runs["graph"][0] == runs["cpu"][0]


def test_masked_row_graph_equals_the_eager_rows(dev, tmp_path):
    """decode_rows with per-row masks (one 1-step graph of a masked RowKey)
    gives the eager B-row body's ids with each row's mask in force, over
    masks that change every step without a new capture."""
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.io.loader import load_model
    from ggllm_tpu_torch.ops.sampling_device import mask_bytes
    from ggllm_tpu_torch.utils.synthetic import write_tiny_model

    path = str(tmp_path / "tiny.ggcc")
    write_tiny_model(path, FalconHParams(n_vocab=512, n_embd=256, n_head=4, n_head_kv=1,
                                         n_layer=2, n_falcon_type=7, n_bpe_merges=0),
                     GGMLType.Q4_0, seed=5)
    cfg = EngineConfig(n_ctx=64, n_batch=16, kv_dtype="float32", compute_dtype="float32")
    mf, params = load_model(path, cfg, device="cuda")
    B, V = 3, mf.hparams.n_vocab
    rng = np.random.default_rng(2)
    masks = [np.packbits(rng.random((B, V)) < 0.1, axis=1, bitorder="little") for _ in range(6)]
    assert masks[0].shape == (B, mask_bytes(V))
    masks = [np.where(np.arange(B)[:, None] == 1, 255, m).astype(np.uint8) for m in masks]
    runs = {}
    for eager in (False, True):
        eng = FalconEngine(mf.hparams, params, cfg, batch_size=B)
        first = eng.prefill_rows(list(range(B)), ROW_PROMPTS, np.zeros(B, np.int64))
        last = np.asarray([int(np.argmax(first[r])) for r in range(B)])
        npv = np.asarray([len(p) for p in ROW_PROMPTS], np.int64)
        out, compile_us = [], None
        for m in masks:
            toks, _, _ = eng.decode_rows(last, npv, 1, {"temp": np.asarray([0.0, 0.0, 0.9])},
                                         generator=torch.Generator(device=dev).manual_seed(1),
                                         eager=eager, mask_bits=m)
            valid = np.unpackbits(m, axis=1, bitorder="little")[:, :V].astype(bool)
            assert all(valid[r, toks[0, r]] for r in range(B))
            out.append(toks[0].tolist())
            last, npv = toks[-1], npv + 1
            if compile_us is None:
                compile_us = eng.timings.t_compile_us
        assert eng.timings.t_compile_us == compile_us and len(eng._chunks) == 1
        runs[eager] = out
    assert runs[False] == runs[True]


# ------------------------------------------------------- speculative rounds


def _spec_pair(tmp_path, kv_dtype, compute="bfloat16", batch=1, **cfg_kw):
    """A tiny Falcon (4 heads over one K/V head, head_dim 64, 2 layers) on
    the card and its first layer as the draft (weights aliased), `batch`
    rows each."""
    import dataclasses

    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.engine.speculative import truncate_params
    from ggllm_tpu_torch.io.loader import load_model
    from ggllm_tpu_torch.utils.synthetic import write_tiny_model

    path = str(tmp_path / "tiny.ggcc")
    write_tiny_model(path, FalconHParams(n_vocab=512, n_embd=256, n_head=4, n_head_kv=1,
                                         n_layer=2, n_falcon_type=7, n_bpe_merges=0),
                     GGMLType.Q4_0, seed=5)
    cfg = EngineConfig(n_ctx=256, n_batch=64, kv_dtype=kv_dtype, compute_dtype=compute, **cfg_kw)
    mf, params = load_model(path, cfg, device="cuda")
    return (FalconEngine(mf.hparams, params, cfg, batch_size=batch),
            FalconEngine(dataclasses.replace(mf.hparams, n_layer=1), truncate_params(params, 1),
                         cfg, batch_size=batch))


SPEC_PROMPT = [int(t) for t in np.random.default_rng(4).integers(3, 500, 20)]


def _spec_run(spec, sampler, n, uniforms=None):
    """Both engines reset, n ids from SPEC_PROMPT; returns (ids, n_acc a
    round, both caches' committed prefix)."""
    spec.target.reset()
    spec.draft.reset()
    ids = spec.generate(SPEC_PROMPT, n, sampler, uniforms=uniforms)
    kv = []
    for e in (spec.target, spec.draft):
        for a in (e.kv if isinstance(e.kv, tuple) else (e.kv,)):
            kv.append(a[:, :, :, :e.n_past].clone())
    return ids, [a for _, a, _ in spec.last_rounds], kv


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_round_graph_equals_the_eager_rounds(dev, tmp_path, kv_dtype, sampled):
    """The replayed round graph (k = 6, 4 rounds a graph) gives the eager
    round body's ids, n_acc and both caches bit for bit, greedy and on fixed
    uniforms; its capture record holds the rows kernel and flash_mqa (the
    verify over 7 positions), the GEMV and the decode kernel (the draft)."""
    from ggllm_tpu_torch.engine.speculative import SpeculativeDecoder
    from ggllm_tpu_torch.ops.sampling import SamplerParams

    tgt, dr = _spec_pair(tmp_path, kv_dtype)
    sampler = (SamplerParams(temp=0.8, top_k=40, top_p=0.95, repeat_penalty=1.0, seed=2)
               if sampled else SamplerParams(temp=0.0, repeat_penalty=1.0))
    us = np.random.default_rng(6).random((24, 14)) if sampled else None
    got = {eager: _spec_run(SpeculativeDecoder(tgt, dr, k=6, eager=eager), sampler, 48, us)
           for eager in (False, True)}
    assert got[False][:2] == got[True][:2] and len(got[False][0]) == 48
    assert all(torch.equal(a, b) for a, b in zip(got[False][2], got[True][2]))
    spec = SpeculativeDecoder(tgt, dr, k=6)
    _spec_run(spec, sampler, 8, us)
    record = spec.round_graph(sampler).counts
    decode = "flash_decode_tc" + (".int8" if kv_dtype == "int8" else "")
    for name in ("quant_matmul.rows", "quant_matmul.gemv", "flash_mqa.tc", decode):
        assert record.get(name, 0) > 0, (name, record)
    assert not record.get("quant_matmul.tc")


def test_speculative_ids_hold_to_the_plain_versions(dev, tmp_path):
    """Greedy speculative ids through the kernels, each within 1e-2 of max
    |logit| of the top logit of the plain versions' target with those ids
    forced (bf16: the rows kernel and the GEMV may part at a near-tie)."""
    from ggllm_tpu_torch.engine.speculative import SpeculativeDecoder
    from ggllm_tpu_torch.ops.sampling import SamplerParams

    tgt, dr = _spec_pair(tmp_path, "bfloat16")
    ids, _, _ = _spec_run(SpeculativeDecoder(tgt, dr, k=6),
                          SamplerParams(temp=0.0, repeat_penalty=1.0), 48)
    plain, _ = _spec_pair(tmp_path, "bfloat16", kernel_layout=False, flash_attention=False)
    lg = plain.eval(SPEC_PROMPT + ids[:-1], logits_all=True)[-len(ids):]
    top = lg.max(axis=1)
    assert np.all(top - lg[np.arange(len(ids)), ids] <= 1e-2 * np.abs(lg).max(axis=1))


def test_sampled_rounds_equal_their_float64_replay(dev, tmp_path):
    """Eager stochastic rounds on the card: each round's ids and n_acc equal
    a float64 host replay over its own p, q and drafts."""
    from ggllm_tpu_torch.engine.speculative import SpeculativeDecoder, replay_round
    from ggllm_tpu_torch.ops.sampling import SamplerParams

    tgt, dr = _spec_pair(tmp_path, "bfloat16")
    spec = SpeculativeDecoder(tgt, dr, k=6, eager=True)
    spec.record = []
    _spec_run(spec, SamplerParams(temp=0.9, top_k=40, top_p=0.9, tfs_z=0.95, typical_p=0.9,
                                  repeat_penalty=1.0, seed=3), 32)
    assert len(spec.last_rounds) > 4
    for rec, (emitted, n_acc, us) in zip(spec.record, spec.last_rounds):
        assert replay_round(rec["p"].double().cpu().numpy(), rec["q"].double().cpu().numpy(),
                            rec["xs"].tolist(), us) == (emitted, n_acc)


ROWS_PROMPTS = [[int(t) for t in np.random.default_rng(8 + b).integers(3, 500, n)]
                for b, n in enumerate((20, 5, 37, 2))]


def _rows_run(spec, prompts, n):
    """Both B-row engines reset, n ids a row; returns (ids, n_acc a round a
    row, both caches over each row's committed prefix)."""
    spec.target.reset()
    spec.draft.reset()
    ids = spec.generate_rows(prompts, n)
    kv = [a[:, :, b, :len(p) - 1 + len(o)].clone()
          for e in (spec.target, spec.draft) for a in (e.kv if isinstance(e.kv, tuple) else (e.kv,))
          for b, (p, o) in enumerate(zip(prompts, ids))]
    return ids, spec.last_rows["n_acc"], kv


@pytest.mark.parametrize("B", [2, 4])
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_rows_round_graph_equals_the_eager_rounds(dev, tmp_path, kv_dtype, B):
    """generate_rows' replayed round graph (k = 6, 4 rounds a graph) gives
    the eager round body's ids, n_acc and both caches over the committed
    prefixes bit for bit; its record holds the verify's B x 7 rows on the
    rows kernel at B = 2 (14 rows) and on the tile at B = 4 (28), the draft's
    B-row steps on the rows kernel and the decode kernel, no GEMV."""
    from ggllm_tpu_torch.engine.speculative import SpeculativeDecoder

    tgt, dr = _spec_pair(tmp_path, kv_dtype, batch=B)
    got = {eager: _rows_run(SpeculativeDecoder(tgt, dr, k=6, eager=eager), ROWS_PROMPTS[:B], 40)
           for eager in (False, True)}
    assert got[False][:2] == got[True][:2] and all(len(o) == 40 for o in got[False][0])
    assert all(torch.equal(a, b) for a, b in zip(got[False][2], got[True][2]))
    spec = SpeculativeDecoder(tgt, dr, k=6)
    _rows_run(spec, ROWS_PROMPTS[:B], 8)
    record = spec.rows_graph().counts
    decode = "flash_decode_tc" + (".int8" if kv_dtype == "int8" else "")
    for name in ("quant_matmul.rows", "flash_mqa.tc", decode):
        assert record.get(name, 0) > 0, (name, record)
    assert bool(record.get("quant_matmul.tc")) == (B == 4)
    assert not record.get("quant_matmul.gemv")


def test_rows_ids_hold_to_the_plain_versions(dev, tmp_path):
    """Every row's generate_rows ids through the kernels lie within 1e-2 of
    max |logit| of the top logit of the plain versions' single stream with
    those ids forced (bf16: the tile, the rows kernel and the GEMV sum in
    other orders)."""
    from ggllm_tpu_torch.engine.speculative import SpeculativeDecoder

    tgt, dr = _spec_pair(tmp_path, "bfloat16", batch=4)
    ids, _, _ = _rows_run(SpeculativeDecoder(tgt, dr, k=6), ROWS_PROMPTS, 40)
    plain, _ = _spec_pair(tmp_path, "bfloat16", kernel_layout=False, flash_attention=False)
    for p, o in zip(ROWS_PROMPTS, ids):
        plain.reset()
        lg = plain.eval(p + o[:-1], logits_all=True)[-len(o):]
        top = lg.max(axis=1)
        assert np.all(top - lg[np.arange(len(o)), o] <= 1e-2 * np.abs(lg).max(axis=1))


def _grad_calls(dev):
    """Each hand kernel's wrapper on card tensors at a shape its kernel takes,
    x / q requiring grad."""
    from ggllm_tpu_torch.kernels.ring_attention import ring_attention
    from ggllm_tpu_torch.parallel.comm import Comm

    g = _gen(0)
    w = random_quant(GGMLType.Q4_0, 128, 256, g, dev)
    x1, x2, x32 = (torch.randn(s, 256, device=dev, generator=g).to(dt).requires_grad_()
                   for s, dt in ((1, torch.bfloat16), (4, torch.bfloat16), (40, torch.float32)))
    q = torch.randn(1, 20, 8, 64, device=dev, generator=g).to(torch.bfloat16).requires_grad_()
    k = torch.randn(1, 64, 2, 64, device=dev, generator=g).to(torch.bfloat16)
    kv = torch.randn(1, 2, 1, 64, 2, 64, device=dev, generator=g).to(torch.bfloat16)
    q1 = torch.randn(1, 1, 8, 64, device=dev, generator=g).to(torch.bfloat16).requires_grad_()
    return {
        "quant_matmul": lambda: qm.quant_matmul(w, x1, torch.float32),
        "quant_matmul_tc": lambda: qm.quant_matmul_tc(w, x2, torch.float32),
        "group_sums": lambda: qm.group_sums(x32),
        "flash_mqa": lambda: flash_mqa(q, k, k, 0),
        "flash_decode": lambda: fd.flash_decode(kv, 2, 0, q1, 30),
        "cache_partials": lambda: fd.cache_partials(kv, 2, 0, q1.reshape(1, 2, 4, 64), 30),
        "ring_attention": lambda: ring_attention(q, k, k, Comm(None, [0], 0, None), 0),
    }


@pytest.mark.parametrize("name", ["quant_matmul", "quant_matmul_tc", "group_sums", "flash_mqa",
                                  "flash_decode", "cache_partials", "ring_attention"])
def test_kernel_wrappers_refuse_inputs_that_require_grad(dev, name):
    """A ctypes kernel gives an output with no grad_fn: its wrapper refuses
    an input that requires grad while grad mode is on, before any launch,
    and runs the same call under no_grad."""
    call = _grad_calls(dev)[name]
    before = dict(build.launch_counts)
    with pytest.raises(RuntimeError, match=f"{name}: an input requires grad"):
        call()
    assert dict(build.launch_counts) == before
    with torch.no_grad():
        out = call()
    assert all(t.isfinite().all() for t in (out if isinstance(out, tuple) else (out,)))


def test_train_demo_gradients_on_the_card_match_the_cpu(dev):
    """The training loss on the card (plain products, TF32 off, no hand
    kernel launched) gives the CPU's gradients within 1e-4 of each leaf's
    largest, on the same weights and tokens."""
    from ggllm_tpu_torch.ops.rope import rope_angles
    from ggllm_tpu_torch.tools import train_demo as demo

    hp = FalconHParams(n_vocab=512, n_embd=64, n_head=4, n_head_kv=1, n_layer=2,
                       n_falcon_type=7, n_bpe_merges=0)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(12, 268, (4, 17)))
    inv = torch.from_numpy(rope_angles(EngineConfig().rope, 16, hp.head_dim))
    grads = {}
    before = dict(build.launch_counts)
    for d in ("cpu", dev):
        params = demo.init_params(hp, 0, d)
        with demo.no_tf32():
            demo.loss_fn(params, tokens.to(d), hp, inv.to(d)).backward()
        grads[str(d)] = [p.grad.cpu() for p in demo.leaves(params)]
    assert dict(build.launch_counts) == before
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


# ---- long context


@pytest.mark.parametrize("H,KV", [(71, 1), (128, 8)])
def test_flash_mqa_at_the_16k_prefill_chunk(dev, H, KV):
    """bf16 prefill attention of a 2048-row chunk at n_past 10240 (the last
    chunk of a 12288-token prompt) over the 18432-position cache, against
    the plain version in 512-row pieces (2e-2 of max |ref|)."""
    g = _gen(19)
    kv = torch.randn(2, 1, LONG_T, KV, 64, generator=g, device=dev).to(torch.bfloat16)
    q = torch.randn(1, 2048, H, 64, generator=g, device=dev).to(torch.bfloat16)
    before = build.launch_counts["flash_mqa.tc"]
    got = flash_mqa(q, kv[0], kv[1], 10240)
    assert build.launch_counts["flash_mqa.tc"] == before + 1
    ref = torch.cat([flash_mqa_plain(q[:, i:i + 512], kv[0], kv[1], 10240 + i)
                     for i in range(0, 2048, 512)], dim=1)
    _close(got, ref, torch.bfloat16)


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_mha_decode_and_cache_writes_past_2_31_elements(dev, cache):
    """LLaMA-7B's heads (G == 1, KV 32, D 128) on layer 31 of a 32-layer
    cache of 18432 positions: 4.83 G elements, so the layer's offsets pass
    2^31. The G == 1 kernel at valid 16383 against the plain version, then a
    per-row write of layer 31 and a chunk-end write of every layer at a
    device n_past, read back."""
    L, KV, D = 32, 32, 128
    g = _gen(20)
    shape = (L, 2, 1, LONG_T, KV, D)
    kv = torch.empty(shape, dtype=torch.bfloat16, device=dev)
    if cache == "int8":
        kv = (torch.empty(shape, dtype=torch.int8, device=dev),
              torch.empty(*shape[:-1], 1, dtype=torch.float32, device=dev))
    for i in range(L):  # a layer at a time
        layer = torch.randn(shape[1:], generator=g, device=dev)
        if cache == "int8":
            kv[0][i], kv[1][i] = kvcache.quantize_new(layer)
        else:
            kv[i] = layer.to(torch.bfloat16)
    assert L * 2 * LONG_T * KV * D > 2**31
    q = torch.randn(1, 1, KV, D, generator=g, device=dev).to(torch.bfloat16)
    counter = "flash_decode.mha" + (".int8" if cache == "int8" else "")
    before = build.launch_counts[counter]
    got = fd.flash_decode(kv, KV, L - 1, q, 16382)
    assert build.launch_counts[counter] == before + 1
    _close(got, fd.flash_decode_plain(kv, KV, L - 1, q, 16382), torch.bfloat16)
    at = LONG_T - 40
    pos = torch.tensor([at], dtype=torch.int32, device=dev)
    new = torch.randn(2, 1, 1, KV, D, generator=g, device=dev).to(torch.bfloat16)
    new16 = torch.randn(L, 2, 1, 16, KV, D, generator=g, device=dev).to(torch.bfloat16)
    kvcache.write_layer(kv, new, L - 1, pos)
    kvcache.write_all_layers(kv, new16, pos - 16)
    if cache == "int8":
        (c1, s1), (c16, s16) = kvcache.quantize_new(new), kvcache.quantize_new(new16)
        assert torch.equal(kv[0][L - 1, :, :, at:at + 1], c1)
        assert torch.equal(kv[1][L - 1, :, :, at:at + 1], s1)
        assert torch.equal(kv[0][:, :, :, at - 16:at], c16)
        assert torch.equal(kv[1][:, :, :, at - 16:at], s16)
    else:
        assert torch.equal(kv[L - 1, :, :, at:at + 1], new)
        assert torch.equal(kv[:, :, :, at - 16:at], new16)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_tiny_model_at_n_ctx_16384(dev, tmp_path, kv_dtype):
    """A tiny Falcon (head_dim 64: the 16k alpha) at EngineConfig(n_ctx=16384,
    n_batch=2048): a 12288-token prompt, then 32 greedy ids from n_past
    12288 through the decode graphs equal to the eager step body's; on an
    f32 cache under f32 compute the card's prefill logits are within 1e-4
    of max |logit| of the CPU's and its greedy ids the CPU's."""
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.io.loader import load_model
    from ggllm_tpu_torch.ops.sampling import SamplerParams
    from ggllm_tpu_torch.utils.synthetic import write_tiny_model

    path = str(tmp_path / "tiny.ggcc")
    write_tiny_model(path, FalconHParams(n_vocab=512, n_embd=256, n_head=4, n_head_kv=1,
                                         n_layer=2, n_falcon_type=7, n_bpe_merges=0),
                     GGMLType.Q4_0, seed=5)
    prompt = [int(t) for t in np.random.default_rng(21).integers(12, 500, 12288)]
    greedy = SamplerParams(temp=0.0)
    cfg = EngineConfig(n_ctx=16384, n_batch=2048, kv_dtype=kv_dtype)
    mf, params = load_model(path, cfg, device="cuda")
    eng = FalconEngine(mf.hparams, params, cfg)
    assert eng.kv_T == LONG_T
    first = int(np.argmax(eng.eval(prompt)))
    ids = {}
    for eager in (False, True):
        eng.rollback(len(prompt))
        ids[eager] = _chunks(eng, first, prompt + [first], 2, 16, greedy, eager)
    assert ids[False] == ids[True] and len(set(ids[False])) > 1
    f32 = EngineConfig(n_ctx=16384, n_batch=2048, kv_dtype="float32", compute_dtype="float32")
    logits, greedy_ids = [], []
    for device in ("cpu", "cuda"):
        mf, params = load_model(path, f32, device=device)
        e = FalconEngine(mf.hparams, params, f32, device=device)
        logits.append(e.eval(prompt))
        tok = int(np.argmax(logits[-1]))
        toks, _ = e.decode_chunk(tok, 16, greedy, last_tokens=prompt + [tok])
        greedy_ids.append([tok] + [int(t) for t in toks])
    scale = np.abs(logits[0]).max()
    np.testing.assert_allclose(logits[1] / scale, logits[0] / scale, atol=1e-4)
    assert greedy_ids[0] == greedy_ids[1]


def test_rope_on_the_card_at_the_16k_caches_positions(dev):
    """RoPE's angles at the 16k alpha for positions 0 ... 18431 (18431
    radians at the first frequency), cos / sin and the rotation on the card
    within 1e-6 of the CPU's (which tests/test_torch_long_context.py holds
    to the JAX apply_rope) in f32."""
    from ggllm_tpu_torch.core.config import RopeConfig
    from ggllm_tpu_torch.ops.rope import rope_angles, rope_cos_sin, rotate

    inv = torch.from_numpy(rope_angles(RopeConfig(), 16384, 64))
    pos = torch.arange(LONG_T).reshape(1, -1)
    x = torch.randn(1, LONG_T, 2, 64, generator=torch.Generator().manual_seed(22))
    cpu = rope_cos_sin(pos, inv)
    card = rope_cos_sin(pos.to(dev), inv.to(dev))
    for a, b in zip(card, cpu):
        assert (a.cpu() - b).abs().max().item() <= 1e-6
    got = rotate(x.to(dev), *card).cpu()
    assert (got - rotate(x, *cpu)).abs().max().item() <= 1e-6 * x.abs().max().item()
