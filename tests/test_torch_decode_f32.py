"""The arithmetic of the port's f32 decode kernel and of its coalesced
group_sums, checked on the CPU.

The kernels (csrc/flash_decode_f32.cu, csrc/group_sums.cu) run only on the
card. What they compute is restated in the wrapper modules and held here
against the JAX package's Pallas kernels in interpret mode, on inputs made
from numpy seeds:
 * `partials_emulated(rt="f32")` (decode_plan's splits, the per-warp key
   tiles, both products formed from split-TF32 terms) against
   `cache_partials`, and `decode_emulated(rt="f32")` with the append block
   against `flash_decode`: Falcon-like groups (G 5 and 71 over 1 or 2 K/V
   heads) at head_dim 32, 64 and 128, f32 and int8 caches, one row or two
   rows with their own lengths, at 2e-5 of max |ref| (the f32 tolerance of
   the card tests and chip_smoke.py); f32 q on a bf16 cache (G 5 and 71 at
   head_dim 64), which the route keeps in f32, the same way, and q rounded
   to bf16 outside the tolerance;
 * the negative control: with one TF32 product (hi x hi), the same
   restatement lands outside 2e-5;
 * the f32 route's decode_plan and `route`; prefill attention where q and
   a dense cache differ in dtype (`--memory-f32`) hands the kernel both in
   the wider one;
 * `group_sums_emulated` (the kernel's lane sums and shuffle tree) against
   `_group_sums`, within 1e-6 of max |ref|.
"""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ggllm_tpu.kernels import flash_decode as jfd
from ggllm_tpu.kernels import quant_matmul as jqm

from ggllm_tpu_torch.kernels import flash_decode as tfd
from ggllm_tpu_torch.kernels import quant_matmul as tqm
from ggllm_tpu_torch.kernels.flash_attention import flash_mqa_plain
from ggllm_tpu_torch.models import falcon as tfalcon
from ggllm_tpu_torch.ops import kvcache as tkvcache
from tests.test_torch_kernels import _int8_cache, _jax_int8_view

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)

TOL = 2e-5  # of max |ref|: tests/test_torch_cuda.py's f32 tolerance
T, L, LAYER, A = 160, 2, 1, 9  # cache positions, layers, the layer attended, append entries
SHAPES = [(G, KV, D) for G in (5, 71) for KV in (1, 2) for D in (32, 64, 128)]
SHAPE_IDS = [f"G{g}_KV{kv}_D{d}" for g, kv, d in SHAPES]


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@functools.lru_cache(maxsize=None)
def _case(G, KV, D, cache, B):
    """(JAX cache operand, port cache, q (B, KV, G, D), append block
    (2, B, A, KV, D), the rows' cache lengths): a random L-layer cache of T
    positions, f32, bf16 or quantized by the JAX package, f32 q."""
    seed = G * 1000 + KV * 100 + D + B
    rng = np.random.default_rng(seed)
    if cache == "int8":
        codes, scales = _int8_cache(L, B, T, KV, D, seed)
        jkv = _jax_int8_view(codes, scales)
        tkv = tkvcache.from_jax_cache((codes, scales), device="cpu")
    elif cache == "bfloat16":  # the same bf16 values on both sides
        tkv = torch.from_numpy(rng.standard_normal((L, 2, B, T, KV, D)).astype(np.float32))
        tkv = tkv.to(torch.bfloat16)
        jkv = jnp.asarray(tkv.float().numpy().reshape(L, 2, B, T, KV * D)).astype(jnp.bfloat16)
    else:
        kv = rng.standard_normal((L, 2, B, T, KV, D)).astype(np.float32)
        jkv, tkv = jnp.asarray(kv.reshape(L, 2, B, T, KV * D)), torch.from_numpy(kv)
    q = rng.standard_normal((B, KV, G, D)).astype(np.float32)
    app = rng.standard_normal((2, B, A, KV, D)).astype(np.float32)
    return jkv, tkv, q, app, np.asarray([151, 45][:B], np.int32)


@functools.lru_cache(maxsize=None)
def _jax_partials(G, KV, D, cache, B):
    jkv, _, q, _, lens = _case(G, KV, D, cache, B)
    ref = jfd.cache_partials(jkv, KV, LAYER, jnp.asarray(q), jnp.asarray(lens), interpret=True)
    return tuple(np.asarray(r) for r in ref)


def _emulated_partials(G, KV, D, cache, B, terms=3):
    _, tkv, q, _, lens = _case(G, KV, D, cache, B)
    return tfd.partials_emulated(tkv, KV, LAYER, torch.from_numpy(q), lens.tolist(), rt="f32",
                                 terms=terms)


@pytest.mark.parametrize("B", [1, 2], ids=["B1", "B2_rows"])
@pytest.mark.parametrize("cache", ["float32", "int8"])
@pytest.mark.parametrize("G,KV,D", SHAPES, ids=SHAPE_IDS)
def test_f32_partials_match_jax_kernel(G, KV, D, cache, B):
    """acc, m and l of the f32 route's restatement within 2e-5 of max |ref|
    of the Pallas `_kern` each; on an f32 cache the plan cuts the rows' keys
    into several splits (an int8 key is cheap beside G = 71 rows' partials:
    there the merge rule keeps one)."""
    got = _emulated_partials(G, KV, D, cache, B)
    for g, r in zip(got, _jax_partials(G, KV, D, cache, B)):
        assert g.shape == r.shape and torch.isfinite(g).all()
        assert _rel(g.numpy(), r) <= TOL
    n, _ = tfd.decode_plan(151, B, KV, G, D, cache, rt="f32")
    assert n > 1 or (cache == "int8" and G == 71)


@pytest.mark.parametrize("B", [1, 2], ids=["B1", "B2_rows"])
@pytest.mark.parametrize("cache", ["float32", "int8"])
@pytest.mark.parametrize("G,KV,D", SHAPES, ids=SHAPE_IDS)
def test_f32_decode_with_append_matches_jax(G, KV, D, cache, B):
    """The whole decode attention with the append block, 4 of its 9 entries
    valid (the cache valid below n_past - 3: the rows' lengths), as the
    kernel's last block merges it, within 2e-5 of max |ref| of the JAX
    flash_decode."""
    jkv, tkv, q, app, lens = _case(G, KV, D, cache, B)
    n_past = lens + 3
    H = KV * G
    ref = np.asarray(jfd.flash_decode(jkv, KV, LAYER, jnp.asarray(q.reshape(B, 1, H, D)),
                                      jnp.asarray(n_past), kv_append=jnp.asarray(app),
                                      append_valid=jnp.int32(4), interpret=True))
    got = tfd.decode_emulated(tkv, KV, LAYER, torch.from_numpy(q).reshape(B, 1, H, D),
                              n_past.tolist(), kv_append=torch.from_numpy(app), append_valid=4,
                              rt="f32")
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert _rel(got.numpy(), ref) <= TOL


BF16_SHAPES = [(G, KV, 64) for G in (5, 71) for KV in (1, 2)]
BF16_IDS = [f"G{g}_KV{kv}_D64" for g, kv, _ in BF16_SHAPES]


@pytest.mark.parametrize("B", [1, 2], ids=["B1", "B2_rows"])
@pytest.mark.parametrize("G,KV,D", BF16_SHAPES, ids=BF16_IDS)
def test_f32_q_on_a_bf16_cache_partials_match_jax_kernel(G, KV, D, B):
    """f32 queries over a bf16 cache (f32 compute on the default cache) stay
    in f32 on the grouped route, as the Pallas `_kern` keeps them: the f32
    route's restatement (bf16 K/V exact in TF32, so their lo terms are zero)
    within 2e-5 of max |ref| of `cache_partials` in acc, m and l."""
    assert tfd.route(KV, G, D, "bfloat16", "float32") == "f32"
    got = _emulated_partials(G, KV, D, "bfloat16", B)
    for g, r in zip(got, _jax_partials(G, KV, D, "bfloat16", B)):
        assert g.shape == r.shape and torch.isfinite(g).all()
        assert _rel(g.numpy(), r) <= TOL


@pytest.mark.parametrize("B", [1, 2], ids=["B1", "B2_rows"])
@pytest.mark.parametrize("G,KV,D", BF16_SHAPES, ids=BF16_IDS)
def test_f32_q_on_a_bf16_cache_decode_with_append_matches_jax(G, KV, D, B):
    """The whole decode attention of f32 q over a bf16 cache with the append
    block (4 of 9 entries valid), as decode_emulated merges it on the route
    `route` picks, within 2e-5 of max |ref| of the JAX flash_decode; rounding
    q to the cache's bf16 first (what the card did before) lands outside."""
    jkv, tkv, q, app, lens = _case(G, KV, D, "bfloat16", B)
    n_past = lens + 3
    H = KV * G
    ref = np.asarray(jfd.flash_decode(jkv, KV, LAYER, jnp.asarray(q.reshape(B, 1, H, D)),
                                      jnp.asarray(n_past), kv_append=jnp.asarray(app),
                                      append_valid=jnp.int32(4), interpret=True))
    tq = torch.from_numpy(q).reshape(B, 1, H, D)
    got = tfd.decode_emulated(tkv, KV, LAYER, tq, n_past.tolist(),
                              kv_append=torch.from_numpy(app), append_valid=4)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert _rel(got.numpy(), ref) <= TOL
    rounded = tfd.decode_emulated(tkv, KV, LAYER, tq.to(torch.bfloat16).float(), n_past.tolist(),
                                  kv_append=torch.from_numpy(app), append_valid=4)
    assert _rel(rounded.numpy(), ref) > TOL


@pytest.mark.parametrize("cache", ["float32", "int8"])
@pytest.mark.parametrize("G,KV,D", [(71, 1, 64), (5, 2, 128), (71, 2, 32)],
                         ids=["G71_KV1_D64", "G5_KV2_D128", "G71_KV2_D32"])
def test_f32_partials_with_one_tf32_product_miss_the_tolerance(G, KV, D, cache):
    """The negative control: hi x hi alone (TF32 accuracy: q's and P's lo
    terms dropped, on an int8 cache the only ones there are) puts acc
    outside 2e-5, so the tolerance tells f32 from TF32 accuracy."""
    acc, _, _ = _emulated_partials(G, KV, D, cache, 1, terms=1)
    assert _rel(acc.numpy(), _jax_partials(G, KV, D, cache, 1)[0]) > TOL


@pytest.mark.parametrize("B,KV,G,D,cache", [(1, 1, 71, 64, "float32"), (1, 8, 16, 64, "float32"),
                                            (1, 1, 71, 64, "int8"), (2, 8, 16, 64, "int8"),
                                            (1, 2, 4, 128, "float32"), (1, 1, 5, 32, "float32")])
def test_f32_decode_plan(B, KV, G, D, cache):
    """On the f32 route every valid key lies in exactly one split and every
    split holds keys, a split holds at least MIN_KEYS keys, and the blocks
    stay within WAVES an SM; the workspace sized for T holds every shorter
    plan; a split is one 64-key tile at Falcon-7B's heads (D = 64), so at
    Falcon-40B's 2047 keys fill the SMs."""
    n_sm, T_ = 132, 2560
    ws = tfd._splits(T_, B, KV, G, D, cache, n_sm, "f32")
    for valid in [1, 31, 32, 64, 151, 300, 1000, 2047, 2560]:
        n, chunk = tfd.decode_plan(valid, B, KV, G, D, cache, n_sm, "f32")
        keys = [t for s in range(n) for t in range(s * chunk, min((s + 1) * chunk, valid))]
        assert keys == list(range(valid))
        assert (n - 1) * chunk < valid and 1 <= n <= ws
        assert n == 1 or chunk >= tfd.MIN_KEYS
        assert B * KV * n < tfd.WAVES * n_sm + B * KV
    n, _ = tfd.decode_plan(2047, 1, 8, 16, 64, "float32", n_sm, "f32")
    assert 8 * n >= n_sm
    for valid, plan in ((300, (5, 64)), (2047, (32, 64)), (2560, (40, 64))):
        assert tfd.decode_plan(valid, 1, 1, 71, 64, "float32", n_sm, "f32") == plan


@pytest.mark.parametrize("KV,G,D,cache,compute,want", [
    (1, 71, 64, "float32", "bfloat16", "f32"),  # --memory-f32: q takes the cache's dtype
    (1, 71, 64, "float32", "float32", "f32"), (8, 16, 64, "int8", "float32", "f32"),
    (2, 4, 128, "float32", "float32", "f32"), (1, 71, 128, "int8", "float32", "f32"),
    (1, 5, 32, "bfloat16", "bfloat16", "f32"), (2, 3, 32, "int8", "bfloat16", "f32"),
    (1, 1, 64, "float32", "float32", "f32"), (1, 71, 64, "bfloat16", "bfloat16", "tc"),
    (8, 16, 128, "int8", "bfloat16", "tc"), (32, 1, 128, "float32", "float32", "mha"),
    (1, 71, 64, "bfloat16", "float32", "f32"), (8, 16, 128, "bfloat16", "float32", "f32"),
    (1, 1, 64, "bfloat16", "float32", "f32"), (32, 1, 128, "bfloat16", "float32", "mha")])
def test_decode_route(KV, G, D, cache, compute, want):
    """f32 queries take the f32 kernel at head_dim 32, 64 and 128 on every
    cache with grouped heads (on a bf16 cache too: q stays f32, as the JAX
    `_kern` keeps it), and bf16 queries at head_dim 32 (every shape the
    CUDA-core kernel took, and grouped f32 at 128); bf16 at 64 / 128 the bf16
    tensor-core kernel; G == 1 over several K/V heads the G == 1 kernel,
    where f32 q meets a bf16 cache as bf16 (the JAX `_cache_partials_mha`
    casts q to a dense cache's dtype)."""
    assert tfd.route(KV, G, D, cache, compute) == want
    assert tfd.supports(KV, G, D, cache, compute) == (True, want)
    mha_cast = cache == "bfloat16" and G == 1 and KV > 1
    assert tfd.q_dtype(KV, G, cache, compute) == (
        compute if cache == "int8" or (cache == "bfloat16" and not mha_cast) else cache)


def test_decode_route_refuses():
    for args in ((4, 4, 256, "float32"), (1, 129, 64, "float32"), (1, 8, 64, "float16")):
        with pytest.raises(NotImplementedError):
            tfd.route(*args)


@pytest.mark.parametrize("S", [256, 300])
@pytest.mark.parametrize("g", [32, 16])
def test_group_sums_emulated_matches_jax_kernel(g, S):
    """The kernel's order of sums (four floats a lane, then the lanes of a
    group by a shuffle tree) against the Pallas `_xg_kern`'s group sums,
    within 1e-6 of max |ref|, and against the plain version."""
    K = 640
    x = np.random.default_rng(S + g).standard_normal((S, K)).astype(np.float32)
    out = np.asarray(jqm._group_sums(jnp.asarray(x), 1, K, g, 256, interpret=True))
    ref = out.reshape(S, 1, -1)[:, :, :K // g].reshape(S, K // g)
    got = tqm.group_sums_emulated(torch.from_numpy(x), g)
    assert got.shape == (S, K // g)
    assert _rel(got.numpy(), ref) <= 1e-6
    assert _rel(tqm.group_sums_plain(torch.from_numpy(x), g).numpy(), got.numpy()) <= 1e-6


@pytest.mark.parametrize("qdtype,cdtype", [(torch.bfloat16, torch.float32),
                                           (torch.float32, torch.bfloat16)],
                         ids=["memory_f32", "f32_compute_bf16_cache"])
def test_prefill_attention_meets_the_cache_in_the_wider_dtype(monkeypatch, qdtype, cdtype):
    """q and a dense cache of another dtype: prefill attention hands
    flash_mqa q, K and V in the wider of the two, f32 (the kernels take one
    dtype; the JAX kernel attends both in f32), and returns q's dtype, equal
    to the plain attention over the same values to f32 rounding of the
    output's dtype: `--memory-f32` (an f32 cache, bf16 compute), which
    raised on the card, and a bf16 cache under f32 compute, which must not
    round q to bf16."""
    seen = []

    def recorder(q, k, v, n_past):
        seen.append((q.dtype, k.dtype, v.dtype))
        return flash_mqa_plain(q, k, v, n_past)

    monkeypatch.setattr(tfalcon, "flash_mqa", recorder)
    B, S, H, KV, D, T, n_past = 1, 7, 8, 2, 32, 40, 5
    g = torch.Generator().manual_seed(13)
    kv = torch.randn(2, 2, B, T, KV, D, generator=g).to(cdtype)
    q = torch.randn(B, S, H, D, generator=g).to(qdtype)
    kv_new = torch.randn(2, B, S, KV, D, generator=g).to(qdtype)
    st = tfalcon.FalconStatic(n_layer=2, n_head=H, n_head_kv=KV, head_dim=D, n_embd=H * D,
                              n_ff=4 * H * D, n_vocab=0, parallel_norms=True, flash=True)
    got = tfalcon.attend(kv, 1, q, kv_new, n_past, st)
    assert seen == [(torch.float32,) * 3] and got.dtype == qdtype
    ref = tfalcon._attention(q.float(), kv[1, 0].float(), kv[1, 1].float(), n_past, st)
    tol = 2e-2 if qdtype == torch.bfloat16 else 1e-6
    assert float((got.float() - ref).abs().max()) <= tol * float(ref.abs().max())
