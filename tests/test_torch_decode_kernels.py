"""The port's flash-decode functions against the JAX package's, on the CPU:
LLaMA's G == 1 partials and flash_decode against `_cache_partials_mha`
(Pallas in interpret mode), on dense and int8 caches; `decode_plan`; and
`partials_emulated` / `decode_emulated`, the one-launch kernels' splits,
per-warp tiles, bf16 P and merge in PyTorch, against JAX and the plain
version. (Split from tests/test_torch_kernels.py, whose helpers it shares,
so that the test workers balance.) Tolerances are stated per test.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ggllm_tpu.kernels import flash_decode as jfd

from ggllm_tpu_torch.kernels import flash_decode as tfd
from ggllm_tpu_torch.ops import kvcache as tkvcache
from tests.test_torch_kernels import _int8_cache, _jax_int8_view

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)


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
    # the f32 route (f32 queries of grouped heads) plans one key tile a split
    n, chunk = tfd.decode_plan(300, B, KV, G, 32, "float32", rt="f32")
    assert n <= tfd._splits(300, B, KV, G, 32, "float32", 132, "f32") and n * chunk >= 300
    assert chunk <= tfd.tile_keys(32, "f32") or B * KV * n >= tfd.WAVES * 132


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
                                       (1, 5, 32, "f32")])
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
    if rt == "f32" or n_past < 5:  # a small group: give the splits a few keys each
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
                                       (1, 5, 32, "f32")])
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
