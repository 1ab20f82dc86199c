"""Long context in the PyTorch port against the JAX package, on the CPU.

Falcon's dynamic NTK RoPE scales with n_ctx // trained_ctx: at n_ctx 16384
over the trained 2048 it is (8 - 1) * 2 + 1 = 15, alpha = 15 ** (64 / 62)
~ 16.37 at head_dim 64. A tiny Falcon at head_dim 64 with
RopeConfig(trained_ctx=64) and n_ctx 512 has the same ratio, 8, so the same
alpha: its engines (JAX and the port, f32 compute, f32 and int8 caches)
prefill a 400-token prompt in 128-row chunks, decode past n_past 400 and
swap the context, and must agree. The JAX engine runs its plain XLA
attention here (flash_attention=False): its Pallas kernels in interpret mode
take minutes for a 400-token prefill; the port's plain attention and decode
versions are what a CPU tensor gets. Beside them: the angles and RoPE at
positions up to the 16k cache's last one (18431), the decode plans at the
16k cache's T 18432 for every route, and the plain decode partials at valid
16383 against the JAX kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggllm_tpu.core.config import EngineConfig, FalconHParams, RopeConfig
from ggllm_tpu.core.dtypes import GGMLType
from ggllm_tpu.engine.engine import FalconEngine
from ggllm_tpu.engine.generator import Generator as JGenerator
from ggllm_tpu.io.ggcc import read_model
from ggllm_tpu.io.loader import load_params
from ggllm_tpu.kernels import flash_decode as jfd
from ggllm_tpu.ops import kvcache as jkvcache
from ggllm_tpu.ops import rope as jrope
from ggllm_tpu.ops.sampling import SamplerParams
from ggllm_tpu.utils.synthetic import write_tiny_model

from ggllm_tpu_torch.core.config import EngineConfig as TEngineConfig
from ggllm_tpu_torch.core.config import RopeConfig as TRopeConfig
from ggllm_tpu_torch.engine.engine import FalconEngine as TFalconEngine
from ggllm_tpu_torch.engine.engine import kv_len
from ggllm_tpu_torch.engine.generator import Generator
from ggllm_tpu_torch.io.loader import load_model as tload_model
from ggllm_tpu_torch.kernels import flash_decode as tfd
from ggllm_tpu_torch.ops import kvcache as tkvcache
from ggllm_tpu_torch.ops import rope as trope
from ggllm_tpu_torch.ops.sampling import SamplerParams as TSamplerParams

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)

N_CTX, TRAINED, N_BATCH = 512, 64, 128  # n_ctx // trained_ctx = 16384 // 2048
PROMPT = [int(t) for t in np.random.default_rng(25).integers(12, 512, 400)]
N_GEN = 48  # greedy ids after the prompt: n_past 400 ... 447, three decode chunks
T16K = 16384 + 2048  # the cache of EngineConfig(n_ctx=16384, n_batch=2048)


def _hp():
    """7B-style (one K/V head), head_dim 64 as Falcon-7B's."""
    return FalconHParams(n_vocab=512, n_embd=256, n_head=4, n_head_kv=1, n_layer=2,
                         n_falcon_type=7, n_bpe_merges=0)


def _jax_cfg(kv_dtype):
    return EngineConfig(n_ctx=N_CTX, n_batch=N_BATCH, kv_dtype=kv_dtype,
                        compute_dtype="float32", rope=RopeConfig(trained_ctx=TRAINED),
                        kernel_layout=False, flash_attention=False)


def _torch_cfg(kv_dtype, n_ctx=N_CTX):
    return TEngineConfig(n_ctx=n_ctx, n_batch=N_BATCH, kv_dtype=kv_dtype,
                         compute_dtype="float32", rope=TRopeConfig(trained_ctx=TRAINED))


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("long") / "tiny64.ggcc")
    write_tiny_model(p, _hp(), ftype_2d=GGMLType.Q8_0, seed=29)
    return p


@pytest.fixture(scope="module")
def engines(path):
    """engines(which, kv_dtype): the module's one JAX engine a cache dtype
    (reset on each call, so each of its programs compiles once), or a fresh
    port engine on the CPU."""
    mf = read_model(path)
    tmf, tparams = tload_model(path, _torch_cfg("float32"), device="cpu")
    jax_engines = {}

    def get(which, kv_dtype="float32"):
        if which == "torch":
            return TFalconEngine(tmf.hparams, tparams, _torch_cfg(kv_dtype), device="cpu")
        if kv_dtype not in jax_engines:
            cfg = _jax_cfg(kv_dtype)
            jax_engines[kv_dtype] = FalconEngine(mf.hparams, load_params(mf, cfg), cfg)
        jax_engines[kv_dtype].reset()
        return jax_engines[kv_dtype]

    return get


@pytest.mark.parametrize("n_ctx", [4096, 8192, 16384, 32768])
def test_ntk_alpha_and_angles_equal_jax(n_ctx):
    """Dynamic NTK alpha and the inverse frequencies bit for bit the JAX
    functions' at head_dim 64 and 128; at 16384 alpha = 15 ** (64 / 62)."""
    for d in (64, 128):
        a = trope.ntk_alpha(TRopeConfig(), n_ctx, d)
        assert a == jrope.ntk_alpha(RopeConfig(), n_ctx, d)
        np.testing.assert_array_equal(trope.rope_angles(TRopeConfig(), n_ctx, d),
                                      jrope.rope_angles(RopeConfig(), n_ctx, d))
    if n_ctx == 16384:
        assert trope.ntk_alpha(TRopeConfig(), n_ctx, 64) == 15.0 ** (64 / 62)
        assert abs(trope.ntk_alpha(TRopeConfig(), n_ctx, 64) - 16.369) < 1e-3
    # the scaled tiny context of this file gives the 16k alpha
    assert (trope.ntk_alpha(TRopeConfig(trained_ctx=TRAINED), N_CTX, 64)
            == trope.ntk_alpha(TRopeConfig(), 16384, 64))


def test_rope_at_the_16k_caches_last_positions_matches_jax():
    """RoPE at positions 16000 ... 18431 (the angles reach 18431 radians)
    within 1e-6 of max |x| of the JAX apply_rope, in f32, and the engine's
    rope_cos_sin + rotate equal apply_rope."""
    inv = jrope.rope_angles(RopeConfig(), 16384, 64)
    pos = np.arange(16000, T16K).reshape(1, -1)
    x = np.random.default_rng(30).standard_normal((1, pos.shape[1], 3, 64)).astype(np.float32)
    ref = np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), inv))
    tx, tpos, tinv = torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(inv)
    got = trope.apply_rope(tx, tpos, tinv).numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(x).max()
    assert np.array_equal(trope.rotate(tx, *trope.rope_cos_sin(tpos, tinv)).numpy(), got)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_scaled_context_engine_matches_jax(engines, kv_dtype):
    """The 16k alpha at n_ctx 512: a 400-token prefill in 128-row chunks
    (logits of every position within 1e-4 of max |logit| of the JAX
    engine's, the tolerance of tests/test_torch_engine.py), then N_GEN greedy
    ids through the decode chunks equal to the JAX engine's."""
    jeng, teng = engines("jax", kv_dtype), engines("torch", kv_dtype)
    assert teng.kv_T == jeng.kv_T == N_CTX + N_BATCH
    np.testing.assert_array_equal(teng.inv_freq.numpy(), np.asarray(jeng.inv_freq))
    ref = jeng.eval(PROMPT, logits_all=True)
    got = teng.eval(PROMPT, logits_all=True)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, atol=1e-4)
    jeng.reset()
    teng.reset()
    ref_ids = jeng.generate(PROMPT, N_GEN, SamplerParams(temp=0.0))
    assert teng.generate(PROMPT, N_GEN, TSamplerParams(temp=0.0)) == ref_ids
    assert teng.n_past == jeng.n_past == len(PROMPT) + N_GEN - 1


def _gen(gen_cls, eng, sampler, prompt, n):
    gen = gen_cls(eng, sampler, eos_id=-1, n_keep=16)
    got = []

    def on_token(t):
        got.append(t)
        return True

    gen.generate(gen.prefill(prompt), n, on_token)
    return got, gen


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_context_swap_matches_jax_generator(engines, kv_dtype):
    """A 480-token prompt and 64 greedy ids cross n_ctx 512 at the 16k
    alpha: the Generator swaps (n_keep 16 plus half the context), and its ids
    and history equal the JAX Generator's; the ids after the swap equal those
    of a fresh engine that prefills the swapped context and decodes on from
    the id sampled before the swap (chip_smoke.py's check at n_ctx 16384)."""
    prompt = PROMPT + PROMPT[:80]
    got, gen = _gen(Generator, engines("torch", kv_dtype), TSamplerParams(temp=0.0), prompt, 64)
    ref, jgen = _gen(JGenerator, engines("jax", kv_dtype), SamplerParams(temp=0.0), prompt, 64)
    assert got == ref and len(got) == 64
    assert gen.swapped and jgen.swapped
    assert gen.all_tokens == jgen.all_tokens
    assert gen.eng.n_past == jgen.eng.n_past
    # the swap came with N_CTX tokens in the cache (all but the last sampled)
    # and kept the first n_keep 16 and the last (N_CTX - 16) // 2 of them
    hist = gen.all_tokens[:N_CTX]
    ctx = hist[:16] + hist[-((N_CTX - 16) // 2):]
    nxt, rest = gen.all_tokens[N_CTX], gen.all_tokens[N_CTX + 1:]
    fresh = engines("torch", kv_dtype)
    fresh.eval(ctx)
    again, _ = fresh.decode_pipelined(nxt, len(rest), 16, TSamplerParams(temp=0.0),
                                      last_tokens=gen.all_tokens[N_CTX - 63:N_CTX + 1])
    assert [int(t) for t in again] == rest


ROUTE_SHAPES = [  # (KV, G, D, cache, compute): every decode route at the 16k cache's T
    (1, 71, 64, "bfloat16", "bfloat16"), (1, 71, 64, "int8", "bfloat16"),
    (8, 16, 64, "bfloat16", "bfloat16"), (8, 29, 64, "int8", "bfloat16"),
    (1, 71, 64, "float32", "bfloat16"), (1, 71, 64, "int8", "float32"),
    (32, 1, 128, "bfloat16", "bfloat16"), (32, 1, 128, "int8", "bfloat16"),
]


@pytest.mark.parametrize("KV,G,D,cache,compute", ROUTE_SHAPES)
def test_decode_plan_at_t_18432_covers_every_valid_length(KV, G, D, cache, compute,
                                                           monkeypatch):
    """The plan made for the cache length T = 18432 (the lengths lie on the
    device) and the workspace made for it: every valid length up to T is
    covered by the plan's splits, each key in exactly one, within the
    workspace's splits; the route is the one the engine asks for."""
    assert kv_len(TEngineConfig(n_ctx=16384, n_batch=2048)) == T16K
    monkeypatch.setitem(tfd._n_sm, None, 132)  # the H100 SXM's multiprocessors
    rt = tfd.route(KV, G, D, cache, compute)
    assert rt == {1: "mha"}.get(G, "tc" if tfd.q_dtype(KV, G, cache, compute) == "bfloat16"
                                else "f32")
    n_split, chunk = tfd.decode_plan(T16K, 1, KV, G, D, cache, 132, rt)
    *_, ws_splits = tfd._workspace(torch.device("cpu"), 0, rt, 1, KV, G, D, T16K, cache)
    assert chunk % 16 == 0 and 1 <= n_split <= ws_splits and n_split * chunk >= T16K
    assert (n_split - 1) * chunk < T16K  # no split starts past the cache
    valid = np.arange(T16K + 1)
    k0 = np.arange(n_split)[:, None] * chunk
    k1 = np.minimum(valid[None, :], k0 + chunk)
    assert (np.clip(k1 - k0, 0, None).sum(axis=0) == valid).all()  # each key once
    tfd._workspaces.clear()


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_plain_partials_at_valid_16383_match_jax(kv_dtype):
    """The plain cache_partials over a T = 18432 cache at valid 16383 (the
    16k context's last decode step), Falcon-7B's heads (G 71 over one K/V
    head, D 64), against the JAX Pallas kernel in interpret mode: each of
    acc, m and l within 1e-5 of its largest magnitude (f32 sums over 16383
    keys in another order: the int8 case's acc parts by 2.2e-5 at |acc| 22,
    which the 1e-5 absolute bound of the 96-key cases in
    tests/test_torch_kernels.py does not take)."""
    rng = np.random.default_rng(31)
    dense = rng.standard_normal((1, 2, 1, T16K, 1, 64)).astype(np.float32)
    q = rng.standard_normal((1, 1, 71, 64)).astype(np.float32)
    valid = np.asarray([16383], np.int32)
    if kv_dtype == "int8":
        codes, scales = (np.asarray(a) for a in jkvcache.quantize_new(jnp.asarray(dense)))
        jkv = (jnp.asarray(codes.reshape(1, 2, 1, T16K, 64)),
               jnp.asarray(np.moveaxis(scales[..., 0], 3, 4)))
        tkv = tkvcache.from_jax_cache((codes, scales), device="cpu")
    else:
        dense = dense.astype(jnp.bfloat16).astype(np.float32)  # the bf16 cache's values
        jkv = jnp.asarray(dense.reshape(1, 2, 1, T16K, 64))
        tkv = torch.from_numpy(dense)
    ref = jfd.cache_partials(jkv, 1, 0, jnp.asarray(q), jnp.asarray(valid), interpret=True)
    got = tfd.cache_partials(tkv, 1, 0, torch.from_numpy(q), torch.from_numpy(valid))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape
        assert np.abs(g.numpy() - r).max() <= 1e-5 * np.abs(r).max()


def test_engine_at_n_ctx_16384_on_the_cpu(path):
    """EngineConfig(n_ctx=16384, n_batch=2048) as the CLI's -c 16384 -b 2048
    builds it: a cache of 18432 positions, the 16k alpha's angles, and the
    tiny model's prefill and greedy ids equal to an n_ctx 512 engine's with
    trained_ctx 64 (the same alpha) over the same prompt."""
    _, params = tload_model(path, _torch_cfg("float32"), device="cpu")
    hp = read_model(path).hparams
    big = TFalconEngine(hp, params, TEngineConfig(n_ctx=16384, n_batch=2048,
                                                  kv_dtype="float32", compute_dtype="float32"),
                        device="cpu")
    assert big.kv_T == T16K and big.kv.shape[3] == T16K
    small = TFalconEngine(hp, params, _torch_cfg("float32"), device="cpu")
    np.testing.assert_array_equal(big.inv_freq.numpy(), small.inv_freq.numpy())
    assert big.generate(PROMPT[:40], 8, TSamplerParams(temp=0.0)) == \
        small.generate(PROMPT[:40], 8, TSamplerParams(temp=0.0))


@pytest.mark.parametrize("temp", [["--temp", "0"], []], ids=["temp0", "derated"])
def test_cli_at_c_16384_gives_the_generators_ids(path, tmp_path, capsysbinary, temp):
    """The CLI at -c 16384 -b 2048 on the CPU, a prompt from -f: the
    prompt and 12 ids of the Generator on an engine at that context (greedy,
    repeat penalty 1, EOS banned); with the temperature left at its default
    it prints the JAX CLI's derating line (0.5 from 16384 on) and --top-k 1
    keeps it greedy."""
    from ggllm_tpu_torch import tokenizer as tok_mod
    from ggllm_tpu_torch.tools import main as tmain

    text = " ".join(np.random.default_rng(32).choice(["the", "thing", "and", "in", "ring"], 60))
    prompt = tmp_path / "prompt.txt"
    prompt.write_text(text)
    rc = tmain.main(["-m", path, "-f", str(prompt), "-c", "16384", "-b", "2048", "-n", "12",
                     "--repeat-penalty", "1", "--ignore-eos", "--top-k", "1", "--device", "cpu",
                     *temp])
    assert rc == 0
    out = capsysbinary.readouterr()
    line = b"info: context size 16384 is large; reducing default temperature to 0.5"
    assert (line in out.err) == (not temp)
    tmf, params = tload_model(path, TEngineConfig(), device="cpu")
    tk = tok_mod.for_model(tmf)
    eng = TFalconEngine(tmf.hparams, params, TEngineConfig(n_ctx=16384, n_batch=2048),
                        device="cpu")
    gen = Generator(eng, TSamplerParams(temp=0.0, repeat_penalty=1.0,
                                        logit_bias={tk.eos_id: float("-inf")}), tk.eos_id)
    got = []
    gen.generate(gen.prefill(tk.tokenize(text, bos=True)), 12, lambda t: got.append(t) is None)
    assert out.out == text.encode() + b"".join(tk.piece(t) for t in got) + b"\n"


def test_profiling_tools_take_the_context_size(monkeypatch):
    """tools/profile_decode.py and tools/time_kernels.py decode build the
    engine at --ctx / --batch (a 12288-token prompt needs n_ctx 16384:
    at the default 2048 the prefill overflows the context)."""
    from ggllm_tpu_torch.tools import profile_decode, time_kernels

    seen = {}

    class Stop(Exception):
        pass

    def engine(hp, params, cfg, **kw):
        seen["cfg"] = cfg
        raise Stop

    monkeypatch.setattr(profile_decode, "make_bench_params", lambda *a, **kw: None)
    monkeypatch.setattr(profile_decode, "FalconEngine", engine)
    with pytest.raises(Stop):
        profile_decode.main(["--ctx", "16384", "--batch", "2048", "--prompt", "12288",
                             "--kv-dtype", "int8"])
    cfg = seen.pop("cfg")
    assert (cfg.n_ctx, cfg.n_batch, cfg.kv_dtype) == (16384, 2048, "int8")
    monkeypatch.setattr(time_kernels, "time_decode", lambda *a: seen.setdefault("args", a))
    time_kernels.main(["decode", "--ctx", "16384", "--batch", "2048", "--prompt", "12288"])
    assert seen["args"][-2:] == (16384, 2048) and seen["args"][3] == 12288
