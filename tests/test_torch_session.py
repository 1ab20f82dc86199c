"""The port's sessions (ggllm_tpu_torch/engine/session.py) and the CLI's
--prompt-cache flags against the JAX package's, on the CPU.

One tiny Falcon Q8_0 file; one JAX engine a KV dtype (f32, bf16, int8; f32
compute) a module. A session file written by either package loads its tokens
and KV into the other with the KV equal to what the JAX load gives, bit for
bit (bf16 as raw bits, int8 codes and scales), also across dense and int8
caches; the prefix cap and every guard mismatch leave the prompt unchanged;
the host rng and mu cross packages, a JAX device key is never restored into
a torch generator, and a torch state only on its device type; a sampled
continuation after save and load equals the uninterrupted run; and the CLI's
--prompt-cache, --prompt-cache-ro, --prompt-cache-all."""

import numpy as np
import pytest
import torch

from ggllm_tpu.core.config import EngineConfig, FalconHParams
from ggllm_tpu.core.dtypes import GGMLType
from ggllm_tpu.engine import session as jsession
from ggllm_tpu.engine.engine import FalconEngine
from ggllm_tpu.io.ggcc import read_model
from ggllm_tpu.io.loader import load_params
from ggllm_tpu.ops import sampling as jsampling
from ggllm_tpu.utils.synthetic import write_tiny_model

from ggllm_tpu_torch.core.config import EngineConfig as TEngineConfig
from ggllm_tpu_torch.engine import session
from ggllm_tpu_torch.engine.engine import FalconEngine as TFalconEngine
from ggllm_tpu_torch.engine.generator import Generator
from ggllm_tpu_torch.io.loader import load_model as tload_model
from ggllm_tpu_torch.ops import sampling
from ggllm_tpu_torch.tools import main as cli

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)

KV_DTYPES = ("float32", "bfloat16", "int8")
PROMPT = [5, 17, 130, 42, 99, 260, 31]


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("sess") / "tiny.ggcc")
    write_tiny_model(p, FalconHParams.tiny(), ftype_2d=GGMLType.Q8_0, seed=6)
    return p


def _cfg(kv_dtype):
    return dict(n_ctx=64, n_batch=16, kv_dtype=kv_dtype, compute_dtype="float32")


@pytest.fixture(scope="module")
def jax_engines(path):
    """One JAX engine a KV dtype, built once (reset before each use)."""
    mf = read_model(path)
    out = {}
    for kvd in KV_DTYPES:
        cfg = EngineConfig(**_cfg(kvd))
        out[kvd] = FalconEngine(mf.hparams, load_params(mf, cfg), cfg)
    return out


@pytest.fixture(scope="module")
def port(path):
    """port(kv_dtype): a fresh port engine on the CPU."""
    loaded = {}

    def make(kvd):
        cfg = TEngineConfig(**_cfg(kvd))
        if kvd not in loaded:
            loaded[kvd] = tload_model(path, cfg, device="cpu")
        mf, params = loaded[kvd]
        return TFalconEngine(mf.hparams, params, cfg, device="cpu")

    return make


def _jax_kv(eng, n):
    """A JAX engine's first n KV positions as numpy: bf16 as uint16 bits,
    int8 as (codes, scales)."""
    kv = eng.kv
    if isinstance(kv, tuple):
        return tuple(np.asarray(a)[:, :, :, :n] for a in kv)
    a = np.asarray(kv)[:, :, :, :n]
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def _port_kv(eng, n):
    kv = eng.kv
    if isinstance(kv, tuple):
        return tuple(a[:, :, :, :n].numpy() for a in kv)
    a = kv[:, :, :, :n]
    return a.view(torch.int16).numpy().view(np.uint16) if a.dtype == torch.bfloat16 else a.numpy()


def _assert_kv_equal(a, b):
    for x, y in zip(a, b) if isinstance(a, tuple) else [(a, b)]:
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _jax_saved(jax_engines, kvd, tmp_path, name="j.npz"):
    jeng = jax_engines[kvd]
    jeng.reset()
    jeng.eval(PROMPT)
    f = str(tmp_path / name)
    jsession.save(f, jeng, PROMPT)
    return f, jeng


@pytest.mark.parametrize("kvd", KV_DTYPES)
def test_a_jax_session_loads_into_the_port(jax_engines, port, tmp_path, kvd):
    f, jeng = _jax_saved(jax_engines, kvd, tmp_path)
    teng = port(kvd)
    assert session.try_load(f, teng, PROMPT + [7, 8]) == [7, 8]
    assert teng.n_past == len(PROMPT)
    _assert_kv_equal(_port_kv(teng, len(PROMPT)), _jax_kv(jeng, len(PROMPT)))


@pytest.mark.parametrize("kvd", KV_DTYPES)
def test_a_port_session_loads_into_jax(jax_engines, port, tmp_path, kvd):
    teng = port(kvd)
    teng.eval(PROMPT)
    f = str(tmp_path / "t.session")  # no .npz suffix: the port writes the path it is given
    session.save(f, teng, PROMPT)
    z = np.load(f)
    assert str(z["kv_dtype"]) == kvd and "rng_key" not in z
    assert (z["kv_q"] if kvd == "int8" else z["kv"]).shape[3] == len(PROMPT)
    jeng = jax_engines[kvd]
    jeng.reset()
    assert jsession.try_load(f, jeng, PROMPT + [7, 8]) == [7, 8]
    assert jeng.n_past == len(PROMPT)
    _assert_kv_equal(_jax_kv(jeng, len(PROMPT)), _port_kv(teng, len(PROMPT)))


@pytest.mark.parametrize("saved,loaded", [("float32", "int8"), ("bfloat16", "int8"),
                                          ("int8", "float32"), ("int8", "bfloat16")])
def test_dense_and_int8_convert_on_load_as_in_jax(jax_engines, port, tmp_path, saved, loaded):
    """A dense session quantizes into an int8 engine (kvcache.quantize_new)
    and an int8 one dequantizes into a dense engine, to the JAX load's KV."""
    f, _ = _jax_saved(jax_engines, saved, tmp_path)
    teng = port(loaded)
    assert session.try_load(f, teng, PROMPT + [9]) == [9]
    jeng = jax_engines[loaded]
    jeng.reset()
    assert jsession.try_load(f, jeng, PROMPT + [9]) == [9]
    _assert_kv_equal(_port_kv(teng, len(PROMPT)), _jax_kv(jeng, len(PROMPT)))
    ref = port(loaded)
    np.testing.assert_allclose(teng.eval([9]), ref.eval(PROMPT + [9]), atol=5e-2)


def test_a_resumed_session_continues_as_a_fresh_eval(port, tmp_path):
    """Resume from a saved session == evaluating the full prompt fresh."""
    e1 = port("float32")
    e1.eval(PROMPT)
    f = str(tmp_path / "s.npz")
    session.save(f, e1, PROMPT)
    e2 = port("float32")
    assert session.try_load(f, e2, PROMPT + [7, 8]) == [7, 8]
    np.testing.assert_allclose(e2.eval([7, 8]), port("float32").eval(PROMPT + [7, 8]), atol=1e-5)


def test_the_prefix_is_capped(port, tmp_path):
    """The reused prefix stops at the first differing id, at n_past, and at
    len(prompt) - 1 (one id is always evaluated)."""
    e1 = port("float32")
    e1.eval(PROMPT)
    f = str(tmp_path / "s.npz")
    session.save(f, e1, PROMPT + [3, 4])  # two ids past n_past
    for prompt, rest in ((PROMPT, PROMPT[-1:]), (PROMPT + [3, 4, 5], [3, 4, 5]),
                         (PROMPT[:3] + [1, 2], [1, 2]), ([9] + PROMPT, [9] + PROMPT)):
        e2 = port("float32")
        assert session.try_load(f, e2, prompt) == rest
        assert e2.n_past == len(prompt) - len(rest)


def _rewrite(src: str, dst: str, **fields):
    z = dict(np.load(src))
    z.update(fields)
    np.savez(dst, **z)


@pytest.mark.parametrize("field,value", [
    ("magic", "ggsn-xxx"), ("version", 1), ("n_embd", 64), ("n_layer", 3), ("n_head_kv", 2),
    ("n_ctx", 128), ("batch", 2)])
def test_a_guard_mismatch_returns_the_prompt_unchanged(port, tmp_path, field, value):
    e1 = port("float32")
    e1.eval(PROMPT)
    f = str(tmp_path / "s.npz")
    session.save(f, e1, PROMPT)
    bad = str(tmp_path / "bad.npz")
    _rewrite(f, bad, **{field: value})
    e2 = port("float32")
    e2.eval([1, 2])
    before = e2.kv.clone()
    assert session.try_load(bad, e2, PROMPT + [7]) == PROMPT + [7]
    assert e2.n_past == 2 and torch.equal(e2.kv, before)


def test_a_missing_or_broken_file_returns_the_prompt(port, tmp_path):
    e = port("float32")
    assert session.try_load(str(tmp_path / "none.npz"), e, PROMPT) == PROMPT
    (tmp_path / "junk.npz").write_bytes(b"not a session")
    assert session.try_load(str(tmp_path / "junk.npz"), e, PROMPT) == PROMPT
    assert e.n_past == 0


def test_the_host_rng_and_mu_cross_packages(port, tmp_path, jax_engines):
    """rng_state (numpy's bit_generator.state) and mu load in both
    directions; the draws that follow are the same."""
    jeng = jax_engines["float32"]
    jeng.reset()
    jeng.eval(PROMPT)
    jst = jsampling.SamplerState.init(jsampling.SamplerParams(seed=21, mirostat=2))
    jst.rng.random(5)
    jst.mu = 3.25
    f = str(tmp_path / "j.npz")
    jsession.save(f, jeng, PROMPT, sampler_state=jst)
    teng = port("float32")
    st, gen, _ = session.load_sampler_state(f, sampling.SamplerParams(seed=3), teng)
    assert st.mu == 3.25
    assert st.rng.bit_generator.state == jst.rng.bit_generator.state
    np.testing.assert_array_equal(st.rng.random(4), jst.rng.random(4))

    st.mu = 1.5
    teng.eval(PROMPT)
    g = str(tmp_path / "t.npz")
    session.save(g, teng, PROMPT, sampler_state=st, generator=gen)
    jst2, key, _ = jsession.load_sampler_state(g, jsampling.SamplerParams(seed=3))
    assert key is None and jst2.mu == 1.5
    np.testing.assert_array_equal(jst2.rng.random(4), st.rng.random(4))


def test_a_jax_device_key_is_not_restored(port, tmp_path, jax_engines, capsys):
    import jax

    jeng = jax_engines["float32"]
    jeng.reset()
    jeng.eval(PROMPT)
    f = str(tmp_path / "j.npz")
    jsession.save(f, jeng, PROMPT, sampler_state=jsampling.SamplerState.init(
        jsampling.SamplerParams(seed=2)), rng_key=jax.random.PRNGKey(5))
    teng = port("float32")
    sampler = sampling.SamplerParams(seed=4)
    _, gen, _ = session.load_sampler_state(f, sampler, teng)
    assert torch.equal(gen.get_state(), teng.new_generator(sampler).get_state())
    assert "JAX device key" in capsys.readouterr().err


def test_a_torch_state_is_restored_only_on_its_device_type(port, tmp_path, capsys):
    teng = port("float32")
    teng.eval(PROMPT)
    sampler = sampling.SamplerParams(seed=4)
    gen = teng.new_generator(sampler)
    torch.rand(7, generator=gen)
    f = str(tmp_path / "t.npz")
    session.save(f, teng, PROMPT, sampler_state=sampling.SamplerState.init(sampler),
                 generator=gen)
    assert str(np.load(f)["rng_backend"]) == "torch:cpu"
    _, got, _ = session.load_sampler_state(f, sampler, port("float32"))
    assert torch.equal(got.get_state(), gen.get_state())
    assert capsys.readouterr().err == ""
    other = str(tmp_path / "cuda.npz")
    _rewrite(f, other, rng_backend="torch:cuda")
    _, got, _ = session.load_sampler_state(other, sampler, port("float32"))
    assert torch.equal(got.get_state(), teng.new_generator(sampler).get_state())
    assert "torch:cuda generator state" in capsys.readouterr().err


def test_a_sampled_continuation_after_save_and_load_equals_the_uninterrupted_run(port, tmp_path):
    """Run A: prompt -> 6 ids -> save -> 6 more; run B: load -> the same 6
    (the host state, mu and the device generator are restored)."""
    sampler = sampling.SamplerParams(temp=0.9, top_k=40, top_p=0.95, seed=7)
    f = str(tmp_path / "repro.npz")
    eA = port("float32")
    genA = Generator(eA, sampler, eos_id=-1)
    genA.generate(genA.prefill(PROMPT), 6, lambda t: True)
    session.save(f, eA, genA.all_tokens[:eA.n_past], sampler_state=genA.state,
                 generator=genA.rng)
    saved = list(genA.all_tokens)
    tailA = []
    genA.generate(genA.prefill([]), 6, lambda t: (tailA.append(t), True)[1])

    eB = port("float32")
    rest = session.try_load(f, eB, saved)
    assert rest == saved[-1:]
    genB = Generator(eB, sampler, eos_id=-1)
    genB.state, genB.rng, _ = session.load_sampler_state(f, sampler, eB)
    genB.all_tokens = saved[:len(saved) - len(rest)]
    tailB = []
    genB.generate(genB.prefill(rest), 6, lambda t: (tailB.append(t), True)[1])
    assert tailB == tailA and len(set(tailA)) > 1


# ------------------------------------------------------------------ the CLI

BASE = ["-c", "96", "-b", "32", "--kv-dtype", "float32", "--compute-dtype", "float32",
        "--decode-chunk", "4", "--device", "cpu"]


def _cli(path, capsysbinary, *extra):
    rc = cli.main(["-m", path, *BASE, *map(str, extra)])
    got = capsysbinary.readouterr()
    return rc, got.out, got.err.decode()


@pytest.mark.parametrize("temp", ["0", "0.8"])
def test_prompt_cache_twice_reuses_the_prompt(path, tmp_path, capsysbinary, temp):
    f = str(tmp_path / "s.session")
    args = ("-p", "the cat sat on the mat", "-n", "10", "--temp", temp, "--prompt-cache", f)
    rc1, out1, err1 = _cli(path, capsysbinary, *args)
    z = np.load(f)
    assert rc1 == 0 and "reused" not in err1 and int(z["n_past"]) == len(z["tokens"])
    assert str(z["rng_backend"]) == "torch:cpu"
    rc2, out2, err2 = _cli(path, capsysbinary, *args)
    assert rc2 == 0 and out2 == out1
    assert f"session: reused {int(z['n_past']) - 1} prompt tokens" in err2


def test_prompt_cache_ro_leaves_the_file_unchanged(path, tmp_path, capsysbinary):
    f = tmp_path / "ro.npz"
    _cli(path, capsysbinary, "-p", "the cat", "-n", "2", "--temp", "0", "--prompt-cache", f,
         "--prompt-cache-ro")
    assert not f.exists()
    _cli(path, capsysbinary, "-p", "the cat", "-n", "2", "--temp", "0", "--prompt-cache", f)
    before = f.read_bytes()
    rc, _, err = _cli(path, capsysbinary, "-p", "the cat sat on it", "-n", "6", "--temp", "0",
                      "--prompt-cache", f, "--prompt-cache-ro", "--prompt-cache-all")
    assert rc == 0 and "session: reused" in err and f.read_bytes() == before


def test_prompt_cache_all_stores_the_generated_ids(path, tmp_path, capsysbinary):
    f = str(tmp_path / "all.npz")
    _cli(path, capsysbinary, "-p", "the cat sat on", "-n", "6", "--temp", "0", "--ignore-eos",
         "--prompt-cache", f)
    n_prompt = int(np.load(f)["n_past"])
    rc, out, _ = _cli(path, capsysbinary, "-p", "the cat sat on", "-n", "6", "--temp", "0",
                      "--ignore-eos", "--prompt-cache", f, "--prompt-cache-all")
    z = np.load(f)
    # all but the last generated id are in the cache, and the file's tokens
    assert rc == 0 and int(z["n_past"]) == n_prompt + 5 == len(z["tokens"])
    from ggllm_tpu_torch import tokenizer as tok_mod
    from ggllm_tpu_torch.io.ggcc import read_model as tread_model

    tk = tok_mod.for_model(tread_model(path))
    text = b"".join(tk.piece(int(t)) for t in z["tokens"][n_prompt:])
    assert out.startswith(b"the cat sat on" + text)


def test_a_draft_with_prompt_cache_exits_1(path, tmp_path, capsysbinary):
    rc, _, err = _cli(path, capsysbinary, "-p", "the cat", "-n", "4", "--self-draft", "1",
                      "--prompt-cache", str(tmp_path / "x.npz"))
    assert rc == 1 and "speculative decoding supports plain generation only" in err
    assert not (tmp_path / "x.npz").exists()
