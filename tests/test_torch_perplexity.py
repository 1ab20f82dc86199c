"""The port's perplexity and embedding paths against the JAX package's, on
the CPU: engine.eval_logprobs (log-softmax and target gather on the
engine's device), engine/perplexity.py, engine.embed (the Falcon and LLaMA
output_hidden forward), tools/perplexity.py, tools/embedding.py and the
CLI's --perplexity / --embedding.

Tiny files of both families written by the JAX package go through both
engines at f32 compute (n_ctx 64, n_batch 16), on dense and int8 caches.
The JAX engines run as the JAX package's own tests run them on the CPU
(tests/test_perplexity.py, tests/test_session_embed.py: the default
config, whose quantized matmuls and attention take the plain XLA reference
of the Pallas kernels there); the port runs its kernels' plain versions.
Each JAX result is computed once a module. Tolerances, stated per test:
log-probs to 1e-4 (f32 cache) and 2e-3 (int8 cache: a code on the other
side of a rounding tie moves a logit by a quantization step's share),
perplexity to 1e-4 relative, embeddings to 1e-4 of max |h|."""

import re

import numpy as np
import pytest
import torch

from ggllm_tpu.core.config import EngineConfig, FalconHParams, LlamaHParams
from ggllm_tpu.core.dtypes import GGMLType
from ggllm_tpu.engine.engine import FalconEngine
from ggllm_tpu.engine.perplexity import perplexity as jperplexity
from ggllm_tpu.io.ggcc import read_model
from ggllm_tpu.io.loader import load_params
from ggllm_tpu.tools import main as jcli
from ggllm_tpu.utils import synthetic as jsynthetic

from ggllm_tpu_torch.core.config import EngineConfig as TEngineConfig
from ggllm_tpu_torch.engine.engine import FalconEngine as TFalconEngine
from ggllm_tpu_torch.engine.perplexity import perplexity
from ggllm_tpu_torch.io.loader import load_model as tload_model

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)

N_CTX, N_BATCH = 64, 16
_rng = np.random.default_rng(8)
IDS = [int(t) for t in _rng.integers(3, 500, 40)]  # three eval chunks: 16 + 16 + 8
PPL_IDS = [int(t) for t in _rng.integers(3, 500, 2 * N_CTX + 9)]  # two whole chunks
SHORT = IDS[:5]  # within one n_batch chunk
LONG = IDS[:32]  # 16 through eval, the last 16 through the output_hidden forward
TEXT = ("the thing and the other thing went south in there, and another one"
        " came out of it; the end of the story is in the south of it all. ") * 4


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ppl")
    falcon, llama = str(d / "falcon.ggcc"), str(d / "llama.ggjt")
    jsynthetic.write_tiny_model(falcon, FalconHParams.tiny(), ftype_2d=GGMLType.Q8_0, seed=12)
    jsynthetic.write_tiny_llama(llama, LlamaHParams.tiny(), ftype_2d=GGMLType.Q4_0, seed=21)
    (d / "text.txt").write_text(TEXT)
    return {"falcon": falcon, "llama": llama, "text": str(d / "text.txt")}


def _cfg(cls, kv_dtype):
    return cls(n_ctx=N_CTX, n_batch=N_BATCH, kv_dtype=kv_dtype, compute_dtype="float32")


@pytest.fixture(scope="module")
def ref(files):
    """ref(family, kv_dtype): the JAX engine's results, computed once."""
    cache = {}

    def get(family, kv_dtype):
        if (family, kv_dtype) not in cache:
            mf = read_model(files[family])
            cfg = _cfg(EngineConfig, kv_dtype)
            eng = FalconEngine(mf.hparams, load_params(mf, cfg), cfg)
            out = {"lp": eng.eval_logprobs(IDS), "n_past": eng.n_past}
            if kv_dtype == "float32":
                out["ppl"] = jperplexity(eng, PPL_IDS)
                for name, ids in (("short", SHORT), ("long", LONG)):
                    eng.reset()
                    out[name] = eng.embed(ids)
            cache[family, kv_dtype] = out
        return cache[family, kv_dtype]

    return get


def _engine(files, family, kv_dtype):
    tmf, params = tload_model(files[family], _cfg(TEngineConfig, kv_dtype), device="cpu")
    return TFalconEngine(tmf.hparams, params, _cfg(TEngineConfig, kv_dtype), device="cpu")


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("family", ["falcon", "llama"])
def test_eval_logprobs_matches_jax(files, ref, family, kv_dtype):
    """40 ids in chunks of 16, 16 and 8: one log-prob a position (39), each
    the JAX engine's to 1e-4 on an f32 cache and 2e-3 on an int8 one; n_past
    advances by the ids, and the prefill timings book them."""
    r = ref(family, kv_dtype)
    eng = _engine(files, family, kv_dtype)
    lp = eng.eval_logprobs(IDS)
    assert lp.shape == r["lp"].shape == (len(IDS) - 1,) and lp.dtype == np.float32
    assert np.all(lp <= 0) and np.isfinite(lp).all()
    np.testing.assert_allclose(lp, r["lp"], rtol=0, atol=1e-4 if kv_dtype == "float32" else 2e-3)
    assert eng.n_past == r["n_past"] == len(IDS)
    assert eng.timings.n_prefill == len(IDS) and eng.timings.t_prefill_us > 0


@pytest.mark.parametrize("family", ["falcon", "llama"])
def test_eval_logprobs_is_the_log_softmax_of_eval(files, family):
    """On the port alone: the device gather equals the host log-softmax of
    eval's logits of every position, to 1e-5."""
    eng = _engine(files, family, "float32")
    lp = eng.eval_logprobs(IDS)
    eng.reset()
    logits = eng.eval(IDS, logits_all=True).astype(np.float64)
    m = logits.max(-1, keepdims=True)
    lsm = logits - m - np.log(np.exp(logits - m).sum(-1, keepdims=True))
    np.testing.assert_allclose(lp, lsm[np.arange(len(IDS) - 1), IDS[1:]], rtol=0, atol=1e-5)


@pytest.mark.parametrize("family", ["falcon", "llama"])
def test_perplexity_matches_jax(files, ref, family):
    """Two chunks of n_ctx 64 (the 9 ids past them unused), NLL over
    positions [32, 63) of each: perplexity, NLL and the running value after
    each chunk within 1e-4 relative of the JAX package's; count and chunks
    equal."""
    r = ref(family, "float32")["ppl"]
    res = perplexity(_engine(files, family, "float32"), PPL_IDS)
    assert (res.n_chunks, res.count) == (r.n_chunks, r.count) == (2, 2 * (N_CTX - 1 - N_CTX // 2))
    np.testing.assert_allclose([res.ppl, res.nll], [r.ppl, r.nll], rtol=1e-4)
    np.testing.assert_allclose(res.per_chunk, r.per_chunk, rtol=1e-4)
    assert 1 < res.ppl < 10 * 512  # a random model over a 512-token vocabulary
    with pytest.raises(ValueError, match="at least n_ctx"):
        perplexity(_engine(files, family, "float32"), PPL_IDS[:N_CTX - 1])


@pytest.mark.parametrize("family", ["falcon", "llama"])
def test_embed_matches_jax(files, ref, family):
    """The final normed hidden state of the last token, f32 (n_embd,), to
    1e-4 of max |h|: a 5-token prompt, and a 32-token one (longer than
    n_batch: 16 through eval, 16 through the output_hidden forward); n_past
    advances by the prompt."""
    r = ref(family, "float32")
    eng = _engine(files, family, "float32")
    for name, ids in (("short", SHORT), ("long", LONG)):
        eng.reset()
        got = eng.embed(ids)
        assert got.shape == r[name].shape == (eng.hp.n_embd,) and got.dtype == np.float32
        scale = np.abs(r[name]).max()
        np.testing.assert_allclose(got / scale, r[name] / scale, rtol=0, atol=1e-4)
        assert eng.n_past == len(ids)


def test_falcon_output_hidden_gives_the_logits(files):
    """Falcon.forward(output_hidden=True) is the state whose lm_head product
    is the logits (the LLaMA module's contract, tests/test_torch_llama.py),
    at last_pos too."""
    import torch

    from ggllm_tpu_torch.ops.linear import linear

    eng = _engine(files, "falcon", "float32")
    toks = torch.tensor([SHORT])
    with torch.inference_mode():
        at2 = eng.model(toks, eng.new_kv(), 0, eng.inv_freq, last_pos=2)
        hid = eng.model(toks, eng.new_kv(), 0, eng.inv_freq, last_pos=2, output_hidden=True)
    assert hid.shape == (1, 1, eng.hp.n_embd) and hid.dtype == torch.float32
    assert torch.equal(linear(eng.model.lm_head, hid, torch.float32, kernels=False), at2)


def _floats(text: str) -> np.ndarray:
    return np.array([float(v) for v in re.findall(r"-?\d+\.\d+", text)])


@pytest.fixture(scope="module")
def jax_cli(files):
    """The JAX CLI's --perplexity and --embedding output on the Falcon file
    (the embedding also on a bf16 cache, which the embedding tool keeps)."""
    import contextlib
    import io
    import os

    base = ["-m", files["falcon"], "-c", str(N_CTX), "-b", str(N_BATCH), "--kv-dtype", "float32",
            "--compute-dtype", "float32"]
    out = {}
    saved = os.environ.get("GGLLM_COMPILE_CACHE")
    os.environ["GGLLM_COMPILE_CACHE"] = ""
    try:
        for mode, extra in (("ppl", ["--perplexity", "-f", files["text"]]),
                            ("emb", ["--embedding", "-p", "the thing"]),
                            ("emb_bf16", ["--embedding", "-p", "the thing", "--kv-dtype",
                                          "bfloat16"])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
                assert jcli.main(base + extra) == 0
            out[mode] = buf.getvalue()
    finally:
        if saved is None:
            os.environ.pop("GGLLM_COMPILE_CACHE")
        else:
            os.environ["GGLLM_COMPILE_CACHE"] = saved
    return base, out


def test_cli_perplexity_and_embedding_match_jax_cli(files, jax_cli, capsys):
    """--perplexity -f FILE and --embedding -p: the same lines as the JAX
    CLI's, numbers to 1e-4 relative (perplexity) and 1e-4 of max |h|
    (embedding, printed to 6 decimals)."""
    from ggllm_tpu_torch.tools import main as cli

    base, ref = jax_cli
    assert cli.main(base + ["--perplexity", "-f", files["text"], "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert re.fullmatch(r"perplexity: \d+\.\d{4} \[\d+ chunks, \d+ tokens\]\n", got)
    assert got.split("[")[1] == ref["ppl"].split("[")[1]
    np.testing.assert_allclose(_floats(got)[:1], _floats(ref["ppl"])[:1], rtol=1e-4)
    assert cli.main(base + ["--embedding", "-p", "the thing", "--device", "cpu"]) == 0
    got, want = _floats(capsys.readouterr().out), _floats(ref["emb"])
    assert got.shape == want.shape == (FalconHParams.tiny().n_embd,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max() + 1e-6)


def test_tools_print_what_the_cli_prints(files, jax_cli, capsys):
    """tools/perplexity.py and tools/embedding.py (the JAX tools' flags)
    print the JAX CLI's numbers, to the tolerances above; --weight-mode
    dequant (the plain dequantize-then-matmul weights) too. The embedding
    tool has no --kv-dtype: its bf16 cache is held to the JAX CLI's."""
    from ggllm_tpu_torch.tools import embedding, perplexity as ppl_tool

    _, ref = jax_cli
    common = ["-m", files["falcon"], "-c", str(N_CTX), "--compute-dtype", "float32",
              "--device", "cpu"]
    for mode in ("fused", "dequant"):
        assert ppl_tool.main(common + ["-f", files["text"], "-b", str(N_BATCH), "--kv-dtype",
                                       "float32", "--weight-mode", mode]) == 0
        got = capsys.readouterr().out.splitlines()[-1]
        assert got.split("[")[1] == ref["ppl"].strip().split("[")[1]
        np.testing.assert_allclose(_floats(got)[:1], _floats(ref["ppl"])[:1], rtol=1e-4)
    assert embedding.main(common + ["-p", "the thing"]) == 0
    got, want = _floats(capsys.readouterr().out), _floats(ref["emb_bf16"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max() + 1e-6)
