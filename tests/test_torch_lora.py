"""LoRA adapters on the port (ggllm_tpu_torch/io/lora.py and the loader's
hook, io/loader.py load_params(lora=, lora_base=)) against the JAX package's
(ggllm_tpu/io/lora.py, io/loader.py:50-61, 391-470), on the CPU in f32.

Tiny files written by the JAX package: Falcon-7B-shaped (Q8_0 and Q4_0, and
an f32 file of the same weights as the --lora-base), Falcon-40B-shaped
(Q8_0) and LLaMA (Q4_0). 'ggla' bytes are equal both ways. The port's
patched tree equals the JAX loader's (read through from_jax_params) to 1e-6
of max |w|: the patched keys dense in every layer, the others QuantTensors,
"wqkvu" split into a dense "wqkv" and a quantized "ffn_up" when only
query_key_value is patched; --lora-base reads the bases from the f32 file;
the missing-base error and the quantized-patch warning are the JAX loader's.
Greedy ids of the patched models equal the JAX engine's exactly: the single
stream, the batcher at B = 2 and speculative rounds with a one-layer
self-draft. An adapter tensor the model lacks is an error naming it (the
JAX loader ignores it). The CLI and both servers with --lora / --lora-base
give the JAX CLI's and the JAX servers' greedy text."""

import dataclasses
import json
import threading
import urllib.request
import warnings

import jax
import numpy as np
import pytest
import torch

from ggllm_tpu.core.config import EngineConfig, FalconHParams, LlamaHParams
from ggllm_tpu.core.dtypes import GGMLType
from ggllm_tpu.engine.engine import FalconEngine as JEngine
from ggllm_tpu.io import lora as jlora
from ggllm_tpu.io.ggcc import read_model
from ggllm_tpu.io.loader import load_params as jload_params
from ggllm_tpu.ops.sampling import SamplerParams as JSamplerParams
from ggllm_tpu.server import app as japp
from ggllm_tpu.tools import main as jcli
from ggllm_tpu.utils.synthetic import write_tiny_llama, write_tiny_model

from ggllm_tpu_torch.core.config import EngineConfig as TEngineConfig
from ggllm_tpu_torch.engine.batching import ContinuousBatcher, Request
from ggllm_tpu_torch.engine.engine import FalconEngine
from ggllm_tpu_torch.engine.speculative import SpeculativeDecoder, truncate_params
from ggllm_tpu_torch.io import lora
from ggllm_tpu_torch.io.ggcc import read_model as tread_model
from ggllm_tpu_torch.io.loader import from_jax_params, load_model
from ggllm_tpu_torch.ops.linear import QuantTensor
from ggllm_tpu_torch.ops.sampling import SamplerParams
from ggllm_tpu_torch.server import app
from ggllm_tpu_torch.tools import main as cli

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)

PROMPTS = ([5, 9, 2, 14, 3], [7, 300, 41])
N = 16
QKV = "transformer.h.{}.self_attention.query_key_value.weight"
FALCON_KEYS = {"qkv": QKV, "wo": "transformer.h.{}.self_attention.dense.weight",
               "ffn_up": "transformer.h.{}.mlp.dense_h_to_4h.weight",
               "ffn_down": "transformer.h.{}.mlp.dense_4h_to_h.weight"}
LLAMA_KEYS = {k: f"layers.{{}}.{v}.weight" for k, v in (
    ("wq", "attention.wq"), ("wk", "attention.wk"), ("wv", "attention.wv"),
    ("wo", "attention.wo"), ("w1", "feed_forward.w1"), ("w2", "feed_forward.w2"),
    ("w3", "feed_forward.w3"))}
# model -> (writer, hparams, format, seed)
MODELS = {"7b_q8": (write_tiny_model, FalconHParams.tiny, GGMLType.Q8_0, 3),
          "7b_q4": (write_tiny_model, FalconHParams.tiny, GGMLType.Q4_0, 3),
          "7b_f32": (write_tiny_model, FalconHParams.tiny, GGMLType.F32, 3),
          "40b": (write_tiny_model, FalconHParams.tiny_gqa, GGMLType.Q8_0, 4),
          "llama": (write_tiny_llama, LlamaHParams.tiny, GGMLType.Q4_0, 7)}
# adapter -> (model, tensor names): query_key_value alone, all four Falcon
# keys, two keys patched in one layer each (a key patched in any layer is
# dense in every layer), every LLaMA matrix and output.weight
ADAPTERS = {
    "7b_q8_qkv": ("7b_q8", [QKV.format(i) for i in range(2)]),
    "7b_q8_all": ("7b_q8", [k.format(i) for k in FALCON_KEYS.values() for i in range(2)]),
    "7b_q4_qkv": ("7b_q4", [QKV.format(i) for i in range(2)]),
    "7b_q4_all": ("7b_q4", [k.format(i) for k in FALCON_KEYS.values() for i in range(2)]),
    "40b": ("40b", [QKV.format(0), FALCON_KEYS["ffn_down"].format(1)]),
    "llama": ("llama", [k.format(i) for k in LLAMA_KEYS.values() for i in range(2)]
              + ["output.weight"]),
}


def _write_adapter(path, model_path, names, r=4, alpha=8, seed=0, f16_b=False):
    """A ggla adapter on `names` (written by the JAX writer) whose delta is
    of the weights' own size: A ~ 1/sqrt(in), B ~ 0.3/sqrt(r), scaling 2."""
    mf = tread_model(model_path)
    rng = np.random.default_rng(seed)
    tensors = {}
    for name in names:
        out, cols = mf.tensors[name].shape
        a = (rng.standard_normal((r, cols)) / np.sqrt(cols)).astype(np.float32)
        b = (rng.standard_normal((out, r)) * 0.3 / np.sqrt(r)).astype(np.float32)
        tensors[name] = {"loraA": a, "loraB": b.astype(np.float16) if f16_b else b}
    jlora.write_lora(path, r, alpha, tensors)
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("lora")
    out = {}
    for name, (write, hp, fmt, seed) in MODELS.items():
        out[name] = str(d / f"{name}.bin")
        write(out[name], hp(), ftype_2d=fmt, seed=seed)
    for name, (model, names) in ADAPTERS.items():
        out[name + ".ggla"] = _write_adapter(str(d / f"{name}.ggla"), out[model], names,
                                             seed=len(name), f16_b=name == "7b_q8_qkv")
    return out


def _jcfg():
    return EngineConfig(n_ctx=96, n_batch=32, kv_dtype="float32", compute_dtype="float32",
                        kernel_layout=False)


def _tcfg():
    return TEngineConfig(n_ctx=96, n_batch=32, kv_dtype="float32", compute_dtype="float32")


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return fn(*a, **kw)


def _jax_params(files, adapter, lora_base=None):
    model = ADAPTERS[adapter][0]
    return _quiet(jload_params, read_model(files[model]), _jcfg(), lora=files[adapter + ".ggla"],
                  lora_base=lora_base)


def _port(files, adapter, batch_size=1, **kw):
    model = ADAPTERS[adapter][0]
    mf, params = _quiet(load_model, files[model], _tcfg(), device="cpu",
                        lora=files[adapter + ".ggla"], **kw)
    return mf, params, FalconEngine(mf.hparams, params, _tcfg(), device="cpu",
                                    batch_size=batch_size)


@pytest.fixture(scope="module")
def jax_greedy(files):
    """The JAX engines' greedy ids of PROMPTS on the patched models."""
    out = {}
    for adapter in ("7b_q8_qkv", "40b", "llama"):
        mf = read_model(files[ADAPTERS[adapter][0]])
        eng = JEngine(mf.hparams, _jax_params(files, adapter), _jcfg())
        for p in PROMPTS:
            eng.reset()
            out[adapter, tuple(p)] = [int(t) for t in eng.generate(
                p, N, JSamplerParams(temp=0.0, repeat_penalty=1.0), stop_ids=set())]
    return out


def test_ggla_bytes_match_jax(tmp_path):
    """The port writes the JAX writer's bytes (A transposed, ggml dim order,
    32-byte padding; f32 and f16 pairs), and each reads the other's file to
    the same arrays, r, alpha and delta."""
    rng = np.random.default_rng(1)
    tensors = {"a.weight": {"loraA": rng.standard_normal((4, 96)).astype(np.float32),
                            "loraB": rng.standard_normal((40, 4)).astype(np.float16)},
               "b.weight": {"loraA": rng.standard_normal((4, 33)).astype(np.float16),
                            "loraB": rng.standard_normal((7, 4)).astype(np.float32)}}
    ours, theirs = str(tmp_path / "port.ggla"), str(tmp_path / "jax.ggla")
    lora.write_lora(ours, 4, 12, tensors)
    jlora.write_lora(theirs, 4, 12, tensors)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    for got, ref in ((lora.read_lora(theirs), jlora.read_lora(ours)),
                     (lora.read_lora(ours), jlora.read_lora(theirs))):
        assert (got.r, got.alpha, got.scaling) == (ref.r, ref.alpha, ref.scaling) == (4, 12, 3.0)
        for name, ab in ref.tensors.items():
            for k in ("loraA", "loraB"):
                assert got.tensors[name][k].dtype == ab[k].dtype
                np.testing.assert_array_equal(got.tensors[name][k], ab[k])
            np.testing.assert_array_equal(got.delta(name), ref.delta(name))
            assert got.shape(name) == ref.delta(name).shape
    with pytest.raises(ValueError, match="delta shape"):
        lora.apply_to_tensor(torch.zeros(7, 34), lora.read_lora(ours), "b.weight")


def _assert_tree(own: dict, ref: dict, dense_keys: set, merged: str | None):
    """own == ref (from_jax_params of the JAX tree): dense leaves to 1e-6 of
    max |w|, QuantTensors plane for plane; the keys of dense_keys dense in
    every layer, the other matrices QuantTensors; `merged` ("wqkvu" or
    None) absent when dense_keys split it."""
    for a, b in zip([own, *own["layers"]], [ref, *ref["layers"]]):
        assert a.keys() == b.keys()
        for key, w in a.items():
            if key == "layers":
                continue
            if isinstance(w, QuantTensor):
                assert key not in dense_keys and w.gtype == b[key].gtype, key
                for name, plane in w.planes.items():
                    assert torch.equal(plane, b[key].planes[name]), (key, name)
            else:
                assert not isinstance(b[key], QuantTensor), key
                scale = float(b[key].abs().max())
                assert float((w - b[key]).abs().max()) <= 1e-6 * scale, key
    for lw in own["layers"]:
        assert all(not isinstance(lw[k], QuantTensor) for k in dense_keys)
        if merged:
            assert merged not in lw


@pytest.mark.parametrize("adapter", list(ADAPTERS))
def test_patched_tree_matches_jax(files, adapter):
    """The port's patched tree equals the JAX loader's (lora=, planar tree,
    through from_jax_params) to 1e-6 of max |w|, patched keys dense in every
    layer, unpatched ones quantized as the file holds them."""
    ref = from_jax_params(jax.tree.map(np.asarray, _jax_params(files, adapter)),
                          torch.float32, device="cpu")
    _, own, _ = _port(files, adapter)
    llama = adapter == "llama"
    if llama:
        dense = {"wqkv", "w13", "wo", "w2"}
        assert not isinstance(own["lm_head"], QuantTensor)
    elif adapter.endswith("_qkv"):
        dense = {"wqkv"}
        assert isinstance(own["layers"][0]["ffn_up"], QuantTensor)
        assert isinstance(own["layers"][1]["w_od"], QuantTensor)
    elif adapter == "40b":  # qkv in layer 0, ffn_down in layer 1: both in both
        dense = {"wqkv", "ffn_down"}
        assert isinstance(own["layers"][0]["wo"], QuantTensor)
    else:
        dense = {"wqkvu", "w_od"}
    _assert_tree(own, ref, dense, None if llama or adapter.endswith("_all") else "wqkvu")
    if adapter == "7b_q8_qkv":  # the delta is there: the patch moved the weight
        _, plain = load_model(files["7b_q8"], _tcfg(), device="cpu")
        base = plain["layers"][0]["wqkvu"].dequantize()[:own["layers"][0]["wqkv"].shape[0]]
        assert float((own["layers"][0]["wqkv"] - base).abs().max()) > 0.1 * float(base.abs().max())


def test_lora_base_matches_jax(files, tmp_path):
    """--lora-base: the bases of the patched weights come from the f32 file
    (the same weights unquantized), as the JAX loader takes them; without a
    base a quantized patch warns with the JAX loader's words, and a base
    that lacks a patched tensor raises its error."""
    base = files["7b_f32"]
    ref = from_jax_params(jax.tree.map(np.asarray, _jax_params(files, "7b_q4_qkv", base)),
                          torch.float32, device="cpu")
    _, own, _ = _port(files, "7b_q4_qkv", lora_base=base)
    _assert_tree(own, ref, {"wqkv"}, "wqkvu")
    _, no_base, _ = _port(files, "7b_q4_qkv")
    assert not torch.equal(own["layers"][0]["wqkv"], no_base["layers"][0]["wqkv"])

    mf, adapter = read_model(files["7b_q4"]), files["7b_q4_qkv.ggla"]
    with pytest.warns(UserWarning) as jw:
        jload_params(mf, _jcfg(), lora=adapter)
    with pytest.warns(UserWarning) as tw:
        load_model(files["7b_q4"], _tcfg(), device="cpu", lora=adapter)
    said = [[str(w.message) for w in ws if "LoRA" in str(w.message)] for ws in (tw, jw)]
    assert said[0] == said[1] and len(said[0]) == 1 and "--lora-base" in said[0][0]
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # an f32 model's patch does not warn
        load_model(base, _tcfg(), device="cpu", lora=adapter)

    other = str(tmp_path / "llama_base.bin")  # a base without the Falcon names
    write_tiny_llama(other, LlamaHParams.tiny(), ftype_2d=GGMLType.F32, seed=1)
    with pytest.raises(ValueError) as je:
        jload_params(mf, _jcfg(), lora=adapter, lora_base=other)
    with pytest.raises(ValueError) as te:
        load_model(files["7b_q4"], _tcfg(), device="cpu", lora=adapter, lora_base=other)
    assert str(te.value) == str(je.value) and "missing LoRA-patched" in str(te.value)


@pytest.mark.parametrize("adapter", ["7b_q8_qkv", "40b", "llama"])
def test_greedy_ids_match_jax(files, jax_greedy, adapter):
    """The patched models' greedy ids equal the JAX engine's on the single
    stream, the batcher at B = 2 and speculative rounds with a one-layer
    self-draft (the patched weights shared)."""
    mf, params, eng = _port(files, adapter)
    greedy = SamplerParams(temp=0.0, repeat_penalty=1.0)
    for p in PROMPTS:
        eng.reset()
        assert eng.generate(p, N, greedy, stop_ids=set()) == jax_greedy[adapter, tuple(p)], p
    _, _, rows = _port(files, adapter, batch_size=2)
    cb = ContinuousBatcher(rows, chunk=4)
    reqs = [cb.submit(Request(list(p), n_predict=N)) for p in PROMPTS]
    cb.run()
    assert [r.out for r in reqs] == [jax_greedy[adapter, tuple(p)] for p in PROMPTS]
    eng.reset()
    draft = FalconEngine(dataclasses.replace(mf.hparams, n_layer=1), truncate_params(params, 1),
                         _tcfg(), device="cpu")
    spec = SpeculativeDecoder(eng, draft, k=3, rounds_per_dispatch=2)
    assert spec.generate(PROMPTS[0], N, greedy) == jax_greedy[adapter, tuple(PROMPTS[0])]
    assert spec.stats.n_rounds > 0


def test_an_adapter_tensor_the_model_lacks_is_an_error(files, tmp_path):
    """The JAX loader ignores adapter tensors the model has no matrix for
    (its load is a silent no-op for them); the port raises and names them:
    a misspelt name, a LLaMA name on a Falcon model, a norm vector."""
    for name in ("transformer.h.0.self_attn.query_key_value.weight",
                 "layers.0.attention.wq.weight", "transformer.h.1.input_layernorm.weight"):
        path = str(tmp_path / "bad.ggla")
        lora.write_lora(path, 2, 2, {name: {"loraA": np.ones((2, 128), np.float32),
                                            "loraB": np.ones((128, 2), np.float32)}})
        with pytest.raises(ValueError, match="not weight matrices") as e:
            load_model(files["7b_q8"], _tcfg(), device="cpu", lora=path)
        assert name in str(e.value)
    wrong = str(tmp_path / "wrong_shape.ggla")
    lora.write_lora(wrong, 2, 2, {QKV.format(0): {"loraA": np.ones((2, 64), np.float32),
                                                  "loraB": np.ones((192, 2), np.float32)}})
    with pytest.raises(ValueError, match="delta shape"):
        _quiet(load_model, files["7b_q8"], _tcfg(), device="cpu", lora=wrong)


CLI_BASE = ["-c", "96", "-b", "32", "--kv-dtype", "float32", "--compute-dtype", "float32",
            "--temp", "0", "--ignore-eos", "--decode-chunk", "4", "-p", "the thing", "-n", "14"]


@pytest.mark.parametrize("flags", [("--lora", "7b_q4_qkv"),
                                   ("--lora", "7b_q4_qkv", "--lora-base", "7b_f32"),
                                   ("--lora", "llama")], ids=["lora", "lora_base", "llama"])
def test_cli_lora_matches_the_jax_cli(files, capsysbinary, monkeypatch, flags):
    """--lora (and --lora-base) through both CLIs: the same text, which is
    not the unpatched model's."""
    monkeypatch.setenv("GGLLM_COMPILE_CACHE", "")
    model = files[ADAPTERS[flags[1]][0]]
    args = [files[f + ".ggla"] if i == 1 else files[f] if i == 3 else f
            for i, f in enumerate(flags)]
    assert _quiet(cli.main, ["-m", model, *CLI_BASE, "--device", "cpu", *args]) == 0
    got = capsysbinary.readouterr().out
    _quiet(jcli.main, ["-m", model, *CLI_BASE, *args])
    assert capsysbinary.readouterr().out == got
    assert cli.main(["-m", model, *CLI_BASE, "--device", "cpu"]) == 0
    assert capsysbinary.readouterr().out != got


def test_cli_self_draft_shares_the_patched_weights(files, capsysbinary):
    """--self-draft 1 with --lora prints the text of --lora alone; a
    --draft-model loads without the adapter (a LLaMA draft, which has none
    of the Falcon adapter's tensors and would refuse it)."""
    model, adapter = files["7b_q8"], files["7b_q8_qkv.ggla"]
    base = ["-m", model, *CLI_BASE, "--device", "cpu", "--lora", adapter, "--repeat-penalty",
            "1"]
    assert _quiet(cli.main, base) == 0
    plain = capsysbinary.readouterr().out
    assert _quiet(cli.main, [*base, "--self-draft", "1", "--draft-k", "3"]) == 0
    out = capsysbinary.readouterr()
    assert out.out == plain and b"self-draft" in out.err
    assert _quiet(cli.main, [*base, "--draft-model", files["llama"], "--draft-k", "3"]) == 0
    assert capsysbinary.readouterr().out == plain


def _post(url, body):
    req = urllib.request.Request(url + "/completion", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _served(httpd, bodies, shutdown=None):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        return [_post(url, b) for b in bodies]
    finally:
        if shutdown:
            shutdown()
        httpd.shutdown()
        httpd.server_close()


BODIES = [{"prompt": p, "n_predict": 12, "temperature": 0, "repeat_penalty": 1.0,
           "ignore_eos": True} for p in ("the thing", "in another", "the thing and more")]


@pytest.mark.parametrize("parallel", [1, 2], ids=["single", "parallel"])
def test_servers_lora_match_the_jax_servers(files, parallel):
    """The port's server main() load (load_engine) with --lora and
    --lora-base, single stream and --parallel 2, answers the JAX server's
    content, the JAX server loading as its main() does
    (load_model(lora=, lora_base=))."""
    from ggllm_tpu.io.loader import load_model as jload_model

    model, adapter, base = files["7b_q4"], files["7b_q4_qkv.ggla"], files["7b_f32"]
    args = app.build_parser().parse_args(
        ["-m", model, "--lora", adapter, "--lora-base", base, "-c", "96", "-b", "32",
         "--kv-dtype", "float32", "--compute-dtype", "float32", "--device", "cpu",
         "-np", str(parallel)])
    mf, _, _, eng = app.load_engine(args)
    got = _served(app.serve(eng, mf.vocab, port=0, parallel=parallel, chunk=4), BODIES)
    jmf, jparams = jload_model(model, _jcfg(), lora=adapter, lora_base=base)
    jhttpd = japp.serve(JEngine(jmf.hparams, jparams, _jcfg(), batch_size=parallel), jmf.vocab,
                        port=0, parallel=parallel, chunk=4)
    ref = _served(jhttpd, BODIES, jhttpd.state.shutdown if parallel > 1 else None)
    for g, r in zip(got, ref):
        assert (g["content"], g["tokens_predicted"]) == (r["content"], r["tokens_predicted"])
