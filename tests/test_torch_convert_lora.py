"""The port's PEFT converter (ggllm_tpu_torch/io/convert_lora.py) on
grouped-query Falcon and LLaMA adapters, on the CPU in f32.

The JAX converter writes such adapters' lora_B rows in HF's order, so it is
no reference here. Instead the adapter is merged into the HF weights in
numpy (W + alpha / r * B @ A), the merged checkpoint is converted, and its
greedy ids and logits are held against the base checkpoint converted and
loaded with the converted adapter (--lora, io/lora.py): the ids equal, the
logits within 1e-5 of max |logit|. A control converts the same adapter as if
its rows needed no reordering, which must fail the comparison. An adapter
whose rows need the base's head counts exits 1 without one."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from ggllm_tpu_torch.core.config import EngineConfig, FalconHParams, LlamaHParams  # noqa: E402
from ggllm_tpu_torch.engine.engine import FalconEngine  # noqa: E402
from ggllm_tpu_torch.io import convert_hf, convert_hf_llama, convert_lora, safetensors  # noqa: E402
from ggllm_tpu_torch.io.loader import load_model  # noqa: E402
from ggllm_tpu_torch.ops.sampling import SamplerParams  # noqa: E402
from ggllm_tpu_torch.utils import synthetic  # noqa: E402

torch.set_num_threads(1)

R, ALPHA = 4, 8
PROMPT = [5, 17, 130, 42, 99, 260]


def _quiet(*a, **kw):
    pass


def _targets(hp) -> dict[str, tuple[int, int]]:
    """HF names -> (out, in) of the matrices the adapter patches: every
    attention projection and one FFN matrix in every layer."""
    E = hp.n_embd
    if hp.arch == "llama":
        return {f"model.layers.{i}.{k}.weight": shape for i in range(hp.n_layer)
                for k, shape in (("self_attn.q_proj", (E, E)), ("self_attn.k_proj", (E, E)),
                                 ("self_attn.v_proj", (E, E)), ("mlp.down_proj", (E, hp.n_ff)))}
    n_qkv = (hp.n_head + 2 * hp.n_head_kv) * hp.head_dim
    return {f"transformer.h.{i}.{k}.weight": shape for i in range(hp.n_layer)
            for k, shape in (("self_attention.query_key_value", (n_qkv, E)),
                             ("mlp.dense_4h_to_h", (E, hp.n_ff)))}


def _spread(name, shape):
    # lora_B of real adapters starts at zero; a visible delta needs a spread
    return 0.5 / np.sqrt(shape[-1]) if "lora_B" in name else 1.0 / np.sqrt(shape[-1])


@pytest.fixture(scope="module", params=["falcon_gqa", "llama"])
def case(request, tmp_path_factory):
    """(base file, adapter dir, merged file, HF base dir) of one family."""
    d = tmp_path_factory.mktemp(request.param)
    if request.param == "llama":
        hp, conv = LlamaHParams(n_vocab=512, n_embd=128, n_mult=64, n_head=4, n_layer=2,
                                n_rot=32), convert_hf_llama.convert
    else:
        hp, conv = FalconHParams.tiny_gqa(), convert_hf.convert
    synthetic.write_hf_model(d / "hf", hp, seed=5, dtype="F32")
    rng = np.random.default_rng(9)
    draw_ad = (lambda name, shape: (rng.standard_normal(shape) * _spread(name, shape))
               .astype(np.float32))
    synthetic.write_peft_adapter(d / "peft", _targets(hp), r=R, alpha=ALPHA, draw=draw_ad,
                                 dtype="F32")
    base = safetensors.load_file(d / "hf" / "model.safetensors")
    ad = safetensors.load_file(d / "peft" / "adapter_model.safetensors")
    merged = dict(base)
    for name in _targets(hp):
        p = "base_model.model." + name.removesuffix(".weight")
        merged[name] = (base[name] + np.float32(ALPHA / R) * (ad[p + ".lora_B.weight"]
                                                              @ ad[p + ".lora_A.weight"]))
    synthetic.write_hf_model(d / "merged", hp, dtype="F32",
                             draw=lambda name, shape: merged[name].reshape(shape))
    conv(str(d / "hf"), str(d / "base.bin"), "f32", log=_quiet)
    conv(str(d / "merged"), str(d / "merged.bin"), "f32", log=_quiet)
    return hp, d


def _run(path, lora=None):
    cfg = EngineConfig(n_ctx=64, n_batch=16, kv_dtype="float32", compute_dtype="float32")
    mf, params = load_model(str(path), cfg, device="cpu", lora=lora)
    eng = FalconEngine(mf.hparams, params, cfg, device="cpu")
    logits = eng.eval(PROMPT)
    ids = eng.generate(PROMPT, 8, SamplerParams(temp=0.0, repeat_penalty=1.0))
    return logits, ids


@pytest.mark.parametrize("base_as", ["config", "dir", "model"])
def test_adapter_with_base_gives_the_merged_model(case, tmp_path, base_as):
    """The adapter converted with base= (config.json, the HF directory, or
    the converted file) and loaded with lora= gives the numpy-merged model's
    logits and greedy ids."""
    hp, d = case
    base = {"config": d / "hf" / "config.json", "dir": d / "hf", "model": d / "base.bin"}[base_as]
    ggla = convert_lora.convert(str(d / "peft"), str(tmp_path / "a.ggla"), base=str(base))
    ref_logits, ref_ids = _run(d / "merged.bin")
    got_logits, got_ids = _run(d / "base.bin", lora=ggla)
    scale = np.abs(ref_logits).max()
    np.testing.assert_allclose(got_logits / scale, ref_logits / scale, atol=1e-5)
    assert got_ids == ref_ids
    base_logits, _ = _run(d / "base.bin")  # the adapter moves the logits
    assert np.abs(base_logits - ref_logits).max() / scale > 1e-2


def test_rows_in_hf_order_are_wrong(case, tmp_path, monkeypatch):
    """Control: the same adapter written with its lora_B rows in HF's order
    (the JAX converter's output) misses the merged model's logits."""
    hp, d = case
    monkeypatch.setattr(convert_lora, "deinterleave_qkv", lambda b, *a: b)
    monkeypatch.setattr(convert_lora, "permute_rope", lambda b, *a: b)
    ggla = convert_lora.convert(str(d / "peft"), str(tmp_path / "a.ggla"),
                                base=str(d / "hf"))
    ref_logits, _ = _run(d / "merged.bin")
    got_logits, _ = _run(d / "base.bin", lora=ggla)
    assert np.abs(got_logits - ref_logits).max() / np.abs(ref_logits).max() > 1e-3


def test_reordered_adapter_without_base_exits_1(case, tmp_path, capsys):
    """An adapter whose lora_B rows need the base's head counts exits 1
    without a base, naming the tensor and the reorder, and writes nothing;
    with --base on the command line it converts."""
    hp, d = case
    out = tmp_path / "out.ggla"
    assert convert_lora.main([str(d / "peft"), str(out)]) == 1
    err = capsys.readouterr().err
    want = "permute_rope" if hp.arch == "llama" else "deinterleave_qkv"
    assert want in err and "base" in err and not out.exists()
    assert convert_lora.main([str(d / "peft"), str(out), "--base", str(d / "hf")]) == 0
    assert out.exists()


def test_names_map_to_the_converted_model(case, tmp_path):
    """The adapter's tensors carry the converted model's names (LLaMA: the
    GGJT names of the model converter's _LAYER_MAP), every one a tensor of
    the converted base, and lora_A unchanged."""
    from ggllm_tpu_torch.io.ggcc import read_model
    from ggllm_tpu_torch.io.lora import read_lora

    hp, d = case
    lf = read_lora(convert_lora.convert(str(d / "peft"), str(tmp_path / "a.ggla"),
                                        base=str(d / "hf")))
    assert set(lf.tensors) <= set(read_model(str(d / "base.bin")).tensors)
    assert len(lf.tensors) == len(_targets(hp))
    ad = safetensors.load_file(d / "peft" / "adapter_model.safetensors")
    if hp.arch == "llama":
        name, peft = "layers.1.attention.wq.weight", "model.layers.1.self_attn.q_proj"
    else:
        name = peft = "transformer.h.1.self_attention.query_key_value"
        name += ".weight"
    np.testing.assert_array_equal(lf.tensors[name]["loraA"],
                                  ad[f"base_model.model.{peft}.lora_A.weight"])
