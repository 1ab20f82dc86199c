"""The port's converters (ggllm_tpu_torch/io/convert_hf.py,
convert_hf_llama.py, convert_lora.py) and its safetensors reader
(io/safetensors.py) against the JAX package's converters, on the CPU.

Tiny checkpoints built with `transformers` (skipped without it, as
tests/test_convert_llama.py is): HF Falcon in the 7B multi-query shape
(num_kv_heads taken out of config.json, as tiiuae/falcon-7b's has none) and
in the 40B grouped-query shape, HF LLaMA with a SentencePiece
tokenizer.model, and a Meta checkpoint in two consolidated.NN.pth shards.
The port's GGCC / GGJT files are byte for byte the JAX converters' at f16
and f32. A bf16 safetensors checkpoint (which the JAX converters cannot
read) converts to the bytes the JAX converter writes from the same bf16
weights saved as pytorch_model.bin. A Falcon-7B PEFT adapter converts,
given its base's config.json, to the JAX converter's ggla bytes (grouped-query
and LLaMA adapters: tests/test_torch_convert_lora.py). In a process
where `safetensors` and `transformers` cannot be imported (the card's
installation) the port converts a bf16 checkpoint and an adapter written by
utils/synthetic.py. The reader gives the safetensors package's arrays, and
the synthetic writers' directories convert as the JAX converters convert
them."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
safetensors_pkg = pytest.importorskip("safetensors")

from ggllm_tpu.io import convert_hf as jhf  # noqa: E402
from ggllm_tpu.io import convert_hf_llama as jllama  # noqa: E402
from ggllm_tpu.io import convert_lora as jlora  # noqa: E402

from ggllm_tpu_torch.core.config import FalconHParams, LlamaHParams  # noqa: E402
from ggllm_tpu_torch.io import convert_hf, convert_hf_llama, convert_lora, safetensors  # noqa: E402
from ggllm_tpu_torch.io.ggcc import read_model  # noqa: E402
from ggllm_tpu_torch.io.lora import read_lora  # noqa: E402
from ggllm_tpu_torch.utils import synthetic  # noqa: E402

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _quiet(*a, **kw):
    pass


def _falcon_config(arch: str):
    if arch == "7b":
        return transformers.FalconConfig(
            vocab_size=512, hidden_size=128, num_attention_heads=4, num_hidden_layers=2,
            multi_query=True, parallel_attn=True, new_decoder_architecture=False, alibi=False,
            bias=False)
    return transformers.FalconConfig(
        vocab_size=512, hidden_size=128, num_attention_heads=4, num_kv_heads=2,
        num_hidden_layers=2, parallel_attn=True, new_decoder_architecture=True, alibi=False,
        bias=False)


def _hf_falcon(d: Path, arch: str, dtype=torch.float32) -> Path:
    torch.manual_seed(2)
    model = transformers.FalconForCausalLM(_falcon_config(arch)).eval().to(dtype)
    model.save_pretrained(str(d), safe_serialization=True)
    if arch == "7b":  # tiiuae/falcon-7b's config has no num_kv_heads (the 40B signal)
        raw = json.loads((d / "config.json").read_text())
        raw.pop("num_kv_heads", None)
        raw.pop("n_head_kv", None)
        (d / "config.json").write_text(json.dumps(raw))
    synthetic.write_tokenizer_json(d / "tokenizer.json", synthetic.make_tiny_vocab(512))
    return d


def _hf_llama(d: Path, dtype=torch.float32):
    cfg = transformers.LlamaConfig(
        vocab_size=512, hidden_size=128, intermediate_size=352, num_attention_heads=4,
        num_hidden_layers=2, rms_norm_eps=1e-6, max_position_embeddings=256,
        tie_word_embeddings=False)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(cfg).eval().to(dtype)
    model.save_pretrained(str(d), safe_serialization=True)
    synthetic.write_sp_model(d / "tokenizer.model", synthetic.make_tiny_sp_vocab(512))
    return d, model


def _meta(d: Path, hf_model) -> Path:
    """A 2-way model-parallel Meta checkpoint of the HF model (ggml-native
    names, the rope rows in Meta's order, per-family shard splits), its
    tokenizer.model in the parent directory as Meta distributions keep it."""
    sd = {k: v.float().numpy() for k, v in hf_model.state_dict().items()}
    perm = jllama.permute_rope
    full = {"tok_embeddings.weight": sd["model.embed_tokens.weight"],
            "norm.weight": sd["model.norm.weight"], "output.weight": sd["lm_head.weight"],
            "rope.freqs": np.ones(16, np.float32)}
    for i in range(2):
        p = f"model.layers.{i}."
        full.update({
            f"layers.{i}.attention.wq.weight": perm(sd[p + "self_attn.q_proj.weight"], 4),
            f"layers.{i}.attention.wk.weight": perm(sd[p + "self_attn.k_proj.weight"], 4),
            f"layers.{i}.attention.wv.weight": sd[p + "self_attn.v_proj.weight"],
            f"layers.{i}.attention.wo.weight": sd[p + "self_attn.o_proj.weight"],
            f"layers.{i}.feed_forward.w1.weight": sd[p + "mlp.gate_proj.weight"],
            f"layers.{i}.feed_forward.w2.weight": sd[p + "mlp.down_proj.weight"],
            f"layers.{i}.feed_forward.w3.weight": sd[p + "mlp.up_proj.weight"],
            f"layers.{i}.attention_norm.weight": sd[p + "input_layernorm.weight"],
            f"layers.{i}.ffn_norm.weight": sd[p + "post_attention_layernorm.weight"]})
    meta = d / "meta"
    meta.mkdir()
    shards = ({}, {})
    for name, w in full.items():
        axis = jllama._meta_shard_axis(name) if name != "rope.freqs" else None
        halves = (w, w) if axis is None else np.split(w, 2, axis=axis)
        for sd_, h in zip(shards, halves):
            sd_[name] = torch.tensor(np.ascontiguousarray(h))
    for i, sd_ in enumerate(shards):
        torch.save(sd_, str(meta / f"consolidated.0{i}.pth"))
    (meta / "params.json").write_text(json.dumps(
        {"dim": 128, "multiple_of": 32, "n_heads": 4, "n_layers": 2, "norm_eps": 1e-6,
         "vocab_size": -1}))
    return meta


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("convert")
    out = {}
    for arch in ("7b", "40b"):
        (root / f"falcon{arch}").mkdir()
        out[f"falcon{arch}"] = _hf_falcon(root / f"falcon{arch}", arch)
    (root / "llama").mkdir()
    out["llama"], model = _hf_llama(root / "llama")
    out["meta"] = _meta(root / "llama", model)
    return out


# checkpoint -> (JAX converter, port converter)
CONVERTERS = {"falcon7b": (jhf.convert, convert_hf.convert),
              "falcon40b": (jhf.convert, convert_hf.convert),
              "llama": (jllama.convert, convert_hf_llama.convert),
              "meta": (jllama.convert_pth, convert_hf_llama.convert_pth)}


def _same_bytes(a, b) -> bool:
    return Path(a).read_bytes() == Path(b).read_bytes()


@pytest.mark.parametrize("ftype", ["f16", "f32"])
@pytest.mark.parametrize("ckpt", list(CONVERTERS))
def test_converters_write_the_jax_bytes(ckpts, tmp_path, ckpt, ftype):
    """The port's converters write the JAX converters' files byte for byte
    (header, vocab and merges or scores, de-interleaved QKV or permuted
    rope rows, the tied lm_head, Meta's shards concatenated)."""
    jconv, tconv = CONVERTERS[ckpt]
    ref, got = tmp_path / "jax.bin", tmp_path / "port.bin"
    jhp = jconv(str(ckpts[ckpt]), str(ref), ftype, log=_quiet)
    thp = tconv(str(ckpts[ckpt]), str(got), ftype, log=_quiet)
    assert vars(thp) == vars(jhp)
    assert _same_bytes(got, ref)
    mf = read_model(got)
    if ckpt.startswith("falcon"):
        assert mf.hparams.n_falcon_type == (40 if ckpt == "falcon40b" else 7)
        assert "lm_head.weight" in mf.tensors  # the tie materialized
    else:
        assert mf.arch == "llama" and mf.hparams.n_rot == 32 and mf.hparams.n_ff == 352


@pytest.mark.parametrize("family", ["falcon", "llama"])
def test_bf16_safetensors_convert_as_the_bf16_bin(tmp_path, family):
    """A bf16 safetensors checkpoint (read by io/safetensors.py, bf16
    widened exactly) converts to the bytes the JAX converter writes from the
    same bf16 weights saved as pytorch_model.bin (its torch path widens
    them too), the .bin in the safetensors file's sorted order."""
    st_dir, bin_dir = tmp_path / "st", tmp_path / "bin"
    st_dir.mkdir()
    if family == "falcon":
        _hf_falcon(st_dir, "7b", torch.bfloat16)
        jconv, tconv = jhf.convert, convert_hf.convert
    else:
        _hf_llama(st_dir, torch.bfloat16)
        jconv, tconv = jllama.convert, convert_hf_llama.convert
    shutil.copytree(st_dir, bin_dir)
    (bin_dir / "model.safetensors").unlink()
    with safetensors_pkg.safe_open(str(st_dir / "model.safetensors"), framework="pt") as f:
        sd = {name: f.get_tensor(name) for name in f.keys()}
    assert {t.dtype for t in sd.values()} == {torch.bfloat16}
    torch.save(sd, str(bin_dir / "pytorch_model.bin"))
    for ftype in ("f16", "f32"):
        jconv(str(bin_dir), str(tmp_path / "jax.bin"), ftype, log=_quiet)
        tconv(str(st_dir), str(tmp_path / "port.bin"), ftype, log=_quiet)
        assert _same_bytes(tmp_path / "port.bin", tmp_path / "jax.bin"), ftype


FALCON_TARGETS = {f"transformer.h.{i}.{k}.weight": shape for i in range(2) for k, shape in (
    ("self_attention.query_key_value", (192, 128)), ("mlp.dense_4h_to_h", (128, 512)))}


def test_falcon_peft_adapter_gives_the_jax_bytes(tmp_path):
    """A Falcon PEFT directory (safetensors f32, and the same as
    adapter_model.bin) converts to the JAX converter's ggla bytes, whose
    pairs read back as PEFT's lora_A / lora_B."""
    st = tmp_path / "st"
    synthetic.write_peft_adapter(st, FALCON_TARGETS, r=4, alpha=8, seed=3, dtype="F32")
    binary = tmp_path / "bin"
    binary.mkdir()
    shutil.copy(st / "adapter_config.json", binary)
    tensors = safetensors.load_file(st / "adapter_model.safetensors")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in tensors.items()},
               str(binary / "adapter_model.bin"))
    base = tmp_path / "config.json"  # a multi-query base: query_key_value rows kept
    base.write_text(json.dumps(synthetic.hf_config(FalconHParams.tiny(), True)))
    for d in (st, binary):
        ref = jlora.convert(str(d), str(tmp_path / "jax.ggla"))
        got = convert_lora.convert(str(d), str(tmp_path / "port.ggla"), base=str(base))
        assert _same_bytes(got, ref), d
    lf = read_lora(got)
    assert (lf.r, lf.alpha) == (4, 8) and set(lf.tensors) == set(FALCON_TARGETS)
    name = "transformer.h.1.mlp.dense_4h_to_h.weight"
    np.testing.assert_array_equal(
        lf.tensors[name]["loraB"],
        tensors["base_model.model.transformer.h.1.mlp.dense_4h_to_h.lora_B.weight"])
    assert lf.shape(name) == (128, 512)


def test_converter_mains(ckpts, tmp_path, capsys):
    """The command lines: --kcache is accepted and says that nothing is
    written; a params.json directory takes the Meta path."""
    convert_hf.main([str(ckpts["falcon7b"]), str(tmp_path / "f.ggcc"), "--kcache"])
    assert "no .kcache" in capsys.readouterr().err
    assert not list(tmp_path.glob("*.kcache"))
    convert_hf_llama.main([str(ckpts["meta"]), str(tmp_path / "m.ggjt"), "--ftype", "f32"])
    convert_hf_llama.convert_pth(str(ckpts["meta"]), str(tmp_path / "ref.ggjt"), "f32",
                                 log=_quiet)
    assert _same_bytes(tmp_path / "m.ggjt", tmp_path / "ref.ggjt")


def test_reader_matches_the_safetensors_package(tmp_path):
    """io/safetensors.py reads what the safetensors package writes (every
    dtype numpy has, bf16 as its f32 value, __metadata__ skipped), in sorted
    order, and the package reads synthetic.write_safetensors' files, whose
    bf16 is torch's round to nearest even."""
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    tensors = {"z": torch.randn(3, 5, generator=g), "a.h": torch.randn(7, generator=g).half(),
               "m": torch.randn(2, 3, generator=g).bfloat16(),
               "i": torch.arange(6, dtype=torch.int32).reshape(2, 3),
               "u": torch.arange(4, dtype=torch.uint8), "b": torch.tensor([True, False]),
               "e": torch.zeros(0, 4)}
    save_file(tensors, str(tmp_path / "t.safetensors"), metadata={"format": "pt"})
    got = list(safetensors.iter_tensors(tmp_path / "t.safetensors"))
    assert [n for n, _ in got] == sorted(tensors)
    for name, arr in got:
        ref = tensors[name].float() if tensors[name].dtype == torch.bfloat16 else tensors[name]
        assert arr.dtype == ref.numpy().dtype and arr.shape == tuple(ref.shape), name
        np.testing.assert_array_equal(arr, ref.numpy())

    x = np.random.default_rng(1).standard_normal((4, 6)).astype(np.float32) * 3
    specs = [("w", (4, 6)), ("v", (6,))]
    vals = {"w": x, "v": x[0]}
    for dtype, tdt in (("BF16", torch.bfloat16), ("F32", torch.float32)):
        path = tmp_path / f"{dtype}.safetensors"
        synthetic.write_safetensors(path, specs, lambda n, s: vals[n], dtype)
        with safetensors_pkg.safe_open(str(path), framework="pt") as f:
            for name, _ in specs:
                assert torch.equal(f.get_tensor(name), torch.from_numpy(vals[name]).to(tdt))
        np.testing.assert_array_equal(safetensors.load_file(path)["w"],
                                      torch.from_numpy(x).to(tdt).float().numpy())


@pytest.mark.parametrize("name", ["falcon7b", "falcon40b", "llama"])
def test_synthetic_hf_dirs_convert_as_jax(tmp_path, name):
    """utils/synthetic.py's HF directories (here in F32, which the JAX
    converters read) convert to the JAX converters' bytes; the vocabulary
    comes back as the tiny vocab's ids (the LLaMA pieces as SentencePiece
    gives them), and the tied Falcon lm_head is the embedding."""
    hp = {"falcon7b": FalconHParams.tiny(), "falcon40b": FalconHParams.tiny_gqa(),
          "llama": LlamaHParams.tiny()}[name]
    d = tmp_path / "hf"
    synthetic.write_hf_model(d, hp, seed=5, dtype="F32")
    jconv, tconv = CONVERTERS[name]
    jconv(str(d), str(tmp_path / "jax.bin"), "f16", log=_quiet)
    hp_out = tconv(str(d), str(tmp_path / "port.bin"), "f16", log=_quiet)
    assert _same_bytes(tmp_path / "port.bin", tmp_path / "jax.bin")
    mf = read_model(tmp_path / "port.bin")
    assert (hp_out.n_embd, hp_out.n_head, hp_out.n_layer, hp_out.n_vocab) == (
        hp.n_embd, hp.n_head, hp.n_layer, hp.n_vocab)
    if hp.arch == "llama":
        assert mf.hparams.n_rot == hp.head_dim and mf.hparams.n_ff == hp.n_ff
        toks = mf.vocab.id_to_token
        assert toks[:3] == [" ⁇ ".encode(), b"", b""] and toks[3 + 65] == b"A"
        assert toks[3 + 256:] == synthetic.make_tiny_sp_vocab(hp.n_vocab).id_to_token[3 + 256:]
    else:
        assert mf.hparams.n_head_kv == hp.n_head_kv
        assert mf.vocab.id_to_token == synthetic.make_tiny_vocab(hp.n_vocab).id_to_token
        np.testing.assert_array_equal(mf.tensor_f32("lm_head.weight"),
                                      mf.tensor_f32("transformer.word_embeddings.weight"))


def test_conversion_without_safetensors_or_transformers(tmp_path):
    """With `safetensors` and `transformers` unimportable, as on the card,
    the port converts a bf16 HF Falcon directory and a bf16 PEFT adapter
    (both from utils/synthetic.py) to the files it writes here."""
    hf, peft = tmp_path / "hf", tmp_path / "peft"
    synthetic.write_hf_model(hf, FalconHParams.tiny(), seed=2)
    synthetic.write_peft_adapter(peft, FALCON_TARGETS, seed=4)
    convert_hf.convert(str(hf), str(tmp_path / "ref.ggcc"), "f16", log=_quiet)
    convert_lora.convert(str(peft), str(tmp_path / "ref.ggla"), base=str(hf))
    code = (
        "import sys\n"
        "sys.modules['safetensors'] = sys.modules['transformers'] = None\n"
        "from ggllm_tpu_torch.io import convert_hf, convert_lora\n"
        f"convert_hf.convert({str(hf)!r}, {str(tmp_path / 'got.ggcc')!r}, 'f16',"
        " log=lambda *a: None)\n"
        f"convert_lora.convert({str(peft)!r}, {str(tmp_path / 'got.ggla')!r}, base={str(hf)!r})\n"
        "assert sys.modules['safetensors'] is None\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=120)
    assert _same_bytes(tmp_path / "got.ggcc", tmp_path / "ref.ggcc")
    assert _same_bytes(tmp_path / "got.ggla", tmp_path / "ref.ggla")
    assert read_model(tmp_path / "got.ggcc").tensors["lm_head.weight"].shape == (512, 128)
