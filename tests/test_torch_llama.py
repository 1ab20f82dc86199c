"""The PyTorch port's LLaMA path against the JAX package, on the CPU.

The same numpy inputs (fixed seeds) go through the JAX function and its
counterpart in the port: RMS norm, classic RoPE and the SwiGLU FFN (atol
1e-5 in f32; bf16 outputs within one bf16 step); the GGJT writer and
reader (bytes and tensors identical); the SentencePiece tokenizer (ids and
bytes identical); the loader bridge (tensors identical); and the slice as a
whole on tiny GGJT files: f32 logits of every position within 1e-4 of max
|logit| of the JAX engine's (tests/test_llama.py:86 allows 2e-3) and greedy
ids equal (over three decode chunks on a dense and on an int8 cache:
tests/test_torch_llama_decode.py). The JAX engine (one a model and cache for
the module, so that each of its programs compiles once) runs its Pallas
kernels in interpret mode (decode attention takes
`_cache_partials_mha`: KV * D is 128 or 256 here); the port runs its
kernels' plain versions."""

import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggllm_tpu.core.config import EngineConfig, LlamaHParams
from ggllm_tpu.core.dtypes import GGMLType
from ggllm_tpu.engine.engine import FalconEngine
from ggllm_tpu.io.ggcc import read_model
from ggllm_tpu.io.loader import load_params
from ggllm_tpu.models import llama as jllama
from ggllm_tpu.ops.sampling import SamplerParams
from ggllm_tpu.tokenizer import spm as jspm
from ggllm_tpu.tokenizer.bpe import Vocab
from ggllm_tpu.utils import synthetic as jsynthetic

from ggllm_tpu_torch import tokenizer as ttokenizer
from ggllm_tpu_torch.core.config import EngineConfig as TEngineConfig
from ggllm_tpu_torch.core.config import LlamaHParams as TLlamaHParams
from ggllm_tpu_torch.core.dtypes import GGMLType as TGGMLType
from ggllm_tpu_torch.engine.engine import FalconEngine as TFalconEngine
from ggllm_tpu_torch.io.ggcc import read_model as tread_model
from ggllm_tpu_torch.io.loader import from_jax_params, load_model as tload_model
from ggllm_tpu_torch.io.loader import load_params as tload_params
from ggllm_tpu_torch.models import llama as tllama
from ggllm_tpu_torch.models import resolve_model
from ggllm_tpu_torch.ops import rope as trope
from ggllm_tpu_torch.ops.sampling import SamplerParams as TSamplerParams
from ggllm_tpu_torch.tokenizer import spm as tspm
from ggllm_tpu_torch.tokenizer.bpe import Vocab as TVocab
from ggllm_tpu_torch.utils import synthetic as tsynthetic

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)

PROMPT = [5, 300, 42, 17, 260, 99, 31, 7]


def _hp_256(cls=LlamaHParams):
    """K-quants need widths divisible by 256: n_embd 256, n_ff 768, D 64."""
    return cls(n_vocab=512, n_embd=256, n_mult=256, n_head=4, n_layer=2, n_rot=64)


def _hp_rot16(cls=LlamaHParams):
    """n_rot 16 below head_dim 32: the tail of each head is not rotated. The
    header heuristic knows LLaMA by n_rot == head_dim, so such a file is
    read with arch="llama"."""
    return cls(n_vocab=512, n_embd=128, n_mult=32, n_head=4, n_layer=2, n_rot=16)


MODELS = {
    "f16": (LlamaHParams.tiny, GGMLType.F16),
    "q4_0": (LlamaHParams.tiny, GGMLType.Q4_0),
    "q8_0": (LlamaHParams.tiny, GGMLType.Q8_0),
    "q4_k": (_hp_256, GGMLType.Q4_K),
    "rot16_q8_0": (_hp_rot16, GGMLType.Q8_0),
}


@pytest.fixture(scope="module")
def llama_files(tmp_path_factory):
    """name -> path of a GGJT file written by the JAX package (on first use)."""
    d = tmp_path_factory.mktemp("llama")
    paths = {}

    class Files:
        def __getitem__(self, name):
            if name not in paths:
                mk_hp, ftype = MODELS[name]
                paths[name] = str(d / f"{name}.ggjt")
                jsynthetic.write_tiny_llama(paths[name], mk_hp(), ftype_2d=ftype, seed=21)
            return paths[name]

    return Files()


@pytest.fixture(scope="module")
def jax_engines(llama_files):
    """jax_engines(name, kv_dtype): one JAX engine a model and cache for the
    module (reset on each call), so each of its programs compiles once."""
    engines = {}

    def get(name, kv_dtype="float32"):
        if (name, kv_dtype) not in engines:
            mf = read_model(llama_files[name], arch="llama" if name.startswith("rot16") else "auto")
            cfg = _jax_cfg(kv_dtype=kv_dtype)
            engines[name, kv_dtype] = FalconEngine(mf.hparams, load_params(mf, cfg), cfg)
        engines[name, kv_dtype].reset()
        return engines[name, kv_dtype]

    return get


def _jax_cfg(kernel_layout=True, kv_dtype="float32"):
    return EngineConfig(n_ctx=64, n_batch=16, kv_dtype=kv_dtype, compute_dtype="float32",
                        kernel_layout=kernel_layout, flash_attention=True)


def _torch_cfg(kv_dtype="float32"):
    return TEngineConfig(n_ctx=64, n_batch=16, kv_dtype=kv_dtype, compute_dtype="float32")


# ------------------------------------------------------------------ functions

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 96)) * 3).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    ref = np.asarray(jllama.rms_norm(jnp.asarray(x, jnp.dtype(dtype)), jnp.asarray(w)),
                     np.float32)
    got = tllama.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(w))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-5 if dtype == "float32" else 0,
                               rtol=0 if dtype == "float32" else 2 ** -7)


@pytest.mark.parametrize("n_rot", [32, 16, 8], ids=["full", "half", "quarter"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_classic_matches_jax(n_rot, dtype):
    """Adjacent pairs (2j, 2j+1) of the first n_rot dims; the rest untouched."""
    from ggllm_tpu.core.config import RopeConfig
    from ggllm_tpu.ops import rope as jrope
    from ggllm_tpu_torch.core.config import RopeConfig as TRopeConfig

    D = 32
    inv = jrope.rope_angles(RopeConfig(), 2048, D, arch="llama")
    np.testing.assert_array_equal(trope.rope_angles(TRopeConfig(), 2048, D, arch="llama"), inv)
    # no NTK scaling for LLaMA, at any context length
    np.testing.assert_array_equal(trope.rope_angles(TRopeConfig(), 8192, D, arch="llama"), inv)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 3, D)).astype(np.float32)
    pos = np.arange(100, 114).reshape(2, 7)
    ref = np.asarray(jllama.apply_rope_classic(jnp.asarray(x, jnp.dtype(dtype)),
                                               jnp.asarray(pos), jnp.asarray(inv), n_rot),
                     np.float32)
    got = trope.apply_rope_classic(torch.from_numpy(x).to(getattr(torch, dtype)),
                                   torch.from_numpy(pos), torch.from_numpy(inv), n_rot)
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
        np.testing.assert_array_equal(got.numpy()[..., n_rot:], x[..., n_rot:])
    else:  # sin/cos differ in their last f32 bits: at most one bf16 step
        np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-6, rtol=2 ** -7)


@pytest.mark.parametrize("merged", [True, False], ids=["w13", "split"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn_matches_jax(merged, dtype):
    """SwiGLU with dense weights: SiLU in f32, cast back, then times up.
    The merged w13 output splits at n_ff = 96, not a power of two."""
    E, F = 64, 96
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 5, E)).astype(np.float32)
    ws = {k: (rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32)
          for k, s in (("w1", (F, E)), ("w3", (F, E)), ("w2", (E, F)))}
    norm = (1 + 0.1 * rng.standard_normal(E)).astype(np.float32)
    jst = jllama.LlamaStatic(n_layer=1, n_head=2, n_head_kv=2, head_dim=32, n_embd=E, n_ff=F,
                             n_vocab=8, n_rot=32)
    tst = tllama.LlamaStatic(n_layer=1, n_head=2, n_head_kv=2, head_dim=32, n_embd=E, n_ff=F,
                             n_vocab=8, n_rot=32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jlw = {"ffn_norm": jnp.asarray(norm), "w2": jnp.asarray(ws["w2"], jdt)}
    tlw = {"ffn_norm": torch.from_numpy(norm), "w2": torch.from_numpy(ws["w2"]).to(tdt)}
    if merged:
        w13 = np.concatenate([ws["w1"], ws["w3"]], 0)
        jlw["w13"], tlw["w13"] = jnp.asarray(w13, jdt), torch.from_numpy(w13).to(tdt)
    else:
        for k in ("w1", "w3"):
            jlw[k], tlw[k] = jnp.asarray(ws[k], jdt), torch.from_numpy(ws[k]).to(tdt)
    ref = np.asarray(jllama._ffn(jnp.asarray(x, jdt), jlw, jst), np.float32)
    got = tllama.LlamaLayer(tlw).ffn(torch.from_numpy(x).to(tdt), tst)
    assert got.dtype == tdt
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got.float().numpy() / scale, ref / scale,
                               atol=1e-5 if dtype == "float32" else 2e-2)


def test_hparams_match_jax():
    for mk in (lambda c: c.llama7b(), lambda c: c.tiny(), _hp_256, _hp_rot16):
        j, t = mk(LlamaHParams), mk(TLlamaHParams)
        assert (j.n_ff, j.head_dim, j.n_head_kv, j.arch) == (t.n_ff, t.head_dim, t.n_head_kv, t.arch)
        assert vars(j) == vars(t)
    assert TLlamaHParams.llama7b().n_ff == 11008
    st, cls = resolve_model(TLlamaHParams.tiny(), flash=False, kernels=False)
    assert cls is tllama.Llama and st.n_rot == 32 and not st.flash and not st.kernels


# ------------------------------------------------------------------ GGJT files

@pytest.mark.parametrize("ftype", ["F32", "F16", "Q4_0", "Q8_0", "Q4_1", "Q5_0", "Q5_1"])
def test_ggjt_writer_bytes_equal_jax(tmp_path, ftype):
    """The port's GGJT writer (vocab, weights and quantizer of its own) writes
    the JAX writer's file byte for byte."""
    jpath, tpath = str(tmp_path / "j.ggjt"), str(tmp_path / "t.ggjt")
    jsynthetic.write_tiny_llama(jpath, LlamaHParams.tiny(), GGMLType[ftype], seed=3)
    tsynthetic.write_tiny_llama(tpath, TLlamaHParams.tiny(), TGGMLType[ftype], seed=3)
    assert filecmp.cmp(jpath, tpath, shallow=False)


@pytest.mark.parametrize("name", ["f16", "q4_0", "q4_k"])
def test_ggjt_read_and_arch_detect(llama_files, name):
    mf, tmf = read_model(llama_files[name]), tread_model(llama_files[name])
    assert tmf.arch == mf.arch == "llama" and tmf.version == mf.version
    assert vars(tmf.hparams) == vars(mf.hparams) and tmf.hparams.n_ff == mf.hparams.n_ff
    assert tmf.vocab.id_to_token == mf.vocab.id_to_token
    assert list(tmf.vocab.scores) == list(mf.vocab.scores)
    assert list(tmf.tensors) == list(mf.tensors)
    assert "layers.0.attention.wq.weight" in tmf.tensors
    for tname, t in mf.tensors.items():
        assert tmf.tensors[tname].gtype == t.gtype and tmf.tensors[tname].shape == t.shape
        np.testing.assert_array_equal(tmf.tensor_f32(tname), mf.tensor_f32(tname))
    tk = ttokenizer.for_model(tmf)
    assert (tk.arch, tk.bos_id, tk.eos_id) == ("llama", 1, 2)


def test_random_block_ggjt_reads_in_both(tmp_path):
    """A Q4_K file from the port's writer (through its K-quant quantizer)
    reads as LLaMA, with equal tensors, in both packages."""
    path = str(tmp_path / "t.ggjt")
    tsynthetic.write_tiny_llama(path, _hp_256(TLlamaHParams), TGGMLType.Q4_K, seed=2)
    mf, tmf = read_model(path), tread_model(path)
    assert mf.arch == tmf.arch == "llama"
    name = "layers.1.feed_forward.w2.weight"
    assert tmf.tensors[name].gtype == TGGMLType.Q4_K and tmf.tensors[name].shape == (256, 768)
    np.testing.assert_array_equal(tmf.tensor_f32(name), mf.tensor_f32(name))


def test_falcon_files_still_detect_falcon(tmp_path):
    """GGCC and pre-GGCC (GGJT v3) Falcon headers: the port's reader detects
    what the JAX reader detects (tests/test_llama.py:37)."""
    import struct

    from ggllm_tpu.utils.synthetic import write_tiny_model

    path = str(tmp_path / "f.ggcc")
    write_tiny_model(path, ftype_2d=GGMLType.Q8_0, seed=1)
    assert tread_model(path).arch == read_model(path).arch == "falcon"
    # the same Falcon header in a GGJT v3 file (no merges field): the
    # heuristic sees n_head_kv 2 and n_falcon_type 40 where LLaMA has
    # n_head and n_layer
    mf = read_model(path)
    hp = mf.hparams
    legacy = str(tmp_path / "f.ggjt")
    with open(legacy, "wb") as f:
        f.write(struct.pack("<II", 0x67676A74, 3))
        f.write(struct.pack("<7I", hp.n_vocab, hp.n_embd, hp.n_head, hp.n_head_kv, hp.n_layer,
                            hp.n_falcon_type, hp.ftype))
        for tok, score in zip(mf.vocab.id_to_token, mf.vocab.scores):
            f.write(struct.pack("<I", len(tok)) + tok + struct.pack("<f", score))
    assert tread_model(legacy, load_merges=False).arch \
        == read_model(legacy, load_merges=False).arch == "falcon"


# ------------------------------------------------------------------ tokenizer

def _tiebreak_vocab(cls):
    toks = [b"<unk>", b"<s>", b"</s>"] + [bytes([b]) for b in range(256)]
    scores = [0.0] * 3 + [-1e6] * 256
    for piece, s in ((b"ab", -1.0), (b"bc", -1.0), (b"abc", -2.0)):
        toks.append(piece)
        scores.append(s)
    return cls(id_to_token=toks, scores=scores, merges=[])


def test_spm_matches_jax_on_tiny_vocab():
    jv, tv = jsynthetic.make_tiny_sp_vocab(512), tsynthetic.make_tiny_sp_vocab(512)
    assert tv.id_to_token == jv.id_to_token and list(tv.scores) == list(jv.scores)
    assert (tspm.BOS_ID, tspm.EOS_ID, tspm.UNK_ID, tspm.BYTE_OFFSET) == \
        (jspm.BOS_ID, jspm.EOS_ID, jspm.UNK_ID, jspm.BYTE_OFFSET)
    tid = {t: i for i, t in enumerate(tv.id_to_token)}
    assert tspm.tokenize(tv, " the") == [tid[b" the"]]
    assert tspm.tokenize(tv, "\x07") == [7 + tspm.BYTE_OFFSET]
    assert tspm.tokenize(tv, "") == [] and tspm.tokenize(tv, "", bos=True) == [tspm.BOS_ID]
    for text in (" the thing and another other south — wörld 日本語 \x07!", "the", "andandand in there"):
        for bos in (False, True):
            ids = tspm.tokenize(tv, text, bos=bos)
            assert ids == jspm.tokenize(jv, text, bos=bos)
            assert tspm.detokenize(tv, ids) == jspm.detokenize(jv, ids)
        assert tspm.detokenize(tv, tspm.tokenize(tv, text)) == text.encode()


def test_spm_tiebreak_matches_jax():
    """Equal scores merge leftmost first (tests/test_llama.py:60)."""
    jv, tv = _tiebreak_vocab(Vocab), _tiebreak_vocab(TVocab)
    tid = {t: i for i, t in enumerate(tv.id_to_token)}
    assert tspm.tokenize(tv, "abc") == [tid[b"abc"]]
    assert tspm.tokenize(tv, "abbc") == [tid[b"ab"], tid[b"bc"]]
    for text in ("abc", "abbc", "bcabcab", "aabbcc", "cab"):
        assert tspm.tokenize(tv, text) == jspm.tokenize(jv, text)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spm_random_bytes_match_jax(seed):
    """Random byte strings (invalid UTF-8 included) over a small alphabet
    that the vocab's pieces are made of, and over all bytes."""
    jv, tv = jsynthetic.make_tiny_sp_vocab(512), tsynthetic.make_tiny_sp_vocab(512)
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b" theandigours\xc3\xa9\xe6", np.uint8)
    for _ in range(20):
        n = int(rng.integers(1, 60))
        for data in (bytes(rng.choice(alphabet, n)), bytes(rng.integers(0, 256, n, dtype=np.uint8))):
            ids = tspm.tokenize(tv, data)
            assert ids == jspm.tokenize(jv, data)
            assert tspm.detokenize(tv, ids) == data


# ------------------------------------------------------------------ the loader

@pytest.mark.parametrize("kernel_layout", [True, False], ids=["kernel", "planar"])
@pytest.mark.parametrize("name", ["f16", "q4_0", "q8_0", "q4_k"])
def test_from_jax_params_bit_identical(llama_files, kernel_layout, name):
    """The JAX loader's LLaMA tree (merged KernelQuant layers, or stacked
    planar split matrices) converts to exactly the port loader's weights."""
    path = llama_files[name]
    jtree = jax.tree.map(np.asarray, load_params(read_model(path),
                                                 _jax_cfg(kernel_layout=kernel_layout)))
    tmf, own = tload_model(path, _torch_cfg(), device="cpu")
    bridged = from_jax_params(jtree, dtype=torch.float32, device="cpu")
    assert own.keys() == bridged.keys() and "output_norm_b" not in own
    assert set(own["layers"][0]) == {"attn_norm", "ffn_norm", "wqkv", "w13", "wo", "w2"}

    def same(a, b, key):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), key
            return
        assert a.gtype == b.gtype and a.shape == b.shape, key
        assert a.planes.keys() == b.planes.keys(), key
        for pname, plane in a.planes.items():
            assert plane.dtype == b.planes[pname].dtype, (key, pname)
            assert torch.equal(plane, b.planes[pname]), (key, pname)

    for key in ("tok_embeddings", "output_norm", "lm_head"):
        same(own[key], bridged[key], key)
    assert len(own["layers"]) == len(bridged["layers"]) == tmf.hparams.n_layer
    for a, b in zip(own["layers"], bridged["layers"]):
        assert a.keys() == b.keys()
        for key in a:
            same(a[key], b[key], key)
    outs = [TFalconEngine(tmf.hparams, p, _torch_cfg(), device="cpu").eval(PROMPT)
            for p in (own, bridged)]
    np.testing.assert_array_equal(outs[0], outs[1])


def test_mixed_types_across_layers_densify(tmp_path):
    """A key whose ggml type differs between layers (here w2: Q8_0 in layer
    0, Q4_0 in layer 1) is dequantized in every layer, in both packages, and
    unmergeable pairs keep their split keys."""
    from ggllm_tpu.io.ggcc import GGJTWriter
    from ggllm_tpu_torch.ops.linear import QuantTensor

    hp = LlamaHParams.tiny()
    path = str(tmp_path / "mixed.ggjt")
    writer = GGJTWriter(path, hp, jsynthetic.make_tiny_sp_vocab(hp.n_vocab))
    for name, arr in jsynthetic.random_llama_weights(hp, 4).items():
        if arr.ndim == 1:
            gtype = GGMLType.F32
        elif name == "layers.1.feed_forward.w2.weight":
            gtype = GGMLType.Q4_0
        elif name.endswith("attention.wk.weight"):
            gtype = GGMLType.F16  # dense beside quantized wq/wv: no wqkv merge
        else:
            gtype = GGMLType.Q8_0
        writer.write_array(name, arr, gtype)
    writer.close()
    jtree = jax.tree.map(np.asarray, load_params(read_model(path), _jax_cfg()))
    tmf, own = tload_model(path, _torch_cfg(), device="cpu")
    for lw, jlw in zip(own["layers"], jtree["layers"]):
        assert set(lw) == set(jlw) == {"attn_norm", "ffn_norm", "wq", "wk", "wv", "w13", "wo", "w2"}
        assert isinstance(lw["w2"], torch.Tensor) and isinstance(lw["wk"], torch.Tensor)
        assert isinstance(lw["wq"], QuantTensor) and isinstance(lw["w13"], QuantTensor)
        np.testing.assert_array_equal(lw["w2"].numpy(), jlw["w2"])
    cfg = _jax_cfg()
    mf = read_model(path)
    ref = FalconEngine(mf.hparams, load_params(mf, cfg), cfg).eval(PROMPT)
    got = TFalconEngine(tmf.hparams, own, _torch_cfg(), device="cpu").eval(PROMPT)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, atol=1e-4)


# ------------------------------------------------------------------ the slice

@pytest.mark.parametrize("name", list(MODELS))
def test_slice_matches_jax_engine(llama_files, jax_engines, name):
    """Logits of every prompt position, of a later single-token eval, and 16
    greedy ids (one decode chunk after the first token)."""
    path = llama_files[name]
    arch = "llama" if name.startswith("rot16") else "auto"
    jeng = jax_engines(name)
    tmf = tread_model(path, arch=arch)
    teng = TFalconEngine(tmf.hparams, tload_params(tmf, _torch_cfg(), device="cpu"),
                         _torch_cfg(), device="cpu")
    assert type(teng.model) is tllama.Llama and teng.st.n_rot == jeng.hp.n_rot

    ref, got = jeng.eval(PROMPT, logits_all=True), teng.eval(PROMPT, logits_all=True)
    assert got.shape == ref.shape == (len(PROMPT), jeng.hp.n_vocab)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, atol=1e-4)
    ref1, got1 = jeng.eval([7]), teng.eval([7])
    np.testing.assert_allclose(got1 / scale, ref1 / scale, atol=1e-4)

    jeng.reset()
    teng.reset()
    ref_ids = jeng.generate(PROMPT, 16, SamplerParams(temp=0.0))
    assert teng.generate(PROMPT, 16, TSamplerParams(temp=0.0)) == ref_ids


def test_output_hidden_and_last_pos(llama_files):
    """output_hidden returns the final normed hidden state whose lm_head
    product is the logits; last_pos picks the position."""
    tmf, params = tload_model(llama_files["q8_0"], _torch_cfg(), device="cpu")
    eng = TFalconEngine(tmf.hparams, params, _torch_cfg(), device="cpu")
    toks = torch.tensor([PROMPT])
    with torch.inference_mode():
        all_logits = eng.model(toks, eng.new_kv(), 0, eng.inv_freq, logits_all=True)
        at3 = eng.model(toks, eng.new_kv(), 0, eng.inv_freq, last_pos=3)
        hid = eng.model(toks, eng.new_kv(), 0, eng.inv_freq, last_pos=3, output_hidden=True)
    assert at3.shape == (1, 1, 512) and hid.shape == (1, 1, 128) and hid.dtype == torch.float32
    torch.testing.assert_close(at3[0, 0], all_logits[0, 3], atol=1e-5, rtol=1e-5)
    from ggllm_tpu_torch.ops.linear import linear

    assert torch.equal(linear(eng.model.lm_head, hid, torch.float32, kernels=False), at3)


@pytest.mark.parametrize("name,extra", [("q4_0", []), ("q4_k", ["--kv-dtype", "int8"])],
                         ids=["q4_0", "q4_k_int8"])
def test_cli_generates_on_cpu(llama_files, capsysbinary, name, extra):
    from ggllm_tpu_torch.tools import main as tmain

    rc = tmain.main(["-m", llama_files[name], "-p", " the thing", "-n", "6", "--temp", "0",
                     "--device", "cpu", "--ignore-eos", *extra])
    assert rc == 0
    out = capsysbinary.readouterr()
    assert out.out.startswith(b" the thing") and b"eval time" in out.err


def test_cli_prompt_gets_bos_and_spm_ids(llama_files, monkeypatch):
    """The CLI tokenizes a LLaMA prompt with the SentencePiece tokenizer, BOS
    first, and stops at its EOS (id 2), as the JAX CLI does: the Generator
    that drives it has prefilled those ids and holds that EOS id."""
    from ggllm_tpu_torch.engine.generator import Generator
    from ggllm_tpu_torch.tools import main as tmain

    seen = {}

    def generate(self, logits, n_predict, on_token):
        seen.update(ids=list(self.all_tokens), stop=self.eos_id)
        return "eos"

    monkeypatch.setattr(Generator, "generate", generate)
    assert tmain.main(["-m", llama_files["q4_0"], "-p", " the", "--device", "cpu"]) == 0
    vocab = tread_model(llama_files["q4_0"]).vocab
    assert seen["ids"] == jspm.tokenize(jsynthetic.make_tiny_sp_vocab(512), " the", bos=True)
    assert seen["ids"] == [tspm.BOS_ID, vocab.id_to_token.index(b" the")]
    assert seen["stop"] == tspm.EOS_ID
