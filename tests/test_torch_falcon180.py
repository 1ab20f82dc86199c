"""Falcon-180B (n_falcon_type 180) in the PyTorch port against the JAX
package, on the CPU.

The port's Falcon presets equal the JAX package's field by field. A tiny
180-type model (E 768, H 24 over KV 8: D 32 and G 3, odd as 180B's 29 is,
so the grouped kernels pad their query rows; F 3072, 2 layers, V 512; E is
three Q2_K super-blocks) is written by the port's GGCC writer in Q2_K and
Q4_0 and goes through both readers (equal hparams and tensors), both
loaders (the JAX tree bridged by from_jax_params equals the port's) and both
engines: the JAX engine with its Pallas kernels in interpret mode, f32
compute (one engine a model and cache for the module, so each of its
programs compiles once), the port with its kernels' plain versions. Logits
of every prompt position are held at 2e-5 of max |logit| (f32,
tests/test_kernels.py:45), greedy ids over three decode chunks on a dense
and an int8 cache must be equal. The plain prefill attention and decode
partials at 180B's head shape (G 29 over 1 and 2 K/V heads, D 64) are held
against the Pallas kernels in interpret mode, and the planner puts 180B at
Q2_K on one 80 GB card, at Q3_K and Q4_K on more, as the JAX planner does."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggllm_tpu.core.config import EngineConfig, FalconHParams
from ggllm_tpu.engine.engine import FalconEngine
from ggllm_tpu.io.ggcc import read_model
from ggllm_tpu.io.loader import load_params
from ggllm_tpu.kernels import flash_decode as jfd
from ggllm_tpu.kernels.flash_attention import flash_mqa as jflash_mqa
from ggllm_tpu.ops.sampling import SamplerParams
from ggllm_tpu.parallel import plan as jplan

from ggllm_tpu_torch.core.config import EngineConfig as TEngineConfig
from ggllm_tpu_torch.core.config import FalconHParams as TFalconHParams
from ggllm_tpu_torch.core.config import named_hparams
from ggllm_tpu_torch.core.dtypes import TYPE_TRAITS, GGMLType as TGGMLType
from ggllm_tpu_torch.engine.engine import FalconEngine as TFalconEngine
from ggllm_tpu_torch.io.ggcc import TensorRecord, read_model as tread_model
from ggllm_tpu_torch.io.loader import from_jax_params, load_model as tload_model
from ggllm_tpu_torch.kernels import flash_decode as tfd
from ggllm_tpu_torch.kernels.flash_attention import flash_mqa
from ggllm_tpu_torch.models import falcon as tfalcon
from ggllm_tpu_torch.ops.sampling import SamplerParams as TSamplerParams
from ggllm_tpu_torch.parallel import plan
from ggllm_tpu_torch.utils import synthetic as tsynthetic

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)

PROMPT = [5, 17, 130, 42, 99, 260, 31, 7]
LOGIT_TOL = 2e-5  # of max |logit|, f32 (tests/test_kernels.py:45)
FORMATS = ("q2_k", "q4_0")
CARD_BYTES = 80 * 10**9  # an 80 GB card


def _hp_180(cls=TFalconHParams):
    return cls(n_vocab=512, n_embd=768, n_head=24, n_head_kv=8, n_layer=2, n_falcon_type=180,
               n_bpe_merges=0)


def _jax_cfg(kv_dtype="float32"):
    return EngineConfig(n_ctx=64, n_batch=16, kv_dtype=kv_dtype, compute_dtype="float32",
                        kernel_layout=True, flash_attention=True)


def _torch_cfg(kv_dtype="float32"):
    return TEngineConfig(n_ctx=64, n_batch=16, kv_dtype=kv_dtype, compute_dtype="float32")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """format -> a tiny 180-type GGCC file from the port's writer."""
    d = tmp_path_factory.mktemp("falcon180")
    paths = {}
    for fmt in FORMATS:
        paths[fmt] = str(d / f"tiny180-{fmt}.ggcc")
        tsynthetic.write_tiny_model(paths[fmt], _hp_180(), TGGMLType[fmt.upper()], seed=29)
    return paths


@pytest.fixture(scope="module")
def jax_engines(files):
    """jax_engines(fmt, kv_dtype): one JAX engine a model and cache for the
    module (reset on each call)."""
    engines = {}

    def get(fmt, kv_dtype="float32"):
        if (fmt, kv_dtype) not in engines:
            mf = read_model(files[fmt])
            cfg = _jax_cfg(kv_dtype)
            engines[fmt, kv_dtype] = FalconEngine(mf.hparams, load_params(mf, cfg), cfg)
        engines[fmt, kv_dtype].reset()
        return engines[fmt, kv_dtype]

    return get


def _torch_engine(path, kv_dtype="float32"):
    tmf, params = tload_model(path, _torch_cfg(kv_dtype), device="cpu")
    return TFalconEngine(tmf.hparams, params, _torch_cfg(kv_dtype), device="cpu")


# ------------------------------------------------------------------ presets

@pytest.mark.parametrize("name", ["falcon7b", "falcon40b", "falcon180b", "tiny", "tiny_gqa"])
def test_falcon_presets_match_jax(name):
    j, t = getattr(FalconHParams, name)(), getattr(TFalconHParams, name)()
    assert vars(j) == vars(t)
    assert (j.head_dim, j.n_ff, j.n_head_kv, j.arch) == (t.head_dim, t.n_ff, t.n_head_kv, t.arch)


def test_named_falcon180b():
    hp = named_hparams("falcon180b")
    assert hp == TFalconHParams.falcon180b()
    assert (hp.n_embd, hp.n_head, hp.n_head_kv, hp.n_layer, hp.n_falcon_type) == \
        (14848, 232, 8, 80, 180)
    assert (hp.head_dim, hp.n_head // hp.n_head_kv, hp.n_ff) == (64, 29, 59392)
    st = tfalcon.FalconStatic.from_hparams(hp)
    assert st.parallel_norms  # the 40B branch: two norms, split wqkv / ffn_up


# ------------------------------------------------------------------ the file

@pytest.mark.parametrize("fmt", FORMATS)
def test_file_reads_equal_in_both(files, fmt):
    mf, tmf = read_model(files[fmt]), tread_model(files[fmt])
    assert tmf.arch == mf.arch == "falcon"
    want = dataclasses.replace(_hp_180(FalconHParams), n_bpe_merges=mf.hparams.n_bpe_merges)
    assert vars(tmf.hparams) == vars(mf.hparams) == vars(want)
    assert list(tmf.tensors) == list(mf.tensors)
    assert "transformer.h.1.ln_attn.weight" in tmf.tensors
    for name, t in mf.tensors.items():
        tt = tmf.tensors[name]
        assert (int(tt.gtype), tt.shape, tt.nbytes) == (int(t.gtype), t.shape, t.nbytes), name
        np.testing.assert_array_equal(tmf.tensor_f32(name), mf.tensor_f32(name))


@pytest.mark.parametrize("fmt", FORMATS)
def test_from_jax_params_bridges_the_jax_tree(files, fmt):
    """The JAX loader's 180-type tree bridges to exactly the port loader's
    weights (split wqkv / ffn_up and merged w_od, both norms)."""
    mf = read_model(files[fmt])
    jtree = jax.tree.map(np.asarray, load_params(mf, _jax_cfg()))
    _, own = tload_model(files[fmt], _torch_cfg(), device="cpu")
    bridged = from_jax_params(jtree, dtype=torch.float32, device="cpu")
    assert set(own["layers"][0]) == {"input_ln_w", "input_ln_b", "attn_ln_w", "attn_ln_b",
                                     "wqkv", "ffn_up", "w_od"}
    for a, b in zip(own["layers"], bridged["layers"]):
        assert a.keys() == b.keys()
        for key in a:
            if isinstance(a[key], torch.Tensor):
                assert torch.equal(a[key], b[key]), key
            else:
                assert (a[key].gtype, a[key].shape) == (b[key].gtype, b[key].shape), key
                for pname, p in a[key].planes.items():
                    assert p.dtype == b[key].planes[pname].dtype, (key, pname)
                    assert torch.equal(p, b[key].planes[pname]), (key, pname)
    for key in ("tok_embeddings", "output_norm", "output_norm_b"):
        assert torch.equal(own[key], bridged[key]), key


# ------------------------------------------------------------------ the engine

@pytest.mark.parametrize("fmt", FORMATS)
def test_logits_match_jax_engine(files, jax_engines, fmt):
    """Logits of every prompt position, then of one decode step."""
    jeng, teng = jax_engines(fmt), _torch_engine(files[fmt])
    ref, got = jeng.eval(PROMPT, logits_all=True), teng.eval(PROMPT, logits_all=True)
    assert got.shape == ref.shape == (len(PROMPT), 512)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=LOGIT_TOL)
    tok = int(ref[-1].argmax())
    np.testing.assert_allclose(teng.eval([tok]) / scale, jeng.eval([tok]) / scale, rtol=0,
                               atol=LOGIT_TOL)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_three_decode_chunks_match_jax_engine(files, jax_engines, fmt, kv_dtype):
    """Greedy ids over three decode chunks (40 tokens at decode_chunk 16,
    the last one partial) on a dense and on an int8 cache."""
    jeng, teng = jax_engines(fmt, kv_dtype), _torch_engine(files[fmt], kv_dtype)
    ref_ids = jeng.generate(PROMPT, 40, SamplerParams(temp=0.0))
    assert teng.generate(PROMPT, 40, TSamplerParams(temp=0.0)) == ref_ids
    assert teng.n_past == jeng.n_past == len(PROMPT) + 39


# ------------------------------------------------------------------ 180B's heads

@pytest.mark.parametrize("KV", [1, 2])
def test_decode_partials_at_g29_match_jax(KV):
    """The plain decode partials at G 29, D 64 (180B's head shape) over a
    short cache against the Pallas kernel in interpret mode (rtol / atol
    1e-5, tests/test_torch_kernels.py), one row past its valid prefix."""
    G, D, B, T, L, l = 29, 64, 2, 96, 2, 1
    rng = np.random.default_rng(KV)
    kv = rng.standard_normal((L, 2, B, T, KV, D)).astype(np.float32)
    qg = rng.standard_normal((B, KV, G, D)).astype(np.float32)
    valid = np.asarray([70, 9], np.int32)
    ref = jfd.cache_partials(jnp.asarray(kv.reshape(L, 2, B, T, KV * D)), KV, l, jnp.asarray(qg),
                             jnp.asarray(valid), interpret=True)
    got = tfd.cache_partials(torch.from_numpy(kv), KV, l, torch.from_numpy(qg),
                             torch.from_numpy(valid))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
    q = qg.reshape(B, 1, KV * G, D)
    ref = jfd.flash_decode(jnp.asarray(kv.reshape(L, 2, B, T, KV * D)), KV, l, jnp.asarray(q),
                           jnp.asarray(valid - 1), interpret=True)
    got = tfd.flash_decode(torch.from_numpy(kv), KV, l, torch.from_numpy(q),
                           torch.from_numpy(valid - 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("n_past", [0, 7])
@pytest.mark.parametrize("KV", [1, 2])
def test_flash_mqa_at_g29_matches_jax(KV, n_past):
    """The plain causal prefill attention at G 29, D 64 against the Pallas
    kernel in interpret mode (atol 1e-5, tests/test_torch_kernels.py)."""
    B, S, T, D, H = 1, 24, 64, 64, 29 * KV
    rng = np.random.default_rng(10 + KV + n_past)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = np.zeros((B, T, KV, D), np.float32)
    v = np.zeros((B, T, KV, D), np.float32)
    fill = n_past + S + 4
    k[:, :fill] = rng.standard_normal((B, fill, KV, D))
    v[:, :fill] = rng.standard_normal((B, fill, KV, D))
    ref = np.asarray(jflash_mqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.int32(n_past), block_s=8, block_t=32, interpret=True))
    got = flash_mqa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), n_past)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_kernel_plans_at_180b_heads():
    """The card's routes and plans at G 29, KV 8, D 64: the bf16 decode
    kernel (29 query rows padded to 32), its plan at 1 .. 2560 valid keys,
    and the prefill blocks' rows, which straddle positions (64 rows hold
    2.2 positions)."""
    from ggllm_tpu_torch.kernels import flash_attention as tfa

    assert tfd.route(8, 29, 64, "bfloat16") == "tc"
    assert tfd.route(8, 29, 64, "int8") == "tc"
    assert tfd._rows(29, "tc") == 32
    for valid in (1, 300, 2047, 2560):
        n, chunk = tfd.decode_plan(valid, 1, 8, 29, 64)
        assert n * chunk >= valid > (n - 1) * chunk and chunk % 16 == 0
    S, G = 300, 29
    covered = []
    for block in range(-(-S * G // tfa.TC_BLOCK_ROWS)):
        p = tfa.tc_block_plan(S, G, 0, 2560, block, tfa.TC_TILE_KEYS[64])
        covered += p["rows"]
        assert p["tiles"] == -(-(p["rows"][-1][0] + 1) // 64)
        assert p["last_key"] == [pos for pos, _ in p["rows"]]
    assert covered == [(pos, h) for pos in range(S) for h in range(G)]


# ------------------------------------------------------------------ the planner

def _mf_180(gtype: TGGMLType):
    """A Falcon-180B file's tensor list (no data): 2-D tensors in gtype, the
    norms in f32, as a quantized 180B file holds them."""
    hp = TFalconHParams.falcon180b()
    tensors = {}
    for name, shape, _, _ in tsynthetic.weight_specs(hp):
        gt = gtype if len(shape) == 2 else TGGMLType.F32
        tr = TYPE_TRAITS[gt]
        n = int(np.prod(shape))
        tensors[name] = TensorRecord(name, gt, tuple(reversed(shape)), 0,
                                     n // tr.block_size * tr.type_size)
    return dataclasses.make_dataclass("MF", ["hparams", "tensors"])(hp, tensors)


@pytest.mark.parametrize("fmt,cards", [("q2_k", 1), ("q3_k", 2), ("q4_k", 2)])
def test_180b_plan_on_80gb_cards(fmt, cards):
    """On the port's preset: Q2_K's 58 GB of planes fit one 80 GB card
    under the planner's 10 % headroom (the embedding loaded in bf16), Q3_K's
    and Q4_K's do not; the port's plan equals the JAX plan given the same
    card and overhead."""
    mf = _mf_180(TGGMLType[fmt.upper()])
    got = plan.suggest_tensor_split(mf, TEngineConfig(), hbm_bytes=CARD_BYTES)
    assert (got.model_axis, got.kv_shard, got.fits) == (cards, "heads", True)
    if cards == 1:
        assert 58e9 < got.per_chip_bytes < 0.9 * CARD_BYTES
    if fmt == "q2_k":  # 84-byte planes as the file's blocks; the embedding loaded in bf16
        emb = mf.tensors["transformer.word_embeddings.weight"]
        total = plan.model_bytes(mf)
        assert plan.kernel_overhead(mf, TEngineConfig()) == \
            (total - emb.nbytes + 2 * emb.n_elements) / total
    same = plan.suggest_tensor_split(mf, TEngineConfig(), hbm_bytes=CARD_BYTES,
                                     overhead=jplan.KERNEL_OVERHEAD)
    ref = jplan.suggest_tensor_split(mf, EngineConfig(), hbm_bytes=CARD_BYTES)
    assert dataclasses.astuple(same) == dataclasses.astuple(ref)
