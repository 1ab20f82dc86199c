"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda` and skipped without one. These cover what chip_smoke.py's
full-width checks do not: every quant format with f32 and bf16 inputs,
ragged tiles (odd S, O and query tiles), 16- and 32-wide group sums, per-row
n_past / valid vectors, head_dim 32, Falcon-40B's 16 query heads per K/V
head, the int8 cache's partials, refusals of what the kernels do not take,
and tiny models (one on an int8 cache) end to end on the card against the
CPU. They import no JAX, so they run on a
machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ggllm_tpu_torch.core.config import EngineConfig, FalconHParams
from ggllm_tpu_torch.core.dtypes import GGMLType
from ggllm_tpu_torch.kernels import build
from ggllm_tpu_torch.kernels import flash_decode as fd
from ggllm_tpu_torch.kernels import quant_matmul as qm
from ggllm_tpu_torch.kernels.flash_attention import flash_mqa, flash_mqa_plain
from ggllm_tpu_torch.ops import kvcache
from ggllm_tpu_torch.ops.linear import QuantTensor
from ggllm_tpu_torch.utils.benchgen import random_quant

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # of max |ref| (tests/test_kernels.py:45)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _close(got, ref, dtype):
    got, ref = got.float().cpu(), ref.float().cpu()
    scale = ref.abs().max().item() + 1e-6
    assert got.isfinite().all()
    assert (got - ref).abs().max().item() / scale <= TOL[dtype]


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


FORMATS = [GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_0,
           GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K, GGMLType.Q2_K, GGMLType.Q3_K]


@pytest.mark.parametrize("gtype", FORMATS, ids=[f.name.lower() for f in FORMATS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("S", [1, 3, 300])
def test_quant_matmul(dev, gtype, dtype, S):
    O, K = 100, (512 if gtype in qm.K_QUANTS else 320)  # odd O: ragged GEMV and tile
    w = random_quant(gtype, O, K, _gen(S), dev, scale=0.2)
    x = torch.randn(S, K, generator=_gen(S + 1), device=dev).to(dtype)
    before = build.launch_counts["quant_matmul"]
    before_fmt = build.launch_counts[f"quant_matmul.{gtype.name.lower()}"]
    got = qm.quant_matmul(w, x, dtype)
    assert build.launch_counts["quant_matmul"] == before + 1
    assert build.launch_counts[f"quant_matmul.{gtype.name.lower()}"] == before_fmt + 1
    _close(got, qm.quant_matmul_plain(w, x, dtype), dtype)


def test_quant_matmul_refuses_what_is_not_ported(dev):
    """On a CUDA tensor a type that is no weight format, a K-quant width
    that is not whole super-blocks, or an f16 x raises; nothing falls back
    to the plain version."""
    x = torch.randn(1, 256, device=dev)
    q8k = SimpleNamespace(gtype=GGMLType.Q8_K, shape=(64, 256), planes={})
    with pytest.raises(NotImplementedError):
        qm.quant_matmul(q8k, x, torch.float32)
    for gtype in (GGMLType.Q4_K, GGMLType.Q3_K):
        w = random_quant(gtype, 64, 512, _gen(0), dev)
        bad = QuantTensor(gtype, (64, 320), w.planes)  # 320 % 256 != 0
        with pytest.raises(ValueError):
            qm.quant_matmul(bad, torch.randn(1, 320, device=dev), torch.float32)
        with pytest.raises(TypeError):
            qm.quant_matmul(w, torch.randn(1, 512, device=dev).half(), torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("g", [32, 16])
def test_group_sums(dev, dtype, g):
    x = torch.randn(300, 320, generator=_gen(0), device=dev).to(dtype)
    _close(qm.group_sums(x, g), qm.group_sums_plain(x, g), torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("H,KV,D", [(8, 1, 64), (6, 2, 64), (5, 1, 32), (128, 8, 64)])
@pytest.mark.parametrize("n_past", [0, 37, "rows"])
def test_flash_mqa(dev, dtype, H, KV, D, n_past):
    B, S, T = 2, 45, 160
    g = _gen(H * D)
    q = torch.randn(B, S, H, D, generator=g, device=dev).to(dtype)
    kv = torch.randn(1, 2, B, T, KV, D, generator=g, device=dev).to(dtype)
    if n_past == "rows":
        n_past = torch.tensor([3, 90], dtype=torch.int32, device=dev)
    got = flash_mqa(q, kv[0, 0], kv[0, 1], n_past)
    _close(got, flash_mqa_plain(q, kv[0, 0], kv[0, 1], n_past), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, "int8"],
                         ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("KV,H,D", [(1, 71, 64), (2, 6, 64), (1, 5, 32), (8, 128, 64)])
@pytest.mark.parametrize("valid", [0, 1, 63, 64, 65, [200, 7]])
def test_cache_partials(dev, dtype, KV, H, D, valid):
    """int8: the cache is the (codes, scales) pair of a quantized random
    cache, q is bf16, and the launch counts under the int8 variant's name."""
    B, T, L, l = 2, 256, 3, 2
    g = _gen(H)
    kv = torch.randn(L, 2, B, T, KV, D, generator=g, device=dev)
    qg = torch.randn(B, KV, H // KV, D, generator=g, device=dev)
    if dtype == "int8":
        kv, qg = kvcache.quantize_new(kv), qg.to(torch.bfloat16)
        counter = "flash_decode.int8"
    else:
        kv, qg = kv.to(dtype), qg.to(dtype)
        counter = "flash_decode"
    before = build.launch_counts[counter]
    acc, m, lsum = fd.cache_partials(kv, KV, l, qg, valid)
    assert build.launch_counts[counter] == before + 1
    acc_p, m_p, l_p = fd.cache_partials_plain(kv, KV, l, qg, valid)
    _close(m, m_p, torch.float32)
    _close(lsum, l_p, torch.float32)
    _close(acc, acc_p, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, "int8"],
                         ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("KV,H,D", [(1, 71, 64), (1, 5, 32), (8, 128, 64)])
@pytest.mark.parametrize("variant", ["no_append", "append", "append_valid", "append_only"])
def test_flash_decode(dev, dtype, KV, H, D, variant):
    """The whole decode attention (partials, then the finishing kernel with
    the [current; pending] append block) against its plain version; per-row
    n_past; "append_only": nothing valid in the cache yet."""
    B, T, L, l, A = 2, 256, 3, 1, 17
    g = _gen(H + len(variant))
    kv = torch.randn(L, 2, B, T, KV, D, generator=g, device=dev)
    cdtype = torch.bfloat16 if dtype == "int8" else dtype
    q = torch.randn(B, 1, H, D, generator=g, device=dev).to(cdtype)
    app = torch.randn(2, B, A, KV, D, generator=g, device=dev).to(cdtype)
    kv = kvcache.quantize_new(kv) if dtype == "int8" else kv.to(dtype)
    n_past = torch.tensor([130, 9], dtype=torch.int32, device=dev)
    kw = {}
    if variant == "append":
        kw = {"kv_append": app[:, :, :1]}
    elif variant == "append_valid":
        kw = {"kv_append": app, "append_valid": 6}
    elif variant == "append_only":
        n_past, kw = 4, {"kv_append": app, "append_valid": 5}
    counter = "flash_decode.int8" if dtype == "int8" else "flash_decode"
    before = build.launch_counts[counter]
    got = fd.flash_decode(kv, KV, l, q, n_past, **kw)
    assert build.launch_counts[counter] == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, fd.flash_decode_plain(kv, KV, l, q, n_past, **kw), cdtype)


def test_cache_partials_refuses_a_bad_int8_pair(dev):
    """int8 codes with scales of another shape or dtype, or an f16 q, raise."""
    codes, scales = kvcache.quantize_new(torch.randn(2, 2, 1, 64, 1, 64, device=dev))
    qg = torch.randn(1, 1, 4, 64, device=dev)
    with pytest.raises(ValueError):
        fd.cache_partials((codes, scales[..., 0]), 1, 0, qg, 5)
    with pytest.raises(TypeError):
        fd.cache_partials((codes, scales.half()), 1, 0, qg, 5)
    with pytest.raises(TypeError):
        fd.cache_partials((codes, scales), 1, 0, qg.half(), 5)
    q = torch.randn(1, 1, 4, 64, device=dev)
    with pytest.raises(ValueError):  # an append block of another head layout
        fd.flash_decode((codes, scales), 1, 0, q, 5, kv_append=torch.randn(2, 1, 3, 2, 64, device=dev))
    with pytest.raises(ValueError):
        fd.flash_decode((codes, scales), 1, 0, q, 5, kv_append=torch.randn(2, 1, 3, 1, 64, device=dev),
                        append_valid=4)


@pytest.mark.parametrize("gtype,kv_dtype", [(GGMLType.Q4_0, "float32"), (GGMLType.Q4_1, "float32"),
                                            (GGMLType.Q4_K, "float32"), (GGMLType.Q6_K, "float32"),
                                            (GGMLType.Q2_K, "float32"), (GGMLType.Q3_K, "int8")],
                         ids=["q4_0", "q4_1", "q4_k", "q6_k", "q2_k", "q3_k_int8"])
def test_tiny_model_on_card_matches_cpu(dev, tmp_path, gtype, kv_dtype):
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.io.loader import load_model
    from ggllm_tpu_torch.ops.sampling import SamplerParams
    from ggllm_tpu_torch.utils.synthetic import write_tiny_model

    path = str(tmp_path / "tiny.ggcc")
    hp = FalconHParams.tiny() if gtype not in qm.K_QUANTS else FalconHParams(
        n_vocab=512, n_embd=256, n_head=8, n_head_kv=2, n_layer=2, n_falcon_type=40,
        n_bpe_merges=0)
    write_tiny_model(path, hp, gtype, seed=5)
    cfg = EngineConfig(n_ctx=64, n_batch=16, kv_dtype=kv_dtype, compute_dtype="float32")
    prompt = [int(t) for t in np.random.default_rng(4).integers(12, 500, 40)]  # 3 chunks
    logits, ids = [], []
    for device in ("cpu", "cuda"):
        mf, params = load_model(path, cfg, device=device)
        eng = FalconEngine(mf.hparams, params, cfg, device=device)
        logits.append(eng.eval(prompt))
        eng.reset()
        ids.append(eng.generate(prompt, 12, SamplerParams(temp=0.0)))
    scale = np.abs(logits[0]).max()
    np.testing.assert_allclose(logits[1] / scale, logits[0] / scale, atol=1e-4)
    assert ids[0] == ids[1]
