"""The port's training demo (ggllm_tpu_torch/tools/train_demo.py) against
the JAX demo (ggllm_tpu/tools/train_demo.py) on the CPU: the loss's
gradients on carried JAX init_params equal jax.grad of the JAX loss within
1e-4 of each leaf's largest, and central finite differences (test_grad.py's
check); five Adam steps from the same init on the same batches give optax's
losses within 1e-4 relative; torch L-BFGS converges test_train_demo.py's
least-squares problem to lstsq and cuts the demo's loss by the JAX test's
criterion; Adam's loss falls by the JAX test's criterion and the written
file, byte for byte the JAX save_ggcc's of the same weights, loads in both
packages and gives the JAX engine's greedy ids (b"cabcab"). Each hand
kernel's wrapper refuses an input that requires grad before any launch."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ggllm_tpu.core.config import EngineConfig as JConfig, FalconHParams as JHParams
from ggllm_tpu.engine.engine import FalconEngine as JEngine
from ggllm_tpu.io.ggcc import read_model as jread_model
from ggllm_tpu.io.loader import load_params as jload_params
from ggllm_tpu.models.falcon import FalconStatic as JStatic, falcon_forward
from ggllm_tpu.ops import sampling as jsampling
from ggllm_tpu.ops.rope import rope_angles as jrope_angles
from ggllm_tpu.tools import train_demo as jdemo
from ggllm_tpu_torch.core.config import EngineConfig, FalconHParams
from ggllm_tpu_torch.engine.engine import FalconEngine
from ggllm_tpu_torch.io.loader import load_model
from ggllm_tpu_torch.ops.rope import rope_angles
from ggllm_tpu_torch.ops.sampling import SamplerParams
from ggllm_tpu_torch.tools import train_demo as demo

torch.set_num_threads(1)

TEXT = b"abcabcabc" * 200
SMALL = dict(n_vocab=512, n_embd=32, n_head=2, n_head_kv=1, n_layer=2, n_falcon_type=7,
             n_bpe_merges=0)


def _hps(**kw):
    return JHParams(**{**SMALL, **kw}), FalconHParams(**{**SMALL, **kw})


def _jax_init(jhp, seed=0):
    return jax.tree.map(np.asarray, jdemo.init_params(jhp, jax.random.PRNGKey(seed)))


def _flat(tree) -> dict:
    return {**{k: v for k, v in tree.items() if k != "layers"},
            **{f"layers/{k}": v for k, v in tree["layers"].items()}}


def _jax_loss(jhp, tokens, S):
    st = JStatic.from_hparams(jhp)
    inv = jrope_angles(JConfig().rope, S, jhp.head_dim)

    def loss(params):
        B = tokens.shape[0]
        kv = jnp.zeros((jhp.n_layer, 2, B, S, jhp.n_head_kv, jhp.head_dim), jnp.float32)
        logits, _ = falcon_forward(params, tokens[:, :-1], kv, jnp.int32(0), inv, st,
                                   logits_all=True, compute_dtype=jnp.float32)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(logp, tokens[:, 1:, None], axis=-1).mean()

    return loss


def _port_loss(hp, params, tokens, S):
    inv = torch.from_numpy(rope_angles(EngineConfig().rope, S, hp.head_dim))
    return demo.loss_fn(params, torch.from_numpy(tokens).long(), hp, inv)


@pytest.mark.parametrize("n_head_kv", [1, 2], ids=["mqa", "gqa"])
def test_gradients_match_jax_grad(n_head_kv):
    """On the same weights and tokens the loss equals the JAX loss and each
    leaf's gradient jax.grad's within 1e-4 of its largest entry: the
    cacheless causal forward trains what the JAX loss's fresh cache does."""
    jhp, hp = _hps(n_head=4, n_head_kv=n_head_kv)
    S = 10
    tokens = np.random.default_rng(3).integers(12, 268, (3, S + 1)).astype(np.int32)
    jp = _jax_init(jhp)
    jloss, jgrads = jax.value_and_grad(_jax_loss(jhp, jnp.asarray(tokens), S))(jp)
    params = demo.params_from_numpy(jp, "cpu")
    loss = _port_loss(hp, params, tokens, S)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    got, ref = _flat(params), _flat(jax.tree.map(np.asarray, jgrads))
    assert got.keys() == ref.keys()
    for k in ref:
        scale = np.abs(ref[k]).max()
        assert scale > 0, k
        err = np.abs(got[k].grad.numpy() - ref[k]).max() / scale
        assert err < 1e-4, (k, err)


def test_gradients_match_finite_differences():
    """test_grad.py's check on the port: autograd against central
    differences at the largest-gradient coordinates of four weights."""
    _, hp = _hps(n_vocab=64, n_layer=1)
    S = 6
    params = demo.init_params(hp, 0, "cpu")
    tokens = np.array([[3, 9, 17, 33, 2, 60, 5]])
    _port_loss(hp, params, tokens, S).backward()
    eps = 1e-3
    for key in ("lm_head", "tok_embeddings", "layers/wq", "layers/ffn_down"):
        leaf = _flat(params)[key]
        g = leaf.grad.reshape(-1)
        for idx in torch.argsort(-g.abs())[[0, 3, 7]]:
            with torch.no_grad():
                flat = leaf.view(-1)
                flat[idx] += eps
                up = float(_port_loss(hp, params, tokens, S))
                flat[idx] -= 2 * eps
                down = float(_port_loss(hp, params, tokens, S))
                flat[idx] += eps
            np.testing.assert_allclose(float(g[idx]), (up - down) / (2 * eps), rtol=2e-2,
                                       atol=1e-5, err_msg=f"{key}[{int(idx)}]")


def test_adam_matches_optax_step_for_step():
    """Five Adam steps from the JAX init on the JAX demo's batches (the same
    rng): every step's loss within 1e-4 relative of optax's."""
    jhp, hp = _hps()
    kw = dict(seq_len=12, batch=4, lr=1e-2, log=lambda *a: None)
    _, ref = jdemo.train(TEXT, jhp, 5, **kw)
    _, got = demo.train(TEXT, hp, 5, device="cpu",
                        params=demo.params_from_numpy(_jax_init(jhp), "cpu"), **kw)
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert got[-1] < got[0]


def test_lbfgs_converges_least_squares():
    """test_train_demo.py's least-squares problem through the demo's L-BFGS
    (one iteration a step, strong-Wolfe line search, memory 10): lstsq's
    solution at 1e-4 after 40 steps."""
    rng = np.random.default_rng(0)
    A = torch.tensor(rng.standard_normal((24, 8)), dtype=torch.float32)
    b = torch.tensor(rng.standard_normal(24), dtype=torch.float32)
    x = torch.zeros(8, requires_grad=True)
    opt = demo.lbfgs([x])

    def closure():
        opt.zero_grad()
        loss = ((A @ x - b) ** 2).mean()
        loss.backward()
        return loss

    for _ in range(40):
        opt.step(closure)
    x_star, *_ = np.linalg.lstsq(A.numpy(), b.numpy(), rcond=None)
    np.testing.assert_allclose(x.detach().numpy(), x_star, atol=1e-4)


def test_demo_lbfgs_reduces_loss():
    """The JAX test's criterion: 12 full-batch L-BFGS steps end below 0.7 of
    the first loss."""
    _, hp = _hps(n_layer=1)
    _, losses = demo.train(b"abcabcabc" * 100, hp, 12, seq_len=12, batch=4,
                           optimizer="lbfgs", log=lambda *a: None, device="cpu")
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])


def test_save_ggcc_writes_the_jax_bytes(tmp_path):
    jhp, hp = _hps(n_layer=2)
    jp = _jax_init(jhp, seed=4)
    jdemo.save_ggcc(str(tmp_path / "j.ggcc"), jhp, jp)
    demo.save_ggcc(str(tmp_path / "t.ggcc"), hp, demo.params_from_numpy(jp, "cpu"))
    assert (tmp_path / "t.ggcc").read_bytes() == (tmp_path / "j.ggcc").read_bytes()


def test_training_reduces_loss_and_loads_in_both(tmp_path):
    """The JAX test's run on the port (60 Adam steps, lr 1e-2): the loss
    ends below half the first; the written file loads in both packages,
    whose engines give the learned cycle b"cabcab" after b"abcab", and the
    same ids."""
    _, hp = _hps(n_embd=64, n_layer=1)
    params, losses = demo.train(TEXT, hp, 60, seq_len=24, batch=4, lr=1e-2,
                                log=lambda *a: None, device="cpu")
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    out = str(tmp_path / "trained.ggcc")
    demo.save_ggcc(out, dataclasses.replace(hp), params)
    prompt = [c + 12 for c in b"abcab"]
    cfg = EngineConfig(n_ctx=64, n_batch=16, kv_dtype="float32", compute_dtype="float32")
    mf, p = load_model(out, cfg, device="cpu")
    ids = FalconEngine(mf.hparams, p, cfg, device="cpu").generate(
        prompt, 6, SamplerParams(temp=0.0, repeat_penalty=1.0))
    jmf = jread_model(out)
    jcfg = JConfig(n_ctx=64, n_batch=16, kv_dtype="float32", compute_dtype="float32")
    jids = JEngine(jmf.hparams, jload_params(jmf, jcfg), jcfg).generate(
        prompt, n_predict=6, sampler=jsampling.SamplerParams(temp=0.0, repeat_penalty=1.0))
    assert bytes((t - 12) % 256 for t in jids) == b"cabcab"
    assert [int(t) for t in ids] == [int(t) for t in jids]


def test_main_writes_a_loadable_file(tmp_path, capsys):
    text = tmp_path / "t.txt"
    text.write_bytes(TEXT)
    out = str(tmp_path / "m.ggcc")
    assert demo.main(["-f", str(text), "-o", out, "--steps", "3", "--seq-len", "16",
                      "--n-embd", "32", "--n-layer", "1", "--device", "cpu"]) == 0
    assert "final loss" in capsys.readouterr().out
    mf, _ = load_model(out, EngineConfig(), device="cpu")
    assert (mf.hparams.n_embd, mf.hparams.n_layer) == (32, 1)


def _guarded_calls():
    """Each hand kernel's wrapper on CPU tensors, q / x requiring grad."""
    from ggllm_tpu_torch.kernels import flash_attention, flash_decode, quant_matmul
    from ggllm_tpu_torch.kernels.ring_attention import ring_attention
    from ggllm_tpu_torch.parallel.comm import Comm
    from ggllm_tpu_torch.utils.benchgen import random_quant
    from ggllm_tpu_torch.core.dtypes import GGMLType

    g = torch.Generator().manual_seed(0)
    w = random_quant(GGMLType.Q4_0, 64, 64, g, "cpu")
    x = torch.randn(2, 64, requires_grad=True)
    q = torch.randn(1, 3, 4, 16, requires_grad=True)
    k = torch.randn(1, 8, 2, 16)
    kv = torch.randn(1, 2, 1, 8, 2, 16)
    q1 = torch.randn(1, 1, 4, 16, requires_grad=True)
    one = Comm(None, [0], 0, None)
    return {
        "quant_matmul": lambda: quant_matmul.quant_matmul(w, x, torch.float32),
        "quant_matmul_tc": lambda: quant_matmul.quant_matmul_tc(w, x, torch.float32),
        "group_sums": lambda: quant_matmul.group_sums(x),
        "flash_mqa": lambda: flash_attention.flash_mqa(q, k, k, 0),
        "flash_decode": lambda: flash_decode.flash_decode(kv, 2, 0, q1, 3),
        "cache_partials": lambda: flash_decode.cache_partials(kv, 2, 0, q1.reshape(1, 2, 2, 16),
                                                              3),
        "ring_attention": lambda: ring_attention(q, k, k, one, 0),
    }


@pytest.mark.parametrize("name", list(_guarded_calls()))
def test_kernel_wrappers_refuse_inputs_that_require_grad(name):
    """Before any launch (so here too), while grad mode is on; under
    no_grad / inference_mode the same call runs."""
    call = _guarded_calls()[name]
    with pytest.raises(RuntimeError, match=f"{name}: an input requires grad"):
        call()
    if name != "quant_matmul_tc":  # the tile has no CPU version
        with torch.no_grad():
            call()
