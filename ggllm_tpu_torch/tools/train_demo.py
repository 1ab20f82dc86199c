"""Train a tiny Falcon from scratch (port of ggllm_tpu/tools/train_demo.py,
the reference's train-text-from-scratch analogue).

The reference carries a ggml autograd with Adam and L-BFGS for its
training examples (ggml.h:1338-1523, examples/train-text-from-scratch); the
JAX package trains with jax.grad and optax. Here the same byte-level tiny
Falcon trains with torch autograd and torch.optim through the port's own
forward (models/falcon.py) on dense f32 weights, and is written as a GGCC
file the engines load:

* the weights are the trainer's own tree of leaf tensors that require grad,
  with the JAX tree's keys (wq / wk / wv / wo / ffn_up / ffn_down stacked
  over the layers, the embedding, the final norm, lm_head); the loss builds
  the model over views of them each call, so the engine's inference path
  (buffers under inference_mode, captured graphs) is untouched;
* the loss is the cacheless causal forward (Falcon.forward with kv None):
  attention over the step's own K/V through the plain einsum, the JAX loss's
  fresh zero cache with flash off, so nothing is written in place and no
  hand kernel runs under autograd (their wrappers refuse inputs that
  require grad: kernels/build.py no_grad_inputs);
* Adam is torch.optim.Adam (optax.adam's formula and defaults); L-BFGS is
  torch.optim.LBFGS with a strong-Wolfe line search and optax's memory of
  10, one iteration a step, full-batch on one fixed batch. optax.lbfgs
  (zoom line search) is another algorithm: the two are held to the same
  criteria, not step for step;
* the batches come from np.random.default_rng(seed) exactly as in the JAX
  demo, so both packages see the same tokens (byte ids offset by 12).

Runs on the CUDA card unless --device cpu is given, with TF32 off.

  python -m ggllm_tpu_torch.tools.train_demo -f input.txt -o out.ggcc \\
      [--steps 200] [--n-embd 128] [--n-layer 2] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import sys

import numpy as np
import torch

from ggllm_tpu_torch.core.config import EngineConfig, FalconHParams
from ggllm_tpu_torch.core.device import resolve_device
from ggllm_tpu_torch.core.dtypes import GGMLType
from ggllm_tpu_torch.io.ggcc import GGCCWriter
from ggllm_tpu_torch.models.falcon import Falcon, FalconStatic
from ggllm_tpu_torch.ops.rope import rope_angles
from ggllm_tpu_torch.utils.synthetic import make_tiny_vocab

def init_params(hp: FalconHParams, seed: int = 0, device=None) -> dict:
    """The JAX init_params:32 tree (same keys, shapes and spreads: weights
    normal / sqrt(fan-in), the embedding normal * 0.02, norms 1 and 0),
    drawn on the CPU from torch.Generator(seed) and put on `device` (the
    card by default), leaves requiring grad."""
    E, H, KV, D, F, V, L = (hp.n_embd, hp.n_head, hp.n_head_kv, hp.head_dim,
                            hp.n_ff, hp.n_vocab, hp.n_layer)
    g = torch.Generator().manual_seed(seed)

    def w(*shape):
        return torch.randn(shape, generator=g) / np.sqrt(shape[-1])

    layers = {"input_ln_w": torch.ones(L, E), "input_ln_b": torch.zeros(L, E),
              "wq": w(L, H * D, E), "wk": w(L, KV * D, E), "wv": w(L, KV * D, E),
              "wo": w(L, E, H * D), "ffn_up": w(L, F, E), "ffn_down": w(L, E, F)}
    tree = {"tok_embeddings": torch.randn(V, E, generator=g) * 0.02,
            "output_norm": torch.ones(E), "output_norm_b": torch.zeros(E),
            "lm_head": w(V, E), "layers": layers}
    return params_from_numpy(tree, device)


def params_from_numpy(tree: dict, device=None) -> dict:
    """A JAX init_params tree (its leaves as numpy, or tensors) as the
    trainer's tree of f32 leaf tensors on `device` that require grad."""
    device = resolve_device(device)

    def leaf(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device, requires_grad=True)

    return {k: ({n: leaf(a) for n, a in v.items()} if k == "layers" else leaf(v))
            for k, v in tree.items()}


def leaves(params: dict) -> list[torch.Tensor]:
    """The tree's leaf tensors, in key order (the optimizers' parameters)."""
    return [params[k] for k in sorted(params) if k != "layers"] + [
        params["layers"][k] for k in sorted(params["layers"])]


def model_tree(params: dict) -> dict:
    """The trainer's tree as the model's: a dict a layer of views of the
    stacked leaves, wq / wk / wv concatenated into the model's fused wqkv
    (gradients flow back to the leaves)."""
    lw = params["layers"]
    L = lw["wq"].shape[0]
    return {**{k: params[k] for k in ("tok_embeddings", "output_norm", "output_norm_b",
                                      "lm_head")},
            "layers": [{"wqkv": torch.cat([lw[k][i] for k in ("wq", "wk", "wv")], 0),
                        **{k: lw[k][i] for k in ("input_ln_w", "input_ln_b", "wo", "ffn_up",
                                                 "ffn_down")}}
                       for i in range(L)]}


def loss_fn(params: dict, tokens: torch.Tensor, hp: FalconHParams,
            inv_freq: torch.Tensor) -> torch.Tensor:
    """Next-token NLL at every position of (B, S + 1) tokens, in f32 (the
    JAX loss_fn:64): the cacheless causal forward of the first S tokens."""
    st = FalconStatic.from_hparams(hp, flash=False, kernels=False)
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    logits = Falcon(st, model_tree(params))(inp, None, 0, inv_freq, logits_all=True)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -logp.gather(-1, tgt[..., None]).mean()


def lbfgs(params: list[torch.Tensor]) -> torch.optim.LBFGS:
    """One L-BFGS iteration a step() with a strong-Wolfe line search and
    optax.lbfgs's memory of 10."""
    return torch.optim.LBFGS(params, lr=1.0, max_iter=1, history_size=10,
                             line_search_fn="strong_wolfe")


@contextlib.contextmanager
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def train(text: bytes, hp: FalconHParams, steps: int, seq_len: int = 64, batch: int = 8,
          lr: float = 3e-3, seed: int = 0, log=print, optimizer: str = "adam", device=None,
          params: dict | None = None):
    """optimizer "adam" (a fresh minibatch a step) or "lbfgs" (full-batch on
    one fixed batch, the reference's GGML_OPT_LBFGS, ggml.h:1417-1503).
    params: the starting tree (default init_params(hp, seed)). Returns
    (the trained tree, each step's loss before its update)."""
    device = resolve_device(device)
    inv_freq = torch.from_numpy(rope_angles(EngineConfig().rope, seq_len, hp.head_dim)).to(device)
    data = np.frombuffer(text, dtype=np.uint8).astype(np.int64) + 12  # byte ids
    assert data.size > seq_len + 1, "need more training text"
    params = params if params is not None else init_params(hp, seed, device)
    rng = np.random.default_rng(seed)

    def sample(b):
        starts = rng.integers(0, data.size - seq_len - 1, b)
        return torch.from_numpy(np.stack([data[s:s + seq_len + 1] for s in starts])).to(device)

    losses = []
    with no_tf32():
        if optimizer == "lbfgs":
            opt, tokens = lbfgs(leaves(params)), sample(batch)

            def closure():
                opt.zero_grad()
                loss = loss_fn(params, tokens, hp, inv_freq)
                loss.backward()
                return loss

            step = lambda: opt.step(closure)  # noqa: E731
        else:
            opt = torch.optim.Adam(leaves(params), lr=lr)

            def step():
                opt.zero_grad()
                loss = loss_fn(params, sample(batch), hp, inv_freq)
                loss.backward()
                opt.step()
                return loss

        for i in range(steps):
            losses.append(step().item())
            if i % max(1, steps // 10) == 0:
                log(f"step {i:5d}  loss {losses[-1]:.4f}")
    return params, losses


def save_ggcc(path: str, hp: FalconHParams, params: dict):
    """The trained tree as an f32 GGCC file, byte for byte the JAX
    save_ggcc:127 of the same values (its tiny byte vocabulary, the fused
    query_key_value rows [wq; wk; wv])."""
    vocab = make_tiny_vocab(hp.n_vocab)
    hp.n_bpe_merges = len(vocab.merges)
    writer = GGCCWriter(path, hp, vocab)

    def a(t):
        return t.detach().to("cpu", torch.float32).numpy()

    writer.write_array("transformer.word_embeddings.weight", a(params["tok_embeddings"]),
                       GGMLType.F32)
    writer.write_array("transformer.ln_f.weight", a(params["output_norm"]), GGMLType.F32)
    writer.write_array("transformer.ln_f.bias", a(params["output_norm_b"]), GGMLType.F32)
    writer.write_array("lm_head.weight", a(params["lm_head"]), GGMLType.F32)
    lw = {k: a(v) for k, v in params["layers"].items()}
    for i in range(hp.n_layer):
        pre = f"transformer.h.{i}"
        writer.write_array(f"{pre}.input_layernorm.weight", lw["input_ln_w"][i], GGMLType.F32)
        writer.write_array(f"{pre}.input_layernorm.bias", lw["input_ln_b"][i], GGMLType.F32)
        qkv = np.concatenate([lw["wq"][i], lw["wk"][i], lw["wv"][i]], axis=0)
        writer.write_array(f"{pre}.self_attention.query_key_value.weight", qkv, GGMLType.F32)
        writer.write_array(f"{pre}.self_attention.dense.weight", lw["wo"][i], GGMLType.F32)
        writer.write_array(f"{pre}.mlp.dense_h_to_4h.weight", lw["ffn_up"][i], GGMLType.F32)
        writer.write_array(f"{pre}.mlp.dense_4h_to_h.weight", lw["ffn_down"][i], GGMLType.F32)
    writer.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description="tiny-Falcon training demo")
    ap.add_argument("-f", "--file", required=True, help="training text")
    ap.add_argument("-o", "--out", required=True, help="output GGCC path")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", choices=("adam", "lbfgs"), default="adam",
                    help="adam (minibatch) or lbfgs (full-batch, line search)")
    ap.add_argument("--n-embd", type=int, default=128)
    ap.add_argument("--n-layer", type=int, default=2)
    ap.add_argument("--n-head", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    hp = FalconHParams(n_vocab=512, n_embd=args.n_embd, n_head=args.n_head,
                       n_head_kv=1, n_layer=args.n_layer, n_falcon_type=7,
                       n_bpe_merges=0)
    with open(args.file, "rb") as f:
        text = f.read()
    params, losses = train(text, hp, args.steps, args.seq_len, args.batch, args.lr,
                           optimizer=args.optimizer, device=args.device)
    save_ggcc(args.out, hp, params)
    print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f}); wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
