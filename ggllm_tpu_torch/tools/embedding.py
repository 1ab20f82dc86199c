"""Embedding extraction CLI on the port (ggllm_tpu/tools/embedding.py, the
same flags; the reference's examples/embedding): prints the final-layer
normed hidden state of the last prompt token.

    python -m ggllm_tpu_torch.tools.embedding -m model.ggcc -p "Hello"

Runs on the CUDA card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import sys

from ggllm_tpu_torch import tokenizer as tok_mod
from ggllm_tpu_torch.core.config import EngineConfig
from ggllm_tpu_torch.engine.engine import FalconEngine
from ggllm_tpu_torch.io.loader import load_model


def main(argv=None):
    ap = argparse.ArgumentParser(description="prompt embedding (final hidden state)")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-p", "--prompt", required=True)
    ap.add_argument("-c", "--ctx-size", type=int, default=2048)
    ap.add_argument("--compute-dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = EngineConfig(n_ctx=args.ctx_size, compute_dtype=args.compute_dtype)
    mf, params = load_model(args.model, cfg, device=args.device)
    engine = FalconEngine(mf.hparams, params, cfg, device=args.device)
    ids = tok_mod.for_model(mf).tokenize(args.prompt, bos=True)
    emb = engine.embed(ids)
    print(" ".join(f"{v:.6f}" for v in emb))
    return 0


if __name__ == "__main__":
    sys.exit(main())
