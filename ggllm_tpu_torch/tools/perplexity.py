"""falcon_perplexity equivalent CLI on the port (ggllm_tpu/tools/perplexity.py,
the same flags):

    python -m ggllm_tpu_torch.tools.perplexity -m model.ggcc -f wiki.test.raw

The text is tokenized with BOS and cut into n_ctx chunks; each chunk
prefills from an empty cache through engine.eval_logprobs (log-softmax and
target gather on the card) and the NLL of positions [min(512, n_ctx / 2),
n_ctx - 1) is summed (engine/perplexity.py). --weight-mode dequant runs the
plain dequantize-then-matmul version of the quantized weights
(EngineConfig(kernel_layout=False)) instead of the fused kernels. The JAX
tool's plane_layout choice (row-major planes for prefill on the TPU) has no
counterpart here: the port's kernels read one layout for prefill and decode.
Runs on the CUDA card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import sys
import time

from ggllm_tpu_torch import tokenizer as tok_mod
from ggllm_tpu_torch.core.config import EngineConfig
from ggllm_tpu_torch.engine.engine import FalconEngine
from ggllm_tpu_torch.engine.perplexity import perplexity
from ggllm_tpu_torch.io.loader import load_model


def main(argv=None):
    ap = argparse.ArgumentParser(description="wikitext-style perplexity")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-f", "--file", required=True, help="raw text file (wiki.test.raw)")
    ap.add_argument("-c", "--ctx-size", type=int, default=2048)
    ap.add_argument("-b", "--batch-size", type=int, default=512)
    ap.add_argument("--kv-dtype", default="bfloat16", choices=("bfloat16", "float32", "int8"))
    ap.add_argument("--compute-dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--weight-mode", default="fused", choices=["fused", "dequant"])
    ap.add_argument("--max-chunks", type=int, default=0,
                    help="limit evaluated chunks (0 = all)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = EngineConfig(n_ctx=args.ctx_size, n_batch=args.batch_size, kv_dtype=args.kv_dtype,
                       compute_dtype=args.compute_dtype,
                       kernel_layout=args.weight_mode == "fused")
    t0 = time.perf_counter()
    mf, params = load_model(args.model, cfg, device=args.device)
    engine = FalconEngine(mf.hparams, params, cfg, device=args.device)
    engine.timings.t_load_us = (time.perf_counter() - t0) * 1e6

    with open(args.file, "rb") as f:
        text = f.read().decode("utf-8", errors="replace")
    tokens = tok_mod.for_model(mf).tokenize(text, bos=True)
    print(f"tokenized {len(tokens)} tokens; "
          f"{len(tokens) // cfg.n_ctx} chunks of {cfg.n_ctx}", file=sys.stderr)

    def progress(i, n, ppl):
        print(f"[{i}]{ppl:.4f},", end="", flush=True)

    res = perplexity(engine, tokens, progress=progress, max_chunks=args.max_chunks)
    print(f"\nperplexity: {res.ppl:.4f} [{res.n_chunks} chunks, {res.count} tokens]")
    print(engine.timings.report(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
