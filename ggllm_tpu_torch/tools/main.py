"""Generation CLI (the core of ggllm_tpu/tools/main.py): load a Falcon GGCC
file or a LLaMA GGJT file, tokenize the prompt with the file's tokenizer
(BOS first), generate and print the text. Sampler settings that the device
cascade covers sample on the card; the rest (--top-k 0, --tfs, --typical,
--mirostat) go through the host cascade (ops/sampling.py), as the JAX CLI's
flags of the same names and defaults do.

    python -m ggllm_tpu_torch.tools.main -m model.ggcc -p "Hello" -n 64

Runs on the CUDA card unless --device cpu is given. --kv-dtype picks the KV
cache's storage: bfloat16 (default), float32 (also --memory-f32) or int8
(codes with one f32 scale per cached position and head).
"""

from __future__ import annotations

import argparse
import sys
import time

from ggllm_tpu_torch import tokenizer as tok_mod
from ggllm_tpu_torch.core.config import EngineConfig
from ggllm_tpu_torch.engine.engine import FalconEngine
from ggllm_tpu_torch.io.loader import load_model
from ggllm_tpu_torch.ops.sampling import SamplerParams


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-p", "--prompt", default="")
    ap.add_argument("-n", "--n-predict", type=int, default=128)
    ap.add_argument("-c", "--ctx-size", type=int, default=2048)
    ap.add_argument("-s", "--seed", type=int, default=-1)
    ap.add_argument("--temp", type=float, default=0.8)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--top-p", type=float, default=0.95)
    ap.add_argument("--tfs", type=float, default=1.0)
    ap.add_argument("--typical", type=float, default=1.0)
    ap.add_argument("--repeat-penalty", type=float, default=1.1)
    ap.add_argument("--repeat-last-n", type=int, default=64)
    ap.add_argument("--frequency-penalty", type=float, default=0.0)
    ap.add_argument("--presence-penalty", type=float, default=0.0)
    ap.add_argument("--mirostat", type=int, default=0, choices=[0, 1, 2])
    ap.add_argument("--mirostat-tau", "--mirostat-ent", type=float, default=5.0,
                    dest="mirostat_tau", help="mirostat target entropy tau")
    ap.add_argument("--mirostat-eta", "--mirostat-lr", type=float, default=0.1,
                    dest="mirostat_eta", help="mirostat learning rate eta")
    ap.add_argument("--no-penalize-nl", action="store_true")
    ap.add_argument("--ignore-eos", action="store_true")
    ap.add_argument("--memory-f32", action="store_true",
                    help="store the KV cache in f32 (sets --kv-dtype float32)")
    ap.add_argument("--kv-dtype", default="bfloat16", choices=("bfloat16", "float32", "int8"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = EngineConfig(n_ctx=args.ctx_size,
                       kv_dtype="float32" if args.memory_f32 else args.kv_dtype)
    t0 = time.perf_counter()
    mf, params = load_model(args.model, cfg, device=args.device)
    tk = tok_mod.for_model(mf)
    eng = FalconEngine(mf.hparams, params, cfg, device=args.device)
    eng.timings.t_load_us = (time.perf_counter() - t0) * 1e6
    prompt = args.prompt
    prompt_ids = tk.tokenize(prompt, bos=not prompt.startswith("<|endoftext|>")) or [tk.bos_id]
    sampler = SamplerParams(
        temp=args.temp, top_k=args.top_k, top_p=args.top_p, tfs_z=args.tfs,
        typical_p=args.typical, repeat_penalty=args.repeat_penalty,
        repeat_last_n=args.repeat_last_n, frequency_penalty=args.frequency_penalty,
        presence_penalty=args.presence_penalty, mirostat=args.mirostat,
        mirostat_tau=args.mirostat_tau, mirostat_eta=args.mirostat_eta,
        penalize_nl=not args.no_penalize_nl, seed=args.seed)
    stop = set() if args.ignore_eos else {tk.eos_id}
    n_predict = min(args.n_predict, cfg.n_ctx - len(prompt_ids))
    out = sys.stdout.buffer
    out.write(prompt.encode("utf-8"))
    out.flush()

    def stream(t: int):
        if t not in stop:
            out.write(tk.piece(t))
            out.flush()

    eng.generate(prompt_ids, n_predict, sampler, stop_ids=stop, stream=stream)
    out.write(b"\n")
    out.flush()
    print(eng.timings.report(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
