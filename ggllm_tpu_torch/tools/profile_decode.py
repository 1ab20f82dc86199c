"""Where the time goes on the main path: a torch.profiler trace of one
prefill chunk and of a run of decode tokens at full model width (random
weights of one format from a seed), on the CUDA card.

    python -m ggllm_tpu_torch.tools.profile_decode [--config falcon7b|falcon40b|llama7b]
        [--format q4_0|q4_1|q5_0|q5_1|q8_0|q2_k|q3_k|q4_k|q5_k|q6_k]
        [--kv-dtype bfloat16|float32|int8] [--prompt 300] [--tokens 16]

Prints one JSON object per phase: wall time, device busy time (the union
of kernel intervals), the device's idle share, launches, and the kernels
that take the most device time.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ggllm_tpu_torch.core.config import EngineConfig, named_hparams
from ggllm_tpu_torch.core.dtypes import GGMLType
from ggllm_tpu_torch.engine.engine import FalconEngine
from ggllm_tpu_torch.ops.sampling import SamplerParams
from ggllm_tpu_torch.utils.benchgen import make_bench_params


def _device_summary(prof, wall_s: float, n_tokens: int, top: int = 12) -> dict:
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, -1.0
    for a, b in spans:  # union of kernel intervals, in microseconds
        if a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    by_name: dict[str, list] = {}
    for e in kernels:
        t = by_name.setdefault(e.name, [0.0, 0])
        t[0] += e.time_range.end - e.time_range.start
        t[1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "tokens": n_tokens,
        "wall_ms_per_token": wall_s * 1e3 / n_tokens,
        "device_busy_ms_per_token": busy / 1e3 / n_tokens,
        "device_idle_share": 1.0 - busy / 1e6 / wall_s,
        "kernel_launches_per_token": len(kernels) / n_tokens,
        "top_kernels_ms_per_token": {
            name[:90]: round(t / 1e3 / n_tokens, 5) for name, (t, _) in ranked},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("falcon7b", "falcon40b", "llama7b"),
                    default="falcon7b")
    ap.add_argument("--format", default="q4_0", help="2-D weight format (default q4_0)")
    ap.add_argument("--kv-dtype", default="bfloat16", choices=("bfloat16", "float32", "int8"))
    ap.add_argument("--prompt", type=int, default=300)
    ap.add_argument("--tokens", type=int, default=16)
    args = ap.parse_args(argv)
    hp = named_hparams(args.config)
    params = make_bench_params(hp, seed=7, gtype=GGMLType[args.format.upper()])
    eng = FalconEngine(hp, params, EngineConfig(kv_dtype=args.kv_dtype))
    prompt = [int(t) for t in np.random.default_rng(0).integers(12, hp.n_vocab, args.prompt)]
    greedy = SamplerParams(temp=0.0)
    eng.generate(prompt[:8], 4, greedy, stop_ids=set())  # warm-up
    eng.reset()

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()  # the same prefill without the profiler's own cost
    eng.eval(prompt)          # returns the logits on the host: the device is done
    plain_wall = time.perf_counter() - t0
    eng.reset()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits = eng.eval(prompt)
        wall = time.perf_counter() - t0
    print(json.dumps({"model": f"{args.config} {args.format} kv {args.kv_dtype}",
                      "phase": f"prefill {args.prompt}",
                      "wall_ms_per_token_unprofiled": plain_wall * 1e3 / args.prompt,
                      **_device_summary(prof, wall, args.prompt)}), flush=True)

    first = int(np.argmax(logits))
    start = eng.n_past
    t0 = time.perf_counter()  # the same tokens without the profiler's own cost
    eng.decode_chunk(first, args.tokens, greedy, last_tokens=prompt + [first])
    plain_wall = time.perf_counter() - t0
    eng.rollback(start)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.decode_chunk(first, args.tokens, greedy, last_tokens=prompt + [first])
        wall = time.perf_counter() - t0
    print(json.dumps({"phase": f"decode {args.tokens} (greedy, n_past {args.prompt})",
                      "wall_ms_per_token_unprofiled": plain_wall * 1e3 / args.tokens,
                      **_device_summary(prof, wall, args.tokens)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
