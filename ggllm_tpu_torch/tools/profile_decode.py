"""Where the time goes on the main path: a torch.profiler trace of one
prefill chunk and of a run of decode tokens at full model width (random
weights of one format from a seed), on the CUDA card.

    python -m ggllm_tpu_torch.tools.profile_decode [--config falcon7b|falcon40b|falcon180b|llama7b]
        [--format q4_0|q4_1|q5_0|q5_1|q8_0|q2_k|q3_k|q4_k|q5_k|q6_k]
        [--kv-dtype bfloat16|float32|int8] [--prompt 300] [--tokens 64] [--rows B]
        [--ctx 2048] [--batch 512]

Prints one JSON object per phase: wall time, device busy time (the union
of kernel intervals), the device's idle share, launches, and the kernels
that take the most device time, and each kernel family's share of the busy
time (`GROUPS`: the prefill tile, the prefill and decode attention, the
GEMVs). `--ctx` and `--batch` set the engine's n_ctx and n_batch (the cache
holds n_ctx + n_batch positions; a prompt past 2048 needs a larger --ctx, as
the CLI's -c). On an int8 cache the prefill also sizes the attention's read
of the cache: the dequantization of every layer's whole cache
(ops/kvcache.py read_layer) that each n_batch chunk makes, timed alone with
CUDA events as one chunk's calls. Decode runs through the replayed CUDA graph
and through the eager step body in turns (time_kernels.py decode_turns:
wall, device-busy and idle share, nodes a token, capture ms), then once
more through the graph for its kernels by name. With --rows B > 1 the
engine has B rows (continuous batching): the prompt is prefilled into every
row (prefill_rows), then the decode steps run as replayed B-row graphs
(decode_rows, 16 steps a chunk, greedy), profiled for their kernels by name
a step.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ggllm_tpu_torch.core.config import EngineConfig
from ggllm_tpu_torch.core.dtypes import GGMLType
from ggllm_tpu_torch.engine.engine import FalconEngine
from ggllm_tpu_torch.ops import kvcache
from ggllm_tpu_torch.ops.sampling import SamplerParams
from ggllm_tpu_torch.tools.time_kernels import decode_turns
from ggllm_tpu_torch.utils.benchgen import bench_hparams, make_bench_params


# kernel families by a part of the kernel's name (csrc/*.cu)
GROUPS = {"prefill tile": ("quant_gemm_tc", "quant_gemm_f32"),
          "prefill attention": ("flash_mqa_",), "decode attention": ("decode_",),
          "decode GEMV": ("quant_gemv_", "quant_mmv_")}


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
    shares = {group: sum(t for name, (t, _) in by_name.items() if any(p in name for p in parts))
              / busy for group, parts in GROUPS.items()} if busy else {}
    return {
        "tokens": n_tokens,
        "wall_ms_per_token": wall_s * 1e3 / n_tokens,
        "device_busy_ms_per_token": busy / 1e3 / n_tokens,
        "device_idle_share": 1.0 - busy / 1e6 / wall_s,
        "kernel_launches_per_token": len(kernels) / n_tokens,
        "top_kernels_ms_per_token": {
            name[:90]: round(t / 1e3 / n_tokens, 5) for name, (t, _) in ranked},
        "busy_share": {g: round(v, 4) for g, v in shares.items() if v},
    }


def _read_layer_ms(eng) -> float:
    """Device ms of one prefill chunk's reads of an int8 cache: read_layer
    of every layer (the whole cache dequantized to the compute dtype), as
    models/falcon.py attend calls it, between two CUDA events; the median
    of 5 runs."""
    dt = getattr(torch, eng.cfg.compute_dtype)
    runs = []
    for _ in range(6):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for l in range(eng.hp.n_layer):
            kvcache.read_layer(eng.kv, l, dt)
        b.record()
        torch.cuda.synchronize()
        runs.append(a.elapsed_time(b))
    return float(np.median(runs[1:]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("falcon7b", "falcon40b", "falcon180b", "llama7b"),
                    default="falcon7b")
    ap.add_argument("--format", default="q4_0", help="2-D weight format (default q4_0)")
    ap.add_argument("--kv-dtype", default="bfloat16", choices=("bfloat16", "float32", "int8"))
    ap.add_argument("--prompt", type=int, default=300)
    ap.add_argument("--tokens", type=int, default=64, help="decode tokens a run (16-token chunks)")
    ap.add_argument("--rows", type=int, default=1, help="batch rows (> 1: the B-row decode)")
    ap.add_argument("--ctx", type=int, default=2048, help="the engine's n_ctx (CLI -c)")
    ap.add_argument("--batch", type=int, default=512, help="the engine's n_batch (CLI -b)")
    args = ap.parse_args(argv)
    hp = bench_hparams(args.config)
    params = make_bench_params(hp, seed=7, gtype=GGMLType[args.format.upper()])
    if args.rows > 1:
        return _rows(args, hp, params)
    eng = FalconEngine(hp, params, EngineConfig(n_ctx=args.ctx, n_batch=args.batch,
                                                kv_dtype=args.kv_dtype))
    prompt = [int(t) for t in np.random.default_rng(0).integers(12, hp.n_vocab, args.prompt)]
    greedy = SamplerParams(temp=0.0)
    eng.eval(prompt[:8])  # warm-up
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
    summary = _device_summary(prof, wall, args.prompt)
    if kvcache.is_quantized(eng.kv):  # the chunks' dequantizing reads of the whole cache
        n_chunks = -(-args.prompt // args.batch)
        ms = _read_layer_ms(eng) * n_chunks
        summary["read_layer"] = {
            "calls": n_chunks * hp.n_layer, "positions_a_call": eng.kv_T,
            "ms_per_token": ms / args.prompt,
            "busy_share": ms / args.prompt / summary["device_busy_ms_per_token"]}
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "model": f"{args.config} {args.format} kv {args.kv_dtype}",
                      "n_ctx": args.ctx, "n_batch": args.batch,
                      "phase": f"prefill {args.prompt}",
                      "wall_ms_per_token_unprofiled": plain_wall * 1e3 / args.prompt,
                      **summary}), flush=True)

    first = int(np.argmax(logits))
    hist = prompt + [first]
    turns = decode_turns(eng, first, hist, args.tokens)
    start = eng.n_past
    with profile(activities=acts) as prof:  # one more graph run, for its kernels by name
        t0 = time.perf_counter()
        out = []
        for _ in range(args.tokens // 16):
            toks, _ = eng.decode_chunk(out[-1] if out else first, 16, greedy,
                                       last_tokens=hist + out)
            out += [int(t) for t in toks]
        wall = time.perf_counter() - t0
    eng.rollback(start)
    print(json.dumps({"phase": f"decode {args.tokens} (greedy, n_past {args.prompt}, 16-token"
                               " chunks): graph and eager step body in turns",
                      "turns": turns, "graph_run": _device_summary(prof, wall, len(out))}),
          flush=True)
    return 0


def _rows(args, hp, params) -> int:
    """The B-row decode: every row prefilled with the prompt, then
    args.tokens steps as 16-step decode_rows graph replays, once unprofiled
    (wall) and once under the profiler."""
    B = args.rows
    eng = FalconEngine(hp, params, EngineConfig(n_ctx=args.ctx, n_batch=args.batch,
                                                kv_dtype=args.kv_dtype), batch_size=B)
    prompt = [int(t) for t in np.random.default_rng(0).integers(12, hp.n_vocab, args.prompt)]
    first = eng.prefill_rows(list(range(B)), [prompt] * B, np.zeros(B, np.int64))
    toks = np.asarray([int(np.argmax(first[r])) for r in range(B)])
    npv = np.full(B, args.prompt)
    eng.decode_rows(toks, npv, 16)  # capture

    def run() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = toks
        for i in range(args.tokens // 16):
            last = eng.decode_rows(last, npv + 16 * i, 16)[0][-1]
        return time.perf_counter() - t0

    plain_wall = run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run()
    steps = args.tokens // 16 * 16
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "model": f"{args.config} {args.format} kv {args.kv_dtype}",
                      "phase": f"decode_rows, {B} rows, {steps} steps at n_past {args.prompt}"
                               " (greedy, 16-step graphs); per-token figures are a step's",
                      "wall_ms_per_step_unprofiled": plain_wall * 1e3 / steps,
                      "capture_ms": eng.timings.t_compile_us / 1e3,
                      **_device_summary(prof, wall, steps)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
