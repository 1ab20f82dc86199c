"""Timing loops on the CUDA card that chip_smoke.py does not run: the
tensor-core prefill tile at every tile width, decode attention and the
decode GEMV at the main paths' shapes, and decode chunks of one stream, the
last three for a tree given by its root, so that two trees can be timed in
turns within one call.

    python -m ggllm_tpu_torch.tools.time_kernels tile
    python ggllm_tpu_torch/tools/time_kernels.py attn [--root DIR]
    python ggllm_tpu_torch/tools/time_kernels.py decode [--root DIR]
        [--config falcon7b|falcon40b|llama7b] [--format q4_0] [--chunks 4] [--tokens 64]
    python ggllm_tpu_torch/tools/time_kernels.py gemv [--root DIR] [--family legacy|kq]
        [--shape q4_0:12288x4096 ...]

`tile` prints, per weight shape of the full-width models and S in 512 / 300,
the `wgmma` tile's time with 128 and 256 x rows a block, with the width
`tc_rows` picks, and `torch.matmul` on the dequantized bf16 weight (means of
10 launches between two CUDA events, no L2 flush: lower than chip_smoke.py's
medians with a flush). `decode` prints one JSON line: the prefill rate of a
300-token prompt and the milliseconds per token of each greedy chunk at
n_past 300. `attn` prints one JSON line per shape of the main paths' decode
attention (Falcon-7B G=71 KV=1 D=64 at 1 / 300 / 2047 valid positions,
Falcon-40B G=16 KV=8 at 300 / 2047, LLaMA-7B G=1 KV=32 D=128 at 1 / 300 /
2047; bf16 and int8 caches of the model's depth and 2560 positions):
`flash_decode` and `scaled_dot_product_attention` (on the dequantized bf16
cache for int8) timed two ways, `call_ms` = one call between two events as
an eager decode step pays it (host work included), and `graph_ms` = device
time, a CUDA graph of one call per layer replayed between two events,
divided by the layers (both: medians of 20, L2 flushed before each).
`gemv` prints one JSON line per decode weight shape of a family (legacy,
the default: Q4_0, Q4_1, Q5_0, Q5_1 and Q8_0 at the Falcon-7B shapes, Q4_0 at
LLaMA-7B's; kq: every K-quant at the Falcon-40B shapes, Q4_K at LLaMA-7B's;
bf16 x, bf16 y, f32 for lm_head): `quant_matmul` at S = 1 as `call_ms` (one
call between two events) and `graph_ms` (device time: a CUDA graph of one
call on each of 4 distinct weights, divided by 4), each with 1 and 2 W rows a
warp where the tree's GEMV has that choice for the format (and the tree's
pick under the plain keys), `torch.matmul` on the dequantized bf16 weight
timed the same two ways, the GEMV launch counters, and the byte bound at
3.35 TB/s (medians of 20, L2 flushed before each); `--shape FMT:OxK` (one or
more) times those weights instead of the family's.
--root names the directory that holds the `ggllm_tpu_torch` package to time
(default: the one this file lies in).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

TILE_SHAPES = (("q4_0", 22848, 4544), ("q4_0", 4544, 22720), ("q4_k", 9216, 8192),
               ("q4_k", 32768, 8192), ("q6_k", 9216, 8192), ("q4_0", 4096, 4096),
               ("q4_0", 4096, 11008))


def _event_ms(fn, n: int = 10) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def median_ms(fn, flush, runs: int = 20, warm: int = 3) -> float:
    """Median of `runs` event-timed calls of fn, `flush` (an L2-sized
    buffer) zeroed before each, outside the events."""
    import statistics

    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        times.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in times)


_WARM_STREAM = []  # the one side stream graph_ms warms up on


def graph_ms(step, n: int, flush, runs: int = 20) -> float:
    """Device time of one of the n calls step(i), i < n (one per layer, as a
    decode step makes them): a CUDA graph of all n, replayed between two
    events (median of `runs`, L2 flushed before each), divided by n. The
    warm-up runs on one stream for all calls: a library call keeps a
    workspace per stream it ran on (cuBLAS), which would otherwise pile up."""
    import torch
    if not _WARM_STREAM:
        _WARM_STREAM.append(torch.cuda.Stream())
    side = _WARM_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        for i in range(n):
            step(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            step(i)
    ms = median_ms(graph.replay, flush, runs) / n
    del graph
    return ms


# (layers, heads, K/V heads, head_dim, valid lengths): Falcon-7B, -40B, LLaMA-7B
ATTN_SHAPES = ((32, 71, 1, 64, (1, 300, 2047)), (60, 128, 8, 64, (300, 2047)),
               (32, 32, 32, 128, (1, 300, 2047)))


def time_attn(T: int = 2560) -> None:
    import torch
    import torch.nn.functional as F
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.kernels import flash_decode as fd
    from ggllm_tpu_torch.ops import kvcache
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    bf16 = torch.bfloat16
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    package = str(Path(build.__file__).resolve().parents[2])
    for L, H, KV, D, valids in ATTN_SHAPES:
        G = H // KV
        kv = torch.randn(L, 2, 1, T, KV, D, generator=gen, device="cuda").to(bf16)
        q = torch.randn(1, 1, H, D, generator=gen, device="cuda").to(bf16)
        kv8 = kvcache.quantize_new(kv)
        for cache_name, cache in (("bfloat16", kv), ("int8", kv8)):
            lib = kv if cache_name == "bfloat16" else (kv8[0].float() * kv8[1]).to(bf16)
            for valid in valids:
                kt = [lib[l, 0, :, :valid].transpose(1, 2) for l in range(L)]
                vt = [lib[l, 1, :, :valid].transpose(1, 2) for l in range(L)]
                if KV == 1:
                    kt = [k.expand(1, H, valid, D) for k in kt]
                    vt = [v.expand(1, H, valid, D) for v in vt]
                qt = q.transpose(1, 2)

                def sdpa(l):
                    return F.scaled_dot_product_attention(qt, kt[l], vt[l],
                                                          enable_gqa=G > 1 and KV > 1)

                def ours(l):
                    return fd.flash_decode(cache, KV, l, q, valid - 1)

                row = {"package": package, "cache": cache_name, "G": G, "KV": KV, "D": D,
                       "valid": valid, "call_ms": median_ms(lambda: ours(L - 1), flush),
                       "graph_ms": graph_ms(ours, L, flush),
                       "library_call_ms": median_ms(lambda: sdpa(L - 1), flush),
                       "library_graph_ms": graph_ms(sdpa, L, flush)}
                print(json.dumps(row), flush=True)
            del lib
        del kv, kv8


# the decode GEMVs' weights: every legacy format at Falcon-7B's shapes and
# every K-quant at Falcon-40B's, Q4_0 and Q4_K at LLaMA-7B's
_LLAMA7B = (("wqkv", 12288, 4096), ("w13", 22016, 4096), ("wo", 4096, 4096),
            ("w2", 4096, 11008), ("lm_head", 32000, 4096))
GEMV_SHAPES = {
    "legacy": tuple((fmt, name, O, K) for fmt in ("q4_0", "q4_1", "q5_0", "q5_1", "q8_0")
                    for name, O, K in (("wqkvu", 22848, 4544), ("w_od", 4544, 22720),
                                       ("lm_head", 65024, 4544)))
    + tuple(("q4_0", "llama." + name, O, K) for name, O, K in _LLAMA7B),
    "kq": tuple((fmt, name, O, K) for fmt in ("q4_k", "q3_k", "q5_k", "q2_k", "q6_k")
                for name, O, K in (("wqkv", 9216, 8192), ("ffn_up", 32768, 8192),
                                   ("w_od", 8192, 40960), ("lm_head", 65024, 8192)))
    + tuple(("q4_k", "llama." + name, O, K) for name, O, K in _LLAMA7B)}
GEMV_COPIES = 4  # distinct weights a graph walks, one call each, as a step's layers do


def time_gemv(shapes, bw: float = 3.35e12) -> None:
    import torch
    from ggllm_tpu_torch.core.dtypes import GGMLType
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.kernels import quant_matmul as qm
    from ggllm_tpu_torch.utils.benchgen import random_quant
    bf16 = torch.bfloat16
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    package = str(Path(build.__file__).resolve().parents[2])
    # the rows a warp per format where the tree's GEMV has a choice (an older
    # tree: the K-quants' only, or none)
    choice = getattr(qm, "GEMV_ROWS", None) or getattr(qm, "GEMV_KQ_ROWS", {})
    for fmt, name, O, K in shapes:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(O + K)
        ws = [random_quant(GGMLType[fmt.upper()], O, K, gen, "cuda") for _ in range(GEMV_COPIES)]
        x = torch.randn(1, K, generator=gen, device="cuda").to(bf16)
        out = torch.float32 if name.endswith("lm_head") else bf16
        nbytes = (sum(p.numel() * p.element_size() for p in ws[0].planes.values())
                  + 2 * K + O * (4 if out == torch.float32 else 2))
        row = {"package": package, "fmt": fmt, "weight": name, "O": O, "K": K,
               "bound_ms": nbytes / bw * 1e3}
        gtype = GGMLType[fmt.upper()]
        picked = choice.get(gtype)
        for rows in (None,) if picked is None else (1, 2):
            if rows is not None:
                choice[gtype] = rows
            key = "" if rows is None else f"_rows{rows}"
            row["call_ms" + key] = median_ms(lambda: qm.quant_matmul(ws[0], x, out), flush)
            row["graph_ms" + key] = graph_ms(lambda i: qm.quant_matmul(ws[i], x, out),
                                             GEMV_COPIES, flush)
        if picked is not None:  # the tree's own choice, under the plain keys
            choice[gtype] = picked
            row["rows"] = picked
            row["call_ms"] = row[f"call_ms_rows{picked}"]
            row["graph_ms"] = row[f"graph_ms_rows{picked}"]
        row["launches"] = {k: v for k, v in build.launch_counts.items()
                           if k.startswith("quant_matmul.gemv")}
        build.launch_counts.clear()
        deq = [w.dequantize(bf16) for w in ws]
        del ws
        row["library_call_ms"] = median_ms(lambda: torch.matmul(x, deq[0].t()), flush)
        row["library_graph_ms"] = graph_ms(lambda i: torch.matmul(x, deq[i].t()), GEMV_COPIES,
                                           flush)
        del deq
        print(json.dumps(row), flush=True)


def time_tile() -> None:
    import torch
    from ggllm_tpu_torch.core.dtypes import GGMLType
    from ggllm_tpu_torch.kernels import quant_matmul as qm
    from ggllm_tpu_torch.utils.benchgen import random_quant
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    bf16 = torch.bfloat16
    picked = qm.tc_rows
    for fmt, O, K in TILE_SHAPES:
        w = random_quant(GGMLType[fmt.upper()], O, K, gen, "cuda")
        wd = w.dequantize(bf16)
        for S in (512, 300):
            x = torch.randn(S, K, generator=gen, device="cuda").to(bf16)
            row = {"fmt": fmt, "O": O, "K": K, "S": S, "tc_rows": picked(S, O)}
            for nt in (128, 256):
                qm.tc_rows = lambda S_, O_, nt=nt: nt
                try:
                    row[f"ms_{nt}"] = _event_ms(lambda: qm.quant_matmul(w, x, bf16))
                finally:
                    qm.tc_rows = picked
            row["ms"] = _event_ms(lambda: qm.quant_matmul(w, x, bf16))
            row["library_ms"] = _event_ms(lambda: torch.matmul(x, wd.t()))
            print(json.dumps(row), flush=True)
        del w, wd


def time_decode(config: str, fmt: str, chunks: int, tokens: int) -> None:
    import numpy as np
    import torch
    from ggllm_tpu_torch.core.config import EngineConfig, named_hparams
    from ggllm_tpu_torch.core.dtypes import GGMLType
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.ops.sampling import SamplerParams
    from ggllm_tpu_torch.utils.benchgen import make_bench_params
    hp = named_hparams(config)
    eng = FalconEngine(hp, make_bench_params(hp, seed=7, gtype=GGMLType[fmt.upper()]),
                       EngineConfig(kv_dtype="bfloat16"))
    prompt = [int(t) for t in np.random.default_rng(0).integers(12, hp.n_vocab, 300)]
    greedy = SamplerParams(temp=0.0)
    eng.generate(prompt[:8], 4, greedy, stop_ids=set())  # warm-up
    eng.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = eng.eval(prompt)  # returns the logits on the host: the device is done
    prefill = time.perf_counter() - t0
    first, start = int(np.argmax(logits)), eng.n_past
    ms = []
    for _ in range(chunks):
        t0 = time.perf_counter()
        eng.decode_chunk(first, tokens, greedy, last_tokens=prompt + [first])
        ms.append((time.perf_counter() - t0) * 1e3 / tokens)
        eng.rollback(start)
        torch.cuda.synchronize()
    print(json.dumps({"package": str(Path(build.__file__).resolve().parents[2]),
                      "model": f"{config} {fmt}", "prefill_tok_s": len(prompt) / prefill,
                      "decode_ms_per_token": ms}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("tile", "attn", "decode", "gemv"))
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--config", choices=("falcon7b", "falcon40b", "llama7b"), default="falcon7b")
    ap.add_argument("--format", default="q4_0")
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--family", choices=("legacy", "kq"), default="legacy",
                    help="gemv: the legacy formats' shapes or the K-quants'")
    ap.add_argument("--shape", action="append", default=[],
                    help="gemv: a weight FMT:OxK to time instead, e.g. q4_0:12288x4096")
    args = ap.parse_args(argv)
    if "ggllm_tpu_torch" not in sys.modules:  # run as a file: take the package from --root
        sys.path.insert(0, args.root)
    if args.what == "tile":
        time_tile()
    elif args.what == "attn":
        time_attn()
    elif args.what == "gemv":
        shapes = GEMV_SHAPES[args.family]
        if args.shape:
            shapes = []
            for spec in args.shape:
                fmt, dims = spec.split(":")
                O, K = (int(v) for v in dims.split("x"))
                shapes.append((fmt, f"{O}x{K}", O, K))
        time_gemv(shapes)
    else:
        time_decode(args.config, args.format, args.chunks, args.tokens)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
