"""Timing loops on the CUDA card that chip_smoke.py does not run: the
tensor-core prefill tile at every tile width, decode attention and the
decode GEMV at the main paths' shapes, decode chunks of one stream, and the
f32 prefill kernels and f32 route, all but the first for a tree given by
its root, so that two trees can be timed in turns within one call.

    python -m ggllm_tpu_torch.tools.time_kernels tile
    python ggllm_tpu_torch/tools/time_kernels.py attn [--root DIR]
        [--cache bfloat16 --cache int8 --cache float32 --cache int8-f32q]
    python ggllm_tpu_torch/tools/time_kernels.py mqa32 [--root DIR]
    python ggllm_tpu_torch/tools/time_kernels.py decode [--root DIR]
        [--config falcon7b|falcon40b|falcon180b|llama7b] [--format q4_0] [--kv-dtype bfloat16]
        [--compute-dtype bfloat16] [--prompt 300] [--tokens 64] [--ctx 2048] [--batch 512]
    python ggllm_tpu_torch/tools/time_kernels.py gemv [--root DIR] [--family legacy|kq]
        [--shape q4_0:12288x4096 ...]
    python ggllm_tpu_torch/tools/time_kernels.py rows [--root DIR] [--shape q4_0:4544x22720 ...]
    python ggllm_tpu_torch/tools/time_kernels.py f32 [--root DIR]
    python ggllm_tpu_torch/tools/time_kernels.py group_sums [--root DIR]
    python ggllm_tpu_torch/tools/time_kernels.py f32path [--root DIR]
        [--config falcon7b|llama7b] [--format q4_0] [--layers 32]
    python ggllm_tpu_torch/tools/time_kernels.py nodes [--root DIR]
        [--config falcon7b|falcon40b|falcon180b|llama7b] [--format q4_0] [--kv-dtype bfloat16]
    python -m ggllm_tpu_torch.tools.time_kernels dispatch

`tile` prints, per weight shape of the full-width models and S in 512 / 300,
the `wgmma` tile's time with 128 and 256 x rows a block, with the width
`tc_rows` picks, and `torch.matmul` on the dequantized bf16 weight (means of
10 launches between two CUDA events, no L2 flush: lower than chip_smoke.py's
medians with a flush). `decode` prints one JSON line: the eager prefill of a
300-token prompt timed PREFILL_RUNS times in a row (wall ms each, ending
with the logits on the host; their median and its rate), then greedy
decode at n_past 300 (`--prompt`) through the replayed CUDA graph and
through the eager step body in turns (graph, eager, eager, graph;
`decode_turns`): wall ms a token, device-busy ms a token, idle
share and nodes a token, and the capture's ms; `--ctx` and `--batch` set the
engine's n_ctx and n_batch (the cache holds n_ctx + n_batch positions; a
prompt past 2048 needs a larger --ctx). `attn` prints one JSON line per shape of the main paths' decode
attention (Falcon-7B G=71 KV=1 D=64 at 1 / 300 / 2047 valid positions,
Falcon-40B G=16 KV=8 at 300 / 2047, LLaMA-7B G=1 KV=32 D=128 at 1 / 300 /
2047; caches of the model's depth and 2560 positions, `--cache` (one or
more; default bfloat16 and int8): bf16 q on a bfloat16 or int8 cache, f32 q
on a float32 cache or on an int8 one, "int8-f32q"):
`flash_decode` and `scaled_dot_product_attention` (on the dequantized cache
for int8, in q's dtype; f32 on the math backend, `sdpa`) timed two ways,
`call_ms` = one call between two events as an eager decode step pays it
(host work included), and `graph_ms` = device time, a CUDA graph of one
call per layer replayed between two events,
divided by the layers (both: medians of 20, L2 flushed before each);
`graph_device_length_ms` the same with the length in a device tensor, as
the decode graph passes it (the grid then covers all T positions).
`mqa32` prints one JSON line per shape of bf16 prefill attention at head
dim 32 (the small test models' B = 2, S = 45, n_past [300, 7], H = 6, KV = 2;
the training demo's S = 512, H = 4, KV = 1 at n_past 0 and 300): `flash_mqa`
as `call_ms` (one call between two events) and `graph_ms` (device time, a
CUDA graph of one call), `scaled_dot_product_attention` with the same causal
mask over the keys any row sees timed the same two ways, the launch counters the call moved, its
largest difference from the plain version as a share of max |plain|, and
its bounds (q, the visible K/V and out at 3.35 TB/s; 4 D operations a
visible (query, key) pair and head at 989 TFLOP/s; medians of 20, L2
flushed before each).
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
`rows` prints one JSON line per decode weight of the three families' B-row
steps (Falcon-7B Q4_0 wqkvu / w_od / lm_head, LLaMA-7B Q4_0 wqkv / wo / w13
/ w2 / lm_head, Falcon-40B Q4_K wqkv / ffn_up / w_od / lm_head; `--shape
FMT:OxK` instead) and S = 1 ... 32 rows of bf16 x (past 16, the batched
speculative rounds' verify, the tree routes to the tile) (bf16 y, f32 for lm_head),
all as device time (a CUDA graph of one call, median of 20, L2 flushed
before each): `quant_matmul` as the tree routes it (`graph_ms`: S = 1 the
GEMV, 2-16 the rows kernel where the tree has one, with `cluster` the
blocks that split K, also at every cluster size it is built for), the
tensor-core tile at the
same rows (`tile_graph_ms`: `quant_matmul_tc`, or a tree's own route where
it has none), `torch.matmul` on the dequantized bf16 weight and the byte
bound at 3.35 TB/s.
`f32` prints one JSON line per shape of the f32 prefill kernels: the f32
quant-matmul tile (f32 x and y) at every `TILE_SHAPES` weight for S in 512 and
300 (also at 64 and 128 x rows a block, where the tree's tile has the
choice) beside f32 `torch.matmul` on the dequantized f32 weight, and f32
`flash_mqa` at the two prefill attention layouts (Falcon-7B H=71 KV=1 D=64,
LLaMA-7B H=KV=32 D=128; S=512, n_past 300, a 2560-position cache layer)
beside f32 `scaled_dot_product_attention` on its math backend (`sdpa`;
medians of 20, L2 flushed before each; TF32 off for the library calls),
each with the launch counters it moved, its largest difference from the
plain version as a share of max |plain|, and its bounds: the bytes at
3.35 TB/s, the operations at the f32 rate outside the tensor cores
(67 TFLOP/s), and three bf16 products at 989 TFLOP/s (the tile) or three
TF32 products at 495 TFLOP/s (attention).
`group_sums` prints one JSON line per shape of the f32 paths' group sums
(f32 x, S = 300 and 512 at Falcon-7B's and LLaMA-7B's widths with 32-wide
groups, S = 512 at Falcon-40B's with 16-wide ones): `group_sums` beside
`torch.matmul` with a 0/1 group map (TF32 off), its largest difference from
the plain version as a share of max |plain|, and its byte bound (4 bytes an
element in, 4 a sum out, at 3.35 TB/s; medians of 20, L2 flushed before
each).
`f32path` prints one JSON line: a full-width model (`--layers` deep) with
float32 compute and cache prefills a 300-token prompt through the tree's
kernels (tok/s on the host clock, ending with the logits on the host, after
one untimed prefill of the same prompt: a kernel's first launch in a
process loads it) and through the plain versions; the largest logit difference as a share of max
|logit|, the positions whose argmax agree, whether both sets of logits are
finite, and the launch counters (`f32_path`, which chip_smoke.py's f32 paths
run too).
`nodes` prints one JSON line: the node count (`graph_nodes`) of the greedy
16-step decode graph (`SamplerParams(temp=0.0)`) of a full-width engine
with random weights, captured as chip_smoke.py's main paths capture it
(`generate` of 4 ids from an 8-token prompt); a tree whose graphs do not
keep their cudaGraph_t is made to keep it.
`dispatch` prints one JSON line per kernel entry: host microseconds a call
through its torch library op, through the public entry as an eager model
calls it, and straight to the op's CUDA implementation, at shapes the card
runs faster than the host launches them (`time_dispatch`).
--root names the directory that holds the `ggllm_tpu_torch` package to time
(default: the one this file lies in).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

PREFILL_RUNS = 5  # decode: timed prefills of the prompt, in a row
TILE_SHAPES = (("q4_0", 22848, 4544), ("q4_0", 4544, 22720), ("q4_k", 9216, 8192),
               ("q4_k", 32768, 8192), ("q6_k", 9216, 8192), ("q4_0", 4096, 4096),
               ("q4_0", 4096, 11008))


def sdpa(q, k, v, **kw):
    """torch's scaled_dot_product_attention, the library yardstick beside
    the attention kernels: f32 q on SDPA's math backend (on an H100 with
    torch 2.11 the memory-efficient kernel, which SDPA picks for f32, wrote
    past its tensors and corrupted a flash-decode workspace's arrival
    counter, as chip_smoke.py notes), bf16 q on the backend SDPA picks."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if q.dtype != torch.float32:
        return F.scaled_dot_product_attention(q, k, v, **kw)
    with sdpa_kernel(SDPBackend.MATH):
        return F.scaled_dot_product_attention(q, k, v, **kw)


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


def time_attn(caches=("bfloat16", "int8"), T: int = 2560) -> None:
    import torch
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
        kv32 = torch.randn(L, 2, 1, T, KV, D, generator=gen, device="cuda")
        q32 = torch.randn(1, 1, H, D, generator=gen, device="cuda")
        kv8 = kvcache.quantize_new(kv32)
        for cache_name in caches:
            f32 = cache_name in ("float32", "int8-f32q")
            q = q32 if f32 else q32.to(bf16)
            if cache_name.startswith("int8"):
                cache = kv8
                lib = (kv8[0].float() * kv8[1]).to(q.dtype)
            else:
                cache = lib = kv32.to(q.dtype)
            for valid in valids:
                kt = [lib[l, 0, :, :valid].transpose(1, 2) for l in range(L)]
                vt = [lib[l, 1, :, :valid].transpose(1, 2) for l in range(L)]
                if KV == 1:
                    kt = [k.expand(1, H, valid, D) for k in kt]
                    vt = [v.expand(1, H, valid, D) for v in vt]
                qt = q.transpose(1, 2)

                def library(l):
                    return sdpa(qt, kt[l], vt[l], enable_gqa=G > 1 and KV > 1)

                def ours(l):
                    return fd.flash_decode(cache, KV, l, q, valid - 1)

                n_past = torch.full((1,), valid - 1, dtype=torch.int32, device="cuda")

                def ours_dev(l):  # the decode graph's form: the grid covers all T
                    return fd.flash_decode(cache, KV, l, q, n_past)

                row = {"package": package, "cache": cache_name, "G": G, "KV": KV, "D": D,
                       "valid": valid, "call_ms": median_ms(lambda: ours(L - 1), flush),
                       "graph_ms": graph_ms(ours, L, flush),
                       "graph_device_length_ms": graph_ms(ours_dev, L, flush),
                       "library_call_ms": median_ms(lambda: library(L - 1), flush),
                       "library_graph_ms": graph_ms(library, L, flush)}
                print(json.dumps(row), flush=True)
            del lib, cache
        del kv32, kv8


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


# the decode weights of the three families' B-row steps
ROWS_SHAPES = (("q4_0", "wqkvu", 22848, 4544), ("q4_0", "w_od", 4544, 22720),
               ("q4_0", "lm_head", 65024, 4544)) + tuple(
    ("q4_0", "llama." + name, O, K) for name, O, K in _LLAMA7B) + (
    ("q4_k", "40b.wqkv", 9216, 8192), ("q4_k", "40b.ffn_up", 32768, 8192),
    ("q4_k", "40b.w_od", 8192, 40960), ("q4_k", "40b.lm_head", 65024, 8192))


def time_rows(shapes, bw: float = 3.35e12) -> None:
    import torch
    from ggllm_tpu_torch.core.dtypes import GGMLType
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.kernels import quant_matmul as qm
    from ggllm_tpu_torch.utils.benchgen import random_quant
    bf16 = torch.bfloat16
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    package = str(Path(build.__file__).resolve().parents[2])
    tile = getattr(qm, "quant_matmul_tc", qm.quant_matmul)  # a tree without the rows kernel
    picked = getattr(qm, "rows_cluster", None)
    for fmt, name, O, K in shapes:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(O + K)
        w = random_quant(GGMLType[fmt.upper()], O, K, gen, "cuda")
        wd = w.dequantize(bf16)
        out = torch.float32 if name.endswith("lm_head") else bf16
        wbytes = sum(p.numel() * p.element_size() for p in w.planes.values())
        for S in range(1, 33):
            x = torch.randn(S, K, generator=gen, device="cuda").to(bf16)
            row = {"package": package, "fmt": fmt, "weight": name, "O": O, "K": K, "S": S,
                   "bound_ms": (wbytes + S * K * 2 + S * O * out.itemsize) / bw * 1e3,
                   "graph_ms": graph_ms(lambda i: qm.quant_matmul(w, x, out), 1, flush)}
            if 1 < S <= getattr(qm, "ROWS_MAX_S", 0) and picked is not None:
                row["cluster"] = picked(O)
                for cl in qm.ROWS_CLUSTERS:
                    qm.rows_cluster = lambda O_, cl=cl: cl
                    try:
                        row[f"graph_ms_cl{cl}"] = graph_ms(lambda i: qm.quant_matmul(w, x, out), 1,
                                                           flush)
                    finally:
                        qm.rows_cluster = picked
            if S > 1:
                row["tile_graph_ms"] = graph_ms(lambda i: tile(w, x, out), 1, flush)
            row["library_graph_ms"] = graph_ms(lambda i: torch.matmul(x, wd.t()), 1, flush)
            row["launches"] = {k: v for k, v in build.launch_counts.items()
                               if k.startswith("quant_matmul.")}
            build.launch_counts.clear()
            print(json.dumps(row), flush=True)
        del w, wd


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


F32_ATTN_SHAPES = ((71, 1, 64), (32, 32, 128))  # (H, KV, D): Falcon-7B, LLaMA-7B


def time_f32(bw: float = 3.35e12) -> None:
    import torch
    from ggllm_tpu_torch.core.dtypes import GGMLType
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.kernels import flash_attention as fa
    from ggllm_tpu_torch.kernels import quant_matmul as qm
    from ggllm_tpu_torch.utils.benchgen import random_quant
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = torch.float32
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    base = {"package": str(Path(build.__file__).resolve().parents[2]),
            "card": torch.cuda.get_device_name(0)}

    def rel(got, ref) -> float:
        return float((got.float() - ref.float()).abs().max() / ref.float().abs().max())

    for fmt, O, K in TILE_SHAPES:
        w = random_quant(GGMLType[fmt.upper()], O, K, gen, "cuda")
        wd = w.dequantize(f32)
        wbytes = sum(p.numel() * p.element_size() for p in w.planes.values())
        for S in (512, 300):
            x = torch.randn(S, K, generator=gen, device="cuda")
            build.launch_counts.clear()
            err = rel(qm.quant_matmul(w, x, f32), qm.quant_matmul_plain(w, x, f32))
            ops = 2 * S * O * K
            row = {**base, "kernel": "quant_matmul f32", "fmt": fmt, "O": O, "K": K, "S": S,
                   "launches": dict(build.launch_counts), "rel_err": err}
            picked = getattr(qm, "f32_rows", None)  # a tree with a choice of tile widths
            for nt in () if picked is None else qm.F32_ROWS[1:]:
                qm.f32_rows = lambda *_, nt=nt: nt
                try:
                    row[f"ms_{nt}"] = median_ms(lambda: qm.quant_matmul(w, x, f32), flush)
                finally:
                    qm.f32_rows = picked
            if picked is not None:
                row["f32_rows"] = picked(S, O)
            row.update({"ms": median_ms(lambda: qm.quant_matmul(w, x, f32), flush),
                        "library_ms": median_ms(lambda: torch.matmul(x, wd.t()), flush),
                        "bytes_bound_ms": (wbytes + 4 * S * K + 4 * S * O) / bw * 1e3,
                        "f32_bound_ms": ops / 67e12 * 1e3,
                        "tensor_bound_ms": 3 * ops / 989e12 * 1e3})
            print(json.dumps(row), flush=True)
        del w, wd
    S, T, n_past = 512, 2560, 300
    for H, KV, D in F32_ATTN_SHAPES:
        kv = torch.randn(2, 1, T, KV, D, generator=gen, device="cuda")
        k, v = kv[0], kv[1]
        q = torch.randn(1, S, H, D, generator=gen, device="cuda")
        build.launch_counts.clear()
        err = rel(fa.flash_mqa(q, k, v, n_past), fa.flash_mqa_plain(q, k, v, n_past))
        Tv = n_past + S
        qt, kt, vt = q.transpose(1, 2), k[:, :Tv].transpose(1, 2), v[:, :Tv].transpose(1, 2)
        mask = (torch.arange(Tv, device="cuda")[None, :]
                <= n_past + torch.arange(S, device="cuda")[:, None])
        kt, vt = kt.expand(1, H, Tv, D), vt.expand(1, H, Tv, D)  # views: G == 1 or MQA
        ops = 4 * (S * n_past + S * (S + 1) // 2) * H * D
        row = {**base, "kernel": "flash_mqa f32", "S": S, "n_past": n_past, "H": H, "KV": KV,
               "D": D, "launches": dict(build.launch_counts), "rel_err": err,
               "ms": median_ms(lambda: fa.flash_mqa(q, k, v, n_past), flush),
               "library_ms": median_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask), flush),
               "bytes_bound_ms": 4 * (2 * S * H * D + 2 * Tv * KV * D) / bw * 1e3,
               "f32_bound_ms": ops / 67e12 * 1e3, "tensor_bound_ms": 3 * ops / 495e12 * 1e3}
        print(json.dumps(row), flush=True)
        del kv, q


# (B, S, H, KV, n_past, T): bf16 prefill attention at head dim 32
MQA32_SHAPES = ((2, 45, 6, 2, (300, 7), 400), (1, 512, 4, 1, (0,), 2560),
                (1, 512, 4, 1, (300,), 2560))


def time_mqa32(bw: float = 3.35e12, peak: float = 989e12) -> None:
    import torch
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    package = str(Path(build.__file__).resolve().parents[2])
    D = 32
    for B, S, H, KV, past, T in MQA32_SHAPES:
        kv = torch.randn(2, B, T, KV, D, generator=gen, device="cuda").to(torch.bfloat16)
        k, v = kv[0], kv[1]
        q = torch.randn(B, S, H, D, generator=gen, device="cuda").to(torch.bfloat16)
        n_past = (torch.tensor(past, dtype=torch.int32, device="cuda") if B > 1
                  else past[0])
        pos = torch.tensor(past, device="cuda")[:, None] + torch.arange(S, device="cuda")
        Tv = int(pos.max()) + 1  # the library call gets the keys any row sees
        mask = (torch.arange(Tv, device="cuda")[None, None, :] <= pos[:, :, None])[:, None]
        qt, kt, vt = q.transpose(1, 2), k[:, :Tv].transpose(1, 2), v[:, :Tv].transpose(1, 2)
        if KV == 1:  # the one K/V head broadcast to all query heads (a view, no copy)
            kt, vt = kt.expand(B, H, Tv, D), vt.expand(B, H, Tv, D)

        def library():
            return sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=KV > 1)

        def ours():
            return fa.flash_mqa(q, k, v, n_past)

        build.launch_counts.clear()
        got, ref = ours().float(), fa.flash_mqa_plain(q, k, v, n_past).float()
        launches = dict(build.launch_counts)
        err = float((got - ref).abs().max() / ref.abs().max())
        pairs = int((pos + 1).sum())
        nbytes = 2 * (2 * q.numel() + int((pos[:, -1] + 1).sum()) * 2 * KV * D)
        row = {"package": package, "B": B, "S": S, "H": H, "KV": KV, "D": D,
               "n_past": list(past), "T": T, "launches": launches, "rel_err": err,
               "call_ms": median_ms(ours, flush), "graph_ms": graph_ms(lambda i: ours(), 1, flush),
               "library_call_ms": median_ms(library, flush),
               "library_graph_ms": graph_ms(lambda i: library(), 1, flush),
               "bytes_bound_ms": nbytes / bw * 1e3, "ops_bound_ms": 4 * pairs * H * D / peak * 1e3}
        print(json.dumps(row), flush=True)
        del kv, q


GROUP_SUMS_SHAPES = tuple((S, K, 32) for S in (300, 512) for K in (4544, 22720, 4096, 11008)) + (
    (512, 8192, 16), (512, 40960, 16))


def time_group_sums(bw: float = 3.35e12) -> None:
    import torch
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.kernels import quant_matmul as qm
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    package = str(Path(build.__file__).resolve().parents[2])
    for S, K, g in GROUP_SUMS_SHAPES:
        x = torch.randn(S, K, generator=gen, device="cuda")
        emap = (torch.arange(K, device="cuda")[:, None] // g
                == torch.arange(K // g, device="cuda")[None, :]).float()
        ref = qm.group_sums_plain(x, g)
        err = float((qm.group_sums(x, g) - ref).abs().max() / ref.abs().max())
        print(json.dumps({"package": package, "card": torch.cuda.get_device_name(0), "S": S,
                          "K": K, "g": g, "rel_err": err,
                          "ms": median_ms(lambda: qm.group_sums(x, g), flush),
                          "library_ms": median_ms(lambda: torch.matmul(x, emap), flush),
                          "bound_ms": (S * K * 4 + S * K // g * 4) / bw * 1e3}), flush=True)
        del x, emap


def f32_path(config: str, fmt: str = "q4_0", n_layer: int = 2, after=None) -> dict:
    """The f32 route at full width and `n_layer` layers (random weights from
    seed 7): float32 compute and cache, one untimed prefill of a 300-token
    prompt (a kernel's first launch in a process loads it), the timed one
    (tok/s on the host clock, ending with the logits on the host) and its
    launch counters; then `after(eng, prompt, logits)` where given, on the
    same engine (its result under "after"); then the same prompt through
    the plain versions: the largest logit difference as a share of max
    |logit|, the positions whose argmax agree, and whether both sets of
    logits are finite. chip_smoke.py's f32 paths and `f32path` below."""
    import gc

    import numpy as np
    import torch
    from ggllm_tpu_torch.core.config import EngineConfig
    from ggllm_tpu_torch.core.dtypes import GGMLType
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.utils.benchgen import make_bench_params
    hp = _hparams(config, n_layer)
    params = make_bench_params(hp, compute_dtype=torch.float32, device="cuda", seed=7,
                               gtype=GGMLType[fmt.upper()])
    cfg = dict(kv_dtype="float32", compute_dtype="float32")
    eng = FalconEngine(hp, params, EngineConfig(**cfg))
    prompt = [int(t) for t in np.random.default_rng(0).integers(12, hp.n_vocab, 300)]
    eng.eval(prompt, logits_all=True)
    eng.reset()
    torch.cuda.synchronize()
    build.launch_counts.clear()
    t0 = time.perf_counter()
    got = eng.eval(prompt, logits_all=True)
    tps = len(prompt) / (time.perf_counter() - t0)
    launches = dict(build.launch_counts)
    extra = None if after is None else after(eng, prompt, got)
    plain = FalconEngine(hp, params, EngineConfig(kernel_layout=False, flash_attention=False,
                                                  **cfg))
    ref = plain.eval(prompt, logits_all=True)
    out = {"model": f"{config} {fmt} float32", "n_layer": n_layer, "prefill_tok_s": tps,
           "logit_rel_err": float(np.abs(got - ref).max() / np.abs(ref).max()),
           "argmax_same": int((got.argmax(1) == ref.argmax(1)).sum()),
           "finite": bool(np.isfinite(got).all() and np.isfinite(ref).all()),
           "launches": launches, "after": extra}
    del eng, plain, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def time_f32_path(config: str, fmt: str, n_layer: int) -> None:
    import torch
    from ggllm_tpu_torch.kernels import build
    r = f32_path(config, fmt, n_layer)
    del r["after"]
    print(json.dumps({"package": str(Path(build.__file__).resolve().parents[2]),
                      "card": torch.cuda.get_device_name(0), **r}), flush=True)


def chained_decode(eng, start: int, first: int, hist: list, n_tokens: int, sampler,
                   eager: bool = False, chunk: int = 16) -> tuple[list, float]:
    """n_tokens ids from n_past `start` (first sampled, not yet forwarded;
    hist the history ending with it) as chained chunk-token decode_chunk
    calls, through the replayed graphs or, with eager, the step body.
    Returns (the ids, tok/s on the host clock, ending with the ids on the
    host). A tree whose decode_chunk has no eager mode runs its own decode."""
    import inspect

    import torch

    kw = {"eager": eager} if "eager" in inspect.signature(eng.decode_chunk).parameters else {}
    eng.rollback(start)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, tok, gen = [], first, None
    for _ in range(n_tokens // chunk):
        toks, gen = eng.decode_chunk(tok, chunk, sampler, gen, last_tokens=hist + out, **kw)
        out += [int(t) for t in toks]
        tok = out[-1]
    return out, n_tokens / (time.perf_counter() - t0)


def replay_device_ms(eng, chunk: int, sampler, reps: int) -> float:
    """Device ms a token of `reps` back-to-back replays, between two CUDA
    events, of the engine's captured chunk-token graph for `sampler`, with
    its last inputs (the same cache positions and values). These replays
    are not credited to the launch counters."""
    import torch

    g = eng.chunk_graph(chunk, sampler)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        g.graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (reps * chunk)


def round_device_ms(spec, sampler, reps: int) -> float:
    """Device ms a round of `reps` back-to-back replays, between two CUDA
    events, of a SpeculativeDecoder's captured round graph for `sampler`
    (None: its batched-round graph, generate_rows'), from its last device
    state (each replay moves n_past on by the rounds' ids, into positions
    past the committed stream; the batched rounds' live mask as the last
    dispatch left it). Not credited to the launch counters."""
    import torch

    g = spec.rows_graph() if sampler is None else spec.round_graph(sampler)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        g.graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (reps * spec.rounds)


def decode_turns(eng, first: int, hist: list, n_tokens: int, chunk: int = 16) -> dict:
    """Greedy decode of n_tokens from the engine's n_past (first sampled, not
    yet forwarded; hist the history ending with it) by `chained_decode`,
    rolled back after each run: through the replayed graph and through the
    eager step body, in turns (graph, eager, eager, graph). Each turn is one
    run without the profiler (wall ms a token: host clock, ending with the
    ids on the host) and one under torch.profiler (device-busy ms a token:
    the union of the device's kernel, copy and fill intervals; nodes a
    token: their count). Idle share = 1 - busy / the unprofiled wall. The
    graph turns also give `replay_device_ms`. A tree whose decode_chunk has
    no eager mode runs the eager turns only."""
    import inspect

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ggllm_tpu_torch.ops.sampling import SamplerParams

    greedy = SamplerParams(temp=0.0)
    start = eng.n_past
    has_graph = "eager" in inspect.signature(eng.decode_chunk).parameters

    def run(eager: bool) -> float:
        return chained_decode(eng, start, first, hist, n_tokens, greedy, eager, chunk)[1]

    modes = ("graph", "eager", "eager", "graph") if has_graph else ("eager", "eager")
    if has_graph:
        run(False)  # capture
    turns: dict = {}
    for mode in modes:
        eager = mode == "eager"
        wall = n_tokens / run(eager)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall_prof = n_tokens / run(eager)
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        busy, end = 0.0, -1.0
        for a, b in spans:  # union of device intervals, in microseconds
            if a > end:
                busy, end = busy + b - a, b
            elif b > end:
                busy, end = busy + b - end, b
        row = {"wall_ms_per_token": wall * 1e3 / n_tokens,
               "device_busy_ms_per_token": busy / 1e3 / n_tokens,
               "idle_share": 1.0 - busy / 1e6 / wall,
               "profiled_wall_ms_per_token": wall_prof * 1e3 / n_tokens,
               "nodes_per_token": len(spans) / n_tokens}
        if not eager:
            row["replay_device_ms_per_token"] = replay_device_ms(eng, chunk, greedy, 4)
        turns.setdefault(mode, []).append(row)
    eng.rollback(start)
    if has_graph:
        turns["capture_ms"] = eng.timings.t_compile_us / 1e3
    return turns


def graph_nodes(cuda_graph) -> int:
    """The node count of a captured torch.cuda.CUDAGraph made with
    keep_graph=True (cuGraphGetNodes on its cudaGraph_t): its kernels,
    copies and fills, and the empty nodes that join the capture's streams.
    Unlike a profiler trace of a replay, it reads the graph itself."""
    import ctypes

    n = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(int(cuda_graph.raw_cuda_graph())), None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {rc}")
    return n.value


def time_nodes(config: str, fmt: str, kv_dtype: str) -> None:
    import numpy as np
    import torch

    keep = torch.cuda.CUDAGraph
    torch.cuda.CUDAGraph = lambda *a, **k: keep(keep_graph=True)
    from ggllm_tpu_torch.core.config import EngineConfig
    from ggllm_tpu_torch.core.dtypes import GGMLType
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.ops.sampling import SamplerParams
    from ggllm_tpu_torch.utils.benchgen import make_bench_params
    hp = _hparams(config)
    params = make_bench_params(hp, device="cuda", seed=7, gtype=GGMLType[fmt.upper()])
    eng = FalconEngine(hp, params, EngineConfig(kv_dtype=kv_dtype))
    prompt = [int(t) for t in np.random.default_rng(0).integers(12, hp.n_vocab, 8)]
    eng.generate(prompt, 4, SamplerParams(temp=0.0), stop_ids=set())
    graph = eng.chunk_graph(16, SamplerParams(temp=0.0)).graph
    torch.cuda.CUDAGraph = keep
    print(json.dumps({"package": str(Path(build.__file__).resolve().parents[2]),
                      "card": torch.cuda.get_device_name(0),
                      "model": f"{config} {fmt} kv {kv_dtype}",
                      "greedy_16_step_graph_nodes": graph_nodes(graph)}), flush=True)


def time_decode(config: str, fmt: str, kv_dtype: str, prompt_len: int, tokens: int,
                compute_dtype: str = "bfloat16", n_ctx: int = 2048, n_batch: int = 512) -> None:
    import numpy as np
    import torch
    from ggllm_tpu_torch.core.config import EngineConfig
    from ggllm_tpu_torch.core.dtypes import GGMLType
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.utils.benchgen import make_bench_params
    hp = _hparams(config)
    params = make_bench_params(hp, compute_dtype=getattr(torch, compute_dtype), seed=7,
                               gtype=GGMLType[fmt.upper()])
    eng = FalconEngine(hp, params, EngineConfig(n_ctx=n_ctx, n_batch=n_batch, kv_dtype=kv_dtype,
                                                compute_dtype=compute_dtype))
    prompt = [int(t) for t in np.random.default_rng(0).integers(12, hp.n_vocab, prompt_len)]
    eng.eval(prompt[:8])  # warm-up
    prefill_ms = []
    for _ in range(PREFILL_RUNS):  # the last leaves the prompt in the cache
        eng.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = eng.eval(prompt)  # returns the logits on the host: the device is done
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    median = float(np.median(prefill_ms))
    first = int(np.argmax(logits))
    turns = decode_turns(eng, first, prompt + [first], tokens)
    print(json.dumps({"package": str(Path(build.__file__).resolve().parents[2]),
                      "card": torch.cuda.get_device_name(0),
                      "model": f"{config} {fmt} kv {kv_dtype} compute {compute_dtype}",
                      "n_ctx": n_ctx, "n_batch": n_batch, "n_past": prompt_len,
                      "prefill_ms": prefill_ms, "prefill_ms_median": median,
                      "prefill_tok_s": len(prompt) / median * 1e3, "decode": turns}), flush=True)


def _hparams(config: str, n_layer: int | None = None):
    """The model as the tools build it (cut to n_layer layers where given):
    the preset, and a LLaMA at n_rot = head_dim (utils/benchgen.py
    bench_hparams' rule), formed here from named_hparams, which every tree
    under --root has, so that two trees timed in turns build the same
    model."""
    import dataclasses

    from ggllm_tpu_torch.core.config import named_hparams
    hp = named_hparams(config)
    if n_layer is not None:
        hp = dataclasses.replace(hp, n_layer=n_layer)
    return dataclasses.replace(hp, n_rot=hp.head_dim) if hp.arch == "llama" else hp


def time_dispatch(reps: int = 2000) -> None:
    """Host microseconds a call of each kernel through its torch library op
    (torch.ops.ggllm.*.default on the operands the entry would pass it),
    through the public entry (as an eager model calls it: the launcher
    after build.no_grad_inputs, the tracer test and, for a weight, the f32
    tile's sums test) and straight to the op's CUDA implementation (the
    launcher), a weight's planes looked up (plane_args) in each of the
    three, at shapes whose launches the card runs faster than the host
    makes them: `reps` calls, then a synchronize, in turns (op, entry,
    launcher, launcher, entry, op). op - launcher is the dispatcher's cost,
    entry - launcher the entry's own."""
    import numpy as np
    import torch
    from ggllm_tpu_torch.core.dtypes import GGMLType
    from ggllm_tpu_torch.kernels import flash_attention as fa
    from ggllm_tpu_torch.kernels import flash_decode as fd
    from ggllm_tpu_torch.kernels import quant_matmul as qm
    from ggllm_tpu_torch.utils.benchgen import random_quant
    ops = torch.ops.ggllm
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    bf16 = torch.bfloat16
    w = random_quant(GGMLType.Q4_0, 128, 256, gen, "cuda")
    meta = (int(w.gtype), 128, 256, bf16)
    x1 = torch.randn(1, 256, generator=gen, device="cuda").to(bf16)
    x32 = torch.randn(32, 256, generator=gen, device="cuda").to(bf16)
    xf = torch.randn(256, 256, generator=gen, device="cuda")
    q = torch.randn(1, 16, 4, 64, generator=gen, device="cuda").to(bf16)
    kv = torch.randn(2, 2, 1, 64, 1, 64, generator=gen, device="cuda").to(bf16)
    q1 = q[:, :1].contiguous()
    cases = {  # entry: (op, public entry, launcher); a weight's planes looked up in each
        "quant_matmul S=1 (gemv)": (
            lambda: ops.quant_matmul.default(x1, *qm.plane_args(w), None, *meta),
            lambda: qm.quant_matmul(w, x1, bf16),
            lambda: qm.quant_matmul_cuda(x1, qm.plane_args(w), None, *meta)),
        "quant_matmul S=32 (tile)": (
            lambda: ops.quant_matmul.default(x32, *qm.plane_args(w), None, *meta),
            lambda: qm.quant_matmul(w, x32, bf16),
            lambda: qm.quant_matmul_cuda(x32, qm.plane_args(w), None, *meta)),
        "group_sums": (lambda: ops.group_sums.default(xf, 32), lambda: qm.group_sums(xf, 32),
                       lambda: qm.group_sums_cuda(xf, 32)),
        "flash_mqa": (lambda: ops.flash_mqa.default(q, kv[0, 0], kv[0, 1], None, 8),
                      lambda: fa.flash_mqa(q, kv[0, 0], kv[0, 1], 8),
                      lambda: fa.flash_mqa_cuda(q, kv[0, 0], kv[0, 1], 8)),
        "flash_decode": (lambda: ops.flash_decode.default(kv, None, 1, 1, q1, None, 40, None,
                                                          None),
                         lambda: fd.flash_decode(kv, 1, 1, q1, 40),
                         lambda: fd.flash_decode_cuda(kv, 1, 1, q1, 40)),
    }

    def us(fn) -> float:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e6

    for name, fns in cases.items():
        runs = {"op": [], "entry": [], "launcher": []}
        for which in ("op", "entry", "launcher", "launcher", "entry", "op"):
            runs[which].append(us(dict(zip(runs, fns))[which]))
        launcher = float(np.mean(runs["launcher"]))
        print(json.dumps({"card": torch.cuda.get_device_name(0), "entry": name, "reps": reps,
                          "op_us": runs["op"], "entry_us": runs["entry"],
                          "launcher_us": runs["launcher"],
                          "op_minus_launcher_us": float(np.mean(runs["op"])) - launcher,
                          "entry_minus_launcher_us": float(np.mean(runs["entry"])) - launcher}),
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("tile", "attn", "mqa32", "decode", "gemv", "rows", "f32",
                                     "f32path", "group_sums", "nodes", "dispatch"))
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--config", choices=("falcon7b", "falcon40b", "falcon180b", "llama7b"),
                    default="falcon7b")
    ap.add_argument("--format", default="q4_0")
    ap.add_argument("--kv-dtype", default="bfloat16", choices=("bfloat16", "float32", "int8"))
    ap.add_argument("--compute-dtype", default="bfloat16", choices=("bfloat16", "float32"),
                    help="decode: the activations' dtype")
    ap.add_argument("--prompt", type=int, default=300, help="decode: n_past")
    ap.add_argument("--ctx", type=int, default=2048, help="decode: the engine's n_ctx")
    ap.add_argument("--batch", type=int, default=512, help="decode: the engine's n_batch")
    ap.add_argument("--layers", type=int, default=32, help="f32path: the model's depth")
    ap.add_argument("--tokens", type=int, default=64, help="decode: tokens a run (16-token chunks)")
    ap.add_argument("--family", choices=("legacy", "kq"), default="legacy",
                    help="gemv: the legacy formats' shapes or the K-quants'")
    ap.add_argument("--shape", action="append", default=[],
                    help="gemv, rows: a weight FMT:OxK to time instead, e.g. q4_0:12288x4096")
    ap.add_argument("--cache", action="append", default=[],
                    choices=("bfloat16", "int8", "float32", "int8-f32q"),
                    help="attn: the caches to time (default bfloat16 and int8)")
    args = ap.parse_args(argv)
    if "ggllm_tpu_torch" not in sys.modules:  # run as a file: take the package from --root
        sys.path.insert(0, args.root)
    if args.what == "tile":
        time_tile()
    elif args.what == "attn":
        time_attn(tuple(args.cache) or ("bfloat16", "int8"))
    elif args.what == "mqa32":
        time_mqa32()
    elif args.what == "f32":
        time_f32()
    elif args.what == "group_sums":
        time_group_sums()
    elif args.what == "f32path":
        time_f32_path(args.config, args.format, args.layers)
    elif args.what in ("gemv", "rows"):
        shapes = GEMV_SHAPES[args.family] if args.what == "gemv" else ROWS_SHAPES
        if args.shape:
            shapes = []
            for spec in args.shape:
                fmt, dims = spec.split(":")
                O, K = (int(v) for v in dims.split("x"))
                shapes.append((fmt, f"{O}x{K}", O, K))
        (time_gemv if args.what == "gemv" else time_rows)(shapes)
    elif args.what == "nodes":
        time_nodes(args.config, args.format, args.kv_dtype)
    elif args.what == "dispatch":
        time_dispatch()
    else:
        time_decode(args.config, args.format, args.kv_dtype, args.prompt, args.tokens,
                    args.compute_dtype, args.ctx, args.batch)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
