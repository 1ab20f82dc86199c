#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ggllm_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. build the hand-written kernels from ggllm_tpu_torch/csrc with nvcc, and
     read the decode GEMVs' SASS (cuobjdump): no I2F in any instantiation of
     the legacy or the K-quant GEMV;
  2. hold every kernel against its plain PyTorch version at the main-path
     shapes (quant_matmul in all ten formats: Q4_0 … Q8_0 at the Falcon-7B
     shapes, Q2_K … Q6_K at the Falcon-40B shapes, Q4_0 and Q4_K at the
     LLaMA-7B shapes, S = 1 through the K-quant GEMV (K-quants) or the
     legacy GEMV and S = 512 through the tensor-core tile; the tile also at
     S = 2, 17 and 300 and at a ragged O;
     the f32 SIMT tile at two shapes; the attention kernels at the three
     models' head layouts, bf16 through the tensor-core kernel, with a
     per-row n_past, and f32 through the SIMT kernels; flash-decode on bf16
     and on int8 caches, grouped heads through the tensor-core kernel and
     LLaMA's G == 1 through its own, with and without the append block and
     with a length per row, and f32 through the SIMT kernel), and time
     kernel, plain version and one PyTorch library call (CUDA events, after
     warm-up, median of 20 runs, L2 flushed before each run) beside the
     card's bound; the GEMVs (S = 1), flash-decode and their library calls
     also as device time (a CUDA graph of one call, or of one call per
     layer divided by the layers); and a dense
     bf16 weight at Falcon-7B's lm_head shape through ops/linear.py against
     the f32 product;
  3. drive the main path at full width and full depth through the engine's
     entry points, with random weights from a seed, six times: Falcon-7B
     Q4_0 and Q4_1 (32 layers), Falcon-40B Q4_K (60 layers) and LLaMA-7B
     Q4_0 (32 layers) on a bf16 cache; Falcon-40B Q3_K (60 layers) and
     LLaMA-7B Q4_K (32 layers) on an int8 cache: prefill a 300-token prompt,
     greedy-decode 128 tokens, then 32 sampled tokens, counting kernel
     launches (set to 0 just before each path and read just after); Falcon-7B
     Q4_0 also samples 32 tokens at top_k 0 (the host cascade); then
     prefill again through the plain versions and compare the logits of all
     300 positions (and the argmax wherever the plain version decides it by
     more than twice the measured difference), then one decode step (S = 1)
     of the same token on both engines, held the same way; the decode step
     must run the format's GEMV and not the other. The int8 paths also time
     16-token decode chunks at n_past 400 (LLaMA: and at n_past 1900) on an
     int8 and on a bf16 cache, in turns. Each model's parameters are freed
     before the next one is built. On these bf16 paths prefill must run the
     tensor-core tile and attention kernel and neither SIMT kernel, and
     decode the head layout's and cache's decode kernel and no other. A
     seventh, shallow path (Falcon-7B Q4_0, full width, 2 layers, float32
     compute and cache) prefills the prompt through the f32 SIMT tile,
     group_sums and the f32 attention kernel and must agree with the plain
     versions to 1e-4, then decodes 8 tokens through the legacy GEMV (f32 x
     and y) and the SIMT decode kernel;
  4. write small files with the port's writers (Falcon GGCC: Q4_0 7B-style;
     Q4_K, Q2_K and Q3_K 40B-style; LLaMA GGJT: Q4_0 and Q4_K) and run the
     CLI on each, all at once, the Q3_K and the LLaMA Q4_K file with
     --kv-dtype int8.
The last two lines of standard output are the kernel table as JSON and
{"ok": true, "device": {...}}. Per-shape rows also go to
chiprun_out/chip_smoke_kernels.json.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 2e-2  # of max |plain|, bf16 inputs (tests/test_kernels.py:45)
LOGIT_TOL = 5e-2
N_RUNS, N_WARM = 20, 3

# card peaks (NVIDIA data sheets; dense bf16 tensor rate)
PEAKS = {"sxm": (3.35e12, 989e12), "pcie": (2.0e12, 756e12), "nvl": (3.9e12, 835e12)}

QUANT_FORMATS = ["q4_0", "q4_1", "q5_0", "q5_1", "q8_0", "q4_k", "q5_k", "q6_k", "q2_k", "q3_k"]
F32_LOGIT_TOL = 1e-4  # f32 path against the plain versions (tests/test_torch_cuda.py)
# kernel -> (source, the TPU kernel it replaces). "quant_matmul" is the S == 1
# GEMV of the legacy formats, ".gemv.kq" the K-quants' S == 1 GEMV (both
# around the loop of ggllm_tpu_torch/csrc/gemv.cuh), ".tc" the
# bf16 tensor-core tile, ".simt" the f32 tile; "flash_mqa" the
# f32 attention kernels, ".tc" the bf16 tensor-core one. COUNTER names the
# launch counter of a kernel where it is not the kernel's own name.
REPLACES = {
    "quant_matmul": ("ggllm_tpu_torch/csrc/quant_gemv_legacy.cu",
                     "ggllm_tpu/kernels/quant_matmul.py:57"),
    "quant_matmul.gemv.kq": ("ggllm_tpu_torch/csrc/quant_gemv_kq.cu",
                             "ggllm_tpu/kernels/quant_matmul.py:57"),
    "quant_matmul.tc": ("ggllm_tpu_torch/csrc/quant_gemm_tc.cuh",
                        "ggllm_tpu/kernels/quant_matmul.py:57"),
    "quant_matmul.simt": ("ggllm_tpu_torch/csrc/quant_matmul.cu",
                          "ggllm_tpu/kernels/quant_matmul.py:57"),
    "group_sums": ("ggllm_tpu_torch/csrc/quant_matmul.cu", "ggllm_tpu/kernels/quant_matmul.py:189"),
    "flash_mqa": ("ggllm_tpu_torch/csrc/flash_attention.cu", "ggllm_tpu/kernels/flash_attention.py:33"),
    "flash_mqa.tc": ("ggllm_tpu_torch/csrc/flash_attention_tc.cu",
                     "ggllm_tpu/kernels/flash_attention.py:33"),
    # grouped query heads: bf16 q on the tensor cores, on a bf16 and (the same
    # Pallas kernel with quant=True, its int8 branches at :79 and :93) an int8
    # cache; f32 q (and head_dim 32) on the SIMT kernel
    "flash_decode_tc": ("ggllm_tpu_torch/csrc/flash_decode_tc.cu",
                        "ggllm_tpu/kernels/flash_decode.py:56"),
    "flash_decode_tc.int8": ("ggllm_tpu_torch/csrc/flash_decode_tc.cu",
                             "ggllm_tpu/kernels/flash_decode.py:79"),
    "flash_decode.simt": ("ggllm_tpu_torch/csrc/flash_decode.cu",
                          "ggllm_tpu/kernels/flash_decode.py:56"),
    # the G == 1 kernel, dense and with quant=True
    "flash_decode.mha": ("ggllm_tpu_torch/csrc/flash_decode.cu",
                         "ggllm_tpu/kernels/flash_decode.py:123"),
    "flash_decode.mha.int8": ("ggllm_tpu_torch/csrc/flash_decode.cu",
                              "ggllm_tpu/kernels/flash_decode.py:123"),
}
COUNTER = {"quant_matmul": "quant_matmul.gemv", "flash_mqa": "flash_mqa.simt"}
# every flash-decode launch counter: the wrapper's (by head layout and cache)
# and the route's
DECODE_COUNTERS = ("flash_decode", "flash_decode.int8", "flash_decode.mha", "flash_decode.mha.int8",
                   "flash_decode_tc", "flash_decode_tc.int8", "flash_decode.simt")


def log(msg: str):
    print(msg, flush=True)


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


class Timer:
    """Median device time of a callable: CUDA events around each run, the
    L2 cache flushed (a 256 MB write) before each run, outside the events
    (tools/time_kernels.py median_ms)."""

    def __init__(self, torch):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        from ggllm_tpu_torch.tools.time_kernels import median_ms

        return median_ms(fn, self.flush, N_RUNS, N_WARM)


def check(name: str, got, ref) -> tuple[float, float]:
    """(max abs err, max abs err / max |ref|); raises above TOL."""
    got, ref = got.float(), ref.float()
    if not bool(got.isfinite().all()):
        raise RuntimeError(f"{name}: kernel output is not finite")
    err = float((got - ref).abs().max())
    rel = err / max(float(ref.abs().max()), 1e-30)
    if rel > TOL:
        raise RuntimeError(f"{name}: max err {err:.3e} = {rel:.3e} of max|ref| > {TOL}")
    return err, rel


def phase_kernels(torch, timer, bw, peak) -> list[dict]:
    """Every kernel against its plain version at the main-path shapes."""
    import torch.nn.functional as F

    from ggllm_tpu_torch.core.dtypes import GGMLType
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.kernels import flash_decode as fd
    from ggllm_tpu_torch.kernels import quant_matmul as qm
    from ggllm_tpu_torch.kernels.flash_attention import flash_mqa, flash_mqa_plain
    from ggllm_tpu_torch.models.falcon import FalconStatic, _attention
    from ggllm_tpu_torch.ops import kvcache
    from ggllm_tpu_torch.tools.time_kernels import graph_ms
    from ggllm_tpu_torch.utils.benchgen import random_quant

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    bf16 = torch.bfloat16
    rows = []

    def row(kernel, shape, err, rel, ms, plain_ms, lib_ms, nbytes, ops, **device_ms):
        tb, to = nbytes / bw * 1e3, ops / peak * 1e3
        r = {"kernel": kernel, "shape": shape, "max_abs_err": err, "rel_err": rel, "ms": ms,
             "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": max(tb, to),
             "bound_by": "bytes" if tb >= to else "operations", **device_ms}
        rows.append(r)
        dev = "".join(f"  {k} {v:.4f}" for k, v in device_ms.items())
        log(f"  {kernel:13s} {shape:34s} err {err:.2e} ({rel:.1e} rel)  kernel {ms:.4f} ms"
            f"  plain {plain_ms:.4f} ms  library {lib_ms if lib_ms is None else round(lib_ms, 4)} ms"
            f"  bound {r['bound_ms']:.4f} ms ({r['bound_by']}){dev}")

    # ---- quant_matmul (+ group_sums inside at S >= 256), every format at
    # its model's main-path shapes, then Q4_0 and Q4_K at LLaMA-7B's
    shapes_7b = (("wqkvu", 22848, 4544), ("w_od", 4544, 22720), ("lm_head", 65024, 4544))
    shapes_40b = (("wqkv", 9216, 8192), ("ffn_up", 32768, 8192), ("w_od", 8192, 40960),
                  ("lm_head", 65024, 8192))
    shapes_llama = (("llama.wqkv", 12288, 4096), ("llama.w13", 22016, 4096),
                    ("llama.wo", 4096, 4096), ("llama.w2", 4096, 11008),
                    ("llama.lm_head", 32000, 4096))
    def matmul_row(fmt, wname, w, wbytes, wdeq, S, xdtype, out_dtype):
        """One (weight, S, x dtype) case: the route's kernel against the plain
        version, counted under its own counter, timed beside `x @ wdeq^T`;
        a GEMV (S = 1) and its library call also as device time (a CUDA
        graph of one call)."""
        (O, K), path = w.shape, qm.route(S, xdtype, w.gtype)
        if path == "gemv" and qm.gemv_kernel(w.gtype) == "kq":
            path = "gemv.kq"
        x = torch.randn(S, K, generator=gen, device="cuda").to(xdtype)
        before = build.launch_counts[f"quant_matmul.{path}"]
        got = qm.quant_matmul(w, x, out_dtype)
        if build.launch_counts[f"quant_matmul.{path}"] != before + 1:
            raise RuntimeError(f"quant_matmul {fmt} S={S} {xdtype} did not run the {path} kernel")
        ref = qm.quant_matmul_plain(w, x, out_dtype)
        err, rel = check(f"quant_matmul {fmt} {wname} S={S} {path}", got, ref)
        ms = timer(lambda: qm.quant_matmul(w, x, out_dtype))
        plain_ms = timer(lambda: qm.quant_matmul_plain(w, x, out_dtype))
        lib_ms = timer(lambda: torch.matmul(x, wdeq.t()))
        nbytes = (wbytes + S * K * x.element_size()
                  + S * O * (4 if out_dtype == torch.float32 else 2))
        device_ms = {}
        if S == 1:
            device_ms = {"graph_ms": graph_ms(lambda i: qm.quant_matmul(w, x, out_dtype), 1,
                                              timer.flush),
                         "library_graph_ms": graph_ms(lambda i: torch.matmul(x, wdeq.t()), 1,
                                                      timer.flush)}
        row("quant_matmul" if path == "gemv" else f"quant_matmul.{path}",
            f"{fmt} {wname} O={O} K={K} S={S}", err, rel, ms, plain_ms, lib_ms, nbytes,
            2 * S * O * K, **device_ms)

    cases = [(fmt, shapes_40b if GGMLType[fmt.upper()] in qm.K_QUANTS else shapes_7b)
             for fmt in QUANT_FORMATS]
    cases += [("q4_0", shapes_llama), ("q4_k", shapes_llama)]
    for fmt, shapes in cases:
        gtype = GGMLType[fmt.upper()]
        for wname, O, K in shapes:
            w = random_quant(gtype, O, K, gen, "cuda")
            wbytes = sum(p.numel() * p.element_size() for p in w.planes.values())
            wdeq = w.dequantize(bf16)
            out_dtype = torch.float32 if wname.endswith("lm_head") else bf16
            for S in (1, 512):
                matmul_row(fmt, wname, w, wbytes, wdeq, S, bf16, out_dtype)
            del w, wdeq

    # ---- the tensor-core tile off the main-path shapes: short and ragged S
    # (2 and 17 rows: the 16- and 64-row tiles; 300: two 256-row chunks, or
    # three of 128 rows where those fill the card better) at
    # one legacy and one K-quant weight, and an O that is no multiple of 64;
    # then the f32 SIMT tile, which serves f32 x only, at the same two weights
    for fmt, wname, O, K in (("q4_0", "wqkvu", 22848, 4544), ("q4_k", "wqkv", 9216, 8192),
                             ("q4_0", "ragged", 4500, 4544), ("q4_k", "ragged", 9001, 8192)):
        w = random_quant(GGMLType[fmt.upper()], O, K, gen, "cuda")
        wbytes = sum(p.numel() * p.element_size() for p in w.planes.values())
        wdeq = w.dequantize(bf16)
        for S in ((300,) if wname == "ragged" else (2, 17, 300)):
            matmul_row(fmt, wname, w, wbytes, wdeq, S, bf16, bf16)
        if wname != "ragged":
            matmul_row(fmt, wname, w, wbytes, wdeq.float(), 512, torch.float32, torch.float32)
        del w, wdeq

    # ---- group_sums: 32-wide at the Falcon-7B and LLaMA-7B widths, 16-wide
    # (Q2_K, Q3_K, Q6_K) at the 40B ones
    for K, g in ((4544, 32), (22720, 32), (8192, 16), (40960, 16), (4096, 32), (11008, 32)):
        S = 512
        x = torch.randn(S, K, generator=gen, device="cuda").to(bf16)
        emap = (torch.arange(K, device="cuda")[:, None] // g
                == torch.arange(K // g, device="cuda")[None, :]).to(bf16)
        err, rel = check(f"group_sums K={K} g={g}", qm.group_sums(x, g),
                         qm.group_sums_plain(x, g))
        ms = timer(lambda: qm.group_sums(x, g))
        plain_ms = timer(lambda: qm.group_sums_plain(x, g))
        lib_ms = timer(lambda: torch.matmul(x, emap))
        row("group_sums", f"S={S} K={K} g={g}", err, rel, ms, plain_ms, lib_ms,
            S * K * 2 + S * K // g * 4, S * K)
        del emap

    # ---- flash_mqa: S=512 against one (1, T=2560, KV, D) cache layer, at
    # Falcon-7B's 71 heads over one K/V head, Falcon-40B's 128 over 8 (D = 64)
    # and LLaMA-7B's 32 heads with a K/V head each (D = 128)
    T, S = 2560, 512

    def mqa_row(q, k, v, n_past, H, KV, D):
        """One case through the wrapper: bf16 runs the tensor-core kernel, f32
        the SIMT kernels; timed beside scaled_dot_product_attention."""
        name = "flash_mqa.tc" if q.dtype == bf16 else "flash_mqa"
        counter = COUNTER.get(name, name)
        before = build.launch_counts[counter]
        got = flash_mqa(q, k, v, n_past)
        if build.launch_counts[counter] != before + 1:
            raise RuntimeError(f"flash_mqa {q.dtype} D={D} did not count under {counter}")
        err, rel = check(f"{name} H={H} KV={KV} n_past={n_past}", got,
                         flash_mqa_plain(q, k, v, n_past))
        ms = timer(lambda: flash_mqa(q, k, v, n_past))
        plain_ms = timer(lambda: flash_mqa_plain(q, k, v, n_past))
        Tv = n_past + S
        qt = q.transpose(1, 2)
        kt, vt = k[:, :Tv].transpose(1, 2), v[:, :Tv].transpose(1, 2)
        mask = (torch.arange(Tv, device="cuda")[None, :]
                <= n_past + torch.arange(S, device="cuda")[:, None])
        if KV == 1:  # the one K/V head broadcast to all query heads (a view, no copy)
            kt, vt = kt.expand(1, H, Tv, D), vt.expand(1, H, Tv, D)
            lib_ms = timer(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
        else:
            lib_ms = timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True))
        pairs = S * n_past + S * (S + 1) // 2  # visible (query, key) pairs
        eb = q.element_size()
        row(name, f"S={S} n_past={n_past} H={H} KV={KV} D={D}", err, rel, ms, plain_ms, lib_ms,
            2 * S * H * D * eb + 2 * Tv * KV * D * eb, 4 * pairs * H * D)

    for H, KV, D, past in ((71, 1, 64, (0, 300)), (128, 8, 64, (0,)), (32, 32, 128, (0, 300))):
        kvc = torch.randn(1, 2, 1, T, KV, D, generator=gen, device="cuda").to(bf16)
        k, v = kvc[0, 0], kvc[0, 1]
        q = torch.randn(1, S, H, D, generator=gen, device="cuda").to(bf16)
        for n_past in past:
            mqa_row(q, k, v, n_past, H, KV, D)
        if KV != 8:  # the f32 kernels, once per layout they still serve
            mqa_row(q.float(), k.float(), v.float(), past[-1], H, KV, D)
        # a batch of two with its own n_past per row (300 query rows each)
        kv2 = torch.randn(1, 2, 2, T, KV, D, generator=gen, device="cuda").to(bf16)
        q2 = torch.randn(2, 300, H, D, generator=gen, device="cuda").to(bf16)
        rows_past = torch.tensor([300, 7], dtype=torch.int32, device="cuda")
        err, rel = check(f"flash_mqa.tc H={H} KV={KV} per-row n_past",
                         flash_mqa(q2, kv2[0, 0], kv2[0, 1], rows_past),
                         flash_mqa_plain(q2, kv2[0, 0], kv2[0, 1], rows_past))
        log(f"  flash_mqa.tc  B=2 S=300 n_past=[300, 7] H={H} KV={KV} D={D} err {err:.2e}"
            f" ({rel:.1e} rel)")

    # ---- flash_decode: the last layer of the full cache (32 layers at
    # Falcon-7B and LLaMA-7B, 60 at 40B); grouped heads take the tensor-core
    # kernel, H == KV the G == 1 kernel, each on a bf16 and an int8 cache.
    # Timed two ways: one call between events (ms: what an eager decode step
    # pays, host work included) and device time (graph_ms: a CUDA graph of one
    # call per layer, as a decode step makes them, divided by the layers); the
    # library call both ways too
    for L, H, KV, D, valids in ((32, 71, 1, 64, (1, 300, 2047)), (60, 128, 8, 64, (300, 2047)),
                                (32, 32, 32, 128, (1, 300, 2047))):
        l, G = L - 1, H // KV
        kv = torch.randn(L, 2, 1, T, KV, D, generator=gen, device="cuda").to(bf16)
        q1 = torch.randn(1, 1, H, D, generator=gen, device="cuda").to(bf16)
        qg = q1.reshape(1, KV, G, D)
        app = torch.randn(2, 1, 16, KV, D, generator=gen, device="cuda").to(bf16)
        st = FalconStatic(n_layer=L, n_head=H, n_head_kv=KV, head_dim=D, n_embd=H * D,
                          n_ff=4 * H * D, n_vocab=0, parallel_norms=KV > 1)
        # the same cache as int8 codes + f32 scales: q stays bf16; the reference
        # attends codes * scales in f32; the library call gets the dequantized
        # cache in bf16 (it has no int8 form)
        kv8 = kvcache.quantize_new(kv)
        deq32 = kv8[0][l].float() * kv8[1][l]  # (2, 1, T, KV, D)
        deq = torch.stack([(kv8[0][i].float() * kv8[1][i]).to(bf16) for i in range(L)])
        base = "flash_decode_tc" if G > 1 else "flash_decode.mha"
        for name, cache, kr, vr, lib_kv, per_pos in (
                (base, kv, kv[l, 0], kv[l, 1], kv, 2 * D),
                (base + ".int8", kv8, deq32[0], deq32[1], deq, D + 4)):
            tag = "int8 " if name.endswith("int8") else ""
            for valid in valids:
                # cache valid below `valid`: no append -> n_past = valid - 1;
                # append with 5 valid entries -> n_past = valid + 4
                before = build.launch_counts[name]
                got = fd.flash_decode(cache, KV, l, q1, valid - 1)
                if build.launch_counts[name] != before + 1:
                    raise RuntimeError(f"flash_decode {tag}G={G} did not run the {name} kernel")
                err, rel = check(f"{name} G={G} valid={valid}", got,
                                 _attention(q1, kr, vr, valid - 1, st))
                err_a, rel_a = check(f"{name} G={G} valid={valid} +append",
                                     fd.flash_decode(cache, KV, l, q1, valid + 4, kv_append=app,
                                                     append_valid=5),
                                     _attention(q1, kr, vr, valid + 4, st, kv_append=app,
                                                append_valid=5))
                acc, m, lsum = fd.cache_partials(cache, KV, l, qg, valid)
                acc_p, m_p, l_p = fd.cache_partials_plain(cache, KV, l, qg, valid)
                check(f"cache_partials {tag}G={G} valid={valid}", acc / lsum, acc_p / l_p)
                check(f"cache_partials {tag}m G={G} valid={valid}", m, m_p)
                ms = timer(lambda: fd.flash_decode(cache, KV, l, q1, valid - 1))
                dev_ms = graph_ms(lambda i: fd.flash_decode(cache, KV, i, q1, valid - 1), L,
                                  timer.flush)
                plain_ms = timer(lambda: fd.flash_decode_plain(cache, KV, l, q1, valid - 1))
                kt = [lib_kv[i, 0, :, :valid].transpose(1, 2) for i in range(L)]
                vt = [lib_kv[i, 1, :, :valid].transpose(1, 2) for i in range(L)]
                if KV == 1:
                    kt = [k.expand(1, H, valid, D) for k in kt]
                    vt = [v.expand(1, H, valid, D) for v in vt]

                def sdpa(i):
                    return F.scaled_dot_product_attention(q1.transpose(1, 2), kt[i], vt[i],
                                                          enable_gqa=G > 1 and KV > 1)

                lib_ms = timer(lambda: sdpa(l))
                lib_dev_ms = graph_ms(sdpa, L, timer.flush)
                # bytes: K and V of the valid prefix (per position and K/V head
                # 2 D in bf16, D + 4 as codes and a scale), q and the output
                row(name, f"{tag}valid={valid} G={G} KV={KV} D={D} (+append err {err_a:.1e})",
                    max(err, err_a), max(rel, rel_a), ms, plain_ms, lib_ms,
                    2 * valid * KV * per_pos + 2 * H * D * 2, 4 * valid * H * D,
                    graph_ms=dev_ms, library_graph_ms=lib_dev_ms)
        # one length per batch row (B = 2, two layers of this cache), with and
        # without the append block
        kv2 = torch.randn(2, 2, 2, T, KV, D, generator=gen, device="cuda").to(bf16)
        q2 = torch.randn(2, 1, H, D, generator=gen, device="cuda").to(bf16)
        app2 = torch.randn(2, 2, 16, KV, D, generator=gen, device="cuda").to(bf16)
        kv8_2 = kvcache.quantize_new(kv2)
        deq2 = kv8_2[0][1].float() * kv8_2[1][1]
        lens = torch.tensor([2047, 300], dtype=torch.int32, device="cuda")
        for name, cache, kr, vr in ((base, kv2, kv2[1, 0], kv2[1, 1]),
                                    (base + ".int8", kv8_2, deq2[0], deq2[1])):
            err, rel = check(f"{name} per-row valid", fd.flash_decode(cache, KV, 1, q2, lens - 1),
                             _attention(q2, kr, vr, lens - 1, st))
            err_a, rel_a = check(f"{name} per-row valid +append",
                                 fd.flash_decode(cache, KV, 1, q2, lens + 4, kv_append=app2,
                                                 append_valid=5),
                                 _attention(q2, kr, vr, lens + 4, st, kv_append=app2,
                                            append_valid=5))
            log(f"  {name:13s} B=2 valid=[2047, 300] G={G} err {err:.2e} ({rel:.1e} rel),"
                f" +append {err_a:.2e} ({rel_a:.1e} rel)")
        del kv, kv8, deq, deq32, kv2, kv8_2, deq2

    # ---- the SIMT kernel of grouped heads, which serves f32 queries: the
    # 2-layer float32 path's decode shape (Falcon-7B heads, f32 cache)
    L, H, KV, D, valid = 2, 71, 1, 64, 300
    kv = torch.randn(L, 2, 1, T, KV, D, generator=gen, device="cuda")
    q1 = torch.randn(1, 1, H, D, generator=gen, device="cuda")
    st = FalconStatic(n_layer=L, n_head=H, n_head_kv=KV, head_dim=D, n_embd=H * D,
                      n_ff=4 * H * D, n_vocab=0, parallel_norms=False)
    before = build.launch_counts["flash_decode.simt"]
    err, rel = check("flash_decode.simt f32", fd.flash_decode(kv, KV, 1, q1, valid - 1),
                     _attention(q1, kv[1, 0], kv[1, 1], valid - 1, st))
    if build.launch_counts["flash_decode.simt"] != before + 1:
        raise RuntimeError("f32 flash_decode did not run the SIMT kernel")
    kt, vt = (kv[1, i, :, :valid].transpose(1, 2).expand(1, H, valid, D) for i in (0, 1))
    row("flash_decode.simt", f"f32 valid={valid} G={H} KV={KV} D={D}", err, rel,
        timer(lambda: fd.flash_decode(kv, KV, 1, q1, valid - 1)),
        timer(lambda: fd.flash_decode_plain(kv, KV, 1, q1, valid - 1)),
        timer(lambda: F.scaled_dot_product_attention(q1.transpose(1, 2), kt, vt)),
        2 * valid * KV * D * 4 + 2 * H * D * 4, 4 * valid * H * D,
        graph_ms=graph_ms(lambda i: fd.flash_decode(kv, KV, i, q1, valid - 1), L, timer.flush))
    del kv

    # ---- a dense weight at Falcon-7B's lm_head shape (an F16 tensor as the
    # loader holds it: in the compute dtype, bf16), bf16 x, S = 1: linear's
    # bf16 product with f32 output against the earlier f32 copy of the weight
    from ggllm_tpu_torch.ops.linear import linear

    w = (torch.randn(65024, 4544, generator=gen, device="cuda") * 0.02).half().to(bf16)
    x = torch.randn(1, 4544, generator=gen, device="cuda").to(bf16)
    ref = torch.matmul(x.float(), w.float().t())
    err, rel = check("linear dense lm_head", linear(w, x, torch.float32), ref)
    new_ms = timer(lambda: linear(w, x, torch.float32))
    old_ms = timer(lambda: torch.matmul(x.float(), w.float().t()))
    dense = {"shape": "dense lm_head 65024x4544 bf16 x S=1", "max_abs_err": err, "rel_err": rel,
             "ms": new_ms, "old_f32_copy_ms": old_ms,
             "bound_ms": (w.numel() * 2 + 4544 * 2 + 65024 * 4) / bw * 1e3}
    log(f"  linear (dense) lm_head 65024x4544 S=1: err {err:.2e} ({rel:.1e} rel); new {new_ms:.4f}"
        f" ms, f32 copy {old_ms:.4f} ms, bound {dense['bound_ms']:.4f} ms")
    rows.append({"kernel": "linear.dense", **dense})
    del w
    return rows


def decode_rates(torch, engines: dict, tokens: list, n: int = 16) -> dict:
    """tok/s of n-token greedy decode chunks at n_past = len(tokens), each
    engine twice, in turns (a, b, b, a); every chunk is rolled back."""
    from ggllm_tpu_torch.ops.sampling import SamplerParams

    greedy = SamplerParams(temp=0.0)
    for eng in engines.values():
        eng.reset()
        eng.eval(tokens[:-1])
        eng.decode_chunk(tokens[-1], 2, greedy)  # warm-up
        eng.rollback(len(tokens) - 1)
    rates = {name: [] for name in engines}
    names = list(engines)
    for name in names + names[::-1]:
        eng = engines[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.decode_chunk(tokens[-1], n, greedy)  # ends by fetching the tokens
        rates[name].append(n / (time.perf_counter() - t0))
        eng.rollback(len(tokens) - 1)
    return rates


def phase_model(torch, model: str, fmt: str, kv_dtype: str = "bfloat16",
                peak_below: int | None = None, long_past: int | None = None,
                host_route_tokens: int = 0) -> dict:
    """One full-width model (`model` is "falcon7b", "falcon40b" or "llama7b")
    with random `fmt` weights and a `kv_dtype` cache through the engine's
    entry points; returns its launch counts and end-to-end figures. Fails if
    a kernel of the path (the matmul in `fmt`, the decode kernel for this
    head layout and cache) was not launched, if another decode kernel was, or
    if peak memory reaches `peak_below`. An int8 path also compares decode
    rates with a bf16 cache at n_past 400 and, if given, at `long_past`;
    host_route_tokens > 0 times that many tokens sampled at top_k 0 (the
    whole vocabulary: the host cascade, one forward and one draw a token)."""
    import gc

    import numpy as np

    from ggllm_tpu_torch.core.config import EngineConfig, named_hparams
    from ggllm_tpu_torch.core.dtypes import GGMLType
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.kernels import quant_matmul as qm
    from ggllm_tpu_torch.ops.sampling import SamplerParams
    from ggllm_tpu_torch.utils.benchgen import make_bench_params

    hp = named_hparams(model)
    label = f"{hp.n_layer}-layer {model} {fmt} {kv_dtype}-cache"
    int8 = kv_dtype == "int8"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = make_bench_params(hp, device="cuda", seed=7, gtype=GGMLType[fmt.upper()])
    torch.cuda.synchronize()
    log(f"  params: {label} on the card in {time.perf_counter() - t0:.1f} s,"
        f" {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    eng = FalconEngine(hp, params, EngineConfig(kv_dtype=kv_dtype))
    rng = np.random.default_rng(0)
    prompt = [int(t) for t in rng.integers(12, hp.n_vocab, 300)]

    eng.generate(prompt[:8], 4, SamplerParams(temp=0.0), stop_ids=set())  # warm-up
    eng.reset()
    eng.timings = type(eng.timings)()
    torch.cuda.synchronize()

    build.launch_counts.clear()
    greedy = eng.generate(prompt, 129, SamplerParams(temp=0.0), stop_ids=set())
    tm = eng.timings
    n_prefill, n_decode = tm.n_prefill, tm.n_decode
    prefill_tps = n_prefill / (tm.t_prefill_us / 1e6)
    decode_tps = n_decode / (tm.t_decode_us / 1e6)
    sampler = SamplerParams(temp=0.8, top_k=40, top_p=0.95, repeat_penalty=1.1, seed=1234)
    t0 = time.perf_counter()
    sampled, _ = eng.decode_chunk(greedy[-1], 32, sampler, last_tokens=prompt + greedy)
    sampled_tps = 32 / (time.perf_counter() - t0)
    counts = dict(build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    host_route = None
    if host_route_tokens:  # top_k 0: the whole vocabulary, sampled by the host cascade
        eng.reset()
        eng.eval(prompt[:-1])
        build.launch_counts.clear()
        t0 = time.perf_counter()
        ids = eng.generate(prompt[-1:], host_route_tokens,  # a forward and a draw a token
                           SamplerParams(temp=0.8, top_k=0, top_p=0.95, seed=99), stop_ids=set())
        host_tps = host_route_tokens / (time.perf_counter() - t0)
        host_route = {"tok_s": host_tps, "launches": dict(build.launch_counts), "ids": len(ids)}
        if len(ids) != host_route_tokens or min(ids) < 0 or max(ids) >= hp.n_vocab:
            raise RuntimeError(f"bad ids from the host sampling route: {ids}")
        log(f"  host-route sampling (top_k 0, temp 0.8), {host_route_tokens} tokens at n_past"
            f" 300: {host_tps:.2f} tok/s")
    log(f"  prefill {n_prefill} tokens: {prefill_tps:.1f} tok/s;"
        f" greedy decode {n_decode} tokens: {decode_tps:.2f} tok/s;"
        f" sampled decode 32 tokens: {sampled_tps:.2f} tok/s;"
        f" peak device memory {peak / 2**30:.2f} GiB")
    log(f"  launches on the {label} path: {counts}")
    mha = hp.n_head_kv == hp.n_head
    # the wrapper's counter for this head layout and cache, and the route's
    decode_counters = {"flash_decode" + (".mha" if mha else "") + (".int8" if int8 else ""),
                       ("flash_decode.mha" if mha else "flash_decode_tc") + (".int8" if int8 else "")}
    # prefill: the tensor-core tile and attention kernel; decode: the format's
    # GEMV (and not the other) and this head layout's and cache's decode kernel
    gemv, other_gemv = (("quant_matmul.gemv.kq", "quant_matmul.gemv") if GGMLType[fmt.upper()]
                        in qm.K_QUANTS else ("quant_matmul.gemv", "quant_matmul.gemv.kq"))
    for name in ("quant_matmul", f"quant_matmul.{fmt}", "quant_matmul.tc", gemv,
                 "flash_mqa", "flash_mqa.tc", *decode_counters):
        if counts.get(name, 0) <= 0:
            raise RuntimeError(f"kernel {name} was not launched on the {label} path")
    if (any(counts.get(k, 0) for k in DECODE_COUNTERS if k not in decode_counters)
            or counts.get(other_gemv, 0)
            or len({counts[k] for k in decode_counters}) != 1
            or any(counts.get(k, 0) for k in ("quant_matmul.simt", "flash_mqa.simt", "group_sums"))
            or counts["quant_matmul"] != counts[f"quant_matmul.{fmt}"]
            or counts["quant_matmul"] != counts["quant_matmul.tc"] + counts[gemv]
            or counts["flash_mqa"] != counts["flash_mqa.tc"]):
        raise RuntimeError(f"a kernel variant of another path ran on the {label} path: {counts}")
    if peak_below is not None and peak >= peak_below:
        raise RuntimeError(f"peak memory {peak} on the {label} path is not below {peak_below}")
    toks = np.asarray(greedy + [int(t) for t in sampled])
    if len(greedy) != 129 or len(sampled) != 32 or toks.min() < 0 or toks.max() >= hp.n_vocab:
        raise RuntimeError(f"bad generated ids: {len(greedy)} greedy, {len(sampled)} sampled")

    # logits of every prompt position, kernels against plain versions. The
    # weights are random, so the two best tokens of a position may lie closer
    # than the two paths' logits do: the argmax must be equal wherever the
    # plain version decides by more than twice the measured difference
    eng.reset()
    got = eng.eval(prompt, logits_all=True)
    plain = FalconEngine(hp, params, EngineConfig(kernel_layout=False, flash_attention=False,
                                                  kv_dtype=kv_dtype))
    ref = plain.eval(prompt, logits_all=True)
    if not (np.isfinite(got).all() and np.isfinite(ref).all()):
        raise RuntimeError("prefill logits are not finite")
    err = float(np.abs(got - ref).max())
    rel = err / float(np.abs(ref).max())
    top2 = np.partition(ref, -2, axis=1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2 * err
    same = got.argmax(axis=1) == ref.argmax(axis=1)
    log(f"  prefill logits at {len(prompt)} positions, kernels vs plain versions: max |d| {err:.4e}"
        f" ({rel:.3e} of max|ref|); same argmax at {int(same.sum())} positions, at all"
        f" {int((same & decided).sum())} of {int(decided.sum())} that the plain version decides"
        f" by more than 2 max |d|; last position {int(got[-1].argmax())} vs {int(ref[-1].argmax())}")
    if rel > LOGIT_TOL or not decided.any() or not same[decided].all():
        raise RuntimeError(f"kernel and plain prefill logits disagree on the {label} path")
    # one decode step (S = 1: the GEMV and the decode attention kernel) on
    # both engines, the same token at n_past 300 of their own caches
    tok = int(ref[-1].argmax())
    build.launch_counts.clear()
    got_d = eng.eval([tok])
    step_counts = dict(build.launch_counts)
    ref_d = plain.eval([tok])
    if not (np.isfinite(got_d).all() and np.isfinite(ref_d).all()):
        raise RuntimeError("decode logits are not finite")
    err_d = float(np.abs(got_d - ref_d).max())
    rel_d = err_d / float(np.abs(ref_d).max())
    top2_d = np.partition(ref_d, -2)[-2:]
    decided_d = bool(top2_d[1] - top2_d[0] > 2 * err_d)
    same_d = int(got_d.argmax()) == int(ref_d.argmax())
    log(f"  decode-step logits at n_past {len(prompt)}, kernels vs plain versions: max |d|"
        f" {err_d:.4e} ({rel_d:.3e} of max|ref|; prefill {rel:.3e}); argmax {int(got_d.argmax())}"
        f" vs {int(ref_d.argmax())} ({'decided' if decided_d else 'not decided'} by 2 max |d|);"
        f" launches {step_counts}")
    if rel_d > LOGIT_TOL or (decided_d and not same_d):
        raise RuntimeError(f"kernel and plain decode logits disagree on the {label} path")
    if step_counts.get(gemv, 0) <= 0 or step_counts.get(other_gemv, 0):
        raise RuntimeError(f"the decode step on the {label} path did not run {gemv} alone:"
                           f" {step_counts}")
    out = {"path": label, "launches": counts, "prefill_tok_s": prefill_tps,
           "decode_tok_s": decode_tps, "sampled_tok_s": sampled_tps, "peak_bytes": peak,
           "logit_rel_err": rel, "argmax_same": int(same.sum()),
           "argmax_decided": int(decided.sum()), "decode_logit_rel_err": rel_d,
           "decode_argmax_same": same_d, "decode_argmax_decided": decided_d,
           "host_route": host_route}
    del plain
    if int8:  # what the int8 cache costs or saves against bf16, same weights
        dense = FalconEngine(hp, params, EngineConfig())
        engines = {"int8": eng, "bfloat16": dense}
        tokens = prompt + [int(t) for t in greedy[:101]]
        out["decode_tok_s_at_400"] = decode_rates(torch, engines, tokens)
        log(f"  16-token greedy chunks at n_past 400, tok/s in turns: {out['decode_tok_s_at_400']}")
        if long_past is not None:  # prefilled in n_batch chunks
            tokens = [int(t) for t in rng.integers(12, hp.n_vocab, long_past + 1)]
            out[f"decode_tok_s_at_{long_past}"] = decode_rates(torch, engines, tokens)
            log(f"  16-token greedy chunks at n_past {long_past}, tok/s in turns:"
                f" {out[f'decode_tok_s_at_{long_past}']}")
        del dense, engines
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_f32_path(torch, model: str = "falcon7b", fmt: str = "q4_0", n_layer: int = 2) -> dict:
    """The f32 route at full width and `n_layer` layers: float32 compute and
    cache, a 300-token prefill through the f32 SIMT tile, group_sums and the
    f32 attention kernel, then 8 greedy tokens through the SIMT decode
    kernel. Fails unless all of them ran, no tensor-core kernel did, and the
    prefill logits of all positions agree with the plain versions to
    F32_LOGIT_TOL of max |logit|."""
    import dataclasses
    import gc

    import numpy as np

    from ggllm_tpu_torch.core.config import EngineConfig, named_hparams
    from ggllm_tpu_torch.core.dtypes import GGMLType
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.utils.benchgen import make_bench_params

    hp = dataclasses.replace(named_hparams(model), n_layer=n_layer)
    label = f"{n_layer}-layer {model} {fmt} float32"
    params = make_bench_params(hp, compute_dtype=torch.float32, device="cuda", seed=7,
                               gtype=GGMLType[fmt.upper()])
    cfg = dict(kv_dtype="float32", compute_dtype="float32")
    eng = FalconEngine(hp, params, EngineConfig(**cfg))
    prompt = [int(t) for t in np.random.default_rng(0).integers(12, hp.n_vocab, 300)]
    eng.eval(prompt[:8])  # warm-up
    eng.reset()
    torch.cuda.synchronize()
    build.launch_counts.clear()
    t0 = time.perf_counter()
    got = eng.eval(prompt, logits_all=True)
    prefill_tps = len(prompt) / (time.perf_counter() - t0)
    decoded, _ = eng.decode_chunk(int(got[-1].argmax()), 8)  # f32 q: the SIMT decode kernel
    counts = dict(build.launch_counts)
    log(f"  launches on the {label} path: {counts}")
    if len(decoded) != 8 or not 0 <= int(decoded.min()) <= int(decoded.max()) < hp.n_vocab:
        raise RuntimeError(f"bad decoded ids on the {label} path: {decoded}")
    for name in ("quant_matmul.simt", f"quant_matmul.{fmt}", "group_sums", "flash_mqa.simt",
                 "flash_decode", "flash_decode.simt", "quant_matmul.gemv"):
        if counts.get(name, 0) <= 0:
            raise RuntimeError(f"kernel {name} was not launched on the {label} path")
    if any(counts.get(k, 0) for k in ("quant_matmul.tc", "flash_mqa.tc", "flash_decode_tc")):
        raise RuntimeError(f"a tensor-core kernel ran on the {label} path: {counts}")
    plain = FalconEngine(hp, params, EngineConfig(kernel_layout=False, flash_attention=False, **cfg))
    ref = plain.eval(prompt, logits_all=True)
    if not (np.isfinite(got).all() and np.isfinite(ref).all()):
        raise RuntimeError("f32 prefill logits are not finite")
    rel = float(np.abs(got - ref).max()) / float(np.abs(ref).max())
    same = int((got.argmax(axis=1) == ref.argmax(axis=1)).sum())
    log(f"  prefill {len(prompt)} tokens: {prefill_tps:.1f} tok/s; logits at all positions, kernels"
        f" vs plain versions: {rel:.3e} of max|ref|; same argmax at {same} positions")
    if rel > F32_LOGIT_TOL:
        raise RuntimeError(f"f32 kernel and plain prefill logits disagree on the {label} path")
    del eng, plain, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"path": label, "launches": counts, "prefill_tok_s": prefill_tps, "logit_rel_err": rel,
            "argmax_same": same}


def phase_cli() -> None:
    """The CLI on small files of both families, all processes at once."""
    from ggllm_tpu_torch.core.config import FalconHParams, LlamaHParams
    from ggllm_tpu_torch.core.dtypes import GGMLType
    from ggllm_tpu_torch.utils.synthetic import write_tiny_llama, write_tiny_model

    # n_embd 256: K-quants need widths divisible by 256 (LLaMA: n_ff 768)
    falcon7 = FalconHParams(n_vocab=512, n_embd=256, n_head=4, n_head_kv=1, n_layer=2,
                            n_falcon_type=7, n_bpe_merges=0)
    falcon40 = FalconHParams(n_vocab=512, n_embd=256, n_head=8, n_head_kv=2, n_layer=2,
                             n_falcon_type=40, n_bpe_merges=0)
    llama = LlamaHParams(n_vocab=512, n_embd=256, n_mult=256, n_head=4, n_layer=2, n_rot=64)
    int8 = ["--kv-dtype", "int8"]
    cases = [("falcon", "q4_0", falcon7, []), ("falcon", "q4_k", falcon40, []),
             ("falcon", "q2_k", falcon40, []), ("falcon", "q3_k", falcon40, int8),
             ("llama", "q4_0", llama, []), ("llama", "q4_k", llama, int8)]
    with tempfile.TemporaryDirectory() as d:
        procs = []
        for family, fmt, hp, extra in cases:
            path = str(Path(d) / f"small-{family}-{fmt}.{'ggjt' if family == 'llama' else 'ggcc'}")
            write = write_tiny_llama if family == "llama" else write_tiny_model
            write(path, hp, GGMLType[fmt.upper()], seed=3)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "ggllm_tpu_torch.tools.main", "-m", path, "-p",
                 "the thing", "-n", "16", "--temp", "0", "--ignore-eos", *extra],
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        results = []
        try:
            for p in procs:
                results.append((p.communicate(timeout=600), p.returncode))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
    for (family, fmt, _, extra), ((out, err), rc) in zip(cases, results):
        out, err = out.decode(errors="replace"), err.decode(errors="replace")
        log(f"  cli {family} {fmt} {' '.join(extra)} rc={rc} stdout={out.strip()[:100]!r}")
        if rc != 0 or not out.startswith("the thing") or "eval time" not in err:
            raise RuntimeError(f"CLI run on a {family} {fmt} file failed:\n{out}\n{err}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from ggllm_tpu_torch.core.dtypes import GGMLType
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.kernels import quant_matmul as qm

    card = smi("name,power.limit")
    log(card)
    kind = torch.cuda.get_device_name(0)
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True, text=True).stdout
    log(f"torch {torch.__version__} cuda {torch.version.cuda} driver {smi('driver_version')}"
        f" nvcc {nvcc.strip().splitlines()[-1]}")
    bw, peak = PEAKS["pcie" if "PCIe" in kind else "nvl" if "NVL" in kind else "sxm"]

    log("phase 1: build")
    t0 = time.perf_counter()
    build.lib()
    log(f"  kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ptxas.txt").write_text(build.build_log)
    # the GEMVs decode their codes without int -> float conversions: every
    # format, rows a warp (1, 2), x and y dtype of both kernels
    from ggllm_tpu_torch.tools.sass_report import gemv_report

    sass = gemv_report(build.BUILD / build.LIB_NAME)
    (out_dir / "sass_gemv.json").write_text(json.dumps(sass, indent=1))
    if len(sass) != len(qm.GEMV_LAYOUT) * 2 * 2 * 2 or any(r["I2F"] for r in sass):
        raise RuntimeError(f"GEMV SASS: {len(sass)} kernels, I2F in"
                           f" {[r for r in sass if r['I2F']]}")
    for r in sass:  # the instantiations the bf16 decode paths launch
        if (r["x"] == r["y"] == "bfloat16"
                and r["rows"] == qm.GEMV_ROWS[GGMLType[r["format"].upper()]]):
            log(f"  quant_gemv_{r['kernel']} {r['format']} {r['rows']} row(s) a warp:"
                f" {r['instructions']} SASS instructions, no I2F; loop {r['loop_instructions']}"
                f" ({r['loop_instructions_per_weight']} a weight)")

    log("phase 2: kernels vs plain versions")
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = phase_kernels(torch, Timer(torch), bw, peak)
    (out_dir / "chip_smoke_kernels.json").write_text(json.dumps({"card": card, "rows": rows}, indent=1))

    log("phase 3: full-width main paths")
    paths = []
    for model, fmt in (("falcon7b", "q4_0"), ("falcon7b", "q4_1"), ("falcon40b", "q4_k")):
        log(f"  -- {model} {fmt}")
        paths.append(phase_model(torch, model, fmt,
                                 host_route_tokens=32 if (model, fmt) == ("falcon7b", "q4_0") else 0))
    log("  -- falcon40b q3_k, int8 cache")
    paths.append(phase_model(torch, "falcon40b", "q3_k", kv_dtype="int8",
                             peak_below=paths[-1]["peak_bytes"]))
    log("  -- llama7b q4_0")
    paths.append(phase_model(torch, "llama7b", "q4_0"))
    log("  -- llama7b q4_k, int8 cache")
    paths.append(phase_model(torch, "llama7b", "q4_k", kv_dtype="int8", long_past=1900))
    log("  -- falcon7b q4_0, 2 layers, float32")
    paths.append(phase_f32_path(torch))
    (out_dir / "chip_smoke_paths.json").write_text(json.dumps({"card": card, "paths": paths},
                                                              indent=1))

    log("phase 4: CLI on GGCC and GGJT files")
    phase_cli()

    headline = {  # the JSON line's shape per kernel
        "quant_matmul": "q4_0 wqkvu O=22848 K=4544 S=1",
        "quant_matmul.gemv.kq": "q4_k ffn_up O=32768 K=8192 S=1",
        "quant_matmul.tc": "q4_0 wqkvu O=22848 K=4544 S=512",
        "quant_matmul.simt": "q4_0 wqkvu O=22848 K=4544 S=512",
        "group_sums": "S=512 K=22720 g=32",
        "flash_mqa": "S=512 n_past=300 H=71 KV=1",
        "flash_mqa.tc": "S=512 n_past=300 H=71 KV=1",
        "flash_decode_tc": "valid=2047 G=71",
        "flash_decode_tc.int8": "int8 valid=2047 G=71",
        "flash_decode.simt": "f32 valid=300 G=71",
        "flash_decode.mha": "valid=2047 G=1 KV=32",
        "flash_decode.mha.int8": "int8 valid=2047 G=1 KV=32",
    }
    kernels = []
    for name, (source, replaces) in REPLACES.items():
        r = next(r for r in rows if r["kernel"] == name and r["shape"].startswith(headline[name]))
        counter = COUNTER.get(name, name)
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": sum(p["launches"].get(counter, 0) for p in paths),
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                 "library_ms": r["library_ms"], "shape": r["shape"]}
        if "graph_ms" in r:  # device time: a CUDA graph of one call (or one per layer)
            entry["graph_ms"] = r["graph_ms"]
            entry["library_graph_ms"] = r.get("library_graph_ms")
        if entry["launches"] <= 0:
            raise RuntimeError(f"kernel {name} was launched on none of the main paths")
        if name.startswith("quant_matmul"):
            entry["x_dtype"] = "float32" if name.endswith("simt") else "bfloat16"
        if name in ("quant_matmul", "quant_matmul.gemv.kq"):
            entry["formats"] = [f for f in QUANT_FORMATS
                                if (GGMLType[f.upper()] in qm.K_QUANTS) == name.endswith("kq")]
            entry["launches_by_format"] = {
                fmt: sum(p["launches"].get(f"quant_matmul.{fmt}", 0) for p in paths)
                for fmt in entry["formats"]}
        if name == "flash_mqa":
            entry["head_dims"], entry["dtypes"] = [32, 64, 128], ["float32", "bfloat16 at D=32"]
        if name == "flash_mqa.tc":
            entry["head_dims"], entry["dtypes"] = [64, 128], ["bfloat16"]
        if name.startswith("flash_decode"):
            entry["cache_dtypes"] = (["int8"] if name.endswith("int8") else ["bfloat16"]
                                     if name == "flash_decode_tc" else ["float32", "int8"]
                                     if name.endswith("simt") else ["bfloat16", "float32"])
            entry["head_dims"] = ([32, 64, 128] if ".mha" in name else [64, 128]
                                  if name.startswith("flash_decode_tc") else [32, 64])
        kernels.append(entry)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
