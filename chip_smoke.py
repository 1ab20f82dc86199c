#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ggllm_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. build the hand-written kernels from ggllm_tpu_torch/csrc with nvcc;
  2. hold every kernel against its plain PyTorch version at the main-path
     shapes (quant_matmul in all ten formats: Q4_0 … Q8_0 at the Falcon-7B
     shapes, Q2_K … Q6_K at the Falcon-40B shapes; the attention kernels at
     both models' head layouts, flash-decode on bf16 and on int8 caches),
     and time kernel, plain version and one PyTorch library call (CUDA
     events, after warm-up, median of 20 runs, L2 flushed before each run)
     beside the card's bound;
  3. drive the main path at full width through the engine's entry points,
     with random weights from a seed, four times: Falcon-7B Q4_0 (32
     layers), Falcon-7B Q4_1 (32 layers), Falcon-40B Q4_K (60 layers), all
     on a bf16 cache, and Falcon-40B Q3_K (60 layers) on an int8 cache:
     prefill a 300-token prompt, greedy-decode 128 tokens, then 32 sampled
     tokens, counting kernel launches (set to 0 just before each path and
     read just after); then prefill again through the plain versions and
     compare the logits. The int8 path also times 16-token decode chunks at
     n_past 400 on an int8 and on a bf16 cache, in turns. Each model's
     parameters are freed before the next one is built;
  4. write small GGCC files with the port's writer (Q4_0 7B-style; Q4_K,
     Q2_K and Q3_K 40B-style) and run the CLI on each, the Q3_K file with
     --kv-dtype int8.
The last two lines of standard output are the kernel table as JSON and
{"ok": true, "device": {...}}. Per-shape rows also go to
chiprun_out/chip_smoke_kernels.json.
"""

from __future__ import annotations

import json
import statistics
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
REPLACES = {
    "quant_matmul": ("ggllm_tpu_torch/csrc/quant_matmul.cu", "ggllm_tpu/kernels/quant_matmul.py:57"),
    "group_sums": ("ggllm_tpu_torch/csrc/quant_matmul.cu", "ggllm_tpu/kernels/quant_matmul.py:189"),
    "flash_mqa": ("ggllm_tpu_torch/csrc/flash_attention.cu", "ggllm_tpu/kernels/flash_attention.py:33"),
    "flash_decode": ("ggllm_tpu_torch/csrc/flash_decode.cu", "ggllm_tpu/kernels/flash_decode.py:56"),
    # the same Pallas kernel with quant=True (its int8 branches at :79 and :93)
    "flash_decode.int8": ("ggllm_tpu_torch/csrc/flash_decode.cu",
                          "ggllm_tpu/kernels/flash_decode.py:79"),
}


def log(msg: str):
    print(msg, flush=True)


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


class Timer:
    """Median device time of a callable: CUDA events around each run, the
    L2 cache flushed (a 256 MB write) before each run, outside the events."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(N_WARM):
            fn()
        times = []
        for _ in range(N_RUNS):
            self.flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            times.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in times)


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
    from ggllm_tpu_torch.kernels import flash_decode as fd
    from ggllm_tpu_torch.kernels import quant_matmul as qm
    from ggllm_tpu_torch.kernels.flash_attention import flash_mqa, flash_mqa_plain
    from ggllm_tpu_torch.models.falcon import FalconStatic, _attention
    from ggllm_tpu_torch.ops import kvcache
    from ggllm_tpu_torch.utils.benchgen import random_quant

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    bf16 = torch.bfloat16
    rows = []

    def row(kernel, shape, err, rel, ms, plain_ms, lib_ms, nbytes, ops):
        tb, to = nbytes / bw * 1e3, ops / peak * 1e3
        r = {"kernel": kernel, "shape": shape, "max_abs_err": err, "rel_err": rel, "ms": ms,
             "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": max(tb, to),
             "bound_by": "bytes" if tb >= to else "operations"}
        rows.append(r)
        log(f"  {kernel:13s} {shape:34s} err {err:.2e} ({rel:.1e} rel)  kernel {ms:.4f} ms"
            f"  plain {plain_ms:.4f} ms  library {lib_ms if lib_ms is None else round(lib_ms, 4)} ms"
            f"  bound {r['bound_ms']:.4f} ms ({r['bound_by']})")

    # ---- quant_matmul (+ group_sums inside at S >= 256), every format at
    # its model's main-path shapes
    shapes_7b = (("wqkvu", 22848, 4544), ("w_od", 4544, 22720), ("lm_head", 65024, 4544))
    shapes_40b = (("wqkv", 9216, 8192), ("ffn_up", 32768, 8192), ("w_od", 8192, 40960),
                  ("lm_head", 65024, 8192))
    for fmt in QUANT_FORMATS:
        gtype = GGMLType[fmt.upper()]
        for wname, O, K in shapes_40b if gtype in qm.K_QUANTS else shapes_7b:
            w = random_quant(gtype, O, K, gen, "cuda")
            wbytes = sum(p.numel() * p.element_size() for p in w.planes.values())
            wdeq = w.dequantize(bf16)
            out_dtype = torch.float32 if wname == "lm_head" else bf16
            for S in (1, 512):
                x = torch.randn(S, K, generator=gen, device="cuda").to(bf16)
                got = qm.quant_matmul(w, x, out_dtype)
                ref = qm.quant_matmul_plain(w, x, out_dtype)
                err, rel = check(f"quant_matmul {fmt} {wname} S={S}", got, ref)
                ms = timer(lambda: qm.quant_matmul(w, x, out_dtype))
                plain_ms = timer(lambda: qm.quant_matmul_plain(w, x, out_dtype))
                lib_ms = timer(lambda: torch.matmul(x, wdeq.t()))
                nbytes = wbytes + S * K * 2 + S * O * (4 if out_dtype == torch.float32 else 2)
                row("quant_matmul", f"{fmt} {wname} O={O} K={K} S={S}", err, rel, ms, plain_ms,
                    lib_ms, nbytes, 2 * S * O * K)
            del w, wdeq

    # ---- group_sums: 32-wide at the 7B widths, 16-wide (Q2_K, Q3_K, Q6_K) at
    # the 40B ones
    for K, g in ((4544, 32), (22720, 32), (8192, 16), (40960, 16)):
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

    # ---- flash_mqa: S=512 against one (1, T=2560, KV, 64) cache layer, at
    # Falcon-7B's 71 heads over one K/V head and Falcon-40B's 128 over 8
    D, T, S = 64, 2560, 512
    for H, KV, past in ((71, 1, (0, 300)), (128, 8, (0,))):
        kvc = torch.randn(1, 2, 1, T, KV, D, generator=gen, device="cuda").to(bf16)
        k, v = kvc[0, 0], kvc[0, 1]
        q = torch.randn(1, S, H, D, generator=gen, device="cuda").to(bf16)
        for n_past in past:
            err, rel = check(f"flash_mqa H={H} KV={KV} n_past={n_past}",
                             flash_mqa(q, k, v, n_past), flash_mqa_plain(q, k, v, n_past))
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
            row("flash_mqa", f"S={S} n_past={n_past} H={H} KV={KV} D={D}", err, rel, ms,
                plain_ms, lib_ms, 2 * S * H * D * 2 + 2 * Tv * KV * D * 2, 4 * pairs * H * D)

    # ---- flash_decode: the last layer of the full cache (32 layers at 7B,
    # 60 at 40B)
    for L, H, KV, valids in ((32, 71, 1, (1, 300, 2047)), (60, 128, 8, (300, 2047))):
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
        deq = deq32.to(bf16)
        for name, cache, kr, vr, lib_kv, per_pos, vals in (
                ("flash_decode", kv, kv[l, 0], kv[l, 1], kv[l], 2 * D, valids),
                ("flash_decode.int8", kv8, deq32[0], deq32[1], deq, D + 4, valids[-2:])):
            tag = "int8 " if name.endswith("int8") else ""
            for valid in vals:
                # cache valid below `valid`: no append -> n_past = valid - 1;
                # append with 5 valid entries -> n_past = valid + 4
                err, rel = check(f"{name} G={G} valid={valid}",
                                 fd.flash_decode(cache, KV, l, q1, valid - 1),
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
                plain_ms = timer(lambda: fd.flash_decode_plain(cache, KV, l, q1, valid - 1))
                kt = lib_kv[0, :, :valid].transpose(1, 2)
                vt = lib_kv[1, :, :valid].transpose(1, 2)
                if KV == 1:
                    kt, vt = kt.expand(1, H, valid, D), vt.expand(1, H, valid, D)
                lib_ms = timer(lambda: F.scaled_dot_product_attention(
                    q1.transpose(1, 2), kt, vt, enable_gqa=KV > 1))
                # bytes: K and V of the valid prefix (per position and K/V head
                # 2 D in bf16, D + 4 as codes and a scale), q and the output
                row(name, f"{tag}valid={valid} G={G} KV={KV} D={D} (+append err {err_a:.1e})",
                    max(err, err_a), max(rel, rel_a), ms, plain_ms, lib_ms,
                    2 * valid * KV * per_pos + 2 * H * D * 2, 4 * valid * H * D)
        del kv, kv8, deq, deq32
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
                peak_below: int | None = None) -> dict:
    """One full-width Falcon model (`model` is "falcon7b" or "falcon40b") with
    random `fmt` weights and a `kv_dtype` cache through the engine's entry
    points; returns its launch counts and end-to-end figures. Fails if a
    kernel of the path (the matmul in `fmt`, the decode kernel's variant for
    this cache) was not launched, or if peak memory reaches `peak_below`."""
    import gc

    import numpy as np

    from ggllm_tpu_torch.core.config import EngineConfig, FalconHParams
    from ggllm_tpu_torch.core.dtypes import GGMLType
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.ops.sampling import SamplerParams
    from ggllm_tpu_torch.utils.benchgen import make_bench_params

    hp = getattr(FalconHParams, model)()
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
    log(f"  prefill {n_prefill} tokens: {prefill_tps:.1f} tok/s;"
        f" greedy decode {n_decode} tokens: {decode_tps:.2f} tok/s;"
        f" sampled decode 32 tokens: {sampled_tps:.2f} tok/s;"
        f" peak device memory {peak / 2**30:.2f} GiB")
    log(f"  launches on the {label} path: {counts}")
    decode_kernel, other = (("flash_decode.int8", "flash_decode") if int8
                            else ("flash_decode", "flash_decode.int8"))
    for name in ("quant_matmul", f"quant_matmul.{fmt}", "group_sums", "flash_mqa", decode_kernel):
        if counts.get(name, 0) <= 0:
            raise RuntimeError(f"kernel {name} was not launched on the {label} path")
    if counts.get(other, 0) or counts["quant_matmul"] != counts[f"quant_matmul.{fmt}"]:
        raise RuntimeError(f"a kernel variant of another path ran on the {label} path: {counts}")
    if peak_below is not None and peak >= peak_below:
        raise RuntimeError(f"peak memory {peak} on the {label} path is not below {peak_below}")
    toks = np.asarray(greedy + [int(t) for t in sampled])
    if len(greedy) != 129 or len(sampled) != 32 or toks.min() < 0 or toks.max() >= hp.n_vocab:
        raise RuntimeError(f"bad generated ids: {len(greedy)} greedy, {len(sampled)} sampled")

    eng.reset()
    got = eng.eval(prompt)
    plain = FalconEngine(hp, params, EngineConfig(kernel_layout=False, flash_attention=False,
                                                  kv_dtype=kv_dtype))
    ref = plain.eval(prompt)
    if not (np.isfinite(got).all() and np.isfinite(ref).all()):
        raise RuntimeError("prefill logits are not finite")
    err = float(np.abs(got - ref).max())
    rel = err / float(np.abs(ref).max())
    log(f"  prefill logits, kernels vs plain versions: max |d| {err:.4e} ({rel:.3e} of max|ref|),"
        f" argmax {int(got.argmax())} vs {int(ref.argmax())}")
    if rel > LOGIT_TOL or int(got.argmax()) != int(ref.argmax()):
        raise RuntimeError(f"kernel and plain prefill logits disagree on the {label} path")
    out = {"path": label, "launches": counts, "prefill_tok_s": prefill_tps,
           "decode_tok_s": decode_tps, "sampled_tok_s": sampled_tps, "peak_bytes": peak,
           "logit_rel_err": rel}
    del plain
    if int8:  # what the int8 cache costs or saves against bf16, same weights
        dense = FalconEngine(hp, params, EngineConfig())
        tokens = prompt + [int(t) for t in greedy[:101]]
        out["decode_tok_s_at_400"] = decode_rates(torch, {"int8": eng, "bfloat16": dense}, tokens)
        log(f"  16-token greedy chunks at n_past 400, tok/s in turns: {out['decode_tok_s_at_400']}")
        del dense
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_cli() -> None:
    from ggllm_tpu_torch.core.config import FalconHParams
    from ggllm_tpu_torch.core.dtypes import GGMLType
    from ggllm_tpu_torch.utils.synthetic import write_tiny_model

    small = {  # n_embd 256: K-quants need widths divisible by 256
        "q4_0": FalconHParams(n_vocab=512, n_embd=256, n_head=4, n_head_kv=1, n_layer=2,
                              n_falcon_type=7, n_bpe_merges=0),
        "q4_k": FalconHParams(n_vocab=512, n_embd=256, n_head=8, n_head_kv=2, n_layer=2,
                              n_falcon_type=40, n_bpe_merges=0),
    }
    small["q2_k"] = small["q3_k"] = small["q4_k"]
    for fmt, hp in small.items():
        extra = ["--kv-dtype", "int8"] if fmt == "q3_k" else []
        with tempfile.TemporaryDirectory() as d:
            path = str(Path(d) / f"small-{fmt}.ggcc")
            write_tiny_model(path, hp, GGMLType[fmt.upper()], seed=3)
            p = subprocess.run([sys.executable, "-m", "ggllm_tpu_torch.tools.main", "-m", path,
                                "-p", "the thing", "-n", "16", "--temp", "0", "--ignore-eos",
                                *extra],
                               cwd=ROOT, capture_output=True, timeout=600)
        out, err = p.stdout.decode(errors="replace"), p.stderr.decode(errors="replace")
        log(f"  cli {fmt} {' '.join(extra)} rc={p.returncode} stdout={out.strip()[:100]!r}")
        if p.returncode != 0 or not out.startswith("the thing") or "eval time" not in err:
            raise RuntimeError(f"CLI run on a {fmt} file failed:\n{out}\n{err}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from ggllm_tpu_torch.kernels import build

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

    log("phase 2: kernels vs plain versions")
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = phase_kernels(torch, Timer(torch), bw, peak)
    (out_dir / "chip_smoke_kernels.json").write_text(json.dumps({"card": card, "rows": rows}, indent=1))

    log("phase 3: full-width main paths")
    paths = []
    for model, fmt in (("falcon7b", "q4_0"), ("falcon7b", "q4_1"), ("falcon40b", "q4_k")):
        log(f"  -- {model} {fmt}")
        paths.append(phase_model(torch, model, fmt))
    log("  -- falcon40b q3_k, int8 cache")
    paths.append(phase_model(torch, "falcon40b", "q3_k", kv_dtype="int8",
                             peak_below=paths[-1]["peak_bytes"]))
    (out_dir / "chip_smoke_paths.json").write_text(json.dumps({"card": card, "paths": paths},
                                                              indent=1))

    log("phase 4: CLI on GGCC files")
    phase_cli()

    headline = {  # the JSON line's shape per kernel
        "quant_matmul": "q4_0 wqkvu O=22848 K=4544 S=1",
        "group_sums": "S=512 K=22720 g=32",
        "flash_mqa": "S=512 n_past=0 H=71 KV=1",
        "flash_decode": "valid=2047 G=71",
        "flash_decode.int8": "int8 valid=2047 G=71",
    }
    cache_dtypes = {"flash_decode": ["bfloat16", "float32"], "flash_decode.int8": ["int8"]}
    kernels = []
    for name, (source, replaces) in REPLACES.items():
        r = next(r for r in rows if r["kernel"] == name and r["shape"].startswith(headline[name]))
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": sum(p["launches"].get(name, 0) for p in paths),
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                 "library_ms": r["library_ms"], "shape": r["shape"]}
        if name == "quant_matmul":
            entry["formats"] = QUANT_FORMATS
            entry["launches_by_format"] = {
                fmt: sum(p["launches"].get(f"quant_matmul.{fmt}", 0) for p in paths)
                for fmt in QUANT_FORMATS}
        if name in cache_dtypes:
            entry["cache_dtypes"] = cache_dtypes[name]
        kernels.append(entry)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
