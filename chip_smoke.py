#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ggllm_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. build the hand-written kernels from ggllm_tpu_torch/csrc with nvcc, and
     read the decode GEMVs' and the rows kernel's SASS (cuobjdump): no I2F in
     any instantiation of the legacy or the K-quant GEMV or the rows kernel;
  2. hold every kernel against its plain PyTorch version at the main-path
     shapes (quant_matmul in all ten formats: Q4_0 … Q8_0 at the Falcon-7B
     shapes, Q2_K … Q6_K at the Falcon-40B shapes, Q4_0 and Q4_K at the
     LLaMA-7B shapes, S = 1 through the K-quant GEMV (K-quants) or the
     legacy GEMV and S = 512 through the tensor-core tile; Q2_K at the
     Falcon-180B shapes at S = 1 and 300, also as device time; the tile also at
     S = 17 and 300 and at a ragged O, and at S = 28 (a batched verify) at the
     Falcon-7B decode weights;
     the f32 tensor-core tile at two shapes at S = 300 and 512 and at three
     more of the f32 paths' 300-row widths, group_sums on f32 x at the f32
     paths' widths; the attention kernels at the
     three models' head layouts (and Falcon-180B's 232 heads over 8 at S =
     300), bf16 through the tensor-core kernel, with a
     per-row n_past, f32 through the f32 tensor-core kernel (split TF32) at
     Falcon-7B's and LLaMA-7B's, and bf16 at head dim 32 through the
     tensor-core kernel too (the small test models' layout, and S = 512 at
     the training demo's 4 heads over one K/V head); flash-decode on bf16
     and on int8 caches (Falcon-180B's 29 query heads a K/V head among
     them, 80 layers), grouped heads through the tensor-core kernel and
     LLaMA's G == 1 through its own, with and without the append block and
     with a length per row, also at 5 decode rows (valid 300, 17, 2047, 1
     and a parked row); f32 q on f32 and int8 caches through the f32
     decode kernel (split TF32) at Falcon-7B's and Falcon-40B's head layouts,
     the same way, its partials also against partials_emulated, f32 q on a
     bf16 cache at Falcon-7B's (valid 300 and 2047), and bf16 at
     head dim 32 through it; the rows kernel at B = 2, 4, 8, 16 decode rows
     at Falcon-7B Q4_0's, LLaMA-7B Q4_0's and Falcon-40B Q4_K's decode
     weights and every other format at B = 4, f32 y held at 2e-5, beside B
     one-row GEMVs and the tensor-core tile at the same rows, and a row's y
     held bit for bit against the same call with the other rows redrawn and
     at two rows), and time
     kernel, plain version and one PyTorch library call (CUDA events, after
     warm-up, median of 20 runs, L2 flushed before each run) beside the
     card's bound; bf16 rows are held at 2e-2 of max |plain|, f32 rows at
     2e-5; the GEMVs (S = 1), flash-decode and their library calls
     also as device time (a CUDA graph of one call, or of one call per
     layer divided by the layers); the long context's lengths
     (_long_context_kernels: a cache of LONG_T = 18432 positions, that of
     n_ctx 16384 and n_batch 2048): flash_mqa.tc at 2048-row chunks at
     n_past 0 and 10240, the decode kernels at valid 8192 / 12288 / 16383,
     LLaMA-7B's G == 1 on layer 31 of a 32-layer cache past 2^31 elements
     with cache writes there read back; and a dense
     bf16 weight at Falcon-7B's lm_head shape through ops/linear.py against
     the f32 product;
  3. drive the main path at full width and full depth through the engine's
     entry points, with random weights from a seed, eight times: Falcon-7B
     Q4_0 and Q4_1 (32 layers), Falcon-40B Q4_K (60 layers), Falcon-180B
     Q2_K (80 layers, one card: its peak below the planner's 90 % of the
     card's memory) and LLaMA-7B
     Q4_0 (32 layers) on a bf16 cache; Falcon-40B Q3_K (60 layers) and
     LLaMA-7B Q4_K (32 layers) on an int8 cache; Falcon-7B Q4_0 on an f32
     cache with bf16 compute (`--memory-f32`, whose decode runs the f32
     decode kernel): prefill a 300-token prompt,
     greedy-decode 128 tokens, then 32 sampled tokens, counting kernel
     launches (set to 0 just before each path and read just after); decode
     runs as replays of captured CUDA graphs (pipelined chunks in generate),
     whose launch counts are credited per replay. From the same state the
     graphs' 64 greedy and 32 sampled ids must equal the eager step body's
     on the same engine, one greedy replay's credited counts must be its
     capture record and the eager run's a chunk: 16 of the format's GEMV
     for each quantized weight and 16 of the head layout's decode kernel
     for each layer, no other GEMV or decode kernel; and graph and eager
     tok/s, the graph's device ms a token and idle share, and capture ms
     are printed; Falcon-7B
     Q4_0 also samples 32 tokens at top_k 0 (the host cascade); then
     prefill again through the plain versions and compare the logits of all
     300 positions (and the argmax wherever the plain version decides it by
     more than twice the measured difference), then one decode step (S = 1)
     of the same token on both engines, held the same way; the decode step
     must run the format's GEMV and not the other. The int8 paths also time
     16-token decode chunks at n_past 400 (LLaMA: and at n_past 1900) on an
     int8 and on a bf16 cache, in turns. Each model's parameters are freed
     before the next one is built. On these bf16 paths prefill must run the
     tensor-core tile and attention kernel and no f32 prefill kernel (on the
     f32 cache, whose dtype q takes, the f32 attention kernel), and decode
     the head layout's and cache's decode kernel and no other. Three
     paths at full width with float32 compute and cache (Falcon-7B Q4_0 at 2
     and at 32 layers, LLaMA-7B Q4_0 at 2) prefill the prompt through the f32
     tensor-core tile, group_sums and the f32 attention kernel, run no bf16
     tensor-core kernel, and must agree with the plain versions to 1e-4 of
     max |logit|, then decode 16 tokens through the legacy GEMV (f32 x and y)
     and the head layout's f32 decode kernel; the 2-layer paths hold their
     graphs against the eager step body in the same way; the forward
     exported (phase_export: FalconEngine.export, torch.export with the
     kernels as torch.ops.ggllm.* nodes) at S = 300 and S = 1 on the 32-layer
     Falcon-7B Q4_0 and LLaMA-7B Q4_0 (n_rot 128) engines and on the 2-layer
     f32 Falcon-7B one (whose prefill graph names ggllm.group_sums), each
     program run once from the cache state the eager forward starts from:
     logits within LOGIT_TOL of max |eager| with the same greedy id, and the
     launches counted by name equal to the eager forward's;
     on the Falcon-7B Q4_0 engine, before its weights are freed, two more
     paths: the single-stream HTTP server (server/app.py, on 127.0.0.1 at a
     free port, in a thread): a greedy request equal to the engine's
     Generator byte for byte, prefix reuse equal to a run from an empty
     cache, two sampled requests at other temperatures, top-p and penalties
     that share one graph (the second captures nothing), a streamed request,
     /v1/chat/completions and /metrics; and perplexity (2 chunks of n_ctx
     2048 from token ids of a seed, log-softmax gather on the card, timed per
     512-token piece at n_past 0 … 1536) and embed() of a 700-token prompt,
     each held against the plain versions, then the perplexity of one chunk
     on an int8 cache; and continuous batching: 8 requests (prompts of 5-300
     tokens, 64 tokens each, 4 greedy and 4 sampled, one with mirostat 2,
     one with penalize_nl false) through a ContinuousBatcher over
     FalconEngine(batch_size=4), decoding as replayed B-row CUDA graphs, whose
     ids must equal the eager B-row step body's and whose capture records
     hold one rows-kernel launch for each quantized weight a step and no
     tile or GEMV, every greedy id within ROWS_LOGIT_TOL of its step's top
     logit in the batch-1 engine with the batched ids forced (a request's
     ids on another's prompt must fail it; the same on the f32 route at 2
     layers, F32_LOGIT_TOL), with
     aggregate and per-row tok/s beside the single stream's, admission time,
     B-row step device ms at B = 1, 2, 4, 8, 16 and capture ms;
     on the same Falcon-7B Q4_0 engine also grammar-constrained decoding
     (the Generator's masked chunks): 64 greedy ids under `root ::= [0-9]+`
     and under a small JSON grammar through the masked graphs equal to the
     eager masked step body's, every id accepted by the grammar, at least
     one 16-step masked chunk rolled back, the unmasked greedy graph's node
     count the parent's (UNMASKED_GRAPH_NODES), a sampled run at temperature
     0.8 within the grammar, grammar tok/s beside the unmasked rate and the
     host ms of valid_bits at the full vocabulary; and the server with
     --parallel 4 over the batching engine (serve(parallel=4, chunk=16,
     prefill_chunk=256) on 127.0.0.1 at a free port): 8 requests at once (4
     greedy, 2 sampled, 1 grammar, 1 streamed) beside a top-k 100 request
     and a bad grammar, which must get HTTP 400 while the others complete,
     every greedy request's ids within ROWS_LOGIT_TOL of the batch-1 engine
     with its ids forced, digits for the grammar request, the stream
     concatenating to its request's ids' pieces, /metrics counting the
     requests sent, the rows kernel and the grouped decode kernel and no
     GEMV launched, with aggregate tok/s, each request's prompt_ms and
     predicted_per_second, and the aggregate of 4 requests with and without
     a grammar row among them; on the same engine also sessions
     (phase_session: a saved 300-token prompt loaded into a fresh engine
     gives 32 greedy ids bit for bit those of an engine that prefilled the
     same split without a file, a sampled run restored after 8 ids continues
     with the uninterrupted run's; the file's bytes, save and load ms) and
     speculative decoding (phase_speculative, k = 6, 4 rounds a graph: 64
     greedy ids with a perfect draft and with --self-draft 8, each held to the
     single stream with the ids forced within ROWS_LOGIT_TOL, the round graph's
     ids, n_acc and both caches equal to the eager rounds', the round graph's
     capture record holding quant_matmul.rows, quant_matmul.gemv, flash_mqa.tc
     and flash_decode_tc; stochastic rounds on fixed uniforms equal to a
     float64 replay of their accept / resample and the graph's to the eager
     rounds'; tok/s, ms a round and acceptance beside the single stream's
     tok/s), and the server answers one greedy request with --self-draft 8
     carrying its speculative field; batched speculative rounds
     (phase_speculative_rows: generate_rows at B = 4 and 2 with a perfect
     draft, --self-draft 8 and an int8 draft cache, the round graphs against
     the eager rounds bit for bit, every row's ids held to the single stream,
     the verify on the tile at 28 rows and on the rows kernel at 14, f32 at
     2 layers, a row ending alone at its context end); --weight-mode dequant
     at full width (phase_dequant: bf16 weights dequantized on the card,
     prefill logits held to the plain versions, its rate beside the fused
     one); a LoRA adapter at load (phase_lora: the Falcon-7B Q4_0 tree's
     first LORA_LAYERS (8) layers written as a GGCC file, an adapter of r 16 on query_key_value and
     dense_4h_to_h of every layer loaded with it on the card, 64 greedy ids
     through the decode graphs beside the fused rate on those layers, the prefill and a
     decode step held to the plain versions on the patched tree and the
     prefill far from the unpatched engine's); after the LLaMA paths the
     quantize tool (phase_quantize: TOOL_LAYERS (1) full-width f16 files, Falcon-7B
     -> q4_0 and LLaMA-7B -> q4_k_m, each loaded and held against the plain
     versions); and the converters (phase_convert: TOOL_LAYERS (1) full-width bf16
     HF checkpoints from utils/synthetic.py, Falcon-7B -> GGCC f16 -> q4_0
     loaded with a converted PEFT adapter and the f16 file as --lora-base,
     LLaMA-7B -> GGJT f16, each held against the plain versions); long
     context on the Falcon-7B Q4_0 weights (phase_long_context: n_ctx 16384,
     n_batch 2048, dynamic NTK RoPE; a 12288-token prefill on an int8 and a
     bf16 cache, the int8 one's last logits held to the plain engine's, 128
     greedy ids from n_past 12288 through the graphs = the eager body's, the
     n_ctx 16384 and 2048 engines' decode at n_past 300 in turns, a context
     swap whose ids equal a fresh engine's fed the swapped context);
     and, last,
     multi-GPU on torch.distributed (phase_multi_gpu; the card is one H100):
     every kernel at a rank's shard shapes against its plain version, then
     ranks started by parallel/mesh.py RankPool on files written from
     seeded trees: two gloo ranks sharing the card (collectives staged
     through host memory and counted, decode eager), tensor-parallel
     Falcon-7B Q4_0 (300-token prefill, 64 greedy ids, a 2-row batcher),
     Falcon-40B Q4_K and LLaMA-7B Q4_0 (n_rot 128), each cut to MG_LAYERS (2),
     sequence-parallel Falcon-7B Q4_0 (32 ids; each rank's cache kv_T / 2
     positions): every rank's ids equal, rank 0's prefill and a decode
     step's logits within LOGIT_TOL of the single process's, its ids within
     ROWS_LOGIT_TOL with the ids forced through the single process's decode
     steps (the batcher's through its prefill), the GEMV, the rows kernel,
     the tile, flash_mqa.tc, flash_decode_tc and flash_decode.mha launched on
     the ranks; and one NCCL rank (Falcon-7B Q4_0, the same layers) whose captured
     decode graph, all-reduces inside, gives the single process's 64 greedy
     ids exactly, its tok/s beside the single process's; then the fallback
     tree and the data axis on the same ranks (phase_gspmd: Falcon-7B Q4_0
     with an r 16 adapter, dequant and Falcon-40B Q4_K / Q6_K, all at
     MG_LAYERS, a data 2 x model 1 batcher, held as above; the NCCL rank's
     fallback decode graph = its eager ids; the kernels at every shard shape
     the ranks held); and the training demo (phase_train: tools/train_demo.py
     on README.md, 200 Adam and 20 L-BFGS steps, the loss falling, gradients
     against the CPU's, the trained file's greedy ids through flash_mqa.f32
     and flash_decode.f32 held to the plain versions);
  4. write small files with the port's writers (Falcon GGCC: Q4_0 7B-style;
     Q4_K, Q2_K and Q3_K 40B-style; LLaMA GGJT: Q4_0 and Q4_K) and run the
     CLI on each, all at once, the Q3_K and the LLaMA Q4_K file with
     --kv-dtype int8; on the Q4_0 file also a context swap, -f, -r,
     --prompt-cache twice (the second run must reuse the prompt and print the
     first run's text), --draft-model (the Q4_K file as the draft), --mtest
     with --alias, -dt 1 (its table lists the GEMV and the decode kernel from
     the graph replays), --weight-mode dequant (its ids held to the fused
     engine's), --export (the forward's torch.export text, naming the
     ggllm ops) and -t 8 -ngl 100 (ignored); and a
     2-layer full-width Falcon-180B Q2_K file written from a tree built on
     the card, on which the CLI with -ts auto must pick one card and print
     16 greedy ids (the file is deleted after); and a 2-layer full-width
     Falcon-7B Q4_0 file at -c 16384 -b 2048 with a prompt of a few thousand
     tokens from -f, whose --temp 0 text must be the Generator's and whose
     run at the default temperature must print the derating line. These
     processes run alongside phase 1's SASS report, and end before phase 2.
The last two lines of standard output are the kernel table as JSON and
{"ok": true, "device": {...}}. Per-shape rows also go to
chiprun_out/chip_smoke_kernels.json.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 2e-2  # of max |plain|, bf16 inputs (tests/test_kernels.py:45)
F32_TOL = 2e-5  # of max |plain|, f32 inputs (tests/test_torch_cuda.py TOL)
LOGIT_TOL = 5e-2
# bf16 batched greedy ids against the single stream (phase 3's batching):
# the rows kernel and the one-row GEMV both form exact code x bf16 products
# summed in f32, so the two paths differ only where an activation's bf16
# rounding flips; the bf16 tensor-core tile that B rows ran before, which
# rounded every decoded weight to bf16, read worst deficits of 0.039-0.148 of
# LOGIT_TOL (at most 7.4e-3 of max |logit|) on an H100
ROWS_LOGIT_TOL = 1e-2
N_RUNS, N_WARM = 20, 3
# the cache of EngineConfig(n_ctx=16384, n_batch=2048): n_ctx + n_batch positions
LONG_CTX, LONG_BATCH = 16384, 2048
LONG_T = LONG_CTX + LONG_BATCH
# depths cut to make room for phase_export within the run's time: the
# multi-GPU phases' models (their checks are of the sharded arithmetic,
# which depth does not change; at 32 layers of Falcon-7B the host-staged
# eager decode of two ranks sharing the card took 90 s), phase_lora's tree,
# and the files of phase_quantize and phase_convert
MG_LAYERS = 2
LORA_LAYERS = 8
TOOL_LAYERS = 1
# nodes of the single stream's unmasked greedy 16-step decode graph on the
# Falcon-7B Q4_0 engine (32 layers, bf16 cache; cuGraphGetNodes on the
# captured graph, tools/time_kernels.py nodes), as the tree before masked
# decode captured it on an H100: the masked chunks must leave it as it was
# (a change to the single stream's step body updates this number)
UNMASKED_GRAPH_NODES = 12847
DIGITS = "root ::= [0-9]+"
JSON_GBNF = r"""
root   ::= object
value  ::= object | array | string | number | "true" | "false" | "null"
object ::= "{" ws ( member ( "," ws member )* )? "}" ws
member ::= string ":" ws value
array  ::= "[" ws ( value ( "," ws value )* )? "]" ws
string ::= "\"" char* "\"" ws
char   ::= [^"\\\x00-\x1f] | "\\" (["\\/bfnrt] | "u" [0-9a-fA-F] [0-9a-fA-F] [0-9a-fA-F] [0-9a-fA-F])
number ::= "-"? [0-9]+ ("." [0-9]+)? ws
ws     ::= [ \t\n]*
"""
GRAMMARS = (("digits", DIGITS), ("json", JSON_GBNF))

# card peaks (NVIDIA data sheets): memory rate, dense bf16 and TF32 tensor
# rates, and float32 outside the tensor cores
PEAKS = {"sxm": (3.35e12, 989e12, 495e12, 67e12), "pcie": (2.0e12, 756e12, 378e12, 51e12),
         "nvl": (3.9e12, 835e12, 417.5e12, 60e12)}

QUANT_FORMATS = ["q4_0", "q4_1", "q5_0", "q5_1", "q8_0", "q4_k", "q5_k", "q6_k", "q2_k", "q3_k"]
# f32 paths against the plain versions (tests/test_torch_cuda.py); the
# CUDA-core f32 kernels this slice replaced read 3.9e-6 at 32 layers of
# Falcon-7B on an H100 (time_kernels.py f32path)
F32_LOGIT_TOL = 1e-4
# kernel -> (source, the TPU kernel it replaces). "quant_matmul" is the S == 1
# GEMV of the legacy formats, ".gemv.kq" the K-quants' S == 1 GEMV (both
# around the loop of ggllm_tpu_torch/csrc/gemv.cuh), ".rows" the kernel of
# 2-16 bf16 rows (B decode rows), ".tc" the bf16 tensor-core tile, ".f32"
# the f32 tensor-core tile; "flash_mqa.tc" the bf16 tensor-core attention
# kernel (head dims 32, 64, 128; at 32 no full-width path runs it, and phase
# 2 checks it), ".f32" the f32 one. COUNTER names the launch counter of a
# kernel where it is not the kernel's own name.
REPLACES = {
    "quant_matmul": ("ggllm_tpu_torch/csrc/quant_gemv_legacy.cu",
                     "ggllm_tpu/kernels/quant_matmul.py:57"),
    "quant_matmul.gemv.kq": ("ggllm_tpu_torch/csrc/quant_gemv_kq.cu",
                             "ggllm_tpu/kernels/quant_matmul.py:57"),
    "quant_matmul.rows": ("ggllm_tpu_torch/csrc/quant_mmv.cuh",
                          "ggllm_tpu/kernels/quant_matmul.py:57"),
    "quant_matmul.tc": ("ggllm_tpu_torch/csrc/quant_gemm_tc.cuh",
                        "ggllm_tpu/kernels/quant_matmul.py:57"),
    "quant_matmul.f32": ("ggllm_tpu_torch/csrc/quant_gemm_f32.cuh",
                         "ggllm_tpu/kernels/quant_matmul.py:57"),
    "group_sums": ("ggllm_tpu_torch/csrc/group_sums.cu", "ggllm_tpu/kernels/quant_matmul.py:189"),
    "flash_mqa.f32": ("ggllm_tpu_torch/csrc/flash_attention_f32.cu",
                      "ggllm_tpu/kernels/flash_attention.py:33"),
    "flash_mqa.tc": ("ggllm_tpu_torch/csrc/flash_attention_tc.cu",
                     "ggllm_tpu/kernels/flash_attention.py:33"),
    # grouped query heads: bf16 q on the tensor cores, on a bf16 and (the same
    # Pallas kernel with quant=True, its int8 branches at :79 and :93) an int8
    # cache; f32 q (f32 and int8 caches; and bf16 q at head_dim 32) on the
    # tensor cores as split TF32
    "flash_decode_tc": ("ggllm_tpu_torch/csrc/flash_decode_tc.cu",
                        "ggllm_tpu/kernels/flash_decode.py:56"),
    "flash_decode_tc.int8": ("ggllm_tpu_torch/csrc/flash_decode_tc.cu",
                             "ggllm_tpu/kernels/flash_decode.py:79"),
    "flash_decode.f32": ("ggllm_tpu_torch/csrc/flash_decode_f32.cu",
                         "ggllm_tpu/kernels/flash_decode.py:56"),
    # the G == 1 kernel, dense and with quant=True
    "flash_decode.mha": ("ggllm_tpu_torch/csrc/flash_decode.cu",
                         "ggllm_tpu/kernels/flash_decode.py:123"),
    "flash_decode.mha.int8": ("ggllm_tpu_torch/csrc/flash_decode.cu",
                              "ggllm_tpu/kernels/flash_decode.py:123"),
}
COUNTER = {"quant_matmul": "quant_matmul.gemv"}
# the f32 prefill kernels, which no bf16 path may run
F32_KERNELS = ("quant_matmul.f32", "flash_mqa.f32", "group_sums")
# the bf16 tensor-core kernels, which no f32 path may run
BF16_TC_KERNELS = ("quant_matmul.rows", "quant_matmul.tc", "flash_mqa.tc", "flash_decode_tc")
# every flash-decode launch counter: the wrapper's (by head layout and cache)
# and the route's
DECODE_COUNTERS = ("flash_decode", "flash_decode.int8", "flash_decode.mha", "flash_decode.mha.int8",
                   "flash_decode_tc", "flash_decode_tc.int8", "flash_decode.f32")
# the caches and head dims each decode kernel takes (the kernels line)
DECODE_LAYOUTS = {"flash_decode_tc": (["bfloat16"], [64, 128]),
                  "flash_decode_tc.int8": (["int8"], [64, 128]),
                  "flash_decode.f32": (["float32", "int8", "bfloat16"], [32, 64, 128]),
                  "flash_decode.mha": (["bfloat16", "float32"], [32, 64, 128]),
                  "flash_decode.mha.int8": (["int8"], [32, 64, 128])}


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


def lib_q(q):
    """q (B, S, H, D) as scaled_dot_product_attention takes it, (B, H, S, D):
    the transposed view of a copy that has 64 zero query rows behind its
    last. On an H100 (torch 2.11) the library call with f32 q of one row
    over 2047 keys (71 heads) stopped on an illegal address when q ended
    40 KB before the end of an allocator segment, and ran with the rows
    behind q its own. So the yardstick's q owns the memory behind it."""
    buf = q.new_zeros(q.shape[0], q.shape[1] + 64, *q.shape[2:])
    buf[:, :q.shape[1]] = q
    return buf[:, :q.shape[1]].transpose(1, 2)


def check(name: str, got, ref, tol: float = TOL) -> tuple[float, float]:
    """(max abs err, max abs err / max |ref|); raises above `tol` (TOL for
    bf16 rows, F32_TOL for f32 rows)."""
    got, ref = got.float(), ref.float()
    if not bool(got.isfinite().all()):
        raise RuntimeError(f"{name}: kernel output is not finite")
    err = float((got - ref).abs().max())
    rel = err / max(float(ref.abs().max()), 1e-30)
    if rel > tol:
        raise RuntimeError(f"{name}: max err {err:.3e} = {rel:.3e} of max|ref| > {tol}")
    return err, rel


def phase_kernels(torch, timer, bw, peak, peak_tf32, peak_f32) -> list[dict]:
    """Every kernel against its plain version at the main-path shapes."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

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

    def row(kernel, shape, err, rel, ms, plain_ms, lib_ms, nbytes, ops, rate=peak, **device_ms):
        """ops at `rate`: the bf16 tensor rate unless given (the f32 rate of
        the CUDA cores; the f32 tensor-core kernels' three products at the
        bf16 or TF32 rate, with their f32 CUDA-core bound beside it)."""
        tb, to = nbytes / bw * 1e3, ops / rate * 1e3
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
    def matmul_row(fmt, wname, w, wbytes, wdeq, S, xdtype, out_dtype, graphs=False, **extra):
        """One (weight, S, x dtype) case: the route's kernel against the plain
        version, counted under its own counter, timed beside `x @ wdeq^T`;
        a GEMV (S = 1), or any S with `graphs`, and its library call also as
        device time (a CUDA graph of one call); `extra` goes into the row."""
        (O, K), path = w.shape, qm.route(S, xdtype, w.gtype)
        if path == "gemv" and qm.gemv_kernel(w.gtype) == "kq":
            path = "gemv.kq"
        x = torch.randn(S, K, generator=gen, device="cuda").to(xdtype)
        before = build.launch_counts[f"quant_matmul.{path}"]
        got = qm.quant_matmul(w, x, out_dtype)
        if build.launch_counts[f"quant_matmul.{path}"] != before + 1:
            raise RuntimeError(f"quant_matmul {fmt} S={S} {xdtype} did not run the {path} kernel")
        ref = qm.quant_matmul_plain(w, x, out_dtype)
        f32 = xdtype == torch.float32
        err, rel = check(f"quant_matmul {fmt} {wname} S={S} {path}", got, ref,
                         F32_TOL if f32 else TOL)
        ms = timer(lambda: qm.quant_matmul(w, x, out_dtype))
        plain_ms = timer(lambda: qm.quant_matmul_plain(w, x, out_dtype))
        lib_ms = timer(lambda: torch.matmul(x, wdeq.t()))
        nbytes = (wbytes + S * K * x.element_size()
                  + S * O * (4 if out_dtype == torch.float32 else 2))
        device_ms = dict(extra)
        if S == 1 or graphs:
            device_ms |= {"graph_ms": graph_ms(lambda i: qm.quant_matmul(w, x, out_dtype), 1,
                                              timer.flush),
                         "library_graph_ms": graph_ms(lambda i: torch.matmul(x, wdeq.t()), 1,
                                                      timer.flush)}
        if f32:  # three bf16 products on the tensor cores; 2 S O K f32 FMAs on the CUDA cores
            device_ms["f32_core_bound_ms"] = 2 * S * O * K / peak_f32 * 1e3
        row("quant_matmul" if path == "gemv" else f"quant_matmul.{path}",
            f"{fmt} {wname} O={O} K={K} S={S}", err, rel, ms, plain_ms, lib_ms, nbytes,
            (3 if f32 else 1) * 2 * S * O * K, **device_ms)

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

    # ---- Falcon-180B's Q2_K matrices (w_od: K = E + F, 1.10 G weights) at one
    # row (the K-quant GEMV) and 300 (the tile: the 180B path's prefill), each
    # also as device time
    shapes_180b = (("180b.wqkv", 15872, 14848), ("180b.ffn_up", 59392, 14848),
                   ("180b.w_od", 14848, 74240), ("180b.lm_head", 65024, 14848))
    for wname, O, K in shapes_180b:
        w = random_quant(GGMLType.Q2_K, O, K, gen, "cuda")
        wbytes = sum(p.numel() * p.element_size() for p in w.planes.values())
        wdeq = w.dequantize(bf16)
        out_dtype = torch.float32 if wname.endswith("lm_head") else bf16
        for S in (1, 300):
            matmul_row("q2_k", wname, w, wbytes, wdeq, S, bf16, out_dtype, graphs=True)
        del w, wdeq

    # ---- the tensor-core tile off the main-path shapes: short and ragged S
    # (17 rows: the 64-row tile; 300: two 256-row chunks, or three of 128
    # rows where those fill the card better) at
    # one legacy and one K-quant weight, and an O that is no multiple of 64;
    # then the f32 tile, which serves f32 x only, at the same two weights at
    # S = 300 (the f32 paths' prefill: 64 x rows a block at both) and 512
    # (128 rows), and at the f32 paths' other 300-row widths (128 rows):
    # Falcon-7B's lm_head and LLaMA-7B's w13 and w2
    for fmt, wname, O, K in (("q4_0", "wqkvu", 22848, 4544), ("q4_k", "wqkv", 9216, 8192),
                             ("q4_0", "ragged", 4500, 4544), ("q4_k", "ragged", 9001, 8192)):
        w = random_quant(GGMLType[fmt.upper()], O, K, gen, "cuda")
        wbytes = sum(p.numel() * p.element_size() for p in w.planes.values())
        wdeq = w.dequantize(bf16)
        for S in ((300,) if wname == "ragged" else (17, 300)):
            matmul_row(fmt, wname, w, wbytes, wdeq, S, bf16, bf16)
        if wname != "ragged":
            wdeq = wdeq.float()
            for S in (300, 512):
                matmul_row(fmt, wname, w, wbytes, wdeq, S, torch.float32, torch.float32)
        del w, wdeq
    # the batched speculative rounds' verify at B = 4, k = 6: 28 rows of the
    # Falcon-7B decode weights on the tile, also as device time
    for wname, O, K in shapes_7b:
        w = random_quant(GGMLType.Q4_0, O, K, gen, "cuda")
        wbytes = sum(p.numel() * p.element_size() for p in w.planes.values())
        wdeq = w.dequantize(bf16)
        matmul_row("q4_0", wname, w, wbytes, wdeq, 28, bf16,
                   torch.float32 if wname == "lm_head" else bf16, graphs=True)
        del w, wdeq
    for wname, O, K in (("lm_head", 65024, 4544), ("llama.w13", 22016, 4096),
                        ("llama.w2", 4096, 11008)):
        w = random_quant(GGMLType.Q4_0, O, K, gen, "cuda")
        wbytes = sum(p.numel() * p.element_size() for p in w.planes.values())
        wdeq = w.dequantize(torch.float32)
        matmul_row("q4_0", wname, w, wbytes, wdeq, 300, torch.float32, torch.float32)
        del w, wdeq

    # ---- B decode rows (continuous batching): S = B rows of bf16 x through
    # the rows kernel at B = 2, 4, 8, 16 at Falcon-7B Q4_0's, LLaMA-7B Q4_0's
    # and Falcon-40B Q4_K's decode weights, every other format at B = 4 on its
    # model's: f32 y held at F32_TOL (exact products summed in f32), the
    # path's y (bf16 but for the lm_head) at TOL; timed as one call and as
    # device time (a graph of one call) beside B one-row GEMVs, the
    # tensor-core tile at the same rows (quant_matmul_tc: its 64-row width)
    # and torch.matmul on the dequantized weight (both ways); bound: the
    # weight planes' bytes (x and y are 0.1 % of them). At the largest B a
    # row's y must equal, bit for bit, the same call's with the other rows
    # redrawn and the call at two rows with a zero row
    llama_rows = tuple(sh for sh in shapes_llama if sh[0] in ("llama.wqkv", "llama.wo", "llama.w2"))
    rows_cases = [("q4_0", shapes_7b, (2, 4, 8, 16)), ("q4_0", llama_rows, (2, 4, 8, 16)),
                  ("q4_k", shapes_40b[::2], (2, 4, 8, 16))]
    rows_cases += [(fmt, shapes_40b if GGMLType[fmt.upper()] in qm.K_QUANTS else shapes_7b, (4,))
                   for fmt in QUANT_FORMATS if fmt not in ("q4_0", "q4_k")]
    for fmt, shapes, batch in rows_cases:
        for wname, O, K in shapes:
            w = random_quant(GGMLType[fmt.upper()], O, K, gen, "cuda")
            wbytes = sum(p.numel() * p.element_size() for p in w.planes.values())
            wdeq = w.dequantize(bf16)
            out_dtype = torch.float32 if wname.endswith("lm_head") else bf16
            x1 = torch.randn(1, K, generator=gen, device="cuda").to(bf16)
            gemv_graph = graph_ms(lambda i: qm.quant_matmul(w, x1, out_dtype), 1, timer.flush)
            for S in batch:
                x = torch.randn(S, K, generator=gen, device="cuda").to(bf16)
                label = f"quant_matmul.rows {fmt} {wname} S={S}"
                before = build.launch_counts["quant_matmul.rows"]
                got32 = qm.quant_matmul(w, x, torch.float32)
                got = qm.quant_matmul(w, x, out_dtype)
                if build.launch_counts["quant_matmul.rows"] != before + 2:
                    raise RuntimeError(f"{label} did not run the rows kernel")
                err, rel = check(f"{label} f32 y", got32,
                                 qm.quant_matmul_plain(w, x, torch.float32), F32_TOL)
                check(f"{label} {out_dtype} y", got, qm.quant_matmul_plain(w, x, out_dtype))
                if S == batch[-1]:
                    other = torch.randn(S, K, generator=gen, device="cuda").to(bf16)
                    for r in (0, S - 1):
                        pair = torch.stack([x[r], torch.zeros_like(x[r])])
                        mixed = other.clone()
                        mixed[r] = x[r]
                        if not (torch.equal(qm.quant_matmul(w, pair, torch.float32)[0], got32[r])
                                and torch.equal(qm.quant_matmul(w, mixed, torch.float32)[r],
                                                got32[r])):
                            raise RuntimeError(f"{label}: row {r}'s y depends on the other rows")
                ms = timer(lambda: qm.quant_matmul(w, x, out_dtype))
                plain_ms = timer(lambda: qm.quant_matmul_plain(w, x, out_dtype))
                lib_ms = timer(lambda: torch.matmul(x, wdeq.t()))
                nbytes = wbytes + S * K * 2 + S * O * (4 if out_dtype == torch.float32 else 2)
                row("quant_matmul.rows", f"{fmt} rows {wname} O={O} K={K} S={S}", err, rel, ms,
                    plain_ms, lib_ms, nbytes, 2 * S * O * K,
                    graph_ms=graph_ms(lambda i: qm.quant_matmul(w, x, out_dtype), 1, timer.flush),
                    library_graph_ms=graph_ms(lambda i: torch.matmul(x, wdeq.t()), 1, timer.flush),
                    tile_graph_ms=graph_ms(lambda i: qm.quant_matmul_tc(w, x, out_dtype), 1,
                                           timer.flush),
                    gemv_graph_ms_times_S=S * gemv_graph, cluster=qm.rows_cluster(O))
            del w, wdeq

    # ---- group_sums: f32 x (only the f32 tile takes group sums), 32-wide at
    # the Falcon-7B and LLaMA-7B widths at S = 300 (the f32 paths' prefill)
    # and 512, 16-wide (Q2_K, Q3_K, Q6_K) at the 40B ones
    for S, K, g in ((300, 4544, 32), (300, 22720, 32), (300, 4096, 32), (300, 11008, 32),
                    (512, 4544, 32), (512, 22720, 32), (512, 4096, 32), (512, 11008, 32),
                    (512, 8192, 16), (512, 40960, 16)):
        x = torch.randn(S, K, generator=gen, device="cuda")
        emap = (torch.arange(K, device="cuda")[:, None] // g
                == torch.arange(K // g, device="cuda")[None, :]).float()
        err, rel = check(f"group_sums S={S} K={K} g={g}", qm.group_sums(x, g),
                         qm.group_sums_plain(x, g), F32_TOL)
        ms = timer(lambda: qm.group_sums(x, g))
        plain_ms = timer(lambda: qm.group_sums_plain(x, g))
        lib_ms = timer(lambda: torch.matmul(x, emap))
        row("group_sums", f"S={S} K={K} g={g}", err, rel, ms, plain_ms, lib_ms,
            S * K * 4 + S * K // g * 4, S * K, rate=peak_f32)
        del emap

    # ---- flash_mqa: S=512 against one (1, T=2560, KV, D) cache layer, at
    # Falcon-7B's 71 heads over one K/V head, Falcon-40B's 128 over 8 (D = 64)
    # and LLaMA-7B's 32 heads with a K/V head each (D = 128); S = 300 (its
    # path's prefill) at Falcon-180B's 232 over 8 (D = 64)
    T, S = 2560, 512

    def mqa_row(q, k, v, n_past, H, KV, D, plain=flash_mqa_plain, tag=""):
        """One case through the wrapper: bf16 runs the bf16 tensor-core
        kernel, f32 the f32 one; timed beside scaled_dot_product_attention
        and `plain`, the plain version (`tag` begins the row's shape)."""
        S = q.shape[1]
        f32 = q.dtype == torch.float32
        name = "flash_mqa.f32" if f32 else "flash_mqa.tc"
        before = build.launch_counts[name]
        got = flash_mqa(q, k, v, n_past)
        if build.launch_counts[name] != before + 1:
            raise RuntimeError(f"flash_mqa {q.dtype} D={D} did not count under {name}")
        err, rel = check(f"{name} {tag}H={H} KV={KV} n_past={n_past}", got,
                         plain(q, k, v, n_past), F32_TOL if f32 else TOL)
        ms = timer(lambda: flash_mqa(q, k, v, n_past))
        plain_ms = timer(lambda: plain(q, k, v, n_past))
        Tv = n_past + S
        qt = lib_q(q)
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
        extra = {}
        if f32:  # three TF32 products on the tensor cores; f32 FMAs on the CUDA cores
            extra["f32_core_bound_ms"] = 4 * pairs * H * D / peak_f32 * 1e3
        row(name, f"{tag}S={S} n_past={n_past} H={H} KV={KV} D={D}", err, rel, ms, plain_ms, lib_ms,
            2 * S * H * D * eb + 2 * Tv * KV * D * eb, (3 if f32 else 1) * 4 * pairs * H * D,
            rate=peak_tf32 if f32 else peak, **extra)

    for H, KV, D, past in ((71, 1, 64, (0, 300)), (128, 8, 64, (0,)), (32, 32, 128, (0, 300)),
                           (232, 8, 64, (0,))):
        kvc = torch.randn(1, 2, 1, T, KV, D, generator=gen, device="cuda").to(bf16)
        k, v = kvc[0, 0], kvc[0, 1]
        q = torch.randn(1, 300 if H == 232 else S, H, D, generator=gen, device="cuda").to(bf16)
        for n_past in past:
            mqa_row(q, k, v, n_past, H, KV, D)
        if KV != 8:  # the f32 kernel at the layouts of the f32 paths
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
    # bf16 at head dim 32 on the tensor-core kernel: the small test models'
    # layout (6 heads over 2 K/V heads, a length per row), timed beside SDPA
    # with the same causal mask (its bound: q, the visible K/V and out; 4 D
    # operations a visible (query, key) pair and head); then S = 512 at the
    # training demo's 4 heads over one K/V head (mqa_row)
    q32 = torch.randn(2, 45, 6, 32, generator=gen, device="cuda").to(bf16)
    kv32 = torch.randn(2, 2, 400, 2, 32, generator=gen, device="cuda").to(bf16)
    before = build.launch_counts["flash_mqa.tc"]
    err, rel = check("flash_mqa.tc bf16 D=32", flash_mqa(q32, kv32[0], kv32[1], rows_past),
                     flash_mqa_plain(q32, kv32[0], kv32[1], rows_past))
    if build.launch_counts["flash_mqa.tc"] != before + 1:
        raise RuntimeError("bf16 flash_mqa at head dim 32 did not run the tensor-core kernel")
    pos = rows_past[:, None] + torch.arange(45, device="cuda")  # (B, S) query positions
    mask32 = (torch.arange(400, device="cuda")[None, None, :] <= pos[:, :, None])[:, None]
    pairs = int((pos + 1).sum())
    q32t = lib_q(q32)
    row("flash_mqa.tc", "B=2 S=45 n_past=[300, 7] H=6 KV=2 D=32", err, rel,
        timer(lambda: flash_mqa(q32, kv32[0], kv32[1], rows_past)),
        timer(lambda: flash_mqa_plain(q32, kv32[0], kv32[1], rows_past)),
        timer(lambda: F.scaled_dot_product_attention(
            q32t, kv32[0].transpose(1, 2), kv32[1].transpose(1, 2),
            attn_mask=mask32, enable_gqa=True)),
        2 * q32.numel() * 2 + int((pos[:, -1] + 1).sum()) * 2 * 2 * 32 * 2, 4 * pairs * 6 * 32)
    kvc = torch.randn(1, 2, 1, T, 1, 32, generator=gen, device="cuda").to(bf16)
    q = torch.randn(1, S, 4, 32, generator=gen, device="cuda").to(bf16)
    for n_past in (0, 300):
        mqa_row(q, kvc[0, 0], kvc[0, 1], n_past, 4, 1, 32)
    del kvc

    # ---- flash_decode: the last layer of the full cache (32 layers at
    # Falcon-7B and LLaMA-7B, 60 at 40B, 80 at 180B: 29 query heads a K/V
    # head, padded to 32 rows); grouped heads take the tensor-core
    # kernel, H == KV the G == 1 kernel, each on a bf16 and an int8 cache.
    # Timed two ways: one call between events (ms: what an eager decode step
    # pays, host work included) and device time (graph_ms: a CUDA graph of one
    # call per layer, as a decode step makes them, divided by the layers); the
    # library call both ways too
    def decode_case(kv, kv8, deq, q1, app, valids, prefix=""):
        """Layer L - 1 of the bf16 cache kv (L, 2, 1, T, KV, D) and of the
        same cache as int8 codes + f32 scales kv8 (q stays bf16; the
        reference attends codes * scales in f32; the library call gets deq,
        the dequantized cache in bf16: it has no int8 form) at each valid
        length, with and without the append block app; `prefix` begins the
        rows' shapes."""
        L, _, _, _, KV, D = kv.shape
        H = q1.shape[2]
        l, G = L - 1, H // KV
        qg = q1.reshape(1, KV, G, D)
        st = FalconStatic(n_layer=L, n_head=H, n_head_kv=KV, head_dim=D, n_embd=H * D,
                          n_ff=4 * H * D, n_vocab=0, parallel_norms=KV > 1)
        deq32 = kv8[0][l].float() * kv8[1][l]  # (2, 1, T, KV, D)
        base = "flash_decode_tc" if G > 1 else "flash_decode.mha"
        for name, cache, kr, vr, lib_kv, per_pos in (
                (base, kv, kv[l, 0], kv[l, 1], kv, 2 * D),
                (base + ".int8", kv8, deq32[0], deq32[1], deq, D + 4)):
            tag = prefix + ("int8 " if name.endswith("int8") else "")
            for valid in valids:
                # cache valid below `valid`: no append -> n_past = valid - 1;
                # append with 5 valid entries -> n_past = valid + 4
                before = build.launch_counts[name]
                got = fd.flash_decode(cache, KV, l, q1, valid - 1)
                if build.launch_counts[name] != before + 1:
                    raise RuntimeError(f"flash_decode {tag}G={G} did not run the {name} kernel")
                err, rel = check(f"{name} {prefix}G={G} valid={valid}", got,
                                 _attention(q1, kr, vr, valid - 1, st))
                err_a, rel_a = check(f"{name} {prefix}G={G} valid={valid} +append",
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

                q1t = lib_q(q1)

                def sdpa(i):
                    return F.scaled_dot_product_attention(q1t, kt[i], vt[i],
                                                          enable_gqa=G > 1 and KV > 1)

                lib_ms = timer(lambda: sdpa(l))
                lib_dev_ms = graph_ms(sdpa, L, timer.flush)
                # bytes: K and V of the valid prefix (per position and K/V head
                # 2 D in bf16, D + 4 as codes and a scale), q and the output
                row(name, f"{tag}valid={valid} G={G} KV={KV} D={D} (+append err {err_a:.1e})",
                    max(err, err_a), max(rel, rel_a), ms, plain_ms, lib_ms,
                    2 * valid * KV * per_pos + 2 * H * D * 2, 4 * valid * H * D,
                    graph_ms=dev_ms, library_graph_ms=lib_dev_ms)
        return st, base

    for L, H, KV, D, valids in ((32, 71, 1, 64, (1, 300, 2047)), (60, 128, 8, 64, (300, 2047)),
                                (32, 32, 32, 128, (1, 300, 2047)),
                                (80, 232, 8, 64, (1, 300, 2047))):
        G = H // KV
        kv = torch.randn(L, 2, 1, T, KV, D, generator=gen, device="cuda").to(bf16)
        q1 = torch.randn(1, 1, H, D, generator=gen, device="cuda").to(bf16)
        app = torch.randn(2, 1, 16, KV, D, generator=gen, device="cuda").to(bf16)
        kv8 = kvcache.quantize_new(kv)
        deq = torch.stack([(kv8[0][i].float() * kv8[1][i]).to(bf16) for i in range(L)])
        st, base = decode_case(kv, kv8, deq, q1, app, valids)
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
        del kv, kv8, deq, kv2, kv8_2, deq2

    # ---- flash_decode at B decode rows (continuous batching): Falcon-7B's
    # heads, four live rows at valid 300, 17, 2047 and 1 and one parked at
    # n_ctx (its step writes at 2048: valid 2049), lengths in a device tensor
    # as the B-row decode graph passes them; bf16 and int8 caches, bf16 q;
    # timed as above (a graph of one call per layer of a 2-layer cache), the
    # library call SDPA with each row's mask; bound: each row's valid K/V
    H, KV, D = 71, 1, 64
    st = FalconStatic(n_layer=2, n_head=H, n_head_kv=KV, head_dim=D, n_embd=H * D,
                      n_ff=4 * H * D, n_vocab=0, parallel_norms=False)
    lens5 = torch.tensor([300, 17, 2047, 1, 2049], dtype=torch.int32, device="cuda")
    kv5 = torch.randn(2, 2, 5, T, KV, D, generator=gen, device="cuda").to(bf16)
    q5 = torch.randn(5, 1, H, D, generator=gen, device="cuda").to(bf16)
    kv8_5 = kvcache.quantize_new(kv5)
    mask5 = (torch.arange(T, device="cuda")[None, :] < lens5[:, None].long())[:, None, None]
    for name, cache, lib_kv, per_pos in (
            ("flash_decode_tc", kv5, kv5, 2 * D),
            ("flash_decode_tc.int8", kv8_5,
             (kv8_5[0].float() * kv8_5[1]).to(bf16), D + 4)):
        ref_kv = ((kv8_5[0][1].float() * kv8_5[1][1]) if name.endswith("int8")
                  else kv5[1].float())
        before = build.launch_counts[name]
        got = fd.flash_decode(cache, KV, 1, q5, lens5 - 1)
        if build.launch_counts[name] != before + 1:
            raise RuntimeError(f"flash_decode at 5 rows did not run the {name} kernel")
        err, rel = check(f"{name} 5 rows valid [300, 17, 2047, 1, parked]", got,
                         _attention(q5, ref_kv[0], ref_kv[1], lens5 - 1, st))
        kt = [lib_kv[i, 0].transpose(1, 2).expand(5, H, T, D) for i in range(2)]
        vt = [lib_kv[i, 1].transpose(1, 2).expand(5, H, T, D) for i in range(2)]

        q5t = lib_q(q5)

        def sdpa5(i):
            return F.scaled_dot_product_attention(q5t, kt[i], vt[i], attn_mask=mask5)

        tag = "int8 " if name.endswith("int8") else ""
        row(name, f"{tag}rows B=5 valid=[300, 17, 2047, 1, 2049] G={H} KV={KV} D={D}", err, rel,
            timer(lambda: fd.flash_decode(cache, KV, 1, q5, lens5 - 1)),
            timer(lambda: fd.flash_decode_plain(cache, KV, 1, q5, lens5 - 1)),
            timer(lambda: sdpa5(1)),
            2 * int(lens5.sum()) * KV * per_pos + 2 * 5 * H * D * 2, 4 * int(lens5.sum()) * H * D,
            graph_ms=graph_ms(lambda i: fd.flash_decode(cache, KV, i, q5, lens5 - 1), 2,
                              timer.flush),
            library_graph_ms=graph_ms(sdpa5, 2, timer.flush))
        del ref_kv, kt, vt
    del kv5, kv8_5, q5, mask5

    # ---- flash_decode on the f32 route: f32 q on an f32 cache and on an int8
    # cache (the f32 route's decode; --memory-f32 casts bf16 q to its f32
    # cache) at Falcon-7B's and Falcon-40B's head layouts, the last layer of
    # the full-depth cache, held at F32_TOL against the plain attention; the
    # partials also against partials_emulated (the kernel's splits, warps'
    # key tiles and split-TF32 terms); timed as the bf16 rows, beside f32 SDPA
    # (TF32 off; its math backend, sdpa32). Bound: the valid K and V (2 D 4
    # bytes a position and K/V head in f32, 2 D + 8 as codes and scales) + q +
    # out, or the products on the tensor cores (three split-TF32 products a
    # product, two for int8 codes, at the TF32 rate)
    for L, H, KV, D, valids in ((32, 71, 1, 64, (1, 300, 2047)), (60, 128, 8, 64, (1, 300, 2047))):
        l, G = L - 1, H // KV
        kv = torch.randn(L, 2, 1, T, KV, D, generator=gen, device="cuda")
        q1 = torch.randn(1, 1, H, D, generator=gen, device="cuda")
        qg = q1.reshape(1, KV, G, D)
        app = torch.randn(2, 1, 16, KV, D, generator=gen, device="cuda")
        st = FalconStatic(n_layer=L, n_head=H, n_head_kv=KV, head_dim=D, n_embd=H * D,
                          n_ff=4 * H * D, n_vocab=0, parallel_norms=KV > 1)
        kv8 = kvcache.quantize_new(kv)
        deq = kv8[0].float() * kv8[1]  # the library's f32 cache
        cases = [("f32 ", kv, kv, 8 * D, 3, valids), ("int8 ", kv8, deq, 2 * D + 8, 2, valids)]
        if G == 71:  # f32 compute on the default bf16 cache: q stays f32
            kvb = kv.to(bf16)
            cases.append(("bf16 cache f32 q ", kvb, kvb.float(), 4 * D, 2, (300, 2047)))
        for tag, cache, lib_kv, key_bytes, products, tag_valids in cases:
            kr, vr = lib_kv[l, 0], lib_kv[l, 1]
            for valid in tag_valids:
                name = "flash_decode.f32"
                before = build.launch_counts[name]
                got = fd.flash_decode(cache, KV, l, q1, valid - 1)
                if build.launch_counts[name] != before + 1:
                    raise RuntimeError(f"f32 flash_decode {tag}G={G} did not run the {name} kernel")
                err, rel = check(f"{name} {tag}G={G} valid={valid}", got,
                                 _attention(q1, kr, vr, valid - 1, st), F32_TOL)
                err_a, rel_a = check(f"{name} {tag}G={G} valid={valid} +append",
                                     fd.flash_decode(cache, KV, l, q1, valid + 4, kv_append=app,
                                                     append_valid=5),
                                     _attention(q1, kr, vr, valid + 4, st, kv_append=app,
                                                append_valid=5), F32_TOL)
                acc, m, lsum = fd.cache_partials(cache, KV, l, qg, valid)
                for what, (acc_r, m_r, l_r) in (
                        ("plain", fd.cache_partials_plain(cache, KV, l, qg, valid)),
                        ("emulated", fd.partials_emulated(cache, KV, l, qg, valid,
                                                          n_sm=fd._sm_count(qg.device)))):
                    check(f"cache_partials {tag}G={G} valid={valid} vs {what}", acc / lsum,
                          acc_r / l_r, F32_TOL)
                    check(f"cache_partials {tag}m G={G} valid={valid} vs {what}", m, m_r, F32_TOL)
                    check(f"cache_partials {tag}l G={G} valid={valid} vs {what}", lsum, l_r,
                          F32_TOL)
                ms = timer(lambda: fd.flash_decode(cache, KV, l, q1, valid - 1))
                dev_ms = graph_ms(lambda i: fd.flash_decode(cache, KV, i, q1, valid - 1), L,
                                  timer.flush)
                plain_ms = timer(lambda: fd.flash_decode_plain(cache, KV, l, q1, valid - 1))
                kt = [lib_kv[i, 0, :, :valid].transpose(1, 2) for i in range(L)]
                vt = [lib_kv[i, 1, :, :valid].transpose(1, 2) for i in range(L)]
                if KV == 1:
                    kt = [k.expand(1, H, valid, D) for k in kt]
                    vt = [v.expand(1, H, valid, D) for v in vt]

                q1t = lib_q(q1)

                def sdpa32(i):
                    # SDPA's math backend: on an H100 (torch 2.11) the
                    # memory-efficient kernel, which SDPA picks for f32, wrote
                    # past its tensors at one query row of 71 heads (valid 1 and
                    # 2047): a flash-decode workspace's arrival counter held f32
                    # output values after the call, and the next merge that
                    # used it came out wrong
                    with sdpa_kernel(SDPBackend.MATH):
                        return F.scaled_dot_product_attention(q1t, kt[i], vt[i],
                                                              enable_gqa=KV > 1)

                lib_ms = timer(lambda: sdpa32(l))
                lib_dev_ms = graph_ms(sdpa32, L, timer.flush)
                row(name, f"{tag}valid={valid} G={G} KV={KV} D={D} (+append err {err_a:.1e})",
                    max(err, err_a), max(rel, rel_a), ms, plain_ms, lib_ms,
                    valid * KV * key_bytes + 2 * H * D * 4, products * 4 * valid * H * D,
                    rate=peak_tf32, graph_ms=dev_ms, library_graph_ms=lib_dev_ms,
                    f32_core_bound_ms=4 * valid * H * D / peak_f32 * 1e3)
        del deq, cases
        # one length per batch row (B = 2, two layers), with and without the
        # append block
        kv2 = torch.randn(2, 2, 2, T, KV, D, generator=gen, device="cuda")
        q2 = torch.randn(2, 1, H, D, generator=gen, device="cuda")
        app2 = torch.randn(2, 2, 16, KV, D, generator=gen, device="cuda")
        kv8_2 = kvcache.quantize_new(kv2)
        deq2 = kv8_2[0][1].float() * kv8_2[1][1]
        lens = torch.tensor([2047, 300], dtype=torch.int32, device="cuda")
        for tag, cache, kr, vr in (("f32", kv2, kv2[1, 0], kv2[1, 1]), ("int8", kv8_2, deq2[0], deq2[1])):
            err, rel = check(f"flash_decode.f32 {tag} per-row valid",
                             fd.flash_decode(cache, KV, 1, q2, lens - 1),
                             _attention(q2, kr, vr, lens - 1, st), F32_TOL)
            err_a, rel_a = check(f"flash_decode.f32 {tag} per-row valid +append",
                                 fd.flash_decode(cache, KV, 1, q2, lens + 4, kv_append=app2,
                                                 append_valid=5),
                                 _attention(q2, kr, vr, lens + 4, st, kv_append=app2,
                                            append_valid=5), F32_TOL)
            log(f"  flash_decode.f32 {tag} B=2 valid=[2047, 300] G={G} err {err:.2e} ({rel:.1e}"
                f" rel), +append {err_a:.2e} ({rel_a:.1e} rel)")
        del kv, kv8, kv2, kv8_2, deq2
    # bf16 q at head dim 32 (the small test models) on a bf16 and an int8 cache
    for tag in ("bf16", "int8"):
        kvs = torch.randn(2, 2, 2, 160, 2, 32, generator=gen, device="cuda")
        kvs = kvcache.quantize_new(kvs) if tag == "int8" else kvs.to(bf16)
        q6 = torch.randn(2, 1, 6, 32, generator=gen, device="cuda").to(bf16)
        app6 = torch.randn(2, 2, 5, 2, 32, generator=gen, device="cuda").to(bf16)
        lens = torch.tensor([150, 7], dtype=torch.int32, device="cuda")
        before = build.launch_counts["flash_decode.f32"]
        err, rel = check(f"flash_decode.f32 bf16 q D=32 {tag} cache",
                         fd.flash_decode(kvs, 2, 1, q6, lens, kv_append=app6, append_valid=3),
                         fd.flash_decode_plain(kvs, 2, 1, q6, lens, kv_append=app6,
                                               append_valid=3))
        if build.launch_counts["flash_decode.f32"] != before + 1:
            raise RuntimeError("bf16 flash_decode at head dim 32 did not run the f32 kernel")
        log(f"  flash_decode.f32 B=2 valid=[150, 7] H=6 KV=2 D=32 bf16 q, {tag} cache, +append:"
            f" err {err:.2e} ({rel:.1e} rel)")

    _long_context_kernels(torch, gen, mqa_row, decode_case)

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


def _long_context_kernels(torch, gen, mqa_row, decode_case) -> None:
    """phase_kernels' rows at the lengths of EngineConfig(n_ctx=16384,
    n_batch=2048), whose cache holds T = 18432 positions (LONG_T), through
    its mqa_row and decode_case. flash_mqa.tc at the 2048-row prefill chunks
    of a 12288-token prompt (its first and last: n_past 0 and 10240) over
    that cache, Falcon-7B's 71 heads over one K/V head and 40B's 128 over 8,
    against the plain version in 512-row pieces (its whole block of f32
    scores would take 19 GB at 128 heads). Decode (flash_decode_tc, and the
    G == 1 kernel) at valid 8192 / 12288 / 16383 of the last layer of a
    full-depth cache of that length: Falcon-7B's heads, 40B's and 180B's at
    16383, and LLaMA-7B's on layer 31 of a 32-layer cache, whose offsets
    pass 2^31 elements; there a per-row cache write and a chunk-end write of
    every layer (ops/kvcache.py write_layer / write_all_layers at a device
    n_past) are read back."""
    from ggllm_tpu_torch.kernels.flash_attention import flash_mqa_plain
    from ggllm_tpu_torch.ops import kvcache

    bf16, T = torch.bfloat16, LONG_T

    def plain_pieces(q, k, v, n_past, rows=512):
        return torch.cat([flash_mqa_plain(q[:, i:i + rows], k, v, n_past + i)
                          for i in range(0, q.shape[1], rows)], dim=1)

    for H, KV, past in ((71, 1, (0, 10240)), (128, 8, (10240,))):
        kvc = torch.randn(2, 1, T, KV, 64, generator=gen, device="cuda").to(bf16)
        q = torch.randn(1, 2048, H, 64, generator=gen, device="cuda").to(bf16)
        for n_past in past:
            mqa_row(q, kvc[0], kvc[1], n_past, H, KV, 64, plain=plain_pieces, tag=f"Tn={T} ")
        del kvc, q
    torch.cuda.empty_cache()

    for L, H, KV, D, valids in ((32, 71, 1, 64, (8192, 12288, 16383)),
                                (60, 128, 8, 64, (16383,)), (80, 232, 8, 64, (16383,)),
                                (32, 32, 32, 128, (16383,))):
        l = L - 1
        # a layer at a time: LLaMA-7B's cache is 4.83 G elements
        kv = torch.empty(L, 2, 1, T, KV, D, dtype=bf16, device="cuda")
        codes = torch.empty(kv.shape, dtype=torch.int8, device="cuda")
        scales = torch.empty(*kv.shape[:-1], 1, dtype=torch.float32, device="cuda")
        deq = torch.empty_like(kv)
        for i in range(L):
            kv[i] = torch.randn(2, 1, T, KV, D, generator=gen, device="cuda").to(bf16)
            codes[i], scales[i] = kvcache.quantize_new(kv[i])
            deq[i] = (codes[i].float() * scales[i]).to(bf16)
        kv8 = (codes, scales)
        q1 = torch.randn(1, 1, H, D, generator=gen, device="cuda").to(bf16)
        app = torch.randn(2, 1, 16, KV, D, generator=gen, device="cuda").to(bf16)
        big = kv.numel() > 2**31
        decode_case(kv, kv8, deq, q1, app, valids,
                    prefix=f"T={T} " + (f"L={L} l={l} " if big else ""))
        if big:  # writes at a device n_past into the last layer, read back
            at = T - 40
            pos = torch.tensor([at], dtype=torch.int32, device="cuda")
            new = torch.randn(2, 1, 1, KV, D, generator=gen, device="cuda").to(bf16)
            new16 = torch.randn(L, 2, 1, 16, KV, D, generator=gen, device="cuda").to(bf16)
            kvcache.write_layer(kv, new, l, pos)
            kvcache.write_layer(kv8, new, l, pos)
            q8, s8 = kvcache.quantize_new(new)
            one = (torch.equal(kv[l, :, :, at:at + 1], new)
                   and torch.equal(codes[l, :, :, at:at + 1], q8)
                   and torch.equal(scales[l, :, :, at:at + 1], s8))
            kvcache.write_all_layers(kv, new16, pos - 16)
            kvcache.write_all_layers(kv8, new16, pos - 16)
            q16, s16 = kvcache.quantize_new(new16)
            every = (torch.equal(kv[:, :, :, at - 16:at], new16)
                     and torch.equal(codes[:, :, :, at - 16:at], q16)
                     and torch.equal(scales[:, :, :, at - 16:at], s16))
            log(f"  kvcache writes at position {at} of layer {l} of a {L}-layer cache of"
                f" {kv.numel() / 2**30:.2f} Gi elements (bf16 and int8), read back:"
                f" one row {'equal' if one else 'DIFFERENT'}, a 16-position chunk of every"
                f" layer {'equal' if every else 'DIFFERENT'}")
            if not (one and every):
                raise RuntimeError("cache writes past 2^31 elements read back other values")
        del kv, codes, scales, deq, kv8
        torch.cuda.empty_cache()


def decode_rates(torch, engines: dict, tokens: list, n: int = 16) -> dict:
    """tok/s of n-token greedy decode chunks (graph replays) at n_past =
    len(tokens), each engine twice, in turns (a, b, b, a); every chunk is
    rolled back."""
    from ggllm_tpu_torch.ops.sampling import SamplerParams

    greedy = SamplerParams(temp=0.0)
    for eng in engines.values():
        eng.reset()
        eng.eval(tokens[:-1])
        eng.decode_chunk(tokens[-1], n, greedy)  # warm-up: captures the chunk's graph
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


def graph_vs_eager(torch, eng, start: int, first: int, hist: list, label: str, gemv: str,
                   other_gemv: str, decode_counters: set, greedy_ref=None, n_greedy: int = 64,
                   n_sampled: int = 32) -> dict:
    """The replayed decode graphs against the eager step body from one state
    (n_past `start`, `first` sampled and not yet forwarded, `hist` the
    history ending with it), on the same engine, in chained 16-step chunks:
    n_greedy greedy ids (the graphs' are greedy_ref where it holds that many,
    the ids the main path's pipelined graphs decoded from this state, else
    they run here and must begin with greedy_ref) and
    n_sampled ids at temp 0.8, top-k 40, top-p 0.95, repeat penalty 1.1,
    seed 1234 must be identical. Then one greedy graph chunk from the state:
    the counts credited to its replay must be its capture's record, the
    eager greedy run's counts per chunk, 16 launches of the format's GEMV
    for each quantized weight, 16 of each of the head layout's decode
    counters for each layer, and none of another GEMV or decode kernel.
    Returns the eager tok/s (host clock, ending with the ids on the host),
    the graphs' where they ran here, and the graph's device ms a token (CUDA
    events around back-to-back replays)."""
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.ops.linear import QuantTensor
    from ggllm_tpu_torch.ops.sampling import SamplerParams
    from ggllm_tpu_torch.tools.time_kernels import chained_decode, replay_device_ms

    greedy = SamplerParams(temp=0.0)
    sampler = SamplerParams(temp=0.8, top_k=40, top_p=0.95, repeat_penalty=1.1, seed=1234)

    def chained(eager: bool, sp, n: int):
        return chained_decode(eng, start, first, hist, n, sp, eager)

    g_sampled, _ = chained(False, sampler, n_sampled)
    e_sampled, _ = chained(True, sampler, n_sampled)
    if g_sampled != e_sampled:
        raise RuntimeError(f"sampled ids of the graph and the eager body differ on the {label}"
                           f" path:\n{g_sampled}\n{e_sampled}")
    ref = [] if greedy_ref is None else [int(t) for t in greedy_ref[:n_greedy]]
    g_ids, g_tps = (ref, None) if len(ref) == n_greedy else chained(False, greedy, n_greedy)
    build.launch_counts.clear()
    e_ids, e_tps = chained(True, greedy, n_greedy)
    eager_counts = dict(build.launch_counts)
    if g_ids != e_ids or g_ids[:len(ref)] != ref:
        raise RuntimeError(f"greedy ids of the graph and the eager body differ on the {label}"
                           f" path:\n{g_ids}\n{e_ids}")
    build.launch_counts.clear()
    one, _ = chained(False, greedy, 16)
    credited = dict(build.launch_counts)
    n_quant = sum(isinstance(m, QuantTensor) for m in eng.model.modules())
    want = {gemv: 16 * n_quant, **{k: 16 * eng.hp.n_layer for k in decode_counters}}
    if (credited != eng.chunk_graph(16, greedy).counts
            or any(credited.get(k) != n for k, n in want.items())
            or credited.get(other_gemv, 0)
            or any(credited.get(k, 0) for k in DECODE_COUNTERS if k not in decode_counters)
            or {k: n * (n_greedy // 16) for k, n in credited.items()} != eager_counts
            or one != g_ids[:16]):
        raise RuntimeError(f"launch counts under one replay on the {label} path: {credited},"
                           f" the capture's record: {eng.chunk_graph(16, greedy).counts}, the"
                           f" eager {n_greedy} tokens': {eager_counts}, expected {want}")
    device_ms = replay_device_ms(eng, 16, greedy, 2)
    eng.rollback(start)
    return {"graph_tok_s": g_tps, "eager_tok_s": e_tps, "graph_device_ms_per_token": device_ms,
            "credited": credited, "greedy_ids_equal": n_greedy, "sampled_ids_equal": n_sampled}


def _logits_held(got, ref, what: str, label: str) -> dict:
    """Kernel logits `got` against the plain versions' `ref`, one row or one
    a position. The weights are random, so the two best tokens of a row may
    lie closer than the two paths' logits do: the argmax must be equal
    wherever the plain version decides by more than twice the measured
    difference (and, over several rows, decide at least one), and max |d|
    lie within LOGIT_TOL of max |ref|."""
    import numpy as np

    got, ref = np.atleast_2d(got), np.atleast_2d(ref)
    if not (np.isfinite(got).all() and np.isfinite(ref).all()):
        raise RuntimeError(f"{what} are not finite on the {label} path")
    err = float(np.abs(got - ref).max())
    rel = err / float(np.abs(ref).max())
    top2 = np.partition(ref, -2, axis=1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2 * err
    same = got.argmax(axis=1) == ref.argmax(axis=1)
    log(f"  {what}, kernels vs plain versions: max |d| {err:.4e} ({rel:.3e} of max|ref|); same"
        f" argmax at {int(same.sum())} of {same.size}, at all {int((same & decided).sum())} of"
        f" {int(decided.sum())} that the plain version decides by more than 2 max |d|; last"
        f" {int(got[-1].argmax())} vs {int(ref[-1].argmax())}")
    if rel > LOGIT_TOL or not same[decided].all() or (same.size > 1 and not decided.any()):
        raise RuntimeError(f"kernel and plain {what} disagree on the {label} path")
    return {"rel": rel, "same": int(same.sum()), "decided": int(decided.sum())}


def _drive(torch, eng, prompt: list, label: str, fmt: str, n_check: int = 64) -> dict:
    """One stream on `eng` through its entry points: a warm-up (it captures
    the greedy chunk's graph), generate(prompt, 129) greedy (the prefill in
    n_batch chunks, then 128 ids through the pipelined decode graphs; tok/s
    from the engine's Timings, capture apart) and 32 ids sampled on from
    there at temp 0.8, top-k 40, top-p 0.95, repeat penalty 1.1; then
    graph_vs_eager from the prefill's state over the first n_check greedy
    ids (idle share = 1 - device ms a token x pipelined tok/s). Fails if a
    kernel of the path (the tensor-core tile, `fmt`'s GEMV, the prefill
    attention kernel and the decode kernel for this head layout and cache)
    did not run, if another variant did (the other GEMV family, the rows
    kernel, an f32 kernel beside the cache's, another decode kernel), or if
    an id lies outside the vocabulary. Returns the figures, the greedy ids
    and the launches of the timed run."""
    import numpy as np

    from ggllm_tpu_torch.core.dtypes import GGMLType
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.kernels import quant_matmul as qm
    from ggllm_tpu_torch.ops.sampling import SamplerParams

    hp, kv_dtype = eng.hp, eng.cfg.kv_dtype
    eng.generate(prompt[:8], 4, SamplerParams(temp=0.0), stop_ids=set())  # warm-up
    eng.reset()
    warm_capture_us = eng.timings.t_compile_us  # the greedy chunk's graph
    eng.timings = type(eng.timings)()
    torch.cuda.synchronize()

    build.launch_counts.clear()
    greedy = eng.generate(prompt, 129, SamplerParams(temp=0.0), stop_ids=set())
    tm = eng.timings
    n_prefill, n_decode = tm.n_prefill, tm.n_decode
    prefill_tps = n_prefill / (tm.t_prefill_us / 1e6)
    decode_tps = n_decode / (tm.t_decode_us / 1e6)  # pipelined graph replays, capture apart
    sampler = SamplerParams(temp=0.8, top_k=40, top_p=0.95, repeat_penalty=1.1, seed=1234)
    t_dec = tm.t_decode_us
    sampled, _ = eng.decode_pipelined(greedy[-1], 32, 16, sampler, last_tokens=prompt + greedy)
    sampled_tps = 32 / ((tm.t_decode_us - t_dec) / 1e6)
    counts = dict(build.launch_counts)
    capture_ms = (warm_capture_us + tm.t_compile_us) / 1e3
    mha = hp.n_head_kv == hp.n_head
    # the wrapper's counter for this head layout and cache, and the route's:
    # an f32 cache casts q to f32, which the f32 decode kernel takes
    base = "flash_decode" + (".mha" if mha else "") + (".int8" if kv_dtype == "int8" else "")
    decode_counters = {base, base if mha else "flash_decode.f32" if kv_dtype == "float32"
                       else "flash_decode_tc" + (".int8" if kv_dtype == "int8" else "")}
    gemv, other_gemv = (("quant_matmul.gemv.kq", "quant_matmul.gemv") if GGMLType[fmt.upper()]
                        in qm.K_QUANTS else ("quant_matmul.gemv", "quant_matmul.gemv.kq"))
    graph = graph_vs_eager(torch, eng, len(prompt), greedy[0], prompt + greedy[:1], label,
                           gemv, other_gemv, decode_counters, greedy_ref=greedy[1:],
                           n_greedy=n_check)
    graph["idle_share"] = 1.0 - graph["graph_device_ms_per_token"] * decode_tps / 1e3
    graph["capture_ms"] = capture_ms
    log(f"  prefill {n_prefill} tokens: {prefill_tps:.1f} tok/s; greedy decode {n_decode} tokens:"
        f" {decode_tps:.2f} tok/s (pipelined graphs); sampled decode 32 tokens:"
        f" {sampled_tps:.2f} tok/s ({smi('name,power.limit')})")
    log(f"  decode graph vs eager step body from n_past {len(prompt)}: {n_check} greedy and 32"
        f" sampled ids identical; eager {graph['eager_tok_s']:.2f} tok/s ({n_check // 16} chained"
        f" 16-token chunks); device {graph['graph_device_ms_per_token']:.4f} ms a token, idle"
        f" share {graph['idle_share']:.3f} of the pipelined run's {1e3 / decode_tps:.4f} ms;"
        f" capture {capture_ms:.1f} ms (2 graphs); one replay credited: {graph['credited']}")
    log(f"  launches on the {label} path: {counts}")
    # prefill: the tensor-core tile and attention kernel (on an f32 cache q
    # takes the cache's dtype: the f32 attention kernel); decode: the format's
    # GEMV (and not the other) and this head layout's and cache's decode kernel
    attn = "flash_mqa.f32" if kv_dtype == "float32" else "flash_mqa.tc"
    for name in ("quant_matmul", f"quant_matmul.{fmt}", "quant_matmul.tc", gemv,
                 "flash_mqa", attn, *decode_counters):
        if counts.get(name, 0) <= 0:
            raise RuntimeError(f"kernel {name} was not launched on the {label} path")
    if (any(counts.get(k, 0) for k in DECODE_COUNTERS if k not in decode_counters)
            or counts.get(other_gemv, 0)
            or len({counts[k] for k in decode_counters}) != 1
            or any(counts.get(k, 0) for k in F32_KERNELS if k != attn)
            or counts["quant_matmul"] != counts[f"quant_matmul.{fmt}"]
            or counts["quant_matmul"] != counts["quant_matmul.tc"] + counts[gemv]
            or counts["flash_mqa"] != counts[attn]):
        raise RuntimeError(f"a kernel variant of another path ran on the {label} path: {counts}")
    toks = np.asarray(greedy + [int(t) for t in sampled])
    if len(greedy) != 129 or len(sampled) != 32 or toks.min() < 0 or toks.max() >= hp.n_vocab:
        raise RuntimeError(f"bad generated ids: {len(greedy)} greedy, {len(sampled)} sampled")
    return {"launches": counts, "prefill_tok_s": prefill_tps, "decode_tok_s": decode_tps,
            "sampled_tok_s": sampled_tps, "graph": graph, "greedy": greedy, "gemv": gemv,
            "other_gemv": other_gemv}


def phase_export(torch, eng, label: str) -> dict:
    """FalconEngine.export on a full-width engine at S = 300 (prefill: the
    tile, flash_mqa, on the f32 route group_sums) and S = 1 (decode: the
    GEMV, flash_decode), each program run once from the cache state the
    engine's eager forward of the same call starts from (an empty cache,
    then the 300-token prompt's). Fails unless the program's text names the
    ops (quant_matmul, and flash_mqa or flash_decode once a layer), its
    logits lie within LOGIT_TOL of max |eager| with the same greedy id, and
    build.launch_counts moved by the program run equal the eager forward's
    by name and count: the graph runs the hand kernels. Logs the export
    seconds, the text's size and both runs' ms."""
    import numpy as np

    from ggllm_tpu_torch.kernels import build

    def leaves(kv):
        return kv if isinstance(kv, tuple) else (kv,)

    prompt = [int(t) for t in np.random.default_rng(3).integers(12, eng.hp.n_vocab, 300)]
    n_layer, out = eng.hp.n_layer, {"path": f"export: {label}", "launches": {}}
    for S in (300, 1):
        t0 = time.perf_counter()
        ep = eng.export(S)
        export_s = time.perf_counter() - t0
        text = str(ep)
        ops = {op: text.count(f"torch.ops.ggllm.{op}.default(")
               for op in ("quant_matmul", "flash_mqa", "flash_decode", "group_sums")}
        attn = "flash_mqa" if S > 1 else "flash_decode"
        if ops[attn] != n_layer or ops["quant_matmul"] <= n_layer:
            raise RuntimeError(f"the S = {S} program of the {label} path names {ops}")
        program = ep.module()
        eng.reset()
        if S == 1:
            eng.eval(prompt)
        n_past, start = eng.n_past, [t.clone() for t in leaves(eng.kv)]
        tok = prompt if S > 1 else [int(np.random.default_rng(4).integers(12, eng.hp.n_vocab))]
        build.launch_counts.clear()
        t0 = time.perf_counter()
        want = eng.eval(tok)
        eager_ms = (time.perf_counter() - t0) * 1e3
        eager = dict(build.launch_counts)
        for dst, src in zip(leaves(eng.kv), start):
            dst.copy_(src)
        tokens = torch.tensor([tok], dtype=torch.long, device=eng.device)
        past = torch.tensor([n_past], dtype=torch.int32, device=eng.device)
        build.launch_counts.clear()
        t0 = time.perf_counter()
        got = program(tokens, eng.kv, past)[0, 0].float().cpu().numpy()
        program_ms = (time.perf_counter() - t0) * 1e3
        ran = dict(build.launch_counts)
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        log(f"  export {label} S={S}: {export_s:.2f} s, {len(text)} characters, nodes {ops};"
            f" program vs eager forward at n_past {n_past}: {rel:.3e} of max|eager|, id"
            f" {int(got.argmax())} vs {int(want.argmax())}; {program_ms:.1f} ms vs eager"
            f" {eager_ms:.1f} ms (first run of the program); launches {ran}")
        if not np.isfinite(got).all() or rel > LOGIT_TOL or got.argmax() != want.argmax():
            raise RuntimeError(f"the exported S = {S} program and the eager forward disagree on"
                               f" the {label} path")
        if ran != eager:
            raise RuntimeError(f"the exported S = {S} program of the {label} path launched {ran},"
                               f" the eager forward {eager}")
        out[f"S={S}"] = {"export_s": export_s, "text_chars": len(text), "nodes": ops,
                         "logit_rel_err": rel, "program_ms": program_ms, "eager_ms": eager_ms}
        _add_launches(out["launches"], ran)
    eng.reset()
    return out


def phase_model(torch, model: str, fmt: str, kv_dtype: str = "bfloat16",
                peak_below: int | None = None, long_past: int | None = None,
                host_route_tokens: int = 0, then=None) -> dict:
    """One full-width model (`model` is "falcon7b", "falcon40b" or "llama7b")
    with random `fmt` weights and a `kv_dtype` cache through the engine's
    entry points (_drive: a 300-token prompt, 129 greedy and 32 sampled
    ids); returns its launch counts and end-to-end figures. Fails as _drive
    does, if peak memory reaches `peak_below`, or if the prefill's logits at
    every position or one decode step's disagree with the plain versions'
    (_logits_held). An int8 path also compares decode rates with a bf16
    cache at n_past 400 and, if given, at `long_past`; host_route_tokens > 0
    times that many tokens sampled at top_k 0 (the whole vocabulary: the
    host cascade, one forward and one draw a token). then(eng, params, hp,
    max |logit| of the plain prefill), if given, runs further paths on the
    engine before it is freed; the paths it returns come back under
    "then"."""
    import gc

    import numpy as np

    from ggllm_tpu_torch.core.config import EngineConfig
    from ggllm_tpu_torch.core.dtypes import GGMLType
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.ops.sampling import SamplerParams
    from ggllm_tpu_torch.utils.benchgen import bench_hparams, make_bench_params

    hp = bench_hparams(model)
    label = f"{hp.n_layer}-layer {model} {fmt} {kv_dtype}-cache"
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
    run = _drive(torch, eng, prompt, label, fmt)
    greedy, gemv, other_gemv = run["greedy"], run["gemv"], run["other_gemv"]
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
    log(f"  peak device memory {peak / 2**30:.2f} GiB ({smi('name,power.limit')})")
    if peak_below is not None and peak >= peak_below:
        raise RuntimeError(f"peak memory {peak} on the {label} path is not below {peak_below}")

    # logits of every prompt position, then one decode step (S = 1: the GEMV
    # and the decode attention kernel) on both engines, the same token at
    # n_past 300 of their own caches
    eng.reset()
    got = eng.eval(prompt, logits_all=True)
    plain = FalconEngine(hp, params, EngineConfig(kernel_layout=False, flash_attention=False,
                                                  kv_dtype=kv_dtype))
    ref = plain.eval(prompt, logits_all=True)
    held = _logits_held(got, ref, f"prefill logits at {len(prompt)} positions", label)
    tok = int(ref[-1].argmax())
    build.launch_counts.clear()
    got_d = eng.eval([tok])
    step_counts = dict(build.launch_counts)
    held_d = _logits_held(got_d, plain.eval([tok]), f"decode-step logits at n_past {len(prompt)}",
                          label)
    peak_plain = torch.cuda.max_memory_allocated()  # with the plain engine's dequantized weights
    log(f"  decode-step launches {step_counts}; peak device memory with the plain comparison"
        f" {peak_plain / 2**30:.2f} GiB")
    if step_counts.get(gemv, 0) <= 0 or step_counts.get(other_gemv, 0):
        raise RuntimeError(f"the decode step on the {label} path did not run {gemv} alone:"
                           f" {step_counts}")
    out = {"path": label, "launches": run["launches"], "prefill_tok_s": run["prefill_tok_s"],
           "decode_tok_s": run["decode_tok_s"], "sampled_tok_s": run["sampled_tok_s"],
           "peak_bytes": peak, "graph": run["graph"],
           "logit_rel_err": held["rel"], "argmax_same": held["same"],
           "argmax_decided": held["decided"], "decode_logit_rel_err": held_d["rel"],
           "decode_argmax_same": bool(held_d["same"]),
           "decode_argmax_decided": bool(held_d["decided"]),
           "host_route": host_route, "peak_with_plain_bytes": peak_plain}
    del plain
    if kv_dtype == "int8":  # what the int8 cache costs or saves against bf16, same weights
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
    if then is not None:
        out["then"] = then(eng, params, hp, float(np.abs(ref).max()))
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_long_context(torch, eng, params, hp) -> dict:
    """Long context on the Falcon-7B Q4_0 weights (full width and depth) at
    EngineConfig(n_ctx=16384, n_batch=2048): dynamic NTK RoPE at alpha =
    15 ** (64 / 62), a cache of LONG_T = 18432 positions. On an int8 cache
    and on a bf16 cache with the same weights, one stream through _drive: a
    12288-token prompt drawn from a seed prefilled in 2048-row chunks, 128
    greedy ids from n_past 12288 through the pipelined decode graphs, which
    the eager step body must give too (graph_vs_eager over all 128), and 32
    sampled ids. Besides _drive's checks, each prefill must launch one
    flash_mqa.tc a layer and chunk and the tile for every other weight. The
    int8 prefill's last-position logits are held against the plain engine's
    (kernel_layout=False, flash_attention=False) by _logits_held. Then decode
    at n_past 300 on the bf16 n_ctx 16384 engine beside `eng` (n_ctx 2048)
    in turns, a measurement whose launches are not the path's, and one
    context swap through engine/generator.py on the int8 engine: a
    16200-token prompt, n_keep 64, 250 greedy ids, whose ids after the swap
    must equal those of a fresh engine fed the swapped context. The peak
    device memory is the phase's, the plain engine included."""
    import gc

    import numpy as np

    from ggllm_tpu_torch.core.config import EngineConfig
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.engine.generator import Generator
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.ops.linear import QuantTensor
    from ggllm_tpu_torch.ops.sampling import SamplerParams

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    greedy = SamplerParams(temp=0.0)
    n_prompt = 12288
    n_chunks = -(-n_prompt // LONG_BATCH)
    n_quant = sum(isinstance(m, QuantTensor) for m in eng.model.modules())
    rng = np.random.default_rng(LONG_CTX)
    prompt = [int(t) for t in rng.integers(12, hp.n_vocab, n_prompt)]
    total: dict = {}
    out = {"path": f"{hp.n_layer}-layer falcon7b q4_0 n_ctx {LONG_CTX} n_batch {LONG_BATCH}",
           "launches": total}

    def config(**kw):
        return EngineConfig(n_ctx=LONG_CTX, n_batch=LONG_BATCH, **kw)

    def run(kv_dtype):
        label = f"long-context {kv_dtype}-cache"
        e = FalconEngine(hp, params, config(kv_dtype=kv_dtype))
        res = _drive(torch, e, prompt, label, "q4_0", n_check=128)
        counts = res.pop("launches")
        if (counts["flash_mqa.tc"] != n_chunks * hp.n_layer
                or counts["quant_matmul.tc"] < n_chunks * (n_quant - 1)):
            raise RuntimeError(f"{label}: not one flash_mqa.tc a layer and chunk, or not the"
                               f" tile for every weight but the head: {counts}")
        _add_launches(total, counts)
        _add_launches(total, res["graph"]["credited"])
        return e, {k: res[k] for k in ("prefill_tok_s", "decode_tok_s", "sampled_tok_s", "graph")}

    t0 = time.perf_counter()
    e8, out["int8"] = run("int8")
    e8.reset()
    logits = e8.eval(prompt)
    plain = FalconEngine(hp, params, config(kv_dtype="int8", kernel_layout=False,
                                            flash_attention=False))
    held = _logits_held(logits, plain.eval(prompt), "int8 prefill's last-position logits",
                        "long-context int8-cache")
    peak = torch.cuda.max_memory_allocated()
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    out.update(logit_rel_err=held["rel"], argmax_same=bool(held["same"]),
               argmax_decided=bool(held["decided"]), peak_with_plain_bytes=peak)
    log(f"  peak device memory of the phase, the plain engine included, {peak / 2**30:.2f} GiB")

    e16, out["bfloat16"] = run("bfloat16")
    # decode at a short prefix: the plan made for T = 18432 against T = 2560
    tokens = [int(t) for t in rng.integers(12, hp.n_vocab, 301)]
    out["decode_tok_s_at_300"] = decode_rates(torch, {f"n_ctx {LONG_CTX}": e16,
                                                      "n_ctx 2048": eng}, tokens)
    log(f"  16-token greedy chunks at n_past 300, bf16 caches, tok/s in turns:"
        f" {out['decode_tok_s_at_300']}")
    del e16
    gc.collect()

    # one context swap (falcon_main's n_keep + half the context) on the int8 engine
    e8.reset()
    swap_prompt = [int(t) for t in rng.integers(12, hp.n_vocab, 16200)]
    gen = Generator(e8, greedy, eos_id=-1, n_keep=64)
    build.launch_counts.clear()
    t1 = time.perf_counter()
    gen.generate(gen.prefill(swap_prompt), 250, lambda t: True)
    swap_s = time.perf_counter() - t1
    counts = dict(build.launch_counts)
    _add_launches(total, counts)
    if not gen.swapped or len(gen.all_tokens) != len(swap_prompt) + 250:
        raise RuntimeError(f"no context swap: {len(gen.all_tokens)} tokens, n_past {e8.n_past}")
    hist = gen.all_tokens[:LONG_CTX]  # in the cache when the swap came
    ctx = hist[:64] + hist[-((LONG_CTX - 64) // 2):]
    nxt, rest = gen.all_tokens[LONG_CTX], gen.all_tokens[LONG_CTX + 1:]
    del e8
    gc.collect()
    fresh = FalconEngine(hp, params, config(kv_dtype="int8"))
    fresh.eval(ctx)
    again, _ = fresh.decode_pipelined(nxt, len(rest), 16, greedy,
                                      last_tokens=gen.all_tokens[LONG_CTX - 63:LONG_CTX + 1])
    again = [int(t) for t in again]
    out["swap"] = {"prompt": len(swap_prompt), "n_keep": 64, "kept": len(ctx),
                   "ids_after_swap": len(rest), "seconds": swap_s, "equal": again == rest}
    log(f"  context swap: a {len(swap_prompt)}-token prompt and 250 greedy ids crossed n_ctx"
        f" {LONG_CTX} in {swap_s:.1f} s; {len(ctx)} tokens kept (n_keep 64); the {len(rest)} ids"
        f" after the swap {'equal' if again == rest else 'DIFFER FROM'} a fresh engine's fed the"
        f" swapped context; launches {counts}")
    if again != rest:
        raise RuntimeError(f"ids after the context swap differ from a fresh engine's:\n{rest}\n"
                           f"{again}")
    del fresh
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  launches on the long-context path: {total}; (long context took"
        f" {time.perf_counter() - t0:.1f} s)")
    return out


def phase_f32_path(torch, model: str = "falcon7b", fmt: str = "q4_0", n_layer: int = 2,
                   graphs: bool = True, export: bool = False) -> dict:
    """The f32 route at full width and `n_layer` layers
    (tools/time_kernels.py f32_path): float32 compute and cache, a 300-token
    prefill (tok/s printed) through the f32 tensor-core tile, group_sums and
    the f32 attention kernel, then 16 greedy tokens through the legacy GEMV
    and the head layout's f32 decode kernel (flash_decode_f32.cu for grouped
    heads, the G == 1 kernel for LLaMA); with `graphs`, the decode graphs
    against the eager step body. Fails unless all of them ran, no bf16
    tensor-core kernel did, and the prefill logits of all positions agree
    with the plain versions to F32_LOGIT_TOL of max |logit|. With `export`,
    phase_export on the engine (its graphs name ggllm.group_sums and the f32
    tile's quant_matmul), returned under "then"."""
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.tools.time_kernels import f32_path

    label = f"{n_layer}-layer {model} {fmt} float32"

    def decode(eng, prompt, logits) -> dict:
        hp = eng.hp
        first = int(logits[-1].argmax())
        decoded, _ = eng.decode_chunk(first, 16)
        counts = dict(build.launch_counts)  # the prefill's and the decode's
        log(f"  launches on the {label} path: {counts}")
        if len(decoded) != 16 or not 0 <= int(decoded.min()) <= int(decoded.max()) < hp.n_vocab:
            raise RuntimeError(f"bad decoded ids on the {label} path: {decoded}")
        # the wrapper's counter and the route's (G == 1: the wrapper counts
        # under the route's name)
        decode_counters = ({"flash_decode.mha"} if hp.n_head_kv == hp.n_head
                           else {"flash_decode", "flash_decode.f32"})
        for name in ("quant_matmul.f32", f"quant_matmul.{fmt}", "group_sums", "flash_mqa.f32",
                     "quant_matmul.gemv", *decode_counters):
            if counts.get(name, 0) <= 0:
                raise RuntimeError(f"kernel {name} was not launched on the {label} path")
        if any(counts.get(k, 0) for k in BF16_TC_KERNELS):
            raise RuntimeError(f"a bf16 kernel ran on the {label} path: {counts}")
        graph = None
        if graphs:
            graph = graph_vs_eager(torch, eng, len(prompt), first, prompt + [first], label,
                                   "quant_matmul.gemv", "quant_matmul.gemv.kq", decode_counters,
                                   greedy_ref=decoded)
            log(f"  decode graph vs eager step body: 64 greedy and 32 sampled ids identical;"
                f" graph {graph['graph_tok_s']:.2f} tok/s, eager {graph['eager_tok_s']:.2f} tok/s"
                f" (4 chained 16-token chunks each); device"
                f" {graph['graph_device_ms_per_token']:.4f} ms a token; capture"
                f" {eng.timings.t_compile_us / 1e3:.1f} ms; one replay credited:"
                f" {graph['credited']}")
        then = [phase_export(torch, eng, label)] if export else []
        if then and then[0]["S=300"]["nodes"]["group_sums"] <= 0:
            raise RuntimeError(f"the S = 300 program of the {label} path names no group_sums")
        return {"launches": counts, "graph": graph, "then": then}

    r = f32_path(model, fmt, n_layer, after=decode)
    if not r["finite"]:
        raise RuntimeError("f32 prefill logits are not finite")
    log(f"  prefill 300 tokens: {r['prefill_tok_s']:.1f} tok/s; logits at all positions, kernels"
        f" vs plain versions: {r['logit_rel_err']:.3e} of max|ref|; same argmax at"
        f" {r['argmax_same']} positions")
    if r["logit_rel_err"] > F32_LOGIT_TOL:
        raise RuntimeError(f"f32 kernel and plain prefill logits disagree on the {label} path")
    return {"path": label, "launches": r["after"]["launches"],
            "prefill_tok_s": r["prefill_tok_s"], "logit_rel_err": r["logit_rel_err"],
            "argmax_same": r["argmax_same"], "graph": r["after"]["graph"],
            **({"then": r["after"]["then"]} if export else {})}


def _batch_run(torch, eng, prompts, specs, eager: bool, chunk: int = 16):
    """Requests (prompt, Request keywords) through a ContinuousBatcher on
    `eng` (seed 1234, prefill_chunk 256) to the end; returns the requests,
    the launch counts of the run (set to 0 just before it) and its wall s."""
    from ggllm_tpu_torch.engine.batching import ContinuousBatcher, Request
    from ggllm_tpu_torch.kernels import build

    torch.cuda.synchronize()
    build.launch_counts.clear()
    t0 = time.perf_counter()
    cb = ContinuousBatcher(eng, chunk=chunk, seed=1234, prefill_chunk=256, eager=eager)
    reqs = [cb.submit(Request(p, **kw)) for p, kw in zip(prompts, specs)]
    cb.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad = [r.rid for r in reqs if r.error is not None or len(r.out) != r.n_predict]
    if bad:
        raise RuntimeError(f"batched requests {bad} failed or ended early")
    return reqs, dict(build.launch_counts), wall


def _teacher_forced(eng1, prompt, ids: list, rel_tol: float) -> dict:
    """`ids` held to the batch-1 engine's logits with those ids forced: the
    single stream evaluates prompt + ids[:-1] from an empty cache, and at
    every step t the id's logit must lie within rel_tol of max |logit| of
    that step's top logit (an id equal to the argmax meets it at 0).
    Returns the largest deficit as a share of its tolerance (`worst`, >= 1
    fails), the steps whose id is not the argmax, and the median top-2 gap
    with the steps whose top-2 gap is below the tolerance (where the check
    cannot tell the top two apart)."""
    import numpy as np

    eng1.reset()
    lg = eng1.eval(prompt + ids[:-1], logits_all=True)[-len(ids):]
    rows = np.arange(len(ids))
    top2 = np.sort(lg, axis=1)[:, -2:]
    tol = rel_tol * np.abs(lg).max(axis=1)
    deficit = top2[:, 1] - lg[rows, ids]
    gap = top2[:, 1] - top2[:, 0]
    return {"worst": float((deficit / tol).max()), "worst_step": int((deficit / tol).argmax()),
            "not_argmax": [int(t) for t in np.flatnonzero(deficit > 0)],
            "median_top2_gap": float(np.median(gap)), "median_tol": float(np.median(tol)),
            "steps_below_tol": int((gap < tol).sum()), "steps": len(ids),
            "deficit": deficit, "gap": gap, "tol": tol}


def _against_single(eng1, prompt, batched: list, label: str, rel_tol: float) -> dict:
    """A greedy request's batched ids against the batch-1 engine on the same
    weights. Its free-running greedy ids (one stream on the GEMV) are
    compared for the step where the two part, printed with the single
    stream's top-2 logit gap there and the batched id's deficit; then every
    batched id is held to the single stream's logits with the batched ids
    forced (`_teacher_forced`): each must be within rel_tol of max |logit|
    of its step's top logit (B rows take the rows kernel, one stream the
    GEMV: the two sum in other orders, so ids may part at a near-tie, and
    past it the batched ids are still checked, against their own history)."""
    from ggllm_tpu_torch.ops.sampling import SamplerParams

    eng1.reset()
    ref = eng1.generate(prompt, len(batched), SamplerParams(temp=0.0, repeat_penalty=1.0),
                        stop_ids=set())
    tf = _teacher_forced(eng1, prompt, batched, rel_tol)
    out = {k: v for k, v in tf.items() if k not in ("deficit", "gap", "tol")}
    out["equal"] = ref == batched
    if not out["equal"]:
        t = next(i for i, (a, b) in enumerate(zip(ref, batched)) if a != b)
        out.update(step=t, gap=float(tf["gap"][t]), deficit_at_step=float(tf["deficit"][t]),
                   tol_at_step=float(tf["tol"][t]))
        log(f"  {label}: batched and single-stream ids part at step {t} ({batched[t]} vs"
            f" {ref[t]}); the single stream's top-2 logit gap there {out['gap']:.4e}, the"
            f" batched id {out['deficit_at_step']:.4e} below the top, tolerance"
            f" {out['tol_at_step']:.4e}")
    log(f"  {label}, every batched id against the single stream's logits with the batched"
        f" ids forced: worst deficit {out['worst']:.3f} of its tolerance (step"
        f" {out['worst_step']}); not the argmax at steps {out['not_argmax']}; median top-2"
        f" gap {out['median_top2_gap']:.4e} (median tolerance {out['median_tol']:.4e},"
        f" {out['steps_below_tol']} of {out['steps']} steps' gaps below it)")
    if out["worst"] >= 1.0:
        raise RuntimeError(f"{label}: batched id at step {out['worst_step']} lies"
                           f" {out['worst']:.3f} tolerances below the single stream's top"
                           f" logit: no near-tie")
    return out


def phase_batching(torch, eng1, params, hp) -> dict:
    """Continuous batching at full width and depth: 8 requests (prompts of
    5-300 tokens from a seed, 64 tokens each; 4 greedy, 4 sampled at temp
    0.8, top-k 40, top-p 0.95, repeat penalty 1.1, one with mirostat 2, one
    with penalize_nl False) through a ContinuousBatcher over
    FalconEngine(batch_size=4) (chunk 16, prefill_chunk 256) on the bf16
    cache, with the decode chunks as replayed B-row CUDA graphs and again
    through the eager B-row step body: every request's ids must be the
    same. Each greedy request's ids against the batch-1 engine `eng1` on the
    same weights: every id within ROWS_LOGIT_TOL of its step's top logit
    with the batched ids forced (`_against_single`), and a control that must fail (a
    request's ids on another's prompt); the same at 2 layers on the f32
    route (F32_LOGIT_TOL). Prints aggregate and per-row decode tok/s
    beside the single stream's, admission (prefill) time, the device ms of
    one B-row step at B = 1, 2, 4, 8, 16 (CUDA events around replays, engines
    sharing `params`), capture ms and peak memory. Fails unless the graph
    run launched the rows kernel, flash_mqa.tc and the decode kernel (the
    tile in admission) and no GEMV, and unless each B-row graph's capture
    record holds one rows-kernel launch for each quantized weight a step and
    no tile or GEMV."""
    import dataclasses

    import numpy as np

    from ggllm_tpu_torch.core.config import EngineConfig
    from ggllm_tpu_torch.core.dtypes import GGMLType
    from ggllm_tpu_torch.engine.engine import FalconEngine, _RowChunk
    from ggllm_tpu_torch.ops.linear import QuantTensor
    from ggllm_tpu_torch.ops.sampling_device import RowKey
    from ggllm_tpu_torch.utils.benchgen import make_bench_params

    B, n_predict = 4, 64
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(12, hp.n_vocab, n)]
               for n in (5, 300, 37, 120, 250, 16, 80, 199)]
    sampled = dict(temp=0.8, top_k=40, top_p=0.95, repeat_penalty=1.1)
    specs = [dict(), sampled, dict(), {**sampled, "mirostat": 2}, dict(),
             {**sampled, "penalize_nl": False}, dict(), sampled]
    specs = [{"n_predict": n_predict, **kw} for kw in specs]
    greedy = [i for i, kw in enumerate(specs) if "temp" not in kw]

    eng = FalconEngine(hp, params, EngineConfig(), batch_size=B)
    reqs, counts, wall = _batch_run(torch, eng, prompts, specs, eager=False)
    tm = eng.timings
    consumed = sum(len(r.out) - 1 for r in reqs)  # the first ids come from prefill
    agg = consumed / (tm.t_decode_us / 1e6)
    capture_ms = tm.t_compile_us / 1e3
    prefill_ms, prefill_tokens = tm.t_prefill_us / 1e3, tm.n_prefill
    log(f"  batcher, 8 requests through {B} rows, graphs: {wall:.2f} s; decode {consumed} tokens"
        f" at {agg:.2f} tok/s aggregate, {agg / B:.2f} tok/s a row; prefill (admission)"
        f" {prefill_tokens} tokens in {prefill_ms:.1f} ms"
        f" ({prefill_tokens / (prefill_ms / 1e3):.1f} tok/s, forwarding all {B} rows);"
        f" capture {capture_ms:.1f} ms")
    for name in ("quant_matmul.rows", "quant_matmul.tc", "flash_mqa.tc", "flash_decode_tc",
                 "flash_decode"):
        if counts.get(name, 0) <= 0:
            raise RuntimeError(f"kernel {name} was not launched on the batching path: {counts}")
    if counts.get("quant_matmul.gemv", 0) or counts.get("flash_decode.f32", 0):
        raise RuntimeError(f"a one-row or f32 kernel ran on the 4-row path: {counts}")
    # decode: each B-row graph's capture record, credited per replay
    n_quant = sum(isinstance(m, QuantTensor) for m in eng.model.modules())
    records = [(c.n_steps, c.graph.counts) for c in eng._chunks.values()
               if isinstance(c, _RowChunk) and c.graph is not None]
    if not records or any(
            rec.get("quant_matmul.rows", 0) != n * n_quant
            or any(rec.get(k, 0) for k in ("quant_matmul.tc", "quant_matmul.gemv",
                                           "quant_matmul.gemv.kq", "quant_matmul.f32"))
            for n, rec in records):
        raise RuntimeError(f"the B-row decode graphs' records are not one rows-kernel launch for"
                           f" each of the {n_quant} quantized weights a step: {records}")
    log(f"  B-row decode graphs: {len(records)}, each {n_quant} rows-kernel launches a step"
        f" (two a layer and the lm_head), no tile and no GEMV")
    eager_reqs, _, eager_wall = _batch_run(torch, eng, prompts, specs, eager=True)
    for r, e in zip(reqs, eager_reqs):
        if r.out != e.out:
            raise RuntimeError(f"request {r.rid}: the B-row graph's ids differ from the eager"
                               f" step body's:\n{r.out}\n{e.out}")
    log(f"  B-row graph and eager step body: all 8 requests' ids identical (eager run"
        f" {eager_wall:.2f} s)")

    eng1.timings = type(eng1.timings)()
    single = {}
    for i in greedy:
        single[i] = _against_single(eng1, prompts[i], reqs[i].out, f"greedy request {i}",
                                    ROWS_LOGIT_TOL)
    single_tps = eng1.timings.n_decode / (eng1.timings.t_decode_us / 1e6)
    log(f"  greedy requests against the batch-1 engine: {single}; single stream"
        f" {single_tps:.2f} tok/s in the same run")
    # control: the check must refuse ids from the wrong row (each greedy
    # request's ids held to the next greedy request's prompt)
    for i, j in zip(greedy, greedy[1:] + greedy[:1]):
        ctl = _teacher_forced(eng1, prompts[j], reqs[i].out, ROWS_LOGIT_TOL)
        log(f"  control: request {i}'s ids on request {j}'s prompt: worst deficit"
            f" {ctl['worst']:.3f} of its tolerance, {len(ctl['not_argmax'])} of"
            f" {ctl['steps']} ids not the argmax")
        if ctl["worst"] < 1.0:
            raise RuntimeError(f"the batched-id check passed request {i}'s ids on request"
                               f" {j}'s prompt: it cannot tell a wrong row")

    step_ms = {}
    for b in (1, 2, 4, 8, 16):
        e = FalconEngine(hp, params, EngineConfig(), batch_size=b)
        e.decode_rows(np.arange(b) + 100, np.full(b, 300), 16)  # captures, replays once
        g = e.rows_graph(16, RowKey(64, 1, 0, False)).graph  # replays not credited
        a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(3):
            g.replay()
        z.record()
        torch.cuda.synchronize()
        step_ms[b] = a.elapsed_time(z) / (3 * 16)
        del e, g
    log("  device ms a B-row step (16-step graph replays at n_past 300): "
        + ", ".join(f"B={b} {ms:.4f} ({b / ms * 1e3:.1f} tok/s)" for b, ms in step_ms.items()))
    peak = torch.cuda.max_memory_allocated()
    log(f"  peak device memory {peak / 2**30:.2f} GiB")

    # the f32 route at 2 layers: batched greedy ids against the single stream
    hp2 = dataclasses.replace(hp, n_layer=2)
    params2 = make_bench_params(hp2, compute_dtype=torch.float32, device="cuda", seed=7,
                                gtype=GGMLType.Q4_0)
    cfg32 = EngineConfig(kv_dtype="float32", compute_dtype="float32")
    e4 = FalconEngine(hp2, params2, cfg32, batch_size=B)
    g_prompts = [prompts[i] for i in greedy]
    g_specs = [specs[i] for i in greedy]
    f32_reqs, f32_counts, _ = _batch_run(torch, e4, g_prompts, g_specs, eager=False)
    f32_eager, _, _ = _batch_run(torch, e4, g_prompts, g_specs, eager=True)
    if [r.out for r in f32_reqs] != [r.out for r in f32_eager]:
        raise RuntimeError("f32 route: the B-row graph's ids differ from the eager step body's")
    if not f32_counts.get("quant_matmul.f32", 0) or not f32_counts.get("flash_decode.f32", 0):
        raise RuntimeError(f"the f32 4-row path did not run the f32 kernels: {f32_counts}")
    e1 = FalconEngine(hp2, params2, cfg32)
    f32_single = {i: _against_single(e1, p, r.out, f"f32 greedy request {i}", F32_LOGIT_TOL)
                  for i, p, r in zip(greedy, g_prompts, f32_reqs)}
    log(f"  2-layer f32 route, 4 greedy requests through {B} rows: graph = eager; against the"
        f" batch-1 engine: {f32_single}")
    del e4, e1, params2
    return {"path": f"falcon7b q4_0 continuous batching B={B}", "launches": counts, "engine": eng,
            "decode_tok_s": agg, "decode_tok_s_per_row": agg / B, "single_tok_s": single_tps,
            "prefill_ms": prefill_ms, "prefill_tokens": prefill_tokens,
            "capture_ms": capture_ms, "wall_s": wall, "step_ms": step_ms,
            "peak_bytes": peak, "greedy_vs_single": single, "f32_greedy_vs_single": f32_single}


def _http(url: str, route: str, body: dict | None = None, stream: bool = False):
    """One request to the server under test: JSON in, JSON out (GET without
    a body); with stream, the SSE events' JSON (the last a "[DONE]" string
    where the route sends one)."""
    import urllib.request

    data = None if body is None else json.dumps({**body, **({"stream": True} if stream else {})})
    req = urllib.request.Request(url + route, data=None if data is None else data.encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        if r.status != 200:
            raise RuntimeError(f"{route}: HTTP {r.status}")
        raw = r.read().decode()
    if not stream:
        return raw if route == "/metrics" else json.loads(raw)
    return [d if d == "[DONE]" else json.loads(d)
            for d in (line[len("data: "):] for line in raw.split("\n\n") if line)]


def phase_server(torch, eng, params, hp) -> dict:
    """The single-stream server (ggllm_tpu_torch/server/app.py serve) over a
    full-width engine, on 127.0.0.1 at a free port, in a thread; the
    requests come from this thread, the engine's work runs in the handler
    threads. (a) a greedy /completion of 64 tokens equals the same engine's
    Generator on the same prompt from an empty cache, run here first, byte
    for byte (so the handler thread replays a graph this thread captured);
    (b) a prompt that extends (a)'s evaluates only what (a)'s cached tokens
    do not share and equals a Generator run from an empty cache; (c) two
    sampled requests at temperature 0.7 and 0.9, other top-p and repeat
    penalties, add exactly one sampled graph key, and the second captures
    nothing; (d) a streamed request's chunks concatenate to the blocking
    content of the same request (replacement characters aside: each chunk
    is decoded on its own); (e) /v1/chat/completions and /metrics answer,
    the counters matching the requests sent; (f) a server with --self-draft
    8 over the same engine answers a greedy request speculatively
    (_spec_request). Fails on any mismatch."""
    import threading

    from ggllm_tpu_torch.engine.generator import Generator
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.server.app import _common_part, serve
    from ggllm_tpu_torch.utils.synthetic import make_tiny_vocab

    vocab = make_tiny_vocab(hp.n_vocab)  # byte tokens, a few merges, fillers
    httpd = serve(eng, vocab, "127.0.0.1", 0, alias="falcon-7b-q4_0-random")
    state = httpd.state
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def graphs() -> int:
        return sum(c.graph is not None for c in eng._chunks.values())

    def direct(body: dict) -> str:
        """The same engine's Generator from an empty cache, on this thread."""
        with state.lock:
            eng.reset()
            ids = state.tk.tokenize(body["prompt"], bos=True)
            gen = Generator(eng, state.sampler_from(body), state.tk.eos_id,
                            eng.cfg.n_ctx // 4)
            parts = []
            gen.generate(gen.prefill(ids), body["n_predict"],
                         lambda t: parts.append(vocab.id_to_token[t]) is None)
            state.cache_tokens = []  # the server's record no longer holds
        return b"".join(parts).decode("utf-8", "replace")

    def text(s: str) -> str:
        return s.replace("�", "")

    a_body = {"prompt": "the thing and the other thing went south. " * 5, "n_predict": 64,
              "temperature": 0, "ignore_eos": True}
    b_body = {**a_body, "prompt": a_body["prompt"] + "And then it went north again, slowly."}
    c_body = {"prompt": "Once upon a time there was a model that answered.", "n_predict": 64,
              "ignore_eos": True}
    d_body = {"prompt": "In a land far away, a server answered every request.",
              "n_predict": 64, "temperature": 0, "ignore_eos": True}
    timings, sent = {}, []
    try:
        ref_a, ref_b = direct(a_body), direct(b_body)  # the references, before the counts
        build.launch_counts.clear()
        a = _http(url, "/completion", a_body)
        sent.append(a)
        a_ids = state.tk.tokenize(a_body["prompt"], bos=True)
        if (a["content"] != ref_a or a["tokens_predicted"] != 64
                or a["tokens_evaluated"] != len(a_ids)):
            raise RuntimeError(f"server (a): {a['tokens_predicted']} tokens from"
                               f" {a['tokens_evaluated']} evaluated; content equal to the"
                               f" Generator's: {a['content'] == ref_a}")
        cached = list(state.cache_tokens)
        b_ids = state.tk.tokenize(b_body["prompt"], bos=True)
        b = _http(url, "/completion", b_body)
        sent.append(b)
        want = len(b_ids) - _common_part(cached, b_ids)
        if b["tokens_evaluated"] != want or not want < len(b_ids) or b["content"] != ref_b:
            raise RuntimeError(f"server (b): {b['tokens_evaluated']} tokens evaluated of"
                               f" {len(b_ids)} (want {want}); content equal to a run from an"
                               f" empty cache: {b['content'] == ref_b}")
        sampled_before = {k for k in eng._chunks if not k[1].greedy}
        compile_us = []
        for temp, top_p, rp, seed in ((0.7, 0.9, 1.1, 1), (0.9, 0.8, 1.2, 2)):
            sent.append(_http(url, "/completion", {**c_body, "temperature": temp, "top_p": top_p,
                                                   "repeat_penalty": rp, "seed": seed}))
            compile_us.append((eng.timings.t_compile_us, graphs()))
        sampled = [k for k in eng._chunks if not k[1].greedy and k not in sampled_before]
        if len(sampled) != 1 or compile_us[1] != compile_us[0] or any(
                r["tokens_predicted"] != 64 for r in sent[2:4]):
            raise RuntimeError(f"server (c): new sampled keys {sampled}; (compile us, graphs)"
                               f" after each request {compile_us}")
        events = _http(url, "/completion", d_body, stream=True)
        sent.append(events[-1])
        chat = _http(url, "/v1/chat/completions", {
            "messages": [{"role": "system", "content": "be brief"},
                         {"role": "user", "content": "what is the thing?"}],
            "max_tokens": 32, "temperature": 0})
        sent.append({"tokens_evaluated": chat["usage"]["prompt_tokens"],
                     "tokens_predicted": chat["usage"]["completion_tokens"]})
        d = _http(url, "/completion", d_body)
        sent.append(d)
        streamed = "".join(e["content"] for e in events[:-1])
        if (not events[-1]["stop"] or text(streamed) != text(d["content"])
                or chat["choices"][0]["message"]["role"] != "assistant"):
            raise RuntimeError(f"server (d, e): streamed {streamed!r} against blocking"
                               f" {d['content']!r}; chat {chat}")
        metrics = _http(url, "/metrics")
        want_m = {"requests_total": len(sent),
                  "prompt_tokens_total": sum(r["tokens_evaluated"] for r in sent),
                  "generated_tokens_total": sum(r["tokens_predicted"] for r in sent)}
        for name, n in want_m.items():
            if f"ggllm_{name} {n}\n" not in metrics:
                raise RuntimeError(f"server (e): /metrics lacks ggllm_{name} {n}:\n{metrics}")
        counts = dict(build.launch_counts)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    spec = _spec_request(torch, eng, params, hp, vocab, a_body)
    for name, n in spec.pop("launches").items():
        counts[name] = counts.get(name, 0) + n
    names = ("a greedy", "b extends a", "c1 sampled 0.7", "c2 sampled 0.9", "d streamed",
             "e chat", "d blocking")
    for name, r in zip(names, sent):
        t = r.get("timings", {})
        timings[name] = {"tokens_evaluated": r["tokens_evaluated"],
                         "tokens_predicted": r["tokens_predicted"],
                         "prompt_ms": t.get("prompt_ms"),
                         "predicted_per_second": t.get("predicted_per_second")}
        log(f"  server {name}: {r['tokens_evaluated']} evaluated, {r['tokens_predicted']}"
            f" predicted, prompt_ms {t.get('prompt_ms')}, predicted_per_second"
            f" {t.get('predicted_per_second')}")
    log(f"  server: (a) equals the Generator byte for byte, (b) evaluated {b['tokens_evaluated']}"
        f" of {len(b_ids)} prompt tokens and equals a run from an empty cache, (c) one sampled"
        f" key, no capture by the second ({graphs()} graphs, capture"
        f" {eng.timings.t_compile_us / 1e3:.1f} ms in all), (d) the stream concatenates to the"
        f" blocking content, (e) /metrics {want_m}")
    log(f"  launches on the server path: {counts}")
    for name in ("quant_matmul.gemv", "quant_matmul.tc", "flash_mqa.tc", "flash_decode_tc"):
        if counts.get(name, 0) <= 0:
            raise RuntimeError(f"kernel {name} was not launched on the server path")
    return {"path": "falcon7b q4_0 server", "launches": counts, "requests": timings,
            "graphs": graphs(), "capture_ms": eng.timings.t_compile_us / 1e3, "self_draft": spec}


def _spec_request(torch, eng, params, hp, vocab, body: dict) -> dict:
    """The same greedy request of 64 tokens twice (repeat penalty 1, so that
    the fused rounds take it; the first captures the round graph) to a
    server over `eng` with --self-draft 8 (serve's draft_engine, draft_k 6):
    each response must carry the speculative field with rounds and 6 drafts
    a round, and /metrics the spec_* counters. Returns the fields, the
    requests' timings and their launches."""
    import dataclasses
    import threading

    from ggllm_tpu_torch.core.config import EngineConfig
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.engine.speculative import truncate_params
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.server.app import serve

    draft = FalconEngine(dataclasses.replace(hp, n_layer=8), truncate_params(params, 8),
                         EngineConfig())
    httpd = serve(eng, vocab, "127.0.0.1", 0, alias="falcon-7b-q4_0-random", draft_engine=draft,
                  draft_k=6)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        build.launch_counts.clear()
        got, capture_ms = [], []
        for _ in range(2):  # the first captures the round graph
            t_compile = eng.timings.t_compile_us
            got.append(_http(url, "/completion", {**body, "repeat_penalty": 1.0,
                                                  "ignore_eos": False}))
            capture_ms.append((eng.timings.t_compile_us - t_compile) / 1e3)
        counts = dict(build.launch_counts)
        metrics = _http(url, "/metrics")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    for i, r in enumerate(got):
        sp = r.get("speculative") or {}
        log(f"  server --self-draft 8, request {i + 1}: {r['tokens_predicted']} predicted"
            f" ({r['stopped_reason']}), {r['tokens_evaluated']} evaluated, speculative {sp},"
            f" timings {r['timings']}, capture {capture_ms[i]:.1f} ms")
        if not sp.get("rounds") or sp["drafted"] != 6 * sp["rounds"] or r["tokens_predicted"] < 1:
            raise RuntimeError(f"server --self-draft 8: response {r}")
    rounds = sum(r["speculative"]["rounds"] for r in got)
    if f"ggllm_spec_rounds_total {rounds}\n" not in metrics:
        raise RuntimeError(f"server --self-draft 8: /metrics lacks {rounds} rounds:\n{metrics}")
    return {"speculative": [r["speculative"] for r in got],
            "timings": [r["timings"] for r in got], "capture_ms": capture_ms, "launches": counts}


def phase_session(torch, eng, params, hp) -> dict:
    """Sessions on the Falcon-7B Q4_0 engine (engine/session.py), bf16
    cache: a 300-token prompt prefilled and saved; the file loaded into a
    fresh engine over the same weights gives 32 greedy ids bit for bit those
    of an engine that prefilled the same split (prompt[:n], then the rest)
    without a file; a sampled Generator run saved after 8 ids and restored
    into a fresh engine continues with the uninterrupted run's 24 ids. Prints
    the file's bytes and the save and load ms."""
    import numpy as np

    from ggllm_tpu_torch.core.config import EngineConfig
    from ggllm_tpu_torch.engine import session
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.engine.generator import Generator
    from ggllm_tpu_torch.ops.sampling import SamplerParams

    rng = np.random.default_rng(11)
    prompt = [int(t) for t in rng.integers(12, hp.n_vocab, 300)]
    greedy = SamplerParams(temp=0.0)
    fresh = FalconEngine(hp, params, EngineConfig())
    with tempfile.TemporaryDirectory() as d:
        f = str(Path(d) / "prompt.session")
        eng.reset()
        eng.eval(prompt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.save(f, eng, prompt)
        save_ms = (time.perf_counter() - t0) * 1e3
        nbytes = Path(f).stat().st_size
        t0 = time.perf_counter()
        rest = session.try_load(f, fresh, prompt)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        n = len(prompt) - len(rest)
        got = fresh.generate(rest, 32, greedy, stop_ids=set())
        eng.reset()
        eng.eval(prompt[:n])
        want = eng.generate(prompt[n:], 32, greedy, stop_ids=set())
        log(f"  session: {nbytes} bytes for {n} positions, save {save_ms:.1f} ms, load"
            f" {load_ms:.1f} ms; 32 greedy ids after the load {'equal' if got == want else 'differ'}")
        if n != len(prompt) - 1 or got != want:
            raise RuntimeError(f"session: reused {n} of {len(prompt)}; ids after the load\n{got}\n"
                               f"without a file\n{want}")
        sampler = SamplerParams(temp=0.8, top_k=40, top_p=0.95, repeat_penalty=1.1, seed=77)
        eng.reset()
        gen = Generator(eng, sampler, eos_id=-1)
        gen.generate(gen.prefill(prompt), 8, lambda t: True)
        session.save(f, eng, gen.all_tokens[:eng.n_past], sampler_state=gen.state,
                     generator=gen.rng)
        saved, tail_a, tail_b = list(gen.all_tokens), [], []
        gen.generate(gen.prefill([]), 24, lambda t: tail_a.append(t) is None)
        fresh.reset()
        rest = session.try_load(f, fresh, saved)
        gen_b = Generator(fresh, sampler, eos_id=-1)
        gen_b.state, gen_b.rng, _ = session.load_sampler_state(f, sampler, fresh)
        gen_b.all_tokens = saved[:len(saved) - len(rest)]
        gen_b.generate(gen_b.prefill(rest), 24, lambda t: tail_b.append(t) is None)
        log(f"  session: a sampled run restored after 8 ids continues with the uninterrupted"
            f" run's 24: {tail_a == tail_b}")
        if tail_a != tail_b or len(set(tail_a)) < 2:
            raise RuntimeError(f"session: sampled continuation\n{tail_b}\nuninterrupted\n{tail_a}")
    del fresh
    return {"path": "falcon7b q4_0 session", "launches": {}, "bytes": nbytes,
            "positions": n, "save_ms": save_ms, "load_ms": load_ms}


def phase_speculative(torch, eng, params, hp) -> dict:
    """Speculative decoding on the Falcon-7B Q4_0 engine (engine/speculative.py,
    k = 6, 4 rounds a graph), bf16 caches, from a 300-token prompt: 64 greedy
    ids with (a) a second engine over the same weights (the perfect draft:
    the all-accept and bonus-token path) and (b) the first 8 layers
    (--self-draft 8). Each run's ids are held to the single stream's with
    the ids forced within ROWS_LOGIT_TOL (_against_single: the verify runs
    S = 7 rows through the rows kernel, the single stream the GEMV); the
    replayed round graph gives the eager round body's ids, n_acc and both
    caches bit for bit; the round graph's capture record holds
    quant_matmul.rows (verify), quant_matmul.gemv (draft), flash_mqa.tc
    (verify attention) and flash_decode_tc (draft attention). Then 4
    stochastic rounds (temperature 0.8, top-k 40, top-p 0.95) on fixed
    uniforms: the eager rounds' ids and n_acc equal a float64 host replay
    over each round's p and q, and the graph's equal the eager rounds'.
    Prints tok/s, ms a round and acceptance of both drafts beside the
    single stream's tok/s on the same prompt."""
    import dataclasses

    import numpy as np

    from ggllm_tpu_torch.core.config import EngineConfig
    from ggllm_tpu_torch.engine.engine import FalconEngine, Timings
    from ggllm_tpu_torch.engine.speculative import (SpeculativeDecoder, replay_round,
                                                    truncate_params)
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.ops.sampling import SamplerParams
    from ggllm_tpu_torch.tools.time_kernels import round_device_ms, replay_device_ms

    rng = np.random.default_rng(13)
    prompt = [int(t) for t in rng.integers(12, hp.n_vocab, 300)]
    greedy = SamplerParams(temp=0.0, repeat_penalty=1.0)
    eng.reset()
    eng.generate(prompt, 64, greedy, stop_ids=set())  # the single stream, warm
    eng.reset()
    eng.timings = Timings()
    single = eng.generate(prompt, 64, greedy, stop_ids=set())
    single_tps = eng.timings.n_decode / (eng.timings.t_decode_us / 1e6)
    single_device_ms = replay_device_ms(eng, 16, greedy, 2)
    drafts = {"a: perfect draft": FalconEngine(hp, params, EngineConfig()),
              "b: --self-draft 8": FalconEngine(dataclasses.replace(hp, n_layer=8),
                                                truncate_params(params, 8), EngineConfig())}
    out = {"path": "falcon7b q4_0 speculative", "single_tok_s": single_tps,
           "single_device_ms_per_token": single_device_ms}
    counts = {}
    want = ("quant_matmul.rows", "quant_matmul.gemv", "flash_mqa.tc", "flash_decode_tc")

    def run(spec, sampler, n, uniforms=None):
        eng.reset()
        spec.draft.reset()
        eng.timings = Timings()
        ids = spec.generate(prompt, n, sampler, uniforms=uniforms)
        torch.cuda.synchronize()
        kv = tuple(e.kv[:, :, :, :e.n_past].clone() for e in (eng, spec.draft))
        return ids, [a for _, a, _ in spec.last_rounds], kv

    for label, dr in drafts.items():
        spec = SpeculativeDecoder(eng, dr, k=6)
        run(spec, greedy, 16)  # captures the greedy round graph
        capture_ms = eng.timings.t_compile_us / 1e3
        build.launch_counts.clear()
        ids, n_acc, kv = run(spec, greedy, 64)
        for name, c in build.launch_counts.items():
            counts[name] = counts.get(name, 0) + c
        tm, st = eng.timings, spec.stats
        tps, ms_round = 64 / (tm.t_decode_us / 1e6), tm.t_decode_us / 1e3 / st.n_rounds
        record = spec.round_graph(greedy).counts
        device_ms = round_device_ms(spec, greedy, 2)
        e_ids, e_acc, e_kv = run(SpeculativeDecoder(eng, dr, k=6, eager=True), greedy, 64)
        same_kv = all(torch.equal(a, b) for a, b in zip(kv, e_kv))
        log(f"  speculative {label}: {tps:.2f} tok/s ({st.n_rounds} rounds, {ms_round:.3f} ms a"
            f" round on the host's clock, {device_ms:.3f} on the device's, acceptance"
            f" {st.acceptance:.4f}, {st.n_emitted / st.n_rounds:.2f} ids a round) against the"
            f" single stream's {single_tps:.2f} ({single_device_ms:.4f} device ms a token);"
            f" capture {capture_ms:.1f} ms; graph = eager body: ids {ids == e_ids}, n_acc"
            f" {n_acc == e_acc}, caches {same_kv}; the round graph's record a replay: {record}")
        if ids != e_ids or n_acc != e_acc or not same_kv:
            raise RuntimeError(f"speculative {label}: the round graph and the eager body differ:"
                               f"\n{ids}\n{e_ids}\n{n_acc}\n{e_acc}; caches equal {same_kv}")
        if any(record.get(name, 0) <= 0 for name in want):
            raise RuntimeError(f"speculative {label}: the round graph launches {record}, not all"
                               f" of {want}")
        tf = _against_single(eng, prompt, ids, f"speculative {label}", ROWS_LOGIT_TOL)
        out[label] = {"tok_s": tps, "ms_a_round": ms_round, "device_ms_a_round": device_ms,
                      "rounds": st.n_rounds,
                      "acceptance": st.acceptance, "capture_ms": capture_ms,
                      "round_graph_launches": record, "equal_single": tf["equal"],
                      "worst_deficit": tf["worst"]}
        if label.startswith("a") and st.acceptance < 0.9:
            raise RuntimeError(f"speculative {label}: acceptance {st.acceptance} with the"
                               " target's own weights as the draft")

    # stochastic rounds on fixed uniforms, with the 8-layer draft
    sampler = SamplerParams(temp=0.8, top_k=40, top_p=0.95, repeat_penalty=1.0, seed=5)
    us = rng.random((8, 14)).astype(np.float32)
    spec = SpeculativeDecoder(eng, drafts["b: --self-draft 8"], k=6, eager=True)
    spec.record = []
    e_ids, e_acc, _ = run(spec, sampler, 24, us)
    rounds = spec.last_rounds
    replays = [replay_round(rec["p"].double().cpu().numpy(), rec["q"].double().cpu().numpy(),
                            rec["xs"].tolist(), u) for rec, (_, _, u) in zip(spec.record, rounds)]
    g_ids, g_acc, _ = run(SpeculativeDecoder(eng, drafts["b: --self-draft 8"], k=6), sampler,
                          24, us)
    ok = replays == [(e, a) for e, a, _ in rounds]
    log(f"  speculative stochastic (8-layer draft, fixed uniforms): {len(rounds)} rounds, n_acc"
        f" {e_acc}; float64 replay of accept / resample {'equal' if ok else 'differs'}; graph ="
        f" eager: ids {g_ids == e_ids}, n_acc {g_acc == e_acc}")
    if not ok or g_ids != e_ids or g_acc != e_acc or len(e_ids) != 24:
        raise RuntimeError(f"speculative stochastic rounds: replays {replays}, rounds"
                           f" {[(e, a) for e, a, _ in rounds]}; graph {g_ids} {g_acc}, eager"
                           f" {e_ids} {e_acc}")
    out["stochastic"] = {"rounds": len(rounds), "n_acc": e_acc}
    out["launches"] = counts
    del drafts, spec
    eng.timings = Timings()
    return out


def _row_caches(spec, prompts, ids) -> list:
    """Both engines' caches over each row's committed prefix (the prompt but
    its last token, the last token, the ids but the last), cloned."""
    def rows_of(kv, b, n):
        parts = kv if isinstance(kv, tuple) else (kv,)
        return [t[:, :, b, :n].clone() for t in parts]

    return [rows_of(e.kv, b, len(p) - 1 + len(o)) for e in (spec.target, spec.draft)
            for b, (p, o) in enumerate(zip(prompts, ids))]


def phase_speculative_rows(torch, eng1, params, hp, single_spec: dict, batcher: dict) -> dict:
    """Batched speculative rounds (engine/speculative.py generate_rows) on the
    Falcon-7B Q4_0 weights at full width and depth, bf16 caches, k = 6, R = 4
    rounds a graph, 64 greedy ids a row from prompts of 5, 37, 120 and 300
    tokens: a perfect draft (a second B-row engine over the same weights) at
    B = 4 and B = 2 (the first two prompts), --self-draft 8 at B = 4, the
    perfect draft on an int8 draft cache at B = 4 (a perfect draft's
    acceptance at least 0.5: bf16 near-ties between the draft's and the
    verify's kernels reject some; at f32, 2 layers, at least 0.95). Each
    run's replayed round
    graphs give the eager round body's ids, n_acc and both caches over the
    committed prefixes bit for bit; every row's ids lie within ROWS_LOGIT_TOL
    of the single stream's (eng1) top logit with the ids forced
    (`_against_single`); a replay's record holds the verify on quant_matmul.tc
    at B = 4 (28 rows) and on quant_matmul.rows at B = 2 (14), the draft
    steps on quant_matmul.rows, flash_mqa.tc and flash_decode_tc, no GEMV. Then
    a 360-position context: the 300-token row ends early and alone (fewer than
    64 ids, frozen by its live mask while the others run on), and the other
    rows' ids equal a run with a short fourth prompt on the same engines.
    Prints aggregate and per-row tok/s, ms a round on the host's and the
    device's clocks, acceptance, capture ms and one replay's launches, beside
    the batcher's B = 4 rate and the single-stream speculative rate of this
    run."""
    import dataclasses

    import numpy as np

    from ggllm_tpu_torch.core.config import EngineConfig
    from ggllm_tpu_torch.core.dtypes import GGMLType
    from ggllm_tpu_torch.engine.engine import FalconEngine, Timings
    from ggllm_tpu_torch.engine.speculative import SpeculativeDecoder, truncate_params
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.ops.linear import QuantTensor
    from ggllm_tpu_torch.tools.time_kernels import round_device_ms
    from ggllm_tpu_torch.utils.benchgen import make_bench_params

    k, R, n = 6, 4, 64
    rng = np.random.default_rng(17)
    prompts = [[int(t) for t in rng.integers(12, hp.n_vocab, m)] for m in (5, 37, 120, 300)]
    n_quant = sum(isinstance(m, QuantTensor) for m in eng1.model.modules())

    def decoder(B, n_layer=None, kv_dtype="bfloat16", n_ctx=2048):
        dhp = hp if n_layer is None else dataclasses.replace(hp, n_layer=n_layer)
        dparams = params if n_layer is None else truncate_params(params, n_layer)
        return SpeculativeDecoder(
            FalconEngine(hp, params, EngineConfig(n_ctx=n_ctx), batch_size=B),
            FalconEngine(dhp, dparams, EngineConfig(n_ctx=n_ctx, kv_dtype=kv_dtype), batch_size=B),
            k=k, rounds_per_dispatch=R)

    def run(spec, ps, eager=False):
        spec.eager = eager
        for e in (spec.target, spec.draft):
            e.reset()
        spec.target.timings = Timings()
        build.launch_counts.clear()
        ids = spec.generate_rows(ps, n)
        torch.cuda.synchronize()
        return ids, spec.last_rows["n_acc"], _row_caches(spec, ps, ids), dict(build.launch_counts)

    out = {"path": "falcon7b q4_0 batched speculative rounds", "launches": {}}
    runs = (("B=4 perfect draft", 4, {}), ("B=2 perfect draft", 2, {}),
            ("B=4 --self-draft 8", 4, {"n_layer": 8}),
            ("B=4 perfect draft, int8 draft cache", 4, {"kv_dtype": "int8"}))
    for label, B, kw in runs:
        ps = prompts[:B]
        spec = decoder(B, **kw)
        run(spec, [p[:8] for p in ps])  # captures the round graph
        capture_ms = spec.target.timings.t_compile_us / 1e3
        ids, n_acc, caches, counts = run(spec, ps)
        for name, c in counts.items():
            out["launches"][name] = out["launches"].get(name, 0) + c
        tm, st = spec.target.timings, spec.stats
        wall_s = tm.t_decode_us / 1e6
        agg = sum(map(len, ids)) / wall_s
        ms_round = tm.t_decode_us / 1e3 / st.n_rounds
        record = spec.rows_graph().counts
        device_ms = round_device_ms(spec, None, 2)
        e_ids, e_acc, e_caches, _ = run(spec, ps, eager=True)
        same_kv = all(torch.equal(a, b) for x, y in zip(caches, e_caches) for a, b in zip(x, y))
        verify = "quant_matmul.tc" if B * (k + 1) > 16 else "quant_matmul.rows"
        log(f"  speculative rows, {label}: {agg:.2f} tok/s aggregate, per row"
            f" {[round(len(o) / wall_s, 2) for o in ids]}; {st.n_rounds} rounds, {ms_round:.3f} ms"
            f" a round on the host's clock, {device_ms:.3f} on the device's; acceptance"
            f" {st.acceptance:.4f}; capture {capture_ms:.1f} ms; graph = eager body: ids"
            f" {ids == e_ids}, n_acc {n_acc == e_acc}, caches {same_kv}; one replay launches"
            f" {record} (the verify's {B * (k + 1)} rows on {verify})")
        if ids != e_ids or n_acc != e_acc or not same_kv:
            raise RuntimeError(f"speculative rows {label}: the round graph and the eager body"
                               f" differ:\n{ids}\n{e_ids}\n{n_acc}\n{e_acc}; caches {same_kv}")
        if any(len(o) != n for o in ids):
            raise RuntimeError(f"speculative rows {label}: {[len(o) for o in ids]} ids")
        steps = R * (k + 1) * (2 * kw.get("n_layer", hp.n_layer) + 1)  # the draft's weights
        want_rows = steps + (R * n_quant if verify.endswith("rows") else 0)
        if (record.get(verify, 0) < R * n_quant or record.get("quant_matmul.rows", 0) != want_rows
                or any(record.get(name, 0) for name in ("quant_matmul.gemv", "quant_matmul.gemv.kq"))
                or (verify.endswith("rows") and record.get("quant_matmul.tc", 0))
                or record.get("flash_mqa.tc", 0) != R * hp.n_layer
                or record.get("flash_decode_tc" + (".int8" if kw.get("kv_dtype") else ""), 0)
                != R * (k + 1) * kw.get("n_layer", hp.n_layer)):
            raise RuntimeError(f"speculative rows {label}: one replay launches {record}")
        tfs = [_against_single(eng1, p, o, f"speculative rows {label}, row {b}", ROWS_LOGIT_TOL)
               for b, (p, o) in enumerate(zip(ps, ids))]
        # the target's own weights on the same cache: every draft id the
        # verify's argmax but at bf16 near-ties, where the draft's decode
        # attention and the verify's prefill attention (and at 28 rows the
        # tile's bf16-rounded weights) part; random weights put 11-20 of 64
        # steps' top-2 gaps below 1e-2 of max |logit|
        if "n_layer" not in kw and "kv_dtype" not in kw and st.acceptance < 0.5:
            raise RuntimeError(f"speculative rows {label}: acceptance {st.acceptance} with the"
                               " target's own weights as the draft")
        out[label] = {"tok_s": agg, "tok_s_per_row": [len(o) / wall_s for o in ids],
                      "ms_a_round": ms_round, "device_ms_a_round": device_ms,
                      "rounds": st.n_rounds, "acceptance": st.acceptance,
                      "capture_ms": capture_ms, "replay_launches": record,
                      "worst_deficit": max(t["worst"] for t in tfs),
                      "equal_single": [t["equal"] for t in tfs]}
        if label == "B=4 perfect draft":
            full = ids
        del spec

    # the same rounds at f32 (2 layers): a perfect draft whose kernels agree
    # to f32 rounding is accepted at (nearly) every position
    hp2 = dataclasses.replace(hp, n_layer=2)
    params2 = make_bench_params(hp2, compute_dtype=torch.float32, device="cuda", seed=7,
                                gtype=GGMLType.Q4_0)
    cfg32 = EngineConfig(kv_dtype="float32", compute_dtype="float32")
    spec = SpeculativeDecoder(FalconEngine(hp2, params2, cfg32, batch_size=4),
                              FalconEngine(hp2, params2, cfg32, batch_size=4), k=k,
                              rounds_per_dispatch=R)
    f32_ids, _, _, f32_counts = run(spec, prompts)
    log(f"  speculative rows, B=4 perfect draft at f32 (2 layers): acceptance"
        f" {spec.stats.acceptance:.4f} in {spec.stats.n_rounds} rounds; launches {f32_counts}")
    if spec.stats.acceptance < 0.95 or not f32_counts.get("quant_matmul.f32"):
        raise RuntimeError(f"speculative rows at f32: acceptance {spec.stats.acceptance},"
                           f" launches {f32_counts}")
    out["f32_acceptance"] = spec.stats.acceptance
    del spec, params2

    # a row at its context end: 300 + 2 R (k + 1) = 356 <= 360 lets it run
    # one dispatch or two, while the others reach 64 ids
    spec = decoder(4, n_ctx=360)
    ended, _, _, _ = run(spec, prompts)
    lives = np.stack(spec.last_rows["live"])
    n_past = spec.last_rows["n_past"]
    short = prompts[:3] + [prompts[0][:3]]
    others, _, _, _ = run(spec, short)
    log(f"  speculative rows, context 360: ids a row {[len(o) for o in ended]}; live masks a"
        f" dispatch {lives.astype(int).tolist()}; device n_past at the end {n_past.tolist()};"
        f" rows 0-2 equal to a run with a short fourth prompt: {ended[:3] == others[:3]}, to"
        f" the 2048-context run: {ended[:3] == full[:3]}")
    if (not 0 < len(ended[3]) < n or [len(o) for o in ended[:3]] != [n] * 3
            or ended[:3] != others[:3] or lives[-1, 3] or n_past.max() > 360):
        raise RuntimeError(f"speculative rows: the 300-token row did not end alone at the"
                           f" context's end: {[len(o) for o in ended]}, {lives.tolist()},"
                           f" {n_past.tolist()}")
    _against_single(eng1, prompts[3], ended[3], "speculative rows, the ended row", ROWS_LOGIT_TOL)
    out["context_end"] = {"ids": [len(o) for o in ended], "n_past": n_past.tolist(),
                          "dispatches": len(lives)}
    del spec
    log(f"  beside: the batcher's B = 4 rate {batcher['decode_tok_s']:.2f} tok/s, the"
        f" single-stream speculative (perfect draft) {single_spec['a: perfect draft']['tok_s']:.2f}"
        f" and single stream {single_spec['single_tok_s']:.2f} tok/s in this run")
    return out


def _greedy_rate(eng, prompt) -> tuple[float, list, dict]:
    """64 greedy ids after `prompt` through the decode graphs (captured by a
    short run first): (decode tok/s, the ids, the launch counts of the run)."""
    from ggllm_tpu_torch.engine.engine import Timings
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.ops.sampling import SamplerParams

    greedy = SamplerParams(temp=0.0)
    eng.reset()
    eng.generate(prompt[:8], 16, greedy, stop_ids=set())  # captures
    eng.reset()
    eng.timings = Timings()
    build.launch_counts.clear()
    ids = eng.generate(prompt, 65, greedy, stop_ids=set())
    return eng.timings.n_decode / (eng.timings.t_decode_us / 1e6), ids, dict(build.launch_counts)


def phase_dequant(torch, eng, params, hp) -> dict:
    """--weight-mode dequant at full width: the Falcon-7B Q4_0 weights
    dequantized once to bf16 on the card (io/loader.py dequantize_params,
    about 14 GB), 64 greedy tokens from a 300-token prompt through the
    decode graphs (dense torch.matmul, the library's path: a yardstick)
    beside the fused engine's rate in the same call. No quantized-matmul
    kernel may run. Its 300 prefill logits are held against the plain
    versions (exact f32 dequantization) at LOGIT_TOL, as the kernels' are;
    the fused engine's distance from the plain versions and the step where
    the two engines' greedy ids part are printed beside (bf16-rounded dense
    weights and the kernels' exact codes part at near-ties)."""
    import numpy as np

    from ggllm_tpu_torch.core.config import EngineConfig
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.io.loader import dequantize_params

    rng = np.random.default_rng(19)
    prompt = [int(t) for t in rng.integers(12, hp.n_vocab, 300)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense = dequantize_params(params, torch.bfloat16)
    torch.cuda.synchronize()
    deq_s = time.perf_counter() - t0
    nbytes = sum(t.numel() * t.element_size() for lw in dense["layers"] for t in lw.values())
    nbytes += dense["lm_head"].numel() * 2
    deq = FalconEngine(hp, dense, EngineConfig())
    runs = {}
    for label, e in (("dequant", deq), ("fused", eng)):
        runs[label] = _greedy_rate(e, prompt)
        e.reset()
        runs[label] += (e.eval(prompt, logits_all=True),)
    plain = FalconEngine(hp, params, EngineConfig(kernel_layout=False, flash_attention=False))
    ref = plain.eval(prompt, logits_all=True)
    del plain
    rel = {k: float(np.abs(r[3] - ref).max() / np.abs(ref).max()) for k, r in runs.items()}
    tok_s, ids, counts, _ = runs["dequant"]
    part = next((t for t, (a, b) in enumerate(zip(ids, runs["fused"][1])) if a != b), None)
    log(f"  --weight-mode dequant: {nbytes / 2**30:.2f} GiB of bf16 weights, dequantized in"
        f" {deq_s:.2f} s; 64 greedy tokens {tok_s:.2f} tok/s against the fused"
        f" {runs['fused'][0]:.2f} (same prompt, same call); prefill logits against the plain"
        f" versions {rel['dequant']:.3e} of max |plain| (the fused engine's {rel['fused']:.3e});"
        f" greedy ids part from the fused engine's at step {part}; launches {counts}")
    if (any(name.startswith("quant_matmul") for name in counts) or not counts.get("flash_decode")
            or rel["dequant"] > LOGIT_TOL or len(ids) != 65):
        raise RuntimeError(f"--weight-mode dequant: logits {rel}, launches {counts}")
    fused_tok_s = runs["fused"][0]
    del deq, dense, runs
    torch.cuda.empty_cache()
    return {"path": "falcon7b q4_0 --weight-mode dequant", "launches": counts, "tok_s": tok_s,
            "fused_tok_s": fused_tok_s, "dequant_s": deq_s, "weight_bytes": nbytes,
            "logit_rel_err": rel["dequant"], "fused_logit_rel_err": rel["fused"],
            "ids_part_at": part}


def _write_f16_model(torch, path: str, hp) -> None:
    """A full-width f16 file of `hp` (GGCC for Falcon, GGJT for LLaMA): the
    port synthetic writer's names, shapes and spreads (weight_specs), drawn
    on the card from a seed; 1-D tensors in f32."""
    import numpy as np

    from ggllm_tpu_torch.core.dtypes import GGMLType
    from ggllm_tpu_torch.io.ggcc import GGCCWriter, GGJTWriter
    from ggllm_tpu_torch.utils.synthetic import make_tiny_sp_vocab, make_tiny_vocab, weight_specs

    if hp.arch == "llama":
        writer = GGJTWriter(path, hp, make_tiny_sp_vocab(hp.n_vocab))
    else:
        vocab = make_tiny_vocab(hp.n_vocab)
        hp.n_bpe_merges = len(vocab.merges)
        writer = GGCCWriter(path, hp, vocab)
    gen = torch.Generator(device="cuda").manual_seed(23)
    for name, shape, scale, offset in weight_specs(hp):
        x = torch.randn(shape, generator=gen, device="cuda") * scale + offset
        gtype = GGMLType.F16 if len(shape) == 2 else GGMLType.F32
        x = x.half() if len(shape) == 2 else x
        writer.write_tensor(name, gtype, tuple(reversed(shape)),
                            np.ascontiguousarray(x.cpu().numpy()).reshape(-1).view(np.uint8))
    writer.close()


def phase_quantize(torch) -> dict:
    """The quantize tool (tools/quantize.py, the C++ codecs) at full width and
    TOOL_LAYERS layers: an f16 Falcon-7B file -> q4_0 and an f16 LLaMA-7B file
    -> q4_k_m (the mixed policy: output.weight and, in a one-layer file, the
    layer's wv and w2 in Q6_K, the others Q4_K).
    Each quantized file is loaded on the card; a 300-token prefill's logits
    and one decode step's are held against the plain versions (LOGIT_TOL),
    and 16 greedy tokens run through the decode graphs. Prints the seconds
    and MB in -> out; the files are deleted."""
    import numpy as np

    from ggllm_tpu_torch.core.config import EngineConfig
    from ggllm_tpu_torch.core.dtypes import GGMLType
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.io.loader import load_model
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.ops.sampling import SamplerParams
    from ggllm_tpu_torch.tools.quantize import quantize_file
    from ggllm_tpu_torch.utils.benchgen import bench_hparams

    out = {"path": f"quantize tool, {TOOL_LAYERS}-layer full-width files", "launches": {}}
    for model, ftype, gemv in (("falcon7b", "q4_0", "quant_matmul.gemv"),
                               ("llama7b", "q4_k_m", "quant_matmul.gemv.kq")):
        # llama.cpp writes n_rot = n_embd / n_head; the reader tells a GGJT
        # LLaMA from a Falcon by it
        hp = bench_hparams(model, TOOL_LAYERS)
        with tempfile.TemporaryDirectory() as d:
            src, dst = str(Path(d) / "f16.bin"), str(Path(d) / f"{ftype}.bin")
            t0 = time.perf_counter()
            _write_f16_model(torch, src, hp)
            write_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            sizes = quantize_file(src, dst, ftype, log=lambda *a: None)
            quant_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            mf, params = load_model(dst, EngineConfig())
            load_s = time.perf_counter() - t0
        rng = np.random.default_rng(29)
        prompt = [int(t) for t in rng.integers(12, hp.n_vocab, 300)]
        eng = FalconEngine(mf.hparams, params, EngineConfig())
        plain = FalconEngine(mf.hparams, params, EngineConfig(kernel_layout=False,
                                                               flash_attention=False))
        build.launch_counts.clear()
        rel, rel_d, got = _held(eng, plain, prompt)
        eng.reset()
        ids = eng.generate(prompt, 17, SamplerParams(temp=0.0), stop_ids=set())
        counts = dict(build.launch_counts)
        for name, c in counts.items():
            out["launches"][name] = out["launches"].get(name, 0) + c
        graph = eng.chunk_graph(16, SamplerParams(temp=0.0)) is not None
        types = sorted({GGMLType(t.gtype).name for t in mf.tensors.values()})
        log(f"  quantize {model} {hp.n_layer} layers f16 -> {ftype}:"
            f" {sizes['total_org'] / 2**20:.1f} MB -> {sizes['total_new'] / 2**20:.1f} MB in"
            f" {quant_s:.2f} s (writing the f16 file {write_s:.2f} s, loading the {ftype} file on"
            f" the card {load_s:.2f} s); types {types}; prefill logits {rel:.3e} and a decode"
            f" step's {rel_d:.3e} of max |plain|; 16 greedy ids through the decode graph"
            f" ({graph}); launches {counts}")
        if (rel > LOGIT_TOL or rel_d > LOGIT_TOL or not np.isfinite(got).all() or not graph
                or len(ids) != 17 or counts.get("quant_matmul.tc", 0) <= 0
                or counts.get(gemv, 0) <= 0):
            raise RuntimeError(f"the quantized {model} {ftype} file: logits {rel}, {rel_d};"
                               f" graph {graph}; launches {counts}")
        out[f"{model} {ftype}"] = {"seconds": quant_s, "mb_in": sizes["total_org"] / 2**20,
                                   "mb_out": sizes["total_new"] / 2**20, "write_f16_s": write_s,
                                   "load_s": load_s, "logit_rel_err": rel,
                                   "decode_logit_rel_err": rel_d, "types": types}
        del eng, plain, params, mf
        torch.cuda.empty_cache()
    return out


def _write_params_file(path: str, params: dict, hp) -> None:
    """The Falcon-7B-style parameter tree `params` (merged "wqkvu" and
    "w_od" QuantTensors on the card) as a GGCC file: each merged weight split
    back into the file's four matrices (rows of "wqkvu", 32-wide blocks of
    "w_od"), planes to ggml blocks (quant/planar.py from_planes), the
    embedding in f32 (exactly its bf16 values)."""
    import numpy as np

    from ggllm_tpu_torch.core.dtypes import TYPE_TRAITS, GGMLType
    from ggllm_tpu_torch.io.ggcc import GGCCWriter
    from ggllm_tpu_torch.quant import planar
    from ggllm_tpu_torch.utils.synthetic import make_tiny_vocab

    vocab = make_tiny_vocab(hp.n_vocab)
    hp.n_bpe_merges = len(vocab.merges)
    w = GGCCWriter(path, hp, vocab)

    def quant(name, q, rows=slice(None), blocks=slice(None)):
        planes = {k: v[rows, blocks].cpu().numpy() for k, v in q.planes.items()}
        blob = planar.from_planes(q.gtype, planes)
        n_rows = blob.shape[0]
        cols = blob.shape[1] // TYPE_TRAITS[q.gtype].type_size * TYPE_TRAITS[q.gtype].block_size
        w.write_tensor(name, q.gtype, (cols, n_rows), blob.reshape(-1))

    def f32(name, t):
        a = t.float().cpu().numpy()
        w.write_tensor(name, GGMLType.F32, tuple(reversed(a.shape)), a.reshape(-1).view(np.uint8))

    f32("transformer.word_embeddings.weight", params["tok_embeddings"])
    f32("transformer.ln_f.weight", params["output_norm"])
    f32("transformer.ln_f.bias", params["output_norm_b"])
    quant("lm_head.weight", params["lm_head"])
    n_qkv = (hp.n_head + 2 * hp.n_head_kv) * hp.head_dim
    nb_wo = hp.n_head * hp.head_dim // 32
    for i, lw in enumerate(params["layers"]):
        p = f"transformer.h.{i}"
        f32(f"{p}.input_layernorm.weight", lw["input_ln_w"])
        f32(f"{p}.input_layernorm.bias", lw["input_ln_b"])
        quant(f"{p}.self_attention.query_key_value.weight", lw["wqkvu"], rows=slice(0, n_qkv))
        quant(f"{p}.self_attention.dense.weight", lw["w_od"], blocks=slice(0, nb_wo))
        quant(f"{p}.mlp.dense_h_to_4h.weight", lw["wqkvu"], rows=slice(n_qkv, None))
        quant(f"{p}.mlp.dense_4h_to_h.weight", lw["w_od"], blocks=slice(nb_wo, None))
    w.close()


def _held(eng, plain, prompt) -> tuple[float, float, np.ndarray]:
    """A prefill of `prompt` (logits of every position) and one decode step
    on the kernels' engine and the plain versions' (fresh caches): each
    max |d| / max |plain|, and the kernels' prefill logits."""
    import numpy as np

    eng.reset()
    plain.reset()
    got, ref = eng.eval(prompt, logits_all=True), plain.eval(prompt, logits_all=True)
    tok = int(ref[-1].argmax())
    got_d, ref_d = eng.eval([tok]), plain.eval([tok])
    if not (np.isfinite(got).all() and np.isfinite(got_d).all()):
        raise RuntimeError("logits are not finite")
    return (float(np.abs(got - ref).max() / np.abs(ref).max()),
            float(np.abs(got_d - ref_d).max() / np.abs(ref_d).max()), got)


def phase_lora(torch, params, hp) -> dict:
    """A LoRA adapter at load (io/loader.py load_params(lora=)) on the main
    path's Falcon-7B Q4_0 weights, their first LORA_LAYERS layers: the tree
    written as a GGCC
    file, a ggla adapter (r = 16, alpha = 32) on query_key_value and
    dense_4h_to_h of every layer, the file loaded on the card with it (the
    patched keys dense bf16, "wqkvu" and "w_od" split, ffn_up and wo still
    Q4_0). A 300-token prefill and 64 greedy ids through the decode graphs;
    the prefill and one decode step's logits held to the plain versions on
    the same patched tree at LOGIT_TOL, and the prefill logits far (over 5
    LOGIT_TOL) from the unpatched engine's; the GEMV, flash_mqa.tc and
    flash_decode must launch. Prints tok/s beside the fused engine's on the
    same layers in the same call, and the seconds of writing the file and
    of the load."""
    import dataclasses
    import warnings

    import numpy as np

    from ggllm_tpu_torch.core.config import EngineConfig
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.engine.speculative import truncate_params
    from ggllm_tpu_torch.io.lora import write_lora
    from ggllm_tpu_torch.io.loader import load_model
    from ggllm_tpu_torch.ops.linear import QuantTensor
    from ggllm_tpu_torch.ops.sampling import SamplerParams

    hp = dataclasses.replace(hp, n_layer=LORA_LAYERS)
    params = truncate_params(params, LORA_LAYERS)
    eng = FalconEngine(hp, params, EngineConfig())  # the fused engine on the same layers
    rng = np.random.default_rng(20)
    prompt = [int(t) for t in rng.integers(12, hp.n_vocab, 300)]
    r, alpha = 16, 32
    n_qkv = (hp.n_head + 2 * hp.n_head_kv) * hp.head_dim
    tensors = {}
    for i in range(hp.n_layer):  # delta spread 2 * 4 * 0.03^2 = 0.0072, the weights' 0.0116
        for name, (out, cols) in ((f"transformer.h.{i}.self_attention.query_key_value.weight",
                                   (n_qkv, hp.n_embd)),
                                  (f"transformer.h.{i}.mlp.dense_4h_to_h.weight",
                                   (hp.n_embd, hp.n_ff))):
            tensors[name] = {"loraA": (rng.standard_normal((r, cols)) * 0.03).astype(np.float32),
                             "loraB": (rng.standard_normal((out, r)) * 0.03).astype(np.float32)}
    with tempfile.TemporaryDirectory() as d:
        path, ggla = str(Path(d) / "falcon7b-q4_0.ggcc"), str(Path(d) / "adapter.ggla")
        t0 = time.perf_counter()
        _write_params_file(path, params, hp)
        write_lora(ggla, r, alpha, tensors)
        write_s = time.perf_counter() - t0
        file_mb, ggla_mb = os.path.getsize(path) / 2**20, os.path.getsize(ggla) / 2**20
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as said:
            warnings.simplefilter("always")
            mf, lparams = load_model(path, EngineConfig(), lora=ggla)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    lw = lparams["layers"][0]
    kinds = {k: "dense " + str(v.dtype).split(".")[-1] if isinstance(v, torch.Tensor)
             and v.dim() == 2 else type(v).__name__ for k, v in lw.items() if k not in
             ("input_ln_w", "input_ln_b")}
    if (kinds != {"wqkv": "dense bfloat16", "ffn_up": "QuantTensor", "wo": "QuantTensor",
                  "ffn_down": "dense bfloat16"}
            or not all(isinstance(l["wo"], QuantTensor) and not isinstance(l["ffn_down"],
                       QuantTensor) for l in lparams["layers"])):
        raise RuntimeError(f"the patched tree's layer weights: {kinds}")
    leng = FalconEngine(mf.hparams, lparams, EngineConfig())
    runs = {label: _greedy_rate(e, prompt) for label, e in (("lora", leng), ("fused", eng))}
    tok_s, ids, counts = runs["lora"]
    graph = leng.chunk_graph(16, SamplerParams(temp=0.0)) is not None
    plain = FalconEngine(mf.hparams, lparams, EngineConfig(kernel_layout=False,
                                                           flash_attention=False))
    rel, rel_d, got = _held(leng, plain, prompt)
    del plain
    eng.reset()
    base = eng.eval(prompt, logits_all=True)
    rel_base = float(np.abs(got - base).max() / np.abs(base).max())
    nbytes = sum(t.numel() * t.element_size() if isinstance(t, torch.Tensor) else
                 sum(p.numel() * p.element_size() for p in t.planes.values())
                 for t in [lparams["lm_head"], *(w for l in lparams["layers"] for w in l.values())])
    log(f"  LoRA r {r} alpha {alpha} on query_key_value and dense_4h_to_h of {hp.n_layer} layers:"
        f" the {file_mb:.1f} MB Q4_0 file and the {ggla_mb:.1f} MB adapter written in"
        f" {write_s:.2f} s, loaded with the adapter on the card in {load_s:.2f} s"
        f" ({[str(w.message)[:60] for w in said]}); layer weights {kinds},"
        f" {nbytes / 2**30:.2f} GiB a token; 64 greedy tokens {tok_s:.2f} tok/s through the decode"
        f" graph ({graph}) against the fused {runs['fused'][0]:.2f} (same prompt, same call);"
        f" prefill logits {rel:.3e} and a decode step's {rel_d:.3e} of max |plain| on the patched"
        f" tree; {rel_base:.3e} of max |unpatched| from the unpatched engine's; launches {counts}")
    if (rel > LOGIT_TOL or rel_d > LOGIT_TOL or rel_base < 5 * LOGIT_TOL or not graph
            or len(ids) != 65 or any(counts.get(k, 0) <= 0 for k in (
                "quant_matmul.gemv", "quant_matmul.tc", "flash_mqa.tc", "flash_decode",
                "flash_decode_tc"))):
        raise RuntimeError(f"the LoRA path: logits {rel}, {rel_d}, from the unpatched {rel_base};"
                           f" graph {graph}; launches {counts}")
    del leng, lparams, eng
    torch.cuda.empty_cache()
    return {"path": f"falcon7b q4_0 --lora (r 16, qkv and dense_4h_to_h), {hp.n_layer} layers",
            "launches": counts,
            "tok_s": tok_s, "fused_tok_s": runs["fused"][0], "write_s": write_s,
            "load_s": load_s, "file_mb": file_mb, "weight_bytes": nbytes,
            "logit_rel_err": rel, "decode_logit_rel_err": rel_d,
            "unpatched_logit_rel_diff": rel_base}


def _card_draw(torch, hp, seed: int):
    """draw(HF name, shape) for synthetic.write_hf_model: weight_specs'
    spreads, drawn on the card from a seed (f32, to the host)."""
    from ggllm_tpu_torch.utils.synthetic import hf_name, weight_specs

    spreads = {hf_name(hp, name): (scale, offset) for name, _, scale, offset in weight_specs(hp)}
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(name, shape):
        scale, offset = spreads[name]
        return (torch.randn(shape, generator=gen, device="cuda") * scale + offset).cpu().numpy()

    return draw


def phase_convert(torch) -> dict:
    """The converters at full width and TOOL_LAYERS layers, without `safetensors` or
    `transformers` (the card's machine has neither): a Falcon-7B HF
    directory (utils/synthetic.py: bf16 safetensors, the embedding tied so
    lm_head is absent, a tokenizer.json of 65024 ids) -> GGCC f16
    (io/convert_hf.py) -> q4_0 (tools/quantize.py); a PEFT adapter (r 16,
    alpha 32, query_key_value and dense_4h_to_h, bf16) -> ggla
    (io/convert_lora.py); the q4_0 file loaded with --lora and --lora-base
    (the f16 file). A LLaMA-7B HF directory (a 32000-piece tokenizer.model)
    -> GGJT f16 (io/convert_hf_llama.py; n_rot 128 from the converter),
    loaded as it is. On each loaded model a 300-token prefill's logits and a
    decode step's are held to the plain versions (LOGIT_TOL) and 16 greedy
    ids run through the decode graph. Prints each step's seconds and MB in
    and out; the files are deleted."""
    import dataclasses
    import warnings

    import numpy as np

    from ggllm_tpu_torch.core.config import EngineConfig, named_hparams
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.io import convert_hf, convert_hf_llama, convert_lora
    from ggllm_tpu_torch.io.loader import load_model
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.ops.linear import QuantTensor
    from ggllm_tpu_torch.ops.sampling import SamplerParams
    from ggllm_tpu_torch.tools.quantize import quantize_file
    from ggllm_tpu_torch.utils.synthetic import write_hf_model, write_peft_adapter

    def mb(*paths):
        return sum(os.path.getsize(p) for p in paths) / 2**20

    def timed(fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        return out, time.perf_counter() - t0

    out = {"path": f"converters, {TOOL_LAYERS}-layer full-width checkpoints", "launches": {}}
    quiet = lambda *a: None  # noqa: E731
    rng = np.random.default_rng(31)
    prompt = [int(t) for t in rng.integers(12, 32000, 300)]
    for model in ("falcon7b", "llama7b"):
        hp = dataclasses.replace(named_hparams(model), n_layer=TOOL_LAYERS)
        steps = {}
        with tempfile.TemporaryDirectory() as d:
            d = Path(d)
            _, steps["write_hf_s"] = timed(write_hf_model, d / "hf", hp,
                                           draw=_card_draw(torch, hp, 37))
            src = mb(*(d / "hf").iterdir())
            f16 = str(d / "f16.bin")
            conv = convert_hf_llama.convert if hp.arch == "llama" else convert_hf.convert
            chp, steps["convert_s"] = timed(conv, str(d / "hf"), f16, "f16", log=quiet)
            steps["mb_in_out"] = [src, mb(f16)]
            lora = None
            if hp.arch == "llama":
                if chp.n_rot != 128:
                    raise RuntimeError(f"the converted LLaMA's n_rot {chp.n_rot}")
                load, kw = f16, {}
            else:
                q4 = str(d / "q4_0.bin")
                _, steps["quantize_s"] = timed(quantize_file, f16, q4, "q4_0", log=quiet)
                steps["quantize_mb_in_out"] = [mb(f16), mb(q4)]
                n_qkv = (hp.n_head + 2 * hp.n_head_kv) * hp.head_dim
                targets = {f"transformer.h.{i}.{k}.weight": shape for i in range(hp.n_layer)
                           for k, shape in (("self_attention.query_key_value", (n_qkv, hp.n_embd)),
                                            ("mlp.dense_4h_to_h", (hp.n_embd, hp.n_ff)))}
                write_peft_adapter(d / "peft", targets, r=16, alpha=32, seed=41)
                lora = str(d / "adapter.ggla")
                _, steps["convert_lora_s"] = timed(convert_lora.convert, str(d / "peft"), lora,
                                                   base=str(d / "hf"))
                steps["lora_mb_in_out"] = [mb(*(d / "peft").iterdir()), mb(lora)]
                load, kw = q4, {"lora": lora, "lora_base": f16}
            torch.cuda.synchronize()
            with warnings.catch_warnings():  # --lora-base: no quantized-patch warning
                warnings.filterwarnings("error", message="applying a LoRA adapter")
                (mf, params), steps["load_s"] = timed(load_model, load, EngineConfig(), **kw)
        if lora and not (isinstance(params["layers"][0]["ffn_up"], QuantTensor)
                         and not isinstance(params["layers"][-1]["wqkv"], QuantTensor)):
            raise RuntimeError("the patched q4_0 tree's layers: "
                               f"{ {k: type(v).__name__ for k, v in params['layers'][0].items()} }")
        eng = FalconEngine(mf.hparams, params, EngineConfig())
        plain = FalconEngine(mf.hparams, params, EngineConfig(kernel_layout=False,
                                                              flash_attention=False))
        build.launch_counts.clear()
        rel, rel_d, _ = _held(eng, plain, prompt)
        del plain
        eng.reset()
        ids = eng.generate(prompt, 17, SamplerParams(temp=0.0), stop_ids=set())
        counts = dict(build.launch_counts)
        for name, c in counts.items():
            out["launches"][name] = out["launches"].get(name, 0) + c
        graph = eng.chunk_graph(16, SamplerParams(temp=0.0)) is not None
        decode = "flash_decode.mha" if hp.arch == "llama" else "flash_decode_tc"
        need = ["flash_mqa.tc", decode] + (["quant_matmul.gemv", "quant_matmul.tc"] if lora else [])
        log(f"  convert {model} {hp.n_layer} layers: {steps}; n_rot {getattr(chp, 'n_rot', '-')};"
            f" prefill logits {rel:.3e} and a decode step's {rel_d:.3e} of max |plain|; 16 greedy"
            f" ids through the decode graph ({graph}); launches {counts}")
        if (rel > LOGIT_TOL or rel_d > LOGIT_TOL or not graph or len(ids) != 17
                or any(counts.get(k, 0) <= 0 for k in need)):
            raise RuntimeError(f"the converted {model}: logits {rel}, {rel_d}; graph {graph};"
                               f" launches {counts}")
        out[model] = {**steps, "logit_rel_err": rel, "decode_logit_rel_err": rel_d}
        del eng, params, mf
        torch.cuda.empty_cache()
    return out


def phase_grammar(torch, eng, hp) -> dict:
    """Grammar-constrained decoding on the single stream (engine/generator.py
    over decode_chunk_masked) at full width and depth, from a 300-token
    prompt, the vocabulary make_tiny_vocab's at n_vocab: 64 greedy ids
    (the end of text banned) under `root ::= [0-9]+` and under JSON_GBNF
    through the masked graphs must equal the eager masked step body's, each
    accepted by a fresh GrammarSampler; at least one 16-step masked chunk
    must have been rolled back at a state change or the run's end; the
    unmasked greedy 16-step graph of the main path must hold
    UNMASKED_GRAPH_NODES nodes; a sampled digit run (temperature 0.8, top-k
    40, top-p 0.95, repeat penalty 1.1) must stay in the grammar. Prints
    grammar tok/s (the graphs' captures apart, the host's valid_bits walks
    included) beside the unmasked Generator's on the same prompt and
    sampler, and the host ms of valid_bits at n_vocab (a new state, the JSON
    string's interior, a cached state). The unmasked and the eager runs come
    first; the launch counts are those of the masked graphs' runs alone
    (their prefills, host-path first ids and masked chunks), which must have
    launched the tile, the GEMV and both attention kernels."""
    from ggllm_tpu_torch.engine.generator import Generator
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.ops.grammar import GrammarSampler, build_token_trie, parse_gbnf
    from ggllm_tpu_torch.ops.sampling import SamplerParams
    from ggllm_tpu_torch.tools.time_kernels import graph_nodes
    from ggllm_tpu_torch.utils.synthetic import make_tiny_vocab

    import numpy as np

    pieces, eos = make_tiny_vocab(hp.n_vocab).id_to_token, 11
    main_graph = eng.chunk_graph(16, SamplerParams(temp=0.0))
    if main_graph is None:
        raise RuntimeError("the main path's greedy 16-step graph is not in the engine")
    nodes = graph_nodes(main_graph.graph)
    t0 = time.perf_counter()
    trie = build_token_trie(pieces, eos)
    trie_ms = (time.perf_counter() - t0) * 1e3
    prompt = [int(t) for t in np.random.default_rng(3).integers(12, hp.n_vocab, 300)]
    greedy = SamplerParams(temp=0.0, repeat_penalty=1.0, logit_bias={eos: float("-inf")})
    sampled = SamplerParams(temp=0.8, top_k=40, top_p=0.95, repeat_penalty=1.1, seed=5,
                            logit_bias={eos: float("-inf")})

    def run(text, sampler, eager=False, n=64):
        gs = None if text is None else GrammarSampler(parse_gbnf(text), pieces, eos, trie=trie)
        eng.reset()
        gen = Generator(eng, sampler, eos, grammar=gs)
        gen.eager = eager
        logits = gen.prefill(prompt)
        toks = []
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), eng.timings.t_compile_us
        gen.generate(logits, n, lambda t: toks.append(t) or True)
        # the first use of a sampler key captures its graphs: not decode time
        tps = len(toks) / (time.perf_counter() - t0 - (eng.timings.t_compile_us - c0) / 1e6)
        if len(toks) != n:
            raise RuntimeError(f"grammar run {text!r}: {len(toks)} ids of {n}")
        if text is not None:
            check = GrammarSampler(parse_gbnf(text), pieces, eos, trie=trie)
            for t in toks:
                check.accept(t)  # GrammarError if an id left the grammar
        return toks, tps, gen.masked_stats

    _, plain_tps, _ = run(None, greedy)
    out = {"unmasked_tok_s": plain_tps, "unmasked_graph_nodes": nodes, "trie_ms": trie_ms}
    eager = {name: run(text, greedy, eager=True) for name, text in GRAMMARS}
    build.launch_counts.clear()  # the masked graphs' runs from here
    greedy_ids = {}
    for name, text in GRAMMARS:
        ids, tps, stats = greedy_ids[name] = run(text, greedy)
        eager_ids, eager_tps, _ = eager[name]
        if ids != eager_ids:
            raise RuntimeError(f"{name} grammar: the masked graphs' ids differ from the eager"
                               f" masked step body's:\n{ids}\n{eager_ids}")
        text_out = b"".join(pieces[t] for t in ids)
        out[name] = {"tok_s": tps, "eager_tok_s": eager_tps, "stats": dict(stats),
                     "text": text_out[:80].decode("utf-8", "replace")}
        log(f"  grammar {name}: 64 greedy ids, masked graphs = eager masked body, all accepted;"
            f" {tps:.2f} tok/s (eager {eager_tps:.2f}; unmasked Generator {plain_tps:.2f});"
            f" masked dispatches {stats}; text {out[name]['text']!r}")
    if not any(out[k]["stats"]["chunks"] and out[k]["stats"]["rolled_back"]
               for k in ("digits", "json")):
        raise RuntimeError(f"no 16-step masked chunk was rolled back: {out}")
    if not all(pieces[t].isdigit() for t in greedy_ids["digits"][0]):
        raise RuntimeError("greedy digit run left the digits")
    ids, tps, stats = run(DIGITS, sampled)
    if not all(pieces[t].isdigit() for t in ids):
        raise RuntimeError(f"sampled digit run left the digits: {ids}")
    out["digits_sampled"] = {"tok_s": tps, "stats": dict(stats)}
    counts = dict(build.launch_counts)
    masked = eng.chunk_graph(16, greedy, masked=True)
    out["masked_graph_nodes"] = None if masked is None else graph_nodes(masked.graph)
    log(f"  grammar sampled digits (temp 0.8): 64 ids in the grammar, {tps:.2f} tok/s; unmasked"
        f" greedy 16-step graph {nodes} nodes (want"
        f" {UNMASKED_GRAPH_NODES}), masked 16-step graph {out['masked_graph_nodes']}")
    # the host's part: valid_bits at the full vocabulary
    ms = {}
    for label, text, prefix in (("digits, new state", DIGITS, b""),
                                ("json, new state", JSON_GBNF, b""),
                                ("json, string interior", JSON_GBNF, b'{"')):
        gs = GrammarSampler(parse_gbnf(text), pieces, eos, trie=trie)
        for b in prefix:
            gs.accept(pieces.index(bytes([b])))
        t0 = time.perf_counter()
        gs.valid_bits()
        t1 = time.perf_counter()
        gs.valid_bits()
        ms[label] = {"ms": (t1 - t0) * 1e3, "cached_ms": (time.perf_counter() - t1) * 1e3,
                     "valid": int(gs.valid_token_ids().size)}
    out["valid_bits_ms"] = ms
    log(f"  valid_bits at V = {hp.n_vocab} on the host: {ms}; the token trie built in"
        f" {trie_ms:.1f} ms")
    log(f"  launches of the masked graphs' runs: {counts}")
    for name in ("quant_matmul.gemv", "quant_matmul.tc", "flash_mqa.tc", "flash_decode_tc"):
        if counts.get(name, 0) <= 0:
            raise RuntimeError(f"kernel {name} was not launched on the grammar path")
    if nodes != UNMASKED_GRAPH_NODES:
        raise RuntimeError(f"the unmasked greedy graph holds {nodes} nodes,"
                           f" not {UNMASKED_GRAPH_NODES}")
    eng.reset()
    return {"path": "falcon7b q4_0 grammar, single stream", "launches": counts, **out}


def phase_server_parallel(torch, eng4, eng1, hp) -> dict:
    """The server with --parallel 4 (server/app.py serve(parallel=4,
    chunk=16, prefill_chunk=256)) over the batching phase's 4-row engine
    `eng4`, on 127.0.0.1 at a free port: 8 requests sent at once from
    threads (4 greedy at repeat penalty 1, 2 sampled at the server's
    defaults, 1 under `root ::= [0-9]+` with ignore_eos, 1 greedy streamed)
    and beside them a top-k 100 request and a bad grammar, which must get
    HTTP 400 while the others complete; twice, the first burst warming the
    server (graph captures, the token trie), the second measured and held
    to what follows. The batcher's Requests are recorded
    at submit: every greedy request's ids (the streamed one's too) within
    ROWS_LOGIT_TOL of the batch-1 engine `eng1` with its ids forced
    (_against_single), the grammar request's content digits, the stream's
    chunks the pieces of its request's ids, /metrics the requests sent;
    the rows kernel and flash_decode_tc ran and no GEMV. Then 4 greedy
    requests at once, and 3 with one grammar request: aggregate tok/s of
    each (tokens over the wall time, admission included)."""
    import concurrent.futures
    import threading
    import urllib.error

    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.server.app import serve
    from ggllm_tpu_torch.utils.synthetic import make_tiny_vocab

    vocab = make_tiny_vocab(hp.n_vocab)
    httpd = serve(eng4, vocab, "127.0.0.1", 0, parallel=4, alias="falcon-7b-q4_0-random",
                  chunk=16, prefill_chunk=256)
    state = httpd.state
    submitted, submit = [], state.batcher.submit

    def record(req):
        submitted.append(req)
        return submit(req)

    state.batcher.submit = record
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    text = ("the thing and the other thing went south, and then it went north again. " * 4)

    def prompt(i: int, n: int = 60) -> str:
        return f"request {i}: " + text[i * 7:i * 7 + n]

    greedy = {"n_predict": 64, "temperature": 0, "repeat_penalty": 1.0}
    bodies = ([{"prompt": prompt(i, 40 + 40 * i), **greedy} for i in range(4)]
              + [{"prompt": prompt(4 + i), "n_predict": 64, "seed": i} for i in range(2)]
              + [{"prompt": prompt(6), "n_predict": 32, "temperature": 0,
                  "repeat_penalty": 1.0, "grammar": DIGITS, "ignore_eos": True}]
              + [{"prompt": prompt(7, 200), **greedy}])
    bad = [{"prompt": prompt(8), "n_predict": 8, "temperature": 0.8, "top_k": 100},
           {"prompt": prompt(9), "n_predict": 8, "grammar": "root ::= [z-a]"}]

    def call(body, stream=False):
        try:
            return 200, _http(url, "/completion", body, stream=stream)
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def burst(batch, streamed=()):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(batch)) as ex:
            futs = [ex.submit(call, b, i in streamed) for i, b in enumerate(batch)]
            got = [f.result() for f in futs]
        return got, time.perf_counter() - t0

    try:
        # a first burst of the same requests captures the B-row graphs of
        # their keys and builds the grammar's token trie (the server's
        # one-time costs); the second is the measured one
        cold, cold_wall = burst(bodies + bad, streamed={7})
        cold_ms = [r["timings"]["prompt_ms"] for _, r in cold[:7]]
        log(f"  --parallel 4, first burst: {cold_wall:.3f} s, prompt_ms {cold_ms} (captures of"
            f" the requests' B-row graph keys, {eng4.timings.t_compile_us / 1e3:.1f} ms of capture"
            f" in the engine so far, and the grammar's token trie)")
        submitted.clear()
        build.launch_counts.clear()
        got, wall = burst(bodies + bad, streamed={7})
        counts = dict(build.launch_counts)
        codes = [c for c, _ in got]
        if codes != [200] * 8 + [400, 400]:
            raise RuntimeError(f"--parallel 4: HTTP codes {codes}: {got}")
        if not got[9][1]["error"].startswith("bad grammar") or "top_k" not in got[8][1]["error"]:
            raise RuntimeError(f"--parallel 4: the 400s' reasons: {got[8:]}")
        finals = [r for _, r in got[:7]] + [got[7][1][-1]]
        by_prompt = {tuple(r.prompt_ids): r for r in submitted}
        reqs = [by_prompt[tuple(state.tk.tokenize(b["prompt"], bos=True))] for b in bodies]
        if any(r.error is not None for r in reqs):
            raise RuntimeError(f"--parallel 4: failed requests {[r.error for r in reqs]}")
        n_tokens = sum(f["tokens_predicted"] for f in finals)
        if finals[6]["tokens_predicted"] != 32 or not finals[6]["content"].isdigit():
            raise RuntimeError(f"--parallel 4: the grammar request answered {finals[6]}")
        streamed = "".join(e["content"] for e in got[7][1][:-1])
        want = "".join(vocab.id_to_token[t].decode("utf-8", "replace") for t in reqs[7].out
                       if t != 11)
        if streamed != want or not got[7][1][-1]["stop"]:
            raise RuntimeError(f"--parallel 4: the stream {streamed!r} is not its ids' {want!r}")
        metrics = _http(url, "/metrics")
        cold_finals = [r for _, r in cold[:7]] + [cold[7][1][-1]]
        want_m = {"requests_total": 16,
                  "prompt_tokens_total": sum(f["tokens_evaluated"]
                                             for f in finals + cold_finals),
                  "generated_tokens_total": n_tokens + sum(f["tokens_predicted"]
                                                           for f in cold_finals)}
        for name, n in want_m.items():
            if f"ggllm_{name} {n}\n" not in metrics:
                raise RuntimeError(f"--parallel 4: /metrics lacks ggllm_{name} {n}:\n{metrics}")
        log(f"  --parallel 4: 8 requests and 2 refused (400: {got[8][1]['error']!r},"
            f" {got[9][1]['error']!r}) at once: {n_tokens} tokens in {wall:.3f} s,"
            f" {n_tokens / wall:.2f} tok/s aggregate; /metrics {want_m}")
        names = ["greedy 0", "greedy 1", "greedy 2", "greedy 3", "sampled 4", "sampled 5",
                 "grammar 6", "streamed 7"]
        per_request = {}
        for name, f in zip(names, finals):
            t = f["timings"]
            per_request[name] = {"tokens_evaluated": f["tokens_evaluated"],
                                 "tokens_predicted": f["tokens_predicted"],
                                 "prompt_ms": t["prompt_ms"],
                                 "predicted_per_second": t["predicted_per_second"]}
            log(f"  --parallel 4 {name}: {f['tokens_evaluated']} evaluated,"
                f" {f['tokens_predicted']} predicted, prompt_ms {t['prompt_ms']},"
                f" predicted_per_second {t['predicted_per_second']}")
        log(f"  launches on the --parallel 4 path: {counts}")
        for name in ("quant_matmul.rows", "flash_decode_tc"):
            if counts.get(name, 0) <= 0:
                raise RuntimeError(f"kernel {name} was not launched on the --parallel 4 path")
        if counts.get("quant_matmul.gemv", 0) or counts.get("quant_matmul.gemv.kq", 0):
            raise RuntimeError(f"a one-row GEMV ran on the --parallel 4 path: {counts}")
        # aggregate rate with and without a grammar row among 4 requests
        agg = {}
        four = [{"prompt": prompt(10 + i, 120), **greedy} for i in range(4)]
        with_grammar = four[:3] + [{**bodies[6], "prompt": prompt(14, 120), "n_predict": 64}]
        for label, batch in (("4 greedy", four), ("3 greedy + 1 grammar", with_grammar)):
            res, w = burst(batch)
            if any(c != 200 for c, _ in res):
                raise RuntimeError(f"--parallel 4, {label}: {res}")
            n = sum(r["tokens_predicted"] for _, r in res)
            agg[label] = {"tokens": n, "wall_s": w, "tok_s": n / w}
        log(f"  --parallel 4 aggregate, 4 requests of 64 tokens at once: " + "; ".join(
            f"{k} {v['tok_s']:.2f} tok/s ({v['tokens']} tokens in {v['wall_s']:.3f} s)"
            for k, v in agg.items()))
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
        state.thread.join(timeout=60)
    single = {}
    for i in (0, 1, 2, 3, 7):
        single[names[i]] = _against_single(eng1, reqs[i].prompt_ids, reqs[i].out,
                                           f"--parallel 4 {names[i]}", ROWS_LOGIT_TOL)
    return {"path": "falcon7b q4_0 server --parallel 4", "launches": counts,
            "aggregate_tok_s": n_tokens / wall, "wall_s": wall, "requests": per_request,
            "first_burst_wall_s": cold_wall, "first_burst_prompt_ms": cold_ms,
            "aggregate_4": agg, "greedy_vs_single": single}


def phase_scores(torch, eng, params, hp, logit_scale: float) -> list[dict]:
    """Perplexity and embeddings on a full-width engine (bf16 cache, n_ctx
    2048) through the kernels, against the plain versions on the same
    weights: perplexity over 2 chunks of n_ctx from token ids of a seed
    (log-softmax gather on the card), timed per 512-token piece of the first
    chunk at n_past 0 … 1536; the first chunk's log-probs through the plain
    versions (max |Δ| ≤ LP_TOL = 2 · LOGIT_TOL · logit_scale, the max |logit|
    of the path's plain prefill: a log-softmax moves by at most twice the
    largest logit change) and the chunk's log-perplexities within LP_TOL;
    embed() of a 700-token prompt (one eval chunk, then the output_hidden
    forward) within LOGIT_TOL of max |h| of the plain path's; then the
    perplexity of the first chunk on an int8 cache, timed, and that chunk's
    log-probs on the int8 cache against the plain versions on an int8 cache
    (max |Δ| ≤ LP_TOL; the ratio of the two perplexities is only printed:
    with random weights and targets it hardly depends on the hidden state).
    Returns the paths' launch counts and figures."""
    import math

    import numpy as np

    from ggllm_tpu_torch.core.config import EngineConfig
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.engine.perplexity import perplexity
    from ggllm_tpu_torch.kernels import build

    lp_tol = 2 * LOGIT_TOL * logit_scale
    n_ctx = eng.cfg.n_ctx
    rng = np.random.default_rng(11)
    toks = rng.integers(12, hp.n_vocab, 2 * n_ctx + 1)
    prompt = [int(t) for t in rng.integers(12, hp.n_vocab, 700)]
    build.launch_counts.clear()
    eng.timings = type(eng.timings)()
    res = perplexity(eng, toks, max_chunks=2)
    ppl_tps = eng.timings.n_prefill / (eng.timings.t_prefill_us / 1e6)
    eng.reset()
    chunk, lp, piece_tps = toks[:n_ctx], [], []
    for i in range(0, n_ctx, eng.cfg.n_batch):  # the first chunk, timed per piece
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lp.append(eng._eval_chunk_logprobs(chunk[i:i + eng.cfg.n_batch],
                                           chunk[i + 1:i + 1 + eng.cfg.n_batch]))
        piece_tps.append(eng.cfg.n_batch / (time.perf_counter() - t0))
    lp = np.concatenate(lp)
    eng.reset()
    emb = eng.embed(prompt)
    counts = dict(build.launch_counts)

    plain = FalconEngine(hp, params, EngineConfig(kernel_layout=False, flash_attention=False))
    lp_plain = plain.eval_logprobs(chunk)
    res_plain = perplexity(plain, toks, max_chunks=1)
    plain.reset()
    emb_plain = plain.embed(prompt)
    del plain
    first_j = min(512, n_ctx // 2)
    lp_err = float(np.abs(lp - lp_plain).max())
    dlog_ppl = abs(math.log(res.per_chunk[0] / res_plain.ppl))
    emb_rel = float(np.abs(emb - emb_plain).max()) / float(np.abs(emb_plain).max())
    nll_check = abs(-lp[first_j:].astype(np.float64).mean() - math.log(res.per_chunk[0]))

    eng8 = FalconEngine(hp, params, EngineConfig(kv_dtype="int8"))
    build.launch_counts.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res8 = perplexity(eng8, toks, max_chunks=1)
    int8_s = time.perf_counter() - t0
    counts8 = dict(build.launch_counts)
    eng8.reset()
    lp8 = eng8.eval_logprobs(chunk)
    del eng8
    plain8 = FalconEngine(hp, params, EngineConfig(kv_dtype="int8", kernel_layout=False,
                                                   flash_attention=False))
    lp8_plain = plain8.eval_logprobs(chunk)
    del plain8
    lp8_err = float(np.abs(lp8 - lp8_plain).max())
    dlog_ppl8 = abs(math.log(res8.ppl / res_plain.ppl))
    log(f"  perplexity, 2 chunks of {n_ctx} (kernels): {res.ppl:.4f} (chunk 1 {res.per_chunk[0]:.4f});"
        f" plain versions, chunk 1: {res_plain.ppl:.4f}; |log ratio| {dlog_ppl:.3e} (limit"
        f" {lp_tol:.3e}); prefill {ppl_tps:.1f} tok/s; per 512-token piece at n_past 0, 512, 1024,"
        f" 1536: {', '.join(f'{t:.1f}' for t in piece_tps)} tok/s")
    log(f"  log-probs of chunk 1, kernels vs plain versions: max |d| {lp_err:.4e} (limit"
        f" {lp_tol:.4e} = 2 * {LOGIT_TOL} * max|logit| {logit_scale:.4f}); piecewise NLL vs"
        f" perplexity() {nll_check:.2e}")
    log(f"  embed() of {len(prompt)} tokens, kernels vs plain versions: max |d| / max |h|"
        f" {emb_rel:.3e} (limit {LOGIT_TOL})")
    log(f"  perplexity of chunk 1 on an int8 cache: {res8.ppl:.4f} in {int8_s * 1e3:.1f} ms"
        f" ({n_ctx / int8_s:.1f} tok/s); |log ratio| to the plain bf16 one {dlog_ppl8:.3e};"
        f" log-probs against the plain versions on an int8 cache: max |d| {lp8_err:.4e} (limit"
        f" {lp_tol:.4e}); launches {counts8}")
    log(f"  launches on the perplexity / embedding path: {counts}")
    finite = all(math.isfinite(v) for v in (res.ppl, res_plain.ppl, res8.ppl))
    if (not finite or not np.isfinite(lp).all() or not np.isfinite(emb).all()
            or not np.isfinite(lp8).all() or lp8.shape != lp.shape
            or lp.shape != (n_ctx - 1,) or emb.shape != (hp.n_embd,)
            or lp_err > lp_tol or dlog_ppl > lp_tol or lp8_err > lp_tol
            or emb_rel > LOGIT_TOL or nll_check > 1e-6):
        raise RuntimeError("perplexity / embedding through the kernels disagree with the plain"
                           " versions")
    for name, c in (("perplexity / embedding", counts), ("int8 perplexity", counts8)):
        for k in ("quant_matmul.tc", "flash_mqa.tc"):
            if c.get(k, 0) <= 0:
                raise RuntimeError(f"kernel {k} was not launched on the {name} path")
        if any(c.get(k, 0) for k in F32_KERNELS):
            raise RuntimeError(f"an f32 kernel ran on the {name} path: {c}")
    return [{"path": "falcon7b q4_0 perplexity / embedding", "launches": counts,
             "ppl": res.ppl, "ppl_plain_chunk1": res_plain.ppl, "lp_max_abs_err": lp_err,
             "lp_tol": lp_tol, "prefill_tok_s": ppl_tps, "piece_tok_s": piece_tps,
             "embed_rel_err": emb_rel},
            {"path": "falcon7b q4_0 int8 perplexity", "launches": counts8, "ppl": res8.ppl,
             "ms": int8_s * 1e3, "lp_max_abs_err": lp8_err, "lp_tol": lp_tol}]


def _cli_in_process(args: list) -> bytes:
    """The CLI's standard output for `args`, run in this process."""
    import io

    from ggllm_tpu_torch.tools import main as cli

    out, saved = io.BytesIO(), (sys.stdout, sys.stderr)
    sys.stdout, sys.stderr = io.TextIOWrapper(out, write_through=True), io.StringIO()
    try:
        rc = cli.main(args)
        sys.stdout.flush()
        text = out.getvalue()
    finally:
        sys.stdout, sys.stderr = saved
    if rc != 0:
        raise RuntimeError(f"the CLI in this process returned {rc}")
    return text


def start_cli(d: str) -> dict:
    """Write the CLI's small files of both families into `d` and start the
    CLI on them, all processes at once (their output goes to files in `d`);
    on the Falcon Q4_0 file also a context swap (-c 128 --keep 16 -n 200),
    the prompt from a file (-f, which must print what -p prints) and a
    reverse prompt (-r with -n 40: the last bytes of the 16 tokens that -p
    -n 16 prints, taken from a run in this process, and it must stop
    there). Returns what check_cli needs."""
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
    greedy = ["--temp", "0", "--ignore-eos"]
    cmds = []
    for family, fmt, hp, extra in cases:
        path = str(Path(d) / f"small-{family}-{fmt}.{'ggjt' if family == 'llama' else 'ggcc'}")
        write = write_tiny_llama if family == "llama" else write_tiny_model
        write(path, hp, GGMLType[fmt.upper()], seed=3)
        cmds.append(["-m", path, "-p", "the thing", "-n", "16", *greedy, *extra])
    q4_0 = cmds[0][1]
    base = _cli_in_process(cmds[0])
    # the antiprompt ends where the 16th token does (the CLI ends with one newline)
    anti = base[len(b"the thing"):-1][-12:]
    prompt_file = Path(d) / "prompt.txt"
    prompt_file.write_text("the thing")
    cmds += [["-m", q4_0, "-p", "the thing", "-c", "128", "--keep", "16", "-n", "200", *greedy],
             ["-m", q4_0, "-f", str(prompt_file), "-n", "16", *greedy],
             ["-m", q4_0, "-p", "the thing", "-n", "40", "--reverse-prompt=" + os.fsdecode(anti),
              *greedy]]
    # --prompt-cache twice (the second run starts when the first has ended)
    # and a draft model (the 40B-style Q4_K file, same vocabulary); then the
    # flags of the slice after: --mtest with --alias, -dt 1 over 64 tokens,
    # --weight-mode dequant, --export and the reference's ignored thread /
    # VRAM flags
    cached = ["-m", q4_0, "-p", "the thing and the other thing", "-n", "16", *greedy,
              "--prompt-cache", str(Path(d) / "cli.session")]
    named = {"swap": len(cases), "-f": len(cases) + 1, "-r": len(cases) + 2}
    for name, cmd in (
            ("cache", cached),
            ("draft", ["-m", q4_0, "-p", "the thing", "-n", "24", "--temp", "0",
                       "--repeat-penalty", "1", "--draft-model", cmds[1][1]]),
            ("mtest", ["-m", q4_0, "--mtest", "--alias", "small-falcon-q4_0"]),
            ("dt", ["-m", q4_0, "-p", "the thing", "-n", "64", *greedy, "-dt", "1"]),
            ("dequant", ["-m", q4_0, "-p", "the thing", "-n", "16", *greedy,
                         "--weight-mode", "dequant"]),
            ("export", ["-m", q4_0, "--export", str(Path(d) / "fwd.txt")]),
            ("compat", ["-m", q4_0, "-p", "the thing", "-n", "16", *greedy, "-t", "8",
                        "-ngl", "100"])):
        named[name] = len(cmds)
        cmds.append(cmd)
    named["cache2"] = len(cmds)  # started when the first --prompt-cache run has ended
    run = {"dir": d, "cases": cases, "base": base, "anti": anti, "procs": [], "named": named,
           "then": {named["cache"]: cached}, "q4_0": q4_0}
    for cmd in cmds:
        _start_cli_process(run, cmd)
    return run


def start_cli_180b(torch, d: str) -> dict:
    """Falcon-180B for the CLI: a 2-layer, full-width Q2_K GGCC file written by
    the port's writer (_write_tree_file) from a seeded tree built on the card
    (the embedding in f16), then the CLI started on it with -ts auto and 16
    greedy ids (its output into d/180b). Returns what check_cli_180b needs."""
    import dataclasses
    import gc

    from ggllm_tpu_torch.core.config import named_hparams
    from ggllm_tpu_torch.core.dtypes import GGMLType
    from ggllm_tpu_torch.utils.benchgen import make_bench_params

    hp = dataclasses.replace(named_hparams("falcon180b"), n_layer=2)
    t0 = time.perf_counter()
    params = make_bench_params(hp, device="cuda", seed=11, gtype=GGMLType.Q2_K)
    path = str(Path(d) / "falcon180b-2-layers-q2_k.ggcc")
    _write_tree_file(path, params, hp, f16_embedding=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  a 2-layer full-width Falcon-180B Q2_K file: {os.path.getsize(path) / 1e6:.1f} MB,"
        f" written in {time.perf_counter() - t0:.1f} s")
    run = {"dir": str(Path(d) / "180b"), "procs": [], "then": {}, "path": path}
    Path(run["dir"]).mkdir()
    _start_cli_process(run, ["-m", path, "-p", "the thing", "-n", "16", "--temp", "0",
                             "--ignore-eos", "-ts", "auto"])
    return run


LONG_WORDS = ("the", "thing", "and", "other", "in", "an", "ring", "her", "out", "that",
              "sound", "there", "ten", "tan", "hour")


def start_cli_16k(torch, d: str) -> dict:
    """The CLI at -c 16384 -b 2048 on a 2-layer, full-width Falcon-7B Q4_0
    GGCC file (_write_params_file from a seeded tree built on the card) with
    a prompt of a few thousand tokens from -f (words drawn from a seed): 64
    ids at --temp 0 (repeat penalty 1, EOS banned), and 16 ids with the
    temperature left at its default, which the CLI derates to 0.5 at this
    context, and --top-k 1 (greedy too). Their output goes into d/16k.
    Returns what check_cli_16k needs."""
    import dataclasses
    import gc

    import numpy as np

    from ggllm_tpu_torch.core.config import named_hparams
    from ggllm_tpu_torch.core.dtypes import GGMLType
    from ggllm_tpu_torch.utils.benchgen import make_bench_params

    hp = dataclasses.replace(named_hparams("falcon7b"), n_layer=2)
    t0 = time.perf_counter()
    params = make_bench_params(hp, device="cuda", seed=16, gtype=GGMLType.Q4_0)
    path = str(Path(d) / "falcon7b-2-layers-q4_0.ggcc")
    _write_params_file(path, params, hp)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    run = {"dir": str(Path(d) / "16k"), "procs": [], "then": {}, "path": path}
    Path(run["dir"]).mkdir()
    run["prompt"] = str(Path(run["dir"]) / "prompt.txt")
    words = np.random.default_rng(16384).choice(LONG_WORDS, 2400)
    Path(run["prompt"]).write_text(" ".join(words))
    log(f"  a 2-layer full-width Falcon-7B Q4_0 file: {os.path.getsize(path) / 1e6:.1f} MB,"
        f" written in {time.perf_counter() - t0:.1f} s; a {len(words)}-word prompt")
    common = ["-m", path, "-f", run["prompt"], "-c", str(LONG_CTX), "-b", str(LONG_BATCH),
              "--repeat-penalty", "1", "--ignore-eos"]
    _start_cli_process(run, [*common, "-n", "64", "--temp", "0"])
    _start_cli_process(run, [*common, "-n", "16", "--top-k", "1"])
    return run


def check_cli_16k(run: dict) -> dict:
    """The two CLI runs of start_cli_16k: each must succeed; the --temp 0
    run's text must be the prompt and the 64 ids of the Generator
    (engine/generator.py) on an engine at the same context, over the same
    file and prompt, greedy with EOS banned; the derated run must print the
    CLI's derating line and the first 16 of those ids. Deletes the file."""
    from ggllm_tpu_torch import tokenizer as tok_mod
    from ggllm_tpu_torch.core.config import EngineConfig
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.engine.generator import Generator
    from ggllm_tpu_torch.io.loader import load_model
    from ggllm_tpu_torch.ops.sampling import SamplerParams

    ((out, err), rc), ((out_d, err_d), rc_d) = wait_cli(run)
    cfg = EngineConfig(n_ctx=LONG_CTX, n_batch=LONG_BATCH)
    mf, params = load_model(run["path"], cfg)
    os.remove(run["path"])
    tk = tok_mod.for_model(mf)
    text = Path(run["prompt"]).read_text()
    ids = tk.tokenize(text, bos=True)
    eng = FalconEngine(mf.hparams, params, cfg)
    gen = Generator(eng, SamplerParams(temp=0.0, repeat_penalty=1.0,
                                       logit_bias={tk.eos_id: float("-inf")}), tk.eos_id)
    got: list = []
    gen.generate(gen.prefill(ids), 64, lambda t: got.append(t) is None)
    want = text.encode() + b"".join(tk.piece(t) for t in got) + b"\n"
    line = f"info: context size {LONG_CTX} is large; reducing default temperature to 0.5"
    derated = line in err_d
    capture = re.search(r"compile time\s*=\s*([0-9.]+) ms", err)
    log(f"  cli -c {LONG_CTX} -b {LONG_BATCH} -f ({len(ids)}-token prompt) --temp 0 rc={rc}:"
        f" {'the Generator' if out == want else 'NOT the Generator'}'s 64 ids; capture"
        f" {capture.group(1) if capture else 'none'} ms; the default temperature rc={rc_d}:"
        f" {'derating line printed' if derated else 'NO derating line'},"
        f" {'its 16 ids the same' if out.startswith(out_d[:-1]) else 'OTHER ids'}")
    if rc or out != want or "eval time" not in err:
        raise RuntimeError(f"CLI at -c {LONG_CTX}: rc {rc}, not the Generator's ids:\n{out[-400:]}"
                           f"\n{want[-400:]}\n{err[-2000:]}")
    if rc_d or not derated or not out_d.endswith(b"\n") or not out.startswith(out_d[:-1]):
        raise RuntimeError(f"CLI at -c {LONG_CTX} with the default temperature: rc {rc_d},"
                           f" derating line {derated}:\n{out_d[-400:]}\n{err_d[-2000:]}")
    del eng, params
    return {"prompt_tokens": len(ids), "ids": len(got), "derated": derated}


def check_cli_180b(run: dict) -> None:
    """The CLI on the 2-layer Falcon-180B file: -ts auto must pick one card,
    and the run print its prompt, 16 ids and its timings; then the file is
    deleted."""
    ((out, err), rc), = wait_cli(run)
    os.remove(run["path"])
    auto = re.search(r"auto tensor split: .*", err)
    load = re.search(r"load time\s*=\s*([0-9.]+) ms", err)
    log(f"  cli falcon180b q2_k (2 layers) -ts auto rc={rc}:"
        f" {auto.group(0) if auto else 'no plan'}; load {load.group(1) if load else '?'} ms;"
        f" stdout={out.strip()[:100]!r}")
    if (rc or not out.startswith(b"the thing") or "eval time" not in err or not auto
            or not auto.group(0).startswith("auto tensor split: 1 chip(s)")):
        raise RuntimeError(f"CLI run on the Falcon-180B file failed:\n{out}\n{err}")


def _start_cli_process(run: dict, cmd: list) -> None:
    i = len(run["procs"])
    with open(Path(run["dir"]) / f"{i}.out", "wb") as out, \
            open(Path(run["dir"]) / f"{i}.err", "wb") as err:
        run["procs"].append(subprocess.Popen(
            [sys.executable, "-m", "ggllm_tpu_torch.tools.main", *cmd], cwd=ROOT,
            stdout=out, stderr=err))


def wait_cli(run: dict) -> list:
    """Wait for start_cli's processes, starting run["then"][i] when process i
    has ended; returns ((stdout bytes, stderr text), rc) each, in the order
    they started."""
    results = []
    i = 0
    while i < len(run["procs"]):
        rc = run["procs"][i].wait(timeout=600)
        results.append(((Path(run["dir"], f"{i}.out").read_bytes(),
                         Path(run["dir"], f"{i}.err").read_text(errors="replace")), rc))
        if i in run["then"]:
            _start_cli_process(run, run["then"][i])
        i += 1
    return results


def check_cli(run: dict, results: list) -> None:
    """The CLI runs of start_cli: each must succeed and print its prompt
    and timings, the Q4_0 run the text of the run in this process, the
    context swap at least one swap, -f and -r the 16 tokens of -p -n 16,
    the second --prompt-cache run the first's text with reused prompt
    tokens, the --draft-model run its acceptance report."""
    cases, base, anti = run["cases"], run["base"], run["anti"]

    def compile_ms(err: str) -> str:  # the CLI's decode-graph capture time
        m = re.search(r"compile time\s*=\s*([0-9.]+) ms", err)
        return m.group(1) if m else "none"

    for (family, fmt, _, extra), ((out, err), rc) in zip(cases, results):
        log(f"  cli {family} {fmt} {' '.join(extra)} rc={rc} capture {compile_ms(err)} ms"
            f" stdout={out.strip()[:100]!r}")
        if rc != 0 or not out.startswith(b"the thing") or "eval time" not in err:
            raise RuntimeError(f"CLI run on a {family} {fmt} file failed:\n{out}\n{err}")
    if results[0][0][0] != base:
        raise RuntimeError(f"the CLI printed other text in this process:\n{base}\n"
                           f"{results[0][0][0]}")
    got = {name: results[i] for name, i in run["named"].items()}
    (out, err), rc = got["swap"]
    swaps = err.count("context swap: kept")
    log(f"  cli context swap (-c 128 --keep 16 -n 200) rc={rc}: {swaps} swap(s), {len(out)} bytes"
        f" out, capture {compile_ms(err)} ms")
    if rc != 0 or not swaps or not out.startswith(b"the thing") or "eval time" not in err:
        raise RuntimeError(f"CLI context swap run failed:\n{out}\n{err}")
    for what, ((out, err), rc) in (("-f", got["-f"]), (f"-r {anti!r} with -n 40", got["-r"]),
                                   ("-t 8 -ngl 100 (ignored)", got["compat"])):
        same = out == base
        log(f"  cli {what} rc={rc}: {'the 16 tokens of -p -n 16' if same else 'another output'},"
            f" capture {compile_ms(err)} ms")
        if rc != 0 or not same:
            raise RuntimeError(f"CLI {what} run failed or printed other text than -p -n 16:\n"
                               f"{out}\n{base}\n{err}")
    (out1, err1), rc1 = got["cache"]
    (out2, err2), rc2 = got["cache2"]
    reused = re.search(r"session: reused (\d+) prompt tokens", err2)
    log(f"  cli --prompt-cache rc={rc1}, {rc2}: the second run reused"
        f" {reused.group(1) if reused else 'no'} prompt tokens,"
        f" {'the same' if out1 == out2 else 'other'} output")
    if rc1 or rc2 or "session: reused" in err1 or not reused or out1 != out2:
        raise RuntimeError(f"CLI --prompt-cache runs:\n{out1}\n{err1}\n{out2}\n{err2}")
    (out, err), rc = got["draft"]
    stats = re.search(r"speculative: \d+ tokens in (\d+) rounds.*", err)
    log(f"  cli --draft-model rc={rc}: {stats.group(0) if stats else 'no speculative report'},"
        f" stdout={out.strip()[:80]!r}")
    if rc or not out.startswith(b"the thing") or not stats or not int(stats.group(1)):
        raise RuntimeError(f"CLI --draft-model run failed:\n{out}\n{err}")
    (out, err), rc = got["mtest"]
    mem = re.search(r"mtest: ([0-9.]+) MiB allocated, peak ([0-9.]+) MiB", err)
    log(f"  cli --mtest --alias rc={rc}: {mem.group(0) if mem else 'no memory line'};"
        f" {'alias reported' if 'model alias: small-falcon-q4_0' in err else 'no alias'}")
    if (rc or out or not mem or "model alias: small-falcon-q4_0" not in err
            or "batch eval time" not in err or "eval time" not in err):
        raise RuntimeError(f"CLI --mtest run failed:\n{out}\n{err}")
    (out, err), rc = got["dt"]
    table = err[err.find("op "):err.find("TOTAL")]
    kernels = [line[:60].strip() for line in table.splitlines()[1:] if line.strip()]
    log(f"  cli -dt 1 rc={rc}: the op table's top rows {kernels}")
    if (rc or not out.startswith(base[:-1]) or not any("quant_gemv" in k for k in kernels)
            or not any("decode_tc_kernel" in k for k in kernels)):
        raise RuntimeError(f"CLI -dt 1 run failed or its table lists no quant_matmul and"
                           f" flash_decode kernel:\n{out}\n{err}")
    (out, err), rc = got["export"]
    path = Path(run["dir"]) / "fwd.txt"
    text = path.read_text() if path.exists() else ""
    ops = {op: text.count(f"torch.ops.ggllm.{op}.default(") for op in ("quant_matmul", "flash_mqa")}
    log(f"  cli --export rc={rc}: {err.strip().splitlines()[-1] if err.strip() else ''};"
        f" {len(text)} characters, nodes {ops}")
    if (rc or f"forward graph (torch.export) exported to {path}" not in err
            or not all(ops.values()) or out.strip()):
        raise RuntimeError(f"CLI --export did not write the forward graph:\n{out}\n{err}")
    (out, err), rc = got["dequant"]
    if rc or not out.startswith(b"the thing"):
        raise RuntimeError(f"CLI --weight-mode dequant run failed:\n{out}\n{err}")
    _dequant_ids(run["q4_0"], out == base)


def _dequant_ids(path: str, same_text: bool) -> None:
    """--weight-mode dequant on a small file: 16 greedy ids of the dequantized
    engine held to the fused engine's logits with the ids forced, within
    ROWS_LOGIT_TOL (bf16 dense products and the kernels sum in other
    orders); the CLI's text equal to the fused run's or not is printed."""
    from ggllm_tpu_torch import tokenizer as tok_mod
    from ggllm_tpu_torch.core.config import EngineConfig
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.io.loader import load_model
    from ggllm_tpu_torch.ops.sampling import SamplerParams

    mf, fused = load_model(path, EngineConfig())
    _, dense = load_model(path, EngineConfig(weight_mode="dequant"))
    prompt = tok_mod.for_model(mf).tokenize("the thing", bos=True)
    eng = FalconEngine(mf.hparams, fused, EngineConfig())
    ids = FalconEngine(mf.hparams, dense, EngineConfig()).generate(
        prompt, 16, SamplerParams(temp=0.0, repeat_penalty=1.0), stop_ids=set())
    tf = _teacher_forced(eng, prompt, ids, ROWS_LOGIT_TOL)
    log(f"  cli --weight-mode dequant: the CLI's text {'equals' if same_text else 'differs from'}"
        f" the fused run's; 16 greedy ids of the dequantized engine against the fused engine's"
        f" logits with the ids forced: worst deficit {tf['worst']:.3f} of ROWS_LOGIT_TOL, not the"
        f" argmax at steps {tf['not_argmax']}")
    if tf["worst"] >= 1.0:
        raise RuntimeError(f"--weight-mode dequant ids {ids} leave the fused engine's near-ties")


def _write_tree_file(path: str, params: dict, hp, f16_embedding: bool = False) -> None:
    """A merged parameter tree on the card (utils/benchgen.py
    make_bench_params: Falcon-7B "wqkvu" / "w_od", 40B-style "wqkv" /
    "ffn_up" / "w_od", LLaMA "wqkv" / "w13" / "wo" / "w2") as a GGCC or GGJT
    file the loader reads back to the same tree: each merged weight split
    back into the file's matrices (rows, or whole blocks of the contraction),
    the embedding and norms in f32 (exactly their values; with
    f16_embedding, a 40B-style embedding in f16, half the bytes)."""
    if hp.arch != "llama" and hp.n_falcon_type < 40:
        return _write_params_file(path, params, hp)
    import numpy as np

    from ggllm_tpu_torch.core.dtypes import TYPE_TRAITS, GGMLType
    from ggllm_tpu_torch.io.ggcc import GGCCWriter, GGJTWriter
    from ggllm_tpu_torch.quant import planar
    from ggllm_tpu_torch.utils.synthetic import make_tiny_sp_vocab, make_tiny_vocab

    if hp.arch == "llama":
        w = GGJTWriter(path, hp, make_tiny_sp_vocab(hp.n_vocab))
    else:
        vocab = make_tiny_vocab(hp.n_vocab)
        hp.n_bpe_merges = len(vocab.merges)
        w = GGCCWriter(path, hp, vocab)

    def quant(name, q, rows=None, cols=None):
        bs = TYPE_TRAITS[q.gtype].block_size
        r = slice(*rows) if rows else slice(None)
        b = slice(cols[0] // bs, cols[1] // bs) if cols else slice(None)
        blob = planar.from_planes(q.gtype, {k: v[r, b].cpu().numpy() for k, v in q.planes.items()})
        n_cols = blob.shape[1] // TYPE_TRAITS[q.gtype].type_size * bs
        w.write_tensor(name, q.gtype, (n_cols, blob.shape[0]), blob.reshape(-1))

    def f32(name, t):
        a = t.float().cpu().numpy()
        w.write_tensor(name, GGMLType.F32, tuple(reversed(a.shape)), a.reshape(-1).view(np.uint8))

    E, F, HD = hp.n_embd, hp.n_ff, hp.n_head * hp.head_dim
    if hp.arch == "llama":
        f32("tok_embeddings.weight", params["tok_embeddings"])
        f32("norm.weight", params["output_norm"])
        quant("output.weight", params["lm_head"])
        for i, lw in enumerate(params["layers"]):
            p = f"layers.{i}"
            f32(f"{p}.attention_norm.weight", lw["attn_norm"])
            for j, k in enumerate(("wq", "wk", "wv")):
                quant(f"{p}.attention.{k}.weight", lw["wqkv"], rows=(j * E, (j + 1) * E))
            quant(f"{p}.attention.wo.weight", lw["wo"])
            f32(f"{p}.ffn_norm.weight", lw["ffn_norm"])
            quant(f"{p}.feed_forward.w1.weight", lw["w13"], rows=(0, F))
            quant(f"{p}.feed_forward.w2.weight", lw["w2"])
            quant(f"{p}.feed_forward.w3.weight", lw["w13"], rows=(F, 2 * F))
    else:
        if f16_embedding:
            a = params["tok_embeddings"].half().cpu().numpy()
            w.write_tensor("transformer.word_embeddings.weight", GGMLType.F16,
                           tuple(reversed(a.shape)), a.reshape(-1).view(np.uint8))
        else:
            f32("transformer.word_embeddings.weight", params["tok_embeddings"])
        f32("transformer.ln_f.weight", params["output_norm"])
        f32("transformer.ln_f.bias", params["output_norm_b"])
        quant("lm_head.weight", params["lm_head"])
        for i, lw in enumerate(params["layers"]):
            p = f"transformer.h.{i}"
            f32(f"{p}.ln_attn.weight", lw["attn_ln_w"])
            f32(f"{p}.ln_attn.bias", lw["attn_ln_b"])
            f32(f"{p}.ln_mlp.weight", lw["input_ln_w"])
            f32(f"{p}.ln_mlp.bias", lw["input_ln_b"])
            quant(f"{p}.self_attention.query_key_value.weight", lw["wqkv"])
            quant(f"{p}.self_attention.dense.weight", lw["w_od"], cols=(0, HD))
            quant(f"{p}.mlp.dense_h_to_4h.weight", lw["ffn_up"])
            quant(f"{p}.mlp.dense_4h_to_h.weight", lw["w_od"], cols=(HD, HD + F))
    w.close()


def _quant_kernels(torch, shapes, what: str) -> dict:
    """Each quantized shard shape (gtype, O, K) through the quant_matmul
    kernels against the plain version: the GEMV (S = 1), the rows kernel
    (S = 2) and the tile (S = 300), at TOL of max |plain| as phase 2. The
    checks' launches are not the paths' and leave the counts as they were."""
    from ggllm_tpu_torch.core.dtypes import GGMLType
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.kernels import quant_matmul as qm
    from ggllm_tpu_torch.utils.benchgen import random_quant

    gen = torch.Generator(device="cuda").manual_seed(3)
    worst, before = {}, dict(build.launch_counts)
    for gt, O, K in sorted(shapes):
        w = random_quant(GGMLType(gt), O, K, gen, "cuda")
        for S in (1, 2, 300):
            x = torch.randn(S, K, generator=gen, device="cuda").to(torch.bfloat16)
            name = f"{GGMLType(gt).name} O={O} K={K} S={S} ({qm.route(S, x.dtype, w.gtype)})"
            _, worst[name] = check(name, qm.quant_matmul(w, x, torch.float32),
                                   qm.quant_matmul_plain(w, x, torch.float32))
        del w
    log(f"  quant_matmul at {what} against the plain version: worst"
        f" {max(worst.values()):.3e} of max |plain| (TOL {TOL}) over {len(worst)} cases")
    for k in set(build.launch_counts) | set(before):
        build.launch_counts[k] = before.get(k, 0)
    return worst


SHARDS = {  # model -> (format, the TP x2 blocks' (O, K), (H, KV, D) of a rank)
    "falcon7b": ("q4_0", [(11520, 4544), (4544, 11392)], (36, 1, 64)),
    "falcon40b": ("q4_k", [(4608, 8192), (16384, 8192), (8192, 20480)], (64, 4, 64)),
    "llama7b": ("q4_0", [(6144, 4096), (11008, 4096), (4096, 2048), (4096, 5504)], (16, 16, 128)),
}


def _shard_kernels(torch) -> dict:
    """Every kernel of the sharded paths at a rank's shard shapes (two
    ranks) against its plain version, before the paths rely on them: the
    quant_matmul kernels at each block (_quant_kernels); flash_mqa at the
    rank's heads (300 positions); flash_decode at them (valid 300). Held at
    TOL of max |plain|, as phase 2."""
    from ggllm_tpu_torch.core.dtypes import GGMLType
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.kernels.flash_attention import flash_mqa, flash_mqa_plain
    from ggllm_tpu_torch.kernels.flash_decode import flash_decode, flash_decode_plain

    worst = _quant_kernels(torch, {(int(GGMLType[fmt.upper()]), O, K)
                                   for fmt, blocks, _ in SHARDS.values() for O, K in blocks},
                           "the TP shard shapes")
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf16 = torch.bfloat16
    attn, before = {}, dict(build.launch_counts)
    for model, (_, _, (H, KV, D)) in SHARDS.items():
        T = 512
        q = torch.randn(1, 300, H, D, generator=gen, device="cuda").to(bf16)
        k, v = (torch.randn(1, T, KV, D, generator=gen, device="cuda").to(bf16) for _ in "kv")
        name = f"{model} flash_mqa H={H} KV={KV} D={D}"
        _, attn[name] = check(name, flash_mqa(q, k, v, 0), flash_mqa_plain(q, k, v, 0))
        kv = torch.randn(1, 2, 1, T, KV, D, generator=gen, device="cuda").to(bf16)
        q1 = torch.randn(1, 1, H, D, generator=gen, device="cuda").to(bf16)
        name = f"{model} flash_decode H={H} KV={KV} D={D} valid 300"
        _, attn[name] = check(name, flash_decode(kv, KV, 0, q1, 299),
                              flash_decode_plain(kv, KV, 0, q1, 299))
    log(f"  attention kernels at the ranks' heads against their plain versions: worst"
        f" {max(attn.values()):.3e} of max |plain| (TOL {TOL}) over {len(attn)} cases")
    for k in set(build.launch_counts) | set(before):  # checks are not the paths' launches
        build.launch_counts[k] = before.get(k, 0)
    return {**worst, **attn}


def _forced_steps(eng1, prompt, ids: list, rel_tol: float) -> dict:
    """`ids` held to the single process's decode path with those ids
    forced: after a prefill of `prompt`, each id's logit at its step (one
    S = 1 forward a step: the GEMV and the decode attention kernel, as the
    ids were made) must lie within rel_tol of max |logit| of that step's top
    logit. Returns the largest deficit as a share of its tolerance
    (`worst`, >= 1 fails), its step and the steps not at the argmax."""
    import numpy as np

    eng1.reset()
    lg = eng1.eval(prompt)
    worst, at, off = 0.0, 0, []
    for t, i in enumerate(ids):
        deficit = float(lg.max() - lg[i]) / (rel_tol * float(np.abs(lg).max()))
        if deficit > 0:
            off.append(t)
        if deficit > worst:
            worst, at = deficit, t
        if t + 1 < len(ids):
            lg = eng1.eval([i])
    return {"worst": worst, "worst_step": at, "not_argmax": off}


def _mg_rank(path: str, mp: int, devices: list, kv_shard: str, prompt: list, n_ids: int,
             rows: list | None = None, eager_too: bool = False, data: int = 1,
             cfg_kw: dict | None = None, lora: str | None = None) -> dict:
    """A rank's part of phase_multi_gpu and phase_gspmd (run by
    parallel/mesh.py RankPool): the file (with the adapter `lora`) loaded
    under a data x mp mesh (this rank's blocks, its fallback tree, or the
    whole model for kv_shard "sequence"), a prefill of `prompt` and n_ids
    greedy ids (the first from the prefill, then pipelined 16-token chunks),
    and with `rows` two requests through the batcher on a 2-row engine;
    with `eager_too` the same ids again through the eager step body.
    Returns the rank's logits, ids, launch counts, host-staged collectives,
    load seconds, decode tok/s, peak memory, the cache's local shape (and
    the 2-row engine's local rows), and the (gtype, O, K) of its quantized
    weights."""
    import numpy as np
    import torch

    from ggllm_tpu_torch.core.config import EngineConfig
    from ggllm_tpu_torch.engine.batching import ContinuousBatcher, Request
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.io.loader import load_model
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.ops.sampling import SamplerParams
    from ggllm_tpu_torch.parallel import comm
    from ggllm_tpu_torch.parallel.mesh import make_mesh

    from ggllm_tpu_torch.ops.linear import QuantTensor

    mesh = make_mesh(data, mp, devices=devices)
    dev = mesh.device
    cfg = EngineConfig(kv_shard=kv_shard, **(cfg_kw or {}))
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with warnings.catch_warnings():  # an adapter on quantized weights without a base
        warnings.simplefilter("ignore")
        mf, params = load_model(path, cfg, mesh=mesh, lora=lora)
    torch.cuda.synchronize(dev)
    load_s = time.perf_counter() - t0
    eng = FalconEngine(mf.hparams, params, cfg, mesh=mesh)
    greedy = SamplerParams(temp=0.0, repeat_penalty=1.0)  # pure argmax
    eng.eval(prompt[:8])  # warm-up (and the graph capture under NCCL)
    eng.decode_chunk(1, 16, greedy)
    eng.reset()
    build.launch_counts.clear()
    comm.STAGED.clear()
    logits = eng.eval(prompt)
    first = int(np.argmax(logits))
    step = eng.eval([first])  # one decode step's logits (S = 1)
    eng.rollback(len(prompt))
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    ids, _ = eng.decode_pipelined(first, n_ids - 1, 16, greedy, last_tokens=prompt + [first])
    decode_s = time.perf_counter() - t0
    eager_ids = None
    if eager_too:  # chained eager chunks (= decode_pipelined's ids); launches counted
        eng.rollback(len(prompt))
        eager_ids, gen = [first], None
        while len(eager_ids) < n_ids:
            got, gen = eng.decode_chunk(eager_ids[-1], 16, greedy, gen, eager=True,
                                        last_tokens=prompt + eager_ids)
            eager_ids += [int(t) for t in got]
        eager_ids = eager_ids[:n_ids]
    out = {"eager_ids": eager_ids, "logits": logits, "step": step, "ids": [first] + [int(t) for t in ids],
           "tok_s": (n_ids - 1) / decode_s, "load_s": load_s,
           "graph": eng.chunk_graph(16, greedy) is not None,
           "kv_shape": list((eng.kv[0] if isinstance(eng.kv, tuple) else eng.kv).shape),
           "kv_T": eng.kv_T, "split": eng.split is not None,
           "quant_shapes": sorted({(int(m.gtype), *m.shape) for m in eng.model.modules()
                                   if isinstance(m, QuantTensor)})}
    if rows:
        eng2 = FalconEngine(mf.hparams, params, cfg, batch_size=2, mesh=mesh)
        b = ContinuousBatcher(eng2, chunk=16)
        reqs = [b.submit(Request(list(p), n_predict=16)) for p in rows]
        b.run()
        out["rows"], out["rows_local"] = [r.out for r in reqs], eng2.rows
    out["launches"] = dict(build.launch_counts)
    out["staged"] = dict(comm.STAGED)
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return out


def _add_launches(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def _need(label: str, counts: dict, names: list) -> None:
    """Fail unless each kernel counter in names launched on the ranks."""
    missing = [n for n in names if counts.get(n, 0) <= 0]
    if missing:
        raise RuntimeError(f"{label}: {missing} not launched on the ranks: {counts}")


GLOO_RATE = "two ranks sharing one card over host-staged gloo collectives, eager decode: not a multi-card rate"


def _held_on_ranks(label, res, eng1, prompt, n_ids, failures: list, total: dict,
                   how=GLOO_RATE) -> dict:
    """The ranks' results of one sharded path held to the single process
    (eng1): every rank's n_ids ids equal; rank 0's prefill and decode-step
    logits within LOGIT_TOL of eng1's, its ids within ROWS_LOGIT_TOL of
    eng1's S = 1 steps with the ids forced. A miss goes to `failures` (the
    phase fails at its end, after its other paths); launches add to total."""
    import numpy as np

    r0 = res[0]
    if any(r["ids"] != r0["ids"] for r in res) or len(r0["ids"]) != n_ids:
        raise RuntimeError(f"{label}: ranks disagree or short: {[r['ids'][:8] for r in res]}")
    eng1.reset()
    ref = eng1.eval(prompt)
    ref_step = eng1.eval([r0["ids"][0]])
    rel = float(np.abs(r0["logits"] - ref).max() / np.abs(ref).max())
    rel_step = float(np.abs(r0["step"] - ref_step).max() / np.abs(ref_step).max())
    tf = _forced_steps(eng1, prompt, r0["ids"], ROWS_LOGIT_TOL)
    log(f"  {label}: prefill logits {rel:.3e}, a decode step's {rel_step:.3e} of max |logit|"
        f" from the single process's; ids forced through its decode steps: worst"
        f" {tf['worst']:.3f} of ROWS_LOGIT_TOL at step {tf['worst_step']}, not the argmax at"
        f" {tf['not_argmax']}")
    if (not np.isfinite(r0["logits"]).all() or rel > LOGIT_TOL or rel_step > LOGIT_TOL
            or tf["worst"] >= 1):
        failures.append(f"{label}: prefill logits {rel:.3e}, a step's {rel_step:.3e} of"
                        f" max |logit| (limit {LOGIT_TOL}), forced ids worst"
                        f" {tf['worst']:.3f} (limit 1)")
    for r in res:
        _add_launches(total, r["launches"])
    staged = sum(sum(r["staged"].values()) for r in res)
    log(f"  {label}: {n_ids} ids equal on {len(res)} ranks; load"
        f" {[round(r['load_s'], 2) for r in res]} s; peak"
        f" {[round(r['peak_gib'], 2) for r in res]} GiB; {staged} collectives staged through"
        f" host memory; {r0['tok_s']:.2f} tok/s ({how})")
    return {"logit_rel_err": rel, "step_logit_rel_err": rel_step,
            "forced_worst": tf["worst"], "tok_s": r0["tok_s"], "tok_s_is": how,
            "load_s": [r["load_s"] for r in res],
            "peak_gib": [r["peak_gib"] for r in res], "staged": staged,
            "launches_rank0": r0["launches"]}


def phase_multi_gpu(torch, d: str, pool, one) -> tuple[dict, str]:
    """Multi-GPU on torch.distributed (parallel/): the card is one H100, so
    two ranks share cuda:0 over a gloo group (collectives staged through
    host memory, counted; decode runs the eager step body) and show that the
    sharded arithmetic and the kernels at shard shapes are right, and one
    NCCL rank shows the decode graph captured with its all-reduces inside.
    Ranks are parallel/mesh.py RankPool processes (the kernels already
    built): `pool`, two gloo ranks on cuda:0, and `one`, one NCCL rank, both
    shared with phase_gspmd; the files go to the work directory d. Paths, from GGCC / GGJT files written from seeded random trees:
    every model cut to MG_LAYERS layers: tensor-parallel Falcon-7B Q4_0
    (prefill 300 tokens, 64 greedy ids, 2 requests through a 2-row batcher);
    tensor-parallel Falcon-40B Q4_K and LLaMA-7B Q4_0 (n_rot 128) (prefill,
    16 ids); sequence-parallel Falcon-7B Q4_0 (prefill 300,
    32 ids, each rank's cache kv_T / 2 positions); one NCCL rank, Falcon-7B
    Q4_0, tensor-parallel (64 ids through the captured graph = the
    single-process engine's exactly, tok/s beside it) and sequence-parallel
    (32 ids through the captured graph = its eager step body's exactly, and
    held to the single process as the sharded paths are). Each sharded path: every rank's ids equal,
    rank 0's prefill logits within LOGIT_TOL of the single-process engine's,
    its ids (and the batcher's) within ROWS_LOGIT_TOL of that engine's with
    the ids forced; the GEMV, the rows kernel, the tile, flash_mqa.tc,
    flash_decode_tc and (LLaMA) flash_decode.mha must launch on the ranks."""
    import gc

    import numpy as np

    from ggllm_tpu_torch.core.config import EngineConfig
    from ggllm_tpu_torch.core.dtypes import GGMLType
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.io.loader import load_model
    from ggllm_tpu_torch.ops.sampling import SamplerParams
    from ggllm_tpu_torch.utils.benchgen import bench_hparams, make_bench_params

    rng = np.random.default_rng(5)
    prompt = [int(t) for t in rng.integers(12, 32000, 300)]
    rows = [prompt[:40], prompt[100:131]]
    out = {"path": "multi-GPU: 2 gloo ranks on one card, 1 NCCL rank", "launches": {},
           "cuts": [f"Falcon-7B Q4_0, Falcon-40B Q4_K and LLaMA-7B Q4_0 at {MG_LAYERS} of 32 /"
                    " 60 / 32 layers"]}
    total = out["launches"]
    gloo = ["cuda:0", "cuda:0"]

    def add(counts):
        _add_launches(total, counts)

    def held(label, res, eng1, n_ids, how=GLOO_RATE):
        return _held_on_ranks(label, res, eng1, prompt, n_ids, failures, total, how)

    need = _need

    failures = []
    t_phase = time.perf_counter()
    out["shard_kernels_worst"] = max(_shard_kernels(torch).values())
    for model, fmt in (("falcon7b", "q4_0"), ("falcon40b", "q4_k"), ("llama7b", "q4_0")):
        hp = bench_hparams(model, MG_LAYERS)  # n_rot = head_dim: the reader's LLaMA test
        t0 = time.perf_counter()
        params = make_bench_params(hp, device="cuda", seed=11, gtype=GGMLType[fmt.upper()])
        path = str(Path(d) / f"{model}.bin")
        _write_tree_file(path, params, hp)
        del params
        mf, p1 = load_model(path, EngineConfig())
        eng1 = FalconEngine(mf.hparams, p1, EngineConfig())
        label = f"{hp.n_layer}-layer {model} {fmt}"
        log(f"  {label}: file written and the single-process engine loaded in"
            f" {time.perf_counter() - t0:.1f} s")
        n_ids = 64 if model == "falcon7b" else 16
        res = pool.run(_mg_rank, path, 2, gloo, "heads", prompt, n_ids,
                       rows if model == "falcon7b" else None)
        out[f"tp2 {label}"] = held(f"tensor-parallel x2 {label}", res, eng1, n_ids)
        names = ["quant_matmul.tc", "flash_mqa.tc",
                 "quant_matmul.gemv.kq" if fmt == "q4_k" else "quant_matmul.gemv",
                 "flash_decode.mha" if hp.arch == "llama" else "flash_decode_tc"]
        if model == "falcon7b":
            names.append("quant_matmul.rows")
            for i, p in enumerate(rows):
                tf = _teacher_forced(eng1, p, res[0]["rows"][i], ROWS_LOGIT_TOL)
                log(f"  batcher row {i}: forced worst {tf['worst']:.3f}")
                if tf["worst"] >= 1 or any(r["rows"] != res[0]["rows"] for r in res):
                    failures.append(f"batcher row {i}: forced worst {tf['worst']}")
            log(f"  2-row batcher on the ranks: ids equal on both, within"
                f" ROWS_LOGIT_TOL of the single process with the ids forced")
        need(label, res[0]["launches"], names)
        if model == "falcon7b":
            res = pool.run(_mg_rank, path, 2, gloo, "sequence", prompt, 32)
            out[f"sp2 {label}"] = held(f"sequence-parallel x2 {label}", res, eng1, 32)
            if any(r["kv_shape"][3] * 2 != r["kv_T"] for r in res):
                raise RuntimeError(f"sequence-parallel cache {res[0]['kv_shape']}")
            need(label + " sequence", res[0]["launches"],
                 ["quant_matmul.tc", "quant_matmul.gemv"])
        if model == "falcon7b":
            # the single process's greedy ids through its decode graphs
            eng1.eval(prompt[:8])  # warm-up: the greedy chunk's capture
            greedy = SamplerParams(temp=0.0, repeat_penalty=1.0)  # pure argmax
            eng1.decode_chunk(1, 16, greedy)
            eng1.reset()
            first = int(np.argmax(eng1.eval(prompt)))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids, _ = eng1.decode_pipelined(first, 63, 16, greedy,
                                           last_tokens=prompt + [first])
            single_tps = 63 / (time.perf_counter() - t0)
            own = [first] + [int(t) for t in ids]
            res = one.run(_mg_rank, path, 1, ["cuda:0"], "heads", prompt, 64)[0]
            add(res["launches"])
            if res["ids"] != own or not res["graph"] or res["staged"]:
                raise RuntimeError(f"one NCCL rank: ids equal {res['ids'] == own}, graph"
                                   f" {res['graph']}, staged {res['staged']}")
            need("one NCCL rank", res["launches"], ["quant_matmul.gemv", "flash_decode_tc"])
            out["nccl1"] = {"tok_s": res["tok_s"], "single_tok_s": single_tps,
                            "load_s": res["load_s"], "peak_gib": res["peak_gib"]}
            log(f"  one NCCL rank, {label}: 64 greedy ids through the"
                f" captured decode graph (all-reduces inside) = the single process's;"
                f" {res['tok_s']:.2f} tok/s beside {single_tps:.2f} tok/s single-process"
                f" (the same call); load {res['load_s']:.2f} s")
            # the sequence-parallel engine under NCCL (mp 1 still runs
            # parallel/sp.py SpModel): its decode graph holds the cache
            # window's masked write and merged_attention's pmax and psums
            sp1 = one.run(_mg_rank, path, 1, ["cuda:0"], "sequence", prompt, 32,
                          eager_too=True)[0]
            out["nccl1 sequence"] = held("one NCCL rank sequence-parallel", [sp1], eng1, 32,
                                         "one NCCL rank, decode graph")
            if sp1["ids"] != sp1["eager_ids"] or not sp1["graph"] or sp1["staged"]:
                raise RuntimeError(f"one NCCL rank sequence-parallel: graph ids = eager ids"
                                   f" {sp1['ids'] == sp1['eager_ids']}, graph"
                                   f" {sp1['graph']}, staged {sp1['staged']}")
            need("one NCCL rank sequence-parallel", sp1["launches"],
                 ["quant_matmul.gemv", "quant_matmul.tc"])
            out["nccl1 sequence"]["ids_equal_single"] = sp1["ids"] == own[:32]
            log(f"  one NCCL rank sequence-parallel: 32 greedy ids through the captured"
                f" decode graph = its eager step body's; equal to the single process's"
                f" graph ids: {sp1['ids'] == own[:32]}")
        if model == "falcon7b":  # phase_gspmd reads this file
            path7b = path
        else:
            os.remove(path)
        del eng1, p1
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  (the multi-GPU phase took {out['seconds']:.1f} s)")
    if failures:
        raise RuntimeError("multi-GPU phase: " + "; ".join(failures))
    return out, path7b


def phase_gspmd(torch, d: str, pool, one, path: str) -> dict:
    """The fallback tree (parallel/sharding.py, io/loader.py _load_split,
    models/falcon.py SplitFalcon) and the data axis, on two gloo ranks
    sharing cuda:0 as phase_multi_gpu runs them (collectives staged through
    host memory, eager decode), from files written from seeded random trees:
    every model at MG_LAYERS layers: (a) Falcon-7B Q4_0 with an r 16 adapter
    on query_key_value and dense_4h_to_h (phase_lora's) at mp 2; (b)
    Falcon-7B Q4_0 under weight_mode "dequant" at mp 2; (c) Falcon-40B with
    Q4_K wqkv / ffn_up and Q6_K wo / ffn_down at mp 2; (d) a data 2 x model
    1 mesh over (b)'s file, fused, with two requests through a 2-row
    batcher (a row a rank). Each held as phase_multi_gpu's paths: every
    rank's 16 ids equal, rank 0's prefill (300 tokens) and decode-step
    logits within LOGIT_TOL of the single process's on the same weights
    (the adapter, dequant), its ids within ROWS_LOGIT_TOL with the ids forced
    through the single process's S = 1 steps, (d)'s batched ids forced
    through its prefill. The GEMV (.kq for 40B), the tile, flash_mqa.tc and
    flash_decode_tc must launch on the ranks (under dequant no quantized
    weight is left: the attention kernels). `pool` (the two gloo ranks),
    `one` (one NCCL rank) and the work directory d are phase_multi_gpu's,
    and `path` is the Falcon-7B Q4_0 file it returns.
    The NCCL rank on (b)'s tree captures the fallback model's decode in a
    graph whose ids equal its eager step body's. Then every quantized shard
    shape the ranks held through the kernels against the plain version. Each
    file is removed once its paths are done."""
    import dataclasses
    import gc

    import numpy as np

    from ggllm_tpu_torch.core.config import EngineConfig, named_hparams
    from ggllm_tpu_torch.core.dtypes import GGMLType
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.io.lora import write_lora
    from ggllm_tpu_torch.io.loader import load_model
    from ggllm_tpu_torch.utils.benchgen import make_bench_params

    rng = np.random.default_rng(5)
    prompt = [int(t) for t in rng.integers(12, 32000, 300)]
    rows = [prompt[:40], prompt[100:131]]
    gloo, n_ids = ["cuda:0", "cuda:0"], 16
    out = {"path": "the fallback tree and the data axis: 2 gloo ranks on one card",
           "launches": {}, "cuts": [f"Falcon-7B and Falcon-40B at {MG_LAYERS} layers"]}
    total, failures, shapes = out["launches"], [], set()
    t_phase = time.perf_counter()

    def single(path, cfg, lora=None):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mf, p1 = load_model(path, cfg, lora=lora)
        return FalconEngine(mf.hparams, p1, cfg)

    def run(label, key, path, eng1, names, **kw):
        t0 = time.perf_counter()
        res = pool.run(_mg_rank, path, kw.pop("mp", 2), gloo, "heads", prompt, n_ids, **kw)
        if not all(r["split"] for r in res):
            raise RuntimeError(f"{label}: the ranks did not load the fallback tree")
        out[key] = _held_on_ranks(label, res, eng1, prompt, n_ids, failures, total)
        _need(label, res[0]["launches"], names)
        for r in res:
            shapes.update(tuple(t) for t in r["quant_shapes"])
        out[key]["seconds"] = time.perf_counter() - t0
        return res

    hp = dataclasses.replace(named_hparams("falcon7b"), n_layer=MG_LAYERS)
    t0 = time.perf_counter()
    ggla = str(Path(d) / "adapter.ggla")
    lrng, n_qkv = np.random.default_rng(20), (hp.n_head + 2 * hp.n_head_kv) * hp.head_dim
    write_lora(ggla, 16, 32, {
        name: {"loraA": (lrng.standard_normal((16, cols)) * 0.03).astype(np.float32),
               "loraB": (lrng.standard_normal((o, 16)) * 0.03).astype(np.float32)}
        for i in range(hp.n_layer)
        for name, (o, cols) in ((f"transformer.h.{i}.self_attention.query_key_value.weight",
                                 (n_qkv, hp.n_embd)),
                                (f"transformer.h.{i}.mlp.dense_4h_to_h.weight",
                                 (hp.n_embd, hp.n_ff)))})
    eng1 = single(path, EngineConfig(), ggla)
    log(f"  the adapter for the {hp.n_layer}-layer falcon7b q4_0 file written, the single process"
        f" loaded with it in {time.perf_counter() - t0:.1f} s")
    run(f"(a) fallback x2 {hp.n_layer}-layer falcon7b q4_0 + LoRA r 16", "lora", path, eng1,
        ["quant_matmul.gemv", "quant_matmul.tc", "flash_mqa.tc", "flash_decode_tc"],
        lora=ggla)
    os.remove(path)
    del eng1
    gc.collect()
    torch.cuda.empty_cache()

    path4 = str(Path(d) / "falcon7b-dequant.bin")
    params = make_bench_params(hp, device="cuda", seed=13, gtype=GGMLType.Q4_0)
    _write_params_file(path4, params, hp)
    del params
    dq = {"weight_mode": "dequant"}
    eng1 = single(path4, EngineConfig(**dq))
    run(f"(b) fallback x2 {hp.n_layer}-layer falcon7b q4_0, weight_mode dequant", "dequant",
        path4, eng1,
        ["flash_mqa.tc", "flash_decode_tc"], cfg_kw=dq)
    # one NCCL rank on the same tree: SplitFalcon's decode captured in a graph
    r = one.run(_mg_rank, path4, 1, ["cuda:0"], "heads", prompt, n_ids, cfg_kw=dq,
                eager_too=True)[0]
    out["nccl1 dequant"] = _held_on_ranks("(b) one NCCL rank, fallback tree", [r], eng1,
                                          prompt, n_ids, failures, total,
                                          "one NCCL rank, decode graph")
    if not (r["split"] and r["graph"] and r["ids"] == r["eager_ids"]) or r["staged"]:
        raise RuntimeError(f"(b) one NCCL rank: fallback tree {r['split']}, graph {r['graph']},"
                           f" graph ids = eager ids {r['ids'] == r['eager_ids']}, staged"
                           f" {r['staged']}")
    log("  (b) one NCCL rank: the fallback tree's decode captured, its 16 graph ids = its"
        " eager step body's")
    eng1 = single(path4, EngineConfig())
    res = run(f"(d) data 2 x model 1, {hp.n_layer}-layer falcon7b q4_0", "data2", path4, eng1,
              ["quant_matmul.gemv", "quant_matmul.tc", "flash_mqa.tc", "flash_decode_tc"],
              mp=1, data=2, rows=rows)
    if any(r["rows_local"] != 1 or r["rows"] != res[0]["rows"] for r in res):
        raise RuntimeError(f"(d): rows a rank {[r['rows_local'] for r in res]}, batched ids"
                           " differ between the ranks")
    for i, p in enumerate(rows):
        tf = _teacher_forced(eng1, p, res[0]["rows"][i], ROWS_LOGIT_TOL)
        log(f"  (d) batcher row {i} (data row {i}): forced worst {tf['worst']:.3f}")
        if tf["worst"] >= 1:
            failures.append(f"(d) batcher row {i}: forced worst {tf['worst']}")
    os.remove(path4)
    del eng1
    gc.collect()
    torch.cuda.empty_cache()

    hp40 = dataclasses.replace(named_hparams("falcon40b"), n_layer=MG_LAYERS)
    path40 = str(Path(d) / "falcon40b-mixed.bin")
    params = make_bench_params(hp40, device="cuda", seed=11, gtype=GGMLType.Q4_K)
    six = make_bench_params(hp40, device="cuda", seed=12, gtype=GGMLType.Q6_K)
    for lw, l6 in zip(params["layers"], six["layers"]):
        lw["w_od"] = l6["w_od"]  # Q6_K wo and ffn_down beside Q4_K wqkv and ffn_up
    del six
    _write_tree_file(path40, params, hp40)
    del params
    eng1 = single(path40, EngineConfig())
    run(f"(c) fallback x2 {hp40.n_layer}-layer falcon40b q4_k / q6_k", "mixed", path40, eng1,
        ["quant_matmul.gemv.kq", "quant_matmul.tc", "flash_mqa.tc", "flash_decode_tc"])
    os.remove(path40)
    del eng1
    gc.collect()
    torch.cuda.empty_cache()
    worst = _quant_kernels(torch, shapes, "the fallback's shard shapes")
    out["split_kernels_worst"] = max(worst.values())
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  (the fallback phase took {out['seconds']:.1f} s)")
    if failures:
        raise RuntimeError("fallback phase: " + "; ".join(failures))
    return out


def phase_train(torch) -> dict:
    """The training demo (tools/train_demo.py) with its defaults (a 2-layer
    128-wide Falcon, sequences of 64, batches of 8, lr 3e-3) on the bytes of
    this repository's README.md, on the card: 200 Adam steps and 20 L-BFGS
    steps, each loss falling; one step's gradients within 1e-4 of each leaf's
    largest of the CPU's on the same weights and batch; the written file
    loaded on the card in f32, 16 greedy ids through the engine's kernels
    (flash_mqa.f32 and flash_decode.f32 at D = 32 must launch) held to the
    plain versions with the ids forced within LOGIT_TOL. Prints steps/s and
    tokens/s of both optimizers."""
    import numpy as np

    from ggllm_tpu_torch.core.config import EngineConfig, FalconHParams
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.io.loader import load_model
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.ops.rope import rope_angles
    from ggllm_tpu_torch.ops.sampling import SamplerParams
    from ggllm_tpu_torch.tools import train_demo as demo

    t_phase = time.perf_counter()
    text = (ROOT / "README.md").read_bytes()
    hp = FalconHParams(n_vocab=512, n_embd=128, n_head=4, n_head_kv=1, n_layer=2,
                       n_falcon_type=7, n_bpe_merges=0)
    seq, batch, out = 64, 8, {"path": "training demo (2-layer 128-wide Falcon) on README.md"}
    before = dict(build.launch_counts)
    demo.train(text, hp, 2, seq, batch, device="cuda", log=lambda *a: None)  # warm-up (cuBLAS)
    for opt, steps in (("adam", 200), ("lbfgs", 20)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, losses = demo.train(text, hp, steps, seq, batch, optimizer=opt, device="cuda",
                                    log=lambda *a: None)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        head, tail = np.mean(losses[:steps // 10]), np.mean(losses[-(steps // 10):])
        out[opt] = {"steps": steps, "first_loss": losses[0], "last_loss": losses[-1],
                    "steps_per_s": steps / s, "tokens_per_s": steps * batch * seq / s}
        log(f"  {opt}: {steps} steps in {s:.2f} s, {steps / s:.2f} steps/s,"
            f" {steps * batch * seq / s:.0f} tokens/s (after a 2-step warm-up); loss"
            f" {losses[0]:.4f} -> {losses[-1]:.4f} (mean of the first / last tenth {head:.4f} /"
            f" {tail:.4f})")
        if not (np.isfinite(losses).all() and tail < head and losses[-1] < losses[0]):
            raise RuntimeError(f"{opt}: the loss did not fall: {losses[:3]} ... {losses[-3:]}")
        if opt == "adam":
            trained = params
    if dict(build.launch_counts) != before:
        raise RuntimeError("a hand kernel launched under autograd")
    # one step's gradients on the card against the CPU's, same weights and batch
    data = np.frombuffer(text, dtype=np.uint8).astype(np.int64) + 12
    starts = np.random.default_rng(9).integers(0, data.size - seq - 1, batch)
    tokens = torch.from_numpy(np.stack([data[i:i + seq + 1] for i in starts]))
    inv = torch.from_numpy(rope_angles(EngineConfig().rope, seq, hp.head_dim))
    grads = {}
    for dev in ("cuda", "cpu"):
        p = demo.params_from_numpy({k: ({n: t.detach().cpu() for n, t in v.items()} if k == "layers"
                                        else v.detach().cpu()) for k, v in trained.items()}, dev)
        with demo.no_tf32():
            demo.loss_fn(p, tokens.to(dev), hp, inv.to(dev)).backward()
        grads[dev] = [t.grad.cpu() for t in demo.leaves(p)]
    grad_rel = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(grads["cuda"], grads["cpu"]))
    log(f"  one step's gradients on the card against the CPU's: worst {grad_rel:.3e} of a leaf's"
        f" largest (limit 1e-4)")
    if not grad_rel < 1e-4:
        raise RuntimeError(f"training gradients on the card {grad_rel:.3e} from the CPU's")
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "trained.ggcc")
        demo.save_ggcc(path, hp, trained)
        cfg = EngineConfig(compute_dtype="float32", kv_dtype="float32")
        mf, p1 = load_model(path, cfg)
    eng = FalconEngine(mf.hparams, p1, cfg)
    plain = FalconEngine(mf.hparams, p1, EngineConfig(compute_dtype="float32",
                                                      kv_dtype="float32", kernel_layout=False,
                                                      flash_attention=False))
    prompt = [c + 12 for c in b"The port "]
    build.launch_counts.clear()
    ids = [int(t) for t in eng.generate(prompt, 16, SamplerParams(temp=0.0, repeat_penalty=1.0))]
    counts = dict(build.launch_counts)
    tf = _forced_steps(plain, prompt, ids, LOGIT_TOL)
    log(f"  the trained file on the card (f32): 16 greedy ids {bytes((t - 12) % 256 for t in ids)!r}"
        f" held to the plain versions with the ids forced: worst {tf['worst']:.3f} of LOGIT_TOL;"
        f" launches {counts}")
    if tf["worst"] >= 1 or any(counts.get(k, 0) <= 0 for k in ("flash_mqa.f32", "flash_decode.f32")):
        raise RuntimeError(f"the trained model: forced worst {tf['worst']}, launches {counts}")
    out.update(launches=counts, grad_rel_err=grad_rel, forced_worst=tf["worst"],
               seconds=time.perf_counter() - t_phase)
    log(f"  (the training phase took {out['seconds']:.1f} s)")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from ggllm_tpu_torch.core.config import EngineConfig, FalconHParams
    from ggllm_tpu_torch.core.dtypes import GGMLType
    from ggllm_tpu_torch.engine.engine import FalconEngine
    from ggllm_tpu_torch.kernels import build
    from ggllm_tpu_torch.kernels import quant_matmul as qm
    from ggllm_tpu_torch.parallel.plan import HEADROOM_FRACTION
    from ggllm_tpu_torch.utils.benchgen import make_bench_params

    card = smi("name,power.limit")
    log(card)
    kind = torch.cuda.get_device_name(0)
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True, text=True).stdout
    log(f"torch {torch.__version__} cuda {torch.version.cuda} driver {smi('driver_version')}"
        f" nvcc {nvcc.strip().splitlines()[-1]}")
    bw, peak, peak_tf32, peak_f32 = PEAKS["pcie" if "PCIe" in kind else "nvl" if "NVL" in kind
                                          else "sxm"]

    t_start = time.perf_counter()
    log("phase 1: build")
    t0 = time.perf_counter()
    build.lib()
    log(f"  kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ptxas.txt").write_text(build.build_log)
    # phase 4's CLI processes run alongside the SASS report and end before
    # phase 2 starts, so that nothing else runs on the card while it times
    with tempfile.TemporaryDirectory() as d:
        cli = start_cli(d)
        cli180 = cli16 = None
        try:
            cli180 = start_cli_180b(torch, d)
            cli16 = start_cli_16k(torch, d)
            # the GEMVs and the rows kernel decode their codes and scales
            # without int -> float conversions: every format, rows a warp (1,
            # 2), x and y dtype of both GEMVs; n-tiles (1, 2) and cluster
            # sizes (1, 2) of the rows kernel
            from ggllm_tpu_torch.tools.sass_report import parse_rows_sass, parse_sass, sass_text

            text = sass_text(build.BUILD / build.LIB_NAME)
            sass, rows_sass = parse_sass(text), parse_rows_sass(text)
            (out_dir / "sass_gemv.json").write_text(json.dumps(sass, indent=1))
            (out_dir / "sass_rows.json").write_text(json.dumps(rows_sass, indent=1))
            if len(sass) != len(qm.GEMV_LAYOUT) * 2 * 2 * 2 or any(r["I2F"] for r in sass):
                raise RuntimeError(f"GEMV SASS: {len(sass)} kernels, I2F in"
                                   f" {[r for r in sass if r['I2F']]}")
            if (len(rows_sass) != len(qm.KERNEL_FORMATS) * 2 * len(qm.ROWS_CLUSTERS)
                    or any(r["I2F"] for r in rows_sass)):
                raise RuntimeError(f"rows kernel SASS: {len(rows_sass)} kernels, I2F in"
                                   f" {[r for r in rows_sass if r['I2F']]}")
            loops = [(r["ntiles"], r["cluster"], r["loop_instructions"], r["loop_HMMA"])
                     for r in rows_sass if r["format"] == "q4_0"]
            log(f"  quant_mmv_rows: {len(rows_sass)} instantiations, no I2F; q4_0's main loop (two"
                f" units) at (n-tiles, cluster, instructions, HMMA): {loops}")
            for r in sass:  # the instantiations the bf16 decode paths launch
                if (r["x"] == r["y"] == "bfloat16"
                        and r["rows"] == qm.GEMV_ROWS[GGMLType[r["format"].upper()]]):
                    log(f"  quant_gemv_{r['kernel']} {r['format']} {r['rows']} row(s) a warp:"
                        f" {r['instructions']} SASS instructions, no I2F; loop"
                        f" {r['loop_instructions']} ({r['loop_instructions_per_weight']} a weight)")

            # torch.export's first call in a process pays its set-up (imports,
            # the fake-tensor machinery, the ggllm ops' first traces): paid
            # here on a tiny engine, while the CLI processes run, and not in
            # phase_export's first export
            t0 = time.perf_counter()
            tiny = FalconHParams.tiny()
            FalconEngine(tiny, make_bench_params(tiny, device="cuda"),
                         EngineConfig(n_ctx=64, n_batch=16)).export()
            log(f"  torch.export set up in {time.perf_counter() - t0:.1f} s")
            cli_results = wait_cli(cli)
            log(f"  ({time.perf_counter() - t_start:.1f} s since the start)")
            log("phase 4: CLI on GGCC and GGJT files (run alongside the SASS report)")
            check_cli(cli, cli_results)
            check_cli_180b(cli180)
            check_cli_16k(cli16)
        finally:
            for p in cli["procs"] + sum((r["procs"] for r in (cli180, cli16) if r), []):
                if p.poll() is None:
                    p.kill()

    log(f"  ({time.perf_counter() - t_start:.1f} s since the start)")
    log("phase 2: kernels vs plain versions")
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = phase_kernels(torch, Timer(torch), bw, peak, peak_tf32, peak_f32)
    (out_dir / "chip_smoke_kernels.json").write_text(json.dumps({"card": card, "rows": rows}, indent=1))

    log(f"  ({time.perf_counter() - t_start:.1f} s since the start)")
    log("phase 3: full-width main paths")
    paths = []
    def serve_and_score(eng, params, hp, logit_scale):
        log("  -- falcon7b q4_0: the forward exported (torch.export) at S = 300 and 1")
        t0 = time.perf_counter()
        exported = phase_export(torch, eng, "32-layer falcon7b q4_0 bfloat16-cache")
        log(f"  -- falcon7b q4_0: sessions (the export took {time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        sessions = phase_session(torch, eng, params, hp)
        log(f"  -- falcon7b q4_0: speculative decoding (sessions took"
            f" {time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        speculative = phase_speculative(torch, eng, params, hp)
        log(f"  (speculative decoding took {time.perf_counter() - t0:.1f} s)")
        log("  -- falcon7b q4_0: grammar on the single stream")
        t0 = time.perf_counter()
        grammar = phase_grammar(torch, eng, hp)
        log(f"  -- falcon7b q4_0: the server (grammar took {time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        served = phase_server(torch, eng, params, hp)
        log(f"  -- falcon7b q4_0: perplexity and embeddings (the server took"
            f" {time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        scored = phase_scores(torch, eng, params, hp, logit_scale)
        log(f"  (perplexity and embeddings took {time.perf_counter() - t0:.1f} s)")
        log("  -- falcon7b q4_0: continuous batching, 4 rows")
        t0 = time.perf_counter()
        batched = phase_batching(torch, eng, params, hp)
        log(f"  -- falcon7b q4_0: the server with --parallel 4 (batching took"
            f" {time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        parallel = phase_server_parallel(torch, batched.pop("engine"), eng, hp)
        log(f"  -- falcon7b q4_0: batched speculative rounds (--parallel 4 took"
            f" {time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        spec_rows = phase_speculative_rows(torch, eng, params, hp, speculative, batched)
        log(f"  -- falcon7b q4_0: --weight-mode dequant (batched rounds took"
            f" {time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        dequant = phase_dequant(torch, eng, params, hp)
        log(f"  -- falcon7b q4_0: a LoRA adapter at load (--weight-mode dequant took"
            f" {time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        lora = phase_lora(torch, params, hp)
        log(f"  (the LoRA adapter took {time.perf_counter() - t0:.1f} s)")
        log(f"  -- falcon7b q4_0: long context, n_ctx {LONG_CTX}, n_batch {LONG_BATCH}")
        long_context = phase_long_context(torch, eng, params, hp)
        return [exported, sessions, speculative, grammar, served, *scored, batched, parallel,
                spec_rows, dequant, lora, long_context]

    for model, fmt in (("falcon7b", "q4_0"), ("falcon7b", "q4_1"), ("falcon40b", "q4_k")):
        log(f"  -- {model} {fmt}")
        first = (model, fmt) == ("falcon7b", "q4_0")
        paths.append(phase_model(torch, model, fmt, host_route_tokens=32 if first else 0,
                                 then=serve_and_score if first else None))
        paths.extend(paths[-1].pop("then", []))
    log("  -- falcon40b q3_k, int8 cache")
    paths.append(phase_model(torch, "falcon40b", "q3_k", kv_dtype="int8",
                             peak_below=paths[-1]["peak_bytes"]))
    log("  -- falcon180b q2_k (80 layers, one card)")
    t0 = time.perf_counter()
    path180 = phase_model(torch, "falcon180b", "q2_k", peak_below=int(
        (1 - HEADROOM_FRACTION) * torch.cuda.get_device_properties(0).total_memory))
    paths.append(path180)
    log(f"  (falcon180b took {time.perf_counter() - t0:.1f} s)")
    log("  -- llama7b q4_0 (n_rot 128), then its forward exported at S = 300 and 1")
    paths.append(phase_model(torch, "llama7b", "q4_0", then=lambda eng, params, hp, scale: [
        phase_export(torch, eng, "32-layer llama7b q4_0 bfloat16-cache")]))
    paths.extend(paths[-1].pop("then"))
    log("  -- llama7b q4_k, int8 cache")
    paths.append(phase_model(torch, "llama7b", "q4_k", kv_dtype="int8", long_past=1900))
    log(f"  -- the quantize tool: {TOOL_LAYERS}-layer Falcon-7B q4_0 and LLaMA-7B q4_k_m files")
    t0 = time.perf_counter()
    paths.append(phase_quantize(torch))
    log(f"  (the quantize tool took {time.perf_counter() - t0:.1f} s)")
    log("  -- the converters: 2-layer Falcon-7B and LLaMA-7B HF checkpoints, a PEFT adapter")
    t0 = time.perf_counter()
    paths.append(phase_convert(torch))
    log(f"  (the converters took {time.perf_counter() - t0:.1f} s)")
    log("  -- falcon7b q4_0, f32 cache (--memory-f32)")
    paths.append(phase_model(torch, "falcon7b", "q4_0", kv_dtype="float32"))
    log("  -- falcon7b q4_0, 2 layers, float32, then its forward exported at S = 300 and 1")
    paths.append(phase_f32_path(torch, export=True))
    paths.extend(paths[-1].pop("then"))
    log("  -- llama7b q4_0, 2 layers, float32")
    paths.append(phase_f32_path(torch, "llama7b"))
    log("  -- falcon7b q4_0, 32 layers, float32")
    paths.append(phase_f32_path(torch, n_layer=32, graphs=False))
    from ggllm_tpu_torch.parallel.mesh import RankPool

    # two gloo ranks sharing the card and one NCCL rank, shared by both phases
    with (tempfile.TemporaryDirectory() as d, RankPool(2, ["cuda:0", "cuda:0"]) as pool,
          RankPool(1, ["cuda:0"]) as one):
        log("  -- multi-GPU: tensor- and sequence-parallel ranks (parallel/)")
        res, path7b = phase_multi_gpu(torch, d, pool, one)
        paths.append(res)
        log("  -- the fallback tree and the data axis (parallel/sharding.py)")
        paths.append(phase_gspmd(torch, d, pool, one, path7b))
    log("  -- the training demo (tools/train_demo.py)")
    paths.append(phase_train(torch))
    (out_dir / "chip_smoke_paths.json").write_text(json.dumps({"card": card, "paths": paths},
                                                              indent=1))

    log(f"  ({time.perf_counter() - t_start:.1f} s since the start)")

    headline = {  # the JSON line's shape per kernel
        "quant_matmul": "q4_0 wqkvu O=22848 K=4544 S=1",
        "quant_matmul.gemv.kq": "q4_k ffn_up O=32768 K=8192 S=1",
        "quant_matmul.rows": "q4_0 rows w_od O=4544 K=22720 S=4",
        "quant_matmul.tc": "q4_0 wqkvu O=22848 K=4544 S=512",
        "quant_matmul.f32": "q4_0 wqkvu O=22848 K=4544 S=300",
        "group_sums": "S=300 K=22720 g=32",
        "flash_mqa.f32": "S=512 n_past=300 H=71 KV=1",
        "flash_mqa.tc": "S=512 n_past=300 H=71 KV=1",
        "flash_decode_tc": "valid=2047 G=71",
        "flash_decode_tc.int8": "int8 valid=2047 G=71",
        "flash_decode.f32": "f32 valid=300 G=71",
        "flash_decode.mha": "valid=2047 G=1 KV=32",
        "flash_decode.mha.int8": "int8 valid=2047 G=1 KV=32",
    }
    path_long = next(p for p in paths if p["path"].endswith(f"n_ctx {LONG_CTX} n_batch {LONG_BATCH}"))
    kernels = []
    for name, (source, replaces) in REPLACES.items():
        r = next(r for r in rows if r["kernel"] == name and r["shape"].startswith(headline[name]))
        counter = COUNTER.get(name, name)
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": sum(p["launches"].get(counter, 0) for p in paths),
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                 "library_ms": r["library_ms"], "shape": r["shape"]}
        if "f32_core_bound_ms" in r:  # the f32 work's bound on the CUDA cores
            entry["f32_core_bound_ms"] = r["f32_core_bound_ms"]
        if "graph_ms" in r:  # device time: a CUDA graph of one call (or one per layer)
            entry["graph_ms"] = r["graph_ms"]
            entry["library_graph_ms"] = r.get("library_graph_ms")
        if entry["launches"] <= 0:
            raise RuntimeError(f"kernel {name} was launched on none of the main paths")
        if name.startswith("quant_matmul"):
            entry["x_dtype"] = "float32" if name.endswith("f32") else "bfloat16"
        if name == "quant_matmul.rows":
            entry["tile_graph_ms"], entry["rows"] = r["tile_graph_ms"], [2, qm.ROWS_MAX_S]
        if name in ("quant_matmul", "quant_matmul.gemv.kq"):
            entry["formats"] = [f for f in QUANT_FORMATS
                                if (GGMLType[f.upper()] in qm.K_QUANTS) == name.endswith("kq")]
            entry["launches_by_format"] = {
                fmt: sum(p["launches"].get(f"quant_matmul.{fmt}", 0) for p in paths)
                for fmt in entry["formats"]}
        if name == "flash_mqa.f32":
            entry["head_dims"], entry["dtypes"] = [32, 64, 128], ["float32"]
        if name == "flash_mqa.tc":
            entry["head_dims"], entry["dtypes"] = [32, 64, 128], ["bfloat16"]
            entry["head_dim_32"] = [  # no full-width path runs D = 32: its rows here
                {k: r32[k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by")}
                for r32 in rows if r32["kernel"] == name and r32["shape"].endswith("D=32")]
        if name.startswith("flash_decode"):
            entry["cache_dtypes"], entry["head_dims"] = DECODE_LAYOUTS[name]
        r180 = [r for r in rows if r["kernel"] == name
                and any(t in r["shape"] for t in ("180b.", "H=232", "G=29"))]
        if r180:  # the kernel at Falcon-180B's shapes, and its launches on that path
            entry["falcon180b"] = [{k: r[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                                      "library_ms", "bound_ms", "bound_by",
                                                      "graph_ms", "library_graph_ms") if k in r}
                                   for r in r180]
            entry["launches_falcon180b"] = path180["launches"].get(counter, 0)
        long_rows = [r for r in rows if r["kernel"] == name
                     and r["shape"].startswith((f"T={LONG_T} ", f"Tn={LONG_T} "))]
        if long_rows:  # the kernel at the 16k context's lengths, and its launches there
            entry["long_context"] = [{k: r[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                                        "library_ms", "bound_ms", "bound_by",
                                                        "graph_ms", "library_graph_ms") if k in r}
                                     for r in long_rows]
            entry["launches_long_context"] = path_long["launches"].get(counter, 0)
        kernels.append(entry)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
