"""Build, load and bind the hand-written CUDA kernels.

Every `ggllm_tpu_torch/csrc/*.cu` file is compiled by `nvcc` for `sm_90a`
(one process per source, all started together) and linked into
`build/libggllm_kernels.so` at the repository root on first use. A stamp
file holds a hash of the sources and flags, so a later process reuses the
library until a source changes. The library has a plain C interface and is
loaded with ctypes: every pointer and the stream pass as `c_void_p`, every
size as `c_int`, and each entry point returns `cudaGetLastError()`.

`launch_counts` counts successful kernel launches per wrapper name (and per
variant, as "quant_matmul.q3_k" or "flash_decode.int8"); a wrapper adds one
right after its launch returned 0 and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent.parent / "build"
LIB_NAME = "libggllm_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# cache, cache_kind, scales, layer, q, q_is_bf16, valid_vec, valid, append,
# n_append, append_valid, out, acc, m, l, part_acc, part_ml, counters, L, B, T,
# KV, G, D, n_split, chunk, workspace splits, stream
DECODE_ARGS = [P, I, P, I, P, I, P, I, P, I, I, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P]
# C entry points: name -> argtypes (all return int = cudaError_t)
SIGNATURES = {
    # gtype, x, x_is_bf16, qs, qh, d, m, sc, scm, xg, y, y_is_bf16, S, K, O, stream
    "gq_quant_matmul": [I, P, I, P, P, P, P, P, P, P, P, I, I, I, I, P],
    # gtype, x, x_is_bf16, qs, qh, d, m, sc, scm, y, y_is_bf16, K, O, W rows a warp, stream
    "gq_quant_gemv_kq": [I, P, I, P, P, P, P, P, P, P, I, I, I, I, P],
    "gq_quant_gemv_legacy": [I, P, I, P, P, P, P, P, P, P, I, I, I, I, P],
    # gtype, x (bf16), qs, qh, d, m, sc, scm, y, y_is_f32, S, K, O, x rows per block, stream
    "gq_quant_matmul_tc": [I, P, P, P, P, P, P, P, P, I, I, I, I, I, P],
    # x, x_is_bf16, xg, S, K, group, stream
    "gq_group_sums": [P, I, P, I, I, I, P],
    # q, k, v, out, is_bf16, n_past_vec, n_past, B, S, H, T, KV, D,
    # k_batch_stride, k_time_stride, stream
    "gq_flash_mqa": [P, P, P, P, I, P, I, I, I, I, I, I, I, I, I, P],
    # q, k, v, out (bf16), n_past_vec, n_past, B, S, H, T, KV, D, k_batch_stride,
    # k_time_stride (long long), stream
    "gq_flash_mqa_tc": [P, P, P, P, P, I, I, I, I, I, I, I, L, L, P],
    # one-launch flash-decode (flash_decode.cu: G == 1 and SIMT; flash_decode_tc.cu)
    "gq_decode": DECODE_ARGS,
    "gq_decode_tc": DECODE_ARGS,
}

launch_counts: collections.Counter = collections.Counter()
build_log: str = ""  # nvcc's output of this process's build (-Xptxas -v report)

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def _stamp(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile csrc/*.cu into build/libggllm_kernels.so unless the stamp
    matches; returns the library path. Raises on any compiler error."""
    global build_log
    sources = sorted(CSRC.glob("*.cu"))
    lib = BUILD / LIB_NAME
    stamp_file = BUILD / (LIB_NAME + ".stamp")
    stamp = _stamp(sources + sorted(CSRC.glob("*.cuh")))
    if lib.exists() and stamp_file.exists() and stamp_file.read_text() == stamp:
        return lib
    obj_dir = BUILD / "obj"
    obj_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in sources:  # one nvcc per source, all running at once
        obj = obj_dir / (src.stem + ".o")
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
    tmp = BUILD / (LIB_NAME + f".tmp{os.getpid()}")
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)
    stamp_file.write_text(stamp)
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def launch(name: str, counters, *args) -> None:
    """Call C entry point `name` and raise on a nonzero cudaError_t; on
    success count one launch under `counters` (a name, or a tuple of the
    wrapper's name and its variant's)."""
    err = getattr(lib(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: cudaError_t {err}")
    for counter in (counters,) if isinstance(counters, str) else counters:
        launch_counts[counter] += 1


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
