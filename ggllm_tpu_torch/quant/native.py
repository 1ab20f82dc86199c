"""The C++ block codecs (native/quants.cpp) through ctypes, for the quantize
tool: multithreaded, and bit for bit the numpy codecs of quant/legacy.py and
quant/kquants.py (strict IEEE f32, no FMA contraction).

The library is built with g++ on first use into the repository's build/
directory. There is no quiet fallback: when it cannot be built, `lib()`
raises and the caller picks the numpy codecs itself (quant/registry.py
quantize(native=False), the tool's --numpy).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = ROOT / "native" / "quants.cpp"
BUILD = ROOT / "build"
SO = BUILD / "libggllmq_codecs.so"
FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off", "-pthread"]

_lock = threading.Lock()
_lib = None


def lib() -> ctypes.CDLL:
    """The loaded codec library, built on first call; raises when g++ or the
    source is missing or the build fails."""
    global _lib
    with _lock:
        if _lib is None:
            if not SO.exists() or SO.stat().st_mtime < SOURCE.stat().st_mtime:
                BUILD.mkdir(exist_ok=True)
                tmp = SO.with_suffix(f".{os.getpid()}.so")
                r = subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SOURCE)],
                                   capture_output=True, text=True, timeout=300)
                if r.returncode != 0:
                    raise RuntimeError(f"building {SOURCE.name} failed:\n{r.stderr}")
                tmp.replace(SO)
            handle = ctypes.CDLL(str(SO))
            for name in ("gq_quantize", "gq_dequantize"):
                fn = getattr(handle, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int64, ctypes.c_int]
            handle.gq_block_size.restype = ctypes.c_int
            handle.gq_type_size.restype = ctypes.c_int
            _lib = handle
        return _lib


def _threads(nthreads: int) -> int:
    return nthreads or min(16, os.cpu_count() or 1)


def quantize(gtype: int, x: np.ndarray, nthreads: int = 0) -> np.ndarray:
    """float32 array (a whole number of blocks) -> packed uint8 blob."""
    h = lib()
    bs, ts = h.gq_block_size(int(gtype)), h.gq_type_size(int(gtype))
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if bs == 0 or x.size % bs:
        raise ValueError(f"native quantize: type {int(gtype)}, {x.size} elements")
    out = np.empty(x.size // bs * ts, dtype=np.uint8)
    if h.gq_quantize(int(gtype), x.ctypes.data, out.ctypes.data, x.size // bs, _threads(nthreads)):
        raise ValueError(f"native quantize: type {int(gtype)} has no quantizer")
    return out


def dequantize(gtype: int, blob: np.ndarray, n: int, nthreads: int = 0) -> np.ndarray:
    """packed uint8 blob -> float32 array of n elements (a whole number of
    blocks)."""
    h = lib()
    bs, ts = h.gq_block_size(int(gtype)), h.gq_type_size(int(gtype))
    blob = np.ascontiguousarray(blob, dtype=np.uint8)
    if bs == 0 or n % bs or blob.nbytes < n // bs * ts:
        raise ValueError(f"native dequantize: type {int(gtype)}, {n} elements")
    out = np.empty(n, dtype=np.float32)
    if h.gq_dequantize(int(gtype), blob.ctypes.data, out.ctypes.data, n // bs, _threads(nthreads)):
        raise ValueError(f"native dequantize: type {int(gtype)} has no dequantizer")
    return out
