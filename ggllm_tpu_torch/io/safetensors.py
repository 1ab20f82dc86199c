"""A reader of the safetensors format, without the `safetensors` package.

A file is a u64 little-endian header length N, then N bytes of JSON
{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{...}}, then the raw little-endian data, each tensor at its offsets from
the end of the header. Tensors are read from a memory map: the dtypes numpy
knows as numpy reads them, BF16 widened exactly to f32 (its 16 bits are the
top half of the f32 word). iter_tensors gives names in sorted order, as the
safetensors package's safe_open(...).keys() does; load_file in the order of
the data, as its safetensors.numpy.load_file does.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
          "I32": np.int32, "I16": np.int16, "I8": np.int8, "U64": np.uint64,
          "U32": np.uint32, "U16": np.uint16, "U8": np.uint8, "BOOL": np.bool_,
          "BF16": np.uint16}


def read_header(path: str | Path) -> tuple[dict, int]:
    """({name: {"dtype", "shape", "data_offsets"}}, the data's file offset)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns (uint16) -> the same values in f32, exactly."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def iter_tensors(path: str | Path, by_offset: bool = False):
    """Yield (name, numpy array) of every tensor in `path`, names sorted
    (by_offset: in the order of their data)."""
    header, start = read_header(path)
    data = np.memmap(path, dtype=np.uint8, mode="r")
    key = (lambda n: header[n]["data_offsets"][0]) if by_offset else None
    for name in sorted(header, key=key):
        info = header[name]
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: {name}: dtype {info['dtype']} is not supported")
        lo, hi = info["data_offsets"]
        arr = data[start + lo:start + hi].view(DTYPES[info["dtype"]]).reshape(info["shape"])
        yield name, bf16_to_f32(arr) if info["dtype"] == "BF16" else arr


def load_file(path: str | Path) -> dict[str, np.ndarray]:
    """Every tensor of `path` as {name: numpy array}, in the order of their
    data (safetensors.numpy's load_file, with BF16 widened to f32)."""
    return dict(iter_tensors(path, by_offset=True))
