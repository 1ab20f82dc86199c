"""LoRA adapter ('ggla' v1) reading, writing, and application (a copy of
ggllm_tpu/io/lora.py, plus the application on a torch device).

File format (convert-lora-to-ggml.py:50-75, read back by
llama_apply_lora_from_file_internal, libfalcon.cpp:3927-4172):

  magic u32 'ggla' (bytes "algg"), version u32 = 1, r i32, alpha i32,
  then per tensor: n_dims i32, name_len i32, ftype i32 (0=f32, 1=f16),
  ne[n_dims] i32 (reversed, ggml order), name bytes, pad to 32 B, raw data.

Tensor names are '<base_tensor_name>.loraA' / '.loraB'. Application
(libfalcon.cpp:4100-4160):  W += scaling * (B @ A),  scaling = alpha / r,
with A (r, in) and B (out, r) row-major.

The application is a load-time transform (io/loader.py): the base weight
is dequantized to f32 on the load device (or read from the unquantized
--lora-base model), the delta added there in f32, and the sum kept as a
dense matrix in the compute dtype, as the reference replaces the quantized
tensor with the patched float tensor.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np
import torch

LORA_MAGIC = b"algg"  # 'ggla' as a little-endian u32
LORA_VERSION = 1
_FTYPE_NP = {0: np.float32, 1: np.float16}
_NP_FTYPE = {np.dtype(np.float32): 0, np.dtype(np.float16): 1}


@dataclass
class LoraFile:
    r: int
    alpha: int
    # base tensor name -> {"loraA": (r, in) f32, "loraB": (out, r) f32}
    tensors: dict[str, dict[str, np.ndarray]] = field(default_factory=dict)

    @property
    def scaling(self) -> float:
        return float(self.alpha) / float(self.r)

    def delta(self, base_name: str) -> np.ndarray:
        """scaling * B @ A, f32 (out, in)."""
        t = self.tensors[base_name]
        a = t["loraA"].astype(np.float32)
        b = t["loraB"].astype(np.float32)
        return (b @ a) * np.float32(self.scaling)

    def shape(self, base_name: str) -> tuple[int, int]:
        """(out, in) of the weight the pair patches."""
        t = self.tensors[base_name]
        return t["loraB"].shape[0], t["loraA"].shape[1]


def write_lora(path: str, r: int, alpha: int,
               tensors: dict[str, dict[str, np.ndarray]]) -> None:
    with open(path, "wb") as f:
        f.write(LORA_MAGIC)
        f.write(struct.pack("<iii", LORA_VERSION, r, alpha))
        for base, ab in tensors.items():
            for suffix in ("loraA", "loraB"):
                arr = ab[suffix]
                if suffix == "loraA":
                    # the reference stores A transposed, (in, r) in numpy order
                    # (convert-lora-to-ggml.py:119 `v = v.T`, consumed by
                    # llama.cpp:2940 base ne[0] == loraA ne[1])
                    arr = arr.T
                arr = np.ascontiguousarray(arr)
                name = f"{base}.{suffix}".encode()
                f.write(struct.pack("<iii", arr.ndim, len(name), _NP_FTYPE[arr.dtype]))
                # ggml ne order: fastest dim first (reverse of numpy shape)
                f.write(struct.pack(f"<{arr.ndim}i", *arr.shape[::-1]))
                f.write(name)
                f.write(b"\x00" * (-f.tell() % 32))
                f.write(arr.tobytes())


def read_lora(path: str) -> LoraFile:
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != LORA_MAGIC:
        raise ValueError(f"{path}: bad lora magic {data[:4]!r}")
    version, r, alpha = struct.unpack_from("<iii", data, 4)
    if version != LORA_VERSION:
        raise ValueError(f"{path}: unsupported lora version {version}")
    lf = LoraFile(r=r, alpha=alpha)
    off = 16
    while off + 12 <= len(data):
        n_dims, name_len, ftype = struct.unpack_from("<iii", data, off)
        off += 12
        ne = struct.unpack_from(f"<{n_dims}i", data, off)
        off += 4 * n_dims
        name = data[off:off + name_len].decode()
        off += name_len
        off += -off % 32
        shape = tuple(reversed(ne))  # numpy order
        dt = _FTYPE_NP[ftype]
        n = int(np.prod(shape))
        arr = np.frombuffer(data, dtype=dt, count=n, offset=off).reshape(shape)
        off += n * np.dtype(dt).itemsize
        if ".lora" not in name:
            raise ValueError(f"{path}: '{name}' is not a lora tensor")
        base, suffix = name.rsplit(".", 1)
        if suffix == "loraA":
            arr = arr.T  # stored transposed on disk; the API keeps (r, in)
        lf.tensors.setdefault(base, {})[suffix] = np.asarray(arr)
    for base, ab in lf.tensors.items():
        if "loraA" not in ab or "loraB" not in ab:
            raise ValueError(f"{path}: incomplete lora pair for '{base}'")
    return lf


def apply_to_matrix(w_f32: np.ndarray, lf: LoraFile, base_name: str) -> np.ndarray:
    """Dense f32 (out, in) base weight + scaled delta."""
    d = lf.delta(base_name)
    if d.shape != w_f32.shape:
        raise ValueError(f"lora '{base_name}': delta shape {d.shape} != weight {w_f32.shape}")
    return w_f32 + d


def apply_to_tensor(w_f32: torch.Tensor, lf: LoraFile, base_name: str) -> torch.Tensor:
    """apply_to_matrix on w_f32's device: scaling * (B @ A) in f32 (no TF32
    on the card) added to the f32 base weight."""
    if lf.shape(base_name) != tuple(w_f32.shape):
        raise ValueError(f"lora '{base_name}': delta shape {lf.shape(base_name)} != weight"
                         f" {tuple(w_f32.shape)}")
    t = lf.tensors[base_name]
    a, b = (torch.from_numpy(np.array(t[k], dtype=np.float32)).to(w_f32.device)
            for k in ("loraA", "loraB"))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        d = b @ a
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return w_f32 + d * lf.scaling
