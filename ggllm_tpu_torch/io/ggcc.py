"""GGCC / GGJT / GGMF / GGML model file reader, GGCC v10 writer (Falcon)
and GGJT v3 writer (LLaMA): a copy of ggllm_tpu/io/ggcc.py.

File format parity with the reference loader/saver (libfalcon.cpp:770-1052):

header        magic u32 ('ggcc'=0x67676363), version u32 (10)
hparams       n_vocab, n_embd, n_head, n_head_kv, n_layer, n_falcon_type,
              ftype, [n_bpe_merges if GGCC]   (all u32); a LLaMA GGJT file:
              n_vocab, n_embd, n_mult, n_head, n_layer, n_rot, ftype
vocab         n_vocab x { len u32, bytes, score f32 }
merges        [GGCC only] count u32, count x { len1 u32, str1, len2 u32, str2 }
tensors       repeated { n_dims u32, name_len u32, type u32, ne u32[n_dims],
              name bytes, pad to 32B (GGJT+), raw data }

Note on shapes: ne[] is in ggml order (ne[0] = contiguous row length). A ggml
2-D tensor [ne0, ne1] corresponds to numpy shape (ne1, ne0); TensorRecord
keeps ggml order in `ne` and exposes numpy convention via `shape`.
"""

from __future__ import annotations

import struct
import threading
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ggllm_tpu_torch.core.config import FalconHParams, LlamaHParams
from ggllm_tpu_torch.core.dtypes import FType, GGMLType, row_nbytes
from ggllm_tpu_torch.quant import registry
from ggllm_tpu_torch.tokenizer.bpe import Vocab

MAGIC_GGML = 0x67676D6C
MAGIC_GGMF = 0x67676D66
MAGIC_GGJT = 0x67676A74
MAGIC_GGCC = 0x67676363

GGCC_VERSION = 10

# internal version lattice, mirroring llama_file_version
V_GGML = 0
V_GGMF_1 = 1
V_GGJT_1 = 2
V_GGJT_2 = 3
V_GGJT_3 = 4
V_GGCC_1 = 5


# multi-file split types (llama legacy multipart, libfalcon.cpp:665-715):
# 1-D tensors duplicate per part; tok_embeddings / wo / w2 split by columns
# (ne[0] multiplies), everything else by rows (ne[1] multiplies)
SPLIT_NONE, SPLIT_BY_COLUMNS, SPLIT_BY_ROWS = 0, 1, 2
_COLUMN_SPLIT_NAMES = ("tok_embeddings.",)
_COLUMN_SPLIT_SUBSTR = (".attention.wo.weight", ".feed_forward.w2.weight")


@dataclass
class TensorRecord:
    name: str
    gtype: GGMLType
    ne: tuple  # ggml dim order: ne[0] is the contiguous (row) dim (GLOBAL)
    offset: int  # byte offset of data in the first owning file
    nbytes: int  # total bytes across shards
    # multipart: per-shard (file_idx, offset); single-file tensors have one
    shards: list = field(default_factory=list)
    shard_ne: tuple = ()  # per-shard ggml shape (== ne when single shard)

    @property
    def shape(self) -> tuple:
        """numpy-convention shape (row-major, last dim contiguous)."""
        return tuple(reversed(self.ne))

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.ne:
            n *= d
        return n


_MM_LOCK = threading.Lock()


@dataclass
class ModelFile:
    path: str
    version: int
    hparams: FalconHParams | LlamaHParams
    vocab: Vocab
    tensors: dict[str, TensorRecord] = field(default_factory=dict)
    paths: list = field(default_factory=list)  # all part files (index 0 = path)

    @property
    def arch(self) -> str:
        return self.hparams.arch

    _mm: dict = None

    def _data(self, idx: int = 0) -> np.memmap:
        # guarded: the loader repacks layers from worker threads
        with _MM_LOCK:
            if self._mm is None:
                self._mm = {}
            if idx not in self._mm:
                p = self.paths[idx] if self.paths else self.path
                self._mm[idx] = np.memmap(p, dtype=np.uint8, mode="r")
            return self._mm[idx]

    def tensor_blob(self, name: str) -> np.ndarray:
        """Raw packed bytes of a tensor. Zero-copy for single-file tensors;
        multipart shards assemble per the split type (BY_ROWS concatenates
        shard row blocks, BY_COLUMNS interleaves per-row segments —
        libfalcon.cpp load_data_for, :1272-1316)."""
        t = self.tensors[name]
        if len(t.shards) <= 1:
            return self._data(t.shards[0][0] if t.shards else 0)[
                t.offset : t.offset + t.nbytes]
        shard_bytes = t.nbytes // len(t.shards)
        split = _split_type(t.name, len(t.ne), len(t.shards))
        if split == SPLIT_NONE:  # 1-D duplicated: take the first
            fi, off = t.shards[0]
            return self._data(fi)[off : off + t.nbytes]
        parts = [self._data(fi)[off : off + shard_bytes] for fi, off in t.shards]
        if split == SPLIT_BY_ROWS:
            return np.concatenate(parts)
        # BY_COLUMNS: each output row = concat of every shard's row segment
        n_rows = t.ne[1]
        per_row = shard_bytes // n_rows
        stacked = np.stack([p.reshape(n_rows, per_row) for p in parts], axis=1)
        return np.ascontiguousarray(stacked).reshape(-1)

    def tensor_f32(self, name: str) -> np.ndarray:
        """Dequantized float32 tensor in numpy-convention shape."""
        t = self.tensors[name]
        return registry.dequantize(t.gtype, self.tensor_blob(name), t.n_elements).reshape(t.shape)

    def close(self):
        self._mm = None


def _split_type(name: str, n_dims: int, n_shards: int) -> int:
    if n_dims == 1 or n_shards == 1:
        return SPLIT_NONE
    if name.startswith(_COLUMN_SPLIT_NAMES) or any(
            s in name for s in _COLUMN_SPLIT_SUBSTR):
        return SPLIT_BY_COLUMNS
    return SPLIT_BY_ROWS


def _read_u32(f) -> int:
    return struct.unpack("<I", f.read(4))[0]


def _read_f32(f) -> float:
    return struct.unpack("<f", f.read(4))[0]


def _detect_arch(version: int, raw: tuple) -> str:
    """Pre-GGCC files carry 7 u32 hparams for BOTH model families; the
    reference disambiguates by binary (llama.cpp vs libfalcon.cpp). Here:
    llama iff field5 == n_embd // field3 (n_rot == head_dim); falcon iff
    field5 in {7, 40, 180} (n_falcon_type)."""
    n_vocab, n_embd, f2, f3, f4, f5, ftype = raw
    if f5 in (7, 40, 180) and f2 and n_embd % f2 == 0:
        return "falcon"
    if f3 and n_embd % f3 == 0 and f5 == n_embd // f3:
        return "llama"
    return "falcon"


def read_model(path: str | Path, load_merges: bool = True,
               arch: str = "auto") -> ModelFile:
    """Parse a model file's header, vocab, merges and tensor metadata.

    arch: "auto" (GGCC -> falcon; pre-GGCC -> heuristic over the 7-field
    hparams header), or explicit "falcon"/"llama".

    Legacy multipart files (base + ".1", ".2", ... siblings; llama multipart,
    libfalcon.cpp:1062-1079) are detected and their tensor shards recorded;
    pre-GGCC falcon files load BPE merges from an adjacent tokenizer.json
    (libfalcon.cpp:880-914)."""
    path = str(path)
    model = _read_one_file(path, load_merges=load_merges, arch=arch)
    model.paths = [path]
    # multipart siblings: model.bin.1, model.bin.2, ...
    i = 1
    while Path(f"{path}.{i}").exists():
        part = _read_one_file(f"{path}.{i}", load_merges=False,
                              arch=model.arch, tensors_into=model.tensors,
                              file_idx=i)
        if (part.hparams.n_vocab != model.hparams.n_vocab
                or part.hparams.n_embd != model.hparams.n_embd):
            raise ValueError(f"{path}.{i}: hparams inconsistent between parts")
        model.paths.append(f"{path}.{i}")
        i += 1
    _finalize_shards(model)
    if (model.arch == "falcon" and model.version < V_GGCC_1 and load_merges
            and not model.vocab.merges):
        model.vocab.merges = _merges_from_tokenizer_json(path)
        model.hparams.n_bpe_merges = len(model.vocab.merges)
        model.vocab.__post_init__()  # rebuild ranks from the new merges
    return model


def _merges_from_tokenizer_json(model_path: str) -> list[tuple[str, str]]:
    """Pre-GGCC falcon fallback: BPE merges from tokenizer.json next to the
    model file (libfalcon.cpp:880-914 parse_json_to_bpe_merges)."""
    import json

    tj = Path(model_path).parent / "tokenizer.json"
    if not tj.exists():
        raise ValueError(
            f"pre-GGCC falcon file has no embedded BPE merges; place the "
            f"model's tokenizer.json at {tj}")
    with open(tj, encoding="utf-8") as f:
        data = json.load(f)
    raw = data.get("model", {}).get("merges", [])
    merges: list[tuple[str, str]] = []
    for m in raw:
        if isinstance(m, str):
            a, _, b = m.partition(" ")
        else:
            a, b = m[0], m[1]
        if a and b:
            merges.append((a, b))
    if not merges:
        raise ValueError(f"no valid BPE merges found in {tj}")
    return merges


def _finalize_shards(model: ModelFile):
    """Resolve global shapes/sizes for multipart tensors."""
    for t in model.tensors.values():
        n = len(t.shards)
        if n <= 1:
            continue
        split = _split_type(t.name, len(t.shard_ne), n)
        ne = t.shard_ne
        if split == SPLIT_NONE:  # duplicated 1-D: one copy is the tensor
            t.ne = ne
            t.nbytes = row_nbytes(t.gtype, ne[0]) * (ne[1] if len(ne) == 2 else 1)
        elif split == SPLIT_BY_COLUMNS:
            t.ne = (ne[0] * n, ne[1])
        else:  # BY_ROWS
            t.ne = (ne[0], ne[1] * n)


def _read_one_file(path: str, load_merges: bool, arch: str,
                   tensors_into: dict | None = None,
                   file_idx: int = 0) -> ModelFile:
    fsize = Path(path).stat().st_size
    with open(path, "rb") as f:
        magic = _read_u32(f)
        if magic == MAGIC_GGML:
            version = V_GGML
        else:
            ver = _read_u32(f)
            if magic == MAGIC_GGMF and ver == 1:
                version = V_GGMF_1
            elif magic == MAGIC_GGJT and ver in (1, 2, 3):
                version = V_GGJT_1 + (ver - 1)
            elif magic == MAGIC_GGCC and ver == GGCC_VERSION:
                version = V_GGCC_1
            else:
                raise ValueError(
                    f"unknown (magic, version): {magic:08x}, is this a GGML/GGCC file?"
                )

        raw = struct.unpack("<7I", f.read(28))
        # quantized block layouts changed at GGJT v2 (Q4/Q8, PR #1405) and
        # again at v3 (Q5/Q8, PR #1508); the reference refuses older files
        # (llama.cpp:1091-1105) — without this guard they load as garbage
        ftype = raw[6]
        if version < V_GGJT_2 and ftype not in (
                int(FType.ALL_F32), int(FType.MOSTLY_F16), int(FType.MOSTLY_Q8_0)):
            raise ValueError(
                f"{path}: pre-GGJT-v2 quantized file (ftype={ftype}) uses an "
                "obsolete block layout and is no longer supported; requantize "
                "from the original weights")
        if version < V_GGJT_3 and ftype in (
                int(FType.MOSTLY_Q4_0), int(FType.MOSTLY_Q4_1), int(FType.MOSTLY_Q8_0)):
            raise ValueError(
                f"{path}: pre-GGJT-v3 quantized file (ftype={ftype}) uses an "
                "obsolete block layout and is no longer supported; requantize "
                "from the original weights")
        if version >= V_GGCC_1:
            arch = "falcon"
        elif arch == "auto":
            arch = _detect_arch(version, raw)

        if arch == "llama":
            hp = LlamaHParams(
                n_vocab=raw[0], n_embd=raw[1], n_mult=raw[2], n_head=raw[3],
                n_layer=raw[4], n_rot=raw[5], ftype=raw[6],
            )
        else:
            hp = FalconHParams(
                n_vocab=raw[0], n_embd=raw[1], n_head=raw[2], n_head_kv=raw[3],
                n_layer=raw[4], n_falcon_type=raw[5], ftype=raw[6],
                n_bpe_merges=0,
            )
        if version >= V_GGCC_1:
            hp.n_bpe_merges = _read_u32(f)

        id_to_token: list[bytes] = []
        scores: list[float] = []
        for _ in range(hp.n_vocab):
            ln = _read_u32(f)
            tok = f.read(ln)
            score = _read_f32(f) if version >= V_GGMF_1 else 0.0
            id_to_token.append(tok)
            scores.append(score)

        # wizard-vocab hack: shave the trailing [PAD] token (libfalcon.cpp:861-868)
        if version >= V_GGJT_3 and hp.n_vocab == 65025 and id_to_token[65024] == b"[PAD]":
            id_to_token = id_to_token[:65024]
            scores = scores[:65024]
            hp.n_vocab = 65024

        merges: list[tuple[str, str]] = []
        if version >= V_GGCC_1 and load_merges:
            n_merges = _read_u32(f)
            for _ in range(n_merges):
                l1 = _read_u32(f)
                w1 = f.read(l1).decode("utf-8")
                l2 = _read_u32(f)
                w2 = f.read(l2).decode("utf-8")
                merges.append((w1, w2))

        vocab = Vocab(id_to_token=id_to_token, scores=scores, merges=merges)

        model = ModelFile(path=path, version=version, hparams=hp, vocab=vocab)
        tensors = model.tensors if tensors_into is None else tensors_into

        # tensor metadata (shards append for multipart siblings)
        while f.tell() < fsize:
            n_dims = _read_u32(f)
            name_len = _read_u32(f)
            gtype = GGMLType(_read_u32(f))
            ne = tuple(struct.unpack(f"<{n_dims}I", f.read(4 * n_dims)))
            name = f.read(name_len).decode("utf-8")
            if n_dims < 1 or n_dims > 2:
                raise ValueError(f"tensor '{name}' has unsupported n_dims={n_dims}")
            if version >= V_GGJT_1:
                f.seek(-f.tell() & 31, 1)  # align to 32 bytes
            offset = f.tell()
            nbytes = row_nbytes(gtype, ne[0]) * (ne[1] if n_dims == 2 else 1)
            rec = tensors.get(name)
            if rec is None:
                tensors[name] = TensorRecord(
                    name, gtype, ne, offset, nbytes,
                    shards=[(file_idx, offset)], shard_ne=ne)
            else:
                if rec.shard_ne != ne or rec.gtype != gtype:
                    raise ValueError(
                        f"inconsistent shard for '{name}': {ne} vs {rec.shard_ne}")
                rec.shards.append((file_idx, offset))
                rec.nbytes += nbytes
            f.seek(nbytes, 1)

    return model


class GGJTWriter:
    """Streaming GGJT v3 writer for LLaMA-family files (the legacy llama.cpp
    on-disk format; hparams order per llama.cpp:124-133)."""

    def __init__(self, path: str | Path, hparams: LlamaHParams, vocab: Vocab):
        self.f = open(path, "wb")
        self.f.write(struct.pack("<II", MAGIC_GGJT, 3))
        for v in (hparams.n_vocab, hparams.n_embd, hparams.n_mult,
                  hparams.n_head, hparams.n_layer, hparams.n_rot, hparams.ftype):
            self.f.write(struct.pack("<I", v))
        for tok, score in zip(vocab.id_to_token, vocab.scores):
            self.f.write(struct.pack("<I", len(tok)))
            self.f.write(tok)
            self.f.write(struct.pack("<f", score))

    write_tensor = None  # assigned below (shared with GGCCWriter)

    def close(self):
        self.f.close()


class GGCCWriter:
    """Streaming GGCC v10 writer (llama_file_saver, libfalcon.cpp:975-1052)."""

    def __init__(self, path: str | Path, hparams: FalconHParams, vocab: Vocab):
        self.f = open(path, "wb")
        self._write_header(hparams)
        self._write_vocab(vocab)

    def _u32(self, v: int):
        self.f.write(struct.pack("<I", v))

    def _write_header(self, hp: FalconHParams):
        self._u32(MAGIC_GGCC)
        self._u32(GGCC_VERSION)
        for v in (hp.n_vocab, hp.n_embd, hp.n_head, hp.n_head_kv, hp.n_layer,
                  hp.n_falcon_type, hp.ftype, hp.n_bpe_merges):
            self._u32(v)

    def _write_vocab(self, vocab: Vocab):
        for tok, score in zip(vocab.id_to_token, vocab.scores):
            self._u32(len(tok))
            self.f.write(tok)
            self.f.write(struct.pack("<f", score))
        self._u32(len(vocab.merges))
        for w1, w2 in vocab.merges:
            b1, b2 = w1.encode("utf-8"), w2.encode("utf-8")
            self._u32(len(b1))
            self.f.write(b1)
            self._u32(len(b2))
            self.f.write(b2)

    def write_tensor(self, name: str, gtype: GGMLType, ne: tuple, blob: np.ndarray):
        """ne in ggml dim order; blob = packed bytes from quant.registry."""
        expected = row_nbytes(gtype, ne[0]) * (ne[1] if len(ne) == 2 else 1)
        assert blob.nbytes == expected, f"{name}: {blob.nbytes} != {expected}"
        nm = name.encode("utf-8")
        self._u32(len(ne))
        self._u32(len(nm))
        self._u32(int(gtype))
        for d in ne:
            self._u32(d)
        self.f.write(nm)
        pad = -self.f.tell() & 31
        self.f.write(b"\x00" * pad)
        self.f.write(np.ascontiguousarray(blob, dtype=np.uint8).tobytes())

    def write_array(self, name: str, arr: np.ndarray, gtype: GGMLType):
        """Quantize a numpy-convention float array and write it."""
        ne = tuple(reversed(arr.shape))
        blob = registry.quantize(gtype, arr.astype(np.float32))
        self.write_tensor(name, gtype, ne, blob)

    def close(self):
        self.f.close()


# GGJT tensor records share the GGCC layout (32-byte aligned data)
GGJTWriter.write_tensor = GGCCWriter.write_tensor
GGJTWriter._u32 = GGCCWriter._u32
GGJTWriter.write_array = GGCCWriter.write_array
