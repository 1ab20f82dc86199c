"""Single-stream inference engine (port of the single-stream part of
ggllm_tpu/engine/engine.py FalconEngine:143).

Prefill runs eagerly, each n_batch chunk at its own length (no power-of-two
buckets). Decoding is the counterpart of the JAX engine's fused loop
(`_decode_loop_fn:495`, one jitted lax.scan of forward, penalties, sampling
and the penalty ring): on the card a chunk of n_steps tokens is ONE CUDA
graph, captured once per key (n_steps and the sampler's shape:
ops/sampling_device.py sampler_key) with the step index j unrolled, and
replayed. Its static inputs (the first token, n_past, the ring, the ring
position, the chunk's uniforms, the sampler's temperature, top-p, penalty
and bias values) are written by device copies before each replay and its
token ids are copied out after it, so a new temperature or penalty value
captures nothing; the graphs of an engine share one memory pool, and at
most MAX_CHUNKS programs are kept. Capture time
goes to Timings.t_compile_us, as the JAX engine books its compiles. On the
CPU (device="cpu"), or on the card when the caller passes eager=True, the
same step body runs eagerly on the same buffers. A failed capture raises,
naming the step; nothing falls back to the eager body.

With a dense cache each layer writes its K/V into the cache in place (at a
device position, by an indexed copy) before attending, which gives the JAX
engine's numbers because its pending buffer has the cache's dtype. With an
int8 cache decoding runs the JAX engine's chunk-deferred scheme
(engine.py:542-585): the chunk's K/V stay unquantized in a pending buffer
in the compute dtype, attention reads the quantized cache below the
chunk's start plus that buffer, and one quantizing write ends the chunk.
The cache's storage lives as long as the engine (`reset` zeroes it in
place), since captured graphs point at it; assigning `kv` drops them.

decode_chunk_masked runs the same chunks under a grammar's mask (the JAX
engine's _masked_step_fn:733 / decode_chunk_masked:799): the chunk's key is
masked, its packed mask bits (ops/grammar.py valid_bits) are one more
static input written before each replay, so a new mask captures nothing,
and the mask is applied before the bias and the penalties. The mask holds
for the whole chunk: the caller (engine/generator.py) consumes ids up to
the grammar state's first change and rolls the rest back.

With batch_size B > 1 (the JAX engine's batched entry points,
engine.py:917-1310, which engine/batching.py's ContinuousBatcher drives) the
cache holds B rows, each at its own position, and the single-stream entry
points refuse. prefill_rows forwards all B rows at once, admitted rows at
their prompts' positions and the others at their live or parked positions,
whose writes land beyond their n_past (the stale-cache invariant);
decode_rows runs n_steps steps of all B rows with a (B,) n_past and per-row
sampler values (ops/sampling_device.py RowValues) as device tensors, on the
card as one CUDA graph a chunk key (n_steps and RowKey), captured and
replayed as the single stream's, sharing MAX_CHUNKS and the memory pool.

Under a mesh (parallel/mesh.py; the JAX engine's mesh branches,
engine.py:159-218) every rank runs an engine on its own device with the
same calls, SPMD: cfg.kv_shard "heads" is tensor parallelism (params from
io/loader.py load_params(mesh=): this rank's weight blocks, the model at its
local head and FFN counts, the mesh's psum after each layer's output
projection, a cache of its K/V heads) or, for a tree the plan cannot take,
the fallback tree (params["split"]: models/falcon.py SplitFalcon, each
weight split as parallel/sharding.py says, the cache's K/V heads split where
kv_specs splits them); "sequence" the sequence-parallel Falcon of
parallel/sp.py (whole weights, the cache's time axis split, kv_T a multiple
of the ranks). Under the fallback tree a mesh's data axis splits a B-row
engine's rows where kv_specs does (data | B, B >= data): each data row of
ranks caches and computes its B / data rows ([row0, row0 + rows)), while
prefill_rows and decode_rows take and return all B rows, gathering the
logits, ids and mirostat state over the data axis after each call (outside
any captured graph; every rank draws all B rows' uniforms), and the
timings count all B rows' tokens, against this rank's time. The logits are
the same on every rank, and so is the device generator (seeded from the
sampler's seed, 0 for -1), so every rank draws the same ids on the device;
the host cascade's draws agree only where the ranks' samplers share a seed
(the CLI sends rank 0's seed to every rank for --seed -1). Under NCCL the
decode chunks stay CUDA graphs with the collectives inside (one collective
runs eagerly at construction, before any capture); gloo collectives cannot
be captured, so a gloo engine on the card decodes through the eager step
body and says so once on stderr.
"""

from __future__ import annotations

import sys
import time
from collections import OrderedDict
from dataclasses import dataclass, replace

import numpy as np
import torch

from ggllm_tpu_torch.core.config import EngineConfig, FalconHParams, LlamaHParams
from ggllm_tpu_torch.core.device import resolve_device
from ggllm_tpu_torch.kernels import build, flash_decode
from ggllm_tpu_torch.models import resolve_model
from ggllm_tpu_torch.ops import kvcache, sampling, sampling_device
from ggllm_tpu_torch.ops.rope import rope_angles
from ggllm_tpu_torch.tokenizer import nl_id

DECODE_CHUNK = 16
MAX_CHUNKS = 8  # decode-chunk programs (graphs) an engine keeps, least recently used out


@dataclass
class Timings:
    """falcon_print_timings fields (libfalcon.cpp:4700-4715)."""

    t_load_us: float = 0.0
    t_compile_us: float = 0.0  # one-time CUDA graph captures, kept out of
    t_sample_us: float = 0.0   # the per-token buckets so that short runs
    t_prefill_us: float = 0.0  # report steady-state numbers
    t_decode_us: float = 0.0
    n_sample: int = 0
    n_prefill: int = 0
    n_decode: int = 0

    def report(self) -> str:
        lines = [f"load time       = {self.t_load_us / 1000:.2f} ms"]
        if self.t_compile_us:
            lines.append(
                f"compile time    = {self.t_compile_us / 1000:.2f} ms"
                " (one-time CUDA graph captures of the decode chunks)")
        if self.n_sample:
            lines.append(
                f"sample time     = {self.t_sample_us / 1000:.2f} ms / {self.n_sample} runs"
                f" ({self.t_sample_us / 1000 / max(1, self.n_sample):.2f} ms per token,"
                f" {self.n_sample / max(1e-9, self.t_sample_us / 1e6):.2f} tokens per second)")
        if self.n_prefill:
            lines.append(
                f"batch eval time = {self.t_prefill_us / 1000:.2f} ms / {self.n_prefill} tokens"
                f" ({self.t_prefill_us / 1000 / max(1, self.n_prefill):.2f} ms per token,"
                f" {self.n_prefill / max(1e-9, self.t_prefill_us / 1e6):.2f} tokens per second)")
        if self.n_decode:
            lines.append(
                f"eval time       = {self.t_decode_us / 1000:.2f} ms / {self.n_decode} runs"
                f" ({self.t_decode_us / 1000 / max(1, self.n_decode):.2f} ms per token,"
                f" {self.n_decode / max(1e-9, self.t_decode_us / 1e6):.2f} tokens per second)")
        return "\n".join(lines)


class _Chunk:
    """One decode-chunk program: its key (n_steps and the sampler's shape,
    sampling_device.sampler_key), the static buffers its steps read and
    write (the sampler's values among them), and its CUDA graph once
    captured."""

    def __init__(self, n_steps: int, key: sampling_device.SamplerKey, n_vocab: int, device):
        self.n_steps, self.key, self.L = n_steps, key, key.ring  # L: the penalty ring's length
        self.sv = sampling_device.SamplerValues(key, device, n_vocab)
        self.tok = torch.zeros(1, dtype=torch.long, device=device)
        self.n_past = torch.zeros(1, dtype=torch.int32, device=device)
        self.ring = torch.full((self.L,), n_vocab, dtype=torch.long, device=device)
        self.pos = torch.zeros(1, dtype=torch.long, device=device)
        self.u = None if key.greedy else torch.full((n_steps,), 0.5, device=device)
        self.out = torch.zeros(n_steps, dtype=torch.long, device=device)
        pin = device.type == "cuda"
        self.host = [torch.empty(n_steps, dtype=torch.long, pin_memory=pin) for _ in range(2)]
        self.done = [torch.cuda.Event() if pin else None for _ in range(2)]
        self.graph: build.Graph | None = None


class _RowChunk:
    """One B-row decode-chunk program: its key (n_steps and the rows'
    sampling_device.RowKey), the static buffers its steps read and write
    (each row's token, n_past, penalty ring and ring position, the chunk's
    (n_steps, B) uniforms, the per-row sampler values and mirostat mu, and
    under a masked key the rows' grammar masks), and its CUDA graph once
    captured."""

    def __init__(self, n_steps: int, key: sampling_device.RowKey, B: int, n_vocab: int, device):
        self.n_steps, self.key, self.L = n_steps, key, key.ring
        self.rv = sampling_device.RowValues(key, B, device, n_vocab)
        self.tok = torch.zeros(B, dtype=torch.long, device=device)
        self.n_past = torch.zeros(B, dtype=torch.int32, device=device)
        self.ring = torch.full((B, key.ring), n_vocab, dtype=torch.long, device=device)
        self.pos = torch.zeros(B, dtype=torch.long, device=device)
        self.u = torch.full((n_steps, B), 0.5, device=device)
        self.out = torch.zeros(n_steps, B, dtype=torch.long, device=device)
        self.graph: build.Graph | None = None


def _chunk_forward(model: torch.nn.Module, inv_freq: torch.Tensor) -> torch.nn.Module:
    """`model` as a module of forward(tokens, kv, n_past) with inv_freq a
    buffer, for torch.export: an instance of a subclass of the model's class
    that shares its submodules and buffers (the same tensors, under the
    same names), so that the program's buffers carry the tree keys."""

    class ChunkForward(type(model)):
        def forward(self, tokens, kv, n_past):
            return super().forward(tokens, kv, n_past, self.inv_freq)

    m = ChunkForward.__new__(ChunkForward)
    torch.nn.Module.__init__(m)
    for name, value in vars(model).items():
        if not name.startswith("_") and name != "training":
            setattr(m, name, value)
    for name, child in model.named_children():
        m.add_module(name, child)
    for name, buf in model.named_buffers(recurse=False):
        m.register_buffer(name, buf)
    m.register_buffer("inv_freq", inv_freq, persistent=False)
    return m.train(model.training)


def kv_len(cfg: EngineConfig, sp: int = 0) -> int:
    """The cache's time dim (an engine's kv_T): n_ctx plus the JAX engine's
    scratch region, so the cache has the same shape in both packages;
    sequence-parallel over sp ranks, rounded up to a multiple of them
    (kv_T:231)."""
    t = cfg.n_ctx + max(cfg.n_batch, DECODE_CHUNK, cfg.decode_chunk)
    return -(-t // sp) * sp if sp else t


class FalconEngine:
    """Single-model, single-stream inference engine for both model families
    (the model is resolved by hparams.arch; the class keeps the JAX
    engine's name).

    device: None (the default) runs on the CUDA card and raises when CUDA
    is missing; device="cpu" runs the kernels' plain versions on the CPU.
    cfg.kernel_layout / cfg.flash_attention set to False route the
    quantized matmuls / attention through the plain versions on any
    device (the reference path the kernels are held against). On the card
    with flash attention on, a head shape that the decode kernels do not
    take raises here (kernels/flash_decode.py supports). penalize_nl=False
    exempts the newline id of the model family's vocabulary from the
    penalties (tokenizer.nl_id: 193 for Falcon, 13 for LLaMA).

    batch_size B > 1 gives the cache B rows for prefill_row / prefill_rows /
    decode_rows (continuous batching, engine/batching.py); the
    single-stream entry points then refuse.

    mesh: this rank's parallel/mesh.py Mesh (the engine runs on its
    device); see the module docstring. Every rank makes the same calls."""

    def __init__(self, hparams: FalconHParams | LlamaHParams, params: dict,
                 cfg: EngineConfig | None = None, device=None, batch_size: int = 1,
                 mesh=None):
        self.device = resolve_device(mesh.device if mesh is not None else device)
        self.hp = hparams
        self.cfg = cfg or EngineConfig()
        if batch_size < 1:
            raise ValueError(f"batch_size {batch_size}")
        self.batch = batch_size
        self.rows, self.row0 = batch_size, 0  # this rank's cache rows: [row0, row0 + rows)
        self.nl_token = nl_id(hparams.arch)
        self.mesh, self.tp_plan, self.sp, self.split = mesh, None, 0, None
        self.st, model_cls = resolve_model(
            hparams, flash=self.cfg.flash_attention is not False,
            kernels=self.cfg.kernel_layout is not False)
        whole = self.st
        if mesh is not None and self.cfg.kv_shard == "sequence":
            if hparams.arch != "falcon":
                raise NotImplementedError("sequence-parallel: falcon only")
            self.sp = mesh.model
        elif mesh is not None and "split" in params:  # the fallback tree (parallel/sharding.py)
            from ggllm_tpu_torch.parallel import sharding

            self.split = params["split"]
            rows, heads = sharding.kv_specs(hparams, mesh.model, mesh.data, batch_size)
            if rows is not None:  # the batch's rows split over the data axis
                self.rows = batch_size // mesh.data
                self.row0 = mesh.data_rank * self.rows
            if heads is not None:
                self.st = replace(self.st, n_head=self.st.n_head // mesh.model,
                                  n_head_kv=self.st.n_head_kv // mesh.model)
        elif mesh is not None:
            from ggllm_tpu_torch.parallel.tp import TpPlan

            self.tp_plan = TpPlan(hparams, mesh.model)
            self.st = self.tp_plan.local_static(self.st)
        st = self.st
        if self.device.type == "cuda" and self.cfg.flash_attention is not False and not self.sp:
            G = st.n_head // st.n_head_kv
            ok, why = flash_decode.supports(st.n_head_kv, G, st.head_dim,
                                            self.cfg.kv_dtype, self.cfg.compute_dtype)
            if not ok:
                raise NotImplementedError(
                    f"flash-decode kernels: {st.n_head} heads over {st.n_head_kv} K/V"
                    f" heads, head_dim {st.head_dim}, {self.cfg.kv_dtype} cache: {why}"
                    " (EngineConfig(flash_attention=False) runs the plain attention)")
        if self.split is not None:
            from ggllm_tpu_torch.models.falcon import SplitFalcon

            self.model = SplitFalcon(st, params, self.split, mesh.comm, whole).to(self.device)
        else:
            self.model = model_cls(st, params).to(self.device)
        # a gloo mesh on the card: collectives cannot be captured in a graph
        self._eager = (mesh is not None and mesh.backend == "gloo"
                       and self.device.type == "cuda")
        self._said_eager = False
        if self.tp_plan is not None:
            self._check_shards(params)
            self.model.reduce = mesh.comm.psum
        if self.sp:
            from ggllm_tpu_torch.parallel.sp import SpModel

            self.model = SpModel(self.model, mesh.comm)
        if mesh is not None and mesh.backend == "nccl":  # one collective before any capture
            mesh.comm.psum(torch.zeros(1, device=self.device))
            torch.cuda.synchronize(self.device)
        self.inv_freq = torch.from_numpy(rope_angles(
            self.cfg.rope, self.cfg.n_ctx, hparams.head_dim, arch=hparams.arch)).to(self.device)
        self.n_past = 0
        self._chunks: OrderedDict[tuple, _Chunk] = OrderedDict()
        self._stream = None  # the stream the decode graphs are captured on
        self._pool = None  # the memory pool they share
        self.kv = self.new_kv()
        self.timings = Timings()

    # ---------------------------------------------------------------- kv

    def _check_shards(self, params: dict) -> None:
        """Refuse a tree that is not this mesh's tensor-parallel blocks."""
        st, lw = self.st, params["layers"][0]
        want = (st.n_head + 2 * st.n_head_kv) * st.head_dim
        key = "wqkv" if "wqkv" in lw else "wqkvu"
        rows = lw[key].shape[0] - (st.n_ff if key == "wqkvu" else 0)
        if rows != want:
            raise ValueError(
                f"layer 0 {key} has {lw[key].shape[0]} rows, not this rank's block of a"
                f" {self.mesh.model}-way tensor-parallel mesh: load the params with"
                " io/loader.py load_params(..., mesh=mesh)")

    def _say_eager(self) -> bool:
        """True where decoding must run the eager step body (a gloo mesh on
        the card), said once on stderr."""
        if self._eager and not self._said_eager:
            self._said_eager = True
            print(f"engine: {self.mesh.model} ranks over gloo on {self.device}: collectives"
                  " cannot be captured in a CUDA graph, so decoding runs the eager step body"
                  " (collectives staged through host memory)", file=sys.stderr)
        return self._eager

    @property
    def kv_T(self) -> int:
        return kv_len(self.cfg, self.sp)

    def new_kv(self):
        """A zeroed cache: one tensor, or (codes, scales) for kv_dtype "int8".
        Under a mesh, this rank's part: its K/V heads (tensor-parallel) or
        its kv_T / mp positions (sequence-parallel)."""
        st = self.st
        T = self.kv_T // self.sp if self.sp else self.kv_T
        shape = (st.n_layer, 2, self.rows, T, st.n_head_kv, st.head_dim)
        return kvcache.new(shape, self.cfg.kv_dtype, self.device)

    @property
    def kv(self):
        """The KV cache. Assigning a new one drops the captured decode
        graphs, which point at the old one's storage."""
        return self._kv

    @kv.setter
    def kv(self, kv):
        self._kv = kv
        self._chunks.clear()

    def reset(self):
        """Back to an empty context: the cache is zeroed in place (its
        storage, which the decode graphs point at, is kept)."""
        self.n_past = 0
        kvcache.zero_(self.kv)

    def _kv_leaves(self, kv) -> tuple:
        return kv if kvcache.is_quantized(kv) else (kv,)

    def _kv_heads(self) -> tuple[int, int] | None:
        """The K/V heads [h0, h1) this rank's cache holds where a mesh splits
        them (tensor-parallel GQA, or the fallback tree's K/V split)."""
        if self.tp_plan is not None and self.tp_plan.KV > 1:
            return self.tp_plan.kv_heads(self.mesh.rank)
        if self.split is not None and self.st.n_head_kv != self.hp.n_head_kv:
            n = self.st.n_head_kv
            return self.mesh.rank * n, (self.mesh.rank + 1) * n
        return None

    def gather_kv(self, n: int):
        """The cache's first n positions as one whole cache, every K/V head
        and position (a tensor, or the int8 pair): under a mesh gathered from
        the ranks' parts (every rank calls it)."""
        out = []
        for leaf in self._kv_leaves(self.kv):
            if self.sp:
                leaf = self.mesh.comm.all_gather(leaf, 3)
            elif self._kv_heads() is not None:
                leaf = self.mesh.comm.all_gather(leaf, 4)
            out.append(leaf[:, :, :, :n])
        return tuple(out) if kvcache.is_quantized(self.kv) else out[0]

    def scatter_kv(self, whole) -> None:
        """Write a whole cache's first positions (gather_kv's form) into this
        engine's cache in place, each rank its part (its K/V heads or its
        time window), the rest zeroed."""
        kvcache.zero_(self.kv)
        for dst, src in zip(self._kv_leaves(self.kv), self._kv_leaves(whole)):
            if self.sp:
                Tl = dst.shape[3]
                src = src[:, :, :, self.mesh.rank * Tl:(self.mesh.rank + 1) * Tl]
            elif self._kv_heads() is not None:
                h0, h1 = self._kv_heads()
                src = src[:, :, :, :, h0:h1]
            dst[:, :, :, :src.shape[3]] = src.to(dst.device, dst.dtype)

    def _single(self, what: str) -> None:
        """Refuse a single-stream entry point on a B-row engine."""
        if self.batch > 1:
            raise ValueError(
                f"FalconEngine.{what} serves one stream; this engine has {self.batch} rows:"
                " use prefill_row / prefill_rows / decode_rows (or engine/batching.py"
                " ContinuousBatcher)")

    # -------------------------------------------------------------- export

    def export(self, seq_len: int | None = None) -> torch.export.ExportedProgram:
        """The model's forward of one chunk of S = seq_len or cfg.n_batch
        tokens as a torch.export program (the JAX engine's export_hlo:374,
        the reference's cgraph export): inputs the tokens (1, S) int64, the
        cache (this engine's: one tensor, or the int8 pair) and n_past, a
        (1,) int32 tensor, so one program serves any position; output the
        last position's f32 logits (1, 1, V). The cache is written in place
        at [n_past, n_past + S) by the graph's indexed copy. The weights and
        the RoPE frequencies are the program's buffers under their tree keys
        ("layers.0.wqkvu.qs", "inv_freq"), the engine's own tensors; the hand
        kernels are nodes torch.ops.ggllm.* (kernels/library.py). S = 1 is
        the decode path (GEMV, flash_decode), S > 1 prefill (the tile,
        flash_mqa). Tracing runs on fake tensors: the cache and n_past are
        untouched. `ep.module()(tokens, kv, n_past)` runs it."""
        self._single("export")
        if self.mesh is not None:
            raise ValueError(f"FalconEngine.export serves a single-device engine; this engine"
                             f" runs on a mesh of {self.mesh.model} ranks")
        S = seq_len or self.cfg.n_batch
        if not 1 <= S <= self.cfg.n_ctx:
            raise ValueError(f"export: {S} tokens a chunk (1 .. n_ctx {self.cfg.n_ctx})")
        tokens = torch.zeros(1, S, dtype=torch.long, device=self.device)
        n_past = torch.zeros(1, dtype=torch.int32, device=self.device)
        with torch.no_grad():
            return torch.export.export(_chunk_forward(self.model, self.inv_freq),
                                       (tokens, self.kv, n_past), strict=False)

    # ---------------------------------------------------------------- eval

    @torch.inference_mode()
    def _forward(self, tokens: torch.Tensor, logits_all: bool = False) -> torch.Tensor:
        self._single("eval")
        n = tokens.shape[-1]
        if self.n_past + n > self.cfg.n_ctx:
            raise ValueError("context overflow")
        logits = self.model(tokens.reshape(1, n), self.kv, self.n_past, self.inv_freq,
                            logits_all=logits_all)
        self.n_past += n
        return logits

    def eval(self, tokens, logits_all: bool = False) -> np.ndarray:
        """Evaluate tokens (one sequence) starting at n_past, in n_batch
        chunks like the reference main loop (falcon_main.cpp:820-845).
        Returns logits: (n, n_vocab) when logits_all else (n_vocab,) for the
        final position."""
        tokens = np.asarray(tokens, dtype=np.int64).reshape(-1)
        out = []
        t0 = time.perf_counter()
        for i in range(0, tokens.size, self.cfg.n_batch):
            chunk = torch.from_numpy(tokens[i:i + self.cfg.n_batch]).to(self.device)
            logits = self._forward(chunk, logits_all)
            if logits_all or i + chunk.numel() >= tokens.size:
                out.append(logits[0].float().cpu().numpy())
        dt = (time.perf_counter() - t0) * 1e6
        if tokens.size > 1:
            self.timings.t_prefill_us += dt
            self.timings.n_prefill += tokens.size
        else:
            self.timings.t_decode_us += dt
            self.timings.n_decode += 1
        if logits_all:
            return np.concatenate(out, axis=0)
        return out[-1][0]

    def eval_logprobs(self, tokens) -> np.ndarray:
        """Next-token log-probabilities of one sequence starting at n_past:
        out[j] = log softmax(logits_j)[tokens[j + 1]], shape (n - 1,), in
        n_batch chunks (the JAX engine's eval_logprobs:454). Each chunk's
        logits stay on the device: the f32 log-softmax and the gather of the
        targets run there (the counterpart of `_gather_logprobs:96`, an XLA
        fusion), so only one float a position crosses to the host. Booked
        as prefill time."""
        tokens = np.asarray(tokens, dtype=np.int64).reshape(-1)
        out = []
        t0 = time.perf_counter()
        for i in range(0, tokens.size, self.cfg.n_batch):
            chunk = tokens[i:i + self.cfg.n_batch]
            out.append(self._eval_chunk_logprobs(chunk, tokens[i + 1:i + 1 + chunk.size]))
        self.timings.t_prefill_us += (time.perf_counter() - t0) * 1e6
        self.timings.n_prefill += tokens.size
        return np.concatenate(out) if out else np.zeros(0, np.float32)

    @torch.inference_mode()
    def _eval_chunk_logprobs(self, chunk: np.ndarray, targets: np.ndarray) -> np.ndarray:
        logits = self._forward(torch.from_numpy(chunk).to(self.device), logits_all=True)[0]
        tgt = torch.from_numpy(targets).to(self.device)
        lsm = torch.log_softmax(logits[:tgt.numel()].float(), dim=-1)
        return lsm.gather(1, tgt[:, None])[:, 0].cpu().numpy()

    @torch.inference_mode()
    def embed(self, tokens) -> np.ndarray:
        """The final-layer normed hidden state of the last token, in f32 (the
        JAX engine's embed:843, the reference's examples/embedding): all but
        the last n_batch tokens go through eval, the tail through one
        output_hidden forward."""
        self._single("embed")
        tokens = np.asarray(tokens, dtype=np.int64).reshape(-1)
        if tokens.size > self.cfg.n_batch:
            head = tokens.size - self.cfg.n_batch
            self.eval(tokens[:head])
            tokens = tokens[head:]
        n = tokens.size
        if self.n_past + n > self.cfg.n_ctx:
            raise ValueError("context overflow")
        t0 = time.perf_counter()
        hidden = self.model(torch.from_numpy(tokens).to(self.device).reshape(1, n), self.kv,
                            self.n_past, self.inv_freq, output_hidden=True)
        self.n_past += n
        out = hidden[0, 0].float().cpu().numpy()
        self.timings.t_prefill_us += (time.perf_counter() - t0) * 1e6
        self.timings.n_prefill += n
        return out

    # ------------------------------------------------------------ decoding

    def new_generator(self, sampler) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(sampler.seed if sampler.seed >= 0 else 0)
        return gen

    def _key(self, n_steps: int, sampler, masked: bool = False) -> tuple:
        return (n_steps, sampling_device.sampler_key(sampler, self.hp.n_vocab, self.nl_token,
                                                     masked))

    def _chunk(self, n_steps: int, sampler, masked: bool = False) -> _Chunk:
        """The decode-chunk program of (n_steps, the sampler's shape, masked)."""
        key = self._key(n_steps, sampler, masked)
        return self._program(key, lambda: _Chunk(*key, self.hp.n_vocab, self.device))

    def _program(self, key: tuple, make):
        """The decode-chunk program (single-stream or B-row) of `key`, made
        by make() on first use; the least recently used one goes when more
        than MAX_CHUNKS are kept (after the device has finished with it)."""
        c = self._chunks.get(key)
        if c is None:
            if len(self._chunks) >= MAX_CHUNKS:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self._chunks.popitem(last=False)
            c = self._chunks[key] = make()
        self._chunks.move_to_end(key)
        return c

    def _steps(self, c: _Chunk, n: int, at: list | None = None) -> None:
        """The step body: n forward + penalty + sample steps from c.tok at
        position c.n_past, each sampled id into c.out[j] and the penalty
        ring (slot (c.pos + j) mod L); with an int8 cache the chunk's K/V
        gather in a pending buffer and one quantizing write ends the chunk.
        Reads and writes only device tensors: this is what a graph captures.
        at[0] follows the step (for the capture's error message)."""
        kv, tok, pending = self.kv, c.tok, None
        if kvcache.is_quantized(kv) and not self.sp:  # chunk-deferred: the cache is read-only
            L_, _, B, _, KV, D = kv[0].shape
            pending = torch.zeros(L_, 2, B, n, KV, D, device=self.device,
                                  dtype=getattr(torch, self.cfg.compute_dtype))
        for j in range(n):
            if at is not None:
                at[0] = j
            pos = c.n_past if j == 0 else c.n_past + j
            if pending is None:
                logits = self.model(tok.view(1, 1), kv, pos, self.inv_freq)[0, 0]
            else:
                logits, kv_new = self.model(tok.view(1, 1), kv, pos, self.inv_freq,
                                            pending=pending, n_pend=j)
                pending[:, :, :, j:j + 1] = kv_new
                logits = logits[0, 0]
            penalized = sampling_device.apply_penalties(logits, c.ring, c.key, c.sv)
            nxt = sampling_device.sample_logits(penalized, c.key, c.sv,
                                                None if c.u is None else c.u[j])
            c.ring.index_copy_(0, (c.pos + j) % c.L, nxt.view(1))
            c.out[j] = nxt
            tok = nxt.view(1)
        if pending is not None:  # the chunk's one (quantizing) write
            kvcache.write_all_layers(kv, pending, c.n_past)

    def _capture(self, c, steps, what: str | None = None) -> None:
        """Capture c's n_steps steps of the step body `steps` (_steps,
        _row_steps, or engine/speculative.py's rounds) as one CUDA graph on
        the engine's capture stream, after one eager step there (which makes
        the stream's flash-decode workspaces and library workspaces outside
        the capture), from the positions in c.n_past. The warm-up writes only
        cache positions at and above each row's n_past, which the chunk
        rewrites, and the inputs that every replay sets. Raises if the
        capture fails, naming the program (`what`, by default the decode
        chunk), the step and the reason."""
        t0 = time.perf_counter()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        side = self._stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            steps(c, 1)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph, at = build.Graph(), [0]
        try:
            with graph.capture(pool=self._pool, stream=side):
                steps(c, c.n_steps, at)
        except Exception as e:
            rows = f"{self.batch}-row " if isinstance(c, _RowChunk) else ""
            what = what or f"the {c.n_steps}-step {rows}decode chunk (sampler key {c.key})"
            raise RuntimeError(f"capturing {what} failed at step {at[0]}: {e}") from e
        c.graph = graph
        self.timings.t_compile_us += (time.perf_counter() - t0) * 1e6

    def _start(self, c: _Chunk, sampler, first_token: int, last_tokens, eager: bool,
               bits=None) -> int:
        """Write the sampler's values (and under a masked key the mask
        `bits`) into c, capture c if it runs as a graph and is not yet
        captured, then set its first token and penalty ring; returns the
        ring position."""
        c.sv.set(sampler, self.hp.n_vocab)
        if c.key.masked:
            c.sv.set_mask(bits)
        if not eager and self.device.type == "cuda" and c.graph is None:
            c.n_past.fill_(self.n_past)
            self._capture(c, self._steps)
        window = list(last_tokens) if last_tokens else [int(first_token)]
        window = window[-min(c.L, self.cfg.n_ctx):]
        ring = np.full(c.L, self.hp.n_vocab, dtype=np.int64)
        ring[:len(window)] = window
        ring = torch.from_numpy(ring)
        if self.device.type == "cuda":
            ring = ring.pin_memory()
        c.ring.copy_(ring, non_blocking=True)
        c.tok.fill_(int(first_token))
        return len(window) % c.L

    def _launch(self, c: _Chunk, pos: int, generator, slot: int, eager: bool) -> None:
        """One chunk at the engine's n_past: its inputs set by device
        writes, the graph replayed (or the step body run), its ids copied
        into pinned host buffer `slot` with an event behind them. Nothing
        here waits for the device."""
        c.n_past.fill_(self.n_past)
        c.pos.fill_(pos)
        if c.u is not None:  # the chunk's uniforms, one launch
            c.u.uniform_(generator=generator)
        if eager or self.device.type != "cuda":
            self._steps(c, c.n_steps)
        else:
            c.graph.replay()
        c.host[slot].copy_(c.out, non_blocking=True)
        if c.done[slot] is not None:
            c.done[slot].record()
        self.n_past += c.n_steps

    @staticmethod
    def _fetch(c: _Chunk, slot: int) -> np.ndarray:
        if c.done[slot] is not None:
            c.done[slot].synchronize()
        return c.host[slot].numpy().copy()

    @torch.inference_mode()
    def decode_chunk(self, first_token: int, n_steps: int, sampler=None,
                     generator: torch.Generator | None = None, last_tokens=None,
                     eager: bool = False):
        """Run n_steps forward+sample steps starting from first_token
        (already sampled, not yet forwarded): on the card one replay of the
        chunk's CUDA graph (captured on first use), on the CPU or with
        eager=True (the reference the graphs are held to) the step body.
        Returns (the n_steps sampled successor ids as numpy, the
        generator); advances n_past by n_steps.

        last_tokens: recent token history ENDING WITH first_token; seeds the
        on-device penalty window. Defaults to just [first_token]."""
        return self._decode(first_token, n_steps, n_steps, sampler, generator, last_tokens,
                            None, eager)

    @torch.inference_mode()
    def decode_chunk_masked(self, first_token: int, mask_bits, n_steps: int = 1, sampler=None,
                            generator: torch.Generator | None = None, last_tokens=None,
                            eager: bool = False):
        """decode_chunk under one constant grammar mask (the JAX engine's
        decode_chunk_masked:799): mask_bits = np.packbits(valid, bitorder=
        "little") over the vocabulary (ops/grammar.py valid_bits), applied
        before the bias and the penalties at every step. One graph a
        (n_steps, the sampler's shape) key, the mask written before each
        replay. Returns (the n_steps ids, the generator); advances n_past by
        n_steps, and the caller rolls back past the ids it does not commit
        (a grammar state that changed mid-chunk): with a dense cache the
        positions past the rollback are stale, with an int8 cache the
        chunk's one quantizing write put them past n_past, where attention
        does not read and the next chunk writes."""
        return self._decode(first_token, n_steps, n_steps, sampler, generator, last_tokens,
                            None, eager, mask_bits)

    @torch.inference_mode()
    def decode_pipelined(self, first_token: int, n_total: int, n_steps: int, sampler=None,
                         generator: torch.Generator | None = None, last_tokens=None,
                         on_tokens=None):
        """n_total tokens in n_steps-sized chunks, PIPELINED (the JAX
        engine's decode_pipelined:658): chunk i+1 is enqueued (its first
        token fed from chunk i's last id by a device copy, its ring left on
        the device) before the host waits for chunk i's ids, which each
        chunk copies into a pinned host buffer of its own behind an event.
        The same ids as chained decode_chunk calls.

        n_total need not be a multiple of n_steps: the last chunk runs in
        full through the same graph and its ids past n_total are dropped
        (their cache positions lie in the cache's scratch region beyond
        n_ctx at most, and past n_past afterwards), so one graph a sampler
        key serves every length.

        on_tokens(np.ndarray) is called per fetched chunk; returning False
        stops early (the chunk already enqueued still advances n_past, up
        to n_total: use rollback() to discard it). Returns (all fetched
        ids, the generator set back to its state after the last fetched
        chunk's draw)."""
        return self._decode(first_token, n_total, n_steps, sampler, generator, last_tokens,
                            on_tokens, False)

    def _decode(self, first_token: int, n_total: int, n_steps: int, sampler, generator,
                last_tokens, on_tokens, eager: bool, bits=None):
        self._single("decode_chunk / decode_pipelined")
        sampler = sampler or sampling.SamplerParams(temp=0.0)
        if not n_total > 0 < n_steps:
            raise ValueError(f"n_total {n_total} and n_steps {n_steps} must be positive")
        n_chunks = -(-n_total // n_steps)
        if self.n_past + n_total > self.cfg.n_ctx:
            raise ValueError("context overflow")
        if self.n_past + n_chunks * n_steps > self.kv_T:
            raise ValueError(f"{n_steps}-step chunks for {n_total} tokens from n_past"
                             f" {self.n_past} run past the cache's {self.kv_T} positions")
        generator = generator or self.new_generator(sampler)
        eager = eager or self._say_eager()
        c = self._chunk(n_steps, sampler, bits is not None)
        start, t_compile = self.n_past, self.timings.t_compile_us
        t0 = time.perf_counter()
        pos = self._start(c, sampler, first_token, last_tokens, eager, bits)
        out: list[np.ndarray] = []
        states = []  # generator state after each enqueued chunk's draw

        def consume(i: int) -> bool:
            toks = self._fetch(c, i % 2)[:n_total - i * n_steps]
            out.append(toks)
            return on_tokens is None or on_tokens(toks) is not False

        for i in range(n_chunks):
            if i:
                c.tok.copy_(c.out[-1:])
            self._launch(c, pos + i * n_steps, generator, i % 2, eager)
            states.append(generator.get_state())
            if i and not consume(i - 1):
                break
        else:
            consume(n_chunks - 1)
        generator.set_state(states[len(out) - 1])
        self.n_past = min(self.n_past, start + n_total)
        n_done = sum(len(t) for t in out)
        self.timings.t_decode_us += ((time.perf_counter() - t0) * 1e6
                                     - (self.timings.t_compile_us - t_compile))
        self.timings.n_decode += n_done
        return np.concatenate(out), generator

    def chunk_graph(self, n_steps: int, sampler, masked: bool = False) -> build.Graph | None:
        """The captured graph of the chunk key (n_steps, sampler, masked), or
        None."""
        c = self._chunks.get(self._key(n_steps, sampler, masked))
        return None if c is None else c.graph

    def rollback(self, n_past: int):
        """Roll the logical KV position back (stale cache beyond is masked)."""
        assert 0 <= n_past <= self.n_past
        self.n_past = n_past

    # --------------------------------------------- batched (per-row) decoding
    # These take an explicit per-row n_past vector and leave the scalar
    # self.n_past alone; engine/batching.py's ContinuousBatcher owns the rows'
    # state.

    @torch.inference_mode()
    def prefill_row(self, row: int, tokens, n_past_vec) -> np.ndarray:
        """Evaluate `tokens` on one batch row from its n_past_vec entry (the
        JAX engine's prefill_row:967); the other rows' entries are their live
        or parked positions. Returns the row's last logits (n_vocab,)."""
        return self.prefill_rows([row], [tokens], n_past_vec)[row]

    @torch.inference_mode()
    def prefill_rows(self, rows, prompts, n_past_vec, fetch_rows=None) -> dict:
        """Evaluate several rows' prompts together (the JAX engine's
        prefill_rows:999, the batcher's admission path), in forwards of all
        B rows n_batch positions wide at most. rows: the batch row of each
        prompt; n_past_vec (B,): admitted rows at their prompts' start, the
        others at their live or parked positions (>= n_ctx): their tokens in
        a forward are zeros whose writes land at and beyond their n_past,
        which attention masks and later writes overwrite (the stale-cache
        invariant), as do an admitted row's padding positions past its
        prompt. fetch_rows: only these rows' last logits go to the host
        (None: every row whose prompt ends here). Returns {row: last logits
        (n_vocab,) f32}. Where a mesh's data axis splits the rows (the
        fallback tree's kv_specs) each data row of ranks forwards its own
        rows and the logits are gathered over the data axis."""
        B = self.batch
        prompts = [np.asarray(p, dtype=np.int64).reshape(-1) for p in prompts]
        npv = np.asarray(n_past_vec, dtype=np.int64).reshape(-1).copy()
        if npv.shape != (B,) or len(rows) != len(prompts) or len(set(rows)) != len(rows):
            raise ValueError(f"rows {list(rows)} and {len(prompts)} prompts for n_past"
                             f" {npv.tolist()} of a {B}-row engine")
        for row, p in zip(rows, prompts):
            if not 0 <= row < B or p.size == 0 or npv[row] + p.size > self.cfg.n_ctx:
                raise ValueError(f"row {row}: {p.size} tokens from n_past {npv[row]}"
                                 f" (context {self.cfg.n_ctx})")
        if self.rows == B:
            return self._prefill_rows(rows, prompts, npv, fetch_rows)
        lo, hi, V = self.row0, self.row0 + self.rows, self.hp.n_vocab
        mine = [(r - lo, p) for r, p in zip(rows, prompts) if lo <= r < hi]
        got = self._prefill_rows([r for r, _ in mine], [p for _, p in mine], npv[lo:hi],
                                 None if fetch_rows is None else [r - lo for r in fetch_rows])
        # the timings count the whole batch's tokens, as decode_rows's do
        self.timings.n_prefill += sum(p.size for r, p in zip(rows, prompts) if not lo <= r < hi)
        buf = torch.zeros(self.rows, V + 1)  # the logits and a "fetched" flag a row
        for r, lg in got.items():
            buf[r, :V], buf[r, V] = torch.from_numpy(lg), 1.0
        every = self.mesh.data_comm.all_gather(buf.to(self.device), 0).cpu().numpy()
        return {r: every[r, :V] for r in range(B) if every[r, V] > 0}

    def _prefill_rows(self, rows, prompts, npv, fetch_rows) -> dict:
        """prefill_rows's forwards over this rank's cache rows (checked)."""
        B, T = self.rows, self.kv_T
        out: dict[int, np.ndarray] = {}
        if not prompts:
            return out
        maxlen = max(p.size for p in prompts)
        t0 = time.perf_counter()
        for done in range(0, maxlen, self.cfg.n_batch):
            width = min(self.cfg.n_batch, maxlen - done)
            if npv.max() + width > T:
                raise ValueError(f"a {width}-token forward from n_past {npv.tolist()} runs past"
                                 f" the cache's {T} positions")
            buf = np.zeros((B, width), dtype=np.int64)
            last = np.zeros(B, dtype=np.int64)
            fetch, sizes = [], []
            for row, p in zip(rows, prompts):
                chunk = p[done:done + width]
                if chunk.size == 0:
                    continue  # this row's prompt ended in an earlier forward
                buf[row, :chunk.size] = chunk
                last[row] = chunk.size - 1
                if done + chunk.size >= p.size and (fetch_rows is None or row in fetch_rows):
                    fetch.append(row)
                sizes.append((row, chunk.size))
            dev = self.device
            logits = self.model(torch.from_numpy(buf).to(dev), self.kv,
                                torch.from_numpy(npv.astype(np.int32)).to(dev), self.inv_freq,
                                last_pos=torch.from_numpy(last).to(dev))
            if fetch:  # only the finishing rows' logits cross to the host
                got = logits[torch.tensor(fetch, device=dev), 0].float().cpu().numpy()
                out.update(zip(fetch, got))
            for row, n in sizes:
                npv[row] += n
                self.timings.n_prefill += n
        self.timings.t_prefill_us += (time.perf_counter() - t0) * 1e6
        return out

    def _row_steps(self, c: _RowChunk, n: int, at: list | None = None) -> None:
        """The B-row step body (the JAX engine's _decode_rows_fn:1058): n
        forward + sample steps of every row from c.tok at the rows' own
        positions c.n_past, each row's ids into c.out[j] and its penalty ring
        (slot (c.pos + j) mod L), sampled by sampling_device.sample_rows_step
        on c.u[j]; with an int8 cache the chunk's K/V gather in a pending
        buffer and one quantizing per-row write ends the chunk. Reads and
        writes only device tensors: this is what a graph captures. at[0]
        follows the step (for the capture's error message)."""
        kv, tok, pending, B = self.kv, c.tok, None, self.rows
        if kvcache.is_quantized(kv):  # chunk-deferred: the cache is read-only
            L_, _, _, _, KV, D = kv[0].shape
            pending = torch.zeros(L_, 2, B, n, KV, D, device=self.device,
                                  dtype=getattr(torch, self.cfg.compute_dtype))
        for j in range(n):
            if at is not None:
                at[0] = j
            pos = c.n_past if j == 0 else c.n_past + j
            if pending is None:
                logits = self.model(tok.view(B, 1), kv, pos, self.inv_freq)[:, 0]
            else:
                logits, kv_new = self.model(tok.view(B, 1), kv, pos, self.inv_freq,
                                            pending=pending, n_pend=j)
                pending[:, :, :, j:j + 1] = kv_new
                logits = logits[:, 0]
            nxt = sampling_device.sample_rows_step(logits, c.ring, c.key, c.rv, c.u[j],
                                                   self.nl_token)
            c.ring.scatter_(1, ((c.pos + j) % c.L)[:, None], nxt[:, None])
            c.out[j] = nxt
            tok = nxt
        if pending is not None:  # the chunk's one (quantizing) per-row write
            (self.model if self.sp else kvcache).write_all_layers(kv, pending, c.n_past)

    @torch.inference_mode()
    def decode_rows(self, toks, n_past_vec, n_steps: int, values: dict | None = None,
                    rings=None, ring_fill=None, bias_ids=None, bias_vals=None, mu=None,
                    top_k: int = 64, generator: torch.Generator | None = None,
                    eager: bool = False, mask_bits=None):
        """n_steps decode steps of all B rows (the JAX engine's
        decode_rows:1232): toks (B,) each row's last sampled id, not yet
        forwarded; n_past_vec (B,) the rows' positions (parked rows at
        n_ctx or beyond: their writes land in the cache's scratch region).
        On the card one replay of the chunk's CUDA graph, captured on first
        use per (n_steps, RowKey); on the CPU or with eager=True the same
        step body. The draw's (n_steps, B) uniforms come from `generator`
        (the engine's device) in one launch before the steps.

        values: the per-row knobs, name -> (B,) array keyed by
        sampling_device.ROW_FIELDS (a missing name: its idle value; "top_k"
        within the static cap top_k, which it defaults to; "penalize_nl"
        False keeps the family's newline logit unpenalized). The penalties
        run over `rings` (B, L), each row's recent ids ENDING WITH toks[b]
        (>= n_vocab: empty), of which ring_fill (B,) are filled; bias_ids /
        bias_vals (B, NB); mu (B,) mirostat's state; mask_bits (B, ceil(n_vocab
        / 8)) uint8, each row's packed grammar mask (all ones: no grammar),
        applied before the bias and the penalties at every step (a masked
        RowKey, the JAX engine's use_mask; the batcher runs it one step a
        chunk, since a row's grammar state changes with its ids). Returns
        ((n_steps, B) ids, the (n_steps, B) uniforms consumed, also kept as
        self.last_us, and the rows' mirostat mu after the chunk) as numpy."""
        B, V = self.batch, self.hp.n_vocab
        npv = np.asarray(n_past_vec, dtype=np.int64).reshape(-1)
        toks = np.asarray(toks, dtype=np.int64).reshape(-1)
        if npv.shape != (B,) or toks.shape != (B,) or n_steps < 1:
            raise ValueError(f"decode_rows: toks {toks.shape}, n_past {npv.shape}, {n_steps}"
                             f" steps on a {B}-row engine")
        if npv.min() < 0 or npv.max() + n_steps > self.kv_T:
            raise ValueError(f"{n_steps}-step rows from n_past {npv.tolist()} run past the"
                             f" cache's {self.kv_T} positions")
        rings = (np.full((B, 1), V, np.int64) if rings is None
                 else np.asarray(rings, np.int64).reshape(B, -1))
        fill = (np.full(B, rings.shape[1], np.int64) if ring_fill is None
                else np.asarray(ring_fill, np.int64).reshape(B))
        bias_ids = (np.full((B, 0), V, np.int64) if bias_ids is None
                    else np.asarray(bias_ids, np.int64).reshape(B, -1))
        bias_vals = (np.zeros(bias_ids.shape, np.float32) if bias_vals is None
                     else np.asarray(bias_vals, np.float32).reshape(bias_ids.shape))
        values = {"top_k": np.full(B, top_k), **(values or {})}
        use_miro = bool(np.any(values.get("mirostat", 0)))
        key = sampling_device.RowKey(top_k, rings.shape[1], bias_ids.shape[1], use_miro,
                                     mask_bits is not None)
        c = self._program(("rows", n_steps, key),
                          lambda: _RowChunk(n_steps, key, self.rows, V, self.device))
        mu = np.full(B, 10.0, np.float32) if mu is None else mu
        generator = generator or torch.Generator(device=self.device).manual_seed(0)
        u = c.u
        if self.rows != B:  # this data row's rows; every rank draws all B rows' uniforms
            lo, hi = self.row0, self.row0 + self.rows
            toks, npv, rings, fill, bias_ids, bias_vals, mu = (
                a[lo:hi] for a in (toks, npv, rings, fill, bias_ids, bias_vals, np.asarray(mu)))
            values = {k: np.asarray(v)[lo:hi] if np.ndim(v) else v for k, v in values.items()}
            mask_bits = None if mask_bits is None else np.asarray(mask_bits)[lo:hi]
            u = torch.empty(n_steps, B, device=self.device)
        eager = eager or self._say_eager()
        t_compile = self.timings.t_compile_us
        t0 = time.perf_counter()
        c.n_past.copy_(torch.from_numpy(npv.astype(np.int32)))  # the warm-up's positions too
        if not eager and self.device.type == "cuda" and c.graph is None:
            self._capture(c, self._row_steps)
        pin = self.device.type == "cuda"
        for dst, src in ((c.tok, toks), (c.ring, rings), (c.pos, fill)):
            src = torch.from_numpy(np.ascontiguousarray(src))
            dst.copy_(src.pin_memory() if pin else src, non_blocking=True)
        c.rv.set(values, bias_ids, bias_vals, mu, mask_bits)
        u.uniform_(generator=generator)
        if u is not c.u:
            c.u.copy_(u[:, self.row0:self.row0 + self.rows])
        if eager or not pin:
            self._row_steps(c, n_steps)
        else:
            c.graph.replay()
        out, new_mu = c.out, c.rv.mu
        if self.rows != B:  # every data row's ids and mu
            out, new_mu = (self.mesh.data_comm.all_gather(t, d) for t, d in ((out, 1), (new_mu, 0)))
        out, us, new_mu = (t.cpu().numpy() for t in (out, u, new_mu))
        self.timings.t_decode_us += ((time.perf_counter() - t0) * 1e6
                                     - (self.timings.t_compile_us - t_compile))
        self.timings.n_decode += n_steps * B  # every rank returns all B rows
        self.last_us = us
        return out, us, new_mu

    def rows_graph(self, n_steps: int, key: sampling_device.RowKey) -> build.Graph | None:
        """The captured graph of the B-row chunk key (n_steps, key), or None."""
        c = self._chunks.get(("rows", n_steps, key))
        return None if c is None else c.graph

    def _sample_host(self, logits: np.ndarray, last_tokens: list, sampler,
                     state: sampling.SamplerState) -> int:
        t0 = time.perf_counter()
        tok = sampling.sample(logits, last_tokens, sampler, state, self.cfg.n_ctx,
                              nl_token=self.nl_token)
        self.timings.t_sample_us += (time.perf_counter() - t0) * 1e6
        self.timings.n_sample += 1
        return tok

    def generate(self, prompt_ids, n_predict: int = 128,
                 sampler: sampling.SamplerParams | None = None,
                 stop_ids: set | None = None, stream=None) -> list[int]:
        """Greedy/sampled generation. Returns generated ids (without prompt).

        Routed as the JAX engine routes (engine.py:1328-1359): the host
        cascade (ops/sampling.py sample) draws the first token after
        prefill; then settings the device cascade covers (device_samplable)
        decode through decode_pipelined in chunks of cfg.decode_chunk tokens
        sampled on the device (positions past a stop id are rolled back, as
        ggllm_tpu/engine/generator.py does), and any other (top_k <= 0 or >
        1024 at temp > 0, tfs / typical < 1, mirostat) one token at a time
        through the host cascade, with one SamplerState throughout. The last
        token is not forwarded."""
        sampler = sampler or sampling.SamplerParams()
        stop_ids = stop_ids or set()
        prompt_ids = list(map(int, np.asarray(prompt_ids).reshape(-1)))
        state = sampling.SamplerState.init(sampler)
        logits = self.eval(prompt_ids)
        out = [self._sample_host(logits, prompt_ids, sampler, state)]
        if stream is not None:
            stream(out[0])
        if out[0] in stop_ids:
            return out
        on_device = sampling_device.device_samplable(sampler)
        generator = None
        while len(out) < n_predict:
            if not on_device:
                if self.n_past >= self.cfg.n_ctx:
                    break
                logits = self.eval([out[-1]])
                t = self._sample_host(logits, prompt_ids + out, sampler, state)
                out.append(t)
                if stream is not None:
                    stream(t)
                if t in stop_ids:
                    return out
                continue
            n_total = min(n_predict - len(out), self.cfg.n_ctx - self.n_past)
            if n_total <= 0:
                break
            if n_total >= self.cfg.decode_chunk:  # whole chunks, then the tail
                n_total -= n_total % self.cfg.decode_chunk
            start, consumed, stopped = self.n_past, [0], [False]

            def on_chunk(arr) -> bool:
                self.timings.n_sample += len(arr)
                for t in map(int, arr):
                    out.append(t)
                    consumed[0] += 1
                    if stream is not None:
                        stream(t)
                    if t in stop_ids:
                        stopped[0] = True
                        return False
                return True

            _, generator = self.decode_pipelined(
                out[-1], n_total, self.cfg.decode_chunk, sampler, generator,
                last_tokens=prompt_ids + out, on_tokens=on_chunk)
            if stopped[0]:  # positions beyond the stop are stale; roll back
                self.rollback(start + consumed[0])
                return out
        return out
