"""Continuous batching: B streams decoding together, each in its own row of
the engine's cache at its own position (port of
ggllm_tpu/engine/batching.py).

Finished rows free their slot and queued requests are admitted mid-flight:
an admission's prompt is evaluated in capped chunks (prefill_chunk tokens a
row a step, engine.prefill_rows) between decode chunks, so an admission
stalls the rows in flight by one capped forward, not a whole prompt. Every
decode chunk (engine.decode_rows, on the card one replayed CUDA graph) runs
all B rows: idle rows are parked at n_ctx, in the cache's scratch region,
and rows mid-prefill take junk steps whose writes lie beyond their n_past,
which the next prefill chunk overwrites (the stale-cache invariant); a row
near n_ctx consumes only its in-context tokens.

Sampling per row: the first token after a prompt through the host cascade
(ops/sampling.py sample), the rest on the device (ops/sampling_device.py
sample_rows_u): greedy, temperature, top-k within the batcher's cap, top-p,
tail-free, typical, repetition / frequency / presence penalties over the
last RING_LEN ids, a sparse logit bias (up to 64 ids), mirostat v1 / v2 with
its mu carried across chunks, and penalize_nl=False, which keeps the
family's newline logit unpenalized (the JAX rows have no newline restore).
The uniforms come from one explicit, seeded torch.Generator; those a
sampled row consumed are kept on its request (Request.us), so that the host
cascade can replay them.

Grammar rows (Request.grammar_sampler, ops/grammar.py GrammarSampler): the
first id goes through filter_logits, the host cascade and `accept`; while
any row holds a grammar, the whole batch decodes in 1-step chunks with a
(B, ceil(V/8)) mask of packed bits (each grammar row's valid_bits, all ones
for the other rows), applied on the device before the bias and the
penalties, and every id of a grammar row is `accept`ed (the JAX batcher's
batching.py:328-337, :371-372).

Unlike the JAX batcher, whose scheduler dies when one row raises
(engine/batching.py:337), a row whose stream callback, on_done callback or
grammar raises (a GrammarError from valid_bits or accept) fails alone: its
request ends with Request.error set and its slot is freed.
"""

from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ggllm_tpu_torch.engine.engine import DECODE_CHUNK, FalconEngine
from ggllm_tpu_torch.ops import sampling
from ggllm_tpu_torch.ops.grammar import GrammarError
from ggllm_tpu_torch.ops.sampling_device import ROW_FIELDS, mask_bytes

RING_LEN = 64  # penalty window (repeat_last_n's default, falcon_common.h)


@dataclass
class Request:
    """One generation request (the JAX batcher's Request:41, plus
    penalize_nl and error)."""

    prompt_ids: list
    n_predict: int = 128
    temp: float = 0.0
    top_p: float = 1.0
    top_k: int = 0  # 0 = the batcher's cap
    repeat_penalty: float = 1.0
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    tfs_z: float = 1.0
    typical_p: float = 1.0
    mirostat: int = 0  # 0 off, 1 / 2 = v1 / v2
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    penalize_nl: bool = True
    logit_bias: dict = field(default_factory=dict)  # token id -> bias
    stop_ids: frozenset = frozenset()
    # ops.grammar.GrammarSampler (this request's state): while any row holds
    # one, the batch decodes one masked step a chunk
    grammar_sampler: object = None
    # per-token callback(token_id); returning False stops the row, raising
    # fails this request alone
    stream: object = None
    on_done: object = None  # called once when the request leaves its row

    # filled by the batcher
    rid: int = -1
    out: list = field(default_factory=list)
    done: bool = False
    error: BaseException | None = None
    row: int = -1
    mu: float = 0.0  # mirostat state (2 tau at admission, then the device's)
    us: list = field(default_factory=list)  # the uniforms consumed (replay)


class ContinuousBatcher:
    """The scheduler over a FalconEngine(batch_size=B) (the JAX
    ContinuousBatcher:78): submit requests, then step() or run(). eager=True
    runs the decode chunks through the engine's eager step body instead of
    its CUDA graphs (the reference the graphs are held to)."""

    def __init__(self, engine: FalconEngine, chunk: int | None = None, top_k: int = 64,
                 seed: int = 0, prefill_chunk: int = 256, eager: bool = False):
        self.eng = engine
        self.eager = eager
        self.B = engine.batch
        self.chunk = min(chunk or engine.cfg.decode_chunk,
                         max(DECODE_CHUNK, engine.cfg.decode_chunk))
        self.top_k = top_k
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.pending: dict[int, tuple] = {}  # row -> (request, prompt tokens done)
        self.prefilling: set[int] = set()
        self.queue: deque[Request] = deque()
        self.rows: list[Request | None] = [None] * self.B
        self.n_past = np.full(self.B, self._park, dtype=np.int64)
        self.last_tok = np.zeros(self.B, dtype=np.int64)
        self.knobs = {name: np.full(self.B, idle) for name, idle in self._IDLE.items()}
        self.knobs["top_k"] = np.full(self.B, top_k)
        self.mu = np.full(self.B, 10.0, dtype=np.float32)
        self.rng = torch.Generator(device=engine.device).manual_seed(seed)
        self._ids = itertools.count()

    # a free row's sampler values, by the Request fields of the same names
    _IDLE = {name: idle for name, _, idle in ROW_FIELDS}

    @property
    def _park(self) -> int:
        return self.eng.cfg.n_ctx  # the scratch region's start (engine.kv_T)

    # ------------------------------------------------------------------ api

    def submit(self, req: Request) -> Request:
        req.prompt_ids = list(map(int, np.asarray(req.prompt_ids).reshape(-1)))
        if not req.prompt_ids:
            raise ValueError("a request needs at least one prompt token")
        if req.grammar_sampler is not None and getattr(self.eng, "mesh", None) is not None:
            raise ValueError("grammar in batched mode requires a single-device engine")
        req.rid = next(self._ids)
        self.queue.append(req)
        return req

    @property
    def active(self) -> list[Request]:
        return [r for r in self.rows if r is not None]

    def step(self):
        """Admit queued requests into free rows, advance the admissions by
        one capped prefill chunk, then run one decode chunk of the live
        rows."""
        self._admit()
        self._prefill_step()
        if any(r is not None and row not in self.prefilling for row, r in enumerate(self.rows)):
            self._decode_chunk()

    def run(self):
        """Step until every submitted request has finished."""
        while self.queue or self.active:
            self.step()

    # ------------------------------------------------------------- internals

    def _admit(self):
        for row in range(self.B):
            if self.rows[row] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            if len(req.prompt_ids) + req.n_predict > self.eng.cfg.n_ctx:
                # keep the most recent context
                keep = self.eng.cfg.n_ctx - req.n_predict
                req.prompt_ids = req.prompt_ids[-max(keep, 1):]
            self.n_past[row] = 0
            req.row = row
            self.rows[row] = req
            self.pending[row] = (req, 0)
            self.prefilling.add(row)

    def _prefill_step(self):
        """Advance every row mid-prefill by at most prefill_chunk tokens in
        one prefill_rows call; rows whose prompt completes sample their first
        token and go live."""
        if not self.pending:
            return
        rows, slices, finishing = [], [], set()
        for row, (req, done) in self.pending.items():
            sl = req.prompt_ids[done:done + self.prefill_chunk]
            rows.append(row)
            slices.append(sl)
            if done + len(sl) >= len(req.prompt_ids):
                finishing.add(row)
        row_logits = self.eng.prefill_rows(rows, slices, self.n_past, fetch_rows=finishing)
        for row, sl in zip(rows, slices):
            req, done = self.pending[row]
            self.n_past[row] += len(sl)
            if row not in finishing:
                self.pending[row] = (req, done + len(sl))
                continue
            del self.pending[row]
            self.prefilling.discard(row)
            self._activate(row, req, row_logits[row])

    def _top_k(self, req: Request) -> int:
        return min(req.top_k, self.top_k) if req.top_k > 0 else self.top_k

    def _activate(self, row: int, req: Request, logits: np.ndarray):
        try:
            tok = self._sample_first(logits, req)
        except GrammarError as e:  # this request fails alone
            req.error, req.done = e, True
            self._free(row)
            return
        self._emit(req, tok)
        if req.done:
            self._free(row)
            return
        self.last_tok[row] = tok
        for name in self._IDLE:
            self.knobs[name][row] = getattr(req, name)
        self.knobs["top_k"][row] = self._top_k(req)
        self.mu[row] = req.mu

    def _sample_first(self, logits: np.ndarray, req: Request) -> int:
        """The first token after the prompt: the whole host cascade, its
        uniform drawn from the batcher's generator and kept on req.us;
        mirostat's mu goes on to the device rows through req.mu; a grammar
        masks the logits first (filter_logits) and accepts the id."""
        params = sampling.SamplerParams(
            temp=req.temp, top_k=self._top_k(req), top_p=req.top_p, tfs_z=req.tfs_z,
            typical_p=req.typical_p, repeat_penalty=req.repeat_penalty, repeat_last_n=RING_LEN,
            frequency_penalty=req.frequency_penalty, presence_penalty=req.presence_penalty,
            mirostat=req.mirostat, mirostat_tau=req.mirostat_tau,
            mirostat_eta=req.mirostat_eta, penalize_nl=req.penalize_nl,
            logit_bias=dict(req.logit_bias))
        gen = self.rng

        class _Rec:
            def random(_self):
                u = float(torch.rand((), generator=gen, device=gen.device))
                req.us.append(u)
                return u

        state = sampling.SamplerState(rng=_Rec(), mu=2.0 * req.mirostat_tau)
        gs = req.grammar_sampler
        if gs is not None:
            logits = gs.filter_logits(logits)
        tok = sampling.sample(logits, req.prompt_ids, params, state, n_ctx=self.eng.cfg.n_ctx,
                              nl_token=self.eng.nl_token)
        if gs is not None:
            gs.accept(tok)
        req.mu = state.mu
        return tok

    def _emit(self, req: Request, tok: int):
        req.out.append(tok)
        if req.stream is not None:
            try:
                if req.stream(tok) is False:
                    req.done = True
            except Exception as e:  # this request fails; the other rows go on
                req.error, req.done = e, True
        if tok in req.stop_ids or len(req.out) >= req.n_predict:
            req.done = True

    def _free(self, row: int):
        req = self.rows[row]
        self.rows[row] = None
        self.pending.pop(row, None)
        self.prefilling.discard(row)
        self.n_past[row] = self._park
        for name, idle in self._IDLE.items():
            self.knobs[name][row] = idle
        self.knobs["top_k"][row] = self.top_k
        self.mu[row] = 10.0
        self.last_tok[row] = 0
        if req is not None and req.on_done is not None:
            try:
                req.on_done()
            except Exception as e:
                req.error = req.error or e

    def _rings(self) -> tuple[np.ndarray, np.ndarray]:
        """Each live row's penalty window: the last RING_LEN ids of its
        history (prompt and output, ending with the id not yet forwarded),
        oldest first, and how many are filled; rebuilt every chunk, so a
        row that stopped mid-chunk leaves no ids behind."""
        rings = np.full((self.B, RING_LEN), self.eng.hp.n_vocab, np.int64)
        fill = np.zeros(self.B, np.int64)
        for row, req in enumerate(self.rows):
            if req is None:
                continue
            hist = (req.prompt_ids + req.out)[-RING_LEN:]
            rings[row, :len(hist)] = hist
            fill[row] = len(hist)
        return rings, fill

    def _bias_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-row sparse logit bias as (B, NB) arrays (empty slots =
        n_vocab, dropped), NB snapped to 0, 8 or 64 so that few graphs are
        keyed on it; ids beyond 64 a row are dropped."""
        n_max = max((len(r.logit_bias) for r in self.rows if r is not None), default=0)
        NB = 0 if n_max == 0 else (8 if n_max <= 8 else 64)
        V = self.eng.hp.n_vocab
        ids = np.full((self.B, NB), V, np.int64)
        vals = np.zeros((self.B, NB), np.float32)
        for row, req in enumerate(self.rows):
            if req is None:
                continue
            for i, (t, b) in enumerate(sorted(req.logit_bias.items())[:NB]):
                if 0 <= int(t) < V:
                    ids[row, i] = int(t)
                    vals[row, i] = float(b)
        return ids, vals

    def _masks(self) -> np.ndarray | None:
        """The rows' packed grammar masks (B, mask_bytes(V)) for the next
        step, all ones for rows without a grammar; None when no live row
        holds one. A row whose grammar cannot go on (valid_bits raises)
        fails alone and is freed here."""
        grammar_rows = [(row, r) for row, r in enumerate(self.rows)
                        if r is not None and r.grammar_sampler is not None
                        and row not in self.prefilling]
        if not grammar_rows:
            return None
        mask = np.full((self.B, mask_bytes(self.eng.hp.n_vocab)), 0xFF, np.uint8)
        for row, req in grammar_rows:
            try:
                mask[row] = req.grammar_sampler.valid_bits()
            except GrammarError as e:
                req.error, req.done = e, True
                self._free(row)
        return mask if any(self.rows[row] is not None for row, _ in grammar_rows) else None

    def _decode_chunk(self):
        # rows whose context is full end now (no token left to produce)
        for row, req in enumerate(self.rows):
            if (req is not None and row not in self.prefilling
                    and self.n_past[row] >= self.eng.cfg.n_ctx):
                req.done = True
                self._free(row)
        mask = self._masks()
        if not self.active:
            return
        rings, fill = self._rings()
        bias_ids, bias_vals = self._bias_arrays()
        steps = self.chunk if mask is None else 1  # a grammar state holds for one id
        toks, us, new_mu = self.eng.decode_rows(
            self.last_tok, self.n_past, steps, self.knobs, rings, fill, bias_ids, bias_vals,
            self.mu, top_k=self.top_k, generator=self.rng, eager=self.eager, mask_bits=mask)
        for row, req in enumerate(self.rows):
            if req is None or row in self.prefilling:
                continue  # a row mid-prefill took junk steps
            if req.mirostat:
                self.mu[row] = req.mu = float(new_mu[row])
            # a row near the context's end consumes only its in-context
            # steps (later ones wrote into the scratch region)
            avail = self.eng.cfg.n_ctx - int(self.n_past[row])
            consumed = 0
            for j in range(min(steps, avail)):
                consumed = j + 1
                if req.temp > 0:  # the host cascade draws one uniform a token
                    req.us.append(float(us[j, row]))
                tok = int(toks[j, row])
                if req.grammar_sampler is not None:
                    try:
                        req.grammar_sampler.accept(tok)  # raises if the mask failed
                    except GrammarError as e:
                        req.error, req.done = e, True
                        break
                self._emit(req, tok)
                if req.done:
                    break
            if req.error is not None:
                self._free(row)
                continue
            self.n_past[row] += consumed  # the forwards behind the consumed ids
            self.last_tok[row] = req.out[-1]
            if avail <= steps and consumed == avail:
                req.done = True
            if req.done:
                self._free(row)
