"""Speculative decoding on the port (port of ggllm_tpu/engine/speculative.py,
the single stream): a draft model proposes k tokens, the target model
verifies them in ONE forward over k + 1 positions, and rejection sampling
keeps the committed stream distributed exactly as the target's sampling
(Leviathan et al. 2023 / Chen et al. 2023 accept/resample identity). Greedy
sampling degenerates to: accept while the draft's argmax equals the
target's, so the output is the target-only greedy stream whatever the draft
proposes.

Both engines share the vocabulary. The draft is a smaller model, another
quantization, or a depth-truncated view of the target (`truncate_params`,
whose layers alias the target's weights).

Samplers the device covers (`_fused_ok`: greedy, or temperature with top-k
in 1..1024, top-p, tail-free and typical, no penalties, no bias, no
mirostat) run fused rounds: on the card R rounds (rounds_per_dispatch) are
ONE CUDA graph, captured once per round key and replayed, as the engine's
decode chunks are (engine/engine.py _Chunk, _capture). A round is
  * k + 1 draft steps (S = 1: the GEMV and the decode attention kernel),
    each writing its K/V into a dense draft cache in place or, with an int8
    cache, into a pending buffer that one quantizing write ends (the
    engine's _steps scheme); the extra step keeps the draft's cache covering
    the committed prefix when all k drafts are accepted;
  * ONE target forward over [tok0; x_1..x_k] at S = k + 1 with n_past a
    device tensor (2 <= S <= 16: the rows kernel, kernels/quant_matmul.py
    route, and flash_mqa with a device n_past), logits at every position;
  * accept and commit on the device: the longest argmax-match prefix
    (greedy), or the stochastic identity over both models' cascade
    distributions (accept x ~ q w.p. min(1, p(x) / q(x)), else draw from
    norm(max(p - q, 0)); after k accepts the bonus draw is from p), then
    n_past advances on the device by n_acc + 1.
Rejected draft positions are written past the committed n_past, where
attention never reads and the next round writes. The round key is the
sampler's shape (greedy, or the candidate count K); the temperature, top-p,
tail-free z and typical p are device tensors written before each replay, so
a new value captures nothing (the JAX decoder keys its jit cache on the
float values, a fault this port does not copy). The stochastic
probabilities come from ops/sampling_device.py cascade_mask_probs over the
top-K slice, and each draw is an inverse CDF in token-id order over the
full-vocabulary distribution (the JAX round's cdf_draw), on uniforms drawn
from a torch.Generator before each replay: (R, 2k + 2) a dispatch (k + 1
draft draws, k accept tests, one resample or bonus draw), which
`last_rounds` returns per round and `generate(uniforms=)` can fix.

The host fetches a dispatch's ids while the next one runs (the JAX
_generate_fused pipelining) and, after the last, rolls both engines back to
the committed stream. Other samplers (penalties, logit bias) take the host
path: rounds of single-token draft evals and one target eval, with the
accept / resample math on the host over ops/sampling.py cascade_probs.
Mirostat defines no per-step distribution and is refused.

generate_rows is the batched counterpart (the JAX _fused_round_rows:324 and
generate_rows:408): greedy offline batch inference from B prompts on two
B-row engines. A batched round runs k + 1 draft steps of all B rows at
their own positions (S = B: the rows kernel, the decode attention kernel
with a (B,) valid length), ONE target forward of the B x (k + 1) rows
[tok0; x_1..x_k] at the rows' device n_past (B (k + 1) <= 16 rows on the
rows kernel, more on the tensor-core tile, and flash_mqa with a (B,)
n_past), then each row's longest argmax-match prefix, committed on the
device. R rounds are one CUDA graph, captured once a decoder (B and the
draft's cache kind are its engines', k and R its own) and replayed. Rows end
one by one: a (B,) live mask, written before each replay, freezes a done
row's n_past and token on the device (its n_acc counts 0), while the
others go on. Unlike the JAX generate_rows, which stops every row when the
longest nears the context, a row ends at its own context end.
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ggllm_tpu_torch.engine.engine import MAX_CHUNKS
from ggllm_tpu_torch.kernels import build
from ggllm_tpu_torch.ops import kvcache, sampling
from ggllm_tpu_torch.ops.sampling_device import cascade_mask_probs, n_candidates


@dataclass
class SpecStats:
    """Per-generation acceptance accounting."""

    n_rounds: int = 0
    n_drafted: int = 0
    n_accepted: int = 0  # drafted tokens that survived verification
    n_emitted: int = 0   # total committed tokens (incl. resample/bonus)

    @property
    def acceptance(self) -> float:
        return self.n_accepted / max(1, self.n_drafted)

    def report(self) -> str:
        return (f"speculative: {self.n_emitted} tokens in {self.n_rounds} "
                f"rounds ({self.n_emitted / max(1, self.n_rounds):.2f}/round), "
                f"draft acceptance {100 * self.acceptance:.1f}%")


def truncate_params(params: dict, n_layers: int) -> dict:
    """The first n_layers transformer blocks of a parameter tree, with the
    embedding, final norm and lm_head shared: the layer list is sliced, so
    the view aliases the loaded weights and copies nothing."""
    return {**params, "layers": list(params["layers"][:n_layers])}


def resample_dist(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """The corrected distribution after rejecting x ~ q: norm(max(p - q, 0)),
    or p where p <= q everywhere."""
    resid = np.maximum(p - q, 0.0)
    tot = float(resid.sum())
    return resid / tot if tot > 0 else p / max(float(p.sum()), 1e-20)


def spec_accept(p: np.ndarray, q: np.ndarray, x: int,
                rng: np.random.Generator, greedy: bool) -> bool:
    """Accept draft token x ~ q against target dist p: w.p. min(1, p[x]/q[x])
    (greedy: iff argmax p == x)."""
    if greedy:
        return int(np.argmax(p)) == x
    return rng.random() < min(1.0, float(p[x]) / max(float(q[x]), 1e-20))


def spec_resample(p: np.ndarray, q: np.ndarray,
                  rng: np.random.Generator, greedy: bool) -> int:
    """Corrected draw after rejecting x ~ q: a sample of resample_dist.
    Together with spec_accept this makes the committed token exactly
    p-distributed regardless of q (the rejection-sampling identity)."""
    if greedy:
        return int(np.argmax(p))
    dist = resample_dist(p, q)
    return int(rng.choice(dist.size, p=dist / dist.sum()))


def _draw(p: np.ndarray, rng: np.random.Generator, greedy: bool) -> int:
    return (int(np.argmax(p)) if greedy
            else int(rng.choice(p.size, p=p / p.sum())))


# ---------------------------------------------------------------- device math


def cdf_draw(dist: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse CDF over a (V,) distribution in token-id order (the JAX
    round's cdf_draw): the first id whose cumulative mass exceeds u times
    the total, else the last id of positive mass. A (1,) int64 tensor;
    reads nothing on the host."""
    V = dist.shape[0]
    cum = torch.cumsum(dist, 0)
    sel = (cum > u * cum[-1]).to(torch.uint8)
    last = (V - 1) - torch.argmax((dist > 0).flip(0).to(torch.uint8))
    return torch.where(sel.amax() > 0, torch.argmax(sel), last).reshape(1)


def accept_round(p: torch.Tensor, q: torch.Tensor, xs: torch.Tensor,
                 u_acc: torch.Tensor | None = None, u_fin: torch.Tensor | None = None):
    """A round's accept and commit on the device. p, q (k + 1, V): the
    target's and the draft's distributions at the round's k + 1 positions
    (greedy: the target's logits, q unused); xs (k,) the drafts. Greedy:
    the longest prefix where xs equals the target's argmax, then the
    target's own id. Otherwise accept x_i while u_acc[i] * q_i(x_i) <
    p_i(x_i) (u < p / q with q_i(x_i) > 0), then draw the resample
    norm(max(p - q, 0)) at the first rejection, or p alone after k accepts,
    on u_fin. Returns (the k + 1 committed-or-padding ids, n_acc (0-d),
    final id (1,))."""
    k = xs.shape[0]
    if u_acc is None:
        pargmax = torch.argmax(p, dim=-1)
        ok = torch.cumprod((pargmax[:k] == xs).to(torch.int64), 0)
        n_acc = ok.sum()
        final = pargmax.gather(0, n_acc.reshape(1))
    else:
        ar = torch.arange(k, device=xs.device)
        q_x, p_x = q[ar, xs], p[ar, xs]
        ok = torch.cumprod((u_acc * q_x < p_x).to(torch.int64), 0)
        n_acc = ok.sum()
        p_sel = p.index_select(0, n_acc.reshape(1))[0]
        q_sel = q.index_select(0, n_acc.reshape(1))[0] * (n_acc < k).to(q.dtype)
        resid = torch.clamp(p_sel - q_sel, min=0.0)
        tot = resid.sum()
        dist = torch.where(tot > 0, resid / torch.clamp(tot, min=1e-38), p_sel)
        final = cdf_draw(dist, u_fin)
    idx = torch.arange(k + 1, device=xs.device)
    toks = torch.where(idx < n_acc, torch.cat([xs, xs[:1]]), final)
    return toks, n_acc, final


def replay_round(p: np.ndarray, q: np.ndarray, xs, us: np.ndarray) -> tuple[list[int], int]:
    """accept_round's stochastic branch in float64 on the host, over a
    round's p and q (k + 1, V), its drafts xs and its 2k + 2 uniforms;
    returns (emitted ids, n_acc)."""
    p, q = np.asarray(p, np.float64), np.asarray(q, np.float64)
    k = len(xs)
    u_acc, u_fin = us[k + 1:2 * k + 1], float(us[2 * k + 1])
    n_acc = 0
    while n_acc < k and u_acc[n_acc] * q[n_acc, xs[n_acc]] < p[n_acc, xs[n_acc]]:
        n_acc += 1
    q_sel = q[n_acc] if n_acc < k else np.zeros_like(p[n_acc])
    resid = np.maximum(p[n_acc] - q_sel, 0.0)
    dist = resid / resid.sum() if resid.sum() > 0 else p[n_acc]
    cum = np.cumsum(dist)
    sel = np.flatnonzero(cum > u_fin * cum[-1])
    final = int(sel[0]) if sel.size else int(np.flatnonzero(dist > 0)[-1])
    return [int(x) for x in xs[:n_acc]] + [final], n_acc


class RoundKey(NamedTuple):
    """What a captured round's shapes and branches depend on: greedy or not,
    and the candidate slice the stochastic cascade cuts from."""

    greedy: bool
    n_cand: int  # 0 when greedy


def round_key(sampler, n_vocab: int) -> RoundKey:
    greedy = sampler.temp <= 0.0
    return RoundKey(greedy, 0 if greedy else n_candidates(int(sampler.top_k), n_vocab))


class _Round:
    """One fused-round program: its key, the static buffers its rounds read
    and write (the pending token, n_past, the sampler's values, the rounds'
    uniforms, ids and n_acc), pinned host buffers for two dispatches' ids,
    and its CUDA graph once captured (with the caches it points at)."""

    def __init__(self, key: RoundKey, R: int, k: int, device):
        self.key, self.n_steps = key, R  # a step of the program is a round
        self.vals = torch.ones(4, dtype=torch.float32, device=device)  # temp, top_p, tfs, typical
        self.tok = torch.zeros(1, dtype=torch.long, device=device)
        self.n_past = torch.zeros(1, dtype=torch.int32, device=device)
        self.u = None if key.greedy else torch.full((R, 2 * k + 2), 0.5, device=device)
        self.toks = torch.zeros(R, k + 1, dtype=torch.long, device=device)
        self.n_acc = torch.zeros(R, dtype=torch.long, device=device)
        pin = device.type == "cuda"
        # each copied whole (a strided pinned destination makes the copy synchronous)
        self.host = [(torch.empty(R, k + 1, dtype=torch.long, pin_memory=pin),
                      torch.empty(R, dtype=torch.long, pin_memory=pin),
                      torch.zeros(R, 2 * k + 2, pin_memory=pin)) for _ in range(2)]
        self.done = [torch.cuda.Event() if pin else None for _ in range(2)]
        self.graph: build.Graph | None = None
        self.caches = None  # (target kv, draft kv) the graph was captured on


ROWS_KEY = "rows"  # the batched rounds' program: one a decoder


class _RowRound:
    """One batched-round program (generate_rows): its key, the static
    buffers its rounds read and write (each row's pending token, n_past and
    live flag, the rounds' (R, B, k + 1) ids and (R, B) n_acc), pinned host
    buffers for two dispatches, each a tensor of its own, and its CUDA graph
    once captured (with the caches it points at)."""

    def __init__(self, key: str, B: int, R: int, k: int, device):
        self.key, self.n_steps = key, R  # a step of the program is a round
        self.tok = torch.zeros(B, dtype=torch.long, device=device)
        self.n_past = torch.zeros(B, dtype=torch.int32, device=device)
        self.live = torch.ones(B, dtype=torch.int32, device=device)
        self.toks = torch.zeros(R, B, k + 1, dtype=torch.long, device=device)
        self.n_acc = torch.zeros(R, B, dtype=torch.long, device=device)
        pin = device.type == "cuda"
        # each copied whole (a strided pinned destination makes the copy synchronous)
        self.host = [(torch.empty(R, B, k + 1, dtype=torch.long, pin_memory=pin),
                      torch.empty(R, B, dtype=torch.long, pin_memory=pin)) for _ in range(2)]
        self.done = [torch.cuda.Event() if pin else None for _ in range(2)]
        self.graph: build.Graph | None = None
        self.caches = None  # (target kv, draft kv) the graph was captured on


class SpeculativeDecoder:
    """Wraps a target and a draft engine; generates from the target's
    sampling distribution at > 1 token per target forward. generate takes
    single-stream engines (batch 1), generate_rows two B-row engines.

    Both engines must be at the same n_past with identical committed
    history. `k` is the draft length per round (2 <= k + 1 <= 16 keeps the
    verify on the rows kernel); rounds_per_dispatch rounds make one graph.
    eager=True runs the round body without a graph on the card (the
    reference the graphs are held to; the CPU always does)."""

    def __init__(self, target, draft, k: int = 6, rounds_per_dispatch: int = 4,
                 eager: bool = False):
        if getattr(target, "mesh", None) is not None or getattr(draft, "mesh", None) is not None:
            raise ValueError("speculative decoding requires a single-device engine")
        assert target.hp.n_vocab == draft.hp.n_vocab, "vocab mismatch"
        assert k >= 1 and rounds_per_dispatch >= 1
        assert target.device == draft.device, "target and draft on one device"
        self.target = target
        self.draft = draft
        self.k = k
        self.rounds = rounds_per_dispatch
        self.eager = eager
        self._programs: OrderedDict[RoundKey, _Round] = OrderedDict()
        self.record: list | None = None  # eager rounds append their p, q, drafts here
        self.stats = SpecStats()
        self.last_rounds: list[tuple[list[int], int, np.ndarray]] = []
        # generate_rows: each row's n_acc per consumed round, the live masks
        # of the dispatches, and the rows' device n_past at the end
        self.last_rows: dict = {}

    # ------------------------------------------------- fused device rounds

    def _fused_ok(self, sampler) -> bool:
        """Greedy, or the stochastic truncation cascade (temperature, top-k
        in 1..1024, top-p, tail-free, typical) with no penalties, bias or
        mirostat, on batch-1 engines; everything else takes the host path."""
        if not (sampler.repeat_penalty == 1.0
                and sampler.frequency_penalty == 0.0
                and sampler.presence_penalty == 0.0
                and not sampler.logit_bias
                and sampler.mirostat == 0
                and self.target.batch == 1 and self.draft.batch == 1):
            return False
        if sampler.temp <= 0:
            return True
        return 0 < sampler.top_k <= 1024

    def _program(self, key, make=None):
        """The program of `key` (a RoundKey, made by `make` otherwise), built
        on first use; at most MAX_CHUNKS are kept, least recently used out."""
        c = self._programs.get(key)
        if c is None:
            if len(self._programs) >= MAX_CHUNKS:
                if self.target.device.type == "cuda":
                    torch.cuda.synchronize(self.target.device)
                self._programs.popitem(last=False)
            c = self._programs[key] = (make() if make is not None
                                       else _Round(key, self.rounds, self.k, self.target.device))
        self._programs.move_to_end(key)
        return c

    def round_graph(self, sampler) -> build.Graph | None:
        """The captured round graph of the sampler's key, or None."""
        c = self._programs.get(round_key(sampler, self.target.hp.n_vocab))
        return None if c is None else c.graph

    def _cascade(self, lg: torch.Tensor, c: _Round) -> torch.Tensor:
        """(n, V) logits -> (n, V) post-cascade probabilities (the JAX round's
        cascade_full): cascade_mask_probs over the top-K slice, the sampler's
        values read from c.vals on the device."""
        n, V = lg.shape
        vals, idx = torch.topk(lg, c.key.n_cand)
        kt = torch.full((n,), c.key.n_cand, dtype=torch.long, device=lg.device)
        temp, top_p, tfs, typ = (c.vals[i:i + 1].expand(n) for i in range(4))
        probs, _ = cascade_mask_probs(vals, temp, top_p, kt, tfs, typ)
        return torch.zeros(n, V, dtype=torch.float32, device=lg.device).scatter(1, idx, probs)

    def _rounds(self, c: _Round, n_rounds: int, at: list | None = None) -> None:
        """The round body: n_rounds rounds from c.tok at position c.n_past,
        each one's ids into c.toks[r] and n_acc into c.n_acc[r], advancing
        c.n_past and c.tok on the device. Reads and writes only device
        tensors: this is what a graph captures. at[0] follows the round."""
        tgt, dr, k = self.target, self.draft, self.k
        greedy = c.key.greedy
        dkv = dr.kv
        quant = kvcache.is_quantized(dkv)
        for r in range(n_rounds):
            if at is not None:
                at[0] = r
            n_past, tok0 = c.n_past, c.tok.clone()
            pending = None
            if quant:  # chunk-deferred: the draft's cache is read-only in the round
                L_, _, B, _, KV, D = dkv[0].shape
                pending = torch.zeros(L_, 2, B, k + 1, KV, D, device=dr.device,
                                      dtype=getattr(torch, dr.cfg.compute_dtype))
            tok, drafted, qs = tok0, [], []
            for j in range(k + 1):
                pos = n_past if j == 0 else n_past + j
                if pending is None:
                    lg = dr.model(tok.view(1, 1), dkv, pos, dr.inv_freq)[0, 0]
                else:
                    lg, kv_new = dr.model(tok.view(1, 1), dkv, pos, dr.inv_freq,
                                          pending=pending, n_pend=j)
                    pending[:, :, :, j:j + 1] = kv_new
                    lg = lg[0, 0]
                if greedy:
                    nxt = torch.argmax(lg).reshape(1)
                else:
                    q = self._cascade(lg.float()[None], c)[0]
                    nxt = cdf_draw(q, c.u[r, j])
                    qs.append(q)
                drafted.append(nxt)
                tok = nxt
            if pending is not None:  # the round's one (quantizing) write
                kvcache.write_all_layers(dkv, pending, n_past)
            xs = torch.cat(drafted[:k])
            seq = torch.cat([tok0, xs]).view(1, k + 1)
            rows = tgt.model(seq, tgt.kv, n_past, tgt.inv_freq, logits_all=True)[0].float()
            if greedy:
                toks, n_acc, final = accept_round(rows, rows, xs)
            else:
                p, q = self._cascade(rows, c), torch.stack(qs)
                toks, n_acc, final = accept_round(p, q, xs, c.u[r, k + 1:2 * k + 1],
                                                  c.u[r, 2 * k + 1])
                if self.record is not None:
                    self.record.append({"p": p, "q": q, "xs": xs})
            c.toks[r] = toks
            c.n_acc[r] = n_acc
            c.n_past.add_((n_acc + 1).to(torch.int32))
            c.tok.copy_(final)

    def _start(self, c: _Round, sampler, tok: int, eager: bool) -> None:
        """Write the sampler's values, capture c if it runs as a graph and
        has none for the engines' current caches, then set the first token
        and n_past."""
        host = torch.tensor([sampler.temp, sampler.top_p, sampler.tfs_z, sampler.typical_p],
                            dtype=torch.float32)
        pin = self.target.device.type == "cuda"
        c.vals.copy_(host.pin_memory() if pin else host, non_blocking=True)
        caches = (self.target.kv, self.draft.kv)
        if not eager and pin and (c.graph is None or c.caches[0] is not caches[0]
                                  or c.caches[1] is not caches[1]):
            # on the target's capture stream and memory pool, after one eager
            # round there; the warm-up writes cache positions at and above
            # n_past only, and moves c.tok / c.n_past, which are set below
            c.tok.fill_(tok)
            c.n_past.fill_(self.target.n_past)
            self.target._capture(c, self._rounds, f"the {c.n_steps}-round speculative program"
                                 f" (key {c.key}, k {self.k}; a step here is a round)")
            c.caches = caches
        c.tok.fill_(tok)
        c.n_past.fill_(self.target.n_past)

    def _dispatch(self, c: _Round, slot: int, generator, us, eager: bool) -> None:
        """One dispatch of R rounds from the device state in c: its
        uniforms (drawn, or `us` (R, 2k + 2) given), the graph replayed (or
        the body run), its ids, n_acc and uniforms copied to pinned host
        buffer `slot` behind an event. Nothing here waits for the device."""
        if c.u is not None:
            if us is None:
                c.u.uniform_(generator=generator)
            else:
                src = torch.from_numpy(np.ascontiguousarray(us, dtype=np.float32))
                c.u.copy_(src.pin_memory() if c.done[0] is not None else src, non_blocking=True)
        if eager or c.graph is None:
            self._rounds(c, c.n_steps)
        else:
            c.graph.replay()
        toks, n_acc, u = c.host[slot]
        toks.copy_(c.toks, non_blocking=True)
        n_acc.copy_(c.n_acc, non_blocking=True)
        if c.u is not None:
            u.copy_(c.u, non_blocking=True)
        if c.done[slot] is not None:
            c.done[slot].record()

    @staticmethod
    def _fetch(c: _Round, slot: int):
        if c.done[slot] is not None:
            c.done[slot].synchronize()
        return tuple(t.numpy().copy() for t in c.host[slot])

    @torch.inference_mode()
    def _generate_fused(self, prompt_ids, n_predict, stop_ids, on_token, stats, sampler,
                        uniforms=None) -> list[int]:
        tgt, dr, k, R = self.target, self.draft, self.k, self.rounds
        base = tgt.n_past  # engines may enter pre-advanced (server prefix reuse)
        if len(prompt_ids) > 1:
            tgt.eval(prompt_ids[:-1])
            dr.eval(prompt_ids[:-1])
        eager = self.eager or tgt.device.type != "cuda"
        c = self._program(round_key(sampler, tgt.hp.n_vocab))
        seed = sampler.seed if sampler.seed >= 0 else int.from_bytes(os.urandom(4), "little")
        generator = torch.Generator(device=tgt.device).manual_seed(seed)
        if uniforms is not None:
            uniforms = np.asarray(uniforms, np.float32).reshape(-1, 2 * k + 2)

        def block_us(i: int):
            """Dispatch i's (R, 2k + 2) uniforms from `uniforms`, 0.5 past them."""
            if uniforms is None:
                return None
            us = np.full((R, 2 * k + 2), 0.5, np.float32)
            rows = uniforms[i * R:(i + 1) * R]
            us[:len(rows)] = rows
            return us

        t_compile = tgt.timings.t_compile_us
        t0 = time.perf_counter()
        self._start(c, sampler, prompt_ids[-1], eager)
        out: list[int] = []
        # per consumed round: (committed tokens, n_acc, uniforms)
        self.last_rounds = []
        stop = False

        def consume(fetched):
            """Commit one fetched dispatch (R rounds) to the host stream."""
            nonlocal stop
            toks_h, n_acc_h, us_h = fetched
            for r in range(toks_h.shape[0]):
                n_acc = int(n_acc_h[r])
                emitted = [int(t) for t in toks_h[r, : n_acc + 1]]
                self.last_rounds.append((emitted, n_acc, us_h[r]))
                stats.n_rounds += 1
                stats.n_drafted += k
                stats.n_accepted += n_acc
                stats.n_emitted += len(emitted)
                tgt.n_past += n_acc + 1
                dr.n_past += n_acc + 1
                for t in emitted:
                    out.append(t)
                    if on_token is not None and on_token(t) is False:
                        stop = True
                    elif stop_ids and t in stop_ids:
                        stop = True
                    if len(out) >= n_predict:
                        stop = True
                    if stop:
                        return

        # the next dispatch goes out before the previous one's ids are
        # fetched: tgt.n_past is the consumed position, and at most one
        # unconsumed dispatch (<= R (k + 1) positions) is in flight when the
        # next one starts, so both stay inside the context
        n_disp = 0
        try:
            while not stop and tgt.n_past + 2 * R * (k + 1) <= tgt.cfg.n_ctx:
                self._dispatch(c, n_disp % 2, generator, block_us(n_disp), eager)
                n_disp += 1
                if n_disp > 1:
                    consume(self._fetch(c, n_disp % 2))
            if n_disp and not stop:
                consume(self._fetch(c, (n_disp - 1) % 2))
        finally:
            # re-align both engines with the committed stream (drop rounds
            # past n_predict or a stop; their cache positions lie past n_past)
            n_final = base + len(prompt_ids) + len(out) - 1
            tgt.rollback(min(tgt.n_past, n_final))
            dr.rollback(min(dr.n_past, n_final))
            tgt.timings.t_decode_us += ((time.perf_counter() - t0) * 1e6
                                        - (tgt.timings.t_compile_us - t_compile))
            tgt.timings.n_decode += len(out)
        return out[:n_predict]

    # ------------------------------------------- batched fused rounds (B rows)

    def _row_program(self) -> _RowRound:
        return self._program(ROWS_KEY, lambda: _RowRound(ROWS_KEY, self.target.batch,
                                                         self.rounds, self.k, self.target.device))

    def rows_graph(self) -> build.Graph | None:
        """The captured batched-round graph, or None."""
        c = self._programs.get(ROWS_KEY)
        return None if c is None else c.graph

    def _rounds_rows(self, c: _RowRound, n_rounds: int, at: list | None = None) -> None:
        """The batched round body (the JAX _fused_round_rows:324): n_rounds
        greedy rounds of all B rows from c.tok at the rows' own positions
        c.n_past, each round's ids into c.toks[r] and n_acc into c.n_acc[r];
        a row whose c.live is 0 commits nothing (n_acc 0, its n_past and
        token unchanged). Reads and writes only device tensors: this is
        what a graph captures. at[0] follows the round."""
        tgt, dr, k = self.target, self.draft, self.k
        B, dkv = tgt.batch, dr.kv
        quant = kvcache.is_quantized(dkv)
        ar = torch.arange(k + 1, device=tgt.device)
        for r in range(n_rounds):
            if at is not None:
                at[0] = r
            npv, tok0 = c.n_past, c.tok.clone()
            pending = None
            if quant:  # chunk-deferred: the draft's cache is read-only in the round
                L_, _, _, _, KV, D = dkv[0].shape
                pending = torch.zeros(L_, 2, B, k + 1, KV, D, device=dr.device,
                                      dtype=getattr(torch, dr.cfg.compute_dtype))
            tok, drafted = tok0, []
            for j in range(k + 1):  # every row at its own position, S = B
                pos = npv if j == 0 else npv + j
                if pending is None:
                    lg = dr.model(tok.view(B, 1), dkv, pos, dr.inv_freq)[:, 0]
                else:
                    lg, kv_new = dr.model(tok.view(B, 1), dkv, pos, dr.inv_freq,
                                          pending=pending, n_pend=j)
                    pending[:, :, :, j:j + 1] = kv_new
                    lg = lg[:, 0]
                tok = torch.argmax(lg, dim=-1)
                drafted.append(tok)
            if pending is not None:  # the round's one (quantizing) per-row write
                kvcache.write_all_layers(dkv, pending, npv)
            xs = torch.stack(drafted[:k], dim=1)  # (B, k)
            seq = torch.cat([tok0[:, None], xs], dim=1)  # (B, k + 1): one verify forward
            rows = tgt.model(seq, tgt.kv, npv, tgt.inv_freq, logits_all=True).float()
            pargmax = torch.argmax(rows, dim=-1)  # (B, k + 1)
            ok = torch.cumprod((pargmax[:, :k] == xs).to(torch.int64), dim=1)
            n_acc = ok.sum(dim=1) * c.live
            final = pargmax.gather(1, n_acc[:, None])[:, 0]
            c.toks[r] = torch.where(ar[None, :] < n_acc[:, None],
                                    torch.cat([xs, xs[:, :1]], dim=1), final[:, None])
            c.n_acc[r] = n_acc
            c.n_past.add_(((n_acc + 1) * c.live).to(torch.int32))
            c.tok.copy_(torch.where(c.live > 0, final, c.tok))

    def _start_rows(self, c: _RowRound, toks: np.ndarray, npv: np.ndarray, eager: bool) -> None:
        """Capture c if it runs as a graph and has none for the engines'
        current caches, then set every row live at its token and n_past."""
        tok = torch.from_numpy(np.asarray(toks, np.int64))
        n_past = torch.from_numpy(np.asarray(npv, np.int32))
        caches = (self.target.kv, self.draft.kv)
        c.live.fill_(1)
        if not eager and self.target.device.type == "cuda" and (
                c.graph is None or c.caches[0] is not caches[0] or c.caches[1] is not caches[1]):
            # on the target's capture stream and memory pool, after one eager
            # round there; the warm-up writes cache positions at and above
            # each row's n_past only, and moves c.tok / c.n_past, set below
            c.tok.copy_(tok)
            c.n_past.copy_(n_past)
            self.target._capture(c, self._rounds_rows,
                                 f"the {c.n_steps}-round batched speculative program"
                                 f" ({self.target.batch} rows, k {self.k}; a step here is a round)")
            c.caches = caches
        c.tok.copy_(tok)
        c.n_past.copy_(n_past)

    def _dispatch_rows(self, c: _RowRound, slot: int, live: np.ndarray, eager: bool) -> None:
        """One dispatch of R batched rounds: the live mask written, the graph
        replayed (or the body run), its ids and n_acc copied to pinned host
        buffer `slot` behind an event. Nothing here waits for the device."""
        src = torch.from_numpy(live.astype(np.int32))
        pin = c.done[0] is not None
        c.live.copy_(src.pin_memory() if pin else src, non_blocking=True)
        if eager or c.graph is None:
            self._rounds_rows(c, c.n_steps)
        else:
            c.graph.replay()
        toks, n_acc = c.host[slot]
        toks.copy_(c.toks, non_blocking=True)
        n_acc.copy_(c.n_acc, non_blocking=True)
        if pin:
            c.done[slot].record()

    @torch.inference_mode()
    def generate_rows(self, prompts, n_predict: int,
                      stop_ids: set | None = None) -> list[list[int]]:
        """Generate GREEDILY from B prompts at once through batched fused
        rounds (the JAX generate_rows:408; offline batch inference). Both
        engines are B-row engines (batch_size == B == len(prompts)) and
        enter fresh: each row's prompt but its last token is prefilled at
        position 0, and the last is the row's first pending token.

        A row is done when it has n_predict ids, emits a stop id, or when
        its position plus 2 R (k + 1) would pass the context (then it ends
        with fewer ids, as the single stream's fused rounds do); the others
        go on. The host fetches a dispatch's ids while the next one runs, so
        a row may run one dispatch past its end before its live mask takes
        effect: those ids are discarded, and the margin keeps its writes
        inside the cache. Returns one list of ids per row; fills `stats` and
        the target's timings (capture time under compile) and `last_rows`."""
        tgt, dr, k, R = self.target, self.draft, self.k, self.rounds
        B = tgt.batch
        if dr.batch != B or len(prompts) != B:
            raise ValueError(f"generate_rows: {len(prompts)} prompts for a {B}-row target and a"
                             f" {dr.batch}-row draft: one prompt a row")
        prompts = [[int(t) for t in np.asarray(p).reshape(-1)] for p in prompts]
        if not all(prompts):
            raise ValueError("generate_rows: every row needs a prompt")
        n_ctx = min(tgt.cfg.n_ctx, dr.cfg.n_ctx)
        stats = self.stats = SpecStats()
        heads = [b for b in range(B) if len(prompts[b]) > 1]
        if heads:
            zeros = np.zeros(B, np.int64)
            for eng in (tgt, dr):
                eng.prefill_rows(heads, [prompts[b][:-1] for b in heads], zeros, fetch_rows=set())
        npv = np.asarray([len(p) - 1 for p in prompts], np.int64)  # the consumed positions
        eager = self.eager or tgt.device.type != "cuda"
        c = self._row_program()
        span = R * (k + 1)  # the most one dispatch advances a row
        out: list[list[int]] = [[] for _ in range(B)]
        accs: list[list[int]] = [[] for _ in range(B)]
        done = [False] * B
        lives: list[np.ndarray] = []

        def consume(fetched, live: np.ndarray) -> None:
            """Commit one fetched dispatch to the rows that were live in it
            and are not done."""
            toks_h, acc_h = fetched
            for r in range(R):
                stats.n_rounds += 1
                for b in range(B):
                    if not live[b] or done[b]:
                        continue
                    n_acc = int(acc_h[r, b])
                    accs[b].append(n_acc)
                    stats.n_drafted += k
                    stats.n_accepted += n_acc
                    npv[b] += n_acc + 1
                    for t in toks_h[r, b, :n_acc + 1]:
                        out[b].append(int(t))
                        stats.n_emitted += 1
                        if (stop_ids and int(t) in stop_ids) or len(out[b]) >= n_predict:
                            done[b] = True
                            break

        t_compile = tgt.timings.t_compile_us
        t0 = time.perf_counter()
        self._start_rows(c, [p[-1] for p in prompts], npv, eager)
        # dispatch i goes out before dispatch i - 1's ids are fetched: a live
        # row's device position is at most its consumed npv + span then, and
        # dispatch i adds at most span more, so npv + 2 span <= n_ctx keeps
        # it inside the context; a row that fails it stays frozen
        n_disp = 0
        while True:
            live = np.asarray([not done[b] and npv[b] + 2 * span <= n_ctx for b in range(B)])
            if not live.any():
                break
            self._dispatch_rows(c, n_disp % 2, live, eager)
            lives.append(live)
            n_disp += 1
            if n_disp > 1:
                consume(self._fetch(c, n_disp % 2), lives[n_disp - 2])
        if n_disp:
            consume(self._fetch(c, (n_disp - 1) % 2), lives[n_disp - 1])
        self.last_rows = {"n_acc": accs, "live": lives, "n_past": c.n_past.cpu().numpy()}
        tgt.timings.t_decode_us += ((time.perf_counter() - t0) * 1e6
                                    - (tgt.timings.t_compile_us - t_compile))
        tgt.timings.n_decode += sum(len(o) for o in out)
        return [o[:n_predict] for o in out]

    # ------------------------------------------------------------ host rounds

    def generate(self, prompt_ids, n_predict: int,
                 sampler: sampling.SamplerParams | None = None,
                 state: sampling.SamplerState | None = None,
                 stop_ids: set | None = None, on_token=None, uniforms=None) -> list[int]:
        """Generate up to n_predict tokens after prompt_ids. Returns the
        committed tokens (committed = evaluated by the target; the trailing
        pending token is included). Greedy and cascade samplers; mirostat
        raises ValueError. uniforms (n, 2k + 2): the fused stochastic rounds'
        uniforms in round order (a replay; rounds past them draw 0.5) instead
        of the sampler seed's generator."""
        sampler = sampler or sampling.SamplerParams(temp=0.0)
        if sampler.mirostat:
            raise ValueError("mirostat does not define a static per-step "
                             "distribution; unsupported in speculative mode")
        state = state or sampling.SamplerState.init(sampler)
        n_ctx = self.target.cfg.n_ctx
        prompt_ids = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        assert prompt_ids, "speculative generation needs a prompt"
        stats = self.stats = SpecStats()
        if (self._fused_ok(sampler)
                and self.target.n_past + len(prompt_ids) - 1
                + 2 * self.rounds * (self.k + 1) <= n_ctx):
            return self._generate_fused(prompt_ids, n_predict, stop_ids,
                                        on_token, stats, sampler, uniforms)

        # prefill both models on the prompt minus its last token; that last
        # token is the first pending token t0
        history = list(prompt_ids)
        t0 = history[-1]
        if len(prompt_ids) > 1:
            self.target.eval(prompt_ids[:-1])
            self.draft.eval(prompt_ids[:-1])
        out: list[int] = []
        while len(out) < n_predict:
            budget = n_predict - len(out)
            k = min(self.k, budget, n_ctx - self.target.n_past - 2)
            if k < 1:
                break
            emitted, t0 = self._round(t0, history, sampler, state, k, stats)
            for t in emitted:
                out.append(t)
                history.append(t)
                if on_token is not None and on_token(t) is False:
                    return out
                if stop_ids and t in stop_ids:
                    return out
                if len(out) >= n_predict:
                    break
        return out

    def _round(self, t0: int, history: list[int], sampler: sampling.SamplerParams,
               state: sampling.SamplerState, k: int,
               stats: SpecStats) -> tuple[list[int], int]:
        """One host-orchestrated draft/verify/accept round. Both engines
        enter at the same n_past with t0 pending (unevaluated); they leave
        re-synchronized with the returned pending token unevaluated. Returns
        (committed tokens: x_1..x_{i-1} + corrected/bonus, new pending token)."""
        tgt, dr = self.target, self.draft
        n0 = tgt.n_past
        assert dr.n_past == n0, (dr.n_past, n0)
        n_ctx = tgt.cfg.n_ctx

        def probs(logits, hist):
            return sampling.cascade_probs(logits, hist, sampler, n_ctx, nl_token=tgt.nl_token)

        # draft k tokens autoregressively, recording each proposal dist
        greedy = sampler.temp <= 0
        xs: list[int] = []
        qs: list[np.ndarray] = []
        hist_d = list(history)
        x = t0
        for _ in range(k):
            q = probs(dr.eval([x]), hist_d)
            x = _draw(q, state.rng, greedy)
            xs.append(x)
            qs.append(q)
            hist_d.append(x)
        # the draft is now at n0+k having evaluated [t0, x_1..x_{k-1}]

        # verify: ONE target forward over [t0, x_1..x_k] -> k+1 rows
        rows = tgt.eval([t0] + xs, logits_all=True)
        stats.n_rounds += 1
        stats.n_drafted += k

        # accept/resample (exact target-distribution identity)
        hist_t = list(history)
        emitted: list[int] = []
        n_acc = 0
        pending = None
        for i in range(k):
            p = probs(rows[i], hist_t)
            if spec_accept(p, qs[i], xs[i], state.rng, greedy):
                emitted.append(xs[i])
                hist_t.append(xs[i])
                n_acc += 1
                continue
            pending = spec_resample(p, qs[i], state.rng, greedy)
            break
        stats.n_accepted += n_acc

        if pending is None:
            # all k accepted: bonus token from the target's k-th row; the
            # draft evaluated only through x_{k-1}: catch it up on x_k
            pending = _draw(probs(rows[k], hist_t), state.rng, greedy)
            dr.eval([xs[k - 1]])
        else:
            # roll both engines back to the last verified position; the
            # cache beyond n_past is never read
            tgt.rollback(n0 + n_acc + 1)
            dr.rollback(n0 + n_acc + 1)
        emitted.append(pending)
        stats.n_emitted += len(emitted)
        return emitted, pending
