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

The batched rounds (the JAX generate_rows) are not ported.
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


class SpeculativeDecoder:
    """Wraps a target and a draft engine (single-stream, batch 1); generates
    from the target's sampling distribution at > 1 token per target forward.

    Both engines must be at the same n_past with identical committed
    history. `k` is the draft length per round (2 <= k + 1 <= 16 keeps the
    verify on the rows kernel); rounds_per_dispatch rounds make one graph.
    eager=True runs the round body without a graph on the card (the
    reference the graphs are held to; the CPU always does)."""

    def __init__(self, target, draft, k: int = 6, rounds_per_dispatch: int = 4,
                 eager: bool = False):
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

    def _program(self, key: RoundKey) -> _Round:
        c = self._programs.get(key)
        if c is None:
            if len(self._programs) >= MAX_CHUNKS:
                if self.target.device.type == "cuda":
                    torch.cuda.synchronize(self.target.device)
                self._programs.popitem(last=False)
            c = self._programs[key] = _Round(key, self.rounds, self.k, self.target.device)
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
