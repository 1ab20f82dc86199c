"""Generation loop for the CLI (port of ggllm_tpu/engine/generator.py:18-228).

Wraps a FalconEngine with the falcon_main generation-loop semantics
(falcon_main.cpp:676-1056): host-sampled first token, pipelined chunks of
device decode when the sampler config is device-coverable (engine
decode_pipelined: on the card, replays of the chunk's CUDA graph), the
per-token host cascade otherwise, and context swap with n_keep on overflow
(falcon_main.cpp:694-760). Grammar-constrained decoding is not ported yet.
"""

from __future__ import annotations

import time

from ggllm_tpu_torch.engine.engine import FalconEngine
from ggllm_tpu_torch.ops import sampling, sampling_device


GRAMMAR_NOT_PORTED = ("grammar-constrained decoding is not ported yet"
                      " (ROADMAP.md, Queue 1: Grammar)")


class GrammarNotPorted(NotImplementedError):
    """A grammar-constrained generation was asked for (the server answers
    such a request with HTTP 400 and this message)."""


class Generator:
    """One generation stream over an engine: fused decode when the sampler
    allows, host cascade otherwise; context swap on overflow.

    Invariant between calls: every token in all_tokens except those in
    pending_feed has been forwarded through the model (is in the KV cache);
    at a turn boundary pending_feed holds the final sampled token, which the
    next turn's prefill (or the fused/host forward) consumes."""

    def __init__(self, engine: FalconEngine, sampler: sampling.SamplerParams,
                 eos_id: int, n_keep: int = 0, fused_ok: bool = True,
                 log=None, grammar=None):
        if grammar is not None:
            raise GrammarNotPorted(GRAMMAR_NOT_PORTED)
        self.eng = engine
        self.sampler = sampler
        self.state = sampling.SamplerState.init(sampler)
        self.eos_id = eos_id
        self.n_keep = n_keep
        self.fused = fused_ok and sampling_device.device_samplable(sampler)
        self.rng = None  # the engine's torch.Generator, made on first use
        self.log = log or (lambda msg: None)
        self.all_tokens: list[int] = []  # full prompt+generation history
        self.pending_feed: list[int] = []  # sampled but not yet forwarded
        self.swapped = False  # a context swap broke the tokens<->KV mapping

    def prefill(self, ids: list[int]):
        """Feed new tokens (plus any unforwarded tail); returns final logits."""
        cfg = self.eng.cfg
        feed = self.pending_feed + list(map(int, ids))
        self.pending_feed = []
        if len(feed) >= cfg.n_ctx:
            # pathological: the new input alone overflows — keep its tail
            feed = feed[-(cfg.n_ctx - 1):]
            self.eng.reset()
        elif self.eng.n_past + len(feed) > cfg.n_ctx:
            self._swap(reserve=len(feed))
        self.all_tokens.extend(map(int, ids))
        return self.eng.eval(feed)

    def _swap(self, reserve: int = 0):
        """Context swap (falcon_main.cpp:694-760): keep the first n_keep
        prompt tokens, re-ingest the most recent half of the remaining
        window (leaving room for `reserve` upcoming tokens). Tokens in
        pending_feed are NOT re-ingested — the caller's next forward
        consumes them."""
        cfg = self.eng.cfg
        n_keep = min(max(self.n_keep, 0), cfg.n_ctx // 2)
        tail_len = max((cfg.n_ctx - n_keep) // 2, 1)
        if reserve:
            tail_len = max(min(tail_len, cfg.n_ctx - n_keep - reserve), 0)
        hist = self.all_tokens[: len(self.all_tokens) - len(self.pending_feed)]
        head = hist[:n_keep]
        tail = hist[len(head):][-tail_len:] if tail_len else []
        self.eng.reset()
        ctx = head + tail
        if ctx:
            self.eng.eval(ctx)
        self.swapped = True
        self.log(f"context swap: kept {len(head)}+{len(tail)} tokens")

    def _host_sample(self, logits) -> int:
        """One host-cascade sample over the whole history."""
        return sampling.sample(logits, self.all_tokens, self.sampler, self.state,
                               self.eng.cfg.n_ctx, nl_token=self.eng.nl_token)

    def generate(self, logits, n_predict: int, on_token) -> str:
        """Sample up to n_predict tokens; on_token(tok) -> False to stop.
        Returns the stop reason ('limit' | 'eos' | 'callback')."""
        eng, sampler = self.eng, self.sampler
        st = {"n_out": 0, "reason": None}

        def consume(t: int) -> bool:
            """Commit one sampled token; False ends the generation."""
            self.all_tokens.append(t)
            st["n_out"] += 1
            if t == self.eos_id:
                st["reason"] = "eos"
            elif not on_token(t):
                st["reason"] = "callback"
            elif st["n_out"] >= n_predict:
                st["reason"] = "limit"
            return st["reason"] is None

        # first token after prefill is host-sampled from the prefill logits
        # (exact cascade; the fused loop samples the successors on device)
        t0 = time.perf_counter()
        tok = self._host_sample(logits)
        eng.timings.t_sample_us += (time.perf_counter() - t0) * 1e6
        eng.timings.n_sample += 1
        try:
            if not consume(tok):
                return st["reason"]
            while True:
                if eng.n_past >= eng.cfg.n_ctx:
                    self.pending_feed = [self.all_tokens[-1]]
                    self._swap()
                    self.pending_feed = []
                if self.fused:
                    # pipelined chunks: consumption (stop checks, streaming)
                    # happens per fetched chunk while the next one computes
                    # (whole chunks, as the JAX Generator calls them; a
                    # shorter tail runs one chunk whose surplus is dropped)
                    n_total = min(n_predict - st["n_out"], eng.cfg.n_ctx - eng.n_past)
                    if n_total >= eng.cfg.decode_chunk:
                        n_total -= n_total % eng.cfg.decode_chunk
                    n_before = eng.n_past
                    consumed = [0]

                    def on_chunk(arr) -> bool:
                        eng.timings.n_sample += len(arr)
                        for t in map(int, arr):
                            consumed[0] += 1
                            if not consume(t):
                                return False
                        return True

                    ok = False
                    try:
                        # only the penalty window's worth of history matters
                        win = max(int(sampler.repeat_last_n), 1)
                        _, self.rng = eng.decode_pipelined(
                            self.all_tokens[-1], n_total, eng.cfg.decode_chunk,
                            sampler, self.rng,
                            last_tokens=self.all_tokens[-win:],
                            on_tokens=on_chunk)
                        ok = True
                    finally:
                        if (not ok or st["reason"] is not None) \
                                and eng.n_past > n_before + consumed[0]:
                            # un-commit KV positions of tokens never consumed
                            # (incl. any chunk enqueued past the stop or an
                            # on_token exception); the final consumed token is
                            # always left unforwarded
                            eng.rollback(n_before + consumed[0])
                    if st["reason"] is not None:
                        return st["reason"]
                else:
                    new_logits = eng.eval([self.all_tokens[-1]])
                    t0 = time.perf_counter()
                    tok = self._host_sample(new_logits)
                    eng.timings.t_sample_us += (time.perf_counter() - t0) * 1e6
                    eng.timings.n_sample += 1
                    if not consume(tok):
                        return st["reason"]
        finally:
            self.pending_feed = [self.all_tokens[-1]]
