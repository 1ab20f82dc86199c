"""Generation loop for the CLI and the server (port of
ggllm_tpu/engine/generator.py:18-272).

Wraps a FalconEngine with the falcon_main generation-loop semantics
(falcon_main.cpp:676-1056): host-sampled first token, pipelined chunks of
device decode when the sampler config is device-coverable (engine
decode_pipelined: on the card, replays of the chunk's CUDA graph), the
per-token host cascade otherwise, and context swap with n_keep on overflow
(falcon_main.cpp:694-760).

Under a grammar (ops/grammar.py GrammarSampler) every id is sampled from
logits masked to the grammar state's valid tokens, before the bias and the
penalties, and then `accept`ed, which raises GrammarError for a token the
mask should have excluded (nothing is resampled). Samplers the device
cascade covers decode through engine.decode_chunk_masked (the mask uploaded
as packed bits): one step a chunk while the grammar state changes, and once
the state has looped onto itself twice, chunks of C = max(2, min(16,
decode_chunk)) steps, whose ids are consumed up to the state's first change
or a stop, the rest rolled back. The others (and the first id after a
prompt) go through the host cascade over filter_logits.
"""

from __future__ import annotations

import time

from ggllm_tpu_torch.engine.engine import FalconEngine
from ggllm_tpu_torch.ops import sampling, sampling_device


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
        if grammar is not None and getattr(engine, "mesh", None) is not None:
            raise ValueError("grammar requires a single-device engine")
        self.eng = engine
        self.sampler = sampler
        self.state = sampling.SamplerState.init(sampler)
        self.eos_id = eos_id
        self.n_keep = n_keep
        self.grammar = grammar  # ops.grammar.GrammarSampler or None
        device_ok = fused_ok and sampling_device.device_samplable(sampler)
        self.fused = device_ok and grammar is None
        # a grammar's masked device steps (engine.decode_chunk_masked); the
        # host cascade over filter_logits otherwise
        self.grammar_device = device_ok and grammar is not None
        self.eager = False  # masked chunks through the eager step body (a reference)
        self._gloop_run = 0  # masked steps in a row whose state looped onto itself
        # masked dispatches: 1-step, C-step, and C-step chunks rolled back
        self.masked_stats = {"steps": 0, "chunks": 0, "rolled_back": 0}
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
        """One host-cascade sample over the whole history, grammar-masked
        when constrained (filter_logits before the cascade, then `accept`)."""
        if self.grammar is not None:
            logits = self.grammar.filter_logits(logits)
        tok = sampling.sample(logits, self.all_tokens, self.sampler, self.state,
                              self.eng.cfg.n_ctx, nl_token=self.eng.nl_token)
        if self.grammar is not None:
            self.grammar.accept(tok)
        return tok

    def _masked_chunk(self, rem: int, consume) -> bool:
        """One masked device dispatch (the JAX Generator's grammar_device
        branch): the grammar state's packed mask, 1 step, or C steps while
        the state loops onto itself; every id is accepted (GrammarError if
        the mask let a wrong one through) and consumed up to the state's
        first change or a stop, the rest rolled back. False once
        generation ends."""
        eng, g = self.eng, self.grammar
        s0 = (g.stacks, g.partial)
        bits = g.valid_bits()
        # one of two chunk sizes (two graphs): rem and room do not shrink it
        C = max(2, min(16, eng.cfg.decode_chunk))
        room = eng.cfg.n_ctx - eng.n_past
        n = C if self._gloop_run >= 2 and room >= C and rem >= 2 else 1
        win = max(int(self.sampler.repeat_last_n), 1)
        n_before = eng.n_past
        toks, self.rng = eng.decode_chunk_masked(
            self.all_tokens[-1], bits, n, self.sampler, self.rng,
            last_tokens=self.all_tokens[-win:], eager=self.eager)
        eng.timings.n_sample += len(toks)
        self.masked_stats["chunks" if n > 1 else "steps"] += 1
        consumed, going = 0, True
        try:
            for t in map(int, toks):
                g.accept(t)
                consumed += 1
                if (g.stacks, g.partial) == s0 and t != self.eos_id:
                    self._gloop_run += 1
                    state_changed = False
                else:
                    self._gloop_run = 0
                    state_changed = True
                going = consume(t)
                if state_changed or not going:
                    break
        finally:
            if consumed < len(toks):  # ids sampled under a stale mask, or unconsumed
                eng.rollback(n_before + consumed)
                self.masked_stats["rolled_back"] += 1
        return going

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
                elif self.grammar_device:
                    if not self._masked_chunk(n_predict - st["n_out"], consume):
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
