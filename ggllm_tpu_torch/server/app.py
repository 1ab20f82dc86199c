"""HTTP inference server on the port (the port of ggllm_tpu/server/app.py;
the capability analogue of examples/server/server.cpp:784-895):

  POST /completion  — generate from a prompt; JSON body with the sampling
                      surface of llama_server_context; ``stream: true`` sends
                      SSE chunks (``data: {json}\\n\\n``), else one JSON object;
                      ``grammar`` (GBNF text, ops/grammar.py) constrains
                      sampling in both modes (a grammar that does not parse:
                      HTTP 400).
  POST /tokenize    — {"content": str} -> {"tokens": [int]}
  POST /detokenize  — {"tokens": [int]} -> {"content": str}
  GET  /            — liveness/info JSON.

OpenAI-compatible surface:

  POST /v1/completions       — text completion, incl. SSE streaming + [DONE]
  POST /v1/chat/completions  — chat completion (role-tagged fallback template)
  GET  /v1/models            — model listing
  GET  /metrics              — Prometheus counters (requests/tokens)

    python -m ggllm_tpu_torch.server -m model.ggcc --port 8080

With --parallel 1 (ServerState) the server wraps ONE engine and serializes
requests under a lock; every request generates through
engine/generator.py, so a device-coverable sampler decodes in pipelined
replays of the engine's CUDA graphs, keyed on the sampler's shape only (a
client's new temperature or penalty captures nothing). Prompt-prefix reuse
(common_part, server.cpp:281-292) keeps the KV cache warm across requests by
rolling n_past back to the longest shared prefix. Handler threads replay
graphs captured on another thread (the engine's work is on its own
streams, under the lock).

With --parallel N > 1 (BatchedServerState, over FalconEngine(batch_size=N))
one scheduler thread owns the engine and steps an engine/batching.py
ContinuousBatcher (--decode-chunk tokens a decode chunk, --prefill-chunk
prompt tokens a row an admission forward): the handler threads only submit
requests and wait on a queue of text pieces, so concurrent requests decode
together as B-row CUDA graphs, captured and replayed on the scheduler
thread. A request the rows cannot serve exactly (top-k above the 64-id
cap, more than 64 merged bias ids) gets HTTP 400; unlike the JAX batched
server, penalize_nl false is served (the port's rows restore the newline).
A request whose grammar or client fails ends alone (HTTP 500, or an SSE
event with "error"); a fault of the scheduler itself fails every waiting
request the same way, ends the scheduler, and later requests get 500.

Stop strings are matched over the generated text with partial-suffix
holdback in streaming mode. The engine runs on the CUDA card unless
--device cpu is given.

With --draft-model FNAME or --self-draft N (--parallel 1 only) the single
stream decodes speculatively (engine/speculative.py, --draft-k drafts a
round): a request whose sampler the fused rounds cover (greedy, or the
truncation cascade without penalties or bias) and that has no grammar runs
draft / verify rounds, replayed as one CUDA graph a dispatch, and its
response carries a "speculative" field (rounds, drafted, accepted,
emitted, acceptance); /metrics adds the spec_* counters. The prefix reuse
is clamped to what the draft's cache holds too. Every other request takes
the Generator path on the target alone.

--lora FNAME applies a 'ggla' LoRA adapter at load in both modes (io/lora.py,
its bases from the unquantized --lora-base FNAME model if given); a
--draft-model loads without it, a --self-draft shares the patched weights.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import queue as queue_mod
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ggllm_tpu_torch import tokenizer as tok_mod
from ggllm_tpu_torch.engine.batching import RING_LEN, ContinuousBatcher, Request
from ggllm_tpu_torch.engine.engine import FalconEngine
from ggllm_tpu_torch.engine.generator import Generator
from ggllm_tpu_torch.ops import sampling
from ggllm_tpu_torch.ops.grammar import (Grammar, GrammarError, GrammarSampler, build_token_trie,
                                         parse_gbnf)
from ggllm_tpu_torch.utils.stream import StopStream

# the SamplerParams fields a batched Request takes, under the same names
_ROW_SAMPLER = ("temp", "top_p", "top_k", "repeat_penalty", "frequency_penalty",
                "presence_penalty", "tfs_z", "typical_p", "mirostat", "mirostat_tau",
                "mirostat_eta", "penalize_nl", "logit_bias")


class RequestFailed(RuntimeError):
    """A batched request that ended with an error (its grammar, its client
    or the scheduler failed): the handler answers it with HTTP 500."""


class _GrammarTrie:
    """The vocabulary's token byte trie (ops/grammar.py build_token_trie),
    built on the first grammar request and shared by all of them."""

    def __init__(self, vocab, eos_id: int):
        self.vocab, self.eos_id = vocab, eos_id
        self._trie = None
        self._lock = threading.Lock()

    def sampler(self, grammar: Grammar | None) -> GrammarSampler | None:
        """A GrammarSampler for a parsed grammar, or None without one."""
        if grammar is None:
            return None
        with self._lock:
            if self._trie is None:
                self._trie = build_token_trie(self.vocab.id_to_token, self.eos_id)
        return GrammarSampler(grammar, self.vocab.id_to_token, self.eos_id, trie=self._trie)


def _common_part(a: list[int], b: list[int]) -> int:
    n = 0
    while n < len(a) and n < len(b) and a[n] == b[n]:
        n += 1
    return n


def _generation_settings(sampler: sampling.SamplerParams, n_predict: int,
                         n_keep: int, stops: list[bytes],
                         eos_id: int) -> dict:
    """format_generation_settings analogue (server.cpp:620-645)."""
    return {
        "n_predict": n_predict, "n_keep": n_keep,
        "temp": sampler.temp, "top_k": sampler.top_k, "top_p": sampler.top_p,
        "tfs_z": sampler.tfs_z, "typical_p": sampler.typical_p,
        "repeat_last_n": sampler.repeat_last_n,
        "repeat_penalty": sampler.repeat_penalty,
        "presence_penalty": sampler.presence_penalty,
        "frequency_penalty": sampler.frequency_penalty,
        "mirostat": sampler.mirostat, "mirostat_tau": sampler.mirostat_tau,
        "mirostat_eta": sampler.mirostat_eta,
        "penalize_nl": sampler.penalize_nl, "seed": sampler.seed,
        "stop": [s.decode("utf-8", "replace") for s in stops],
        # server.cpp: specifically whether the EOS logit is banned
        "ignore_eos": sampler.logit_bias.get(eos_id) == float("-inf"),
    }


def _stop_fields(stop_reason: str, stop_match: bytes | None) -> dict:
    """The reference's stopped_* booleans (server.cpp:650-662)."""
    return {
        "stopped_eos": stop_reason == "eos",
        "stopped_word": stop_reason == "stop",
        "stopped_limit": stop_reason == "limit",
        "stopping_word": (stop_match or b"").decode("utf-8", "replace"),
    }


class _State:
    """What both server states share: the engine, its vocabulary and
    tokenizer, the shared grammar trie, and a request's sampler."""

    def __init__(self, engine: FalconEngine, vocab, arch: str = "falcon",
                 alias: str = "unknown"):
        self.engine = engine
        self.vocab = vocab
        self.alias = alias
        self.tk = tok_mod.Tokenizer(vocab=vocab, arch=arch)
        self.grammars = _GrammarTrie(vocab, self.tk.eos_id)

    def sampler_from(self, body: dict) -> sampling.SamplerParams:
        logit_bias = {int(t): (float("-inf") if b is False else float(b))
                      for t, b in body.get("logit_bias", [])}
        if body.get("ignore_eos"):
            # server.cpp parse_options_completion: logit_bias[eos] = -inf
            logit_bias[self.tk.eos_id] = float("-inf")
        return sampling.SamplerParams(
            top_k=int(body.get("top_k", 40)),
            top_p=float(body.get("top_p", 0.95)),
            tfs_z=float(body.get("tfs_z", 1.0)),
            typical_p=float(body.get("typical_p", 1.0)),
            temp=float(body.get("temperature", 0.8)),
            repeat_penalty=float(body.get("repeat_penalty", 1.1)),
            repeat_last_n=int(body.get("repeat_last_n", 64)),
            frequency_penalty=float(body.get("frequency_penalty", 0.0)),
            presence_penalty=float(body.get("presence_penalty", 0.0)),
            mirostat=int(body.get("mirostat", 0)),
            mirostat_tau=float(body.get("mirostat_tau", 5.0)),
            mirostat_eta=float(body.get("mirostat_eta", 0.1)),
            penalize_nl=bool(body.get("penalize_nl", True)),
            # [[token_id, bias], ...]; false bans the token (server.cpp parity)
            logit_bias=logit_bias,
            seed=int(body.get("seed", -1)),
        )

    def unsupported(self, body: dict) -> str | None:
        """Why this request can't be served (None = it can)."""
        return None

    def _response(self, body: dict, emit, ss: StopStream, parts: list[bytes], reason: str,
                  settings: dict, truncated: bool, n_predicted: int, n_evaluated: int,
                  timings: dict) -> dict:
        """Flush what the stop stream holds back (through emit when
        streaming), then the final response (server.cpp's fields)."""
        if not ss.stopped:
            tail = ss.flush()
            if tail:
                parts.append(tail)
                if emit is not None:
                    emit({"content": tail.decode("utf-8", "replace"), "stop": False})
        return {
            "content": "" if emit else b"".join(parts).decode("utf-8", "replace"),
            "stop": True,
            "model": self.alias,
            "prompt": body.get("prompt", ""),
            "truncated": truncated,
            "stopped_reason": reason,
            **_stop_fields(reason, ss.stop_match),
            "generation_settings": settings,
            "tokens_predicted": n_predicted,
            "tokens_evaluated": n_evaluated,
            "timings": timings,
        }


class ServerState(_State):
    """One engine + its conversation cache, guarded by a lock; with `spec`
    (an engine/speculative.py SpeculativeDecoder over this engine and a
    draft) the requests its fused rounds cover decode speculatively."""

    def __init__(self, engine: FalconEngine, vocab, arch: str = "falcon",
                 alias: str = "unknown", spec=None):
        super().__init__(engine, vocab, arch, alias)
        # reentrant: a caller that holds it to use the engine may call completion
        self.lock = threading.RLock()
        self.cache_tokens: list[int] = []  # what the engine's KV cache holds
        self.spec = spec
        self.draft_tokens: list[int] = []  # what the draft engine's KV cache holds

    def completion(self, body: dict, emit=None, grammar: Grammar | None = None) -> dict:
        """Run one completion under the state's lock. emit(chunk_dict)
        streams; returns final dict.

        `grammar` (the body's "grammar", parsed) constrains the Generator.
        If emit raises (a client gone mid-stream), the Generator rolls n_past
        back to the tokens it consumed and the cache record follows the
        cache."""
        with self.lock:
            return self._completion(body, emit, grammar)

    def _completion(self, body: dict, emit, grammar: Grammar | None) -> dict:
        eng = self.engine
        cfg = eng.cfg
        prompt = body.get("prompt", "")
        n_predict = int(body.get("n_predict", 128))
        stops = [s.encode() for s in body.get("stop", []) if s]
        sampler = self.sampler_from(body)

        prompt_ids = self.tk.tokenize(prompt, bos=True)
        n_keep = int(body.get("n_keep", 0)) or cfg.n_ctx // 4
        truncated = False
        if len(prompt_ids) >= cfg.n_ctx:
            # keep n_keep head + most recent tail (server.cpp truncation);
            # clamp so head + tail + n_predict always fits in n_ctx
            n_keep = max(0, min(n_keep, cfg.n_ctx - n_predict - 1))
            tail = max(1, cfg.n_ctx - n_keep - n_predict)
            prompt_ids = prompt_ids[:n_keep] + prompt_ids[-tail:]
            truncated = True

        use_spec = (self.spec is not None and grammar is None
                    and self.spec._fused_ok(sampler) and n_predict > 0)
        # prefix reuse against the previous request's tokens
        n_common = _common_part(self.cache_tokens, prompt_ids)
        if use_spec:  # the draft's cache must hold the reused prefix too
            n_common = min(n_common, _common_part(self.draft_tokens, prompt_ids),
                           self.spec.draft.n_past)
        if n_common == len(prompt_ids):
            n_common -= 1  # always re-eval at least the final token
        if 0 < n_common <= eng.n_past:
            eng.rollback(n_common)
            to_eval = prompt_ids[n_common:]
        else:
            n_common = 0
            to_eval = prompt_ids
            eng.reset()
        self.cache_tokens = []  # until the cache holds what the record says
        if use_spec:
            return self._spec_completion(body, emit, prompt_ids, to_eval, n_common, n_predict,
                                         stops, sampler, truncated, n_keep)
        gen = Generator(eng, sampler, self.tk.eos_id, n_keep,
                        grammar=self.grammars.sampler(grammar))
        gen.all_tokens = list(prompt_ids[:n_common])

        t0 = time.perf_counter()
        logits = gen.prefill(to_eval)
        t_prompt = time.perf_counter() - t0

        ss = StopStream(stops)
        tokens_predicted = 0
        parts: list[bytes] = []

        def on_token(tok: int) -> bool:
            nonlocal tokens_predicted
            tokens_predicted += 1
            out = ss.push(self.vocab.id_to_token[tok])
            if out:
                parts.append(out)
                if emit is not None:
                    emit({"content": out.decode("utf-8", "replace"), "stop": False})
            return not ss.stopped

        t0 = time.perf_counter()
        try:
            reason = gen.generate(logits, n_predict, on_token)
        finally:  # the tokens the cache holds (all but the last forwarded)
            self.cache_tokens = list(gen.all_tokens) if not gen.swapped else []
        t_gen = time.perf_counter() - t0
        return self._response(
            body, emit, ss, parts, {"callback": "stop", "eos": "eos"}.get(reason, "limit"),
            _generation_settings(sampler, n_predict, n_keep, stops, self.tk.eos_id),
            truncated, tokens_predicted, len(to_eval), {
                "prompt_ms": round(t_prompt * 1e3, 2),
                "predicted_ms": round(t_gen * 1e3, 2),
                "predicted_per_second": round(tokens_predicted / t_gen, 2) if t_gen > 0 else None,
            })

    def _spec_completion(self, body: dict, emit, prompt_ids, to_eval, n_common, n_predict,
                         stops, sampler, truncated, n_keep) -> dict:
        """One completion through the speculative decoder (the JAX server's
        _spec_completion:255): streaming, stop strings and the response
        schema as on the Generator path, plus the "speculative" field.
        Greedy content equals the Generator path's (the target's greedy
        ids). The target already stands at n_common; the draft follows it
        there. If emit raises (a client gone), the decoder rolls both
        engines back to the ids committed so far and the cache records
        follow them."""
        spec, eng = self.spec, self.engine
        if n_common > 0:
            spec.draft.rollback(n_common)
        else:
            spec.draft.reset()
        self.draft_tokens = []
        t0 = time.perf_counter()
        if len(to_eval) > 1:  # prefill both models up to the pending token
            eng.eval(to_eval[:-1])
            spec.draft.eval(to_eval[:-1])
        t_prompt = time.perf_counter() - t0

        ss = StopStream(stops)
        parts: list[bytes] = []
        committed: list[int] = []  # every id the decoder committed, eos included
        outcome = {"reason": "limit", "n": 0}
        eos = self.tk.eos_id

        def on_token(tok: int) -> bool:
            committed.append(tok)
            if tok == eos:
                outcome["reason"] = "eos"
                return False
            outcome["n"] += 1
            out = ss.push(self.vocab.id_to_token[tok])
            if out:
                parts.append(out)
                if emit is not None:
                    emit({"content": out.decode("utf-8", "replace"), "stop": False})
            if ss.stopped:
                outcome["reason"] = "stop"
                return False
            return True

        t0 = time.perf_counter()
        try:
            spec.generate([to_eval[-1]], n_predict, sampler, on_token=on_token)
        finally:  # what both caches hold: all but the last committed id
            self.cache_tokens = self.draft_tokens = list(prompt_ids) + committed
        t_gen = time.perf_counter() - t0
        st = spec.stats
        final = self._response(
            body, emit, ss, parts, outcome["reason"],
            _generation_settings(sampler, n_predict, n_keep, stops, eos),
            truncated, outcome["n"], len(to_eval), {
                "prompt_ms": round(t_prompt * 1e3, 2),
                "predicted_ms": round(t_gen * 1e3, 2),
                "predicted_per_second": round(outcome["n"] / t_gen, 2) if t_gen > 0 else None,
            })
        final["speculative"] = {"rounds": st.n_rounds, "drafted": st.n_drafted,
                                "accepted": st.n_accepted, "emitted": st.n_emitted,
                                "acceptance": round(st.acceptance, 4)}
        return final


class BatchedServerState(_State):
    """Continuous-batching server state (--parallel N > 1; the JAX
    BatchedServerState, ggllm_tpu/server/app.py:337-540): one scheduler
    thread owns the engine (FalconEngine(batch_size=N)) and steps a
    ContinuousBatcher; concurrent /completion requests decode together in
    B-row chunks. The handler threads submit Requests and wait on their
    queues; they never touch the engine.

    Per request: the rows' device cascade (greedy, temperature, top-k
    within the 64-id cap, top-p, tail-free, typical, repetition / frequency
    / presence penalties over a 64-token window, up to 64 bias ids with
    ignore_eos, mirostat v1 / v2, penalize_nl) and GBNF grammars (while a
    grammar row is live the batch decodes one masked step a chunk)."""

    def __init__(self, engine: FalconEngine, vocab, arch: str = "falcon", chunk: int = 8,
                 alias: str = "unknown", prefill_chunk: int = 256):
        super().__init__(engine, vocab, arch, alias)
        self.batcher = ContinuousBatcher(engine, chunk=chunk, prefill_chunk=prefill_chunk)
        self.cv = threading.Condition()
        self._stop = False
        self.fault: BaseException | None = None  # what ended the scheduler
        self.thread = threading.Thread(target=self._loop, name="batch-scheduler", daemon=True)
        self.thread.start()

    def shutdown(self):
        """End the scheduler thread (after its current step)."""
        with self.cv:
            self._stop = True
            self.cv.notify_all()

    def _loop(self):
        while True:
            with self.cv:
                while not self._stop and not (self.batcher.queue or self.batcher.active):
                    self.cv.wait()
                if self._stop:
                    break
            try:
                self.batcher.step()
            except Exception as e:  # the scheduler's own fault: fail every waiter, then end
                traceback.print_exc(file=sys.stderr)
                with self.cv:
                    self.fault, self._stop = e, True
                break
        self._fail_waiting(self.fault or RuntimeError("the server shut down"))

    def _fail_waiting(self, error: BaseException) -> None:
        """End every queued and live request with `error` (their handlers
        answer 500 instead of waiting forever)."""
        with self.cv:
            waiting = list(self.batcher.queue) + self.batcher.active
            self.batcher.queue.clear()
        for r in waiting:
            r.error, r.done = r.error or error, True
            if r.on_done is not None:
                r.on_done()

    def unsupported(self, body: dict) -> str | None:
        """Why this request can't run in batched mode (None = it can): the
        JAX server's rules (:396), except that penalize_nl false is served."""
        # count MERGED bias entries: ignore_eos adds a -inf bias on eos, so
        # 64 explicit entries + ignore_eos would overflow the rows' 64 slots
        bias_ids = {int(t) for t, _ in body.get("logit_bias", [])}
        if body.get("ignore_eos"):
            bias_ids.add(self.tk.eos_id)
        if len(bias_ids) > 64:
            return ("logit_bias is capped at 64 entries in batched mode "
                    "(ignore_eos counts as one)")
        if float(body.get("temperature", 0.8)) > 0 and \
                not (0 < int(body.get("top_k", 40)) <= 64):
            return "top_k must be in 1..64 in batched mode"
        return None

    def completion(self, body: dict, emit=None, grammar: Grammar | None = None) -> dict:
        """Submit one request to the scheduler and wait for it, streaming
        text pieces through emit(chunk_dict) when given; `grammar` (the
        body's "grammar", parsed) constrains its row. Raises
        RequestFailed if the request ended with an error, or the scheduler
        has stopped; if emit raises (a client gone), the request is told to
        stop at its next id and the exception goes on."""
        cfg = self.engine.cfg
        n_predict = int(body.get("n_predict", 128))
        stops = [s.encode() for s in body.get("stop", []) if s]
        prompt_ids = self.tk.tokenize(body.get("prompt", ""), bos=True)
        truncated = False
        if len(prompt_ids) + n_predict >= cfg.n_ctx:
            n_keep = max(0, min(int(body.get("n_keep", 0)) or cfg.n_ctx // 4,
                                cfg.n_ctx - n_predict - 1))
            tail = max(1, cfg.n_ctx - n_keep - n_predict)
            prompt_ids = prompt_ids[:n_keep] + prompt_ids[-tail:]
            truncated = True

        ss = StopStream(stops)
        q: queue_mod.Queue = queue_mod.Queue()
        eos = self.tk.eos_id
        outcome = {"reason": "limit"}
        clock = {"submit": time.perf_counter()}
        cancelled = [False]

        def stream(tok: int) -> bool:  # on the scheduler thread
            clock.setdefault("first", time.perf_counter())
            clock["last"] = time.perf_counter()
            if cancelled[0]:
                return False
            if tok == eos:
                outcome["reason"] = "eos"
                return False
            out = ss.push(self.vocab.id_to_token[tok])
            if out:
                q.put(out)
            if ss.stopped:
                outcome["reason"] = "stop"
                return False
            return True

        # the rows' penalty window is the batcher's fixed RING_LEN
        sampler = dataclasses.replace(self.sampler_from(body), repeat_last_n=RING_LEN)
        req = Request(prompt_ids=prompt_ids, n_predict=n_predict, stream=stream,
                      grammar_sampler=self.grammars.sampler(grammar),
                      **{k: getattr(sampler, k) for k in _ROW_SAMPLER})
        req.on_done = lambda: q.put(None)
        with self.cv:
            if self._stop:
                raise RequestFailed(f"the batch scheduler has stopped: {self.fault!r}")
            self.batcher.submit(req)
            self.cv.notify()

        parts: list[bytes] = []
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                parts.append(item)
                if emit is not None:
                    emit({"content": item.decode("utf-8", "replace"), "stop": False})
        except BaseException:
            cancelled[0] = True  # the row stops at its next id and frees its slot
            raise
        if req.error is not None:
            raise RequestFailed(f"the request failed: {req.error!r}") from req.error
        done = time.perf_counter()
        n_out = len(req.out)
        first = clock.get("first", done)
        # the first id comes from the prompt's logits: prompt_ms is the time
        # to it (queueing and admission included), predicted_* the ids after
        t_pred = clock.get("last", done) - first
        return self._response(
            body, emit, ss, parts, outcome["reason"],
            _generation_settings(sampler, n_predict, int(body.get("n_keep", 0)), stops, eos),
            truncated, n_out, len(prompt_ids), {
                "prompt_ms": round((first - clock["submit"]) * 1e3, 2),
                "predicted_ms": round(t_pred * 1e3, 2),
                "predicted_per_second": (round((n_out - 1) / t_pred, 2)
                                         if n_out > 1 and t_pred > 0 else None),
                "total_ms": round((done - clock["submit"]) * 1e3, 2),
            })


def _chat_to_prompt(messages: list[dict]) -> tuple[str, list[str]]:
    """Minimal chat templating for /v1/chat/completions: role-tagged turns
    with the assistant turn left open. Returns (prompt, extra stop strings).
    Falcon instruction finetunes mostly train on User:/Assistant: style
    turns (utils/finetune.py templates); this is the generic fallback."""
    parts = []
    for m in messages:
        role = m.get("role", "user")
        content = m.get("content", "")
        if role == "system":
            parts.append(f"{content}\n")
        elif role == "assistant":
            parts.append(f"Assistant: {content}\n")
        else:
            parts.append(f"User: {content}\n")
    parts.append("Assistant:")
    return "".join(parts), ["\nUser:"]


def _openai_to_native(body: dict, chat: bool) -> dict:
    """Translate an OpenAI-style request body to the native /completion
    schema (the subset both schemas express)."""
    if chat:
        prompt, extra_stops = _chat_to_prompt(body.get("messages", []))
    else:
        prompt = body.get("prompt", "")
        if isinstance(prompt, list):
            prompt = "".join(prompt)
        extra_stops = []
    stop = body.get("stop") or []
    if isinstance(stop, str):
        stop = [stop]
    native = {
        "prompt": prompt,
        "n_predict": int(body.get("max_tokens", 128)),
        "temperature": float(body.get("temperature", 0.8)),
        "top_p": float(body.get("top_p", 0.95)),
        "stop": list(stop) + extra_stops,
        "frequency_penalty": float(body.get("frequency_penalty", 0.0)),
        "presence_penalty": float(body.get("presence_penalty", 0.0)),
        "seed": int(body.get("seed", -1)),
        # OpenAI logit_bias is {"token_id": bias}; native is [[id, bias]]
        "logit_bias": [[int(t), float(b)]
                       for t, b in (body.get("logit_bias") or {}).items()],
    }
    if "top_k" in body:  # common extension
        native["top_k"] = int(body["top_k"])
    return native


def _openai_response(final: dict, chat: bool, rid: int, model: str) -> dict:
    finish = "length" if final.get("stopped_limit") else "stop"
    text = final.get("content", "")
    if chat:
        choice = {"index": 0, "finish_reason": finish,
                  "message": {"role": "assistant", "content": text}}
        obj = "chat.completion"
    else:
        choice = {"index": 0, "finish_reason": finish, "logprobs": None,
                  "text": text}
        obj = "text_completion"
    return {
        "id": f"{'chatcmpl' if chat else 'cmpl'}-{rid}",
        "object": obj,
        "created": int(time.time()),
        "model": model,
        "choices": [choice],
        "usage": {
            "prompt_tokens": final.get("tokens_evaluated", 0),
            "completion_tokens": final.get("tokens_predicted", 0),
            "total_tokens": (final.get("tokens_evaluated", 0)
                             + final.get("tokens_predicted", 0)),
        },
    }


METRICS = (("requests_total", "Completed completion requests"),
           ("prompt_tokens_total", "Prompt tokens evaluated"),
           ("generated_tokens_total", "Tokens generated"))
SPEC_METRICS = (("spec_rounds_total", "Speculative draft/verify rounds"),
                ("spec_drafted_total", "Draft tokens proposed"),
                ("spec_accepted_total", "Draft tokens accepted"))


def make_handler(state: ServerState):
    if not hasattr(state, "rid_counter"):
        state.rid_counter = itertools.count(1)
        state.metrics_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # structured one-liners to stderr
            print(json.dumps({"ts": time.time(), "msg": fmt % args}), file=sys.stderr)

        def _json(self, code: int, obj: dict):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n) if n else b"{}"
            return json.loads(raw or b"{}")

        def do_GET(self):
            if self.path == "/v1/models":
                self._json(200, {"object": "list", "data": [{
                    "id": state.alias, "object": "model",
                    "created": 0, "owned_by": "ggllm_tpu"}]})
                return
            if self.path == "/metrics":
                # Prometheus text exposition (the reference's observability
                # is stderr tables)
                m = getattr(state, "metrics", None) or {}
                lines = []
                spec = getattr(state, "spec", None) is not None
                for name, help_ in METRICS + (SPEC_METRICS if spec else ()):
                    lines.append(f"# HELP ggllm_{name} {help_}")
                    lines.append(f"# TYPE ggllm_{name} counter")
                    lines.append(f"ggllm_{name} {m.get(name, 0)}")
                data = ("\n".join(lines) + "\n").encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            if self.path == "/":
                hp = state.engine.hp
                mtype = (f"falcon-{hp.n_falcon_type}b"
                         if getattr(hp, "arch", "falcon") == "falcon" else "llama")
                self._json(200, {
                    "status": "ok",
                    "model": {"n_vocab": hp.n_vocab, "n_embd": hp.n_embd,
                              "n_layer": hp.n_layer, "n_head": hp.n_head,
                              "n_head_kv": hp.n_head_kv, "type": mtype},
                    "n_ctx": state.engine.cfg.n_ctx,
                })
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            try:
                body = self._body()
            except (ValueError, json.JSONDecodeError):
                self._json(400, {"error": "invalid json"})
                return
            if self.path == "/tokenize":
                ids = state.tk.tokenize(body.get("content", ""), bos=False)
                self._json(200, {"tokens": [int(t) for t in ids]})
                return
            if self.path == "/detokenize":
                ids = body.get("tokens", [])
                text = b"".join(state.vocab.id_to_token[int(t)] for t in ids)
                self._json(200, {"content": text.decode("utf-8", "replace")})
                return
            if self.path == "/completion":
                self._run_completion(body, openai=None)
                return
            if self.path == "/v1/completions":
                self._run_completion(_openai_to_native(body, chat=False),
                                     openai="completion", stream=bool(body.get("stream")))
                return
            if self.path == "/v1/chat/completions":
                self._run_completion(_openai_to_native(body, chat=True),
                                     openai="chat", stream=bool(body.get("stream")))
                return
            self._json(404, {"error": "not found"})

        def _run_completion(self, body: dict, openai: str | None,
                            stream: bool | None = None):
            why = state.unsupported(body)
            if why is not None:
                self._json(400, {"error": why})
                return
            grammar = None
            if body.get("grammar"):
                try:
                    grammar = parse_gbnf(body["grammar"])
                except GrammarError as e:
                    self._json(400, {"error": f"bad grammar: {e}"})
                    return
            if stream is None:
                stream = bool(body.get("stream"))
            metrics = getattr(state, "metrics", None)
            # handler threads run concurrently in batched mode: rids come
            # from an atomic counter, and the counters' updates take a lock
            rid = next(state.rid_counter)

            def run(emit=None):
                final = state.completion(body, emit=emit, grammar=grammar)
                if metrics is not None:
                    with state.metrics_lock:
                        metrics["requests_total"] += 1
                        metrics["prompt_tokens_total"] += final.get("tokens_evaluated", 0)
                        metrics["generated_tokens_total"] += final.get("tokens_predicted", 0)
                        sp = final.get("speculative") or {}
                        for name, field in (("spec_rounds_total", "rounds"),
                                            ("spec_drafted_total", "drafted"),
                                            ("spec_accepted_total", "accepted")):
                            metrics[name] += sp.get(field, 0)
                return final

            chat = openai == "chat"
            if stream:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.end_headers()

                def send(obj):
                    self.wfile.write(b"data: " + json.dumps(obj).encode() + b"\n\n")
                    self.wfile.flush()

                if openai is None:
                    try:
                        send(run(emit=send))
                    except (RequestFailed, GrammarError) as e:
                        send({"content": "", "stop": True, "stopped_reason": "error",
                              "error": str(e)})
                    return
                # OpenAI streaming: per-token delta chunks + [DONE]
                base = {"id": f"{'chatcmpl' if chat else 'cmpl'}-{rid}",
                        "object": "chat.completion.chunk" if chat else "text_completion",
                        "created": int(time.time()), "model": state.alias}

                def emit(chunk):
                    text = chunk.get("content", "")
                    if not text and chunk.get("stop"):
                        return
                    delta = ({"delta": {"content": text}} if chat
                             else {"text": text, "logprobs": None})
                    send({**base, "choices": [{"index": 0, "finish_reason": None, **delta}]})

                try:
                    final = run(emit=emit)
                except (RequestFailed, GrammarError) as e:
                    send({"error": str(e)})
                    self.wfile.write(b"data: [DONE]\n\n")
                    self.wfile.flush()
                    return
                finish = "length" if final.get("stopped_limit") else "stop"
                tail = {"delta": {}} if chat else {"text": "", "logprobs": None}
                send({**base, "choices": [{"index": 0, "finish_reason": finish, **tail}]})
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
                return
            try:
                final = run()
            except (RequestFailed, GrammarError) as e:
                self._json(500, {"error": str(e)})
                return
            if openai is None:
                self._json(200, final)
            else:
                self._json(200, _openai_response(final, chat, rid, state.alias))

    return Handler


class _Server(ThreadingHTTPServer):
    # the stdlib's listen backlog is 5: a burst of concurrent clients (what
    # --parallel is for) would overflow it and have connections refused
    request_queue_size = 256
    daemon_threads = True

    def server_close(self):
        super().server_close()
        stop = getattr(getattr(self, "state", None), "shutdown", None)
        if stop is not None:  # the batched state's scheduler thread
            stop()


def serve(engine: FalconEngine, vocab, host: str = "127.0.0.1", port: int = 8080,
          arch: str = "falcon", parallel: int = 1, alias: str = "unknown", chunk: int = 8,
          prefill_chunk: int = 256, draft_engine: FalconEngine | None = None,
          draft_k: int = 6):
    """The server over `engine` (not yet serving: call serve_forever on the
    result; server_close also ends a batched state's scheduler).
    parallel > 1 serves concurrent requests through the continuous batcher
    (chunk decode steps a chunk, prefill_chunk prompt tokens a row an
    admission forward) and needs FalconEngine(batch_size=parallel); one
    stream needs a batch-1 engine. draft_engine (one stream only) turns on
    speculative decoding with draft_k drafts a round."""
    if engine.batch != max(parallel, 1):
        raise ValueError(f"--parallel {parallel} needs an engine of batch_size"
                         f" {max(parallel, 1)}; this engine has {engine.batch} rows")
    if parallel > 1:
        if draft_engine is not None:
            raise ValueError("speculative serving requires --parallel 1")
        state = BatchedServerState(engine, vocab, arch, chunk=chunk, alias=alias,
                                   prefill_chunk=prefill_chunk)
    else:
        spec = None
        if draft_engine is not None:
            from ggllm_tpu_torch.engine.speculative import SpeculativeDecoder

            spec = SpeculativeDecoder(engine, draft_engine, k=draft_k)
        state = ServerState(engine, vocab, arch, alias=alias, spec=spec)
    state.metrics = {name: 0 for name, _ in METRICS + SPEC_METRICS}
    httpd = _Server((host, port), make_handler(state))
    httpd.state = state
    return httpd


def build_parser():
    import argparse

    ap = argparse.ArgumentParser(description="Falcon / LLaMA inference server (CUDA card)")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("-c", "--ctx-size", type=int, default=2048)
    ap.add_argument("-b", "--batch-size", type=int, default=512)
    ap.add_argument("-np", "--parallel", type=int, default=1,
                    help="serve N concurrent requests via continuous batching")
    ap.add_argument("--decode-chunk", type=int, default=8,
                    help="batched decode tokens per dispatch (CUDA graph replay)")
    ap.add_argument("--prefill-chunk", type=int, default=256,
                    help="admission prefill tokens per dispatch: bounds the decode stall"
                         " in-flight streams see while a new request's prompt evaluates")
    ap.add_argument("--kv-dtype", default="bfloat16", choices=("bfloat16", "float32", "int8"))
    ap.add_argument("--compute-dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--weight-mode", default="fused", choices=["fused", "dequant"])
    ap.add_argument("-a", "--alias", default=None,
                    help="model name returned in responses (server.cpp "
                         "model_alias; defaults to the model path)")
    ap.add_argument("--lora", default=None, help="apply a 'ggla' LoRA adapter")
    ap.add_argument("--lora-base", default=None,
                    help="unquantized base model for --lora")
    ap.add_argument("--draft-model", default=None, metavar="FNAME",
                    help="speculative decoding: a smaller same-vocab model drafts tokens the"
                         " main model verifies (fused device rounds; --parallel 1 only)")
    ap.add_argument("--self-draft", type=int, default=0, metavar="N",
                    help="speculative decoding with the model's own first N layers as the draft"
                         " (--parallel 1 only)")
    ap.add_argument("--draft-k", type=int, default=6, help="draft tokens per speculative round")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def load_engine(args):
    """(ModelFile, params, EngineConfig, engine) as main serves them: the
    model loaded on args.device with the adapter of --lora / --lora-base
    applied, the engine at batch_size --parallel."""
    from ggllm_tpu_torch.core.config import EngineConfig
    from ggllm_tpu_torch.io.loader import load_model

    cfg = EngineConfig(n_ctx=args.ctx_size, n_batch=args.batch_size, kv_dtype=args.kv_dtype,
                       compute_dtype=args.compute_dtype, weight_mode=args.weight_mode)
    mf, params = load_model(args.model, cfg, device=args.device, lora=args.lora,
                            lora_base=args.lora_base)
    engine = FalconEngine(mf.hparams, params, cfg, device=args.device,
                          batch_size=args.parallel)
    return mf, params, cfg, engine


def main(argv=None):
    from ggllm_tpu_torch.io.loader import load_model

    ap = build_parser()
    args = ap.parse_args(argv)
    if args.parallel < 1:
        ap.error(f"--parallel {args.parallel}: at least 1")
    spec = bool(args.draft_model or args.self_draft)
    if spec and args.parallel > 1:
        print("error: speculative serving requires --parallel 1", file=sys.stderr)
        return 1

    mf, params, cfg, engine = load_engine(args)
    draft = None
    if args.self_draft:
        from ggllm_tpu_torch.engine.speculative import truncate_params

        if not 0 < args.self_draft < mf.hparams.n_layer:
            print(f"error: --self-draft must be in 1..{mf.hparams.n_layer - 1}", file=sys.stderr)
            return 1
        draft = FalconEngine(dataclasses.replace(mf.hparams, n_layer=args.self_draft),
                             truncate_params(params, args.self_draft), cfg, device=args.device)
    elif args.draft_model:
        dmf, dparams = load_model(args.draft_model, cfg, device=args.device)
        draft = FalconEngine(dmf.hparams, dparams, cfg, device=args.device)
    httpd = serve(engine, mf.vocab, args.host, args.port, arch=mf.arch,
                  parallel=args.parallel, alias=args.alias or args.model,
                  chunk=args.decode_chunk, prefill_chunk=args.prefill_chunk,
                  draft_engine=draft, draft_k=args.draft_k)
    print(f"listening on http://{args.host}:{httpd.server_address[1]}", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
    return 0
