"""HTTP inference server on the port, single-stream mode (the port of the
single-stream part of ggllm_tpu/server/app.py; the capability analogue of
examples/server/server.cpp:784-895):

  POST /completion  — generate from a prompt; JSON body with the sampling
                      surface of llama_server_context; ``stream: true`` sends
                      SSE chunks (``data: {json}\\n\\n``), else one JSON object.
  POST /tokenize    — {"content": str} -> {"tokens": [int]}
  POST /detokenize  — {"tokens": [int]} -> {"content": str}
  GET  /            — liveness/info JSON.

OpenAI-compatible surface:

  POST /v1/completions       — text completion, incl. SSE streaming + [DONE]
  POST /v1/chat/completions  — chat completion (role-tagged fallback template)
  GET  /v1/models            — model listing
  GET  /metrics              — Prometheus counters (requests/tokens)

    python -m ggllm_tpu_torch.server -m model.ggcc --port 8080

The server wraps ONE engine and serializes requests under a lock; every
request generates through engine/generator.py, so a device-coverable
sampler decodes in pipelined replays of the engine's CUDA graphs, keyed on
the sampler's shape only (a client's new temperature or penalty captures
nothing). Prompt-prefix reuse (common_part, server.cpp:281-292) keeps the
KV cache warm across requests by rolling n_past back to the longest shared
prefix. Stop strings are matched over the generated text with
partial-suffix holdback in streaming mode. The engine runs on the CUDA card
unless --device cpu is given; handler threads replay graphs captured on
another thread (the engine's work is on its own streams, under the lock).

Not ported yet, and refused with the ROADMAP item rather than served
otherwise: --parallel > 1 (continuous batching), --draft-model /
--self-draft (speculative decoding), --lora / --lora-base, and a request's
"grammar" (HTTP 400). The JAX server's --decode-chunk, --prefill-chunk and
--draft-k, which feed only the batcher and the speculative decoder, are not
flags here: argparse refuses them.
"""

from __future__ import annotations

import itertools
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ggllm_tpu_torch import tokenizer as tok_mod
from ggllm_tpu_torch.engine.engine import FalconEngine
from ggllm_tpu_torch.engine.generator import GRAMMAR_NOT_PORTED, Generator
from ggllm_tpu_torch.ops import sampling
from ggllm_tpu_torch.utils.stream import StopStream

PARALLEL_REFUSAL = ("--parallel > 1 (continuous batching in the server) is not ported yet"
                    " (ROADMAP.md, Queue 1: continuous batching in the server, --parallel over"
                    " engine/batching.py ContinuousBatcher)")
DRAFT_REFUSAL = ("--draft-model / --self-draft (speculative decoding) is not ported yet"
                 " (ROADMAP.md, Queue 1: speculative decoding)")
LORA_REFUSAL = "--lora / --lora-base are not ported yet (ROADMAP.md, Queue 1: LoRA)"


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


class ServerState:
    """One engine + its conversation cache, guarded by a lock."""

    def __init__(self, engine: FalconEngine, vocab, arch: str = "falcon",
                 alias: str = "unknown"):
        self.engine = engine
        self.vocab = vocab
        self.alias = alias
        self.tk = tok_mod.Tokenizer(vocab=vocab, arch=arch)
        self.lock = threading.Lock()
        self.cache_tokens: list[int] = []  # what the engine's KV cache holds

    # ------------------------------------------------------------ generate

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

    def completion(self, body: dict, emit=None) -> dict:
        """Run one completion. emit(chunk_dict) streams; returns final dict.

        Raises GrammarNotPorted for a grammar request (the Generator
        refuses it before the cache is touched). If emit raises (a
        client gone mid-stream), the Generator rolls n_past back to the
        tokens it consumed and the cache record follows the cache."""
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

        gen = Generator(eng, sampler, self.tk.eos_id, n_keep, grammar=body.get("grammar") or None)
        # prefix reuse against the previous request's tokens
        n_common = _common_part(self.cache_tokens, prompt_ids)
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
        if not ss.stopped:
            tail = ss.flush()
            if tail:
                parts.append(tail)
                if emit is not None:
                    emit({"content": tail.decode("utf-8", "replace"), "stop": False})
        t_gen = time.perf_counter() - t0

        stop_reason = {"callback": "stop", "eos": "eos"}.get(reason, "limit")
        out = b"".join(parts)
        return {
            "content": "" if emit else out.decode("utf-8", "replace"),
            "stop": True,
            "model": self.alias,
            "prompt": prompt,
            "truncated": truncated,
            "stopped_reason": stop_reason,
            **_stop_fields(stop_reason, ss.stop_match),
            "generation_settings": _generation_settings(
                sampler, n_predict, n_keep, stops, self.tk.eos_id),
            "tokens_predicted": tokens_predicted,
            "tokens_evaluated": len(to_eval),
            "timings": {
                "prompt_ms": round(t_prompt * 1e3, 2),
                "predicted_ms": round(t_gen * 1e3, 2),
                "predicted_per_second": round(tokens_predicted / t_gen, 2) if t_gen > 0 else None,
            },
        }


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
                for name, help_ in METRICS:
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
            if body.get("grammar"):
                self._json(400, {"error": GRAMMAR_NOT_PORTED})
                return
            if stream is None:
                stream = bool(body.get("stream"))
            metrics = getattr(state, "metrics", None)
            rid = next(state.rid_counter)

            def run(emit=None):
                with state.lock:
                    final = state.completion(body, emit=emit)
                if metrics is not None:
                    with state.metrics_lock:
                        metrics["requests_total"] += 1
                        metrics["prompt_tokens_total"] += final.get("tokens_evaluated", 0)
                        metrics["generated_tokens_total"] += final.get("tokens_predicted", 0)
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
                    send(run(emit=send))
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

                final = run(emit=emit)
                finish = "length" if final.get("stopped_limit") else "stop"
                tail = {"delta": {}} if chat else {"text": "", "logprobs": None}
                send({**base, "choices": [{"index": 0, "finish_reason": finish, **tail}]})
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
                return
            final = run()
            if openai is None:
                self._json(200, final)
            else:
                self._json(200, _openai_response(final, chat, rid, state.alias))

    return Handler


class _Server(ThreadingHTTPServer):
    request_queue_size = 256
    daemon_threads = True


def serve(engine: FalconEngine, vocab, host: str = "127.0.0.1", port: int = 8080,
          arch: str = "falcon", parallel: int = 1, alias: str = "unknown"):
    """The single-stream server over `engine` (not yet serving: call
    serve_forever on the result). parallel > 1 is refused."""
    if parallel > 1:
        raise NotImplementedError(PARALLEL_REFUSAL)
    state = ServerState(engine, vocab, arch, alias=alias)
    state.metrics = {name: 0 for name, _ in METRICS}
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
                    help="concurrent requests through continuous batching (not ported:"
                         " only 1)")
    ap.add_argument("--kv-dtype", default="bfloat16", choices=("bfloat16", "float32", "int8"))
    ap.add_argument("--compute-dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--weight-mode", default="fused", choices=["fused", "dequant"])
    ap.add_argument("-a", "--alias", default=None,
                    help="model name returned in responses (server.cpp "
                         "model_alias; defaults to the model path)")
    ap.add_argument("--lora", default=None, help="apply a 'ggla' LoRA adapter (not ported)")
    ap.add_argument("--lora-base", default=None,
                    help="unquantized base model for --lora (not ported)")
    ap.add_argument("--draft-model", default=None, metavar="FNAME",
                    help="speculative decoding's draft model (not ported)")
    ap.add_argument("--self-draft", type=int, default=0, metavar="N",
                    help="speculative decoding with the model's first N layers (not ported)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None):
    from ggllm_tpu_torch.core.config import EngineConfig
    from ggllm_tpu_torch.io.loader import load_model

    ap = build_parser()
    args = ap.parse_args(argv)
    if args.parallel > 1:
        ap.error(PARALLEL_REFUSAL)
    if args.draft_model or args.self_draft:
        ap.error(DRAFT_REFUSAL)
    if args.lora or args.lora_base:
        ap.error(LORA_REFUSAL)

    cfg = EngineConfig(n_ctx=args.ctx_size, n_batch=args.batch_size, kv_dtype=args.kv_dtype,
                       compute_dtype=args.compute_dtype,
                       kernel_layout=args.weight_mode == "fused")
    mf, params = load_model(args.model, cfg, device=args.device)
    engine = FalconEngine(mf.hparams, params, cfg, device=args.device)
    httpd = serve(engine, mf.vocab, args.host, args.port, arch=mf.arch,
                  alias=args.alias or args.model)
    print(f"listening on http://{args.host}:{httpd.server_address[1]}", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
    return 0
