"""The port's single-stream HTTP server (ggllm_tpu_torch/server/app.py)
against the JAX package's (ggllm_tpu/server/app.py), in-process on the CPU.

One tiny Falcon GGCC file written by the JAX package is served by both,
each over its own engine at f32 (n_ctx 128, n_batch 32; the JAX engine in
the default config its own tests/test_server.py uses, whose matmuls and
attention take the plain XLA reference of the Pallas kernels on the CPU).
The same requests go to both servers, in the same order; the JAX responses
are taken once a module. Greedy content, tokens_predicted and
tokens_evaluated (prefix reuse), truncation, stopping word and ignore_eos
fields must be equal, the SSE stream must concatenate to the blocking
content, and the /v1 responses must have the same fields. The helpers the
port keeps copies of are held to the originals (--lora / --lora-base:
tests/test_torch_lora.py). With a --self-draft 1 draft (engine/speculative.py) greedy
requests give the plain path's content and carry the "speculative" field and
the spec_* counters, also with prefix reuse, streaming and a client gone
mid-stream; grammar and penalized requests take the plain path; a draft with
--parallel 2 is refused. (Grammar requests and --parallel:
tests/test_torch_server_parallel.py.)"""

import json
import threading
import urllib.request

import pytest
import torch

from ggllm_tpu.core.config import EngineConfig, FalconHParams
from ggllm_tpu.core.dtypes import GGMLType
from ggllm_tpu.engine.engine import FalconEngine
from ggllm_tpu.io.ggcc import read_model
from ggllm_tpu.io.loader import load_params
from ggllm_tpu.server import app as japp
from ggllm_tpu.utils.synthetic import write_tiny_model

from ggllm_tpu_torch.core.config import EngineConfig as TEngineConfig
from ggllm_tpu_torch.engine.engine import FalconEngine as TFalconEngine
from ggllm_tpu_torch.io.loader import load_model as tload_model
from ggllm_tpu_torch.server import app

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)

SSE_BODY = {"prompt": "in the south", "n_predict": 33, "temperature": 0, "ignore_eos": True}
LONG = " ".join(["the thing and the other"] * 40)  # past n_ctx 128: truncated
# (path, body) in order: later requests reuse the cache the earlier ones left
REQUESTS = [
    ("/completion", {"prompt": "the thing", "n_predict": 17, "temperature": 0,
                     "ignore_eos": True}),
    ("/completion", {"prompt": "the thing and more of it", "n_predict": 17, "temperature": 0,
                     "ignore_eos": True}),
    ("/completion", {"prompt": "the thing and more of it", "n_predict": 17, "temperature": 0}),
    ("/completion", {"prompt": LONG, "n_predict": 17, "n_keep": 8, "temperature": 0,
                     "ignore_eos": True}),
    ("/completion", {"prompt": "in the south", "n_predict": 33, "temperature": 0,
                     "repeat_penalty": 1.3, "ignore_eos": True}),
    ("/v1/completions", {"prompt": "the other", "max_tokens": 17, "temperature": 0,
                         "stop": "\n\n\n"}),
    ("/v1/chat/completions", {"messages": [{"role": "system", "content": "be brief"},
                                           {"role": "user", "content": "the thing"}],
                              "max_tokens": 17, "temperature": 0}),
]


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("srv") / "tiny.ggcc")
    write_tiny_model(p, FalconHParams.tiny(), ftype_2d=GGMLType.Q8_0, seed=5)
    return p


def _start(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(url, route, body):
    req = urllib.request.Request(url + route, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(url, route):
    with urllib.request.urlopen(url + route, timeout=30) as r:
        return r.read()


def _sse(url, route, body):
    """The data lines of an SSE response, JSON-decoded ("[DONE]" as is)."""
    req = urllib.request.Request(url + route, data=json.dumps({**body, "stream": True}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        raw = r.read().decode()
    return [d if d == "[DONE]" else json.loads(d)
            for d in (line[len("data: "):] for line in raw.split("\n\n") if line)]


def _text(s: str) -> str:
    return s.replace("\ufffd", "")


def _engine(path):
    cfg = TEngineConfig(n_ctx=128, n_batch=32, kv_dtype="float32", compute_dtype="float32")
    tmf, params = tload_model(path, cfg, device="cpu")
    return tmf, TFalconEngine(tmf.hparams, params, cfg, device="cpu")


@pytest.fixture(scope="module")
def jax_responses(path):
    """The JAX server's responses to _drive's requests and an SSE stream,
    once."""
    mf = read_model(path)
    cfg = EngineConfig(n_ctx=128, n_batch=32, kv_dtype="float32", compute_dtype="float32")
    httpd = japp.serve(FalconEngine(mf.hparams, load_params(mf, cfg), cfg), mf.vocab, port=0)
    url = _start(httpd)
    try:
        return _drive(url) + [_sse(url, "/completion", SSE_BODY)]
    finally:
        httpd.shutdown()
        httpd.server_close()


@pytest.fixture(scope="module")
def server(path):
    tmf, eng = _engine(path)
    httpd = app.serve(eng, tmf.vocab, port=0)
    url = _start(httpd)
    yield url, httpd.state
    httpd.shutdown()
    httpd.server_close()


def _stop_in(content: str) -> str:
    """Three characters from the second half of a completion (none of them a
    replacement character): a stop string that fires there."""
    i = next(i for i in range(len(content) // 2, len(content) - 3)
             if "\ufffd" not in content[i:i + 3])
    return content[i:i + 3]


def _drive(url) -> list:
    """REQUESTS in order, then the fifth again with a stop string taken from
    its content, then /tokenize and /."""
    out = [_post(url, route, body) for route, body in REQUESTS]
    out.append(_post(url, "/completion", {**REQUESTS[4][1], "stop": [_stop_in(out[4]["content"])]}))
    out.append(_post(url, "/tokenize", {"content": "hello wörld, the thing\n"}))
    out.append(json.loads(_get(url, "/")))
    return out


def _same_fields(got: dict, ref: dict, skip=("timings", "created")):
    assert got.keys() == ref.keys()
    for k in got:
        if k not in skip:
            assert got[k] == ref[k], k


def test_responses_match_the_jax_server(server, jax_responses):
    """_drive's requests in order through both servers: /completion's
    content, tokens_predicted, tokens_evaluated (the second and third reuse
    the first's cached prefix: fewer tokens than the prompt), truncated,
    stopped_* / stopping_word (a stop string that fires) and
    generation_settings (ignore_eos) equal;
    the /v1 responses' fields equal but for the clock; /tokenize ids and /
    equal. Then /metrics counts what was sent."""
    url, state = server
    got = _drive(url)
    routes = [route for route, _ in REQUESTS] + ["/completion", "/tokenize", "/"]
    for route, g, r in zip(routes, got, jax_responses[:-1]):
        if route == "/completion":
            assert g["timings"].keys() == r["timings"].keys()
        _same_fields(g, r)
    first, extended, again, long_, unstopped, stopped = got[:4] + got[4:5] + got[7:8]
    assert first["tokens_predicted"] == 17 and first["generation_settings"]["ignore_eos"]
    assert 0 < extended["tokens_evaluated"] < len(state.tk.tokenize(REQUESTS[1][1]["prompt"],
                                                                    bos=True))
    assert again["tokens_evaluated"] == 1
    assert long_["truncated"] and not first["truncated"]
    assert unstopped["stopped_limit"] and not unstopped["stopped_word"]
    assert stopped["stopped_word"] and stopped["stopping_word"] in unstopped["content"]
    assert unstopped["content"].startswith(stopped["content"])
    assert got[-2]["tokens"] == jax_responses[-3]["tokens"] and got[-2]["tokens"]
    metrics = _get(url, "/metrics").decode()
    assert f"ggllm_requests_total {len(REQUESTS) + 1}" in metrics
    n_gen = sum(g.get("tokens_predicted", g.get("usage", {}).get("completion_tokens", 0))
                for g in got[:len(REQUESTS) + 1])
    assert f"ggllm_generated_tokens_total {n_gen}" in metrics


def test_stopping_word_and_sse_stream(server, jax_responses):
    """A stop string taken from a greedy completion ends the next one there
    (stopped_word, stopping_word, the content before it); the SSE stream of
    a request is the JAX server's, chunk for chunk, and concatenates to the
    blocking content, native and OpenAI. (Each chunk is decoded on its own,
    as the reference sends it, so a character split across two chunks
    arrives as replacement characters: the texts are compared without
    them.)"""
    url, _ = server
    body = SSE_BODY
    full = _post(url, "/completion", body)["content"]
    stop = full[len(full) // 2:len(full) // 2 + 3]
    cut = _post(url, "/completion", {**body, "stop": [stop]})
    assert cut["stopped_word"] and cut["stopping_word"] == stop
    assert cut["content"] == full[:full.index(stop)]
    events = _sse(url, "/completion", body)
    assert events[-1]["stop"] and events[-1]["content"] == ""
    assert [e["content"] for e in events[:-1]] == [e["content"] for e in jax_responses[-1][:-1]]
    assert _text("".join(e["content"] for e in events[:-1])) == _text(full)
    v1 = _post(url, "/v1/completions", {"prompt": "in the south", "max_tokens": 33,
                                        "temperature": 0})
    events = _sse(url, "/v1/completions", {"prompt": "in the south", "max_tokens": 33,
                                           "temperature": 0})
    assert events[-1] == "[DONE]" and events[-2]["choices"][0]["finish_reason"] is not None
    assert (_text("".join(e["choices"][0]["text"] for e in events[:-2]))
            == _text(v1["choices"][0]["text"]))


def test_sampled_requests_share_one_program(server):
    """Two sampled requests that differ in temperature, top-p and repeat
    penalty answer with ids from the vocabulary and leave one sampled chunk
    program (on the card: one graph) in the engine."""
    url, state = server
    for temp, top_p, rp in ((0.7, 0.9, 1.1), (0.9, 0.8, 1.2)):
        r = _post(url, "/completion", {"prompt": "the thing", "n_predict": 17, "seed": 3,
                                       "temperature": temp, "top_p": top_p,
                                       "repeat_penalty": rp, "ignore_eos": True})
        assert r["tokens_predicted"] == 17 and r["generation_settings"]["temp"] == temp
    sampled = [k for k in state.engine._chunks if not k[1].greedy]
    assert len(sampled) == 1


def test_client_gone_mid_stream_leaves_a_consistent_cache(server, path):
    """An emit that raises (a client gone mid-stream) leaves the engine's
    n_past at the tokens consumed and the cache record at what the cache
    holds: the next request's greedy content equals a fresh server's."""
    url, state = server
    body = {"prompt": "the thing", "n_predict": 33, "temperature": 0, "ignore_eos": True}
    calls = [0]

    def emit(chunk):
        calls[0] += 1
        if calls[0] == 3:
            raise BrokenPipeError("client gone")

    with state.lock, pytest.raises(BrokenPipeError):
        state.completion(body, emit=emit)
    assert state.engine.n_past == len(state.cache_tokens) - 1
    follow = {"prompt": "the thing and more", "n_predict": 17, "temperature": 0}
    got = _post(url, "/completion", follow)
    tmf, eng = _engine(path)
    ref = app.ServerState(eng, tmf.vocab).completion(follow)
    assert got["content"] == ref["content"] and got["tokens_predicted"] == ref["tokens_predicted"]


def test_draft_is_refused_where_it_cannot_run(path, capsys):
    """The draft flags are the JAX server's (--draft-model, --self-draft,
    --draft-k); a draft is refused with --parallel above 1 (before any model
    loads) and a --self-draft depth outside 1 .. n_layer - 1."""
    args = app.build_parser().parse_args(["-m", path, "--draft-model", path, "--self-draft", "1",
                                          "--draft-k", "4"])
    assert (args.draft_model, args.self_draft, args.draft_k) == (path, 1, 4)
    for extra in (["--self-draft", "1"], ["--draft-model", path]):
        assert app.main(["-m", "/nonexistent.ggcc", "--parallel", "2", *extra]) == 1
        assert "speculative serving requires --parallel 1" in capsys.readouterr().err
    assert app.main(["-m", path, "--device", "cpu", "--self-draft", "2"]) == 1
    assert "--self-draft must be in 1..1" in capsys.readouterr().err


def test_helpers_match_the_originals():
    """The copies of the JAX server's helpers give the originals' results."""
    from ggllm_tpu.ops.sampling import SamplerParams
    from ggllm_tpu_torch.ops.sampling import SamplerParams as TSamplerParams

    for a, b in (([1, 2, 3], [1, 2, 4]), ([], [1]), ([5, 6], [5, 6, 7]), ([1], [2])):
        assert app._common_part(a, b) == japp._common_part(a, b)
    kw = dict(temp=0.7, top_k=20, top_p=0.9, repeat_penalty=1.2, logit_bias={2: float("-inf")},
              seed=4, penalize_nl=False)
    for eos in (2, 0):
        assert (app._generation_settings(TSamplerParams(**kw), 16, 4, [b"x", b"yz"], eos)
                == japp._generation_settings(SamplerParams(**kw), 16, 4, [b"x", b"yz"], eos))
    for reason in ("eos", "stop", "limit"):
        for match in (None, b"\xe2\x82", b"end"):
            assert app._stop_fields(reason, match) == japp._stop_fields(reason, match)
    msgs = [{"role": "system", "content": "s"}, {"role": "user", "content": "u"},
            {"role": "assistant", "content": "a"}, {"content": "no role"}]
    assert app._chat_to_prompt(msgs) == japp._chat_to_prompt(msgs)
    for body, chat in (({"messages": msgs, "stop": "x", "top_k": 5, "logit_bias": {"3": -1}},
                        True),
                       ({"prompt": ["a", "b"], "max_tokens": 7, "seed": 2}, False),
                       ({}, False)):
        assert app._openai_to_native(body, chat) == japp._openai_to_native(body, chat)
    final = {"content": "hi", "stopped_limit": True, "tokens_evaluated": 3,
             "tokens_predicted": 5}
    for chat in (True, False):
        got, ref = app._openai_response(final, chat, 7, "m"), japp._openai_response(final, chat,
                                                                                     7, "m")
        assert abs(got.pop("created") - ref.pop("created")) <= 2 and got == ref


# ------------------------------------------------------- speculative serving

# no ignore_eos: its logit bias takes the plain path
SPEC_BODIES = [{"prompt": "the thing", "n_predict": 21, "temperature": 0, "repeat_penalty": 1.0},
               {"prompt": "the thing and more of it", "n_predict": 17, "temperature": 0,
                "repeat_penalty": 1.0}]


@pytest.fixture(scope="module")
def spec_server(path):
    """A server whose draft is the target's first layer (--self-draft 1),
    three drafts a round."""
    from ggllm_tpu_torch.engine.speculative import truncate_params

    tmf, eng = _engine(path)
    cfg = eng.cfg
    _, params = tload_model(path, cfg, device="cpu")
    eng = TFalconEngine(tmf.hparams, params, cfg, device="cpu")
    import dataclasses

    draft = TFalconEngine(dataclasses.replace(tmf.hparams, n_layer=1), truncate_params(params, 1),
                          cfg, device="cpu")
    httpd = app.serve(eng, tmf.vocab, port=0, draft_engine=draft, draft_k=3)
    url = _start(httpd)
    yield url, httpd.state
    httpd.shutdown()
    httpd.server_close()


def _plain(path, body):
    """A fresh plain server state's response (the handler's grammar parse
    included)."""
    tmf, eng = _engine(path)
    grammar = app.parse_gbnf(body["grammar"]) if body.get("grammar") else None
    return app.ServerState(eng, tmf.vocab).completion(body, grammar=grammar)


def test_self_draft_requests_equal_the_plain_path(spec_server, path):
    """Greedy requests through the speculative server give the plain path's
    content, carry the speculative field, reuse the cached prefix on both
    engines, and /metrics counts the rounds."""
    url, state = spec_server
    rounds = drafted = 0
    for body in SPEC_BODIES:
        got, ref = _post(url, "/completion", body), _plain(path, body)
        assert got["content"] == ref["content"]
        assert got["tokens_predicted"] == ref["tokens_predicted"]
        sp = got["speculative"]
        assert sp["rounds"] > 0 and sp["drafted"] == 3 * sp["rounds"] and "speculative" not in ref
        rounds, drafted = rounds + sp["rounds"], drafted + sp["drafted"]
    assert got["tokens_evaluated"] < len(state.tk.tokenize(SPEC_BODIES[1]["prompt"], bos=True))
    assert state.engine.n_past == state.spec.draft.n_past == len(state.cache_tokens) - 1
    assert state.cache_tokens == state.draft_tokens
    text = _get(url, "/metrics").decode()
    assert f"ggllm_spec_rounds_total {rounds}" in text
    assert f"ggllm_spec_drafted_total {drafted}" in text
    assert "ggllm_spec_accepted_total" in text


def test_grammar_and_penalized_requests_take_the_plain_path(spec_server, path):
    url, state = spec_server
    for body in ({"prompt": "the thing", "n_predict": 9, "temperature": 0,
                  "repeat_penalty": 1.0, "grammar": "root ::= [0-9]+"},
                 {"prompt": "the thing", "n_predict": 9, "temperature": 0,
                  "repeat_penalty": 1.3}):
        got = _post(url, "/completion", body)
        assert "speculative" not in got
        assert got["content"] == _plain(path, body)["content"]
    assert state.engine.n_past == len(state.cache_tokens) - 1


def test_a_streamed_speculative_request_and_a_client_gone(spec_server, path):
    """A streamed request's chunks concatenate to the blocking content; an
    emit that raises leaves both engines at the ids committed so far and
    the next request equal to a fresh server's."""
    url, state = spec_server
    body = {**SPEC_BODIES[0], "n_predict": 25}
    events = _sse(url, "/completion", body)
    assert events[-1]["stop"] and events[-1]["speculative"]["rounds"] > 0
    want = _plain(path, body)["content"]
    assert _text("".join(e["content"] for e in events[:-1])) == _text(want)
    calls = [0]

    def emit(chunk):
        calls[0] += 1
        if calls[0] == 3:
            raise BrokenPipeError("client gone")

    with state.lock, pytest.raises(BrokenPipeError):
        state.completion({**SPEC_BODIES[0], "prompt": "in the south"}, emit=emit)
    assert state.engine.n_past == state.spec.draft.n_past == len(state.cache_tokens) - 1
    follow = {**SPEC_BODIES[1], "prompt": "in the south and north"}
    got = _post(url, "/completion", follow)
    assert got["content"] == _plain(path, follow)["content"] and got["speculative"]["rounds"] > 0


def test_a_draft_needs_one_stream(path):
    tmf, eng = _engine(path)
    _, params = tload_model(path, eng.cfg, device="cpu")
    eng2 = TFalconEngine(tmf.hparams, params, eng.cfg, device="cpu", batch_size=2)
    with pytest.raises(ValueError, match="--parallel 1"):
        app.serve(eng2, tmf.vocab, port=0, parallel=2, draft_engine=eng)
