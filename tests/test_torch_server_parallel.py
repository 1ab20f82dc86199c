"""The port's server with --parallel (server/app.py BatchedServerState over
engine/batching.py) and grammar requests in both of its modes, against the
JAX package's batched server, in-process on the CPU.

One tiny Falcon GGCC file written by the JAX package is served by both at
f32 with 3 rows and chunk 4 (the JAX tests/test_server.py:144 setup). The
same greedy requests, sent one at a time, get the same content, counts,
stop fields and settings from both (the JAX responses once a module);
concurrent requests complete with the contents they get alone. The
batched-mode refusals are the JAX server's but for penalize_nl false,
which the port serves. Grammar requests answer digits in both modes and a
grammar that does not parse gets HTTP 400 in both; SSE chunks concatenate
to the blocking content; /metrics counts what was sent; --decode-chunk
and --prefill-chunk reach the batcher; serve(parallel=2) refuses a batch-1
engine; and a fault of the scheduler fails the waiting requests (HTTP 500)
instead of leaving them hanging."""

import concurrent.futures
import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from ggllm_tpu.core.config import EngineConfig, FalconHParams
from ggllm_tpu.core.dtypes import GGMLType
from ggllm_tpu.engine.engine import FalconEngine as JEngine
from ggllm_tpu.io.ggcc import read_model
from ggllm_tpu.io.loader import load_params
from ggllm_tpu.server import app as japp
from ggllm_tpu.utils.synthetic import write_tiny_model

from ggllm_tpu_torch.core.config import EngineConfig as TEngineConfig
from ggllm_tpu_torch.engine.engine import FalconEngine
from ggllm_tpu_torch.io.loader import load_model
from ggllm_tpu_torch.server import app

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)

GREEDY = {"temperature": 0.0, "repeat_penalty": 1.0}
DIGITS = "root ::= [0-9]+"
LONG = " ".join(["the thing and the other"] * 40)  # past n_ctx 128: truncated
# (route, body), sent one at a time to both servers
REQUESTS = [
    ("/completion", {"prompt": "hello a", "n_predict": 8, **GREEDY}),
    ("/completion", {"prompt": "the theatre", "n_predict": 12, "temperature": 0}),
    ("/completion", {"prompt": "in another", "n_predict": 10, "ignore_eos": True, **GREEDY}),
    ("/completion", {"prompt": "the", "n_predict": 8, "grammar": DIGITS, **GREEDY}),
    ("/completion", {"prompt": LONG, "n_predict": 9, "n_keep": 8, **GREEDY}),
    ("/completion", {"prompt": "ab cd", "n_predict": 8, "repeat_penalty": 1.0,
                     "temperature": 0, "logit_bias": [[11, False], [40, 2.5]]}),
    ("/v1/completions", {"prompt": "the other", "max_tokens": 9, "temperature": 0}),
]
UNSUPPORTED = [
    {"prompt": "x", "temperature": 0.8, "top_k": 500},
    {"prompt": "x", "temperature": 0.8, "top_k": 0},
    {"prompt": "x", "temperature": 0.0, "top_k": 500},
    {"prompt": "x", "logit_bias": [[t, 1.0] for t in range(65)]},
    {"prompt": "x", "logit_bias": [[t, 1.0] for t in range(64)]},
    {"prompt": "x", "logit_bias": [[t, 1.0] for t in range(64)], "ignore_eos": True},
    {"prompt": "x", "logit_bias": [[t, 1.0] for t in range(63)], "ignore_eos": True},
    {"prompt": "x", "grammar": DIGITS},
    {"prompt": "x"},
]


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("psrv") / "tiny.ggcc")
    write_tiny_model(p, FalconHParams.tiny(), ftype_2d=GGMLType.Q8_0, seed=8)
    return p


def _start(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(url, route, body):
    req = urllib.request.Request(url + route, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _status(url, route, body) -> tuple[int, dict]:
    try:
        return 200, _post(url, route, body)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _sse(url, body):
    req = urllib.request.Request(url + "/completion",
                                 data=json.dumps({**body, "stream": True}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        raw = r.read().decode()
    return [json.loads(line[len("data: "):]) for line in raw.split("\n\n") if line]


def _cfg(cls):
    return cls(n_ctx=128, n_batch=32, kv_dtype="float32", compute_dtype="float32")


def _port(path, parallel=3, **kw):
    mf, params = load_model(path, _cfg(TEngineConfig), device="cpu")
    eng = FalconEngine(mf.hparams, params, _cfg(TEngineConfig), device="cpu",
                       batch_size=parallel)
    return app.serve(eng, mf.vocab, port=0, parallel=parallel, chunk=4, **kw)


@pytest.fixture(scope="module")
def jax_server(path):
    """The JAX batched server (3 rows, chunk 4): its responses to REQUESTS,
    and its state for the unsupported() rules."""
    mf = read_model(path)
    cfg = _cfg(EngineConfig)
    httpd = japp.serve(JEngine(mf.hparams, load_params(mf, cfg), cfg, batch_size=3), mf.vocab,
                       port=0, parallel=3, chunk=4)
    url = _start(httpd)
    try:
        yield [_post(url, route, body) for route, body in REQUESTS], httpd.state
    finally:
        httpd.state.shutdown()
        httpd.shutdown()
        httpd.server_close()


@pytest.fixture(scope="module")
def server(path):
    httpd = _port(path)
    url = _start(httpd)
    yield url, httpd.state
    httpd.shutdown()
    httpd.server_close()


def _same(got: dict, ref: dict):
    assert got.keys() - {"timings"} == ref.keys() - {"timings"}
    for k in ref:
        if k not in ("timings", "created"):
            assert got[k] == ref[k], k


def test_greedy_responses_match_the_jax_batched_server(server, jax_server):
    """REQUESTS one at a time: content, tokens_predicted, tokens_evaluated,
    truncation, stop fields and generation_settings equal the JAX batched
    server's; the grammar request answers digits; the timings hold
    prompt_ms and predicted_per_second."""
    url, _ = server
    got = [_post(url, route, body) for route, body in REQUESTS]
    for g, r in zip(got, jax_server[0]):
        _same(g, r)
    assert got[3]["content"].isdigit() and got[3]["tokens_predicted"] == 8
    assert got[4]["truncated"] and not got[0]["truncated"]
    assert got[2]["tokens_predicted"] == 10 and got[2]["generation_settings"]["ignore_eos"]
    t = got[0]["timings"]
    assert t["prompt_ms"] > 0 and t["predicted_per_second"] > 0 and t["total_ms"] >= t["prompt_ms"]


def test_concurrent_requests_complete_as_alone(server):
    """Requests sent at once (more than the rows, a grammar one among them)
    batch together and each answers what it answers alone."""
    url, _ = server
    bodies = [{"prompt": p, "n_predict": 8, **GREEDY}
              for p in ("hello a", "the theatre", "in another", "ab cd", "x y z")]
    bodies.append({"prompt": "the", "n_predict": 8, "grammar": DIGITS, **GREEDY})
    with concurrent.futures.ThreadPoolExecutor(len(bodies)) as ex:
        together = list(ex.map(lambda b: _post(url, "/completion", b), bodies))
    alone = [_post(url, "/completion", b) for b in bodies]
    for t, a in zip(together, alone):
        assert t["content"] == a["content"] and t["tokens_predicted"] == a["tokens_predicted"]
    assert together[-1]["content"].isdigit()


def test_unsupported_matches_jax_but_serves_penalize_nl_false(server, jax_server):
    """The batched-mode refusals (top-k outside 1..64 at temperature > 0,
    more than 64 merged bias ids) are the JAX server's, message for message;
    penalize_nl false, which the JAX server refuses, is served (HTTP 200)."""
    url, state = server
    jstate = jax_server[1]
    for body in UNSUPPORTED:
        assert state.unsupported(body) == jstate.unsupported(body), body
    nl = {"prompt": "x", "n_predict": 4, "penalize_nl": False, **GREEDY}
    assert jstate.unsupported(nl) == "penalize_nl=false requires --parallel 1"
    assert state.unsupported(nl) is None
    code, body = _status(url, "/completion", nl)
    assert code == 200 and body["tokens_predicted"] == 4
    assert body["generation_settings"]["penalize_nl"] is False
    code, body = _status(url, "/completion", UNSUPPORTED[0])
    assert code == 400 and body["error"] == "top_k must be in 1..64 in batched mode"


def test_grammar_stream_metrics_and_bad_grammar(server, path):
    """A bad grammar gets HTTP 400 in batched and single-stream mode (the
    batched server's other requests complete); a streamed grammar request's
    chunks concatenate to its blocking content, digits only, equal to the
    single-stream server's; /metrics counts the requests sent."""
    url, state = server
    before = dict(state.metrics)
    bad = {"prompt": "the", "n_predict": 4, "grammar": "root ::= [z-a]"}
    good = {"prompt": "the thing", "n_predict": 10, "grammar": DIGITS, **GREEDY}
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        futs = [ex.submit(_status, url, "/completion", b) for b in (good, bad, good)]
        (c1, r1), (c2, r2), (c3, r3) = (f.result() for f in futs)
    assert (c1, c2, c3) == (200, 400, 200) and r2["error"].startswith("bad grammar")
    assert r1["content"] == r3["content"] and r1["content"].isdigit()
    events = _sse(url, good)
    assert events[-1]["stop"] and all(not e["stop"] for e in events[:-1])
    assert "".join(e["content"] for e in events[:-1]) == r1["content"]
    sent = [r1, r3, events[-1]]
    with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
        metrics = r.read().decode()
    want = {"requests_total": len(sent),
            "prompt_tokens_total": sum(r["tokens_evaluated"] for r in sent),
            "generated_tokens_total": sum(r["tokens_predicted"] for r in sent)}
    for name, n in want.items():
        assert f"ggllm_{name} {before[name] + n}\n" in metrics, name
    single = _port(path, parallel=1)
    surl = _start(single)
    try:
        assert _status(surl, "/completion", bad)[0] == 400
        assert _post(surl, "/completion", good)["content"] == r1["content"]
    finally:
        single.shutdown()
        single.server_close()


def test_flags_reach_the_batcher(path, monkeypatch):
    """main() builds FalconEngine(batch_size=--parallel) and hands
    --decode-chunk and --prefill-chunk to the batcher; serve() refuses an
    engine whose rows are not --parallel."""
    seen = {}

    class _Httpd:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            pass

        def server_close(self):
            pass

    def fake_serve(engine, vocab, host, port, **kw):
        seen.update(kw, batch=engine.batch)
        return _Httpd()

    monkeypatch.setattr(app, "serve", fake_serve)
    assert app.main(["-m", path, "--device", "cpu", "-c", "128", "--parallel", "2",
                     "--decode-chunk", "6", "--prefill-chunk", "48"]) == 0
    assert seen["batch"] == 2 and seen["parallel"] == 2
    assert seen["chunk"] == 6 and seen["prefill_chunk"] == 48
    monkeypatch.undo()
    mf, params = load_model(path, _cfg(TEngineConfig), device="cpu")
    eng = FalconEngine(mf.hparams, params, _cfg(TEngineConfig), device="cpu")
    with pytest.raises(ValueError, match="batch_size 2"):
        app.serve(eng, mf.vocab, port=0, parallel=2)
    args = app.build_parser().parse_args(["-m", "x"])
    assert (args.parallel, args.decode_chunk, args.prefill_chunk) == (1, 8, 256)


def test_a_scheduler_fault_fails_the_waiting_requests(path):
    """A fault of the scheduler itself (a step that raises) answers every
    waiting request with HTTP 500 naming it, ends the scheduler, and later
    requests get 500 at once."""
    httpd = _port(path, parallel=2)
    url = _start(httpd)
    state = httpd.state
    steps = [0]
    real = state.batcher.step

    def step():
        steps[0] += 1
        if steps[0] == 3:
            raise RuntimeError("device lost")
        real()

    state.batcher.step = step
    try:
        bodies = [{"prompt": p, "n_predict": 40, **GREEDY} for p in ("a b", "c d", "e f")]
        with concurrent.futures.ThreadPoolExecutor(3) as ex:
            got = list(ex.map(lambda b: _status(url, "/completion", b), bodies))
        assert [c for c, _ in got] == [500] * 3
        assert all("device lost" in r["error"] for _, r in got)
        state.thread.join(timeout=30)
        assert not state.thread.is_alive() and isinstance(state.fault, RuntimeError)
        code, r = _status(url, "/completion", bodies[0])
        assert code == 500 and "stopped" in r["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_many_concurrent_clients_lose_no_request(server):
    """More clients than rows and cores at once, with the interpreter
    switching threads often: every request answers 200 with its tokens, and
    /metrics counts each one (no lost update of the shared counters)."""
    import sys

    url, state = server
    before = dict(state.metrics)
    bodies = [{"prompt": f"client {i}", "n_predict": 3, **GREEDY} for i in range(24)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with concurrent.futures.ThreadPoolExecutor(len(bodies)) as ex:
            got = list(ex.map(lambda b: _status(url, "/completion", b), bodies))
    finally:
        sys.setswitchinterval(interval)
    assert all(c == 200 and r["tokens_predicted"] == 3 for c, r in got), got
    assert state.metrics["requests_total"] == before["requests_total"] + len(bodies)
    assert (state.metrics["generated_tokens_total"]
            == before["generated_tokens_total"] + 3 * len(bodies))
