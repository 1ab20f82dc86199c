"""Jobs that the port's rank processes run (parallel/mesh.py RankPool) for
tests/test_torch_tp.py, test_torch_sp.py, test_torch_sharding.py and
test_torch_cli_parallel.py.

Each job runs on every rank of the pool's world, makes its mesh of the
first `mp` ranks (a rank outside it returns None), builds what it needs on
the CPU in f32 and returns numpy values. This module imports torch and the
port only: a rank process imports no jax."""

from __future__ import annotations

import numpy as np
import torch

from ggllm_tpu_torch.core.config import EngineConfig
from ggllm_tpu_torch.engine.batching import ContinuousBatcher, Request
from ggllm_tpu_torch.engine.engine import FalconEngine
from ggllm_tpu_torch.io.loader import load_model
from ggllm_tpu_torch.ops.sampling import SamplerParams
from ggllm_tpu_torch.parallel.mesh import make_mesh

GREEDY = SamplerParams(temp=0.0, repeat_penalty=1.0)


def cfg_of(**kw) -> EngineConfig:
    kw.setdefault("n_ctx", 64)
    kw.setdefault("n_batch", 16)
    kw.setdefault("kv_dtype", "float32")
    kw.setdefault("compute_dtype", "float32")
    return EngineConfig(**kw)


def _mesh(mp: int, data: int = 1):
    return make_mesh(data, mp, devices=["cpu"] * torch.distributed.get_world_size())


def _engine(path: str, mp: int, cfg_kw: dict, batch: int = 1, data: int = 1, lora=None):
    mesh = _mesh(mp, data)
    if mesh is None:
        return None
    cfg = cfg_of(**cfg_kw)
    mf, params = load_model(path, cfg, mesh=mesh, lora=lora)
    return FalconEngine(mf.hparams, params, cfg, batch_size=batch, mesh=mesh)


def single_engine(path: str, cfg_kw: dict, batch: int = 1) -> FalconEngine:
    """The port's single-process engine of the same file and config."""
    cfg = cfg_of(**cfg_kw)
    mf, params = load_model(path, cfg, device="cpu")
    return FalconEngine(mf.hparams, params, cfg, device="cpu", batch_size=batch)


def prefill_step(path: str, mp: int, cfg_kw: dict, prompt: list, step_tok=None):
    """(prefill logits, one decode step's logits after step_tok (default the
    prefill's argmax), the cache's local shape)."""
    eng = _engine(path, mp, cfg_kw)
    if eng is None:
        return None
    l1 = eng.eval(prompt)
    t = int(np.argmax(l1)) if step_tok is None else step_tok
    l2 = eng.eval([t])
    kv = eng.kv[0] if isinstance(eng.kv, tuple) else eng.kv
    return l1, l2, tuple(kv.shape)


def logits_all(path: str, mp: int, cfg_kw: dict, ids: list):
    eng = _engine(path, mp, cfg_kw)
    return None if eng is None else eng.eval(ids, logits_all=True)


def prefill_only(path: str, mp: int, cfg_kw: dict, ids: list):
    eng = _engine(path, mp, cfg_kw)
    return None if eng is None else eng.eval(ids)


def generate(path: str, mp: int, cfg_kw: dict, prompt: list, n: int):
    eng = _engine(path, mp, cfg_kw)
    return None if eng is None else eng.generate(prompt, n, GREEDY)


def decode_chunks(path: str, mp: int, cfg_kw: dict, prompt: list, n_total: int,
                  n_steps: int):
    """(decode_chunk ids of n_total in chained chunks, decode_pipelined ids)
    from the prefill's argmax."""
    out = []
    for pipelined in (False, True):
        eng = _engine(path, mp, cfg_kw)
        if eng is None:
            return None
        first = int(np.argmax(eng.eval(prompt)))
        last = prompt + [first]
        if pipelined:
            ids, _ = eng.decode_pipelined(first, n_total, n_steps, GREEDY, last_tokens=last)
        else:
            ids, gen, tok = [], None, first
            for _ in range(n_total // n_steps):
                got, gen = eng.decode_chunk(tok, n_steps, GREEDY, gen, last_tokens=last)
                ids += [int(t) for t in got]
                last = last + [int(t) for t in got]
                tok = ids[-1]
        out.append([int(t) for t in ids])
    return out


def split_run(path: str, mp: int, cfg_kw: dict, prompt: list, n_ids: int, lora=None):
    """The fallback tree under a 1 x mp mesh: (prefill logits, one decode
    step's after the prefill's argmax, n_ids greedy ids from a fresh cache,
    the cache's local shape, this rank's layer-0 weight shapes)."""
    eng = _engine(path, mp, cfg_kw, lora=lora)
    if eng is None:
        return None
    assert eng.split is not None
    l1 = eng.eval(prompt)
    l2 = eng.eval([int(np.argmax(l1))])
    eng.reset()
    ids = [int(t) for t in eng.generate(prompt, n_ids, GREEDY)]
    layer = eng.model.layers[0]
    shapes = {k: tuple(getattr(layer, k).shape) for k in ("wq", "wk", "wv", "wo", "ffn_up",
                                                          "ffn_down")}
    return l1, l2, ids, tuple(eng.kv.shape), shapes


def rows_run(path: str, mp: int, data: int, cfg_kw: dict, batch: int, prompts: list,
             temp: float = 0.0):
    """A data x mp mesh's batch_size engine (data 1, mp 0: the single
    process's): prefill_rows of one prompt a row (every row at position 0)
    and 4 decode_rows steps at `temp` from the argmaxes; (their logits
    {row: ...}, the (4, B) ids, the cache's local rows, the timings'
    (n_prefill, n_decode))."""
    if mp == 0:
        eng = single_engine(path, cfg_kw, batch=batch)
    else:
        eng = _engine(path, mp, cfg_kw, batch=batch, data=data)
        if eng is None:
            return None
    B = batch
    got = eng.prefill_rows(list(range(B)), prompts[:B], np.zeros(B, np.int64))
    toks = np.array([int(np.argmax(got[r])) for r in range(B)])
    ids, _, _ = eng.decode_rows(toks, np.array([len(p) for p in prompts[:B]]), 4,
                                values={"temp": np.full(B, temp)})
    return got, ids, eng.kv.shape[2], (eng.timings.n_prefill, eng.timings.n_decode)


def batcher(path: str, mp: int, cfg_kw: dict, prompts: list, n_predict: int, chunk: int,
            batch: int = 2, data: int = 1):
    eng = _engine(path, mp, cfg_kw, batch=batch, data=data)
    if eng is None:
        return None
    b = ContinuousBatcher(eng, chunk=chunk)
    reqs = [b.submit(Request(list(p), n_predict=n_predict)) for p in prompts]
    b.run()
    return [r.out for r in reqs]


def embed(path: str, mp: int, cfg_kw: dict, prompt: list):
    eng = _engine(path, mp, cfg_kw)
    return None if eng is None else eng.embed(prompt)


def blocks(path: str, mp: int, cfg_kw: dict, keys: tuple):
    """Layer 0's weight blocks of this rank, dequantized to f32."""
    mesh = _mesh(mp)
    if mesh is None:
        return None
    _, params = load_model(path, cfg_of(**cfg_kw), mesh=mesh)
    lw = params["layers"][0]
    return {k: lw[k].dequantize(torch.float32).numpy() for k in keys}


def load_error(path: str, mp: int, cfg_kw: dict, lora=None, data: int = 1):
    """The message a load under the mesh raises (None where it loads)."""
    mesh = make_mesh(data, mp // data, devices=["cpu"] * torch.distributed.get_world_size())
    if mesh is None:
        return None
    try:
        load_model(path, cfg_of(**cfg_kw), mesh=mesh, lora=lora)
    except NotImplementedError as e:
        return str(e)
    return None


def ring(q: np.ndarray, k: np.ndarray, v: np.ndarray, mp: int, n_past: int):
    """kernels/ring_attention.py on rank i's blocks: q's i-th block of
    positions, k / v's i-th window of the cache. Returns the local output."""
    from ggllm_tpu_torch.kernels.ring_attention import ring_attention

    mesh = _mesh(mp)
    if mesh is None:
        return None
    i, Sl, Tl = mesh.rank, q.shape[1] // mp, k.shape[1] // mp
    blk = lambda a, w: torch.from_numpy(np.ascontiguousarray(a[:, i * w:(i + 1) * w]))  # noqa: E731
    return ring_attention(blk(q, Sl), blk(k, Tl), blk(v, Tl), mesh.comm, n_past).numpy()


def merged(q: np.ndarray, k: np.ndarray, v: np.ndarray, mp: int, n_past, append=None,
           append_valid=None):
    """parallel/sp.py merged_attention on rank i's window of the cache."""
    from ggllm_tpu_torch.parallel.sp import merged_attention

    mesh = _mesh(mp)
    if mesh is None:
        return None
    i, Tl = mesh.rank, k.shape[1] // mp
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    app = None if append is None else t(append)
    return merged_attention(t(q), t(k[:, i * Tl:(i + 1) * Tl]), t(v[:, i * Tl:(i + 1) * Tl]),
                            torch.as_tensor(n_past), i, Tl, mesh.comm, append=app,
                            append_valid=append_valid).numpy()


def imported_jax() -> list[str]:
    """The modules of jax or of the JAX package this rank has imported."""
    import sys

    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "ggllm_tpu"))


def cli_text(path: str, mp: int, argv: list):
    """(rc, stdout bytes, seed) of the port CLI's work on this rank
    (tools/main.py _run under the mesh, as -ts N runs it on every rank; the
    CLI keeps every rank's stdout but rank 0's quiet, so it is caught here
    instead)."""
    import io
    import sys

    from ggllm_tpu_torch.tools import main as cli

    mesh = _mesh(mp)
    if mesh is None:
        return None
    parser = cli.build_parser()
    args = parser.parse_args(["-m", path, "--device", "cpu", *argv])
    raw, saved = io.BytesIO(), (sys.stdout, sys.stderr)
    sys.stdout, sys.stderr = io.TextIOWrapper(raw, write_through=True), io.StringIO()
    try:
        rc = cli._run(parser, args, mesh)
        sys.stdout.flush()
        return rc, raw.getvalue(), args.seed
    finally:
        sys.stdout, sys.stderr = saved
