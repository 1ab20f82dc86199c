"""Session (prompt-cache) save and restore (port of
ggllm_tpu/engine/session.py).

The capability analogue of llama_{load,save}_session_file + falcon state
serialization (libfalcon.cpp:4226-4601): the evaluated token list, the KV
cache, the sampler state and the last logits go into one npz, and a load
reuses the longest matching prompt prefix (falcon_main.cpp:412-510,
763-784).

The file format is the JAX package's (magic "ggsn-tpu", version 2, the same
hparams guard), so a file written by either package loads its tokens and KV
into the other. The KV keeps its native dtype and only the first n_past
positions: int8 codes and scales as they are, bf16 as a raw uint16 view
under kv_dtype "bfloat16". A load converts between an int8 and a dense
cache (int8 -> codes * scales in f32; dense -> ops/kvcache.py
quantize_new) and writes into the engine's cache in place, so the decode
graphs that point at its storage stay valid.

Only the host part of the sampler state crosses packages: `rng_state` (a
numpy bit_generator.state) and `mirostat` mu. The JAX package stores its
device PRNG key as `rng_key` (a threefry key); the port stores its
torch.Generator's state under `torch_rng_state`, tagged `rng_backend` =
"torch:<device type>", and never writes `rng_key`. A load restores a torch
state only from a torch file of the same device type; in every other case
load_sampler_state makes a fresh generator and says so on stderr.

Under a mesh (parallel/mesh.py) every rank calls save / try_load /
load_sampler_state: save gathers the ranks' parts of the cache
(engine.gather_kv) and rank 0 writes the file, whole, in this format; a load
is read by rank 0, sent to every rank, and each writes its part
(engine.scatter_kv), as the JAX load puts the cache back into its sharding
(session.py:125-129).

Unlike the JAX save, which hands numpy a file name (numpy then appends
".npz" to a name without it, so such a file is never found again), the port
writes to exactly the path it is given.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from ggllm_tpu_torch.ops import kvcache

SESSION_MAGIC = "ggsn-tpu"
SESSION_VERSION = 2


def _np_view(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A cache slice as numpy in its own dtype; bfloat16, which npz cannot
    hold, as its raw uint16 bits."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def rng_backend(generator: torch.Generator) -> str:
    return f"torch:{generator.device.type}"


def save(path: str, engine, tokens: list[int], sampler_state=None,
         generator: torch.Generator | None = None, logits=None) -> None:
    """Write the engine's first n_past KV positions, `tokens` (the ids they
    hold), the host sampler state, the device generator's state and the last
    logits to `path`."""
    n_past = engine.n_past
    kv = engine.gather_kv(n_past)
    if engine.mesh is not None and engine.mesh.rank != 0:
        return
    arrays = dict(
        magic=SESSION_MAGIC,
        version=SESSION_VERSION,
        n_embd=engine.hp.n_embd,
        n_layer=engine.hp.n_layer,
        n_head_kv=engine.hp.n_head_kv,
        n_ctx=engine.cfg.n_ctx,
        batch=engine.batch,
        n_past=n_past,
        tokens=np.asarray(tokens, dtype=np.int32),
    )
    if kvcache.is_quantized(kv):  # int8 cache: codes + per-vector scales, as they are
        arrays["kv_q"] = _np_view(kv[0])[0]
        arrays["kv_s"] = _np_view(kv[1])[0]
        arrays["kv_dtype"] = "int8"
    else:
        arrays["kv"], arrays["kv_dtype"] = _np_view(kv)
    if sampler_state is not None:
        arrays["rng_state"] = json.dumps(sampler_state.rng.bit_generator.state)
        arrays["mu"] = np.float64(sampler_state.mu)
    if generator is not None:
        arrays["torch_rng_state"] = generator.get_state().numpy()
        arrays["rng_backend"] = rng_backend(generator)
    if logits is not None:
        arrays["logits"] = np.asarray(logits, dtype=np.float32)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, path)


def _read(path: str):
    if not path or not os.path.exists(path):
        return None
    try:
        z = np.load(path, allow_pickle=False)
        if str(z["magic"]) != SESSION_MAGIC or int(z["version"]) != SESSION_VERSION:
            return None
        return z
    except Exception:
        return None


def _open(path: str, engine):
    """The session's arrays, or None if there is none or it is not a
    session; under a mesh read by rank 0 and sent to every rank."""
    mesh = engine.mesh
    if mesh is None:
        return _read(path)
    z = _read(path) if mesh.rank == 0 else None
    return mesh.comm.broadcast_object(None if z is None else {k: z[k] for k in z.files})


def _loaded_kv(z, kv_dtype: str, engine_kv):
    """The file's KV converted to the engine's cache kind, on its device:
    (codes, scales) for an int8 engine, else one tensor of its dtype."""
    dev = (engine_kv[0] if kvcache.is_quantized(engine_kv) else engine_kv).device
    if kv_dtype == "int8":
        codes, scales = torch.from_numpy(z["kv_q"]), torch.from_numpy(z["kv_s"])
        if kvcache.is_quantized(engine_kv):
            return codes.to(dev), scales.to(dev)
        dense = codes.to(torch.float32) * scales  # dequantized into the engine's dtype
        return dense.to(engine_kv.dtype).to(dev)
    raw = z["kv"]
    dense = (torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
             if kv_dtype == "bfloat16" else torch.from_numpy(raw))
    if kvcache.is_quantized(engine_kv):
        codes, scales = kvcache.quantize_new(dense)
        return codes.to(dev), scales.to(dev)
    return dense.to(engine_kv.dtype).to(dev)


def try_load(path: str, engine, prompt_ids: list[int]) -> list[int]:
    """Restore the engine's KV state from a session; returns the prompt
    suffix that still needs evaluation. The reused prefix is the longest
    common one of the file's tokens and the prompt, capped at n_past and at
    len(prompt) - 1 (one token is always evaluated, for fresh logits). On
    any mismatch returns prompt_ids unchanged and leaves the engine as it
    was."""
    z = _open(path, engine)
    if z is None:
        return list(prompt_ids)
    try:
        if (int(z["n_embd"]) != engine.hp.n_embd
                or int(z["n_layer"]) != engine.hp.n_layer
                or int(z["n_head_kv"]) != engine.hp.n_head_kv
                or int(z["n_ctx"]) != engine.cfg.n_ctx
                or int(z["batch"]) != engine.batch):
            return list(prompt_ids)
        saved = z["tokens"]
        n_past = int(z["n_past"])
        kv_dtype = str(z["kv_dtype"])
        n = 0
        limit = min(len(prompt_ids) - 1, saved.size, n_past)
        while n < limit and prompt_ids[n] == int(saved[n]):
            n += 1
        if n == 0:
            return list(prompt_ids)
        loaded = _loaded_kv(z, kv_dtype, engine.kv)
    except Exception:
        return list(prompt_ids)

    engine.scatter_kv(loaded)  # in place: the decode graphs keep their storage
    engine.n_past = n
    return list(prompt_ids[n:])


def load_sampler_state(path: str, sampler, engine):
    """(SamplerState, torch.Generator, last logits or None) from a session.
    The host rng and mu come from any session file that holds them (either
    package's). The generator is restored only from a torch state written on
    `engine`'s device type; otherwise it is engine.new_generator(sampler),
    and, where a session file exists, stderr says that it is fresh."""
    from ggllm_tpu_torch.ops import sampling

    state = sampling.SamplerState.init(sampler)
    generator = engine.new_generator(sampler)
    z = _open(path, engine)
    if z is None:
        return state, generator, None
    restored = False
    logits = None
    try:
        logits = np.asarray(z["logits"]) if "logits" in z else None
        if "rng_state" in z:
            st = json.loads(str(z["rng_state"]))
            bg = getattr(np.random, st["bit_generator"])()
            bg.state = st
            state.rng = np.random.Generator(bg)
            state.mu = float(z["mu"])
        if "torch_rng_state" in z and str(z["rng_backend"]) == rng_backend(generator):
            generator.set_state(torch.from_numpy(z["torch_rng_state"]))
            restored = True
    except Exception:
        state, generator = sampling.SamplerState.init(sampler), engine.new_generator(sampler)
    if not restored:
        found = (f"a {z['rng_backend']} generator state" if "rng_backend" in z
                 else "a JAX device key" if "rng_key" in z else "no device generator state")
        print(f"session: {path} holds {found}; the {generator.device.type} generator starts"
              " fresh from the seed", file=sys.stderr)
    return state, generator, logits
