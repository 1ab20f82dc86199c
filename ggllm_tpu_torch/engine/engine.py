"""Single-stream inference engine (port of the single-stream part of
ggllm_tpu/engine/engine.py FalconEngine:143).

PyTorch runs eagerly, so the JAX engine's compile-shaped machinery has no
counterpart here: prefill chunks run at their own length (no power-of-two
buckets), and decoding is a Python step loop whose tokens stay on the
device until the end of a chunk (no fused lax.scan). With a dense cache
each layer writes its K/V into the cache in place before attending, which
gives the JAX engine's numbers because its pending buffer has the cache's
dtype. With an int8 cache decode_chunk runs the JAX engine's chunk-deferred
scheme (engine.py:542-585): the chunk's K/V stay unquantized in a pending
buffer in the compute dtype, attention reads the quantized cache below the
chunk's start plus that buffer, and one quantizing write ends the chunk.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ggllm_tpu_torch.core.config import EngineConfig, FalconHParams, LlamaHParams
from ggllm_tpu_torch.core.device import resolve_device
from ggllm_tpu_torch.kernels import flash_decode
from ggllm_tpu_torch.models import resolve_model
from ggllm_tpu_torch.ops import kvcache, sampling, sampling_device
from ggllm_tpu_torch.ops.rope import rope_angles
from ggllm_tpu_torch.tokenizer import nl_id

DECODE_CHUNK = 16


@dataclass
class Timings:
    """falcon_print_timings fields (libfalcon.cpp:4700-4715)."""

    t_load_us: float = 0.0
    t_sample_us: float = 0.0
    t_prefill_us: float = 0.0
    t_decode_us: float = 0.0
    n_sample: int = 0
    n_prefill: int = 0
    n_decode: int = 0

    def report(self) -> str:
        lines = [f"load time       = {self.t_load_us / 1000:.2f} ms"]
        if self.n_sample:
            lines.append(
                f"sample time     = {self.t_sample_us / 1000:.2f} ms / {self.n_sample} runs"
                f" ({self.t_sample_us / 1000 / max(1, self.n_sample):.2f} ms per token,"
                f" {self.n_sample / max(1e-9, self.t_sample_us / 1e6):.2f} tokens per second)")
        if self.n_prefill:
            lines.append(
                f"batch eval time = {self.t_prefill_us / 1000:.2f} ms / {self.n_prefill} tokens"
                f" ({self.t_prefill_us / 1000 / max(1, self.n_prefill):.2f} ms per token,"
                f" {self.n_prefill / max(1e-9, self.t_prefill_us / 1e6):.2f} tokens per second)")
        if self.n_decode:
            lines.append(
                f"eval time       = {self.t_decode_us / 1000:.2f} ms / {self.n_decode} runs"
                f" ({self.t_decode_us / 1000 / max(1, self.n_decode):.2f} ms per token,"
                f" {self.n_decode / max(1e-9, self.t_decode_us / 1e6):.2f} tokens per second)")
        return "\n".join(lines)


class FalconEngine:
    """Single-model, single-stream inference engine for both model families
    (the model is resolved by hparams.arch; the class keeps the JAX
    engine's name).

    device: None (the default) runs on the CUDA card and raises when CUDA
    is missing; device="cpu" runs the kernels' plain versions on the CPU.
    cfg.kernel_layout / cfg.flash_attention set to False route the
    quantized matmuls / attention through the plain versions on any
    device (the reference path the kernels are held against). On the card
    with flash attention on, a head shape that the decode kernels do not
    take raises here (kernels/flash_decode.py supports). penalize_nl=False
    exempts the newline id of the model family's vocabulary from the
    penalties (tokenizer.nl_id: 193 for Falcon, 13 for LLaMA)."""

    def __init__(self, hparams: FalconHParams | LlamaHParams, params: dict,
                 cfg: EngineConfig | None = None, device=None):
        self.device = resolve_device(device)
        self.hp = hparams
        self.cfg = cfg or EngineConfig()
        self.batch = 1
        self.nl_token = nl_id(hparams.arch)
        if self.device.type == "cuda" and self.cfg.flash_attention is not False:
            G = hparams.n_head // hparams.n_head_kv
            ok, why = flash_decode.supports(hparams.n_head_kv, G, hparams.head_dim,
                                            self.cfg.kv_dtype, self.cfg.compute_dtype)
            if not ok:
                raise NotImplementedError(
                    f"flash-decode kernels: {hparams.n_head} heads over {hparams.n_head_kv} K/V"
                    f" heads, head_dim {hparams.head_dim}, {self.cfg.kv_dtype} cache: {why}"
                    " (EngineConfig(flash_attention=False) runs the plain attention)")
        self.st, model_cls = resolve_model(
            hparams, flash=self.cfg.flash_attention is not False,
            kernels=self.cfg.kernel_layout is not False)
        self.model = model_cls(self.st, params).to(self.device)
        self.inv_freq = torch.from_numpy(rope_angles(
            self.cfg.rope, self.cfg.n_ctx, hparams.head_dim, arch=hparams.arch)).to(self.device)
        self.n_past = 0
        self.kv = self.new_kv()
        self.timings = Timings()

    # ---------------------------------------------------------------- kv

    @property
    def kv_T(self) -> int:
        """KV time dim: n_ctx plus the JAX engine's scratch region, so the
        cache has the same shape in both packages."""
        return self.cfg.n_ctx + max(self.cfg.n_batch, DECODE_CHUNK, self.cfg.decode_chunk)

    def new_kv(self):
        """A zeroed cache: one tensor, or (codes, scales) for kv_dtype "int8"."""
        hp = self.hp
        shape = (hp.n_layer, 2, self.batch, self.kv_T, hp.n_head_kv, hp.head_dim)
        return kvcache.new(shape, self.cfg.kv_dtype, self.device)

    def reset(self):
        self.n_past = 0
        self.kv = self.new_kv()

    # ---------------------------------------------------------------- eval

    @torch.inference_mode()
    def _forward(self, tokens: torch.Tensor, logits_all: bool = False) -> torch.Tensor:
        n = tokens.shape[-1]
        if self.n_past + n > self.cfg.n_ctx:
            raise ValueError("context overflow")
        logits = self.model(tokens.reshape(1, n), self.kv, self.n_past, self.inv_freq,
                            logits_all=logits_all)
        self.n_past += n
        return logits

    def eval(self, tokens, logits_all: bool = False) -> np.ndarray:
        """Evaluate tokens (one sequence) starting at n_past, in n_batch
        chunks like the reference main loop (falcon_main.cpp:820-845).
        Returns logits: (n, n_vocab) when logits_all else (n_vocab,) for the
        final position."""
        tokens = np.asarray(tokens, dtype=np.int64).reshape(-1)
        out = []
        t0 = time.perf_counter()
        for i in range(0, tokens.size, self.cfg.n_batch):
            chunk = torch.from_numpy(tokens[i:i + self.cfg.n_batch]).to(self.device)
            logits = self._forward(chunk, logits_all)
            if logits_all or i + chunk.numel() >= tokens.size:
                out.append(logits[0].float().cpu().numpy())
        dt = (time.perf_counter() - t0) * 1e6
        if tokens.size > 1:
            self.timings.t_prefill_us += dt
            self.timings.n_prefill += tokens.size
        else:
            self.timings.t_decode_us += dt
            self.timings.n_decode += 1
        if logits_all:
            return np.concatenate(out, axis=0)
        return out[-1][0]

    # ------------------------------------------------------------ decoding

    def _ring(self, sampler, first_token: int, last_tokens) -> tuple[torch.Tensor, int]:
        """Device ring of the last repeat_last_n tokens (n_vocab = empty)."""
        L = max(int(sampler.repeat_last_n), 1)
        window = list(last_tokens) if last_tokens else [int(first_token)]
        window = window[-min(L, self.cfg.n_ctx):]
        ring = np.full(L, self.hp.n_vocab, dtype=np.int64)
        ring[:len(window)] = window
        return torch.from_numpy(ring).to(self.device), len(window) % L

    def new_generator(self, sampler) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(sampler.seed if sampler.seed >= 0 else 0)
        return gen

    @torch.inference_mode()
    def decode_chunk(self, first_token: int, n_steps: int, sampler=None,
                     generator: torch.Generator | None = None, last_tokens=None):
        """Run n_steps forward+sample steps starting from first_token
        (already sampled, not yet forwarded). Returns (the n_steps sampled
        successor ids as numpy, the generator); advances n_past by n_steps.

        last_tokens: recent token history ENDING WITH first_token; seeds the
        on-device penalty window. Defaults to just [first_token]."""
        sampler = sampler or sampling.SamplerParams(temp=0.0)
        if self.n_past + n_steps > self.cfg.n_ctx:
            raise ValueError("context overflow")
        spec = sampling_device.penalty_spec(sampler, self.hp.n_vocab, self.nl_token)
        generator = generator or self.new_generator(sampler)
        ring, pos = self._ring(sampler, first_token, last_tokens)
        L = ring.numel()
        out = torch.empty(n_steps, dtype=torch.long, device=self.device)
        tok = torch.tensor([int(first_token)], dtype=torch.long, device=self.device)
        pending = None
        if kvcache.is_quantized(self.kv):  # chunk-deferred: the cache is read-only
            L_, _, B, _, KV, D = self.kv[0].shape
            pending = torch.zeros(L_, 2, B, n_steps, KV, D, device=self.device,
                                  dtype=getattr(torch, self.cfg.compute_dtype))
        t0 = time.perf_counter()
        for j in range(n_steps):
            if pending is None:
                logits = self._forward(tok)[0, 0]
            else:
                logits, kv_new = self.model(tok.reshape(1, 1), self.kv, self.n_past + j,
                                            self.inv_freq, pending=pending, n_pend=j)
                pending[:, :, :, j:j + 1] = kv_new
                logits = logits[0, 0]
            penalized = sampling_device.apply_penalties(logits, ring, spec)
            nxt = sampling_device.sample_logits(penalized, generator, float(sampler.temp),
                                                int(sampler.top_k), float(sampler.top_p))
            ring[(pos + j) % L] = nxt
            out[j] = nxt
            tok = nxt.reshape(1)
        if pending is not None:  # the chunk's one (quantizing) write
            kvcache.write_all_layers(self.kv, pending, self.n_past)
            self.n_past += n_steps
        toks = out.cpu().numpy()
        self.timings.t_decode_us += (time.perf_counter() - t0) * 1e6
        self.timings.n_decode += n_steps
        return toks, generator

    def rollback(self, n_past: int):
        """Roll the logical KV position back (stale cache beyond is masked)."""
        assert 0 <= n_past <= self.n_past
        self.n_past = n_past

    def _sample_host(self, logits: np.ndarray, last_tokens: list, sampler,
                     state: sampling.SamplerState) -> int:
        t0 = time.perf_counter()
        tok = sampling.sample(logits, last_tokens, sampler, state, self.cfg.n_ctx,
                              nl_token=self.nl_token)
        self.timings.t_sample_us += (time.perf_counter() - t0) * 1e6
        self.timings.n_sample += 1
        return tok

    def generate(self, prompt_ids, n_predict: int = 128,
                 sampler: sampling.SamplerParams | None = None,
                 stop_ids: set | None = None, stream=None) -> list[int]:
        """Greedy/sampled generation. Returns generated ids (without prompt).

        Routed as the JAX engine routes (engine.py:1328-1359): the host
        cascade (ops/sampling.py sample) draws the first token after
        prefill; then settings the device cascade covers (device_samplable)
        decode in chunks of cfg.decode_chunk tokens sampled on the device,
        and any other (top_k <= 0 or > 1024 at temp > 0, tfs / typical < 1,
        mirostat) one token at a time through the host cascade, with one
        SamplerState throughout. The last token is not forwarded."""
        sampler = sampler or sampling.SamplerParams()
        stop_ids = stop_ids or set()
        prompt_ids = list(map(int, np.asarray(prompt_ids).reshape(-1)))
        state = sampling.SamplerState.init(sampler)
        logits = self.eval(prompt_ids)
        out = [self._sample_host(logits, prompt_ids, sampler, state)]
        if stream is not None:
            stream(out[0])
        if out[0] in stop_ids:
            return out
        on_device = sampling_device.device_samplable(sampler)
        generator = None
        while len(out) < n_predict:
            if not on_device:
                if self.n_past >= self.cfg.n_ctx:
                    break
                logits = self.eval([out[-1]])
                toks = [self._sample_host(logits, prompt_ids + out, sampler, state)]
            else:
                chunk = min(self.cfg.decode_chunk, n_predict - len(out),
                            self.cfg.n_ctx - self.n_past)
                if chunk <= 0:
                    break
                start = self.n_past
                toks, generator = self.decode_chunk(out[-1], chunk, sampler, generator,
                                                    last_tokens=prompt_ids + out)
                self.timings.n_sample += chunk
            for j, t in enumerate(map(int, toks)):
                out.append(t)
                if stream is not None:
                    stream(t)
                if t in stop_ids:
                    if on_device:  # positions beyond the stop are stale; roll back
                        self.rollback(start + j + 1)
                    return out
        return out
