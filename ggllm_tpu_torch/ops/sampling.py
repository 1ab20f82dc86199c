"""Sampler parameters (the fields of ggllm_tpu/ops/sampling.py SamplerParams
that the device cascade reads; the host cascade is not ported)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class SamplerParams:
    """falcon_main sampling knobs (falcon_main.cpp:899-986 defaults)."""

    top_k: int = 40
    top_p: float = 0.95
    temp: float = 0.8
    repeat_penalty: float = 1.1
    repeat_last_n: int = 64
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    penalize_nl: bool = True
    logit_bias: dict = field(default_factory=dict)
    seed: int = -1
