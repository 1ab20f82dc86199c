"""The hand-written CUDA kernels, their plain versions and their torch
library ops (library.py: torch.ops.ggllm.*, defined on import)."""

from ggllm_tpu_torch.kernels import library  # noqa: F401
