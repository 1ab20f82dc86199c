"""Model-family registry: one engine, two decoder architectures (port of
ggllm_tpu/models/__init__.py)."""

from __future__ import annotations


def resolve_model(hparams, flash: bool = True, kernels: bool = True):
    """hparams -> (Static, nn.Module class) for the engine, by hparams.arch."""
    if getattr(hparams, "arch", "falcon") == "llama":
        from ggllm_tpu_torch.models.llama import Llama, LlamaStatic

        return LlamaStatic.from_hparams(hparams, flash=flash, kernels=kernels), Llama
    from ggllm_tpu_torch.models.falcon import Falcon, FalconStatic

    return FalconStatic.from_hparams(hparams, flash=flash, kernels=kernels), Falcon
