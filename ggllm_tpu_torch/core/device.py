"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None -> the CUDA card. Raises when CUDA is asked for and missing:
    the port never falls back to the CPU on its own; pass device="cpu" to
    run the plain versions of the kernels there."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device
