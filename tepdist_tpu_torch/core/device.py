"""Device choice for the port's entry points: the card unless the caller
asks for the CPU, and never a silent fall back from one to the other."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and no CUDA
    device is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU with the kernels' plain PyTorch versions")
    return dev
