"""Device resolution: a CUDA request on a host without CUDA raises."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available on "
            "this host; pass device='cpu' to run the plain PyTorch paths")
    return dev
