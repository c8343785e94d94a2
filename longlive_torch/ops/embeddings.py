"""Timestep embeddings."""

from __future__ import annotations

import torch


def sinusoidal_embedding_1d(dim: int, position: torch.Tensor) -> torch.Tensor:
    """[cos | sin] sinusoidal embedding, cos first.

    position: any-shaped tensor of (possibly fractional) timesteps.
    Returns [..., dim] float32.
    """
    assert dim % 2 == 0
    half = dim // 2
    pos = torch.as_tensor(position, dtype=torch.float32)
    freqs = torch.pow(torch.tensor(10000.0, device=pos.device),
                      -torch.arange(half, dtype=torch.float32, device=pos.device) / half)
    sinusoid = pos[..., None] * freqs
    return torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=-1)
