"""Functional NN primitives shared by the models.

Matmuls run in the parameter dtype (bf16 at inference) with float32
accumulation; normalisations compute their statistics in float32 and cast
back.  Linear parameters are ``{"weight": [out, in], "bias": [out]}``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    """x @ weight.T + bias, output in the input dtype."""
    return F.linear(x, p["weight"], p.get("bias"))


def layer_norm(x: torch.Tensor, eps: float = 1e-6,
               scale: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LayerNorm without affine in float32, cast back; then the optional
    affine in the input dtype."""
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(dtype)
    if scale is not None:
        y = y * scale
    if bias is not None:
        y = y + bias
    return y


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with float32 statistics; the scale is applied in x's dtype."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    scale = torch.rsqrt(var + eps).to(x.dtype)
    return x * scale * weight


def rms_scale(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The elementwise factor of an RMS norm (rsqrt(mean x^2) * w) in
    float32, for fusion into a downstream float32 op (RoPE's premul)."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return torch.rsqrt(var + eps) * weight.float()


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    y = 0.5 * xf * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (xf + 0.044715 * xf ** 3)))
    return y.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x.float()).to(x.dtype)
