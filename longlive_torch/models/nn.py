"""Functional NN primitives shared by the models.

Matmuls run in the parameter dtype (bf16 at inference) with float32
accumulation; normalisations compute their statistics in float32 and cast
back.  Linear parameters are ``{"weight": [out, in], "bias": [out]}``.
Training keeps float32 parameters and runs under ``torch.autocast`` on the
GPU: linears then take bf16 operands, and RMS norms return their input's
(bf16) dtype.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops import quant


def lora_weight(w: torch.Tensor, lora_a: torch.Tensor, lora_b: torch.Tensor,
                scale: float) -> torch.Tensor:
    """W0 + scale B A: the product and the sum in float32 (outside any
    autocast region), rounded once to W0's dtype."""
    with torch.autocast(w.device.type, enabled=False):
        return (w.float() + scale * (lora_b.float() @ lora_a.float())).to(w.dtype)


def linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    """x @ weight.T + bias, output in the input dtype.  Linears quantized by
    ``ops.quant.quantize_dit_params`` (``w_int8``) take the int8 route:
    ``LONGLIVE_INT8_FUSED`` set and not ``0`` (read at call time) selects
    the fused kernel, otherwise the separate-quantize route.

    A linear with LoRA adapters (``training.lora.attach_lora``: ``lora_a``
    [r, in], ``lora_b`` [out, r], ``lora_s``) runs one GEMM on
    ``lora_weight``, the merged weight of this layer only (the JAX
    package's delta-first form); its backward keeps that layer's weight as
    the GEMM's operand and hands the adapters their gradients."""
    if "w_int8" in p:
        if os.environ.get("LONGLIVE_INT8_FUSED", "0") != "0":
            return quant.linear_int8_fused(x, p)
        return quant.linear_int8(x, p)
    w = p["weight"]
    if "lora_a" in p:
        w = lora_weight(w, p["lora_a"], p["lora_b"], p["lora_s"])
    return F.linear(x, w, p.get("bias"))


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
    """RMSNorm with float32 statistics; the scale and the weight are applied
    in x's dtype."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    scale = torch.rsqrt(var + eps).to(x.dtype)
    return x * scale * weight.to(x.dtype)


def rms_scale(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The elementwise factor of an RMS norm (rsqrt(mean x^2) * w) in
    float32, for fusion into a downstream float32 op (RoPE's premul)."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return torch.rsqrt(var + eps) * weight.float()


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))), computed in float32
    and rounded to x's dtype (PyTorch's kernel upcasts bf16), saving only
    its input for backward."""
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x.float()).to(x.dtype)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """The exact (erf) GELU in float32, rounded to x's dtype: the DiT's
    image projection (``img_emb``) and the CLIP towers."""
    return F.gelu(x.float()).to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x) in float32, rounded to x's dtype."""
    xf = x.float()
    return (xf * torch.sigmoid(1.702 * xf)).to(x.dtype)
