"""Attention for the causal DiT.

- ``flash_attention``: self-attention of a block's queries over one layer of
  the KV cache with an additive float32 bias per KV token (0 = attend,
  -1e30 = masked).  On a CUDA tensor it launches the hand-written Hopper
  kernel of ``csrc/flash_attention.cu``; on a CPU tensor it runs
  ``flash_attention_plain``, the same arithmetic in plain PyTorch.
- ``dense_attention``: plain softmax attention, used for cross-attention
  (the text context is only 512 tokens).

Layout: q and the output are [B, Sq, N, D]; K and V are one layer's rows of
the cache, [B*N, S, D] (head-major, token rows contiguous).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import kernels

NEG_INF = -1e30  # finite: -inf - -inf would poison the running max with NaN

launches = 0  # kernel launches of flash_attention since the last reset


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + bias) v with float32 logits.

    q: [B, Sq, N, D]; k, v: [B, Skv, N, D]; bias broadcastable to
    [B, N, Sq, Skv]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bsnd,btnd->bnst", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnst,btnd->bsnd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic: q is pre-scaled by 1/sqrt(D) and rounded to
    its dtype, logits are float32 plus the bias, P is rounded to V's dtype
    before PV, and the output is divided by the float32 row sum at the end.

    q: [B, Sq, N, D]; k, v: [B*N, S, D]; bias: [B, S] float32."""
    b, sq, n, d = q.shape
    s = k.shape[1]
    qs = (q.float() * (1.0 / math.sqrt(d))).to(q.dtype)
    qh = qs.permute(0, 2, 1, 3).reshape(b * n, sq, d)
    logits = torch.bmm(qh.float(), k.float().transpose(1, 2))  # [B*N, Sq, S]
    logits = logits.view(b, n, sq, s) + bias.float()[:, None, None, :]
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    lsum = p.sum(dim=-1, keepdim=True)
    pv = torch.bmm(p.to(v.dtype).reshape(b * n, sq, s).float(), v.float())
    out = pv.view(b, n, sq, d) / lsum
    return out.permute(0, 2, 1, 3).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """Attention of q [B, Sq, N, D] over one cache layer k, v [B*N, S, D]
    with bias [B, S] float32.  Returns [B, Sq, N, D] in q's dtype.

    CPU tensors run the plain version.  CUDA tensors launch the kernel,
    which takes bf16 q/k/v, D = 128, contiguous 16-byte-aligned operands
    and a float32 bias; anything else raises ValueError."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias)
    global launches
    b, sq, n, d = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention: {name} must be bf16, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous and "
                             "16-byte aligned")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on {q.device}")
    if d != 128:
        raise ValueError(f"flash_attention: head dim {d} unsupported (kernel takes 128)")
    s = k.shape[1]
    if k.shape != (b * n, s, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k/v must be [B*N, S, D] = "
                         f"[{b * n}, S, {d}], got {tuple(k.shape)} / {tuple(v.shape)}")
    if (bias.dtype != torch.float32 or bias.shape != (b, s)
            or not bias.is_contiguous() or bias.device != q.device):
        raise ValueError(f"flash_attention: bias must be contiguous float32 [{b}, {s}] "
                         f"on {q.device}, got {bias.dtype} {tuple(bias.shape)}")
    out = torch.empty_like(q)
    lib = kernels.load("flash_attention")
    fn = lib.longlive_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                                ctypes.c_void_p]
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, sq, n, s, 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(lib, rc, "flash_attention")
    launches += 1
    return out
