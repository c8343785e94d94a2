"""Attention for the causal DiT.

- ``flash_attention``: self-attention of a block's queries over one layer of
  the KV cache with an additive float32 bias per KV token (0 = attend,
  -1e30 = masked).  On a CUDA tensor it launches the hand-written Hopper
  kernel of ``csrc/flash_attention.cu``; on a CPU tensor it runs
  ``flash_attention_plain``, the same arithmetic in plain PyTorch.  Two
  modes: ``bias`` (q arrives roped) and ``q_rope`` (q arrives un-roped and
  the kernel applies the halfsplit rotation, with the softmax scale folded
  in, while it stages the q tile).
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
mode_launches = {"bias": 0, "q_rope": 0}  # the same launches, by mode


def reset_launches() -> None:
    global launches
    launches = 0
    for mode in mode_launches:
        mode_launches[mode] = 0


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


def rope_scaled_q(q: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """The q_rope prologue: ``bf16(q * cs + swap(q) * sn)`` in float32 with
    ``cs = scale * [cos ++ cos]``, ``sn = scale * [-sin ++ sin]`` and
    ``swap`` exchanging the two halves of the head dim (the halfsplit
    rotation with the softmax scale folded in), rounded to q's dtype.

    q: [B, Sq, N, D]; cos, sin: [Sq, D/2] float32, shared by every head."""
    half = q.shape[-1] // 2
    rc, rs = cos.float() * scale, sin.float() * scale
    cs = torch.cat([rc, rc], dim=-1)[None, :, None, :]
    sn = torch.cat([-rs, rs], dim=-1)[None, :, None, :]
    qf = q.float()
    qsw = torch.cat([qf[..., half:], qf[..., :half]], dim=-1)
    return (qf * cs + qsw * sn).to(q.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor, q_rope=None) -> torch.Tensor:
    """The kernel's arithmetic: q is pre-scaled by 1/sqrt(D) (and, with
    ``q_rope``, rotated: ``rope_scaled_q``) and rounded to its dtype, logits
    are float32 plus the bias, P is rounded to V's dtype before PV, and the
    output is divided by the float32 row sum at the end.  One head at a
    time, so the logits of a 12-frame recache (18720 x 18720) stay ~1.4 GB.

    q: [B, Sq, N, D]; k, v: [B*N, S, D]; bias: [B, S] float32."""
    b, sq, n, d = q.shape
    scale = 1.0 / math.sqrt(d)
    if q_rope is None:
        qs = (q.float() * scale).to(q.dtype)
    else:
        qs = rope_scaled_q(q, q_rope[0], q_rope[1], scale)
    qh = qs.permute(0, 2, 1, 3).reshape(b * n, sq, d)
    out = torch.empty((b * n, sq, d), dtype=torch.float32, device=q.device)
    for bh in range(b * n):
        logits = qh[bh].float() @ k[bh].float().T + bias[bh // n].float()  # [Sq, S]
        m = logits.amax(dim=-1, keepdim=True)
        p = torch.exp(logits - m)
        lsum = p.sum(dim=-1, keepdim=True)
        out[bh] = (p.to(v.dtype).float() @ v[bh].float()) / lsum
    return out.view(b, n, sq, d).permute(0, 2, 1, 3).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, q_rope=None) -> torch.Tensor:
    """Attention of q [B, Sq, N, D] over one cache layer k, v [B*N, S, D]
    with bias [B, S] float32.  Returns [B, Sq, N, D] in q's dtype.

    ``q_rope=(cos, sin)``, each [Sq, D/2] float32: q is un-roped (the RMS
    premul already applied) and is rotated in the kernel (halfsplit
    layout; see ``rope_scaled_q``).

    CPU tensors run the plain version.  CUDA tensors launch the kernel,
    which takes bf16 q/k/v, D = 128, contiguous 16-byte-aligned operands
    and a float32 bias; anything else raises ValueError."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias, q_rope)
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
    cos_ptr = sin_ptr = None
    if q_rope is not None:
        for name, t in zip(("cos", "sin"), q_rope):
            if (t.dtype != torch.float32 or t.shape != (sq, d // 2) or not t.is_contiguous()
                    or t.data_ptr() % 16 or t.device != q.device):
                raise ValueError(f"flash_attention: q_rope {name} must be contiguous, "
                                 f"16-byte aligned float32 [{sq}, {d // 2}] on {q.device}, got "
                                 f"{t.dtype} {tuple(t.shape)} on {t.device}")
        cos_ptr, sin_ptr = q_rope[0].data_ptr(), q_rope[1].data_ptr()
    out = torch.empty_like(q)
    lib = kernels.load("flash_attention")
    fn = lib.longlive_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                                ctypes.c_void_p]
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), cos_ptr, sin_ptr,
            out.data_ptr(), b, sq, n, s, 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(lib, rc, "flash_attention")
    launches += 1
    mode_launches["bias" if q_rope is None else "q_rope"] += 1
    return out
