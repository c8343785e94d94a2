"""Fused causal conv3d for the streaming VAE decoder.

``fused_causal_conv`` computes ``[RMS-norm + SiLU ->] causal conv3d (kernel
3 x {3,1} x {3,1}, stride 1, SAME spatial) -> + bias [-> + residual]`` over
the virtual frame sequence [2 cache frames ++ T frames], and returns the new
2-frame cache (the last two normalised input frames) beside the output.  On
a CUDA tensor it launches the hand-written Hopper kernel of
``csrc/causal_conv.cu``; on a CPU tensor it runs ``fused_causal_conv_plain``.

Layout: channels-last frames [T, H, W, C] (batch 1, folded out by the
caller); weights in the torch layout [O, C, 3, kh, kw].
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import kernels

launches = 0  # kernel launches of fused_causal_conv since the last reset


def norm_silu(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """silu(rms_norm_channel(x, gamma)) with the kernel's rounding points:
    y = dtype(x / (||x|| + 1e-12) * sqrt(C) * gamma), s = dtype(sigmoid(y)),
    out = y * s in x's dtype.  x: [..., C]."""
    xf = x.float()
    norm = torch.sqrt(xf.square().sum(dim=-1, keepdim=True)) + 1e-12
    y = (xf / norm * math.sqrt(x.shape[-1]) * gamma.float()).to(x.dtype)
    return y * torch.sigmoid(y.float()).to(x.dtype)


def fused_causal_conv_plain(
    x: torch.Tensor, cache: torch.Tensor, w: torch.Tensor,
    b: Optional[torch.Tensor] = None, gamma: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: float32 conv over the
    concatenated [cache ++ normalised x], bias added in float32, one
    rounding to x's dtype, then the residual added in that dtype."""
    xin = norm_silu(x, gamma) if gamma is not None else x
    full = torch.cat([cache.to(x.dtype), xin], dim=0)  # [T+2, H, W, C]
    kh, kw = w.shape[3], w.shape[4]
    y = F.conv3d(full.permute(3, 0, 1, 2)[None].float(), w.float(), None,
                 padding=(0, kh // 2, kw // 2))[0]  # [O, T, H, W]
    y = y.permute(1, 2, 3, 0)
    if b is not None:
        y = y + b.float()
    y = y.to(x.dtype)
    if residual is not None:
        y = y + residual
    return y, full[-2:]


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """[O, C, 3, kh, kw] -> [3, kh, kw, O, C] contiguous: each (tap, row,
    column) slice is an [O, C] block with channels innermost."""
    return w.permute(2, 3, 4, 0, 1).contiguous()


def fused_causal_conv(
    x: torch.Tensor, cache: torch.Tensor, w: torch.Tensor,
    b: Optional[torch.Tensor] = None, gamma: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None, w_packed: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [T, H, W, C]; cache: [2, H, W, C] (the previous two conv input
    frames, normalised when ``gamma`` is given; zeros before the first
    chunk); w: [O, C, 3, kh, kw] with kh, kw in {1, 3}; b: [O]; gamma: [C];
    residual: [T, H, W, O]; w_packed: ``pack_weights(w)``, made once where
    the parameters are built (packed here per call when omitted).  Returns
    (out [T, H, W, O], new_cache [2, H, W, C]).

    CPU tensors run the plain version.  CUDA tensors launch the kernel,
    which takes bf16 x/cache/w/residual, C % 32 == 0 and O % 96 == 0;
    anything else raises ValueError."""
    o, c = int(w.shape[0]), int(w.shape[1])
    kt, kh, kw = (int(s) for s in w.shape[2:])
    if kt != 3 or kh not in (1, 3) or kw not in (1, 3):
        raise ValueError(f"fused_causal_conv: kernel {tuple(w.shape[2:])} unsupported")
    if x.device.type == "cpu":
        return fused_causal_conv_plain(x, cache, w, b, gamma, residual)
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"fused_causal_conv: unsupported device {x.device}")
    t, h, wd, cx = x.shape
    if cx != c or cache.shape != (2, h, wd, c):
        raise ValueError(f"fused_causal_conv: x {tuple(x.shape)} / cache "
                         f"{tuple(cache.shape)} do not match w {tuple(w.shape)}")
    if c % 32 or o % 96:
        raise ValueError(f"fused_causal_conv: needs C % 32 == 0 and O % 96 == 0, "
                         f"got C={c} O={o}")
    if residual is not None and residual.shape != (t, h, wd, o):
        raise ValueError(f"fused_causal_conv: residual {tuple(residual.shape)} "
                         f"!= {(t, h, wd, o)}")
    wp = pack_weights(w) if w_packed is None else w_packed
    if wp.shape != (3, kh, kw, o, c):
        raise ValueError(f"fused_causal_conv: w_packed {tuple(wp.shape)} != {(3, kh, kw, o, c)}")
    bf = None if b is None else b.float().contiguous()
    gf = None if gamma is None else gamma.float().contiguous()
    for name, tt in (("x", x), ("cache", cache), ("w", wp), ("residual", residual)):
        if tt is None:
            continue
        if tt.dtype != torch.bfloat16:
            raise ValueError(f"fused_causal_conv: {name} must be bf16, got {tt.dtype}")
        if not tt.is_contiguous() or tt.data_ptr() % 16 or tt.device != x.device:
            raise ValueError(f"fused_causal_conv: {name} must be contiguous, "
                             f"16-byte aligned and on {x.device}")
    for name, tt, n in (("b", bf, o), ("gamma", gf, c)):
        if tt is not None and (tt.shape != (n,) or tt.device != x.device):
            raise ValueError(f"fused_causal_conv: {name} must be [{n}] on {x.device}")
    out = torch.empty((t, h, wd, o), dtype=x.dtype, device=x.device)
    nx = torch.empty_like(cache)
    ptr = lambda a: None if a is None else a.data_ptr()
    lib = kernels.load("causal_conv")
    fn = lib.longlive_causal_conv
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    rc = fn(x.data_ptr(), cache.data_ptr(), wp.data_ptr(), ptr(bf), ptr(gf),
            ptr(residual), out.data_ptr(), nx.data_ptr(), t, h, wd, c, o, kh, kw,
            torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(lib, rc, "fused_causal_conv")
    launches += 1
    return out, nx
