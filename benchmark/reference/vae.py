"""Plain float32 reference of the Wan2.1 VAE decoder (``Decoder3d`` of
Wan's ``vae.py``), streaming one latent frame per call with its causal
conv caches.

It imports torch only.  Weights are the benchmark's (``benchmark.weights``):
convs ``{"w": [O, C, kt, kh, kw], "b": [O]}``, norms a gamma vector.  The
caches are a list in decoder traversal order, each the last two input
frames of a causal conv, channels-last [B, 2, H, W, C] (the streaming
decoder's state: the list a live decoder keeps between frames).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

CACHE_T = 2


def _norm(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """Wan's RMS_norm over channels (dim 1): normalize * sqrt(C) * gamma."""
    c = x.shape[1]
    shape = (1, c) + (1,) * (x.dim() - 2)
    return F.normalize(x, dim=1) * math.sqrt(c) * gamma.float().reshape(shape)


class _Caches:
    """The conv caches in traversal order: ``take`` the next one, ``put``
    its successor.  ``None`` = the first latent frame of a video."""

    def __init__(self, caches: List[torch.Tensor]):
        self.old = caches
        self.idx = 0
        self.new: List[torch.Tensor] = []

    def take(self) -> torch.Tensor:
        c = self.old[self.idx]
        self.idx += 1
        return c

    def put(self, c: torch.Tensor) -> None:
        self.new.append(c)


def _to_cf(c: torch.Tensor) -> torch.Tensor:
    """[B, T, H, W, C] -> [B, C, T, H, W] float32."""
    return c.float().permute(0, 4, 1, 2, 3)


def _to_cl(c: torch.Tensor) -> torch.Tensor:
    return c.permute(0, 2, 3, 4, 1).contiguous()


def causal_conv(x: torch.Tensor, p: dict, caches: Optional[_Caches]) -> torch.Tensor:
    """Wan's CausalConv3d: x [B, C, T, H, W]; the time axis is padded with
    the cached last two input frames, space with SAME zeros."""
    w = p["w"].float()
    kt, kh, kw = w.shape[2:]
    if kt > 1:
        full = torch.cat([_to_cf(caches.take()), x], dim=2)
        caches.put(_to_cl(full[:, :, -CACHE_T:]))
    else:
        full = x
    return F.conv3d(full, w, p["b"].float(), padding=(0, kh // 2, kw // 2))


def res_block(x: torch.Tensor, p: dict, caches: _Caches) -> torch.Tensor:
    h = x if p.get("shortcut") is None else causal_conv(x, p["shortcut"], None)
    y = causal_conv(F.silu(_norm(x, p["norm1"])), p["conv1"], caches)
    y = causal_conv(F.silu(_norm(y, p["norm2"])), p["conv2"], caches)
    return y + h


def attn_block(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Single-head attention over each frame's pixels."""
    b, c, t, h, w = x.shape
    y = _norm(x, p["norm"]).permute(0, 2, 3, 4, 1).reshape(b * t, h * w, c)
    qkv = y @ p["qkv"]["w"].float().reshape(3 * c, c).t() + p["qkv"]["b"].float()
    q, k, v = qkv.split(c, dim=-1)
    o = torch.softmax((q @ k.transpose(1, 2)) / math.sqrt(c), dim=-1) @ v
    o = o @ p["proj"]["w"].float().reshape(c, c).t() + p["proj"]["b"].float()
    return x + o.reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)


def upsample(x: torch.Tensor, p: dict, caches: _Caches, temporal: bool,
             first: bool) -> torch.Tensor:
    """Wan's Resample 'upsample3d' / 'upsample2d'.  The first latent frame
    skips the time conv (its cache becomes zeros, Wan's 'Rep')."""
    if temporal:
        if first:
            old = caches.take()
            caches.put(torch.zeros_like(old))
        else:
            y = causal_conv(x, p["time_conv"], caches)  # [B, 2C, T, H, W]
            b, c2, t, h, w = y.shape
            y = y.reshape(b, 2, c2 // 2, t, h, w)
            x = torch.stack((y[:, 0], y[:, 1]), 3).reshape(b, c2 // 2, t * 2, h, w)
    b, c, t, h, w = x.shape
    z = x.permute(0, 2, 1, 3, 4).reshape(b * t, c, h, w)
    z = F.interpolate(z, scale_factor=2.0, mode="nearest-exact")
    z = F.conv2d(z, p["conv"]["w"].float(), p["conv"]["b"].float(), padding=1)
    return z.reshape(b, t, z.shape[1], 2 * h, 2 * w).permute(0, 2, 1, 3, 4)


def decode_frame(params: dict, cfg: dict, z: torch.Tensor, caches: List[torch.Tensor],
                 first: bool) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One latent frame z [B, 1, z_dim, h, w] (normalised) -> (pixels
    [B, 1 or 4, 3, H, W] in [-1, 1], the next caches)."""
    mean = params["mean"].float().reshape(1, -1, 1, 1, 1)
    std = params["std"].float().reshape(1, -1, 1, 1, 1)
    x = z.float().permute(0, 2, 1, 3, 4) * std + mean
    x = causal_conv(x, params["conv2"], None)
    d = params["decoder"]
    cc = _Caches(caches)
    x = causal_conv(x, d["conv1"], cc)
    x = res_block(x, d["middle"][0], cc)
    x = attn_block(x, d["middle"][1])
    x = res_block(x, d["middle"][2], cc)
    mult = cfg["dim_mult"]
    ups = list(reversed(cfg["temperal_downsample"]))
    bi = 0
    for i in range(len(mult)):
        for _ in range(cfg["num_res_blocks"] + 1):
            x = res_block(x, d["upsamples"][bi], cc)
            bi += 1
        if i != len(mult) - 1:
            x = upsample(x, d["upsamples"][bi], cc, ups[i], first)
            bi += 1
    x = causal_conv(F.silu(_norm(x, d["head_norm"])), d["head_conv"], cc)
    return torch.clamp(x, -1.0, 1.0).permute(0, 2, 1, 3, 4), cc.new


def zero_caches(cfg: dict, b: int, h: int, w: int, device) -> List[torch.Tensor]:
    """The caches before a video's first frame, in traversal order."""
    dims = [cfg["dim"] * u for u in (cfg["dim_mult"][-1],) + tuple(reversed(cfg["dim_mult"]))]
    shapes = [(cfg["z_dim"], h, w)] + [(dims[0], h, w)] * 4
    ups = list(reversed(cfg["temperal_downsample"]))
    hh, ww, in_dim = h, w, dims[0]
    for i in range(len(cfg["dim_mult"])):
        out_dim = dims[i + 1]
        if i >= 1:
            in_dim //= 2
        for _ in range(cfg["num_res_blocks"] + 1):
            shapes += [(in_dim, hh, ww), (out_dim, hh, ww)]
            in_dim = out_dim
        if i != len(cfg["dim_mult"]) - 1:
            if ups[i]:
                shapes.append((out_dim, hh, ww))
            hh, ww = 2 * hh, 2 * ww
    shapes.append((dims[-1], hh, ww))
    return [torch.zeros((b, CACHE_T, sh, sw, c), device=device) for c, sh, sw in shapes]


def decode(params: dict, cfg: dict, latents: torch.Tensor, caches: Optional[List[torch.Tensor]],
           first: bool) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Latent frames [B, T, z, h, w] one at a time; ``caches`` None starts a
    video (``first`` then True)."""
    b, t, _, h, w = latents.shape
    if caches is None:
        caches = zero_caches(cfg, b, h, w, latents.device)
    outs = []
    for i in range(t):
        px, caches = decode_frame(params, cfg, latents[:, i:i + 1], caches, first and i == 0)
        outs.append(px)
    return torch.cat(outs, dim=1), caches
