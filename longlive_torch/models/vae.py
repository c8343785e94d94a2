"""Causal 3D-conv video VAE (Wan2.1), streaming decoder.

- ``CausalConv3d``: temporal causality = prepend the cached last two input
  frames (zeros initially); spatial padding is symmetric SAME.
- Temporal upsampling: the first latent frame bypasses the time conv
  ('Rep') and maps to one pixel frame; every later latent frame maps to 4.
- Caches are an explicit list threaded through the decoder in traversal
  order (``_CacheThread``); the decoder runs one latent frame per call.
- Activations are channels-last [B, T, H, W, C].  The wide causal convs of
  the residual blocks and the time convs go to ``ops.vae_conv``'s fused
  kernel (its int8 variant under ``LONGLIVE_VAE_INT8=1``); the narrow convs
  (decoder conv1 16->384, head 96->3, the 1x1x1 convs, the 2-D resample
  convs) are plain ``F.conv3d`` / ``F.conv2d``.
- ``LONGLIVE_VAE_PAIR=1`` (read at call time, as in the JAX package): each
  no-shortcut residual block runs as ONE ``ops.vae_conv.fused_res_block``
  kernel (both convs, conv1's normalised output kept on chip) instead of
  two fused convs; off under ``LONGLIVE_VAE_INT8=1``.

Geometry (dim 96, z 16, dim_mult [1, 2, 4, 4], 2 res blocks, temporal
downsample [False, True, True]) is Wan2.1's.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import nn
from ..ops import vae_conv as _vc

CACHE_T = 2

WAN_LATENT_MEAN = [
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
]
WAN_LATENT_STD = [
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
]


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temperal_downsample: Tuple[bool, ...] = (False, True, True)

    @property
    def temperal_upsample(self) -> Tuple[bool, ...]:
        return tuple(reversed(self.temperal_downsample))


def tiny_vae_config() -> VAEConfig:
    return VAEConfig(dim=8, z_dim=4, dim_mult=(1, 2), num_res_blocks=1,
                     temperal_downsample=(True,))


# ---------------------------------------------------------------------------
# primitive ops


def conv3d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [B, T, H, W, C] channels-last; w: [O, C, kt, kh, kw].  No temporal
    padding (the caller prepends caches), SAME spatial padding."""
    kh, kw = w.shape[3], w.shape[4]
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.to(x.dtype),
                 None if b is None else b.to(x.dtype), padding=(0, kh // 2, kw // 2))
    return y.permute(0, 2, 3, 4, 1)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [N, H, W, C]; w: [O, C, kh, kw]; SAME padding."""
    kh, kw = w.shape[2:]
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype),
                 None if b is None else b.to(x.dtype), padding=(kh // 2, kw // 2))
    return y.permute(0, 2, 3, 1)


def rms_norm_channel(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """F.normalize over channels * sqrt(C) * gamma; x: [..., C]."""
    xf = x.float()
    norm = torch.sqrt(xf.square().sum(dim=-1, keepdim=True)) + 1e-12
    y = xf / norm * math.sqrt(x.shape[-1])
    return (y * gamma.float()).to(x.dtype)


class _CacheThread:
    """Threads the conv caches through the decoder in traversal order."""

    def __init__(self, caches: Optional[List[Any]]):
        self.caches = list(caches) if caches is not None else None
        self.idx = 0
        self.out: List[Any] = []

    def pull(self):
        if self.caches is None:
            return None
        c = self.caches[self.idx]
        self.idx += 1
        return c

    def push(self, new):
        self.out.append(new)


def _fusable_weight(w: torch.Tensor) -> bool:
    """Kernel (3,3,3) or (3,1,1) and both widths >= 96: the convs the fused
    causal-conv kernel takes.  The narrow convs stay on the plain path."""
    return (w.dim() == 5 and tuple(w.shape[2:]) in ((3, 3, 3), (3, 1, 1))
            and w.shape[0] >= 96 and w.shape[1] >= 96)


def _fusable(x: torch.Tensor, p: dict, thread: _CacheThread) -> bool:
    """True where the fused kernel takes the conv: streaming (cached) mode,
    batch 1, a fusable weight."""
    if thread.caches is None or x.shape[0] != 1:
        return False
    return _fusable_weight(p["w"])


# the norm whose gamma the int8 weights of a conv fold in
_NORM_OF = {"conv1": "norm1", "conv2": "norm2", "head_conv": "head_norm"}


def pack_fused_weights(params: Any) -> Any:
    """Adds the fused kernel's weights beside ``w`` in every conv it takes:
    ``w_packed`` (``ops.vae_conv.pack_weights``) and ``w_int8``
    (``pack_weights_int8`` with the gamma of the norm in front of the conv,
    for ``LONGLIVE_VAE_INT8=1``), so decoding packs no weights.  Mutates
    and returns ``params``; call it again after replacing a ``w`` or a
    norm."""
    if isinstance(params, dict):
        for key, v in params.items():
            w = v.get("w") if isinstance(v, dict) else None
            if isinstance(w, torch.Tensor) and _fusable_weight(w):
                v["w_packed"] = _vc.pack_weights(w)
                v["w_int8"] = _vc.pack_weights_int8(w, params.get(_NORM_OF.get(key)))
        for v in params.values():
            if isinstance(v, (dict, list)):
                pack_fused_weights(v)
    elif isinstance(params, list):
        for v in params:
            pack_fused_weights(v)
    return params


def _fused_conv(x, p, thread: _CacheThread, gamma=None, residual=None):
    cache = thread.pull().to(x.dtype)
    out, nx = _vc.fused_causal_conv(
        x[0], cache[0], p["w"], p.get("b"), gamma,
        None if residual is None else residual[0], w_packed=p.get("w_packed"),
        w_int8=p.get("w_int8"))
    thread.push(nx[None])
    return out[None]


def causal_conv3d(x: torch.Tensor, p: dict, thread: _CacheThread) -> torch.Tensor:
    """CausalConv3d with its 2-frame input cache; uncached mode zero-pads."""
    kt = p["w"].shape[2]
    cache = thread.pull()
    if kt == 1:
        if thread.caches is not None:
            thread.push(cache)  # a 1-frame kernel has no temporal context
        return conv3d(x, p["w"], p.get("b"))
    if thread.caches is None:
        xt = F.pad(x, (0, 0, 0, 0, 0, 0, kt - 1, 0))
        return conv3d(xt, p["w"], p.get("b"))
    full = torch.cat([cache.to(x.dtype), x], dim=1)
    thread.push(full[:, -CACHE_T:])
    return conv3d(full, p["w"], p.get("b"))


def norm_silu_causal_conv(x, gamma, p, thread: _CacheThread, residual=None):
    """silu(rms_norm_channel(x, gamma)) -> causal conv3d [-> + residual]."""
    if _fusable(x, p, thread):
        return _fused_conv(x, p, thread, gamma=gamma, residual=residual)
    y = nn.silu(rms_norm_channel(x, gamma))
    y = causal_conv3d(y, p, thread)
    if residual is not None:
        y = y + residual
    return y


# ---------------------------------------------------------------------------
# blocks


def _pair_fusable(x, p, thread: _CacheThread) -> bool:
    """True when ``fused_res_block`` takes the whole block:
    ``LONGLIVE_VAE_PAIR=1`` without ``LONGLIVE_VAE_INT8=1``, no shortcut,
    both convs with a bias, both [C, C, 3, 3, 3] and each taken by the
    fused conv on its own (streaming, batch 1, C >= 96)."""
    if os.environ.get("LONGLIVE_VAE_PAIR", "0") != "1":
        return False
    if os.environ.get("LONGLIVE_VAE_INT8", "0") == "1":
        return False  # the pair kernel is bf16 only
    if p.get("shortcut") is not None:
        return False
    if p["conv1"].get("b") is None or p["conv2"].get("b") is None:
        return False
    if not (_fusable(x, p["conv1"], thread) and _fusable(x, p["conv2"], thread)):
        return False
    c = p["conv1"]["w"].shape[1]
    return all(tuple(p[k]["w"].shape) == (c, c, 3, 3, 3) for k in ("conv1", "conv2"))


def res_block(x, p, thread: _CacheThread):
    if _pair_fusable(x, p, thread):
        c1, c2 = (thread.pull().to(x.dtype) for _ in range(2))
        out, n1, n2 = _vc.fused_res_block(
            x[0], c1[0], c2[0], p["conv1"]["w"], p["conv1"]["b"], p["norm1"],
            p["conv2"]["w"], p["conv2"]["b"], p["norm2"],
            w1_packed=p["conv1"].get("w_packed"), w2_packed=p["conv2"].get("w_packed"))
        thread.push(n1[None])
        thread.push(n2[None])
        return out[None]
    h = x
    if p.get("shortcut") is not None:
        h = causal_conv3d(x, p["shortcut"], _CacheThread(None))  # 1x1x1
    y = norm_silu_causal_conv(x, p["norm1"], p["conv1"], thread)
    return norm_silu_causal_conv(y, p["norm2"], p["conv2"], thread, residual=h)


def attention_block(x, p):
    """Single-head per-frame spatial attention; the 1x1 qkv/proj convs are
    matmuls.  Plain PyTorch with float32 logits."""
    b, t, h, w, c = x.shape
    identity = x
    y = rms_norm_channel(x, p["norm"]).reshape(b * t, h * w, c)
    wq = p["qkv"]["w"].reshape(3 * c, c)
    qkv = (torch.matmul(y.float(), wq.float().t()) + p["qkv"]["b"].float()).to(y.dtype)
    q, k, v = qkv.split(c, dim=-1)
    logits = torch.matmul(q.float(), k.float().transpose(1, 2))
    probs = torch.softmax(logits / math.sqrt(c), dim=-1).to(v.dtype)
    o = torch.matmul(probs, v)
    wp = p["proj"]["w"].reshape(c, c)
    o = (torch.matmul(o.float(), wp.float().t()) + p["proj"]["b"].float()).to(o.dtype)
    return o.reshape(b, t, h, w, c) + identity


def _interleave_time(y: torch.Tensor) -> torch.Tensor:
    """[B, T, H, W, 2C] -> [B, 2T, H, W, C]: the two channel halves become
    consecutive frames."""
    b, t, h, w, c2 = y.shape
    c = c2 // 2
    return y.reshape(b, t, h, w, 2, c).permute(0, 1, 4, 2, 3, 5).reshape(b, t * 2, h, w, c)


def resample_up(x, p, thread: _CacheThread, temporal: bool, first_frame: bool):
    """Temporal (time conv + interleave) then spatial (nearest 2x + 3x3 conv)
    upsampling.  In streaming mode the first latent frame skips the time
    conv and primes its cache with zeros."""
    if temporal:
        if thread.caches is not None:
            if first_frame:
                thread.push(torch.zeros_like(thread.pull()))
            elif _fusable(x, p["time_conv"], thread):
                x = _interleave_time(_fused_conv(x, p["time_conv"], thread))
            else:
                cache = thread.pull()
                full = torch.cat([cache.to(x.dtype), x], dim=1)
                thread.push(full[:, -CACHE_T:])
                x = _interleave_time(conv3d(full, p["time_conv"]["w"], p["time_conv"]["b"]))
        else:
            xt = F.pad(x, (0, 0, 0, 0, 0, 0, 2, 0))
            x = _interleave_time(conv3d(xt, p["time_conv"]["w"], p["time_conv"]["b"]))
    b, t, h, w, c = x.shape
    up = x.reshape(b * t, h, w, c).repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    y = conv2d(up, p["conv"]["w"], p["conv"]["b"])
    return y.reshape(b, t, 2 * h, 2 * w, y.shape[-1])


# ---------------------------------------------------------------------------
# decoder


def decoder_apply(params, cfg: VAEConfig, z, caches, first_frame: bool):
    """Decoder3d over a chunk of latent frames.  z: [B, T, h, w, z_dim].
    Returns ([B, T_out, H, W, 3], caches')."""
    thread = _CacheThread(caches)
    x = causal_conv3d(z, params["conv1"], thread)
    x = res_block(x, params["middle"][0], thread)
    x = attention_block(x, params["middle"][1])
    x = res_block(x, params["middle"][2], thread)
    ups = cfg.temperal_upsample
    bi = 0
    for i in range(len(cfg.dim_mult)):
        for _ in range(cfg.num_res_blocks + 1):
            x = res_block(x, params["upsamples"][bi], thread)
            bi += 1
        if i != len(cfg.dim_mult) - 1:
            x = resample_up(x, params["upsamples"][bi], thread, ups[i], first_frame)
            bi += 1
    x = norm_silu_causal_conv(x, params["head_norm"], params["head_conv"], thread)
    return x, (thread.out if caches is not None else None)


def decoder_cache_shapes(cfg: VAEConfig, b, h, w) -> List[Tuple[int, ...]]:
    """Cache shapes in decoder traversal order; h, w are LATENT dims."""
    dims = [cfg.dim * u for u in (cfg.dim_mult[-1],) + tuple(reversed(cfg.dim_mult))]
    shapes: List[Tuple[int, ...]] = []

    def conv_cache(c, hh, ww):
        shapes.append((b, CACHE_T, hh, ww, c))

    def res_caches(c_in, c_out, hh, ww):
        conv_cache(c_in, hh, ww)   # res conv1 input
        conv_cache(c_out, hh, ww)  # res conv2 input

    conv_cache(cfg.z_dim, h, w)  # decoder conv1
    res_caches(dims[0], dims[0], h, w)  # middle res0
    res_caches(dims[0], dims[0], h, w)  # middle res1
    ups = cfg.temperal_upsample
    hh, ww = h, w
    in_dim = dims[0]
    for i in range(len(cfg.dim_mult)):
        out_dim = dims[i + 1]
        if i >= 1:
            in_dim = in_dim // 2
        for _ in range(cfg.num_res_blocks + 1):
            res_caches(in_dim, out_dim, hh, ww)
            in_dim = out_dim
        if i != len(cfg.dim_mult) - 1:
            if ups[i]:
                conv_cache(out_dim, hh, ww)  # time conv (pre-upsample)
            hh, ww = hh * 2, ww * 2
    conv_cache(dims[-1], hh, ww)  # head conv
    return shapes


def init_decoder_caches(cfg: VAEConfig, batch, height, width, dtype=torch.float32,
                        device="cpu"):
    """Zero caches for streaming decode; height/width are LATENT dims."""
    return [torch.zeros(s, dtype=dtype, device=device)
            for s in decoder_cache_shapes(cfg, batch, height, width)]


# ---------------------------------------------------------------------------
# parameters


def init_vae_params(cfg: VAEConfig = VAEConfig(), dtype=torch.float32, device="cpu",
                    seed: int = 0) -> dict:
    """Random decoder-side parameters (decoder + the 1x1x1 ``conv2`` + the
    latent mean/std): convs U(-1/sqrt(fan_in), 1/sqrt(fan_in)), norms ones,
    the attention projection zero."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def uni(shape, std):
        return ((torch.rand(shape, generator=gen, device=device) * 2 - 1) * std).to(dtype)

    def conv(c_in, c_out, k):
        k = (k, k, k) if isinstance(k, int) else k
        std = 1.0 / math.sqrt(c_in * math.prod(k))
        return {"w": uni((c_out, c_in) + tuple(k), std), "b": uni((c_out,), std)}

    def conv2(c_in, c_out, k):
        std = 1.0 / math.sqrt(c_in * k * k)
        return {"w": uni((c_out, c_in, k, k), std), "b": uni((c_out,), std)}

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    def res(c_in, c_out):
        return {"norm1": ones(c_in), "conv1": conv(c_in, c_out, 3),
                "norm2": ones(c_out), "conv2": conv(c_out, c_out, 3),
                "shortcut": conv(c_in, c_out, 1) if c_in != c_out else None}

    def attn(c):
        p = {"norm": ones(c), "qkv": conv2(c, 3 * c, 1), "proj": conv2(c, c, 1)}
        p["proj"]["w"] = torch.zeros_like(p["proj"]["w"])
        return p

    dims = [cfg.dim * u for u in (cfg.dim_mult[-1],) + tuple(reversed(cfg.dim_mult))]
    ups: List[dict] = []
    for i in range(len(cfg.dim_mult)):
        in_dim = dims[i] // 2 if i >= 1 else dims[i]
        out_dim = dims[i + 1]
        for _ in range(cfg.num_res_blocks + 1):
            ups.append(res(in_dim, out_dim))
            in_dim = out_dim
        if i != len(cfg.dim_mult) - 1:
            p = {"conv": conv2(out_dim, out_dim // 2, 3)}
            if cfg.temperal_upsample[i]:
                p["time_conv"] = conv(out_dim, out_dim * 2, (3, 1, 1))
            ups.append(p)
    decoder = {
        "conv1": conv(cfg.z_dim, dims[0], 3),
        "middle": [res(dims[0], dims[0]), attn(dims[0]), res(dims[0], dims[0])],
        "upsamples": ups,
        "head_norm": ones(dims[-1]),
        "head_conv": conv(dims[-1], 3, 3),
    }
    return {
        "decoder": pack_fused_weights(decoder),
        "conv2": conv(cfg.z_dim, cfg.z_dim, 1),
        "mean": torch.tensor(WAN_LATENT_MEAN[: cfg.z_dim], dtype=torch.float32, device=device),
        "std": torch.tensor(WAN_LATENT_STD[: cfg.z_dim], dtype=torch.float32, device=device),
    }


# ---------------------------------------------------------------------------
# decode


def vae_decode_chunk(params, cfg: VAEConfig, z_chunk, caches, first: bool):
    """One streaming decode step.  z_chunk: [B, T, z, h, w] normalised
    latents.  Returns (pixels [B, T_out, 3, H, W] in [-1, 1], caches')."""
    z = z_chunk.permute(0, 1, 3, 4, 2)
    z = (z.float() * params["std"].float() + params["mean"].float()).to(z_chunk.dtype)
    x = causal_conv3d(z, params["conv2"], _CacheThread(None))  # 1x1x1
    out, caches = decoder_apply(params["decoder"], cfg, x, caches, first)
    out = torch.clamp(out.float(), -1.0, 1.0)
    return out.permute(0, 1, 4, 2, 3), caches


@torch.no_grad()
def vae_decode(params, cfg: VAEConfig, latents, chunk: int = 1):
    """Frame 0 alone, then ``chunk`` frames at a time.
    latents: [B, T, z, h, w] -> pixels [B, 1+4*(T-1), 3, H, W]."""
    b, t, _, h, w = latents.shape
    caches = init_decoder_caches(cfg, b, h, w, latents.dtype, latents.device)
    outs = []
    x0, caches = vae_decode_chunk(params, cfg, latents[:, :1], caches, True)
    outs.append(x0)
    i = 1
    while i < t:
        n = min(chunk, t - i)
        xi, caches = vae_decode_chunk(params, cfg, latents[:, i:i + n], caches, False)
        outs.append(xi)
        i += n
    return torch.cat(outs, dim=1)


@torch.no_grad()
def vae_decode_scan(params, cfg: VAEConfig, latents, caches=None, first: bool = True):
    """Frame-by-frame streaming decode (frame 0 through the first-frame
    path).  Returns (pixels [B, 1+4*(T-1), 3, H, W], caches')."""
    b, t, _, h, w = latents.shape
    if caches is None:
        caches = init_decoder_caches(cfg, b, h, w, latents.dtype, latents.device)
    outs = []
    start = 0
    if first:
        px0, caches = vae_decode_chunk(params, cfg, latents[:, :1], caches, True)
        outs.append(px0)
        start = 1
    for i in range(start, t):
        px, caches = vae_decode_chunk(params, cfg, latents[:, i:i + 1], caches, False)
        outs.append(px)
    return torch.cat(outs, dim=1), caches
