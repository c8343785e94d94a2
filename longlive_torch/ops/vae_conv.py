"""Fused causal conv3d for the streaming VAE decoder.

``fused_causal_conv`` computes ``[RMS-norm + SiLU ->] causal conv3d (kernel
3 x {3,1} x {3,1}, stride 1, SAME spatial) -> + bias [-> + residual]`` over
the virtual frame sequence [2 cache frames ++ T frames], and returns the new
2-frame cache (the last two normalised input frames) beside the output.  On
a CUDA tensor it launches the hand-written Hopper kernels of
``csrc/causal_conv.cu`` (an input pass that normalises each input element
once and writes the new cache, then a TMA-fed ``wgmma`` implicit GEMM whose
tiles ``conv_tiles`` picks); on a CPU tensor it runs
``fused_causal_conv_plain``.

``LONGLIVE_VAE_INT8=1`` (read at call time, as in the JAX package) selects
the int8 variant: the weights are quantized per packed column, that is per
(kernel column dx, output channel), with the norm's gamma folded in
(``pack_weights_int8``); the activations get one scale per (output frame,
row tile of ``row_tile`` rows) over everything that tile's product reads;
each dx's int32 product is rescaled on its own and the dx terms are summed
in float32.  On a CUDA tensor it launches the int8 kernels of
``csrc/causal_conv.cu``: a pre-pass that writes the quantized operand once
(``quantized_operand_plain`` is its plain version, ``kernel_quantized_operand``
returns the kernel's), then a TMA-fed s8 ``wgmma`` GEMM whose tiles
``conv_int8_tiles`` picks.

``fused_res_block`` computes a whole no-shortcut residual block,
``conv2(silu(norm2(conv1(silu(norm1(x)))))) + x`` with both convs' 2-frame
caches, in ONE call of ``csrc/res_block_pair.cu`` on a CUDA tensor (the
decoder's ``LONGLIVE_VAE_PAIR=1`` mode): K2's input pass and GEMM, conv1
with norm2 + SiLU in its epilogue where a CTA's N covers C (``pair_tiles``).
Its plain version, ``fused_res_block_plain``, is the chain of two
``fused_causal_conv_plain`` calls, which rounds where the kernel does.

Layout: channels-last frames [T, H, W, C] (batch 1, folded out by the
caller); weights in the torch layout [O, C, 3, kh, kw].
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import kernels
from .quant import _div, _rdiv, int_matmul

launches = 0  # calls of fused_causal_conv that launched kernels since the last reset
mode_launches = {"bf16": 0, "int8": 0}  # the same, by variant
pair_launches = 0  # calls of fused_res_block that launched its kernels since the last reset

SMEM_LIMIT = 232448  # shared memory a CTA may use on sm_90

# fused_causal_conv's bf16 kernel: the candidate boxes of 128 or 256 output
# pixels (rows x columns, the columns a multiple of 8), widest first
CONV_BOXES = {128: ((1, 128), (2, 64), (4, 32), (8, 16), (16, 8)),
              256: ((2, 128), (4, 64), (8, 32), (16, 16), (32, 8))}


class ConvTiles(NamedTuple):
    """A conv kernel's tiling: a ``bh`` x ``bw`` box of output pixels of
    one frame (M = 128 ``mt``), loaded with its ``kh - 1`` halo rows; ``kc``
    channels per K step (the inner dimension of every TMA box, ``kc`` times
    the element size in bytes, swizzled over as many); ``bn`` output
    channels (N); ``mt`` m64 tiles per consumer warpgroup; a ring of
    ``stages`` stages of ``stage`` bytes each (the box rounded to 1024,
    then ``kh`` weight tiles); and the CTA's dynamic shared memory ``smem``
    (the ring, its barriers and 1024 bytes of alignment)."""
    bh: int
    bw: int
    kc: int
    bn: int
    mt: int
    stages: int
    stage: int
    smem: int


def _box(h: int, w: int, kh: int, bn: int, boxes) -> Tuple[int, int]:
    """The box of ``boxes`` whose tiles over h x w pixels move the fewest
    rows into shared memory (its rows with the kh - 1 halo rows, and kh x N
    weight rows, per K step), the widest on a tie."""
    return min(boxes, key=lambda b: -(-h // b[0]) * -(-w // b[1]) * ((b[0] + kh - 1) * b[1]
                                                                      + kh * bn))


@functools.lru_cache(maxsize=None)
def conv_tiles(h: int, w: int, c: int, o: int, kh: int = 3) -> ConvTiles:
    """The bf16 conv kernel's tiles for H x W frames, C -> O channels and kh
    kernel rows, as measured best on an H100 at the decoder's shapes
    (PERF.md): KC = 64 where it divides C, else 32; the time convs (kh = 1)
    N = 192 where it divides O, else 96; the 3x3 convs N = 96, with M = 256
    (two m64 tiles per consumer warpgroup) at KC = 32 and M = 128 at KC =
    64; the box by ``_box``; then as many stages, up to 8, as a CTA's shared
    memory holds."""
    kc = 64 if c % 64 == 0 else 32
    if kh == 1:
        bn, mt = (192 if o % 192 == 0 else 96), 1
    else:
        bn, mt = 96, (1 if kc == 64 else 2)
    bh, bw = _box(h, w, kh, bn, CONV_BOXES[128 * mt])
    return conv_tiling(bh, bw, kc, bn, mt, kh)


def conv_tiling(bh: int, bw: int, kc: int, bn: int, mt: int, kh: int,
                elem: int = 2) -> ConvTiles:
    """The ConvTiles of a box, K step, N and m64 tiles for kh kernel rows
    and elements of ``elem`` bytes, with as many stages, up to 8, as a
    CTA's shared memory holds."""
    row = kc * elem
    stage = -(-(bh + kh - 1) * bw * row // 1024) * 1024 + kh * bn * row
    stages = min(8, (SMEM_LIMIT - 1024) // (stage + 16))
    return ConvTiles(bh, bw, kc, bn, mt, stages, stage, 1024 + stages * (stage + 16))


@functools.lru_cache(maxsize=None)
def conv_int8_tiles(h: int, w: int, c: int, o: int, kh: int, kw: int, th: int) -> ConvTiles:
    """The int8 conv kernel's tiles for H x W frames, C -> O channels, kh x
    kw kernel rows and columns and row tiles of ``th`` rows, as measured
    best on an H100 at the decoder's shapes (PERF.md): K steps of 128
    channels (bytes) for the 3x3 convs where 128 divides C or C < 128 (C =
    96: one step, its last 32 channels zero-filled by TMA), else 64; N = 192
    without a float accumulator for the time convs (kw = 1) where 192
    divides O, else N = 96 with the float sum of the kernel columns; M =
    128, the box by ``_box`` among those whose rows divide th (a box lies
    inside one row tile, so one activation scale covers it); then as many
    stages, up to 8, as fit."""
    kc = 128 if kw == 3 and (c % 128 == 0 or c < 128) else 64
    bn = 192 if kw == 1 and o % 192 == 0 else 96
    bh, bw = _box(th, w, kh, bn, [b for b in CONV_BOXES[128] if th % b[0] == 0])
    return conv_tiling(bh, bw, kc, bn, 1, kh, elem=1)


@functools.lru_cache(maxsize=None)
def pair_tiles(h: int, w: int, c: int) -> Tuple[ConvTiles, ConvTiles]:
    """fused_res_block's tiles of conv1 and conv2 for H x W frames of C
    channels.  conv2 takes K2's (``conv_tiles``).  conv1 takes norm2 + SiLU
    in its epilogue where one CTA's N covers C: C = 96 (m64n96, two m64
    tiles per warpgroup at KC = 32, K2's own tiles) and C = 192 (m64n192 at
    KC = 32); at wider C it takes K2's tiles, and a norm pass follows it
    (``bn != c`` says so)."""
    t2 = conv_tiles(h, w, c, c, 3)
    if c not in (96, 192):
        return t2, t2
    mt = 2 if c == 96 else 1
    bh, bw = _box(h, w, 3, c, CONV_BOXES[128 * mt])
    return conv_tiling(bh, bw, 32, c, mt, 3), t2


def reset_launches() -> None:
    global launches, pair_launches
    launches = pair_launches = 0
    for mode in mode_launches:
        mode_launches[mode] = 0


def norm_silu(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """silu(rms_norm_channel(x, gamma)) with the kernel's rounding points:
    y = dtype(x / (||x|| + 1e-12) * sqrt(C) * gamma), s = dtype(sigmoid(y)),
    out = y * s in x's dtype.  x: [..., C]."""
    xf = x.float()
    norm = torch.sqrt(xf.square().sum(dim=-1, keepdim=True)) + 1e-12
    y = (xf / norm * math.sqrt(x.shape[-1]) * gamma.float()).to(x.dtype)
    return y * torch.sigmoid(y.float()).to(x.dtype)


def _aligned(n: int) -> int:
    """The JAX kernel's lane-padded channel count (widths >= 96 rounded up
    to 128-multiples); it enters the row-tile choice."""
    return n if (n < 96 or n % 128 == 0) else -(-n // 128) * 128


def pick_tiles(cp: int, op: int, h: int, w: int, dtype_bytes: int, kh: int = 3, kw: int = 3,
               budget: float = 20e6) -> Tuple[int, int]:
    """The JAX kernel's (row tile, output tile) choice for its VMEM budget
    (``ops/vae_conv.py::_pick_tiles`` at its default budget).  The row tile
    sets the granularity of the int8 variant's activation scale, so the
    port takes the same one for the same shape."""
    bo_cands = [op]
    if op % 128 == 0:
        bo_cands += [b for b in (256, 128) if b < op and op % b == 0]
    wp = w + 16
    for th in (8, 6, 4, 2):
        if h % th:
            continue
        for bo in bo_cands:
            kbuf = th * wp * 3 * kh * cp * dtype_bytes
            stag = 3 * (th + 2) * wp * cp * dtype_bytes
            wght = 3 * kh * cp * kw * bo * dtype_bytes * 2
            out9 = th * wp * kw * bo * 4
            io = 2 * 2 * th * w * bo * dtype_bytes
            if kbuf + stag + wght + out9 + io < budget:
                return th, bo
    return 2, min(bo_cands[-1], 128)


def row_tile(x: torch.Tensor, w: torch.Tensor) -> int:
    """Rows per activation scale of the int8 variant for input x
    [T, H, W, C] and weights w [O, C, 3, kh, kw]."""
    o, c = int(w.shape[0]), int(w.shape[1])
    return pick_tiles(_aligned(max(x.shape[-1], c)), _aligned(o), x.shape[1], x.shape[2],
                      x.element_size(), int(w.shape[3]), int(w.shape[4]))[0]


def pack_weights_int8(w: torch.Tensor, gamma: Optional[torch.Tensor] = None):
    """Int8 weights of the int8 variant: g = max(|gamma|, 1e-6) (ones
    without a norm) is folded into the weights along K = (tap, row,
    channel), and each packed column (kernel column dx, output channel o)
    gets the scale sc = max(amax over K, 1e-12) / 127, q = round(w g / sc).
    Returns (wq [3, kh, kw, O, C] int8, sc [kw, O] float32, ginv [C]
    float32 = 1 / g, which the kernel applies to the activations)."""
    c = int(w.shape[1])
    g = (torch.ones(c, dtype=torch.float32, device=w.device) if gamma is None
         else torch.clamp_min(gamma.abs(), 1e-6).float())
    wf = w.float().permute(2, 3, 4, 0, 1) * g  # [3, kh, kw, O, C]
    sc = _div(torch.clamp_min(wf.abs().amax(dim=(0, 1, 4)), 1e-12), 127.0)  # [kw, O]
    wq = torch.round(wf / sc[None, None, :, :, None]).to(torch.int8)
    return wq.contiguous(), sc.contiguous(), _rdiv(1.0, g).contiguous()


def activation_scales(full: torch.Tensor, ginv: torch.Tensor, th: int, kh: int) -> torch.Tensor:
    """The int8 variant's activation scale of every (output frame, row)
    [T, H]: over the three virtual frames t..t+2 of ``full`` [T+2, H, W, C]
    and the rows of the row tile with its halo (one row each side when
    kh = 3, clipped at the image), amax = max(max|full * ginv|, 1e-8) and
    s = amax / 127.  Every row of a tile carries its tile's scale."""
    rowmax = (full.float() * ginv).abs().amax(dim=(2, 3))  # [T+2, H]
    fm = torch.maximum(torch.maximum(rowmax[:-2], rowmax[1:-1]), rowmax[2:])  # [T, H]
    h, ph = full.shape[1], kh // 2
    tiles = []
    for r0 in range(0, h, th):
        amax = fm[:, max(r0 - ph, 0):min(r0 + th + ph, h)].amax(dim=1)
        tiles.append(_div(torch.clamp_min(amax, 1e-8), 127.0)[:, None].expand(-1, min(th, h - r0)))
    return torch.cat(tiles, dim=1)


def _conv_int8_plain(full: torch.Tensor, w_int8, th: int) -> torch.Tensor:
    """The int8 variant's product over [T+2, H, W, C] frames: per output
    frame t, the K-packed operand (tap, row, channel) over the W + 2 pw
    padded columns, quantized q = round(a / s) with a = full * ginv and
    its row's scale s; per dx the exact integer product, then
    float32(int) * (s * sc[dx, o]) summed over dx in order.  Returns
    float32 [T, H, W, O]."""
    wq, sc, ginv = w_int8
    kh, kw, o = wq.shape[1], wq.shape[2], wq.shape[3]
    t, h, wd = full.shape[0] - 2, full.shape[1], full.shape[2]
    ph, pw = kh // 2, kw // 2
    s_row = activation_scales(full, ginv, th, kh)  # [T, H]
    a = full.float() * ginv
    wflat = wq.permute(2, 3, 0, 1, 4).reshape(kw * o, -1)  # rows (dx, o), K (tap, row, c)
    out = []
    for ti in range(t):
        taps = []
        for tau in range(3):
            fr = torch.nn.functional.pad(a[ti + tau], (0, 0, pw, pw, ph, ph))
            taps += [fr[dy:dy + h] for dy in range(kh)]
        op = torch.round(torch.cat(taps, dim=-1) / s_row[ti][:, None, None]).to(torch.int8)
        prod = int_matmul(op.reshape(h * (wd + 2 * pw), -1), wflat).reshape(h, wd + 2 * pw, kw, o)
        y = None
        for dx in range(kw):
            y_dx = prod[:, dx:dx + wd, dx].float() * (s_row[ti][:, None, None] * sc[dx])
            y = y_dx if y is None else y + y_dx
        out.append(y)
    return torch.stack(out)


def quantized_operand_plain(full: torch.Tensor, ginv: torch.Tensor, th: int,
                            kh: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 kernel's quantized operand in plain PyTorch, from
    ``activation_scales``: per (output frame t, temporal tap tau, row tile
    R of ``th`` rows), R's th + 2 ph rows (ph = kh // 2: the halo, rows
    outside the image zero) of virtual frame t + tau of ``full`` [T+2, H,
    W, C], quantized q = round(a / s[t][R]) with a = full * ginv.  Returns
    (Q [T, 3, nR, th + 2 ph, W, C] int8, s [T, nR] float32); contracted one
    kernel column at a time with ``pack_weights_int8``'s weights it gives
    ``_conv_int8_plain``'s product."""
    t, h = full.shape[0] - 2, full.shape[1]
    ph, nr = kh // 2, -(-h // th)
    scales = activation_scales(full, ginv, th, kh)[:, ::th].contiguous()  # a tile's first row
    a = F.pad(full.float() * ginv, (0, 0, 0, 0, ph, nr * th - h + ph))
    rows = (torch.arange(nr, device=full.device)[:, None] * th
            + torch.arange(th + 2 * ph, device=full.device))  # [nR, th + 2 ph]
    frames = a[:, rows]  # [T+2, nR, th + 2 ph, W, C]
    op = torch.stack([frames[tau:tau + t] for tau in range(3)], dim=1)
    return torch.round(op / scales[:, None, :, None, None, None]).to(torch.int8), scales


def fused_causal_conv_plain(
    x: torch.Tensor, cache: torch.Tensor, w: torch.Tensor,
    b: Optional[torch.Tensor] = None, gamma: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None, w_int8=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: float32 conv over the
    concatenated [cache ++ normalised x], bias added in float32, one
    rounding to x's dtype, then the residual added in that dtype.  With
    ``w_int8`` (``pack_weights_int8(w, gamma)``) the int8 variant's
    product (``_conv_int8_plain``, row tile ``row_tile(x, w)``) replaces
    the float32 conv."""
    xin = norm_silu(x, gamma) if gamma is not None else x
    full = torch.cat([cache.to(x.dtype), xin], dim=0)  # [T+2, H, W, C]
    if w_int8 is not None:
        y = _conv_int8_plain(full, w_int8, row_tile(x, w))
        if b is not None:
            y = y + b.float()
        y = y.to(x.dtype)
        if residual is not None:
            y = y + residual
        return y, full[-2:]
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


def _check(name: str, t: Optional[torch.Tensor], dtype, device) -> None:
    if t is None:
        return
    if t.dtype != dtype:
        raise ValueError(f"fused_causal_conv: {name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16 or t.device != device:
        raise ValueError(f"fused_causal_conv: {name} must be contiguous, "
                         f"16-byte aligned and on {device}")


def _check_int8(w_int8, device, kh: int, kw: int, o: int, c: int):
    wq, sc, ginv = w_int8
    if wq.shape != (3, kh, kw, o, c) or sc.shape != (kw, o) or ginv.shape != (c,):
        raise ValueError(f"fused_causal_conv: w_int8 shapes {tuple(wq.shape)}, "
                         f"{tuple(sc.shape)}, {tuple(ginv.shape)} do not match w")
    _check("w_int8", wq, torch.int8, device)
    _check("w_int8 scales", sc, torch.float32, device)
    _check("w_int8 ginv", ginv, torch.float32, device)
    return wq, sc, ginv


def _int8_operand(lib, x, cache, gf, ginv, th: int, kh: int, stream):
    """The int8 pre-pass on the card: the normalised frames xn (x itself
    without a norm), the new cache, Q and its scales
    (``quantized_operand_plain``'s layout)."""
    t, h, wd, c = x.shape
    xn = torch.empty_like(x) if gf is not None else x
    nx = torch.empty_like(cache)
    rowmax = torch.empty((t + 2, h), dtype=torch.float32, device=x.device)
    nr = -(-h // th)
    q = torch.empty((t, 3, nr, th + 2 * (kh // 2), wd, c), dtype=torch.int8, device=x.device)
    scales = torch.empty((t, nr), dtype=torch.float32, device=x.device)
    fn = lib.longlive_causal_conv_int8_operand
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    rc = fn(x.data_ptr(), cache.data_ptr(), None if gf is None else gf.data_ptr(),
            ginv.data_ptr(), None if gf is None else xn.data_ptr(), nx.data_ptr(),
            rowmax.data_ptr(), q.data_ptr(), scales.data_ptr(), t, h, wd, c, kh, th, stream)
    kernels.check(lib, rc, "fused_causal_conv (int8 operand)")
    return xn, nx, q, scales


def kernel_quantized_operand(x: torch.Tensor, cache: torch.Tensor, w: torch.Tensor,
                             gamma: Optional[torch.Tensor] = None,
                             w_int8=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The int8 kernel's pre-pass alone on CUDA tensors (no conv, not
    counted as a launch): (Q, s, full) with Q and s laid out as
    ``quantized_operand_plain(full, ginv, row_tile(x, w), kh)`` lays them
    out, and full = [cache ++ the frames it quantized] (x normalised by the
    kernel with a gamma), for the tests' bit-equality."""
    if x.device.type != "cuda":
        raise ValueError(f"kernel_quantized_operand: needs a CUDA tensor, got {x.device}")
    o, c, kh, kw = int(w.shape[0]), int(w.shape[1]), int(w.shape[3]), int(w.shape[4])
    if c % 32 or x.shape[-1] != c or cache.shape != (2,) + tuple(x.shape[1:]):
        raise ValueError("kernel_quantized_operand: shapes do not match, or C % 32 != 0")
    _check("x", x, torch.bfloat16, x.device)
    _check("cache", cache, torch.bfloat16, x.device)
    ginv = _check_int8(pack_weights_int8(w, gamma) if w_int8 is None else w_int8, x.device,
                       kh, kw, o, c)[2]
    gf = None if gamma is None else gamma.float().contiguous()
    xn, _, q, scales = _int8_operand(kernels.load("causal_conv"), x, cache, gf, ginv,
                                     row_tile(x, w), kh,
                                     torch.cuda.current_stream(x.device).cuda_stream)
    return q, scales, torch.cat([cache, xn])


def fused_causal_conv(
    x: torch.Tensor, cache: torch.Tensor, w: torch.Tensor,
    b: Optional[torch.Tensor] = None, gamma: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None, w_packed: Optional[torch.Tensor] = None,
    w_int8=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [T, H, W, C]; cache: [2, H, W, C] (the previous two conv input
    frames, normalised when ``gamma`` is given; zeros before the first
    chunk); w: [O, C, 3, kh, kw] with kh, kw in {1, 3}; b: [O]; gamma: [C];
    residual: [T, H, W, O]; w_packed: ``pack_weights(w)`` and w_int8:
    ``pack_weights_int8(w, gamma)``, made once where the parameters are
    built (packed here per call when omitted).  Returns (out [T, H, W, O],
    new_cache [2, H, W, C]).  ``LONGLIVE_VAE_INT8=1`` selects the int8
    variant.

    CPU tensors run the plain version.  CUDA tensors launch the kernel,
    which takes bf16 x/cache/w/residual, C % 32 == 0 and O % 96 == 0;
    anything else raises ValueError."""
    o, c = int(w.shape[0]), int(w.shape[1])
    kt, kh, kw = (int(s) for s in w.shape[2:])
    if kt != 3 or kh not in (1, 3) or kw not in (1, 3):
        raise ValueError(f"fused_causal_conv: kernel {tuple(w.shape[2:])} unsupported")
    int8 = os.environ.get("LONGLIVE_VAE_INT8", "0") == "1"
    if int8 and w_int8 is None:
        w_int8 = pack_weights_int8(w, gamma)
    if x.device.type == "cpu":
        return fused_causal_conv_plain(x, cache, w, b, gamma, residual,
                                       w_int8 if int8 else None)
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
    bf = None if b is None else b.float().contiguous()
    gf = None if gamma is None else gamma.float().contiguous()
    for name, tt in (("x", x), ("cache", cache), ("residual", residual)):
        _check(name, tt, torch.bfloat16, x.device)
    for name, tt, n in (("b", bf, o), ("gamma", gf, c)):
        if tt is not None and (tt.shape != (n,) or tt.device != x.device):
            raise ValueError(f"fused_causal_conv: {name} must be [{n}] on {x.device}")
    ptr = lambda a: None if a is None else a.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = kernels.load("causal_conv")
    out = torch.empty((t, h, wd, o), dtype=x.dtype, device=x.device)
    if int8:
        wq, sc, ginv = _check_int8(w_int8, x.device, kh, kw, o, c)
        th = row_tile(x, w)
        _, nx, q, scales = _int8_operand(lib, x, cache, gf, ginv, th, kh, stream)
        tl = conv_int8_tiles(h, wd, c, o, kh, kw, th)
        fn = lib.longlive_causal_conv_int8
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
        rc = fn(q.data_ptr(), scales.data_ptr(), wq.data_ptr(), sc.data_ptr(), ptr(bf),
                ptr(residual), out.data_ptr(), t, h, wd, c, o, kh, kw, th, tl.bh, tl.bw, tl.kc,
                tl.bn, int(tl.bn == 96), tl.stages, stream)
        kernels.check(lib, rc, "fused_causal_conv (int8)")
        mode = "int8"
    else:
        wp = pack_weights(w) if w_packed is None else w_packed
        if wp.shape != (3, kh, kw, o, c):
            raise ValueError(f"fused_causal_conv: w_packed {tuple(wp.shape)} != "
                             f"{(3, kh, kw, o, c)}")
        _check("w", wp, torch.bfloat16, x.device)
        tl = conv_tiles(h, wd, c, o, kh)
        xn = x if gamma is None else torch.empty_like(x)
        nx = torch.empty_like(cache)
        fn = lib.longlive_conv_input  # norm + SiLU once per element; the new cache
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        rc = fn(x.data_ptr(), cache.data_ptr(), ptr(gf), None if gamma is None else xn.data_ptr(),
                nx.data_ptr(), t, h, wd, c, stream)
        kernels.check(lib, rc, "fused_causal_conv (input pass)")
        fn = lib.longlive_causal_conv
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
        rc = fn(xn.data_ptr(), cache.data_ptr(), wp.data_ptr(), ptr(bf), ptr(residual),
                out.data_ptr(), t, h, wd, c, o, kh, kw, tl.bh, tl.bw, tl.kc, tl.bn, tl.mt,
                tl.stages, stream)
        kernels.check(lib, rc, "fused_causal_conv")
        mode = "bf16"
    launches += 1
    mode_launches[mode] += 1
    return out, nx


# ---------------------------------------------------------------------------
# a whole no-shortcut residual block (the decoder's LONGLIVE_VAE_PAIR=1 mode)


def fused_res_block_plain(
    x: torch.Tensor, cache1: torch.Tensor, cache2: torch.Tensor, w1: torch.Tensor,
    b1: torch.Tensor, gamma1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
    gamma2: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: the two-call chain
    ``y = conv1(norm1silu(x)) + b1`` rounded to x's dtype, then
    ``out = conv2(norm2silu(y)) + b2`` rounded, plus x.  Returns (out,
    new cache1, new cache2): the last two frames of [cache1 ++ norm1silu(x)]
    and of [cache2 ++ norm2silu(y)] (for T = 1: [cache[1], the new frame])."""
    y, nc1 = fused_causal_conv_plain(x, cache1, w1, b1, gamma1)
    out, nc2 = fused_causal_conv_plain(y, cache2, w2, b2, gamma2, residual=x)
    return out, nc1, nc2


@functools.lru_cache(maxsize=None)
def _pair_tile_args(h: int, w: int, c: int):
    """``pair_tiles`` as the C entry takes them: (bh, bw, kc, nt, mt,
    stages) of conv1 and of conv2, two int[6]."""
    return tuple((ctypes.c_int * 6)(tl.bh, tl.bw, tl.kc, tl.bn, tl.mt, tl.stages)
                 for tl in pair_tiles(h, w, c))


def fused_res_block(
    x: torch.Tensor, cache1: torch.Tensor, cache2: torch.Tensor, w1: torch.Tensor,
    b1: torch.Tensor, gamma1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
    gamma2: torch.Tensor, w1_packed: Optional[torch.Tensor] = None,
    w2_packed: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A no-shortcut residual block: x [T, H, W, C]; cache1, cache2
    [2, H, W, C] (the normalised inputs of conv1 and conv2 of the two frames
    before x; zeros before the first chunk); w1, w2 [C, C, 3, 3, 3]; b1,
    b2, gamma1, gamma2 [C]; w*_packed: ``pack_weights`` of each, made once
    with the parameters (packed here per call when omitted).  Returns (out
    [T, H, W, C], new cache1, new cache2).

    CPU tensors run the plain version.  CUDA tensors make one call of the
    kernels (counted once in ``pair_launches``), which take bf16
    x/caches/weights and C % 96 == 0 (tiles from ``pair_tiles``); anything
    else raises ValueError."""
    c = int(w1.shape[1])
    for name, w in (("w1", w1), ("w2", w2)):
        if tuple(w.shape) != (c, c, 3, 3, 3):
            raise ValueError(f"fused_res_block: {name} {tuple(w.shape)} is not [C, C, 3, 3, 3]")
    if x.device.type == "cpu":
        return fused_res_block_plain(x, cache1, cache2, w1, b1, gamma1, w2, b2, gamma2)
    global pair_launches
    if x.device.type != "cuda":
        raise ValueError(f"fused_res_block: unsupported device {x.device}")
    t, h, wd, cx = x.shape
    if cx != c or cache1.shape != (2, h, wd, c) or cache2.shape != (2, h, wd, c):
        raise ValueError(f"fused_res_block: x {tuple(x.shape)} / caches {tuple(cache1.shape)}, "
                         f"{tuple(cache2.shape)} do not match C = {c}")
    if c % 96:
        raise ValueError(f"fused_res_block: needs C % 96 == 0, got C={c}")
    packed = [pack_weights(w) if wp is None else wp
              for w, wp in ((w1, w1_packed), (w2, w2_packed))]
    vecs = [None if vv is None else vv.float().contiguous() for vv in (b1, gamma1, b2, gamma2)]
    for name, tt in (("x", x), ("cache1", cache1), ("cache2", cache2), ("w1_packed", packed[0]),
                     ("w2_packed", packed[1])):
        _check(name, tt, torch.bfloat16, x.device)
        if name.endswith("packed") and tt.shape != (3, 3, 3, c, c):
            raise ValueError(f"fused_res_block: {name} {tuple(tt.shape)} != {(3, 3, 3, c, c)}")
    for name, tt in zip(("b1", "gamma1", "b2", "gamma2"), vecs):
        if tt is None or tt.shape != (c,) or tt.device != x.device:
            raise ValueError(f"fused_res_block: {name} must be [{c}] on {x.device}")
    fused = pair_tiles(h, wd, c)[0].bn == c  # norm2 in conv1's epilogue
    out, xn, z = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    y = None if fused else torch.empty_like(x)  # conv1's output before a norm pass
    nc1, nc2 = torch.empty_like(cache1), torch.empty_like(cache2)
    tiles = _pair_tile_args(h, wd, c)
    lib = kernels.load("res_block_pair")
    fn = lib.longlive_res_block_pair
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 4
                   + [ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.c_void_p])
    rc = fn(x.data_ptr(), cache1.data_ptr(), cache2.data_ptr(), packed[0].data_ptr(),
            vecs[0].data_ptr(), vecs[1].data_ptr(), packed[1].data_ptr(), vecs[2].data_ptr(),
            vecs[3].data_ptr(), out.data_ptr(), nc1.data_ptr(), nc2.data_ptr(), xn.data_ptr(),
            z.data_ptr(), None if y is None else y.data_ptr(), t, h, wd, c, tiles[0], tiles[1],
            torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(lib, rc, "fused_res_block")
    pair_launches += 1
    return out, nc1, nc2
