"""Attention for the causal DiT.

- ``flash_attention``: self-attention of a block's queries over one layer of
  the KV cache with an additive float32 bias per KV token (0 = attend,
  -1e30 = masked).  On a CUDA tensor it launches the hand-written Hopper
  kernel of ``csrc/flash_attention.cu``; on a CPU tensor it runs
  ``flash_attention_plain``, the same arithmetic in plain PyTorch.  Modes:
  ``bias`` (q arrives roped), ``q_rope`` (q arrives un-roped and the kernel
  applies the halfsplit rotation, with the softmax scale folded in, while
  it stages the q tile), ``qk_int8`` (QK^T in int8) and ``two_segment``
  (a second, fully valid KV segment ``k2``/``v2`` -- the fresh block of the
  serving decode -- beside the cache, one online softmax over both, with
  the dead cache tiles named by ``skip_ranges`` elided).  Two switches,
  read at call time as in the JAX package, apply in every mode:
  ``LONGLIVE_EXP2=1`` folds log2(e) into the softmax scale (and the bias)
  and takes exp2; ``LONGLIVE_MXU_LSUM=1`` sums each softmax row from P
  rounded to V's dtype (on the tensor cores in the kernel).  The serving
  cross-attention takes it under ``LONGLIVE_CROSS_FLASH=1`` (``cross=True``,
  counted apart).  ``flash_attention_unmasked`` gives it K/V in the
  [B, S, N, D] layout, every token valid: the bidirectional samplers'
  self- and cross-attentions.
- ``flash_attention_frame_masked``: full-sequence self-attention under a
  frame-structured mask computed from token indices (block-causal, sink +
  window, teacher forcing), with the tiles the mask leaves dead skipped
  (``LONGLIVE_TF_ELIDE``, default on).  On a CUDA tensor it launches the
  kernel of ``csrc/flash_attention_masked.cu``; on a CPU tensor it runs
  ``flash_attention_frame_masked_plain``.  Forward only.
- ``dense_attention``: plain softmax attention, the serving cross-attention
  by default (the text context is only 512 tokens).
- ``flash_attention_train``: differentiable attention with a [B, Skv]
  kv-valid mask for the training paths, a ``torch.autograd.Function``.  On
  CUDA tensors its forward and its backward (dQ, then dK/dV) are the
  kernels of ``csrc/flash_attention_train.cu``; on CPU tensors both run
  their plain versions, ``flash_attention_train_plain`` and
  ``flash_attention_train_backward_plain``.

Layout: q, the output and ``k2``/``v2`` are [B, Sq, N, D];
``flash_attention``'s K and V are one layer's rows of the cache,
[B*N, S, D] (head-major, token rows contiguous); ``flash_attention_train``'s
and ``flash_attention_frame_masked``'s are [B, Skv, N, D].
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import List, Optional, Sequence, Tuple

import torch

from . import kernels
from .quant import _rdiv

NEG_INF = -1e30  # finite: -inf - -inf would poison the running max with NaN

LOG2E = math.log2(math.e)
KV_TILE = 64  # KV tokens per tile of the live-tile mask the kernel is given
LIVE_WORDS = 64  # 32-tile words of the kernel's live-tile mask (up to 131072 cache tokens)
KERNEL_KV_TILE = 128  # KV tokens per tile of the kernel: the granularity of dead-tile elision
KERNEL_Q_TILE = 128  # query rows per item (CTA) of the kernel
KERNEL_MAX_SPLIT = 4  # CTAs an item of the kernel's last wave may be split into
KERNEL_MIN_SHARE = 4  # KV tiles each CTA of a split item walks at the least

launches = 0  # kernel launches of flash_attention since the last reset
# the same launches, by mode (a two-segment launch counts as two_segment,
# whatever its QK^T type; a cross-attention launch as cross), and those that
# ran with each switch on
mode_launches = {"bias": 0, "q_rope": 0, "qk_int8": 0, "two_segment": 0, "cross": 0}
flag_launches = {"exp2": 0, "mxu_lsum": 0}

# kernel launches of flash_attention_frame_masked since the last reset, by mask kind
masked_launches = {"block_causal": 0, "sink_window": 0, "teacher_forcing": 0}
MASKED_TILE_Q, MASKED_TILE_KV = 128, 128  # its kernel's tiles: the granularity of its elision
MASKED_MAX_KV_TILES = 2048  # its kernel's live-tile list in shared memory (262144 kv tokens)
_MASKED_PLAIN_ROWS = 2048  # query rows per chunk of its plain version


# kernel launches of flash_attention_train since the last reset: its forward
# (recomputes under checkpointing included) and its two backward kernels
train_launches = {"fwd": 0, "bwd_dq": 0, "bwd_dkdv": 0}
EMPTY_LSE = 1e30  # logsumexp of a row with no valid kv token (its P is 0)
_PLAIN_ROWS = 8192  # query rows per chunk of the plain training versions
TILE_DEAD, TILE_PARTIAL, TILE_FULL = 0, 1, 2  # train_kv_tile_states' classes


def reset_launches() -> None:
    global launches
    launches = 0
    for counter in (mode_launches, flag_launches, train_launches, masked_launches):
        for name in counter:
            counter[name] = 0


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


def quantize_k_tokens(k: torch.Tensor):
    """Symmetric int8 quantization of each row of k over its last dim (a
    roped key per token and head): amax = max|k| + 1e-30,
    q = round(k * (127 / amax)) (no clip: |q| <= 127), scale = amax / 127 as
    amax * (1/127), so k ~= q * scale.  k: [..., D] -> (int8 [..., D],
    float32 scales [...]).  The qk_int8 mode quantizes q (after the softmax
    scale) with the same formula."""
    kf = k.float()
    amax = kf.abs().amax(dim=-1, keepdim=True) + 1e-30
    ki = torch.round(kf * _rdiv(127.0, amax)).to(torch.int8)
    return ki, (amax * (1.0 / 127.0)).squeeze(-1)


def dequantize_k(k: torch.Tensor, k_scales: torch.Tensor, dtype) -> torch.Tensor:
    return (k.float() * k_scales.float()[..., None]).to(dtype)


def switches() -> Tuple[bool, bool]:
    """(exp2, mxu_lsum): ``LONGLIVE_EXP2=1`` and ``LONGLIVE_MXU_LSUM=1``,
    read at each ``flash_attention`` call as the JAX package reads them."""
    return (os.environ.get("LONGLIVE_EXP2", "0") == "1",
            os.environ.get("LONGLIVE_MXU_LSUM", "0") == "1")


def softmax_scale(d: int, exp2: bool = False) -> float:
    """1/sqrt(D), times log2(e) in the exp2 mode (exp(x) == exp2(x log2 e)),
    as a Python float; the kernels and the plain version round it to
    float32 where they multiply."""
    scale = 1.0 / math.sqrt(d)
    return scale * LOG2E if exp2 else scale


def _scaled_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q pre-scaled by the softmax scale and rounded to its dtype."""
    return (q.float() * scale).to(q.dtype)


def _qk_int8_operands(q, k, k_scales, scale: float):
    """The qk_int8 mode's operands: (q8 [B, Sq, N, D], q scales [B, Sq, N],
    k8 [B*N, S, D], k scales [B*N, S]).  K is quantized here unless it
    arrives int8 with ``k_scales``."""
    q8, qsc = quantize_k_tokens(_scaled_q(q, scale))
    if k_scales is None:
        k8, ksc = quantize_k_tokens(k)
    else:
        k8, ksc = k, k_scales
    return q8, qsc, k8, ksc


def live_kv_tiles(skip_ranges: Sequence[Tuple[int, int]], s: int,
                  tile: int = KV_TILE) -> List[bool]:
    """Liveness of each of the ceil(s / tile) KV tiles of the first
    segment (the JAX package's ``_skip_tile_arrays``' ``live``): a tile is
    dead only when the disjoint token ranges ``skip_ranges`` ((start, end)
    pairs) cover all of its ``tile`` positions.  A partly covered tile is
    live and its bias masks the covered tokens, so elision changes no
    result.  Python ints in, Python bools out: no device work."""
    live = []
    for i in range(-(-s // tile)):
        lo, hi = i * tile, (i + 1) * tile
        cov = sum(max(0, min(hi, b) - max(lo, a)) for a, b in skip_ranges)
        live.append(cov < tile)
    return live


def kernel_live_tiles(live: Sequence[bool]) -> List[bool]:
    """The kernel's ``KERNEL_KV_TILE``-token cache tiles that it computes,
    from the ``KV_TILE``-token mask of ``live_kv_tiles``: a tile is dead
    only when both of its halves are (so it equals ``live_kv_tiles`` at
    ``tile=KERNEL_KV_TILE``)."""
    step = KERNEL_KV_TILE // KV_TILE
    return [any(live[i:i + step]) for i in range(0, len(live), step)]


def split_plan(items: int, sms: int, tiles: int) -> Tuple[int, int]:
    """How the kernel's grid covers ``items`` (query tile, head) items, each
    walking ``tiles`` KV tiles, on ``sms`` SMs (one CTA per SM at a time):
    (nfull, k), the first ``nfull`` items one CTA each and the last
    ``items - nfull`` (the last wave's remainder) split into ``k`` CTAs
    that each walk a k-th of the tiles.  k in 1..KERNEL_MAX_SPLIT makes
    the remainder's rounds, ceil(k * rem / sms) / k of an item's time, the
    fewest (the smallest k on a tie), with at least KERNEL_MIN_SHARE tiles
    a CTA; k = 1 splits nothing (nfull = items).  Python ints in and out."""
    rem = items % sms
    best, k_best = 1.0, 1
    for k in range(2, KERNEL_MAX_SPLIT + 1):
        rounds = -(-k * rem // sms) / k
        if rem and tiles >= k * KERNEL_MIN_SHARE and rounds < best:
            best, k_best = rounds, k
    return (items, 1) if k_best == 1 else (items - rem, k_best)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor, q_rope=None, qk_int8: bool = False,
                          k_scales: Optional[torch.Tensor] = None,
                          k2: Optional[torch.Tensor] = None, v2: Optional[torch.Tensor] = None,
                          skip_ranges=None, exp2: bool = False,
                          mxu_lsum: bool = False) -> torch.Tensor:
    """The kernel's arithmetic: q is pre-scaled by the softmax scale (and,
    with ``q_rope``, rotated: ``rope_scaled_q``) and rounded to its dtype,
    logits are float32 plus the bias, P is rounded to V's dtype before PV,
    and the output is divided by the float32 row sum at the end.
    ``qk_int8``: the logits are (float(q8 . k8) * q_scale) * k_scale + bias,
    the integer product exact (|q8 . k8| <= 128 * 127^2 < 2^24, so float32
    holds it); a second segment's keys are quantized here per call.
    ``k2``/``v2``: a second, fully valid segment after the first, one
    softmax over both (``bias`` covers the first only); ``skip_ranges``
    only elides tiles the bias masks, so it changes nothing here.
    ``exp2``: the scale carries log2(e), the bias is multiplied by it and
    P = exp2(s - m).  ``mxu_lsum``: the row sum is taken over P rounded to
    V's dtype.  One head at a time, so the logits of a 12-frame recache
    (18720 x 18720) stay ~1.4 GB.

    q: [B, Sq, N, D]; k, v: [B*N, S, D] (k int8 with ``k_scales`` [B*N, S]);
    bias: [B, S] float32; k2, v2: [B, S2, N, D]."""
    _check_modes(q_rope, qk_int8, k_scales, k2, v2, skip_ranges)
    b, sq, n, d = q.shape
    scale = softmax_scale(d, exp2)
    if qk_int8:
        q8, qsc, k8, ksc = _qk_int8_operands(q, k, k_scales, scale)
        qh = q8.permute(0, 2, 1, 3).reshape(b * n, sq, d)
        qsc = qsc.permute(0, 2, 1).reshape(b * n, sq)
        if k2 is not None:
            k2, k2sc = quantize_k_tokens(k2)
    elif q_rope is None:
        qh = _scaled_q(q, scale).permute(0, 2, 1, 3).reshape(b * n, sq, d)
    else:
        qs = rope_scaled_q(q, q_rope[0], q_rope[1], scale)
        qh = qs.permute(0, 2, 1, 3).reshape(b * n, sq, d)
    bias = bias.float() * LOG2E if exp2 else bias.float()
    out = torch.empty((b * n, sq, d), dtype=torch.float32, device=q.device)
    for bh in range(b * n):
        bi, h = divmod(bh, n)
        qf = qh[bh].float()
        if qk_int8:
            logits = (qf @ k8[bh].float().T) * qsc[bh, :, None] * ksc[bh].float() + bias[bi]
        else:
            logits = qf @ k[bh].float().T + bias[bi]  # [Sq, S]
        vv = v[bh]
        if k2 is not None:
            l2 = qf @ k2[bi, :, h].float().T
            if qk_int8:
                l2 = l2 * qsc[bh, :, None] * k2sc[bi, :, h]
            logits = torch.cat([logits, l2], dim=-1)
            vv = torch.cat([vv, v2[bi, :, h]], dim=0)
        m = logits.amax(dim=-1, keepdim=True)
        p = torch.exp2(logits - m) if exp2 else torch.exp(logits - m)
        pv = p.to(v.dtype).float()
        lsum = (pv if mxu_lsum else p).sum(dim=-1, keepdim=True)
        out[bh] = (pv @ vv.float()) / lsum
    return out.view(b, n, sq, d).permute(0, 2, 1, 3).to(q.dtype)


def _check_modes(q_rope, qk_int8: bool, k_scales, k2=None, v2=None, skip_ranges=None) -> None:
    if k_scales is not None and not qk_int8:
        raise ValueError("flash_attention: k_scales (an int8 K) needs qk_int8=True")
    if q_rope is not None and (qk_int8 or k2 is not None or skip_ranges is not None):
        raise ValueError("q_rope (in-kernel q RoPE) supports the plain bf16 "
                         "single-segment kernel only")
    if (k2 is None) != (v2 is None):
        raise ValueError("flash_attention: k2 and v2 come together")


def _check_operand(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"flash_attention: {name} must be {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16 or t.device != device:
        raise ValueError(f"flash_attention: {name} must be contiguous, 16-byte aligned "
                         f"and on {device}")


class _LiveTiles(ctypes.Structure):
    """The kernel's live-tile mask, passed by value: bit i of word i // 32
    is set when first-segment KV tile i is computed."""

    _fields_ = [("bits", ctypes.c_uint32 * LIVE_WORDS)]


def _live_mask(tiles: List[bool], s: int) -> _LiveTiles:
    mask = _LiveTiles()
    if len(tiles) > 32 * LIVE_WORDS:
        raise ValueError(f"flash_attention: skip_ranges over {s} tokens: the kernel's "
                         f"live-tile mask covers {32 * LIVE_WORDS * KV_TILE}")
    for i, ok in enumerate(tiles):
        if ok:
            mask.bits[i >> 5] |= 1 << (i & 31)
    return mask


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, q_rope=None, qk_int8: bool = False,
                    k_scales: Optional[torch.Tensor] = None,
                    k2: Optional[torch.Tensor] = None, v2: Optional[torch.Tensor] = None,
                    skip_ranges: Optional[Sequence[Tuple[int, int]]] = None,
                    cross: bool = False) -> torch.Tensor:
    """Attention of q [B, Sq, N, D] over one cache layer k, v [B*N, S, D]
    with bias [B, S] float32.  Returns [B, Sq, N, D] in q's dtype.

    ``q_rope=(cos, sin)``, each [Sq, D/2] float32: q is un-roped (the RMS
    premul already applied) and is rotated in the kernel (halfsplit
    layout; see ``rope_scaled_q``).

    ``qk_int8``: QK^T runs on int8 q and K.  The kernel quantizes the
    scaled q in its prologue, bit for bit as the plain pass
    ``quantize_k_tokens(_scaled_q(q, scale))`` (``kernel_quantized_q``
    shows it).  K is either the int8 cache layer with its scales
    ``k_scales`` [B*N, S] float32, read in place, or bf16, quantized here
    per call.

    ``k2``/``v2`` [B, S2, N, D] (bf16): a second, fully valid KV segment
    attended after the cache (its ragged tail masked); ``bias`` covers the
    cache only.  ``skip_ranges``: disjoint (start, end) token ranges of the
    cache that the bias masks; the KV tiles they cover completely are not
    read at all (``live_kv_tiles``).  Neither combines with ``q_rope``.

    ``LONGLIVE_EXP2=1`` and ``LONGLIVE_MXU_LSUM=1`` (see ``switches``)
    select the exp2 and the row-sum-on-tensor-core arithmetic in any mode.

    ``cross``: the call is a cross-attention (k, v the prompt's K/V, a zero
    bias); its launch counts under ``mode_launches["cross"]``.

    The kernel's (query tile, head) items that would fill only part of its
    last wave are each split over several CTAs along the KV tiles
    (``split_plan``); the last CTA of such an item merges the parts.

    CPU tensors run the plain version.  CUDA tensors launch the kernel,
    which takes bf16 q/v/k2/v2 (and K unless int8), D = 128, contiguous
    16-byte-aligned operands and a float32 bias; anything else raises
    ValueError."""
    _check_modes(q_rope, qk_int8, k_scales, k2, v2, skip_ranges)
    exp2, mxu_lsum = switches()
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias, q_rope, qk_int8, k_scales, k2, v2,
                                     skip_ranges, exp2, mxu_lsum)
    global launches
    b, sq, n, d = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if d != 128:
        raise ValueError(f"flash_attention: head dim {d} unsupported (kernel takes 128)")
    s = k.shape[1] if k.dim() == 3 else -1
    k_dtype = torch.int8 if k_scales is not None else torch.bfloat16
    _check_operand("q", q, torch.bfloat16, (b, sq, n, d), q.device)
    _check_operand("k", k, k_dtype, (b * n, s, d), q.device)
    _check_operand("v", v, torch.bfloat16, (b * n, s, d), q.device)
    if (bias.dtype != torch.float32 or bias.shape != (b, s)
            or not bias.is_contiguous() or bias.device != q.device):
        raise ValueError(f"flash_attention: bias must be contiguous float32 [{b}, {s}] "
                         f"on {q.device}, got {bias.dtype} {tuple(bias.shape)}")
    if k_scales is not None:
        _check_operand("k_scales", k_scales, torch.float32, (b * n, s), q.device)
    s2 = 0
    if k2 is not None:
        s2 = k2.shape[1] if k2.dim() == 4 else -1
        _check_operand("k2", k2, torch.bfloat16, (b, s2, n, d), q.device)
        _check_operand("v2", v2, torch.bfloat16, (b, s2, n, d), q.device)
    if s + s2 == 0:
        raise ValueError("flash_attention: no KV tokens")
    cos_ptr = sin_ptr = None
    if q_rope is not None:
        for name, t in zip(("cos", "sin"), q_rope):
            if (t.dtype != torch.float32 or t.shape != (sq, d // 2) or not t.is_contiguous()
                    or t.data_ptr() % 16 or t.device != q.device):
                raise ValueError(f"flash_attention: q_rope {name} must be contiguous, "
                                 f"16-byte aligned float32 [{sq}, {d // 2}] on {q.device}, got "
                                 f"{t.dtype} {tuple(t.shape)} on {t.device}")
        cos_ptr, sin_ptr = q_rope[0].data_ptr(), q_rope[1].data_ptr()
    live, live_tiles = _LiveTiles(), -(-s // KERNEL_KV_TILE)
    if skip_ranges is not None:
        tiles = live_kv_tiles(skip_ranges, s)
        live, live_tiles = _live_mask(tiles, s), sum(kernel_live_tiles(tiles))
    ksc = k2sc = None
    if qk_int8:  # q is quantized in the kernel's prologue
        k, ksc = (k, k_scales) if k_scales is not None else quantize_k_tokens(k)
        if k2 is not None:
            k2, k2sc = quantize_k_tokens(k2)
    out = torch.empty((b, sq, n, d), dtype=torch.bfloat16, device=q.device)
    mode = ("two_segment" if k2 is not None else "qk_int8" if qk_int8
            else "q_rope" if q_rope is not None else "cross" if cross else "bias")
    items = -(-sq // KERNEL_Q_TILE) * b * n
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    nfull, ksplit = split_plan(items, sms, live_tiles + -(-s2 // KERNEL_KV_TILE))
    part = counters = None
    if nfull < items:
        part = torch.empty(((items - nfull) * ksplit * KERNEL_Q_TILE * (d + 2),),
                           dtype=torch.float32, device=q.device)
        counters = _split_counters(q.device, items - nfull)
    _launch(q, k, ksc, v, bias, cos_ptr, sin_ptr, k2, k2sc, v2, live,
            skip_ranges is not None, out, None, None, (nfull, ksplit, part, counters), s, s2,
            softmax_scale(d, exp2), qk_int8, exp2, mxu_lsum, mode)
    launches += 1
    mode_launches[mode] += 1
    flag_launches["exp2"] += int(exp2)
    flag_launches["mxu_lsum"] += int(mxu_lsum)
    return out


def flash_attention_unmasked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             cross: bool = False) -> torch.Tensor:
    """``flash_attention`` of q [B, Sq, N, D] over every token of k, v
    [B, S, N, D] (a zero bias), the K/V moved into its [B*N, S, D] layout
    for the call."""
    b, s, n, d = k.shape

    def heads(a):
        return a.to(q.dtype).transpose(1, 2).contiguous().view(b * n, s, d)

    bias = torch.zeros((b, s), dtype=torch.float32, device=q.device)
    return flash_attention(q.contiguous(), heads(k), heads(v), bias, cross=cross)


_COUNTERS = {}  # (device, stream) -> the kernel's split counters, zero between calls


def _split_counters(device, n: int) -> torch.Tensor:
    """n int32 zeros for the kernel's split items on the current stream.
    The kernel leaves them zero (the CTA that merges an item resets its
    count), so one buffer serves every later call on that stream and a
    call launches nothing but the kernel."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros((max(n, 1024),), dtype=torch.int32, device=device)
    return buf


def _launch(q, k, ksc, v, bias, cos_ptr, sin_ptr, k2, k2sc, v2, live, use_skip, out, q8_out,
            qs_out, split, s, s2, scale, qk_int8, exp2, mxu_lsum, what) -> None:
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    b, sq, n, _ = q.shape
    nfull, ksplit, part, counters = split
    lib = kernels.load("flash_attention")
    fn = lib.longlive_flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 10 + [_LiveTiles, ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    rc = fn(q.data_ptr(), k.data_ptr(), ptr(ksc), v.data_ptr(), bias.data_ptr(), cos_ptr,
            sin_ptr, ptr(k2), ptr(k2sc), ptr(v2), live, int(use_skip), out.data_ptr(),
            ptr(q8_out), ptr(qs_out), nfull, ksplit, ptr(part), ptr(counters), b, sq, n, s, s2,
            scale, int(qk_int8), int(exp2), int(mxu_lsum),
            torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(lib, rc, f"flash_attention ({what})")


def kernel_quantized_q(q: torch.Tensor, exp2: bool = False):
    """The qk_int8 mode's q as the kernel's prologue quantizes it: (q8
    [B, Sq, N, D] int8, scales [B, Sq, N] float32), which must equal the
    plain pass ``quantize_k_tokens(_scaled_q(q, scale))`` bit for bit.
    Launches the kernel once over a one-token cache (not counted in
    ``launches``).  q: bf16 [B, Sq, N, 128] on a CUDA device."""
    b, sq, n, d = q.shape
    _check_operand("q", q, torch.bfloat16, (b, sq, n, 128), q.device)
    k = torch.zeros((b * n, 1, d), dtype=torch.int8, device=q.device)
    ksc = torch.ones((b * n, 1), dtype=torch.float32, device=q.device)
    v = torch.zeros((b * n, 1, d), dtype=torch.bfloat16, device=q.device)
    bias = torch.zeros((b, 1), dtype=torch.float32, device=q.device)
    q8 = torch.empty((b, sq, n, d), dtype=torch.int8, device=q.device)
    qs = torch.empty((b, sq, n), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    items = -(-sq // KERNEL_Q_TILE) * b * n
    _launch(q, k, ksc, v, bias, None, None, None, None, None, _LiveTiles(), False, out, q8, qs,
            (items, 1, None, None), 1, 0, softmax_scale(d, exp2), True, exp2, False,
            "q quantize")
    return q8, qs


# ---------------------------------------------------------------------------
# full-sequence self-attention under a frame-structured mask


def _check_mask_kind(mask_kind: str) -> None:
    if mask_kind not in masked_launches:
        raise ValueError(f"flash_attention_frame_masked: unknown mask_kind {mask_kind!r} "
                         f"(one of {', '.join(masked_launches)})")


def _tf_part(lo: torch.Tensor, hi: torch.Tensor, start: int, end: int, blk: int):
    """(exists, first block, last block) of the tokens of [lo, hi) that lie
    in one half [start, end) of the [clean | noisy] sequence, block ids
    counted from the half's start (``blk`` tokens per block)."""
    a, b = torch.clamp(lo, min=start), torch.clamp(hi, max=end)
    return b > a, (a - start) // blk, (b - 1 - start) // blk


def frame_mask_live_tiles(kind: str, sq: int, skv: int, block_q: int, block_kv: int,
                          frame_seq: int, nfb: int = 1, local: int = -1, sink: int = 0,
                          clean_frames: int = 0) -> torch.Tensor:
    """[ceil(sq / block_q), ceil(skv / block_kv)] bool on the CPU: tile (iq,
    ikv), tokens [iq * block_q, (iq + 1) * block_q) x [ikv * block_kv, ...),
    is live when the mask ``kind`` leaves any (q, kv) pair of it unmasked
    or it holds a q == kv pair (the JAX package's ``_frame_mask_tile_arrays``'
    ``live``, at any tile size).  The ranges are whole tiles: a ragged last
    tile counts its padding as the JAX package counts its padded tokens, so
    some live tiles hold no unmasked pair (the kernel masks kv >= skv).
    Block-causal and sink-window work on frame ranges; teacher forcing on the
    block ranges of each tile's clean and noisy parts, padding excluded."""
    _check_mask_kind(kind)
    nq, nkv = -(-sq // block_q), -(-skv // block_kv)
    q_lo = torch.arange(nq, dtype=torch.int64)[:, None] * block_q
    k_lo = torch.arange(nkv, dtype=torch.int64)[None, :] * block_kv
    q_hi, k_hi = q_lo + block_q, k_lo + block_kv
    if kind == "teacher_forcing":
        cl, blk = clean_frames * frame_seq, frame_seq * nfb
        qc, qc0, qc1 = _tf_part(q_lo, q_hi, 0, cl, blk)
        qn, qn0, qn1 = _tf_part(q_lo, q_hi, cl, 2 * cl, blk)
        kc, kc0, _ = _tf_part(k_lo, k_hi, 0, cl, blk)
        kn, kn0, kn1 = _tf_part(k_lo, k_hi, cl, 2 * cl, blk)
        alive = ((qc & kc & (kc0 <= qc1)) | (qn & kn & (kn0 <= qn1) & (kn1 >= qn0))
                 | (qn & kc & (kc0 < qn1)))
    else:
        qf_lo, qf_hi = q_lo // frame_seq, (q_hi - 1) // frame_seq
        kf_lo, kf_hi = k_lo // frame_seq, (k_hi - 1) // frame_seq
        ends_lo, ends_hi = (qf_lo // nfb + 1) * nfb, (qf_hi // nfb + 1) * nfb
        if kind == "block_causal":
            alive = (kf_hi >= (ends_lo - local if local != -1 else 0)) & (kf_lo < ends_hi)
        else:
            alive = ((kf_lo < torch.clamp(ends_hi, max=sink))
                     | ((kf_hi >= ends_lo - (local - sink)) & (kf_lo < ends_hi)))
    return alive | ((q_lo < k_hi) & (k_lo < q_hi))


def _frame_token_mask(kind: str, qi: torch.Tensor, ki: torch.Tensor, frame_seq: int,
                      nfb: int, local: int, sink: int, clean_frames: int) -> torch.Tensor:
    """[len(qi), len(ki)] bool: the kernel's per-element mask from the token
    indices, q == kv always attended."""
    qi, ki = qi[:, None], ki[None, :]
    if kind == "teacher_forcing":
        cl = clean_frames * frame_seq
        qn, kn = qi >= cl, ki >= cl
        qf = torch.where(qn, qi - cl, qi) // frame_seq
        kf = torch.where(kn, ki - cl, ki) // frame_seq
        qb, kb = qf // nfb, kf // nfb
        # kv tokens past the [clean | noisy] halves (kf >= clean_frames)
        # never count as the last noisy block's
        mask = (((~qn & ~kn & (kb <= qb)) | (qn & kn & (kb == qb)) | (qn & ~kn & (kb < qb)))
                & (kf < clean_frames))
    else:
        kf = ki // frame_seq
        ends = (qi // frame_seq // nfb + 1) * nfb
        mask = kf < ends
        if kind == "block_causal" and local != -1:
            mask = mask & (kf >= ends - local)
        elif kind == "sink_window":
            mask = mask & ((kf < sink) | (kf >= ends - (local - sink)))
    return mask | (qi == ki)


def flash_attention_frame_masked_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                       mask_kind: str, frame_seq: int, nfb: int = 1,
                                       local: int = -1, sink: int = 0,
                                       clean_frames: int = 0) -> torch.Tensor:
    """The kernel's arithmetic: q is scaled by 1/sqrt(D) in float32 and
    rounded to its dtype, the logits are float32 with the masked ones set to
    -1e30, P = exp(s - m) in float32 with the row max m, the row sum l is
    taken over the unrounded P, P V over P rounded to V's dtype, and the
    output is divided by max(l, 1e-30).  At most ``_MASKED_PLAIN_ROWS``
    query rows and one head at a time, so a 65520-token call holds ~2 GB
    of logits.

    q, k, v: [B, S, N, D].  Returns [B, Sq, N, D] in q's dtype."""
    _check_mask_kind(mask_kind)
    b, sq, n, d = q.shape
    skv = k.shape[1]
    qs = _scaled_q(q, 1.0 / math.sqrt(d))
    ki = torch.arange(skv, device=q.device)
    out = torch.empty_like(q)
    for r0 in range(0, sq, _MASKED_PLAIN_ROWS):
        r1 = min(r0 + _MASKED_PLAIN_ROWS, sq)
        mask = _frame_token_mask(mask_kind, torch.arange(r0, r1, device=q.device), ki,
                                 frame_seq, nfb, local, sink, clean_frames)
        for bi in range(b):
            for h in range(n):
                s = (qs[bi, r0:r1, h].float() @ k[bi, :, h].float().T).masked_fill(~mask, NEG_INF)
                p = torch.exp(s - s.amax(dim=-1, keepdim=True))
                l = p.sum(dim=-1, keepdim=True)
                o = (p.to(v.dtype).float() @ v[bi, :, h].float()) / l.clamp_min(1e-30)
                out[bi, r0:r1, h] = o.to(q.dtype)
    return out


_MASK_KIND_IDS = {"block_causal": 0, "sink_window": 1, "teacher_forcing": 2}


def frame_mask_cta_order(kind: str, sq: int, skv: int, frame_seq: int, nfb: int = 1,
                         local: int = -1, sink: int = 0, clean_frames: int = 0) -> torch.Tensor:
    """The order in which the kernel's CTAs take their q tiles (int32 on
    the CPU, a permutation of the ``ceil(sq / MASKED_TILE_Q)`` tiles):
    descending live-tile count (``frame_mask_live_tiles`` at the kernel's
    tiles), ties in tile order.  The heaviest CTAs then start in the first
    wave and the light ones fill the tail.  (With elision off every CTA
    walks every tile, and the order changes nothing.)"""
    live = frame_mask_live_tiles(kind, sq, skv, MASKED_TILE_Q, MASKED_TILE_KV, frame_seq, nfb,
                                 local, sink, clean_frames)
    return torch.argsort(-live.sum(dim=1), stable=True).to(torch.int32)


@functools.lru_cache(maxsize=64)
def _cta_order_on(device: torch.device, *args) -> torch.Tensor:
    """``frame_mask_cta_order(*args)`` on ``device``, made once per geometry
    (copied from pinned memory without a host wait)."""
    return frame_mask_cta_order(*args).pin_memory().to(device, non_blocking=True)


def _frame_masked_launch(qs, k, v, out, order, mask_kind, frame_seq, nfb, local, sink,
                         clean_frames, elide) -> None:
    """One launch of the kernel on the scaled q ``qs``, its q tiles taken in
    ``order`` (int32 on q's device)."""
    b, sq, n, _ = qs.shape
    lib = kernels.load("flash_attention_masked")
    fn = lib.longlive_flash_masked
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    rc = fn(qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), order.data_ptr(), b, sq,
            k.shape[1], n, _MASK_KIND_IDS[mask_kind], frame_seq, nfb, local, sink, clean_frames,
            int(elide), _stream(qs))
    kernels.check(lib, rc, f"flash_attention_frame_masked ({mask_kind})")


def flash_attention_frame_masked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                 mask_kind: str = "block_causal", frame_seq: int,
                                 nfb: int = 1, local: int = -1, sink: int = 0,
                                 clean_frames: int = 0,
                                 elide_dead_tiles: Optional[bool] = None) -> torch.Tensor:
    """Self-attention of q over k, v, each [B, S, N, D], under the frame
    mask ``mask_kind`` (``frame_seq`` tokens per frame, blocks of ``nfb``
    frames):

    - ``block_causal``: kv frame < the end of q's block, and within the last
      ``local`` frames of it unless ``local`` is -1;
    - ``sink_window``: kv frame < the end of q's block, and a sink frame
      (< ``sink``) or within the last ``local - sink`` frames;
    - ``teacher_forcing``: [clean | noisy] of ``clean_frames`` frames each;
      clean attends clean causally by block, a noisy block its own noisy
      frames and the clean blocks before it, kv tokens past both halves
      never;

    and every token attends itself.  ``elide_dead_tiles`` (None: the
    ``LONGLIVE_TF_ELIDE`` switch, read here at each call as the JAX package
    reads it, default on) makes the kernel skip the tiles no unmasked pair
    touches (``frame_mask_live_tiles``); it changes no bit, and the plain
    version has nothing to skip.  Returns [B, Sq, N, D] in q's dtype.

    Forward only: with gradients enabled on an input that requires them it
    raises ValueError (the JAX package's kernel has no gradient either).
    CPU tensors run the plain version.  CUDA tensors launch the kernel,
    which takes contiguous, 16-byte aligned bf16 operands with D = 128 and
    at most ``MASKED_MAX_KV_TILES * MASKED_TILE_KV`` kv tokens; anything
    else raises ValueError."""
    _check_mask_kind(mask_kind)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise ValueError("flash_attention_frame_masked is forward only: call it under "
                         "torch.no_grad() or on inputs that do not require grad")
    if frame_seq < 1 or nfb < 1:
        raise ValueError(f"flash_attention_frame_masked: frame_seq {frame_seq} and nfb {nfb} "
                         "must be positive")
    if elide_dead_tiles is None:
        elide_dead_tiles = os.environ.get("LONGLIVE_TF_ELIDE", "1") == "1"
    kw = dict(mask_kind=mask_kind, frame_seq=frame_seq, nfb=nfb, local=local, sink=sink,
              clean_frames=clean_frames)
    if q.device.type == "cpu":
        return flash_attention_frame_masked_plain(q, k, v, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_frame_masked: unsupported device {q.device}")
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError("flash_attention_frame_masked: q, k, v must be [B, S, N, D]")
    b, sq, n, d = q.shape
    skv = k.shape[1]
    if d != 128:
        raise ValueError(f"flash_attention_frame_masked: head dim {d} unsupported "
                         "(the kernel takes 128)")
    if sq < 1 or skv < 1 or -(-skv // MASKED_TILE_KV) > MASKED_MAX_KV_TILES:
        raise ValueError(f"flash_attention_frame_masked: {sq} query and {skv} kv tokens "
                         f"(the kernel takes 1 to {MASKED_MAX_KV_TILES * MASKED_TILE_KV} kv)")
    for name, t, shape in (("q", q, (b, sq, n, d)), ("k", k, (b, skv, n, d)),
                           ("v", v, (b, skv, n, d))):
        _check_operand(name, t, torch.bfloat16, shape, q.device)
    qs = _scaled_q(q, 1.0 / math.sqrt(d))
    out = torch.empty_like(q)
    order = _cta_order_on(q.device, mask_kind, sq, skv, frame_seq, nfb, local, sink,
                          clean_frames)
    _frame_masked_launch(qs, k, v, out, order, mask_kind, frame_seq, nfb, local, sink,
                         clean_frames, elide_dead_tiles)
    masked_launches[mask_kind] += 1
    return out


# ---------------------------------------------------------------------------
# differentiable attention for the training paths


def _kv_valid_2d(kv_valid: Optional[torch.Tensor], b: int, skv: int,
                 device) -> Optional[torch.Tensor]:
    """kv_valid [Skv] or [B, Skv] -> bool [B, Skv] on ``device`` (None stays None)."""
    if kv_valid is None:
        return None
    valid = kv_valid.to(device=device, dtype=torch.bool)
    if valid.ndim == 1:
        valid = valid[None]
    if valid.shape[-1] != skv:
        raise ValueError(f"kv_valid covers {valid.shape[-1]} tokens, k has {skv}")
    return valid.expand(b, skv)


def flash_attention_train_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                kv_valid: Optional[torch.Tensor] = None):
    """The forward kernel's arithmetic: logits (q.k) * scale in float32
    (float64 for float64 inputs), masked tokens excluded, P rounded to V's
    dtype for P V while the row sum takes the unrounded P.  A row with no
    valid token gives zeros and lse = EMPTY_LSE.  One head and at most
    ``_PLAIN_ROWS`` query rows at a time, so the critic's 32760 x 32760
    logits never exist at once.

    q: [B, Sq, N, D]; k, v: [B, Skv, N, D]; kv_valid: bool [Skv] or
    [B, Skv] (None = all valid).  Returns (out [B, Sq, N, D] in q's dtype,
    lse [B, N, Sq])."""
    b, sq, n, d = q.shape
    skv = k.shape[1]
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / math.sqrt(d)
    valid = _kv_valid_2d(kv_valid, b, skv, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((b, n, sq), dtype=acc, device=q.device)
    for bi in range(b):
        for h in range(n):
            kf, vf = k[bi, :, h].to(acc), v[bi, :, h].to(acc)
            for r0 in range(0, sq, _PLAIN_ROWS):
                rows = slice(r0, min(r0 + _PLAIN_ROWS, sq))
                s = (q[bi, rows, h].to(acc) @ kf.T) * scale
                if valid is not None:
                    s = s.masked_fill(~valid[bi], NEG_INF)
                m = s.amax(dim=-1, keepdim=True)
                p = torch.exp(s - m)
                if valid is not None:
                    p = p * valid[bi]
                l = p.sum(dim=-1, keepdim=True)
                empty = l == 0
                o = (p.to(v.dtype).to(acc) @ vf) / torch.where(empty, 1.0, l)
                out[bi, rows, h] = o.to(q.dtype)
                lse[bi, h, rows] = torch.where(empty, EMPTY_LSE, m + torch.log(l))[:, 0]
    return out, lse


def flash_attention_train_backward_plain(q, k, v, out, lse, dout,
                                         kv_valid: Optional[torch.Tensor] = None):
    """The backward kernels' arithmetic: P = exp(s - lse) recomputed (0
    where masked), Delta = rowsum(dO * O), dV = P^T dO with P rounded to
    V's dtype, dP = dO V^T, dS = P (dP - Delta) rounded to q's dtype,
    dQ = scale dS K and dK = scale dS^T Q.  Chunked like the forward.
    Returns (dq, dk, dv) in the dtypes of q, k, v."""
    b, sq, n, d = q.shape
    skv = k.shape[1]
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / math.sqrt(d)
    valid = _kv_valid_2d(kv_valid, b, skv, q.device)
    delta = (dout.to(acc) * out.to(acc)).sum(dim=-1)  # [B, Sq, N]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for bi in range(b):
        for h in range(n):
            kf, vf = k[bi, :, h].to(acc), v[bi, :, h].to(acc)
            dk_acc = torch.zeros((skv, d), dtype=acc, device=q.device)
            dv_acc = torch.zeros((skv, d), dtype=acc, device=q.device)
            for r0 in range(0, sq, _PLAIN_ROWS):
                rows = slice(r0, min(r0 + _PLAIN_ROWS, sq))
                qf, dof = q[bi, rows, h].to(acc), dout[bi, rows, h].to(acc)
                p = torch.exp((qf @ kf.T) * scale - lse[bi, h, rows, None].to(acc))
                if valid is not None:
                    p = p * valid[bi]
                dv_acc += p.to(v.dtype).to(acc).T @ dof
                ds = p * (dof @ vf.T - delta[bi, rows, h, None])
                ds = ds.to(q.dtype).to(acc)
                dq[bi, rows, h] = (ds @ kf * scale).to(q.dtype)
                dk_acc += ds.T @ qf
            dk[bi, :, h] = (dk_acc * scale).to(k.dtype)
            dv[bi, :, h] = dv_acc.to(v.dtype)
    return dq, dk, dv


def train_kv_tile_states(kv_valid: Optional[torch.Tensor], skv: int,
                         tile: int) -> torch.Tensor:
    """The training kernels' rule for kv tiles of ``tile`` tokens: TILE_DEAD
    (no valid token: skipped), TILE_FULL (``tile`` valid tokens, all below
    Skv: no per-token mask) or TILE_PARTIAL.  kv_valid: bool [Skv] or
    [B, Skv] (None = all valid).  Returns int8 [B, ceil(Skv / tile)], B = 1
    unless kv_valid is [B, Skv]."""
    if kv_valid is None:
        valid = torch.ones((1, skv), dtype=torch.bool)
    else:
        valid = kv_valid.to(torch.bool).reshape(-1, skv)
    ntiles = -(-skv // tile)
    padded = torch.zeros((valid.shape[0], ntiles * tile), dtype=torch.bool, device=valid.device)
    padded[:, :skv] = valid
    count = padded.view(-1, ntiles, tile).sum(dim=-1)
    return torch.where(count == 0, TILE_DEAD,
                       torch.where(count == tile, TILE_FULL, TILE_PARTIAL)).to(torch.int8)


def train_kv_tiles() -> dict:
    """The training kernels' kv tiles, read from their library (so it
    needs the CUDA toolkit): tokens per forward tile ("fwd"), per dQ tile
    ("bwd_dq"), kv rows per dK/dV CTA ("bwd_dkdv"), and the most tiles a
    forward or dQ CTA lists ("max_listed"; past it, it walks every tile)."""
    out = (ctypes.c_int * 4)()
    kernels.load("flash_attention_train").longlive_flash_train_kv_tiles(out)
    return dict(zip(("fwd", "bwd_dq", "bwd_dkdv", "max_listed"), out))


def _check_train_operand(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"flash_attention_train: {name} is on {t.device}, q on {device}")
    if t.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention_train: {name} must be bf16, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"flash_attention_train: {name} must be {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"flash_attention_train: {name} must be contiguous and "
                         "16-byte aligned")


def _train_geometry(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(B, Sq, Skv, N) after checking what the kernels take: bf16,
    contiguous [B, S, N, 128] on one CUDA device, at least one kv token."""
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError("flash_attention_train: q, k, v must be [B, S, N, D]")
    b, sq, n, d = q.shape
    if d != 128:
        raise ValueError(f"flash_attention_train: head dim {d} unsupported "
                         "(the kernels take 128)")
    skv = k.shape[1]
    if skv < 1 or sq < 1:
        raise ValueError("flash_attention_train: empty q or kv")
    _check_train_operand("q", q, (b, sq, n, d), q.device)
    _check_train_operand("k", k, (b, skv, n, d), q.device)
    _check_train_operand("v", v, (b, skv, n, d), q.device)
    return b, sq, skv, n


def _train_mask(kv_valid: Optional[torch.Tensor], b: int, skv: int, device):
    """The kernels' mask operand: contiguous uint8 [B, Skv], or None."""
    valid = _kv_valid_2d(kv_valid, b, skv, device)
    return None if valid is None else valid.to(torch.uint8).contiguous()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_train_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  kv_valid: Optional[torch.Tensor] = None):
    """(out, lse) of ``flash_attention_train``'s forward: the plain version
    for CPU tensors, the forward kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return flash_attention_train_plain(q, k, v, kv_valid)
    b, sq, skv, n = _train_geometry(q, k, v)
    mask = _train_mask(kv_valid, b, skv, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
    lib = kernels.load("flash_attention_train")
    fn = lib.longlive_flash_train_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                                ctypes.c_void_p]
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, sq, skv, n, 1.0 / math.sqrt(q.shape[-1]),
            _stream(q))
    kernels.check(lib, rc, "flash_attention_train forward")
    train_launches["fwd"] += 1
    return out, lse


def _train_backward_operands(q, k, v, out, lse, dout, kv_valid):
    """((B, Sq, Skv, N), the mask operand or None) after checking the
    backward's operands.  The caller keeps the mask alive while a kernel
    reads it."""
    b, sq, skv, n = _train_geometry(q, k, v)
    mask = _train_mask(kv_valid, b, skv, q.device)
    _check_train_operand("out", out, q.shape, q.device)
    _check_train_operand("dout", dout, q.shape, q.device)
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, n, sq) or not lse.is_contiguous():
        raise ValueError("flash_attention_train: lse must be contiguous float32 [B, N, Sq]")
    return (b, sq, skv, n), mask


def flash_attention_train_backward_dq(q, k, v, out, lse, dout,
                                      kv_valid: Optional[torch.Tensor] = None):
    """(dq, delta) from the backward's first kernel (CUDA tensors only);
    delta = rowsum(dO * O) [B, N, Sq] feeds the second."""
    (b, sq, skv, n), mask = _train_backward_operands(q, k, v, out, lse, dout, kv_valid)
    mask_ptr = None if mask is None else mask.data_ptr()
    dq, delta = torch.empty_like(q), torch.empty_like(lse)
    lib = kernels.load("flash_attention_train")
    fn = lib.longlive_flash_train_bwd_dq
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                                ctypes.c_void_p]
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, sq, skv, n,
            1.0 / math.sqrt(q.shape[-1]), _stream(q))
    kernels.check(lib, rc, "flash_attention_train backward (dq)")
    train_launches["bwd_dq"] += 1
    return dq, delta


def flash_attention_train_backward_dkdv(q, k, v, out, lse, dout, delta,
                                        kv_valid: Optional[torch.Tensor] = None):
    """(dk, dv) from the backward's second kernel (CUDA tensors only), with
    ``delta`` from ``flash_attention_train_backward_dq``."""
    (b, sq, skv, n), mask = _train_backward_operands(q, k, v, out, lse, dout, kv_valid)
    mask_ptr = None if mask is None else mask.data_ptr()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = kernels.load("flash_attention_train")
    fn = lib.longlive_flash_train_bwd_dkdv
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                                ctypes.c_void_p]
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, skv, n,
            1.0 / math.sqrt(q.shape[-1]), _stream(q))
    kernels.check(lib, rc, "flash_attention_train backward (dk, dv)")
    train_launches["bwd_dkdv"] += 1
    return dk, dv


def flash_attention_train_backward(q, k, v, out, lse, dout,
                                   kv_valid: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of ``flash_attention_train``: the plain version for CPU
    tensors, the dQ kernel then the dK/dV kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return flash_attention_train_backward_plain(q, k, v, out, lse, dout, kv_valid)
    dq, delta = flash_attention_train_backward_dq(q, k, v, out, lse, dout, kv_valid)
    dk, dv = flash_attention_train_backward_dkdv(q, k, v, out, lse, dout, delta, kv_valid)
    return dq, dk, dv


class _FlashAttentionTrain(torch.autograd.Function):
    """CPU tensors: the plain versions.  CUDA tensors: the kernels, which
    raise ValueError for operands they cannot take (never a plain
    fallback)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid):
        valid = _kv_valid_2d(kv_valid, q.shape[0], k.shape[1], q.device)
        out, lse = flash_attention_train_forward(q, k, v, valid)
        ctx.save_for_backward(q, k, v, out, lse, valid)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, valid = ctx.saved_tensors
        return flash_attention_train_backward(q, k, v, out, lse, dout.contiguous(), valid) + (
            None,)


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable softmax(q k^T / sqrt(D), kv-masked) v: q [B, Sq, N, D],
    k, v [B, Skv, N, D], kv_valid bool [Skv] or [B, Skv] (None = all
    valid).  Returns [B, Sq, N, D] in q's dtype; gradients reach q, k, v.

    CPU tensors run the plain versions.  CUDA tensors launch the kernels,
    which take contiguous, 16-byte aligned bf16 operands with D = 128;
    anything else raises ValueError."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention_train: unsupported device {q.device}")
    return _FlashAttentionTrain.apply(q, k, v, kv_valid)


def attend_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_valid: Optional[torch.Tensor] = None, k2: Optional[torch.Tensor] = None,
                 v2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The training route of every attention: with a second, fully valid
    segment ``k2``/``v2`` (the fresh block beside the read-only cache), the
    segments are concatenated and ``kv_valid`` is extended with ones; then
    ``flash_attention_train``."""
    if k2 is not None:
        b = q.shape[0]
        if kv_valid is not None:
            kv_valid = torch.cat([_kv_valid_2d(kv_valid, b, k.shape[1], q.device),
                                  torch.ones((b, k2.shape[1]), dtype=torch.bool,
                                             device=q.device)], dim=1)
        k = torch.cat([k, k2], dim=1)
        v = torch.cat([v, v2], dim=1)
    return flash_attention_train(q, k, v, kv_valid)
