"""Causal Wan DiT, cached forward.

Plain functions over a parameter dict:

- ``blocks`` is a list of per-layer dicts; linears are
  ``{"weight": [out, in], "bias": [out]}``;
- the KV cache is ``ops.kv_cache.KVCache`` ([L, B, N, S, D]); each layer
  writes its block's roped K/V in place at the block's slots (write then
  attend), then the attention kernel reads that layer's rows of the cache
  directly.  A KV-recache passes the slots, the frames to write and the
  attended mask explicitly;
- ``fused_rope``: q's rotation runs in the attention kernel's prologue
  (bf16 cache only);
- int8 serving: block linears quantized by ``ops.quant.quantize_dit_params``
  (and optionally fused into one ``qkv`` linear by ``fuse_qkv_params``);
  an int8 K cache (``kv_int8``) stores each block's roped K quantized once
  and attends with QK^T in int8 with the stored scales; ``qk_int8``
  (the ``pallas_qk8`` recache) quantizes a bf16 cache's K per call;
- RoPE uses absolute frame positions; cross-attention K/V are computed once
  per prompt (``prepare_cross_kv``);
- adaLN: 6-way per-frame modulation per block, 2-way at the head;
- the serving two-segment form (``LONGLIVE_TWO_SEGMENT=1`` on the standard
  decode, not under ``kernel_cache`` nor an int8 K cache): the cache is
  read-only inside the layer loop; each layer attends [its cache rows, the
  block's own slots masked and their tiles elided, ++ the block's fresh
  K/V] in one kernel call, and the block's K/V of every layer are written
  once after the loop (not at all under ``commit_writes=False``);
- the training form (``two_segment=True``): the cache is read-only inside
  the layer loop, each layer attends [cache ++ its fresh block] through the
  differentiable ``attend_train`` (cross-attention too) and returns the
  block's K/V, which are committed once after the loop; ``remat_layers``
  checkpoints each layer;
- the full-sequence forwards (``dit_forward_full``,
  ``dit_forward_teacher_forcing``): no cache, the whole sequence under a
  frame mask, dense with a materialized bias or through the frame-masked
  attention kernel with a ``FrameMaskSpec``.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from ..config import CacheConfig, DiTConfig
from ..ops import kv_cache as kvc
from torch.utils.checkpoint import checkpoint

from ..ops.attention import NEG_INF, attend_train, dense_attention, flash_attention
from ..ops.attention import (flash_attention_frame_masked, flash_attention_train,
                             dequantize_k, flash_attention_unmasked, quantize_k_tokens)
from ..ops.masks import FrameMaskSpec, expand_frame_mask, teacher_forcing_frame_mask
from ..ops.quant import slice_linear
from ..ops.embeddings import sinusoidal_embedding_1d
from ..ops.rope import RopeTables, apply_rotary, halfsplit_qk_perm, rope_multipliers
from . import nn


class CrossKV(NamedTuple):
    """Per-layer cross-attention K/V for one prompt: [L, B, text_len, N, D]."""

    k: torch.Tensor
    v: torch.Tensor


# ---------------------------------------------------------------------------
# parameters


def canonicalize_rope_layout(params: dict, cfg: DiTConfig) -> dict:
    """With ``cfg.rope_layout == "halfsplit"``, permutes the self-attention
    q/k OUTPUT features (weight rows, bias, qk-norm scale) so each head's
    complex pairs are stored (re half ++ im half).  Attention is invariant
    to a consistent q/k channel permutation; apply exactly once."""
    for blk in params["blocks"]:
        _canonicalize_block(blk, cfg)
    return params


def _canonicalize_block(blk: dict, cfg: DiTConfig) -> dict:
    """``canonicalize_rope_layout`` of one block, in place."""
    if cfg.rope_layout != "halfsplit":
        return blk
    perm = torch.as_tensor(halfsplit_qk_perm(cfg.head_dim, cfg.num_heads))
    sa = blk["self_attn"]
    for name in ("q", "k"):
        p = sa[name]
        idx = perm.to(p["weight"].device)
        p["weight"] = p["weight"][idx].contiguous()
        if p.get("bias") is not None:
            p["bias"] = p["bias"][idx].contiguous()
    for name in ("norm_q", "norm_k"):
        if name in sa:
            sa[name]["scale"] = sa[name]["scale"][perm.to(sa[name]["scale"].device)]
    return blk


def init_dit_params(cfg: DiTConfig, dtype=torch.float32, device="cpu",
                    seed: int = 0, zero_head: bool = True,
                    place_block: Optional[Callable[[dict], dict]] = None) -> dict:
    """Random init: xavier-uniform linears with zero bias, N(0, 0.02) text
    and time embeddings, modulation N(0, 1/dim), zero head projection
    unless ``zero_head=False``.  Drawn on ``device`` from a generator seeded
    with ``seed``.  ``model_type == "i2v"`` adds each block's image-branch
    K/V (``k_img``, ``v_img``, ``norm_k_img``) and the ``img_emb``
    projection of the CLIP features, drawn after the rest.
    ``place_block`` takes each block as soon as it is drawn (the host-resident
    init moves it to pinned host memory, so ``device`` holds one block at a
    time); the draws are the same."""
    d, ffn = cfg.dim, cfg.ffn_dim
    pt = math.prod(cfg.patch_size)
    gen = torch.Generator(device=device).manual_seed(seed)

    def lin(d_in, d_out, init="xavier", std=0.02):
        if init == "xavier":
            lim = math.sqrt(6.0 / (d_in + d_out))
            w = (torch.rand((d_out, d_in), generator=gen, device=device) * 2 - 1) * lim
        elif init == "normal":
            w = torch.randn((d_out, d_in), generator=gen, device=device) * std
        else:
            w = torch.zeros((d_out, d_in), device=device)
        return {"weight": w.to(dtype), "bias": torch.zeros(d_out, dtype=dtype, device=device)}

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    def attn():
        p = {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d)}
        if cfg.qk_norm:
            p["norm_q"] = {"scale": ones(d)}
            p["norm_k"] = {"scale": ones(d)}
        return p

    def cross_attn():
        p = attn()
        if cfg.model_type == "i2v":  # the image branch's K/V
            p["k_img"], p["v_img"] = lin(d, d), lin(d, d)
            if cfg.qk_norm:
                p["norm_k_img"] = {"scale": ones(d)}
        return p

    blocks = []
    for _ in range(cfg.num_layers):
        blk = {
            "self_attn": attn(),
            "cross_attn": cross_attn(),
            "ffn": {"fc1": lin(d, ffn), "fc2": lin(ffn, d)},
            "modulation": (torch.randn((6, d), generator=gen, device=device)
                           / math.sqrt(d)).to(dtype),
        }
        if cfg.cross_attn_norm:
            blk["norm3"] = {"scale": ones(d),
                            "bias": torch.zeros(d, dtype=dtype, device=device)}
        _canonicalize_block(blk, cfg)
        blocks.append(blk if place_block is None else place_block(blk))
    params = {
        "patch_embedding": lin(cfg.in_dim * pt, d),
        "text_embedding": {"fc1": lin(cfg.text_dim, d, "normal"),
                           "fc2": lin(d, d, "normal")},
        "time_embedding": {"fc1": lin(cfg.freq_dim, d, "normal"),
                           "fc2": lin(d, d, "normal")},
        "time_projection": {"fc": lin(d, 6 * d)},
        "blocks": blocks,
        "head": {
            "head": lin(d, cfg.out_dim * pt, "zeros" if zero_head else "xavier"),
            "modulation": (torch.randn((2, d), generator=gen, device=device)
                           / math.sqrt(d)).to(dtype),
        },
    }
    if cfg.model_type == "i2v":
        # the CLIP features' projection: LayerNorm, Linear, GELU, Linear, LayerNorm
        cd = cfg.clip_dim
        params["img_emb"] = {
            "ln1": {"scale": ones(cd), "bias": torch.zeros(cd, dtype=dtype, device=device)},
            "fc1": lin(cd, cd), "fc2": lin(cd, d),
            "ln2": {"scale": ones(d), "bias": torch.zeros(d, dtype=dtype, device=device)}}
    return params


# ---------------------------------------------------------------------------
# patching


def patchify(x: torch.Tensor, cfg: DiTConfig) -> torch.Tensor:
    """[B, F, C, H, W] -> [B, F*(H/ph)*(W/pw), C*ph*pw], channel-major patch
    order and (f, h, w) token order."""
    pt, ph, pw = cfg.patch_size
    assert pt == 1, "temporal patch 1"
    b, f, c, h, w = x.shape
    x = x.reshape(b, f, c, h // ph, ph, w // pw, pw)
    x = x.permute(0, 1, 3, 5, 2, 4, 6)
    return x.reshape(b, f * (h // ph) * (w // pw), c * ph * pw)


def unpatchify(tokens: torch.Tensor, cfg: DiTConfig, f: int, h: int, w: int) -> torch.Tensor:
    """[B, S, out*ph*pw] -> [B, F, C_out, H, W]."""
    pt, ph, pw = cfg.patch_size
    b = tokens.shape[0]
    hp, wp = h // ph, w // pw
    x = tokens.reshape(b, f, hp, wp, pt, ph, pw, cfg.out_dim)
    x = x.permute(0, 1, 7, 2, 5, 3, 6, 4).squeeze(-1)
    return x.reshape(b, f, cfg.out_dim, h, w)


# ---------------------------------------------------------------------------
# conditioning


def time_modulation(params: dict, cfg: DiTConfig, t: torch.Tensor, dtype):
    """t: [B, F] -> (e [B, F, dim], e0 [B, F, 6, dim])."""
    b, f = t.shape
    emb = sinusoidal_embedding_1d(cfg.freq_dim, t.reshape(-1)).to(dtype)
    te = params["time_embedding"]
    e = nn.linear(nn.silu(nn.linear(emb, te["fc1"])), te["fc2"])
    e0 = nn.linear(nn.silu(e), params["time_projection"]["fc"])
    return e.reshape(b, f, cfg.dim).to(dtype), e0.reshape(b, f, 6, cfg.dim).to(dtype)


def embed_text(params: dict, prompt_embeds: torch.Tensor, dtype) -> torch.Tensor:
    """Text features [B, text_len, text_dim] -> context [B, text_len, dim];
    zero padding rows participate in cross-attention."""
    p = params["text_embedding"]
    x = prompt_embeds.to(dtype)
    return nn.linear(nn.gelu_tanh(nn.linear(x, p["fc1"])), p["fc2"])


def prepare_cross_kv(params: dict, cfg: DiTConfig, prompt_embeds: torch.Tensor,
                     dtype=torch.bfloat16) -> CrossKV:
    """Per-layer cross-attention K/V for a prompt, computed once."""
    ctx = embed_text(params, prompt_embeds, dtype)
    ks, vs = zip(*(layer_cross_kv(blk["cross_attn"], cfg, ctx) for blk in params["blocks"]))
    return CrossKV(k=torch.stack(ks), v=torch.stack(vs))


def layer_cross_kv(cross_p: dict, cfg: DiTConfig,
                   ctx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's cross-attention K/V [B, text_len, N, D] from the embedded
    text ``ctx`` (``embed_text``) and the layer's ``cross_attn`` weights."""
    n, hd = cfg.num_heads, cfg.head_dim
    b, s, _ = ctx.shape
    k = nn.linear(ctx, cross_p["k"])
    if cfg.qk_norm:
        k = nn.rms_norm(k, cross_p["norm_k"]["scale"], cfg.eps)
    return k.reshape(b, s, n, hd), nn.linear(ctx, cross_p["v"]).reshape(b, s, n, hd)


# ---------------------------------------------------------------------------
# transformer layer


def _per_frame(x: torch.Tensor, f: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, f, s // f, d)


def _flat(x: torch.Tensor) -> torch.Tensor:
    b, f, fs, d = x.shape
    return x.reshape(b, f * fs, d)


def _projections(layer_p: dict, cfg: DiTConfig, x: torch.Tensor, kv_only: bool = False):
    """(q or None, k, v) of the block's self-attention, each [B, S, dim].
    A fused ``qkv`` linear runs once (only its k and v rows for
    ``kv_only``)."""
    if "qkv" in layer_p:
        d = cfg.dim
        if kv_only:
            kv = nn.linear(x, slice_linear(layer_p["qkv"], d, 3 * d))
            return None, kv[..., :d], kv[..., d:]
        qkv = nn.linear(x, layer_p["qkv"])
        return qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    k = nn.linear(x, layer_p["k"])
    v = nn.linear(x, layer_p["v"])
    return (None if kv_only else nn.linear(x, layer_p["q"])), k, v


def _rope_k(layer_p: dict, cfg: DiTConfig, k: torch.Tensor, rope_cos: torch.Tensor,
            rope_sin: torch.Tensor) -> torch.Tensor:
    """Roped K [B, S, N, D], the RMS scale fused into RoPE's float32 premul."""
    b, s, _ = k.shape
    k_pre = nn.rms_scale(k, layer_p["norm_k"]["scale"], cfg.eps) if cfg.qk_norm else None
    return apply_rotary(k.reshape(b, s, cfg.num_heads, cfg.head_dim), rope_cos, rope_sin,
                        premul=k_pre, layout=cfg.rope_layout)


def _self_kv(layer_p: dict, cfg: DiTConfig, x: torch.Tensor, rope_cos: torch.Tensor,
             rope_sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's roped K and V, each [B, S, N, D]."""
    b, s, _ = x.shape
    _, k, v = _projections(layer_p, cfg, x, kv_only=True)
    return (_rope_k(layer_p, cfg, k, rope_cos, rope_sin),
            v.reshape(b, s, cfg.num_heads, cfg.head_dim))


def _attention_layer_cached(
    layer_p: dict, cfg: DiTConfig, cache_cfg: CacheConfig, x: torch.Tensor,
    rope_cos: torch.Tensor, rope_sin: torch.Tensor, cache: kvc.KVCache, layer_idx: int,
    offsets: List[int], write_frames: Tuple[int, ...], bias: torch.Tensor,
    kv_only: bool = False, fused_rope: bool = False, qk_int8: bool = False,
    block_kv: Optional[list] = None, skip_ranges: Optional[List[Tuple[int, int]]] = None,
) -> Optional[torch.Tensor]:
    """Self-attention against the cache: frames ``write_frames`` of the
    block's roped K/V are written in place into layer ``layer_idx`` at token
    offsets ``offsets``, then the queries attend that layer's rows under
    ``bias``.

    ``block_kv`` (a list) selects the serving two-segment form: the cache is
    not written; the block's roped K and V ([B, S, N, D]) are appended to
    the list and attended as the kernel's second segment, with the dead
    cache tiles ``skip_ranges`` elided and q's RoPE never fused.

    An int8 K cache (``cache.k_scale`` set) gets the block's roped K
    quantized once, with its scales, and is attended in the qk_int8 mode
    with the stored scales; ``qk_int8`` on a bf16 cache quantizes K per
    call.  ``fused_rope`` (halfsplit layout, bf16 cache): q gets the RMS
    premul, is rounded to its dtype, and is rotated in the attention
    kernel's prologue."""
    b, s, _ = x.shape
    n, hd = cfg.num_heads, cfg.head_dim
    q, k, v = _projections(layer_p, cfg, x, kv_only)
    k = _rope_k(layer_p, cfg, k, rope_cos, rope_sin)
    v = v.reshape(b, s, n, hd)
    int8_cache = cache.k_scale is not None
    two_segment = block_kv is not None
    if two_segment:
        block_kv.append((k, v))
    else:
        k_sc = None
        if int8_cache:
            k, k_sc = quantize_k_tokens(k)
        kvc.write_block_kv(cache_cfg, cache, layer_idx, k, v, offsets, write_frames, k_sc)
    if kv_only:
        return None
    q_pre = nn.rms_scale(q, layer_p["norm_q"]["scale"], cfg.eps) if cfg.qk_norm else None
    q_rope = None
    if fused_rope and not two_segment and not int8_cache and cfg.rope_layout == "halfsplit":
        if q_pre is not None:
            q = (q.float() * q_pre).to(q.dtype)
        q = q.reshape(b, s, n, hd)
        q_rope = (rope_cos, rope_sin)
    else:
        q = apply_rotary(q.reshape(b, s, n, hd), rope_cos, rope_sin, premul=q_pre,
                         layout=cfg.rope_layout)
    s_tok = cache.k.shape[3]
    out = flash_attention(
        q.contiguous(), cache.k[layer_idx].view(b * n, s_tok, hd),
        cache.v[layer_idx].view(b * n, s_tok, hd), bias, q_rope=q_rope,
        qk_int8=qk_int8 or int8_cache,
        k_scales=cache.k_scale[layer_idx].view(b * n, s_tok) if int8_cache else None,
        k2=k.contiguous() if two_segment else None, v2=v.contiguous() if two_segment else None,
        skip_ranges=skip_ranges)
    return nn.linear(out.reshape(b, s, n * hd), layer_p["o"])


def _cross_attention_layer(layer_p: dict, cfg: DiTConfig, x: torch.Tensor,
                           ck: torch.Tensor, cv: torch.Tensor,
                           train: bool = False) -> torch.Tensor:
    """Attention of x's queries over the prompt's K/V [B, T, N, D]:
    ``flash_attention_train`` in the training forms; when serving, plain
    softmax, or with ``LONGLIVE_CROSS_FLASH=1`` (read here at each call, as
    the JAX package reads it) the attention kernel's bias mode with a zero
    bias over the prompt's tokens (q pre-scaled and rounded, the exp2 and
    mxu_lsum switches applying).  The prompt's K/V are put in the kernel's
    [B*N, T, D] layout per call (1.5 MB per layer at full width): the
    ``CrossKV`` a prompt carries serves the training forms in its own
    layout."""
    b, s, _ = x.shape
    n, hd = cfg.num_heads, cfg.head_dim
    q = nn.linear(x, layer_p["q"])
    if cfg.qk_norm:
        q = nn.rms_norm(q, layer_p["norm_q"]["scale"], cfg.eps)
    q = q.reshape(b, s, n, hd)
    if train:
        out = flash_attention_train(q, ck.to(q.dtype), cv.to(q.dtype))
    elif os.environ.get("LONGLIVE_CROSS_FLASH", "0") == "1":
        out = flash_attention_unmasked(q, ck, cv, cross=True)
    else:
        out = dense_attention(q, ck.to(q.dtype), cv.to(q.dtype))
    return nn.linear(out.reshape(b, s, n * hd), layer_p["o"])


def _modulated(x: torch.Tensor, cfg: DiTConfig, f: int, shift, scale) -> torch.Tensor:
    h = _per_frame(nn.layer_norm(x, cfg.eps), f)
    return _flat(h * (1 + scale) + shift)


def _block_body(cfg: DiTConfig, cache_cfg: CacheConfig, num_frames: int, x: torch.Tensor,
                layer_p: dict, cache: kvc.KVCache, cross_k: torch.Tensor,
                cross_v: torch.Tensor, e0: torch.Tensor, rope_cos, rope_sin,
                bias: torch.Tensor, layer_idx: int, offsets: List[int],
                write_frames: Tuple[int, ...], kv_only: bool = False,
                fused_rope: bool = False, qk_int8: bool = False,
                block_kv: Optional[list] = None,
                skip_ranges: Optional[List[Tuple[int, int]]] = None) -> torch.Tensor:
    """One causal attention block.  ``kv_only``: write this layer's K/V and
    skip the rest (the last layer of a commit forward, whose output nobody
    reads).  ``block_kv``, ``skip_ranges``: the serving two-segment form
    (see ``_attention_layer_cached``)."""
    f = num_frames
    e = layer_p["modulation"][None, None].to(e0.dtype) + e0  # [B, F, 6, dim]
    e_ = [e[:, :, i][:, :, None] for i in range(6)]
    h = _modulated(x, cfg, f, e_[0], e_[1])
    y = _attention_layer_cached(layer_p["self_attn"], cfg, cache_cfg, h, rope_cos, rope_sin,
                                cache, layer_idx, offsets, write_frames, bias,
                                kv_only=kv_only, fused_rope=fused_rope, qk_int8=qk_int8,
                                block_kv=block_kv, skip_ranges=skip_ranges)
    if kv_only:
        return x
    return _block_tail(cfg, f, x, y, layer_p, cross_k, cross_v, e_)


def _block_tail(cfg: DiTConfig, f: int, x: torch.Tensor, y: torch.Tensor, layer_p: dict,
                cross_k: torch.Tensor, cross_v: torch.Tensor, e_: list,
                train: bool = False) -> torch.Tensor:
    """A block after its self-attention output ``y``: gated residual,
    cross-attention, modulated FFN."""
    x = x + _flat(_per_frame(y, f) * e_[2])
    norm3 = layer_p.get("norm3")
    h = nn.layer_norm(x, cfg.eps, scale=None if norm3 is None else norm3["scale"],
                      bias=None if norm3 is None else norm3["bias"])
    x = x + _cross_attention_layer(layer_p["cross_attn"], cfg, h, cross_k, cross_v, train)
    h = _modulated(x, cfg, f, e_[3], e_[4])
    ffn = layer_p["ffn"]
    y = nn.linear(nn.gelu_tanh(nn.linear(h, ffn["fc1"])), ffn["fc2"])
    return x + _flat(_per_frame(y, f) * e_[5])


def _block_body_train(cfg: DiTConfig, f: int, x: torch.Tensor, layer_p: dict,
                      cache_k: torch.Tensor, cache_v: torch.Tensor, cross_k: torch.Tensor,
                      cross_v: torch.Tensor, e0: torch.Tensor, rope_cos, rope_sin,
                      kv_valid: torch.Tensor, kv_only: bool = False,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None):
    """One causal block in the training form: the queries attend [this
    layer's read-only cache rows ``cache_k``/``cache_v`` ([B, S, N, D])
    under ``kv_valid`` ++ the block's own K/V].  Returns (x, block K, block
    V); ``kv_only`` computes the K/V and leaves x as it is.  An int8 cache
    (``k_scale``, ``v_scale`` [B, S, N]) is dequantized here, in q's dtype,
    so that under checkpointing the layer keeps the int8 rows, not a
    dequantized copy."""
    b, s, _ = x.shape
    n, hd = cfg.num_heads, cfg.head_dim
    e = layer_p["modulation"][None, None].to(e0.dtype) + e0
    e_ = [e[:, :, i][:, :, None] for i in range(6)]
    h = _modulated(x, cfg, f, e_[0], e_[1])
    sa = layer_p["self_attn"]
    k, v = _self_kv(sa, cfg, h, rope_cos, rope_sin)
    if kv_only:
        return x, k, v
    q = nn.linear(h, sa["q"])
    q_pre = nn.rms_scale(q, sa["norm_q"]["scale"], cfg.eps) if cfg.qk_norm else None
    q = apply_rotary(q.reshape(b, s, n, hd), rope_cos, rope_sin, premul=q_pre,
                     layout=cfg.rope_layout)
    if k_scale is not None:
        cache_k, cache_v = (dequantize_k(c, sc, q.dtype)
                            for c, sc in ((cache_k, k_scale), (cache_v, v_scale)))
    y = attend_train(q, cache_k.to(q.dtype), cache_v.to(q.dtype), kv_valid, k2=k, v2=v)
    y = nn.linear(y.reshape(b, s, n * hd), sa["o"])
    return _block_tail(cfg, f, x, y, layer_p, cross_k, cross_v, e_, train=True), k, v


def _head(params: dict, cfg: DiTConfig, x: torch.Tensor, e: torch.Tensor, f: int) -> torch.Tensor:
    hp = params["head"]
    em = hp["modulation"][None, None].to(e.dtype) + e[:, :, None]  # [B, F, 2, dim]
    h = _modulated(x, cfg, f, em[:, :, 0][:, :, None], em[:, :, 1][:, :, None])
    return nn.linear(h, hp["head"])


# ---------------------------------------------------------------------------
# cached forward


def dit_forward_cached(
    params: dict, cfg: DiTConfig, cache_cfg: CacheConfig, tables: RopeTables,
    x: torch.Tensor, t: torch.Tensor, cross_kv: CrossKV, cache: kvc.KVCache,
    start_frame: int, *, kv_valid: Optional[torch.Tensor] = None,
    offsets: Optional[List[int]] = None, write_frames: Optional[Tuple[int, ...]] = None,
    advance_counters: bool = True, kv_only: bool = False, fused_rope: bool = False,
    qk_int8: bool = False, two_segment: bool = False, remat_layers: bool = False,
    window_frames: Optional[int] = None, commit_writes: bool = True,
    serving_two_segment: Optional[bool] = None, kernel_cache: bool = False,
) -> Tuple[torch.Tensor, kvc.KVCache]:
    """One cached DiT forward over a block of F frames at absolute frame
    ``start_frame``.  x: [B, F, C, H, W] noisy latents; t: [B, F].

    Writes the block's K/V into ``cache`` in place (every pass overwrites
    the same slots before attending, so threading the cache through the
    denoise passes matches discarding their writes) and returns
    (flow [B, F, C, H, W] float32, cache with counters advanced when
    ``advance_counters``).  ``kv_only``: the commit forward — the last
    layer only writes K/V and the returned flow is zeros.

    Explicit cache plumbing (the KV-recache): ``offsets`` [F] token offsets
    of the block's frames (default: their ring slots), ``write_frames`` the
    frames whose K/V are written (default all), ``kv_valid`` [S_cache] bool
    the attended tokens (default: the fill state's mask).  Each layer writes
    those frames, then attends under that mask.

    ``qk_int8``: self-attention runs QK^T in int8 (the JAX package's
    ``attn_impl="pallas_qk8"``); an int8 K cache always does.

    ``serving_two_segment`` (None: ``LONGLIVE_TWO_SEGMENT=1``, read here as
    the JAX package reads it) selects the serving two-segment form, taken
    only on the standard plumbing, on a bf16 cache, and not when
    ``kernel_cache`` (the pipeline's resolution of its ``kernel_cache`` key:
    the JAX package runs that cache in its kernel layout, which has no
    two-segment form).  There the cache is read-only in the layer loop,
    each layer attends [cache, the block's slots masked and their tiles
    elided, ++ the block's K/V] and the block's K/V are written after the
    loop, unless ``commit_writes`` is False (the cache is then left as it
    was; the write-then-attend form writes in place regardless);
    ``window_frames`` caps the attended window.

    ``two_segment`` selects the training form (``_dit_forward_train``),
    which takes the standard plumbing only, plus ``remat_layers``,
    ``window_frames`` and ``commit_writes`` as above, on a bf16 cache or on
    the rollout's int8 K and V cache (``cache_int8``)."""
    if two_segment:
        if (kv_valid is not None or offsets is not None or write_frames is not None
                or fused_rope or qk_int8 or (cache.k_scale is None) != (cache.v_scale is None)):
            raise ValueError("the training form takes no explicit cache plumbing, no "
                             "fused_rope, no int8 attention and no int8 K without int8 V")
        return _dit_forward_train(params, cfg, cache_cfg, tables, x, t, cross_kv, cache,
                                  start_frame, advance_counters=advance_counters,
                                  kv_only=kv_only, remat_layers=remat_layers,
                                  window_frames=window_frames, commit_writes=commit_writes)
    b, f, c, h, w = x.shape
    dtype = params["patch_embedding"]["weight"].dtype
    if kernel_cache and serving_two_segment:
        raise ValueError("kernel_cache takes no two-segment forward")
    if serving_two_segment is None:
        serving_two_segment = os.environ.get("LONGLIVE_TWO_SEGMENT", "0") == "1"
    serving_two_segment = (serving_two_segment and not kernel_cache and kv_valid is None
                           and offsets is None and write_frames is None
                           and cache.k_scale is None)
    if offsets is None:
        offsets = kvc.block_write_offsets(cache_cfg, cache, start_frame, f)
    if write_frames is None:
        write_frames = tuple(range(f))
    if kv_valid is None:
        kv_valid = kvc.validity_mask(cache_cfg, cache, start_frame, f,
                                     window_frames=window_frames, device=x.device,
                                     exclude_block=serving_two_segment)
    skip_ranges = None
    if serving_two_segment:
        # the block's own slots are masked out of the cache segment: hand
        # the kernel their token ranges so it elides those tiles outright
        skip_ranges = [(offsets[i], offsets[i] + cache_cfg.frame_seq) for i in write_frames]

    tokens = nn.linear(patchify(x.to(dtype), cfg), params["patch_embedding"])
    e, e0 = time_modulation(params, cfg, t, dtype)
    hp, wp = h // cfg.patch_size[1], w // cfg.patch_size[2]
    rope_cos, rope_sin = rope_multipliers(tables, f, hp, wp, start_frame)
    bias = torch.where(kv_valid.to(x.device), 0.0, NEG_INF).to(torch.float32)
    bias = bias[None].expand(b, -1).contiguous()

    blocks = params["blocks"]
    pending = []  # the two-segment form's block K/V of every layer, to commit
    for li in range(len(blocks)):
        last_kv_only = kv_only and li == len(blocks) - 1
        block_kv = [] if serving_two_segment else None
        tokens = _block_body(cfg, cache_cfg, f, tokens, blocks[li], cache, cross_kv.k[li],
                             cross_kv.v[li], e0, rope_cos, rope_sin, bias, li, offsets,
                             write_frames, kv_only=last_kv_only, fused_rope=fused_rope,
                             qk_int8=qk_int8, block_kv=block_kv, skip_ranges=skip_ranges)
        if serving_two_segment and commit_writes:
            pending.append(block_kv[0])
    for li, (k_blk, v_blk) in enumerate(pending):
        kvc.write_block_kv(cache_cfg, cache, li, k_blk, v_blk, offsets, write_frames)
    if kv_only:
        flow = torch.zeros((b, f, cfg.out_dim, h, w), dtype=torch.float32, device=x.device)
    else:
        out_tokens = _head(params, cfg, tokens, e, f)
        flow = unpatchify(out_tokens.float(), cfg, f, h, w)
    if advance_counters:
        cache = kvc.advance(cache_cfg, cache, start_frame, f)
    return flow, dataclasses.replace(cache)


def _dit_forward_train(
    params: dict, cfg: DiTConfig, cache_cfg: CacheConfig, tables: RopeTables,
    x: torch.Tensor, t: torch.Tensor, cross_kv: CrossKV, cache: kvc.KVCache,
    start_frame: int, *, advance_counters: bool, kv_only: bool, remat_layers: bool,
    window_frames: Optional[int], commit_writes: bool,
) -> Tuple[torch.Tensor, kvc.KVCache]:
    """The training form of ``dit_forward_cached`` (the JAX package's
    ``two_segment=True``).  The cache is only read inside the layer loop:
    each layer attends [its cache rows under the window's validity mask,
    the block's own slots excluded, ++ the block's fresh K/V], so a graph
    over this forward never holds a cache that a later write changes.  With
    ``commit_writes`` the block's K/V of every layer are written into the
    cache once, after the loop (in place, without gradient).  With
    ``remat_layers`` and gradients enabled each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant): backward keeps each layer's
    input and recomputes the rest.  ``kv_only``: the last layer computes
    only its K/V and the flow is zeros.

    An int8 K and V cache (the rollout's ``cache_int8``) is dequantized by
    each layer as it reads it, and the block's K and V are quantized once,
    at the commit (one float32 scale per token and head)."""
    b, f, c, h, w = x.shape
    dtype = params["patch_embedding"]["weight"].dtype
    offsets = kvc.block_write_offsets(cache_cfg, cache, start_frame, f)
    int8 = cache.v_scale is not None
    kv_valid = kvc.validity_mask(cache_cfg, cache, start_frame, f, window_frames=window_frames,
                                 device=x.device, exclude_block=True)
    tokens = nn.linear(patchify(x.to(dtype), cfg), params["patch_embedding"]).to(dtype)
    e, e0 = time_modulation(params, cfg, t, dtype)
    hp, wp = h // cfg.patch_size[1], w // cfg.patch_size[2]
    rope_cos, rope_sin = rope_multipliers(tables, f, hp, wp, start_frame)
    blocks = params["blocks"]
    remat = remat_layers and torch.is_grad_enabled()
    block_kv = []
    for li, layer_p in enumerate(blocks):
        args = (cfg, f, tokens, layer_p, cache.k[li].transpose(1, 2), cache.v[li].transpose(1, 2),
                cross_kv.k[li], cross_kv.v[li], e0, rope_cos, rope_sin, kv_valid,
                kv_only and li == len(blocks) - 1)
        if int8:
            args += (cache.k_scale[li].transpose(1, 2), cache.v_scale[li].transpose(1, 2))
        if remat:
            tokens, k_blk, v_blk = checkpoint(_block_body_train, *args, use_reentrant=False)
        else:
            tokens, k_blk, v_blk = _block_body_train(*args)
        if commit_writes:
            block_kv.append((k_blk.detach(), v_blk.detach()))
    if kv_only:
        flow = torch.zeros((b, f, cfg.out_dim, h, w), dtype=torch.float32, device=x.device)
    else:
        flow = unpatchify(_head(params, cfg, tokens, e, f).float(), cfg, f, h, w)
    if commit_writes:
        with torch.no_grad():
            for li, (k_blk, v_blk) in enumerate(block_kv):
                if int8:
                    (k_blk, k_sc), (v_blk, v_sc) = quantize_k_tokens(k_blk), quantize_k_tokens(v_blk)
                    kvc.write_block_kv(cache_cfg, cache, li, k_blk, v_blk, offsets,
                                       new_k_scale=k_sc, new_v_scale=v_sc)
                else:
                    kvc.write_block_kv(cache_cfg, cache, li, k_blk, v_blk, offsets)
    if advance_counters:
        cache = kvc.advance(cache_cfg, cache, start_frame, f)
    return flow, dataclasses.replace(cache)


# ---------------------------------------------------------------------------
# full-sequence forwards


def _full_layer(cfg: DiTConfig, f: int, x: torch.Tensor, layer_p: dict, cross_k: torch.Tensor,
                cross_v: torch.Tensor, e0: torch.Tensor, rope_cos, rope_sin,
                self_attend) -> torch.Tensor:
    """One block of a full-sequence forward over ``f`` frames: q and k
    RMS-normed, then roped (no fused premul), ``self_attend(q, k, v)``, then
    the block's tail with the serving cross-attention."""
    b, s, _ = x.shape
    n, hd = cfg.num_heads, cfg.head_dim
    e = layer_p["modulation"][None, None].to(e0.dtype) + e0
    e_ = [e[:, :, i][:, :, None] for i in range(6)]
    h = _modulated(x, cfg, f, e_[0], e_[1])
    sa = layer_p["self_attn"]
    q, k, v = _projections(sa, cfg, h)
    if cfg.qk_norm:
        q = nn.rms_norm(q, sa["norm_q"]["scale"], cfg.eps)
        k = nn.rms_norm(k, sa["norm_k"]["scale"], cfg.eps)
    q = apply_rotary(q.reshape(b, s, n, hd), rope_cos, rope_sin, layout=cfg.rope_layout)
    k = apply_rotary(k.reshape(b, s, n, hd), rope_cos, rope_sin, layout=cfg.rope_layout)
    y = self_attend(q, k, v.reshape(b, s, n, hd))
    y = nn.linear(y.reshape(b, s, n * hd), sa["o"])
    return _block_tail(cfg, f, x, y, layer_p, cross_k, cross_v, e_)


def _dense_self_attend(frame_mask: torch.Tensor, frame_seq: int):
    bias = torch.where(expand_frame_mask(frame_mask, frame_seq), 0.0, NEG_INF)
    bias = bias.to(torch.float32)[None, None]
    return lambda q, k, v: dense_attention(q, k, v, bias)


def _masked_self_attend(spec: FrameMaskSpec, frame_seq: int):
    return lambda q, k, v: flash_attention_frame_masked(
        q.contiguous(), k.contiguous(), v.contiguous(), mask_kind=spec.kind,
        frame_seq=frame_seq, nfb=spec.num_frame_per_block, local=spec.local_attn_size,
        sink=spec.sink_frames, clean_frames=spec.clean_frames)


def _full_layers(params: dict, cfg: DiTConfig, f: int, tokens: torch.Tensor,
                 cross_kv: CrossKV, e0: torch.Tensor, rope_cos, rope_sin, self_attend,
                 remat_layers: bool) -> torch.Tensor:
    """Every layer of a full-sequence forward; with ``remat_layers`` and
    gradients enabled each layer runs under ``torch.utils.checkpoint``."""
    remat = remat_layers and torch.is_grad_enabled()
    for li, layer_p in enumerate(params["blocks"]):
        args = (cfg, f, tokens, layer_p, cross_kv.k[li], cross_kv.v[li], e0, rope_cos, rope_sin,
                self_attend)
        tokens = (checkpoint(_full_layer, *args, use_reentrant=False) if remat
                  else _full_layer(*args))
    return tokens


def dit_forward_full(
    params: dict, cfg: DiTConfig, tables: RopeTables, x: torch.Tensor, t: torch.Tensor,
    cross_kv: CrossKV, frame_mask, start_frame: int = 0, remat_layers: bool = False,
) -> torch.Tensor:
    """Uncached forward over the whole sequence x [B, F, C, H, W] with
    per-frame timesteps t [B, F], under ``frame_mask``: a [F, F] bool tensor
    (the dense route: a float32 token-level bias, small sizes only) or an
    ``ops.masks.FrameMaskSpec`` (``flash_attention_frame_masked``: the
    kernel on CUDA tensors, its plain version on CPU tensors; no [S, S]
    tensor).  RoPE positions start at frame ``start_frame``.  The
    cross-attention takes the serving route (``LONGLIVE_CROSS_FLASH``).
    ``remat_layers``: per-layer checkpointing under gradients (the kernel
    route is forward only).  Returns the flow [B, F, C, H, W] float32."""
    b, f, c, h, w = x.shape
    dtype = params["patch_embedding"]["weight"].dtype
    tokens = nn.linear(patchify(x.to(dtype), cfg), params["patch_embedding"])
    e, e0 = time_modulation(params, cfg, t, dtype)
    hp, wp = h // cfg.patch_size[1], w // cfg.patch_size[2]
    rope_cos, rope_sin = rope_multipliers(tables, f, hp, wp, start_frame)
    if isinstance(frame_mask, FrameMaskSpec):
        self_attend = _masked_self_attend(frame_mask, hp * wp)
    else:
        self_attend = _dense_self_attend(frame_mask.to(x.device), hp * wp)
    tokens = _full_layers(params, cfg, f, tokens, cross_kv, e0, rope_cos, rope_sin, self_attend,
                          remat_layers)
    return unpatchify(_head(params, cfg, tokens, e, f).float(), cfg, f, h, w)


def dit_forward_teacher_forcing(
    params: dict, cfg: DiTConfig, tables: RopeTables, noisy: torch.Tensor, clean: torch.Tensor,
    t: torch.Tensor, cross_kv: CrossKV, aug_t: Optional[torch.Tensor] = None,
    attn_impl: str = "auto", remat_layers: bool = False,
) -> torch.Tensor:
    """Teacher-forcing forward: the sequence is [clean | noisy] (each
    [B, F, C, H, W]) under the teacher-forcing mask; the clean half runs at
    timesteps ``aug_t`` (zeros when None), the noisy half at ``t`` [B, F];
    both halves take the same RoPE positions.  Returns the flow of the
    noisy half [B, F, C, H, W] float32.

    ``attn_impl``: ``"pallas"`` computes the mask from token indices in
    ``flash_attention_frame_masked`` (kernel on CUDA tensors, plain version
    on CPU tensors); ``"xla"`` is the dense route (a [2S, 2S] float32 bias:
    ~17 GB at the 21-frame training geometry); ``"auto"`` is the kernel on
    a CUDA device (which raises for a head dim it cannot take), the dense
    route on the CPU."""
    if attn_impl == "auto":
        attn_impl = "pallas" if noisy.device.type == "cuda" else "xla"
    if attn_impl not in ("pallas", "xla"):
        raise ValueError(f"dit_forward_teacher_forcing: unknown attn_impl {attn_impl!r}")
    b, f, c, h, w = noisy.shape
    dtype = params["patch_embedding"]["weight"].dtype
    x2 = torch.cat([clean, noisy], dim=1).to(dtype)
    tokens = nn.linear(patchify(x2, cfg), params["patch_embedding"])
    if aug_t is None:
        aug_t = torch.zeros_like(t)
    e_clean, e0_clean = time_modulation(params, cfg, aug_t, dtype)
    e_noisy, e0_noisy = time_modulation(params, cfg, t, dtype)
    e0 = torch.cat([e0_clean, e0_noisy], dim=1)
    hp, wp = h // cfg.patch_size[1], w // cfg.patch_size[2]
    rope_cos, rope_sin = rope_multipliers(tables, f, hp, wp, 0)
    rope_cos, rope_sin = torch.cat([rope_cos, rope_cos]), torch.cat([rope_sin, rope_sin])
    if attn_impl == "pallas":
        spec = FrameMaskSpec("teacher_forcing", cfg.num_frame_per_block, clean_frames=f)
        self_attend = _masked_self_attend(spec, hp * wp)
    else:
        self_attend = _dense_self_attend(
            teacher_forcing_frame_mask(f, cfg.num_frame_per_block, noisy.device), hp * wp)
    tokens = _full_layers(params, cfg, 2 * f, tokens, cross_kv, e0, rope_cos, rope_sin,
                          self_attend, remat_layers)
    tokens = tokens[:, tokens.shape[1] // 2:]  # the noisy half
    return unpatchify(_head(params, cfg, tokens, e_noisy, f).float(), cfg, f, h, w)
