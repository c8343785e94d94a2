"""Causal Wan DiT, cached (kernel-layout) forward.

Plain functions over a parameter dict:

- ``blocks`` is a list of per-layer dicts; linears are
  ``{"weight": [out, in], "bias": [out]}``;
- the KV cache is ``ops.kv_cache.KVCache`` ([L, B, N, S, D]); each layer
  writes its block's roped K/V in place at the block's (consecutive) ring
  slots, then the attention kernel reads that layer's rows of the cache
  directly;
- RoPE uses absolute frame positions; cross-attention K/V are computed once
  per prompt (``prepare_cross_kv``);
- adaLN: 6-way per-frame modulation per block, 2-way at the head.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..config import CacheConfig, DiTConfig
from ..ops import kv_cache as kvc
from ..ops.attention import NEG_INF, dense_attention, flash_attention
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
    if cfg.rope_layout != "halfsplit":
        return params
    perm = torch.as_tensor(halfsplit_qk_perm(cfg.head_dim, cfg.num_heads))
    for blk in params["blocks"]:
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
    return params


def init_dit_params(cfg: DiTConfig, dtype=torch.float32, device="cpu",
                    seed: int = 0, zero_head: bool = True) -> dict:
    """Random init: xavier-uniform linears with zero bias, N(0, 0.02) text
    and time embeddings, modulation N(0, 1/dim), zero head projection
    unless ``zero_head=False``.  Drawn on ``device`` from a generator seeded
    with ``seed``."""
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

    blocks = []
    for _ in range(cfg.num_layers):
        blk = {
            "self_attn": attn(),
            "cross_attn": attn(),
            "ffn": {"fc1": lin(d, ffn), "fc2": lin(ffn, d)},
            "modulation": (torch.randn((6, d), generator=gen, device=device)
                           / math.sqrt(d)).to(dtype),
        }
        if cfg.cross_attn_norm:
            blk["norm3"] = {"scale": ones(d),
                            "bias": torch.zeros(d, dtype=dtype, device=device)}
        blocks.append(blk)
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
    return canonicalize_rope_layout(params, cfg)


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
    return e.reshape(b, f, cfg.dim), e0.reshape(b, f, 6, cfg.dim)


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
    n, hd = cfg.num_heads, cfg.head_dim
    b, s, _ = ctx.shape
    ks, vs = [], []
    for blk in params["blocks"]:
        p = blk["cross_attn"]
        k = nn.linear(ctx, p["k"])
        if cfg.qk_norm:
            k = nn.rms_norm(k, p["norm_k"]["scale"], cfg.eps)
        ks.append(k.reshape(b, s, n, hd))
        vs.append(nn.linear(ctx, p["v"]).reshape(b, s, n, hd))
    return CrossKV(k=torch.stack(ks), v=torch.stack(vs))


# ---------------------------------------------------------------------------
# transformer layer


def _per_frame(x: torch.Tensor, f: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, f, s // f, d)


def _flat(x: torch.Tensor) -> torch.Tensor:
    b, f, fs, d = x.shape
    return x.reshape(b, f * fs, d)


def _attention_layer_cached_kl(
    layer_p: dict, cfg: DiTConfig, x: torch.Tensor, rope_cos: torch.Tensor,
    rope_sin: torch.Tensor, cache: kvc.KVCache, layer_idx: int, tok_off: int,
    bias: torch.Tensor, kv_only: bool = False,
) -> Optional[torch.Tensor]:
    """Self-attention against the cache: the block's roped K/V are written
    in place into layer ``layer_idx`` at token ``tok_off``, then the queries
    attend that layer's rows (sink + window + the block itself)."""
    b, s, _ = x.shape
    n, hd = cfg.num_heads, cfg.head_dim
    k = nn.linear(x, layer_p["k"])
    v = nn.linear(x, layer_p["v"]).reshape(b, s, n, hd)
    k_pre = nn.rms_scale(k, layer_p["norm_k"]["scale"], cfg.eps) if cfg.qk_norm else None
    k = apply_rotary(k.reshape(b, s, n, hd), rope_cos, rope_sin, premul=k_pre,
                     layout=cfg.rope_layout)
    cache.k[layer_idx, :, :, tok_off:tok_off + s].copy_(k.transpose(1, 2))
    cache.v[layer_idx, :, :, tok_off:tok_off + s].copy_(v.transpose(1, 2))
    if kv_only:
        return None
    q = nn.linear(x, layer_p["q"])
    q_pre = nn.rms_scale(q, layer_p["norm_q"]["scale"], cfg.eps) if cfg.qk_norm else None
    q = apply_rotary(q.reshape(b, s, n, hd), rope_cos, rope_sin, premul=q_pre,
                     layout=cfg.rope_layout)
    s_tok = cache.k.shape[3]
    out = flash_attention(q.contiguous(), cache.k[layer_idx].view(b * n, s_tok, hd),
                          cache.v[layer_idx].view(b * n, s_tok, hd), bias)
    return nn.linear(out.reshape(b, s, n * hd), layer_p["o"])


def _cross_attention_layer(layer_p: dict, cfg: DiTConfig, x: torch.Tensor,
                           ck: torch.Tensor, cv: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    n, hd = cfg.num_heads, cfg.head_dim
    q = nn.linear(x, layer_p["q"])
    if cfg.qk_norm:
        q = nn.rms_norm(q, layer_p["norm_q"]["scale"], cfg.eps)
    out = dense_attention(q.reshape(b, s, n, hd), ck.to(q.dtype), cv.to(q.dtype))
    return nn.linear(out.reshape(b, s, n * hd), layer_p["o"])


def _modulated(x: torch.Tensor, cfg: DiTConfig, f: int, shift, scale) -> torch.Tensor:
    h = _per_frame(nn.layer_norm(x, cfg.eps), f)
    return _flat(h * (1 + scale) + shift)


def _block_body_kl(cfg: DiTConfig, num_frames: int, x: torch.Tensor, layer_p: dict,
                   cache: kvc.KVCache, cross_k: torch.Tensor, cross_v: torch.Tensor,
                   e0: torch.Tensor, rope_cos, rope_sin, bias: torch.Tensor,
                   layer_idx: int, tok_off: int, kv_only: bool = False) -> torch.Tensor:
    """One causal attention block.  ``kv_only``: write this layer's K/V and
    skip the rest (the last layer of a commit forward, whose output nobody
    reads)."""
    f = num_frames
    e = layer_p["modulation"][None, None].to(e0.dtype) + e0  # [B, F, 6, dim]
    e_ = [e[:, :, i][:, :, None] for i in range(6)]
    h = _modulated(x, cfg, f, e_[0], e_[1])
    y = _attention_layer_cached_kl(layer_p["self_attn"], cfg, h, rope_cos, rope_sin,
                                   cache, layer_idx, tok_off, bias, kv_only=kv_only)
    if kv_only:
        return x
    x = x + _flat(_per_frame(y, f) * e_[2])
    norm3 = layer_p.get("norm3")
    h = nn.layer_norm(x, cfg.eps, scale=None if norm3 is None else norm3["scale"],
                      bias=None if norm3 is None else norm3["bias"])
    x = x + _cross_attention_layer(layer_p["cross_attn"], cfg, h, cross_k, cross_v)
    h = _modulated(x, cfg, f, e_[3], e_[4])
    ffn = layer_p["ffn"]
    y = nn.linear(nn.gelu_tanh(nn.linear(h, ffn["fc1"])), ffn["fc2"])
    return x + _flat(_per_frame(y, f) * e_[5])


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
    start_frame: int, *, advance_counters: bool = True, kv_only: bool = False,
) -> Tuple[torch.Tensor, kvc.KVCache]:
    """One cached DiT forward over a block of F frames at absolute frame
    ``start_frame``.  x: [B, F, C, H, W] noisy latents; t: [B, F].

    Writes the block's K/V into ``cache`` in place (every pass overwrites
    the same slots before attending, so threading the cache through the
    denoise passes matches discarding their writes) and returns
    (flow [B, F, C, H, W] float32, cache with counters advanced when
    ``advance_counters``).  ``kv_only``: the commit forward — the last
    layer only writes K/V and the returned flow is zeros."""
    b, f, c, h, w = x.shape
    dtype = params["patch_embedding"]["weight"].dtype
    offsets = kvc.block_write_offsets(cache_cfg, cache, start_frame, f)
    fs = cache_cfg.frame_seq
    if offsets != [offsets[0] + i * fs for i in range(f)]:
        raise NotImplementedError(
            "the block's frames land in non-consecutive cache slots (sink or "
            "ring not a multiple of the block); the per-frame write form "
            "waits for the recache slice (ROADMAP queue 1, item 8)")
    tok_off = offsets[0]

    tokens = nn.linear(patchify(x.to(dtype), cfg), params["patch_embedding"])
    e, e0 = time_modulation(params, cfg, t, dtype)
    hp, wp = h // cfg.patch_size[1], w // cfg.patch_size[2]
    rope_cos, rope_sin = rope_multipliers(tables, f, hp, wp, start_frame)
    valid = kvc.validity_mask(cache_cfg, cache, start_frame, f, device=x.device)
    bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)[None].expand(b, -1).contiguous()

    blocks = params["blocks"]
    n_full = len(blocks) - 1 if kv_only else len(blocks)
    for li in range(n_full):
        tokens = _block_body_kl(cfg, f, tokens, blocks[li], cache, cross_kv.k[li],
                                cross_kv.v[li], e0, rope_cos, rope_sin, bias, li, tok_off)
    if kv_only:
        li = len(blocks) - 1
        _block_body_kl(cfg, f, tokens, blocks[li], cache, cross_kv.k[li], cross_kv.v[li],
                       e0, rope_cos, rope_sin, bias, li, tok_off, kv_only=True)
        flow = torch.zeros((b, f, cfg.out_dim, h, w), dtype=torch.float32, device=x.device)
    else:
        out_tokens = _head(params, cfg, tokens, e, f)
        flow = unpatchify(out_tokens.float(), cfg, f, h, w)
    if advance_counters:
        cache = kvc.advance(cache_cfg, cache, start_frame, f)
    return flow, dataclasses.replace(cache)
