"""Bidirectional Wan DiT: the DMD teacher (``real_score``) and critic
(``fake_score``).

The same parameter layout as the causal model (``models.dit``).  It differs
from the causal path in three ways:

- one timestep per sample: the modulation is per sequence, [B, 6, dim];
- full bidirectional self-attention over all frames (no cache, no mask);
- RoPE always starts at frame 0.

Every attention (self and cross) goes through the differentiable
``flash_attention_train``; ``remat_layers`` checkpoints each layer when
gradients are on.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..config import DiTConfig
from ..ops.attention import flash_attention_train
from ..ops.embeddings import sinusoidal_embedding_1d
from ..ops.rope import RopeTables, apply_rotary, rope_multipliers
from . import nn
from .dit import CrossKV, _cross_attention_layer, patchify, unpatchify

_I2V = ("the i2v image branch of the bidirectional model is not ported yet: "
        "ROADMAP queue 1, item 11")


def prepare_img_cross_kv(params: dict, cfg: DiTConfig, clip_fea: torch.Tensor) -> CrossKV:
    raise NotImplementedError(_I2V)


def _bidi_block(x: torch.Tensor, layer_p: dict, ck: torch.Tensor, cv: torch.Tensor,
                e0: torch.Tensor, rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                cfg: DiTConfig) -> torch.Tensor:
    """One bidirectional attention block; x [B, S, dim], e0 [B, 6, dim]."""
    b, s, _ = x.shape
    n, hd = cfg.num_heads, cfg.head_dim
    em = layer_p["modulation"][None].to(e0.dtype) + e0
    e_ = [em[:, i][:, None] for i in range(6)]  # each [B, 1, dim]

    sa = layer_p["self_attn"]
    hh = nn.layer_norm(x, cfg.eps) * (1 + e_[1]) + e_[0]
    q = nn.linear(hh, sa["q"])
    k = nn.linear(hh, sa["k"])
    if cfg.qk_norm:
        q = nn.rms_norm(q, sa["norm_q"]["scale"], cfg.eps)
        k = nn.rms_norm(k, sa["norm_k"]["scale"], cfg.eps)
    v = nn.linear(hh, sa["v"]).reshape(b, s, n, hd)
    q = apply_rotary(q.reshape(b, s, n, hd), rope_cos, rope_sin, layout=cfg.rope_layout)
    k = apply_rotary(k.reshape(b, s, n, hd), rope_cos, rope_sin, layout=cfg.rope_layout)
    y = flash_attention_train(q, k, v.to(q.dtype))
    x = x + nn.linear(y.reshape(b, s, n * hd), sa["o"]) * e_[2]

    norm3 = layer_p.get("norm3")
    hh = nn.layer_norm(x, cfg.eps, scale=None if norm3 is None else norm3["scale"],
                       bias=None if norm3 is None else norm3["bias"])
    x = x + _cross_attention_layer(layer_p["cross_attn"], cfg, hh, ck, cv, train=True)

    hh = nn.layer_norm(x, cfg.eps) * (1 + e_[4]) + e_[3]
    ffn = layer_p["ffn"]
    y = nn.linear(nn.gelu_tanh(nn.linear(hh, ffn["fc1"])), ffn["fc2"])
    return x + y * e_[5]


def bidirectional_forward(params: dict, cfg: DiTConfig, tables: RopeTables, x: torch.Tensor,
                          t: torch.Tensor, cross_kv: CrossKV, cross_kv_img=None,
                          remat_layers: bool = False) -> torch.Tensor:
    """Flow prediction [B, F, C, H, W] (float32) for latents x [B, F, C, H, W]
    at one timestep per sample, t [B].  The residual stream stays in the
    parameter dtype."""
    if cross_kv_img is not None:
        raise NotImplementedError(_I2V)
    b, f, c, h, w = x.shape
    dtype = params["patch_embedding"]["weight"].dtype
    tokens = nn.linear(patchify(x.to(dtype), cfg), params["patch_embedding"]).to(dtype)
    emb = sinusoidal_embedding_1d(cfg.freq_dim, t).to(dtype)
    te = params["time_embedding"]
    e = nn.linear(nn.silu(nn.linear(emb, te["fc1"])), te["fc2"]).to(dtype)  # [B, dim]
    e0 = nn.linear(nn.silu(e), params["time_projection"]["fc"]).reshape(b, 6, cfg.dim).to(dtype)
    hp, wp = h // cfg.patch_size[1], w // cfg.patch_size[2]
    rope_cos, rope_sin = rope_multipliers(tables, f, hp, wp, 0)
    remat = remat_layers and torch.is_grad_enabled()
    for li, layer_p in enumerate(params["blocks"]):
        args = (tokens, layer_p, cross_kv.k[li], cross_kv.v[li], e0, rope_cos, rope_sin, cfg)
        tokens = (checkpoint(_bidi_block, *args, use_reentrant=False) if remat
                  else _bidi_block(*args))
    hd_p = params["head"]
    em = hd_p["modulation"][None].to(e.dtype) + e[:, None]  # [B, 2, dim]
    y = nn.layer_norm(tokens, cfg.eps) * (1 + em[:, 1][:, None]) + em[:, 0][:, None]
    out = nn.linear(y, hd_p["head"])
    return unpatchify(out.float(), cfg, f, h, w)


def bidirectional_forward_streamed(*args, **kwargs):
    raise NotImplementedError("the host-streamed bidirectional forward (a teacher larger "
                              "than the card) is not ported yet: ROADMAP queue 1, item 11")
