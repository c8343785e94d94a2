"""Bidirectional Wan DiT: the DMD teacher (``real_score``) and critic
(``fake_score``), and the vanilla Wan2.1 samplers' model (text-to-video and,
with ``model_type == "i2v"``, image-to-video).

The same parameter layout as the causal model (``models.dit``).  It differs
from the causal path in three ways:

- one timestep per sample: the modulation is per sequence, [B, 6, dim];
- full bidirectional self-attention over all frames (no cache, no mask);
- RoPE always starts at frame 0.

``attn_impl`` picks the route of every attention, self and cross:

- ``"auto"`` (the samplers): the serving attention ``flash_attention`` in
  its bias mode with a zero bias, K/V moved into its [B*N, S, D] layout;
  the cross-attentions count as its ``cross`` launches;
- ``"train_auto"`` (the training losses): the differentiable
  ``flash_attention_train``.

Either takes its kernel on CUDA tensors and its plain version on CPU
tensors.  ``remat_layers`` checkpoints each layer when gradients are on.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..config import DiTConfig
from ..ops.attention import flash_attention_train, flash_attention_unmasked
from ..ops.embeddings import sinusoidal_embedding_1d
from ..ops.rope import RopeTables, apply_rotary, rope_multipliers
from . import nn
from .dit import CrossKV, embed_text, layer_cross_kv, patchify, unpatchify

ATTN_IMPLS = ("auto", "train_auto")


def prepare_img_cross_kv(params: dict, cfg: DiTConfig, clip_fea: torch.Tensor) -> CrossKV:
    """CLIP image features [B, 257, clip_dim] -> per-layer K/V of the image
    branch [L, B, 257, N, D]: the ``img_emb`` projection (LayerNorm,
    Linear, exact GELU, Linear, LayerNorm), then each block's ``k_img``
    (RMS-normed by ``norm_k_img``) and ``v_img``, in the parameters'
    dtype."""
    p = params["img_emb"]
    dtype = params["patch_embedding"]["weight"].dtype
    x = nn.layer_norm(clip_fea.to(dtype), 1e-5, p["ln1"]["scale"], p["ln1"]["bias"])
    x = nn.linear(nn.gelu_exact(nn.linear(x, p["fc1"])), p["fc2"])
    ctx = nn.layer_norm(x, 1e-5, p["ln2"]["scale"], p["ln2"]["bias"])
    n, hd = cfg.num_heads, cfg.head_dim
    b, s, _ = ctx.shape
    ks, vs = [], []
    for blk in params["blocks"]:
        ca = blk["cross_attn"]
        k = nn.linear(ctx, ca["k_img"])
        if cfg.qk_norm:
            k = nn.rms_norm(k, ca["norm_k_img"]["scale"], cfg.eps)
        ks.append(k.reshape(b, s, n, hd))
        vs.append(nn.linear(ctx, ca["v_img"]).reshape(b, s, n, hd))
    return CrossKV(k=torch.stack(ks), v=torch.stack(vs))


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, attn_impl: str,
            cross: bool) -> torch.Tensor:
    """Attention of q [B, Sq, N, D] over every token of k, v [B, S, N, D]
    by the route ``attn_impl`` names."""
    if attn_impl == "train_auto":
        return flash_attention_train(q, k.to(q.dtype), v.to(q.dtype))
    return flash_attention_unmasked(q, k, v, cross=cross)


def _bidi_block(x: torch.Tensor, layer_p: dict, ck: torch.Tensor, cv: torch.Tensor,
                e0: torch.Tensor, rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                cfg: DiTConfig, attn_impl: str, cki: Optional[torch.Tensor] = None,
                cvi: Optional[torch.Tensor] = None, self_attend=None) -> torch.Tensor:
    """One bidirectional attention block; x [B, S, dim], e0 [B, 6, dim].
    With the image branch's K/V (``cki``, ``cvi``), its attention is added
    to the text attention's output before the shared ``o`` projection.
    ``self_attend(q, k, v)`` replaces the self-attention's route (the
    sequence-parallel forward's all-to-all attention; x is then this rank's
    token shard)."""
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
    y = (_attend(q, k, v, attn_impl, cross=False) if self_attend is None
         else self_attend(q, k, v))
    x = x + nn.linear(y.reshape(b, s, n * hd), sa["o"]) * e_[2]

    norm3 = layer_p.get("norm3")
    hh = nn.layer_norm(x, cfg.eps, scale=None if norm3 is None else norm3["scale"],
                       bias=None if norm3 is None else norm3["bias"])
    ca = layer_p["cross_attn"]
    cq = nn.linear(hh, ca["q"])
    if cfg.qk_norm:
        cq = nn.rms_norm(cq, ca["norm_q"]["scale"], cfg.eps)
    cq = cq.reshape(b, s, n, hd)
    co = _attend(cq, ck, cv, attn_impl, cross=True)
    if cki is not None:
        co = co + _attend(cq, cki, cvi, attn_impl, cross=True)
    x = x + nn.linear(co.reshape(b, s, n * hd), ca["o"])

    hh = nn.layer_norm(x, cfg.eps) * (1 + e_[4]) + e_[3]
    ffn = layer_p["ffn"]
    y = nn.linear(nn.gelu_tanh(nn.linear(hh, ffn["fc1"])), ffn["fc2"])
    return x + y * e_[5]


def _bidi_prologue(params: dict, cfg: DiTConfig, tables: RopeTables, x: torch.Tensor,
                   t: torch.Tensor):
    """(tokens [B, S, dim], e [B, dim], e0 [B, 6, dim], rope_cos, rope_sin)
    of a forward: the patch and time embeddings, from the tree's
    ``patch_embedding``, ``time_embedding`` and ``time_projection``."""
    b, f, c, h, w = x.shape
    dtype = params["patch_embedding"]["weight"].dtype
    tokens = nn.linear(patchify(x.to(dtype), cfg), params["patch_embedding"]).to(dtype)
    emb = sinusoidal_embedding_1d(cfg.freq_dim, t).to(dtype)
    te = params["time_embedding"]
    e = nn.linear(nn.silu(nn.linear(emb, te["fc1"])), te["fc2"]).to(dtype)  # [B, dim]
    e0 = nn.linear(nn.silu(e), params["time_projection"]["fc"]).reshape(b, 6, cfg.dim).to(dtype)
    hp, wp = h // cfg.patch_size[1], w // cfg.patch_size[2]
    rope_cos, rope_sin = rope_multipliers(tables, f, hp, wp, 0)
    return tokens, e, e0, rope_cos, rope_sin


def _bidi_head(head_p: dict, cfg: DiTConfig, tokens: torch.Tensor, e: torch.Tensor,
               shape) -> torch.Tensor:
    """The head's flow prediction [B, F, C, H, W] (float32); ``shape`` the
    input latents' shape."""
    b, f, c, h, w = shape
    em = head_p["modulation"][None].to(e.dtype) + e[:, None]  # [B, 2, dim]
    y = nn.layer_norm(tokens, cfg.eps) * (1 + em[:, 1][:, None]) + em[:, 0][:, None]
    return unpatchify(nn.linear(y, head_p["head"]).float(), cfg, f, h, w)


def _check_impl(attn_impl: str) -> None:
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r}: one of {ATTN_IMPLS}")


def bidirectional_forward(params: dict, cfg: DiTConfig, tables: RopeTables, x: torch.Tensor,
                          t: torch.Tensor, cross_kv: CrossKV, attn_impl: str = "auto",
                          cross_kv_img: Optional[CrossKV] = None,
                          remat_layers: bool = False) -> torch.Tensor:
    """Flow prediction [B, F, C, H, W] (float32) for latents x [B, F, C, H, W]
    at one timestep per sample, t [B].  The residual stream stays in the
    parameter dtype.  ``cross_kv_img`` (``prepare_img_cross_kv``; an i2v
    model) adds each block's attention over the CLIP image tokens."""
    _check_impl(attn_impl)
    tokens, e, e0, rope_cos, rope_sin = _bidi_prologue(params, cfg, tables, x, t)
    remat = remat_layers and torch.is_grad_enabled()
    for li, layer_p in enumerate(params["blocks"]):
        img = (None, None) if cross_kv_img is None else (cross_kv_img.k[li], cross_kv_img.v[li])
        args = (tokens, layer_p, cross_kv.k[li], cross_kv.v[li], e0, rope_cos, rope_sin, cfg,
                attn_impl) + img
        tokens = (checkpoint(_bidi_block, *args, use_reentrant=False) if remat
                  else _bidi_block(*args))
    return _bidi_head(params["head"], cfg, tokens, e, x.shape)


def bidirectional_forward_streamed(params: dict, cfg: DiTConfig, tables: RopeTables,
                                   x: torch.Tensor, t: torch.Tensor,
                                   cross_kv: Optional[CrossKV] = None, attn_impl: str = "auto",
                                   context: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``bidirectional_forward`` with the layer stack in the host's memory
    (``utils.memory.blocks_to_host``): each layer is copied to x's device
    one layer ahead of its compute (``utils.memory.stream_scan``), so the
    device holds the embeddings, the head and two layers.  The same
    per-layer arithmetic as the resident forward, so the same bits.  No
    gradient flows through the copies: inference and the teacher only.

    Pass EITHER ``cross_kv`` (per-layer K/V [L, ...], on the device or
    streamed beside the blocks) OR ``context``: raw text features [B,
    text_len, text_dim] (``embed_text`` in the parameters' dtype), from
    which each layer derives its cross K/V with its own streamed weights
    (``layer_cross_kv``), so no [L, ...] cross K/V exist: the 14B
    teacher's form."""
    from ..utils.memory import stream_scan

    _check_impl(attn_impl)
    if (cross_kv is None) == (context is None):
        raise ValueError("bidirectional_forward_streamed needs either cross_kv (per-layer "
                         "K/V) or context (text features), not both")
    tokens, e, e0, rope_cos, rope_sin = _bidi_prologue(params, cfg, tables, x, t)
    blocks = params["blocks"]
    if context is not None:
        ctx = embed_text(params, context, params["patch_embedding"]["weight"].dtype)

        def step(carry, layer_p):
            ck, cv = layer_cross_kv(layer_p["cross_attn"], cfg, ctx)
            return _bidi_block(carry, layer_p, ck, cv, e0, rope_cos, rope_sin, cfg, attn_impl)

        tokens = stream_scan(step, tokens, blocks, x.device)
    else:
        def step(carry, xs):
            layer_p, ck, cv = xs
            return _bidi_block(carry, layer_p, ck, cv, e0, rope_cos, rope_sin, cfg, attn_impl)

        tokens = stream_scan(step, tokens, list(zip(blocks, cross_kv.k, cross_kv.v)), x.device)
    return _bidi_head(params["head"], cfg, tokens, e, x.shape)
