"""Ulysses sequence parallelism for the cached causal decode, over a
process group (the mesh's ``sp`` axis).

The port of ``longlive_tpu/parallel/decode_sp.py``:

- tokens are sharded on the WITHIN-FRAME axis: each rank owns a contiguous
  ``frame_seq / P`` slice of every frame, so the per-frame adaLN modulation
  and the frame-offset cache writes keep their single-card structure; the
  RoPE rows are sliced per frame to match;
- every linear, norm and the FFN run on the token shard at full width (no
  parameter is sharded);
- the self-attention scatters heads and gathers each frame's tokens with an
  all-to-all per operand ([B, F, fs/P, N, D] <-> [B, F, fs, N/P, D]): each
  rank writes its N/P heads of the block's K/V into its cache, in the
  single-card ring slots, and attends them over the whole [sink ++ window]
  through the attention kernel's bias mode;
- the KV cache is this rank's head slice of the standard layout,
  [L, B, N/P, S, D] (``init_sp_cache``); its counters are host ints, the
  same on every rank;
- the cross-attention needs no communication (its K/V are replicated);
- the head's output ([B, F*fs/P, 64]) is all-gathered along the
  within-frame axis, so the scheduler's arithmetic stays replicated.

Per layer and rank: two all-to-alls, Q, K and V stacked in one and the
output in the other (one, K and V, for the last layer of a commit forward,
which writes K/V only): NCCL's cost per call, not per byte, dominates at
these sizes.  The forward
keeps ``dit_forward_cached``'s write-then-attend form (as the JAX package's
sp path does): the serving two-segment form and the fused q RoPE are
single-card options, and the int8 K cache is refused by the pipeline.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from ..config import CacheConfig, DiTConfig
from ..models import dit as D
from ..models import nn
from ..ops import kv_cache as kvc
from ..ops.attention import NEG_INF, flash_attention
from ..ops.rope import RopeTables, apply_rotary, rope_multipliers
from .mesh import all_gather_dim
from .sequence import heads_to_seq, seq_to_heads


def _sp_layer(cfg: DiTConfig, cache_cfg: CacheConfig, f: int, x: torch.Tensor, layer_p: dict,
              cache: kvc.KVCache, li: int, cross_k: torch.Tensor, cross_v: torch.Tensor,
              e0: torch.Tensor, rope_cos, rope_sin, bias: torch.Tensor, offsets: List[int],
              write_frames: Tuple[int, ...], group, kv_only: bool, qk_int8: bool) -> torch.Tensor:
    """One causal block on this rank's token shard x [B, F*fs/P, dim]."""
    b, s_loc, _ = x.shape
    n, hd = cfg.num_heads, cfg.head_dim
    fsl = s_loc // f
    e = layer_p["modulation"][None, None].to(e0.dtype) + e0  # [B, F, 6, dim]
    e_ = [e[:, :, i][:, :, None] for i in range(6)]
    h = D._modulated(x, cfg, f, e_[0], e_[1])
    sa = layer_p["self_attn"]
    q, k, v = D._projections(sa, cfg, h, kv_only)
    ops = [D._rope_k(sa, cfg, k, rope_cos, rope_sin), v.reshape(b, s_loc, n, hd)]
    if not kv_only:
        q_pre = nn.rms_scale(q, sa["norm_q"]["scale"], cfg.eps) if cfg.qk_norm else None
        ops.append(apply_rotary(q.reshape(b, s_loc, n, hd), rope_cos, rope_sin, premul=q_pre,
                                layout=cfg.rope_layout))
    # one all-to-all for the stacked operands: [K, V(, Q), B, F, fs/P, N, D]
    # -> [.., B, F, fs, N/P, D]
    g = heads_to_seq(torch.stack(ops).reshape(len(ops), b, f, fsl, n, hd), group)
    nl = g.shape[-2]
    g = g.reshape(len(ops), b, f * g.shape[3], nl, hd)
    kvc.write_block_kv(cache_cfg, cache, li, g[0], g[1], offsets, write_frames)
    if kv_only:
        return x
    s_tok = cache.k.shape[3]
    out = flash_attention(g[2].contiguous(), cache.k[li].view(b * nl, s_tok, hd),
                          cache.v[li].view(b * nl, s_tok, hd), bias, qk_int8=qk_int8)
    y = seq_to_heads(out.reshape(b, f, -1, nl, hd), group).reshape(b, s_loc, n * hd)
    y = nn.linear(y, sa["o"])
    return D._block_tail(cfg, f, x, y, layer_p, cross_k, cross_v, e_)


def sp_dit_forward_cached(
    params: dict, cfg: DiTConfig, cache_cfg: CacheConfig, tables: RopeTables, group,
    x: torch.Tensor, t: torch.Tensor, cross_kv: D.CrossKV, cache: kvc.KVCache,
    start_frame: int, *, kv_valid: Optional[torch.Tensor] = None,
    offsets: Optional[List[int]] = None, write_frames: Optional[Tuple[int, ...]] = None,
    advance_counters: bool = True, kv_only: bool = False, qk_int8: bool = False,
    window_frames: Optional[int] = None,
) -> Tuple[torch.Tensor, kvc.KVCache]:
    """``dit_forward_cached`` with the tokens sharded over ``group`` on the
    within-frame axis.  The same contract: x [B, F, C, H, W] and t [B, F]
    replicated; ``cache`` this rank's head slice (``init_sp_cache``),
    written in place; the explicit cache plumbing (``kv_valid``,
    ``offsets``, ``write_frames``) of a recache as there.  Returns (flow
    [B, F, C, H, W] float32, the same on every rank; the cache with its
    counters advanced when ``advance_counters``).  ``kv_only``: the last
    layer only writes its K/V and the flow is zeros."""
    b, f, c, h, w = x.shape
    p, r = dist.get_world_size(group), dist.get_rank(group)
    dtype = params["patch_embedding"]["weight"].dtype
    hp, wp = h // cfg.patch_size[1], w // cfg.patch_size[2]
    fs = hp * wp
    if fs % p or cfg.num_heads % p:
        raise ValueError(f"sequence parallelism over {p} ranks needs the tokens of a frame "
                         f"({fs}) and the heads ({cfg.num_heads}) to divide over them")
    if cache.k.shape[2] * p != cfg.num_heads or cache.k_scale is not None:
        raise ValueError(f"the sp cache holds {cache.k.shape[2]} heads of a bf16 K; this "
                         f"rank's slice is {cfg.num_heads // p} (init_sp_cache)")
    fsl = fs // p
    if offsets is None:
        offsets = kvc.block_write_offsets(cache_cfg, cache, start_frame, f)
    if write_frames is None:
        write_frames = tuple(range(f))
    if kv_valid is None:
        kv_valid = kvc.validity_mask(cache_cfg, cache, start_frame, f,
                                     window_frames=window_frames, device=x.device)
    mine = slice(r * fsl, (r + 1) * fsl)

    tokens = D.patchify(x.to(dtype), cfg).reshape(b, f, fs, -1)[:, :, mine]
    tokens = nn.linear(tokens.reshape(b, f * fsl, -1), params["patch_embedding"])
    e, e0 = D.time_modulation(params, cfg, t, dtype)
    rope_cos, rope_sin = (a.reshape(f, fs, -1)[:, mine].reshape(f * fsl, -1)
                          for a in rope_multipliers(tables, f, hp, wp, start_frame))
    bias = torch.where(kv_valid.to(x.device), 0.0, NEG_INF).to(torch.float32)
    bias = bias[None].expand(b, -1).contiguous()

    blocks = params["blocks"]
    for li, layer_p in enumerate(blocks):
        tokens = _sp_layer(cfg, cache_cfg, f, tokens, layer_p, cache, li, cross_kv.k[li],
                           cross_kv.v[li], e0, rope_cos, rope_sin, bias, offsets, write_frames,
                           group, kv_only=kv_only and li == len(blocks) - 1, qk_int8=qk_int8)
    if kv_only:
        flow = torch.zeros((b, f, cfg.out_dim, h, w), dtype=torch.float32, device=x.device)
    else:
        out = D._head(params, cfg, tokens, e, f).reshape(b, f, fsl, -1)
        out = all_gather_dim(out, 2, group).reshape(b, f * fs, -1)
        flow = D.unpatchify(out.float(), cfg, f, h, w)
    if advance_counters:
        cache = kvc.advance(cache_cfg, cache, start_frame, f)
    return flow, dataclasses.replace(cache)


def init_sp_cache(cache_cfg: CacheConfig, num_layers: int, batch: int, num_heads: int,
                  head_dim: int, sp: int, dtype=torch.bfloat16, device="cpu") -> kvc.KVCache:
    """This rank's head slice of the standard cache: [L, B, N/P, S, D] K and
    V (bf16 K only: the sp path has no int8 K cache)."""
    if num_heads % sp:
        raise ValueError(f"{num_heads} heads do not divide over sp {sp}")
    return kvc.init_cache(cache_cfg, num_layers, batch, num_heads // sp, head_dim, dtype,
                          device)
