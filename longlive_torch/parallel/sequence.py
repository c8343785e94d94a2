"""Ulysses sequence parallelism for the bidirectional Wan model (the
vanilla samplers), over a process group (the mesh's ``sp`` axis).

The port of ``longlive_tpu/parallel/sequence.py``: tokens are sharded
contiguously over the whole sequence (rank r holds tokens [r*S/P, (r+1)*S/P),
its RoPE rows with them); each block's linears, norms and FFN run on the
shard at full width; the self-attention scatters heads and gathers the
sequence with one all-to-all of Q, K and V stacked (``all_to_all_single``
on a contiguous [P, 3, B, S/P, N/P, D] permutation), attends N/P heads
over the whole sequence, and goes back with one more; the cross-attention stays
local over all heads (its K/V depend on the prompt only and are
replicated); the tokens are all-gathered before the head.  The chunks a
rank receives are the sequence slices in rank order, JAX's ``tiled=True``
order, so the token order is restored exactly.  Over a group of one rank
the collectives still run (copies), so the path is the one of P ranks.

Every rank of the group returns the full flow, so a sampler's arithmetic
around the model stays replicated.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..config import DiTConfig
from ..models.dit import CrossKV
from ..models.dit_bidirectional import (_attend, _bidi_block, _bidi_head, _bidi_prologue,
                                        _check_impl)
from ..ops.rope import RopeTables
from .mesh import all_gather_dim


def heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """[..., S/P, N, D] sequence-sharded -> [..., S, N/P, D] head-sharded:
    rank r gets heads [r*N/P, (r+1)*N/P) of every rank's tokens, the
    token slices concatenated in rank order along the S axis (dim -3)."""
    p = dist.get_world_size(group)
    *lead, sl, n, d = x.shape
    k = len(lead)
    send = x.reshape(*lead, sl, p, n // p, d).movedim(k + 1, 0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # [P (source), *lead, S/P, N/P, D] -> [*lead, P * S/P, N/P, D]
    return recv.movedim(0, k).reshape(*lead, p * sl, n // p, d)


def seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """[..., S, N/P, D] head-sharded -> [..., S/P, N, D] sequence-sharded:
    the inverse of :func:`heads_to_seq`."""
    p = dist.get_world_size(group)
    *lead, s, nl, d = x.shape
    k = len(lead)
    send = x.reshape(*lead, p, s // p, nl, d).movedim(k, 0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # [P (source = head slice), *lead, S/P, N/P, D] -> [*lead, S/P, P * N/P, D]
    return recv.movedim(0, k + 1).reshape(*lead, s // p, p * nl, d)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                      attn_impl: str = "auto") -> torch.Tensor:
    """Attention of sequence-sharded q, k, v [B, S/P, N, D] over the whole
    sequence; returns [B, S/P, N, D], sharded as q.  N must divide over the
    group."""
    qg, kg, vg = heads_to_seq(torch.stack([q, k, v]), group).unbind(0)  # one all-to-all
    return seq_to_heads(_attend(qg, kg, vg, attn_impl, cross=False), group)


def sp_bidirectional_forward(params: dict, cfg: DiTConfig, tables: RopeTables, group,
                             x: torch.Tensor, t: torch.Tensor, cross_kv: CrossKV,
                             attn_impl: str = "auto") -> torch.Tensor:
    """``bidirectional_forward`` with the tokens sharded over ``group``:
    x [B, F, C, H, W] and t [B] replicated; returns the flow [B, F, C, H, W]
    (float32), the same on every rank.  Numerically the single-card forward
    (one rank: its bits)."""
    _check_impl(attn_impl)
    p, r = dist.get_world_size(group), dist.get_rank(group)
    n = cfg.num_heads
    tokens, e, e0, rope_cos, rope_sin = _bidi_prologue(params, cfg, tables, x, t)
    s = tokens.shape[1]
    if s % p or n % p:
        raise ValueError(f"sequence parallelism over {p} ranks needs the tokens ({s}) and "
                         f"the heads ({n}) to divide over them")
    sl = slice(r * s // p, (r + 1) * s // p)
    tokens = tokens[:, sl].contiguous()
    rope_cos, rope_sin = rope_cos[sl], rope_sin[sl]

    def attend(q, k, v):
        return ulysses_attention(q, k, v, group, attn_impl)

    for li, layer_p in enumerate(params["blocks"]):
        tokens = _bidi_block(tokens, layer_p, cross_kv.k[li], cross_kv.v[li], e0, rope_cos,
                             rope_sin, cfg, attn_impl, self_attend=attend)
    tokens = all_gather_dim(tokens, 1, group)
    return _bidi_head(params["head"], cfg, tokens, e, x.shape)
