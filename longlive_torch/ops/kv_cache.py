"""Frame-sink + ring-window KV cache.

The buffer is ``[sink | ring]`` frames.  Frame ``f`` lives at frame-slot
``f`` if ``f < sink`` else ``sink + (f - ring_base) % ring``; nothing is ever
rolled or copied, steady-state eviction is the ring overwriting its oldest
slot.  Attention over the cache is dense over [sink ++ window] with only a
validity mask during warm-up.  The counters (``ring_base``, ``sink_filled``,
``ring_filled``) are host ints: the pipeline knows every block position.

K and V are stored ``[L, B, N, S, D]``: layer ``l``'s rows are one
contiguous ``[B*N, S, D]`` block, the attention kernel's K/V operand, reached
by a pointer offset with no per-layer copy.  This is the port's one layout:
the JAX package's second, kernel-operand layout and its converters
(``to_kernel_layout`` / ``from_kernel_layout``) have no counterpart here,
and ``kernel_cache`` resolves to the same arithmetic on this layout.

Buffers are updated in place: forwards write their K/V into them and a
prompt switch's ``zero_cache`` clears them, so a caller that still needs
the old contents clones first.

The int8 K cache (``init_cache(k_int8=True)``, the ``kv_int8`` serving
mode) stores K as int8 with one float32 scale per token and head in
``k_scale`` [L, B, N, S]; V stays in the cache dtype.  The training
rollout's int8 cache (``cache_int8``: ``k_int8`` and ``v_int8``) stores V
so too, with ``v_scale``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from ..config import CacheConfig


@dataclasses.dataclass
class KVCache:
    """k, v: [L, B, N, S, D] roped keys / values; counters are host ints;
    k_scale / v_scale: [L, B, N, S] float32 when k / v is int8, else None."""

    k: torch.Tensor
    v: torch.Tensor
    ring_base: int
    sink_filled: int = 0
    ring_filled: int = 0
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


def init_cache(cfg: CacheConfig, num_layers: int, batch: int, num_heads: int,
               head_dim: int, dtype=torch.bfloat16, device="cpu",
               k_int8: bool = False, v_int8: bool = False) -> KVCache:
    shape = (num_layers, batch, num_heads, cfg.size_tokens, head_dim)

    def scales(on):
        return torch.zeros(shape[:-1], dtype=torch.float32, device=device) if on else None

    return KVCache(
        k=torch.zeros(shape, dtype=torch.int8 if k_int8 else dtype, device=device),
        v=torch.zeros(shape, dtype=torch.int8 if v_int8 else dtype, device=device),
        ring_base=cfg.sink_frames, k_scale=scales(k_int8), v_scale=scales(v_int8))


def clone_cache(cache: KVCache) -> KVCache:
    """A copy of the cache's buffers (the counters are host ints)."""
    return dataclasses.replace(
        cache, **{n: None if getattr(cache, n) is None else getattr(cache, n).clone()
                  for n in ("k", "v", "k_scale", "v_scale")})


def to_standard_layout(cache: KVCache):
    """(k, v) as [L, B, S, N, D] — the JAX package's standard cache layout."""
    return cache.k.transpose(2, 3), cache.v.transpose(2, 3)


def frame_slot(cfg: CacheConfig, frame: int, ring_base: int) -> int:
    """Frame-granular cache slot for absolute frame index ``frame``."""
    if frame < cfg.sink_frames:
        return frame
    return cfg.sink_frames + (frame - ring_base) % cfg.ring_frames


def block_write_offsets(cfg: CacheConfig, cache: KVCache, start_frame: int,
                        num_frames: int) -> List[int]:
    """Token offsets into the cache for frames [start, start + num_frames)."""
    return [frame_slot(cfg, start_frame + i, cache.ring_base) * cfg.frame_seq
            for i in range(num_frames)]


def write_block_kv(cfg: CacheConfig, cache: KVCache, layer: int, new_k: torch.Tensor,
                   new_v: torch.Tensor, offsets: Sequence[int],
                   write_frames: Optional[Sequence[int]] = None,
                   new_k_scale: Optional[torch.Tensor] = None,
                   new_v_scale: Optional[torch.Tensor] = None) -> None:
    """Writes frames ``write_frames`` (default all) of a block's roped K/V
    ``new_k``/``new_v`` [B, F*frame_seq, N, D] into layer ``layer`` of the
    cache, frame ``i`` at token offset ``offsets[i]``; an int8 cache also
    takes the block's scales ``new_k_scale`` / ``new_v_scale`` [B,
    F*frame_seq, N].  Frames may land in
    slots that are not consecutive (a sink or ring that is no multiple of
    the block, or a ring base moved by an odd recache): each run of frames
    whose slots do follow each other is one copy, so a block in consecutive
    slots is written at once."""
    fs = cfg.frame_seq
    frames = list(range(len(offsets)) if write_frames is None else write_frames)
    runs = []  # [first frame, first token offset, frames]
    for i in frames:
        last = runs[-1] if runs else None
        if last and i == last[0] + last[2] and offsets[i] == last[1] + last[2] * fs:
            last[2] += 1
        else:
            runs.append([i, offsets[i], 1])
    for i, off, nf in runs:
        src = slice(i * fs, (i + nf) * fs)
        cache.k[layer, :, :, off:off + nf * fs].copy_(new_k[:, src].transpose(1, 2))
        cache.v[layer, :, :, off:off + nf * fs].copy_(new_v[:, src].transpose(1, 2))
        if cache.k_scale is not None:
            cache.k_scale[layer, :, :, off:off + nf * fs].copy_(new_k_scale[:, src].transpose(1, 2))
        if cache.v_scale is not None:
            cache.v_scale[layer, :, :, off:off + nf * fs].copy_(new_v_scale[:, src].transpose(1, 2))


def advance(cfg: CacheConfig, cache: KVCache, start_frame: int,
            num_frames: int) -> KVCache:
    """Counter update after committing a block at [start, +num_frames)."""
    end = start_frame + num_frames
    sink_filled = max(cache.sink_filled, min(end, cfg.sink_frames))
    to_ring = max(end - max(start_frame, cfg.sink_frames), 0)
    ring_filled = min(cache.ring_filled + to_ring, cfg.ring_frames)
    return dataclasses.replace(cache, sink_filled=sink_filled,
                               ring_filled=ring_filled)


def validity_mask(cfg: CacheConfig, cache: KVCache, start_frame: int,
                  num_frames: int, window_frames: Optional[int] = None,
                  device="cpu", exclude_block: bool = False) -> torch.Tensor:
    """Token-level boolean mask over the cache a forward at
    [start, +num_frames) may attend, the current block included.
    ``window_frames`` caps the budget to sink + the most recent frames when
    the cache holds more history.  ``exclude_block`` drops the slots the
    block writes: the training form attends [cache ++ fresh block] with
    the block as a second segment, so its stale slots are masked out (the
    union of this mask and the block is the written-through mask)."""
    after = advance(cfg, cache, start_frame, num_frames)
    valid = []
    end = start_frame + num_frames
    budget = None
    if window_frames is not None and window_frames - cfg.sink_frames < cfg.ring_frames:
        budget = window_frames - cfg.sink_frames
    for slot in range(cfg.total_frames):
        if slot < cfg.sink_frames:
            ok = slot < after.sink_filled
        else:
            r = slot - cfg.sink_frames
            ok = r < after.ring_filled
            if budget is not None:
                # latest absolute frame held by ring slot r
                slot_frame = end - 1 - (end - 1 - (cache.ring_base + r)) % cfg.ring_frames
                ok = ok and slot_frame >= end - budget
        valid.append(ok)
    if exclude_block:
        for i in range(num_frames):
            valid[frame_slot(cfg, start_frame + i, cache.ring_base)] = False
    return torch.tensor(valid, dtype=torch.bool, device=device).repeat_interleave(cfg.frame_seq)


def recache_state(cfg: CacheConfig, cache: KVCache, end_frame: int,
                  num_recache_frames: int) -> KVCache:
    """Counters after a KV-recache that replayed frames
    [end_frame - n, end_frame) packed linearly from slot 0: later ring
    writes then evict in the replay's order.  The buffers are rewritten by
    the recache forward itself."""
    n = int(num_recache_frames)
    return dataclasses.replace(
        cache, ring_base=int(end_frame) - n + cfg.sink_frames,
        sink_filled=min(n, cfg.sink_frames),
        ring_filled=min(max(n - cfg.sink_frames, 0), cfg.ring_frames))


def zero_cache(cache: KVCache) -> KVCache:
    """Zeroes the buffers in place and keeps the counters (a prompt switch
    clears the K/V but not the fill state; ``recache_state`` resets it)."""
    cache.k.zero_()
    cache.v.zero_()
    for sc in (cache.k_scale, cache.v_scale):
        if sc is not None:
            sc.zero_()
    return dataclasses.replace(cache)


def recache_valid(cfg: CacheConfig, num_frames: int, window_frames: int,
                  device="cpu") -> torch.Tensor:
    """Token-level mask a recache forward whose replay fills slots
    [0, num_frames) attends: the sink slots plus the most recent
    ``window_frames - sink`` replay slots."""
    sink = cfg.sink_frames
    n = max(num_frames, sink)
    budget = window_frames - sink
    valid = [slot < sink or n - budget <= slot < n for slot in range(cfg.total_frames)]
    return torch.tensor(valid, dtype=torch.bool, device=device).repeat_interleave(cfg.frame_seq)
