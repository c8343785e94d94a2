"""Frame-sink + ring-window KV cache.

The buffer is ``[sink | ring]`` frames.  Frame ``f`` lives at frame-slot
``f`` if ``f < sink`` else ``sink + (f - ring_base) % ring``; nothing is ever
rolled or copied, steady-state eviction is the ring overwriting its oldest
slot.  Attention over the cache is dense over [sink ++ window] with only a
validity mask during warm-up.  The counters (``ring_base``, ``sink_filled``,
``ring_filled``) are host ints: the pipeline knows every block position.

K and V are stored ``[L, B, N, S, D]``: layer ``l``'s rows are one
contiguous ``[B*N, S, D]`` block, the attention kernel's K/V operand, reached
by a pointer offset with no per-layer copy.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..config import CacheConfig


@dataclasses.dataclass
class KVCache:
    """k, v: [L, B, N, S, D] roped keys / values; counters are host ints."""

    k: torch.Tensor
    v: torch.Tensor
    ring_base: int
    sink_filled: int = 0
    ring_filled: int = 0


def init_cache(cfg: CacheConfig, num_layers: int, batch: int, num_heads: int,
               head_dim: int, dtype=torch.bfloat16, device="cpu") -> KVCache:
    shape = (num_layers, batch, num_heads, cfg.size_tokens, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        ring_base=cfg.sink_frames,
    )


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
                  device="cpu") -> torch.Tensor:
    """Token-level boolean mask over the cache a forward at
    [start, +num_frames) may attend, the current block included.
    ``window_frames`` caps the budget to sink + the most recent frames when
    the cache holds more history."""
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
    return torch.tensor(valid, dtype=torch.bool, device=device).repeat_interleave(cfg.frame_seq)
