"""Frame-level attention masks of the full-sequence forwards.

The masks are built at frame granularity ([F_q, F_kv] bool, on an explicit
device), since the structure is constant within a frame.  ``FrameMaskSpec``
describes one of them by its parameters, so the frame-masked attention
kernel (``ops.attention.flash_attention_frame_masked``) can compute it from
token indices instead of reading a token-level [S, S] mask (4+ GB at the
training geometry).  ``expand_frame_mask`` gives the token-level mask for
the dense route at small sizes.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class FrameMaskSpec:
    """A frame-structured mask by its parameters.  ``kind``:
    ``block_causal``, ``sink_window`` (``local_attn_size`` counts the sink
    frames too) or ``teacher_forcing`` (the [clean | noisy] layout over
    ``clean_frames`` frames per half)."""

    kind: str
    num_frame_per_block: int = 1
    local_attn_size: int = -1
    sink_frames: int = 0
    clean_frames: int = 0

    def materialize(self, num_frames: int, device="cpu") -> torch.Tensor:
        if self.kind == "block_causal":
            return blockwise_causal_frame_mask(num_frames, self.num_frame_per_block,
                                               self.local_attn_size, device)
        if self.kind == "sink_window":
            return sink_window_frame_mask(num_frames, self.num_frame_per_block,
                                          self.sink_frames,
                                          self.local_attn_size - self.sink_frames, device)
        if self.kind == "teacher_forcing":
            return teacher_forcing_frame_mask(num_frames, self.num_frame_per_block, device)
        raise ValueError(self.kind)


def _grid(nq: int, nk: int, device):
    return (torch.arange(nq, device=device)[:, None], torch.arange(nk, device=device)[None, :])


def blockwise_causal_frame_mask(num_frames: int, num_frame_per_block: int = 1,
                                local_attn_size: int = -1, device="cpu") -> torch.Tensor:
    """[F, F] bool: query frame q attends kv frame k iff k lies in a block
    that ends at or before q's block end, within the last
    ``local_attn_size`` frames of it (-1: no window)."""
    q, k = _grid(num_frames, num_frames, device)
    ends = (q // num_frame_per_block + 1) * num_frame_per_block
    m = k < ends
    if local_attn_size != -1:
        m = m & (k >= ends - local_attn_size)
    return m


def blockwise_causal_frame_mask_i2v(num_frames: int, num_frame_per_block: int = 3,
                                    local_attn_size: int = -1, device="cpu") -> torch.Tensor:
    """The image-to-video variant: frame 0 is a block of its own, later
    frames form blocks of ``num_frame_per_block`` starting at frame 1."""
    q, k = _grid(num_frames, num_frames, device)
    blk = num_frame_per_block
    ends = torch.where(q < 1, 1, ((q - 1) // blk + 1) * blk + 1)
    m = k < ends
    if local_attn_size != -1:
        m = m & (k >= ends - local_attn_size)
    return m


def teacher_forcing_frame_mask(num_frames: int, num_frame_per_block: int = 1,
                               device="cpu") -> torch.Tensor:
    """[2F, 2F] bool over [clean | noisy]: a clean frame attends the clean
    frames of its block and the earlier blocks; a noisy frame of block i
    attends the noisy frames of block i and the clean frames of the blocks
    before i; every frame attends itself.  A partial last block (F not a
    multiple of the block) stays inside its half of the sequence."""
    f, blk = num_frames, num_frame_per_block
    q, k = _grid(2 * f, 2 * f, device)
    q_is_noise = q >= f
    q_block = torch.where(q_is_noise, q - f, q) // blk
    clean_mask = (~q_is_noise) & (k < torch.clamp((q_block + 1) * blk, max=f))
    noise_own = (k >= f + q_block * blk) & (k < torch.clamp(f + (q_block + 1) * blk, max=2 * f))
    noise_ctx = k < q_block * blk
    return clean_mask | (q_is_noise & (noise_own | noise_ctx)) | (q == k)


def sink_window_frame_mask(num_frames: int, num_frame_per_block: int, sink_frames: int,
                           ring_frames: int, device="cpu") -> torch.Tensor:
    """[F, F] bool: the pattern cached generation with a frame sink and a
    ring window realizes.  Query frame q sees kv frame k iff k was generated
    no later than q's block and k is a sink frame or among the last
    ``ring_frames`` frames at that point."""
    q, k = _grid(num_frames, num_frames, device)
    ends = (q // num_frame_per_block + 1) * num_frame_per_block
    in_ring = k >= torch.clamp(ends - ring_frames, min=sink_frames)
    return (k < ends) & ((k < sink_frames) | in_ring)


def expand_frame_mask(frame_mask: torch.Tensor, frame_seq: int) -> torch.Tensor:
    """[Fq, Fkv] -> [Fq * fs, Fkv * fs] token-level bool (small sizes only)."""
    return frame_mask.repeat_interleave(frame_seq, 0).repeat_interleave(frame_seq, 1)
