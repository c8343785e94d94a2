"""Pipelined serving: the VAE decode of one segment overlaps the generation
of the next.

The JAX package overlaps the two by asynchronous dispatch to another device,
and runs serially when the decode device is the generation chip.  The
renderer does the same: its decode is enqueued on the decode device's
current stream, so with ``decode_device`` on another card the latents cross
with a non-blocking copy and neither card's launches block the host, while
on the generation card (or the CPU) segment n's decode runs after segment
n's generation, in the serial path's order.  On a card each sample decodes
as its own B = 1 chain, as ``run_inference``'s serial path decodes, so K2
takes every conv it takes there and the pixels are that path's, bit for
bit.

Over a sequence-parallel pipeline (built with a ``mesh``) every rank of the sp group
generates, and holds the full latents after the flow's all-gather; only the
group's rank 0 decodes, and the others' ``render`` returns None.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Union

import torch
import torch.distributed as dist

from ..models import dit as D
from ..models import vae as V
from ..utils.memory import map_tree
from .causal_inference import CausalInferencePipeline


def _decode_device(pipe: CausalInferencePipeline,
                   decode_device: Union[None, int, str, torch.device]) -> torch.device:
    """The JAX package's default is the last visible device: here the last
    CUDA card for a pipeline on the card, the pipeline's device otherwise.
    An int is a CUDA device index."""
    if decode_device is None:
        if pipe.device.type != "cuda":
            return pipe.device
        decode_device = torch.cuda.device_count() - 1
    if isinstance(decode_device, int):
        if not 0 <= decode_device < torch.cuda.device_count():
            raise ValueError(f"decode device {decode_device}: this host has "
                             f"{torch.cuda.device_count()} CUDA device(s)")
        return torch.device("cuda", decode_device)
    return torch.device(decode_device)


class PipelinedRenderer:
    """Drives generate -> decode with segment-level overlap.

    pipe:           a CausalInferencePipeline.
    vae_params:     the VAE's parameters; moved to ``decode_device``.
    segment_frames: latent frames per segment (a multiple of the pipeline's
                    frame block; larger amortises more, smaller lowers the
                    first frame's latency and a switch's granularity).
    decode_device:  where the VAE runs (see ``_decode_device``).
    per_stream_decode: with B > 1, decode each stream's latents as a
                    separate B = 1 call with its own conv caches: the decode's
                    peak memory is one stream's temporaries instead of B
                    times them.  The VAE mixes no samples, so the pixels are
                    the batched decode's.  A decode on a card always takes
                    this form: K2 takes batch 1 only.
    """

    def __init__(self, pipe: CausalInferencePipeline, vae_params: dict, vae_cfg: V.VAEConfig,
                 segment_frames: int = 12,
                 decode_device: Union[None, int, str, torch.device] = None,
                 per_stream_decode: bool = False):
        if segment_frames <= 0 or segment_frames % pipe.frame_block:
            raise ValueError(f"segment_frames {segment_frames} must be a positive multiple of "
                             f"the pipeline's frame block {pipe.frame_block}")
        self.pipe = pipe
        self.vcfg = vae_cfg
        self.segment_frames = segment_frames
        self.per_stream_decode = per_stream_decode
        self.decode_device = _decode_device(pipe, decode_device)
        dev = self.decode_device
        self.vae_params = map_tree(lambda t: t if t.device == dev else t.to(dev), vae_params)
        # under sp, the group's rank 0 alone decodes
        self.decodes = pipe.sp_group is None or dist.get_rank(pipe.sp_group) == 0

    def _decode(self, lat: torch.Tensor, caches, first: bool):
        """(pixels, caches) of one segment's latents, on the current stream."""
        per_stream = self.per_stream_decode or self.decode_device.type == "cuda"
        if not (per_stream and lat.shape[0] > 1):
            return V.vae_decode_scan(self.vae_params, self.vcfg, lat, caches, first)
        # B separate B = 1 decodes, each with its own conv-cache chain
        caches = caches or [None] * lat.shape[0]
        rows = []
        for s in range(lat.shape[0]):
            row, caches[s] = V.vae_decode_scan(self.vae_params, self.vcfg, lat[s:s + 1],
                                               caches[s], first)
            rows.append(row)
        return torch.cat(rows, dim=0), caches

    @torch.no_grad()
    def render(self, noise: torch.Tensor, cross_kv: D.CrossKV,
               generator: Optional[torch.Generator] = None, dtype=torch.bfloat16,
               poll_switch: Optional[Callable[[int], Optional[D.CrossKV]]] = None
               ) -> Optional[torch.Tensor]:
        """noise [B, T, C, H, W] -> pixels [B, 1 + 4 (T - 1), 3, H*8, W*8]
        in [-1, 1], on the decode device (None on an sp rank that does not
        decode).

        ``poll_switch(segment_start_frame)``: consulted before each segment;
        a CrossKV it returns is an unscheduled prompt switch, applied through
        ``CausalInferencePipeline.reactive_switch`` (its replay bounded by
        ``reactive_recache_frames`` when set).  A switch lands on a segment
        boundary: lower ``segment_frames`` for a finer one."""
        t = noise.shape[1]
        seg = self.segment_frames
        pipe = self.pipe
        generator = pipe._generator(generator)
        # the latent history a reactive replay reads: the window, else the
        # bounded replay, else the whole video (global attention asks for
        # it explicitly through reactive_recache_frames)
        local = pipe.config.local_attn_size
        window = local if local != -1 else (pipe.config.reactive_recache_frames or t)
        hist: Optional[torch.Tensor] = None
        cache = vae_caches = None
        pixel_segs: List[torch.Tensor] = []
        start = 0
        while start < t:
            if poll_switch is not None:
                new_cross = poll_switch(start)
                if new_cross is not None:
                    if start > 0:
                        cache = pipe.reactive_switch(cache, hist, new_cross, start)
                    cross_kv = new_cross
            n = min(seg, t - start)
            lat, cache = pipe.generate_latents_scanned(noise[:, start:start + n], cross_kv,
                                                       generator, cache, start)
            if poll_switch is not None:
                hist = (lat if hist is None else torch.cat([hist, lat], dim=1))[:, -window:]
            first, start = start == 0, start + n
            if not self.decodes:
                continue
            lat = lat.to(dtype)
            dev = self.decode_device
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                # a copy to another card does not block the host
                lat = lat.to(dev, non_blocking=lat.device.type == dev.type == "cuda")
                px, vae_caches = self._decode(lat, vae_caches, first)
            pixel_segs.append(px)
        return torch.cat(pixel_segs, dim=1) if self.decodes else None
