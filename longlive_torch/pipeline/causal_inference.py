"""Autoregressive causal generation pipeline.

Per 3-frame block: four denoising forwards (flow -> x0, re-noise to the
next timestep between them), then a clean-context commit forward on x0 whose
only product is the block's K/V in the cache.  The cache is updated in
place: each denoise pass overwrites the block's slots before attending, so
threading one buffer through the passes equals discarding their writes, and
the fill counters advance only on the commit.

A prompt switch rebuilds the cache under the new prompt by replaying the
last generated frames in one kv_only forward (the KV-recache,
``build_recache_fn``), or chunk by chunk while those frames are generated
(``EagerRecache``).

Serving two-segment decode (``LONGLIVE_TWO_SEGMENT=1`` with ``kernel_cache:
false``): every standard forward -- the denoise passes and the commit --
attends [cache ++ fresh block] without writing the cache in the layer loop;
the denoise passes commit nothing and the commit (or, under
``reuse_last_denoise_kv``, the last denoise pass) writes the block's K/V
once after it.  The recaches pass explicit cache plumbing and keep the
write-then-attend form.

Quantized serving: ``kv_int8`` stores the cache's K as int8 with per-token
scales (attention then runs QK^T in int8 and q's RoPE is not fused);
``recache_attn_impl: pallas_qk8`` runs the one-shot recache forwards with
int8 QK^T on a bf16 cache; int8 block linears come with the parameters
(``ops.quant.quantize_dit_params``).
"""

from __future__ import annotations

import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import CacheConfig, DiTConfig, LatentGeometry, PipelineConfig
from ..models import dit as D
from ..ops import kv_cache as kvc
from ..ops import scheduler as S
from ..ops.rope import make_rope_tables
from ..utils.device import resolve_device


def build_recache_fn(cfg: DiTConfig, cache_cfg: CacheConfig, tables, sched_context_noise: float,
                     num_frames: int, global_sink: bool, overwrite_sink: bool,
                     window_frames: int, forward=None):
    """The KV-recache of a prompt switch: zero the cache (unless
    ``global_sink``), then replay the last ``num_frames`` generated frames
    under the new prompt in ONE kv_only forward that writes their K/V
    linearly from slot 0 (from the sink boundary when the original sink is
    kept) and attends the sink plus the most recent window of the replay.

    ``forward``: optional pipeline-style callable
    ``(params, x, t_val, cross, cache, start, **kw)``; defaults to the cached
    DiT forward.  Returns fn(params, cache, cross_new, replay,
    recache_start_frame) -> cache, which updates ``cache``'s buffers in
    place."""
    sink = cache_cfg.sink_frames

    if forward is None:
        def forward(params, x, t_val, cross, cache, start, **kw):
            b, f = x.shape[:2]
            t = torch.full((b, f), t_val, dtype=torch.float32, device=x.device)
            return D.dit_forward_cached(params, cfg, cache_cfg, tables, x, t, cross, cache,
                                        start, **kw)

    def fn(params, cache, cross_new, replay, recache_start_frame):
        n = num_frames
        if not global_sink:
            cache = kvc.zero_cache(cache)
        state = kvc.recache_state(cache_cfg, cache, recache_start_frame + n, n)
        write_frames = tuple(range(n)) if overwrite_sink else tuple(range(sink, n))
        _, state = forward(
            params, replay, float(sched_context_noise), cross_new, state,
            recache_start_frame,
            kv_valid=kvc.recache_valid(cache_cfg, n, window_frames, device=replay.device),
            offsets=[i * cache_cfg.frame_seq for i in range(n)],
            write_frames=write_frames, advance_counters=False, kv_only=True)
        return state

    return fn


class EagerRecache:
    """Incremental (chunked) prompt-switch KV-recache, which hides the
    switch stall.

    With a switch scheduled at frame ``s`` the replay window [s - n, s) is
    generated one block at a time BEFORE the switch, and the recache is a
    blockwise-causal prefill: as each pre-switch block lands, its chunk is
    committed (kv_only, under the NEW prompt) into a second cache.  At the
    switch nothing but the counters is left to do.  Total work equals the
    one-shot recache; the memory cost is the second cache while the switch
    approaches.  Replay block i never attends later blocks, which is the
    blockwise-causal mask of the reference's interactive mode.

    Usage (switch at frame ``s`` known in advance):
        er = pipe.begin_eager_recache(batch, switch_frame=s)
        er.feed(cross_new, latents, latents_start)   # any time frames land
        cache = er.finish()                          # at the switch
    ``feed`` consumes the overlap of a latent span with the replay window
    [s - n, s); frames outside it are ignored."""

    def __init__(self, pipe: "CausalInferencePipeline", batch: int, switch_frame: int,
                 dtype=None):
        fpb = pipe.frame_block
        local = pipe.config.local_attn_size
        n = switch_frame if local == -1 else min(local, switch_frame)
        if n % fpb:
            raise ValueError(
                f"eager recache needs a block-aligned replay ({n} frames, "
                f"block {fpb}); use the one-shot recache")
        self.pipe = pipe
        self.n = n
        self.start = switch_frame - n  # absolute frame of replay index 0
        self.fed = 0  # replay frames committed so far
        self.cache = pipe.init_cache(batch, dtype)

    def feed(self, cross_new: D.CrossKV, latents: torch.Tensor, latents_start: int) -> int:
        """Commits the overlap of ``[latents_start, +F)`` with the replay
        frames not fed yet.  Returns the number of frames consumed."""
        fpb = self.pipe.frame_block
        consumed = 0
        while self.fed < self.n:
            c0 = self.fed
            abs0 = self.start + c0
            if not (latents_start <= abs0 and abs0 + fpb <= latents_start + latents.shape[1]):
                break
            chunk = latents[:, abs0 - latents_start:abs0 - latents_start + fpb]
            self.cache = self.pipe._eager_recache_chunk(self.cache, cross_new, chunk, c0,
                                                        self.start)
            self.fed += fpb
            consumed += fpb
        return consumed

    def finish(self) -> kvc.KVCache:
        """The completed post-switch cache: frames packed from slot 0,
        counters as after the one-shot recache."""
        assert self.fed == self.n, f"eager recache incomplete: {self.fed}/{self.n} frames fed"
        return kvc.recache_state(self.pipe.cache_cfg, self.cache, self.start + self.n, self.n)


class CausalInferencePipeline:
    """Block-by-block AR generation with a frame-sink + ring-window cache.

    ``params``: a DiT parameter dict (models.dit.init_dit_params or
    utils.params.dit_params_from_jax) on ``device``."""

    def __init__(self, config: PipelineConfig, params: dict,
                 geometry: LatentGeometry = LatentGeometry(),
                 dit_config: Optional[DiTConfig] = None, device="cuda",
                 deterministic_renoise: bool = False):
        self.config = config
        self.params = params
        self.geom = geometry
        self.cfg = dit_config or config.dit_config()
        self.device = resolve_device(device)
        # zero re-noise between denoise steps: removes the only RNG-dependent
        # part of the block step (cross-framework parity tests)
        self.deterministic_renoise = deterministic_renoise

        self.sched = S.make_schedule(1000, shift=config.timestep_shift, sigma_min=0.0,
                                     extra_one_step=True, training=True)
        steps = np.asarray(config.denoising_step_list, np.float64)
        if config.warp_denoising_step:
            steps = S.warp_denoising_steps(self.sched, config.denoising_step_list)
        self.denoise_timesteps: Tuple[float, ...] = tuple(float(s) for s in steps)

        self.cache_cfg = CacheConfig.from_model(self.cfg, self.geom,
                                                config.num_output_frames)
        self.tables = make_rope_tables(self.cfg.head_dim, self.cfg.rope_max_pos,
                                       device=self.device)
        self.frame_block = config.num_frame_per_block
        # attention budget in frames (the whole cache at inference)
        self.attn_window_frames = self.cache_cfg.total_frames
        # with sink and ring both multiples of the block, every block's
        # frames land in consecutive cache slots and are written at once
        self._contig = (self.cache_cfg.sink_frames % self.frame_block == 0
                        and self.cache_cfg.ring_frames % self.frame_block == 0)
        # kernel_cache: None = on where the contiguous-ring invariant holds
        # and the cache is bf16.  The port has one cache layout; the value
        # decides, as in the JAX package, whether LONGLIVE_TWO_SEGMENT may
        # take the two-segment decode (only without it), and True adds the
        # JAX package's checks.
        kc = config.kernel_cache
        if kc is None:
            kc = self._contig and not config.kv_int8
        elif kc:
            if config.kv_int8:
                raise ValueError("kernel_cache is a single-device bf16 serving mode "
                                 "(sp == 1, no kv_int8)")
            if not self._contig:
                raise ValueError(
                    "kernel_cache requires the contiguous-ring invariant "
                    "(sink_size and local_attn_size - sink_size must be "
                    "multiples of num_frame_per_block)")
        self.kernel_cache = bool(kc)
        # the one-shot recache's attention: int8 QK^T for "pallas_qk8"
        # (config.RECACHE_ATTN_IMPLS); an int8 cache always attends so
        self._recache_qk8 = config.recache_attn_impl == "pallas_qk8"
        if self._recache_qk8 and config.fused_rope and not config.kv_int8:
            raise ValueError("recache_attn_impl 'pallas_qk8' does not combine with fused_rope "
                             "on a bf16 cache: the int8 QK kernel has no q_rope prologue")

    @property
    def dtype(self) -> torch.dtype:
        return self.params["patch_embedding"]["weight"].dtype

    def _forward(self, params, x, t_val, cross_kv, cache, start_frame, **kw):
        b, f = x.shape[:2]
        t = torch.full((b, f), t_val, dtype=torch.float32, device=x.device)
        kw.setdefault("fused_rope", self.config.fused_rope)
        kw.setdefault("kernel_cache", self.kernel_cache)
        return D.dit_forward_cached(params, self.cfg, self.cache_cfg, self.tables,
                                    x, t, cross_kv, cache, start_frame, **kw)

    def _generator(self, generator: Optional[torch.Generator]) -> Optional[torch.Generator]:
        if generator is None and not self.deterministic_renoise:
            generator = torch.Generator(device=self.device).manual_seed(self.config.seed)
        return generator

    def _block_step(self, cache: kvc.KVCache, cross_kv: D.CrossKV,
                    noise_block: torch.Tensor, start_frame: int,
                    generator: Optional[torch.Generator], skip_commit: bool = False):
        """4-step denoise + clean-context commit for one block.

        ``skip_commit`` (the JAX package's ``_block_fn_nocommit``): no
        commit, and no counter advance.  Exact for the last block before a
        scheduled switch: its committed K/V would be read by nothing (the
        eager recache's cache replaces this one), x0 never depends on the
        commit, and the commit draws no noise."""
        b, f = noise_block.shape[:2]
        x = noise_block
        x0 = x
        n_steps = len(self.denoise_timesteps)
        reuse_kv = self.config.reuse_last_denoise_kv and not skip_commit
        for i, t_val in enumerate(self.denoise_timesteps):
            # reuse_last_denoise_kv: the last denoise pass commits its K/V
            # in place of the clean-context commit forward; the other passes'
            # writes are dropped (two-segment: never made)
            commit = reuse_kv and i == n_steps - 1
            flow, cache = self._forward(self.params, x, t_val, cross_kv, cache, start_frame,
                                        advance_counters=commit, commit_writes=commit)
            t_flat = torch.full((b * f,), t_val, dtype=torch.float32, device=x.device)
            x0 = S.convert_flow_to_x0(
                self.sched, flow.reshape(b * f, *flow.shape[2:]),
                x.reshape(b * f, *x.shape[2:]).float(), t_flat).reshape(x.shape)
            if i < n_steps - 1:
                t_next = torch.full((b * f,), self.denoise_timesteps[i + 1],
                                    dtype=torch.float32, device=x.device)
                if self.deterministic_renoise:
                    noise = torch.zeros(x0.shape, dtype=torch.float32, device=x.device)
                else:
                    noise = torch.randn(x0.shape, generator=generator,
                                        dtype=torch.float32, device=x.device)
                x = S.add_noise(self.sched, x0.reshape(b * f, *x0.shape[2:]),
                                noise.reshape(b * f, *x0.shape[2:]),
                                t_next).reshape(x0.shape)
        if not reuse_kv and not skip_commit:
            _, cache = self._forward(self.params, x0, float(self.config.context_noise),
                                     cross_kv, cache, start_frame, kv_only=True)
        return x0, cache

    def init_cache(self, batch_size: int, dtype=None) -> kvc.KVCache:
        return kvc.init_cache(self.cache_cfg, self.cfg.num_layers, batch_size,
                              self.cfg.num_heads, self.cfg.head_dim,
                              dtype or self.dtype, self.device, k_int8=self.config.kv_int8)

    def prepare_condition(self, prompt_embeds: torch.Tensor) -> D.CrossKV:
        """prompt_embeds: [B, text_len, text_dim] zero-padded text features."""
        return D.prepare_cross_kv(self.params, self.cfg,
                                  prompt_embeds.to(self.device), self.dtype)

    # -- prompt switches -----------------------------------------------------

    def _recache_fn(self, num_frames: int, global_sink: bool,
                    overwrite_sink: Optional[bool] = None):
        """The KV-recache for a prompt switch (``build_recache_fn`` on this
        pipeline's forward).  ``overwrite_sink`` defaults to
        ``not global_sink``: without a global sink the replay's first frames
        become the new sink."""
        if overwrite_sink is None:
            overwrite_sink = not global_sink
        if num_frames % self.frame_block:
            if self.kernel_cache:
                raise ValueError(
                    "kernel_cache requires block-aligned recache sizes; set "
                    "kernel_cache: false to allow odd recache lengths")
            if self._contig:
                # a recache of n frames sets ring_base = t - n + sink, which
                # stays a block multiple only when n is one
                print(f"[longlive_torch] WARNING: odd-sized recache ({num_frames} frames, "
                      f"block {self.frame_block}): later blocks may land in "
                      "non-consecutive cache slots and are written with the "
                      "per-frame form for the rest of this pipeline's life.  Use "
                      "block-aligned replay sizes (reactive_switch rounds down "
                      "automatically).", file=sys.stderr, flush=True)
                self._contig = False
        forward = self._forward
        if self._recache_qk8:
            def forward(*a, **kw):
                return self._forward(*a, qk_int8=True, **kw)
        return build_recache_fn(self.cfg, self.cache_cfg, self.tables,
                                float(self.config.context_noise), num_frames, global_sink,
                                overwrite_sink, self.attn_window_frames, forward=forward)

    def reactive_switch(self, cache: kvc.KVCache, history: torch.Tensor,
                        cross_new: D.CrossKV, current_frame: int,
                        frames: Optional[int] = None) -> kvc.KVCache:
        """Unscheduled (reactive) prompt switch at ``current_frame``: rebuilds
        the KV cache under the new prompt and returns it.

        Without a schedule the eager recache cannot hide the replay, so its
        prefill is the stall.  ``frames`` (default
        ``config.reactive_recache_frames``, else the full
        ``min(local_attn, t)`` window) bounds it, rounded down to whole
        blocks: a replay of r frames cuts the stall roughly r/window, and the
        window refills with post-switch frames.  ``history``: the generated
        latents ending at ``current_frame`` (at least the replay span)."""
        local = self.cfg.local_attn_size
        full = current_frame if local == -1 else min(local, current_frame)
        if frames is None:
            frames = self.config.reactive_recache_frames or full
        fpb = self.frame_block
        n = min(frames, full)
        n -= n % fpb
        if n <= 0:
            n = min(fpb, full)
        assert history.shape[1] >= n, f"history has {history.shape[1]} frames; replay needs {n}"
        replay = history[:, history.shape[1] - n:]
        return self._recache_fn(n, bool(self.config.global_sink))(
            self.params, cache, cross_new, replay, current_frame - n)

    def _eager_recache_chunk(self, cache: kvc.KVCache, cross_new: D.CrossKV,
                             chunk: torch.Tensor, c0: int, recache_start: int) -> kvc.KVCache:
        """One EagerRecache chunk: commits replay frames [c0, c0 + block)
        (kv_only, new prompt) into slots [c0, c0 + block) under the
        recache's sink + window rule, cut at the chunk's end."""
        fpb = self.frame_block
        fs = self.cache_cfg.frame_seq
        _, cache = self._forward(
            self.params, chunk, float(self.config.context_noise), cross_new, cache,
            recache_start + c0,
            kv_valid=kvc.recache_valid(self.cache_cfg, c0 + fpb, self.attn_window_frames,
                                       device=chunk.device),
            offsets=[(c0 + i) * fs for i in range(fpb)], write_frames=tuple(range(fpb)),
            advance_counters=False, kv_only=True)
        return cache

    def begin_eager_recache(self, batch: int, switch_frame: int, dtype=None) -> EagerRecache:
        """Starts an incremental recache for a prompt switch scheduled at
        ``switch_frame`` (see EagerRecache)."""
        return EagerRecache(self, batch, switch_frame, dtype)

    # -- generation loops ------------------------------------------------------

    @torch.no_grad()
    def generate_latents(
        self, noise: torch.Tensor, cross_kv: D.CrossKV,
        generator: Optional[torch.Generator] = None, profile: bool = False,
    ) -> torch.Tensor:
        """noise [B, T, C, H, W] -> latents [B, T, C, H, W] float32."""
        b, t_frames = noise.shape[:2]
        fpb = self.frame_block
        assert t_frames % fpb == 0
        generator = self._generator(generator)
        noise = noise.to(self.device)
        cache = self.init_cache(b)
        outputs = []
        block_times = []
        for s in range(0, t_frames, fpb):
            t0 = time.perf_counter()
            x0, cache = self._block_step(cache, cross_kv, noise[:, s:s + fpb], s, generator)
            outputs.append(x0)
            if profile:
                self._sync()
                block_times.append(time.perf_counter() - t0)
        latents = torch.cat(outputs, dim=1)
        if profile:
            steady = block_times[2:] or block_times
            mean = float(np.mean(steady))
            print(f"[profile] blocks={len(block_times)} "
                  f"steady-state latency={mean / fpb * 1e3:.2f} ms/latent-frame "
                  f"({fpb / mean:.2f} latent fps, {4 * fpb / mean:.2f} pixel fps)")
            self.last_block_times = block_times
        return latents

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
