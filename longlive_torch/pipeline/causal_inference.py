"""Autoregressive causal generation pipeline.

Per 3-frame block: four denoising forwards (flow -> x0, re-noise to the
next timestep between them), then a clean-context commit forward on x0 whose
only product is the block's K/V in the cache.  The cache is updated in
place: each denoise pass overwrites the block's slots before attending, so
threading one buffer through the passes equals discarding their writes, and
the fill counters advance only on the commit.
"""

from __future__ import annotations

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


def check_supported(config: PipelineConfig) -> None:
    """Knobs of the JAX package this slice of the port does not carry yet."""
    todo = {
        "kv_int8": (config.kv_int8, "queue 1, item 9 (int8)"),
        "fused_rope": (config.fused_rope, "queue 2, K1 mode q_rope"),
        "kernel_cache: false": (config.kernel_cache is False,
                                "queue 1, item 8 (write-then-attend cache form)"),
        "switch_frame_indices": (bool(config.switch_frame_indices),
                                 "queue 1, item 8 (interactive generation)"),
        "eager_recache": (config.eager_recache, "queue 1, item 8"),
    }
    for key, (on, item) in todo.items():
        if on:
            raise NotImplementedError(f"{key} is not ported yet: ROADMAP {item}")


class CausalInferencePipeline:
    """Block-by-block AR generation with a frame-sink + ring-window cache.

    ``params``: a DiT parameter dict (models.dit.init_dit_params or
    utils.params.dit_params_from_jax) on ``device``."""

    def __init__(self, config: PipelineConfig, params: dict,
                 geometry: LatentGeometry = LatentGeometry(),
                 dit_config: Optional[DiTConfig] = None, device="cuda",
                 deterministic_renoise: bool = False):
        check_supported(config)
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
        if (self.cache_cfg.sink_frames % self.frame_block
                or self.cache_cfg.ring_frames % self.frame_block):
            raise NotImplementedError(
                "sink_size and local_attn_size - sink_size must be multiples "
                "of num_frame_per_block (contiguous block writes); the "
                "per-frame write form waits for ROADMAP queue 1, item 8")

    @property
    def dtype(self) -> torch.dtype:
        return self.params["patch_embedding"]["weight"].dtype

    def _forward(self, x, t_val, cross_kv, cache, start_frame, **kw):
        b, f = x.shape[:2]
        t = torch.full((b, f), t_val, dtype=torch.float32, device=x.device)
        return D.dit_forward_cached(self.params, self.cfg, self.cache_cfg, self.tables,
                                    x, t, cross_kv, cache, start_frame, **kw)

    def _block_step(self, cache: kvc.KVCache, cross_kv: D.CrossKV,
                    noise_block: torch.Tensor, start_frame: int,
                    generator: Optional[torch.Generator]):
        """4-step denoise + clean-context commit for one block."""
        b, f = noise_block.shape[:2]
        x = noise_block
        x0 = x
        n_steps = len(self.denoise_timesteps)
        reuse_kv = self.config.reuse_last_denoise_kv
        for i, t_val in enumerate(self.denoise_timesteps):
            # reuse_last_denoise_kv: the last denoise pass commits its K/V
            # in place of the clean-context commit forward
            commit = reuse_kv and i == n_steps - 1
            flow, cache = self._forward(x, t_val, cross_kv, cache, start_frame,
                                        advance_counters=commit)
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
        if not reuse_kv:
            _, cache = self._forward(x0, float(self.config.context_noise), cross_kv,
                                     cache, start_frame, kv_only=True)
        return x0, cache

    def init_cache(self, batch_size: int, dtype=None) -> kvc.KVCache:
        return kvc.init_cache(self.cache_cfg, self.cfg.num_layers, batch_size,
                              self.cfg.num_heads, self.cfg.head_dim,
                              dtype or self.dtype, self.device)

    def prepare_condition(self, prompt_embeds: torch.Tensor) -> D.CrossKV:
        """prompt_embeds: [B, text_len, text_dim] zero-padded text features."""
        return D.prepare_cross_kv(self.params, self.cfg,
                                  prompt_embeds.to(self.device), self.dtype)

    @torch.no_grad()
    def generate_latents(
        self, noise: torch.Tensor, cross_kv: D.CrossKV,
        generator: Optional[torch.Generator] = None, profile: bool = False,
    ) -> torch.Tensor:
        """noise [B, T, C, H, W] -> latents [B, T, C, H, W] float32."""
        b, t_frames = noise.shape[:2]
        fpb = self.frame_block
        assert t_frames % fpb == 0
        if generator is None and not self.deterministic_renoise:
            generator = torch.Generator(device=self.device).manual_seed(self.config.seed)
        noise = noise.to(self.device)
        cache = self.init_cache(b)
        outputs = []
        block_times = []
        for s in range(0, t_frames, fpb):
            t0 = time.perf_counter()
            x0, cache = self._block_step(cache, cross_kv, noise[:, s:s + fpb], s, generator)
            outputs.append(x0)
            if profile:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                block_times.append(time.perf_counter() - t0)
        latents = torch.cat(outputs, dim=1)
        if profile:
            steady = block_times[2:] or block_times
            mean = float(np.mean(steady))
            print(f"[profile] blocks={len(block_times)} "
                  f"steady-state latency={mean / fpb * 1e3:.2f} ms/latent-frame "
                  f"({fpb / mean:.2f} latent fps, {4 * fpb / mean:.2f} pixel fps)")
        return latents
