"""Self-forcing training rollout with the KV cache.

- One denoise step (``exit_idx``) is sampled per rollout and shared by all
  blocks; a block runs denoise steps 0..exit_idx and stops there.
- Only the exit-step forward carries gradient; the earlier steps and the
  clean-context commit run without it.
- The commit re-runs the block at ``context_noise``, with that noise added
  to the prediction first.
- Every random draw comes in explicitly (``draws``), so a replay repeats
  the draws of the rollout it replays.

The gradient form (``cotangent`` given): each block's exit forward is
back-propagated against its slice of the cotangent right away, before the
commit overwrites the cache that forward read, and the gradients gather in
the parameters' ``.grad``.  This is exact: the cache chain and the
re-noise draws, every dependency between blocks, carry no gradient, so the
rollout's VJP is the sum of the per-block VJPs (the JAX package's
``block_vjp``).  Peak memory is one block's activations.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import CacheConfig, DiTConfig
from ..models import dit as D
from ..ops import kv_cache as kvc
from ..ops import scheduler as S
from ..ops.rope import RopeTables


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    denoise_timesteps: Tuple[float, ...]  # warped
    context_noise: float = 0.0
    frame_block: int = 3
    last_step_only: bool = False
    # checkpoint each DiT layer of a forward that carries gradient
    remat_layers: bool = True
    # attention budget in frames (sink + recent); None = the whole cache.
    # The training cache holds min(local + slice, num_training) frames but
    # attends local_attn_size of them.
    window_frames: Optional[int] = None
    # store the rollout's K/V cache int8 (K and V, one float32 scale per
    # token and head): a memory lever only, the cache is context without
    # gradient.  Each block is quantized once, at its commit; the denoise
    # forwards attend the fresh block unquantized.
    cache_int8: bool = False


def denoised_timestep_bounds(sched: S.FlowMatchSchedule, rcfg: RolloutConfig,
                             exit_idx: int) -> Tuple[int, int]:
    """(denoised_timestep_from, denoised_timestep_to): the 1000-argmin
    encoding that clamps the DMD / critic timesteps under ``ts_schedule``."""
    ts = sched.timesteps.numpy()

    def enc(t):
        return 1000 - int(np.argmin(np.abs(ts - t)))

    t_from = enc(rcfg.denoise_timesteps[exit_idx])
    if exit_idx == len(rcfg.denoise_timesteps) - 1:
        return t_from, 0
    return t_from, enc(rcfg.denoise_timesteps[exit_idx + 1])


def _forward(params: dict, cfg: DiTConfig, cache_cfg: CacheConfig, tables: RopeTables,
             sched: S.FlowMatchSchedule, rcfg: RolloutConfig, cross_kv: D.CrossKV,
             x: torch.Tensor, t_val: float, cache: kvc.KVCache, start: int,
             commit: bool = False):
    """A training-form forward of one block at timestep ``t_val``: x0
    (float32) and the cache; the commit (``commit``) writes the block's K/V
    and returns zeros for x0."""
    b, fpb = x.shape[:2]
    t = torch.full((b, fpb), float(t_val), dtype=torch.float32, device=x.device)
    flow, cache_out = D.dit_forward_cached(
        params, cfg, cache_cfg, tables, x, t, cross_kv, cache, start, two_segment=True,
        remat_layers=rcfg.remat_layers, window_frames=rcfg.window_frames,
        commit_writes=commit, kv_only=commit)
    if commit:
        return flow, cache_out
    bf = b * fpb
    x0 = S.convert_flow_to_x0(
        sched, flow.reshape(bf, *flow.shape[2:]), x.reshape(bf, *x.shape[2:]).float(),
        torch.full((bf,), float(t_val), dtype=torch.float32, device=x.device))
    return x0.reshape(flow.shape), cache_out


def rollout_block(params: dict, cfg: DiTConfig, cache_cfg: CacheConfig, tables: RopeTables,
                  sched: S.FlowMatchSchedule, rcfg: RolloutConfig, cross_kv: D.CrossKV,
                  x: torch.Tensor, cache: kvc.KVCache, draws: torch.Tensor, abs_start: int,
                  exit_idx: int,
                  cotangent: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, kvc.KVCache]:
    """One block of the rollout: the pre-exit denoise steps, the exit-step
    forward, then the clean-context commit.  x: [B, fpb, C, H, W] noise;
    draws: [exit_idx + 1, B, fpb, C, H, W], the pre-exit re-noise draws
    followed by the commit's context-noise draw.

    With a ``cotangent`` [B, fpb, C, H, W] and gradients enabled, the exit
    forward is back-propagated against it before the commit.  Returns (x0 [B, fpb, C, H, W] float32, without graph; the
    cache with the block committed)."""
    b, fpb = x.shape[:2]
    bf = b * fpb
    steps = rcfg.denoise_timesteps
    with torch.no_grad():
        for i in range(exit_idx):
            x0, _ = _forward(params, cfg, cache_cfg, tables, sched, rcfg, cross_kv, x, steps[i],
                             cache, abs_start)
            t_next = torch.full((bf,), float(steps[i + 1]), dtype=torch.float32,
                                device=x.device)
            x = S.add_noise(sched, x0.reshape(bf, *x0.shape[2:]),
                            draws[i].reshape(bf, *x0.shape[2:]), t_next).reshape(x0.shape)
    backprop = cotangent is not None and torch.is_grad_enabled()
    with torch.set_grad_enabled(backprop):
        x0, _ = _forward(params, cfg, cache_cfg, tables, sched, rcfg, cross_kv, x,
                         steps[exit_idx], cache, abs_start)
        if backprop:
            torch.autograd.backward(x0, cotangent.to(x0.dtype))
    x0 = x0.detach()
    with torch.no_grad():
        t_ctx = torch.full((bf,), float(rcfg.context_noise), dtype=torch.float32,
                           device=x.device)
        ctx = S.add_noise(sched, x0.reshape(bf, *x0.shape[2:]),
                          draws[exit_idx].reshape(bf, *x0.shape[2:]), t_ctx).reshape(x0.shape)
        _, cache = _forward(params, cfg, cache_cfg, tables, sched, rcfg, cross_kv, ctx,
                            rcfg.context_noise, cache, abs_start, commit=True)
    return x0, cache


def rollout_trajectory(params: dict, cfg: DiTConfig, cache_cfg: CacheConfig,
                       tables: RopeTables, sched: S.FlowMatchSchedule, rcfg: RolloutConfig,
                       noise: torch.Tensor, cross_kv: D.CrossKV, draws: torch.Tensor,
                       exit_idx: int, cotangent: Optional[torch.Tensor] = None,
                       cache_dtype: Optional[torch.dtype] = None,
                       cache: Optional[kvc.KVCache] = None, current_start_frame: int = 0,
                       initial_latent: Optional[torch.Tensor] = None,
                       ) -> Tuple[torch.Tensor, kvc.KVCache]:
    """Rolls out ``F_total`` frames block by block with the KV cache.
    noise: [B, F_total, C, H, W]; draws: [F_total / fpb, exit_idx + 1, B,
    fpb, C, H, W] (see ``rollout_block``).  Returns (latents [B, F_total,
    C, H, W] float32, the final cache).

    ``cotangent`` [B, F_total, C, H, W]: the gradient form (module
    docstring); the parameters (and ``cross_kv``, where it is a leaf that
    requires grad) gather d(sum(latents * cotangent)) in ``.grad``.  A new
    cache is in ``cache_dtype`` (default: the parameters'), or int8 with
    ``rcfg.cache_int8``.

    ``cache`` and ``current_start_frame`` continue a sequence (streaming
    long tuning): the blocks start at absolute frame
    ``current_start_frame`` and are committed into ``cache``, in place.

    ``initial_latent`` [B, F0, C, H, W]: conditioning frames (an image's
    latents) committed at t = 0 before the first block, without gradient;
    the blocks then start F0 frames later."""
    b, f_total = noise.shape[:2]
    fpb = rcfg.frame_block
    if f_total % fpb:
        raise ValueError(f"{f_total} frames are no multiple of the {fpb}-frame block")
    if draws.shape[:2] != (f_total // fpb, exit_idx + 1):
        raise ValueError(f"draws must be [{f_total // fpb}, {exit_idx + 1}, ...], "
                         f"got {tuple(draws.shape)}")
    if cache is None:
        cache = kvc.init_cache(cache_cfg, cfg.num_layers, b, cfg.num_heads, cfg.head_dim,
                               cache_dtype or params["patch_embedding"]["weight"].dtype,
                               noise.device, k_int8=rcfg.cache_int8, v_int8=rcfg.cache_int8)
    if initial_latent is not None:
        with torch.no_grad():
            _, cache = _forward(params, cfg, cache_cfg, tables, sched, rcfg, cross_kv,
                                initial_latent.detach(), 0.0, cache, current_start_frame,
                                commit=True)
        current_start_frame += initial_latent.shape[1]
    outputs = []
    for bi, s in enumerate(range(0, f_total, fpb)):
        x0, cache = rollout_block(
            params, cfg, cache_cfg, tables, sched, rcfg, cross_kv, noise[:, s:s + fpb], cache,
            draws[bi], current_start_frame + s, exit_idx,
            None if cotangent is None else cotangent[:, s:s + fpb])
        outputs.append(x0)
    return torch.cat(outputs, dim=1), cache


def sample_exit_idx(generator: torch.Generator, num_steps: int, last_step_only: bool) -> int:
    """The rollout's exit step, uniform over the denoise steps."""
    if last_step_only:
        return num_steps - 1
    return int(torch.randint(0, num_steps, (), generator=generator))
