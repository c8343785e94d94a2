"""Rectified-flow (flow-matching) noise schedule.

- sigmas: linspace(sigma_start, sigma_min, N[+1])[:N], optionally inverted /
  reversed, then shift-warped  sigma' = s*sigma / (1 + (s-1)*sigma);
- timesteps = sigmas * num_train_timesteps;
- add_noise: x_t = (1-sigma)*x0 + sigma*noise, sigma at the nearest timestep;
- flow -> x0: x0 = x_t - sigma_t * flow;
- the Euler step: x_next = x_t + flow * (sigma_next - sigma_t).

Tables are built in float64 with numpy and kept as float32 tensors; the
conversions compute in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FlowMatchSchedule:
    """sigmas, timesteps, weights: [N] float32 (CPU); moved to the data's
    device where they are used."""

    sigmas: torch.Tensor
    timesteps: torch.Tensor
    weights: torch.Tensor
    num_train_timesteps: int


def make_schedule(
    num_inference_steps: int = 100,
    num_train_timesteps: int = 1000,
    shift: float = 3.0,
    sigma_max: float = 1.0,
    sigma_min: float = 0.003 / 1.002,
    inverse_timesteps: bool = False,
    extra_one_step: bool = False,
    reverse_sigmas: bool = False,
    denoising_strength: float = 1.0,
    training: bool = False,
) -> FlowMatchSchedule:
    """The generator schedule of the shipped configs is
    ``make_schedule(1000, shift=timestep_shift, sigma_min=0.0,
    extra_one_step=True, training=True)``."""
    sigma_start = sigma_min + (sigma_max - sigma_min) * denoising_strength
    if extra_one_step:
        sigmas = np.linspace(sigma_start, sigma_min, num_inference_steps + 1)[:-1]
    else:
        sigmas = np.linspace(sigma_start, sigma_min, num_inference_steps)
    if inverse_timesteps:
        sigmas = sigmas[::-1].copy()
    sigmas = shift * sigmas / (1.0 + (shift - 1.0) * sigmas)
    if reverse_sigmas:
        sigmas = 1.0 - sigmas
    timesteps = sigmas * num_train_timesteps

    if training:
        x = timesteps
        y = np.exp(-2.0 * ((x - num_inference_steps / 2) / num_inference_steps) ** 2)
        y_shifted = y - y.min()
        weights = y_shifted * (num_inference_steps / y_shifted.sum())
    else:
        weights = np.zeros_like(timesteps)

    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return FlowMatchSchedule(f32(sigmas), f32(timesteps), f32(weights),
                             num_train_timesteps)


def warp_denoising_steps(
    sched: FlowMatchSchedule, denoising_step_list: Sequence[int]
) -> np.ndarray:
    """Maps nominal timesteps (e.g. [1000, 750, 500, 250]) onto the shifted
    schedule: ``t_i = [timesteps..., 0][1000 - s_i]``."""
    t = np.concatenate([sched.timesteps.numpy(), np.zeros([1], np.float32)])
    idx = sched.num_train_timesteps - np.asarray(denoising_step_list, np.int64)
    return t[idx]


def timestep_id(sched: FlowMatchSchedule, timestep: torch.Tensor) -> torch.Tensor:
    """Nearest-timestep index: ``argmin(|timesteps - t|)``."""
    t = torch.as_tensor(timestep, dtype=torch.float32)
    table = sched.timesteps.to(t.device)
    return torch.argmin(torch.abs(table - t[..., None]), dim=-1)


def _sigma_for(sched: FlowMatchSchedule, timestep, ndim: int) -> torch.Tensor:
    t = torch.as_tensor(timestep, dtype=torch.float32)
    sig = sched.sigmas.to(t.device)[timestep_id(sched, t)]
    return sig.reshape(sig.shape + (1,) * (ndim - sig.ndim))


def add_noise(sched: FlowMatchSchedule, original_samples: torch.Tensor,
              noise: torch.Tensor, timestep: torch.Tensor) -> torch.Tensor:
    """x_t = (1-sigma)*x0 + sigma*noise; ``timestep`` has the samples'
    leading shape (commonly [B*T] against [B*T, C, H, W])."""
    sigma = _sigma_for(sched, timestep, original_samples.ndim)
    sample = (1.0 - sigma) * original_samples.float() + sigma * noise.float()
    return sample.to(noise.dtype)


def convert_flow_to_x0(sched: FlowMatchSchedule, flow_pred: torch.Tensor,
                       xt: torch.Tensor, timestep: torch.Tensor) -> torch.Tensor:
    """x0 = x_t - sigma_t * flow."""
    sigma = _sigma_for(sched, timestep, xt.ndim)
    x0 = xt.float() - sigma * flow_pred.float()
    return x0.to(flow_pred.dtype)


def step(sched: FlowMatchSchedule, model_output: torch.Tensor, timestep,
         sample: torch.Tensor, to_final: bool = False) -> torch.Tensor:
    """Euler flow step: sample + flow * (sigma_next - sigma), sigma at the
    nearest timestep and sigma_next the next entry of the table (0 past its
    end, or with ``to_final``).  The sigmas are float32 tensors of the
    samples' rank, so the step computes in float32 at least."""
    tid = timestep_id(sched, timestep)
    sigmas = sched.sigmas.to(tid.device)
    n = sigmas.shape[0]
    sigma = sigmas[tid]
    if to_final:
        sigma_next = torch.zeros_like(sigma)
    else:
        sigma_next = torch.where(tid + 1 >= n, torch.zeros_like(sigma),
                                 sigmas[torch.clamp(tid + 1, max=n - 1)])
    expand = (1,) * (model_output.ndim - sigma.ndim)
    sigma = sigma.reshape(sigma.shape + expand)
    sigma_next = sigma_next.reshape(sigma_next.shape + expand)
    return sample + model_output * (sigma_next - sigma)


def training_weight(sched: FlowMatchSchedule, timestep: torch.Tensor) -> torch.Tensor:
    """Per-sample loss weights at the nearest timestep."""
    t = torch.as_tensor(timestep, dtype=torch.float32)
    return sched.weights.to(t.device)[timestep_id(sched, t)]


def training_target(sample: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Flow-matching target = noise - sample."""
    return noise - sample


def convert_x0_to_flow(sched: FlowMatchSchedule, x0_pred: torch.Tensor,
                       xt: torch.Tensor, timestep: torch.Tensor) -> torch.Tensor:
    """flow = (x_t - x0) / sigma_t."""
    sigma = _sigma_for(sched, timestep, xt.ndim)
    flow = (xt.float() - x0_pred.float()) / sigma
    return flow.to(x0_pred.dtype)


def convert_x0_to_noise(sched: FlowMatchSchedule, x0: torch.Tensor, xt: torch.Tensor,
                        timestep: torch.Tensor) -> torch.Tensor:
    """noise = (x_t - (1 - sigma) * x0) / sigma under the rectified-flow
    corruption."""
    sigma = _sigma_for(sched, timestep, xt.ndim)
    noise = (xt.float() - (1.0 - sigma) * x0.float()) / sigma
    return noise.to(x0.dtype)
