"""Distribution Matching Distillation losses.

- generator loss = 0.5 * MSE(x, stopgrad(x - kl_grad)) with
  kl_grad = (fake_x0 - real_x0_cfg) / normalizer, at a random
  shift-warped timestep clamped to [0.02, 0.98] * 1000 and optionally to
  the rollout's exit-step range (``ts_schedule``);
- critic loss = the flow-matching denoising loss of the critic's
  prediction on generator samples at a random timestep;
- CFG on the real score with ``real_guidance_scale``; fake guidance 0.

Teacher (``real_score``) and critic (``fake_score``) are bidirectional Wan
models with one timestep per sample.  Random draws come in explicitly:
``score_t`` [B] integer timesteps drawn uniformly from
``score_timestep_range`` and ``score_noise`` shaped like the latents.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..config import DiTConfig
from ..models import dit as D
from ..models.dit_bidirectional import bidirectional_forward
from ..ops import scheduler as S
from ..ops.rope import RopeTables


@dataclasses.dataclass(frozen=True)
class DMDConfig:
    num_train_timestep: int = 1000
    timestep_shift: float = 5.0
    real_guidance_scale: float = 3.0
    fake_guidance_scale: float = 0.0
    ts_schedule: bool = False
    ts_schedule_max: bool = False
    min_score_timestep: int = 0

    @property
    def min_step(self) -> int:
        return int(0.02 * self.num_train_timestep)

    @property
    def max_step(self) -> int:
        return int(0.98 * self.num_train_timestep)


def score_timestep_range(dcfg: DMDConfig, denoised_from: Optional[int],
                         denoised_to: Optional[int]) -> Tuple[int, int]:
    """[min_t, max_t) of the uniform integer timestep draw."""
    min_t = (denoised_to if (dcfg.ts_schedule and denoised_to is not None)
             else dcfg.min_score_timestep)
    max_t = (denoised_from if (dcfg.ts_schedule_max and denoised_from is not None)
             else dcfg.num_train_timestep)
    return min_t, max_t


def _sample_score_timestep(score_t: torch.Tensor, dcfg: DMDConfig, batch: int,
                           num_frames: int) -> torch.Tensor:
    """The drawn integer timesteps [B] -> [B, F] float32, shift-warped and
    clamped."""
    t = score_t.to(torch.float32).reshape(batch, 1).expand(batch, num_frames)
    if dcfg.timestep_shift > 1:
        s = dcfg.timestep_shift
        t = s * (t / 1000.0) / (1 + (s - 1) * (t / 1000.0)) * 1000.0
    return t.clamp(dcfg.min_step, dcfg.max_step)


def _score_noisy(score_t: torch.Tensor, score_noise: torch.Tensor, dcfg: DMDConfig,
                 sched: S.FlowMatchSchedule, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (noisy, t) pair both score models see."""
    b, f = x.shape[:2]
    t = _sample_score_timestep(score_t.to(x.device), dcfg, b, f)
    noisy = S.add_noise(sched, x.reshape(b * f, *x.shape[2:]),
                        score_noise.to(x.device, torch.float32).reshape(b * f, *x.shape[2:]),
                        t.reshape(-1)).reshape(x.shape)
    return noisy, t


def _x0_pred_bidirectional(params: dict, cfg: DiTConfig, tables: RopeTables,
                           sched: S.FlowMatchSchedule, noisy: torch.Tensor, t: torch.Tensor,
                           cross_kv: D.CrossKV, remat_layers: bool = False) -> torch.Tensor:
    """Flow prediction -> x0 (one timestep per sample: t[:, 0])."""
    flow = bidirectional_forward(params, cfg, tables, noisy, t[:, 0], cross_kv,
                                 attn_impl="train_auto", remat_layers=remat_layers)
    b, f = noisy.shape[:2]
    return S.convert_flow_to_x0(
        sched, flow.reshape(b * f, *flow.shape[2:]),
        noisy.reshape(b * f, *noisy.shape[2:]).float(), t.reshape(-1)).reshape(flow.shape)


def _param_dtype(params: dict) -> torch.dtype:
    return params["patch_embedding"]["weight"].dtype


def teacher_real_x0(teacher_params: dict, teacher_cfg: DiTConfig, tables: RopeTables,
                    sched: S.FlowMatchSchedule, dcfg: DMDConfig, gen_latents: torch.Tensor,
                    prompt_cond: torch.Tensor, prompt_uncond: torch.Tensor,
                    score_t: torch.Tensor, score_noise: torch.Tensor) -> torch.Tensor:
    """The teacher's CFG-combined x0 prediction as a pass of its own, with
    no gradient: the same (noisy, t) the loss samples, cond and uncond
    batched in one forward.  Returns real_c + (real_c - real_u) * scale in
    float32."""
    with torch.no_grad():
        x = gen_latents.detach()
        b, f = x.shape[:2]
        noisy, t = _score_noisy(score_t, score_noise, dcfg, sched, x)
        noisy2, t2 = torch.cat([noisy, noisy]), torch.cat([t, t])
        prompts2 = torch.cat([prompt_cond, prompt_uncond])
        ckv = D.prepare_cross_kv(teacher_params, teacher_cfg, prompts2,
                                 _param_dtype(teacher_params))
        x02 = _x0_pred_bidirectional(teacher_params, teacher_cfg, tables, sched, noisy2, t2,
                                     ckv)
        real_c, real_u = x02[:b], x02[b:]
        return (real_c + (real_c - real_u) * dcfg.real_guidance_scale).float()


def distribution_matching_loss(
    gen_latents: torch.Tensor, critic_params: dict, teacher_params: Optional[dict],
    cfg: DiTConfig, tables: RopeTables, sched: S.FlowMatchSchedule, dcfg: DMDConfig,
    prompt_cond: torch.Tensor, prompt_uncond: torch.Tensor, score_t: torch.Tensor,
    score_noise: torch.Tensor, gradient_mask: Optional[torch.Tensor] = None,
    teacher_cfg: Optional[DiTConfig] = None, real_x0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, dict]:
    """DMD generator loss; gradient flows into ``gen_latents`` only (the
    critic and teacher run without gradient).  ``real_x0``: the teacher's
    prediction from ``teacher_real_x0`` (then ``teacher_params`` is unused).
    ``gradient_mask`` [B, F] bool: masked mean over the selected frames."""
    teacher_cfg = teacher_cfg or cfg
    with torch.no_grad():
        x = gen_latents.detach()
        dtype = _param_dtype(critic_params)
        noisy, t = _score_noisy(score_t, score_noise, dcfg, sched, x)
        crit_c = D.prepare_cross_kv(critic_params, cfg, prompt_cond, dtype)
        fake_x0 = _x0_pred_bidirectional(critic_params, cfg, tables, sched, noisy, t, crit_c)
        if dcfg.fake_guidance_scale != 0.0:
            crit_u = D.prepare_cross_kv(critic_params, cfg, prompt_uncond, dtype)
            fake_u = _x0_pred_bidirectional(critic_params, cfg, tables, sched, noisy, t, crit_u)
            fake_x0 = fake_x0 + (fake_x0 - fake_u) * dcfg.fake_guidance_scale
        if real_x0 is None:
            tdt = _param_dtype(teacher_params)
            real_c = _x0_pred_bidirectional(
                teacher_params, teacher_cfg, tables, sched, noisy, t,
                D.prepare_cross_kv(teacher_params, teacher_cfg, prompt_cond, tdt))
            real_u = _x0_pred_bidirectional(
                teacher_params, teacher_cfg, tables, sched, noisy, t,
                D.prepare_cross_kv(teacher_params, teacher_cfg, prompt_uncond, tdt))
            real = real_c + (real_c - real_u) * dcfg.real_guidance_scale
        else:
            real = real_x0
        grad = fake_x0.float() - real.float()
        normalizer = (x.float() - real.float()).abs().mean(dim=(1, 2, 3, 4), keepdim=True)
        grad = torch.nan_to_num(grad / normalizer)

    xf = gen_latents.float()
    err = (xf - (xf - grad).detach()).square()
    if gradient_mask is not None:
        m = gradient_mask[:, :, None, None, None].float()
        per_frame = err.shape[2] * err.shape[3] * err.shape[4]
        loss = 0.5 * (err * m).sum() / torch.clamp(m.sum() * per_frame, min=1.0)
    else:
        loss = 0.5 * err.mean()
    aux = {"dmdtrain_gradient_norm": grad.abs().mean(), "dmd_timestep_mean": t.mean()}
    return loss, aux


def denoising_loss(loss_type: str, sched: S.FlowMatchSchedule, x: torch.Tensor,
                   x_pred: torch.Tensor, noise: torch.Tensor, xt: torch.Tensor,
                   timestep: torch.Tensor, flow_pred: Optional[torch.Tensor] = None,
                   gradient_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The denoising-loss family: x0 / v / noise / flow MSE (the shipped
    configs use 'flow').  'v' weights the x0 error by 1 / (1 - alpha_bar)
    with alpha_bar = a^2 / (a^2 + s^2) of the flow path x_t = a x0 + s eps."""
    if loss_type == "x0":
        err = (x - x_pred).square()
    elif loss_type == "v":
        sig = sched.sigmas.to(x.device)[S.timestep_id(sched, timestep.to(x.device))].float()
        while sig.ndim < x.ndim:
            sig = sig[..., None]
        a2 = (1.0 - sig).square()
        s2 = sig.clamp(min=1e-4).square()
        err = (a2 + s2) / s2 * (x - x_pred).square()
    elif loss_type == "noise":
        noise_pred = S.convert_x0_to_noise(sched, x_pred, xt, timestep)
        err = (noise - noise_pred).square()
    elif loss_type == "flow":
        if flow_pred is None:
            raise ValueError("the flow loss needs flow_pred")
        err = (flow_pred - (noise - x)).square()
    else:
        raise ValueError(f"unsupported denoising_loss_type {loss_type!r}")
    if gradient_mask is not None:
        m = gradient_mask.to(err.dtype)
        while m.ndim < err.ndim:
            m = m[..., None]
        return (err * m).sum() / torch.clamp(m.expand(err.shape).sum(), min=1.0)
    return err.mean()


def critic_denoising_loss(critic_params: dict, gen_latents: torch.Tensor, cfg: DiTConfig,
                          tables: RopeTables, sched: S.FlowMatchSchedule, dcfg: DMDConfig,
                          prompt_cond: torch.Tensor, score_t: torch.Tensor,
                          score_noise: torch.Tensor, loss_type: str = "flow",
                          ) -> Tuple[torch.Tensor, dict]:
    """The critic's denoising loss on generator samples (``gen_latents``
    without graph); differentiable in the critic's parameters, its layers
    checkpointed."""
    b, f = gen_latents.shape[:2]
    cross = D.prepare_cross_kv(critic_params, cfg, prompt_cond, _param_dtype(critic_params))
    x = gen_latents.detach().float()
    noise = score_noise.to(x.device, torch.float32)
    noisy, t = _score_noisy(score_t, noise, dcfg, sched, x)
    pred_x0 = _x0_pred_bidirectional(critic_params, cfg, tables, sched, noisy, t, cross,
                                     remat_layers=True)
    flow_pred = None
    if loss_type == "flow":
        flow_pred = S.convert_x0_to_flow(
            sched, pred_x0.reshape(b * f, *x.shape[2:]), noisy.reshape(b * f, *x.shape[2:]),
            t.reshape(-1)).reshape(x.shape).float()
    loss = denoising_loss(loss_type, sched, x, pred_x0.float(), noise, noisy.float(),
                          t[..., None, None, None], flow_pred)
    return loss, {"critic_timestep_mean": t.mean()}
