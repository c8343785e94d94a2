"""Score-distillation trainer (DMD / Self-Forcing init training).

- Two AdamW optimisers (generator and critic learning rates and betas from
  the config), each after a clip of the global gradient norm;
- the critic trains on every step, the generator in addition on every
  ``dfake_gen_update_ratio``-th optimiser step;
- an EMA of the generator kept on the host in float32.

Every generator update is staged, per block (the form the JAX package
calls ``staged_phases`` + ``block_vjp``; here it is the only form):

1. roll out without gradient and keep the latents;
2. dL/dlatents of the DMD loss, with the critic and teacher run without
   gradient;
3. replay the rollout block by block with the same draws: the steps before
   the exit without gradient, the exit forward with gradient and its
   backward against that block's dL/dlatents right away, then the commit
   without gradient.

Exact by the chain rule: the rollout cache is written in place between
blocks, so one graph over the whole rollout would read a cache that later
blocks overwrote, and every dependency between blocks carries no gradient
anyway.  The cross-attention K/V are a leaf during the replay; their
gradient, gathered over the blocks, is back-propagated through
``prepare_cross_kv`` once at the end.

Precision: float32 parameters, AdamW state, losses and scheduler
arithmetic.  On the GPU each model runs under ``torch.autocast`` (bf16
linears and attention operands with float32 accumulation, norms' statistics
in float32); on the CPU everything is float32.

LoRA (``lora_rank`` > 0, the JAX package's adapter mode): the generator's
bases are frozen and its adapters (``training.lora``, in ``lora_dtype``)
are what AdamW, the gradient clip and the EMA see; with
``lora_apply_to_critic`` the critic's likewise, otherwise the critic trains
in full.  The models run with their adapters attached (``_gen_full``,
``_critic_full``), so no merged copy of either exists.

Random draws: ``train_step`` takes a ``StepDraws`` (the tests replay the
JAX package's draws through it) or, by default, draws one from a
``torch.Generator`` seeded by (seed, step) on the CPU, so a step's draws do
not depend on the device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..config import CacheConfig, DiTConfig, LatentGeometry
from ..models import dit as D
from ..ops import scheduler as S
from ..ops.rope import make_rope_tables
from . import dmd as dmd_mod
from . import lora as lora_mod
from . import rollout as ro

_LEVERS = "ROADMAP queue 1, item 12 (single-chip training levers)"


@dataclasses.dataclass
class TrainerConfig:
    # optimisation (longlive_train_init.yaml)
    lr: float = 2.0e-6
    lr_critic: float = 4.0e-7
    beta1: float = 0.0
    beta2: float = 0.999
    beta1_critic: float = 0.0
    beta2_critic: float = 0.999
    weight_decay: float = 0.01
    grad_clip_norm: float = 10.0
    dfake_gen_update_ratio: int = 5
    ema_weight: float = 0.99
    ema_start_step: int = 200
    # the EMA shadow lives on the host in float32 (the only form here;
    # ema_on_host: false changes nothing)
    ema_on_host: bool = True
    # rollout / model
    denoising_step_list: Tuple[int, ...] = (1000, 750, 500, 250)
    warp_denoising_step: bool = True
    timestep_shift: float = 5.0
    guidance_scale: float = 3.0
    num_frame_per_block: int = 3
    num_training_frames: int = 21
    min_num_training_frames: int = 21
    slice_last_frames: int = 21
    context_noise: float = 0.0
    last_step_only: bool = False
    ts_schedule: bool = False
    ts_schedule_max: bool = False
    num_train_timestep: int = 1000
    # every attention of training takes the differentiable kernel route
    attn_impl: str = "train_auto"
    seed: int = 0
    lora_rank: int = 0
    lora_alpha: float = 256.0
    lora_apply_to_critic: bool = True
    lora_dtype: str = "bfloat16"
    # single-chip levers of the JAX package, not ported (raise)
    opt_on_host: bool = False
    opt_async: bool = False
    cache_int8: bool = False
    teacher_stream: bool = False
    page_generator: bool = False
    gradient_accumulation_steps: int = 1
    # the staged per-block generator step is the only form here; the two
    # keys are accepted and change nothing
    staged_phases: bool = False
    block_vjp: bool = False
    # synchronise the device around each phase and report ``phase_ms``
    phase_ledger: bool = False


@dataclasses.dataclass
class PhaseDraws:
    """The random numbers one update (generator or critic) consumes."""

    exit_idx: int
    num_blocks: int
    renoise: torch.Tensor  # [num_blocks, exit_idx + 1, B, fpb, C, H, W]
    score_t: torch.Tensor  # [B] integer timesteps
    score_noise: torch.Tensor  # [B, num_blocks * fpb, C, H, W]


@dataclasses.dataclass
class StepDraws:
    generator: Optional[PhaseDraws]  # None on steps that train the critic only
    critic: PhaseDraws


def param_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a parameter tree, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in tree for t in param_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in param_leaves(v)]
    return [] if tree is None else [tree]


def map_tree(fn, tree):
    """``fn`` applied to every tensor of a parameter tree, same structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    return None if tree is None else fn(tree)


class ScoreDistillationTrainer:
    def __init__(self, tcfg: TrainerConfig, dit_cfg: DiTConfig, geometry: LatentGeometry,
                 gen_params: dict, critic_params: dict, teacher_params: dict,
                 teacher_cfg: Optional[DiTConfig] = None, device=None):
        for name, why in (("opt_on_host", _LEVERS), ("opt_async", _LEVERS),
                          ("teacher_stream", _LEVERS), ("page_generator", _LEVERS),
                          ("cache_int8", _LEVERS)):
            if getattr(tcfg, name):
                raise NotImplementedError(f"{name} is not ported yet: {why}")
        if tcfg.gradient_accumulation_steps > 1:
            raise NotImplementedError(f"gradient accumulation is not ported yet: {_LEVERS}")
        if tcfg.attn_impl != "train_auto":
            raise ValueError(f"attn_impl {tcfg.attn_impl!r}: the port's training attention is "
                             "the train_auto route only")
        self.tcfg, self.cfg, self.geom = tcfg, dit_cfg, geometry
        self.teacher_cfg = teacher_cfg or dit_cfg
        self.device = torch.device(device) if device is not None else (
            gen_params["patch_embedding"]["weight"].device)
        self.sched = S.make_schedule(1000, shift=tcfg.timestep_shift, sigma_min=0.0,
                                     extra_one_step=True, training=True)
        steps = tcfg.denoising_step_list
        if tcfg.warp_denoising_step:
            steps = tuple(float(x) for x in S.warp_denoising_steps(self.sched, steps))
        window = None if dit_cfg.local_attn_size == -1 else dit_cfg.local_attn_size
        self.rcfg = ro.RolloutConfig(denoise_timesteps=tuple(float(x) for x in steps),
                                     context_noise=tcfg.context_noise,
                                     frame_block=tcfg.num_frame_per_block,
                                     last_step_only=tcfg.last_step_only, window_frames=window)
        self.dcfg = dmd_mod.DMDConfig(num_train_timestep=tcfg.num_train_timestep,
                                      timestep_shift=tcfg.timestep_shift,
                                      real_guidance_scale=tcfg.guidance_scale,
                                      ts_schedule=tcfg.ts_schedule,
                                      ts_schedule_max=tcfg.ts_schedule_max)
        # the training cache holds the whole training window:
        # kv_frames = min(local + slice, num_training_frames)
        if dit_cfg.local_attn_size == -1:
            kv_frames = tcfg.num_training_frames
        else:
            kv_frames = min(dit_cfg.local_attn_size + tcfg.slice_last_frames,
                            tcfg.num_training_frames)
        self.cache_cfg = CacheConfig(sink_frames=dit_cfg.sink_size,
                                     ring_frames=kv_frames - dit_cfg.sink_size,
                                     frame_seq=geometry.frame_seq_length)
        self.tables = make_rope_tables(dit_cfg.head_dim, dit_cfg.rope_max_pos,
                                       device=self.device)
        self.cache_dtype = (torch.bfloat16 if self.device.type == "cuda"
                            else gen_params["patch_embedding"]["weight"].dtype)

        self.teacher_params = teacher_params
        self.use_lora = tcfg.lora_rank > 0
        self.critic_lora_on = self.use_lora and tcfg.lora_apply_to_critic
        self.lora_scale = tcfg.lora_alpha / tcfg.lora_rank if self.use_lora else 1.0
        gen_lora = critic_lora = None
        if self.use_lora:
            # a stream apart from the steps' draws ((seed << 32) + step) and
            # the training loop's noise ((seed << 32) + 2^31 + step); the
            # generator's adapters first, then the critic's (JAX: the two
            # halves of PRNGKey(seed + 17))
            g = torch.Generator().manual_seed((tcfg.seed << 32) + (1 << 30) + 17)
            ldt = lora_mod.lora_dtype(tcfg.lora_dtype)
            gen_lora = lora_mod.init_lora(gen_params, tcfg.lora_rank, ldt, g)
            if self.critic_lora_on:
                critic_lora = lora_mod.init_lora(critic_params, tcfg.lora_rank, ldt, g)
        gen_trained = gen_lora if self.use_lora else gen_params
        critic_trained = critic_lora if self.critic_lora_on else critic_params
        for t in param_leaves(teacher_params) + param_leaves(gen_params) + param_leaves(
                critic_params):
            t.requires_grad_(False)
        self.gen_leaves = [t.requires_grad_(True) for t in param_leaves(gen_trained)]
        self.critic_leaves = [t.requires_grad_(True) for t in param_leaves(critic_trained)]
        # eps outside the square root and decoupled decay, as optax.adamw
        self.gen_opt = torch.optim.AdamW(self.gen_leaves, lr=tcfg.lr,
                                         betas=(tcfg.beta1, tcfg.beta2), eps=1e-8,
                                         weight_decay=tcfg.weight_decay)
        self.critic_opt = torch.optim.AdamW(self.critic_leaves, lr=tcfg.lr_critic,
                                            betas=(tcfg.beta1_critic, tcfg.beta2_critic),
                                            eps=1e-8, weight_decay=tcfg.weight_decay)
        self.state: Dict[str, Any] = {
            "gen_params": gen_params, "critic_params": critic_params,
            "gen_lora": gen_lora, "critic_lora": critic_lora,
            "gen_opt": self.gen_opt, "critic_opt": self.critic_opt,
            # the EMA follows the trained tree: the adapters under LoRA
            "ema_params": map_tree(self._host_copy, gen_trained), "step": 0}
        self.phase_ms: Dict[str, float] = {}

    # -- helpers -------------------------------------------------------------

    @staticmethod
    def _host_copy(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to("cpu", torch.float32, copy=True)

    def _autocast(self):
        return torch.autocast(self.device.type, dtype=torch.bfloat16,
                              enabled=self.device.type == "cuda", cache_enabled=False)

    @contextlib.contextmanager
    def _phase(self, name: str):
        """Times the enclosed phase (``phase_ledger``: synchronised, into
        ``phase_ms``); costs nothing when the ledger is off."""
        if not self.tcfg.phase_ledger:
            yield
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.phase_ms[name] = self.phase_ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3

    def _param_dtype(self) -> torch.dtype:
        return self.state["gen_params"]["patch_embedding"]["weight"].dtype

    def _gen_full(self) -> dict:
        """The generator as it runs: its adapters attached under LoRA."""
        if self.use_lora:
            return lora_mod.attach_lora(self.state["gen_params"], self.state["gen_lora"],
                                        self.lora_scale)
        return self.state["gen_params"]

    def _critic_full(self) -> dict:
        if self.critic_lora_on:
            return lora_mod.attach_lora(self.state["critic_params"], self.state["critic_lora"],
                                        self.lora_scale)
        return self.state["critic_params"]

    def _rollout(self, gen: dict, noise, cross, renoise: torch.Tensor, exit_idx: int,
                 cotangent=None, cache=None, start: int = 0):
        """(latents, final cache) of the generator's rollout; ``cache`` and
        ``start`` continue a sequence."""
        return ro.rollout_trajectory(
            gen, self.cfg, self.cache_cfg, self.tables, self.sched, self.rcfg, noise, cross,
            renoise.to(self.device), exit_idx, cotangent=cotangent,
            cache_dtype=self.cache_dtype, cache=cache, current_start_frame=start)

    def _apply_update(self, opt: torch.optim.Optimizer, leaves: List[torch.Tensor]) -> float:
        """clip_by_global_norm then AdamW; returns the pre-clip global norm.
        A parameter without gradient gets zeros, as in the JAX update (its
        moments decay and the weight decay still applies)."""
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = torch.nn.utils.clip_grad_norm_(leaves, self.tcfg.grad_clip_norm)
        opt.step()
        opt.zero_grad(set_to_none=True)
        return float(norm)

    # -- draws ---------------------------------------------------------------

    def _block_range(self, frames: int) -> Tuple[int, int]:
        """(min, max) rollout length in blocks for ``frames`` frames of noise."""
        fpb = self.rcfg.frame_block
        max_b = min(self.tcfg.num_training_frames // fpb, frames // fpb)
        return min(self.tcfg.min_num_training_frames // fpb, max_b), max_b

    def _sample_rollout_geometry(self, g: torch.Generator, frames: int) -> Tuple[int, int, bool]:
        """(exit step, rollout blocks, whether the DMD loss masks the first
        block): a random exit, and a random length when the config allows a
        range."""
        exit_idx = ro.sample_exit_idx(g, len(self.rcfg.denoise_timesteps),
                                      self.rcfg.last_step_only)
        min_b, max_b = self._block_range(frames)
        nb = min_b if min_b >= max_b else int(torch.randint(min_b, max_b + 1, (), generator=g))
        return exit_idx, nb, nb != min_b

    def _phase_draws(self, g: torch.Generator, noise_shape) -> PhaseDraws:
        exit_idx, nb, _ = self._sample_rollout_geometry(g, noise_shape[1])
        fpb = self.rcfg.frame_block
        b, rest = noise_shape[0], tuple(noise_shape[2:])
        t_from, t_to = ro.denoised_timestep_bounds(self.sched, self.rcfg, exit_idx)
        lo, hi = dmd_mod.score_timestep_range(self.dcfg, t_from, t_to)
        return PhaseDraws(
            exit_idx=exit_idx, num_blocks=nb,
            renoise=torch.randn((nb, exit_idx + 1, b, fpb) + rest, generator=g),
            score_t=torch.randint(lo, hi, (b,), generator=g),
            score_noise=torch.randn((b, nb * fpb) + rest, generator=g))

    def sample_draws(self, noise_shape, step: int) -> StepDraws:
        """The draws of step ``step``, from a CPU generator seeded by (seed,
        step)."""
        g = torch.Generator().manual_seed((self.tcfg.seed << 32) + step)
        train_gen = step % self.tcfg.dfake_gen_update_ratio == 0
        gen = self._phase_draws(g, noise_shape) if train_gen else None
        return StepDraws(generator=gen, critic=self._phase_draws(g, noise_shape))

    # -- the two updates -----------------------------------------------------

    def _dmd_cotangent(self, latents, prompt_c, prompt_u, score_t, score_noise, gmask):
        """(loss, aux, dL/dlatents) of the DMD loss, the critic and the
        teacher run without gradient."""
        real_x0 = dmd_mod.teacher_real_x0(
            self.teacher_params, self.teacher_cfg, self.tables, self.sched, self.dcfg,
            latents, prompt_c, prompt_u, score_t, score_noise)
        lat = latents.detach().requires_grad_()
        loss, aux = dmd_mod.distribution_matching_loss(
            lat, self._critic_full(), None, self.cfg, self.tables, self.sched, self.dcfg,
            prompt_c, prompt_u, score_t, score_noise, gradient_mask=gmask,
            teacher_cfg=self.teacher_cfg, real_x0=real_x0)
        (dlat,) = torch.autograd.grad(loss, lat)
        return loss, aux, dlat

    def _replay_backward(self, gen: dict, noise, prompt_c, renoise, exit_idx, dlat,
                         cache=None, start: int = 0) -> None:
        """The rollout replayed block by block against ``dlat``, the cross
        K/V a leaf whose gradient goes through ``prepare_cross_kv`` once at
        the end; the gradients gather in the trained leaves' ``.grad``."""
        cross = D.prepare_cross_kv(gen, self.cfg, prompt_c, self._param_dtype())
        leaf = D.CrossKV(k=cross.k.detach().requires_grad_(),
                         v=cross.v.detach().requires_grad_())
        self._rollout(gen, noise, leaf, renoise, exit_idx, cotangent=dlat, cache=cache,
                      start=start)
        if leaf.k.grad is not None:
            torch.autograd.backward([cross.k, cross.v], [leaf.k.grad, leaf.v.grad])

    def _gen_step(self, noise, prompt_c, prompt_u, d: PhaseDraws):
        gen, dtype = self._gen_full(), self._param_dtype()
        fpb = self.rcfg.frame_block
        use_mask = d.num_blocks != self._block_range(noise.shape[1])[0]
        noise = noise[:, :d.num_blocks * fpb]
        with self._phase("gen_rollout"), torch.no_grad(), self._autocast():
            cross = D.prepare_cross_kv(gen, self.cfg, prompt_c, dtype)
            latents = self._rollout(gen, noise, cross, d.renoise, d.exit_idx)[0]
        gmask = None
        if use_mask:  # the DMD loss skips the first block of a shortened rollout
            gmask = (torch.arange(latents.shape[1], device=self.device)[None] >= fpb
                     ).expand(latents.shape[:2])
        with self._phase("dmd_loss_grad"), self._autocast():
            loss, aux, dlat = self._dmd_cotangent(latents, prompt_c, prompt_u, d.score_t,
                                                  d.score_noise, gmask)
        del latents
        with self._phase("gen_block_backward"), self._autocast():
            self._replay_backward(gen, noise, prompt_c, d.renoise, d.exit_idx, dlat)
        with self._phase("gen_optimizer"):
            gnorm = self._apply_update(self.gen_opt, self.gen_leaves)
        return loss, dict(aux, generator_grad_norm=gnorm)

    def _critic_loss_backward(self, latents, prompt_c, score_t, score_noise):
        loss, aux = dmd_mod.critic_denoising_loss(
            self._critic_full(), latents, self.cfg, self.tables, self.sched, self.dcfg,
            prompt_c, score_t, score_noise)
        loss.backward()
        return loss, aux

    def _critic_step(self, noise, prompt_c, d: PhaseDraws):
        gen, dtype = self._gen_full(), self._param_dtype()
        noise = noise[:, :d.num_blocks * self.rcfg.frame_block]
        with self._phase("critic_rollout"), torch.no_grad(), self._autocast():
            cross = D.prepare_cross_kv(gen, self.cfg, prompt_c, dtype)
            latents = self._rollout(gen, noise, cross, d.renoise, d.exit_idx)[0]
        with self._phase("critic_loss_grad"), self._autocast():
            loss, aux = self._critic_loss_backward(latents, prompt_c, d.score_t, d.score_noise)
        with self._phase("critic_optimizer"):
            gnorm = self._apply_update(self.critic_opt, self.critic_leaves)
        return loss, dict(aux, critic_grad_norm=gnorm)

    # -- public API ----------------------------------------------------------

    def train_step(self, noise: torch.Tensor, prompt_c: torch.Tensor, prompt_u: torch.Tensor,
                   draws: Optional[StepDraws] = None) -> Dict[str, Any]:
        """One step with the reference cadence: the critic trains on every
        step; the generator in addition on every ``dfake_gen_update_ratio``-th
        optimiser step (before the critic, on its own rollout).  noise:
        [B, F, C, H, W]; prompt embeddings [B, text_len, text_dim]."""
        step = int(self.state["step"])
        train_generator = step % self.tcfg.dfake_gen_update_ratio == 0
        if draws is None:
            draws = self.sample_draws(noise.shape, step)
        if train_generator != (draws.generator is not None):
            raise ValueError(f"step {step} {'trains' if train_generator else 'skips'} the "
                             "generator; the draws say otherwise")
        noise, prompt_c, prompt_u = (x.to(self.device, torch.float32)
                                     for x in (noise, prompt_c, prompt_u))
        self.phase_ms = {}
        metrics: Dict[str, Any] = {"step": step, "opt_step": step}
        fpb = self.rcfg.frame_block
        if train_generator:
            d = draws.generator
            loss, aux = self._gen_step(noise, prompt_c, prompt_u, d)
            metrics.update({"generator_loss": loss.item(), "exit_idx": d.exit_idx,
                            "rollout_frames": d.num_blocks * fpb,
                            **{k: float(v) for k, v in aux.items()}})
            self._update_ema(step)
        d = draws.critic
        loss, aux = self._critic_step(noise, prompt_c, d)
        metrics.update({"critic_loss": loss.item(), "critic_exit_idx": d.exit_idx,
                        **{k: float(v) for k, v in aux.items()}})
        if self.tcfg.phase_ledger:
            metrics["phase_ms"] = dict(self.phase_ms)
        self.state["step"] = step + 1
        return metrics

    def _update_ema(self, step: int):
        gen = self.state["gen_lora" if self.use_lora else "gen_params"]
        if step < self.tcfg.ema_start_step:
            self.state["ema_params"] = map_tree(self._host_copy, gen)
            return
        w = self.tcfg.ema_weight
        for e, p in zip(param_leaves(self.state["ema_params"]), param_leaves(gen)):
            e.mul_(w).add_(self._host_copy(p), alpha=1 - w)

    def finish_pending(self) -> Dict[str, float]:
        """Nothing runs in the background here (no ``opt_async``); kept for
        the training loop's protocol.  Returns no late metrics."""
        return {}

    _TREES = ("gen_params", "critic_params", "gen_lora", "critic_lora")

    def state_dict(self) -> Dict[str, Any]:
        """What a checkpoint holds: parameters and adapters (None where
        LoRA is off), optimiser states (over the trained trees), EMA, step."""
        detach = lambda t: t.detach()  # noqa: E731
        return {**{key: map_tree(detach, self.state[key]) for key in self._TREES},
                "gen_opt": self.gen_opt.state_dict(),
                "critic_opt": self.critic_opt.state_dict(),
                "ema_params": self.state["ema_params"], "step": int(self.state["step"])}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Restores a ``state_dict`` in place (the optimisers keep their
        parameter references)."""
        with torch.no_grad():
            for key in self._TREES:
                leaves, src = param_leaves(self.state[key]), param_leaves(sd.get(key))
                if len(src) != len(leaves):
                    raise ValueError(f"{key}: {len(src)} tensors in the checkpoint, "
                                     f"{len(leaves)} in the model")
                for dst, s in zip(leaves, src):
                    dst.copy_(s)
        self.gen_opt.load_state_dict(sd["gen_opt"])
        self.critic_opt.load_state_dict(sd["critic_opt"])
        self.state["ema_params"] = sd["ema_params"]
        self.state["step"] = int(sd["step"])
