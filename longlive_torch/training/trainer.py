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

The single-card memory levers (all exact: the same results, other
residency):

- ``staged_phases``: the teacher, and under the critic's LoRA its frozen
  base, live in pinned host memory and come to the card for the phase that
  reads them;
- ``teacher_stream`` (needs ``staged_phases``): the teacher's blocks stay
  on the host and stream one layer at a time through its x0 pass
  (``teacher_x0_streamed``): a teacher larger than the card (14B);
- ``page_generator`` (needs ``staged_phases``): the generator's trees go to
  pinned host memory while the teacher and critic run (each leaf's
  ``.data`` swapped, so the optimiser's references hold);
- ``cache_int8``: the rollout's K/V cache int8 (``RolloutConfig``);
- ``opt_on_host``: AdamW on the host (``host_adamw_step``: pinned float32
  master, m and v; the card holds the trained parameters only);
  ``opt_async`` runs the critic's host update on a worker thread, landed
  before the critic's next read, so its grad norm is reported one step
  late;
- ``gradient_accumulation_steps`` = k: ``optax.MultiSteps``' semantics, the
  running mean of k micro-steps' gradients, one clip and AdamW update on
  the k-th; the generator trains on optimiser steps ``micro // k`` that are
  multiples of ``dfake_gen_update_ratio``.

Random draws: ``train_step`` takes a ``StepDraws`` (the tests replay the
JAX package's draws through it) or, by default, draws one from a
``torch.Generator`` seeded by (seed, step) on the CPU, so a step's draws do
not depend on the device.

Several ranks (``mesh``, a ``parallel.mesh.make_mesh`` mesh of ``dp`` x
``fsdp``): the JAX package lets XLA insert the gathers; here they are
written out.

- At rest each rank holds its ``fsdp`` shard of the generator, the critic
  and the teacher (``parallel.mesh``'s rules; a streamed teacher stays
  whole in host memory), and AdamW's state and the EMA of its trained
  shards; LoRA adapters match no rule and are replicated;
- each phase gathers the whole tree it runs (``_gen_full``,
  ``_critic_full``, the teacher) and drops it after; the trained leaves of
  the gathered tree are leaves of their own, and before an update their
  gradients are reduce-scattered over ``fsdp`` and summed over ``dp``
  (a replicated leaf's summed over every rank), divided by the world;
- the batch is split over ``dp``: the ranks of one ``fsdp`` group hold the
  same rows.  The trainer's own draws are the same on every rank: each
  rank draws the global batch's numbers and takes its rows;
- the gradient norm is the global one, the clip applies it to the shards,
  and the reported losses are the global means, the same on every rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..config import CacheConfig, DiTConfig, LatentGeometry
from ..models import dit as D
from ..ops import scheduler as S
from ..ops.quant import _div
from ..ops.rope import make_rope_tables
from ..parallel import mesh as pm
from ..utils import memory as mem
from ..utils.memory import map_tree, param_leaves
from ..utils.profiling import PhaseTimer
from . import dmd as dmd_mod
from . import lora as lora_mod
from . import rollout as ro


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
    # the single-card levers (module docstring)
    opt_on_host: bool = False
    opt_async: bool = False  # needs opt_on_host
    cache_int8: bool = False
    teacher_stream: bool = False  # needs staged_phases
    page_generator: bool = False  # needs staged_phases
    gradient_accumulation_steps: int = 1  # not with opt_on_host
    staged_phases: bool = False
    # the per-block generator replay is the only form here: accepted, and
    # like the JAX package's it needs staged_phases
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


# -- host AdamW (opt_on_host) -------------------------------------------------


def host_adamw_init(trained: List[torch.Tensor]) -> Dict[str, Any]:
    """The host AdamW state of the trained tensors: pinned float32 master
    copies and zero moments m and v (lists in the tensors' order), and the
    update count ``t``."""
    arena = mem.HostArena()

    def zeros(p):
        return arena.empty(p.shape, torch.float32).zero_()

    return {"m": [zeros(p) for p in trained], "v": [zeros(p) for p in trained],
            "master": [arena.empty(p.shape, torch.float32).copy_(p.detach()) for p in trained],
            "t": 0}


def host_adamw_step(st: Dict[str, Any], grads: List[torch.Tensor], *, lr: float, b1: float,
                    b2: float, eps: float = 1e-8, weight_decay: float = 0.0,
                    clip: float = 0.0, norm: Optional[float] = None) -> float:
    """One AdamW update of the host state ``st`` in place from host
    gradients, after a clip of their global norm to ``clip`` (0: none);
    returns the norm (before the clip).  ``norm``: the norm to clip by,
    given (the shards' global norm over the ranks), else computed here.
    The JAX package's numpy update, op for op, in in-place float32 torch
    ops on the host (which spread over its cores): the norm in float64,
    eps outside the square root, the decay decoupled, the bias corrections
    in Python floats."""
    g32 = [g.float() for g in grads]
    gn = norm if norm is not None else float(
        sum(float(g.double().square().sum()) for g in g32) ** 0.5)
    scale = 1.0 if (clip <= 0.0 or gn <= clip) else clip / gn
    st["t"] += 1
    t = st["t"]
    bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    for g, m, v, p in zip(g32, st["m"], st["v"], st["master"]):
        if scale != 1.0:
            g = g * scale
        m.mul_(b1).add_(g * (1.0 - b1))
        v.mul_(b2).add_(g.square().mul_(1.0 - b2))
        upd = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
        if weight_decay:
            upd.add_(p * weight_decay)
        p.sub_(upd.mul_(lr))
    return gn


def _grads_to_host(leaves: List[torch.Tensor]):
    """(pinned host copies of the leaves' gradients, an event after the
    copies or None off the card).  The copies are enqueued without a host
    wait."""
    arena = mem.HostArena()
    host = [arena.empty(p.grad.shape, p.grad.dtype).copy_(p.grad, non_blocking=True)
            for p in leaves]
    if leaves[0].device.type != "cuda":
        return host, None
    ready = torch.cuda.Event()
    ready.record()
    return host, ready


def _host_update(st: Dict[str, Any], leaves: List[torch.Tensor], host_grads, ready,
                 kwargs: dict, stream=None) -> float:
    """``host_adamw_step`` once the gradients are on the host, then the new
    master copied into the leaves (on ``stream``, waited for, when given)."""
    if ready is not None:
        ready.synchronize()
    gn = host_adamw_step(st, host_grads, **kwargs)
    with torch.no_grad(), (torch.cuda.stream(stream) if stream is not None
                           else contextlib.nullcontext()):
        for p, m in zip(leaves, st["master"]):
            p.copy_(m, non_blocking=stream is not None)
    if stream is not None:
        stream.synchronize()
    return gn


class _AsyncHostUpdate:
    """One host AdamW update on a worker thread (``opt_async``): the
    gradients' copies to the host are enqueued on the caller's thread; the
    worker waits for them, runs ``host_adamw_step`` and copies the new
    parameters to the card on a stream of its own, waited for before it
    ends.  ``join`` returns the grad norm and re-raises the worker's error.
    Nothing reads the parameters until the join."""

    def __init__(self, st: Dict[str, Any], leaves: List[torch.Tensor], kwargs: dict):
        host, ready = _grads_to_host(leaves)
        stream = torch.cuda.Stream(leaves[0].device) if ready is not None else None
        self._box: Dict[str, Any] = {}

        def run():
            try:
                self._box["norm"] = _host_update(st, leaves, host, ready, kwargs, stream)
            except BaseException as e:  # noqa: BLE001 — re-raised by join
                self._box["err"] = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def join(self) -> float:
        self._thread.join()
        if "err" in self._box:
            raise self._box["err"]
        return self._box["norm"]


class ScoreDistillationTrainer:
    def __init__(self, tcfg: TrainerConfig, dit_cfg: DiTConfig, geometry: LatentGeometry,
                 gen_params: dict, critic_params: dict, teacher_params: dict,
                 teacher_cfg: Optional[DiTConfig] = None, device=None, mesh=None):
        if tcfg.attn_impl != "train_auto":
            raise ValueError(f"attn_impl {tcfg.attn_impl!r}: the port's training attention is "
                             "the train_auto route only")
        if tcfg.opt_on_host and tcfg.gradient_accumulation_steps > 1:
            raise NotImplementedError("opt_on_host does not compose with gradient accumulation "
                                      "(the JAX package's optax.MultiSteps); accumulate by "
                                      "batching instead")
        if tcfg.opt_async and not tcfg.opt_on_host:
            raise ValueError("opt_async requires opt_on_host")
        for name in ("teacher_stream", "page_generator", "block_vjp"):
            if getattr(tcfg, name) and not tcfg.staged_phases:
                raise ValueError(f"{name} requires staged_phases")
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
                                     last_step_only=tcfg.last_step_only, window_frames=window,
                                     cache_int8=tcfg.cache_int8)
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
        # several ranks: each keeps its fsdp shards (the module docstring)
        self.mesh = mesh
        # each tree's leaves' fsdp dims (None: replicated), param_leaves order
        fsdp = pm.axis_size(mesh, "fsdp")
        self._specs = {"gen": pm.leaf_specs(gen_params, fsdp),
                       "critic": pm.leaf_specs(critic_params, fsdp)}
        if mesh is not None:
            if pm.axis_size(mesh, "sp") != 1:
                raise ValueError("training shards over dp and fsdp; sp is a serving axis")
            gen_params = pm.shard_params(gen_params, mesh)
            critic_params = pm.shard_params(critic_params, mesh)
            if not tcfg.teacher_stream:
                self._specs["teacher"] = pm.leaf_specs(teacher_params, fsdp)
                teacher_params = pm.shard_params(teacher_params, mesh)
        gen_trained = gen_lora if self.use_lora else gen_params
        critic_trained = critic_lora if self.critic_lora_on else critic_params
        for t in param_leaves(teacher_params) + param_leaves(gen_params) + param_leaves(
                critic_params):
            t.requires_grad_(False)
        self.gen_leaves = [t.requires_grad_(True) for t in param_leaves(gen_trained)]
        self.critic_leaves = [t.requires_grad_(True) for t in param_leaves(critic_trained)]
        # the trained leaves' fsdp dims (adapters are replicated), and the
        # leaves of the last gathered tree whose gradients an update reduces
        self._trained_specs = {
            "gen": [None] * len(self.gen_leaves) if self.use_lora else self._specs["gen"],
            "critic": ([None] * len(self.critic_leaves) if self.critic_lora_on
                       else self._specs["critic"])}
        self._gathered: Dict[str, List[torch.Tensor]] = {}
        if tcfg.opt_on_host:
            gen_opt, critic_opt = (host_adamw_init(self.gen_leaves),
                                   host_adamw_init(self.critic_leaves))
        else:
            # eps outside the square root and decoupled decay, as optax.adamw
            gen_opt = torch.optim.AdamW(self.gen_leaves, lr=tcfg.lr,
                                        betas=(tcfg.beta1, tcfg.beta2), eps=1e-8,
                                        weight_decay=tcfg.weight_decay)
            critic_opt = torch.optim.AdamW(self.critic_leaves, lr=tcfg.lr_critic,
                                           betas=(tcfg.beta1_critic, tcfg.beta2_critic),
                                           eps=1e-8, weight_decay=tcfg.weight_decay)
        if tcfg.staged_phases:
            # the frozen trees leave the card: the teacher (whole, or with
            # teacher_stream its blocks), and the critic's base under LoRA
            teacher_params = (mem.blocks_to_host(teacher_params, self.device)
                              if tcfg.teacher_stream else mem.offload_to_host(teacher_params))
            if self.critic_lora_on:
                critic_params = mem.offload_to_host(critic_params)
        self.teacher_params = teacher_params
        self.state: Dict[str, Any] = {
            "gen_params": gen_params, "critic_params": critic_params,
            "gen_lora": gen_lora, "critic_lora": critic_lora,
            "gen_opt": gen_opt, "critic_opt": critic_opt,
            # the EMA follows the trained tree: the adapters under LoRA
            "ema_params": map_tree(self._host_copy, gen_trained), "step": 0}
        # gradient accumulation: the running mean of the micro-steps'
        # gradients and the micro-steps gathered, per model
        self._accum: Dict[str, list] = {}
        self._pending: Optional[_AsyncHostUpdate] = None  # the critic's (opt_async)
        self._late_norm: Optional[float] = None  # its grad norm, landed, not yet reported
        # phase_ledger: each phase's wall time, the device synchronised
        # around it; cleared at the start of a step
        self.phase_timer = PhaseTimer() if tcfg.phase_ledger else None
        self.page_bytes: Dict[str, int] = {}

    @property
    def gen_opt(self):
        """The generator's optimiser state: a ``torch.optim.AdamW``, or the
        host AdamW's (``host_adamw_init``) under ``opt_on_host``."""
        return self.state["gen_opt"]

    @property
    def critic_opt(self):
        return self.state["critic_opt"]

    # -- helpers -------------------------------------------------------------

    @staticmethod
    def _host_copy(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to("cpu", torch.float32, copy=True)

    def _autocast(self):
        return torch.autocast(self.device.type, dtype=torch.bfloat16,
                              enabled=self.device.type == "cuda", cache_enabled=False)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def _phase(self, name: str):
        """Times the enclosed phase into ``phase_timer`` (``phase_ledger``),
        the device synchronised before and after it; costs nothing when the
        ledger is off."""
        if self.phase_timer is None:
            yield
            return
        self._sync()
        with self.phase_timer.phase(name):
            yield
            self._sync()

    def _clear_phases(self) -> None:
        if self.phase_timer is not None:
            self.phase_timer.phases.clear()

    def _param_dtype(self) -> torch.dtype:
        return self.state["gen_params"]["patch_embedding"]["weight"].dtype

    # -- several ranks ---------------------------------------------------------

    def _gather(self, key: str, tree: dict, trained: bool = False) -> dict:
        """The whole tree from this rank's shards (itself without a mesh).
        ``trained``: the tree's leaves are model ``key``'s trained leaves,
        and its update follows; the gathered ones require grad and are kept
        until ``_reduce_grads`` drops them."""
        if self.mesh is None:
            return tree
        full = pm.gather_params(tree, self._specs[key], self.mesh)
        if trained:
            leaves = param_leaves(full)
            for t in leaves:
                t.requires_grad_(True)
            self._gathered[key] = leaves
        return full

    def _reduce_grads(self, which: str) -> None:
        """The gradients of the last gathered tree's trained leaves, as this
        rank's shards' ``.grad``: reduce-scattered over ``fsdp``, summed over
        ``dp`` (a replicated leaf's over every rank), divided by the world
        (the ranks of an ``fsdp`` group hold the same rows, so this is the
        mean over the dp groups: the gradient of the global mean loss)."""
        leaves = self.gen_leaves if which == "gen" else self.critic_leaves
        full = self._gathered.pop(which, leaves)
        world = pm.world_size()
        for shard, f, dim in zip(leaves, full, self._trained_specs[which]):
            g = torch.zeros_like(f) if f.grad is None else f.grad
            if dim is None:
                g = g.clone()
                dist.all_reduce(g)
            else:
                g = pm.reduce_scatter_dim(g, dim, pm.axis_group(self.mesh, "fsdp"))
                dist.all_reduce(g, group=pm.axis_group(self.mesh, "dp"))
            f.grad = None
            shard.grad = g.div_(world)

    def _grad_norm(self, which: str, grads: List[torch.Tensor]) -> float:
        """The global norm of the trained shards' gradients ``grads``: the
        sharded leaves' squares summed over ``fsdp``, a replicated leaf's
        counted once."""
        sq = torch.zeros(2, dtype=torch.float64, device=self.device)
        for g, dim in zip(grads, self._trained_specs[which]):
            sq[int(dim is None)] += g.double().square().sum()
        sharded = sq[:1].clone()
        dist.all_reduce(sharded, group=pm.axis_group(self.mesh, "fsdp"))
        return float((sharded[0] + sq[1]).sqrt())

    def _clip(self, which: str, leaves: List[torch.Tensor]) -> float:
        """Clip of the leaves' gradients to ``grad_clip_norm`` by their
        global norm (``clip_grad_norm_``'s rule); returns the norm."""
        if self.mesh is None:
            return float(torch.nn.utils.clip_grad_norm_(leaves, self.tcfg.grad_clip_norm))
        norm = self._grad_norm(which, [p.grad for p in leaves])
        coef = min(1.0, self.tcfg.grad_clip_norm / (norm + 1e-6))
        if coef < 1.0:
            for p in leaves:
                p.grad.mul_(coef)
        return norm

    def _global_mean(self, x) -> float:
        """A loss or metric averaged over the ranks (the mean over the
        global batch: the ranks' batches are the same size)."""
        if self.mesh is None:
            return x.item() if isinstance(x, torch.Tensor) else float(x)
        t = torch.as_tensor(x, dtype=torch.float64, device=self.device).detach().clone()
        dist.all_reduce(t)
        return float(t) / pm.world_size()

    def _dp_size(self) -> int:
        return pm.axis_size(self.mesh, "dp")

    def _rows(self, global_batch: int) -> slice:
        """This rank's rows of a global batch (all of them without a mesh)."""
        return slice(0, global_batch) if self.mesh is None else pm.batch_rows(
            self.mesh, global_batch)

    def _local_draws(self, d: PhaseDraws) -> PhaseDraws:
        """This rank's rows of the global batch's draws."""
        rows = self._rows(d.score_t.shape[0])
        return dataclasses.replace(d, renoise=d.renoise[:, :, rows], score_t=d.score_t[rows],
                                   score_noise=d.score_noise[rows])

    def _full_tensor(self, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """A shard of a trained leaf's kind gathered whole (over the card's
        collectives for a host tensor, then back to the host)."""
        if dim is None:
            return t
        on = t.device
        return pm.all_gather_dim(t.detach().to(self.device), dim,
                                 pm.axis_group(self.mesh, "fsdp")).to(on)

    def _shard_tensor(self, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        if dim is None:
            return t
        return t.chunk(pm.axis_size(self.mesh, "fsdp"), dim)[
            pm.axis_rank(self.mesh, "fsdp")].contiguous()

    def _gen_full(self, trained: bool = False) -> dict:
        """The generator as it runs: gathered from the ranks' shards, its
        adapters attached under LoRA.  ``trained``: the generator's update
        follows, which reduces the gathered leaves' gradients."""
        if self.use_lora:
            return lora_mod.attach_lora(self._gather("gen", self.state["gen_params"]),
                                        self.state["gen_lora"], self.lora_scale)
        return self._gather("gen", self.state["gen_params"], trained)

    def _critic_full(self, trained: bool = False) -> dict:
        """The critic as it runs, on the card: gathered from the ranks'
        shards, its adapters attached under LoRA, over its base fetched
        from the host under ``staged_phases`` (the copy lives as long as the
        returned tree).  ``trained`` as ``_gen_full``'s."""
        if not self.critic_lora_on:
            return self._gather("critic", self.state["critic_params"], trained)
        base = self.state["critic_params"]
        if self.tcfg.staged_phases:
            base = mem.fetch_from_host(base, self.device)
        return lora_mod.attach_lora(self._gather("critic", base), self.state["critic_lora"],
                                    self.lora_scale)

    def _rollout(self, gen: dict, noise, cross, renoise: torch.Tensor, exit_idx: int,
                 cotangent=None, cache=None, start: int = 0):
        """(latents, final cache) of the generator's rollout; ``cache`` and
        ``start`` continue a sequence."""
        return ro.rollout_trajectory(
            gen, self.cfg, self.cache_cfg, self.tables, self.sched, self.rcfg, noise, cross,
            renoise.to(self.device), exit_idx, cotangent=cotangent,
            cache_dtype=self.cache_dtype, cache=cache, current_start_frame=start)

    # -- the optimiser updates -----------------------------------------------

    def _apply_update(self, which: str) -> Optional[float]:
        """Clip of the global gradient norm, then AdamW, for the generator's
        (``"gen"``) or the critic's trained tensors, from their ``.grad``;
        the gradients are cleared.  A tensor without gradient gets zeros, as
        in the JAX update (its moments decay and the weight decay still
        applies).  Returns this micro-step's gradient norm (before the
        clip), or None where the update runs in the background
        (``opt_async``, the critic's: ``_join_pending`` lands it).

        With ``gradient_accumulation_steps`` = k the gradient joins the
        running mean of the micro-steps (optax.MultiSteps: acc + (g - acc)
        / (n + 1)); the k-th clips and applies the mean and starts over."""
        tc = self.tcfg
        leaves = self.gen_leaves if which == "gen" else self.critic_leaves
        if self.mesh is not None:
            self._reduce_grads(which)
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opt = self.state[which + "_opt"]
        if tc.opt_on_host:
            gen = which == "gen"
            kwargs = dict(lr=tc.lr if gen else tc.lr_critic, b1=tc.beta1 if gen else tc.beta1_critic,
                          b2=tc.beta2 if gen else tc.beta2_critic,
                          weight_decay=tc.weight_decay, clip=tc.grad_clip_norm)
            if self.mesh is not None:
                kwargs["norm"] = self._grad_norm(which, [p.grad for p in leaves])
            if tc.opt_async and not gen:
                if self._pending is not None:
                    raise RuntimeError("one background critic update at a time")
                self._pending = _AsyncHostUpdate(opt, leaves, kwargs)
                norm = None
            else:
                norm = _host_update(opt, leaves, *_grads_to_host(leaves), kwargs)
            for p in leaves:
                p.grad = None
            return norm
        k = tc.gradient_accumulation_steps
        if k == 1:
            norm = self._clip(which, leaves)
            opt.step()
            opt.zero_grad(set_to_none=True)
            return norm
        norm = (torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(p.grad)
                                                      for p in leaves]))
                if self.mesh is None else self._grad_norm(which, [p.grad for p in leaves]))
        acc = self._accum.setdefault(which, [[torch.zeros_like(p) for p in leaves], 0])
        for a, p in zip(acc[0], leaves):
            a.add_(_div(p.grad - a, acc[1] + 1))
        acc[1] += 1
        if acc[1] == k:
            for a, p in zip(acc[0], leaves):
                p.grad = a  # the clip scales it in place; zeroed below
            self._clip(which, leaves)
            opt.step()
            for a in acc[0]:
                a.zero_()
            acc[1] = 0
        opt.zero_grad(set_to_none=True)
        return float(norm)

    def _join_pending(self) -> None:
        """Lands the critic's background update (``opt_async``) and keeps
        its grad norm for the next metrics; a no-op when none runs.  Every
        read of the critic's parameters comes after it."""
        if self._pending is None:
            return
        fut, self._pending = self._pending, None
        self._late_norm = fut.join()

    def _critic_norm(self, norm: Optional[float]) -> Dict[str, float]:
        """The critic's grad norm for this step's metrics: this update's, or
        under ``opt_async`` the last landed one (none on the first step)."""
        if norm is None:
            norm, self._late_norm = self._late_norm, None
        return {} if norm is None else {"critic_grad_norm": norm}

    def finish_pending(self) -> Dict[str, float]:
        """Lands any background update (before reading ``state`` directly:
        a checkpoint, the end of training) and returns the grad norm that
        landed but no step's metrics reported yet."""
        self._join_pending()
        return self._critic_norm(None)

    # -- draws ---------------------------------------------------------------

    def _opt_step(self, micro: int) -> int:
        return micro // max(1, self.tcfg.gradient_accumulation_steps)

    def trains_generator(self, micro: int) -> bool:
        """Whether micro-step ``micro`` trains the generator: its optimiser
        step is a multiple of ``dfake_gen_update_ratio``."""
        return self._opt_step(micro) % self.tcfg.dfake_gen_update_ratio == 0

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
        """The draws of micro-step ``step``, from a CPU generator seeded by
        (seed, step), for a batch of ``noise_shape`` (with a mesh, the
        global batch's: every rank draws them)."""
        g = torch.Generator().manual_seed((self.tcfg.seed << 32) + step)
        gen = self._phase_draws(g, noise_shape) if self.trains_generator(step) else None
        return StepDraws(generator=gen, critic=self._phase_draws(g, noise_shape))

    # -- the two updates -----------------------------------------------------

    @contextlib.contextmanager
    def _generator_paged_out(self):
        """``page_generator``: the generator's trees (its base and adapters)
        in pinned host memory for the enclosed phases, each leaf's ``.data``
        swapped for its host copy and back, so every reference (the
        optimiser's too) follows.  ``page_bytes`` records the tree's bytes
        and the device bytes the swap freed (as requested of the caching
        allocator, whose blocks may be larger)."""
        if not self.tcfg.page_generator:
            yield
            return
        leaves = param_leaves(self.state["gen_params"]) + param_leaves(self.state["gen_lora"])
        on_card = self.device.type == "cuda"

        def requested():
            return (torch.cuda.memory_stats(self.device)["requested_bytes.all.current"]
                    if on_card else 0)

        with self._phase("gen_page_out"):
            before = requested()
            host = mem.offload_to_host([p.data for p in leaves])
            for p, h in zip(leaves, host):
                p.data = h
            freed = before - requested()
        self.page_bytes = {"gen_page_bytes": mem.hbm_bytes(host), "gen_page_freed_bytes": freed}
        try:
            yield
        finally:
            with self._phase("gen_page_in"):
                for p, h in zip(leaves, host):
                    p.data = h.to(self.device, non_blocking=True)

    def _dmd_cotangent(self, latents, prompt_c, prompt_u, score_t, score_noise, gmask):
        """(loss, aux, dL/dlatents) of the DMD loss, the critic and the
        teacher run without gradient: the teacher resident, fetched from
        the host (``staged_phases``) or streamed per layer
        (``teacher_stream``); the generator paged out meanwhile
        (``page_generator``); the critic's background update landed
        first."""
        tc = self.tcfg
        with self._generator_paged_out():
            teacher = self.teacher_params
            real_x0 = None
            if tc.teacher_stream:
                with self._phase("teacher_x0_streamed"), self._autocast():
                    real_x0 = dmd_mod.teacher_real_x0(
                        teacher, self.teacher_cfg, self.tables, self.sched, self.dcfg, latents,
                        prompt_c, prompt_u, score_t, score_noise, streamed=True)
            elif tc.staged_phases:
                with self._phase("teacher_fetch"):
                    teacher = mem.fetch_from_host(teacher, self.device)
            if not tc.teacher_stream:
                teacher = self._gather("teacher", teacher)
            self._join_pending()
            with self._phase("dmd_loss_grad"), self._autocast():
                if real_x0 is None:
                    real_x0 = dmd_mod.teacher_real_x0(
                        teacher, self.teacher_cfg, self.tables, self.sched, self.dcfg, latents,
                        prompt_c, prompt_u, score_t, score_noise)
                del teacher
                lat = latents.detach().requires_grad_()
                loss, aux = dmd_mod.distribution_matching_loss(
                    lat, self._critic_full(), None, self.cfg, self.tables, self.sched,
                    self.dcfg, prompt_c, prompt_u, score_t, score_noise, gradient_mask=gmask,
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
        gen, dtype = self._gen_full(trained=True), self._param_dtype()
        fpb = self.rcfg.frame_block
        use_mask = d.num_blocks != self._block_range(noise.shape[1])[0]
        noise = noise[:, :d.num_blocks * fpb]
        with self._phase("gen_rollout"), torch.no_grad(), self._autocast():
            cross = D.prepare_cross_kv(gen, self.cfg, prompt_c, dtype)
            latents = self._rollout(gen, noise, cross, d.renoise, d.exit_idx)[0]
            del cross
        gmask = None
        if use_mask:  # the DMD loss skips the first block of a shortened rollout
            gmask = (torch.arange(latents.shape[1], device=self.device)[None] >= fpb
                     ).expand(latents.shape[:2])
        loss, aux, dlat = self._dmd_cotangent(latents, prompt_c, prompt_u, d.score_t,
                                              d.score_noise, gmask)
        del latents
        with self._phase("gen_block_backward"), self._autocast():
            self._replay_backward(gen, noise, prompt_c, d.renoise, d.exit_idx, dlat)
        with self._phase("opt_generator"):
            gnorm = self._apply_update("gen")
        return loss, dict(aux, generator_grad_norm=gnorm)

    def _critic_loss_backward(self, latents, prompt_c, score_t, score_noise):
        loss, aux = dmd_mod.critic_denoising_loss(
            self._critic_full(trained=True), latents, self.cfg, self.tables, self.sched, self.dcfg,
            prompt_c, score_t, score_noise)
        loss.backward()
        return loss, aux

    def _critic_step(self, noise, prompt_c, d: PhaseDraws):
        gen, dtype = self._gen_full(), self._param_dtype()
        noise = noise[:, :d.num_blocks * self.rcfg.frame_block]
        with self._phase("critic_rollout"), torch.no_grad(), self._autocast():
            cross = D.prepare_cross_kv(gen, self.cfg, prompt_c, dtype)
            latents = self._rollout(gen, noise, cross, d.renoise, d.exit_idx)[0]
        self._join_pending()  # after the rollout's launches, which read no critic
        with self._phase("critic_loss_grad"), self._autocast():
            loss, aux = self._critic_loss_backward(latents, prompt_c, d.score_t, d.score_noise)
        with self._phase("opt_critic"):
            gnorm = self._apply_update("critic")
        return loss, dict(aux, **self._critic_norm(gnorm))

    # -- public API ----------------------------------------------------------

    def train_step(self, noise: torch.Tensor, prompt_c: torch.Tensor, prompt_u: torch.Tensor,
                   draws: Optional[StepDraws] = None) -> Dict[str, Any]:
        """One micro-step with the reference cadence: the critic trains on
        every step; the generator in addition on every
        ``dfake_gen_update_ratio``-th optimiser step (before the critic, on
        its own rollout).  With ``gradient_accumulation_steps`` = k the
        updates apply on every k-th micro-step.  noise: [B, F, C, H, W];
        prompt embeddings [B, text_len, text_dim]."""
        step = int(self.state["step"])
        opt_step = self._opt_step(step)
        train_generator = self.trains_generator(step)
        if draws is None:
            dp = self._dp_size()
            draws = self.sample_draws((noise.shape[0] * dp,) + tuple(noise.shape[1:]), step)
        if train_generator != (draws.generator is not None):
            raise ValueError(f"step {step} {'trains' if train_generator else 'skips'} the "
                             "generator; the draws say otherwise")
        noise, prompt_c, prompt_u = (x.to(self.device, torch.float32)
                                     for x in (noise, prompt_c, prompt_u))
        if self.mesh is not None:
            draws = StepDraws(generator=None if draws.generator is None
                              else self._local_draws(draws.generator),
                              critic=self._local_draws(draws.critic))
        self._clear_phases()
        metrics: Dict[str, Any] = {"step": step, "opt_step": opt_step}
        fpb = self.rcfg.frame_block
        if train_generator:
            d = draws.generator
            loss, aux = self._gen_step(noise, prompt_c, prompt_u, d)
            metrics.update({"generator_loss": self._global_mean(loss), "exit_idx": d.exit_idx,
                            "rollout_frames": d.num_blocks * fpb,
                            **{k: self._global_mean(v) for k, v in aux.items()}})
            self._after_generator_update(step)
        d = draws.critic
        loss, aux = self._critic_step(noise, prompt_c, d)
        metrics.update({"critic_loss": self._global_mean(loss), "critic_exit_idx": d.exit_idx,
                        **{k: self._global_mean(v) for k, v in aux.items()}})
        self._close_step(metrics, step)
        return metrics

    def _after_generator_update(self, step: int) -> None:
        """The EMA after the generator's update of micro-step ``step``, on
        the last micro-step of its optimiser step."""
        if (step + 1) % max(1, self.tcfg.gradient_accumulation_steps) == 0:
            self._update_ema(self._opt_step(step))

    def _close_step(self, metrics: Dict[str, Any], step: int) -> None:
        if self.phase_timer is not None:
            metrics["phase_ms"] = {k: sum(v) * 1e3 for k, v in self.phase_timer.phases.items()}
            metrics.update(self.page_bytes)
        self.page_bytes = {}
        self.state["step"] = step + 1

    def _update_ema(self, step: int):
        """Before ``ema_start_step`` the EMA is the trained tree, copied
        into the EMA's own tensors (a new copy would hold two EMAs in host
        memory at once); after it, the running average."""
        gen = self.state["gen_lora" if self.use_lora else "gen_params"]
        w = self.tcfg.ema_weight
        for e, p in zip(param_leaves(self.state["ema_params"]), param_leaves(gen)):
            if step < self.tcfg.ema_start_step:
                e.copy_(p.detach())
            else:
                e.mul_(w).add_(self._host_copy(p), alpha=1 - w)

    _TREES = ("gen_params", "critic_params", "gen_lora", "critic_lora")

    def _resharded(self, sd: Dict[str, Any], fn) -> Dict[str, Any]:
        """``sd`` (a ``state_dict``'s layout) with ``fn(tensor, fsdp dim)``
        applied to every tensor that a rank holds a shard of: the
        parameters, the EMA, the optimiser's moments and master copies, the
        accumulated gradients.  The identity without a mesh."""
        if self.mesh is None:
            return sd

        def tree(t, specs):
            it = iter(specs)
            return map_tree(lambda x: fn(x, next(it)), t)

        def opt(st, which):
            specs = self._trained_specs[which]
            if self.tcfg.opt_on_host:
                return {**st, **{n: [fn(x, d) for x, d in zip(st[n], specs)]
                                 for n in ("m", "v", "master")}}
            return {**st, "state": {i: {k: fn(v, specs[i]) if k in ("exp_avg", "exp_avg_sq")
                                        else v for k, v in p.items()}
                                    for i, p in st["state"].items()}}

        return {**sd, "gen_params": tree(sd["gen_params"], self._specs["gen"]),
                "critic_params": tree(sd["critic_params"], self._specs["critic"]),
                "ema_params": tree(sd["ema_params"], self._trained_specs["gen"]),
                "gen_opt": opt(sd["gen_opt"], "gen"),
                "critic_opt": opt(sd["critic_opt"], "critic"),
                "accum": {w: [[fn(x, d) for x, d in zip(a[0], self._trained_specs[w])], a[1]]
                          for w, a in (sd.get("accum") or {}).items()}}

    def state_dict(self) -> Dict[str, Any]:
        """What a checkpoint holds: parameters and adapters (None where
        LoRA is off), optimiser states (over the trained trees: torch
        AdamW's, or the host AdamW's tensors), the accumulated gradients
        mid-way through an optimiser step, EMA, step.  A background update
        lands first.  With a mesh every rank calls it and gets the whole
        trees, gathered from the ranks' shards, so a checkpoint loads on
        any number of ranks."""
        self._join_pending()
        detach = lambda t: t.detach()  # noqa: E731
        opts = {key: (self.state[key] if self.tcfg.opt_on_host else self.state[key].state_dict())
                for key in ("gen_opt", "critic_opt")}
        sd = {**{key: map_tree(detach, self.state[key]) for key in self._TREES}, **opts,
              "accum": {w: [list(a[0]), a[1]] for w, a in self._accum.items()},
              "ema_params": self.state["ema_params"], "step": int(self.state["step"])}
        return self._resharded(sd, self._full_tensor)

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Restores a ``state_dict`` in place (the optimisers keep their
        parameter references); with a mesh each rank takes its shards of
        the whole trees."""
        self._join_pending()
        sd = self._resharded(sd, self._shard_tensor)
        with torch.no_grad():
            for key in self._TREES:
                leaves, src = param_leaves(self.state[key]), param_leaves(sd.get(key))
                if len(src) != len(leaves):
                    raise ValueError(f"{key}: {len(src)} tensors in the checkpoint, "
                                     f"{len(leaves)} in the model")
                for dst, s in zip(leaves, src):
                    dst.copy_(s)
            for key in ("gen_opt", "critic_opt"):
                if self.tcfg.opt_on_host:
                    st, src = self.state[key], sd[key]
                    for name in ("m", "v", "master"):
                        for dst, s in zip(st[name], src[name]):
                            dst.copy_(s)
                    st["t"] = int(src["t"])
                else:
                    self.state[key].load_state_dict(sd[key])
            self._accum = {w: [[a.to(self.device) for a in acc], int(n)]
                           for w, (acc, n) in (sd.get("accum") or {}).items()}
            for dst, s in zip(param_leaves(self.state["ema_params"]),
                              param_leaves(sd["ema_params"])):
                dst.copy_(s)
        self.state["step"] = int(sd["step"])
