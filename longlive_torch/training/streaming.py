"""Streaming long tuning (train-long-test-long).

Per sequence (up to ``max_length`` frames):

- the first chunk rolls out ``chunk_size`` (21) frames from noise;
- each later chunk rolls out ``new_frames`` (18 at the shipped settings)
  frames continuing the SAME KV cache, and ``overlap = chunk_size -
  new_frames`` frames of the previous chunk go in front of them, so every
  supervised chunk is ``chunk_size`` frames;
- the first frame of such a chunk is re-encoded through the VAE (decode,
  last pixel frame, encode) as inference-time image conditioning would
  give it;
- the DMD loss masks the overlap frames: only new frames take gradient;
- with a switch prompt, when the sequence's drawn switch frame falls inside
  a chunk, the cache is rebuilt under the new prompt first (the KV-recache
  of the last ``min(chunk_size, ...)`` frames, ``pipeline.causal_inference
  .build_recache_fn``) and the chunk is generated under it.

The cadence is the batch trainer's: the generator every
``dfake_gen_update_ratio``-th step, then the critic, each on a chunk of its
own; a sequence exhausted between the two calls ``new_sequence_cb``.

Both updates take the batch trainer's staged, per-block form.  The
generator's rollout writes the cache in place, so the cache is cloned
before it and the per-block replay continues the clone from the chunk's
start (the replay's final cache equals the rollout's: the same draws).
The replay takes the chunk's cotangent without its overlap frames.

Random draws come in explicitly (``ChunkDraws``), asked for in the order
the state decides their shapes; by default from a CPU ``torch.Generator``
seeded by (seed, step), so a step's draws do not depend on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..models import dit as D
from ..models import vae as V
from ..ops import kv_cache as kvc
from ..pipeline.causal_inference import build_recache_fn
from . import dmd as dmd_mod
from . import rollout as ro
from .trainer import ScoreDistillationTrainer


@dataclasses.dataclass
class StreamingConfig:
    chunk_size: int = 21
    max_length: int = 240
    min_new_frame: int = 18
    switch_choices: Tuple[int, ...] = ()  # configs/longlive_train_long.yaml
    global_sink: bool = False
    train_first_chunk: bool = True


class ChunkDraws:
    """The random numbers one streaming update (generator or critic)
    consumes, drawn on demand from a CPU generator: the new-frame choice
    (chunks after the first), the exit step, the chunk's noise, the
    rollout's re-noise draws, then the score draws.  A subclass may take
    them from elsewhere (the tests replay the JAX package's keys)."""

    def __init__(self, generator: torch.Generator):
        self.g = generator

    def choice(self, n: int) -> int:
        return int(torch.randint(0, n, (), generator=self.g))

    def exit_idx(self, num_steps: int, last_step_only: bool) -> int:
        return ro.sample_exit_idx(self.g, num_steps, last_step_only)

    def noise(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.g)

    def renoise(self, num_blocks: int, exit_idx: int, block_shape) -> torch.Tensor:
        """[num_blocks, exit_idx + 1, *block_shape] (``rollout_block``)."""
        return torch.randn((num_blocks, exit_idx + 1) + tuple(block_shape), generator=self.g)

    def score(self, shape, lo: int, hi: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(score_t [B] in [lo, hi), score_noise ``shape``)."""
        return (torch.randint(lo, hi, (shape[0],), generator=self.g),
                torch.randn(tuple(shape), generator=self.g))

    def seed_chunk(self) -> "ChunkDraws":
        """The draws of the untrained seed chunk (``train_first_chunk:
        false``): its exit step, noise and re-noise draws."""
        return self


@dataclasses.dataclass
class StreamStepDraws:
    generator: Optional[ChunkDraws]  # None on steps that train the critic only
    critic: ChunkDraws


class StreamingTrainer(ScoreDistillationTrainer):
    """The streaming state machine on top of the DMD trainer.  ``vae_params``
    (None: no re-encode) serve the first-frame re-encode."""

    def __init__(self, *args, streaming_cfg: StreamingConfig = StreamingConfig(),
                 vae_params: Optional[dict] = None, vae_cfg: Optional[V.VAEConfig] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.scfg = streaming_cfg
        self.vae_params = vae_params
        self.vae_cfg = vae_cfg or V.VAEConfig()
        self.seq_state: Optional[Dict[str, Any]] = None

    # -- sequence lifecycle ----------------------------------------------------

    def start_new_sequence(self, prompt_c: torch.Tensor, prompt_u: torch.Tensor,
                           prompt_switch: Optional[torch.Tensor] = None,
                           switch_choice: Optional[int] = None):
        """A fresh sequence (empty cache) for the prompt embeddings [B,
        text_len, text_dim].  With a switch prompt and ``switch_choices``,
        the switch frame is ``switch_choices[switch_choice]``; the choice is
        drawn, when not given, from a CPU generator seeded by (seed, step).
        The cache batch follows the prompt batch."""
        switch_idx = None
        choices = self.scfg.switch_choices
        if prompt_switch is not None and choices:
            if switch_choice is None:
                g = torch.Generator().manual_seed(
                    (self.tcfg.seed << 32) + (1 << 29) + int(self.state["step"]))
                switch_choice = int(torch.randint(0, len(choices), (), generator=g))
            switch_idx = int(choices[switch_choice])

        def dev(x):
            return None if x is None else x.to(self.device, torch.float32)

        self.seq_state = {
            "current_length": 0, "previous_frames": None, "has_switched": False,
            "prompt_c": dev(prompt_c), "prompt_u": dev(prompt_u),
            "prompt_switch": dev(prompt_switch), "switch_frame_index": switch_idx,
            "cache": kvc.init_cache(self.cache_cfg, self.cfg.num_layers, prompt_c.shape[0],
                                    self.cfg.num_heads, self.cfg.head_dim, self.cache_dtype,
                                    self.device),
        }

    def can_generate_more(self) -> bool:
        s = self.seq_state
        return (s is not None
                and s["current_length"] + self.scfg.min_new_frame <= self.scfg.max_length)

    # -- the chunk ---------------------------------------------------------------

    def _reencode_first_frame(self, chunk: torch.Tensor) -> torch.Tensor:
        """The chunk with its first latent frame replaced by the VAE's
        encoding of the last pixel frame its decode gives (no gradient; no-op
        without VAE parameters)."""
        if self.vae_params is None:
            return chunk
        vdt = self.vae_params["conv1"]["w"].dtype
        with torch.no_grad():
            pixels = V.vae_decode(self.vae_params, self.vae_cfg, chunk[:, :1].to(vdt), chunk=1)
            relatent = V.vae_encode(self.vae_params, self.vae_cfg, pixels[:, -1:].to(vdt))
        return torch.cat([relatent.to(chunk.dtype), chunk[:, 1:]], dim=1)

    def _assemble(self, prev_overlap: Optional[torch.Tensor], new_chunk: torch.Tensor):
        """(supervised chunk, the next chunk's previous frames): the overlap
        frames before the new ones, then the first frame re-encoded."""
        full = new_chunk if prev_overlap is None else torch.cat([prev_overlap, new_chunk], 1)
        new_prev = full[:, -self.scfg.chunk_size:]
        if prev_overlap is not None:
            with self._phase("reencode"):
                full = self._reencode_first_frame(full)
        return full, new_prev

    def _recache(self, prompt: torch.Tensor, replay: torch.Tensor, start: int) -> None:
        """The cache rebuilt under ``prompt`` from the ``replay`` frames
        (absolute frames [start, start + n))."""
        s, n = self.seq_state, replay.shape[1]
        fn = build_recache_fn(
            self.cfg, self.cache_cfg, self.tables, float(self.rcfg.context_noise), n,
            global_sink=self.scfg.global_sink, overwrite_sink=False,
            window_frames=self.rcfg.window_frames or self.cache_cfg.total_frames)
        gen = self._gen_full()
        with self._phase("recache"), torch.no_grad(), self._autocast():
            cross = D.prepare_cross_kv(gen, self.cfg, prompt, self._param_dtype())
            s["cache"] = fn(gen, s["cache"], cross, replay, start)

    def _seed_chunk(self, d: ChunkDraws) -> None:
        """An untrained first chunk that only seeds the cache and the
        previous frames (``train_first_chunk: false``)."""
        s = self.seq_state
        c, fpb = self.scfg.chunk_size, self.rcfg.frame_block
        b = s["cache"].k.shape[1]
        exit_idx = d.exit_idx(len(self.rcfg.denoise_timesteps), self.rcfg.last_step_only)
        noise = d.noise((b, c, self.geom.channels, self.geom.height, self.geom.width))
        renoise = d.renoise(c // fpb, exit_idx,
                            (b, fpb, self.geom.channels, self.geom.height, self.geom.width))
        gen = self._gen_full()
        with self._phase("seed_rollout"), torch.no_grad(), self._autocast():
            cross = D.prepare_cross_kv(gen, self.cfg, s["prompt_c"], self._param_dtype())
            lat, s["cache"] = self._rollout(gen, noise.to(self.device), cross, renoise, exit_idx,
                                            cache=s["cache"], start=0)
        s["previous_frames"] = lat[:, -c:]
        s["current_length"] = c

    def _gen_chunk(self, prompt, noise, renoise, exit_idx, overlap, prev_overlap, score_t,
                   score_noise):
        s = self.seq_state
        gen, cur = self._gen_full(), s["current_length"]
        with self._phase("gen_rollout"), torch.no_grad(), self._autocast():
            # the rollout commits into the cache in place; the replay
            # continues this copy from the chunk's start
            start_cache = dataclasses.replace(s["cache"], k=s["cache"].k.clone(),
                                              v=s["cache"].v.clone())
            cross = D.prepare_cross_kv(gen, self.cfg, prompt, self._param_dtype())
            new_chunk, s["cache"] = self._rollout(gen, noise, cross, renoise, exit_idx,
                                                  cache=s["cache"], start=cur)
        full, s["previous_frames"] = self._assemble(prev_overlap, new_chunk)
        gmask = None
        if overlap > 0:  # the overlap frames are context: no gradient
            gmask = (torch.arange(full.shape[1], device=self.device)[None] >= overlap
                     ).expand(full.shape[:2])
        with self._phase("dmd_loss_grad"), self._autocast():
            loss, aux, dlat = self._dmd_cotangent(full, prompt, s["prompt_u"], score_t,
                                                  score_noise, gmask)
        del full
        with self._phase("gen_block_backward"), self._autocast():
            self._replay_backward(gen, noise, prompt, renoise, exit_idx, dlat[:, overlap:],
                                  cache=start_cache, start=cur)
        del start_cache
        with self._phase("gen_optimizer"):
            gnorm = self._apply_update(self.gen_opt, self.gen_leaves)
        return loss, dict(aux, generator_grad_norm=gnorm)

    def _critic_chunk(self, prompt, noise, renoise, exit_idx, prev_overlap, score_t,
                      score_noise):
        s = self.seq_state
        gen = self._gen_full()
        with self._phase("critic_rollout"), torch.no_grad(), self._autocast():
            cross = D.prepare_cross_kv(gen, self.cfg, prompt, self._param_dtype())
            new_chunk, s["cache"] = self._rollout(gen, noise, cross, renoise, exit_idx,
                                                  cache=s["cache"], start=s["current_length"])
        full, s["previous_frames"] = self._assemble(prev_overlap, new_chunk)
        with self._phase("critic_loss_grad"), self._autocast():
            loss, aux = self._critic_loss_backward(full, prompt, score_t, score_noise)
        with self._phase("critic_optimizer"):
            gnorm = self._apply_update(self.critic_opt, self.critic_leaves)
        return loss, dict(aux, critic_grad_norm=gnorm)

    def _one_streaming_fwdbwd(self, train_generator: bool, d: ChunkDraws) -> Dict[str, Any]:
        """Generates the sequence's next chunk with the persistent cache and
        updates one model."""
        if self.seq_state is None:
            raise RuntimeError("call start_new_sequence first")
        s, c, fpb = self.seq_state, self.scfg.chunk_size, self.rcfg.frame_block
        if not self.scfg.train_first_chunk and s["current_length"] == 0:
            self._seed_chunk(d.seed_chunk())

        cur, prev = s["current_length"], s["previous_frames"]
        if prev is None:
            new_frames, overlap = c, 0
        else:
            max_new = min(self.scfg.max_length - cur + 1, c)
            choices = list(range(self.scfg.min_new_frame, max_new, 3)) or [
                self.scfg.min_new_frame]
            new_frames = choices[d.choice(len(choices))]
            overlap = c - new_frames
            if overlap > prev.shape[1]:
                overlap, new_frames = 0, c
        exit_idx = d.exit_idx(len(self.rcfg.denoise_timesteps), self.rcfg.last_step_only)

        si = s["switch_frame_index"]
        switching = (si is not None and not s["has_switched"]
                     and cur <= si < cur + new_frames)
        use_switch = si is not None and (s["has_switched"] or cur >= si or switching)
        prompt = s["prompt_switch"] if use_switch else s["prompt_c"]
        if switching and cur > 0 and prev is not None:
            n = min(c, prev.shape[1], cur)
            self._recache(prompt, prev[:, -n:], cur - n)
        if switching:
            s["has_switched"] = True

        b = s["cache"].k.shape[1]
        frame = (self.geom.channels, self.geom.height, self.geom.width)
        noise = d.noise((b, new_frames) + frame).to(self.device)
        renoise = d.renoise(new_frames // fpb, exit_idx, (b, fpb) + frame)
        t_from, t_to = ro.denoised_timestep_bounds(self.sched, self.rcfg, exit_idx)
        lo, hi = dmd_mod.score_timestep_range(self.dcfg, t_from, t_to)
        score_t, score_noise = d.score((b, overlap + new_frames) + frame, lo, hi)
        prev_overlap = None if overlap == 0 else prev[:, -overlap:]
        if train_generator:
            loss, aux = self._gen_chunk(prompt, noise, renoise, exit_idx, overlap, prev_overlap,
                                        score_t, score_noise)
            metrics = {"generator_loss": loss.item()}
        else:
            loss, aux = self._critic_chunk(prompt, noise, renoise, exit_idx, prev_overlap,
                                           score_t, score_noise)
            metrics = {"critic_loss": loss.item()}
        s["current_length"] = cur + new_frames
        metrics.update({k: float(v) for k, v in aux.items()})
        metrics.update({"exit_idx": exit_idx, "new_frames": new_frames, "overlap": overlap,
                        "current_length": s["current_length"], "switched": switching})
        return metrics

    # -- the step ------------------------------------------------------------------

    def sample_stream_draws(self, step: int) -> StreamStepDraws:
        """The draws of step ``step``: one CPU generator seeded by (seed,
        step), the generator's update (when it trains) drawing first."""
        g = torch.Generator().manual_seed((self.tcfg.seed << 32) + step)
        train_gen = step % self.tcfg.dfake_gen_update_ratio == 0
        return StreamStepDraws(generator=ChunkDraws(g) if train_gen else None,
                               critic=ChunkDraws(g))

    def streaming_train_step(self, draws: Optional[StreamStepDraws] = None,
                             new_sequence_cb: Optional[Callable[[], None]] = None
                             ) -> Dict[str, Any]:
        """One step with the batch trainer's cadence: on every
        ``dfake_gen_update_ratio``-th step the generator trains on the next
        chunk, then (after ``new_sequence_cb`` when that exhausted the
        sequence) the critic on the chunk after it.  The generator's chunk
        state is in the metrics with a ``gen_`` prefix; ``switched`` and
        ``new_frames`` cover both updates."""
        step = int(self.state["step"])
        train_generator = step % self.tcfg.dfake_gen_update_ratio == 0
        if draws is None:
            draws = self.sample_stream_draws(step)
        if train_generator != (draws.generator is not None):
            raise ValueError(f"step {step} {'trains' if train_generator else 'skips'} the "
                             "generator; the draws say otherwise")
        self.phase_ms = {}
        metrics: Dict[str, Any] = {"step": step, "opt_step": step}
        gen_m: Dict[str, Any] = {}
        if train_generator:
            gen_m = self._one_streaming_fwdbwd(True, draws.generator)
            self._update_ema(step)
            if not self.can_generate_more():
                if new_sequence_cb is None:
                    raise RuntimeError("sequence exhausted mid-step; pass new_sequence_cb")
                new_sequence_cb()
        crit_m = self._one_streaming_fwdbwd(False, draws.critic)
        metrics.update({f"gen_{k}": v for k, v in gen_m.items() if k != "generator_loss"})
        if "generator_loss" in gen_m:
            metrics["generator_loss"] = gen_m["generator_loss"]
        metrics.update(crit_m)
        metrics["switched"] = bool(gen_m.get("switched", False)) or bool(crit_m["switched"])
        metrics["new_frames"] = gen_m.get("new_frames", 0) + crit_m["new_frames"]
        if self.tcfg.phase_ledger:
            metrics["phase_ms"] = dict(self.phase_ms)
        self.state["step"] = step + 1
        return metrics
