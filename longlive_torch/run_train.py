"""Training CLI: batch DMD training (Self-Forcing init) and streaming long
tuning.

Usage:
  python -m longlive_torch.run_train --config_path configs/longlive_train_init.yaml \\
      --allow_random_weights
  python -m longlive_torch.run_train --config_path configs/longlive_train_long.yaml \\
      --allow_random_weights

``streaming_training: true`` selects the streaming trainer (chunks
continuing one KV cache, prompt switches from ``switch_prompt_path`` with
the KV-recache, the first-frame re-encode through the VAE); ``adapter:
{type: lora, ...}`` trains LoRA adapters on the generator (and the critic
with ``apply_to_critic``) over frozen bases.  Runs on the GPU (``--device
cuda``, the default); a YAML with ``tiny_debug: true`` runs the tiny model
and ``--device cpu`` the plain PyTorch paths.  Auto-resume restores the
latest checkpoint under ``--logdir`` (adapters and their optimiser states
included, and the loader's position) unless ``--no_auto_resume``; a
streaming run resumes at the start of a new sequence (the sequence's state
is not in the checkpoint).  More than one process is not ported yet and
raises NotImplementedError.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import sys
import time

import torch
import yaml

from .config import (WAN_MODEL_CONFIGS, LatentGeometry, pipeline_config_from_dict,
                     tiny_dit_config, tiny_geometry, warn_unknown_keys)
from .models import dit as D
from .models import vae as V
from .training import lora as lora_mod
from .training.streaming import StreamingConfig, StreamingTrainer
from .training.trainer import ScoreDistillationTrainer, TrainerConfig, map_tree
from .utils import loading, train_state
from .utils.dataset import ShardedCheckpointableLoader, TextDataset, TwoTextDataset, cycle
from .utils.device import resolve_device
from .utils.metrics import MetricsLogger


def build_trainer_config(raw: dict) -> TrainerConfig:
    mk = raw.get("model_kwargs", {}) or {}
    adapter = raw.get("adapter") or {}
    return TrainerConfig(
        lr=float(raw.get("lr", 2e-6)),
        lr_critic=float(raw.get("lr_critic", 4e-7)),
        beta1=float(raw.get("beta1", 0.0)),
        beta2=float(raw.get("beta2", 0.999)),
        beta1_critic=float(raw.get("beta1_critic", 0.0)),
        beta2_critic=float(raw.get("beta2_critic", 0.999)),
        weight_decay=float(raw.get("weight_decay", 0.01)),
        dfake_gen_update_ratio=int(raw.get("dfake_gen_update_ratio", 5)),
        gradient_accumulation_steps=int(raw.get("gradient_accumulation_steps", 1)),
        ema_weight=float(raw.get("ema_weight", 0.99)),
        ema_start_step=int(raw.get("ema_start_step", 200)),
        denoising_step_list=tuple(raw.get("denoising_step_list", (1000, 750, 500, 250))),
        warp_denoising_step=bool(raw.get("warp_denoising_step", True)),
        timestep_shift=float(mk.get("timestep_shift", 5.0)),
        guidance_scale=float(raw.get("guidance_scale", 3.0)),
        num_frame_per_block=int(raw.get("num_frame_per_block", 3)),
        num_training_frames=int(raw.get("num_training_frames", 21)),
        min_num_training_frames=int(raw.get("min_num_training_frames",
                                            raw.get("num_training_frames", 21))),
        slice_last_frames=int(raw.get("slice_last_frames", 21)),
        context_noise=float(raw.get("context_noise", 0)),
        last_step_only=bool(raw.get("last_step_only", False)),
        ts_schedule=bool(raw.get("ts_schedule", False)),
        ts_schedule_max=bool(raw.get("ts_schedule_max", False)),
        seed=int(raw.get("seed", 0)),
        lora_rank=int(adapter.get("rank", 0)) if adapter.get("type") == "lora" else 0,
        lora_alpha=float(adapter.get("alpha", 256)),
        lora_apply_to_critic=bool(adapter.get("apply_to_critic", True)),
        lora_dtype=str(adapter.get("dtype", "bfloat16")),
        opt_on_host=bool(raw.get("opt_on_host", False)),
        opt_async=bool(raw.get("opt_async", False)),
        ema_on_host=bool(raw.get("ema_on_host", True)),
        cache_int8=bool(raw.get("cache_int8", False)),
        staged_phases=bool(raw.get("staged_phases", False)) or bool(raw.get("block_vjp", False)),
        block_vjp=bool(raw.get("block_vjp", False)),
        page_generator=bool(raw.get("page_generator", False)),
        teacher_stream=bool(raw.get("teacher_stream", False)),
        phase_ledger=bool(raw.get("phase_ledger", False)),
    )


def resolve_score_models(raw: dict, dit_cfg, tcfg: TrainerConfig, device="cuda",
                         strict: bool = False):
    """Teacher (``real_score``) and critic (``fake_score``): FRESH base-Wan
    weights named by ``real_name`` / ``fake_name``, never copies of the
    generator.  Random init uses seeds ``seed + 1`` (teacher) and
    ``seed + 2`` (critic).  Returns (teacher_params, teacher_cfg,
    critic_params), float32."""
    real_name = raw.get("real_name", "Wan2.1-T2V-1.3B")
    fake_name = raw.get("fake_name", "Wan2.1-T2V-1.3B")
    seed = int(raw.get("seed", 0))
    if raw.get("tiny_debug"):
        teacher = D.init_dit_params(dit_cfg, torch.float32, device, seed=seed + 1,
                                    zero_head=False)
        critic = D.init_dit_params(dit_cfg, torch.float32, device, seed=seed + 2,
                                   zero_head=False)
        return teacher, dit_cfg, critic
    tgeom = WAN_MODEL_CONFIGS.get(real_name)
    if tgeom is None:
        raise KeyError(f"real_name {real_name!r} unknown; known: {list(WAN_MODEL_CONFIGS)}")
    teacher_cfg = dataclasses.replace(dit_cfg, **tgeom)
    if teacher_cfg.dim != dit_cfg.dim or teacher_cfg.num_layers != dit_cfg.num_layers:
        raise NotImplementedError(
            f"real_name {real_name!r} is a larger teacher; it needs the host-streamed "
            "teacher (teacher_stream), not ported yet: ROADMAP queue 1, item 12 "
            "(single-chip training levers)")
    teacher = loading.load_base_dit(os.path.join("wan_models", real_name), teacher_cfg,
                                    torch.float32, device, seed=seed + 1, strict=strict)
    fgeom = WAN_MODEL_CONFIGS.get(fake_name)
    if fgeom is None:
        raise KeyError(f"fake_name {fake_name!r} unknown; known: {list(WAN_MODEL_CONFIGS)}")
    if fgeom["dim"] != dit_cfg.dim or fgeom["num_layers"] != dit_cfg.num_layers:
        raise ValueError(f"fake_name {fake_name!r} geometry {fgeom} differs from the "
                         "generator's; the critic must share the generator's config")
    critic = loading.load_base_dit(os.path.join("wan_models", fake_name), dit_cfg,
                                   torch.float32, device, seed=seed + 2, strict=strict)
    return teacher, teacher_cfg, critic


def random_prompt_embedding(prompt: str, cfg, device) -> torch.Tensor:
    """[1, text_len, text_dim] from a generator seeded by the prompt's
    SHA-256 (the same embedding for the same text in every run)."""
    seed = int.from_bytes(hashlib.sha256(prompt.encode("utf-8")).digest()[:8], "little")
    g = torch.Generator().manual_seed(seed)
    return torch.randn((1, cfg.text_len, cfg.text_dim), generator=g).to(device)


def main(argv=None):
    """Returns the trainer after the loop."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config_path", required=True)
    ap.add_argument("--logdir", default="checkpoints/run")
    ap.add_argument("--max_iters", type=int, default=None)
    ap.add_argument("--no_auto_resume", action="store_true")
    ap.add_argument("--allow_random_weights", action="store_true",
                    help="proceed with random init when model artifacts are missing "
                         "(smoke runs only: distilling against a random teacher is "
                         "silently ruined)")
    ap.add_argument("--no_save", action="store_true",
                    help="write no checkpoints (smoke runs: a full-size state is ~40 GB)")
    ap.add_argument("--device", default="cuda", help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"error: {e}")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError("multi-process training is not ported yet: "
                                  "ROADMAP queue 1, item 14")
    with open(args.config_path) as f:
        raw = yaml.safe_load(f)
    warn_unknown_keys(raw, source=args.config_path)
    pconfig = pipeline_config_from_dict(raw)
    tcfg = build_trainer_config(raw)
    tiny = bool(raw.get("tiny_debug"))
    if tiny:
        dit_cfg, geom = tiny_dit_config(), tiny_geometry()
        tcfg.num_frame_per_block = dit_cfg.num_frame_per_block
        tcfg.num_training_frames = min(tcfg.num_training_frames, 4)
        tcfg.min_num_training_frames = min(tcfg.min_num_training_frames, 4)
        tcfg.slice_last_frames = min(tcfg.slice_last_frames, 4)
    else:
        dit_cfg, geom = pconfig.dit_config(), LatentGeometry()
    max_iters = args.max_iters or int(raw.get("max_iters", 10000))
    log_iters = int(raw.get("log_iters", 100))
    max_ckpts = int(raw.get("max_checkpoints", 5))
    strict = not (args.allow_random_weights or bool(raw.get("allow_random_weights", False))
                  or tiny)

    if tiny:
        gen_params = D.init_dit_params(dit_cfg, torch.float32, device, seed=0, zero_head=False)
        vcfg = V.tiny_vae_config()  # visualize() and the streaming re-encode
        vae_params = V.init_vae_params(vcfg, torch.float32, device, seed=0)
        text_encoder = None
    else:
        gen_params = loading.load_dit_params(pconfig, dit_cfg, torch.float32, device,
                                             strict=strict)
        vae_params, vcfg = loading.load_vae_params(pconfig, torch.bfloat16, device,
                                                   strict=strict)
        text_encoder = loading.load_text_encoder(pconfig, torch.bfloat16, device, strict=strict)
    teacher_params, teacher_cfg, critic_params = resolve_score_models(
        raw, dit_cfg, tcfg, device, strict=strict)
    streaming = bool(raw.get("streaming_training", False))
    if streaming:
        scfg = StreamingConfig(
            chunk_size=int(raw.get("streaming_chunk_size", 21)),
            max_length=int(raw.get("streaming_max_length", 240)),
            min_new_frame=int(raw.get("streaming_min_new_frame", 18)),
            switch_choices=tuple(raw.get("switch_choices", ()) or ()),
            global_sink=bool(raw.get("global_sink", False)),
            train_first_chunk=bool(raw.get("train_first_chunk", True)))
        trainer = StreamingTrainer(tcfg, dit_cfg, geom, gen_params, critic_params,
                                   teacher_params, teacher_cfg=teacher_cfg, device=device,
                                   streaming_cfg=scfg, vae_params=vae_params, vae_cfg=vcfg)
    else:
        trainer = ScoreDistillationTrainer(tcfg, dit_cfg, geom, gen_params, critic_params,
                                           teacher_params, teacher_cfg=teacher_cfg,
                                           device=device)

    if not args.no_auto_resume:
        restored = train_state.restore_train_state(args.logdir)
        if restored is not None:
            trainer.load_state_dict(restored)
            print(f"[resume] restored step {trainer.state['step']}")

    data_path = raw.get("data_path")
    switch_path = raw.get("switch_prompt_path")
    loader = None
    if data_path and os.path.exists(data_path):
        if switch_path and os.path.exists(switch_path):
            ds = TwoTextDataset(data_path, switch_path)
        else:
            ds = TextDataset(data_path)
        lstate = None if args.no_auto_resume else train_state.load_loader_state(args.logdir)
        loader = ShardedCheckpointableLoader(ds, 0, 1, seed=int(raw.get("seed", 0)),
                                             state=lstate)
        if lstate is not None:
            print(f"[resume] loader at epoch {loader.epoch} index {loader.index}")
        prompt_iter = loader
    else:
        prompt_iter = cycle([{"prompts": "(random)", "idx": 0}])
    neg_prompt = raw.get("negative_prompt", "")

    def encode(p):
        if text_encoder is not None:
            return text_encoder([p])["prompt_embeds"].float()
        return random_prompt_embedding(p, dit_cfg, device)

    neg_embed = encode(neg_prompt)  # the same every step: encoded once

    vis_interval = int(raw.get("vis_interval", 0) or 0)
    vis_lengths = list(raw.get("vis_video_lengths", [21]) or [21])

    def visualize(step: int):
        """The EMA generator through the inference pipeline and the VAE."""
        from .pipeline import CausalInferencePipeline
        from .utils.video_io import to_video_array, write_video

        cdt = torch.bfloat16 if device.type == "cuda" else torch.float32
        ema = trainer.state["ema_params"]
        if trainer.use_lora:  # the EMA tracks the adapters: merge them into the base
            ema = lora_mod.merge_lora(trainer.state["gen_params"],
                                      map_tree(lambda t: t.to(device), ema), trainer.lora_scale)
        ema = map_tree(lambda t: t.detach().to(device, cdt), ema)
        pipe = CausalInferencePipeline(pconfig, ema, geometry=geom, dit_config=dit_cfg,
                                       device=device)
        cross = pipe.prepare_condition(encode(next(prompt_iter)["prompts"]).to(cdt))
        for length in vis_lengths:
            g = torch.Generator().manual_seed(step)
            nz = torch.randn((1, length, geom.channels, geom.height, geom.width), generator=g)
            lat = pipe.generate_latents(nz.to(device), cross)
            px = V.vae_decode_scan(vae_params, vcfg, lat.to(cdt))[0]
            write_video(os.path.join(args.logdir, f"vis_{step:06d}_{length}f.mp4"),
                        to_video_array(px), fps=16)

    wandb_project = raw.get("wandb_project")
    logger = MetricsLogger(
        logdir=args.logdir,
        wandb_config=(dict(project=wandb_project, entity=raw.get("wandb_entity"))
                      if wandb_project not in (None, "YOUR_WANDB_PROJECT") else None))
    batch = int(raw.get("image_or_video_shape", [1])[0])

    def new_sequence():
        row = next(prompt_iter)
        ps = row.get("switch_prompts")
        trainer.start_new_sequence(
            encode(row["prompts"]).expand(batch, -1, -1), neg_embed.expand(batch, -1, -1),
            prompt_switch=None if ps is None else encode(ps).expand(batch, -1, -1))

    t0 = time.time()
    while int(trainer.state["step"]) < max_iters:
        step = int(trainer.state["step"])
        if streaming:
            if not trainer.can_generate_more():
                new_sequence()
            metrics = trainer.streaming_train_step(new_sequence_cb=new_sequence)
        else:
            row = next(prompt_iter)
            cc, cu = encode(row["prompts"]), neg_embed
            # the step's noise, from a stream of its own (the trainer's
            # draws take (seed << 32) + step)
            g = torch.Generator().manual_seed((tcfg.seed << 32) + (1 << 31) + step)
            noise = torch.randn((batch, tcfg.num_training_frames, geom.channels, geom.height,
                                 geom.width), generator=g)
            metrics = trainer.train_step(noise, cc.expand(batch, -1, -1),
                                         cu.expand(batch, -1, -1))
        if step % log_iters == 0 or step < 3:
            metrics["wall_s"] = round(time.time() - t0, 1)
            print(metrics, flush=True)
        logger.log(metrics, step=step)
        if step > 0 and step % log_iters == 0 and not args.no_save:
            trainer.finish_pending()
            train_state.save_train_state(args.logdir, step, trainer.state_dict(), max_ckpts)
            if loader is not None:
                train_state.save_loader_state(args.logdir, step, loader.state())
        if vis_interval and step > 0 and step % vis_interval == 0:
            try:
                visualize(step)
            except Exception as e:  # noqa: BLE001 — a failed preview must not stop training
                print(f"[vis] failed at step {step}: {e!r}")
    leftover = trainer.finish_pending()
    if leftover:
        logger.log(leftover, step=int(trainer.state["step"]))
    final = int(trainer.state["step"])
    if not args.no_save:
        train_state.save_train_state(args.logdir, final, trainer.state_dict(), max_ckpts)
        if loader is not None:
            train_state.save_loader_state(args.logdir, final, loader.state())
    return trainer



if __name__ == "__main__":
    main()
