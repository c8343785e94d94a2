"""Interactive (streaming prompt-switch) generation CLI.

Usage:  python -m longlive_torch.run_interactive --config_path configs/longlive_interactive_inference.yaml

Runs on the GPU (``--device cuda``, the default); ``--device cpu`` runs the
plain PyTorch paths.  Without checkpoints the DiT and VAE are randomly
initialised and, without T5 assets, each prompt segment's embedding is
random.  With the T5, every segment of every row is encoded up front and
the T5's weights then move to the host's memory.  ``tiny_debug: true`` in
the config runs the tiny model and geometry (smoke runs).  With
``profile: true`` the one-shot recache loop runs and prints the switch
stall; otherwise the eager-recache production loop runs.

Several cards: ``torchrun --nproc_per_node N -m
longlive_torch.run_interactive ... --sp P`` as ``run_inference``: N / P
groups each serve their share of the rows (switches included, each group
on its own: no collective between groups), sequence-parallel over their P
cards; each group's rank 0 decodes and writes.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import torch

from .config import LatentGeometry, load_pipeline_config, tiny_dit_config, tiny_geometry
from .models import dit as D
from .models import vae as V
from .parallel import mesh as pm
from .pipeline import InteractiveCausalInferencePipeline
from .utils import loading
from .utils.dataset import MultiTextDataset, shard
from .utils.device import resolve_device
from .utils.video_io import to_video_array, write_video


def main(argv=None):
    """Returns one record per written video: {"path", "latents", "pixels",
    "decode_s"} (an sp rank that does not write: one per row, with its
    latents and None elsewhere)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config_path", required=True)
    ap.add_argument("--use_ema", action="store_true")
    ap.add_argument("--max_prompts", type=int, default=None)
    ap.add_argument("--num_output_frames", type=int, default=None)
    ap.add_argument("--sp", type=int, default=1,
                    help="sequence-parallel degree for the DiT")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    try:  # before any parameter is built; under torchrun, this rank's card
        mesh, device, group, groups, writes = pm.serving_ranks(args.sp,
                                                               resolve_device(args.device))
    except (RuntimeError, pm.LayoutError) as e:
        sys.exit(f"error: {e}")
    rank = pm.global_rank()

    config = load_pipeline_config(args.config_path)
    if args.num_output_frames:
        config = dataclasses.replace(config, num_output_frames=args.num_output_frames)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    use_ema = args.use_ema or config.use_ema
    if config.extras.get("tiny_debug"):
        # smoke runs: the tiny random-weight model and geometry, with the
        # config's window and block
        cfg = dataclasses.replace(tiny_dit_config(), local_attn_size=config.local_attn_size,
                                  sink_size=config.sink_size,
                                  num_frame_per_block=config.num_frame_per_block)
        geom = tiny_geometry()
        params = D.init_dit_params(cfg, dtype, device, seed=config.seed, zero_head=False)
        vcfg = V.tiny_vae_config()
        vae_params = V.init_vae_params(vcfg, dtype, device, seed=0)
    else:
        cfg = config.dit_config()
        geom = LatentGeometry()
        params = loading.load_dit_params(config, cfg, dtype, device, use_ema=use_ema)
        vae_params, vcfg = loading.load_vae_params(config, dtype, device)
    text_encoder = loading.load_text_encoder(config, dtype, device)

    pipe = InteractiveCausalInferencePipeline(config, params, geometry=geom, dit_config=cfg,
                                              device=device, mesh=mesh)
    switch_indices = list(config.switch_frame_indices)

    if config.data_path and os.path.exists(config.data_path) and text_encoder:
        rows = shard(MultiTextDataset(config.data_path), group, groups)
    else:
        rows = [{"prompts": ["(random)"] * (len(switch_indices) + 1), "idx": 0}]
    if args.max_prompts:
        rows = rows[: args.max_prompts]
    if config.inference_iter != -1:
        rows = rows[: config.inference_iter + 1]

    # every row's prompt segments up front, as the reference encodes them
    gen = torch.Generator(device=device).manual_seed(config.seed)
    all_conds = []
    for row in rows:
        if len(row["prompts"]) != len(switch_indices) + 1:
            raise ValueError(f"{len(row['prompts'])} prompt segments vs "
                             f"{len(switch_indices)} switches")
        if text_encoder is not None:
            all_conds.append([text_encoder([p])["prompt_embeds"] for p in row["prompts"]])
        else:
            all_conds.append([torch.randn((1, cfg.text_len, cfg.text_dim), generator=gen,
                                          device=device) for _ in row["prompts"]])
    if text_encoder is not None:
        text_encoder.offload()

    out_dir = config.output_folder or "videos/interactive"
    model_type = "lora" if config.lora_ckpt else "ema" if use_ema else "regular"
    results = []
    for row, conds in zip(rows, all_conds):
        cross_list = [pipe.prepare_condition(c) for c in conds]
        noise = torch.randn((1, config.num_output_frames, geom.channels, geom.height,
                             geom.width), generator=gen, device=device)
        if config.profile:
            latents = pipe.generate_latents_interactive(noise, cross_list, switch_indices,
                                                        generator=gen, profile=True)
        else:
            latents = pipe.generate_latents_interactive_scanned(noise, cross_list,
                                                                switch_indices, generator=gen)
        if mesh is not None:
            pm.check_replicated(latents, pipe.sp_group, "the latents")
        if not writes:  # an sp rank past its group's first: generation only
            results.append({"path": None, "latents": latents, "pixels": None,
                            "decode_s": None})
            continue
        t0 = time.perf_counter()
        pixels = V.vae_decode_scan(vae_params, vcfg, latents.to(dtype))[0]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        decode_s = time.perf_counter() - t0
        if config.profile:
            print(f"[profile] vae decode {decode_s / latents.shape[1] * 1e3:.2f} "
                  f"ms/latent-frame ({latents.shape[1]} latent frames)")
        if config.save_with_index:
            name = f"rank{rank}-{row['idx']}-0_{model_type}.mp4"
        else:  # the first segment's prompt names the video
            stem = row["prompts"][0][:100].replace(os.sep, "_")
            name = f"rank{rank}-{stem}-0.mp4"
        path = write_video(os.path.join(out_dir, name), to_video_array(pixels), fps=16)
        print(f"wrote {path}")
        results.append({"path": path, "latents": latents, "pixels": pixels,
                        "decode_s": decode_s})
    return results


if __name__ == "__main__":
    main()
