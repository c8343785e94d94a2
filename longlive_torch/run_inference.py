"""Single-prompt generation CLI.

Usage:  python -m longlive_torch.run_inference --config_path configs/longlive_inference.yaml

Runs on the GPU (``--device cuda``, the default); ``--device cpu`` runs the
plain PyTorch paths.  Without checkpoints the DiT and VAE are randomly
initialised and, without T5 assets, the prompt embedding is random.  With
the T5, every prompt is encoded up front and the T5's weights then move to
the host's memory before generation.  ``tiny_debug: true`` in the config
runs the tiny model and geometry (smoke runs).

``--decode_device i`` renders through ``pipeline.PipelinedRenderer`` in
``--segment_frames`` segments: on another card the VAE decode of each
segment overlaps the next segment's generation; on the generation card (or
with ``--device cpu``, where only index 0 is accepted) the two run serially,
as JAX's renderer runs on its generation chip.  On a card each of
``num_samples`` streams decodes alone, as the serial path decodes, and the
pixels are that path's; ``--per_stream_decode`` asks for that form on the
CPU too.

Several cards: ``torchrun --nproc_per_node N -m longlive_torch.run_inference
... --sp P`` runs N / P groups of P ranks; each group renders its share of
the prompt rows (round robin), its DiT sequence-parallel over its P cards
(``parallel.decode_sp``), and only the group's rank 0 decodes and writes,
with its rank in the file name.  ``--sp`` must divide N; sp refuses
``kv_int8`` and ``kernel_cache: true``.
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
from .pipeline import CausalInferencePipeline, PipelinedRenderer
from .utils import loading
from .utils.dataset import TextDataset, shard
from .utils.device import resolve_device
from .utils.video_io import to_video_array, write_video


def main(argv=None):
    """Returns one record per written video: {"path", "latents", "pixels",
    "decode_s", "render_s"}: ``render_s`` is the wall time of generation and
    decode; pipelined (``--decode_device``), "latents" and "decode_s" are
    None.  An sp rank that does not write returns one record per row with
    its latents and None elsewhere."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config_path", required=True)
    ap.add_argument("--use_ema", action="store_true")
    ap.add_argument("--max_prompts", type=int, default=None)
    ap.add_argument("--num_output_frames", type=int, default=None)
    ap.add_argument("--sp", type=int, default=1,
                    help="sequence-parallel degree for the DiT")
    ap.add_argument("--decode_device", type=int, default=None,
                    help="CUDA device index for the VAE: on another card the decode "
                         "of segment n overlaps the generation of segment n + 1, on the "
                         "generation card they run serially; with --device cpu only 0 "
                         "(the CPU) is accepted")
    ap.add_argument("--segment_frames", type=int, default=12,
                    help="latent frames per pipelined segment")
    ap.add_argument("--per_stream_decode", action="store_true",
                    help="batched serving: decode each stream separately (a decode "
                         "on a card always does)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    try:  # before any parameter is built; under torchrun, this rank's card
        mesh, device, group, groups, writes = pm.serving_ranks(args.sp,
                                                               resolve_device(args.device))
    except (RuntimeError, pm.LayoutError) as e:
        sys.exit(f"error: {e}")
    rank = pm.global_rank()
    if args.decode_device is not None:
        n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
        if not 0 <= args.decode_device < n_dev:
            where = (f"this host has {n_dev} CUDA device(s)" if device.type == "cuda"
                     else "with --device cpu the decode runs on the CPU, index 0")
            sys.exit(f"error: --decode_device {args.decode_device}: {where}")

    config = load_pipeline_config(args.config_path)
    fpb = config.num_frame_per_block
    if args.decode_device is not None and (args.segment_frames <= 0
                                           or args.segment_frames % fpb):
        raise ValueError(f"--segment_frames {args.segment_frames} must be a positive multiple "
                         f"of the frame block {fpb}")
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

    pipe = CausalInferencePipeline(config, params, geometry=geom, dit_config=cfg,
                                   device=device, mesh=mesh)
    renderer = None
    if args.decode_device is not None:
        renderer = PipelinedRenderer(
            pipe, vae_params, vcfg, segment_frames=args.segment_frames,
            decode_device=args.decode_device if device.type == "cuda" else device,
            per_stream_decode=args.per_stream_decode)

    if config.data_path and os.path.exists(config.data_path) and text_encoder:
        rows = shard(TextDataset(config.data_path), group, groups)
    else:
        rows = [{"prompts": "(random prompt embedding)", "idx": 0}]
    if args.max_prompts:
        rows = rows[: args.max_prompts]
    if config.inference_iter != -1:
        rows = rows[: config.inference_iter + 1]

    gen = torch.Generator(device=device).manual_seed(config.seed)
    if text_encoder is not None:
        conds = [text_encoder([row["prompts"]])["prompt_embeds"] for row in rows]
        text_encoder.offload()
    else:
        conds = [torch.randn((1, cfg.text_len, cfg.text_dim), generator=gen, device=device)
                 for _ in rows]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out_dir = config.output_folder or "videos/long"
    model_type = "lora" if config.lora_ckpt else "ema" if use_ema else "regular"
    ns = max(1, config.num_samples)
    results = []
    for row, cond in zip(rows, conds):
        cross = pipe.prepare_condition(cond.repeat(ns, 1, 1) if ns > 1 else cond)
        noise = torch.randn((ns, config.num_output_frames, geom.channels, geom.height,
                             geom.width), generator=gen, device=device)
        sync()
        t_render = time.perf_counter()
        latents = decode_s = None
        if renderer is not None:
            pixels = renderer.render(noise, cross, generator=gen, dtype=dtype)
            sync()
            if pixels is not None and pixels.device != device:  # decoded on another card
                torch.cuda.synchronize(pixels.device)
        else:
            latents = pipe.generate_latents(noise, cross, generator=gen,
                                            profile=config.profile)
            if mesh is not None:
                pm.check_replicated(latents, pipe.sp_group, "the latents")
            if writes:
                t0 = time.perf_counter()
                pixels = torch.cat([V.vae_decode_scan(vae_params, vcfg,
                                                      latents[i:i + 1].to(dtype))[0]
                                    for i in range(ns)], dim=0)
                sync()
                decode_s = time.perf_counter() - t0
        render_s = time.perf_counter() - t_render
        if not writes:  # an sp rank past its group's first: generation only
            results.append({"path": None, "pixels": None, "latents": latents,
                            "decode_s": None, "render_s": render_s})
            continue
        if config.profile and latents is not None:
            print(f"[profile] vae decode {decode_s / latents.shape[1] * 1e3:.2f} "
                  f"ms/latent-frame ({latents.shape[1]} latent frames)")
        for seed_idx in range(ns):
            if config.save_with_index:
                name = f"rank{rank}-{row['idx']}-{seed_idx}_{model_type}.mp4"
            else:
                stem = row["prompts"][:100].replace(os.sep, "_")
                name = f"rank{rank}-{stem}-{seed_idx}.mp4"
            path = write_video(os.path.join(out_dir, name),
                               to_video_array(pixels[seed_idx:seed_idx + 1]), fps=16)
            print(f"wrote {path}")
            results.append({"path": path, "pixels": pixels[seed_idx:seed_idx + 1],
                            "latents": None if latents is None
                            else latents[seed_idx:seed_idx + 1],
                            "decode_s": decode_s, "render_s": render_s})
    return results


if __name__ == "__main__":
    main()
