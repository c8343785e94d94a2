"""Vanilla Wan2.1 bidirectional sampler CLI: text-to-video and
image-to-video with the UniPC / DPM++ solvers (50 steps by default).

Usage:
  python -m longlive_torch.run_t2v --prompt "..." [--image img.png]
      [--model_name Wan2.1-T2V-1.3B] [--size 832x480] [--frame_num 81]
      [--steps 50] [--solver unipc|dpm++] [--guide_scale 5.0] [--shift 5.0]
      [--negative_prompt "..."] [--seed 0] [--output out.mp4] [--device cuda]

Runs on the GPU (``--device cuda``, the default); ``--device cpu`` runs the
plain PyTorch paths.  Without checkpoints under ``wan_models/<model_name>/``
the DiT, VAE and CLIP are randomly initialised and, without T5 assets, the
prompt embedding is random (the negative prompt's is zero).
``--tiny_debug`` runs the tiny random-weight model (smoke runs).  The DiT
takes the Wan2.1-1.3B widths whatever ``--model_name`` says, as the JAX
package's CLI does.  ``--image`` switches to image-to-video.
``--offload_blocks`` (text-to-video) keeps the DiT's blocks in pinned host
memory, built there, and streams them to the card one layer ahead of their
compute: a model larger than the card; the same latents as the resident
run.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from .config import DiTConfig, PipelineConfig, tiny_dit_config
from .models import clip as C
from .models import dit as D
from .models import vae as V
from .pipeline.image2video import Image2VideoPipeline, encode_first_frame_condition
from .ops import solvers as SV
from .parallel import mesh as pm
from .pipeline.text2video import DEFAULT_NEGATIVE_PROMPT, Text2VideoPipeline, initial_noise
from .utils import loading
from .utils.device import resolve_device
from .utils.video_io import to_video_array, write_video


def _read_image(path: str) -> np.ndarray:
    """[H, W, 3] uint8 file -> [1, 3, H, W] float32 in [-1, 1]."""
    import imageio.v2 as imageio

    img = np.asarray(imageio.imread(path))
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    img = img[..., :3].astype(np.float32) / 255.0
    return (img * 2.0 - 1.0).transpose(2, 0, 1)[None]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompt", required=True)
    ap.add_argument("--image", default=None, help="first frame (switches to i2v)")
    ap.add_argument("--model_name", default="Wan2.1-T2V-1.3B")
    ap.add_argument("--size", default="832x480", help="WxH pixels")
    ap.add_argument("--frame_num", type=int, default=81, help="4n+1 pixel frames")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--solver", default="unipc", choices=["unipc", "dpm++"])
    ap.add_argument("--guide_scale", type=float, default=5.0)
    ap.add_argument("--shift", type=float, default=5.0)
    ap.add_argument("--negative_prompt", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--output", default="videos/t2v.mp4")
    ap.add_argument("--sp", type=int, default=1,
                    help="sequence-parallel degree over torchrun's ranks (t2v only)")
    ap.add_argument("--offload_blocks", action="store_true",
                    help="keep the DiT's blocks in host memory and stream them to the "
                         "device per layer (text-to-video)")
    ap.add_argument("--tiny_debug", action="store_true",
                    help="tiny random-weight model (smoke runs)")
    ap.add_argument("--device", default="cuda", help="torch device to run on (default cuda)")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(args: argparse.Namespace, image: Optional[np.ndarray] = None) -> dict:
    """The whole run on parsed arguments; ``image`` [1, 3, H, W] float32 in
    [-1, 1] (``_read_image``'s output) switches to image-to-video.  Returns
    {"path", "latents", "pixels", "condition_s" (the prompts' K/V and, for
    i2v, CLIP and the first-frame encode), "sample_s" (the solver's steps
    alone), "ms_per_step", "decode_s"}; on a rank that does not write
    (``--sp`` under torchrun: every rank but 0) "path", "pixels" and
    "decode_s" are None.  ``--sp P``: the sampler's forwards run
    sequence-parallel over P ranks (``parallel.sequence``); the world
    must be a multiple of P (each group renders the prompt; rank 0
    writes)."""
    i2v = image is not None
    if i2v and args.sp > 1:
        raise ValueError("--sp runs the text-to-video sampler only, as in the JAX package")
    mesh, device, _, _, writes = pm.serving_ranks(args.sp, resolve_device(args.device))
    writes = writes and pm.is_main_process()  # one prompt: rank 0 alone writes
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    w, h = (int(x) for x in args.size.split("x"))
    if i2v and args.offload_blocks:
        raise NotImplementedError("--offload_blocks streams the text-to-video sampler only, as "
                                  "in the JAX package")

    config = PipelineConfig(model_name=args.model_name, seed=args.seed)
    if args.tiny_debug:
        vcfg = V.tiny_vae_config()
        vae_params = V.init_vae_params(vcfg, dtype, device, seed=0)
    else:
        vae_params, vcfg = loading.load_vae_params(config, dtype, device)
    stride_t = 2 ** sum(vcfg.temperal_downsample)
    spatial = 2 ** (len(vcfg.dim_mult) - 1)
    if (args.frame_num - 1) % stride_t:
        raise ValueError(f"frame_num must be {stride_t}*n+1, got {args.frame_num}")
    lat_h, lat_w = h // spatial, w // spatial
    f_lat = (args.frame_num - 1) // stride_t + 1

    if args.tiny_debug:
        cfg = dataclasses.replace(tiny_dit_config(), local_attn_size=-1, sink_size=0,
                                  in_dim=vcfg.z_dim, out_dim=vcfg.z_dim)
        if i2v:
            ccfg = C.tiny_clip_vision_config()
            clip_params = C.init_clip_vision_params(ccfg, dtype, device, seed=2)
            cfg = dataclasses.replace(cfg, model_type="i2v", in_dim=2 * vcfg.z_dim + stride_t,
                                      clip_dim=ccfg.dim)
        params = D.init_dit_params(cfg, dtype, device, seed=args.seed, zero_head=False)
        text_encoder = None
    else:
        cfg = DiTConfig(local_attn_size=-1, sink_size=0)
        if i2v:
            clip_params, ccfg = loading.load_clip_vision(config, dtype, device)
            cfg = DiTConfig(local_attn_size=-1, sink_size=0, model_type="i2v",
                            in_dim=16 + stride_t + vcfg.z_dim)
        params = loading.load_base_dit(os.path.join("wan_models", args.model_name), cfg,
                                       dtype, device, seed=args.seed,
                                       on_host=args.offload_blocks)
        text_encoder = loading.load_text_encoder(config, dtype, device)

    neg = args.negative_prompt or DEFAULT_NEGATIVE_PROMPT
    if text_encoder is not None:
        cond = text_encoder([args.prompt])["prompt_embeds"]
        null = text_encoder([neg])["prompt_embeds"]
        text_encoder.offload()
    else:  # random-weight smoke mode (no downloaded assets)
        g1 = torch.Generator(device=device).manual_seed(1)
        cond = torch.randn((1, cfg.text_len, cfg.text_dim), generator=g1,
                           device=device).to(torch.bfloat16)
        null = torch.zeros_like(cond)

    sampling = dict(sampling_steps=args.steps, shift=args.shift, guide_scale=args.guide_scale,
                    solver=args.solver)
    _sync(device)
    t0 = time.perf_counter()
    if i2v:
        img = torch.as_tensor(image, dtype=torch.float32, device=device)
        if tuple(img.shape[-2:]) != (h, w):
            img = C.resize_bicubic(img, h, w)
        clip_fea = C.encode_image(clip_params, ccfg, img)
        y = encode_first_frame_condition(vae_params, vcfg, img.to(dtype), args.frame_num)
        pipe = Image2VideoPipeline(params, cfg, device=device)
        model_fn, coeffs = pipe.prepare_sampler(cond, null, clip_fea, y, **sampling)
    else:
        pipe = Text2VideoPipeline(params, cfg, device=device, offload_blocks=args.offload_blocks,
                                  mesh=mesh)
        del params  # with offload_blocks the pipeline holds the blocks on the host
        model_fn, coeffs = pipe.prepare_sampler(cond, null, **sampling)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    noise = initial_noise(None, gen, (1, f_lat, vcfg.z_dim, lat_h, lat_w), device)
    _sync(device)
    t1 = time.perf_counter()  # the steps alone from here
    with torch.no_grad():
        latents = SV.sample_flow(model_fn, noise.to(torch.bfloat16), coeffs)
    _sync(device)
    t2 = time.perf_counter()
    if mesh is not None:
        pm.check_replicated(latents, pipe.sp_group, "the latents")
    if not writes:  # generation only; rank 0 decodes and writes
        return {"path": None, "latents": latents, "pixels": None, "condition_s": t1 - t0,
                "sample_s": t2 - t1, "ms_per_step": (t2 - t1) / args.steps * 1e3,
                "decode_s": None}
    pixels = V.vae_decode(vae_params, vcfg, latents.to(dtype))
    _sync(device)
    t3 = time.perf_counter()
    path = write_video(args.output, to_video_array(pixels), fps=16)
    rec = {"path": path, "latents": latents, "pixels": pixels, "condition_s": t1 - t0,
           "sample_s": t2 - t1, "ms_per_step": (t2 - t1) / args.steps * 1e3,
           "decode_s": t3 - t2}
    print(f"wrote {path} ({args.frame_num} frames @ {w}x{h}, {'i2v' if i2v else 't2v'}, "
          f"{args.solver} {args.steps} steps: {rec['ms_per_step']:.1f} ms/step, decode "
          f"{rec['decode_s'] * 1e3:.1f} ms)")
    return rec


def main(argv=None):
    """Returns ``generate``'s record."""
    args = parse_args(argv)
    try:  # before any parameter is built
        resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"error: {e}")
    image = _read_image(args.image) if args.image is not None else None
    try:
        return generate(args, image)
    except pm.LayoutError as e:
        sys.exit(f"error: {e}")


if __name__ == "__main__":
    main()
