"""Device-time breakdown of the PyTorch/CUDA port's main path on one GPU.

Usage (from the repository root, on a host with an NVIDIA GPU):

    python scripts/torch_breakdown.py [--out build/torch_breakdown.json]

Full Wan2.1-1.3B width at 480x832 with random weights.  Runs blocks 0-3 of
generation unprofiled, then profiles block 4 (frames 12-14: full window,
ring wrapped) with ``torch.profiler``, then decodes latent frames 0-1 and
profiles the decode of frame 2.  Device kernel time is grouped into the
port's two kernels, matrix products, library convolutions and the rest; the
idle share is 1 - (summed kernel time / host wall time of the same step run
again without the profiler).
Prints one JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from longlive_torch.config import LatentGeometry, PipelineConfig  # noqa: E402
from longlive_torch.models import dit as D  # noqa: E402
from longlive_torch.models import vae as V  # noqa: E402
from longlive_torch.pipeline import CausalInferencePipeline  # noqa: E402

GROUPS = (
    ("flash_attention (K1)", ("flash_attention_kernel",)),
    ("fused_causal_conv (K2)", ("causal_conv_kernel",)),
    # cuDNN's conv kernels are named *_fprop_implicit_gemm_*: test before gemm
    ("library conv (cuDNN)", ("fprop", "conv", "cudnn", "winograd")),
    ("matmul (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
)


def _group(name: str) -> str:
    low = name.lower()
    for label, keys in GROUPS:
        if any(k in low for k in keys):
            return label
    return "other (elementwise, copies, reductions)"


def _wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _profile(fn):
    """(wall ms without the profiler, {group: device ms}, top kernels) of
    ``fn``: one profiled call, then one timed call without the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    wall = _wall_ms(fn)
    groups, kernels = {}, []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        kind = getattr(evt, "device_type", None)
        if not dev_us or (kind is not None and kind != torch.autograd.DeviceType.CUDA):
            continue  # host-side ops; their kernels are counted as device events
        ms = dev_us / 1e3
        groups[_group(evt.key)] = groups.get(_group(evt.key), 0.0) + ms
        kernels.append((ms, evt.count, evt.key[:90]))
    kernels.sort(reverse=True)
    return wall, groups, kernels[:8]


def _summary(label, wall, groups, kernels, per):
    busy = sum(groups.values())
    return {
        "step": label, "wall_ms": wall, "device_busy_ms": busy,
        "idle_share": (1 - busy / wall) if wall > 0 and busy > 0 else None,
        "per": per, "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"ms": m, "count": c, "name": n} for m, c, n in kernels],
    }


@torch.no_grad()
def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/torch_breakdown.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("error: needs a CUDA GPU")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    pc = PipelineConfig(local_attn_size=12, sink_size=3, num_frame_per_block=3,
                        num_output_frames=15)
    cfg = pc.dit_config()
    params = D.init_dit_params(cfg, torch.bfloat16, dev, seed=0)
    pipe = CausalInferencePipeline(pc, params, geometry=LatentGeometry(), dit_config=cfg,
                                   device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    cross = pipe.prepare_condition(torch.randn((1, cfg.text_len, cfg.text_dim),
                                               generator=g, device=dev))
    noise = torch.randn((1, 15, 16, 60, 104), generator=g, device=dev)
    cache = pipe.init_cache(1)
    outs = []
    for s in range(0, 12, 3):
        x0, cache = pipe._block_step(cache, cross, noise[:, s:s + 3], s, g)
        outs.append(x0)
    state = {}

    def block():
        state["x0"], state["cache"] = pipe._block_step(cache, cross, noise[:, 12:15], 12, g)

    dit = _summary("DiT block (frames 12-14: 4 denoise + 1 commit forward)",
                   *_profile(block), per="3 latent frames")
    lat = torch.cat(outs + [state["x0"]], dim=1).to(torch.bfloat16)

    vp = V.init_vae_params(V.VAEConfig(), torch.bfloat16, dev, seed=0)
    vcfg = V.VAEConfig()
    caches = V.init_decoder_caches(vcfg, 1, 60, 104, torch.bfloat16, dev)
    _, caches = V.vae_decode_chunk(vp, vcfg, lat[:, :1], caches, True)
    _, caches = V.vae_decode_chunk(vp, vcfg, lat[:, 1:2], caches, False)
    vae = _summary("VAE decode of latent frame 2",
                   *_profile(lambda: V.vae_decode_chunk(vp, vcfg, lat[:, 2:3], caches, False)),
                   per="1 latent frame")
    result = {"card": card, "torch": torch.__version__, "steps": [dit, vae]}
    text = json.dumps(result, indent=1)
    print(text)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text)


if __name__ == "__main__":
    main()
