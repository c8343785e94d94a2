"""Device-time breakdown of the PyTorch/CUDA port's main path on one GPU.

Usage (from the repository root, on a host with an NVIDIA GPU):

    python scripts/torch_breakdown.py [--out build/torch_breakdown.json]

Full Wan2.1-1.3B width at 480x832 with random weights.  Runs blocks 0-3 of
generation unprofiled, then profiles block 4 (frames 12-14: full window,
ring wrapped) with ``torch.profiler``: the bf16 main config, then the
int8 serving mode (``configs/longlive_inference_tuned.yaml`` with
``kv_int8``, the block linears quantized by ``quantize_dit_params`` and
``LONGLIVE_INT8_FUSED=1``), then the serving options
(``configs/longlive_inference.yaml`` with ``kernel_cache: false`` under
``LONGLIVE_TWO_SEGMENT=1``, ``LONGLIVE_EXP2=1`` and
``LONGLIVE_MXU_LSUM=1``).  Then it decodes latent frames 0-1 and
profiles the decode of frame 2, three times: bf16, with the int8 convs
(``LONGLIVE_VAE_INT8=1``) and with the fused res blocks
(``LONGLIVE_VAE_PAIR=1``).  Then the two encoders: the VAE encoder's third
chunk (pixel frames 5-8 of a 480x832 clip, one latent frame) after chunks
0-1, and umT5-XXL's ``encode_prompts`` of one prompt of 512 ids (40
valid).  Then one step of ``run_t2v``'s text-to-video sampler at 832x480,
81 frames (the cond and uncond halves in one forward of batch 2), resident
and with ``--offload_blocks``.  Then
the training step of
``configs/longlive_train_init.yaml`` (21 frames, float32 parameters under
bf16 autocast): the generator's replay of the last rollout block (exit step
1: one pre-exit forward, the exit forward with its backward, the commit)
after six blocks unprofiled, and the critic's denoising loss with its
backward.  Then the streamed teacher: ``teacher_real_x0(streamed=True)`` at
Wan2.1-T2V-14B's width on 4 of its 40 layers (blocks in pinned host
memory, each copied to the card one layer ahead of its compute; cond and
uncond at 21 frames), with the compute stream's idle share (1 - the union
of its kernels' intervals over the profiled call's span) and the share of
the host-to-device copies' time that overlaps a kernel.  Device kernel time is grouped into the port's kernels, matrix
products, library convolutions and the rest ("other", whose largest
kernels are also listed on their own: ``other_top_kernels``); K2 (``fused_causal_conv``)
counts all its kernels, the input pass (norm + SiLU, the new cache) and the
conv, and for int8 the input pass, the quantize pass and the GEMM; K5
(``linear_int8_fused``) its quantize pass and its GEMM; K6
(``fused_res_block``) its launches of the shared input pass and GEMM, which
carry names of their own; the passes are also reported on their own
(``parts_ms``, ``parts_share_of_wall``).  The idle
share is 1 - (summed kernel time / host wall time of the same step run again
without the profiler).
Prints one JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from longlive_torch.config import (LatentGeometry, PipelineConfig,  # noqa: E402
                                   load_pipeline_config)
from longlive_torch.models import dit as D  # noqa: E402
from longlive_torch.models import t5 as T5  # noqa: E402
from longlive_torch.models import vae as V  # noqa: E402
from longlive_torch.pipeline import CausalInferencePipeline  # noqa: E402

GROUPS = (
    ("flash_attention (K1)", ("serving_attention_kernel",)),
    ("flash_attention_train (K4)", ("fwd_kernel", "bwd_dq_kernel", "bwd_dkdv_kernel")),
    # K6 runs K2's input pass and GEMM under names of its own: test it first
    ("fused_res_block (K6)", ("conv_input_kernel<6>", "biasnormsilu", "pairresidual")),
    ("fused_causal_conv (K2)", ("causal_conv_wgmma_kernel", "conv_input_kernel",
                                "causal_conv_int8_wgmma_kernel", "conv_int8_input_kernel",
                                "conv_int8_quantize_kernel")),
    ("flash_attention_frame_masked (K3)", ("frame_masked_kernel",)),
    ("linear_int8_fused (K5)", ("int8_linear_quantize_kernel", "int8_linear_gemm_kernel")),
    # cuDNN's conv kernels are named *_fprop_implicit_gemm_*: test before gemm
    ("library conv (cuDNN)", ("fprop", "conv", "cudnn", "winograd")),
    ("matmul (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
)


# kernels reported on their own as well as in their group: (label, key)
PARTS = (("K2's input pass", "conv_input_kernel<2>"),
         ("K2 int8's input pass", "conv_int8_input_kernel"),
         ("K2 int8's quantize pass", "conv_int8_quantize_kernel"),
         ("K2 int8's GEMM", "causal_conv_int8_wgmma_kernel"),
         ("K6's input and norm passes", "conv_input_kernel<6>"),
         ("K6's conv1 with norm2 in its epilogue", "biasnormsilu"),
         ("K5's quantize pass", "int8_linear_quantize_kernel"),
         ("K5's GEMM", "int8_linear_gemm_kernel"))


OTHER = "other (elementwise, copies, reductions)"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _group(name: str) -> str:
    low = name.lower()
    for label, keys in GROUPS:
        if any(k in low for k in keys):
            return label
    return OTHER


def _wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _profile(fn):
    """(wall ms without the profiler, {group: device ms}, top kernels,
    {part: device ms}, top kernels of the "other" group) of ``fn``: one
    profiled call, then one timed call without the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    wall = _wall_ms(fn)
    groups, kernels, parts = {}, [], {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        kind = getattr(evt, "device_type", None)
        if not dev_us or (kind is not None and kind != torch.autograd.DeviceType.CUDA):
            continue  # host-side ops; their kernels are counted as device events
        ms, group = dev_us / 1e3, _group(evt.key)
        groups[group] = groups.get(group, 0.0) + ms
        kernels.append((ms, evt.count, evt.key[:90], group))
        for label, key in PARTS:
            if key in evt.key.lower():
                parts[label] = parts.get(label, 0.0) + ms
    kernels.sort(reverse=True)
    other = [k for k in kernels if k[3] == OTHER]
    return wall, groups, kernels[:8], parts, other[:12]


def _summary(label, wall, groups, kernels, parts, other, per):
    busy = sum(groups.values())
    return {
        "step": label, "wall_ms": wall, "device_busy_ms": busy,
        "idle_share": (1 - busy / wall) if wall > 0 and busy > 0 else None,
        "per": per, "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "parts_ms": parts,
        "parts_share_of_wall": {k: v / wall for k, v in parts.items()} if wall > 0 else {},
        "top_kernels": [{"ms": m, "count": c, "name": n} for m, c, n, _ in kernels],
        "other_top_kernels": [{"ms": m, "count": c, "name": n} for m, c, n, _ in other],
    }


@contextlib.contextmanager
def _env(**env):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dit_block(dev, label: str, pc: PipelineConfig, int8: bool = False, env=None):
    """The profile of block 4 (frames 12-14) of ``pc`` after blocks 0-3;
    ``int8``: the block linears quantized; ``env``: switches set around
    the whole run.  Random bf16 weights from seed 0."""
    from longlive_torch.ops import quant as Q

    with _env(**(env or {})):
        cfg = pc.dit_config()
        params = D.init_dit_params(cfg, torch.bfloat16, dev, seed=0)
        if int8:
            params = Q.quantize_dit_params(params)
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

        row = _summary(label, *_profile(block), per="3 latent frames")
    return row, torch.cat(outs + [state["x0"]], dim=1)


def vae_frame(dev, vp, lat, label: str, env: dict):
    """The profile of the decode of latent frame 2 of ``lat`` after frames
    0-1, under ``env`` (the VAE switches not in it cleared)."""
    env = {"LONGLIVE_VAE_INT8": "0", "LONGLIVE_VAE_PAIR": "0", **env}
    vcfg = V.VAEConfig()
    with _env(**env):
        caches = V.init_decoder_caches(vcfg, 1, 60, 104, torch.bfloat16, dev)
        _, caches = V.vae_decode_chunk(vp, vcfg, lat[:, :1], caches, True)
        _, caches = V.vae_decode_chunk(vp, vcfg, lat[:, 1:2], caches, False)
        row = _summary(label, *_profile(
            lambda: V.vae_decode_chunk(vp, vcfg, lat[:, 2:3], caches, False)),
            per="1 latent frame")
    del caches
    torch.cuda.empty_cache()
    return row


@torch.no_grad()
def vae_encode_chunk(dev, vp, label: str):
    """The profile of the encoder on pixel frames 5-8 of a random 480x832
    clip after frames 0 and 1-4 (bf16 convs; the VAE switches cleared)."""
    vcfg = V.VAEConfig()
    with _env(LONGLIVE_VAE_INT8="0", LONGLIVE_VAE_PAIR="0"):
        g = torch.Generator(device=dev).manual_seed(1)
        x = (torch.rand((1, 9, 480, 832, 3), generator=g, device=dev) * 2 - 1).to(torch.bfloat16)
        caches = V.init_encoder_caches(vcfg, 1, 480, 832, torch.bfloat16, dev)
        _, caches = V.encoder_apply(vp["encoder"], vcfg, x[:, :1], caches, True)
        _, caches = V.encoder_apply(vp["encoder"], vcfg, x[:, 1:5], caches, False)
        row = _summary(label, *_profile(
            lambda: V.encoder_apply(vp["encoder"], vcfg, x[:, 5:9], caches, False)),
            per="1 latent frame (4 pixel frames)")
    del caches, x
    torch.cuda.empty_cache()
    return row


def t5_prompt(dev, label: str):
    """The profile of umT5-XXL's ``encode_prompts`` (random bf16 weights)
    on one prompt of 512 ids, 40 valid."""
    tcfg = T5.T5Config()
    params = T5.init_t5_params(tcfg, torch.bfloat16, dev, seed=0)
    g = torch.Generator(device=dev).manual_seed(2)
    mask = (torch.arange(tcfg.text_len, device=dev) < 40).long()[None]
    ids = torch.randint(1, tcfg.vocab_size, (1, tcfg.text_len), generator=g, device=dev) * mask
    T5.encode_prompts(params, tcfg, ids, mask)  # warm-up
    row = _summary(label, *_profile(lambda: T5.encode_prompts(params, tcfg, ids, mask)),
                   per="1 prompt")
    del params
    torch.cuda.empty_cache()
    return row


@torch.no_grad()
def sampler_step(dev, label: str, offload: bool = False):
    """The profile of one step of ``run_t2v``'s text-to-video sampler at
    832x480, 81 frames (21 latent frames, 32760 tokens a sample): one
    bidirectional forward of the cond and uncond halves in one batch of 2
    (``attn_impl="auto"``: K1 for the self- and cross-attentions), after
    one unprofiled step.  ``offload``: the blocks in pinned host memory,
    streamed per layer (``--offload_blocks``); the row adds the compute
    stream's idle share and the copies' overlap (``_intervals``)."""
    from longlive_torch.config import DiTConfig
    from longlive_torch.ops.rope import make_rope_tables
    from longlive_torch.pipeline.text2video import concat_cross, guided_sampler
    from longlive_torch.utils import memory

    cfg = DiTConfig(local_attn_size=-1, sink_size=0)
    params = D.init_dit_params(cfg, torch.bfloat16, dev, seed=0, zero_head=False)
    g = torch.Generator(device=dev).manual_seed(3)
    pe = torch.randn((1, cfg.text_len, cfg.text_dim), generator=g, device=dev)
    both = concat_cross(D.prepare_cross_kv(params, cfg, pe),
                        D.prepare_cross_kv(params, cfg, torch.zeros_like(pe)))
    if offload:
        params = memory.blocks_to_host(params, dev)
    tables = make_rope_tables(cfg.head_dim, cfg.rope_max_pos, device=dev)
    fn = guided_sampler(params, cfg, tables, 5.0, both, streamed=offload)
    x = torch.randn((1, 21, 16, 60, 104), generator=g, device=dev).to(torch.bfloat16)
    fn(x, 999.0)  # warm-up
    row = _summary(label, *_profile(lambda: fn(x, 937.0)), per="1 sampler step (B 2)")
    row.update(_intervals(lambda: fn(x, 937.0)))
    del params, both
    torch.cuda.empty_cache()
    return row


def _intervals(fn) -> dict:
    """The compute stream's busy and idle share and the host-to-device
    copies' overlap with kernels, from one more profiled call of ``fn``."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    busy, span, copy_ms, overlap = _intervals_ms(prof)
    return {"compute_busy_ms": busy, "compute_span_ms": span,
            "compute_idle_share": (1 - busy / span) if span else None,
            "h2d_copy_ms": copy_ms, "h2d_overlapped_share": (overlap / copy_ms) if copy_ms else None}


def _intervals_ms(prof):
    """(union ms of the device kernels' intervals, span ms from the first
    kernel's start to the last's end, host-to-device copy ms, the ms of
    those copies that overlap a kernel) from a profile's events."""
    kernels, copies = [], []
    for e in prof.events():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        iv = (e.time_range.start, e.time_range.end)
        name = e.name.lower()
        if "memcpy htod" in name:
            copies.append(iv)
        elif "memcpy" not in name and "memset" not in name:
            kernels.append(iv)
    kernels.sort()
    merged = []
    for a, b in kernels:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    span = (merged[-1][1] - merged[0][0]) if merged else 0
    overlap = sum(max(0, min(b, mb) - max(a, ma)) for a, b in copies for ma, mb in merged)
    return busy / 1e3, span / 1e3, sum(b - a for a, b in copies) / 1e3, overlap / 1e3


def streamed_teacher(dev, label: str):
    """The profile of one streamed teacher pass at the 14B's width on 4
    layers (``teacher_real_x0(streamed=True)`` under the trainer's
    autocast), after one unprofiled pass; adds the compute stream's idle
    share and the host-to-device copies' overlap with kernels."""
    from longlive_torch.config import WAN_MODEL_CONFIGS, DiTConfig
    from longlive_torch.ops import scheduler as S
    from longlive_torch.ops.rope import make_rope_tables
    from longlive_torch.training import dmd
    from longlive_torch.utils import loading, memory

    cfg = dataclasses.replace(DiTConfig(), **dict(WAN_MODEL_CONFIGS["Wan2.1-T2V-14B"],
                                                  num_layers=4))
    host = loading.load_base_dit("wan_models/none", cfg, torch.float32, dev, seed=7,
                                 on_host=True)
    tree = memory.blocks_to_host(host, dev)
    geom = LatentGeometry()
    sched = S.make_schedule(1000, shift=5.0, sigma_min=0.0, extra_one_step=True, training=True)
    tables = make_rope_tables(cfg.head_dim, cfg.rope_max_pos, device=dev)
    g = torch.Generator().manual_seed(21)
    lat = torch.randn((1, 21, geom.channels, geom.height, geom.width), generator=g).to(dev)
    pc, pu = (torch.randn((1, cfg.text_len, cfg.text_dim), generator=g).to(dev) for _ in range(2))
    st, sn = torch.tensor([600]), torch.randn(lat.shape, generator=g)

    def run():
        with torch.autocast(dev.type, dtype=torch.bfloat16, cache_enabled=False):
            dmd.teacher_real_x0(tree, cfg, tables, sched, dmd.DMDConfig(), lat, pc, pu, st, sn,
                                streamed=True)

    run()  # warm-up
    row = _summary(label, *_profile(run), per="1 teacher pass over 4 layers (B 2)")
    row.update(_intervals(run), layer_gib=memory.hbm_bytes(host["blocks"][0]) / 2 ** 30)
    del host, tree
    torch.cuda.empty_cache()
    return row


def _config(name: str, **changes) -> PipelineConfig:
    pc = load_pipeline_config(os.path.join(ROOT, "configs", name))
    return dataclasses.replace(pc, num_output_frames=15, **changes)


def training_steps(dev, cfg=None, geom=None, profile=None):
    """Profiles of one replayed rollout block with backward and of the
    critic loss with backward, at the training config's size (the 1.3B
    and 480x832 unless ``cfg``/``geom`` say otherwise)."""
    from longlive_torch.config import DiTConfig
    from longlive_torch.training import dmd as DMD
    from longlive_torch.training import rollout as RO
    from longlive_torch.training.trainer import ScoreDistillationTrainer, TrainerConfig

    cfg, geom, profile = cfg or DiTConfig(), geom or LatentGeometry(), profile or _profile
    gen = D.init_dit_params(cfg, torch.float32, dev, seed=0, zero_head=False)
    critic = D.init_dit_params(cfg, torch.float32, dev, seed=2, zero_head=False)
    tr = ScoreDistillationTrainer(TrainerConfig(), cfg, geom, gen, critic, {}, device=dev)
    g = torch.Generator().manual_seed(0)
    frame = (cfg.in_dim, geom.height, geom.width)
    noise = torch.randn((1, 21) + frame, generator=g).to(dev)
    draws = torch.randn((7, 2, 1, 3) + frame, generator=g).to(dev)
    prompt = torch.randn((1, cfg.text_len, cfg.text_dim), generator=g).to(dev)
    cc = tr.cache_cfg
    with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=dev.type == "cuda",
                        cache_enabled=False):
        with torch.no_grad():
            cross = D.prepare_cross_kv(gen, cfg, prompt, torch.float32)
        leaf = D.CrossKV(cross.k.detach().requires_grad_(), cross.v.detach().requires_grad_())
        cache = None
        with torch.no_grad():
            _, cache = RO.rollout_trajectory(gen, cfg, cc, tr.tables, tr.sched, tr.rcfg,
                                             noise[:, :18], leaf, draws[:6], 1,
                                             cache_dtype=tr.cache_dtype)
        base_k, base_v = cache.k.clone(), cache.v.clone()
        cot = torch.randn((1, 3) + frame, generator=g).to(dev)

        def replay():
            cache.k.copy_(base_k)
            cache.v.copy_(base_v)
            RO.rollout_block(gen, cfg, cc, tr.tables, tr.sched, tr.rcfg, leaf, noise[:, 18:],
                             cache, draws[6], 18, 1, cotangent=cot)

        block = _summary("training: replay of rollout block 6 (exit 1) with backward",
                         *profile(replay), per="3 latent frames")
        del base_k, base_v, cache
        lat = torch.randn((1, 21) + frame, generator=g).to(dev)
        st = torch.randint(0, 1000, (1,), generator=g)
        sn = torch.randn((1, 21) + frame, generator=g)

        def critic_step():
            loss, _ = DMD.critic_denoising_loss(critic, lat, cfg, tr.tables, tr.sched, tr.dcfg,
                                                prompt, st, sn)
            loss.backward()

        crit = _summary("training: critic denoising loss with backward (21 frames)",
                        *profile(critic_step), per="one critic update's gradient")
    return [block, crit]


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
    dit, lat = dit_block(dev, "DiT block (frames 12-14: 4 denoise + 1 commit forward)", pc)
    lat = lat.to(torch.bfloat16)
    torch.cuda.empty_cache()
    int8, _ = dit_block(dev, "DiT block, int8 serving (tuned config, kv_int8, int8 linears, "
                        "LONGLIVE_INT8_FUSED=1)", _config("longlive_inference_tuned.yaml",
                                                          kv_int8=True),
                        int8=True, env={"LONGLIVE_INT8_FUSED": "1"})
    for part in ("K5's quantize pass", "K5's GEMM"):  # a renamed kernel would read 0
        if not int8["parts_ms"].get(part):
            sys.exit(f"error: no {part} in the int8 serving block's profile")
    torch.cuda.empty_cache()
    options, _ = dit_block(dev, "DiT block, serving options (kernel_cache off, two-segment, "
                           "exp2, mxu_lsum)", _config("longlive_inference.yaml",
                                                      kernel_cache=False),
                           env={"LONGLIVE_TWO_SEGMENT": "1", "LONGLIVE_EXP2": "1",
                                "LONGLIVE_MXU_LSUM": "1"})
    torch.cuda.empty_cache()

    vp = V.init_vae_params(V.VAEConfig(), torch.bfloat16, dev, seed=0)
    vae = [vae_frame(dev, vp, lat, "VAE decode of latent frame 2", {}),
           vae_frame(dev, vp, lat, "VAE decode of latent frame 2, int8 convs "
                     "(LONGLIVE_VAE_INT8=1)", {"LONGLIVE_VAE_INT8": "1"}),
           vae_frame(dev, vp, lat, "VAE decode of latent frame 2, fused res blocks "
                     "(LONGLIVE_VAE_PAIR=1)", {"LONGLIVE_VAE_PAIR": "1"})]
    encoders = [vae_encode_chunk(dev, vp, "VAE encode of pixel frames 5-8 (one latent frame)"),
                t5_prompt(dev, "umT5-XXL encode_prompts, one prompt of 512 ids (40 valid)")]
    del vp, lat
    torch.cuda.empty_cache()
    sampler = sampler_step(dev, "run_t2v sampler step, 832x480 x 81 frames (cond + uncond)")
    offload = sampler_step(dev, "run_t2v sampler step, --offload_blocks (blocks streamed from "
                           "the host)", offload=True)
    with torch.enable_grad():
        train = training_steps(dev)
    torch.cuda.empty_cache()
    teacher = streamed_teacher(dev, "streamed 14B-width teacher pass, 4 of 40 layers "
                               "(cond + uncond, 21 frames)")
    result = {"card": card, "torch": torch.__version__,
              "steps": [dit, int8, options] + vae + encoders + [sampler, offload] + train + [teacher]}
    text = json.dumps(result, indent=1)
    print(text)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text)


if __name__ == "__main__":
    main()
