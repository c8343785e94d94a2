#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``longlive_torch``).

Usage, from the root of a checkout on a host with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:

1. card identity (``nvidia-smi`` name and power limit);
2. build of every CUDA kernel of the main path from ``longlive_torch/csrc``;
3. kernel checks at the main path's shapes: each kernel against its plain
   PyTorch version on the same inputs, with times of the kernel, the plain
   version, the least time the card could take, and one PyTorch library
   call computing the same function (timed here only, never used by the
   port);
4. a small-input reference: the port on the GPU (bf16, kernels) against the
   port on the CPU (float32, plain versions);
5. the main path: ``longlive_torch.run_inference`` on
   ``configs/longlive_inference.yaml`` for 15 latent frames (5 blocks, the
   ring wraps) at full Wan2.1-1.3B width with random weights, then VAE
   decode and the video file; every kernel's launch count over that run is
   checked against the count derived from the model structure.

The last lines are the ``kernels`` JSON line, the card line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bandwidth


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"chip_smoke: {msg}", flush=True)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls after one
    warm-up call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# Agreement of a kernel with its plain version: both round their bf16
# outputs once but sum in another order (K1: tiled online softmax with P
# rounded against the running max; K2: taps, and per-pixel norms that may
# round an input 1 ulp apart).  Limits scale with the output itself:
# max |out - ref| <= max |ref| / 64 (a few bf16 ulps of the largest value)
# and ||out - ref|| / ||ref|| <= 1e-2.
REL_RMS_LIMIT = 1e-2


def agreement(out, ref):
    """(max_abs_err, its tolerance, relative RMS error) of out vs ref."""
    o, r = out.float(), ref.float()
    err = (o - r).abs().max().item()
    rel = ((o - r).norm() / r.norm().clamp_min(1e-30)).item()
    return err, r.abs().max().item() / 64, rel


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        fail(f"nvidia-smi: {e}")
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi exited {r.returncode}: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernel checks


def check_attention(torch, A):
    """K1 at the decode shape: q = one 3-frame block (4680 tokens, 12 heads
    of 128), K/V = one layer of the 12-frame cache (18720 tokens) read in
    place from a 2-layer stacked cache."""
    import torch.nn.functional as F

    b, n, d, fs = 1, 12, 128, 1560
    sq, s = 3 * fs, 12 * fs
    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn((b, sq, n, d), generator=g, device="cuda").to(torch.bfloat16)
    kc = torch.randn((2, b, n, s, d), generator=g, device="cuda").to(torch.bfloat16)
    vc = torch.randn((2, b, n, s, d), generator=g, device="cuda").to(torch.bfloat16)
    k, v = kc[1].view(b * n, s, d), vc[1].view(b * n, s, d)
    flops = 4.0 * b * n * sq * s * d
    nbytes = 2 * q.numel() * 2 + 2 * k.numel() * 2 + b * s * 4
    cases = []
    for label, frames in (("warm-up: sink + block valid", 6), ("full window", 12)):
        valid = torch.arange(s, device="cuda") < frames * fs
        bias = torch.where(valid, 0.0, A.NEG_INF).float()[None].contiguous()
        out = A.flash_attention(q, k, v, bias)
        ref = A.flash_attention_plain(q, k, v, bias)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            fail(f"flash_attention ({label}): non-finite output")
        err, tol, rel = agreement(out, ref)
        mask4 = bias.to(torch.bfloat16)[:, None, None, :]
        qt, kt, vt = q.transpose(1, 2), k.view(b, n, s, d), v.view(b, n, s, d)
        ms = cuda_ms(torch, lambda: A.flash_attention(q, k, v, bias), 10)
        plain_ms = cuda_ms(torch, lambda: A.flash_attention_plain(q, k, v, bias), 3)
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask4), 10)
        log(f"flash_attention {label}: max_abs_err={err:.3e} tol={tol:.3e} "
            f"rel_rms_err={rel:.3e} (limit {REL_RMS_LIMIT:.0e}) "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f}")
        if not (err <= tol and rel <= REL_RMS_LIMIT):
            fail(f"flash_attention ({label}) disagrees with its plain version: "
                 f"max_abs_err {err} (limit {tol}), rel_rms_err {rel} "
                 f"(limit {REL_RMS_LIMIT})")
        cases.append({"case": label, "q": [b, sq, n, d], "kv": [b * n, s, d],
                      "max_abs_err": err, "tolerance": tol, "rel_rms_err": rel, "ms": ms,
                      "plain_ms": plain_ms, "library_ms": lib_ms})
    t_bound, bound_by = bound(flops, nbytes)
    full = cases[-1]
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "longlive_torch/csrc/flash_attention.cu",
        "replaces": "longlive_tpu/ops/attention.py:63",
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "tolerance": min(c["tolerance"] for c in cases),
        "rel_rms_err": max(c["rel_rms_err"] for c in cases),
        "rel_rms_limit": REL_RMS_LIMIT,
        "ms": full["ms"], "kernel_ms": full["ms"], "plain_ms": full["plain_ms"],
        "bound_ms": t_bound, "bound_by": bound_by, "library_ms": full["library_ms"],
        "unit": "one call at the decode shape (full window)", "cases": cases,
    }


# The 30 fused convs of one later latent frame of the Wan2.1 decoder at
# 480x832: (label, T, H, W, C, O, kernel rows/cols, norm, residual, count).
CONV_CASES = [
    ("res conv1 384@60x104", 1, 60, 104, 384, 384, 3, True, False, 5),
    ("res conv2 384@60x104", 1, 60, 104, 384, 384, 3, True, True, 5),
    ("time conv 384->768@60x104", 1, 60, 104, 384, 768, 1, False, False, 1),
    ("shortcut-block conv1 192->384@120x208", 2, 120, 208, 192, 384, 3, True, False, 1),
    ("res conv1 384@120x208", 2, 120, 208, 384, 384, 3, True, False, 2),
    ("res conv2 384@120x208", 2, 120, 208, 384, 384, 3, True, True, 3),
    ("time conv 384->768@120x208", 2, 120, 208, 384, 768, 1, False, False, 1),
    ("res conv1 192@240x416", 4, 240, 416, 192, 192, 3, True, False, 3),
    ("res conv2 192@240x416", 4, 240, 416, 192, 192, 3, True, True, 3),
    ("res conv1 96@480x832", 4, 480, 832, 96, 96, 3, True, False, 3),
    ("res conv2 96@480x832", 4, 480, 832, 96, 96, 3, True, True, 3),
]


def check_conv(torch, VC):
    """K2 at every fused-conv shape of one later latent frame; the headline
    numbers are sums over the 30 convs of that frame."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(2)
    bf = torch.bfloat16
    cases = []
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flops": 0.0, "bytes": 0.0}
    assert sum(c[-1] for c in CONV_CASES) == 30
    for label, t, h, w, c, o, k, norm, res, count in CONV_CASES:
        x = torch.randn((t, h, w, c), generator=g, device="cuda").to(bf)
        cache = torch.randn((2, h, w, c), generator=g, device="cuda").to(bf)
        std = 1.0 / math.sqrt(c * 3 * k * k)
        wt = ((torch.rand((o, c, 3, k, k), generator=g, device="cuda") * 2 - 1) * std).to(bf)
        bias = (torch.rand((o,), generator=g, device="cuda") * 2 - 1) * std
        gamma = (1.0 + 0.1 * torch.randn((c,), generator=g, device="cuda")) if norm else None
        resid = torch.randn((t, h, w, o), generator=g, device="cuda").to(bf) if res else None
        wp = VC.pack_weights(wt)  # packed once, as the VAE's parameters are
        out, nx = VC.fused_causal_conv(x, cache, wt, bias, gamma, resid, w_packed=wp)
        ref, ref_nx = VC.fused_causal_conv_plain(x, cache, wt, bias, gamma, resid)
        torch.cuda.synchronize()
        if not (torch.isfinite(out).all() and torch.isfinite(nx).all()):
            fail(f"fused_causal_conv ({label}): non-finite output")
        err, tol, rel = agreement(out, ref)
        err_nx, tol_nx, rel_nx = agreement(nx, ref_nx)
        if not (err_nx <= tol_nx and rel_nx <= REL_RMS_LIMIT):
            fail(f"fused_causal_conv ({label}) new cache disagrees with its plain "
                 f"version: max_abs_err {err_nx} (limit {tol_nx}), rel_rms_err "
                 f"{rel_nx} (limit {REL_RMS_LIMIT})")
        xin = VC.norm_silu(x, gamma) if norm else x
        full = torch.cat([cache, xin], 0).permute(3, 0, 1, 2)[None].contiguous()
        wb, bb = wt, bias.to(bf)
        ms = cuda_ms(torch, lambda: VC.fused_causal_conv(
            x, cache, wt, bias, gamma, resid, w_packed=wp), 5)
        plain_ms = cuda_ms(torch, lambda: VC.fused_causal_conv_plain(
            x, cache, wt, bias, gamma, resid), 3)
        lib_ms = cuda_ms(torch, lambda: F.conv3d(full, wb, bb, padding=(0, k // 2, k // 2)), 5)
        flops = 2.0 * t * h * w * o * c * 3 * k * k
        nbytes = 2 * (x.numel() + cache.numel() + wt.numel() + t * h * w * o + 2 * h * w * c
                      + (resid.numel() if res else 0)) + 4 * (o + (c if norm else 0))
        t_bound, bound_by = bound(flops, nbytes)
        log(f"fused_causal_conv {label} x{count}: max_abs_err={err:.3e} tol={tol:.3e} "
            f"rel_rms_err={rel:.3e} (new cache {err_nx:.3e} / {tol_nx:.3e}, "
            f"{rel_nx:.3e}) ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={t_bound:.4f} ({bound_by})")
        if not (err <= tol and rel <= REL_RMS_LIMIT):
            fail(f"fused_causal_conv ({label}) disagrees with its plain version: "
                 f"max_abs_err {err} (limit {tol}), rel_rms_err {rel} "
                 f"(limit {REL_RMS_LIMIT})")
        cases.append({"case": label, "count": count, "max_abs_err": max(err, err_nx),
                      "tolerance": min(tol, tol_nx), "rel_rms_err": max(rel, rel_nx),
                      "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": t_bound, "bound_by": bound_by})
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("flops", flops), ("bytes", nbytes)):
            tot[key] += count * val
        del x, cache, wt, wp, resid, out, nx, ref, ref_nx, full
        torch.cuda.empty_cache()
    t_bound, bound_by = bound(tot["flops"], tot["bytes"])
    return {
        "name": "fused_causal_conv", "route": "cuda",
        "source": "longlive_torch/csrc/causal_conv.cu",
        "replaces": "longlive_tpu/ops/vae_conv.py:78",
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "tolerance": min(c["tolerance"] for c in cases),
        "rel_rms_err": max(c["rel_rms_err"] for c in cases),
        "rel_rms_limit": REL_RMS_LIMIT,
        "ms": tot["ms"], "kernel_ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": t_bound, "bound_by": bound_by, "library_ms": tot["library_ms"],
        "unit": "sum over the 30 fused convs of one later latent frame", "cases": cases,
    }


# ---------------------------------------------------------------------------
# phase 4: small-input reference (GPU kernels vs CPU plain versions)


def rel_err(a, b) -> float:
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return ((a - b).norm() / b.norm().clamp_min(1e-12)).item()


def check_small_reference(torch):
    import dataclasses

    from longlive_torch.config import DiTConfig, LatentGeometry, PipelineConfig
    from longlive_torch.models import dit as D
    from longlive_torch.models import vae as V
    from longlive_torch.pipeline import CausalInferencePipeline

    # head_dim 128 (the kernel's); 10x12 latents -> 30 tokens per frame,
    # a 120-token cache: ragged q and KV tiles
    cfg = DiTConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=2, in_dim=16, out_dim=16,
                    text_dim=64, text_len=16, freq_dim=64, local_attn_size=4, sink_size=1,
                    num_frame_per_block=1, rope_max_pos=64)
    geom = LatentGeometry(height=10, width=12)
    pc = PipelineConfig(num_frame_per_block=1, local_attn_size=4, sink_size=1,
                        num_output_frames=6)
    params32 = D.init_dit_params(cfg, torch.float32, "cpu", seed=3, zero_head=False)

    def to_dev(tree, dev, dt):
        if isinstance(tree, dict):
            return {k: to_dev(v, dev, dt) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_dev(v, dev, dt) for v in tree]
        return None if tree is None else tree.to(dev, dt)

    g = torch.Generator().manual_seed(4)
    pe = torch.randn((1, cfg.text_len, cfg.text_dim), generator=g)
    noise = torch.randn((1, 6, 16, geom.height, geom.width), generator=g)
    lat = {}
    for dev, dt in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
        pipe = CausalInferencePipeline(pc, to_dev(params32, dev, dt), geometry=geom,
                                       dit_config=cfg, device=dev, deterministic_renoise=True)
        lat[dev] = pipe.generate_latents(noise, pipe.prepare_condition(pe))
    e_dit = rel_err(lat["cuda"], lat["cpu"])

    vcfg = dataclasses.replace(V.tiny_vae_config(), dim=96, z_dim=16)  # widths 192/96: fused
    vp32 = V.init_vae_params(vcfg, torch.float32, "cpu", seed=5)
    z = lat["cpu"][:, :3]
    px_cpu = V.vae_decode(vp32, vcfg, z)
    px_gpu = V.vae_decode(to_dev(vp32, "cuda", torch.bfloat16), vcfg, z.to("cuda", torch.bfloat16))
    e_vae = rel_err(px_gpu, px_cpu)
    log(f"small reference: DiT latents rel_err={e_dit:.3e}, VAE pixels rel_err={e_vae:.3e} "
        "(GPU bf16 kernels vs CPU float32 plain; limit 5e-2)")
    if not (torch.isfinite(lat["cuda"]).all() and torch.isfinite(px_gpu).all()):
        fail("small reference: non-finite GPU output")
    if not (e_dit <= 5e-2 and e_vae <= 5e-2):
        fail(f"small reference disagrees: DiT {e_dit}, VAE {e_vae} (limit 5e-2)")


# ---------------------------------------------------------------------------
# phase 5: main path


def run_main_path(torch, A, VC):
    from longlive_torch import run_inference
    from longlive_torch.config import load_pipeline_config
    from longlive_torch.models.vae import VAEConfig

    cfg_path = os.path.join(ROOT, "configs", "longlive_inference.yaml")
    frames = 15
    pc = load_pipeline_config(cfg_path)
    dcfg, vcfg = pc.dit_config(), VAEConfig()
    blocks = frames // pc.num_frame_per_block
    # per block: every layer attends in each denoise forward; the commit
    # forward's last layer only writes K/V
    want_attn = blocks * (dcfg.num_layers * len(pc.denoising_step_list) + dcfg.num_layers - 1)
    # per latent frame: both convs of every res block; later frames also
    # run one time conv per temporal upsample
    n_res = 2 + len(vcfg.dim_mult) * (vcfg.num_res_blocks + 1)
    n_time = sum(vcfg.temperal_upsample[: len(vcfg.dim_mult) - 1])
    want_conv = 2 * n_res + (frames - 1) * (2 * n_res + n_time)

    torch.cuda.reset_peak_memory_stats()
    A.launches = 0
    VC.launches = 0
    t0 = time.perf_counter()
    results = run_inference.main(["--config_path", cfg_path, "--num_output_frames",
                                  str(frames), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got_attn, got_conv = A.launches, VC.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"main path: {wall:.1f} s wall, peak device memory {peak:.2f} GiB, "
        f"launches flash_attention={got_attn} (want {want_attn}), "
        f"fused_causal_conv={got_conv} (want {want_conv})")
    if len(results) != 1:
        fail(f"main path wrote {len(results)} videos, expected 1")
    r = results[0]
    lat, px = r["latents"], r["pixels"]
    want_px = (1, 1 + 4 * (frames - 1), 3, 480, 832)
    if tuple(lat.shape) != (1, frames, 16, 60, 104) or tuple(px.shape) != want_px:
        fail(f"main path shapes: latents {tuple(lat.shape)}, pixels {tuple(px.shape)}")
    if not (torch.isfinite(lat).all() and torch.isfinite(px).all()):
        fail("main path produced non-finite latents or pixels")
    if not os.path.exists(r["path"]) or os.path.getsize(r["path"]) == 0:
        fail(f"main path output {r['path']} missing")
    if got_attn != want_attn or got_conv != want_conv:
        fail(f"launch counts: flash_attention {got_attn} != {want_attn} or "
             f"fused_causal_conv {got_conv} != {want_conv}")
    log(f"main path decode: {r['decode_s'] / frames * 1e3:.2f} ms/latent-frame; "
        f"output {r['path']} ({os.path.getsize(r['path'])} bytes)")
    return got_attn, got_conv


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"torch: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    try:
        from longlive_torch.ops import attention as A
        from longlive_torch.ops import kernels
        from longlive_torch.ops import vae_conv as VC
    except ImportError as e:
        fail(f"the longlive_torch package is not beside this script: {e}")

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in true float32
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    try:
        logs = kernels.build_all()
    except RuntimeError as e:
        fail(f"kernel build: {e}")
    for name, text in logs.items():
        lines = [ln for ln in text.splitlines() if "registers" in ln or "spill" in ln]
        log(f"built {name}: " + " | ".join(ln.strip() for ln in lines))
    log(f"build: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    entries = [check_attention(torch, A), check_conv(torch, VC)]
    log(f"kernel checks: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    check_small_reference(torch)
    log(f"small reference: {time.perf_counter() - t0:.1f} s")

    got_attn, got_conv = run_main_path(torch, A, VC)
    entries[0]["launches"], entries[1]["launches"] = got_attn, got_conv
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
