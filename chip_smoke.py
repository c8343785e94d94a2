#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``longlive_torch``).

Usage, from the root of a checkout on a host with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:

1. card identity (``nvidia-smi`` name and power limit);
2. build of every CUDA kernel of the paths below from ``longlive_torch/csrc``;
3. kernel checks at the paths' shapes: each kernel (K1 in its bias, q_rope,
   qk_int8 and two-segment modes, under the exp2 + mxu_lsum switches, as
   the cross-attention and at B = 2, its int8 q quantize bit-equal to the
   plain pass, K2 bf16 and int8 at the decoder's and the encoder's shapes
   (the int8 pre-pass's operand bit-equal to its plain version), K6, K5, K3 under its three mask
   kinds at the full forwards' shapes, elided bit-equal to unelided, K4's
   forward and its two backward kernels at the four training shapes and at
   the streaming rollout's wrapped ring and its forward at the 14B
   teacher's B 2, 40-head shapes, K1 bias at the streaming recache's
   32760 over 32760, K2 at the one-frame decode's and encode's shapes, K1
   at the bidirectional samplers' B = 2 shapes: 32760 over 32760 and the
   image cross-attention's 32760 over 257, K1 at the shapes one rank of an
   sp group of 2 or 4 sees: the sp decode, 4680 over 18720 at 6 and 3
   heads, and the sp sampler's self-attention, B 2, 32760 over 32760 at 6
   and 3 heads)
   against its plain PyTorch version on the same
   inputs, with times of the kernel, the plain version, the least time the
   card could take, and one PyTorch library call computing the same
   function (timed here only, never used by the port);
4. a small-input reference: the port on the GPU (bf16, kernels) against the
   port on the CPU (float32, plain versions), for single-prompt, fused-rope,
   one-shot-recache, eager-recache and reactive generation, the quantized
   serving mode (int8 linears, int8 K cache, int8 recache, int8 VAE convs),
   the serving options (two-segment decode, exp2, mxu_lsum, the fused res
   block), the full-sequence forwards (teacher forcing, and a sink-window
   ``FrameMaskSpec``; once more under ``LONGLIVE_CROSS_FLASH=1``), the two
   encoders (umT5 ``encode_prompts``, and ``vae_encode`` at widths where K2
   takes the res-block convs), one training step, one streaming step
   with LoRA adapters (bf16 on the GPU, float32 on the CPU; a switch with
   its recache and a re-encoded overlap frame), the bidirectional
   samplers (text-to-video under UniPC, image-to-video under DPM++ with
   its CLIP features and first-frame encode), two training steps with
   the single-card levers (host AdamW with its background critic update,
   the paged and streamed teacher, the page-out; the int8 rollout cache
   with 2-step accumulation), and ``PipelinedRenderer.render`` (segments
   of 2 frames, the decode on the renderer's stream, an unscheduled switch
   polled at the second segment);
5. the paths, at full Wan2.1-1.3B width with random weights, each with
   every kernel's launch count checked against the count derived from the
   model structure:
   a. main: ``run_inference`` on ``configs/longlive_inference.yaml`` for 15
      latent frames (5 blocks, the ring wraps), VAE decode and the video;
   h. pipelined: the same with ``--decode_device 0 --segment_frames 6``
      (``PipelinedRenderer``: segments of 6, 6 and 3, each decoded on the
      renderer's CUDA stream while the next generates), its pixels
      bit-equal to main's; each stream's ms per latent frame (CUDA events)
      and the wall beside main's serial generate + decode;
   j. eval: ``run_eval`` on the video h wrote, then ``evaluate_video`` with a
      full-width CLIP ViT-H/14 on the card (its features held against the
      CPU's), every score finite and in [0, 1];
   i. per-stream decode: ``num_samples: 2``, 6 frames, ``--segment_frames 3
      --per_stream_decode``: bit-equal to a B = 1 decode of each stream, and
      within 5e-2 of one batched B = 2 decode (plain convs: K2 takes batch
      1); the two decodes' peaks;
   b. tuned: ``run_inference`` on ``configs/longlive_inference_tuned.yaml``
      (window 9, fused q RoPE) for 15 frames;
   c. reactive: an unscheduled switch on the tuned config at frame 9 (a
      6-frame replay);
   d. interactive: ``run_interactive`` (one-shot recache) on
      ``configs/longlive_interactive_inference.yaml`` cut to 27 frames with
      switches at 12 and 18, then the eager-recache loop on the same inputs;
   e. int8 serving: the tuned config with ``kv_int8: true``, the DiT's
      block linears quantized (``quantize_dit_params``),
      ``LONGLIVE_INT8_FUSED=1`` and ``LONGLIVE_VAE_INT8=1``: 15 frames with
      a reactive switch at frame 9, run cold and warm, then the VAE decode;
   f. int8 recache: ``run_interactive`` on the interactive config with
      ``recache_attn_impl: pallas_qk8`` (bf16 cache), 18 frames, one switch
      at 12;
   s. serving options: ``run_inference`` on a copy of
      ``configs/longlive_inference.yaml`` with ``kernel_cache: false`` and
      ``LONGLIVE_TWO_SEGMENT=1``, ``LONGLIVE_EXP2=1``,
      ``LONGLIVE_MXU_LSUM=1``, ``LONGLIVE_VAE_PAIR=1`` (set for this path
      only), 15 latent frames, VAE decode and the video;
   t. full forwards: ``dit_forward_teacher_forcing`` over the 21 frames of
      ``configs/longlive_train_init.yaml`` (65520 tokens), then
      ``dit_forward_full`` under a sink-window ``FrameMaskSpec`` (32760
      tokens), then the teacher-forcing forward again under
      ``LONGLIVE_CROSS_FLASH=1``, non-zero heads, K3 launched once per
      layer (and K1 as the cross-attention once per layer in the last);
   u. text encoder: umT5-XXL at full width in bf16, ``encode_prompts`` on
      1 and 2 prompts of 512 ids; ``run_inference`` with it (the prompt
      encoded, the T5 moved to the host, 6 frames conditioned on it, with
      decode); then the streamed encode from the pinned host weights, equal
      to the resident one with a peak below 3 GiB;
   v. VAE encode: the full Wan VAE encoder on one 480x832 frame, then 17
      frames (5 latent frames), K2 launched 20 times per chunk;
   w. checkpoint load: synthetic full-width generator, rank-256 LoRA and
      Wan VAE files in the reference's key layout, loaded bit-equal to a
      direct conversion, then ``run_inference`` on them (the main path's
      launches);
   g. training: ``run_train`` on ``configs/longlive_train_init.yaml`` (21
      frames, generator, critic and teacher all 1.3B) for 2 steps, K4's
      forward and backward launches checked; then one step of the same
      trainer on models with non-zero heads (``run_train``'s random init
      gives the teacher and critic zero heads, which zeroes the generator's
      gradient and stops the critic's at its head), with non-zero gradients
      reaching the first layer of the generator and of the critic;
   x. streaming: ``run_train`` on ``configs/longlive_train_long.yaml``
      (streaming long tuning, rank-256 LoRA on the generator and the
      critic) cut to ``streaming_max_length`` 60 and ``switch_choices``
      [21], 3 steps: the chunk state (a prompt switch with the 21-frame
      recache on step 0, a new sequence on step 2), K4, K1 (the recache) and
      K2 (the re-encodes) launches, the phase split, the peak; then one
      streaming step on models with non-zero heads, with non-zero
      gradients reaching layer 0's ``lora_b`` of both models;
   y. t2v: ``run_t2v.main`` (the vanilla Wan2.1 sampler) at 832x480, 81
      frames (21 latent frames, 32760 tokens a sample), UniPC for
      SAMPLER_STEPS steps with the cond and uncond halves in one batch,
      then the decode and the video;
   z. i2v: ``run_t2v.generate`` with a seeded 720x1280 image: the i2v DiT,
      a full-width CLIP ViT-H/14, the 81-frame first-frame encode, DPM++
      for SAMPLER_STEPS steps, the decode and the video;
   l. (run right after phase 3, while the host's memory is free) the
      streamed teacher at Wan2.1-T2V-14B's width on 4 of its layers,
      bit-equal to the resident pass, both timed;
   m. (likewise) 14B teacher: ``run_train`` on
      ``configs/longlive_train_init.yaml`` with ``real_name:
      Wan2.1-T2V-14B`` streamed from pinned host memory,
      ``page_generator``, ``cache_int8`` and 2-step accumulation, 2
      micro-steps on non-zero heads (the host's memory checked first, and
      its least during the run printed);
   n. host optimiser: the streaming path's config and cut with
      ``opt_on_host`` and ``opt_async``, 3 steps;
   o. t2v offload: ``run_t2v --offload_blocks``, 2 steps and the decode,
      its latents bit-equal to a resident run's;
   p. multi-device at one rank: a one-rank NCCL group, over which the
      main config's 15 frames run through ``sp_dit_forward_cached`` (the
      pipeline with a mesh) against the single path with ``kernel_cache:
      false``, and one t2v sampler step through ``sp_bidirectional_forward``
      against ``bidirectional_forward`` (the same weights with non-zero
      heads, noise and draws): bit-equal, or within 5e-2 with the reason
      logged; each sp run's K1 launches checked.

The last lines are the ``kernels`` JSON line, the card line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import subprocess
import sys
import time
from typing import Optional

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_INT8_OPS = 1979e12   # H100 SXM dense int8 tensor-core peak
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bandwidth
UPDATE_LIMIT = 0.25       # GPU-vs-CPU parameter change of one small training step


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


def device_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls queued behind a sleep
    kernel after one warm-up call: the host enqueues every call before the
    first starts, so a call whose host work outlasts its kernels is timed
    by its kernels alone (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(reps * 500_000)  # ~0.25 ms of the card's clock per call
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


def bound(flops: float, nbytes: float, int8_ops: float = 0.0):
    """(least ms, "operations" or "bytes"): bf16 operations at the bf16 peak
    plus int8 operations at the int8 peak, against the bytes at HBM rate."""
    t_ops = (flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
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


class _Tee(io.TextIOBase):
    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, text):
        self.buf.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def run_captured(fn):
    """(fn(), what it printed); the output is shown as it is printed."""
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        result = fn()
    return result, tee.buf.getvalue()


def profile_number(text: str, pattern: str, what: str) -> float:
    """A number from a ``[profile]`` line of the pipelines."""
    m = re.search(pattern, text)
    if m is None:
        fail(f"{what}: no match for {pattern!r} in the [profile] output")
    return float(m.group(1))


SWITCHES = ("LONGLIVE_TWO_SEGMENT", "LONGLIVE_EXP2", "LONGLIVE_MXU_LSUM", "LONGLIVE_VAE_PAIR")


@contextlib.contextmanager
def switched(**env):
    """Environment switches set for the body only, restored after it."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def reset_counts(A, VC) -> None:
    from longlive_torch.ops import quant as Q

    A.reset_launches()
    VC.reset_launches()
    Q.reset_launches()


def counts(A, VC) -> dict:
    """Serving launches: K1 by mode and by switch, K3 by mask kind, K2 by
    mode, K6, K5, and the calls of the int8 linears' separate-quantize route
    (fc2, outside K5's shape rule)."""
    from longlive_torch.ops import quant as Q

    return {"flash_attention": dict(A.mode_launches),
            "flash_attention_switches": dict(A.flag_launches),
            "flash_attention_frame_masked": dict(A.masked_launches),
            "fused_causal_conv": dict(VC.mode_launches), "fused_res_block": VC.pair_launches,
            "int8_linear": Q.launches, "linear_int8_route": Q.linear_int8_calls}


def expect(bias=0, q_rope=0, qk_int8=0, two_segment=0, cross=0, exp2=0, mxu_lsum=0,
           block_causal=0, sink_window=0, teacher_forcing=0, conv=0, conv_int8=0, pair=0, k5=0,
           route=0) -> dict:
    """A full set of expected counts (``counts``' keys), zero by default."""
    return {"flash_attention": {"bias": bias, "q_rope": q_rope, "qk_int8": qk_int8,
                                "two_segment": two_segment, "cross": cross},
            "flash_attention_switches": {"exp2": exp2, "mxu_lsum": mxu_lsum},
            "flash_attention_frame_masked": {"block_causal": block_causal,
                                             "sink_window": sink_window,
                                             "teacher_forcing": teacher_forcing},
            "fused_causal_conv": {"bf16": conv, "int8": conv_int8}, "fused_res_block": pair,
            "int8_linear": k5, "linear_int8_route": route}


def check_counts(label: str, got: dict, expected: dict) -> None:
    log(f"{label}: launches {json.dumps(got)} (want {json.dumps(expected)})")
    for name, w in expected.items():
        if got[name] != w:
            fail(f"{label}: launch count of {name} {got[name]} != {w}")


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
        cases.append({"case": label, "mode": "bias", "q": [b, sq, n, d], "kv": [b * n, s, d],
                      "max_abs_err": err, "tolerance": tol, "rel_rms_err": rel, "ms": ms,
                      "plain_ms": plain_ms, "library_ms": lib_ms})
    t_bound, bound_by = bound(flops, nbytes)
    full = cases[-1]
    return {
        "name": "flash_attention", "route": "cuda", "mode": "bias",
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


# K1 at the shapes the new paths give it: (label, mode, query frames, cache
# frames, valid frames: a count from slot 0, or the valid slots).  Tuned
# config: 9-frame cache (sink 3 + ring 6); its reactive replay attends the
# sink and the 6 replayed slots.  The interactive one-shot recache replays
# 12 frames over the 12-frame cache.  The streaming trainer's recache
# replays 21 frames over the 21-frame training cache and attends the sink
# and the last 9 replay slots (window 12).  The bias case at the tuned
# shape is no path's; it sets the q_rope prologue's cost beside the same
# work without it.
ATTN_CASES = [
    ("q_rope tuned decode: 3-frame block over the 9-frame cache", "q_rope", 3, 9, 9),
    ("bias at the tuned decode shape (q pre-roped; the prologue's cost)", "bias", 3, 9, 9),
    ("q_rope tuned reactive replay: 6 frames over the 9-frame cache", "q_rope", 6, 9, 6),
    ("bias interactive recache: 12 frames over the 12-frame cache", "bias", 12, 12, 12),
    ("bias streaming recache: 21 frames over the 21-frame training cache", "bias", 21, 21,
     (0, 1, 2) + tuple(range(12, 21))),
]


def _attention_entry(name: str, mode: str, cases: list, head: dict, unit: str) -> dict:
    return {
        "name": name, "route": "cuda", "mode": mode,
        "source": "longlive_torch/csrc/flash_attention.cu",
        "replaces": "longlive_tpu/ops/attention.py:63",
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "tolerance": min(c["tolerance"] for c in cases),
        "rel_rms_err": max(c["rel_rms_err"] for c in cases),
        "rel_rms_limit": REL_RMS_LIMIT,
        "ms": head["ms"], "kernel_ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "unit": unit, "cases": cases,
    }


def check_attention_cases(torch, A, entry):
    """Adds the ATTN_CASES: the bias cases to K1's bias entry; returns the
    q_rope entry (headline: the tuned decode).  q_rope cases: cos/sin are
    the DiT's rope multipliers for the block; ``library_ms`` is
    ``scaled_dot_product_attention`` on q roped beforehand (no single
    PyTorch call applies the rotation and attends, so the rope pass is
    excluded from it).  Each bound counts the valid KV tokens only."""
    import torch.nn.functional as F

    from longlive_torch.ops.rope import make_rope_tables, rope_multipliers

    b, n, d, fs = 1, 12, 128, 1560
    tables = make_rope_tables(d, 1024, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(6)
    rope_cases = []
    for label, mode, qf, kf, vf in ATTN_CASES:
        sq, s = qf * fs, kf * fs
        q = torch.randn((b, sq, n, d), generator=g, device="cuda").to(torch.bfloat16)
        k = torch.randn((b * n, s, d), generator=g, device="cuda").to(torch.bfloat16)
        v = torch.randn((b * n, s, d), generator=g, device="cuda").to(torch.bfloat16)
        slots = torch.arange(s, device="cuda") // fs
        valid = (slots < vf) if isinstance(vf, int) else torch.isin(
            slots, torch.tensor(vf, device="cuda"))
        nvalid = vf if isinstance(vf, int) else len(vf)
        bias = torch.where(valid, 0.0, A.NEG_INF).float()[None].contiguous()
        rope = rope_multipliers(tables, qf, 30, 52, start_frame=24) if mode == "q_rope" else None
        out = A.flash_attention(q, k, v, bias, q_rope=rope)
        ref = A.flash_attention_plain(q, k, v, bias, q_rope=rope)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            fail(f"flash_attention ({label}): non-finite output")
        err, tol, rel = agreement(out, ref)
        del ref
        qr = q if rope is None else A.rope_scaled_q(q, rope[0], rope[1], 1.0)
        qt, kt, vt = qr.transpose(1, 2), k.view(b, n, s, d), v.view(b, n, s, d)
        mask4 = bias.to(torch.bfloat16)[:, None, None, :]
        ms = cuda_ms(torch, lambda: A.flash_attention(q, k, v, bias, q_rope=rope), 10)
        plain_ms = cuda_ms(torch, lambda: A.flash_attention_plain(q, k, v, bias, q_rope=rope), 2)
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask4), 10)
        t_bound, bound_by = bound(4.0 * b * n * sq * nvalid * fs * d,
                                  2 * q.numel() * 2 + 2 * k.numel() * 2 + b * s * 4)
        log(f"flash_attention {label}: max_abs_err={err:.3e} tol={tol:.3e} "
            f"rel_rms_err={rel:.3e} (limit {REL_RMS_LIMIT:.0e}) ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={t_bound:.4f} "
            f"({bound_by}; {t_bound / ms:.1%} of bound)")
        if not (err <= tol and rel <= REL_RMS_LIMIT):
            fail(f"flash_attention ({label}) disagrees with its plain version: "
                 f"max_abs_err {err} (limit {tol}), rel_rms_err {rel} "
                 f"(limit {REL_RMS_LIMIT})")
        case = {"case": label, "mode": mode, "q": [b, sq, n, d], "kv": [b * n, s, d],
                "valid_tokens": nvalid * fs, "max_abs_err": err, "tolerance": tol,
                "rel_rms_err": rel, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": t_bound, "bound_by": bound_by}
        if mode == "q_rope":
            rope_cases.append(case)
        else:
            entry["cases"].append(case)
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            entry["tolerance"] = min(entry["tolerance"], tol)
            entry["rel_rms_err"] = max(entry["rel_rms_err"], rel)
        del q, k, v, out, qr, qt, kt, vt
        torch.cuda.empty_cache()
    return _attention_entry("flash_attention_q_rope", "q_rope", rope_cases, rope_cases[0],
                            "one call at the tuned decode shape (3 frames over 9)")


# K1's qk_int8 mode at the int8 paths' shapes: (label, query frames, cache
# frames, K stored int8 with its scales).  The int8 K cache of the tuned
# config (9 frames); the 12-frame one-shot recache of the interactive
# config with K quantized per call (pallas_qk8 on a bf16 cache).
INT8_ATTN_CASES = [
    ("qk_int8 decode, stored K scales: 3-frame block over the 9-frame int8 cache", 3, 9, True),
    ("qk_int8 recache (pallas_qk8): 12 frames over the 12-frame bf16 cache", 12, 12, False),
]


def check_attention_int8(torch, A):
    """K1's qk_int8 mode against its plain version.  ``library_ms`` is
    ``scaled_dot_product_attention`` on bf16 q, K (dequantized where it is
    stored int8) and V: no PyTorch call attends with int8 QK^T.  The bound
    counts QK^T at the int8 rate and PV at the bf16 rate; the bytes are q
    and the output in bf16, K as the call reads it (int8 and its float32
    scales, or bf16), V in bf16 and the bias."""
    import torch.nn.functional as F

    b, n, d, fs = 1, 12, 128, 1560
    g = torch.Generator(device="cuda").manual_seed(12)
    cases = []
    for label, qf, kf, stored in INT8_ATTN_CASES:
        sq, s = qf * fs, kf * fs
        q = torch.randn((b, sq, n, d), generator=g, device="cuda").to(torch.bfloat16)
        kb = torch.randn((b * n, s, d), generator=g, device="cuda").to(torch.bfloat16)
        v = torch.randn((b * n, s, d), generator=g, device="cuda").to(torch.bfloat16)
        bias = torch.zeros((b, s), dtype=torch.float32, device="cuda")
        k, ksc = A.quantize_k_tokens(kb) if stored else (kb, None)
        out = A.flash_attention(q, k, v, bias, qk_int8=True, k_scales=ksc)
        ref = A.flash_attention_plain(q, k, v, bias, qk_int8=True, k_scales=ksc)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            fail(f"flash_attention ({label}): non-finite output")
        err, tol, rel = agreement(out, ref)
        del ref
        kd = A.dequantize_k(k, ksc, torch.bfloat16) if stored else kb
        qt, kt, vt = q.transpose(1, 2), kd.view(b, n, s, d), v.view(b, n, s, d)
        ms = cuda_ms(torch, lambda: A.flash_attention(q, k, v, bias, qk_int8=True,
                                                      k_scales=ksc), 10)
        plain_ms = cuda_ms(torch, lambda: A.flash_attention_plain(q, k, v, bias, qk_int8=True,
                                                                  k_scales=ksc), 2)
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), 10)
        work = 2.0 * b * n * sq * s * d
        k_bytes = k.numel() * (1 if stored else 2) + (ksc.numel() * 4 if stored else 0)
        t_bound, bound_by = bound(work, 2 * q.numel() * 2 + k_bytes + v.numel() * 2 + b * s * 4,
                                  int8_ops=work)
        log(f"flash_attention {label}: max_abs_err={err:.3e} tol={tol:.3e} "
            f"rel_rms_err={rel:.3e} (limit {REL_RMS_LIMIT:.0e}) ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={t_bound:.4f} "
            f"({bound_by}; {t_bound / ms:.1%} of bound)")
        if not (err <= tol and rel <= REL_RMS_LIMIT):
            fail(f"flash_attention ({label}) disagrees with its plain version: "
                 f"max_abs_err {err} (limit {tol}), rel_rms_err {rel} "
                 f"(limit {REL_RMS_LIMIT})")
        cases.append({"case": label, "mode": "qk_int8", "q": [b, sq, n, d],
                      "kv": [b * n, s, d], "k_stored_int8": stored, "max_abs_err": err,
                      "tolerance": tol, "rel_rms_err": rel, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms, "bound_ms": t_bound, "bound_by": bound_by})
        del q, k, kb, kd, v, out, qt, kt, vt
        torch.cuda.empty_cache()
    return _attention_entry("flash_attention_qk_int8", "qk_int8", cases, cases[0],
                            "one call at the int8 decode shape (3 frames over the 9-frame "
                            "int8 cache)")


# K1's two-segment mode at the serving-options decode: a 3-frame block (4680
# queries, 12 heads of 128) over one layer of the 12-frame cache (sink 3 +
# ring 9) in which the block's own 3 slots are masked and elided, ++ the
# block's fresh K/V as segment 2.  (label, the block's cache slots, valid
# cache frames): the steady state after the ring wrapped, a block's first
# forward, where no cache token is valid and the softmax state must come out
# of segment 2 alone, and slots whose last 128-token kernel tile is half
# dead (its live 64-token half computed, the bias masking the rest).
TWO_SEG_CASES = [
    ("two-segment decode: block at ring slots 3-5, 9 cache frames valid", (3, 4, 5), 9),
    ("two-segment first block: block at the sink slots, no cache token valid", (0, 1, 2), 0),
    ("two-segment decode: block at ring slots 5-7, a 128-token tile half dead", (5, 6, 7), 9),
]


def _two_segment_inputs(torch, A, g, slots, valid_frames):
    """(q, k, v, k2, v2, bias, skip_ranges, SDPA operands, valid tokens,
    bytes the call must read and write)."""
    b, n, d, fs, frames = 1, 12, 128, 1560, 12
    sq, s = 3 * fs, frames * fs
    bf = torch.bfloat16
    q, k2, v2 = (torch.randn((b, sq, n, d), generator=g, device="cuda").to(bf) for _ in range(3))
    k, v = (torch.randn((b * n, s, d), generator=g, device="cuda").to(bf) for _ in range(2))
    fvalid = [bool(valid_frames) and f not in slots for f in range(frames)]
    assert sum(fvalid) == valid_frames
    valid = torch.tensor(fvalid, device="cuda").repeat_interleave(fs)
    bias = torch.where(valid, 0.0, A.NEG_INF).float()[None].contiguous()
    skip = [(f * fs, (f + 1) * fs) for f in slots]
    kt = torch.cat([k.view(b, n, s, d), k2.transpose(1, 2)], dim=2)
    vt = torch.cat([v.view(b, n, s, d), v2.transpose(1, 2)], dim=2)
    mask = torch.cat([valid, torch.ones(sq, dtype=torch.bool, device="cuda")])[None, None, None]
    nvalid = int(valid.sum()) + sq
    live = s - len(slots) * fs  # cache tokens the kernel reads
    nbytes = 2 * 2 * q.numel() + 2 * 2 * (live + sq) * b * n * d + 4 * b * s
    return q, k, v, k2, v2, bias, skip, (q.transpose(1, 2), kt, vt, mask), nvalid, nbytes


def check_attention_two_segment(torch, A):
    """K1's two-segment mode (switches off) against its plain version at
    the serving-options decode.  ``library_ms`` is
    ``scaled_dot_product_attention`` over [cache ++ block] concatenated
    beforehand, with the mask; ``no_skip_ms`` the same kernel call without
    ``skip_ranges`` (the block's dead slots computed and masked).  The
    bound counts the valid KV tokens (14040 of the cache + the block's
    4680) and the bytes of the tiles read."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(14)
    cases = []
    with switched(LONGLIVE_EXP2="0", LONGLIVE_MXU_LSUM="0"):
        for label, slots, vf in TWO_SEG_CASES:
            q, k, v, k2, v2, bias, skip, lib, nvalid, nbytes = _two_segment_inputs(
                torch, A, g, slots, vf)
            call = lambda sk=skip: A.flash_attention(q, k, v, bias, k2=k2, v2=v2,  # noqa: E731
                                                     skip_ranges=sk)
            out = call()
            ref = A.flash_attention_plain(q, k, v, bias, k2=k2, v2=v2, skip_ranges=skip)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                fail(f"flash_attention ({label}): non-finite output")
            err, tol, rel = agreement(out, ref)
            del ref
            ms = cuda_ms(torch, call, 10)
            no_skip_ms = cuda_ms(torch, lambda: call(None), 10)
            plain_ms = cuda_ms(torch, lambda: A.flash_attention_plain(
                q, k, v, bias, k2=k2, v2=v2, skip_ranges=skip), 2)
            lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                lib[0], lib[1], lib[2], attn_mask=lib[3]), 10)
            t_bound, bound_by = bound(4.0 * 12 * q.shape[1] * nvalid * 128, nbytes)
            log(f"flash_attention {label}: max_abs_err={err:.3e} tol={tol:.3e} "
                f"rel_rms_err={rel:.3e} (limit {REL_RMS_LIMIT:.0e}) ms={ms:.4f} "
                f"no_skip_ms={no_skip_ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                f"bound_ms={t_bound:.4f} ({bound_by}; {t_bound / ms:.1%} of bound)")
            if not (err <= tol and rel <= REL_RMS_LIMIT):
                fail(f"flash_attention ({label}) disagrees with its plain version: "
                     f"max_abs_err {err} (limit {tol}), rel_rms_err {rel} "
                     f"(limit {REL_RMS_LIMIT})")
            cases.append({"case": label, "mode": "two_segment", "q": list(q.shape),
                          "kv": list(k.shape), "kv2": list(k2.shape), "valid_tokens": nvalid,
                          "max_abs_err": err, "tolerance": tol, "rel_rms_err": rel, "ms": ms,
                          "no_skip_ms": no_skip_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                          "bound_ms": t_bound, "bound_by": bound_by})
            del q, k, v, k2, v2, out, lib
            torch.cuda.empty_cache()
    return _attention_entry("flash_attention_two_segment", "two_segment", cases, cases[0],
                            "one call at the serving-options decode (3 frames over the "
                            "12-frame cache, the block's slots elided, ++ the block)")


# LONGLIVE_EXP2=1 + LONGLIVE_MXU_LSUM=1 (and each alone at the path's call)
# in every K1 mode, at the paths' decode shapes: (label, mode, exp2, mxu_lsum)
SWITCH_CASES = [
    ("exp2 + mxu_lsum, two-segment decode (the serving-options call)", "two_segment", 1, 1),
    ("exp2 only, two-segment decode", "two_segment", 1, 0),
    ("mxu_lsum only, two-segment decode", "two_segment", 0, 1),
    ("exp2 + mxu_lsum, bias decode: 3 frames over the 12-frame cache", "bias", 1, 1),
    ("exp2 + mxu_lsum, q_rope tuned decode: 3 frames over 9", "q_rope", 1, 1),
    ("exp2 + mxu_lsum, qk_int8 decode, stored K scales: 3 frames over 9", "qk_int8", 1, 1),
]


def check_attention_switches(torch, A):
    """K1 under the exp2 and mxu_lsum switches against its plain version
    with the same switches; ``library_ms`` is the mode's SDPA call, as in
    the checks above (the switches change the arithmetic, not the
    function)."""
    import torch.nn.functional as F

    from longlive_torch.ops.rope import make_rope_tables, rope_multipliers

    b, n, d, fs = 1, 12, 128, 1560
    g = torch.Generator(device="cuda").manual_seed(15)
    tables = make_rope_tables(d, 1024, device="cuda")
    cases = []
    for label, mode, exp2, lsum in SWITCH_CASES:
        kw, lib = {}, None
        if mode == "two_segment":
            q, k, v, k2, v2, bias, skip, lib, nvalid, nbytes = _two_segment_inputs(
                torch, A, g, TWO_SEG_CASES[0][1], TWO_SEG_CASES[0][2])
            kw = dict(k2=k2, v2=v2, skip_ranges=skip)
        else:
            kf = 12 if mode == "bias" else 9
            sq, s = 3 * fs, kf * fs
            q = torch.randn((b, sq, n, d), generator=g, device="cuda").to(torch.bfloat16)
            k, v = (torch.randn((b * n, s, d), generator=g, device="cuda").to(torch.bfloat16)
                    for _ in range(2))
            bias = torch.zeros((b, s), dtype=torch.float32, device="cuda")
            nvalid = s
            nbytes = 2 * 2 * q.numel() + 2 * 2 * k.numel() + 4 * b * s
            qr, kd = q, k
            if mode == "q_rope":
                kw["q_rope"] = rope_multipliers(tables, 3, 30, 52, start_frame=24)
                qr = A.rope_scaled_q(q, kw["q_rope"][0], kw["q_rope"][1], 1.0)
            if mode == "qk_int8":
                k, ksc = A.quantize_k_tokens(k)
                kw.update(qk_int8=True, k_scales=ksc)
                nbytes -= k.numel()
            lib = (qr.transpose(1, 2), kd.view(b, n, s, d), v.view(b, n, s, d), None)
        with switched(LONGLIVE_EXP2=str(exp2), LONGLIVE_MXU_LSUM=str(lsum)):
            before = dict(A.flag_launches)
            out = A.flash_attention(q, k, v, bias, **kw)
            if A.flag_launches != {"exp2": before["exp2"] + exp2,
                                   "mxu_lsum": before["mxu_lsum"] + lsum}:
                fail(f"flash_attention ({label}): switch counts {A.flag_launches} after {before}")
            ref = A.flash_attention_plain(q, k, v, bias, exp2=bool(exp2), mxu_lsum=bool(lsum),
                                          **kw)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                fail(f"flash_attention ({label}): non-finite output")
            err, tol, rel = agreement(out, ref)
            del ref
            ms = cuda_ms(torch, lambda: A.flash_attention(q, k, v, bias, **kw), 10)
            plain_ms = cuda_ms(torch, lambda: A.flash_attention_plain(
                q, k, v, bias, exp2=bool(exp2), mxu_lsum=bool(lsum), **kw), 2)
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            lib[0], lib[1], lib[2], attn_mask=lib[3]), 10)
        work = 4.0 * b * n * q.shape[1] * nvalid * d
        t_bound, bound_by = (bound(work / 2, nbytes, int8_ops=work / 2) if mode == "qk_int8"
                             else bound(work, nbytes))
        log(f"flash_attention {label}: max_abs_err={err:.3e} tol={tol:.3e} "
            f"rel_rms_err={rel:.3e} (limit {REL_RMS_LIMIT:.0e}) ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={t_bound:.4f} "
            f"({bound_by}; {t_bound / ms:.1%} of bound)")
        if not (err <= tol and rel <= REL_RMS_LIMIT):
            fail(f"flash_attention ({label}) disagrees with its plain version: "
                 f"max_abs_err {err} (limit {tol}), rel_rms_err {rel} (limit {REL_RMS_LIMIT})")
        cases.append({"case": label, "mode": mode, "exp2": bool(exp2), "mxu_lsum": bool(lsum),
                      "q": list(q.shape), "kv": list(k.shape), "valid_tokens": nvalid,
                      "max_abs_err": err, "tolerance": tol, "rel_rms_err": rel, "ms": ms,
                      "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": t_bound,
                      "bound_by": bound_by})
        del q, k, v, out, lib
        kw.clear()
        torch.cuda.empty_cache()
    return _attention_entry("flash_attention_exp2_mxu_lsum", "exp2 + mxu_lsum", cases, cases[0],
                            "one call at the serving-options decode with both switches")


def check_attention_edges(torch, A, entry):
    """K1's edges at full width: B = 2 at the decode shape (the tensor
    maps' batch offsets; each batch with its own bias), joined to K1's bias
    entry with its times; and the qk_int8 mode's q quantize, which the
    kernel runs in its prologue, bit for bit against the plain pass at the
    int8 decode shape, with and without the exp2 scale."""
    import torch.nn.functional as F

    b, n, d, fs = 2, 12, 128, 1560
    sq, s = 3 * fs, 12 * fs
    g = torch.Generator(device="cuda").manual_seed(19)
    q = torch.randn((b, sq, n, d), generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((b * n, s, d), generator=g, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    tok = torch.arange(s, device="cuda")
    bias = torch.stack([torch.where(tok < 12 * fs, 0.0, A.NEG_INF),
                        torch.where(tok < 6 * fs, 0.0, A.NEG_INF)]).float().contiguous()
    label = "bias decode, B = 2 (full window; sink + block valid)"
    out = A.flash_attention(q, k, v, bias)
    ref = A.flash_attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        fail(f"flash_attention ({label}): non-finite output")
    err, tol, rel = agreement(out, ref)
    del ref
    ms = cuda_ms(torch, lambda: A.flash_attention(q, k, v, bias), 10)
    plain_ms = cuda_ms(torch, lambda: A.flash_attention_plain(q, k, v, bias), 2)
    qt, kt, vt = q.transpose(1, 2), k.view(b, n, s, d), v.view(b, n, s, d)
    mask4 = bias.to(torch.bfloat16)[:, None, None, :]
    lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask4),
                     10)
    t_bound, bound_by = bound(4.0 * n * sq * 18 * fs * d,
                              2 * 2 * q.numel() + 2 * 2 * k.numel() + 4 * b * s)
    log(f"flash_attention {label}: max_abs_err={err:.3e} tol={tol:.3e} "
        f"rel_rms_err={rel:.3e} (limit {REL_RMS_LIMIT:.0e}) ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={t_bound:.4f} "
        f"({bound_by}; {t_bound / ms:.1%} of bound)")
    if not (err <= tol and rel <= REL_RMS_LIMIT):
        fail(f"flash_attention ({label}) disagrees with its plain version: "
             f"max_abs_err {err} (limit {tol}), rel_rms_err {rel} (limit {REL_RMS_LIMIT})")
    entry["cases"].append({"case": label, "mode": "bias", "q": [b, sq, n, d], "kv": [b * n, s, d],
                           "valid_tokens": 18 * fs, "max_abs_err": err, "tolerance": tol,
                           "rel_rms_err": rel, "ms": ms, "plain_ms": plain_ms,
                           "library_ms": lib_ms, "bound_ms": t_bound, "bound_by": bound_by})
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    entry["tolerance"] = min(entry["tolerance"], tol)
    entry["rel_rms_err"] = max(entry["rel_rms_err"], rel)
    del out, qt, kt, vt, k, v
    for exp2 in (False, True):
        q8, qs = A.kernel_quantized_q(q[:1], exp2=exp2)
        ref8, refs, _, _ = A._qk_int8_operands(q[:1], q[:1], None, A.softmax_scale(d, exp2))
        if not (torch.equal(q8, ref8) and torch.equal(qs, refs)):
            fail(f"flash_attention: the kernel's q quantize (exp2={exp2}) differs from the "
                 f"plain pass in {int((q8 != ref8).sum())} values, "
                 f"{int((qs != refs).sum())} scales")
    log("flash_attention qk_int8: the prologue's q quantize is bit-equal to the plain pass "
        f"at {list(q[:1].shape)} (exp2 off and on)")
    del q, q8, qs, ref8, refs
    torch.cuda.empty_cache()


# K1 at the cross-attention's shapes under LONGLIVE_CROSS_FLASH=1: (label,
# query tokens); 512 prompt tokens, a zero bias
CROSS_CASES = [
    ("cross: a 3-frame block over the 512-token prompt", 4680),
    ("cross: the 21-frame teacher-forcing sequence over the prompt", 65520),
]


def check_attention_cross(torch, A, entry):
    """K1 as the cross-attention (``cross=True``, zero bias) against its
    plain version; the cases join K1's bias entry.  ``library_ms`` is SDPA
    without a mask."""
    import torch.nn.functional as F

    b, n, d, s = 1, 12, 128, 512
    g = torch.Generator(device="cuda").manual_seed(17)
    for label, sq in CROSS_CASES:
        q = torch.randn((b, sq, n, d), generator=g, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((b * n, s, d), generator=g, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        bias = torch.zeros((b, s), dtype=torch.float32, device="cuda")
        before = A.mode_launches["cross"]
        out = A.flash_attention(q, k, v, bias, cross=True)
        if A.mode_launches["cross"] != before + 1:
            fail(f"flash_attention ({label}): not counted as a cross launch")
        ref = A.flash_attention_plain(q, k, v, bias)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            fail(f"flash_attention ({label}): non-finite output")
        err, tol, rel = agreement(out, ref)
        del ref
        ms = cuda_ms(torch, lambda: A.flash_attention(q, k, v, bias, cross=True), 10)
        plain_ms = cuda_ms(torch, lambda: A.flash_attention_plain(q, k, v, bias), 2)
        qt, kt, vt = q.transpose(1, 2), k.view(b, n, s, d), v.view(b, n, s, d)
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), 10)
        t_bound, bound_by = bound(4.0 * b * n * sq * s * d,
                                  2 * 2 * q.numel() + 2 * 2 * k.numel() + 4 * b * s)
        log(f"flash_attention {label}: max_abs_err={err:.3e} tol={tol:.3e} "
            f"rel_rms_err={rel:.3e} (limit {REL_RMS_LIMIT:.0e}) ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={t_bound:.4f} "
            f"({bound_by}; {t_bound / ms:.1%} of bound)")
        if not (err <= tol and rel <= REL_RMS_LIMIT):
            fail(f"flash_attention ({label}) disagrees with its plain version: "
                 f"max_abs_err {err} (limit {tol}), rel_rms_err {rel} (limit {REL_RMS_LIMIT})")
        entry["cases"].append({"case": label, "mode": "cross", "q": [b, sq, n, d],
                               "kv": [b * n, s, d], "max_abs_err": err, "tolerance": tol,
                               "rel_rms_err": rel, "ms": ms, "plain_ms": plain_ms,
                               "library_ms": lib_ms, "bound_ms": t_bound, "bound_by": bound_by})
        # the entry keeps the error and limit of its worst case (the cross
        # outputs are larger, and so are their errors and limits)
        if err / tol > entry["max_abs_err"] / entry["tolerance"]:
            entry["max_abs_err"], entry["tolerance"] = err, tol
        entry["rel_rms_err"] = max(entry["rel_rms_err"], rel)
        del q, k, v, out, qt, kt, vt
        torch.cuda.empty_cache()


# K1 at the bidirectional samplers' shapes (run_t2v at 832x480, 81 frames:
# 21 latent frames of 1560 tokens, the cond and uncond halves of CFG in one
# batch of 2): (label, mode, query tokens, kv tokens).  Every key is valid.
BIDI_CASES = [
    ("bias, bidirectional self: both CFG halves (B 2), 32760 over 32760", "bias", 32760, 32760),
    ("cross, text: both CFG halves (B 2), 32760 over 512", "cross", 32760, 512),
    ("cross, i2v image: both CFG halves (B 2), 32760 over 257 CLIP tokens", "cross", 32760, 257),
]


def check_attention_bidirectional(torch, A, entry):
    """K1 at the bidirectional samplers' shapes against its plain version
    (B = 2, a zero bias; the image cross-attention's 257 keys leave the last
    128-token tile ragged); the cases join K1's bias entry.
    ``library_ms`` is SDPA without a mask."""
    import torch.nn.functional as F

    b, n, d = 2, 12, 128
    g = torch.Generator(device="cuda").manual_seed(23)
    for label, mode, sq, s in BIDI_CASES:
        q = torch.randn((b, sq, n, d), generator=g, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((b * n, s, d), generator=g, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        bias = torch.zeros((b, s), dtype=torch.float32, device="cuda")
        cross = mode == "cross"
        before = A.mode_launches[mode]
        out = A.flash_attention(q, k, v, bias, cross=cross)
        if A.mode_launches[mode] != before + 1:
            fail(f"flash_attention ({label}): not counted as a {mode} launch")
        ref = A.flash_attention_plain(q, k, v, bias)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            fail(f"flash_attention ({label}): non-finite output")
        err, tol, rel = agreement(out, ref)
        del ref
        ms = cuda_ms(torch, lambda: A.flash_attention(q, k, v, bias, cross=cross), 5)
        plain_ms = cuda_ms(torch, lambda: A.flash_attention_plain(q, k, v, bias), 1)
        qt, kt, vt = q.transpose(1, 2), k.view(b, n, s, d), v.view(b, n, s, d)
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), 5)
        t_bound, bound_by = bound(4.0 * b * n * sq * s * d,
                                  2 * 2 * q.numel() + 2 * 2 * k.numel() + 4 * b * s)
        log(f"flash_attention {label}: max_abs_err={err:.3e} tol={tol:.3e} "
            f"rel_rms_err={rel:.3e} (limit {REL_RMS_LIMIT:.0e}) ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={t_bound:.4f} "
            f"({bound_by}; {t_bound / ms:.1%} of bound)")
        if not (err <= tol and rel <= REL_RMS_LIMIT):
            fail(f"flash_attention ({label}) disagrees with its plain version: "
                 f"max_abs_err {err} (limit {tol}), rel_rms_err {rel} (limit {REL_RMS_LIMIT})")
        entry["cases"].append({"case": label, "mode": mode, "q": [b, sq, n, d],
                               "kv": [b * n, s, d], "max_abs_err": err, "tolerance": tol,
                               "rel_rms_err": rel, "ms": ms, "plain_ms": plain_ms,
                               "library_ms": lib_ms, "bound_ms": t_bound, "bound_by": bound_by})
        if err / tol > entry["max_abs_err"] / entry["tolerance"]:
            entry["max_abs_err"], entry["tolerance"] = err, tol
        entry["rel_rms_err"] = max(entry["rel_rms_err"], rel)
        del q, k, v, out, qt, kt, vt
        torch.cuda.empty_cache()


# K3 at the full forwards' shapes (1560 tokens per frame, 12 heads of 128):
# (label, mask kind, frames, blocks of, local, sink).  The teacher-forcing
# sequence is [clean | noisy], twice the frames' tokens.
MASKED_CASES = [
    ("teacher_forcing, 21 frames (65520 tokens)", "teacher_forcing", 21, 3, -1, 0),
    ("sink_window, 21 frames (32760 tokens), window 12, sink 3", "sink_window", 21, 3, 12, 3),
    ("block_causal, 21 frames (32760 tokens)", "block_causal", 21, 3, -1, 0),
    ("teacher_forcing, 20 frames (62400 tokens, a partial last block)", "teacher_forcing", 20,
     3, -1, 0),
]


def timed_once(torch, fn):
    """(fn(), its device ms) for one call, from CUDA events."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def check_frame_masked(torch, A):
    """K3 against its plain version at the full forwards' shapes.  The bound
    counts the unmasked (q, kv) pairs of the mask (its frame pairs times
    1560^2; the diagonal adds none) at the bf16 rate, against q, k, v and
    the output once.  ``plain_ms`` is the plain call that gives the
    reference (one call); ``library_ms`` is ``scaled_dot_product_attention``
    with the materialized mask as an additive bf16 [S, S] tensor (8.6 GB at
    65520 tokens), built outside the timing.  At the first shape the
    unelided kernel must equal the elided one bit for bit; its time against
    the elided one's shows the skipping (``frame_mask_live_tiles`` counts
    the live tiles)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from longlive_torch.ops.masks import FrameMaskSpec, expand_frame_mask

    b, n, d, fs = 1, 12, 128, 1560
    g = torch.Generator(device="cuda").manual_seed(18)
    cases = []
    for i, (label, kind, f, nfb, local, sink) in enumerate(MASKED_CASES):
        tf = kind == "teacher_forcing"
        s = (2 if tf else 1) * f * fs
        kw = dict(mask_kind=kind, frame_seq=fs, nfb=nfb, local=local, sink=sink,
                  clean_frames=f if tf else 0)
        q, k, v = (torch.randn((b, s, n, d), generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        before = A.masked_launches[kind]
        out = A.flash_attention_frame_masked(q, k, v, elide_dead_tiles=True, **kw)
        if A.masked_launches[kind] != before + 1:
            fail(f"flash_attention_frame_masked ({label}): launch not counted")
        ref, plain_ms = timed_once(torch, lambda: A.flash_attention_frame_masked_plain(
            q, k, v, **kw))
        if not torch.isfinite(out).all():
            fail(f"flash_attention_frame_masked ({label}): non-finite output")
        err, tol, rel = agreement(out, ref)
        del ref
        extra = {}
        if i == 0:
            full = A.flash_attention_frame_masked(q, k, v, elide_dead_tiles=False, **kw)
            host = A.frame_mask_live_tiles(kind, s, s, A.MASKED_TILE_Q, A.MASKED_TILE_KV, fs, nfb,
                                           local, sink, kw["clean_frames"])
            if not torch.equal(full, out):
                fail(f"flash_attention_frame_masked ({label}): elided != unelided, max diff "
                     f"{(full.float() - out.float()).abs().max().item()}")
            del full
            extra = {"elided_equals_unelided": True, "live_tiles": int(host.sum()),
                     "tiles": host.numel(),
                     "unelided_ms": cuda_ms(torch, lambda: A.flash_attention_frame_masked(
                         q, k, v, elide_dead_tiles=False, **kw), 3)}
        ms = cuda_ms(torch, lambda: A.flash_attention_frame_masked(q, k, v, **kw), 5)
        frame_mask = FrameMaskSpec(kind, nfb, local, sink, f if tf else 0).materialize(f)
        pairs = int(frame_mask.sum()) * fs * fs
        t_bound, bound_by = bound(4.0 * b * n * pairs * d, 4 * 2 * q.numel())
        mask = torch.full((s, s), A.NEG_INF, dtype=torch.bfloat16, device="cuda")
        mask = mask.masked_fill_(expand_frame_mask(frame_mask.to("cuda"), fs), 0.0)[None, None]
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask), 3)
        del mask, qt, kt, vt
        log(f"flash_attention_frame_masked {label}: max_abs_err={err:.3e} tol={tol:.3e} "
            f"rel_rms_err={rel:.3e} (limit {REL_RMS_LIMIT:.0e}) ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={t_bound:.4f} ({bound_by}; "
            f"{t_bound / ms:.1%} of bound; {pairs / s / s:.1%} of the pairs unmasked) "
            + " ".join(f"{k}={v}" for k, v in extra.items()))
        if not (err <= tol and rel <= REL_RMS_LIMIT):
            fail(f"flash_attention_frame_masked ({label}) disagrees with its plain version: "
                 f"max_abs_err {err} (limit {tol}), rel_rms_err {rel} (limit {REL_RMS_LIMIT})")
        cases.append({"case": label, "mask_kind": kind, "q": [b, s, n, d], "kv": [b, s, n, d],
                      "unmasked_pairs": pairs, "max_abs_err": err, "tolerance": tol,
                      "rel_rms_err": rel, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": t_bound, "bound_by": bound_by, **extra})
        del q, k, v, out
        torch.cuda.empty_cache()
    head = cases[0]
    return {
        "name": "flash_attention_frame_masked", "route": "cuda",
        "mode": "teacher_forcing, sink_window, block_causal",
        "source": "longlive_torch/csrc/flash_attention_masked.cu",
        "replaces": "longlive_tpu/ops/attention.py:780",
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "tolerance": min(c["tolerance"] for c in cases),
        "rel_rms_err": max(c["rel_rms_err"] for c in cases), "rel_rms_limit": REL_RMS_LIMIT,
        "ms": head["ms"], "kernel_ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "unit": "one teacher-forcing call at the 21-frame training geometry (65520 tokens)",
        "cases": cases,
    }


# K5 at the int8 serving path's shapes: (label, M, K, N, calls per DiT
# block).  Per forward and layer: q, k, v, o, cross q, cross o at M 4680 and
# fc1; the cross k, v once per prompt and layer at M 512; the reactive
# switch's replay forwards at M 9360.  A steady block (4 denoise + 1 commit
# forwards of 30 layers) makes 900 calls at q/k/v/o's shape and 150 at
# fc1's (``per_block``; its bound: ``block_bound_ms``).
K5_CASES = [
    ("q, k, v, o, cross q, cross o: 3-frame block", 4680, 1536, 1536, 900),
    ("fc1: 3-frame block", 4680, 1536, 8960, 150),
    ("cross k, v: 512 text tokens", 512, 1536, 1536, 0),
    ("q, k, v, o: the reactive replay (6 frames)", 9360, 1536, 1536, 0),
]


def int8_linear_inputs(torch, Q, m: int, k: int, n: int, g):
    """(x, quantized linear) of one K5 case, from the generator ``g``."""
    x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
    lim = math.sqrt(6.0 / (k + n))
    w = (torch.rand((n, k), generator=g, device="cuda") * 2 - 1) * lim
    p = Q.quantize_weight(w.to(torch.bfloat16))
    p["bias"] = (0.02 * torch.randn((n,), generator=g, device="cuda")).to(torch.bfloat16)
    return x, p


def check_int8_linear(torch, Q):
    """K5 against its plain version, bit for bit (its quantize pass's int8
    rows and scales too).  Its times are device times (``device_ms``): a
    call's host work (~30-60 us) outlasts its kernels at these shapes, so
    back-to-back calls would time the host (``host_ms``, ``cuda_ms``, is
    kept beside them).  ``library_ms`` is the separate-quantize route
    (``quantize_activations``, ``torch._int_mm`` and the float32 rescale),
    the JAX package's default route for these linears; ``int_mm_ms`` is
    ``torch._int_mm`` alone on the same int8 operands (context, not a
    yardstick: it leaves out the quantize and the rescale)."""
    g = torch.Generator(device="cuda").manual_seed(13)
    cases = []
    for label, m, k, n, per_block in K5_CASES:
        x, p = int8_linear_inputs(torch, Q, m, k, n, g)
        out = Q.linear_int8_fused(x, p)
        ref = Q.linear_int8_fused_plain(x, p)
        xq, sx = Q.kernel_quantized_rows(x)
        pq, psx = Q.quantize_rows_plain(x)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            fail(f"int8_linear ({label}): non-finite output")
        err, tol, rel = agreement(out, ref)
        equal = (out == ref).float().mean().item()
        ms = device_ms(torch, lambda: Q.linear_int8_fused(x, p), 20)
        host_ms = cuda_ms(torch, lambda: Q.linear_int8_fused(x, p), 20)
        plain_ms = device_ms(torch, lambda: Q.linear_int8_fused_plain(x, p), 5)
        lib_ms = device_ms(torch, lambda: Q.linear_int8(x, p), 20)
        wt = p["w_int8"].t()
        int_mm_ms = device_ms(torch, lambda: torch._int_mm(xq, wt), 20)
        t_bound, bound_by = bound(0.0, 2 * m * k + n * k + 4 * n + 2 * n + 2 * m * n,
                                  int8_ops=2.0 * m * k * n)
        log(f"int8_linear {label} (M {m}, K {k}, N {n}): "
            f"max_abs_err={err:.3e} tol={tol:.3e} rel_rms_err={rel:.3e} equal={equal:.6f} "
            f"ms={ms:.4f} host_ms={host_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} int_mm_ms={int_mm_ms:.4f} bound_ms={t_bound:.4f} "
            f"({bound_by}; {t_bound / ms:.1%} of bound)")
        if not (torch.equal(xq, pq) and torch.equal(sx, psx)):
            fail(f"int8_linear ({label}): the quantize pass differs from quantize_rows_plain")
        if not torch.equal(out, ref):
            fail(f"int8_linear ({label}) is not bit-equal to its plain version: "
                 f"{equal:.6f} of the outputs equal, max_abs_err {err}")
        cases.append({"case": label, "m": m, "k": k, "n": n, "per_block": per_block,
                      "max_abs_err": err, "tolerance": tol, "rel_rms_err": rel, "equal": equal,
                      "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "int_mm_ms": int_mm_ms, "bound_ms": t_bound, "bound_by": bound_by})
        del x, p, out, ref, xq, sx, pq, psx, wt
    head = cases[0]
    return {
        "name": "int8_linear", "route": "cuda", "source": "longlive_torch/csrc/int8_linear.cu",
        "replaces": "longlive_tpu/ops/quant.py:131",
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "tolerance": min(c["tolerance"] for c in cases),
        "rel_rms_err": max(c["rel_rms_err"] for c in cases), "rel_rms_limit": REL_RMS_LIMIT,
        "ms": head["ms"], "kernel_ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "unit": "one call at q/k/v/o (M 4680, K 1536, N 1536)",
        "block_bound_ms": sum(c["per_block"] * c["bound_ms"] for c in cases),
        "cases": cases,
    }


# The 30 fused convs of one later latent frame of the Wan2.1 decoder at
# 480x832: (label, T, H, W, C, O, kernel rows/cols, norm, residual, count).
# The next two cases are the first latent frame's (T = 1) at the two widest
# stages, the last two the encoder's one conv shape no decoder conv has
# (its stage-1 shortcut block's conv1, in a later chunk and in the first):
# timed and checked, but outside the 30-conv sum (count 0).
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
    ("res conv1 96@480x832 T=1 (first latent frame)", 1, 480, 832, 96, 96, 3, True, False, 0),
    ("res conv2 192@240x416 T=1 (first latent frame)", 1, 240, 416, 192, 192, 3, True, True, 0),
    ("encoder shortcut-block conv1 96->192@240x416", 4, 240, 416, 96, 192, 3, True, False, 0),
    ("encoder shortcut-block conv1 96->192@240x416 T=1 (first chunk)", 1, 240, 416, 96, 192, 3,
     True, False, 0),
    # the streaming trainer's re-encode: a one-frame decode and a one-frame
    # encode run every res-block conv at T = 1; these two shapes are the
    # ones the cases above do not cover at T = 1
    ("shortcut-block conv1 192->384@120x208 T=1 (one-frame decode and encode)", 1, 120, 208,
     192, 384, 3, True, False, 0),
    ("res conv2 384@120x208 T=1 (one-frame decode and encode)", 1, 120, 208, 384, 384, 3,
     True, True, 0),
]


def check_conv(torch, VC, int8: bool = False):
    """K2 at every fused-conv shape of one later latent frame, bf16 or the
    int8 variant (``LONGLIVE_VAE_INT8=1`` around its calls, the int8
    weights packed once); the headline numbers are sums over the 30 convs
    of that frame.  ``library_ms`` is cuDNN's bf16 conv3d on the
    normalised frames in both cases (no PyTorch call convolves in int8);
    the int8 bound counts the convs' operations at the int8 rate."""
    name = "fused_causal_conv_int8" if int8 else "fused_causal_conv"
    with switched(LONGLIVE_VAE_INT8="1" if int8 else "0"):
        cases, tot = conv_cases(torch, VC, int8, name)
    t_bound, bound_by = (bound(0.0, tot["bytes"], int8_ops=tot["flops"]) if int8
                         else bound(tot["flops"], tot["bytes"]))
    return {
        "name": name, "route": "cuda", "mode": "int8" if int8 else "bf16",
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


def conv_cases(torch, VC, int8: bool, name: str):
    """check_conv's cases and their count-weighted sums."""
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
        # packed once, as the VAE's parameters are
        pk = dict(w_int8=VC.pack_weights_int8(wt, gamma)) if int8 else dict(
            w_packed=VC.pack_weights(wt))
        out, nx = VC.fused_causal_conv(x, cache, wt, bias, gamma, resid, **pk)
        ref, ref_nx = VC.fused_causal_conv_plain(x, cache, wt, bias, gamma, resid,
                                                 pk.get("w_int8"))
        torch.cuda.synchronize()
        if not (torch.isfinite(out).all() and torch.isfinite(nx).all()):
            fail(f"{name} ({label}): non-finite output")
        err, tol, rel = agreement(out, ref)
        err_nx, tol_nx, rel_nx = agreement(nx, ref_nx)
        if not (err_nx <= tol_nx and rel_nx <= REL_RMS_LIMIT):
            fail(f"{name} ({label}) new cache disagrees with its plain "
                 f"version: max_abs_err {err_nx} (limit {tol_nx}), rel_rms_err "
                 f"{rel_nx} (limit {REL_RMS_LIMIT})")
        del ref, ref_nx
        if int8:  # the pre-pass's operand, bit-equal to its plain version
            q, s, full_k = VC.kernel_quantized_operand(x, cache, wt, gamma, pk["w_int8"])
            q_ref, s_ref = VC.quantized_operand_plain(full_k, pk["w_int8"][2],
                                                      VC.row_tile(x, wt), k)
            if not (torch.equal(q, q_ref) and torch.equal(s, s_ref)):
                fail(f"{name} ({label}): the quantized operand {tuple(q.shape)} differs from "
                     f"quantized_operand_plain in {int((q != q_ref).sum())} elements")
            del q, s, full_k, q_ref, s_ref
        xin = VC.norm_silu(x, gamma) if norm else x
        full = torch.cat([cache, xin], 0).permute(3, 0, 1, 2)[None].contiguous()
        wb, bb = wt, bias.to(bf)
        ms = cuda_ms(torch, lambda: VC.fused_causal_conv(
            x, cache, wt, bias, gamma, resid, **pk), 5)
        plain_ms = cuda_ms(torch, lambda: VC.fused_causal_conv_plain(
            x, cache, wt, bias, gamma, resid, pk.get("w_int8")), 2)
        lib_ms = cuda_ms(torch, lambda: F.conv3d(full, wb, bb, padding=(0, k // 2, k // 2)), 5)
        flops = 2.0 * t * h * w * o * c * 3 * k * k
        w_bytes = wt.numel() * (1 if int8 else 2) + (4 * (k * o + c) if int8 else 0)
        nbytes = (2 * (x.numel() + cache.numel() + t * h * w * o + 2 * h * w * c
                       + (resid.numel() if res else 0)) + w_bytes
                  + 4 * (o + (c if norm else 0)))
        t_bound, bound_by = (bound(0.0, nbytes, int8_ops=flops) if int8
                             else bound(flops, nbytes))
        log(f"{name} {label} x{count}: max_abs_err={err:.3e} tol={tol:.3e} "
            f"rel_rms_err={rel:.3e} (new cache {err_nx:.3e} / {tol_nx:.3e}, "
            f"{rel_nx:.3e}) ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={t_bound:.4f} ({bound_by})")
        if not (err <= tol and rel <= REL_RMS_LIMIT):
            fail(f"{name} ({label}) disagrees with its plain version: "
                 f"max_abs_err {err} (limit {tol}), rel_rms_err {rel} "
                 f"(limit {REL_RMS_LIMIT})")
        cases.append({"case": label, "count": count, "max_abs_err": max(err, err_nx),
                      "tolerance": min(tol, tol_nx), "rel_rms_err": max(rel, rel_nx),
                      "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": t_bound, "bound_by": bound_by})
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("flops", flops), ("bytes", nbytes)):
            tot[key] += count * val
        del x, cache, wt, pk, resid, out, nx, full
        torch.cuda.empty_cache()
    return cases, tot


# K6 at the no-shortcut res blocks of one later latent frame of the Wan2.1
# decoder at 480x832: (label, T, H, W, C, calls per later latent frame).
# The last case is no path's: a chunk of 4 latent frames at the 384-wide
# stage (conv1 followed by a norm pass over 4 frames).
PAIR_CASES = [
    ("res block 384@60x104 (middle, stage 0)", 1, 60, 104, 384, 5),
    ("res block 384@120x208 (stage 1)", 2, 120, 208, 384, 2),
    ("res block 192@240x416 (stage 2)", 4, 240, 416, 192, 3),
    ("res block 96@480x832 (stage 3)", 4, 480, 832, 96, 3),
    ("res block 384@60x104 over 4 frames (no path's)", 4, 60, 104, 384, 0),
]


def pair_tiling(VC, h: int, w: int, c: int) -> dict:
    """K6's tiles at one geometry (``ops.vae_conv.pair_tiles``): each conv's
    box, K step, N, m64 tiles per warpgroup and stages, and where norm2
    runs (conv1's epilogue, or a pass after it)."""
    t1, t2 = VC.pair_tiles(h, w, c)
    keys = ("bh", "bw", "kc", "bn", "mt", "stages")
    return {"conv1": {k: getattr(t1, k) for k in keys},
            "conv2": {k: getattr(t2, k) for k in keys},
            "norm2": "conv1 epilogue" if t1.bn == c else "pass"}


def check_res_block_pair(torch, VC):
    """K6 against its plain version (the two-call plain chain) and against
    the chain of two K2 launches, at every pair shape of one later latent
    frame; the headline numbers are sums over its 13 calls.  No single
    PyTorch call computes a res block: ``library_ms`` is two cuDNN bf16
    conv3d calls on the normalised inputs (norms excluded), ``chain_ms``
    the two K2 launches."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(16)
    bf = torch.bfloat16
    cases = []
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "chain_ms": 0.0, "flops": 0.0,
           "bytes": 0.0}
    assert sum(c[-1] for c in PAIR_CASES) == 13
    for label, t, h, w, c, count in PAIR_CASES:
        x = torch.randn((t, h, w, c), generator=g, device="cuda").to(bf)
        c1, c2 = (torch.randn((2, h, w, c), generator=g, device="cuda").to(bf) for _ in range(2))
        std = 1.0 / math.sqrt(27 * c)
        w1, w2 = (((torch.rand((c, c, 3, 3, 3), generator=g, device="cuda") * 2 - 1) * std)
                  .to(bf) for _ in range(2))
        b1, b2 = ((torch.rand((c,), generator=g, device="cuda") * 2 - 1) * std for _ in range(2))
        g1, g2 = (1.0 + 0.1 * torch.randn((c,), generator=g, device="cuda") for _ in range(2))
        p1, p2 = VC.pack_weights(w1), VC.pack_weights(w2)  # packed once, as the VAE's are
        args = (x, c1, c2, w1, b1, g1, w2, b2, g2)
        before = VC.pair_launches
        got = VC.fused_res_block(*args, w1_packed=p1, w2_packed=p2)
        if VC.pair_launches != before + 1:
            fail(f"fused_res_block ({label}): {VC.pair_launches - before} launches, expected 1")
        ref = VC.fused_res_block_plain(*args)

        def chain():
            y, n1 = VC.fused_causal_conv(x, c1, w1, b1, g1, w_packed=p1)
            out, n2 = VC.fused_causal_conv(y, c2, w2, b2, g2, residual=x, w_packed=p2)
            return out, n1, n2

        via_k2 = chain()
        torch.cuda.synchronize()
        if not all(torch.isfinite(a).all() for a in got):
            fail(f"fused_res_block ({label}): non-finite output")
        errs = {}
        for what, other in (("plain", ref), ("two K2", via_k2)):
            for name, a, r in zip(("out", "new cache1", "new cache2"), got, other):
                err, tol, rel = agreement(a, r)
                errs[f"{name} vs {what}"] = (err, tol, rel)
                if not (err <= tol and rel <= REL_RMS_LIMIT):
                    fail(f"fused_res_block ({label}) {name} disagrees with the {what} version: "
                         f"max_abs_err {err} (limit {tol}), rel_rms_err {rel} "
                         f"(limit {REL_RMS_LIMIT})")
        del ref, via_k2
        full1 = torch.cat([c1, VC.norm_silu(x, g1)], 0).permute(3, 0, 1, 2)[None].contiguous()
        y = got[0]  # any bf16 frames of the right shape: cuDNN's time does not depend on them
        full2 = torch.cat([c2, y], 0).permute(3, 0, 1, 2)[None].contiguous()
        b1b, b2b = b1.to(bf), b2.to(bf)
        ms = cuda_ms(torch, lambda: VC.fused_res_block(*args, w1_packed=p1, w2_packed=p2), 5)
        chain_ms = cuda_ms(torch, chain, 5)
        plain_ms = cuda_ms(torch, lambda: VC.fused_res_block_plain(*args), 2)
        lib_ms = cuda_ms(torch, lambda: (F.conv3d(full1, w1, b1b, padding=(0, 1, 1)),
                                         F.conv3d(full2, w2, b2b, padding=(0, 1, 1))), 5)
        flops = 2 * 2.0 * t * h * w * c * c * 27
        nbytes = 2 * (2 * x.numel() + 4 * c1.numel()) + 2 * 2 * w1.numel() + 4 * 4 * c
        t_bound, bound_by = bound(flops, nbytes)
        worst = max(errs.values(), key=lambda e: e[0] / e[1])
        log(f"fused_res_block {label} x{count}: "
            + ", ".join(f"{k} {e:.3e}/{tl:.3e}/{r:.3e}" for k, (e, tl, r) in errs.items())
            + f"; ms={ms:.4f} chain_ms={chain_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={t_bound:.4f} ({bound_by}; "
            f"{t_bound / ms:.1%} of bound)")
        cases.append({"case": label, "count": count, "t": t, "h": h, "w": w, "c": c,
                      "tile": pair_tiling(VC, h, w, c), "max_abs_err": worst[0],
                      "tolerance": worst[1], "rel_rms_err": max(e[2] for e in errs.values()),
                      "ms": ms, "chain_ms": chain_ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms, "bound_ms": t_bound, "bound_by": bound_by})
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("chain_ms", chain_ms), ("flops", flops), ("bytes", nbytes)):
            tot[key] += count * val
        del x, c1, c2, w1, w2, p1, p2, got, full1, full2, y
        torch.cuda.empty_cache()
    t_bound, bound_by = bound(tot["flops"], tot["bytes"])
    return {
        "name": "fused_res_block", "route": "cuda",
        "source": "longlive_torch/csrc/res_block_pair.cu",
        "replaces": "longlive_tpu/ops/vae_conv.py:650",
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "tolerance": min(c["tolerance"] for c in cases),
        "rel_rms_err": max(c["rel_rms_err"] for c in cases), "rel_rms_limit": REL_RMS_LIMIT,
        "ms": tot["ms"], "kernel_ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": t_bound, "bound_by": bound_by, "library_ms": tot["library_ms"],
        "chain_ms": tot["chain_ms"],
        "unit": "sum over the 13 res blocks of one later latent frame (library_ms: two cuDNN "
                "bf16 conv3d per block; chain_ms: two K2 launches per block)",
        "cases": cases,
    }


# ---------------------------------------------------------------------------
# phase 4: small-input reference (GPU kernels vs CPU plain versions)


def rel_err(a, b) -> float:
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return ((a - b).norm() / b.norm().clamp_min(1e-12)).item()


def to_dev(tree, dev, dt):
    """A parameter tree on ``dev`` in ``dt``, without the VAE's packed
    weights (``vae.pack_fused_weights`` makes them again on the device)."""
    if isinstance(tree, dict):
        return {k: to_dev(v, dev, dt) for k, v in tree.items()
                if k not in ("w_packed", "w_int8")}
    if isinstance(tree, list):
        return [to_dev(v, dev, dt) for v in tree]
    return None if tree is None else tree.to(dev, dt)


def check_small_reference(torch):
    """The same small inputs through each generation loop on the GPU (bf16,
    kernels) and on the CPU (float32, plain versions); then the VAE."""
    from longlive_torch.config import DiTConfig, LatentGeometry, PipelineConfig
    from longlive_torch.models import dit as D
    from longlive_torch.models import vae as V
    from longlive_torch.pipeline import InteractiveCausalInferencePipeline

    # head_dim 128 (the kernel's); 10x12 latents -> 30 tokens per frame,
    # a 120-token cache: ragged q and KV tiles
    cfg = DiTConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=2, in_dim=16, out_dim=16,
                    text_dim=64, text_len=16, freq_dim=64, local_attn_size=4, sink_size=1,
                    num_frame_per_block=1, rope_max_pos=64)
    geom = LatentGeometry(height=10, width=12)
    base = dict(num_frame_per_block=1, local_attn_size=4, sink_size=1, num_output_frames=6)
    params32 = D.init_dit_params(cfg, torch.float32, "cpu", seed=3, zero_head=False)

    g = torch.Generator().manual_seed(4)
    pes = [torch.randn((1, cfg.text_len, cfg.text_dim), generator=g) for _ in range(3)]
    noise = torch.randn((1, 6, 16, geom.height, geom.width), generator=g)
    # (label, config knobs, run(pipe, conds)); switches at frame 3 (and 4)
    loops = [
        ("single prompt", {}, lambda p, c: p.generate_latents(noise, c[0])),
        ("fused rope", dict(fused_rope=True), lambda p, c: p.generate_latents(noise, c[0])),
        ("one-shot recache", dict(global_sink=False),
         lambda p, c: p.generate_latents_interactive(noise, c[:2], [3])),
        ("eager recache", dict(global_sink=False, eager_recache=True),
         lambda p, c: p.generate_latents_interactive_scanned(noise, c, [3, 4])),
        ("reactive, fused rope", dict(fused_rope=True, reactive_recache_frames=2),
         lambda p, c: p.generate_latents_reactive(noise, c[0],
                                                  lambda s: c[1] if s == 3 else None)),
    ]
    errs = {}
    lat32 = None
    for label, knobs, run in loops:
        lat = {}
        for dev, dt in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
            pipe = InteractiveCausalInferencePipeline(
                PipelineConfig(**base, **knobs), to_dev(params32, dev, dt), geometry=geom,
                dit_config=cfg, device=dev, deterministic_renoise=True)
            lat[dev] = run(pipe, [pipe.prepare_condition(pe) for pe in pes])
        if not torch.isfinite(lat["cuda"]).all():
            fail(f"small reference ({label}): non-finite GPU output")
        errs[label] = rel_err(lat["cuda"], lat["cpu"])
        lat32 = lat32 if lat32 is not None else lat["cpu"]

    vcfg = dataclasses.replace(V.tiny_vae_config(), dim=96, z_dim=16)  # widths 192/96: fused
    vp32 = V.init_vae_params(vcfg, torch.float32, "cpu", seed=5)
    z = lat32[:, :3]
    px_cpu = V.vae_decode(vp32, vcfg, z)
    vp_gpu = V.pack_fused_weights(to_dev(vp32, "cuda", torch.bfloat16))
    px_gpu = V.vae_decode(vp_gpu, vcfg, z.to("cuda", torch.bfloat16))
    errs["VAE pixels"] = rel_err(px_gpu, px_cpu)
    log("small reference (GPU bf16 kernels vs CPU float32 plain; limit 5e-2): "
        + ", ".join(f"{k} rel_err={v:.3e}" for k, v in errs.items()))
    if not torch.isfinite(px_gpu).all():
        fail("small reference: non-finite GPU VAE output")
    bad = {k: v for k, v in errs.items() if not v <= 5e-2}
    if bad:
        fail(f"small reference disagrees (limit 5e-2): {bad}")


# GPU-vs-CPU limit of the quantized small reference: the GPU's activations
# are bf16, so its int8 values are taken from inputs ~0.4% away from the
# CPU's float32 ones and land one step apart at many elements; each step is
# ~1% of a row's range (measured on the card: see PERF.md)
INT8_REF_LIMIT = 1e-1


def check_small_int8_reference(torch, A, VC):
    """The quantized serving mode on small inputs, GPU (bf16, kernels) vs
    CPU (float32, plain versions): int8 block linears with
    ``LONGLIVE_INT8_FUSED=1`` (256-token frames and dim 256 put them in
    K5's shape rule), then reactive generation on the int8 K cache and the
    one-shot int8 recache on a bf16 cache, and the VAE with
    ``LONGLIVE_VAE_INT8=1``.  Also checks that the GPU runs went through K5,
    K1's qk_int8 mode and K2's int8 variant."""
    from longlive_torch.config import DiTConfig, LatentGeometry, PipelineConfig
    from longlive_torch.models import dit as D
    from longlive_torch.models import vae as V
    from longlive_torch.ops import quant as Q
    from longlive_torch.pipeline import InteractiveCausalInferencePipeline

    cfg = DiTConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=2, in_dim=16, out_dim=16,
                    text_dim=64, text_len=16, freq_dim=64, local_attn_size=4, sink_size=1,
                    num_frame_per_block=1, rope_max_pos=64)
    geom = LatentGeometry(height=32, width=32)
    base = dict(num_frame_per_block=1, local_attn_size=4, sink_size=1, num_output_frames=6,
                global_sink=False)
    params32 = D.init_dit_params(cfg, torch.float32, "cpu", seed=3, zero_head=False)
    g = torch.Generator().manual_seed(9)
    pes = [torch.randn((1, cfg.text_len, cfg.text_dim), generator=g) for _ in range(2)]
    noise = torch.randn((1, 6, 16, geom.height, geom.width), generator=g)
    loops = [
        ("int8 K cache, reactive switch", dict(kv_int8=True, reactive_recache_frames=2),
         lambda p, c: p.generate_latents_reactive(noise, c[0],
                                                  lambda s: c[1] if s == 3 else None)),
        ("int8 recache (pallas_qk8)", dict(recache_attn_impl="pallas_qk8"),
         lambda p, c: p.generate_latents_interactive(noise, c, [3])),
    ]
    errs, lat32 = {}, None
    with switched(LONGLIVE_INT8_FUSED="1", LONGLIVE_VAE_INT8="1"):
        for label, knobs, run in loops:
            lat = {}
            for dev, dt in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
                pipe = InteractiveCausalInferencePipeline(
                    PipelineConfig(**base, **knobs),
                    Q.quantize_dit_params(to_dev(params32, dev, dt)), geometry=geom,
                    dit_config=cfg, device=dev, deterministic_renoise=True)
                reset_counts(A, VC)
                lat[dev] = run(pipe, [pipe.prepare_condition(pe) for pe in pes])
                got = counts(A, VC)
            if not (got["int8_linear"] > 0 and got["flash_attention"]["qk_int8"] > 0):
                fail(f"small int8 reference ({label}): the GPU run launched {got}")
            if not torch.isfinite(lat["cuda"]).all():
                fail(f"small int8 reference ({label}): non-finite GPU output")
            errs[label] = rel_err(lat["cuda"], lat["cpu"])
            lat32 = lat32 if lat32 is not None else lat["cpu"]
        vcfg = dataclasses.replace(V.tiny_vae_config(), dim=96, z_dim=16)
        vp32 = V.init_vae_params(vcfg, torch.float32, "cpu", seed=5)
        z = lat32[:, :3, :, :8, :8]
        px_cpu = V.vae_decode(vp32, vcfg, z)
        reset_counts(A, VC)
        px_gpu = V.vae_decode(V.pack_fused_weights(to_dev(vp32, "cuda", torch.bfloat16)), vcfg,
                              z.to("cuda", torch.bfloat16))
        if counts(A, VC)["fused_causal_conv"]["int8"] == 0:
            fail("small int8 reference: the GPU VAE launched no int8 conv")
        errs["VAE pixels, int8 convs"] = rel_err(px_gpu, px_cpu)
    log(f"small int8 reference (GPU bf16 kernels vs CPU float32 plain; limit "
        f"{INT8_REF_LIMIT:.0e}): " + ", ".join(f"{k} rel_err={v:.3e}" for k, v in errs.items()))
    bad = {k: v for k, v in errs.items() if not v <= INT8_REF_LIMIT}
    if bad:
        fail(f"small int8 reference disagrees (limit {INT8_REF_LIMIT}): {bad}")
    return errs


def check_small_serving_options_reference(torch, A, VC):
    """The serving options on small inputs, GPU (bf16, kernels) vs CPU
    (float32, plain versions): generation with ``kernel_cache: false``,
    ``LONGLIVE_TWO_SEGMENT=1``, ``LONGLIVE_EXP2=1`` and
    ``LONGLIVE_MXU_LSUM=1`` (64-token frames: each of a block's slots is
    one whole KV tile, so elision runs), then the VAE (widths 192 and 96)
    with ``LONGLIVE_VAE_PAIR=1``.  Checks that the GPU runs went through
    the two-segment mode with both switches and through K6."""
    from longlive_torch.config import DiTConfig, LatentGeometry, PipelineConfig
    from longlive_torch.models import dit as D
    from longlive_torch.models import vae as V
    from longlive_torch.pipeline import CausalInferencePipeline

    cfg = DiTConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=2, in_dim=16, out_dim=16,
                    text_dim=64, text_len=16, freq_dim=64, local_attn_size=4, sink_size=1,
                    num_frame_per_block=1, rope_max_pos=64)
    geom = LatentGeometry(height=16, width=16)
    pc = PipelineConfig(num_frame_per_block=1, local_attn_size=4, sink_size=1,
                        num_output_frames=6, kernel_cache=False)
    params32 = D.init_dit_params(cfg, torch.float32, "cpu", seed=3, zero_head=False)
    g = torch.Generator().manual_seed(10)
    pe = torch.randn((1, cfg.text_len, cfg.text_dim), generator=g)
    noise = torch.randn((1, 6, 16, geom.height, geom.width), generator=g)
    errs, lat = {}, {}
    with switched(**{k: "1" for k in SWITCHES}):
        for dev, dt in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
            pipe = CausalInferencePipeline(pc, to_dev(params32, dev, dt), geometry=geom,
                                           dit_config=cfg, device=dev, deterministic_renoise=True)
            reset_counts(A, VC)
            lat[dev] = pipe.generate_latents(noise, pipe.prepare_condition(pe))
        got = counts(A, VC)
        att = got["flash_attention"]
        if not (att["two_segment"] > 0 and att["two_segment"] == A.launches
                == got["flash_attention_switches"]["exp2"]
                == got["flash_attention_switches"]["mxu_lsum"]):
            fail(f"small serving-options reference: the GPU run launched {got}")
        if not torch.isfinite(lat["cuda"]).all():
            fail("small serving-options reference: non-finite GPU latents")
        errs["two-segment generation, exp2, mxu_lsum"] = rel_err(lat["cuda"], lat["cpu"])
        vcfg = dataclasses.replace(V.tiny_vae_config(), dim=96, z_dim=16)
        vp32 = V.init_vae_params(vcfg, torch.float32, "cpu", seed=5)
        z = lat["cpu"][:, :3]
        px_cpu = V.vae_decode(vp32, vcfg, z)
        reset_counts(A, VC)
        px_gpu = V.vae_decode(V.pack_fused_weights(to_dev(vp32, "cuda", torch.bfloat16)), vcfg,
                              z.to("cuda", torch.bfloat16))
        if VC.pair_launches == 0:
            fail("small serving-options reference: the GPU VAE launched no fused_res_block")
        if not torch.isfinite(px_gpu).all():
            fail("small serving-options reference: non-finite GPU pixels")
        errs["VAE pixels, fused res blocks"] = rel_err(px_gpu, px_cpu)
    log("small serving-options reference (GPU bf16 kernels vs CPU float32 plain; limit "
        "5e-2): " + ", ".join(f"{k} rel_err={v:.3e}" for k, v in errs.items()))
    bad = {k: v for k, v in errs.items() if not v <= 5e-2}
    if bad:
        fail(f"small serving-options reference disagrees (limit 5e-2): {bad}")
    return errs


def check_small_full_forwards(torch, A, VC):
    """The full-sequence forwards on small inputs, GPU (bf16, kernels) vs
    CPU (float32, plain versions): ``dit_forward_teacher_forcing`` over 5
    frames (blocks of 2: a partial last block; 64-token frames, a ragged
    kv tail) with ``aug_t``, ``dit_forward_full`` with a sink-window
    ``FrameMaskSpec`` from frame 2, then the teacher-forcing forward again
    under ``LONGLIVE_CROSS_FLASH=1``.  Checks that each GPU forward
    launched K3 once per layer (and K1 as the cross-attention once per
    layer under the switch), and nothing else."""
    from longlive_torch.config import DiTConfig
    from longlive_torch.models import dit as D
    from longlive_torch.ops.masks import FrameMaskSpec
    from longlive_torch.ops.rope import make_rope_tables

    cfg = DiTConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=2, in_dim=16, out_dim=16,
                    text_dim=64, text_len=16, freq_dim=64, num_frame_per_block=2,
                    rope_max_pos=64)
    params32 = D.init_dit_params(cfg, torch.float32, "cpu", seed=3, zero_head=False)
    g = torch.Generator().manual_seed(19)
    pe = torch.randn((1, cfg.text_len, cfg.text_dim), generator=g)
    noisy, clean = (torch.randn((1, 5, 16, 16, 16), generator=g) for _ in range(2))
    t, aug_t = torch.rand((1, 5), generator=g) * 1000, torch.rand((1, 5), generator=g) * 200
    x6, t6 = torch.randn((1, 6, 16, 16, 16), generator=g), torch.rand((1, 6), generator=g) * 1000
    spec = FrameMaskSpec("sink_window", 2, 4, 1)
    layers = cfg.num_layers
    runs = [
        ("teacher forcing", {}, lambda p, c, tab, dev, dt: D.dit_forward_teacher_forcing(
            p, cfg, tab, *(a.to(dev, dt) for a in (noisy, clean)), t.to(dev), c, aug_t.to(dev),
            attn_impl="pallas"), expect(teacher_forcing=layers)),
        ("full, sink_window spec, start_frame 2", {}, lambda p, c, tab, dev, dt:
         D.dit_forward_full(p, cfg, tab, x6.to(dev, dt), t6.to(dev), c, spec, start_frame=2),
         expect(sink_window=layers)),
        ("teacher forcing, LONGLIVE_CROSS_FLASH=1", {"LONGLIVE_CROSS_FLASH": "1"},
         lambda p, c, tab, dev, dt: D.dit_forward_teacher_forcing(
             p, cfg, tab, *(a.to(dev, dt) for a in (noisy, clean)), t.to(dev), c,
             aug_t.to(dev), attn_impl="pallas"), expect(teacher_forcing=layers, cross=layers)),
    ]
    errs = {}
    with torch.no_grad():
        for label, env, run, want in runs:
            out = {}
            with switched(**env):
                for dev, dt in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
                    p = to_dev(params32, dev, dt)
                    cross = D.prepare_cross_kv(p, cfg, pe.to(dev), dt)
                    tables = make_rope_tables(cfg.head_dim, cfg.rope_max_pos, device=dev)
                    reset_counts(A, VC)
                    out[dev] = run(p, cross, tables, dev, dt)
                    got = counts(A, VC)
            check_counts(f"small full forwards ({label}), GPU", got, want)
            if not torch.isfinite(out["cuda"]).all():
                fail(f"small full forwards ({label}): non-finite GPU output")
            errs[label] = rel_err(out["cuda"], out["cpu"])
    log("small full-forward reference (GPU bf16 kernels vs CPU float32 plain; limit 5e-2): "
        + ", ".join(f"{k} rel_err={v:.3e}" for k, v in errs.items()))
    bad = {k: v for k, v in errs.items() if not v <= 5e-2}
    if bad:
        fail(f"small full-forward reference disagrees (limit 5e-2): {bad}")
    return errs


def check_small_encoders(torch, VC) -> dict:
    """The two encoders on small inputs, GPU (bf16) vs CPU (float32):
    ``encode_prompts`` of a 3-layer umT5 at width 512 (plain PyTorch, no
    kernel) on two prompts of 64 ids (40 and 17 valid); ``vae_encode`` of 5
    frames at 32 x 48 at the widths where K2 takes the res-block convs (96
    -> 192, two stages, one temporal downsample), which launches K2 8
    times per chunk of 1, 2, 2 frames (both convs of its 4 res blocks)."""
    from longlive_torch.models import t5 as T5
    from longlive_torch.models import vae as V

    errs = {}
    tcfg = T5.T5Config(vocab_size=1000, dim=512, dim_attn=512, dim_ffn=1024, num_heads=8,
                       num_layers=3, text_len=64)
    tp32 = T5.init_t5_params(tcfg, torch.float32, "cpu", seed=21)
    g = torch.Generator().manual_seed(22)
    ids = torch.randint(1, tcfg.vocab_size, (2, tcfg.text_len), generator=g)
    mask = (torch.arange(tcfg.text_len)[None] < torch.tensor([[40], [17]])).long()
    feats = {}
    for dev, dt in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
        feats[dev] = T5.encode_prompts(to_dev(tp32, dev, dt), tcfg, (ids * mask).to(dev),
                                       mask.to(dev))
    if not torch.isfinite(feats["cuda"]).all() or feats["cuda"][1, 17:].any():
        fail("small T5 reference: non-finite GPU features, or padding rows not zero")
    errs["T5 encode_prompts"] = rel_err(feats["cuda"], feats["cpu"])

    vcfg = dataclasses.replace(V.tiny_vae_config(), dim=96, z_dim=16)  # widths 96/192: fused
    vp32 = V.init_vae_params(vcfg, torch.float32, "cpu", seed=23)
    px = torch.rand((1, 5, 3, 32, 48), generator=g) * 2 - 1
    mu_cpu = V.vae_encode(vp32, vcfg, px)
    vp_gpu = V.pack_fused_weights(to_dev(vp32, "cuda", torch.bfloat16))
    before = VC.mode_launches["bf16"]
    mu_gpu = V.vae_encode(vp_gpu, vcfg, px.to("cuda", torch.bfloat16))
    torch.cuda.synchronize()
    if VC.mode_launches["bf16"] - before != 8 * 3:
        fail(f"small VAE encode: K2 launched {VC.mode_launches['bf16'] - before} times, "
             "expected 24 (8 res-block convs x 3 chunks)")
    if tuple(mu_gpu.shape) != (1, 3, 16, 16, 24) or not torch.isfinite(mu_gpu).all():
        fail(f"small VAE encode: latents {tuple(mu_gpu.shape)} or non-finite")
    errs["VAE encode"] = rel_err(mu_gpu, mu_cpu)
    log("small encoder reference (GPU bf16 vs CPU float32; limit 5e-2): "
        + ", ".join(f"{k} rel_err={v:.3e}" for k, v in errs.items()))
    bad = {k: v for k, v in errs.items() if not v <= 5e-2}
    if bad:
        fail(f"small encoder reference disagrees (limit 5e-2): {bad}")
    return errs


# ---------------------------------------------------------------------------
# phase 5: the paths at full width


def derived():
    """Launch counts derived from the model: a block runs every layer in
    each denoise forward and all but the last layer's attention in its
    commit forward; a block whose commit is skipped, only the former; a
    recache or eager chunk is one commit-like forward.  The VAE runs both
    convs of every res block per latent frame, plus one time conv per
    temporal upsample from the second frame on; under LONGLIVE_VAE_PAIR=1
    each res block without a shortcut is one K6 launch instead.  Int8 linears: per layer
    of a full forward, K5 runs q, k, v, o, cross q, cross o and fc1 (K 1536)
    and fc2 (K 8960, past K5's K <= 4096) takes the separate-quantize
    route; the kv_only last layer of a commit runs only its k and v; each
    prompt's cross-attention K/V run 2 K5 calls per layer (M 512)."""
    from longlive_torch.config import DiTConfig, PipelineConfig
    from longlive_torch.models.vae import VAEConfig

    layers, steps = DiTConfig().num_layers, len(PipelineConfig().denoising_step_list)
    vcfg = VAEConfig()
    n_res = 2 + len(vcfg.dim_mult) * (vcfg.num_res_blocks + 1)
    n_time = sum(vcfg.temperal_upsample[: len(vcfg.dim_mult) - 1])
    # the stages whose first res block changes width carry a shortcut; every
    # other res block is one fused_res_block under LONGLIVE_VAE_PAIR=1
    dims = [vcfg.dim * u for u in (vcfg.dim_mult[-1],) + tuple(reversed(vcfg.dim_mult))]
    n_short = sum((dims[i] // 2 if i else dims[i]) != dims[i + 1]
                  for i in range(len(vcfg.dim_mult)))
    k5_full, k5_commit = 7 * layers, 7 * (layers - 1) + 2
    # the encoder: both convs of every res block (num_res_blocks per stage,
    # two in the middle) per chunk of 1, 4, 4, ... pixel frames
    n_enc = len(vcfg.dim_mult) * vcfg.num_res_blocks + 2
    stride_t = 2 ** sum(vcfg.temperal_downsample)
    return {"block": layers * steps + layers - 1, "block_nocommit": layers * steps,
            "enc_conv": lambda frames: 2 * n_enc * (1 + (frames - 1) // stride_t),
            "recache": layers - 1,
            "conv": lambda frames: 2 * n_res + (frames - 1) * (2 * n_res + n_time),
            "pair": lambda frames: (n_res - n_short) * frames,
            "conv_pair": lambda frames: 2 * n_short + (frames - 1) * (2 * n_short + n_time),
            "k5_block": steps * k5_full + k5_commit, "k5_recache": k5_commit,
            "k5_prompt": 2 * layers,
            "fc2_block": steps * layers + layers - 1, "fc2_recache": layers - 1}


def check_video(torch, label: str, r: dict, frames: int) -> None:
    lat, px = r["latents"], r["pixels"]
    want_px = (1, 1 + 4 * (frames - 1), 3, 480, 832)
    if tuple(lat.shape) != (1, frames, 16, 60, 104) or tuple(px.shape) != want_px:
        fail(f"{label}: shapes latents {tuple(lat.shape)}, pixels {tuple(px.shape)}")
    if not (torch.isfinite(lat).all() and torch.isfinite(px).all()):
        fail(f"{label}: non-finite latents or pixels")
    if not os.path.exists(r["path"]) or os.path.getsize(r["path"]) == 0:
        fail(f"{label}: output {r['path']} missing")


def run_inference_path(torch, A, VC, label: str, config: str, attn_mode: str,
                       keep: Optional[dict] = None) -> dict:
    """``run_inference`` on ``configs/<config>`` for 15 latent frames;
    ``keep`` receives the pixels."""
    from longlive_torch import run_inference

    frames, dv = 15, derived()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(A, VC)
    t0 = time.perf_counter()
    results, text = run_captured(lambda: run_inference.main([
        "--config_path", os.path.join(ROOT, "configs", config),
        "--num_output_frames", str(frames), "--device", "cuda"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts(A, VC)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if len(results) != 1:
        fail(f"{label} wrote {len(results)} videos, expected 1")
    r = results[0]
    check_video(torch, label, r, frames)
    check_counts(label, got, expect(**{attn_mode: (frames // 3) * dv["block"]},
                                    conv=dv["conv"](frames)))
    out = {"dit_ms_per_latent_frame": profile_number(
               text, r"steady-state latency=([0-9.]+) ms/latent-frame", label),
           "decode_ms_per_latent_frame": r["decode_s"] / frames * 1e3,
           "render_ms": r["render_s"] * 1e3,
           "wall_s": wall, "peak_gib": peak, "launches": got}
    if keep is not None:
        keep["pixels"] = r["pixels"]
    log(f"{label}: {wall:.1f} s wall, peak device memory {peak:.2f} GiB, DiT "
        f"{out['dit_ms_per_latent_frame']:.2f} ms/latent-frame, decode "
        f"{out['decode_ms_per_latent_frame']:.2f} ms/latent-frame, generation + decode "
        f"{out['render_ms']:.2f} ms; output {r['path']} ({os.path.getsize(r['path'])} bytes)")
    return out


def _cli_inputs(torch, config_name: str, frames: int, segments: int):
    """Pipeline config, DiT params and the random inputs ``run_interactive``
    draws for ``segments`` prompts: the same generator sequence."""
    from longlive_torch.config import LatentGeometry, load_pipeline_config
    from longlive_torch.utils import loading

    path = config_name if os.path.isabs(config_name) else os.path.join(ROOT, "configs",
                                                                       config_name)
    config = dataclasses.replace(load_pipeline_config(path), num_output_frames=frames)
    cfg, geom = config.dit_config(), LatentGeometry()
    params = loading.load_dit_params(config, cfg, torch.bfloat16, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(config.seed)
    conds = [torch.randn((1, cfg.text_len, cfg.text_dim), generator=gen, device="cuda")
             for _ in range(segments)]
    noise = torch.randn((1, frames, geom.channels, geom.height, geom.width), generator=gen,
                        device="cuda")
    return config, cfg, params, conds, noise, gen


def run_reactive_path(torch, A, VC) -> dict:
    """An unscheduled switch on the tuned config at frame 9: the block at 9
    first replays the last 6 frames (reactive_recache_frames) under the new
    prompt.  Block times are read at each poll, after a synchronise.  The
    loop runs twice in one process: the first switch of a process is cold
    (allocator growth, first use of the replay's shapes), the second warm."""
    from longlive_torch.pipeline import InteractiveCausalInferencePipeline

    frames, switch, dv = 15, 9, derived()
    config, cfg, params, conds, noise, _ = _cli_inputs(
        torch, "longlive_inference_tuned.yaml", frames, 2)
    pipe = InteractiveCausalInferencePipeline(config, params, dit_config=cfg, device="cuda")
    cross = [pipe.prepare_condition(c) for c in conds]
    n = min(config.reactive_recache_frames, switch)
    marks = []

    def poll(s):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return cross[1] if s == switch else None

    out, lats = {"replay_frames": n}, []
    for run in ("cold", "warm"):
        marks.clear()
        gen = torch.Generator(device="cuda").manual_seed(config.seed)
        torch.cuda.reset_peak_memory_stats()
        reset_counts(A, VC)
        lat = pipe.generate_latents_reactive(noise, cross[0], poll, generator=gen)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        got = counts(A, VC)
        if tuple(lat.shape) != (1, frames, 16, 60, 104) or not torch.isfinite(lat).all():
            fail(f"reactive ({run}): latents {tuple(lat.shape)} or non-finite")
        check_counts(f"reactive ({run})", got,
                     expect(q_rope=(frames // 3) * dv["block"] + dv["recache"]))
        blocks = [b - a for a, b in zip(marks, marks[1:])]  # one per block start
        sw = switch // 3
        steady = [t for i, t in enumerate(blocks) if i >= 2 and i != sw]
        mean = sum(steady) / len(steady)
        out[run] = {"block_ms": [t * 1e3 for t in blocks], "switch_block_ms": blocks[sw] * 1e3,
                    "steady_block_ms": mean * 1e3, "switch_stall_ms": (blocks[sw] - mean) * 1e3,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        out["launches"] = got
        lats.append(lat)
        r = out[run]
        log(f"reactive ({run}): {n}-frame replay at frame {switch}: switch block "
            f"{r['switch_block_ms']:.2f} ms vs steady {r['steady_block_ms']:.2f} ms "
            f"(+{r['switch_stall_ms']:.2f} ms stall), peak device memory {r['peak_gib']:.2f} GiB")
    out["warm_vs_cold_rel_err"] = rel_err(lats[1], lats[0])
    return out


def run_interactive_paths(torch, A, VC) -> dict:
    """``run_interactive`` (``profile: true``: the one-shot recache loop)
    on the shipped interactive config cut in time to 27 frames with
    switches at 12 and 18, so the second switch's eager replay reaches into
    the first segment; then the eager-recache loop on the same inputs."""
    import yaml

    from longlive_torch import run_interactive
    from longlive_torch.pipeline import InteractiveCausalInferencePipeline

    frames, dv = 27, derived()
    with open(os.path.join(ROOT, "configs", "longlive_interactive_inference.yaml")) as f:
        raw = yaml.safe_load(f)
    raw.update(num_output_frames=frames, switch_frame_indices="12, 18")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    path = os.path.join(ROOT, "build", "chip_smoke_interactive.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)

    torch.cuda.reset_peak_memory_stats()
    reset_counts(A, VC)
    t0 = time.perf_counter()
    results, text = run_captured(lambda: run_interactive.main(
        ["--config_path", path, "--device", "cuda"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts(A, VC)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if len(results) != 1:
        fail(f"interactive wrote {len(results)} videos, expected 1")
    r = results[0]
    check_video(torch, "interactive one-shot", r, frames)
    check_counts("interactive one-shot", got, expect(bias=9 * dv["block"] + 2 * dv["recache"],
                                                      conv=dv["conv"](frames)))
    oneshot = {
        "steady_ms_per_latent_frame": profile_number(
            text, r"steady-state latency=([0-9.]+) ms/latent-frame", "interactive"),
        "switch_stall_ms": profile_number(text, r"\(\+([-0-9.]+) ms recache overhead\)",
                                          "interactive"),
        "decode_ms_per_latent_frame": r["decode_s"] / frames * 1e3,
        "wall_s": wall, "peak_gib": peak, "launches": got}
    log(f"interactive one-shot: {wall:.1f} s wall, peak device memory {peak:.2f} GiB, "
        f"steady {oneshot['steady_ms_per_latent_frame']:.2f} ms/latent-frame, switch stall "
        f"+{oneshot['switch_stall_ms']:.2f} ms; output {r['path']}")

    config, cfg, params, conds, noise, gen = _cli_inputs(torch, path, frames, 3)
    pipe = InteractiveCausalInferencePipeline(config, params, dit_config=cfg, device="cuda")
    cross = [pipe.prepare_condition(c) for c in conds]
    torch.cuda.reset_peak_memory_stats()
    reset_counts(A, VC)
    (lat, text) = run_captured(lambda: pipe.generate_latents_interactive_scanned(
        noise, cross, list(config.switch_frame_indices), generator=gen, profile=True))
    torch.cuda.synchronize()
    got = counts(A, VC)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if tuple(lat.shape) != (1, frames, 16, 60, 104) or not torch.isfinite(lat).all():
        fail(f"interactive eager: latents {tuple(lat.shape)} or non-finite")
    check_counts("interactive eager", got, expect(bias=7 * dv["block"] + 2 * dv["block_nocommit"]
                                                   + 8 * dv["recache"]))
    # before the first switch both loops compute the same blocks
    e_seg0 = rel_err(lat[:, :12], r["latents"][:, :12])
    if not e_seg0 <= 1e-2:
        fail(f"interactive eager: first segment differs from the one-shot run ({e_seg0})")
    fpb = pipe.frame_block
    eager = {
        "steady_ms_per_latent_frame": sum(pipe.last_block_times) / len(pipe.last_block_times)
        / fpb * 1e3,
        "switch_block_ms": [t * 1e3 for t in pipe.last_switch_times],
        "eager_chunk_block_ms": [t * 1e3 for t in pipe.last_eager_times],
        "switch_stall_ms": profile_number(text, r"\(\+([-0-9.]+) ms recache overhead\)",
                                          "interactive eager"),
        "first_segment_rel_err_vs_oneshot": e_seg0, "peak_gib": peak, "launches": got}
    log(f"interactive eager: peak device memory {peak:.2f} GiB, steady "
        f"{eager['steady_ms_per_latent_frame']:.2f} ms/latent-frame, switch stall "
        f"+{eager['switch_stall_ms']:.2f} ms, first segment vs one-shot rel_err {e_seg0:.2e}")
    return {"interactive_oneshot": oneshot, "interactive_eager": eager}


def run_int8_serving_path(torch, A, VC) -> dict:
    """The quantized serving mode on the tuned config: ``kv_int8: true``,
    the block linears quantized once (``quantize_dit_params``),
    ``LONGLIVE_INT8_FUSED=1`` and ``LONGLIVE_VAE_INT8=1``; 15 frames with a
    reactive switch at frame 9 (the reactive path's inputs), run twice in
    one process (cold, then warm, as the reactive path), then the VAE
    decode of the warm run.  Block times are read at each poll, after a
    synchronise.  ``loading.load_dit_params``' random init has a zero head,
    so the latents do not depend on the DiT here: the small int8 reference
    holds its numbers instead."""
    from longlive_torch.models import vae as V
    from longlive_torch.ops import quant as Q
    from longlive_torch.pipeline import InteractiveCausalInferencePipeline
    from longlive_torch.utils import loading

    frames, switch, dv = 15, 9, derived()
    blocks = frames // 3
    out = {}
    with switched(LONGLIVE_INT8_FUSED="1", LONGLIVE_VAE_INT8="1"):
        config, cfg, params, conds, noise, _ = _cli_inputs(
            torch, "longlive_inference_tuned.yaml", frames, 2)
        config = dataclasses.replace(config, kv_int8=True)
        params = Q.quantize_dit_params(params)
        pipe = InteractiveCausalInferencePipeline(config, params, dit_config=cfg, device="cuda")
        vae_params, vcfg = loading.load_vae_params(config, torch.bfloat16, "cuda")
        for run in ("cold", "warm"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(A, VC)
            cross = [pipe.prepare_condition(c) for c in conds]
            marks = []

            def poll(s):
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
                return cross[1] if s == switch else None

            gen = torch.Generator(device="cuda").manual_seed(config.seed)
            lat = pipe.generate_latents_reactive(noise, cross[0], poll, generator=gen)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            if tuple(lat.shape) != (1, frames, 16, 60, 104) or not torch.isfinite(lat).all():
                fail(f"int8 serving ({run}): latents {tuple(lat.shape)} or non-finite")
            decode_s = None
            if run == "warm":
                t0 = time.perf_counter()
                px = V.vae_decode_scan(vae_params, vcfg, lat.to(torch.bfloat16))[0]
                torch.cuda.synchronize()
                decode_s = time.perf_counter() - t0
                if (tuple(px.shape) != (1, 1 + 4 * (frames - 1), 3, 480, 832)
                        or not torch.isfinite(px).all()):
                    fail(f"int8 serving: pixels {tuple(px.shape)} or non-finite")
            got = counts(A, VC)
            check_counts(f"int8 serving ({run})", got, expect(
                qk_int8=blocks * dv["block"] + dv["recache"],
                conv_int8=dv["conv"](frames) if decode_s is not None else 0,
                k5=2 * dv["k5_prompt"] + blocks * dv["k5_block"] + dv["k5_recache"],
                route=blocks * dv["fc2_block"] + dv["fc2_recache"]))
            times = [b - a for a, b in zip(marks, marks[1:])]  # one per block
            sw = switch // 3
            steady = [t for i, t in enumerate(times) if i >= 2 and i != sw]
            mean = sum(steady) / len(steady)
            out[run] = {"dit_ms_per_latent_frame": mean / 3 * 1e3,
                        "block_ms": [t * 1e3 for t in times], "switch_block_ms": times[sw] * 1e3,
                        "switch_stall_ms": (times[sw] - mean) * 1e3,
                        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
            r = out[run]
            log(f"int8 serving ({run}): DiT {r['dit_ms_per_latent_frame']:.2f} ms/latent-frame, "
                f"switch stall +{r['switch_stall_ms']:.2f} ms (block {r['switch_block_ms']:.2f} "
                f"ms), peak device memory {r['peak_gib']:.2f} GiB")
    out.update(dit_ms_per_latent_frame=out["warm"]["dit_ms_per_latent_frame"],
               decode_ms_per_latent_frame=decode_s / frames * 1e3, launches=got)
    log(f"int8 serving: decode {out['decode_ms_per_latent_frame']:.2f} ms/latent-frame "
        f"(LONGLIVE_VAE_INT8=1)")
    return out


def run_int8_recache_path(torch, A, VC) -> dict:
    """``run_interactive`` (``profile: true``: the one-shot loop) on the
    shipped interactive config cut to 18 frames with one switch at 12 and
    ``recache_attn_impl: pallas_qk8``: the 12-frame recache runs K1 in its
    qk_int8 mode with K quantized per call on the bf16 cache."""
    import yaml

    from longlive_torch import run_interactive

    frames, dv = 18, derived()
    with open(os.path.join(ROOT, "configs", "longlive_interactive_inference.yaml")) as f:
        raw = yaml.safe_load(f)
    raw.update(num_output_frames=frames, switch_frame_indices="12",
               recache_attn_impl="pallas_qk8")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    path = os.path.join(ROOT, "build", "chip_smoke_int8_recache.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(A, VC)
    t0 = time.perf_counter()
    results, text = run_captured(lambda: run_interactive.main(
        ["--config_path", path, "--device", "cuda"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts(A, VC)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if len(results) != 1:
        fail(f"int8 recache wrote {len(results)} videos, expected 1")
    r = results[0]
    check_video(torch, "int8 recache", r, frames)
    check_counts("int8 recache", got, expect(bias=(frames // 3) * dv["block"],
                                             qk_int8=dv["recache"], conv=dv["conv"](frames)))
    out = {"steady_ms_per_latent_frame": profile_number(
               text, r"steady-state latency=([0-9.]+) ms/latent-frame", "int8 recache"),
           "switch_stall_ms": profile_number(text, r"\(\+([-0-9.]+) ms recache overhead\)",
                                             "int8 recache"),
           "decode_ms_per_latent_frame": r["decode_s"] / frames * 1e3,
           "wall_s": wall, "peak_gib": peak, "launches": got}
    log(f"int8 recache: {wall:.1f} s wall, peak device memory {peak:.2f} GiB, steady "
        f"{out['steady_ms_per_latent_frame']:.2f} ms/latent-frame, 12-frame int8 recache stall "
        f"+{out['switch_stall_ms']:.2f} ms; output {r['path']}")
    return out


def run_serving_options_path(torch, A, VC) -> dict:
    """``run_inference`` on ``configs/longlive_inference.yaml`` with
    ``kernel_cache: false`` (a copy written under ``build/``) and the four
    serving switches set for this path only: 15 latent frames, the VAE
    decode and the video.  Every self-attention is K1's two-segment mode
    with exp2 and mxu_lsum; every no-shortcut res block is one K6 launch."""
    import yaml

    from longlive_torch import run_inference

    frames, dv = 15, derived()
    with open(os.path.join(ROOT, "configs", "longlive_inference.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["kernel_cache"] = False
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    path = os.path.join(ROOT, "build", "chip_smoke_serving_options.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    label = "serving options"
    with switched(**{k: "1" for k in SWITCHES}):
        torch.cuda.reset_peak_memory_stats()
        reset_counts(A, VC)
        t0 = time.perf_counter()
        results, text = run_captured(lambda: run_inference.main([
            "--config_path", path, "--num_output_frames", str(frames), "--device", "cuda"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts(A, VC)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if len(results) != 1:
        fail(f"{label} wrote {len(results)} videos, expected 1")
    r = results[0]
    check_video(torch, label, r, frames)
    k1 = (frames // 3) * dv["block"]
    check_counts(label, got, expect(two_segment=k1, exp2=k1, mxu_lsum=k1,
                                    conv=dv["conv_pair"](frames), pair=dv["pair"](frames)))
    out = {"dit_ms_per_latent_frame": profile_number(
               text, r"steady-state latency=([0-9.]+) ms/latent-frame", label),
           "decode_ms_per_latent_frame": r["decode_s"] / frames * 1e3,
           "wall_s": wall, "peak_gib": peak, "launches": got}
    log(f"{label}: {wall:.1f} s wall, peak device memory {peak:.2f} GiB, DiT "
        f"{out['dit_ms_per_latent_frame']:.2f} ms/latent-frame, decode "
        f"{out['decode_ms_per_latent_frame']:.2f} ms/latent-frame; output {r['path']} "
        f"({os.path.getsize(r['path'])} bytes)")
    return out


def run_full_forwards_path(torch, A, VC) -> dict:
    """The full-sequence forwards at full width on random weights with
    non-zero heads: one ``dit_forward_teacher_forcing`` over the 21 frames
    of ``configs/longlive_train_init.yaml`` at 60 x 104 latents ([clean |
    noisy]: 65520 tokens; ``attn_impl="auto"``, which is K3 on the card),
    then one ``dit_forward_full`` under ``FrameMaskSpec("sink_window", 3,
    12, 3)`` over 21 frames (32760 tokens), then the teacher-forcing
    forward again under ``LONGLIVE_CROSS_FLASH=1``.  Each must give a finite
    flow of the input's shape and launch K3 once per layer, and the last K1
    as the cross-attention once per layer, and nothing else."""
    from longlive_torch.config import DiTConfig, LatentGeometry
    from longlive_torch.models import dit as D
    from longlive_torch.ops.masks import FrameMaskSpec
    from longlive_torch.ops.rope import make_rope_tables

    cfg, geom, frames = DiTConfig(), LatentGeometry(), 21
    params = D.init_dit_params(cfg, torch.bfloat16, "cuda", seed=0, zero_head=False)
    tables = make_rope_tables(cfg.head_dim, cfg.rope_max_pos, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(20)
    shape = (1, frames, geom.channels, geom.height, geom.width)
    pe = torch.randn((1, cfg.text_len, cfg.text_dim), generator=gen, device="cuda")
    noisy, clean, x = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
    t = torch.rand((1, frames), generator=gen, device="cuda") * 1000
    spec = FrameMaskSpec("sink_window", cfg.num_frame_per_block, cfg.local_attn_size,
                         cfg.sink_size)
    tf = lambda c: D.dit_forward_teacher_forcing(params, cfg, tables, noisy, clean, t, c)  # noqa: E731
    layers = cfg.num_layers
    runs = [("teacher forcing, 21 frames (65520 tokens)", "0", tf,
             expect(teacher_forcing=layers)),
            ("full, sink_window 12/3, 21 frames (32760 tokens)", "0",
             lambda c: D.dit_forward_full(params, cfg, tables, x, t, c, spec),
             expect(sink_window=layers)),
            ("teacher forcing, 21 frames, LONGLIVE_CROSS_FLASH=1", "1", tf,
             expect(teacher_forcing=layers, cross=layers))]
    out = {}
    # the path's launches: every forward's, summed
    launches = expect()
    with torch.no_grad():
        cross = D.prepare_cross_kv(params, cfg, pe, torch.bfloat16)
        for label, cross_flash, run, want in runs:
            with switched(LONGLIVE_CROSS_FLASH=cross_flash):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_counts(A, VC)
                t0 = time.perf_counter()
                flow = run(cross)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                got = counts(A, VC)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            if tuple(flow.shape) != shape or not torch.isfinite(flow).all():
                fail(f"full forwards ({label}): flow {tuple(flow.shape)} or non-finite")
            if flow.abs().max().item() == 0:
                fail(f"full forwards ({label}): the flow is zero")
            check_counts(f"full forwards ({label})", got, want)
            for name in ("flash_attention", "flash_attention_frame_masked"):
                for mode, c in got[name].items():
                    launches[name][mode] += c
            out[label] = {"wall_ms": wall * 1e3, "peak_gib": peak, "launches": got}
            log(f"full forwards ({label}): {wall * 1e3:.1f} ms wall, peak device memory "
                f"{peak:.2f} GiB, flow RMS {flow.float().square().mean().sqrt().item():.4g}")
            del flow
    out["launches"] = launches
    return out


class StubTokenizer:
    """The HF tokenizer's interface without its assets (the chip machine
    has neither ``transformers`` nor the umT5 files): each character one
    id, then padding to ``max_length``."""

    def __init__(self, vocab: int):
        self.vocab = vocab

    def __call__(self, texts, padding, truncation, max_length, return_tensors,
                 add_special_tokens):
        import numpy as np

        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros_like(ids)
        for i, text in enumerate(texts):
            toks = [1 + ord(c) % (self.vocab - 1) for c in text][:max_length]
            ids[i, :len(toks)], mask[i, :len(toks)] = toks, 1
        return {"input_ids": ids, "attention_mask": mask}


def run_text_encoder_path(torch, A, VC) -> dict:
    """umT5-XXL at full width (24 layers, dim 4096, 5.68 G parameters) in
    bf16, random weights drawn on the card: ``encode_prompts`` on 1 and 2
    prompts of 512 ids (40 and 90 valid), resident; then ``run_inference``
    on a copy of ``configs/longlive_inference.yaml`` with one prompt and
    ``load_text_encoder`` giving this encoder (a stub tokenizer): it
    encodes the prompt, moves the T5's weights to the host's pinned memory
    and generates 6 latent frames conditioned on it, with the decode; then
    ``t5_encode_streamed`` from the pinned host weights, held equal to the
    resident encode (limit 1e-2 relative) with a peak below 3 GiB above the
    memory in use when it starts."""
    import unittest.mock

    import yaml

    from longlive_torch import run_inference
    from longlive_torch.models import t5 as T5
    from longlive_torch.utils import loading

    label, frames, dv = "text encoder", 6, derived()
    tcfg = T5.T5Config()
    t0 = time.perf_counter()
    enc = T5.T5TextEncoder(T5.init_t5_params(tcfg, torch.bfloat16, "cuda", seed=11), tcfg,
                           device="cuda", tokenizer=StubTokenizer(tcfg.vocab_size))
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0}
    g = torch.Generator(device="cuda").manual_seed(12)
    ids = torch.randint(1, tcfg.vocab_size, (2, tcfg.text_len), generator=g, device="cuda")
    mask = (torch.arange(tcfg.text_len, device="cuda")[None]
            < torch.tensor([[40], [90]], device="cuda")).long()
    ids = ids * mask
    resident = {}
    for b in (1, 2):
        enc.encode_ids(ids[:b], mask[:b])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        resident[b] = enc.encode_ids(ids[:b], mask[:b])
        torch.cuda.synchronize()
        out[f"resident_ms_batch{b}"] = (time.perf_counter() - t0) * 1e3
        out[f"resident_peak_gib_batch{b}"] = torch.cuda.max_memory_allocated() / 2 ** 30
        f = resident[b]
        if (tuple(f.shape) != (b, tcfg.text_len, tcfg.dim) or not torch.isfinite(f).all()
                or f[0, 40:].any() or not f[0, :40].any()):
            fail(f"{label}: resident features {tuple(f.shape)}, non-finite or padding not zero")

    with open(os.path.join(ROOT, "configs", "longlive_inference.yaml")) as f:
        raw = yaml.safe_load(f)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    raw["data_path"] = os.path.join(ROOT, "build", "chip_smoke_prompt.txt")
    with open(raw["data_path"], "w") as f:
        f.write("A lighthouse on a cliff at night, waves breaking below, slow pan\n")
    path = os.path.join(ROOT, "build", "chip_smoke_text_encoder.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(A, VC)
    t0 = time.perf_counter()
    with unittest.mock.patch.object(loading, "load_text_encoder", lambda *a, **k: enc):
        results, text = run_captured(lambda: run_inference.main([
            "--config_path", path, "--num_output_frames", str(frames), "--device", "cuda"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts(A, VC)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if len(results) != 1 or not enc.low_memory:
        fail(f"{label}: {len(results)} videos (expected 1), T5 offloaded: {enc.low_memory}")
    check_video(torch, label, results[0], frames)
    check_counts(label, got, expect(bias=(frames // 3) * dv["block"], conv=dv["conv"](frames)))
    out.update(run_inference_wall_s=wall, run_inference_peak_gib=peak, launches=got,
               decode_ms_per_latent_frame=results[0]["decode_s"] / frames * 1e3)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    streamed = enc.encode_ids(ids, mask)
    torch.cuda.synchronize()
    out["streamed_ms_batch2"] = (time.perf_counter() - t0) * 1e3
    out["streamed_peak_above_start_gib"] = (torch.cuda.max_memory_allocated() - start) / 2 ** 30
    err = rel_err(streamed, resident[2])
    out["streamed_rel_err"] = err
    log(f"{label}: init {out['init_s']:.1f} s; resident encode_prompts "
        f"{out['resident_ms_batch1']:.1f} ms (batch 1), {out['resident_ms_batch2']:.1f} ms "
        f"(batch 2), peak {out['resident_peak_gib_batch2']:.2f} GiB; run_inference (encode, "
        f"offload, 6 frames, decode) {wall:.1f} s wall, peak {peak:.2f} GiB; streamed "
        f"{out['streamed_ms_batch2']:.1f} ms (batch 2), peak "
        f"{out['streamed_peak_above_start_gib']:.3f} GiB above its start, rel_err {err:.3e}")
    if not err <= 1e-2:
        fail(f"{label}: streamed encode disagrees with the resident one: {err} (limit 1e-2)")
    if not out["streamed_peak_above_start_gib"] < 3:
        fail(f"{label}: streamed peak {out['streamed_peak_above_start_gib']:.2f} GiB >= 3")
    return out


def run_vae_encode_path(torch, A, VC) -> dict:
    """The full Wan VAE encoder (random weights) on one 480x832 frame (the
    streaming trainer's re-encode), then 17 frames (chunks 1 + 4 x 4, 5
    latent frames): K2 launches 20 per chunk, normalised latents
    [1, T', 16, 60, 104], finite."""
    from longlive_torch.models import vae as V

    label, dv = "vae encode", derived()
    vcfg = V.VAEConfig()
    params = V.init_vae_params(vcfg, torch.bfloat16, "cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(13)
    out = {}
    with torch.no_grad():
        for frames in (1, 1, 17):  # the first call warms up
            px = (torch.rand((1, frames, 3, 480, 832), generator=g, device="cuda") * 2
                  - 1).to(torch.bfloat16)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(A, VC)
            t0 = time.perf_counter()
            mu = V.vae_encode(params, vcfg, px)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = counts(A, VC)
            latent = 1 + (frames - 1) // 4
            if tuple(mu.shape) != (1, latent, 16, 60, 104) or not torch.isfinite(mu).all():
                fail(f"{label} ({frames} frames): latents {tuple(mu.shape)} or non-finite")
            check_counts(f"{label} ({frames} frames)", got, expect(conv=dv["enc_conv"](frames)))
            out[f"{frames}_frames"] = {"ms_per_latent_frame": wall * 1e3 / latent,
                                       "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                                       "launches": got}
            log(f"{label} ({frames} frames, {latent} latent): {wall * 1e3:.1f} ms, "
                f"{wall * 1e3 / latent:.2f} ms/latent-frame, peak "
                f"{out[f'{frames}_frames']['peak_gib']:.2f} GiB")
    out["launches"] = got  # the 17-frame encode's
    return out


def assert_trees_equal(torch, got, want, what: str, path: str = "") -> None:
    """Bit equality of two parameter trees (keys, dtypes, shapes, values)."""
    if isinstance(want, dict):
        if set(got) != set(want):
            fail(f"{what}: keys differ at {path or 'the root'}: {sorted(set(got) ^ set(want))}")
        for k in want:
            assert_trees_equal(torch, got[k], want[k], what, f"{path}.{k}")
    elif isinstance(want, list):
        if len(got) != len(want):
            fail(f"{what}: {path} has {len(got)} entries, not {len(want)}")
        for i, (a, b) in enumerate(zip(got, want)):
            assert_trees_equal(torch, a, b, what, f"{path}[{i}]")
    elif want is None:
        if got is not None:
            fail(f"{what}: {path} is not None")
    elif isinstance(want, tuple):  # the int8 weights of a fused conv
        assert_trees_equal(torch, list(got), list(want), what, path)
    elif got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
        fail(f"{what}: {path} differs ({got.dtype} {tuple(got.shape)} vs {want.dtype} "
             f"{tuple(want.shape)})")


def run_checkpoint_load_path(torch, A, VC) -> dict:
    """Checkpoint loading at full width, in a temporary working directory:
    synthetic files in the reference's key layout (the port's random
    parameters, fan-in scaled, non-zero head, through ``dit_state_dict`` /
    ``vae_state_dict``): the generator as ``{"generator": sd}`` in bf16 with
    ``_fsdp_wrapped_module.`` prefixes, a PEFT LoRA of the YAML's rank 256
    on every attention and FFN linear as ``{"generator_lora": ...}`` with
    ``base_model.model.`` and ``.default`` keys, and
    ``wan_models/Wan2.1-T2V-1.3B/Wan2.1_VAE.pth`` with the encoder.  The
    loaders' trees must be bit-equal to a direct in-memory conversion of the
    same state dicts; then ``run_inference`` on a copy of
    ``configs/longlive_inference.yaml`` pointing at them runs the main path
    (15 frames, decode) with its launch counts."""
    import tempfile

    import yaml

    from longlive_torch import run_inference
    from longlive_torch.config import DiTConfig, load_pipeline_config
    from longlive_torch.models import dit as D
    from longlive_torch.models import vae as V
    from longlive_torch.utils import checkpoint as CK
    from longlive_torch.utils import loading

    label, frames, dv = "checkpoint load", 15, derived()
    cfg, vcfg = DiTConfig(), V.VAEConfig()
    with open(os.path.join(ROOT, "configs", "longlive_inference.yaml")) as f:
        raw = yaml.safe_load(f)
    rank = int(raw["adapter"]["rank"])
    cpu = lambda tree: {k: v.detach().to("cpu").contiguous() for k, v in tree.items()}  # noqa: E731
    sd = cpu(CK.dit_state_dict(D.init_dit_params(cfg, torch.bfloat16, "cuda", seed=14,
                                                 zero_head=False), cfg))
    vsd = cpu(CK.vae_state_dict(V.init_vae_params(vcfg, torch.float32, "cuda", seed=15), vcfg))
    g = torch.Generator(device="cuda").manual_seed(16)
    lora = {}
    for i in range(cfg.num_layers):
        for t in ("self_attn.q", "self_attn.k", "self_attn.v", "self_attn.o", "cross_attn.q",
                  "cross_attn.k", "cross_attn.v", "cross_attn.o", "ffn.0", "ffn.2"):
            o, n = sd[f"blocks.{i}.{t}.weight"].shape
            key = f"base_model.model.blocks.{i}.{t}.lora_%s.default.weight"
            lora[key % "A"] = torch.randn((rank, n), generator=g, device="cuda") / math.sqrt(n)
            lora[key % "B"] = torch.randn((o, rank), generator=g, device="cuda") * (
                0.02 / math.sqrt(rank))
    lora = cpu({k: v.to(torch.bfloat16) for k, v in lora.items()})
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            torch.save({"generator": {f"_fsdp_wrapped_module.{k}": v for k, v in sd.items()},
                        "step": 0}, "generator.pt")
            torch.save({"generator_lora": lora}, "lora.pt")
            os.makedirs(os.path.join("wan_models", "Wan2.1-T2V-1.3B"))
            torch.save(vsd, os.path.join("wan_models", "Wan2.1-T2V-1.3B", "Wan2.1_VAE.pth"))
            out["write_s"] = time.perf_counter() - t0
            raw.update(generator_ckpt="generator.pt", lora_ckpt="lora.pt", data_path=None,
                       output_folder="videos")
            with open("inference.yaml", "w") as f:
                yaml.safe_dump(raw, f)
            config = load_pipeline_config("inference.yaml")
            t0 = time.perf_counter()
            params = loading.load_dit_params(config, cfg, torch.bfloat16, "cuda")
            torch.cuda.synchronize()
            out["dit_load_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            vae_params, _ = loading.load_vae_params(config, torch.bfloat16, "cuda")
            torch.cuda.synchronize()
            out["vae_load_s"] = time.perf_counter() - t0
            direct = CK.dit_params_from_torch(
                CK.fold_lora_into_dit_sd(sd, lora, alpha_over_rank=1.0), cfg, torch.bfloat16,
                "cuda")
            assert_trees_equal(torch, params, direct, f"{label}: the loaded DiT")
            if torch.equal(direct["blocks"][0]["ffn"]["fc1"]["weight"],
                           CK.dit_params_from_torch(sd, cfg, torch.bfloat16, "cuda")[
                               "blocks"][0]["ffn"]["fc1"]["weight"]):
                fail(f"{label}: the LoRA fold changed nothing")
            assert_trees_equal(torch, vae_params,
                               CK.vae_params_from_torch(vsd, vcfg, torch.bfloat16, "cuda"),
                               f"{label}: the loaded VAE")
            del params, vae_params, direct
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(A, VC)
            t0 = time.perf_counter()
            results, text = run_captured(lambda: run_inference.main([
                "--config_path", "inference.yaml", "--num_output_frames", str(frames),
                "--device", "cuda"]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = counts(A, VC)
            if len(results) != 1:
                fail(f"{label} wrote {len(results)} videos, expected 1")
            check_video(torch, label, results[0], frames)
        finally:
            os.chdir(ROOT)
    check_counts(label, got, expect(bias=(frames // 3) * dv["block"], conv=dv["conv"](frames)))
    out.update(run_inference_wall_s=wall, launches=got,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               dit_ms_per_latent_frame=profile_number(
                   text, r"steady-state latency=([0-9.]+) ms/latent-frame", label))
    log(f"{label}: wrote the files in {out['write_s']:.1f} s; load_dit_params (with the "
        f"rank-{rank} LoRA fold) {out['dit_load_s']:.2f} s, load_vae_params "
        f"{out['vae_load_s']:.2f} s, both bit-equal to a direct conversion; run_inference "
        f"{wall:.1f} s wall (loading included), DiT {out['dit_ms_per_latent_frame']:.2f} "
        f"ms/latent-frame, peak {out['peak_gib']:.2f} GiB")
    return out


# ---------------------------------------------------------------------------
# phase 3b: K4 checks at the training path's shapes


def train_attention_cases(torch):
    """K4's four shape classes on the training path (B 1, 12 heads of 128):
    (label, Sq, Skv, kv_valid or None).  The rollout's self-attention is
    the last block of a 21-frame rollout: the 21-frame cache (window 12,
    the block's own slots excluded: sink 3 + 6 recent frames valid) beside
    the fresh 3-frame block."""
    from longlive_torch.config import CacheConfig
    from longlive_torch.ops import kv_cache as kvc

    fs = 1560
    cc = CacheConfig(sink_frames=3, ring_frames=18, frame_seq=fs)
    state = kvc.KVCache(k=torch.empty(0), v=torch.empty(0), ring_base=3, sink_filled=3,
                        ring_filled=15)
    cache_valid = kvc.validity_mask(cc, state, 18, 3, window_frames=12, device="cuda",
                                    exclude_block=True)
    rollout_valid = torch.cat([cache_valid, torch.ones(3 * fs, dtype=torch.bool, device="cuda")])
    return [
        ("rollout self: 3-frame block over the 21-frame cache + block", 3 * fs, 24 * fs,
         rollout_valid[None]),
        ("rollout cross: 3-frame block over 512 text tokens", 3 * fs, 512, None),
        ("critic/teacher self: 21 frames over 21 frames", 21 * fs, 21 * fs, None),
        ("critic/teacher cross: 21 frames over 512 text tokens", 21 * fs, 512, None),
        ("streaming rollout self over the wrapped ring: frames 24-26 after the recache at 21 "
         "(valid slots 0-5, 18-20)", 3 * fs, 24 * fs, wrapped_ring_valid(torch)[None]),
    ]


def wrapped_ring_valid(torch):
    """The kv mask of the streaming rollout's block at frames 24-26 (the
    critic's chunk after the switch at 21 in the "streaming" path): the
    recache packed frames 0-20 from slot 0 (ring base 3), frames 21-23
    went to slots 3-5, so the 12-frame window (sink 3 + frames 18-23)
    lives in slots 0-5 and 18-20, out of slot order, beside the block."""
    from longlive_torch.config import CacheConfig
    from longlive_torch.ops import kv_cache as kvc

    fs = 1560
    cc = CacheConfig(sink_frames=3, ring_frames=18, frame_seq=fs)
    state = kvc.KVCache(k=torch.empty(0), v=torch.empty(0), ring_base=3, sink_filled=3,
                        ring_filled=18)
    cache_valid = kvc.validity_mask(cc, state, 24, 3, window_frames=12, device="cuda",
                                    exclude_block=True)
    slots = torch.nonzero(cache_valid.view(21, fs)[:, 0]).flatten().tolist()
    if slots != [0, 1, 2, 3, 4, 5, 18, 19, 20]:
        fail(f"wrapped-ring mask: valid slots {slots}")
    return torch.cat([cache_valid, torch.ones(3 * fs, dtype=torch.bool, device="cuda")])


def train_attention_bounds(b: int, sq: int, skv: int, n: int, d: int, nvalid: int):
    """K4's bounds, (least ms, "operations" or "bytes") for its forward, dQ
    and dK/dV kernels: 4, 6 and 8 units of B N Sq Skv_valid D operations;
    bytes: the forward reads q, k, v and writes out, lse; dQ reads q, k, v,
    out, dout, lse and writes dq, delta; dK/dV reads q, k, v, dout, lse,
    delta and writes dk, dv."""
    work = b * n * sq * nvalid * d
    qe, ke, rows = b * sq * n * d, b * skv * n * d, 4 * b * n * sq
    return (bound(4.0 * work, 2 * (2 * qe + 2 * ke) + rows),
            bound(6.0 * work, 2 * (4 * qe + 2 * ke) + 2 * rows),
            bound(8.0 * work, 2 * (2 * qe + 4 * ke) + 2 * rows))


def check_train_attention(torch, A):
    """K4's forward kernel and its two backward kernels (dQ with Delta, then
    dK/dV) against their plain versions at each shape class, with times of
    the kernels, the plain versions, the bound, and
    ``scaled_dot_product_attention`` (forward; its backward as one
    ``torch.autograd.grad`` call).  The plain backward and the library's
    compute dq, dk and dv in one call: both backward entries carry that
    call's time.  Bounds count valid kv tokens only: forward 4 B N Sq Skv D
    operations, dQ 6 (S recomputed, dP, dQ), dK/dV 8 (S, dP, dV, dK).  The
    log line of each case also gives the share of each kernel's kv tiles
    that the mask leaves live, computed from the mask by the kernels' rule
    (``train_kv_tile_states`` at the tiles ``train_kv_tiles`` reads from
    the library), not measured: the forward and dQ kernels skip the dead
    tiles, a dK/dV CTA over a dead tile only writes zeros."""
    import torch.nn.functional as F

    b, n, d, bf = 1, 12, 128, torch.bfloat16
    tiles = A.train_kv_tiles()
    g = torch.Generator(device="cuda").manual_seed(7)
    fwd_cases, dq_cases, dkdv_cases = [], [], []
    for label, sq, skv, valid in train_attention_cases(torch):
        q, k, v, dout = (torch.randn((b, s, n, d), generator=g, device="cuda").to(bf)
                         for s in (sq, skv, skv, sq))
        nvalid = skv if valid is None else int(valid.sum())
        live = {kind: float((A.train_kv_tile_states(valid, skv, tile) != A.TILE_DEAD)
                            .float().mean())
                for kind, tile in tiles.items() if kind != "max_listed"}
        out, lse = A.flash_attention_train_forward(q, k, v, valid)
        dq, delta = A.flash_attention_train_backward_dq(q, k, v, out, lse, dout, valid)
        dk, dv = A.flash_attention_train_backward_dkdv(q, k, v, out, lse, dout, delta, valid)
        torch.cuda.synchronize()
        ref, ref_lse = A.flash_attention_train_plain(q, k, v, valid)
        rdq, rdk, rdv = A.flash_attention_train_backward_plain(q, k, v, ref, ref_lse, dout, valid)
        torch.cuda.synchronize()
        for name, t in (("out", out), ("dq", dq), ("dk", dk), ("dv", dv)):
            if not torch.isfinite(t).all():
                fail(f"flash_attention_train ({label}): non-finite {name}")
        f_err, f_tol, f_rel = agreement(out, ref)
        lse_err = (lse - ref_lse).abs().max().item()
        grads = [agreement(x, y) for x, y in ((dq, rdq), (dk, rdk), (dv, rdv))]
        del ref, ref_lse, rdq, rdk, rdv
        fwd_ms = cuda_ms(torch, lambda: A.flash_attention_train_forward(q, k, v, valid), 5)
        dq_ms = cuda_ms(torch, lambda: A.flash_attention_train_backward_dq(
            q, k, v, out, lse, dout, valid), 5)
        dkdv_ms = cuda_ms(torch, lambda: A.flash_attention_train_backward_dkdv(
            q, k, v, out, lse, dout, delta, valid), 5)
        plain_fwd = cuda_ms(torch, lambda: A.flash_attention_train_plain(q, k, v, valid), 1)
        plain_bwd = cuda_ms(torch, lambda: A.flash_attention_train_backward_plain(
            q, k, v, out, lse, dout, valid), 1)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        mask4 = None if valid is None else valid[:, None, None, :]
        lib_fwd = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask4), 5)
        lo = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask4)
        dot = dout.transpose(1, 2)
        lib_bwd = cuda_ms(torch, lambda: torch.autograd.grad(lo, (qt, kt, vt), dot,
                                                             retain_graph=True), 5)
        (tb_f, by_f), (tb_q, by_q), (tb_k, by_k) = train_attention_bounds(b, sq, skv, n, d,
                                                                           nvalid)
        log(f"flash_attention_train {label}: forward max_abs_err={f_err:.3e} tol={f_tol:.3e} "
            f"rel_rms_err={f_rel:.3e} lse max_abs_err={lse_err:.3e}; backward (dq, dk, dv) "
            + ", ".join(f"{e:.3e}/{t:.3e}/{r:.3e}" for e, t, r in grads)
            + f"; ms fwd={fwd_ms:.4f} dq={dq_ms:.4f} dkdv={dkdv_ms:.4f} plain fwd={plain_fwd:.2f} "
            f"bwd={plain_bwd:.2f} library fwd={lib_fwd:.4f} bwd={lib_bwd:.4f} bound "
            f"fwd={tb_f:.4f} ({by_f}) dq={tb_q:.4f} ({by_q}) dkdv={tb_k:.4f} ({by_k}); the "
            "mask's live kv tile share "
            + ", ".join(f"{kind} {share:.3f}" for kind, share in live.items()))
        if not (f_err <= f_tol and f_rel <= REL_RMS_LIMIT and lse_err <= 1e-2):
            fail(f"flash_attention_train forward ({label}) disagrees with its plain version: "
                 f"max_abs_err {f_err} (limit {f_tol}), rel_rms_err {f_rel}, lse {lse_err}")
        for name, (e, t, r) in zip(("dq", "dk", "dv"), grads):
            if not (e <= t and r <= REL_RMS_LIMIT):
                fail(f"flash_attention_train backward ({label}) {name} disagrees with its "
                     f"plain version: max_abs_err {e} (limit {t}), rel_rms_err {r}")
        common = {"case": label, "q": [b, sq, n, d], "kv": [b, skv, n, d],
                  "valid_tokens": nvalid}
        fwd_cases.append(dict(common, max_abs_err=f_err, tolerance=f_tol, rel_rms_err=f_rel,
                              ms=fwd_ms, plain_ms=plain_fwd, library_ms=lib_fwd,
                              bound_ms=tb_f, bound_by=by_f))
        (qe, qt_, qr), (ke, kt_, kr), (ve, vt_, vr) = grads
        dq_cases.append(dict(common, max_abs_err=qe, tolerance=qt_, rel_rms_err=qr, ms=dq_ms,
                             plain_ms=plain_bwd, library_ms=lib_bwd, bound_ms=tb_q,
                             bound_by=by_q))
        worst = max(((ke, kt_), (ve, vt_)), key=lambda et: et[0] / et[1])
        dkdv_cases.append(dict(common, max_abs_err=worst[0], tolerance=worst[1],
                               rel_rms_err=max(kr, vr), ms=dkdv_ms, plain_ms=plain_bwd,
                               library_ms=lib_bwd, bound_ms=tb_k, bound_by=by_k))
        del q, k, v, dout, out, lse, dq, dk, dv, delta, qt, kt, vt, lo
        torch.cuda.empty_cache()

    def entry(name, cases, what):
        head = cases[2]  # the critic's self-attention, the largest call
        # the case nearest its own limit (outputs, so limits, differ by shape)
        worst = max(cases, key=lambda c: c["max_abs_err"] / c["tolerance"])
        return {
            "name": name, "route": "cuda",
            "source": "longlive_torch/csrc/flash_attention_train.cu",
            "replaces": "longlive_tpu/ops/attention.py:1012",
            "max_abs_err": worst["max_abs_err"], "tolerance": worst["tolerance"],
            "worst_case": worst["case"],
            "rel_rms_err": max(c["rel_rms_err"] for c in cases),
            "rel_rms_limit": REL_RMS_LIMIT,
            "ms": head["ms"], "kernel_ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "unit": f"one {what} call at the critic's self-attention (32760 over 32760)",
            "cases": cases,
        }

    return (entry("flash_attention_train", fwd_cases, "forward"),
            entry("flash_attention_train_bwd_dq", dq_cases,
                  "dQ kernel (plain_ms and library_ms: the whole backward)"),
            entry("flash_attention_train_bwd_dkdv", dkdv_cases,
                  "dK/dV kernel (plain_ms and library_ms: the whole backward)"))


# ---------------------------------------------------------------------------
# phase 4b: small-input training reference


def check_small_training(torch):
    """One train step (generator and critic) of a small model on the GPU
    (float32 parameters, bf16 autocast, kernels) against the CPU (float32,
    plain versions), the same draws.  Losses and grad norms within 5e-2
    relative (bf16 operands).  The change of the parameters, p1 - p0, within
    UPDATE_LIMIT of the CPU's change (relative, over each model): a step
    that made no update reads 1 and one with the wrong sign 2.  The
    learning rates are raised so that the change stands clear of float32
    rounding; AdamW's first step with beta1 = 0 moves each element by
    ~lr * sign(grad), so elements whose gradient is below bf16's noise may
    flip, and that is what the reading measures."""
    from longlive_torch.config import DiTConfig, LatentGeometry
    from longlive_torch.models import dit as D
    from longlive_torch.training.trainer import (ScoreDistillationTrainer, TrainerConfig,
                                                 map_tree, param_leaves)

    cfg = DiTConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=2, in_dim=16, out_dim=16,
                    text_dim=64, text_len=16, freq_dim=64, local_attn_size=2, sink_size=1,
                    num_frame_per_block=1, rope_max_pos=64)
    geom = LatentGeometry(height=10, width=12)
    tcfg = TrainerConfig(num_frame_per_block=1, num_training_frames=3,
                         min_num_training_frames=3, slice_last_frames=3,
                         dfake_gen_update_ratio=1, lr=1e-4, lr_critic=3e-5)
    g = torch.Generator().manual_seed(8)
    noise = torch.randn((1, 3, 16, geom.height, geom.width), generator=g)
    pc, pu = (torch.randn((1, cfg.text_len, cfg.text_dim), generator=g) for _ in range(2))
    models = [D.init_dit_params(cfg, torch.float32, "cpu", seed=s, zero_head=False)
              for s in (3, 4, 5)]
    runs = {}
    draws = None
    for dev in ("cpu", "cuda"):
        copies = (map_tree(lambda t: t.detach().to(dev, copy=True), m) for m in models)
        tr = ScoreDistillationTrainer(tcfg, cfg, geom, *copies, device=dev)
        draws = draws or tr.sample_draws(noise.shape, 0)
        runs[dev] = (tr.train_step(noise, pc, pu, draws), tr)
    (mc, tc), (mg, tg) = runs["cpu"], runs["cuda"]
    errs = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-12)
            for k in ("generator_loss", "critic_loss", "generator_grad_norm", "critic_grad_norm")}
    flat = lambda tree: torch.cat([t.detach().flatten().cpu() for t in param_leaves(tree)])  # noqa: E731
    for key, p0 in (("gen_params", models[0]), ("critic_params", models[1])):
        d_gpu, d_cpu = flat(tg.state[key]) - flat(p0), flat(tc.state[key]) - flat(p0)
        errs[f"{key} change"] = ((d_gpu - d_cpu).norm() / d_cpu.norm()).item()
    log(f"small training reference (GPU bf16 kernels vs CPU float32 plain; limits 5e-2 for "
        f"losses and grad norms, {UPDATE_LIMIT} for the parameters' change, where no update "
        "reads 1): " + ", ".join(f"{k} rel_err={v:.3e}" for k, v in errs.items()))
    bad = {k: v for k, v in errs.items()
           if not v <= (UPDATE_LIMIT if k.endswith("change") else 5e-2)}
    if bad or not all(math.isfinite(mg[k]) for k in errs if not k.endswith("change")):
        fail(f"small training reference disagrees: {bad}")


# ---------------------------------------------------------------------------
# phase 5e: the training path at full width


def derived_train_launches(layers: int, blocks: int, gen_exit, critic_exits,
                           teacher_layers: int = 0) -> dict:
    """K4 launches of ``run_train`` steps, from the model: a rollout block
    runs (exit + 1) forwards of every layer's self- and cross-attention and
    a commit over all but the last layer; the DMD loss runs the critic and
    the (cond + uncond batched) teacher once each, the teacher over its own
    ``teacher_layers`` (default: the generator's); the generator's replay
    reruns the rollout, and its exit forwards are recomputed under
    checkpointing and differentiated; the critic's loss forward likewise.
    ``gen_exit``: None, an exit, or a list of them (one generator update
    per micro-step)."""
    L, nb, TL = layers, blocks, teacher_layers or layers

    def rollout(e):
        return nb * (2 * L * (e + 1) + 2 * (L - 1))

    fwd = bwd = 0
    for e in ([] if gen_exit is None else gen_exit if isinstance(gen_exit, list) else [gen_exit]):
        fwd += rollout(e) + 2 * L + 2 * TL + nb * (2 * L * e + 4 * L + 2 * (L - 1))
        bwd += nb * 2 * L
    for e in critic_exits:
        fwd += rollout(e) + 4 * L
        bwd += 2 * L
    return {"fwd": fwd, "bwd_dq": bwd, "bwd_dkdv": bwd}


def run_training_path(torch, A, VC, card: str) -> dict:
    """``run_train`` on ``configs/longlive_train_init.yaml`` at full width
    (21 frames, 7 blocks) for 2 steps: step 0 trains the generator and the
    critic, step 1 the critic.  ``phase_ledger`` is switched on in a copy
    of the config for the phase split; no checkpoint is written."""
    from longlive_torch.config import DiTConfig

    path, raw = _train_yaml("chip_smoke_train.yaml", "longlive_train_init.yaml",
                            phase_ledger=True)
    trainer, rows, wall, got, serving, peak = _run_train_rows(
        torch, A, VC, path, os.path.join(ROOT, "build", "chip_smoke_train"), 2)
    del trainer
    if [r["step"] for r in rows] != [0, 1]:
        fail(f"training: logged steps {[r['step'] for r in rows]}, expected [0, 1]")
    if "generator_loss" not in rows[0] or "generator_loss" in rows[1]:
        fail("training: step 0 must train the generator and the critic, step 1 the critic")
    losses = {f"step {r['step']} {k}": r[k] for r in rows
              for k in ("generator_loss", "critic_loss", "generator_grad_norm",
                        "critic_grad_norm") if k in r}
    if not all(math.isfinite(v) for v in losses.values()):
        fail(f"training: non-finite losses {losses}")
    fpb = int(raw["num_frame_per_block"])
    want = derived_train_launches(DiTConfig().num_layers, int(raw["num_training_frames"]) // fpb,
                                  rows[0]["exit_idx"],
                                  [r["critic_exit_idx"] for r in rows])
    log(f"training: launches {json.dumps(got)} (want {json.dumps(want)}; exits: generator "
        f"{rows[0]['exit_idx']}, critic {[r['critic_exit_idx'] for r in rows]})")
    if got != want:
        fail(f"training: K4 launch counts {got} != {want}")
    if serving != expect():
        fail(f"training: serving kernels launched {serving}")
    if peak >= 80:
        fail(f"training: peak device memory {peak:.2f} GiB")
    steps = [{"step_s": sum(r["phase_ms"].values()) / 1e3, "phase_ms": r["phase_ms"]}
             for r in rows]
    for r, s in zip(rows, steps):
        log(f"training step {r['step']}: {s['step_s']:.2f} s "
            f"({', '.join(f'{k} {v:.0f} ms' for k, v in s['phase_ms'].items())})")
    log(f"training on {card}: {wall:.1f} s wall for set-up and 2 steps, peak device "
        f"memory {peak:.2f} GiB; " + ", ".join(f"{k} {v:.6g}" for k, v in losses.items()))
    return {"wall_s": wall, "peak_gib": peak, "steps": steps, "losses": losses,
            "launches": got, "frames": int(raw["num_training_frames"])}


def run_live_training_step(torch, A, VC, card: str) -> dict:
    """One step (generator and critic) of the trainer ``run_train`` builds
    for ``configs/longlive_train_init.yaml``, on full-width models with
    non-zero heads (seeds 0, 2, 1 for generator, critic, teacher), so that
    every K4 backward of the step carries a gradient.  Fails unless the
    losses and grad norms are finite and the grad norms non-zero, every
    parameter is finite afterwards, the first layer of the generator and of
    the critic took an AdamW step (``adam_rms``: the RMS of the change less
    the weight decay, over lr; 0 without a gradient, ~1 for AdamW's
    sign-like first step where |grad| >> eps; the limit is 0.1, above the
    ~1e-2 that float32 rounding of the decay alone can read), and the K4
    launches are as derived."""
    import yaml

    from longlive_torch.config import LatentGeometry, pipeline_config_from_dict
    from longlive_torch.models import dit as D
    from longlive_torch.run_train import build_trainer_config
    from longlive_torch.training.trainer import ScoreDistillationTrainer, param_leaves

    with open(os.path.join(ROOT, "configs", "longlive_train_init.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["phase_ledger"] = True
    tcfg = build_trainer_config(raw)
    cfg, geom = pipeline_config_from_dict(raw).dit_config(), LatentGeometry()
    torch.cuda.reset_peak_memory_stats()
    gen, critic, teacher = (D.init_dit_params(cfg, torch.float32, "cuda", seed=s,
                                              zero_head=False) for s in (0, 2, 1))
    tr = ScoreDistillationTrainer(tcfg, cfg, geom, gen, critic, teacher, device="cuda")
    g = torch.Generator().manual_seed(11)
    noise = torch.randn((1, tcfg.num_training_frames, geom.channels, geom.height, geom.width),
                        generator=g)
    pc, pu = (torch.randn((1, cfg.text_len, cfg.text_dim), generator=g) for _ in range(2))
    watched = {("generator", tcfg.lr): (gen, [("self_attn", "q"), ("cross_attn", "k")]),
               ("critic", tcfg.lr_critic): (critic, [("self_attn", "q"), ("cross_attn", "v")])}
    before = {(who, lr, a, b): m["blocks"][0][a][b]["weight"].detach().clone()
              for (who, lr), (m, names) in watched.items() for a, b in names}
    reset_counts(A, VC)
    m = tr.train_step(noise, pc, pu)
    torch.cuda.synchronize()
    got = dict(A.train_launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    adam_rms = {}
    for (who, lr, a, b), p0 in before.items():
        p1 = watched[(who, lr)][0]["blocks"][0][a][b]["weight"].detach()
        step = (p1 - p0 * (1 - lr * tcfg.weight_decay)) / lr
        adam_rms[f"{who} block 0 {a}.{b}"] = step.pow(2).mean().sqrt().item()
    finite = all(bool(torch.isfinite(t).all()) for t in param_leaves(gen) + param_leaves(critic))
    norms = {k: m[k] for k in ("generator_loss", "critic_loss", "generator_grad_norm",
                               "critic_grad_norm", "dmdtrain_gradient_norm")}
    want = derived_train_launches(cfg.num_layers,
                                  tcfg.num_training_frames // tcfg.num_frame_per_block,
                                  m["exit_idx"], [m["critic_exit_idx"]])
    step_s = sum(m["phase_ms"].values()) / 1e3
    log(f"training, non-zero heads, on {card}: {step_s:.2f} s "
        f"({', '.join(f'{k} {v:.0f} ms' for k, v in m['phase_ms'].items())}), peak "
        f"{peak:.2f} GiB; exits generator {m['exit_idx']}, critic {m['critic_exit_idx']}; "
        + ", ".join(f"{k} {v:.6g}" for k, v in norms.items()) + "; AdamW step / lr RMS: "
        + ", ".join(f"{k} {v:.3f}" for k, v in adam_rms.items())
        + f"; launches {json.dumps(got)} (want {json.dumps(want)})")
    if not all(math.isfinite(v) for v in norms.values()) or not finite:
        fail(f"training, non-zero heads: non-finite values {norms}, parameters finite: {finite}")
    if not all(norms[k] > 0 for k in ("generator_grad_norm", "critic_grad_norm",
                                      "dmdtrain_gradient_norm")):
        fail(f"training, non-zero heads: a zero gradient {norms}")
    if not all(v > 0.1 for v in adam_rms.values()):
        fail(f"training, non-zero heads: a first layer took no AdamW step {adam_rms}")
    if got != want:
        fail(f"training, non-zero heads: K4 launch counts {got} != {want}")
    return {"step_s": step_s, "phase_ms": m["phase_ms"], "peak_gib": peak, "norms": norms,
            "adam_step_rms_over_lr": adam_rms, "launches": got}


# ---------------------------------------------------------------------------
# phase 4c and 5f: streaming long tuning with LoRA


def check_small_streaming(torch):
    """One streaming step with rank-8 LoRA adapters on the generator and the
    critic (generator and critic, ratio 1) of a small model on the GPU
    (float32 bases, bf16 adapters, bf16 autocast, kernels) against the CPU
    (float32 adapters, plain versions), the same draws and the same
    adapters' init: the generator's chunk is 3 fresh frames, the critic's 2
    new frames after 1 overlap frame (re-encoded through a VAE at widths
    where K2 takes its convs) under a switch at frame 4 (the recache, K1).
    Losses and grad norms within 5e-2 relative; the adapters' change within
    UPDATE_LIMIT (as ``check_small_training``; A moves by the weight decay
    alone on a first step, which bf16 rounds away, so B's change carries
    the reading)."""
    from longlive_torch.config import DiTConfig, LatentGeometry
    from longlive_torch.models import dit as D
    from longlive_torch.models import vae as V
    from longlive_torch.training.streaming import StreamingConfig, StreamingTrainer
    from longlive_torch.training.trainer import TrainerConfig, map_tree, param_leaves

    cfg = DiTConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=2, in_dim=16, out_dim=16,
                    text_dim=64, text_len=16, freq_dim=64, local_attn_size=2, sink_size=1,
                    num_frame_per_block=1, rope_max_pos=64)
    geom = LatentGeometry(height=16, width=24)
    vcfg = dataclasses.replace(V.tiny_vae_config(), dim=96, z_dim=16)  # widths 96/192: fused
    vp32 = V.init_vae_params(vcfg, torch.float32, "cpu", seed=24)
    scfg = StreamingConfig(chunk_size=3, max_length=8, min_new_frame=2, switch_choices=(4,))
    g = torch.Generator().manual_seed(9)
    pc, pu, ps = (torch.randn((1, cfg.text_len, cfg.text_dim), generator=g) for _ in range(3))
    models = [D.init_dit_params(cfg, torch.float32, "cpu", seed=s, zero_head=False)
              for s in (3, 4, 5)]
    runs = {}
    for dev, ldt in (("cpu", "float32"), ("cuda", "bfloat16")):
        tcfg = TrainerConfig(num_frame_per_block=1, num_training_frames=3,
                             min_num_training_frames=3, slice_last_frames=3,
                             dfake_gen_update_ratio=1, lr=1e-4, lr_critic=3e-5, lora_rank=8,
                             lora_alpha=8.0, lora_dtype=ldt)
        copies = (map_tree(lambda t: t.detach().to(dev, copy=True), m) for m in models)
        vp = vp32 if dev == "cpu" else V.pack_fused_weights(to_dev(vp32, dev, torch.bfloat16))
        tr = StreamingTrainer(tcfg, cfg, geom, *copies, device=dev, streaming_cfg=scfg,
                              vae_params=vp, vae_cfg=vcfg)
        before = {k: map_tree(lambda t: t.detach().to("cpu", torch.float32, copy=True),
                              tr.state[k]) for k in ("gen_lora", "critic_lora")}
        tr.start_new_sequence(pc, pu, prompt_switch=ps, switch_choice=0)
        m = tr.streaming_train_step()
        runs[dev] = (m, tr, before)
    (mc, tc, bc), (mg, tg, bg) = runs["cpu"], runs["cuda"]
    if not (mg["switched"] and mg["overlap"] == 1 and mg["current_length"] == 5
            and all(mg[k] == mc[k] for k in ("exit_idx", "gen_exit_idx"))):
        fail(f"small streaming reference: chunk state {mg} (CPU {mc})")
    errs = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-12)
            for k in ("generator_loss", "critic_loss", "gen_generator_grad_norm",
                      "critic_grad_norm")}
    flat = lambda tree: torch.cat([t.detach().float().flatten().cpu()  # noqa: E731
                                   for t in param_leaves(tree)])
    for key in ("gen_lora", "critic_lora"):
        d_gpu = flat(tg.state[key]) - flat(bg[key])
        d_cpu = flat(tc.state[key]) - flat(bc[key])
        errs[f"{key} change"] = ((d_gpu - d_cpu).norm() / d_cpu.norm()).item()
    log("small streaming LoRA reference (GPU bf16 kernels vs CPU float32 plain; limits 5e-2 "
        f"for losses and grad norms, {UPDATE_LIMIT} for the adapters' change): "
        + ", ".join(f"{k} rel_err={v:.3e}" for k, v in errs.items()))
    bad = {k: v for k, v in errs.items()
           if not v <= (UPDATE_LIMIT if k.endswith("change") else 5e-2)}
    if bad or not all(math.isfinite(mg[k]) for k in errs if not k.endswith("change")):
        fail(f"small streaming reference disagrees: {bad}")
    return errs


def derived_streaming_launches(layers: int, chunks) -> dict:
    """K4 launches of streaming steps: ``chunks`` lists each update as
    (trains the generator, rollout blocks, exit step); each counts as the
    batch trainer's update of that many blocks (``derived_train_launches``:
    the DMD and critic forwards run over the whole chunk, overlap frames
    included, in the same number of launches)."""
    total = {"fwd": 0, "bwd_dq": 0, "bwd_dkdv": 0}
    for gen, blocks, exit_idx in chunks:
        one = derived_train_launches(layers, blocks, exit_idx if gen else None,
                                     [] if gen else [exit_idx])
        total = {k: total[k] + one[k] for k in total}
    return total


def _stream_chunks(rows, fpb: int):
    """(trains the generator, blocks, exit) of each update of the logged
    streaming steps, in order."""
    out = []
    for r in rows:
        if "generator_loss" in r:
            out.append((True, r["gen_new_frames"] // fpb, r["gen_exit_idx"]))
        out.append((False, (r["new_frames"] - r.get("gen_new_frames", 0)) // fpb,
                    r["exit_idx"]))
    return out


def run_streaming_path(torch, A, VC, card: str) -> dict:
    """``run_train`` on ``configs/longlive_train_long.yaml`` (streaming long
    tuning, rank-256 LoRA on the generator and the critic, generator, critic
    and teacher all 1.3B) for 3 steps, two depth cuts in a copy of the
    config: ``streaming_max_length`` 60 of 240 (so that step 2 starts a new
    sequence) and ``switch_choices`` [21], the first of its eleven (so that
    the second chunk switches prompts and runs the recache).  Step 0 trains
    the generator on a 21-frame chunk, then the critic on 18 new frames
    after 3 overlap frames (re-encoded: a one-frame decode and encode, K2
    28 + 20) after the 21-frame recache (K1 bias, 29 layers: its last layer
    writes K/V only); step 1 the critic on 18 more; step 2 the critic on a
    new sequence's first chunk.  K4's launches are derived from the logged
    exits; K1 and K2 counted exactly; no other serving kernel."""
    from longlive_torch.config import DiTConfig
    from longlive_torch.training.trainer import param_leaves

    path, raw = _train_yaml("chip_smoke_train_long.yaml", "longlive_train_long.yaml",
                            streaming_max_length=60, switch_choices=[21], phase_ledger=True)
    log("streaming: configs/longlive_train_long.yaml cut to streaming_max_length 60 (of 240) "
        "and switch_choices [21] (the first of 11), 3 steps, no checkpoint")
    trainer, rows, wall, got, serving, peak = _run_train_rows(
        torch, A, VC, path, os.path.join(ROOT, "build", "chip_smoke_train_long"), 3)
    lora_params = sum(t.numel() for k in ("gen_lora", "critic_lora")
                      for t in param_leaves(trainer.state[k]))
    del trainer
    state = [(r.get("gen_current_length"), r.get("gen_overlap"), r.get("gen_switched"),
              r["current_length"], r["overlap"], r["switched"]) for r in rows]
    want_state = [(21, 0, False, 39, 3, True), (None, None, None, 57, 3, False),
                  (None, None, None, 21, 0, False)]
    log(f"streaming: (gen current_length, overlap, switched; critic's) per step {state}")
    if [r["step"] for r in rows] != [0, 1, 2] or state != want_state:
        fail(f"streaming: steps {[r['step'] for r in rows]}, chunk state {state}, "
             f"expected {want_state}")
    losses = {f"step {r['step']} {k}": r[k] for r in rows
              for k in ("generator_loss", "critic_loss", "gen_generator_grad_norm",
                        "critic_grad_norm") if k in r}
    if not all(math.isfinite(v) for v in losses.values()):
        fail(f"streaming: non-finite losses {losses}")
    fpb = int(raw["num_frame_per_block"])
    chunks = _stream_chunks(rows, fpb)
    want = derived_streaming_launches(DiTConfig().num_layers, chunks)
    want_serving = expect(bias=DiTConfig().num_layers - 1, conv=2 * (28 + 20))
    log(f"streaming: K4 launches {json.dumps(got)} (want {json.dumps(want)}; updates "
        f"(generator, blocks, exit) {chunks})")
    if got != want:
        fail(f"streaming: K4 launch counts {got} != {want}")
    check_counts("streaming", serving, want_serving)
    if peak >= 80:
        fail(f"streaming: peak device memory {peak:.2f} GiB")
    steps = [{"step_s": sum(r["phase_ms"].values()) / 1e3, "phase_ms": r["phase_ms"]}
             for r in rows]
    for r, st in zip(rows, steps):
        log(f"streaming step {r['step']}: {st['step_s']:.2f} s "
            f"({', '.join(f'{k} {v:.0f} ms' for k, v in st['phase_ms'].items())})")
    log(f"streaming on {card}: {wall:.1f} s wall for set-up and 3 steps, peak device memory "
        f"{peak:.2f} GiB, {lora_params} adapter parameters (generator + critic); "
        + ", ".join(f"{k} {v:.6g}" for k, v in losses.items()))
    return {"wall_s": wall, "peak_gib": peak, "steps": steps, "losses": losses,
            "chunk_state": state, "train_launches": got, "launches": serving,
            "adapter_params": lora_params}


def run_live_streaming_step(torch, A, VC, card: str) -> dict:
    """One streaming step (generator, then critic) of the trainer
    ``run_train`` builds for ``configs/longlive_train_long.yaml`` (rank-256
    LoRA on both), on full-width models with non-zero heads (seeds 0, 2, 1
    for generator, critic, teacher; ``run_train``'s random init gives the
    teacher and critic zero heads, which zeroes every adapter's gradient)
    and the Wan VAE (random, bf16): a 21-frame chunk, then 18 new frames
    after 3 overlap frames re-encoded.  Fails unless the losses and grad
    norms are finite and non-zero and layer 0's ``lora_b`` of the generator
    and of the critic moved off zero (AdamW moves an element only where its
    gradient is non-zero; A's gradient carries B = 0 on this first step),
    and the launches are as derived."""
    import yaml

    from longlive_torch.config import LatentGeometry, pipeline_config_from_dict
    from longlive_torch.models import dit as D
    from longlive_torch.models import vae as V
    from longlive_torch.run_train import build_trainer_config
    from longlive_torch.training.streaming import StreamingConfig, StreamingTrainer

    with open(os.path.join(ROOT, "configs", "longlive_train_long.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["phase_ledger"] = True
    tcfg = build_trainer_config(raw)
    cfg, geom = pipeline_config_from_dict(raw).dit_config(), LatentGeometry()
    torch.cuda.reset_peak_memory_stats()
    gen, critic, teacher = (D.init_dit_params(cfg, torch.float32, "cuda", seed=s,
                                              zero_head=False) for s in (0, 2, 1))
    vcfg = V.VAEConfig()
    vae = V.init_vae_params(vcfg, torch.bfloat16, "cuda", seed=0)
    tr = StreamingTrainer(tcfg, cfg, geom, gen, critic, teacher, device="cuda",
                          streaming_cfg=StreamingConfig(max_length=60), vae_params=vae,
                          vae_cfg=vcfg)
    g = torch.Generator().manual_seed(12)
    pc, pu = (torch.randn((1, cfg.text_len, cfg.text_dim), generator=g) for _ in range(2))
    tr.start_new_sequence(pc, pu)
    reset_counts(A, VC)
    m = tr.streaming_train_step()
    torch.cuda.synchronize()
    got = dict(A.train_launches)
    serving = counts(A, VC)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    moved = {}
    for who in ("gen_lora", "critic_lora"):
        for grp, name in (("self_attn", "q"), ("cross_attn", "k"), ("ffn", "fc2")):
            b = tr.state[who][0][grp][name]["lora_b"].detach()
            moved[f"{who} layer 0 {grp}.{name} lora_b nonzero share"] = (
                (b != 0).float().mean().item())
    norms = {k: m[k] for k in ("generator_loss", "critic_loss", "gen_generator_grad_norm",
                               "critic_grad_norm", "gen_dmdtrain_gradient_norm")}
    want = derived_streaming_launches(cfg.num_layers, _stream_chunks([m], tcfg.num_frame_per_block))
    step_s = sum(m["phase_ms"].values()) / 1e3
    log(f"streaming, non-zero heads, on {card}: {step_s:.2f} s "
        f"({', '.join(f'{k} {v:.0f} ms' for k, v in m['phase_ms'].items())}), peak "
        f"{peak:.2f} GiB; exits generator {m['gen_exit_idx']}, critic {m['exit_idx']}; "
        + ", ".join(f"{k} {v:.6g}" for k, v in norms.items()) + "; "
        + ", ".join(f"{k} {v:.3f}" for k, v in moved.items())
        + f"; launches {json.dumps(got)} (want {json.dumps(want)})")
    if not all(math.isfinite(v) for v in norms.values()):
        fail(f"streaming, non-zero heads: non-finite values {norms}")
    if not all(norms[k] > 0 for k in ("gen_generator_grad_norm", "critic_grad_norm",
                                      "gen_dmdtrain_gradient_norm")):
        fail(f"streaming, non-zero heads: a zero gradient {norms}")
    if not all(v > 0.5 for v in moved.values()):
        fail(f"streaming, non-zero heads: a layer-0 lora_b took no gradient {moved}")
    if got != want:
        fail(f"streaming, non-zero heads: K4 launch counts {got} != {want}")
    check_counts("streaming, non-zero heads", serving, expect(conv=28 + 20))
    return {"step_s": step_s, "phase_ms": m["phase_ms"], "peak_gib": peak, "norms": norms,
            "lora_b_nonzero_share": moved, "train_launches": got, "launches": serving}


# ---------------------------------------------------------------------------
# phase 4d and 5y/5z: the vanilla Wan samplers (run_t2v, text- and image-to-video)

SAMPLER_STEPS = 4  # of run_t2v's 50: the per-step time gives the rest


def _no_train_launches(A, label: str) -> None:
    if any(A.train_launches.values()):
        fail(f"{label}: the training attention (K4) launched {dict(A.train_launches)}")


def check_small_samplers(torch, A, VC) -> dict:
    """The bidirectional samplers on small inputs, GPU (bf16, kernels) vs
    CPU (float32, plain versions): ``Text2VideoPipeline`` under UniPC and
    ``Image2VideoPipeline`` under DPM++ (3 steps each; head dim 128, 10 x
    12 latents: 30 tokens a frame, ragged tiles), the i2v conditioning
    made from a 37 x 53 image resized to 20 x 24: CLIP features (a
    3-layer CLIP at width 64) and the first-frame encode (the VAE at widths
    96/192, where K2 takes its convs).  Each GPU sampler launches K1 once
    per layer and step as the self-attention and once (t2v) or twice (i2v)
    as the cross-attention, and no K4."""
    from longlive_torch.config import DiTConfig
    from longlive_torch.models import clip as C
    from longlive_torch.models import dit as D
    from longlive_torch.models import vae as V
    from longlive_torch.pipeline import Image2VideoPipeline, Text2VideoPipeline
    from longlive_torch.pipeline.image2video import encode_first_frame_condition

    steps, frames = 3, 5  # pixel frames; 3 latent frames (the VAE's time stride is 2)
    vcfg = dataclasses.replace(V.tiny_vae_config(), dim=96, z_dim=16)
    ccfg = C.CLIPVisionConfig(image_size=28, patch_size=14, dim=64, mlp_ratio=2, num_heads=4,
                              num_layers=3, out_dim=16)
    base = dict(dim=256, ffn_dim=512, num_heads=2, num_layers=2, out_dim=16, text_dim=64,
                text_len=16, freq_dim=64, local_attn_size=-1, sink_size=0, rope_max_pos=64)
    t2v_cfg = DiTConfig(in_dim=16, **base)
    i2v_cfg = DiTConfig(in_dim=16 + 2 + 16, model_type="i2v", clip_dim=ccfg.dim, **base)
    t2v32 = D.init_dit_params(t2v_cfg, torch.float32, "cpu", seed=3, zero_head=False)
    i2v32 = D.init_dit_params(i2v_cfg, torch.float32, "cpu", seed=4, zero_head=False)
    vp32 = V.init_vae_params(vcfg, torch.float32, "cpu", seed=5)
    cp32 = C.init_clip_vision_params(ccfg, torch.float32, "cpu", seed=6)
    g = torch.Generator().manual_seed(24)
    cond, null = (torch.randn((1, 16, 64), generator=g) for _ in range(2))
    noise = torch.randn((1, 3, 16, 10, 12), generator=g)
    img = torch.rand((1, 3, 37, 53), generator=g) * 2 - 1
    layers = base["num_layers"]
    out, errs = {}, {}
    for dev, dt in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
        r = {}
        with torch.no_grad():
            pipe = Text2VideoPipeline(to_dev(t2v32, dev, dt), t2v_cfg, device=dev)
            reset_counts(A, VC)
            r["t2v latents"] = pipe.generate_latents(cond, null, noise, sampling_steps=steps,
                                                     solver="unipc", dtype=dt)
            r["t2v launches"] = counts(A, VC)
            _no_train_launches(A, f"small t2v sampler ({dev})")
            vp = to_dev(vp32, dev, dt)
            vp = V.pack_fused_weights(vp) if dev == "cuda" else vp32
            im = C.resize_bicubic(img.to(dev), 20, 24)
            r["CLIP features"] = C.encode_image(to_dev(cp32, dev, dt), ccfg, im)
            r["first-frame condition"] = encode_first_frame_condition(vp, vcfg, im.to(dt), frames)
            pipe = Image2VideoPipeline(to_dev(i2v32, dev, dt), i2v_cfg, device=dev)
            reset_counts(A, VC)
            r["i2v latents"] = pipe.generate_latents(cond, null, r["CLIP features"],
                                                     r["first-frame condition"], noise,
                                                     sampling_steps=steps, solver="dpm++",
                                                     dtype=dt)
            r["i2v launches"] = counts(A, VC)
            _no_train_launches(A, f"small i2v sampler ({dev})")
        out[dev] = r
    check_counts("small t2v sampler, GPU", out["cuda"]["t2v launches"],
                 expect(bias=layers * steps, cross=layers * steps))
    check_counts("small i2v sampler, GPU", out["cuda"]["i2v launches"],
                 expect(bias=layers * steps, cross=2 * layers * steps))
    for key in ("t2v latents", "CLIP features", "first-frame condition", "i2v latents"):
        if not torch.isfinite(out["cuda"][key].float()).all():
            fail(f"small samplers ({key}): non-finite GPU output")
        errs[key] = rel_err(out["cuda"][key], out["cpu"][key])
    log("small sampler reference (GPU bf16 kernels vs CPU float32 plain; limit 5e-2): "
        + ", ".join(f"{k} rel_err={v:.3e}" for k, v in errs.items()))
    bad = {k: v for k, v in errs.items() if not v <= 5e-2}
    if bad:
        fail(f"small sampler reference disagrees (limit 5e-2): {bad}")
    return errs


@contextlib.contextmanager
def random_base_dit(torch):
    """``loading.load_base_dit``'s random init (seeded as the loader seeds
    it, resident or ``on_host``) with non-zero heads: its own zeroes the
    head, and with it every flow prediction."""
    import unittest.mock

    from longlive_torch.models import dit as D

    init = D.init_dit_params
    with unittest.mock.patch.object(D, "init_dit_params",
                                    lambda *a, **k: init(*a, **{**k, "zero_head": False})):
        yield


def _sampler_path(torch, A, VC, label: str, run, want: dict, steps: int = SAMPLER_STEPS,
                  keep_latents: bool = False) -> dict:
    """Runs ``run()`` (a ``run_t2v`` record of ``steps`` steps) at full
    width with the counts set to 0 just before it; checks the video's
    shapes and file, the launches against ``want`` and that K4 never
    launched.  ``keep_latents``: the latents (on the host) in the record as
    ``latents_cpu``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(A, VC)
    t0 = time.perf_counter()
    with random_base_dit(torch):
        r = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts(A, VC)
    _no_train_launches(A, label)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    lat, px = r["latents"], r["pixels"]
    if tuple(lat.shape) != (1, 21, 16, 60, 104) or tuple(px.shape) != (1, 81, 3, 480, 832):
        fail(f"{label}: shapes latents {tuple(lat.shape)}, pixels {tuple(px.shape)}")
    if not (torch.isfinite(lat.float()).all() and torch.isfinite(px).all()):
        fail(f"{label}: non-finite latents or pixels")
    if lat.float().std().item() == 0 or px.std().item() == 0:
        fail(f"{label}: constant latents or pixels")
    if not os.path.exists(r["path"]) or os.path.getsize(r["path"]) == 0:
        fail(f"{label}: output {r['path']} missing")
    check_counts(label, got, want)
    out = {"steps": steps, "ms_per_step": r["ms_per_step"], "sample_s": r["sample_s"],
           "condition_s": r["condition_s"], "decode_s": r["decode_s"],
           "projected_50_step_s": r["ms_per_step"] * 50 / 1e3, "wall_s": wall, "peak_gib": peak,
           "launches": got}
    if keep_latents:
        out["latents_cpu"] = lat.cpu()
    log(f"{label}: {wall:.1f} s wall, {steps} steps at {r['ms_per_step']:.1f} ms/step "
        f"(50 steps: {out['projected_50_step_s']:.1f} s), conditioning "
        f"{r['condition_s'] * 1e3:.1f} ms, decode of 21 latent frames {r['decode_s'] * 1e3:.1f} "
        f"ms, peak device memory {peak:.2f} GiB; output {r['path']}")
    return out


def _t2v_argv(solver: str, name: str, steps: int = SAMPLER_STEPS) -> list:
    return ["--prompt", "a fox runs through the snow", "--size", "832x480", "--frame_num", "81",
            "--steps", str(steps), "--solver", solver, "--seed", "0",
            "--output", os.path.join(ROOT, "build", name), "--device", "cuda"]


def run_t2v_path(torch, A, VC) -> dict:
    """``run_t2v.main`` at Wan2.1-T2V-1.3B width, 832x480, 81 frames (21
    latent frames, 32760 tokens a sample), UniPC for SAMPLER_STEPS steps:
    random weights with non-zero heads, a random prompt embedding and a
    zero negative one (no assets), cond and uncond in one batch of 2; then
    the decode and the video.  K1: per step 30 self-attentions and 30
    text cross-attentions; K2: the decode's 28 + 30 x 20."""
    from longlive_torch import run_t2v

    dv, layers = derived(), 30
    return _sampler_path(
        torch, A, VC, "t2v", lambda: run_t2v.main(_t2v_argv("unipc", "chip_smoke_t2v.mp4")),
        expect(bias=layers * SAMPLER_STEPS, cross=layers * SAMPLER_STEPS, conv=dv["conv"](21)))


def run_i2v_path(torch, A, VC) -> dict:
    """``run_t2v`` in its image-to-video mode at full width: the i2v DiT
    (in_dim 36), a random full-width CLIP ViT-H/14 (32 layers, dim 1280,
    257 tokens), a seeded synthetic 720x1280 image (resized to 480x832,
    and to 224x224 for CLIP), the first-frame condition from an 81-frame
    encode (21 chunks), DPM++ for SAMPLER_STEPS steps, the decode and the
    video.  Driven through ``run_t2v.generate`` (the card's machine may
    have no image reader).  K1: per step 30 self-attentions and 60
    cross-attentions (text and image); K2: 21 x 20 in the encode and 628 in
    the decode."""
    import numpy as np

    from longlive_torch import run_t2v

    dv, layers = derived(), 30
    rng = np.random.default_rng(25)
    # a smooth seeded image: a colour gradient with noise
    yy, xx = np.meshgrid(np.linspace(-1, 1, 720), np.linspace(-1, 1, 1280), indexing="ij")
    image = np.stack([yy, xx, yy * xx]) * 0.8 + 0.1 * rng.standard_normal((3, 720, 1280))
    image = np.clip(image, -1, 1).astype(np.float32)[None]
    args = run_t2v.parse_args(_t2v_argv("dpm++", "chip_smoke_i2v.mp4"))
    return _sampler_path(
        torch, A, VC, "i2v", lambda: run_t2v.generate(args, image),
        expect(bias=layers * SAMPLER_STEPS, cross=2 * layers * SAMPLER_STEPS,
               conv=dv["enc_conv"](81) + dv["conv"](21)))


# ---------------------------------------------------------------------------
# phase 3 (K4 at the 14B teacher's shapes), 4e and 5l-5o: the single-card
# training levers, the host-streamed Wan2.1-T2V-14B teacher, t2v offload

TEACHER_14B = "Wan2.1-T2V-14B"


def check_train_attention_14b(torch, A, fwd_entry: dict) -> None:
    """K4's forward at the streamed 14B teacher's shapes (cond and uncond in
    a batch of 2, 40 heads of 128, 21 frames of 1560 tokens): its
    self-attention (32760 over 32760) and its cross-attention (32760 over
    512 text tokens), against the plain version, with the kernel's, the
    plain version's and ``scaled_dot_product_attention``'s times and the
    bound.  The teacher runs without gradient: forward only.  The cases
    join the forward entry's."""
    import torch.nn.functional as F

    from longlive_torch.config import WAN_MODEL_CONFIGS

    b, n, d, bf = 2, WAN_MODEL_CONFIGS[TEACHER_14B]["num_heads"], 128, torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(19)
    for label, sq, skv in (("14B teacher self: 2 x 21 frames over 21 frames, 40 heads",
                            21 * 1560, 21 * 1560),
                           ("14B teacher cross: 2 x 21 frames over 512 text tokens, 40 heads",
                            21 * 1560, 512)):
        q, k, v = (torch.randn((b, s, n, d), generator=g, device="cuda").to(bf)
                   for s in (sq, skv, skv))
        out, lse = A.flash_attention_train_forward(q, k, v, None)
        (ref, ref_lse), plain_ms = timed_once(torch, lambda: A.flash_attention_train_plain(
            q, k, v, None))
        if not torch.isfinite(out).all():
            fail(f"flash_attention_train ({label}): non-finite output")
        err, tol, rel = agreement(out, ref)
        lse_err = (lse - ref_lse).abs().max().item()
        del ref, ref_lse
        ms = cuda_ms(torch, lambda: A.flash_attention_train_forward(q, k, v, None), 3)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), 3)
        tb, by = train_attention_bounds(b, sq, skv, n, d, skv)[0]
        log(f"flash_attention_train {label}: forward max_abs_err={err:.3e} tol={tol:.3e} "
            f"rel_rms_err={rel:.3e} lse max_abs_err={lse_err:.3e}; ms={ms:.4f} plain={plain_ms:.2f} "
            f"library={lib_ms:.4f} bound={tb:.4f} ({by})")
        if not (err <= tol and rel <= REL_RMS_LIMIT and lse_err <= 1e-2):
            fail(f"flash_attention_train forward ({label}) disagrees with its plain version: "
                 f"max_abs_err {err} (limit {tol}), rel_rms_err {rel}, lse {lse_err}")
        fwd_entry["cases"].append({"case": label, "q": [b, sq, n, d], "kv": [b, skv, n, d],
                                   "valid_tokens": skv, "max_abs_err": err, "tolerance": tol,
                                   "rel_rms_err": rel, "ms": ms, "plain_ms": plain_ms,
                                   "library_ms": lib_ms, "bound_ms": tb, "bound_by": by})
        del q, k, v, out, lse, qt, kt, vt
        torch.cuda.empty_cache()
    worst = max(fwd_entry["cases"], key=lambda c: c["max_abs_err"] / c["tolerance"])
    fwd_entry.update(max_abs_err=worst["max_abs_err"], tolerance=worst["tolerance"],
                     worst_case=worst["case"],
                     rel_rms_err=max(c["rel_rms_err"] for c in fwd_entry["cases"]))


LEVER_RUNS = {
    "host optimiser, paged and streamed teacher": dict(
        opt_on_host=True, opt_async=True, staged_phases=True, teacher_stream=True,
        page_generator=True),
    "int8 rollout cache, 2-step accumulation": dict(cache_int8=True,
                                                    gradient_accumulation_steps=2),
}


def check_small_levers(torch) -> dict:
    """Two steps of a small model's trainer with the single-card levers on
    the GPU (bf16 autocast, kernels; pinned host copies, the copy stream,
    the background critic update) against the CPU (float32, plain
    versions), the same draws: the losses and grad norms within 5e-2
    relative (where the step reports them) and the change of the
    parameters within UPDATE_LIMIT, as ``check_small_training``."""
    from longlive_torch.config import DiTConfig, LatentGeometry
    from longlive_torch.models import dit as D
    from longlive_torch.training.trainer import (ScoreDistillationTrainer, TrainerConfig,
                                                 map_tree, param_leaves)

    cfg = DiTConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=2, in_dim=16, out_dim=16,
                    text_dim=64, text_len=16, freq_dim=64, local_attn_size=2, sink_size=1,
                    num_frame_per_block=1, rope_max_pos=64)
    geom = LatentGeometry(height=10, width=12)
    g = torch.Generator().manual_seed(9)
    noise = torch.randn((1, 3, 16, geom.height, geom.width), generator=g)
    pc, pu = (torch.randn((1, cfg.text_len, cfg.text_dim), generator=g) for _ in range(2))
    models = [D.init_dit_params(cfg, torch.float32, "cpu", seed=s, zero_head=False)
              for s in (3, 4, 5)]
    flat = lambda tree: torch.cat([t.detach().flatten().cpu() for t in param_leaves(tree)])  # noqa: E731
    out = {}
    for label, options in LEVER_RUNS.items():
        tcfg = TrainerConfig(num_frame_per_block=1, num_training_frames=3,
                             min_num_training_frames=3, slice_last_frames=3,
                             dfake_gen_update_ratio=1, lr=1e-4, lr_critic=3e-5, **options)
        runs, draws = {}, None
        for dev in ("cpu", "cuda"):
            copies = (map_tree(lambda t: t.detach().to(dev, copy=True), m) for m in models)
            tr = ScoreDistillationTrainer(tcfg, cfg, geom, *copies, device=dev)
            draws = draws or [tr.sample_draws(noise.shape, i) for i in range(2)]
            ms = [tr.train_step(noise, pc, pu, d) for d in draws]
            ms[-1].update(tr.finish_pending())
            runs[dev] = (ms, tr)
        (mc, tc), (mg, tg) = runs["cpu"], runs["cuda"]
        errs = {f"step {i} {k}": abs(g_[k] - c_[k]) / max(abs(c_[k]), 1e-12)
                for i, (g_, c_) in enumerate(zip(mg, mc))
                for k in ("generator_loss", "critic_loss", "generator_grad_norm",
                          "critic_grad_norm") if k in c_}
        for key, p0 in (("gen_params", models[0]), ("critic_params", models[1])):
            d_gpu, d_cpu = flat(tg.state[key]) - flat(p0), flat(tc.state[key]) - flat(p0)
            errs[f"{key} change"] = ((d_gpu - d_cpu).norm() / d_cpu.norm()).item()
        log(f"small lever reference ({label}; GPU bf16 kernels vs CPU float32 plain; limits "
            f"5e-2, {UPDATE_LIMIT} for the parameters' change): "
            + ", ".join(f"{k} rel_err={v:.3e}" for k, v in errs.items()))
        bad = {k: v for k, v in errs.items()
               if not v <= (UPDATE_LIMIT if k.endswith("change") else 5e-2)}
        if bad:
            fail(f"small lever reference ({label}) disagrees: {bad}")
        out[label] = errs
    return out


def host_available_gib() -> float:
    """The host's available memory (``/proc/meminfo`` MemAvailable), GiB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2 ** 20
    fail("/proc/meminfo has no MemAvailable line")


@contextlib.contextmanager
def host_memory_watch(period_s: float = 0.1):
    """Yields a dict whose ``min_gib`` is the least host memory available
    (``/proc/meminfo`` MemAvailable) seen while the block runs, sampled
    every ``period_s`` on a thread of its own."""
    import threading

    seen = {"min_gib": host_available_gib()}
    stop = threading.Event()

    def sample():
        while not stop.wait(period_s):
            seen["min_gib"] = min(seen["min_gib"], host_available_gib())

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield seen
    finally:
        stop.set()
        thread.join()
        seen["min_gib"] = min(seen["min_gib"], host_available_gib())


def float32_tree_gib(torch, cfg) -> tuple:
    """(one block, everything but the blocks) of a DiT tree at ``cfg``'s
    widths in float32, GiB, from a one-layer build on the card."""
    from longlive_torch.models import dit as D
    from longlive_torch.utils import memory as M

    one = D.init_dit_params(dataclasses.replace(cfg, num_layers=1), torch.float32, "cuda")
    block = M.hbm_bytes(one["blocks"]) / 2 ** 30
    rest = M.hbm_bytes({k: v for k, v in one.items() if k != "blocks"}) / 2 ** 30
    del one
    torch.cuda.empty_cache()
    return block, rest


# Host memory the 14B teacher's run takes beyond its trees (the arena's
# last, partly filled slab and the run's own host tensors): 2.34 GiB
# measured on an H100 host with 96 GiB; the run prints what it measured.
HOST_SLACK_GIB = 3.0


def empty_host_cache(torch) -> None:
    """Returns the pinned memory PyTorch's caching host allocator holds to
    the host (earlier paths pinned weights; the 14B teacher needs the
    room)."""
    for name in ("_host_emptyCache", "_accelerator_emptyHostCache"):
        fn = getattr(torch._C, name, None)
        if fn is not None:
            fn()
            return


def teacher_14b_config(num_layers=None):
    from longlive_torch.config import WAN_MODEL_CONFIGS, DiTConfig

    geo = dict(WAN_MODEL_CONFIGS[TEACHER_14B])
    if num_layers is not None:
        geo["num_layers"] = num_layers
    return dataclasses.replace(DiTConfig(), **geo)


def check_streamed_teacher(torch, card: str) -> dict:
    """The streamed teacher pass at the 14B's width on 4 of its 40 layers:
    ``teacher_real_x0(streamed=True)`` (blocks in pinned host memory, one
    layer copied ahead of its compute) bit-equal to the resident pass on
    the same tree, under the trainer's autocast, with both wall times (the
    copies should hide behind the compute) and the peaks."""
    from longlive_torch.config import LatentGeometry
    from longlive_torch.ops import scheduler as S
    from longlive_torch.ops.rope import make_rope_tables
    from longlive_torch.training import dmd
    from longlive_torch.utils import loading
    from longlive_torch.utils import memory as M

    cfg = teacher_14b_config(num_layers=4)
    geom = LatentGeometry()
    host = loading.load_base_dit("wan_models/none", cfg, torch.float32, "cuda", seed=7,
                                 on_host=True)
    # a non-zero head (the random init zeroes it) so that every output element moves
    host["head"]["head"]["weight"].normal_(0.0, 0.02)
    streamed_tree = M.blocks_to_host(host, "cuda")
    sched = S.make_schedule(1000, shift=5.0, sigma_min=0.0, extra_one_step=True, training=True)
    tables = make_rope_tables(cfg.head_dim, cfg.rope_max_pos, device="cuda")
    g = torch.Generator().manual_seed(21)
    lat = torch.randn((1, 21, geom.channels, geom.height, geom.width), generator=g).cuda()
    pc, pu = (torch.randn((1, cfg.text_len, cfg.text_dim), generator=g).cuda() for _ in range(2))
    st, sn = torch.tensor([600]), torch.randn(lat.shape, generator=g)
    dcfg = dmd.DMDConfig()
    auto = lambda: torch.autocast("cuda", dtype=torch.bfloat16, cache_enabled=False)  # noqa: E731
    out, times, peaks = {}, {}, {}
    for name in ("streamed", "resident", "streamed again"):
        tree = streamed_tree if name.startswith("streamed") else M.fetch_from_host(host, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with auto():
            out[name] = dmd.teacher_real_x0(tree, cfg, tables, sched, dcfg, lat, pc, pu, st, sn,
                                            streamed=name.startswith("streamed"))
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        del tree
    equal = torch.equal(out["streamed again"], out["resident"])
    layer_gib = M.hbm_bytes(host["blocks"][0]) / 2 ** 30
    log(f"streamed 14B-width teacher (4 of 40 layers, {layer_gib:.3f} GiB a layer in float32) on "
        f"{card}: bit-equal to the resident pass: {equal}; wall ms streamed {times['streamed']:.1f} "
        f"(first call) / {times['streamed again']:.1f}, resident {times['resident']:.1f}; peak "
        f"above the inputs GiB streamed {peaks['streamed again']:.2f}, resident "
        f"{peaks['resident']:.2f}")
    if not torch.isfinite(out["resident"]).all() or out["resident"].std().item() == 0:
        fail("streamed 14B-width teacher: the resident pass is non-finite or constant")
    if not equal:
        diff = (out["streamed again"] - out["resident"]).abs().max().item()
        fail(f"streamed 14B-width teacher: differs from the resident pass by {diff}")
    return {"layers": 4, "layer_gib": layer_gib, "streamed_ms": times["streamed again"],
            "streamed_first_ms": times["streamed"], "resident_ms": times["resident"],
            "peak_gib": peaks, "bit_equal": equal}


def _train_yaml(name: str, base: str, **overrides):
    """(path, config): ``configs/<base>`` with ``overrides``, written to
    ``build/<name>``."""
    import yaml

    with open(os.path.join(ROOT, "configs", base)) as f:
        raw = yaml.safe_load(f)
    raw.update(overrides)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    path = os.path.join(ROOT, "build", name)
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path, raw


def _run_train_rows(torch, A, VC, path: str, logdir: str, steps: int):
    """``run_train.main`` for ``steps`` steps with the counts set to 0 just
    before; (trainer, logged rows, wall s, K4 launches, serving launches,
    device peak GiB)."""
    import shutil

    from longlive_torch import run_train

    shutil.rmtree(logdir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(A, VC)
    t0 = time.perf_counter()
    trainer, _ = run_captured(lambda: run_train.main([
        "--config_path", path, "--logdir", logdir, "--allow_random_weights", "--max_iters",
        str(steps), "--no_auto_resume", "--no_save", "--device", "cuda"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got, serving = dict(A.train_launches), counts(A, VC)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return trainer, rows, wall, got, serving, peak


def run_teacher_14b_path(torch, A, VC, card: str) -> dict:
    """``run_train`` on ``configs/longlive_train_init.yaml`` (21 frames,
    generator and critic at 1.3B) with the teacher its own comment names,
    ``real_name: Wan2.1-T2V-14B`` (dim 5120, 40 heads, 40 layers), streamed
    from pinned host memory (``teacher_stream``, ``staged_phases``), the
    generator paged out during the DMD loss (``page_generator``), the int8
    rollout cache and 2-step gradient accumulation, for 2 micro-steps: one
    optimiser update, both micro-steps training the generator and the
    critic.  Random weights (``--allow_random_weights``) with non-zero
    heads, so that the teacher's x0 depends on every streamed layer: each
    streamed pass's flow must be finite and not constant.  Fails with a
    clear message when the host lacks the memory of the run's host trees
    (the teacher's blocks, 52.4 GiB in float32, and the generator's EMA
    and page-out copies) and HOST_SLACK_GIB beside them; prints the host
    memory before and after the teacher is built and at its least during
    the run, the phases, the peak, the page-out's freed bytes against the
    generator's, and the K4 launches against the derived counts (the
    teacher's share 40 self- plus 40 cross-attention forwards per
    pass)."""
    import unittest.mock

    from longlive_torch.config import DiTConfig
    from longlive_torch.training import dmd
    from longlive_torch.utils import loading
    from longlive_torch.utils import memory as M

    cfg14 = teacher_14b_config()
    block14, _ = float32_tree_gib(torch, cfg14)
    block13, rest13 = float32_tree_gib(torch, DiTConfig())
    trees = {"teacher blocks": block14 * cfg14.num_layers,
             "generator EMA": block13 * DiTConfig().num_layers + rest13}
    trees["generator page-out"] = trees["generator EMA"]
    need = sum(trees.values()) + HOST_SLACK_GIB
    empty_host_cache(torch)
    avail = host_available_gib()
    log(f"14B teacher: host memory available {avail:.2f} GiB; the run's host trees in float32 "
        + ", ".join(f"{k} {v:.2f}" for k, v in trees.items())
        + f" GiB, with {HOST_SLACK_GIB} GiB beside them {need:.2f} GiB in all")
    if avail < need:
        fail(f"14B teacher: the host has {avail:.2f} GiB available, the streamed 14B teacher "
             f"needs {need:.2f} GiB of host memory")
    host_mem = {}
    real_load = loading.load_base_dit

    def load(model_dir, cfg, *args, **kw):
        if kw.get("on_host"):
            host_mem["before_gib"] = host_available_gib()
            t0 = time.perf_counter()
            out = real_load(model_dir, cfg, *args, **kw)
            host_mem["build_s"] = time.perf_counter() - t0
            host_mem["after_gib"] = host_available_gib()
            host_mem["blocks_gib"] = M.hbm_bytes(out["blocks"]) / 2 ** 30
            return out
        return real_load(model_dir, cfg, *args, **kw)

    path, _ = _train_yaml("chip_smoke_teacher_14b.yaml", "longlive_train_init.yaml",
                       real_name=TEACHER_14B, teacher_stream=True, staged_phases=True,
                       page_generator=True, cache_int8=True, gradient_accumulation_steps=2,
                       phase_ledger=True)
    log("14B teacher: configs/longlive_train_init.yaml with real_name Wan2.1-T2V-14B, "
        "teacher_stream, staged_phases, page_generator, cache_int8, "
        "gradient_accumulation_steps 2; 2 micro-steps (one optimiser update), no checkpoint")
    flows = []
    real_streamed = dmd.bidirectional_forward_streamed

    def streamed(*args, **kw):
        out = real_streamed(*args, **kw)
        flows.append({"finite": bool(torch.isfinite(out).all()), "std": out.float().std().item()})
        return out

    # non-zero heads: the random init's zero heads make the teacher's flow
    # zero, and its x0 independent of the 40 streamed layers
    with unittest.mock.patch.object(loading, "load_base_dit", load), \
            unittest.mock.patch.object(dmd, "bidirectional_forward_streamed", streamed), \
            random_base_dit(torch), host_memory_watch() as watch:
        trainer, rows, wall, got, serving, peak = _run_train_rows(
            torch, A, VC, path, os.path.join(ROOT, "build", "chip_smoke_teacher_14b"), 2)
    if trainer.teacher_cfg.dim != cfg14.dim or trainer.teacher_cfg.num_layers != cfg14.num_layers:
        fail(f"14B teacher: the trainer's teacher is {trainer.teacher_cfg}")
    on_host = trainer.teacher_params["blocks"][0]["ffn"]["fc1"]["weight"]
    if on_host.device.type != "cpu" or not on_host.is_pinned():
        fail("14B teacher: the teacher's blocks are not in pinned host memory")
    gen_bytes = M.hbm_bytes(trainer.state["gen_params"])
    del trainer, on_host
    gc.collect()
    empty_host_cache(torch)
    host_mem["min_gib"] = watch["min_gib"]
    host_mem["peak_use_gib"] = host_mem["before_gib"] - watch["min_gib"]
    host_mem["trees_gib"] = sum(trees.values())
    log(f"14B teacher: host memory available {host_mem['before_gib']:.2f} GiB before the "
        f"teacher, {watch['min_gib']:.2f} at the least (sampled every 0.1 s): the run took "
        f"{host_mem['peak_use_gib']:.2f} GiB at its peak, its trees {host_mem['trees_gib']:.2f}")
    log(f"14B teacher: the streamed passes' flow {json.dumps(flows)}")
    if len(flows) != 2 or not all(f["finite"] and f["std"] > 0 for f in flows):
        fail(f"14B teacher: want one finite, non-constant streamed flow per micro-step: {flows}")
    if [r["step"] for r in rows] != [0, 1] or [r["opt_step"] for r in rows] != [0, 0]:
        fail(f"14B teacher: steps {[(r['step'], r['opt_step']) for r in rows]}")
    if not all("generator_loss" in r for r in rows):
        fail("14B teacher: both micro-steps must train the generator (optimiser step 0)")
    losses = {f"step {r['step']} {k}": r[k] for r in rows
              for k in ("generator_loss", "critic_loss", "generator_grad_norm",
                        "critic_grad_norm") if k in r}
    if not all(math.isfinite(v) for v in losses.values()):
        fail(f"14B teacher: non-finite losses {losses}")
    if not all(r["generator_loss"] > 0 for r in rows):
        fail(f"14B teacher: the DMD loss is zero with non-zero heads: {losses}")
    for r in rows:
        missing = {"teacher_x0_streamed", "gen_page_out", "gen_page_in", "dmd_loss_grad",
                   "opt_generator", "opt_critic"} - set(r["phase_ms"])
        if missing:
            fail(f"14B teacher: step {r['step']} lacks the phases {sorted(missing)}")
        freed, paged = r["gen_page_freed_bytes"], r["gen_page_bytes"]
        if not paged == freed == gen_bytes:
            fail(f"14B teacher: the page-out freed {freed} device bytes (as requested of the "
                 f"allocator) for a {paged}-byte generator ({gen_bytes} expected)")
    fpb = 3
    want = derived_train_launches(DiTConfig().num_layers, 21 // fpb,
                                  [r["exit_idx"] for r in rows],
                                  [r["critic_exit_idx"] for r in rows],
                                  teacher_layers=cfg14.num_layers)
    log(f"14B teacher: K4 launches {json.dumps(got)} (want {json.dumps(want)}; exits: generator "
        f"{[r['exit_idx'] for r in rows]}, critic {[r['critic_exit_idx'] for r in rows]}; the "
        f"teacher's share {2 * cfg14.num_layers} forwards per pass)")
    if got != want:
        fail(f"14B teacher: K4 launch counts {got} != {want}")
    check_counts("14B teacher", serving, expect())
    if peak >= 80:
        fail(f"14B teacher: peak device memory {peak:.2f} GiB")
    steps = [{"step_s": sum(r["phase_ms"].values()) / 1e3, "phase_ms": r["phase_ms"],
              "gen_page_bytes": r["gen_page_bytes"],
              "gen_page_freed_bytes": r["gen_page_freed_bytes"]} for r in rows]
    for r, s_ in zip(rows, steps):
        log(f"14B teacher step {r['step']}: {s_['step_s']:.2f} s "
            f"({', '.join(f'{k} {v:.0f} ms' for k, v in s_['phase_ms'].items())}); page-out "
            f"freed {s_['gen_page_freed_bytes']} of {s_['gen_page_bytes']} bytes")
    log(f"14B teacher on {card}: {wall:.1f} s wall for set-up and 2 micro-steps, peak device "
        f"memory {peak:.2f} GiB; host memory available {host_mem.get('before_gib', 0):.1f} GiB "
        f"before the teacher, {host_mem.get('after_gib', 0):.1f} after (its blocks "
        f"{host_mem.get('blocks_gib', 0):.2f} GiB, built in {host_mem.get('build_s', 0):.1f} s); "
        + ", ".join(f"{k} {v:.6g}" for k, v in losses.items()))
    return {"wall_s": wall, "peak_gib": peak, "steps": steps, "losses": losses,
            "launches": got, "host_memory": host_mem}


def run_host_optimiser_path(torch, A, VC, card: str) -> dict:
    """``run_train`` on ``configs/longlive_train_long.yaml`` with the levers
    its own comment lists, ``opt_on_host`` and ``opt_async`` (AdamW of the
    rank-256 adapters on the host, the critic's update in the background),
    cut as the "streaming" path (``streaming_max_length`` 60,
    ``switch_choices`` [21]) for the same 3 steps, so the two read side by
    side: the chunk state, K4, K1 and K2 as there; the ``opt_*`` phases,
    the critic's grad norm a step late, the step times."""
    from longlive_torch.config import DiTConfig

    path, _ = _train_yaml("chip_smoke_host_opt.yaml", "longlive_train_long.yaml",
                       streaming_max_length=60, switch_choices=[21], phase_ledger=True,
                       opt_on_host=True, opt_async=True)
    trainer, rows, wall, got, serving, peak = _run_train_rows(
        torch, A, VC, path, os.path.join(ROOT, "build", "chip_smoke_host_opt"), 3)
    # the host AdamW's float32 master, m and v of both models' adapters
    host_state_gib = sum(t.numel() for t in trainer.gen_leaves + trainer.critic_leaves) * 12 / 2**30
    del trainer
    gc.collect()
    state = [(r.get("gen_current_length"), r.get("gen_overlap"), r.get("gen_switched"),
              r["current_length"], r["overlap"], r["switched"]) for r in rows[:3]]
    want_state = [(21, 0, False, 39, 3, True), (None, None, None, 57, 3, False),
                  (None, None, None, 21, 0, False)]
    if [r["step"] for r in rows[:3]] != [0, 1, 2] or state != want_state:
        fail(f"host optimiser: steps {[r['step'] for r in rows]}, chunk state {state}, "
             f"expected {want_state}")
    if "critic_grad_norm" in rows[0] or not all("critic_grad_norm" in r for r in rows[1:]):
        fail("host optimiser: the critic's grad norm must come one step late "
             f"({[sorted(r) for r in rows]})")
    losses = {f"step {r['step']} {k}": r[k] for r in rows[:3]
              for k in ("generator_loss", "critic_loss", "gen_generator_grad_norm",
                        "critic_grad_norm") if k in r}
    if not all(math.isfinite(v) for v in losses.values()):
        fail(f"host optimiser: non-finite losses {losses}")
    want = derived_streaming_launches(DiTConfig().num_layers, _stream_chunks(rows[:3], 3))
    log(f"host optimiser: K4 launches {json.dumps(got)} (want {json.dumps(want)})")
    if got != want:
        fail(f"host optimiser: K4 launch counts {got} != {want}")
    check_counts("host optimiser", serving,
                 expect(bias=DiTConfig().num_layers - 1, conv=2 * (28 + 20)))
    if peak >= 80:
        fail(f"host optimiser: peak device memory {peak:.2f} GiB")
    steps = [{"step_s": sum(r["phase_ms"].values()) / 1e3, "phase_ms": r["phase_ms"]}
             for r in rows[:3]]
    for r, s_ in zip(rows, steps):
        log(f"host optimiser step {r['step']}: {s_['step_s']:.2f} s "
            f"({', '.join(f'{k} {v:.0f} ms' for k, v in s_['phase_ms'].items())})")
    log(f"host optimiser on {card}: {wall:.1f} s wall for set-up and 3 steps, peak device memory "
        f"{peak:.2f} GiB, host AdamW state {host_state_gib:.2f} GiB; "
        + ", ".join(f"{k} {v:.6g}" for k, v in losses.items()))
    return {"wall_s": wall, "peak_gib": peak, "steps": steps, "losses": losses,
            "chunk_state": state, "train_launches": got, "launches": serving,
            "host_state_gib": host_state_gib}


OFFLOAD_STEPS = 2


# K1 at the shapes one rank of an sp group sees (sp 2 and 4 of the 12
# heads): the sp decode (a 3-frame block over the 12-frame cache, every key
# valid, the standard cache layout) and the sp sampler's self-attention
# (both CFG halves, 32760 over 32760): (label, B, query tokens, keys, heads).
SP_ATTN_CASES = [
    *((f"bias, sp decode at {n} heads (sp {12 // n}): 4680 over 18720", 1, 4680, 18720, n)
      for n in (6, 3)),
    *((f"bias, sp sampler self at {n} heads (sp {12 // n}): B 2, 32760 over 32760", 2, 32760,
       32760, n) for n in (6, 3)),
]


def check_attention_sp(torch, A, entry):
    """K1 at SP_ATTN_CASES against its plain version, a zero bias; the
    cases join K1's bias entry.  ``library_ms`` is SDPA without a mask;
    each bound counts every key (all valid)."""
    import torch.nn.functional as F

    d = 128
    g = torch.Generator(device="cuda").manual_seed(31)
    for label, b, sq, s, n in SP_ATTN_CASES:
        q = torch.randn((b, sq, n, d), generator=g, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((b * n, s, d), generator=g, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        bias = torch.zeros((b, s), dtype=torch.float32, device="cuda")
        before = A.mode_launches["bias"]
        out = A.flash_attention(q, k, v, bias)
        if A.mode_launches["bias"] != before + 1:
            fail(f"flash_attention ({label}): not counted as a bias launch")
        ref = A.flash_attention_plain(q, k, v, bias)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            fail(f"flash_attention ({label}): non-finite output")
        err, tol, rel = agreement(out, ref)
        del ref
        ms = cuda_ms(torch, lambda: A.flash_attention(q, k, v, bias), 5)
        plain_ms = cuda_ms(torch, lambda: A.flash_attention_plain(q, k, v, bias), 1)
        qt, kt, vt = q.transpose(1, 2), k.view(b, n, s, d), v.view(b, n, s, d)
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), 5)
        t_bound, bound_by = bound(4.0 * b * n * sq * s * d,
                                  2 * 2 * q.numel() + 2 * 2 * k.numel() + 4 * b * s)
        log(f"flash_attention {label}: max_abs_err={err:.3e} tol={tol:.3e} "
            f"rel_rms_err={rel:.3e} (limit {REL_RMS_LIMIT:.0e}) ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={t_bound:.4f} "
            f"({bound_by}; {t_bound / ms:.1%} of bound)")
        if not (err <= tol and rel <= REL_RMS_LIMIT):
            fail(f"flash_attention ({label}) disagrees with its plain version: "
                 f"max_abs_err {err} (limit {tol}), rel_rms_err {rel} (limit {REL_RMS_LIMIT})")
        entry["cases"].append({"case": label, "mode": "bias", "q": [b, sq, n, d],
                               "kv": [b * n, s, d], "max_abs_err": err, "tolerance": tol,
                               "rel_rms_err": rel, "ms": ms, "plain_ms": plain_ms,
                               "library_ms": lib_ms, "bound_ms": t_bound, "bound_by": bound_by})
        if err / tol > entry["max_abs_err"] / entry["tolerance"]:
            entry["max_abs_err"], entry["tolerance"] = err, tol
        entry["rel_rms_err"] = max(entry["rel_rms_err"], rel)
        del q, k, v, out, qt, kt, vt
        torch.cuda.empty_cache()


SP_LIMIT = 5e-2  # the small-reference limit, where the one-rank sp path is not bit-equal


def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _sp_agreement(torch, label: str, got, want) -> dict:
    """Bit-equal, or within SP_LIMIT (relative) with the reason logged."""
    if torch.equal(got, want):
        log(f"{label}: bit-equal to the single-card path")
        return {"bit_equal": True, "rel_err": 0.0}
    err = rel_err(got, want)
    log(f"{label}: not bit-equal to the single-card path (rel_err {err:.3e}, limit "
        f"{SP_LIMIT:.0e}): the sp path runs the same arithmetic on the same shapes and its "
        "one-rank collectives are copies, so a difference is another kernel or GEMM "
        "choice for a tensor of another stride")
    if not err <= SP_LIMIT:
        fail(f"{label}: the one-rank sp path disagrees with the single-card path: rel_err "
             f"{err} (limit {SP_LIMIT})")
    return {"bit_equal": False, "rel_err": err}


def run_sp_one_rank_path(torch, A, VC) -> dict:
    """Multi-device at one rank: a one-rank NCCL group (a free localhost
    port), over which the sequence-parallel code runs at full width with its
    collectives (all-to-alls and all-gathers of one rank): the main
    config's 15 frames through ``CausalInferencePipeline(mesh=...)``
    (``sp_dit_forward_cached``) against the single path with
    ``kernel_cache: false``, and one step of the t2v sampler (832x480, 81
    frames, both CFG halves) through ``sp_bidirectional_forward`` against
    ``bidirectional_forward``; the same random weights (non-zero heads),
    noise and draws.  Each sp run's launches are counted on their own."""
    import datetime

    import torch.distributed as dist

    from longlive_torch.parallel import mesh as pm
    from longlive_torch.pipeline import CausalInferencePipeline, Text2VideoPipeline

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = pm.make_mesh(dp=1, fsdp=1, sp=1, device_type="cuda")
        out = {"backend": dist.get_backend(pm.axis_group(mesh, "sp"))}
        frames, dv = 15, derived()
        with random_base_dit(torch):
            config, cfg, params, conds, noise, _ = _cli_inputs(torch, "longlive_inference.yaml",
                                                               frames, 1)
        single = CausalInferencePipeline(dataclasses.replace(config, kernel_cache=False),
                                         params, device="cuda")
        sp = CausalInferencePipeline(dataclasses.replace(config, kernel_cache=None), params,
                                     device="cuda", mesh=mesh)
        cross = single.prepare_condition(conds[0])

        def generate(pipe, counted=False):
            """(latents, warm ms per latent frame): an untimed run first (the
            first collective creates the NCCL communicator, ~1 s)."""
            def run():
                g = torch.Generator(device="cuda").manual_seed(config.seed)
                return pipe.generate_latents(noise, cross, generator=g)

            run()
            torch.cuda.synchronize()
            if counted:
                reset_counts(A, VC)
            t0 = time.perf_counter()
            lat = run()
            torch.cuda.synchronize()
            return lat, (time.perf_counter() - t0) / frames * 1e3

        want, single_ms = generate(single)
        got, sp_ms = generate(sp, counted=True)
        launches = counts(A, VC)
        check_counts("sp decode (one rank)", launches, expect(bias=(frames // 3) * dv["block"]))
        if tuple(got.shape) != (1, frames, 16, 60, 104) or not torch.isfinite(got).all():
            fail(f"sp decode (one rank): latents {tuple(got.shape)}, finite "
                 f"{bool(torch.isfinite(got).all())}")
        out["decode"] = {**_sp_agreement(torch, "sp decode (one rank), 15 frames", got, want),
                         "sp_ms_per_latent_frame": sp_ms,
                         "single_ms_per_latent_frame": single_ms, "launches": launches}
        log(f"sp decode (one rank): {sp_ms:.2f} ms/latent-frame (wall of a warm run, generation "
            f"only) against the single path's {single_ms:.2f}")
        del single, sp, want, got, cross
        torch.cuda.empty_cache()

        tcfg = dataclasses.replace(cfg, local_attn_size=-1, sink_size=0)
        lat = torch.randn((1, 21, 16, 60, 104), generator=torch.Generator(device="cuda")
                          .manual_seed(7), device="cuda").to(torch.bfloat16)
        step = {}
        for name, mesh_ in (("single", None), ("sp", mesh)):
            pipe = Text2VideoPipeline(params, tcfg, device="cuda", mesh=mesh_)
            model_fn, _ = pipe.prepare_sampler(conds[0].to(torch.bfloat16),
                                               torch.zeros_like(conds[0]).to(torch.bfloat16))
            if name == "sp":
                reset_counts(A, VC)
            step[name] = timed_once(torch, lambda: model_fn(lat, 999.0))
            if name == "sp":
                launches = counts(A, VC)
                check_counts("sp t2v step (one rank)", launches, expect(bias=30, cross=30))
        (got, sp_step_ms), (want, single_step_ms) = step["sp"], step["single"]
        if not torch.isfinite(got).all():
            fail("sp t2v step (one rank): non-finite flow")
        out["t2v_step"] = {**_sp_agreement(torch, "sp t2v step (one rank)", got, want),
                           "sp_ms": sp_step_ms, "single_ms": single_step_ms,
                           "launches": launches}
        log(f"sp t2v step (one rank): {sp_step_ms:.1f} ms against the single path's "
            f"{single_step_ms:.1f} (device time, one guided forward of B 2)")
        return out
    finally:
        dist.destroy_process_group()


def run_t2v_offload_path(torch, A, VC) -> dict:
    """``run_t2v`` with ``--offload_blocks`` at the t2v path's shape
    (832x480, 81 frames), OFFLOAD_STEPS UniPC steps and the decode: the
    DiT's blocks built in pinned host memory and streamed per layer.  Its
    latents must be bit-equal to the resident run's with the same seed (run
    first, same steps).  K1: per step 30 self- and 30 cross-attentions (the
    prompts' K/V are computed once, before the steps); K2: the decode's
    628."""
    from longlive_torch import run_t2v

    dv, layers = derived(), 30
    def argv(name):
        return _t2v_argv("unipc", name, steps=OFFLOAD_STEPS)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with random_base_dit(torch):
        resident = run_t2v.main(argv("chip_smoke_t2v_resident.mp4"))
    torch.cuda.synchronize()
    resident_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    resident = {"latents": resident["latents"].cpu(), "ms_per_step": resident["ms_per_step"]}
    gc.collect()
    torch.cuda.empty_cache()
    out = _sampler_path(torch, A, VC, "t2v offload",
                        lambda: run_t2v.main(argv("chip_smoke_t2v_offload.mp4")
                                             + ["--offload_blocks"]),
                        expect(bias=layers * OFFLOAD_STEPS, cross=layers * OFFLOAD_STEPS,
                               conv=dv["conv"](21)), steps=OFFLOAD_STEPS, keep_latents=True)
    equal = torch.equal(out.pop("latents_cpu"), resident["latents"])
    log(f"t2v offload: latents bit-equal to the resident run: {equal}; ms/step offload "
        f"{out['ms_per_step']:.1f}, resident {resident['ms_per_step']:.1f}; peak GiB offload "
        f"{out['peak_gib']:.2f}, resident {resident_peak:.2f}")
    if not equal:
        fail("t2v offload: the latents differ from the resident run's")
    out.update(resident_ms_per_step=resident["ms_per_step"], resident_peak_gib=resident_peak,
               bit_equal=equal)
    return out


# ---------------------------------------------------------------------------
# pipelined serving and eval


def check_small_renderer(torch, A, VC) -> dict:
    """``PipelinedRenderer.render`` on small inputs, GPU (bf16, kernels, the
    decode on the generation card) vs CPU (float32, plain versions): 6
    frames in segments of 2, an unscheduled switch polled at the second
    segment (a 2-frame replay), the VAE at widths 96/192 (K2's convs)."""
    from longlive_torch.config import DiTConfig, LatentGeometry, PipelineConfig
    from longlive_torch.models import dit as D
    from longlive_torch.models import vae as V
    from longlive_torch.pipeline import CausalInferencePipeline, PipelinedRenderer

    cfg = DiTConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=2, in_dim=16, out_dim=16,
                    text_dim=64, text_len=16, freq_dim=64, local_attn_size=4, sink_size=1,
                    num_frame_per_block=1, rope_max_pos=64)
    geom = LatentGeometry(height=10, width=12)
    pc = PipelineConfig(num_frame_per_block=1, local_attn_size=4, sink_size=1,
                        num_output_frames=6, reactive_recache_frames=2)
    vcfg = dataclasses.replace(V.tiny_vae_config(), dim=96, z_dim=16)
    params32 = D.init_dit_params(cfg, torch.float32, "cpu", seed=3, zero_head=False)
    vp32 = V.init_vae_params(vcfg, torch.float32, "cpu", seed=5)
    g = torch.Generator().manual_seed(16)
    pes = [torch.randn((1, cfg.text_len, cfg.text_dim), generator=g) for _ in range(2)]
    noise = torch.randn((1, 6, 16, geom.height, geom.width), generator=g)
    px = {}
    for dev, dt in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
        pipe = CausalInferencePipeline(pc, to_dev(params32, dev, dt), geometry=geom,
                                       dit_config=cfg, device=dev, deterministic_renoise=True)
        vp = V.pack_fused_weights(to_dev(vp32, dev, dt)) if dev == "cuda" else vp32
        renderer = PipelinedRenderer(pipe, vp, vcfg, segment_frames=2,
                                     decode_device=0 if dev == "cuda" else dev)
        cross = [pipe.prepare_condition(pe) for pe in pes]
        polls = []

        def poll(start, cross=cross, polls=polls):
            polls.append(start)
            return cross[1] if start == 2 else None

        reset_counts(A, VC)
        px[dev] = renderer.render(noise, cross[0], dtype=dt, poll_switch=poll)
        got = counts(A, VC)
        if polls != [0, 2, 4]:
            fail(f"small renderer ({dev}): polled at {polls}")
    # K1: 6 blocks of 2 layers in each of 4 denoise forwards and 1 in the
    # kv-only commit, and 1 in the replay; K2: both convs of each of the 6
    # res blocks per latent frame, and the time conv from the second on
    n_res = 2 + len(vcfg.dim_mult) * (vcfg.num_res_blocks + 1)
    n_time = sum(vcfg.temperal_upsample[: len(vcfg.dim_mult) - 1])
    check_counts("small renderer, GPU", got,
                 expect(bias=6 * (2 * 4 + 1) + 1, conv=2 * n_res + 5 * (2 * n_res + n_time)))
    if not torch.isfinite(px["cuda"]).all():
        fail("small renderer: non-finite GPU pixels")
    err = rel_err(px["cuda"], px["cpu"])
    log(f"small renderer reference (GPU bf16 kernels vs CPU float32 "
        f"plain; limit 5e-2): pixels rel_err={err:.3e}")
    if not err <= 5e-2:
        fail(f"small renderer reference disagrees (limit 5e-2): {err}")
    return {"pixels rel_err": err}


@contextlib.contextmanager
def segment_timed(torch, record: dict):
    """While active: each segment's generation and decode of the renderer
    timed with CUDA events (``record["gen"]``, ``record["decode"]``:
    (start, end) pairs), its latents kept in ``record["latents"]`` and the
    renderer in ``record["renderer"]``."""
    from longlive_torch.pipeline import serve
    from longlive_torch.pipeline.causal_inference import CausalInferencePipeline

    gen0, dec0, init0 = (CausalInferencePipeline.generate_latents_scanned,
                         serve.PipelinedRenderer._decode, serve.PipelinedRenderer.__init__)
    for key in ("gen", "decode", "latents"):
        record[key] = []

    def events():
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        return a, b

    def gen(self, *args, **kw):
        a, b = events()
        lat, cache = gen0(self, *args, **kw)
        b.record()
        record["gen"].append((a, b))
        record["latents"].append(lat)
        return lat, cache

    def dec(self, *args, **kw):
        a, b = events()
        out = dec0(self, *args, **kw)
        b.record()
        record["decode"].append((a, b))
        return out

    def init(self, *args, **kw):
        init0(self, *args, **kw)
        record["renderer"] = self

    CausalInferencePipeline.generate_latents_scanned = gen
    serve.PipelinedRenderer._decode = dec
    serve.PipelinedRenderer.__init__ = init
    try:
        yield record
    finally:
        CausalInferencePipeline.generate_latents_scanned = gen0
        serve.PipelinedRenderer._decode = dec0
        serve.PipelinedRenderer.__init__ = init0


def _check_videos(torch, label: str, results: list, frames: int, samples: int) -> None:
    if len(results) != samples:
        fail(f"{label} wrote {len(results)} videos, expected {samples}")
    for r in results:
        px = r["pixels"]
        if tuple(px.shape) != (1, 1 + 4 * (frames - 1), 3, 480, 832):
            fail(f"{label}: pixels {tuple(px.shape)}")
        if not torch.isfinite(px).all():
            fail(f"{label}: non-finite pixels")
        if not os.path.exists(r["path"]) or os.path.getsize(r["path"]) == 0:
            fail(f"{label}: output {r['path']} missing")


def _pipelined_run(torch, A, VC, label: str, config: str, frames: int, argv: list,
                   samples: int = 1):
    """``run_inference`` with ``--decode_device 0`` under ``segment_timed``:
    (its records, the segment record, counts, wall s, peak GiB)."""
    from longlive_torch import run_inference

    torch.cuda.reset_peak_memory_stats()
    reset_counts(A, VC)
    t0 = time.perf_counter()
    with segment_timed(torch, {}) as rec:
        results, _ = run_captured(lambda: run_inference.main([
            "--config_path", config, "--num_output_frames", str(frames), "--device", "cuda",
            "--decode_device", "0"] + argv))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts(A, VC)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _check_videos(torch, label, results, frames, samples)
    return results, rec, got, wall, peak


def _bit_equal(torch, label: str, got, want, what: str) -> None:
    if not torch.equal(got, want):
        err, tol, rel = agreement(got, want)
        fail(f"{label}: pixels differ from {what} (max_abs_err {err:.3e}, rel RMS {rel:.3e})")


def run_pipelined_path(torch, A, VC, main: dict, main_pixels) -> dict:
    """``run_inference --decode_device 0 --segment_frames 6`` on
    ``configs/longlive_inference.yaml`` for 15 latent frames (segments of 6,
    6 and 3): the same seed and noise as path "main", its pixels bit-equal
    to "main"'s, the launches "main"'s.  Each segment's generation and
    decode timed with CUDA events; the render's wall beside "main"'s serial
    generate + decode."""
    frames, dv, label = 15, derived(), "pipelined"
    results, rec, got, wall, peak = _pipelined_run(
        torch, A, VC, label, os.path.join(ROOT, "configs", "longlive_inference.yaml"), frames,
        ["--segment_frames", "6"])
    r = results[0]
    check_counts(label, got, expect(bias=(frames // 3) * dv["block"], conv=dv["conv"](frames)))
    if [lat.shape[1] for lat in rec["latents"]] != [6, 6, 3]:
        fail(f"{label}: segments {[lat.shape[1] for lat in rec['latents']]}")
    _bit_equal(torch, label, r["pixels"], main_pixels, "the serial main path's")
    gen_ms = [a.elapsed_time(b) for a, b in rec["gen"]]
    dec_ms = [a.elapsed_time(b) for a, b in rec["decode"]]
    render_ms = r["render_s"] * 1e3
    out = {"render_ms": render_ms, "serial_render_ms": main["render_ms"],
           "gen_ms": gen_ms, "decode_ms": dec_ms,
           "gen_ms_per_latent_frame": sum(gen_ms) / frames,
           "decode_ms_per_latent_frame": sum(dec_ms) / frames,
           "render_ms_per_latent_frame": render_ms / frames,
           "serial_ms_per_latent_frame": main["render_ms"] / frames,
           "wall_s": wall, "peak_gib": peak, "video": r["path"], "launches": got}
    log(f"{label}: segments 6/6/3, pixels bit-equal to main; render {render_ms:.2f} ms "
        f"({out['render_ms_per_latent_frame']:.2f} ms/latent-frame) vs main's serial "
        f"{main['render_ms']:.2f} ({out['serial_ms_per_latent_frame']:.2f}); generation "
        f"{out['gen_ms_per_latent_frame']:.2f} ms/latent-frame "
        f"({', '.join(f'{t:.1f}' for t in gen_ms)} ms), decode "
        f"{out['decode_ms_per_latent_frame']:.2f} ({', '.join(f'{t:.1f}' for t in dec_ms)} "
        f"ms); peak {peak:.2f} GiB")
    return out


def run_per_stream_decode_path(torch, A, VC) -> dict:
    """``configs/longlive_inference.yaml`` with ``num_samples: 2`` (a copy
    under ``build/``), 6 latent frames: ``run_inference`` serially, then
    with ``--decode_device 0 --segment_frames 3`` without and with
    ``--per_stream_decode``.  On the card the renderer decodes each stream
    as its own B = 1 chain either way (K2 takes batch 1, as the JAX
    package's kernel), so both renders launch K2 for 2 streams and give the
    serial path's pixels bit for bit.  Those pixels are then held against a
    float32 plain decode of the same latents (one batched B = 2
    ``vae_decode_scan``: the plain convs) within the small references'
    whole-decode limit, relative 5e-2, beside the bf16 plain decode's
    distance from it; and the decode's peak above its inputs, per stream
    against the batched bf16 decode's."""
    import yaml

    from longlive_torch import run_inference
    from longlive_torch.models import vae as V

    frames, dv, label = 6, derived(), "per-stream decode"
    with open(os.path.join(ROOT, "configs", "longlive_inference.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["num_samples"] = 2
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    path = os.path.join(ROOT, "build", "chip_smoke_per_stream.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    want = expect(bias=(frames // 3) * dv["block"], conv=2 * dv["conv"](frames))

    reset_counts(A, VC)
    results, _ = run_captured(lambda: run_inference.main([
        "--config_path", path, "--num_output_frames", str(frames), "--device", "cuda"]))
    torch.cuda.synchronize()
    check_counts(f"{label}, serial", counts(A, VC), want)
    _check_videos(torch, f"{label}, serial", results, frames, 2)
    serial = torch.cat([r["pixels"] for r in results], dim=0)
    del results
    runs = {}
    for flag in ([], ["--per_stream_decode"]):
        what = f"{label}, renderer{' ' + flag[0] if flag else ''}"
        renderer = None  # frees the previous run's pipeline and its DiT weights
        results, rec, got, wall, peak = _pipelined_run(
            torch, A, VC, what, path, frames, ["--segment_frames", "3"] + flag, samples=2)
        check_counts(what, got, want)
        _bit_equal(torch, what, torch.cat([r["pixels"] for r in results], dim=0), serial,
                   "the serial path's")
        runs[what] = {"wall_s": wall, "peak_gib": peak, "launches": got}
        renderer = rec["renderer"]
        lat = torch.cat(rec["latents"], dim=1).to(torch.bfloat16)
        del results, rec

    def decode_peak(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated() - base) / 2 ** 30

    vp, vcfg = renderer.vae_params, renderer.vcfg
    _, per_stream_gib = decode_peak(lambda: renderer._decode(lat, None, True)[0])
    reset_counts(A, VC)
    plain, batched_gib = decode_peak(lambda: V.vae_decode_scan(vp, vcfg, lat)[0])
    if counts(A, VC)["fused_causal_conv"]["bf16"] != 0:
        fail(f"{label}: the batched B = 2 reference decode launched K2")
    vp32 = to_dev(vp, "cuda", torch.float32)
    ref = V.vae_decode_scan(vp32, vcfg, lat.float())[0]
    del vp32
    k2_rel, plain_rel = rel_err(serial, ref), rel_err(plain, ref)
    k2_err = (serial.float() - ref).abs().max().item()
    plain_err = (plain.float() - ref).abs().max().item()
    # a chain of 30 convs a latent frame in bf16: held as whole decodes are
    # (the small references' limit), not as one kernel call
    if not k2_rel <= 5e-2:
        fail(f"{label}: K2 pixels vs the float32 plain decode: rel_err {k2_rel:.3e} "
             f"(limit 5e-2), max_abs_err {k2_err:.3e}")
    out = {"renders": runs, "launches": got, "decode_peak_gib": per_stream_gib,
           "batched_decode_peak_gib": batched_gib,
           "k2_vs_float32": {"rel_err": k2_rel, "max_abs_err": k2_err},
           "plain_bf16_vs_float32": {"rel_err": plain_rel, "max_abs_err": plain_err},
           "k2_vs_plain_bf16_rel_err": rel_err(serial, plain)}
    log(f"{label}: 2 streams x {frames} latent frames; both renders (with and without "
        f"--per_stream_decode) bit-equal to the serial path, K2 {want['fused_causal_conv']['bf16']} "
        f"launches each; against a float32 plain decode of the same latents: K2 rel_err "
        f"{k2_rel:.3e} (limit 5e-2), max_abs_err {k2_err:.3e}; the bf16 plain decode rel_err "
        f"{plain_rel:.3e}, max_abs_err {plain_err:.3e}; K2 vs bf16 plain rel_err "
        f"{out['k2_vs_plain_bf16_rel_err']:.3e}; decode peak above its inputs "
        f"{per_stream_gib:.3f} GiB per stream vs {batched_gib:.3f} batched")
    return out


def run_eval_path(torch, video_path: str) -> dict:
    """``run_eval.main`` on the video path "pipelined" wrote, then
    ``evaluate_video`` on its frames with a full-width CLIP ViT-H/14 (random,
    bf16, on the card): every score finite and in [0, 1]; the CLIP features
    of the 16 sampled frames held against the CPU's float32 ones."""
    import importlib.util

    from longlive_torch import run_eval
    from longlive_torch.eval import metrics as M
    from longlive_torch.models import clip as C

    cv2 = importlib.util.find_spec("cv2") is not None
    t0 = time.perf_counter()
    res, _ = run_captured(lambda: run_eval.main([video_path, "--json", os.path.join(
        ROOT, "build", "chip_smoke_eval.json")]))
    eval_s = time.perf_counter() - t0
    video = run_eval.load_video(video_path)
    ccfg = C.CLIPVisionConfig()
    cp32 = C.init_clip_vision_params(ccfg, torch.float32, "cpu", seed=0)
    cp = to_dev(cp32, "cuda", torch.bfloat16)
    t0 = time.perf_counter()
    clip_scores = M.evaluate_video(video, cp, ccfg)
    torch.cuda.synchronize()
    clip_s = time.perf_counter() - t0
    feats = M._frame_features(video, cp, ccfg)
    feats_cpu = M._frame_features(video, cp32, ccfg)
    err = rel_err(torch.from_numpy(feats), torch.from_numpy(feats_cpu))
    for what, scores in (("run_eval", res["videos"][video_path]), ("CLIP", clip_scores)):
        for k, v in scores.items():
            if k != "num_frames" and not (math.isfinite(v) and 0.0 <= v <= 1.0):
                fail(f"eval ({what}): {k} = {v}")
    if feats.shape != (16, ccfg.dim):
        fail(f"eval: CLIP features {feats.shape}")
    if not err <= 5e-2:
        fail(f"eval: CLIP features GPU vs CPU rel_err {err} (limit 5e-2)")
    out = {"cv2": cv2, "frames": len(video), "eval_s": eval_s, "clip_eval_s": clip_s,
           "clip_features_rel_err": err, "scores": res["videos"][video_path],
           "clip_scores": clip_scores}
    log(f"eval: {video_path} ({len(video)} frames; cv2 {'present: Farneback flows' if cv2 else 'absent: the frame-difference branches'}): "
        f"run_eval {eval_s:.2f} s per video, with the CLIP tower on the card {clip_s:.2f} s; "
        f"CLIP features GPU vs CPU rel_err {err:.3e} (limit 5e-2); scores "
        + json.dumps(clip_scores))
    return out


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
        from longlive_torch.ops import quant as Q
        from longlive_torch.ops import vae_conv as VC
    except ImportError as e:
        fail(f"the longlive_torch package is not beside this script: {e}")

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in true float32
    torch.backends.cudnn.allow_tf32 = False
    for knob in ("LONGLIVE_INT8_FUSED", "LONGLIVE_VAE_INT8", "LONGLIVE_CROSS_FLASH",
                 "LONGLIVE_TF_ELIDE") + SWITCHES:  # set per path below
        os.environ.pop(knob, None)

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
    k1 = check_attention(torch, A)
    entries = [k1, check_attention_cases(torch, A, k1), check_attention_int8(torch, A),
               check_attention_two_segment(torch, A), check_attention_switches(torch, A),
               check_conv(torch, VC), check_conv(torch, VC, int8=True),
               check_res_block_pair(torch, VC), check_int8_linear(torch, Q)]
    check_attention_cross(torch, A, k1)
    check_attention_bidirectional(torch, A, k1)
    check_attention_sp(torch, A, k1)
    check_attention_edges(torch, A, k1)
    entries.append(check_frame_masked(torch, A))
    entries += check_train_attention(torch, A)
    check_train_attention_14b(torch, A, entries[-3])
    log(f"kernel checks: {time.perf_counter() - t0:.1f} s")

    # the 14B teacher's paths first, right after the kernel checks: the
    # teacher's blocks and the generator's two host copies take ~63 GiB of
    # host memory, and the later paths leave less of it available (on a
    # 101 GiB H100 host: 96.3 GiB available here, 67.1 after them)
    streamed_teacher = check_streamed_teacher(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    teacher_14b = run_teacher_14b_path(torch, A, VC, card)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    check_small_reference(torch)
    renderer_ref = check_small_renderer(torch, A, VC)
    int8_ref = check_small_int8_reference(torch, A, VC)
    options_ref = check_small_serving_options_reference(torch, A, VC)
    full_ref = check_small_full_forwards(torch, A, VC)
    encoders_ref = check_small_encoders(torch, VC)
    check_small_training(torch)
    streaming_ref = check_small_streaming(torch)
    sampler_ref = check_small_samplers(torch, A, VC)
    levers_ref = check_small_levers(torch)
    log(f"small references: {time.perf_counter() - t0:.1f} s")

    paths, main_px = {}, {}
    paths["main"] = run_inference_path(torch, A, VC, "main", "longlive_inference.yaml", "bias",
                                       keep=main_px)
    torch.cuda.empty_cache()
    paths["pipelined"] = run_pipelined_path(torch, A, VC, paths["main"], main_px.pop("pixels"))
    gc.collect()
    torch.cuda.empty_cache()
    evaluation = run_eval_path(torch, paths["pipelined"]["video"])
    paths["per-stream decode"] = run_per_stream_decode_path(torch, A, VC)
    gc.collect()
    torch.cuda.empty_cache()
    paths["tuned"] = run_inference_path(torch, A, VC, "tuned", "longlive_inference_tuned.yaml",
                                        "q_rope")
    torch.cuda.empty_cache()
    paths["reactive"] = run_reactive_path(torch, A, VC)
    torch.cuda.empty_cache()
    paths.update(run_interactive_paths(torch, A, VC))
    torch.cuda.empty_cache()
    paths["int8 serving"] = run_int8_serving_path(torch, A, VC)
    torch.cuda.empty_cache()
    paths["int8 recache"] = run_int8_recache_path(torch, A, VC)
    torch.cuda.empty_cache()
    paths["serving options"] = run_serving_options_path(torch, A, VC)
    gc.collect()
    torch.cuda.empty_cache()
    paths["full forwards"] = run_full_forwards_path(torch, A, VC)
    for label, run in (("text encoder", run_text_encoder_path), ("vae encode", run_vae_encode_path),
                       ("checkpoint load", run_checkpoint_load_path), ("t2v", run_t2v_path),
                       ("i2v", run_i2v_path)):
        gc.collect()
        torch.cuda.empty_cache()
        paths[label] = run(torch, A, VC)
    gc.collect()
    torch.cuda.empty_cache()
    training = run_training_path(torch, A, VC, card)
    gc.collect()
    torch.cuda.empty_cache()
    live = run_live_training_step(torch, A, VC, card)
    gc.collect()
    torch.cuda.empty_cache()
    paths["streaming"] = run_streaming_path(torch, A, VC, card)
    gc.collect()
    torch.cuda.empty_cache()
    live_stream = run_live_streaming_step(torch, A, VC, card)
    gc.collect()
    torch.cuda.empty_cache()
    host_opt = run_host_optimiser_path(torch, A, VC, card)
    gc.collect()
    torch.cuda.empty_cache()
    paths["t2v offload"] = run_t2v_offload_path(torch, A, VC)
    gc.collect()
    torch.cuda.empty_cache()
    sp_one_rank = run_sp_one_rank_path(torch, A, VC)
    log("paths: " + json.dumps(paths))
    log("multi-device at one rank: " + json.dumps(sp_one_rank))
    log("small renderer reference: " + json.dumps(renderer_ref))
    log("eval: " + json.dumps(evaluation))
    log("small int8 reference: " + json.dumps(int8_ref))
    log("small serving-options reference: " + json.dumps(options_ref))
    log("small full-forward reference: " + json.dumps(full_ref))
    log("small encoder reference: " + json.dumps(encoders_ref))
    log("training: " + json.dumps(training))
    log("training, non-zero heads: " + json.dumps(live))
    log("streaming, non-zero heads: " + json.dumps(live_stream))
    log("small streaming reference: " + json.dumps(streaming_ref))
    log("small sampler reference: " + json.dumps(sampler_ref))
    log("small lever reference: " + json.dumps(levers_ref))
    log("streamed 14B-width teacher: " + json.dumps(streamed_teacher))
    log("14B teacher: " + json.dumps(teacher_14b))
    log("host optimiser: " + json.dumps(host_opt))

    # each entry's launches: the count of the path that runs it, read from
    # that path's own run (counts set to 0 just before it)
    launch_of = {
        "flash_attention": ("main", "flash_attention", "bias"),
        "flash_attention_q_rope": ("tuned", "flash_attention", "q_rope"),
        "flash_attention_qk_int8": ("int8 serving", "flash_attention", "qk_int8"),
        "fused_causal_conv": ("main", "fused_causal_conv", "bf16"),
        "fused_causal_conv_int8": ("int8 serving", "fused_causal_conv", "int8"),
        "int8_linear": ("int8 serving", "int8_linear", None),
        "flash_attention_two_segment": ("serving options", "flash_attention", "two_segment"),
        "flash_attention_exp2_mxu_lsum": ("serving options", "flash_attention_switches", "exp2"),
        "fused_res_block": ("serving options", "fused_res_block", None),
        "flash_attention_frame_masked": ("full forwards", "flash_attention_frame_masked",
                                         "teacher_forcing"),
    }
    for entry in entries:
        name = entry["name"]
        if name in launch_of:
            path, key, mode = launch_of[name]
            pick = lambda c: c[key] if mode is None else c[key][mode]  # noqa: E731
            entry["launches_path"] = path
            entry["launches"] = pick(paths[path]["launches"])
            entry["launches_by_path"] = {label: pick(p["launches"]) for label, p in paths.items()}
            if name == "flash_attention":  # K1 as the cross-attention, its own count
                entry["cross_launches_path"] = "full forwards"
                entry["cross_launches"] = paths["full forwards"]["launches"][key]["cross"]
                entry["cross_launches_by_path"] = {
                    label: p["launches"][key]["cross"] for label, p in paths.items()}
        else:
            key = {"flash_attention_train": "fwd", "flash_attention_train_bwd_dq": "bwd_dq",
                   "flash_attention_train_bwd_dkdv": "bwd_dkdv"}[name]
            entry["launches_path"] = "training"
            entry["launches"] = training["launches"][key]
            entry["launches_by_path"] = {
                "training": training["launches"][key],
                "training, non-zero heads": live["launches"][key],
                "streaming": paths["streaming"]["train_launches"][key],
                "streaming, non-zero heads": live_stream["train_launches"][key],
                "14B teacher": teacher_14b["launches"][key],
                "host optimiser": host_opt["train_launches"][key]}
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
