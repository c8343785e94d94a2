"""A/B of K1, the serving flash attention, between two checkouts on one GPU.

Usage (from the repository root, on a host with an NVIDIA GPU):

    git archive <base commit> | tar -x -C build/base      # build/ is git-ignored
    python scripts/torch_attention_ab.py --base build/base [--paths] \
        [--out build/attention_ab.json]

This checkout's ``chip_smoke.py`` drives each checkout's ``longlive_torch``
in turn (base, this tree, this tree, base; ``use_tree`` of
``scripts/torch_train_attention_ab.py``): the other checkout is used only
through ``longlive_torch``'s entry points, and builds its kernels under its
own ``build/kernels`` (every kernel before its first turn).  Every turn times ``flash_attention`` (CUDA events,
10 calls after a warm-up) on the same inputs at every K1 case of
``chip_smoke.py``'s phase 3: the bias decode (``check_attention``), the
``ATTN_CASES``, ``INT8_ATTN_CASES``, ``TWO_SEG_CASES`` (with and without
``skip_ranges``), ``SWITCH_CASES`` and ``CROSS_CASES``.  Once per case it
also times the case's ``scaled_dot_product_attention`` call (the library
call; never used by the port) and computes the bound as ``chip_smoke.py``
does.  ``--paths`` then runs, in the same order of turns, the main, tuned,
int8 serving and serving-options paths and the interactive one-shot loop
(``chip_smoke.run_*``, launch counts asserted) and keeps their DiT ms per
latent frame, decode ms, peak memory and the one-shot switch stall.  Prints
one JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_train_attention_ab as AB  # noqa: E402  (load_file, use_tree)

ROOT = AB.ROOT
TURNS = ("base", "this", "this", "base")


def k1_cases(cs, A):
    """[(label, args, kwargs, switches, sdpa operands, (bound ms, bound_by))]
    at chip_smoke.py's K1 shapes, inputs made once from seeds."""
    from longlive_torch.ops.rope import make_rope_tables, rope_multipliers

    b, n, d, fs = 1, 12, 128, 1560
    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(21)
    rnd = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(bf)  # noqa: E731

    def masked(valid):
        return torch.where(valid, 0.0, A.NEG_INF).float()[None].contiguous()

    tables = make_rope_tables(d, 1024, device="cuda")
    off = {"LONGLIVE_EXP2": "0", "LONGLIVE_MXU_LSUM": "0"}
    cases = []

    def bias_case(label, sq, s, vf, rope=None, bias=None):
        q, k, v = rnd(b, sq, n, d), rnd(b * n, s, d), rnd(b * n, s, d)
        if bias is None:
            bias = masked(torch.arange(s, device="cuda") < vf)
        qr = q if rope is None else A.rope_scaled_q(q, rope[0], rope[1], 1.0)
        lib = (qr.transpose(1, 2), k.view(b, n, s, d), v.view(b, n, s, d),
               bias.to(bf)[:, None, None, :])
        nbytes = 2 * q.numel() * 2 + 2 * k.numel() * 2 + b * s * 4
        cases.append((label, (q, k, v, bias), {"q_rope": rope} if rope else {}, off, lib,
                      cs.bound(4.0 * b * n * sq * vf * d, nbytes)))

    for label, frames in (("warm-up: sink + block valid", 6), ("full window", 12)):
        bias_case(f"bias decode, {label}", 3 * fs, 12 * fs, 12 * fs,
                  bias=masked(torch.arange(12 * fs, device="cuda") < frames * fs))
    for label, mode, qf, kf, vf in cs.ATTN_CASES:
        rope = rope_multipliers(tables, qf, 30, 52, start_frame=24) if mode == "q_rope" else None
        bias_case(label, qf * fs, kf * fs, vf * fs, rope=rope)
    for label, qf, kf, stored in cs.INT8_ATTN_CASES:
        sq, s = qf * fs, kf * fs
        q, kb, v = rnd(b, sq, n, d), rnd(b * n, s, d), rnd(b * n, s, d)
        bias = torch.zeros((b, s), dtype=torch.float32, device="cuda")
        k, ksc = A.quantize_k_tokens(kb) if stored else (kb, None)
        kd = A.dequantize_k(k, ksc, bf) if stored else kb
        work = 2.0 * b * n * sq * s * d
        k_bytes = k.numel() * (1 if stored else 2) + (ksc.numel() * 4 if stored else 0)
        cases.append((label, (q, k, v, bias), {"qk_int8": True, "k_scales": ksc}, off,
                      (q.transpose(1, 2), kd.view(b, n, s, d), v.view(b, n, s, d), None),
                      cs.bound(work, 2 * q.numel() * 2 + k_bytes + v.numel() * 2 + b * s * 4,
                               int8_ops=work)))
    for label, slots, vf in cs.TWO_SEG_CASES:
        q, k, v, k2, v2, bias, skip, lib, nvalid, nbytes = cs._two_segment_inputs(
            torch, A, g, slots, vf)
        bnd = cs.bound(4.0 * n * q.shape[1] * nvalid * d, nbytes)
        cases.append((label, (q, k, v, bias), {"k2": k2, "v2": v2, "skip_ranges": skip}, off,
                      lib, bnd))
        cases.append((label + ", no skip_ranges", (q, k, v, bias), {"k2": k2, "v2": v2}, off,
                      lib, bnd))
    for label, mode, exp2, lsum in cs.SWITCH_CASES:
        env = {"LONGLIVE_EXP2": str(exp2), "LONGLIVE_MXU_LSUM": str(lsum)}
        if mode == "two_segment":
            q, k, v, k2, v2, bias, skip, lib, nvalid, nbytes = cs._two_segment_inputs(
                torch, A, g, cs.TWO_SEG_CASES[0][1], cs.TWO_SEG_CASES[0][2])
            cases.append((label, (q, k, v, bias), {"k2": k2, "v2": v2, "skip_ranges": skip},
                          env, lib, cs.bound(4.0 * n * q.shape[1] * nvalid * d, nbytes)))
            continue
        s = (12 if mode == "bias" else 9) * fs
        q, k, v = rnd(b, 3 * fs, n, d), rnd(b * n, s, d), rnd(b * n, s, d)
        bias = torch.zeros((b, s), dtype=torch.float32, device="cuda")
        kw, qr, kd = {}, q, k
        nbytes = 2 * 2 * q.numel() + 2 * 2 * k.numel() + 4 * b * s
        if mode == "q_rope":
            kw["q_rope"] = rope_multipliers(tables, 3, 30, 52, start_frame=24)
            qr = A.rope_scaled_q(q, kw["q_rope"][0], kw["q_rope"][1], 1.0)
        if mode == "qk_int8":
            k, ksc = A.quantize_k_tokens(k)
            kw.update(qk_int8=True, k_scales=ksc)
            nbytes -= k.numel()
        work = 4.0 * b * n * q.shape[1] * s * d
        bnd = (cs.bound(work / 2, nbytes, int8_ops=work / 2) if mode == "qk_int8"
               else cs.bound(work, nbytes))
        cases.append((label, (q, k, v, bias), kw, env,
                      (qr.transpose(1, 2), kd.view(b, n, s, d), v.view(b, n, s, d), None), bnd))
    for label, sq in cs.CROSS_CASES:
        s = 512
        q, k, v = rnd(b, sq, n, d), rnd(b * n, s, d), rnd(b * n, s, d)
        bias = torch.zeros((b, s), dtype=torch.float32, device="cuda")
        cases.append((label, (q, k, v, bias), {"cross": True}, off,
                      (q.transpose(1, 2), k.view(b, n, s, d), v.view(b, n, s, d), None),
                      cs.bound(4.0 * b * n * sq * s * d,
                               2 * 2 * q.numel() + 2 * 2 * k.numel() + 4 * b * s)))
    return cases


def time_k1(cs, A, cases):
    rows = {}
    for label, args, kw, env, _, _ in cases:
        with cs.switched(**env):
            rows[label] = cs.cuda_ms(torch, lambda: A.flash_attention(*args, **kw), 10)
    return rows


def library_and_bounds(cs, cases):
    import torch.nn.functional as F

    rows = {}
    for label, _, _, _, lib, (t_bound, bound_by) in cases:
        rows[label] = {"library_ms": cs.cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            lib[0], lib[1], lib[2], attn_mask=lib[3]), 10),
            "bound_ms": t_bound, "bound_by": bound_by}
    return rows


def paths(cs, A, VC):
    """The serving paths' DiT ms per latent frame, decode, peak memory and
    the one-shot switch stall, each path's launch counts asserted."""
    out = {}
    for label, config, mode in (("main", "longlive_inference.yaml", "bias"),
                                ("tuned", "longlive_inference_tuned.yaml", "q_rope")):
        r = cs.run_inference_path(torch, A, VC, label, config, mode)
        out[label] = {k: r[k] for k in ("dit_ms_per_latent_frame", "decode_ms_per_latent_frame",
                                        "peak_gib", "launches")}
        torch.cuda.empty_cache()
    r = cs.run_interactive_paths(torch, A, VC)["interactive_oneshot"]
    out["interactive one-shot"] = {k: r[k] for k in (
        "steady_ms_per_latent_frame", "switch_stall_ms", "peak_gib", "launches")}
    torch.cuda.empty_cache()
    r = cs.run_int8_serving_path(torch, A, VC)
    out["int8 serving"] = {"dit_ms_per_latent_frame": r["dit_ms_per_latent_frame"],
                           "decode_ms_per_latent_frame": r["decode_ms_per_latent_frame"],
                           "warm": r["warm"], "cold": r["cold"]}
    torch.cuda.empty_cache()
    r = cs.run_serving_options_path(torch, A, VC)
    out["serving options"] = {k: r[k] for k in ("dit_ms_per_latent_frame",
                                                "decode_ms_per_latent_frame", "peak_gib",
                                                "launches")}
    gc.collect()
    torch.cuda.empty_cache()
    return out


def use_built_tree(root: str):
    """``use_tree`` of the checkout at ``root``, its kernels built first
    (no path or timing pays for a build)."""
    A, VC = AB.use_tree(root)
    sys.modules["longlive_torch.ops.kernels"].build_all()
    return A, VC


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True, help="root of the checkout to compare against")
    ap.add_argument("--paths", action="store_true")
    ap.add_argument("--out", default="build/attention_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("error: needs a CUDA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    cs = AB.load_file("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    for knob in ("LONGLIVE_INT8_FUSED", "LONGLIVE_VAE_INT8", "LONGLIVE_CROSS_FLASH",
                 "LONGLIVE_TF_ELIDE") + cs.SWITCHES:
        os.environ.pop(knob, None)
    trees = {"base": os.path.abspath(args.base), "this": ROOT}
    result = {"card": card, "torch": torch.__version__, "order": [], "k1_ms": {}}
    A, _ = AB.use_tree(ROOT)
    cases = k1_cases(cs, A)
    result["cases"] = library_and_bounds(cs, cases)
    for turn, name in enumerate(TURNS):
        A, _ = use_built_tree(trees[name])
        key = f"{name}_{turn}"
        result["order"].append(key)
        result["k1_ms"][key] = time_k1(cs, A, cases)
        print(json.dumps({key: result["k1_ms"][key]}), flush=True)
    del cases
    gc.collect()
    torch.cuda.empty_cache()
    if args.paths:
        result["paths"] = {}
        for turn, name in enumerate(TURNS):
            A, VC = use_built_tree(trees[name])
            key = f"{name}_{turn}"
            result["paths"][key] = paths(cs, A, VC)
            print(json.dumps({"paths": key, "result": result["paths"][key]}), flush=True)
    text = json.dumps(result, indent=1, default=str)
    print(text)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text)


if __name__ == "__main__":
    main()
