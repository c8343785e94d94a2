"""A/B of the VAE decoder's conv kernels between two checkouts on one GPU:
K2's int8 variant (``fused_causal_conv`` under ``LONGLIVE_VAE_INT8=1``),
K6 (``fused_res_block``) beside its own route (two K2 launches), and K2's
bf16 conv, whose GEMM K6 shares.

Usage (from the repository root, on a host with an NVIDIA GPU):

    git archive <base commit> | tar -x -C build/base      # build/ is git-ignored
    python scripts/torch_vae_ab.py --base build/base [--paths] [--clocks] \
        [--out build/vae_ab.json]

This checkout's ``chip_smoke.py`` drives each checkout's ``longlive_torch``
in turn (base, this tree, this tree, base; ``use_tree`` of
``scripts/torch_train_attention_ab.py``, every kernel built before its first
turn): the other checkout is used only through ``longlive_torch``'s entry
points.  Once, on this tree, ``chip_smoke.check_conv(int8=True)`` and
``chip_smoke.check_res_block_pair`` check both kernels against their plain
versions and give the plain, library and bound times.  Every turn then
times (CUDA events, 5 calls after a warm-up) on inputs made once from
seeds: the int8 conv at every shape of ``chip_smoke.CONV_CASES`` (the
weights packed once), the bf16 conv at the same shapes, and at every shape
of ``chip_smoke.PAIR_CASES`` K6 and the chain of two K2 launches, with
count-weighted sums over one later latent frame (30 convs, 13 blocks).
The two of a pair are timed a, b, b, a within each case: under a power
limit the card's clock follows the load just before (a chain timed always
after K6 read 5-10% slower than alone).
``--paths`` then runs, in the same order of turns, the main, tuned, int8
serving and serving-options paths (``chip_smoke.run_*``, launch counts
asserted) and keeps their DiT and decode ms per latent frame, peak memory
and launches.  ``--clocks`` runs, on this tree only, K6 and its chain in
loops of 4 s each (chain, K6, K6, chain) at the 192- and 96-wide res-block
shapes, sampling the card's SM clock and power draw with ``nvidia-smi``
every 100 ms (the first quarter of the samples dropped): what a power
limit does to each under sustained load.  Prints one JSON object and
writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_attention_ab as K1AB  # noqa: E402  (use_built_tree)
import torch_train_attention_ab as AB  # noqa: E402  (load_file, use_tree)

ROOT = AB.ROOT
TURNS = ("base", "this", "this", "base")


def conv_inputs(cs, VC):
    """[(label, count, args, int8 weights, bf16 packed weights)] at
    ``chip_smoke.CONV_CASES``, made once from a seed."""
    g = torch.Generator(device="cuda").manual_seed(2)
    bf = torch.bfloat16
    out = []
    for label, t, h, w, c, o, k, norm, res, count in cs.CONV_CASES:
        x = torch.randn((t, h, w, c), generator=g, device="cuda").to(bf)
        cache = torch.randn((2, h, w, c), generator=g, device="cuda").to(bf)
        std = 1.0 / math.sqrt(c * 3 * k * k)
        wt = ((torch.rand((o, c, 3, k, k), generator=g, device="cuda") * 2 - 1) * std).to(bf)
        bias = (torch.rand((o,), generator=g, device="cuda") * 2 - 1) * std
        gamma = (1.0 + 0.1 * torch.randn((c,), generator=g, device="cuda")) if norm else None
        resid = torch.randn((t, h, w, o), generator=g, device="cuda").to(bf) if res else None
        out.append((label, count, (x, cache, wt, bias, gamma, resid),
                    VC.pack_weights_int8(wt, gamma), VC.pack_weights(wt)))
    return out


def pair_inputs(cs, VC):
    """[(label, count, args, (packed w1, packed w2))] at
    ``chip_smoke.PAIR_CASES``, made once from a seed."""
    g = torch.Generator(device="cuda").manual_seed(16)
    bf = torch.bfloat16
    out = []
    for label, t, h, w, c, count in cs.PAIR_CASES:
        x = torch.randn((t, h, w, c), generator=g, device="cuda").to(bf)
        c1, c2 = (torch.randn((2, h, w, c), generator=g, device="cuda").to(bf) for _ in range(2))
        std = 1.0 / math.sqrt(27 * c)
        w1, w2 = (((torch.rand((c, c, 3, 3, 3), generator=g, device="cuda") * 2 - 1) * std)
                  .to(bf) for _ in range(2))
        b1, b2 = ((torch.rand((c,), generator=g, device="cuda") * 2 - 1) * std for _ in range(2))
        g1, g2 = (1.0 + 0.1 * torch.randn((c,), generator=g, device="cuda") for _ in range(2))
        out.append((label, count, (x, c1, c2, w1, b1, g1, w2, b2, g2),
                    (VC.pack_weights(w1), VC.pack_weights(w2))))
    return out


def alternated(cs, fns: dict) -> dict:
    """{name: ms} of two functions timed a, b, b, a (each the mean of its
    two readings), ``fns`` {name: (fn, switches set around its timing)}: the
    card's clock under a power limit follows the load just before, so
    neither goes always first."""
    (a, (fa, ea)), (b, (fb, eb)) = fns.items()
    ms = {a: 0.0, b: 0.0}
    for name, fn, env in ((a, fa, ea), (b, fb, eb), (b, fb, eb), (a, fa, ea)):
        with cs.switched(**env):
            ms[name] += cs.cuda_ms(torch, fn, 5) / 2
    return ms


def time_convs(cs, VC, convs):
    """{label: {"int8": ms, "bf16": ms}} and the count-weighted sums."""
    rows, sums = {}, {"int8": 0.0, "bf16": 0.0}
    for label, count, args, w_int8, w_packed in convs:
        rows[label] = alternated(cs, {
            "int8": (lambda: VC.fused_causal_conv(*args, w_int8=w_int8),
                     {"LONGLIVE_VAE_INT8": "1"}),
            "bf16": (lambda: VC.fused_causal_conv(*args, w_packed=w_packed),
                     {"LONGLIVE_VAE_INT8": "0"})})
        for key in sums:
            sums[key] += count * rows[label][key]
    return rows, sums


def time_pairs(cs, VC, pairs):
    """{label: {"k6": ms, "chain": ms}} (chain: two K2 launches) and the
    count-weighted sums."""
    rows, sums = {}, {"k6": 0.0, "chain": 0.0}
    off = {"LONGLIVE_VAE_INT8": "0"}
    for label, count, args, (p1, p2) in pairs:
        x, c1, c2, w1, b1, g1, w2, b2, g2 = args

        def chain():
            y, n1 = VC.fused_causal_conv(x, c1, w1, b1, g1, w_packed=p1)
            return VC.fused_causal_conv(y, c2, w2, b2, g2, residual=x, w_packed=p2)

        rows[label] = alternated(cs, {
            "chain": (chain, off),
            "k6": (lambda: VC.fused_res_block(*args, w1_packed=p1, w2_packed=p2), off)})
        for key in sums:
            sums[key] += count * rows[label][key]
    return rows, sums


def paths(cs, A, VC):
    """DiT and decode ms per latent frame, peak memory and launches of the
    main, tuned, int8 serving and serving-options paths."""
    keys = ("dit_ms_per_latent_frame", "decode_ms_per_latent_frame", "peak_gib", "launches")
    out = {}
    for label, config, mode in (("main", "longlive_inference.yaml", "bias"),
                                ("tuned", "longlive_inference_tuned.yaml", "q_rope")):
        r = cs.run_inference_path(torch, A, VC, label, config, mode)
        out[label] = {k: r[k] for k in keys}
        torch.cuda.empty_cache()
    r = cs.run_int8_serving_path(torch, A, VC)
    out["int8 serving"] = {"dit_ms_per_latent_frame": r["dit_ms_per_latent_frame"],
                           "decode_ms_per_latent_frame": r["decode_ms_per_latent_frame"],
                           "peak_gib": max(r[run]["peak_gib"] for run in ("cold", "warm")),
                           "launches": r["launches"]}
    torch.cuda.empty_cache()
    r = cs.run_serving_options_path(torch, A, VC)
    out["serving options"] = {k: r[k] for k in keys}
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sustained(cs, VC, pairs, secs: float = 4.0) -> list:
    """[{case, what, ms per call, mean SM clock MHz, mean power W}] of K6
    and its chain in loops of ``secs`` at the 192- and 96-wide shapes."""
    rows = []
    for label, count, args, (p1, p2) in pairs:
        if args[0].shape[-1] == 384:
            continue
        x, c1, c2, w1, b1, g1, w2, b2, g2 = args

        def chain():
            y, n1 = VC.fused_causal_conv(x, c1, w1, b1, g1, w_packed=p1)
            return VC.fused_causal_conv(y, c2, w2, b2, g2, residual=x, w_packed=p2)

        def k6():
            return VC.fused_res_block(*args, w1_packed=p1, w2_packed=p2)

        for what, fn in (("chain", chain), ("k6", k6), ("k6", k6), ("chain", chain)):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                    "--format=csv,noheader,nounits", "-lms", "100"],
                                   stdout=subprocess.PIPE, text=True)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            n, t0 = 0, time.perf_counter()
            start.record()
            while time.perf_counter() - t0 < secs:
                fn()
                n += 1
                if n % 4 == 0:
                    torch.cuda.synchronize()
            end.record()
            torch.cuda.synchronize()
            smi.terminate()
            samples = [[float(v) for v in line.split(",")]
                       for line in smi.communicate()[0].splitlines() if line.count(",") == 1]
            samples = samples[len(samples) // 4:]
            rows.append({"case": label, "what": what, "ms": start.elapsed_time(end) / n,
                         "sm_clock_mhz": sum(r[0] for r in samples) / len(samples),
                         "power_w": sum(r[1] for r in samples) / len(samples)})
            print(json.dumps(rows[-1]), flush=True)
    return rows


def summary(res: dict) -> dict:
    """Kernel sums only: the check's numbers without the per-case list."""
    return {k: v for k, v in res.items() if k != "cases"}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True, help="root of the checkout to compare against")
    ap.add_argument("--paths", action="store_true")
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--out", default="build/vae_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("error: needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in true float32,
    torch.backends.cudnn.allow_tf32 = False  # as chip_smoke.py runs them
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    cs = AB.load_file("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    for knob in ("LONGLIVE_INT8_FUSED", "LONGLIVE_VAE_INT8", "LONGLIVE_CROSS_FLASH",
                 "LONGLIVE_TF_ELIDE") + cs.SWITCHES:
        os.environ.pop(knob, None)
    trees = {"base": os.path.abspath(args.base), "this": ROOT}
    result = {"card": card, "torch": torch.__version__, "order": [], "convs": {},
              "conv_sums": {}, "pairs": {}, "pair_sums": {}}
    _, VC = K1AB.use_built_tree(ROOT)
    result["check_int8"] = cs.check_conv(torch, VC, int8=True)
    result["check_pair"] = cs.check_res_block_pair(torch, VC)
    print(json.dumps({"check_int8": summary(result["check_int8"]),
                      "check_pair": summary(result["check_pair"])}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    convs, pairs = conv_inputs(cs, VC), pair_inputs(cs, VC)
    for turn, name in enumerate(TURNS):
        _, VC = K1AB.use_built_tree(trees[name])
        key = f"{name}_{turn}"
        result["order"].append(key)
        result["convs"][key], result["conv_sums"][key] = time_convs(cs, VC, convs)
        result["pairs"][key], result["pair_sums"][key] = time_pairs(cs, VC, pairs)
        print(json.dumps({key: {"conv_sums": result["conv_sums"][key],
                                "pair_sums": result["pair_sums"][key]}}), flush=True)
    if args.clocks:
        _, VC = K1AB.use_built_tree(ROOT)
        with cs.switched(LONGLIVE_VAE_INT8="0"):
            result["clocks"] = sustained(cs, VC, pairs)
    del convs, pairs
    gc.collect()
    torch.cuda.empty_cache()
    if args.paths:
        result["paths"] = {}
        for turn, name in enumerate(TURNS):
            A, VC = K1AB.use_built_tree(trees[name])
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
