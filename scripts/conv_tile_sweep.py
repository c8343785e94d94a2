"""Times K2's conv (``ops.vae_conv.fused_causal_conv``) under every tiling
its kernel has an instantiation for, at every fused conv shape of the
Wan2.1 decoder at 480x832 (``chip_smoke.CONV_CASES``), beside the tiling its
rule picks (``ops.vae_conv.conv_tiles``; with ``--int8``, the int8 variant
under ``LONGLIVE_VAE_INT8=1`` and ``conv_int8_tiles``): the measurement
each rule rests on.

Usage (from the repository root, on a host with an NVIDIA Hopper GPU):

    python scripts/conv_tile_sweep.py [--int8] [--out build/conv_tile_sweep.json]

For each shape and each instantiation that fits it (bf16: N, m64 tiles per
consumer warpgroup, channels per K step; int8: N, channels per K step,
boxes whose rows divide the row tile), every box of ``CONV_BOXES`` is timed
(CUDA events, one warm-up call, then 10 calls) after its output is held
against the plain version.  Prints one line per tiling and a summary per
shape, and writes the JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from longlive_torch.ops import vae_conv as VC  # noqa: E402

# (N, m64 tiles, channels per K step) of each instantiation of the kernel
INSTANTIATIONS = ((96, 1, 32), (96, 1, 64), (96, 2, 32), (192, 1, 32), (192, 1, 64))
# the int8 kernel's: (N, channels per K step); N = 192 keeps no float sum
# of the kernel columns, so it runs the time convs (kw = 1) only
INT8_INSTANTIATIONS = ((96, 64), (96, 128), (192, 64), (192, 128))


def tilings(h, w, c, o, kh):
    for bn, mt, kc in INSTANTIATIONS:
        if o % bn or c % kc:
            continue
        for bh, bw in VC.CONV_BOXES[128 * mt]:
            tl = VC.conv_tiling(bh, bw, kc, bn, mt, kh)
            if tl.stages >= 2:
                yield tl


def int8_tilings(w, o, kh, th):
    for bn, kc in INT8_INSTANTIATIONS:
        if o % bn or (bn == 192 and kh != 1):
            continue
        for bh, bw in VC.CONV_BOXES[128]:
            tl = VC.conv_tiling(bh, bw, kc, bn, 1, kh, elem=1)
            if th % bh == 0 and tl.stages >= 2:
                yield tl


def time_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--out", default="build/conv_tile_sweep.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("error: needs a CUDA GPU")
    torch.backends.cudnn.allow_tf32 = False
    os.environ["LONGLIVE_VAE_INT8"] = "1" if args.int8 else "0"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    rule = "conv_int8_tiles" if args.int8 else "conv_tiles"
    pick = getattr(VC, rule)
    g = torch.Generator(device="cuda").manual_seed(2)
    bf = torch.bfloat16
    shapes = []
    try:
        for label, t, h, w, c, o, k, norm, res, count in chip_smoke.CONV_CASES:
            x = torch.randn((t, h, w, c), generator=g, device="cuda").to(bf)
            cache = torch.randn((2, h, w, c), generator=g, device="cuda").to(bf)
            std = 1.0 / math.sqrt(c * 3 * k * k)
            wt = ((torch.rand((o, c, 3, k, k), generator=g, device="cuda") * 2 - 1) * std).to(bf)
            bias = (torch.rand((o,), generator=g, device="cuda") * 2 - 1) * std
            gamma = (1.0 + 0.1 * torch.randn((c,), generator=g, device="cuda")) if norm else None
            resid = torch.randn((t, h, w, o), generator=g, device="cuda").to(bf) if res else None
            wp = dict(w_int8=VC.pack_weights_int8(wt, gamma)) if args.int8 else dict(
                w_packed=VC.pack_weights(wt))
            ref, _ = VC.fused_causal_conv_plain(x, cache, wt, bias, gamma, resid,
                                                wp.get("w_int8"))
            if args.int8:
                th = VC.row_tile(x, wt)
                chosen, cands = tuple(pick(h, w, c, o, k, k, th)), int8_tilings(w, o, k, th)
            else:
                chosen, cands = tuple(pick(h, w, c, o, k)), tilings(h, w, c, o, k)
            rows = []
            for tl in cands:
                setattr(VC, rule, lambda *a, tl=tl: tl)
                run = lambda: VC.fused_causal_conv(x, cache, wt, bias, gamma, resid,  # noqa: E731
                                                   **wp)
                err, tol, rel = chip_smoke.agreement(run()[0], ref)
                if not (err <= tol and rel <= chip_smoke.REL_RMS_LIMIT):
                    sys.exit(f"{label} {tuple(tl)}: disagrees with the plain version "
                             f"({err} / {tol}, {rel})")
                rows.append({"tiles": tuple(tl), "ms": time_ms(run),
                             "picked": tuple(tl) == chosen})
                print(f"{label} x{count} {tuple(tl[:6])} ms={rows[-1]['ms']:.4f}"
                      + (" (picked)" if rows[-1]["picked"] else ""), flush=True)
            best = min(rows, key=lambda r: r["ms"])
            picked = next(r for r in rows if r["picked"])
            print(f"== {label} x{count}: picked {picked['ms']:.4f} ms, best {best['ms']:.4f} "
                  f"{best['tiles'][:6]}", flush=True)
            shapes.append({"case": label, "count": count, "picked_ms": picked["ms"],
                           "best_ms": best["ms"], "best": best["tiles"], "tilings": rows})
            setattr(VC, rule, pick)
            del x, cache, wt, wp, resid, ref
            torch.cuda.empty_cache()
    finally:
        setattr(VC, rule, pick)
    result = {"card": card, "torch": torch.__version__, "variant": "int8" if args.int8 else "bf16",
              "sum_picked_ms": sum(s["count"] * s["picked_ms"] for s in shapes),
              "sum_best_ms": sum(s["count"] * s["best_ms"] for s in shapes), "shapes": shapes}
    print(f"sum over the 30 convs of a later latent frame: picked {result['sum_picked_ms']:.4f} "
          f"ms, best per shape {result['sum_best_ms']:.4f}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
