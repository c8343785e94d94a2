"""A/B of K3 (``flash_attention_frame_masked``), K5 (``linear_int8_fused``)
and K4's forward (``flash_attention_train_forward``, which shares its
mainloop with K3) between two checkouts on one GPU.

Usage (from the repository root, on a host with an NVIDIA GPU):

    git archive <base commit> | tar -x -C build/base      # build/ is git-ignored
    python scripts/torch_kernel_ab.py --base build/base [--paths] [--clocks] \
        [--out build/kernel_ab.json]

This checkout's ``chip_smoke.py`` drives each checkout's ``longlive_torch``
in turn (base, this tree, this tree, base; ``use_tree`` of
``scripts/torch_train_attention_ab.py``, every kernel built before its first
turn): the other checkout is used only through ``longlive_torch``'s entry
points.  Once, on this tree, ``chip_smoke.check_frame_masked`` and
``chip_smoke.check_int8_linear`` check both kernels against their plain
versions and give the plain, library and bound times.  Every turn then
times (CUDA events after a warm-up) on inputs made once from seeds: K3 at
every shape of ``chip_smoke.MASKED_CASES`` (3 calls back to back) and K5
at every shape of ``chip_smoke.K5_CASES`` (20 calls queued behind a sleep,
``chip_smoke.device_ms``: its device time, which its host work would hide
otherwise; back to back as well), with a projection of K5's device time in
one steady DiT block (900 times the one-call time at q/k/v/o's shape plus
150 times fc1's: not a measurement of a block, which
``scripts/torch_breakdown.py`` profiles), and K4's forward at the four
shapes of ``chip_smoke.train_attention_cases`` (5 calls back to back), its
outputs held bit for bit against the first turn's.  On this tree alone,
alternated a, b, b, a: K3 with its q tiles heaviest first (the wrapper's
order) against tile order.  ``--clocks`` runs, on this tree only, K5 at
fc1's shape and ``torch._int_mm`` on the same int8 operands in sustained
loops of 3 s (K5, _int_mm, _int_mm, K5), sampling the card's SM clock and
power draw with ``nvidia-smi``.  ``--paths`` then runs, in the same order of turns,
the main path, the int8 serving path, the serving-options path and the
full forwards (``chip_smoke.run_*``, launch counts asserted) and keeps
their DiT ms per latent frame, decode ms per latent frame, the forwards'
wall times, peak memory and launches, and profiles one serving-options DiT
block (``torch_breakdown.dit_block``: wall, device busy time, idle share,
groups).  Prints one JSON object and writes it to ``--out``.
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
FS, HEADS = 1560, 12  # tokens per latent frame at 60 x 104, heads of 128


def masked_inputs(cs):
    """[(label, q, k, v, mask keywords)] at ``chip_smoke.MASKED_CASES``."""
    g = torch.Generator(device="cuda").manual_seed(18)
    out = []
    for label, kind, f, nfb, local, sink in cs.MASKED_CASES:
        tf = kind == "teacher_forcing"
        s = (2 if tf else 1) * f * FS
        q, k, v = (torch.randn((1, s, HEADS, 128), generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        out.append((label, q, k, v, dict(mask_kind=kind, frame_seq=FS, nfb=nfb, local=local,
                                         sink=sink, clean_frames=f if tf else 0)))
    return out


def linear_inputs(cs, Q):
    """[(label, calls per block, x, quantized linear)] at ``chip_smoke.K5_CASES``."""
    g = torch.Generator(device="cuda").manual_seed(13)
    return [(label, per_block) + cs.int8_linear_inputs(torch, Q, m, k, n, g)
            for label, m, k, n, per_block in cs.K5_CASES]


def time_turn(cs, A, Q, masked, linears, train) -> tuple:
    """({"k3": {label: ms}, "k5": {label: device ms}, "k5_host": {label: ms
    of back-to-back calls, host work included}, "k5_block_projection_ms":
    900 x q/k/v/o's + 150 x fc1's device ms, "k4_fwd": {label: ms}}, {label:
    K4 forward's (out, lse)}) of one tree."""
    k3 = {label: cs.cuda_ms(torch, lambda: A.flash_attention_frame_masked(q, k, v, **kw), 3)
          for label, q, k, v, kw in masked}
    k5 = {label: cs.device_ms(torch, lambda: Q.linear_int8_fused(x, p), 20)
          for label, _, x, p in linears}
    k5_host = {label: cs.cuda_ms(torch, lambda: Q.linear_int8_fused(x, p), 20)
               for label, _, x, p in linears}
    k4 = {label: cs.cuda_ms(torch, lambda: A.flash_attention_train_forward(q, k, v, valid), 5)
          for label, q, k, v, _, valid in train}
    k4_out = {label: A.flash_attention_train_forward(q, k, v, valid)
              for label, q, k, v, _, valid in train}
    return ({"k3": k3, "k5": k5, "k5_host": k5_host,
             "k5_block_projection_ms": sum(per * k5[label] for label, per, _, _ in linears),
             "k4_fwd": k4}, k4_out)


def alternated(timer, fns: dict, reps: int) -> dict:
    """{name: ms} of two functions timed by ``timer`` a, b, b, a (each the
    mean of its two readings): the card's clock under a power limit follows
    the load just before, so neither goes always first."""
    (a, fa), (b, fb) = fns.items()
    ms = {a: 0.0, b: 0.0}
    for name, fn in ((a, fa), (b, fb), (b, fb), (a, fa)):
        ms[name] += timer(torch, fn, reps) / 2
    return ms


def k3_orders(cs, A, masked) -> dict:
    """{label: {"heaviest_first": ms, "tile_order": ms}} of this tree's K3."""
    out = {}
    for label, q, k, v, kw in masked:
        b, s, n, d = q.shape
        qs = A._scaled_q(q, 1.0 / math.sqrt(d))
        res = torch.empty_like(q)
        heavy = A._cta_order_on(q.device, kw["mask_kind"], s, s, kw["frame_seq"], kw["nfb"],
                                kw["local"], kw["sink"], kw["clean_frames"])
        ident = torch.arange(heavy.numel(), dtype=torch.int32, device="cuda")
        out[label] = alternated(cs.cuda_ms, {
            name: (lambda order=order: A._frame_masked_launch(qs, k, v, res, order, elide=True,
                                                              **kw))
            for name, order in (("heaviest_first", heavy), ("tile_order", ident))}, 3)
    return out


def sustained(fn, secs: float = 3.0) -> dict:
    """{ms per call, mean SM clock MHz, mean power W} of ``fn`` in a loop of
    ``secs``, sampling the card with ``nvidia-smi`` every 100 ms (the first
    quarter of the samples dropped)."""
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
        if n % 8 == 0:
            torch.cuda.synchronize()
    end.record()
    torch.cuda.synchronize()
    smi.terminate()
    samples = [[float(v) for v in line.split(",")]
               for line in smi.communicate()[0].splitlines() if line.count(",") == 1]
    samples = samples[len(samples) // 4:]
    return {"ms": start.elapsed_time(end) / n,
            "sm_clock_mhz": sum(r[0] for r in samples) / len(samples),
            "power_w": sum(r[1] for r in samples) / len(samples)}


def clocks(Q, linears) -> list:
    """K5 at fc1's shape and ``torch._int_mm`` on the same int8 operands in
    sustained loops (K5, _int_mm, _int_mm, K5): the clock and power each
    runs at."""
    _, _, x, p = next(item for item in linears if item[0].startswith("fc1"))
    xq, _ = Q.kernel_quantized_rows(x)
    wt = p["w_int8"].t()
    fns = {"k5": lambda: Q.linear_int8_fused(x, p), "int_mm": lambda: torch._int_mm(xq, wt)}
    return [dict(what=name, **sustained(fns[name]))
            for name in ("k5", "int_mm", "int_mm", "k5")]


def options_block(tree: str) -> dict:
    """The profile of one serving-options DiT block (``torch_breakdown``'s,
    on the loaded checkout): wall ms, device busy ms, idle share, groups."""
    bd = AB.load_file("torch_breakdown", os.path.join(ROOT, "scripts", "torch_breakdown.py"))
    pc = bd._config("longlive_inference.yaml", kernel_cache=False)
    row, _ = bd.dit_block(torch.device("cuda"), f"DiT block, serving options ({tree})", pc,
                          env={k: "1" for k in ("LONGLIVE_TWO_SEGMENT", "LONGLIVE_EXP2",
                                                "LONGLIVE_MXU_LSUM")})
    return {k: row[k] for k in ("wall_ms", "device_busy_ms", "idle_share", "groups_ms")}


def paths(cs, A, VC, tree: str) -> dict:
    """The main, int8 serving and serving-options paths' DiT (and decode)
    ms per latent frame, the full forwards' wall ms, peaks and launches,
    and the serving-options block's profile."""
    out = {}
    r = cs.run_inference_path(torch, A, VC, "main", "longlive_inference.yaml", "bias")
    out["main"] = {k: r[k] for k in ("dit_ms_per_latent_frame", "peak_gib", "launches")}
    torch.cuda.empty_cache()
    r = cs.run_int8_serving_path(torch, A, VC)
    out["int8 serving"] = {"dit_ms_per_latent_frame": r["dit_ms_per_latent_frame"],
                           "switch_stall_ms": r["warm"]["switch_stall_ms"],
                           "peak_gib": max(r[run]["peak_gib"] for run in ("cold", "warm")),
                           "launches": r["launches"]}
    torch.cuda.empty_cache()
    r = cs.run_serving_options_path(torch, A, VC)
    out["serving options"] = {k: r[k] for k in ("dit_ms_per_latent_frame",
                                                "decode_ms_per_latent_frame", "peak_gib",
                                                "launches")}
    torch.cuda.empty_cache()
    out["serving options block"] = options_block(tree)
    gc.collect()
    torch.cuda.empty_cache()
    out["full forwards"] = cs.run_full_forwards_path(torch, A, VC)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True, help="root of the checkout to compare against")
    ap.add_argument("--paths", action="store_true")
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--out", default="build/kernel_ab.json")
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
    result = {"card": card, "torch": torch.__version__, "order": [], "turns": {}}
    A, _ = K1AB.use_built_tree(ROOT)
    Q = sys.modules["longlive_torch.ops.quant"]
    result["check_k3"] = cs.check_frame_masked(torch, A)
    result["check_k5"] = cs.check_int8_linear(torch, Q)
    gc.collect()
    torch.cuda.empty_cache()
    masked, linears = masked_inputs(cs), linear_inputs(cs, Q)
    train = AB.inputs(cs.train_attention_cases(torch))
    result["k3_orders"] = k3_orders(cs, A, masked)
    print(json.dumps({"k3_orders": result["k3_orders"]}), flush=True)
    if args.clocks:
        result["clocks"] = clocks(Q, linears)
        print(json.dumps({"clocks": result["clocks"]}), flush=True)
    first = None
    for turn, name in enumerate(TURNS):
        A, _ = K1AB.use_built_tree(trees[name])
        Q = sys.modules["longlive_torch.ops.quant"]
        key = f"{name}_{turn}"
        result["order"].append(key)
        result["turns"][key], k4_out = time_turn(cs, A, Q, masked, linears, train)
        first = first or k4_out
        result["turns"][key]["k4_fwd_equal_to_first_turn"] = {
            label: all(torch.equal(a, b) for a, b in zip(out, first[label]))
            for label, out in k4_out.items()}
        print(json.dumps({key: result["turns"][key]}), flush=True)
        del k4_out
    del masked, linears, train, first
    gc.collect()
    torch.cuda.empty_cache()
    if args.paths:
        result["paths"] = {}
        for turn, name in enumerate(TURNS):
            A, VC = K1AB.use_built_tree(trees[name])
            key = f"{name}_{turn}"
            result["paths"][key] = paths(cs, A, VC, key)
            print(json.dumps({"paths": key, "result": result["paths"][key]}, default=str),
                  flush=True)
    text = json.dumps(result, indent=1, default=str)
    print(text)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text)


if __name__ == "__main__":
    main()
