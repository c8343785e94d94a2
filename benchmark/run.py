"""Runs one cell of the benchmark once.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It makes its weights and inputs from the
seed on the card, loads the program's kernels, warms up the cell's shapes
(all of that is ``setup_s``), measures for ``--seconds``, judges what the
window produced against the plain reference, and prints one JSON line last
on standard output: the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics from a traced run (``--trace 1``).

``--variant int8`` runs the program's int8 serving path in place of its
bf16 one, ``--variant fp8ref`` the plain reference with float8 operands in
the sampler's place: the controls of the correctness limits (PERF.md),
never run by a check.
"""

import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from .harness import (ROOT, Ctx, cache_dirs, device_info, find_cell,  # noqa: E402
                      forbidden_modules, judge, log, read_metrics, result_line)


def parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--variant", choices=("program", "int8", "fp8ref"), default="program")
    return ap.parse_args(argv)


def main(argv=None, root: Path = ROOT, require_chip: bool = True, device: str = "cuda") -> int:
    """One run; ``device`` other than ``cuda`` (the CPU tests' rehearsal)
    skips the look for a card."""
    args = parse(argv)
    require_chip = require_chip and device == "cuda"
    cache_dirs(root)
    cell = find_cell(root, args.workload)
    chips = int(cell["chips"])
    import torch

    if require_chip and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        log(f"{args.workload} needs {chips} CUDA device(s); this host has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
    ctx = Ctx(cell, args.seed, args.seconds, args.trace, dev, T_PROC0, args.variant, root)
    ctx.phases["process_to_context"] = time.perf_counter() - T_PROC0
    if args.variant == "int8":
        os.environ["LONGLIVE_INT8_FUSED"] = "1"
        os.environ["LONGLIVE_VAE_INT8"] = "1"
    kind = ctx.traffic["kind"]
    if kind == "serve":
        from .serve import Serve

        driver = Serve(ctx)
    elif kind == "sampler":
        from .sampler import Sampler

        driver = Sampler(ctx)
    else:
        raise SystemExit(f"traffic kind {kind!r}: serve or sampler")
    rec = driver.run()
    dinfo = device_info(dev, ctx.memory_peak)
    if args.trace:
        summ = ctx.tracer.summary
        rec["trace"] = summ
        dinfo["busy_s"] = summ["busy_s"]
        dinfo["window_s"] = summ["window_s"]
    metrics = read_metrics(cell["per_layer"] if args.trace else cell["end_to_end"], rec, ctx)
    t_judge = time.perf_counter()
    compared = driver.judge()
    judge_s = time.perf_counter() - t_judge
    correct, checks = judge(compared, cell["limits"])
    bad = forbidden_modules()
    if bad:
        log(f"this process holds {bad}")
        return 3
    lines = [json.dumps({"setup_phases_s": ctx.phases, "setup_s": ctx.setup_s,
                         "window_s": rec["window_s"], "attempted": rec["attempted"],
                         "counters": rec.get("counters"), "judge_s": judge_s,
                         "gap_samples": len(rec.get("gaps_ms", [])),
                         "switches": len(rec.get("switch_ms", [])),
                         "gap_max_ms": max(rec.get("gaps_ms") or [0.0]),
                         "span_s": {k: sum(v) / 1e3 for k, v in rec.get("spans", {}).items()},
                         "trace_reduce_s": ctx.tracer.reduce_s,
                         "diagnostics": getattr(driver, "diag", None)}),
             result_line(correct, rec["attempted"], sum(1 for c in checks if not c["ok"]),
                         metrics, dinfo, checks,
                         rec["trace"]["breakdown"] if args.trace else None)]
    for c in checks:
        log(f"check {c['name']} = {c['value']!r} (limit {c['limit']!r})")
    print("\n".join(lines), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
