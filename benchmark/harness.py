"""What every cell shares: the cell's files found by name, the run's
context (device, seed, set-up phases, tracer), timing helpers, the metric
readers and the result line."""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

ROOT = Path(__file__).resolve().parent.parent  # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "longlive_tpu")


def log(msg: str) -> None:
    print(f"[benchmark] {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(root: Path, workload: str) -> dict:
    """The cell ``workload`` of ``root``/BENCHMARK.json with its
    configuration, traffic mix and limits, each from its own file."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = dict(cells[workload])
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    here = root / "benchmark"
    cell["config_data"] = load_json(root / conf["file"])
    cell["traffic_data"] = load_json(here / "traffic" / f"{cell['traffic']}.json")
    limits = here / "limits" / f"{workload}.json"
    cell["limits"] = load_json(limits)["limits"] if limits.exists() else {}
    cell["end_to_end"] = [m for m in bench["end_to_end"] if _applies(m, workload, None)]
    e2e = {m["name"] for m in cell["end_to_end"]}
    cell["per_layer"] = [m for m in bench["per_layer"] if _applies(m, workload, e2e)]
    return cell


def _applies(metric: dict, workload: str, e2e: Optional[set]) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return e2e is None or metric["moves"] in e2e


def cuda_events(device: torch.device, n: int):
    if device.type != "cuda":
        return [_HostEvent() for _ in range(n)]
    return [torch.cuda.Event(enable_timing=True) for _ in range(n)]


class _HostEvent:
    """A CUDA event's stand-in on the CPU (the tests' runs)."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


def elapsed_ms(a, b) -> float:
    return float(a.elapsed_time(b))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Ctx:
    """One run of one cell."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool, device: torch.device,
                 t_proc0: float, variant: str = "program", root: Path = ROOT):
        self.root = root
        self.cell = cell
        self.workload = cell["name"]
        self.config = cell["config_data"]
        self.traffic = cell["traffic_data"]
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.t_proc0 = t_proc0
        self.variant = variant
        self.world = 1  # the chips the run uses
        self.memory_peak: Optional[int] = None  # the program's, read when the window closes
        self.phases: Dict[str, float] = {}
        self.setup_s: Optional[float] = None
        from .trace import Tracer

        self.tracer = Tracer(device)

    @contextlib.contextmanager
    def phase(self, name: str):
        sync(self.device)
        t = time.perf_counter()
        yield
        sync(self.device)
        self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t

    def setup_done(self) -> None:
        sync(self.device)
        self.setup_s = time.perf_counter() - self.t_proc0

    def read_memory_peak(self) -> None:
        """The device's peak so far: the program's own, read at the window's
        close, before the judgement's captures and the reference."""
        if self.device.type == "cuda":
            self.memory_peak = int(torch.cuda.max_memory_allocated(self.device))

    def load_kernels(self, names: List[str]) -> None:
        """The program's kernel libraries, built into its checkout's
        ``build/kernels`` on a checkout's first run, loaded from there after."""
        if self.device.type != "cuda":
            return
        from longlive_torch.ops import kernels

        for n in names:
            kernels.load(n)


def reader(root: Path, name: str):
    """The reader of metric ``name``: ``benchmark/metrics/<name>.py``'s
    ``read(rec, ctx)``, which returns a number or None."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], rec: dict, ctx: Ctx) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        v = reader(ctx.root, m["name"])(rec, ctx)
        if v is None:
            continue
        if not math.isfinite(v):
            raise RuntimeError(f"metric {m['name']} read {v}")
        out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Modules of JAX or of the JAX package this process holds, by whole
    top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_info(device: torch.device, memory_peak: Optional[int]) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)
                                     if memory_peak is None else memory_peak)}


def judge(compared: List[tuple], limits: Dict[str, float]):
    """(correct, checks): every compared number at or under its limit; a
    number without a limit fails."""
    checks = []
    ok = bool(compared)
    for name, value in compared:
        lim = limits.get(name)
        good = lim is not None and math.isfinite(value) and value <= lim
        ok = ok and good
        checks.append({"name": name, "value": value, "limit": lim, "ok": good})
    return ok, checks


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: List[dict], breakdown: Optional[dict] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return json.dumps(out)


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache a library may keep goes to fixed
    directories inside the checkout."""
    base = root / "build" / "bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
