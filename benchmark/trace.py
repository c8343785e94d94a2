"""The traced window of a ``--trace 1`` run: ``torch.profiler`` over a few
steady steps, reduced to device time by kernel group, the device's busy
time, its idle gaps by what the host was doing, and the top operations.

The kernel-name groups are a frozen copy of ``scripts/torch_breakdown.py``'s
so that the benchmark reads the same names whatever that script
becomes.  Nothing is written to disk.
"""

from __future__ import annotations

import re
import time
from typing import Dict, List, Optional, Tuple

import torch

GROUPS = (
    ("K1", ("serving_attention_kernel",)),
    ("K4", ("fwd_kernel", "bwd_dq_kernel", "bwd_dkdv_kernel")),
    ("K6", ("conv_input_kernel<6>", "biasnormsilu", "pairresidual")),
    ("K2", ("causal_conv_wgmma_kernel", "conv_input_kernel", "causal_conv_int8_wgmma_kernel",
            "conv_int8_input_kernel", "conv_int8_quantize_kernel")),
    ("K3", ("frame_masked_kernel",)),
    ("K5", ("int8_linear_quantize_kernel", "int8_linear_gemm_kernel")),
    ("cudnn", ("fprop", "conv", "cudnn", "winograd")),
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
)
OTHER = "glue"
WINDOW = "bench.window"


def group(name: str) -> str:
    low = name.lower()
    for label, keys in GROUPS:
        if any(k in low for k in keys):
            return label
    return OTHER


def _clean(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", name)[:64]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def summarize(kernels: List[Tuple[str, float, float]], host: List[Tuple[str, float, float]],
              w0: float, w1: float) -> dict:
    """Device ops (name, start, end) and host ops, in one clock (seconds),
    over the window [w0, w1] -> the summary every reader takes."""
    clipped = [(n, max(a, w0), min(b, w1)) for n, a, b in kernels if b > w0 and a < w1]
    busy = _union([(a, b) for _, a, b in clipped])
    busy_s = sum(b - a for a, b in busy)
    groups: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    for n, a, b in clipped:
        g = group(n)
        groups[g] = groups.get(g, 0.0) + (b - a)
        key = f"{g}:{n}"
        by_name[key] = by_name.get(key, 0.0) + (b - a)
    gaps = []
    t = w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    host = sorted(host, key=lambda e: e[1])
    idle: Dict[str, float] = {}
    active: List[Tuple[str, float, float]] = []
    j = 0
    for a, b in gaps:  # in time order: a sweep over the host ops
        mid = 0.5 * (a + b)
        while j < len(host) and host[j][1] <= mid:
            active.append(host[j])
            j += 1
        active = [e for e in active if e[2] >= mid]
        label = min(active, key=lambda e: e[2] - e[1])[0] if active else "no_host_operation"
        idle[label] = idle.get(label, 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": w1 - w0, "busy_s": busy_s, "groups": groups,
            "breakdown": {"device_ops": [[_clean(n), s] for n, s in top],
                          "idle_gaps": [[_clean(n), s] for n, s in gaps_top]}}


class Tracer:
    """Starts and stops the profiler around the traced steps.  The device's
    own trace (``host=False``: kernels only, which costs the host next to
    nothing) gives ``summary``: busy time, groups, top operations, over the
    span from its first operation's start to its last one's end.  A second,
    short window with the host's operations too (``host=True``; their
    recording slows the host, so its idle share reads high) labels the idle
    gaps by what the host was doing."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.span = None
        self.host = False
        self.summary: Optional[dict] = None
        self.reduce_s = 0.0

    def start(self, host: bool = False) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.host = host or self.device.type != "cuda"
        acts = [torch.profiler.ProfilerActivity.CPU] if self.host else []
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.span = torch.profiler.record_function(WINDOW)
        self.span.__enter__()

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        t = time.perf_counter()
        kernels, host, window = [], [], None
        cuda = torch.autograd.DeviceType.CUDA
        for e in self.prof.profiler.kineto_results.events():
            s, f = e.start_ns() * 1e-9, e.end_ns() * 1e-9
            name = e.name()
            if e.device_type() == cuda:
                if not e.is_user_annotation():  # the device-side copies of host spans
                    kernels.append((name, s, f))
            elif name == WINDOW:
                window = (s, f)
            elif f > s:
                host.append((name, s, f))
        self.prof = None
        if not self.host:
            if not kernels:
                raise RuntimeError("the device's trace holds no operation")
            window = (min(k[1] for k in kernels), max(k[2] for k in kernels))
        if window is None:
            raise RuntimeError("the traced window's span is missing from the profile")
        summ = summarize(kernels, host, *window)
        if self.host and self.summary is not None:  # the labels of the idle gaps
            self.summary["breakdown"]["idle_gaps"] = summ["breakdown"]["idle_gaps"]
        else:
            self.summary = summ
        self.reduce_s += time.perf_counter() - t
