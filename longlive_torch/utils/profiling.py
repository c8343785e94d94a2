"""Tracing and profiling.

- ``trace(logdir)``: a ``torch.profiler`` capture of the enclosed region
  (the CPU, and the card where CUDA is present), written into ``logdir`` as
  a Chrome trace;
- ``annotate(name)``: a named range in that trace (``record_function``),
  and an NVTX range where CUDA is present;
- ``PhaseTimer``: wall time per named phase, synchronised on the stream of
  given tensors.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

import torch


@contextlib.contextmanager
def trace(logdir: str = "profiles"):
    """Profiles the enclosed region and writes ``logdir/trace.json`` (open
    it in Perfetto or chrome://tracing).  Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named range around the enclosed launches (an NVTX range too on a
    host with CUDA)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


class PhaseTimer:
    """Per-phase wall times (``phases``: name -> seconds of each call) and the
    JAX package's breakdown text (``report``)."""

    def __init__(self):
        self.phases: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync_on=None):
        """Times the enclosed region; ``sync_on`` (a tensor or a tree of
        them) makes the time include the work queued on their devices'
        current streams, which the timer waits for."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            for dev in {t.device for t in _tensors(sync_on) if t.is_cuda}:
                torch.cuda.current_stream(dev).synchronize()
            self.phases.setdefault(name, []).append(time.perf_counter() - t0)

    def report(self) -> str:
        lines = ["Profiling results:"]
        total = sum(sum(v) for v in self.phases.values())
        for name, vals in self.phases.items():
            s = sum(vals)
            lines.append(
                f"  - {name}: {s*1e3:.2f} ms over {len(vals)} calls "
                f"({100*s/max(total,1e-9):.1f}%)"
            )
        lines.append(f"  - Total: {total*1e3:.2f} ms")
        return "\n".join(lines)
