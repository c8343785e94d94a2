"""Runs a function of the port's multi-rank tests on N gloo ranks: N CPU
processes started with ``subprocess`` (one torch thread each), a gloo
default group met through a file in the test's temporary directory (no
TCP port), a timeout on the group so that a hang fails.

``run_ranks(world, "torch_dist_cases", "fn", args, tmp_path)`` pickles
``args``, starts the ranks, and returns each rank's return value of
``fn(rank, world, args)`` (a rank's error is raised here with its
traceback); ``start_ranks`` returns at once and its ``results()`` waits.
The ranks import torch and the port only, never JAX.

Run as a script, it is one rank: ``python torch_dist.py RANK WORLD DIR``.
"""

from __future__ import annotations

import datetime
import importlib
import os
import pickle
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GROUP_TIMEOUT_S = 120


class Ranks:
    """Ranks started by ``start_ranks``; ``results()`` waits for them."""

    def __init__(self, world: int, d: str, procs: list, timeout_s: float):
        self.world, self.d, self.procs = world, d, procs
        self.deadline = time.monotonic() + timeout_s

    def results(self) -> list:
        try:
            for p in self.procs:
                p.wait(timeout=max(1.0, self.deadline - time.monotonic()))
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        results = []
        for r in range(self.world):
            path = os.path.join(self.d, f"out.{r}.pkl")
            if not os.path.exists(path):
                with open(os.path.join(self.d, f"log.{r}"), errors="replace") as f:
                    log = f.read()[-4000:]
                raise RuntimeError(f"rank {r} of {self.world} wrote no result (exit "
                                   f"{self.procs[r].returncode}):\n{log}")
            with open(path, "rb") as f:
                res, err = pickle.load(f)
            if err is not None:
                raise RuntimeError(f"rank {r} of {self.world} failed:\n{err}")
            results.append(res)
        return results


def start_ranks(world: int, module: str, fn: str, args, tmp_path, timeout_s: float = 300,
                env: dict = None) -> Ranks:
    """Starts the ranks and returns at once: the caller may compute its own
    side (the JAX package's) while they run."""
    d = os.path.join(str(tmp_path), f"ranks_{fn}_{world}_{time.monotonic_ns()}")
    os.makedirs(d)
    with open(os.path.join(d, "args.pkl"), "wb") as f:
        pickle.dump((module, fn, args), f)
    child_env = {k: v for k, v in os.environ.items()
                 if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    child_env.update({"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
                      "PYTHONPATH": os.pathsep.join([ROOT, HERE,
                                                     child_env.get("PYTHONPATH", "")])})
    child_env.update(env or {})
    procs = []
    for r in range(world):  # each rank's output to a file: no pipe to fill
        with open(os.path.join(d, f"log.{r}"), "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(r), str(world), d],
                env=child_env, cwd=str(tmp_path), stdout=log, stderr=subprocess.STDOUT))
    return Ranks(world, d, procs, timeout_s)


def run_ranks(world: int, module: str, fn: str, args, tmp_path, timeout_s: float = 300,
              env: dict = None) -> list:
    return start_ranks(world, module, fn, args, tmp_path, timeout_s, env).results()


def random_tree(shapes, seed: int):
    """A tree of float32 numpy arrays with the structure and shapes of
    ``shapes`` (dicts, lists and leaves with a ``.shape``: a JAX init under
    ``jax.eval_shape``): N(0, 0.05) everywhere, plus 1 for the leaves that
    scale (the norms' weights, the VAE's latent ``std``).  The tests hand
    the same tree to both packages; building it takes none of the JAX
    init's time (~7 s for the tiny DiT, ~21 s for the tiny VAE here)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    scales = ("scale", "norm", "norm1", "norm2", "head_norm", "std")

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, key) for v in node)
        if node is None:
            return None
        a = 0.05 * rng.standard_normal(tuple(node.shape)).astype(np.float32)
        return a + 1.0 if key in scales else a

    return walk(shapes)


def _rank_main(rank: int, world: int, d: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ.setdefault("LOCAL_RANK", "0")
    dist.init_process_group("gloo", init_method="file://" + os.path.join(d, "rendezvous"),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    res, err = None, None
    try:
        with open(os.path.join(d, "args.pkl"), "rb") as f:
            module, fn, args = pickle.load(f)
        res = getattr(importlib.import_module(module), fn)(rank, world, args)
    except BaseException:  # noqa: BLE001 -- written for the parent, which raises it
        err = traceback.format_exc()
    with open(os.path.join(d, f"out.{rank}.pkl"), "wb") as f:
        pickle.dump((res, err), f)
    if err is not None:
        os._exit(1)  # the other ranks' collectives fail on the closed connection
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path[:0] = [ROOT, HERE]
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
