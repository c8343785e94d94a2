"""Process groups, the (dp, fsdp, sp) mesh and the parameter sharding rules.

The JAX package runs one process over a device mesh and lets XLA insert
the collectives (``longlive_tpu/parallel/mesh.py``).  The port runs one
process per card under ``torchrun`` and calls ``torch.distributed``
itself: NCCL for CUDA tensors, gloo for CPU tensors (the tests).  A CUDA
tensor's collective goes over NCCL or raises; nothing is staged through
host memory.

- ``init_distributed`` reads ``torchrun``'s environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) and
  starts the default group with a timeout, so a hang fails;
- ``make_mesh`` lays the ranks out as ``(dp, fsdp, sp)``, row-major, as a
  ``DeviceMesh`` with those dimension names; ``axis_size`` /
  ``axis_rank`` / ``axis_group`` read one axis;
- the FSDP rules (``_DIT_RULES``) are the JAX package's, carried to the
  port's layout: a linear is ``{"weight": [out, in], "bias": [out]}``, so
  JAX's ``d_out`` axis is the weight's dim 0 and ``d_in`` its dim 1.  A dim
  that the ``fsdp`` axis does not divide does not take the rule (JAX's
  ``param_pspec``: the next rule is tried, and a leaf that none takes is
  replicated);
- ``leaf_specs`` lists each leaf's sharded dim; ``shard_params`` returns
  this rank's shards; ``gather_params`` puts a tree of shards back together
  (every rank of the ``fsdp`` group calls it);
- ``batch_rows`` is this dp rank's slice of a global batch (JAX's
  ``batch_sharding``, rows over ``dp``).
"""

from __future__ import annotations

import datetime
import os
import re
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.memory import map_tree

AXES = ("dp", "fsdp", "sp")
# a collective that waits longer than this fails the run instead of hanging it
TIMEOUT_S = 900.0


def init_distributed(device="cuda") -> Tuple[int, int, torch.device]:
    """(rank, world size, this rank's device) from ``torchrun``'s
    environment.  With ``WORLD_SIZE`` > 1 the default process group starts
    here (once): NCCL for ``cuda``, gloo for ``cpu``, rendezvous through
    ``MASTER_ADDR`` / ``MASTER_PORT``.  Under ``torchrun`` "the card" is
    ``cuda:$LOCAL_RANK``, made the current device.  Without ``torchrun``
    the world is one rank and no group starts.  A default group started
    before (a test's gloo ranks) is taken as it is."""
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        rank = int(os.environ.get("RANK", "0"))
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {str(device)!r} requested but CUDA is not available "
                               "on this host; pass --device cpu to run the plain PyTorch paths")
        if world > 1:
            if local >= torch.cuda.device_count():
                raise RuntimeError(f"LOCAL_RANK {local}: this host has "
                                   f"{torch.cuda.device_count()} CUDA device(s); start "
                                   "torchrun with --nproc_per_node at most that")
            dev = torch.device("cuda", local)
            torch.cuda.set_device(dev)
    if world > 1 and not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return rank, world, dev


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return global_rank() == 0


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def make_mesh(dp: int = 1, fsdp: Optional[int] = None, sp: int = 1, device_type: str = "cuda"):
    """The world's ranks as a ``(dp, fsdp, sp)`` ``DeviceMesh``, row-major
    (rank = (dp_i * fsdp + fsdp_i) * sp + sp_i).  Default: every rank on
    ``fsdp``.  The product must equal the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    n = world_size()
    if fsdp is None:
        fsdp = n // (dp * sp) if n % (dp * sp) == 0 else 0
    if dp * fsdp * sp != n or min(dp, fsdp, sp) < 1:
        raise LayoutError(f"mesh dp {dp} x fsdp {fsdp} x sp {sp} != world size {n}: start "
                         f"torchrun with --nproc_per_node {dp * max(fsdp, 1) * sp}, or change "
                         "the mesh")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: run under torchrun (or call "
                           "torch.distributed.init_process_group first)")
    return init_device_mesh(device_type, (dp, fsdp, sp), mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh[axis].size()


def axis_rank(mesh, axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    return mesh.get_group(axis)


# ---------------------------------------------------------------------------
# FSDP rules: (path regex, the dim sharded over ``fsdp``).  Paths join the
# tree's keys and list indices with "/" (``blocks/3/ffn/fc1/weight``).
# JAX's stacked-layer specs, e.g. ``P(None, None, "fsdp")`` on a kernel
# [L, d_in, d_out], become dim 0 of the port's [out, in] weight.

_DIT_RULES: Sequence[Tuple[str, int]] = (
    (r"blocks/\d+/ffn/fc1/weight", 0),
    (r"blocks/\d+/ffn/fc1/bias", 0),
    (r"blocks/\d+/ffn/fc2/weight", 1),
    (r"blocks/\d+/(self_attn|cross_attn)/[qkv]/weight", 0),
    (r"blocks/\d+/(self_attn|cross_attn)/[qkv]/bias", 0),
    (r"blocks/\d+/(self_attn|cross_attn)/o/weight", 1),
    (r"time_projection/fc/weight", 0),
    (r"time_projection/fc/bias", 0),
    (r"text_embedding/fc1/weight", 1),
    (r"token_embedding", 0),  # T5
    (r"blocks/\d+/attn/[qkv]", 0),  # T5
    (r"blocks/\d+/attn/o", 1),  # T5
    (r"blocks/\d+/ffn/(gate|fc1)", 0),  # T5 (no bias)
)


def shard_dim(path: str, shape: Sequence[int], fsdp: int, rules=_DIT_RULES) -> Optional[int]:
    """The dim of the leaf at ``path`` sharded over an ``fsdp`` axis of
    that size, or None (replicated).  The first rule whose pattern matches
    and whose dim the axis divides wins."""
    if fsdp <= 1:
        return None
    for pat, dim in rules:
        if re.search(pat, path) and dim < len(shape) and shape[dim] % fsdp == 0:
            return dim
    return None


def _walk(tree: Any, fn, path: str = "") -> Any:
    """``fn(path, leaf)`` over a tree of dicts, lists and tensors."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(path, tree)


def named_leaves(tree: Any) -> list:
    """(path, tensor) of every tensor of a tree, in
    ``utils.memory.param_leaves`` order."""
    out = []
    _walk(tree, lambda p, t: out.append((p, t)))
    return out


def leaf_specs(tree: Any, fsdp: int, rules=_DIT_RULES) -> list:
    """The ``shard_dim`` of every tensor of a full tree, in
    ``utils.memory.param_leaves`` order."""
    return [shard_dim(p, tuple(t.shape), fsdp, rules) for p, t in named_leaves(tree)]


def shard_params(params: Any, mesh, rules=_DIT_RULES) -> Any:
    """This rank's shards of a full parameter tree under the FSDP rules (a
    contiguous copy of its slice; replicated leaves are kept as they are)."""
    n, r = axis_size(mesh, "fsdp"), axis_rank(mesh, "fsdp")

    def place(path, t):
        dim = shard_dim(path, tuple(t.shape), n, rules)
        if dim is None:
            return t
        return t.detach().chunk(n, dim)[r].clone().requires_grad_(t.requires_grad)

    return _walk(params, place)


def _all_gather_single():
    # torch 2.13 renames all_gather_into_tensor; both take (out, in, group)
    return getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _reduce_scatter_single():
    return getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def all_gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's tensors concatenated along ``dim``, in rank order."""
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=t.dtype,
                      device=t.device)
    _all_gather_single()(out, src, group=group)
    return out.movedim(0, dim)


def reduce_scatter_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's sum of ``t``, this rank's slice of it along ``dim``."""
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=t.dtype,
                      device=t.device)
    _reduce_scatter_single()(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def gather_params(shards: Any, specs: list, mesh) -> Any:
    """The full tree from every ``fsdp`` rank's shards; ``specs``: the full
    tree's ``leaf_specs``.  The gathered tensors are new tensors without
    history; replicated leaves are returned as they are."""
    group = axis_group(mesh, "fsdp")
    dims = iter(specs)

    def gather(t):
        dim = next(dims)
        if dim is None:
            return t
        with torch.no_grad():
            return all_gather_dim(t.detach(), dim, group)

    return map_tree(gather, shards)


def batch_rows(mesh, n: int) -> slice:
    """This dp rank's rows of a global batch of ``n`` (contiguous, in dp
    order: JAX's ``P("dp")`` on the leading dim)."""
    dp, r = axis_size(mesh, "dp"), axis_rank(mesh, "dp")
    if n % dp:
        raise ValueError(f"global batch {n} does not divide over dp {dp}")
    b = n // dp
    return slice(r * b, (r + 1) * b)


class LayoutError(ValueError):
    """A mesh that the run's ranks cannot form (the CLIs exit with it)."""


def serving_ranks(sp: int, device):
    """The serving CLIs' layout of ``torchrun``'s ranks: ``world / sp``
    groups of ``sp`` ranks, each group rendering its share of the prompt
    rows, sequence-parallel over its ranks.  Returns (the mesh for the
    pipeline, None unless sp > 1; this rank's device; this group's index;
    the number of groups; whether this rank writes: its group's rank 0).
    Without ``torchrun``: (None, device, 0, 1, True)."""
    _, world, dev = init_distributed(device)
    if sp < 1 or world % sp:
        raise LayoutError(f"--sp {sp} does not divide the {world} rank(s) of this run: start "
                         f"it with torchrun --nproc_per_node N, N a multiple of {sp}")
    if world == 1:
        return None, dev, 0, 1, True
    mesh = make_mesh(dp=world // sp, fsdp=1, sp=sp, device_type=dev.type)
    return (mesh if sp > 1 else None, dev, axis_rank(mesh, "dp"), world // sp,
            axis_rank(mesh, "sp") == 0)


def check_replicated(t: torch.Tensor, group, what: str) -> None:
    """Raises unless every rank of ``group`` holds the same ``t``: the
    ranks of an sp group seed their draws alike and must stay in step."""
    every = all_gather_dim(t.contiguous()[None], 0, group)
    if not torch.equal(every, every[:1].expand_as(every)):
        diff = (every - every[:1]).abs().max().item()
        raise RuntimeError(f"{what} differ across the sp group's ranks (max |x - x_rank0| "
                           f"{diff}): the ranks fell out of step")
