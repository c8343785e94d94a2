"""Host memory for parameter trees, and layer streaming.

A parameter tree (nested dicts, lists and tuples of tensors) that does not
fit on the card beside everything else lives in the host's memory and
comes over per use:

- ``offload_to_host`` / ``fetch_from_host``: a whole tree out to pinned
  host memory and back (the trainer's page-outs between phases);
- ``blocks_to_host`` + ``stream_scan``: the layer stack stays on the host,
  the embeddings and the head on the card, and each layer is copied to the
  card one layer ahead of its compute (a 14B teacher or sampler next to
  everything else).

Pinned host memory comes from 1 GiB slabs (``HostArena``): PyTorch's
caching host allocator rounds every request up to a power of two, so one
request per tensor would waste up to half of a 52 GiB layer stack.  Without
CUDA the host copies are plain CPU tensors.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import torch

SLAB_BYTES = 1 << 30
_ALIGN = 512  # bytes; every tensor of a slab starts on such a boundary


def param_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a parameter tree, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in tree for t in param_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in param_leaves(v)]
    return [] if tree is None else [tree]


def map_tree(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``fn`` applied to every tensor of a parameter tree, same structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(map_tree(fn, v) for v in tree)
    return None if tree is None else fn(tree)


class HostArena:
    """Pinned host tensors carved out of 1 GiB pinned slabs, first fit over
    the slabs already open.  A tensor larger than a slab gets a pinned
    buffer of its own.  The slabs live as long as any tensor carved out of
    them; freed, they return to PyTorch's caching host allocator."""

    def __init__(self):
        self._slabs: List[list] = []  # [buffer, bytes used]

    def empty(self, shape, dtype: torch.dtype) -> torch.Tensor:
        if not torch.cuda.is_available():
            return torch.empty(shape, dtype=dtype)
        n = torch.Size(shape).numel() * torch.empty((), dtype=dtype).element_size()
        size = -(-n // _ALIGN) * _ALIGN
        if size > SLAB_BYTES:
            buf, off = torch.empty(size, dtype=torch.uint8, pin_memory=True), 0
        else:
            for slab in self._slabs:
                if slab[1] + size <= SLAB_BYTES:
                    break
            else:
                slab = [torch.empty(SLAB_BYTES, dtype=torch.uint8, pin_memory=True), 0]
                self._slabs.append(slab)
            buf, off = slab[0], slab[1]
            slab[1] += size
        return buf[off:off + n].view(dtype).view(shape)

    def empty_like(self, t: torch.Tensor) -> torch.Tensor:
        """An empty tensor shaped like ``t``, with its strides where ``t`` is
        dense (a transposed weight stays transposed: a GEMM's bits may
        depend on its operand's layout)."""
        flat = self.empty((t.numel(),), t.dtype)
        order = sorted(range(t.dim()), key=lambda d: -t.stride(d))
        if t.permute(order).is_contiguous():
            return flat.as_strided(t.shape, t.stride())
        return flat.view(t.shape)


def _host_copy(t: torch.Tensor, arena: HostArena) -> torch.Tensor:
    if t.device.type == "cpu" and t.is_pinned():
        return t
    return arena.empty_like(t).copy_(t.detach())


def offload_to_host(tree: Any, arena: Optional[HostArena] = None) -> Any:
    """The tree copied to pinned host memory (``arena``'s slabs, a new
    arena's by default).  Tensors already pinned are kept as they are; a
    device tensor's copy waits for the device."""
    arena = arena or HostArena()
    return map_tree(lambda t: _host_copy(t, arena), tree)


def fetch_from_host(tree: Any, device, non_blocking: bool = True) -> Any:
    """The tree on ``device``; copies from pinned memory do not wait for the
    device (tensors already there are kept)."""
    return map_tree(lambda t: t.to(device, non_blocking=non_blocking), tree)


def hbm_bytes(tree: Any) -> int:
    """Bytes of the tree's tensors."""
    return sum(t.numel() * t.element_size() for t in param_leaves(tree))


def blocks_to_host(params: dict, device, key: str = "blocks",
                   arena: Optional[HostArena] = None) -> dict:
    """The tree with its layer stack ``params[key]`` (a list of per-layer
    trees) in pinned host memory and everything else on ``device``: the
    first half of per-layer weight streaming (``stream_scan`` is the
    second).  Layers already pinned (``utils.loading.load_base_dit(on_host
    =True)``) are not copied again."""
    out = {k: fetch_from_host(v, device) for k, v in params.items() if k != key}
    arena = arena or HostArena()
    out[key] = [offload_to_host(layer, arena) for layer in params[key]]
    return out


_COPY_STREAMS: dict = {}  # device -> the stream stream_scan copies on


def _copy_stream(device: torch.device):
    """One copy stream per device for every ``stream_scan``: the caching
    allocator keeps a pool per stream, so a new stream per call would strand
    the blocks of the last."""
    if device not in _COPY_STREAMS:
        _COPY_STREAMS[device] = torch.cuda.Stream(device)
    return _COPY_STREAMS[device]


def stream_scan(step: Callable[[Any, Any], Any], carry: Any, layers: Sequence[Any],
                device) -> Any:
    """``carry = step(carry, layer)`` over ``layers`` (per-layer trees whose
    tensors live on the host or on ``device``), each layer fetched to
    ``device`` first.

    On a CUDA device the copies run on a stream of their own: layer l + 1
    is copied while layer l computes, the compute stream waits on one event
    per layer, and each copied tensor is tied to the compute stream
    (``record_stream``) so that the caching allocator does not hand its
    memory out again before the layer's compute is done.  Before layer l +
    1 is copied the host waits until layer l - 1's compute is done, so at
    most two layers are on the device.  On the CPU it is a plain loop."""
    device = torch.device(device)
    if device.type != "cuda":
        for layer in layers:
            carry = step(carry, fetch_from_host(layer, device))
        return carry
    compute = torch.cuda.current_stream(device)
    copier = _copy_stream(device)

    def fetch(layer):
        with torch.cuda.stream(copier):
            out = fetch_from_host(layer, device)
            copied = torch.cuda.Event()
            copied.record(copier)
        return out, copied

    nxt = fetch(layers[0]) if len(layers) else None
    done_prev = None
    for i in range(len(layers)):
        (buf, copied), nxt = nxt, None
        compute.wait_event(copied)
        for t in param_leaves(buf):
            t.record_stream(compute)
        carry = step(carry, buf)
        del buf
        done = torch.cuda.Event()
        done.record(compute)
        if i + 1 < len(layers):
            if done_prev is not None:
                done_prev.synchronize()  # layer i - 1 is done: its memory may be reused
            nxt = fetch(layers[i + 1])
        done_prev = done
    return carry


def log_memory(tag: str = "", device=None) -> str:
    """A line of the card's memory: allocated by PyTorch, and in use of the
    total (``torch.cuda.mem_get_info``); printed and returned."""
    if not torch.cuda.is_available():
        line = f"[mem] {tag}: no CUDA device"
    else:
        free, total = torch.cuda.mem_get_info(device)
        line = (f"[mem] {tag}: {torch.cuda.memory_allocated(device) / 2**30:.2f} GiB allocated, "
                f"{(total - free) / 2**30:.2f} / {total / 2**30:.2f} GiB in use")
    print(line, flush=True)
    return line
