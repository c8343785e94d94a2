"""Parameters carried across from the JAX package's param trees.

The JAX trees stack the DiT's per-layer parameters on a leading [L] axis
and store linears as ``{"kernel": [in, out], "bias"}``.  These converters
take such a tree with numpy leaves (``jax.tree.map(np.asarray, tree)``) and
return the port's layout: a list of per-layer dicts and
``{"weight": [out, in], "bias"}``.  The halfsplit q/k permutation is already
applied in a JAX tree (``canonicalize_rope_layout`` ran when it was built)
and is not applied again.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..models.vae import pack_fused_weights


def _tensor(a, dtype, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))  # a writable copy
    if t.is_floating_point() and dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def _convert(node: Any, dtype, device) -> Any:
    if node is None:
        return None
    if isinstance(node, dict):
        if "kernel" in node:
            out = {"weight": _tensor(np.asarray(node["kernel"]).T, dtype, device)}
            if node.get("bias") is not None:
                out["bias"] = _tensor(node["bias"], dtype, device)
            return out
        return {k: _convert(v, dtype, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v, dtype, device) for v in node]
    return _tensor(node, dtype, device)


def _unstack(node: Any, i: int) -> Any:
    if isinstance(node, dict):
        return {k: _unstack(v, i) for k, v in node.items()}
    return None if node is None else np.asarray(node)[i]


def dit_params_from_jax(tree: dict, dtype=None, device="cpu") -> dict:
    """JAX DiT params (numpy leaves) -> the port's DiT parameter dict."""
    blocks = tree["blocks"]
    num_layers = np.asarray(blocks["modulation"]).shape[0]
    out = {k: _convert(v, dtype, device) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [_convert(_unstack(blocks, i), dtype, device) for i in range(num_layers)]
    return out


def vae_params_from_jax(tree: dict, dtype=None, device="cpu") -> dict:
    """JAX VAE params (numpy leaves) -> the port's decoder-side parameters.
    Conv weights are already in the torch [O, I, k...] layout; the encoder
    subtree is not carried (the decoder slice does not use it).  The fused
    convs get their packed weights (``vae.pack_fused_weights``)."""
    out = {k: _convert(tree[k], dtype, device) for k in ("decoder", "conv2")}
    pack_fused_weights(out["decoder"])
    for k in ("mean", "std"):
        out[k] = _tensor(tree[k], torch.float32, device)
    return out
