"""Parameters carried across from the JAX package's param trees.

The JAX trees stack the DiT's per-layer parameters on a leading [L] axis
and store linears as ``{"kernel": [in, out], "bias"}``.  These converters
take such a tree with numpy leaves (``jax.tree.map(np.asarray, tree)``) and
return the port's layout: a list of per-layer dicts and
``{"weight": [out, in], "bias"}``.  Int8 linears of a tree quantized by the
JAX package's ``quantize_dit_params`` (``{"w_int8": [in, out],
"w_scale": [out], "bias"}``, a fused ``qkv`` included) become
``{"w_int8": [out, in] int8, in contiguous, "w_scale": [out] float32,
"bias"}``, the operand layout of the port's int8 kernel.  The halfsplit
q/k permutation is already applied in a JAX tree
(``canonicalize_rope_layout`` ran when it was built) and is not applied
again.  The VAE's conv weights are in the torch layout in both packages
(encoder and decoder); the umT5 encoder's stacked layers become a list.
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
        if "w_int8" in node:
            out = {"w_int8": _tensor(np.ascontiguousarray(np.asarray(node["w_int8"]).T), None,
                                     device),
                   "w_scale": _tensor(node["w_scale"], torch.float32, device)}
            if node.get("bias") is not None:
                out["bias"] = _tensor(node["bias"], dtype, device)
            return out
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
    """JAX VAE params (numpy leaves) -> the port's VAE parameters: the
    encoder and decoder with their 1x1x1 ``conv1`` / ``conv2``.  Conv
    weights are already in the torch [O, I, k...] layout.  The fused convs
    get their packed weights (``vae.pack_fused_weights``)."""
    out = {k: _convert(tree[k], dtype, device) for k in ("encoder", "decoder", "conv1", "conv2")}
    pack_fused_weights(out["encoder"])
    pack_fused_weights(out["decoder"])
    for k in ("mean", "std"):
        out[k] = _tensor(tree[k], torch.float32, device)
    return out


def t5_params_from_jax(tree: dict, dtype=None, device="cpu") -> dict:
    """JAX umT5 params (numpy leaves; the layers stacked on [L], linears
    [in, out]) -> the port's (``models.t5``: a list of per-layer dicts,
    linear weights [out, in])."""
    blocks = tree["blocks"]
    num_layers = np.asarray(blocks["norm1"]).shape[0]

    def layer(i):
        def at(a, transpose=False):
            a = np.asarray(a)[i]
            return _tensor(a.T if transpose else a, dtype, device)

        return {"norm1": at(blocks["norm1"]),
                "attn": {k: at(v, True) for k, v in blocks["attn"].items()},
                "pos_emb": at(blocks["pos_emb"]),
                "norm2": at(blocks["norm2"]),
                "ffn": {k: at(v, True) for k, v in blocks["ffn"].items()}}

    return {"token_embedding": _tensor(tree["token_embedding"], dtype, device),
            "blocks": [layer(i) for i in range(num_layers)],
            "norm": _tensor(tree["norm"], dtype, device)}
