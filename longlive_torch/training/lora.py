"""LoRA adapters for training.

The reference wraps every linear inside the transformer blocks with PEFT
LoRA (rank and alpha 256 in ``configs/longlive_train_long.yaml``, on the
generator and the critic).  Here the adapters are a tree of their own, one
dict per layer like ``params["blocks"][i]``:

    lora[i][group][name] = {"lora_a": [r, d_in], "lora_b": [d_out, r]}

in PEFT's orientation (``lora_A.weight``, ``lora_B.weight``), so the PEFT
converters (``utils.checkpoint.lora_to_peft_sd``) only rename keys.
``attach_lora`` embeds them into a parameter tree without copying the
bases, and ``models.nn.linear`` then applies W = W0 + (alpha / rank) B A
one layer at a time (the PEFT execution model: no merged copy of the model
ever exists), so autograd gathers the adapters' gradients while the bases
stay frozen.  PEFT init: A kaiming-uniform with bound 1 / sqrt(d_in), B = 0
(the delta starts at zero).  ``merge_lora`` materialises the merged
weights, for one-offs on the host (the EMA preview, exports).
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from ..models.nn import lora_weight

LORA_TARGET_GROUPS = ("self_attn", "cross_attn", "ffn")
_LINEAR_NAMES = ("q", "k", "v", "o", "fc1", "fc2")


def init_lora(params: dict, rank: int = 256, dtype=torch.bfloat16,
              generator: Optional[torch.Generator] = None, device=None) -> List[dict]:
    """Adapters for every targeted linear of ``params["blocks"]``: A uniform
    in [-1/sqrt(d_in), 1/sqrt(d_in)] from ``generator`` (a CPU generator;
    layer by layer, group and linear in the tree's order), B zeros; in
    ``dtype`` on ``device`` (default: the base weights' device)."""
    out = []
    for blk in params["blocks"]:
        layer = {}
        for group in LORA_TARGET_GROUPS:
            gp = blk.get(group)
            if gp is None:
                continue
            lg = {}
            for name, p in gp.items():
                if name not in _LINEAR_NAMES or "weight" not in p:
                    continue
                d_out, d_in = p["weight"].shape
                bound = 1.0 / math.sqrt(d_in)
                a = torch.empty((rank, d_in)).uniform_(-bound, bound, generator=generator)
                dev = p["weight"].device if device is None else device
                lg[name] = {"lora_a": a.to(dev, dtype),
                            "lora_b": torch.zeros((d_out, rank), dtype=dtype, device=dev)}
            layer[group] = lg
        out.append(layer)
    return out


def attach_lora(params: dict, lora: List[dict], scale: float = 1.0) -> dict:
    """``params`` with each targeted linear gaining ``lora_a``, ``lora_b``
    (the adapter tensors themselves, not copies) and ``lora_s`` (alpha /
    rank): ``models.nn.linear`` applies the delta.  The bases are shared,
    not copied."""
    blocks = []
    for blk, lyr in zip(params["blocks"], lora):
        blk = dict(blk)
        for group, lg in lyr.items():
            gp = dict(blk[group])
            for name, ab in lg.items():
                gp[name] = {**gp[name], **ab, "lora_s": float(scale)}
            blk[group] = gp
        blocks.append(blk)
    return {**params, "blocks": blocks}


def merge_lora(params: dict, lora: List[dict], scale: float = 1.0) -> dict:
    """``params`` with every targeted weight replaced by W0 + scale B A
    (``models.nn.lora_weight``, the LoRA linear's own arithmetic);
    everything else passes through untouched."""
    blocks = []
    for blk, lyr in zip(params["blocks"], lora):
        blk = dict(blk)
        for group, lg in lyr.items():
            gp = dict(blk[group])
            for name, ab in lg.items():
                base = gp[name]
                gp[name] = {**base, "weight": lora_weight(base["weight"], ab["lora_a"],
                                                          ab["lora_b"], scale)}
            blk[group] = gp
        blocks.append(blk)
    return {**params, "blocks": blocks}


def lora_params_count(lora: List[dict]) -> int:
    return sum(t.numel() for lyr in lora for lg in lyr.values() for ab in lg.values()
               for t in ab.values())


def lora_dtype(name: str) -> torch.dtype:
    """The adapters' dtype from its config name (``bfloat16``, ``float32``)."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"lora_dtype {name!r} is no floating torch dtype")
    return dt
