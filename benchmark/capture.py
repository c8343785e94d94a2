"""The program's layers as the judgement reads them.

``LayerTap`` wraps one of the program's layer functions while installed:
each call it selects records the layer's input and the outputs of its
parts, taken where the program's ``models.nn.linear`` returns them (every
layer calls it through its module): the self-attention and the
cross-attention after their output projections, and the FFN before its
gate.  The reference (``reference.dit.layer_parts``) recomputes each part
from the program's input to it.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

# part -> (the layer's parameter group, the linear whose output it is)
PARTS = {"y": ("self_attn", "o"), "c": ("cross_attn", "o"), "f": ("ffn", "fc2")}


class LayerTap:
    """``locate(args, kwargs, i)`` -> (the layer's input, its parameters,
    the key the call is recorded under or None), for the i-th call since
    installing.  ``calls``: (key, input, {part: output}) per recorded call."""

    def __init__(self, module, name: str,
                 locate: Callable[[tuple, dict, int], Tuple[object, dict, Optional[object]]]):
        self.module, self.name, self.locate = module, name, locate
        self.calls: List[tuple] = []
        self.orig = None

    def install(self) -> None:
        from longlive_torch.models import nn

        fn0, lin0 = getattr(self.module, self.name), nn.linear
        self.orig = (fn0, lin0)
        watch, got, seen = {}, {}, [0]

        def linear(x, p):
            y = lin0(x, p)
            part = watch.get(id(p))
            if part is not None:
                got[part] = y.clone()
            return y

        def layer(*a, **kw):
            x, layer_p, key = self.locate(a, kw, seen[0])
            seen[0] += 1
            if key is None:
                return fn0(*a, **kw)
            watch.update({id(layer_p[g][n]): part for part, (g, n) in PARTS.items()
                          if n in layer_p.get(g, {})})
            x_in = x.clone()
            try:
                out = fn0(*a, **kw)
            finally:
                watch.clear()
            self.calls.append((key, x_in, dict(got)))
            got.clear()
            return out

        setattr(self.module, self.name, layer)
        nn.linear = linear

    def remove(self) -> None:
        from longlive_torch.models import nn

        if self.orig is not None:
            setattr(self.module, self.name, self.orig[0])
            nn.linear = self.orig[1]
            self.orig = None

