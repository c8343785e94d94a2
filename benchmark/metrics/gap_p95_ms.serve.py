"""The 95th percentile (linear interpolation) of the window's delivery
gaps: host time between consecutive segments reaching the host."""

import numpy as np


def read(rec, ctx):
    g = rec.get("gaps_ms")
    return float(np.percentile(g, 95)) if g else None
