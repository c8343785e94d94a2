"""K1's share of its roofline in the traced window: the least time its
calls need (per call the larger of operations / 989 TFLOP/s and bytes /
3.35 TB/s, from the cell's shapes, valid keys only; benchmark.flops) over
the device time of its kernels."""


def read(rec, ctx):
    t = rec.get("trace")
    k1 = t["groups"].get("K1", 0.0) if t else 0.0
    least = rec.get("traced_work", {}).get("k1_least_s", 0.0)
    return 100.0 * least / k1 if k1 > 0 and least > 0 else None
