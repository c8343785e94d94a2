"""K2's share of its roofline in the traced window: the least time its
convs need (per conv the larger of operations / 989 TFLOP/s and bytes /
3.35 TB/s; benchmark.flops) over the device time of its kernels (its input
pass included)."""


def read(rec, ctx):
    t = rec.get("trace")
    k2 = t["groups"].get("K2", 0.0) if t else 0.0
    least = rec.get("traced_work", {}).get("k2_least_s", 0.0)
    return 100.0 * least / k2 if k2 > 0 and least > 0 else None
