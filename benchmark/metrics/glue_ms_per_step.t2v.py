"""Device time of the traced window's kernels that are neither K1 nor GEMMs,
per guided step."""


def read(rec, ctx):
    t = rec.get("trace")
    if not t or t["busy_s"] <= 0 or not rec.get("traced_steps"):
        return None
    glue = sum(v for g, v in t["groups"].items() if g not in ("K1", "gemm"))
    return glue * 1e3 / rec["traced_steps"]
