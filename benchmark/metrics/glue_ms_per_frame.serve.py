"""Device time of the traced window's kernels that are neither K1, K2 nor
GEMMs (elementwise, copies, reductions, cuDNN's narrow convs), per latent
frame served in that window."""


def read(rec, ctx):
    t = rec.get("trace")
    if not t or t["busy_s"] <= 0 or not rec.get("traced_latent_frames"):
        return None
    glue = sum(v for g, v in t["groups"].items() if g not in ("K1", "K2", "gemm"))
    return glue * 1e3 / rec["traced_latent_frames"]
