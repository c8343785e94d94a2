"""The window's milliseconds over the guided sampler steps it completed."""


def read(rec, ctx):
    return rec["window_s"] * 1e3 / rec["steps"] if rec.get("steps") else None
