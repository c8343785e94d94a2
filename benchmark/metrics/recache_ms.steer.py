"""CUDA-event time of each switch's prepare_condition + reactive_switch,
summed over the window and divided by the switches."""


def read(rec, ctx):
    s = rec["spans"].get("recache_ms")
    return sum(s) / len(s) if s else None
