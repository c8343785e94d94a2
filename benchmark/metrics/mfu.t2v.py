"""The model operations of the whole window (DiT forwards: linears,
attention over valid keys and the cross-attention; the VAE's convs and
attention; benchmark.flops) over the window's seconds times 989 TFLOP/s
times the cell's chips."""


def read(rec, ctx):
    ops = rec.get("work", {}).get("model", 0.0)
    if ops <= 0 or ctx.device.type != "cuda":
        return None
    return 100.0 * ops / (rec["window_s"] * 989e12 * ctx.world)
