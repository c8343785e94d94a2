"""CUDA-event time of each generate_latents_scanned call, summed over the
window, per latent frame generated."""


def read(rec, ctx):
    s = rec["spans"].get("gen_ms")
    return sum(s) / rec["latent_frames"] if s else None
