"""CUDA-event time of each vae_decode_scan call, summed over the window,
per latent frame decoded."""


def read(rec, ctx):
    s = rec["spans"].get("vae_ms")
    return sum(s) / rec["latent_frames"] if s else None
