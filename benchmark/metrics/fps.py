"""Pixel frames shipped to the host in the window over the window's seconds."""


def read(rec, ctx):
    return rec["pixel_frames"] / rec["window_s"] if rec.get("pixel_frames") else None
