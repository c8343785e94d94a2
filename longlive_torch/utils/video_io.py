"""Video export (mp4 at 16 fps)."""

from __future__ import annotations

import os

import numpy as np


def write_video(path: str, video: np.ndarray, fps: int = 16) -> str:
    """video: [T, H, W, 3] float in [0, 1] or uint8.  Writes an mp4 with
    OpenCV, else imageio; without either it saves ``path + ".npy"``.
    Returns the path written."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if video.dtype != np.uint8:
        video = (np.clip(video, 0.0, 1.0) * 255.0).astype(np.uint8)
    try:
        import cv2

        h, w = video.shape[1:3]
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if not writer.isOpened():
            raise RuntimeError("cv2.VideoWriter failed to open")
        for frame in video:
            writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        writer.release()
        return path
    except Exception:
        pass
    try:
        import imageio

        imageio.mimwrite(path, list(video), fps=fps)
        return path
    except Exception:
        np.save(path + ".npy", video)
        return path + ".npy"


def to_video_array(pixels) -> np.ndarray:
    """[B, T, 3, H, W] in [-1, 1] (tensor or array) -> [T, H, W, 3] in
    [0, 1] for batch 0."""
    if hasattr(pixels, "detach"):
        pixels = pixels.detach().float().cpu().numpy()
    v = np.asarray(pixels)[0]
    v = v * 0.5 + 0.5
    return np.clip(v.transpose(0, 2, 3, 1), 0.0, 1.0)
