"""VBench-style video quality metrics.

The reference cites VBench scores but ships no harness; this is one: the
standard VBench temporal and frame-wise dimensions, computed with
self-contained proxies where VBench scores with external checkpoints (RAFT,
DINO, MUSIQ, AMT); each docstring names its proxy.  The flow and pixel math
runs on the host in numpy (and OpenCV where it is installed, with a fallback
where it is not).

All metrics take ``video`` as a float array [T, H, W, 3] in [0, 1] and return
a score in [0, 1] (higher = better, VBench's convention).  The CLIP-based
dimensions (subject / background consistency, the CLIP text-video score)
use the port's CLIP ViT-H tower (``models/clip.py``), on the device that
holds its parameters, when they are given, and downsampled pixel features
otherwise.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


def _as_video(video) -> np.ndarray:
    v = np.asarray(video, np.float32)
    assert v.ndim == 4 and v.shape[-1] == 3, f"want [T,H,W,3], got {v.shape}"
    return np.clip(v, 0.0, 1.0)


def _luma_u8(v: np.ndarray, max_side: int = 256) -> np.ndarray:
    """[T, h, w] uint8 luma, downscaled so max(h, w) <= max_side (flow cost
    is resolution-quadratic; VBench's RAFT also runs at reduced size)."""
    g = (v * 255.0).mean(axis=-1)
    t, h, w = g.shape
    s = max(h, w) / float(max_side)
    if s > 1.0:
        hs, ws = max(int(round(h / s)), 8), max(int(round(w / s)), 8)
        try:
            import cv2

            g = np.stack([cv2.resize(f, (ws, hs), interpolation=cv2.INTER_AREA)
                          for f in g])
        except ImportError:
            sh, sw = h // hs, w // ws
            g = g[:, : hs * sh, : ws * sw].reshape(t, hs, sh, ws, sw).mean((2, 4))
    return g.astype(np.uint8)


def _flows(v: np.ndarray) -> Optional[np.ndarray]:
    """[T-1, h, w, 2] Farneback optical flow between consecutive frames
    (classical, weight-free — the stand-in for VBench's RAFT), or None when
    cv2 is unavailable."""
    try:
        import cv2
    except ImportError:
        return None
    g = _luma_u8(v)
    return np.stack([
        cv2.calcOpticalFlowFarneback(g[i], g[i + 1], None, 0.5, 3, 15, 3, 5,
                                     1.2, 0)
        for i in range(len(g) - 1)
    ])


def temporal_flicker(video, flows=None) -> float:
    """VBench 'temporal flickering': 1 - mean absolute difference between
    consecutive frames over STATIC regions (pixels whose optical-flow
    magnitude is below 1px at analysis scale, mirroring VBench's
    static-region masking; full frame when cv2/flow is unavailable or
    nothing is static).  Static video -> 1.0."""
    v = _as_video(video)
    if len(v) < 2:
        return 1.0
    diff = np.abs(np.diff(v, axis=0)).mean(axis=-1)  # [T-1, H, W]
    if flows is None:
        flows = _flows(v)
    if flows is not None:
        mag = np.linalg.norm(flows, axis=-1)  # [T-1, h, w]
        try:
            import cv2

            mag = np.stack([
                cv2.resize(m, (diff.shape[2], diff.shape[1]),
                           interpolation=cv2.INTER_LINEAR) for m in mag])
        except ImportError:
            pass
        if mag.shape == diff.shape:
            static = mag < 1.0
            if static.any():
                return float(1.0 - diff[static].mean())
    return float(1.0 - diff.mean())


def motion_smoothness(video) -> float:
    """VBench 'motion smoothness': drop each middle frame, reconstruct it by
    flow interpolation from its neighbours (flow-warped average — the
    weight-free stand-in for VBench's AMT interpolator), and score
    1 - normalized reconstruction error.  Constant-velocity motion
    reconstructs exactly -> 1.0.  Falls back to the second-temporal-
    difference proxy without cv2."""
    v = _as_video(video)
    if len(v) < 3:
        return 1.0
    try:
        import cv2
    except ImportError:
        accel = np.abs(v[2:] - 2.0 * v[1:-1] + v[:-2]).mean()
        return float(1.0 - min(accel * 2.0, 1.0))
    g = _luma_u8(v).astype(np.float32)
    t, h, w = g.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    errs = []
    for i in range(1, t - 1, 2):
        # half-flow warps toward the dropped frame from both neighbours
        fwd = cv2.calcOpticalFlowFarneback(g[i - 1], g[i + 1], None, 0.5, 3,
                                           15, 3, 5, 1.2, 0)
        pa = cv2.remap(g[i - 1], xx + 0.5 * fwd[..., 0], yy + 0.5 * fwd[..., 1],
                       cv2.INTER_LINEAR)
        pb = cv2.remap(g[i + 1], xx - 0.5 * fwd[..., 0], yy - 0.5 * fwd[..., 1],
                       cv2.INTER_LINEAR)
        errs.append(np.abs(0.5 * (pa + pb) - g[i]).mean())
    if not errs:
        return 1.0
    return float(np.clip(1.0 - np.mean(errs) / 255.0, 0.0, 1.0))


def dynamic_degree(video, threshold: Optional[float] = None,
                   flows=None) -> float:
    """VBench 'dynamic degree': fraction of frame pairs that are dynamic.
    With cv2, a pair is dynamic when the mean of its top-5% optical-flow
    magnitudes exceeds a resolution-scaled threshold (VBench's RAFT
    criterion with Farneback flow); without cv2, falls back to mean
    absolute frame difference > 0.01.  Higher = more motion; not a quality
    score per se."""
    v = _as_video(video)
    if len(v) < 2:
        return 0.0
    if flows is None:
        flows = _flows(v)
    if flows is None:
        thr = 0.01 if threshold is None else threshold
        mae = np.abs(np.diff(v, axis=0)).mean(axis=(1, 2, 3))
        return float((mae > thr).mean())
    h, w = flows.shape[1:3]
    # VBench scales its RAFT threshold with resolution (factor relative to
    # 256); 6.0 at 256 is its default
    thr = (6.0 * min(h, w) / 256.0) if threshold is None else threshold
    mag = np.linalg.norm(flows, axis=-1).reshape(len(flows), -1)
    k = max(int(mag.shape[1] * 0.05), 1)
    top = np.sort(mag, axis=1)[:, -k:].mean(axis=1)
    return float((top > thr).mean())


def imaging_quality(video) -> float:
    """VBench 'imaging quality' proxy: normalized Laplacian variance
    (sharpness; VBench proper uses MUSIQ).  Blurred/flat videos score low."""
    v = _as_video(video).mean(axis=-1)  # luma-ish
    lap = (-4.0 * v[:, 1:-1, 1:-1] + v[:, :-2, 1:-1] + v[:, 2:, 1:-1]
           + v[:, 1:-1, :-2] + v[:, 1:-1, 2:])
    sharp = float(lap.var())
    return float(1.0 - math.exp(-sharp * 300.0))


def _frame_features(video: np.ndarray, clip_params=None, clip_cfg=None,
                    max_frames: int = 16) -> np.ndarray:
    """[T, D] L2-normalized per-frame features: CLIP ViT-H pooled features
    when params are given, else 16x16 downsampled pixels."""
    v = _as_video(video)
    if len(v) > max_frames:
        idx = np.linspace(0, len(v) - 1, max_frames).round().astype(int)
        v = v[idx]
    if clip_params is not None:
        import torch

        from ..models import clip as C

        device = clip_params["patch_embedding"]["weight"].device
        imgs = torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2))).to(device)
        with torch.no_grad():
            tokens = C.encode_image(clip_params, clip_cfg, imgs * 2.0 - 1.0)  # [-1, 1]
        feats = tokens[:, 0].float().cpu().numpy()  # CLS token
    else:
        t, h, w, _ = v.shape
        hs, ws = max(h // 16, 1), max(w // 16, 1)
        feats = v[:, : hs * 16 : hs, : ws * 16 : ws].reshape(t, -1)
        feats = feats - feats.mean(axis=1, keepdims=True)
    norm = np.linalg.norm(feats, axis=1, keepdims=True) + 1e-8
    return feats / norm


def subject_consistency(video, clip_params=None, clip_cfg=None) -> float:
    """VBench 'subject consistency': mean of (cos(first, t) + cos(t-1, t))/2
    over frames (DINO features in VBench; CLIP/pixel features here)."""
    f = _frame_features(video, clip_params, clip_cfg)
    if len(f) < 2:
        return 1.0
    sim_first = (f[1:] @ f[0]).clip(0, 1)
    sim_prev = np.einsum("td,td->t", f[1:], f[:-1]).clip(0, 1)
    return float(((sim_first + sim_prev) / 2.0).mean())


def background_consistency(video, clip_params=None, clip_cfg=None) -> float:
    """VBench 'background consistency': mean cosine similarity of each frame
    feature to the video's mean feature (CLIP features in VBench)."""
    f = _frame_features(video, clip_params, clip_cfg)
    mean = f.mean(axis=0)
    mean /= np.linalg.norm(mean) + 1e-8
    return float((f @ mean).clip(0, 1).mean())


def clip_score(video, text_features, clip_params, clip_cfg) -> float:
    """CLIP text-video alignment (VBench 'overall consistency' family):
    mean cosine similarity between L2-normalized CLIP text features and
    per-frame image features.  Requires the in-repo CLIP tower params and
    precomputed text features (models.clip.clip_text_forward)."""
    f = _frame_features(video, clip_params, clip_cfg)
    tf = np.asarray(text_features, np.float32).reshape(-1)
    tf /= np.linalg.norm(tf) + 1e-8
    return float((f @ tf).clip(-1, 1).mean())


def evaluate_video(video, clip_params=None, clip_cfg=None,
                   text_features=None) -> dict:
    """All dimensions for one video.  Returns {metric: score}."""
    v = _as_video(video)
    # the consecutive-frame Farneback flows dominate eval cost; compute
    # once and share (motion_smoothness solves DIFFERENT 2-frame-gap
    # flows, so it keeps its own)
    flows = _flows(v) if len(v) >= 2 else None
    out = {
        "temporal_flicker": temporal_flicker(v, flows=flows),
        "motion_smoothness": motion_smoothness(v),
        "dynamic_degree": dynamic_degree(v, flows=flows),
        "imaging_quality": imaging_quality(v),
        "subject_consistency": subject_consistency(v, clip_params, clip_cfg),
        "background_consistency": background_consistency(v, clip_params, clip_cfg),
    }
    if text_features is not None and clip_params is not None:
        out["clip_score"] = clip_score(video, text_features, clip_params, clip_cfg)
    return out
