"""VBench-style evaluation CLI.

Usage:
  python -m longlive_torch.run_eval video1.mp4 [video2.npy ...] [--json out.json]
      [--clip_checkpoint models_clip.pth] [--device cuda]

Scores each video on the VBench temporal and frame-wise dimensions
(``eval/metrics.py``) and prints one JSON object per video and an
aggregate.  With ``--clip_checkpoint`` (the CLIP ViT-H weights Wan's i2v
ships) the CLIP-feature dimensions run the port's CLIP tower on
``--device`` (default ``cuda``; ``cpu`` runs it in float32).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .eval import evaluate_video


def load_video(path: str) -> np.ndarray:
    """mp4/npy -> [T, H, W, 3] float in [0, 1]."""
    if path.endswith(".npy"):
        v = np.load(path)
        if v.ndim == 4 and v.shape[1] == 3:  # [T, 3, H, W]
            v = v.transpose(0, 2, 3, 1)
        v = v.astype(np.float32)
        # integer-valued [0, 255] arrays (uint8 saves, or float dumps of
        # them) must be rescaled, not clipped to ~all-ones
        if v.max() > 1.5:
            v = v / 255.0
        return np.clip(v, 0.0, 1.0)
    try:
        import cv2

        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        cap.release()
        if frames:
            return np.stack(frames).astype(np.float32) / 255.0
    except ImportError:
        pass
    import imageio

    frames = [np.asarray(f, np.float32) / 255.0 for f in imageio.mimread(
        path, memtest=False)]
    return np.stack(frames)


def main(argv=None):
    """Returns {"videos": {path: scores}, "aggregate": {metric: mean}}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("videos", nargs="+")
    ap.add_argument("--json", default=None, help="write results to this file")
    ap.add_argument("--clip_checkpoint", default=None,
                    help="optional CLIP ViT-H torch checkpoint for the "
                         "CLIP-feature dimensions")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the CLIP tower (default cuda)")
    args = ap.parse_args(argv)

    clip_params = clip_cfg = None
    if args.clip_checkpoint:
        import torch

        from .models import clip as C
        from .utils.device import resolve_device
        from .utils.loading import _torch_load

        try:
            device = resolve_device(args.device)
        except RuntimeError as e:
            sys.exit(f"error: {e}")
        clip_cfg = C.CLIPVisionConfig()
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
        clip_params = C.clip_vision_params_from_torch(
            _torch_load(args.clip_checkpoint), clip_cfg, dtype, device)

    results = {}
    for path in args.videos:
        video = load_video(path)
        scores = evaluate_video(video, clip_params, clip_cfg)
        scores["num_frames"] = int(len(video))
        results[path] = scores
        print(json.dumps({"video": path, **scores}))

    keys = [k for k in next(iter(results.values())) if k != "num_frames"]
    agg = {k: float(np.mean([r[k] for r in results.values()])) for k in keys}
    print(json.dumps({"aggregate": agg, "videos": len(results)}))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"videos": results, "aggregate": agg}, f, indent=2)
    return {"videos": results, "aggregate": agg}


if __name__ == "__main__":
    main()
