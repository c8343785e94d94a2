"""The port's eval harness (``eval/metrics.py``, ``run_eval``) held against
the JAX package's on seeded videos, on the CPU.  The flow and pixel metrics
are the same numpy / OpenCV arithmetic in both packages, so they must agree
exactly, with OpenCV and without it (``sys.modules["cv2"] = None`` makes
every ``import cv2`` fail, for both packages at once).  The CLIP branch runs
the port's CLIP tower on the JAX parameters, carried across: within 1e-5."""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from longlive_torch import eval as TE
from longlive_torch import run_eval as TR
from longlive_torch.models import clip as TC
from longlive_torch.utils.params import clip_vision_params_from_jax
from longlive_torch.utils.video_io import write_video
from longlive_tpu import eval as JE
from longlive_tpu import run_eval as JR
from longlive_tpu.models import clip as JC

CLIP_TOL = 1e-5

METRICS = ["temporal_flicker", "motion_smoothness", "dynamic_degree", "imaging_quality",
           "subject_consistency", "background_consistency"]


def _static(t=8, h=32, w=32):
    frame = np.random.RandomState(0).rand(1, h, w, 3).astype(np.float32)
    return np.repeat(frame, t, axis=0)


def _noise(t=8, h=32, w=32):
    return np.random.RandomState(1).rand(t, h, w, 3).astype(np.float32)


def _pan(t=8, h=32, w=32, step=2):
    """Constant-velocity pan over a smooth random texture."""
    coarse = np.random.RandomState(4).rand(h // 8, (w + step * t) // 8 + 1, 3)
    tex = np.kron(coarse, np.ones((8, 8, 1))).astype(np.float32)
    return np.stack([tex[:, step * i:step * i + w] for i in range(t)])


def _blurred(t=8, h=32, w=32):
    """The noise video under a 5 x 5 box blur: soft, still flickering."""
    v = np.pad(_noise(t, h, w), ((0, 0), (2, 2), (2, 2), (0, 0)), mode="edge")
    return np.mean([v[:, i:i + h, j:j + w] for i in range(5) for j in range(5)],
                   axis=0).astype(np.float32)


VIDEOS = {"static": _static, "noise": _noise, "pan": _pan, "blurred": _blurred,
          # wider than the flows' 256-pixel analysis size: the luma downscale
          "wide pan": lambda: _pan(t=6, h=40, w=320, step=6)}


@pytest.mark.parametrize("cv2", ["cv2", "no cv2"])
@pytest.mark.parametrize("name", sorted(VIDEOS))
def test_metrics_match_jax(name, cv2, monkeypatch):
    if cv2 == "no cv2":
        monkeypatch.setitem(sys.modules, "cv2", None)
    v = VIDEOS[name]()
    for metric in METRICS:
        assert getattr(TE, metric)(v) == getattr(JE, metric)(v), metric
    got, want = TE.evaluate_video(v), JE.evaluate_video(v)
    assert got == want
    assert all(0.0 <= x <= 1.0 for x in got.values())


def test_metrics_order_the_videos():
    """The JAX package's sanity ordering holds for the port."""
    assert TE.temporal_flicker(_static()) == 1.0 and TE.dynamic_degree(_static()) == 0.0
    assert TE.temporal_flicker(_noise()) < TE.temporal_flicker(_static())
    assert TE.motion_smoothness(_pan()) > TE.motion_smoothness(_noise())
    assert TE.imaging_quality(_noise()) > TE.imaging_quality(_blurred())


def test_clip_branch_matches_jax():
    jcfg = JC.tiny_clip_vision_config()
    jparams = JC.init_clip_vision_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tcfg = TC.CLIPVisionConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    tparams = clip_vision_params_from_jax(jax.tree.map(np.asarray, jparams))
    # 20 frames of another size than the tower's: 16 sampled, then resized
    v = np.random.RandomState(2).rand(20, 24, 40, 3).astype(np.float32)
    text = np.random.RandomState(3).rand(jcfg.dim).astype(np.float32)
    for fn in (TE.subject_consistency, TE.background_consistency):
        name = fn.__name__
        assert abs(fn(v, tparams, tcfg) - getattr(JE, name)(v, jparams, jcfg)) <= CLIP_TOL, name
    got = TE.clip_score(v, text, tparams, tcfg)
    assert abs(got - JE.clip_score(v, text, jparams, jcfg)) <= CLIP_TOL
    assert -1.0 <= got <= 1.0
    got = TE.evaluate_video(v, tparams, tcfg, text_features=text)
    want = JE.evaluate_video(v, jparams, jcfg, text_features=text)
    assert got.keys() == want.keys() and "clip_score" in got
    for k in got:
        assert abs(got[k] - want[k]) <= CLIP_TOL, k


@pytest.mark.parametrize("ext", ["npy", "mp4"])
def test_run_eval_matches_jax(ext, tmp_path, monkeypatch):
    paths = []
    for i, v in enumerate((_pan(), _noise())):
        if ext == "npy":
            paths.append(str(tmp_path / f"v{i}.npy"))
            np.save(paths[-1], (v * 255).astype(np.uint8))
        else:
            paths.append(write_video(str(tmp_path / f"v{i}.mp4"), v))
            assert paths[-1].endswith(".mp4")
    monkeypatch.setattr(sys, "argv", ["run_eval", *paths, "--json", str(tmp_path / "jax.json")])
    JR.main()
    out = TR.main([*paths, "--json", str(tmp_path / "torch.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "torch.json").read_text()) == want
    assert out == want and want["videos"][paths[0]]["num_frames"] == 8
    np.testing.assert_array_equal(TR.load_video(paths[1]), JR.load_video(paths[1]))
