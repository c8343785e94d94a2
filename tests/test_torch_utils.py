"""The port's utilities held against the JAX package's: video export, the
prompt dataset and its sharding, and the loading rules (random init with a
warning when an artifact is absent, an error under ``strict``, and an error
from the file itself when an artifact is present but unreadable)."""

import os

import numpy as np
import pytest
import torch

from longlive_torch import run_inference
from longlive_torch.config import PipelineConfig, tiny_dit_config
from longlive_torch.utils import loading
from longlive_torch.utils.dataset import TextDataset, shard
from longlive_torch.utils.video_io import to_video_array, write_video
from longlive_tpu.utils import dataset as JDS
from longlive_tpu.utils import video_io as JVIO

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_to_video_array_matches_jax():
    px = np.random.default_rng(0).uniform(-1.5, 1.5, (2, 3, 3, 4, 5)).astype(np.float32)
    np.testing.assert_array_equal(to_video_array(torch.from_numpy(px)), JVIO.to_video_array(px))


def test_write_video_writes_the_named_file(tmp_path):
    video = np.random.default_rng(1).uniform(0, 1, (3, 16, 16, 3)).astype(np.float32)
    want = str(tmp_path / "sub" / "clip.mp4")
    path = write_video(want, video)
    assert path in (want, want + ".npy")  # .npy: no video writer installed
    assert os.path.getsize(path) > 0


@pytest.mark.parametrize("hosts", [1, 2, 3])
def test_text_dataset_and_shard_match_jax(hosts):
    path = os.path.join(ROOT, "example", "long_example.txt")
    tds, jds = TextDataset(path), JDS.TextDataset(path)
    assert len(tds) == len(jds) > 0
    for h in range(hosts):
        assert shard(tds, h, hosts) == JDS.shard(jds, h, hosts)


def test_loading_random_init_and_fail_fast(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    cfg = tiny_dit_config()
    pc = PipelineConfig(generator_ckpt=str(tmp_path / "absent.pt"))
    params = loading.load_dit_params(pc, cfg, torch.float32, "cpu")
    assert params["patch_embedding"]["weight"].shape[0] == cfg.dim
    _, vcfg = loading.load_vae_params(pc, torch.float32, "cpu")
    assert vcfg.dim == 96
    assert loading.load_text_encoder(pc) is None
    assert capsys.readouterr().err.count("WARNING") == 3
    with pytest.raises(FileNotFoundError):
        loading.load_dit_params(pc, cfg, torch.float32, "cpu", strict=True)
    with pytest.raises(FileNotFoundError):
        loading.load_vae_params(pc, torch.float32, "cpu", strict=True)
    with pytest.raises(FileNotFoundError):
        loading.load_text_encoder(pc, strict=True)


def test_loading_raises_for_present_artifacts(tmp_path, monkeypatch):
    """Files that exist are read, never replaced by random weights: an
    empty (truncated) checkpoint raises from ``torch.load``."""
    monkeypatch.chdir(tmp_path)
    ckpt = tmp_path / "gen.pt"
    ckpt.write_bytes(b"")
    pc = PipelineConfig(generator_ckpt=str(ckpt))
    base = tmp_path / "wan_models" / pc.model_name
    (base / "google" / "umt5-xxl").mkdir(parents=True)
    (base / "Wan2.1_VAE.pth").write_bytes(b"")
    (base / "models_t5_umt5-xxl-enc-bf16.pth").write_bytes(b"")
    with pytest.raises(EOFError):
        loading.load_dit_params(pc, tiny_dit_config(), torch.float32, "cpu")
    with pytest.raises(EOFError):
        loading.load_vae_params(pc, torch.float32, "cpu")
    with pytest.raises(EOFError):
        loading.load_text_encoder(pc, torch.float32, "cpu")


@pytest.mark.parametrize("flags", [["--sp", "2"], ["--decode_device", "0", "--segment_frames", "4"]])
def test_cli_rejects_unported_flags(flags):
    """``--sp 2`` in a run of one rank (no torchrun) exits naming torchrun;
    a ``--decode_device`` segment that is no multiple of the config's
    3-frame block is refused; both before any parameter is built."""
    cfg = os.path.join(ROOT, "configs", "longlive_inference.yaml")
    error, match = ((SystemExit, "torchrun") if flags[0] == "--sp"
                    else (ValueError, "frame block 3"))
    with pytest.raises(error, match=match):
        run_inference.main(["--config_path", cfg, "--device", "cpu"] + flags)
