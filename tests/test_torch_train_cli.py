"""The port's training CLI and its utilities: ``run_train`` with
``tiny_debug: true`` on the CPU for 2 steps (metrics JSONL, checkpoints,
auto-resume), streaming LoRA training for 3 steps with its resume, the
score models' random init, the single-card levers (and the JAX package's
refusals of their combinations), the refusals of what is not ported, the
checkpointable loader against the JAX package's, and the train-state
files."""

import json
import os

import pytest
import torch
import yaml

from longlive_torch import run_train
from longlive_torch.config import tiny_dit_config
from longlive_torch.models import dit as D
from longlive_torch.training.trainer import param_leaves
from longlive_torch.utils import dataset as TDS
from longlive_torch.utils import train_state
from longlive_tpu.utils import dataset as JDS

TINY = {
    "tiny_debug": True, "distribution_loss": "dmd", "num_frame_per_block": 1,
    "num_training_frames": 4, "min_num_training_frames": 4, "slice_last_frames": 4,
    "denoising_step_list": [1000, 750, 500, 250], "warp_denoising_step": True,
    "dfake_gen_update_ratio": 2, "log_iters": 1, "max_checkpoints": 2, "max_iters": 2,
    "model_kwargs": {"timestep_shift": 5.0, "local_attn_size": 4, "sink_size": 1},
    "image_or_video_shape": [1, 4, 4, 8, 8], "negative_prompt": "low quality",
    "phase_ledger": True,
}


def _write(tmp_path, cfg):
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(param_leaves(a), param_leaves(b)))


def test_run_train_tiny_two_steps_and_resume(tmp_path, capsys):
    data = tmp_path / "prompts.txt"
    data.write_text("a cat\na dog\na fox\n")
    cfg = dict(TINY, data_path=str(data))
    path, logdir = _write(tmp_path, cfg), str(tmp_path / "run")
    tr = run_train.main(["--config_path", path, "--logdir", logdir, "--no_auto_resume",
                         "--device", "cpu"])
    rows = [json.loads(line) for line in open(os.path.join(logdir, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [0, 1]
    assert "generator_loss" in rows[0] and "generator_loss" not in rows[1]  # ratio 2
    for r in rows:
        assert torch.isfinite(torch.tensor(r["critic_loss"]))
        assert set(r["phase_ms"]) >= {"critic_rollout", "critic_loss_grad"}
    assert set(rows[0]["phase_ms"]) >= {"gen_rollout", "dmd_loss_grad", "gen_block_backward"}
    assert train_state.list_checkpoint_steps(logdir) == [1, 2]  # max_checkpoints 2
    assert train_state.load_loader_state(logdir) == {"epoch": 0, "index": 2}

    # auto-resume restores the state and the loop ends at once
    capsys.readouterr()
    tr2 = run_train.main(["--config_path", path, "--logdir", logdir, "--device", "cpu"])
    assert "[resume] restored step 2" in capsys.readouterr().out
    assert tr2.state["step"] == 2
    for key in ("gen_params", "critic_params"):
        assert _same(tr2.state[key], tr.state[key])
    assert _same(tr2.state["ema_params"], tr.state["ema_params"])
    assert tr2.gen_opt.state_dict()["state"][0]["step"] == 1
    assert len(open(os.path.join(logdir, "metrics.jsonl")).readlines()) == 2


def test_run_train_tiny_streaming_lora_three_steps_and_resume(tmp_path, capsys):
    """A streaming YAML with rank-4 adapters on both models: three steps
    (the generator and the critic on step 0, the prompt switch, a new
    sequence on step 2), the preview video of the EMA adapters merged into
    the base, a checkpoint holding the adapters and their AdamW states, and
    an auto-resume that restores them bit-equal; the resumed run starts a
    new sequence."""
    first, second = tmp_path / "a.txt", tmp_path / "b.txt"
    first.write_text("a cat\na dog\na fox\n")
    second.write_text("a cat at night\na dog at night\na fox at night\n")
    cfg = dict(TINY, data_path=str(first), switch_prompt_path=str(second), max_iters=3,
               log_iters=2, vis_interval=2, vis_video_lengths=[2], streaming_training=True, streaming_chunk_size=3,
               streaming_max_length=8, streaming_min_new_frame=2, switch_choices=[4],
               num_training_frames=3, min_num_training_frames=3, slice_last_frames=3,
               adapter={"type": "lora", "rank": 4, "alpha": 4, "apply_to_critic": True,
                        "dtype": "float32"})
    path, logdir = _write(tmp_path, cfg), str(tmp_path / "run")
    tr = run_train.main(["--config_path", path, "--logdir", logdir, "--no_auto_resume",
                         "--device", "cpu"])
    rows = [json.loads(line) for line in open(os.path.join(logdir, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [0, 1, 2]
    assert [r["current_length"] for r in rows] == [5, 7, 5]
    assert [r["switched"] for r in rows] == [True, False, True]
    assert "generator_loss" in rows[0] and "generator_loss" not in rows[1]
    assert {"recache", "reencode", "gen_block_backward"} <= set(rows[0]["phase_ms"])
    assert train_state.list_checkpoint_steps(logdir) == [2, 3]
    assert os.path.getsize(os.path.join(logdir, "vis_000002_2f.mp4")) > 0  # EMA adapters merged
    saved = train_state.restore_train_state(logdir)
    assert saved["gen_lora"] is not None and saved["critic_lora"] is not None
    assert len(saved["gen_opt"]["state"]) == len(param_leaves(tr.state["gen_lora"]))
    for key in ("gen_lora", "critic_lora"):
        assert _same(saved[key], tr.state[key])

    capsys.readouterr()
    tr2 = run_train.main(["--config_path", path, "--logdir", logdir, "--device", "cpu"])
    assert "[resume] restored step 3" in capsys.readouterr().out
    for key in ("gen_params", "critic_params", "gen_lora", "critic_lora", "ema_params"):
        assert _same(tr2.state[key], tr.state[key])
    for a, b in ((tr2.gen_opt, tr.gen_opt), (tr2.critic_opt, tr.critic_opt)):
        sa, sb = a.state_dict()["state"], b.state_dict()["state"]
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[i]["exp_avg_sq"], sb[i]["exp_avg_sq"]) for i in sa)
    assert tr2.seq_state is None  # the loop ended at once; a step would start a new sequence


LEVERS = {
    "opt_on_host": dict(opt_on_host=True),
    "cache_int8": dict(cache_int8=True),
    "gradient_accumulation_steps": dict(gradient_accumulation_steps=2),
    "teacher_stream": dict(staged_phases=True, teacher_stream=True),
    "page_generator": dict(staged_phases=True, page_generator=True),
    "opt_async": dict(opt_on_host=True, opt_async=True),
}
LEVER_PHASES = {"opt_on_host": {"opt_generator", "opt_critic"},
                "teacher_stream": {"teacher_x0_streamed"},
                "page_generator": {"teacher_fetch", "gen_page_out", "gen_page_in"},
                "opt_async": {"opt_generator", "opt_critic"}}


@pytest.mark.parametrize("key", list(LEVERS))
def test_unported_options_raise(tmp_path, key):
    """The single-card levers, once refused, run through ``run_train`` on
    the tiny config for 2 steps (ratio 2: the generator on step 0; with
    2-step accumulation both steps are optimiser step 0): finite losses,
    their phases in the ledger, the background critic update's grad norm a
    step late and the last one logged at the end."""
    path, logdir = _write(tmp_path, dict(TINY, **LEVERS[key])), str(tmp_path / "r")
    tr = run_train.main(["--config_path", path, "--logdir", logdir, "--no_auto_resume",
                         "--device", "cpu", "--no_save"])
    rows = [json.loads(line) for line in open(os.path.join(logdir, "metrics.jsonl"))]
    assert [r["step"] for r in rows[:2]] == [0, 1]
    accum = key == "gradient_accumulation_steps"
    assert [r["opt_step"] for r in rows[:2]] == ([0, 0] if accum else [0, 1])
    assert ["generator_loss" in r for r in rows[:2]] == [True, accum]
    for r in rows[:2]:
        assert torch.isfinite(torch.tensor(r["critic_loss"]))
        assert LEVER_PHASES.get(key, set()) <= set(r["phase_ms"]) or "generator_loss" not in r
    if key == "opt_async":
        assert "critic_grad_norm" not in rows[0] and "critic_grad_norm" in rows[1]
        assert "critic_grad_norm" in rows[2] and tr._pending is None
    if key == "page_generator":
        assert rows[0]["gen_page_bytes"] == sum(t.numel() * 4 for t in param_leaves(
            tr.state["gen_params"]))
    if key == "cache_int8":
        assert tr.rcfg.cache_int8


@pytest.mark.parametrize("options,err", [
    (dict(opt_async=True), ValueError),
    (dict(teacher_stream=True), ValueError),
    (dict(page_generator=True), ValueError),
    (dict(opt_on_host=True, gradient_accumulation_steps=2), NotImplementedError),
], ids=["opt_async without opt_on_host", "teacher_stream without staged_phases",
        "page_generator without staged_phases", "opt_on_host with accumulation"])
def test_lever_guards_raise(tmp_path, options, err):
    """The JAX package's refusals of lever combinations."""
    path = _write(tmp_path, dict(TINY, **options))
    with pytest.raises(err):
        run_train.main(["--config_path", path, "--logdir", str(tmp_path / "r"), "--device",
                        "cpu", "--no_save"])


def test_larger_teacher_needs_teacher_stream(monkeypatch, tmp_path):
    """``real_name`` of a wider teacher (here the tiny config at twice its
    width, standing for Wan2.1-T2V-14B): without ``teacher_stream`` the JAX
    package's ValueError; with it, the teacher is built in host memory at
    its own widths."""
    from longlive_torch import config as C

    cfg = tiny_dit_config()
    geo = dict(dim=cfg.dim, ffn_dim=cfg.ffn_dim, num_heads=cfg.num_heads,
               num_layers=cfg.num_layers)
    monkeypatch.setitem(C.WAN_MODEL_CONFIGS, "Wan2.1-T2V-1.3B", geo)
    monkeypatch.setitem(C.WAN_MODEL_CONFIGS, "Wan2.1-T2V-14B",
                        dict(geo, dim=2 * cfg.dim, num_heads=2 * cfg.num_heads))
    monkeypatch.chdir(tmp_path)
    raw = {"real_name": "Wan2.1-T2V-14B"}
    with pytest.raises(ValueError, match="teacher_stream"):
        run_train.resolve_score_models(raw, cfg, run_train.build_trainer_config(raw), "cpu")
    raw.update(teacher_stream=True, staged_phases=True)
    teacher, tcfg, _ = run_train.resolve_score_models(raw, cfg,
                                                      run_train.build_trainer_config(raw), "cpu")
    assert tcfg.dim == 2 * cfg.dim and tcfg.num_heads == 2 * cfg.num_heads
    assert tuple(teacher["blocks"][0]["self_attn"]["q"]["weight"].shape) == (2 * cfg.dim,) * 2
    assert all(t.device.type == "cpu" for t in param_leaves(teacher))


def test_more_than_one_process_raises(tmp_path, monkeypatch):
    """A ``parallel:`` layout of more ranks than the run has (one, without
    torchrun) exits naming torchrun before any model is built."""
    cfg = _write(tmp_path, dict(TINY, parallel={"dp": 2, "fsdp": 1}))
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node 2"):
        run_train.main(["--config_path", cfg, "--device", "cpu"])


def test_score_models_are_fresh_and_strict(monkeypatch, tmp_path):
    """Teacher and critic are fresh random inits (seeds seed+1, seed+2),
    never the generator; outside tiny_debug a missing checkpoint fails
    unless random weights are allowed."""
    cfg = tiny_dit_config()
    tcfg = run_train.build_trainer_config({"seed": 0})
    gen = D.init_dit_params(cfg, torch.float32, "cpu", seed=0, zero_head=False)
    teacher, tcfg_out, critic = run_train.resolve_score_models(
        {"tiny_debug": True, "seed": 0}, cfg, tcfg, "cpu")
    assert tcfg_out is cfg
    assert not _same(teacher, gen) and not _same(critic, gen) and not _same(teacher, critic)
    from longlive_torch import config as C

    monkeypatch.setitem(C.WAN_MODEL_CONFIGS, "Wan2.1-T2V-1.3B",
                        dict(dim=cfg.dim, ffn_dim=cfg.ffn_dim, num_heads=cfg.num_heads,
                             num_layers=cfg.num_layers))
    monkeypatch.chdir(tmp_path)  # no wan_models/ here
    with pytest.raises(FileNotFoundError):
        run_train.resolve_score_models({}, cfg, tcfg, "cpu", strict=True)
    teacher, _, critic = run_train.resolve_score_models({}, cfg, tcfg, "cpu")
    assert not _same(teacher, critic)


def test_prompt_embedding_is_seeded_by_the_text():
    cfg = tiny_dit_config()
    a = run_train.random_prompt_embedding("a cat", cfg, "cpu")
    assert torch.equal(a, run_train.random_prompt_embedding("a cat", cfg, "cpu"))
    assert not torch.equal(a, run_train.random_prompt_embedding("a dog", cfg, "cpu"))


def test_loader_matches_jax_and_resumes(tmp_path):
    first, second = tmp_path / "a.txt", tmp_path / "b.txt"
    first.write_text("".join(f"p{i}\n" for i in range(7)))
    second.write_text("".join(f"s{i}\n" for i in range(7)))
    tds, jds = TDS.TwoTextDataset(str(first), str(second)), JDS.TwoTextDataset(str(first),
                                                                               str(second))
    assert TDS.shuffled_indices(7, 3, 2) == JDS.shuffled_indices(7, 3, 2)
    assert TDS.epoch_shard(tds, 1, 2, 3, 1) == JDS.epoch_shard(jds, 1, 2, 3, 1)
    tl, jl = TDS.ShardedCheckpointableLoader(tds, 0, 2, seed=5), JDS.ShardedCheckpointableLoader(
        jds, 0, 2, seed=5)
    assert [next(tl) for _ in range(9)] == [next(jl) for _ in range(9)]
    resumed = TDS.ShardedCheckpointableLoader(tds, 0, 2, seed=5, state=tl.state())
    assert [next(resumed) for _ in range(3)] == [next(jl) for _ in range(3)]
    c = TDS.cycle([1, 2])
    assert [next(c) for _ in range(5)] == [1, 2, 1, 2, 1]


def test_train_state_retention_and_latest(tmp_path):
    logdir = str(tmp_path)
    for step in (3, 10, 7):
        train_state.save_train_state(logdir, step, {"step": step, "w": torch.ones(2) * step},
                                     max_checkpoints=2)
    assert train_state.list_checkpoint_steps(logdir) == [7, 10]
    assert train_state.latest_checkpoint_step(logdir) == 10
    assert train_state.restore_train_state(logdir)["w"].tolist() == [10.0, 10.0]
    assert train_state.restore_train_state(str(tmp_path / "none")) is None


def test_run_train_tiny_writes_the_preview_video(tmp_path):
    """vis_interval: the EMA generator through the inference pipeline and
    the (tiny) VAE, written beside the checkpoints."""
    path = _write(tmp_path, dict(TINY, vis_interval=1, vis_video_lengths=[2]))
    logdir = tmp_path / "run"
    run_train.main(["--config_path", path, "--logdir", str(logdir), "--no_auto_resume",
                    "--no_save", "--device", "cpu"])
    video = logdir / "vis_000001_2f.mp4"
    assert video.exists() and video.stat().st_size > 0
    assert train_state.list_checkpoint_steps(str(logdir)) == []
