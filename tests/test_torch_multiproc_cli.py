"""The port's CLIs on 2 gloo ranks, spawned once for the module: the
counterpart of the JAX package's ``scripts/multiproc_sim.py`` phases, and
of ``run_inference --sp 2`` / ``run_t2v --sp 2`` against one process and
against the JAX package.

- ``run_train`` tiny on 2 ranks (fsdp 2, the prompt rows of a data file):
  finite losses, the same on both ranks (the global means); each rank
  holds a shard; rank 0 alone prints; its 2 steps' losses and gradient
  norms against one process's ``run_train`` on the same config (an fsdp
  group's ranks share the rows, so the step is the one process's; 5e-4,
  the single-process step's gradient-norm tolerance in
  ``tests/test_torch_train_step.py``);
- its restart: the auto-resume restores step 2 on both ranks (the
  checkpoint written by rank 0, the loader's position per rank) and runs
  on to step 3;
- ``run_interactive`` tiny with the 2 rows of a data file sharded over the
  ranks (one each) and a switch: each rank writes its own row's video,
  named with its rank;
- ``run_inference --sp 2`` and ``run_t2v --sp 2`` tiny: the sp group's
  rank 0 writes, both ranks hold the same latents, and they match one
  process's run of the same CLI (the same seeds; 5e-4, JAX's multi-block
  sp tolerance in ``tests/test_decode_sp.py``);
- the two again on fixed weights, against the JAX package's sp pipeline
  and sp sampler on 2 virtual devices, on the inputs the CLI drew:
  ``run_inference --sp 2`` with its re-noise drawn as zeros (JAX draws
  its own from another generator), and ``run_t2v --sp 2``, which samples
  in bf16 (on the CPU too); 5e-4 as above.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from longlive_torch import run_inference, run_t2v, run_train
from longlive_tpu.config import load_pipeline_config as j_load_pipeline_config
from longlive_tpu.config import tiny_dit_config as j_tiny
from longlive_tpu.config import tiny_geometry as j_geom
from longlive_tpu.models import dit as JD
from longlive_tpu.parallel import mesh as JM
from longlive_tpu.models import vae as JV
from longlive_tpu.pipeline import CausalInferencePipeline as JPipeline
from longlive_tpu.pipeline.text2video import Text2VideoPipeline as JText2Video

from torch_dist import random_tree, start_ranks

TOL = 5e-4
GRAD_TOL = 5e-4  # tests/test_torch_train_step.py: grad norms through a whole rollout

TRAIN = {
    "tiny_debug": True, "distribution_loss": "dmd", "num_frame_per_block": 1,
    "num_training_frames": 4, "min_num_training_frames": 4, "slice_last_frames": 4,
    "denoising_step_list": [1000, 750, 500, 250], "warp_denoising_step": True,
    "dfake_gen_update_ratio": 2, "log_iters": 1, "max_checkpoints": 2,
    "model_kwargs": {"timestep_shift": 5.0, "local_attn_size": 4, "sink_size": 1},
    "image_or_video_shape": [1, 4, 4, 8, 8], "negative_prompt": "low quality",
}
SERVE = {"tiny_debug": True, "model_kwargs": {"local_attn_size": 4, "sink_size": 1},
         "num_frame_per_block": 1, "profile": False}


def _t2v_cfg():
    """``run_t2v --tiny_debug``'s DiT config, the JAX package's."""
    z = JV.tiny_vae_config().z_dim
    return dataclasses.replace(j_tiny(), local_attn_size=-1, sink_size=0, in_dim=z, out_dim=z)


def _sp2():
    return JM.make_mesh(dp=1, fsdp=1, sp=2, devices=jax.devices()[:2])


def _yaml(path, cfg):
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    prompts = d / "prompts.txt"
    prompts.write_text("".join(f"prompt {i}\n" for i in range(4)))
    rows = d / "rows.jsonl"
    rows.write_text("".join(json.dumps({"prompts": [f"row {i} a", f"row {i} b"]}) + "\n"
                            for i in range(2)))
    def tree(cfg, seed):
        return random_tree(jax.eval_shape(lambda: JD.init_dit_params(
            jax.random.PRNGKey(0), cfg, jnp.float32, zero_head=False)), seed)

    args = dict(
        tree=tree(j_tiny(), 5), t2v_tree=tree(_t2v_cfg(), 6),
        logdir=str(d / "run"),
        train_cfg=_yaml(d / "train.yaml", dict(TRAIN, data_path=str(prompts))),
        interactive_cfg=_yaml(d / "interactive.yaml", dict(
            SERVE, num_output_frames=6, switch_frame_indices="3", global_sink=False,
            eager_recache=True, data_path=str(rows), output_folder=str(d / "interactive"))),
        inference_cfg=_yaml(d / "inference.yaml", dict(SERVE, num_output_frames=5,
                                                       output_folder=str(d / "inference"))),
        t2v_argv=["--prompt", "a red fox", "--tiny_debug", "--size", "16x16", "--frame_num",
                  "5", "--steps", "3", "--output", str(d / "t2v.mp4"), "--device", "cpu"])
    ranks = start_ranks(2, "torch_dist_cases", "cli_cases", args, d)
    one = []  # while the ranks run: one process's run_train on the same config
    step = run_train.ScoreDistillationTrainer.train_step

    def recorded(self, *a, **kw):
        m = step(self, *a, **kw)
        one.append(m)
        return m

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(run_train.ScoreDistillationTrainer, "train_step", recorded)
        mp.chdir(d)
        run_train.main(["--config_path", args["train_cfg"], "--logdir", str(d / "one"),
                        "--device", "cpu", "--no_auto_resume", "--max_iters", "2"])
    args["one_process_train"] = one
    return args, ranks.results()


def test_run_train_two_ranks(setup):
    _, out = setup
    for r in (0, 1):
        m = out[r]["train_metrics"]
        assert out[r]["train_step"] == 2 and len(m) == 3  # 2 steps, then 1 after the resume
        assert all(np.isfinite(x["critic_loss"]) for x in m)
        assert m == out[0]["train_metrics"]  # the global means, the same on both
        assert out[r]["train_shard_numel"] == out[0]["train_shard_numel"]
    assert "'critic_loss'" in out[0]["train_printed"] and not out[1]["train_printed"]


def test_run_train_two_ranks_matches_one_process(setup):
    args, out = setup
    want = args["one_process_train"]
    assert len(want) == 2 and "generator_loss" in want[0]  # step 0 trains the generator
    for got, w in zip(out[0]["train_metrics"], want):
        assert (got.get("exit_idx"), got["critic_exit_idx"]) == (w.get("exit_idx"),
                                                                  w["critic_exit_idx"])
        for k in ("generator_loss", "critic_loss", "generator_grad_norm", "critic_grad_norm"):
            if k in w:
                np.testing.assert_allclose(got[k], w[k], rtol=GRAD_TOL, atol=GRAD_TOL)
    assert want[0]["generator_grad_norm"] > 0


def test_run_train_restart_resumes(setup):
    args, out = setup
    for r in (0, 1):
        assert out[r]["resumed_step"] == 3
    assert "[resume] restored step 2" in out[0]["train_printed"]
    ckpt = os.path.join(args["logdir"], "checkpoint_model_000003")
    assert sorted(f for f in os.listdir(ckpt) if f.startswith("loader_state")) == [
        "loader_state_p0.json", "loader_state_p1.json"]


def test_run_interactive_rows_sharded_with_switch(setup):
    _, out = setup
    (name0, lat0), = out[0]["interactive"]
    (name1, lat1), = out[1]["interactive"]
    assert name0.startswith("rank0-row 0 a") and name1.startswith("rank1-row 1 a")
    assert lat0.shape == lat1.shape == (1, 6, 4, 8, 8) and np.isfinite(lat0).all()
    assert not np.allclose(lat0, lat1)  # two rows, two prompts


def test_run_inference_sp2_matches_one_process(setup, tmp_path, monkeypatch):
    args, out = setup
    (path0, lat0), = out[0]["inference"]
    (path1, lat1), = out[1]["inference"]
    assert os.path.getsize(path0) > 0 and os.path.basename(path0).startswith("rank0-")
    assert path1 is None and np.array_equal(lat0, lat1)
    monkeypatch.chdir(tmp_path)
    (want,) = run_inference.main(["--config_path", args["inference_cfg"], "--device", "cpu"])
    np.testing.assert_allclose(lat0, want["latents"].numpy(), rtol=TOL, atol=TOL)


def test_run_t2v_sp2_matches_one_process(setup, tmp_path):
    args, out = setup
    (path0, lat0), (path1, lat1) = out[0]["t2v"], out[1]["t2v"]
    assert os.path.getsize(path0) > 0 and path1 is None and np.array_equal(lat0, lat1)
    argv = list(args["t2v_argv"])
    argv[argv.index("--output") + 1] = str(tmp_path / "one.mp4")
    want = run_t2v.main(argv)
    np.testing.assert_allclose(lat0, want["latents"].float().numpy(), rtol=TOL, atol=TOL)


def test_run_inference_sp2_matches_jax(setup):
    args, out = setup
    inputs, lat0 = out[0]["inference_fixed"]
    _, lat1 = out[1]["inference_fixed"]
    assert np.array_equal(lat0, lat1)
    pc = j_load_pipeline_config(args["inference_cfg"])
    jcfg = dataclasses.replace(j_tiny(), local_attn_size=pc.local_attn_size,
                               sink_size=pc.sink_size, num_frame_per_block=pc.num_frame_per_block)
    jp = JPipeline(pc, jax.tree.map(jnp.asarray, args["tree"]), geometry=j_geom(),
                   dit_config=jcfg, attn_impl="xla", deterministic_renoise=True, mesh=_sp2())
    want = jp.generate_latents(jnp.asarray(inputs["noise"]),
                               jp.prepare_condition(jnp.asarray(inputs["cond"])))
    np.testing.assert_allclose(lat0, np.asarray(want), rtol=TOL, atol=TOL)


def test_run_t2v_sp2_matches_jax(setup):
    args, out = setup
    inputs, lat0 = out[0]["t2v_fixed"]
    _, lat1 = out[1]["t2v_fixed"]
    assert np.array_equal(lat0, lat1)
    argv = args["t2v_argv"]
    jp = JText2Video(jax.tree.map(jnp.asarray, args["t2v_tree"]), _t2v_cfg(), attn_impl="xla",
                     mesh=_sp2())
    bf16 = lambda x: jnp.asarray(x).astype(jnp.bfloat16)  # noqa: E731  (exact: bf16 values)
    want = jp.generate_latents(bf16(inputs["cond"]), bf16(inputs["null"]),
                               noise=bf16(inputs["noise"]),
                               sampling_steps=int(argv[argv.index("--steps") + 1]),
                               dtype=jnp.bfloat16)
    np.testing.assert_allclose(lat0, np.asarray(want).astype(np.float32), rtol=TOL, atol=TOL)
