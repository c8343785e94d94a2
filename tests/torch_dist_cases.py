"""The rank-side halves of the port's multi-rank tests (``torch_dist``):
each function runs on every gloo rank, imports torch and the port only,
and returns numpy arrays that the test compares with the JAX package's
multi-device functions."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _cross(a):
    from longlive_torch.models.dit import CrossKV

    return CrossKV(_t(a[0]), _t(a[1]))


# ---------------------------------------------------------------------------
# tests/test_torch_parallel.py


def parallel_cases(rank, world, a):
    """Ulysses attention and the sequence-parallel bidirectional forward at
    sp 2 (two groups of 2) and sp 4, and the FSDP shard / gather round trip
    at fsdp 2 and 4."""
    from longlive_torch.config import tiny_dit_config
    from longlive_torch.ops.rope import make_rope_tables
    from longlive_torch.parallel import mesh as M
    from longlive_torch.parallel import sequence as SQ
    from longlive_torch.utils.memory import param_leaves
    from longlive_torch.utils.params import dit_params_from_jax

    cfg = tiny_dit_config()
    params = dit_params_from_jax(a["tree"])
    tables = make_rope_tables(cfg.head_dim, cfg.rope_max_pos)
    q, k, v = (_t(z) for z in a["qkv"])
    out = {}
    for sp in (2, 4):
        mesh = M.make_mesh(dp=world // sp, fsdp=1, sp=sp, device_type="cpu")
        g, r = M.axis_group(mesh, "sp"), M.axis_rank(mesh, "sp")
        n = q.shape[1] // sp
        mine = slice(r * n, (r + 1) * n)
        y = SQ.ulysses_attention(q[:, mine], k[:, mine], v[:, mine], g)
        out[f"ulysses_{sp}"] = M.all_gather_dim(y, 1, g).numpy()
        with torch.no_grad():
            out[f"bidi_{sp}"] = SQ.sp_bidirectional_forward(
                params, cfg, tables, g, _t(a["x"]), _t(a["t"]), _cross(a["cross"])).numpy()
    for n in (2, 4):
        mesh = M.make_mesh(dp=world // n, fsdp=n, sp=1, device_type="cpu")
        shards = M.shard_params(params, mesh)
        back = M.gather_params(shards, M.leaf_specs(params, n), mesh)
        out[f"roundtrip_{n}"] = all(torch.equal(x, y) for x, y in
                                    zip(param_leaves(params), param_leaves(back)))
        out[f"numel_{n}"] = sum(t.numel() for t in param_leaves(shards))
    out["numel"] = sum(t.numel() for t in param_leaves(params))
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_decode_sp.py


def decode_sp_cases(rank, world, a):
    """One sp forward and its cache at sp 2 and 4; then over sp 2: an
    8-frame generation (the ring wraps), an eager-recache switch, and
    ``PipelinedRenderer``."""
    from longlive_torch.config import PipelineConfig, tiny_dit_config, tiny_geometry
    from longlive_torch.models import vae as TV
    from longlive_torch.parallel import mesh as M
    from longlive_torch.parallel.decode_sp import sp_dit_forward_cached
    from longlive_torch.pipeline import (CausalInferencePipeline,
                                         InteractiveCausalInferencePipeline, PipelinedRenderer)
    from longlive_torch.utils.params import dit_params_from_jax, vae_params_from_jax

    cfg, geom = tiny_dit_config(), tiny_geometry()
    params = dit_params_from_jax(a["tree"])
    pc = PipelineConfig(**a["pc"])

    def pipe(mesh, cls=CausalInferencePipeline, **knobs):
        return cls(dataclasses.replace(pc, **knobs), params, geometry=geom, dit_config=cfg,
                   device="cpu", deterministic_renoise=True, mesh=mesh)

    out = {}
    with torch.no_grad():
        for sp in (2, 4):
            p = pipe(M.make_mesh(dp=world // sp, fsdp=1, sp=sp, device_type="cpu"))
            x = _t(a["x1"])
            t = torch.full(x.shape[:2], 750.0)
            flow, cache = sp_dit_forward_cached(params, cfg, p.cache_cfg, p.tables, p.sp_group,
                                                x, t, _cross(a["cross"]), p.init_cache(1), 0)
            full = dataclasses.replace(  # every rank's head slice
                cache, **{n: M.all_gather_dim(getattr(cache, n), 2, p.sp_group)
                          for n in ("k", "v")})
            out[f"fwd_{sp}"] = (flow.numpy(), full.k.numpy(), full.v.numpy(),
                                tuple(cache.k.shape), p.kernel_cache)
        mesh = M.make_mesh(dp=world // 2, fsdp=1, sp=2, device_type="cpu")
        p = pipe(mesh)
        crosses = [p.prepare_condition(_t(pe)) for pe in a["pes"]]
        out["gen8"] = p.generate_latents(_t(a["noise"]), crosses[0]).numpy()
        ip = pipe(mesh, InteractiveCausalInferencePipeline, global_sink=False,
                  eager_recache=True)
        out["eager"] = ip.generate_latents_interactive_scanned(_t(a["noise"]), crosses,
                                                               [4, 6]).numpy()
        vcfg = TV.tiny_vae_config()
        renderer = PipelinedRenderer(pipe(mesh, num_output_frames=6),
                                     vae_params_from_jax(a["vtree"]), vcfg, segment_frames=2)
        px = renderer.render(_t(a["noise"][:, :6]), crosses[0], dtype=torch.float32)
        out["render"] = None if px is None else px.numpy()
    out["sp_rank"] = M.axis_rank(mesh, "sp")
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_fsdp.py


def _full_leaves(tree):
    from longlive_torch.utils.memory import param_leaves

    return [t.detach().numpy().copy() for t in param_leaves(tree)]


def fsdp_cases(rank, world, a):
    """On a dp 2 x fsdp 2 mesh: one DMD step with the given global draws
    (each rank its rows); the checkpoint of its whole state (written by
    rank 0), loaded back on the 4 ranks; then two streaming steps at
    dp 2."""
    import torch.distributed as dist

    from longlive_torch.config import tiny_dit_config, tiny_geometry
    from longlive_torch.parallel import mesh as M
    from longlive_torch.training.streaming import StreamingConfig, StreamingTrainer
    from longlive_torch.training.trainer import ScoreDistillationTrainer, TrainerConfig
    from longlive_torch.utils import train_state
    from longlive_torch.utils.memory import param_leaves
    from longlive_torch.utils.params import dit_params_from_jax

    cfg, geom = tiny_dit_config(), tiny_geometry()
    mesh = M.make_mesh(dp=2, fsdp=2, sp=1, device_type="cpu")
    rows = M.batch_rows(mesh, a["noise"].shape[0])

    def trainer(cls=ScoreDistillationTrainer, **kw):
        return cls(TrainerConfig(**a["tcfg"]), cfg, geom,
                   *(dit_params_from_jax(t) for t in a["trees"]), device="cpu", mesh=mesh, **kw)

    out = {}
    tr = trainer()
    m = tr.train_step(_t(a["noise"])[rows], _t(a["pe_c"])[rows], _t(a["pe_u"])[rows],
                      a["draws"])
    out["metrics"] = {k: v for k, v in m.items() if isinstance(v, (int, float))}
    out["gathered_after"] = len(tr._gathered)
    sd = tr.state_dict()
    out["gen"], out["critic"] = _full_leaves(sd["gen_params"]), _full_leaves(sd["critic_params"])
    for which in ("gen", "critic"):  # AdamW's moments, gathered whole
        st = sd[which + "_opt"]["state"]
        out[which + "_moments"] = [(st[i]["exp_avg"].numpy(), st[i]["exp_avg_sq"].numpy())
                                   for i in range(len(st))]
    out["shard_numel"] = sum(t.numel() for t in param_leaves(tr.state["gen_params"]))
    train_state.save_train_state(a["logdir"], 1, sd, max_checkpoints=2)
    back = trainer()
    back.load_state_dict(train_state.restore_train_state(a["logdir"]))
    out["reload_equal"] = all(
        torch.equal(x, y) for key in ("gen_params", "critic_params")
        for x, y in zip(param_leaves(tr.state[key]), param_leaves(back.state[key])))
    out["opt_equal"] = all(
        torch.equal(x["exp_avg_sq"], y["exp_avg_sq"])
        for x, y in zip(tr.gen_opt.state.values(), back.gen_opt.state.values()))

    st = trainer(StreamingTrainer, streaming_cfg=StreamingConfig(**a["stream"]))
    st.start_new_sequence(_t(a["pe_c"])[rows], _t(a["pe_u"])[rows])
    out["stream"] = [{k: v for k, v in st.streaming_train_step().items()
                      if isinstance(v, (int, float))} for _ in range(2)]
    out["stream_gathered_after"] = len(st._gathered)
    out["stream_gen"] = _full_leaves(st.state_dict()["gen_params"])
    dist.barrier()
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_multiproc_cli.py


class _PromptEncoder:
    """A stand-in text encoder: each prompt's seeded random embedding
    (``run_train.random_prompt_embedding``), so that the CLIs read the
    prompt rows of a data file without umT5 assets."""

    def __init__(self, cfg):
        self.cfg = cfg

    def __call__(self, texts):
        from longlive_torch.run_train import random_prompt_embedding

        return {"prompt_embeds": random_prompt_embedding(texts[0], self.cfg, "cpu")}

    def offload(self):
        pass


def _inference_on_fixed_weights(a):
    """``run_inference --sp 2`` once more on the test's weights (``a["tree"]``
    for its random init), the re-noise drawn as zeros
    (``deterministic_renoise``): (its inputs, its latents), for the JAX
    package's sp pipeline to take the same inputs (it draws its re-noise
    from another generator)."""
    import unittest.mock as mock

    from longlive_torch import run_inference
    from longlive_torch.models import dit as D
    from longlive_torch.pipeline import CausalInferencePipeline as P
    from longlive_torch.utils.params import dit_params_from_jax

    inputs = {}
    init, prepare, generate = P.__init__, P.prepare_condition, P.generate_latents

    def zero_renoise(self, *args, **kw):
        init(self, *args, **{**kw, "deterministic_renoise": True})

    def prepare_recorded(self, cond):
        inputs["cond"] = cond.numpy().copy()
        return prepare(self, cond)

    def generate_recorded(self, noise, cross, **kw):
        inputs["noise"] = noise.numpy().copy()
        return generate(self, noise, cross, **kw)

    with mock.patch.object(D, "init_dit_params",
                           lambda *_, **__: dit_params_from_jax(a["tree"])), \
            mock.patch.multiple(P, __init__=zero_renoise, prepare_condition=prepare_recorded,
                                generate_latents=generate_recorded):
        (rec,) = run_inference.main(["--config_path", a["inference_cfg"], "--device", "cpu",
                                     "--sp", "2"])
    return inputs, rec["latents"].numpy()


def _t2v_on_fixed_weights(a):
    """``run_t2v --sp 2`` once more on the test's weights
    (``a["t2v_tree"]``): (its inputs, its latents), for the JAX package's
    sp sampler to take the same inputs."""
    import unittest.mock as mock

    from longlive_torch import run_t2v
    from longlive_torch.models import dit as D
    from longlive_torch.ops import solvers as SV
    from longlive_torch.pipeline import Text2VideoPipeline as P
    from longlive_torch.utils.params import dit_params_from_jax

    inputs = {}
    prepare, sample = P.prepare_sampler, SV.sample_flow

    def prepare_recorded(self, cond, null, **kw):
        inputs["cond"], inputs["null"] = (x.float().numpy().copy() for x in (cond, null))
        return prepare(self, cond, null, **kw)

    def sample_recorded(fn, noise, coeffs):
        inputs["noise"] = noise.float().numpy().copy()
        return sample(fn, noise, coeffs)

    with mock.patch.object(D, "init_dit_params",
                           lambda *_, **__: dit_params_from_jax(a["t2v_tree"])), \
            mock.patch.object(P, "prepare_sampler", prepare_recorded), \
            mock.patch.object(SV, "sample_flow", sample_recorded):
        rec = run_t2v.main(a["t2v_argv"] + ["--sp", "2"])
    return inputs, rec["latents"].float().numpy()


def cli_cases(rank, world, a):
    """The CLIs on 2 ranks: ``run_train`` (fsdp 2) for 2 steps, then its
    auto-resume to 3; ``run_interactive`` with the rows of a data file
    sharded over the ranks and a switch; ``run_inference --sp 2``, and again
    on fixed weights; ``run_t2v --sp 2``."""
    import contextlib
    import io
    import os

    from longlive_torch import run_inference, run_interactive, run_t2v, run_train
    from longlive_torch.config import tiny_dit_config
    from longlive_torch.training import trainer as T
    from longlive_torch.utils import loading
    from longlive_torch.utils.memory import param_leaves

    seen = []
    step = T.ScoreDistillationTrainer.train_step

    def recorded(self, *args, **kw):
        m = step(self, *args, **kw)
        seen.append({k: v for k, v in m.items() if isinstance(v, (int, float))})
        return m

    T.ScoreDistillationTrainer.train_step = recorded
    out = {}
    train = ["--config_path", a["train_cfg"], "--logdir", a["logdir"], "--device", "cpu"]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        tr = run_train.main(train + ["--no_auto_resume", "--max_iters", "2"])
        out["train_shard_numel"] = sum(t.numel() for t in param_leaves(tr.state["gen_params"]))
        out["train_step"] = int(tr.state["step"])
        tr = run_train.main(train + ["--max_iters", "3"])
    out["resumed_step"] = int(tr.state["step"])
    out["train_metrics"] = seen
    out["train_printed"] = printed.getvalue()

    recs = run_inference.main(["--config_path", a["inference_cfg"], "--device", "cpu",
                               "--sp", "2"])
    out["inference"] = [(r["path"], r["latents"].numpy()) for r in recs]
    out["inference_fixed"] = _inference_on_fixed_weights(a)
    rec = run_t2v.main(a["t2v_argv"] + ["--sp", "2"])
    out["t2v"] = (rec["path"], rec["latents"].float().numpy())
    out["t2v_fixed"] = _t2v_on_fixed_weights(a)

    loading.load_text_encoder = lambda *args, **kw: _PromptEncoder(tiny_dit_config())
    recs = run_interactive.main(["--config_path", a["interactive_cfg"], "--device", "cpu"])
    out["interactive"] = [(os.path.basename(r["path"]), r["latents"].numpy()) for r in recs]
    return out
