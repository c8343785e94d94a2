#!/usr/bin/env python3
"""The port on 2-4 cards of one host, at full Wan2.1-1.3B width with random
weights (non-zero heads), over NCCL.

Usage (from the root of a checkout, on a host with N = 2 or 4 GPUs):

    torchrun --nproc_per_node N scripts/torch_multi_gpu.py

Phases, each of which exits non-zero when it fails:

1. sp decode: the main config's 15 latent frames through
   ``CausalInferencePipeline`` over an sp group of all N ranks
   (``parallel.decode_sp``), against one card's single path
   (``kernel_cache: false``) on rank 0: the same weights, noise and draws,
   within the small-reference limit 5e-2 (relative; the sp ranks' GEMMs run
   on other shapes, so the bits may differ), the latents the same on every
   rank; ms per latent frame of both;
2. sp t2v step: one guided forward of the t2v sampler (832x480, 81 frames,
   both CFG halves) through ``sp_bidirectional_forward`` against
   ``bidirectional_forward`` on rank 0, the same limit; the ms of each
   (synchronised wall);
3. fsdp training: ``run_train`` on ``configs/longlive_train_init.yaml``
   with ``parallel: {dp: 1, fsdp: N}`` for 2 steps, its random weights
   with non-zero heads (its own init zeroes the generator's head, and with
   it the generator's loss and gradient): finite losses and grad norms, a
   non-zero generator gradient, the same on every rank; each rank's shard
   of the generator.  Then one step of a trainer built from that config
   (non-zero heads, the shipped learning rates) at fsdp N against the same
   step on one card (rank 0; the same weights, inputs and draws): each
   generator and critic tensor's change within 5e-2 of the change's norm
   (an update applied to the wrong slice, with the wrong sign or not at
   all is off by ~1 or more).

``--phases decode,t2v,train`` picks the phases (default: all three).

Rank 0 prints one JSON line with the results, the card's name and power
limit, and on cards writes it to ``chiprun_out/multi_gpu_<N>.json``.  ``--profile``:
rank 0 also prints a ``torch.profiler`` summary (device and host time by
op) of one sp decode of the 15 frames.

``--device cpu --tiny`` rehearses the script on the CPU over gloo with the
tiny model and geometry (``torchrun --nproc_per_node 2 scripts/
torch_multi_gpu.py --device cpu --tiny``); its numbers are no device's.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT = 5e-2


def fail(msg: str) -> None:
    print(f"torch_multi_gpu: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def rel_err(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
    return ((a - b).norm() / b.norm().clamp_min(1e-12)).item()


def main() -> None:
    import argparse

    import torch
    import torch.distributed as dist

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="the tiny model (a CPU rehearsal)")
    ap.add_argument("--profile", action="store_true",
                    help="rank 0 prints a torch.profiler summary of one sp decode")
    ap.add_argument("--phases", default="decode,t2v,train",
                    help="comma-separated: decode, t2v, train")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if not phases <= {"decode", "t2v", "train"}:
        fail(f"--phases {args.phases}: the phases are decode, t2v, train")

    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    from longlive_torch.config import (LatentGeometry, load_pipeline_config, tiny_dit_config,
                                       tiny_geometry)
    from longlive_torch.models import dit as D
    from longlive_torch.parallel import mesh as pm
    from longlive_torch.pipeline import CausalInferencePipeline, Text2VideoPipeline

    rank, world, dev = pm.init_distributed(args.device)
    if world < 2:
        fail("run under torchrun --nproc_per_node 2 or 4")
    main_rank = rank == 0
    on_card = dev.type == "cuda"
    dtype = torch.bfloat16 if on_card else torch.float32
    sync = torch.cuda.synchronize if on_card else (lambda *_: None)
    out = {"world": world,
           "device": torch.cuda.get_device_name(dev) if on_card else "cpu (a rehearsal)"}
    if main_rank and on_card:
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    mesh = pm.make_mesh(dp=1, fsdp=1, sp=world, device_type=dev.type)
    group = pm.axis_group(mesh, "sp")

    if phases & {"decode", "t2v"}:
        # the sp phases' inputs
        frames = 15
        config = dataclasses.replace(
            load_pipeline_config(os.path.join(ROOT, "configs", "longlive_inference.yaml")),
            num_output_frames=frames, kernel_cache=None)
        cfg, geom = config.dit_config(), LatentGeometry()
        if args.tiny:
            cfg, geom = tiny_dit_config(), tiny_geometry()
            cfg = dataclasses.replace(cfg, num_frame_per_block=3, local_attn_size=12, sink_size=3)
        params = D.init_dit_params(cfg, dtype, dev, seed=config.seed, zero_head=False)
        g = torch.Generator(device=dev).manual_seed(config.seed)
        cond = torch.randn((1, cfg.text_len, cfg.text_dim), generator=g, device=dev)
        noise = torch.randn((1, frames, geom.channels, geom.height, geom.width), generator=g,
                            device=dev)

        if "decode" in phases:  # 1. sp decode
            def generate(pipe):
                cross = pipe.prepare_condition(cond)
                gen = torch.Generator(device=dev).manual_seed(config.seed)
                sync(dev)
                t0 = time.perf_counter()
                lat = pipe.generate_latents(noise, cross, generator=gen)
                sync(dev)
                return lat, (time.perf_counter() - t0) / frames * 1e3

            sp_pipe = CausalInferencePipeline(config, params, geometry=geom, dit_config=cfg,
                                              device=dev, mesh=mesh)
            generate(sp_pipe)  # warm-up: the kernels' first launches
            lat_sp, sp_ms = generate(sp_pipe)
            pm.check_replicated(lat_sp, group, "the sp decode's latents")
            if args.profile:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
                with profile(activities=acts) as prof:
                    generate(sp_pipe)
                if main_rank:
                    ka = prof.key_averages()
                    sort = "self_device_time_total" if on_card else "self_cpu_time_total"
                    print(ka.table(sort_by=sort, row_limit=15, max_name_column_width=60),
                          flush=True)
                    print(ka.table(sort_by="self_cpu_time_total", row_limit=10,
                                   max_name_column_width=60), flush=True)
            if main_rank:
                single = CausalInferencePipeline(dataclasses.replace(config, kernel_cache=False),
                                                 params, geometry=geom, dit_config=cfg, device=dev)
                generate(single)
                lat, single_ms = generate(single)
                err = rel_err(lat_sp, lat)
                out["sp_decode"] = {"frames": frames, "sp_ms_per_latent_frame": sp_ms,
                                    "single_ms_per_latent_frame": single_ms, "rel_err": err,
                                    "bit_equal": bool(torch.equal(lat_sp, lat))}
                print(f"sp decode: {json.dumps(out['sp_decode'])}", flush=True)
                if not (err <= LIMIT and torch.isfinite(lat_sp).all()):
                    fail(f"sp decode differs from one card: rel_err {err} (limit {LIMIT})")
                del single, lat
            del sp_pipe, lat_sp
            pm.barrier()

        if "t2v" in phases:  # 2. sp t2v step
            tcfg = dataclasses.replace(cfg, local_attn_size=-1, sink_size=0)
            shape = (1, 3, 4, 8, 8) if args.tiny else (1, 21, 16, 60, 104)
            x = torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(7),
                            device=dev).to(dtype)

            def step(mesh_):
                pipe = Text2VideoPipeline(params, tcfg, device=dev, mesh=mesh_)
                fn, _ = pipe.prepare_sampler(cond.to(dtype), torch.zeros_like(cond).to(dtype))
                fn(x, 999.0)  # warm-up
                sync(dev)
                t0 = time.perf_counter()
                flow = fn(x, 999.0)
                sync(dev)
                return flow, (time.perf_counter() - t0) * 1e3

            flow_sp, sp_step_ms = step(mesh)
            pm.check_replicated(flow_sp, group, "the sp t2v step's flow")
            if main_rank:
                flow, single_step_ms = step(None)
                err = rel_err(flow_sp, flow)
                out["sp_t2v_step"] = {"sp_ms": sp_step_ms, "single_ms": single_step_ms,
                                      "rel_err": err}
                print(f"sp t2v step: {json.dumps(out['sp_t2v_step'])}", flush=True)
                if not err <= LIMIT:
                    fail(f"sp t2v step differs from one card: rel_err {err} (limit {LIMIT})")
                del flow
            del flow_sp
            pm.barrier()
        del params
        torch.cuda.empty_cache()

    if "train" in phases:  # 3. fsdp training
        out.update(fsdp_training(args, raw_train_config(args, world), dev, world, main_rank))
    if main_rank:
        line = json.dumps(out)
        if on_card:  # a CPU rehearsal's numbers are no device's
            os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
            with open(os.path.join(ROOT, "chiprun_out", f"multi_gpu_{world}.json"), "w") as f:
                f.write(line + "\n")
        print(line, flush=True)
    pm.barrier()
    dist.destroy_process_group()


def _scalars(metrics: dict) -> dict:
    return {k: v for k, v in metrics.items() if isinstance(v, (int, float))}


def raw_train_config(args, world: int) -> dict:
    import yaml

    with open(os.path.join(ROOT, "configs", "longlive_train_init.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["parallel"] = {"dp": 1, "fsdp": world}
    raw["tiny_debug"] = args.tiny
    return raw


def fsdp_training(args, raw: dict, dev, world: int, main_rank: bool) -> dict:
    """Phase 3: ``run_train`` for 2 steps, then one trainer step at fsdp N
    against one card.  Returns rank 0's results (nothing elsewhere)."""
    import unittest.mock

    import torch
    import torch.distributed as dist
    import yaml

    from longlive_torch import run_train
    from longlive_torch.config import (LatentGeometry, pipeline_config_from_dict,
                                       tiny_dit_config, tiny_geometry)
    from longlive_torch.models import dit as D
    from longlive_torch.parallel import mesh as pm
    from longlive_torch.training import trainer as T
    from longlive_torch.utils.memory import param_leaves

    on_card = dev.type == "cuda"
    init = D.init_dit_params

    def nonzero_heads(*a, **k):  # run_train's random init zeroes the generator's head
        return init(*a, **{**k, "zero_head": False})

    path = os.path.join(ROOT, "build", f"multi_gpu_train_{world}.yaml")
    if main_rank:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            yaml.safe_dump(raw, f)
    pm.barrier()
    seen = []
    train_step = T.ScoreDistillationTrainer.train_step

    def recorded(self, *a, **kw):
        m = train_step(self, *a, **kw)
        seen.append(_scalars(m))
        return m

    t0 = time.perf_counter()
    with unittest.mock.patch.object(T.ScoreDistillationTrainer, "train_step", recorded), \
            unittest.mock.patch.object(D, "init_dit_params", nonzero_heads):
        trainer = run_train.main(["--config_path", path, "--logdir",
                                  os.path.join(ROOT, "build", "multi_gpu_train"),
                                  "--allow_random_weights", "--max_iters", "2",
                                  "--no_auto_resume", "--no_save", "--device", args.device])
    if on_card:
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    shard = sum(t.numel() for t in param_leaves(trainer.state["gen_params"]))
    del trainer
    keys = ("generator_loss", "critic_loss", "generator_grad_norm", "critic_grad_norm")
    vals = [m[k] for m in seen for k in keys if k in m]
    if len(seen) != 2 or not all(math.isfinite(v) for v in vals):
        fail(f"fsdp training: steps {seen}")
    if not any(m.get("generator_grad_norm", 0.0) > 0 for m in seen):
        fail(f"fsdp training: the generator's gradient is zero: {seen}")
    every = [None] * world
    dist.all_gather_object(every, seen)
    if any(e != seen for e in every):
        fail(f"fsdp training: the ranks report different metrics {every}")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if on_card else None
    torch.cuda.empty_cache()

    # one step at fsdp N against the same step on one card
    tc = run_train.build_trainer_config(raw)
    if args.tiny:  # as run_train's tiny_debug
        cfg, geom = tiny_dit_config(), tiny_geometry()
        tc.num_frame_per_block = cfg.num_frame_per_block
        for k in ("num_training_frames", "min_num_training_frames", "slice_last_frames"):
            setattr(tc, k, min(getattr(tc, k), 4))
    else:
        cfg, geom = pipeline_config_from_dict(raw).dit_config(), LatentGeometry()
    noise = torch.randn((1, tc.num_training_frames, geom.channels, geom.height, geom.width),
                        generator=torch.Generator().manual_seed(11))
    pe_c = run_train.random_prompt_embedding("a red fox runs through the snow", cfg, "cpu")
    pe_u = run_train.random_prompt_embedding(raw.get("negative_prompt", ""), cfg, "cpu")

    def one_step(mesh, keep: bool):
        """(metrics, [generator, critic] leaves before and after, on the
        host where ``keep``) of one step from run_train's seeds."""
        trees = [D.init_dit_params(cfg, torch.float32, dev, seed=s, zero_head=False)
                 for s in (0, 2, 1)]  # generator, critic, teacher
        specs = pm.leaf_specs(trees[0], world)
        before = ([[t.to("cpu", copy=True) for t in param_leaves(x)] for x in trees[:2]]
                  if keep else None)
        tr = T.ScoreDistillationTrainer(tc, cfg, geom, *trees, device=dev, mesh=mesh)
        del trees
        t1 = time.perf_counter()
        m = tr.train_step(noise, pe_c, pe_u)
        if on_card:
            torch.cuda.synchronize(dev)
        m["wall_s"] = time.perf_counter() - t1
        after = []
        for key in ("gen_params", "critic_params"):
            tree = tr.state[key] if mesh is None else pm.gather_params(tr.state[key], specs, mesh)
            after.append([t.detach().cpu() for t in param_leaves(tree)] if keep else None)
        del tr
        torch.cuda.empty_cache()
        return m, before, after

    fmesh = pm.make_mesh(dp=1, fsdp=world, sp=1, device_type=dev.type)
    m_n, before, after_n = one_step(fmesh, main_rank)
    result = {}
    if main_rank:
        m_1, _, after_1 = one_step(None, True)
        worst, unchanged, equal = {}, {}, True
        for name, b0, xs, ys in zip(("generator", "critic"), before, after_n, after_1):
            errs, unchanged[name] = [0.0], 0
            for p0, x, y in zip(b0, xs, ys):
                change = (y - p0).norm().item()
                if change > 0:
                    errs.append((x - y).norm().item() / change)
                else:  # no gradient: AdamW's decay alone rounds away
                    unchanged[name] += 1
                    errs.append(0.0 if torch.equal(x, y) else math.inf)
                equal = equal and torch.equal(x, y)
            worst[name] = max(errs)
            if unchanged[name] * 2 > len(b0):
                fail(f"fsdp step: {unchanged[name]} of {len(b0)} {name} tensors unchanged")
        result["fsdp_train"] = {"steps": seen, "wall_s": wall, "gen_shard_elements": shard,
                                "peak_gib": peak}
        result["fsdp_step_vs_one_card"] = {
            "fsdp": _scalars(m_n), "one_card": _scalars(m_1), "bit_equal": equal,
            "worst_change_rel_err": worst, "unchanged_tensors": unchanged, "limit": LIMIT}
        print(f"fsdp step vs one card: {json.dumps(result['fsdp_step_vs_one_card'])}",
              flush=True)
        if not max(worst.values()) <= LIMIT:
            fail(f"fsdp step differs from one card: {worst} (limit {LIMIT})")
    pm.barrier()
    return result

if __name__ == "__main__":
    main()
