"""Tiny end-to-end DMD convergence harness for the PyTorch port.

The port's training tests hold one or two steps against the JAX trainer;
this harness checks what they cannot: that ``longlive_torch``'s
``ScoreDistillationTrainer`` LEARNS.  DMD against a teacher that represents
a known toy latent distribution must move the generator's samples toward
that distribution, and flipping the sign of the KL gradient must destroy
the effect.  The protocol is ``scripts/dmd_convergence.py``'s:

  1. Toy distribution: latents = mu + 0.1 eps around a fixed smooth spatial
     pattern mu (amplitude ~1).
  2. Teacher: the tiny bidirectional DiT pre-trained by flow matching
     (``torch.optim.Adam``) on toy samples, over the shift-warped timestep
     law the DMD loss samples.
  3. DMD: the port's ``ScoreDistillationTrainer`` (the critic every step,
     the generator every 2nd), the critic initialised from the teacher;
     the generator, the causal AR rollout, from random weights.
     ``--streaming`` runs ``StreamingTrainer``'s chunked state machine.
  4. Metric: MSE of the generator's rollout samples (fixed eval noise and
     re-noise) to mu, every ``eval_every`` steps.
  5. Negative control (``--flip-sign``): the DMD loss negated, which is
     exactly a KL-gradient sign flip for the 0.5 ||x - sg(x - grad)||^2
     form.  The metric must not improve.

The draws come from ``torch.Generator``s, so the curve differs from the JAX
package's in its values; it is held to the same margins
(``tests/test_torch_dmd_convergence.py``).  It runs on the CPU: the tiny
config's head dim (24) is not a shape the CUDA kernels take.

Usage:  python scripts/torch_dmd_convergence.py [--steps 300] [--flip-sign]
        [--streaming] [--json out.json]
"""

import argparse
import json
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch


def make_mu(geom, frames: int) -> torch.Tensor:
    """Fixed smooth target pattern [F, C, H, W], amplitude ~1."""
    f = torch.arange(frames, dtype=torch.float32)
    c = torch.arange(geom.channels, dtype=torch.float32)
    h = torch.arange(geom.height, dtype=torch.float32)
    w = torch.arange(geom.width, dtype=torch.float32)
    pat = (torch.sin(2 * math.pi * h / geom.height)[:, None]
           * torch.cos(2 * math.pi * w / geom.width)[None, :])
    scale = (1.0 + 0.3 * torch.sin(f))[:, None, None, None]
    chan = (1.0 + 0.2 * c)[None, :, None, None]
    return scale * chan * pat[None, None]


def pretrain_teacher(cfg, geom, frames, mu, data_sigma, steps, lr, seed):
    """Flow-matching pre-training of the bidirectional teacher on the toy
    distribution, over the SAME shift-warped timesteps DMD later samples.
    Returns (params, the prompt embedding, the last loss)."""
    from longlive_torch.models import dit as D
    from longlive_torch.models.dit_bidirectional import bidirectional_forward
    from longlive_torch.ops import scheduler as S
    from longlive_torch.ops.rope import make_rope_tables
    from longlive_torch.training import dmd as dmd_mod
    from longlive_torch.utils.memory import param_leaves

    sched = S.make_schedule(1000, shift=5.0, sigma_min=0.0, extra_one_step=True,
                            training=True)
    dcfg = dmd_mod.DMDConfig(timestep_shift=5.0)
    tables = make_rope_tables(cfg.head_dim, cfg.rope_max_pos)
    params = D.init_dit_params(cfg, torch.float32, "cpu", seed=seed, zero_head=False)
    # teacher conditioning: the fixed prompt embedding the DMD run also uses
    pe = torch.randn((1, cfg.text_len, cfg.text_dim),
                     generator=torch.Generator().manual_seed(1001))
    leaves = [p.requires_grad_(True) for p in param_leaves(params)]
    opt = torch.optim.Adam(leaves, lr=lr)
    batch = 4
    shape = (batch, frames, geom.channels, geom.height, geom.width)
    bf = batch * frames
    g = torch.Generator().manual_seed(7)
    loss = None
    for _ in range(steps):
        x0 = mu[None] + data_sigma * torch.randn(shape, generator=g)
        score_t = torch.randint(dcfg.min_score_timestep, dcfg.num_train_timestep, (batch,),
                                generator=g)
        t = dmd_mod._sample_score_timestep(score_t, dcfg, batch, frames)
        noise = torch.randn(shape, generator=g)
        noisy = S.add_noise(sched, x0.reshape(bf, *shape[2:]), noise.reshape(bf, *shape[2:]),
                            t.reshape(-1)).reshape(shape)
        tgt = S.training_target(x0, noise)  # = noise - x0
        ckv = D.prepare_cross_kv(params, cfg, pe.expand(batch, -1, -1), torch.float32)
        flow = bidirectional_forward(params, cfg, tables, noisy, t[:, 0], ckv,
                                     attn_impl="train_auto")
        loss = torch.mean(torch.square(flow - tgt))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    for p in leaves:
        p.requires_grad_(False)
    return params, pe, float(loss.detach())


def run(steps=400, eval_every=40, flip_sign=False, lr=2e-4, lr_critic=4e-4,
        teacher_steps=600, seed=0, verbose=True, streaming=False):
    """Returns a dict with the metric curve and its initial / final values.

    ``streaming=True`` runs the StreamingTrainer leg: the same DMD
    mechanics through the chunked long-tuning state machine."""
    from longlive_torch.config import tiny_dit_config, tiny_geometry
    from longlive_torch.models import dit as D
    from longlive_torch.training import dmd as dmd_mod
    from longlive_torch.training.trainer import ScoreDistillationTrainer, TrainerConfig
    from longlive_torch.utils.memory import map_tree

    torch.manual_seed(seed)
    cfg = tiny_dit_config()
    geom = tiny_geometry()
    frames = 4
    data_sigma = 0.1
    mu = make_mu(geom, frames)

    teacher, pe, tloss = pretrain_teacher(cfg, geom, frames, mu, data_sigma, teacher_steps,
                                          2e-3, seed + 100)
    if verbose:
        print(f"teacher flow-matching loss after {teacher_steps} steps: {tloss:.4f}",
              flush=True)

    # negative control: negate the DMD loss == flip the KL-gradient sign
    orig_dmd = dmd_mod.distribution_matching_loss
    if flip_sign:
        def flipped(*a, **kw):
            loss, aux = orig_dmd(*a, **kw)
            return -loss, aux

        dmd_mod.distribution_matching_loss = flipped
    try:
        tcfg = TrainerConfig(
            lr=lr, lr_critic=lr_critic, weight_decay=0.0, dfake_gen_update_ratio=2,
            ema_start_step=10 ** 9, guidance_scale=0.0, num_frame_per_block=1,
            num_training_frames=frames, min_num_training_frames=frames,
            slice_last_frames=frames, seed=seed)
        copy = lambda tree: map_tree(lambda t: t.clone(), tree)  # noqa: E731
        gen0 = D.init_dit_params(cfg, torch.float32, "cpu", seed=seed, zero_head=False)
        # the critic starts FROM the teacher, as the reference's fake_score
        if streaming:
            from longlive_torch.training.streaming import StreamingConfig, StreamingTrainer

            scfg = StreamingConfig(chunk_size=frames, min_new_frame=frames - 1,
                                   max_length=3 * frames)
            tr = StreamingTrainer(tcfg, cfg, geom, copy(gen0), copy(teacher), teacher,
                                  device="cpu", streaming_cfg=scfg)
        else:
            tr = ScoreDistillationTrainer(tcfg, cfg, geom, copy(gen0), copy(teacher),
                                          teacher, device="cpu")

        g_eval = torch.Generator().manual_seed(seed + 5)
        eval_shape = (2, frames, geom.channels, geom.height, geom.width)
        eval_noise = torch.randn(eval_shape, generator=g_eval)
        exit_idx = len(tcfg.denoising_step_list) - 1
        fpb = tcfg.num_frame_per_block
        eval_renoise = torch.randn((frames // fpb, exit_idx + 1, 2, fpb) + eval_shape[2:],
                                   generator=torch.Generator().manual_seed(99))
        pe2 = pe.expand(2, -1, -1).contiguous()

        def metric():
            with torch.no_grad():
                gen = tr._gen_full()
                cross = D.prepare_cross_kv(gen, cfg, pe2, torch.float32)
                lat = tr._rollout(gen, eval_noise, cross, eval_renoise, exit_idx)[0]
            return float(torch.mean(torch.square(lat - mu[None])))

        if streaming:
            tr.start_new_sequence(pe2, pe2)

        curve = [(0, metric())]
        glosses, closses = [], []
        g_noise = torch.Generator().manual_seed(seed + 6)
        for i in range(steps):
            if streaming:
                if not tr.can_generate_more():
                    tr.start_new_sequence(pe2, pe2)
                m = tr.streaming_train_step(new_sequence_cb=lambda: tr.start_new_sequence(pe2,
                                                                                         pe2))
            else:
                # fresh rollout noise every step: two fixed points would not
                # probe distribution matching
                m = tr.train_step(torch.randn(eval_shape, generator=g_noise), pe2, pe2)
            if "generator_loss" in m:
                glosses.append(float(m["generator_loss"]))
            closses.append(float(m["critic_loss"]))
            if (i + 1) % eval_every == 0:
                curve.append((i + 1, metric()))
                if verbose:
                    print(f"step {i + 1}: mse_to_mu={curve[-1][1]:.4f} "
                          f"gen_loss={glosses[-1] if glosses else float('nan'):.4f} "
                          f"critic_loss={closses[-1]:.4f}", flush=True)
    finally:
        dmd_mod.distribution_matching_loss = orig_dmd

    return {
        "flip_sign": flip_sign,
        "streaming": streaming,
        "steps": steps,
        "teacher_fm_loss": tloss,
        "curve": curve,
        "initial_mse": curve[0][1],
        "final_mse": curve[-1][1],
        "min_mse": min(v for _, v in curve),
        "gen_losses": glosses[:: max(1, len(glosses) // 20)],
        "critic_losses": closses[:: max(1, len(closses) // 20)],
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--eval_every", type=int, default=40)
    ap.add_argument("--teacher_steps", type=int, default=600)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--lr_critic", type=float, default=4e-4)
    ap.add_argument("--flip-sign", action="store_true")
    ap.add_argument("--streaming", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    out = run(steps=args.steps, eval_every=args.eval_every, flip_sign=args.flip_sign,
              lr=args.lr, lr_critic=args.lr_critic, teacher_steps=args.teacher_steps,
              streaming=args.streaming)
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
