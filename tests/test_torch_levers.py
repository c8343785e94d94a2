"""The single-card training levers of the port held against the JAX
package at the tiny config, float32 on the CPU, the JAX package's random
draws replayed: host AdamW (``host_adamw_step``), the host-optimiser
trainers (``opt_on_host``, ``opt_async``), gradient accumulation, the int8
rollout cache (the larger streamed teacher is
``tests/test_torch_teacher_stream.py``'s); and, in the
port alone, that the exact levers change no bit (``page_generator``,
``staged_phases``, ``opt_async`` against ``opt_on_host``) and that a
host-optimiser checkpoint round-trips.  Tolerances are the trainer tests'
(``tests/test_torch_train_step.py``): 5e-4 on losses and norms, 1e-3 of
each leaf's change."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longlive_torch.config import CacheConfig, tiny_dit_config, tiny_geometry
from longlive_torch.models import dit as TD
from longlive_torch.ops import kv_cache as tkvc
from longlive_torch.ops import scheduler as TS
from longlive_torch.ops.rope import make_rope_tables
from longlive_torch.training import dmd as tdmd
from longlive_torch.training import rollout as tro
from longlive_torch.training.trainer import (PhaseDraws, ScoreDistillationTrainer, StepDraws,
                                             TrainerConfig, host_adamw_init, host_adamw_step,
                                             map_tree, param_leaves)
from longlive_torch.utils.params import dit_params_from_jax
from longlive_tpu.config import CacheConfig as JCacheConfig
from longlive_tpu.config import tiny_dit_config as j_tiny
from longlive_tpu.models import dit as JD
from longlive_tpu.ops import scheduler as JS
from longlive_tpu.ops.rope import make_rope_tables as j_rope_tables
from longlive_tpu.training import rollout as jro
from longlive_tpu.training import trainer as JT
from test_torch_train_step import (GRAD_TOL, _close, check_updates, jax_rollout_draws,
                                   jax_score_draws)

KW = dict(num_frame_per_block=1, num_training_frames=3, slice_last_frames=3,
          dfake_gen_update_ratio=1, lr=1e-3, lr_critic=3e-4)
METRICS = ("generator_loss", "critic_loss", "generator_grad_norm", "critic_grad_norm",
           "dmdtrain_gradient_norm", "dmd_timestep_mean", "critic_timestep_mean")


def big_teacher_config(cfg):
    """The tiny teacher at twice the width and heads (head_dim kept), as
    ``tests/test_training.py``'s larger-teacher test builds it."""
    return dataclasses.replace(cfg, dim=2 * cfg.dim, num_heads=2 * cfg.num_heads,
                               ffn_dim=2 * cfg.ffn_dim)


@pytest.fixture(scope="module")
def models():
    jcfg = j_tiny()
    trees = [jax.tree.map(np.asarray, JD.init_dit_params(jax.random.PRNGKey(i), jcfg,
                                                         jnp.float32, zero_head=False))
             for i in range(3)]  # generator, critic, teacher
    big = jax.tree.map(np.asarray, JD.init_dit_params(jax.random.PRNGKey(9),
                                                      big_teacher_config(jcfg), jnp.float32,
                                                      zero_head=False))
    return jcfg, tiny_dit_config(), trees, big


def _inputs(cfg):
    geom = tiny_geometry()
    rng = np.random.default_rng(3)
    noise = rng.standard_normal((1, 3, geom.channels, geom.height, geom.width)).astype(np.float32)
    pe_c = rng.standard_normal((1, cfg.text_len, cfg.text_dim)).astype(np.float32)
    return noise, pe_c, (pe_c * 0.1).astype(np.float32)


def jax_step_draws(jtr, ttr, key, micro, noise):
    """The draws of the JAX trainer's micro-step ``micro`` (its key splits,
    ``train_step``) for the port's ``train_step``."""
    r = jax.random.fold_in(key, micro)
    r_exit, r_len, r_g, r_exit2, r_len2, r_c = jax.random.split(r, 6)
    jnoise = jnp.asarray(noise)

    def phase(r_exit, r_len, r_phase):
        exit_idx, nb, _ = jtr._sample_rollout_geometry(jnoise, r_exit, r_len)
        r_roll, r_second = jax.random.split(r_phase)
        t_from, t_to = jro.denoised_timestep_bounds(jtr.sched, jtr.rcfg, exit_idx)
        lo, hi = tdmd.score_timestep_range(ttr.dcfg, t_from, t_to)
        st, sn = jax_score_draws(r_second, (1, nb) + noise.shape[2:], lo, hi)
        return PhaseDraws(exit_idx, nb, jax_rollout_draws(r_roll, nb, exit_idx,
                                                          (1, 1) + noise.shape[2:]), st, sn)

    gen = phase(r_exit, r_len, r_g) if ttr.trains_generator(micro) else None
    return StepDraws(generator=gen, critic=phase(r_exit2, r_len2, r_c))


def build(models, jax_too=True, big_teacher=False, **options):
    """(JAX trainer or None, port trainer) on the same trees and options;
    ``big_teacher``: the teacher twice as wide."""
    jcfg, tcfg, (gen, critic, teach), big = models
    geom = tiny_geometry()
    jt_cfg = tt_cfg = None
    if big_teacher:
        teach, jt_cfg, tt_cfg = big, big_teacher_config(jcfg), big_teacher_config(tcfg)
    copy = lambda t: jax.tree.map(jnp.array, t)  # noqa: E731  (the JAX trainer donates)
    jtr = None
    if jax_too:
        jtr = JT.ScoreDistillationTrainer(
            JT.TrainerConfig(**KW, **options, attn_impl="xla"), jcfg, geom, copy(gen),
            copy(critic), copy(teach), teacher_cfg=jt_cfg)
    ttr = ScoreDistillationTrainer(TrainerConfig(**KW, **options), tcfg, geom,
                                   *(dit_params_from_jax(t) for t in (gen, critic, teach)),
                                   teacher_cfg=tt_cfg, device="cpu")
    return jtr, ttr


def run_steps(jtr, ttr, models, num_steps, draw_from=None, start=0):
    """Micro-steps ``start`` to ``start + num_steps`` of both trainers (the
    port alone when ``jtr`` is None, with the draws of ``draw_from``'s JAX
    trainer), the JAX trainer's draws replayed; losses and norms compared.
    Returns the port's metrics."""
    noise, pe_c, pe_u = _inputs(models[1])
    key = jax.random.PRNGKey(12)
    out = []
    for micro in range(start, start + num_steps):
        draws = jax_step_draws(jtr or draw_from, ttr, key, micro, noise)
        tm = ttr.train_step(torch.from_numpy(noise), torch.from_numpy(pe_c),
                            torch.from_numpy(pe_u), draws)
        if jtr is not None:
            jm = jtr.train_step(jnp.asarray(noise), jnp.asarray(pe_c), jnp.asarray(pe_u), key)
            assert set(k for k in METRICS if k in tm) == set(k for k in METRICS if k in jm)
            assert (tm["step"], tm["opt_step"]) == (jm["step"], jm["opt_step"])
            for k in METRICS:
                if k in jm:
                    _close(tm[k], jm[k], GRAD_TOL)
        out.append(tm)
    return out


def _trained(ttr):
    return [(k, dit_params_from_jax, map_tree(lambda t: t.detach().clone(), ttr.state[k]))
            for k in ("gen_params", "critic_params")]


def _same_state(a, b):
    for key in ("gen_params", "critic_params", "gen_lora", "critic_lora"):
        assert all(torch.equal(x, y) for x, y in zip(param_leaves(a.state[key]),
                                                     param_leaves(b.state[key]))), key


@pytest.mark.parametrize("scale", [0.01, 50.0], ids=["below the clip", "clipped"])
def test_host_adamw_step_matches_jax(scale):
    """Three ``host_adamw_step``s against the JAX package's numpy update,
    beta1 = 0 (as shipped) and 0.9: the norms, master copies and moments
    within 1e-6 relative (they come out bit for bit)."""
    rng = np.random.default_rng(2)
    shapes = [(5, 7), (7,), (3, 2, 4)]
    for b1 in (0.0, 0.9):
        params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        jst = JT.host_adamw_init(params)
        tst = host_adamw_init([torch.from_numpy(p) for p in params])
        kw = dict(lr=1e-2, b1=b1, b2=0.999, weight_decay=0.01, clip=10.0)
        for _ in range(3):
            grads = [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]
            _, jn = JT.host_adamw_step(jst, grads, **kw)
            tn = host_adamw_step(tst, [torch.from_numpy(g) for g in grads], **kw)
            np.testing.assert_allclose(tn, jn, rtol=1e-6)
            assert tst["t"] == jst["t"]
            for name in ("master", "m", "v"):
                for t, j in zip(tst[name], jst[name]):
                    np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, atol=1e-12)


def test_host_optimiser_trainers_match_jax(models):
    """Two steps (generator and critic on both) with ``opt_on_host`` and
    ``opt_async`` against the JAX trainer with the same options: losses and
    norms, the critic's lagged by one step in both (absent on step 0), and
    the change of every parameter.  The port's ``opt_on_host`` alone then
    gives the same bits, its critic norms one step earlier."""
    jtr, ttr = build(models, opt_on_host=True, opt_async=True)
    before = _trained(ttr)
    ms = run_steps(jtr, ttr, models, 2)
    assert "critic_grad_norm" not in ms[0] and "critic_grad_norm" in ms[1]
    late = ttr.finish_pending()
    assert set(late) == {"critic_grad_norm"} and ttr._pending is None
    _close(late["critic_grad_norm"], jtr.finish_pending()["critic_grad_norm"], GRAD_TOL)
    check_updates(jtr, ttr, before)
    _, sync = build(models, jax_too=False, opt_on_host=True)
    ms_sync = run_steps(None, sync, models, 2, draw_from=jtr)
    _same_state(sync, ttr)
    for key in ("gen_opt", "critic_opt"):
        assert sync.state[key]["t"] == ttr.state[key]["t"] == 2
        for name in ("m", "v", "master"):
            assert all(torch.equal(a, b) for a, b in zip(sync.state[key][name],
                                                          ttr.state[key][name]))
    assert [m["critic_loss"] for m in ms] == [m["critic_loss"] for m in ms_sync]
    assert ms[1]["critic_grad_norm"] == ms_sync[0]["critic_grad_norm"]
    assert late["critic_grad_norm"] == ms_sync[1]["critic_grad_norm"]


def test_gradient_accumulation_matches_jax(models):
    """``gradient_accumulation_steps=2`` against the JAX trainer
    (optax.MultiSteps): micro-step 0 changes no parameter, micro-step 1
    applies the mean of both micro-steps' gradients; both train the
    generator (optimiser step 0) and the EMA follows on the second."""
    jtr, ttr = build(models, gradient_accumulation_steps=2)
    before = _trained(ttr)
    ms = run_steps(jtr, ttr, models, 1)
    for key, _, p0 in before:
        assert all(torch.equal(a, b) for a, b in zip(param_leaves(ttr.state[key]),
                                                     param_leaves(p0))), key
    assert all(torch.equal(e, p) for e, p in zip(param_leaves(ttr.state["ema_params"]),
                                                 param_leaves(before[0][2])))
    ms += run_steps(jtr, ttr, models, 1, start=1)
    assert [m["opt_step"] for m in ms] == [0, 0] and all("generator_loss" in m for m in ms)
    check_updates(jtr, ttr, before)
    # before ema_start_step the EMA is a copy of the generator after the update
    assert all(torch.equal(e, p.detach()) for e, p in zip(
        param_leaves(ttr.state["ema_params"]), param_leaves(ttr.state["gen_params"])))


def test_opt_on_host_with_accumulation_and_other_guards_raise(models):
    """The JAX package's guards."""
    for options, err in ((dict(opt_on_host=True, gradient_accumulation_steps=2),
                          NotImplementedError),
                         (dict(opt_async=True), ValueError),
                         (dict(teacher_stream=True), ValueError),
                         (dict(page_generator=True), ValueError),
                         (dict(block_vjp=True), ValueError)):
        with pytest.raises(err):
            build(models, jax_too=False, **options)


@pytest.mark.parametrize("lora", [False, True], ids=["full", "lora"])
def test_paging_levers_change_no_bit(models, lora):
    """``staged_phases`` (the teacher, and under the critic's LoRA its base,
    in host memory between phases), ``page_generator`` and
    ``teacher_stream``, each against the resident trainer: two steps give
    the same losses, norms and parameters, bit for bit."""
    extra = dict(lora_rank=4, lora_alpha=4.0, lora_dtype="float32") if lora else {}
    draw_from, ref = build(models, **extra)
    ms_ref = run_steps(None, ref, models, 2, draw_from=draw_from)
    for options in (dict(staged_phases=True, page_generator=True),
                    dict(staged_phases=True, teacher_stream=True)):
        _, tr = build(models, jax_too=False, **extra, **options)
        ms = run_steps(None, tr, models, 2, draw_from=draw_from)
        assert [{k: m[k] for k in METRICS} for m in ms] == [
            {k: m[k] for k in METRICS} for m in ms_ref], options
        _same_state(tr, ref)
        if options.get("teacher_stream"):
            assert tr.teacher_params["blocks"][0]["ffn"]["fc1"]["weight"].device.type == "cpu"


def test_int8_rollout_cache_matches_jax(models):
    """Five one-frame blocks through a 4-frame cache stored int8 (K and V,
    per-token scales; ``RolloutConfig.cache_int8``) against the JAX
    package's int8 rollout: the latents within 1e-3 of max |ref| (the
    reading is 4.2e-5: both quantize K/V that agree to float32 rounding,
    and a code one side rounds the other way moves the later blocks), and
    the final cache's codes within one step of each other, at least 99%
    of them equal (99.86% read), their scales within 1e-3 relative.  The
    unquantized cache's latents stand
    5.1e-4 off: the quantization acts."""
    jcfg, tcfg, (gen, _, _), _ = models
    geom = tiny_geometry()
    jsched = JS.make_schedule(1000, shift=5.0, sigma_min=0.0, extra_one_step=True, training=True)
    tsched = TS.make_schedule(1000, shift=5.0, sigma_min=0.0, extra_one_step=True, training=True)
    steps = tuple(float(x) for x in JS.warp_denoising_steps(jsched, (1000, 750, 500, 250)))
    fs = geom.frame_seq_length
    rng = np.random.default_rng(0)
    shape = (1, 5, geom.channels, geom.height, geom.width)
    noise = rng.standard_normal(shape).astype(np.float32)
    pe = rng.standard_normal((1, tcfg.text_len, tcfg.text_dim)).astype(np.float32)
    key, exit_idx = jax.random.PRNGKey(7), 2
    jp = jax.tree.map(jnp.asarray, gen)
    jcross = JD.prepare_cross_kv(jp, jcfg, jnp.asarray(pe), jnp.float32)
    jr = jro.RolloutConfig(denoise_timesteps=steps, frame_block=1, attn_impl="xla",
                           window_frames=3, cache_int8=True)
    jl, jcache, _ = jro.rollout_trajectory(jp, jcfg, JCacheConfig(1, 3, fs),
                                           j_rope_tables(jcfg.head_dim, jcfg.rope_max_pos),
                                           jsched, jr, jnp.asarray(noise), jcross, key, exit_idx)
    tp = dit_params_from_jax(gen)
    tt = make_rope_tables(tcfg.head_dim, tcfg.rope_max_pos)
    draws = jax_rollout_draws(key, 5, exit_idx, (1, 1) + shape[2:])
    out = {}
    with torch.no_grad():
        cross = TD.prepare_cross_kv(tp, tcfg, torch.from_numpy(pe), torch.float32)
        for int8 in (True, False):
            tr = tro.RolloutConfig(denoise_timesteps=steps, frame_block=1, window_frames=3,
                                   cache_int8=int8)
            out[int8] = tro.rollout_trajectory(tp, tcfg, CacheConfig(1, 3, fs), tt, tsched, tr,
                                               torch.from_numpy(noise), cross, draws, exit_idx)
    lat, cache = out[True]
    want = np.asarray(jl)
    err = np.abs(lat.numpy() - want).max() / np.abs(want).max()
    gap = np.abs(out[False][0].numpy() - want).max() / np.abs(want).max()
    print(f"int8 rollout cache: max |port - JAX| / max |JAX| = {err:.3e}; the bf16 cache's "
          f"latents differ by {gap:.3e}")
    assert err <= 1e-3 and gap > 10 * err
    assert cache.k.dtype == cache.v.dtype == torch.int8
    k, v = tkvc.to_standard_layout(cache)
    for got, ref in ((k, jcache.k), (v, jcache.v)):
        diff = np.abs(got.numpy().astype(np.int32) - np.asarray(ref).astype(np.int32))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
    for got, ref in ((cache.k_scale, jcache.k_scale), (cache.v_scale, jcache.v_scale)):
        np.testing.assert_allclose(got.transpose(2, 3).numpy(), np.asarray(ref), rtol=1e-3)


def test_host_optimiser_checkpoint_round_trip(models, tmp_path):
    """A host-optimiser trainer's ``state_dict`` after one step, saved and
    loaded into a fresh trainer: the host AdamW states come back equal,
    and the next step of both is bit for bit the same."""
    draw_from, tr = build(models, opt_on_host=True, opt_async=True)
    run_steps(None, tr, models, 1, draw_from=draw_from)
    path = tmp_path / "state.pt"
    torch.save(tr.state_dict(), path)
    _, tr2 = build(models, jax_too=False, opt_on_host=True, opt_async=True)
    tr2.load_state_dict(torch.load(path, weights_only=False))
    for key in ("gen_opt", "critic_opt"):
        assert tr2.state[key]["t"] == tr.state[key]["t"] == 1
        for name in ("m", "v", "master"):
            assert all(torch.equal(a, b) for a, b in zip(tr2.state[key][name],
                                                          tr.state[key][name]))
    noise, pe_c, pe_u = _inputs(models[1])
    d = jax_step_draws(draw_from, tr, jax.random.PRNGKey(12), 1, noise)
    a, b = (t.train_step(torch.from_numpy(noise), torch.from_numpy(pe_c),
                         torch.from_numpy(pe_u), d) for t in (tr, tr2))
    assert a["critic_loss"] == b["critic_loss"] and a["generator_loss"] == b["generator_loss"]
    tr.finish_pending()
    tr2.finish_pending()
    _same_state(tr, tr2)


def test_ema_refresh_and_restore_in_place(models):
    """Before ``ema_start_step`` the EMA refresh copies the generator into
    the EMA's own host tensors (no second host copy of the tree beside the
    first), and ``load_state_dict`` restores the EMA into them too, keeping
    no tensor of the checkpoint's."""
    _, tr = build(models, jax_too=False)
    ema = param_leaves(tr.state["ema_params"])
    gen = param_leaves(tr.state["gen_params"])
    with torch.no_grad():
        for p in gen:
            p.add_(0.5)
    tr._update_ema(0)
    assert all(a is b for a, b in zip(param_leaves(tr.state["ema_params"]), ema))
    assert all(torch.equal(e, p.detach()) and not e.requires_grad for e, p in zip(ema, gen))
    sd = tr.state_dict()
    sd["ema_params"] = map_tree(lambda t: t - 1.0, sd["ema_params"])
    tr.load_state_dict(sd)
    got = param_leaves(tr.state["ema_params"])
    assert all(a is b for a, b in zip(got, ema))
    assert all(torch.equal(e, p.detach() - 1.0) for e, p in zip(got, gen))
    assert not any(a is b for a, b in zip(got, param_leaves(sd["ema_params"])))
