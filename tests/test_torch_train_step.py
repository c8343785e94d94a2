"""The training step of the port held against the JAX package at the tiny
config, float32 on the CPU, with the JAX package's random draws replayed:
the rollout (latents, and generator gradients of sum(latents * w) through
the per-block backward), the DMD and critic losses (values and
gradients), AdamW after the global-norm clip against optax, and two
``ScoreDistillationTrainer.train_step``s against the JAX trainer's
monolithic step (one graph over the whole rollout), which holds the port's
per-block generator backward to it."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from longlive_torch.config import CacheConfig, tiny_dit_config, tiny_geometry
from longlive_torch.models import dit as TD
from longlive_torch.ops import scheduler as TS
from longlive_torch.ops.rope import make_rope_tables
from longlive_torch.training import dmd as tdmd
from longlive_torch.training import rollout as tro
from longlive_torch.training.trainer import (PhaseDraws, ScoreDistillationTrainer, StepDraws,
                                             TrainerConfig, param_leaves)
from longlive_torch.utils.params import dit_params_from_jax
from longlive_tpu.config import CacheConfig as JCacheConfig
from longlive_tpu.config import tiny_dit_config as j_tiny
from longlive_tpu.models import dit as JD
from longlive_tpu.ops import scheduler as JS
from longlive_tpu.ops.rope import make_rope_tables as j_rope_tables
from longlive_tpu.training import dmd as jdmd
from longlive_tpu.training import rollout as jro
from longlive_tpu.training.trainer import ScoreDistillationTrainer as JTrainer
from longlive_tpu.training.trainer import TrainerConfig as JTrainerConfig

RTOL, ATOL = 1e-4, 1e-4  # float32 end to end; summation order differs
GRAD_TOL = 5e-4           # gradients through a whole rollout: longer chains of sums
UPDATE_TOL = 1e-3         # each leaf's change over the steps, relative to its norm


@pytest.fixture(scope="module")
def models():
    jcfg = j_tiny()
    trees = [jax.tree.map(np.asarray, JD.init_dit_params(jax.random.PRNGKey(i), jcfg,
                                                         jnp.float32, zero_head=False))
             for i in range(3)]  # generator, critic, teacher
    return jcfg, tiny_dit_config(), trees


def _sched():
    kw = dict(shift=5.0, sigma_min=0.0, extra_one_step=True, training=True)
    return JS.make_schedule(1000, **kw), TS.make_schedule(1000, **kw)


def _close(got, want, tol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _leaf_close(tparams, jgrads, tol):
    """Port parameter gradients against a JAX gradient tree."""
    jt = dit_params_from_jax(jax.tree.map(np.asarray, jgrads))
    for got, want in zip(param_leaves(tparams), param_leaves(jt)):
        g = np.zeros(got.shape, np.float32) if got.grad is None else got.grad.numpy()
        w = want.numpy()
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * max(np.abs(w).max(), 1e-3))


def _by_path(tree, path=""):
    """{path: tensor} of a parameter tree (the JAX trees' dicts come back
    with sorted keys, so leaves are matched by path, not by order)."""
    if isinstance(tree, dict):
        return {p: t for k, v in tree.items() for p, t in _by_path(v, f"{path}/{k}").items()}
    if isinstance(tree, list):
        return {p: t for i, v in enumerate(tree) for p, t in _by_path(v, f"{path}/{i}").items()}
    return {path: tree}


def check_updates(jtr, ttr, trees):
    """Each trained tree's change over the steps against the JAX trainer's,
    leaf by leaf within UPDATE_TOL of the change's norm.  ``trees``: (state
    key, the converter of the JAX tree, the port's tree before the steps)."""
    for key, convert, before in trees:
        want = _by_path(convert(jax.tree.map(np.asarray, jtr.state[key])))
        got, p0 = _by_path(ttr.state[key]), _by_path(before)
        assert set(got) == set(want) == set(p0)
        for path, w in want.items():
            d_got, d_want = got[path].detach() - p0[path], w - p0[path]
            err = ((d_got - d_want).norm() / d_want.norm()).item()
            assert err <= UPDATE_TOL, f"{key}{path}: change off by {err:.2e} (relative)"


def jax_rollout_draws(rng, num_blocks, exit_idx, block_shape):
    """The re-noise draws ``rollout_trajectory`` makes from ``rng``: per
    block, one split per pre-exit step and one for the commit, the chain
    running on across blocks."""
    out = []
    for _ in range(num_blocks):
        row = []
        for _ in range(exit_idx + 1):
            rng, sub = jax.random.split(rng)
            row.append(np.asarray(jax.random.normal(sub, block_shape, jnp.float32)))
        out.append(row)
    return torch.from_numpy(np.array(out))


def jax_score_draws(rng, shape, lo, hi):
    """(score_t [B], score_noise) as ``_score_noisy`` /
    ``critic_denoising_loss`` draw them from ``rng``."""
    rng_t, rng_n = jax.random.split(rng)
    t = jax.random.randint(rng_t, (shape[0], 1), lo, hi)[:, 0]
    n = jax.random.normal(rng_n, shape, jnp.float32)
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(n))


def _requires_grad(tparams):
    for t in param_leaves(tparams):
        t.requires_grad_(True)
    return tparams


def test_rollout_latents_and_gradients_match_jax(models):
    """Five one-frame blocks through a 4-frame cache with a 3-frame window,
    exit step 2: the latents, then the generator gradients of
    sum(latents * w) (the port's per-block backward with the cross K/V as a
    leaf, against jax.grad over the whole rollout)."""
    _check_rollout(models, context_noise=0.0)


@pytest.mark.parametrize("context_noise", [100.0])
def test_rollout_with_context_noise_matches_jax(models, context_noise):
    """The same rollout with each block's commit re-run on its prediction
    noised to ``context_noise`` (the shipped configs set 0), the commit's
    draw replayed."""
    _check_rollout(models, context_noise=context_noise)


def _check_rollout(models, context_noise):
    jcfg, tcfg, (gen, _, _) = models
    geom = tiny_geometry()
    jsched, tsched = _sched()
    steps = tuple(float(x) for x in JS.warp_denoising_steps(jsched, (1000, 750, 500, 250)))
    jr = jro.RolloutConfig(denoise_timesteps=steps, frame_block=1, attn_impl="xla",
                           window_frames=3, context_noise=context_noise)
    tr = tro.RolloutConfig(denoise_timesteps=steps, frame_block=1, window_frames=3,
                           context_noise=context_noise)
    fs = geom.frame_seq_length
    jcc, tcc = JCacheConfig(1, 3, fs), CacheConfig(1, 3, fs)
    jt, tt = j_rope_tables(jcfg.head_dim, jcfg.rope_max_pos), make_rope_tables(tcfg.head_dim,
                                                                                 tcfg.rope_max_pos)
    rng = np.random.default_rng(0)
    shape = (1, 5, geom.channels, geom.height, geom.width)
    noise = rng.standard_normal(shape).astype(np.float32)
    pe = rng.standard_normal((1, tcfg.text_len, tcfg.text_dim)).astype(np.float32)
    w = rng.standard_normal(shape).astype(np.float32)
    key, exit_idx = jax.random.PRNGKey(7), 2
    jp = jax.tree.map(jnp.asarray, gen)

    def jlat(p):
        cross = JD.prepare_cross_kv(p, jcfg, jnp.asarray(pe), jnp.float32)
        return jro.rollout_trajectory(p, jcfg, jcc, jt, jsched, jr, jnp.asarray(noise), cross,
                                      key, exit_idx)[0]

    jl, jvjp = jax.vjp(jlat, jp)
    (jg,) = jvjp(jnp.asarray(w))
    draws = jax_rollout_draws(key, 5, exit_idx, (1, 1) + shape[2:])

    tp = _requires_grad(dit_params_from_jax(gen))
    cross = TD.prepare_cross_kv(tp, tcfg, torch.from_numpy(pe), torch.float32)
    with torch.no_grad():
        tl, _ = tro.rollout_trajectory(tp, tcfg, tcc, tt, tsched, tr, torch.from_numpy(noise),
                                       cross, draws, exit_idx)
    _close(tl, jl)
    leaf = TD.CrossKV(cross.k.detach().requires_grad_(), cross.v.detach().requires_grad_())
    tl2, _ = tro.rollout_trajectory(tp, tcfg, tcc, tt, tsched, tr, torch.from_numpy(noise), leaf,
                                    draws, exit_idx, cotangent=torch.from_numpy(w))
    torch.autograd.backward([cross.k, cross.v], [leaf.k.grad, leaf.v.grad])
    assert torch.equal(tl2, tl)
    _leaf_close(tp, jg, GRAD_TOL)


def test_dmd_and_critic_losses_match_jax(models):
    """distribution_matching_loss (value and d/dlatents; with the teacher
    in the loss, and with teacher_real_x0 precomputed) and
    critic_denoising_loss (value and the critic's parameter gradients)."""
    jcfg, tcfg, (_, critic, teacher) = models
    geom = tiny_geometry()
    jsched, tsched = _sched()
    jt, tt = j_rope_tables(jcfg.head_dim, jcfg.rope_max_pos), make_rope_tables(tcfg.head_dim,
                                                                                 tcfg.rope_max_pos)
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((1, 3, geom.channels, geom.height, geom.width)).astype(np.float32)
    pe_c = rng.standard_normal((1, tcfg.text_len, tcfg.text_dim)).astype(np.float32)
    pe_u = (pe_c * 0.1).astype(np.float32)
    jdc, tdc = jdmd.DMDConfig(timestep_shift=5.0), tdmd.DMDConfig(timestep_shift=5.0)
    jc, jtch = (jax.tree.map(jnp.asarray, t) for t in (critic, teacher))
    tc, ttch = dit_params_from_jax(critic), dit_params_from_jax(teacher)

    key = jax.random.PRNGKey(9)
    (jloss, jaux), jdl = jax.value_and_grad(
        lambda l: jdmd.distribution_matching_loss(l, jc, jtch, jcfg, jt, jsched, jdc,
                                                  jnp.asarray(pe_c), jnp.asarray(pe_u), key,
                                                  attn_impl="xla"), has_aux=True)(jnp.asarray(lat))
    st, sn = jax_score_draws(key, lat.shape, *tdmd.score_timestep_range(tdc, None, None))
    for real_x0 in (None, tdmd.teacher_real_x0(ttch, tcfg, tt, tsched, tdc, torch.from_numpy(lat),
                                               torch.from_numpy(pe_c), torch.from_numpy(pe_u),
                                               st, sn)):
        tl = torch.from_numpy(lat).requires_grad_()
        loss, aux = tdmd.distribution_matching_loss(
            tl, tc, ttch, tcfg, tt, tsched, tdc, torch.from_numpy(pe_c), torch.from_numpy(pe_u),
            st, sn, real_x0=real_x0)
        loss.backward()
        _close(loss.item(), jloss)
        _close(tl.grad, jdl)
        for k in ("dmdtrain_gradient_norm", "dmd_timestep_mean"):
            _close(aux[k].item(), jaux[k])

    key = jax.random.PRNGKey(10)
    (jcl, jcaux), jcg = jax.value_and_grad(
        lambda p: jdmd.critic_denoising_loss(p, jnp.asarray(lat), jcfg, jt, jsched, jdc,
                                             jnp.asarray(pe_c), key, attn_impl="xla"),
        has_aux=True)(jc)
    st, sn = jax_score_draws(key, lat.shape, *tdmd.score_timestep_range(tdc, None, None))
    _requires_grad(tc)
    closs, caux = tdmd.critic_denoising_loss(tc, torch.from_numpy(lat), tcfg, tt, tsched, tdc,
                                             torch.from_numpy(pe_c), st, sn)
    closs.backward()
    _close(closs.item(), jcl)
    _close(caux["critic_timestep_mean"].item(), jcaux["critic_timestep_mean"])
    _leaf_close(tc, jcg, GRAD_TOL)


@pytest.mark.parametrize("scale", [0.01, 50.0], ids=["below the clip", "clipped"])
def test_adamw_after_clip_matches_optax(scale):
    """clip_grad_norm_ + torch.optim.AdamW against optax.chain(
    clip_by_global_norm, adamw) over three updates: eps outside the square
    root, decoupled weight decay, bias correction (beta1 = 0 as shipped,
    and 0.9)."""
    rng = np.random.default_rng(2)
    shapes = [(5, 7), (7,), (3, 2, 4)]
    for b1 in (0.0, 0.9):
        params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        tx = optax.chain(optax.clip_by_global_norm(10.0),
                         optax.adamw(1e-2, b1=b1, b2=0.999, weight_decay=0.01))
        jp = [jnp.asarray(p) for p in params]
        st = tx.init(jp)
        tp = [torch.from_numpy(p.copy()).requires_grad_() for p in params]
        opt = torch.optim.AdamW(tp, lr=1e-2, betas=(b1, 0.999), eps=1e-8, weight_decay=0.01)
        for _ in range(3):
            grads = [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]
            upd, st = tx.update([jnp.asarray(g) for g in grads], st, jp)
            jp = optax.apply_updates(jp, upd)
            for t, g in zip(tp, grads):
                t.grad = torch.from_numpy(g.copy())  # the clip scales in place
            norm = torch.nn.utils.clip_grad_norm_(tp, 10.0)
            opt.step()
            _close(norm.item(), optax.global_norm([jnp.asarray(g) for g in grads]), 1e-5)
            for t, j in zip(tp, jp):
                _close(t.detach(), j, 1e-5)


def test_two_train_steps_match_jax_trainer(models):
    """Two steps with dfake_gen_update_ratio = 1 (generator and critic on
    both), the JAX trainer's draws replayed: losses, grad norms and the
    change of every generator and critic parameter.  The learning rates are
    raised (and kept apart) so that the change dominates float32 rounding:
    at the shipped 2e-6 an update of ~lr is below the parameters' own
    tolerance, and a missing, negated or misrouted update would pass."""
    _check_train_steps(models, 2)


@pytest.mark.parametrize("options", [dict(ts_schedule=True, ts_schedule_max=True),
                                     dict(ts_schedule=True)],
                         ids=["ts_schedule and ts_schedule_max", "ts_schedule"])
def test_train_step_options_match_jax_trainer(models, options):
    """One step as above with the score timesteps drawn inside the
    rollout's denoised range (``ts_schedule``: from its lower end;
    ``ts_schedule_max``: up to its upper end): the port's draws come from
    its own ``score_timestep_range``, so a wrong range departs from the JAX
    trainer's draws in the losses, the grad norms and the timestep means.
    The parameters' change is held by the test above: after one AdamW step
    it is +-lr wherever |grad| >> eps, and a few elements with |grad| near
    eps (1e-8) make it hang on float32 roundoff of those gradients."""
    _check_train_steps(models, 1, check_updates=False, **options)


def _check_train_steps(models, num_steps, check_updates=True, **options):
    jcfg, tcfg, (gen, critic, teacher) = models
    geom = tiny_geometry()
    kw = dict(num_frame_per_block=1, num_training_frames=3, slice_last_frames=3,
              dfake_gen_update_ratio=1, lr=1e-3, lr_critic=3e-4, **options)
    copy = lambda t: jax.tree.map(jnp.array, t)  # noqa: E731  (the JAX trainer donates)
    jtr = JTrainer(JTrainerConfig(**kw, attn_impl="xla"), jcfg, geom, copy(gen), copy(critic),
                   copy(teacher))
    ttr = ScoreDistillationTrainer(TrainerConfig(**kw), tcfg, geom, dit_params_from_jax(gen),
                                   dit_params_from_jax(critic), dit_params_from_jax(teacher),
                                   device="cpu")
    rng = np.random.default_rng(3)
    noise = rng.standard_normal((1, 3, geom.channels, geom.height, geom.width)).astype(np.float32)
    pe_c = rng.standard_normal((1, tcfg.text_len, tcfg.text_dim)).astype(np.float32)
    pe_u = (pe_c * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(12)
    jnoise = jnp.asarray(noise)
    ranges = []
    for micro in range(num_steps):
        # the JAX trainer's key splits (trainer.py train_step)
        r = jax.random.fold_in(key, micro)
        r_exit, r_len, r_g, r_exit2, r_len2, r_c = jax.random.split(r, 6)

        def phase(r_exit, r_len, r_phase):
            exit_idx, nb, _ = jtr._sample_rollout_geometry(jnoise, r_exit, r_len)
            r_roll, r_second = jax.random.split(r_phase)
            t_from, t_to = jro.denoised_timestep_bounds(jtr.sched, jtr.rcfg, exit_idx)
            lo, hi = tdmd.score_timestep_range(ttr.dcfg, t_from, t_to)
            ranges.append((lo, hi))
            st, sn = jax_score_draws(r_second, (1, nb) + noise.shape[2:], lo, hi)
            return PhaseDraws(exit_idx, nb,
                              jax_rollout_draws(r_roll, nb, exit_idx, (1, 1) + noise.shape[2:]),
                              st, sn)

        draws = StepDraws(generator=phase(r_exit, r_len, r_g), critic=phase(r_exit2, r_len2, r_c))
        jm = jtr.train_step(jnoise, jnp.asarray(pe_c), jnp.asarray(pe_u), key)
        tm = ttr.train_step(torch.from_numpy(noise), torch.from_numpy(pe_c),
                            torch.from_numpy(pe_u), draws)
        assert (tm["exit_idx"], tm["critic_exit_idx"]) == (jm["exit_idx"], jm["critic_exit_idx"])
        for k in ("generator_loss", "critic_loss", "generator_grad_norm", "critic_grad_norm",
                  "dmdtrain_gradient_norm", "dmd_timestep_mean", "critic_timestep_mean"):
            _close(tm[k], jm[k], GRAD_TOL)
    for key_, init in (("gen_params", gen), ("critic_params", critic)) if check_updates else ():
        want = dit_params_from_jax(jax.tree.map(np.asarray, jtr.state[key_]))
        leaves = zip(param_leaves(ttr.state[key_]), param_leaves(want),
                     param_leaves(dit_params_from_jax(init)))
        for i, (got, w, p0) in enumerate(leaves):
            d_got, d_want = got.detach() - p0, w - p0
            err = ((d_got - d_want).norm() / d_want.norm()).item()
            assert err <= UPDATE_TOL, f"{key_} leaf {i}: change off by {err:.2e} (relative)"
    assert ttr.state["step"] == num_steps
    full = (ttr.dcfg.min_score_timestep, ttr.dcfg.num_train_timestep)
    assert any(r != full for r in ranges) == bool(options.get("ts_schedule")
                                                  or options.get("ts_schedule_max"))


@pytest.mark.parametrize("loss_type", ["x0", "v", "noise", "flow"])
def test_denoising_loss_variants_match_jax(loss_type):
    """The denoising-loss family on the same arrays, with and without a
    frame mask (the shipped configs use 'flow')."""
    jsched, tsched = _sched()
    rng = np.random.default_rng(4)
    x, xp, noise, xt, fp = (rng.standard_normal((2, 3, 4, 8, 8)).astype(np.float32)
                            for _ in range(5))
    t = np.asarray([[700.0] * 3, [120.0] * 3], np.float32)[..., None, None, None]
    mask = np.asarray([[True, False, True], [True, True, False]])
    for m in (None, mask):
        jl = jdmd.denoising_loss(loss_type, jsched, *(jnp.asarray(a) for a in (x, xp, noise, xt)),
                                 jnp.asarray(t), jnp.asarray(fp),
                                 None if m is None else jnp.asarray(m))
        tl = tdmd.denoising_loss(loss_type, tsched, *(torch.from_numpy(a) for a in (x, xp, noise, xt)),
                                 torch.from_numpy(t), torch.from_numpy(fp),
                                 None if m is None else torch.from_numpy(m))
        _close(tl.item(), jl, 1e-5)
