"""LoRA training of the port held against the JAX package (tiny config,
float32 on the CPU, the adapters carried across by
``utils.params.lora_params_from_jax``): the adapters' init, the LoRA
linear against the merged weights, the cached and bidirectional DiT
forwards with adapters attached, the adapters' gradients, the PEFT
converters and two LoRA steps of the batch trainer, the JAX package's
draws replayed (the LoRA streaming steps are in
``tests/test_torch_streaming.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longlive_torch.config import CacheConfig, tiny_dit_config, tiny_geometry
from longlive_torch.models import dit as TD
from longlive_torch.models import nn as TN
from longlive_torch.models.dit_bidirectional import bidirectional_forward
from longlive_torch.ops import kv_cache as TK
from longlive_torch.ops.rope import make_rope_tables
from longlive_torch.training import dmd as tdmd
from longlive_torch.training import lora as TL
from longlive_torch.training.trainer import (PhaseDraws, ScoreDistillationTrainer, StepDraws,
                                             TrainerConfig, map_tree, param_leaves)
from longlive_torch.utils import checkpoint as TC
from longlive_torch.utils.params import dit_params_from_jax, lora_params_from_jax
from longlive_tpu.config import CacheConfig as JCacheConfig
from longlive_tpu.config import tiny_dit_config as j_tiny
from longlive_tpu.models import dit as JD
from longlive_tpu.models.dit_bidirectional import bidirectional_forward as j_bidi
from longlive_tpu.ops import kv_cache as JK
from longlive_tpu.ops.rope import make_rope_tables as j_rope_tables
from longlive_tpu.training import lora as JL
from longlive_tpu.training import rollout as jro
from longlive_tpu.training.trainer import ScoreDistillationTrainer as JTrainer
from longlive_tpu.training.trainer import TrainerConfig as JTrainerConfig
from longlive_tpu.utils import checkpoint as JC
from test_torch_train_step import (GRAD_TOL, RTOL, _close, check_updates, jax_rollout_draws,
                                   jax_score_draws)

SCALE = 0.5  # alpha / rank of the forwards below


@pytest.fixture(scope="module")
def adapters():
    """A tiny generator and rank-4 adapters with a non-zero B (so that A's
    gradient and the delta are non-zero), as JAX trees with numpy leaves."""
    jcfg = j_tiny()
    params = JD.init_dit_params(jax.random.PRNGKey(0), jcfg, jnp.float32, zero_head=False)
    lora = JL.init_lora(jax.random.PRNGKey(3), params, rank=4)
    lora = jax.tree.map(lambda x: x + 0.1 * jax.random.normal(jax.random.PRNGKey(4), x.shape),
                        lora)
    return jcfg, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, lora)


def _port(tree, lora):
    tp = dit_params_from_jax(tree)
    tl = lora_params_from_jax(lora)
    return tp, tl, TL.attach_lora(tp, tl, SCALE)


def _jax(tree, lora):
    jp = jax.tree.map(jnp.asarray, tree)
    return JL.attach_lora(jp, jax.tree.map(jnp.asarray, lora), SCALE)


def test_init_lora_shapes_bound_and_zero_b():
    """Every attention and FFN linear of every layer gets A [r, d_in]
    uniform within 1/sqrt(d_in) and B [d_out, r] zeros, in the requested
    dtype; as many parameters as the JAX package's adapters."""
    cfg = tiny_dit_config()
    params = TD.init_dit_params(cfg, torch.float32, "cpu", seed=0, zero_head=False)
    lora = TL.init_lora(params, rank=4, dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0))
    assert len(lora) == cfg.num_layers
    for blk, lyr in zip(params["blocks"], lora):
        assert {g: set(lg) for g, lg in lyr.items()} == {
            "self_attn": {"q", "k", "v", "o"}, "cross_attn": {"q", "k", "v", "o"},
            "ffn": {"fc1", "fc2"}}
        for g, lg in lyr.items():
            for n, ab in lg.items():
                d_out, d_in = blk[g][n]["weight"].shape
                a, b = ab["lora_a"], ab["lora_b"]
                assert a.shape == (4, d_in) and b.shape == (d_out, 4)
                assert a.dtype == b.dtype == torch.bfloat16
                assert a.float().abs().max() <= 1 / np.sqrt(d_in) and a.float().std() > 0
                assert not b.any()
    jparams = JD.init_dit_params(jax.random.PRNGKey(0), j_tiny(), jnp.float32, zero_head=False)
    assert TL.lora_params_count(lora) == JL.lora_params_count(
        JL.init_lora(jax.random.PRNGKey(1), jparams, rank=4))


def test_lora_linear_equals_the_merged_weights(adapters):
    """``nn.linear`` with adapters attached against ``nn.linear`` on
    ``merge_lora``'s weights, and merge_lora against the JAX package's."""
    _, tree, lora = adapters
    tp, tl, attached = _port(tree, lora)
    merged = TL.merge_lora(tp, tl, SCALE)
    x = torch.from_numpy(np.random.default_rng(30).standard_normal((2, 5, 96)).astype(np.float32))
    for g, n in (("self_attn", "q"), ("cross_attn", "v"), ("ffn", "fc1")):
        p_att, p_mer = attached["blocks"][1][g][n], merged["blocks"][1][g][n]
        torch.testing.assert_close(TN.linear(x, p_att), TN.linear(x, p_mer), rtol=1e-6,
                                   atol=1e-6)
        assert not torch.equal(p_mer["weight"], tp["blocks"][1][g][n]["weight"])
    jm = jax.tree.map(np.asarray, JL.merge_lora(jax.tree.map(jnp.asarray, tree),
                                                jax.tree.map(jnp.asarray, lora), SCALE))
    for got, want in zip(param_leaves(merged), param_leaves(dit_params_from_jax(jm))):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def test_cached_forward_with_adapters_matches_jax(adapters):
    """Two blocks of the cached forward (a denoise pass, then the commit)
    with adapters attached, flows and cache against the JAX package's."""
    jcfg, tree, lora = adapters
    tcfg, geom = tiny_dit_config(), tiny_geometry()
    _, _, tparams = _port(tree, lora)
    jparams = _jax(tree, lora)
    fs = geom.frame_seq_length
    tcc, jcc = CacheConfig(1, 3, fs), JCacheConfig(1, 3, fs)
    tt, jt = make_rope_tables(tcfg.head_dim, tcfg.rope_max_pos), j_rope_tables(
        jcfg.head_dim, jcfg.rope_max_pos)
    rng = np.random.default_rng(31)
    pe = rng.standard_normal((1, tcfg.text_len, tcfg.text_dim)).astype(np.float32)
    tcross = TD.prepare_cross_kv(tparams, tcfg, torch.from_numpy(pe), torch.float32)
    jcross = JD.prepare_cross_kv(jparams, jcfg, jnp.asarray(pe), jnp.float32)
    _close(tcross.k, jcross.k)
    L, N, hd = tcfg.num_layers, tcfg.num_heads, tcfg.head_dim
    tcache = TK.init_cache(tcc, L, 1, N, hd, torch.float32)
    jcache = JK.init_cache(jcc, L, 1, N, hd, jnp.float32)
    for start in range(2):
        for t_val, commit in ((750.0, False), (0.0, True)):
            x = rng.standard_normal((1, 1, geom.channels, geom.height, geom.width)).astype(
                np.float32)
            t = np.full((1, 1), t_val, np.float32)
            jflow, jcache = JD.dit_forward_cached(
                jparams, jcfg, jcc, jt, jnp.asarray(x), jnp.asarray(t), jcross, jcache,
                jnp.asarray(start, jnp.int32), advance_counters=commit, kv_only=commit)
            tflow, tcache = TD.dit_forward_cached(
                tparams, tcfg, tcc, tt, torch.from_numpy(x), torch.from_numpy(t), tcross, tcache,
                start, advance_counters=commit, kv_only=commit)
            _close(tflow, jflow)
    k, v = TK.to_standard_layout(tcache)
    _close(k, jcache.k)
    _close(v, jcache.v)


def test_bidirectional_forward_and_adapter_gradients_match_jax(adapters):
    """The bidirectional forward (the critic's and teacher's) with adapters
    attached, and the gradients of sum(flow * w) with respect to every
    adapter (through the cross-attention K/V too) against jax.grad."""
    jcfg, tree, lora = adapters
    tcfg, geom = tiny_dit_config(), tiny_geometry()
    tp, tl, _ = _port(tree, lora)
    tt, jt = make_rope_tables(tcfg.head_dim, tcfg.rope_max_pos), j_rope_tables(
        jcfg.head_dim, jcfg.rope_max_pos)
    rng = np.random.default_rng(32)
    pe = rng.standard_normal((2, tcfg.text_len, tcfg.text_dim)).astype(np.float32)
    x = rng.standard_normal((2, 3, geom.channels, geom.height, geom.width)).astype(np.float32)
    t = np.asarray([500.0, 125.0], np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree)

    def jloss(lo):
        p = JL.attach_lora(jp, lo, SCALE)
        cross = JD.prepare_cross_kv(p, jcfg, jnp.asarray(pe), jnp.float32)
        flow = j_bidi(p, jcfg, jt, jnp.asarray(x), jnp.asarray(t), cross, attn_impl="xla",
                      remat_layers=True)
        return jnp.sum(flow * w), flow

    (_, jflow), jg = jax.value_and_grad(jloss, has_aux=True)(jax.tree.map(jnp.asarray, lora))
    for t_ in param_leaves(tl):
        t_.requires_grad_(True)
    p = TL.attach_lora(tp, tl, SCALE)
    cross = TD.prepare_cross_kv(p, tcfg, torch.from_numpy(pe), torch.float32)
    flow = bidirectional_forward(p, tcfg, tt, torch.from_numpy(x), torch.from_numpy(t), cross,
                                 attn_impl="train_auto", remat_layers=True)
    (flow * torch.from_numpy(w)).sum().backward()
    _close(flow.detach(), jflow)
    want = lora_params_from_jax(jax.tree.map(np.asarray, jg))
    for got, wt in zip(param_leaves(tl), param_leaves(want)):
        w_ = wt.numpy()
        assert got.grad is not None
        np.testing.assert_allclose(got.grad.numpy(), w_, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * max(np.abs(w_).max(), 1e-3))
    assert all(g.grad.abs().max() > 0 for g in param_leaves(tl))


@pytest.mark.parametrize("layout", ["halfsplit", "interleaved"])
def test_peft_converters_bit_equal_to_jax(adapters, layout):
    """lora_to_peft_sd (the same keys, bit-equal values) and peft_sd_to_lora
    (bit-equal adapters, from the reference's ``.default`` key variant too)
    against the JAX package's, under both RoPE layouts (halfsplit permutes
    the self-attention q/k adapters' B rows)."""
    import dataclasses

    jcfg, _, lora = adapters
    jcfg = dataclasses.replace(jcfg, rope_layout=layout)
    tcfg = dataclasses.replace(tiny_dit_config(), rope_layout=layout)
    want = JC.lora_to_peft_sd(lora, jcfg)
    got = TC.lora_to_peft_sd(lora_params_from_jax(lora), tcfg)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v)
    sd = {k.replace(".weight", ".default.weight"): torch.from_numpy(v) for k, v in want.items()}
    back_j = lora_params_from_jax(jax.tree.map(np.asarray, JC.peft_sd_to_lora(sd, jcfg)))
    back_t = TC.peft_sd_to_lora(sd, tcfg)
    assert [{g: set(lg) for g, lg in lyr.items()} for lyr in back_t] == [
        {g: set(lg) for g, lg in lyr.items()} for lyr in back_j]
    for lt, lj, lo in zip(back_t, back_j, lora_params_from_jax(lora)):
        for g, lg in lj.items():
            for n, ab in lg.items():
                for which in ("lora_a", "lora_b"):
                    assert torch.equal(lt[g][n][which], ab[which])
                    assert torch.equal(lt[g][n][which], lo[g][n][which])


def _copy_adapters(dst, src):
    with torch.no_grad():
        for d, s in zip(dst, src):
            for g, lg in s.items():
                for n, ab in lg.items():
                    for which, t in ab.items():
                        d[g][n][which].copy_(t)


def test_two_lora_train_steps_match_jax_trainer():
    """Two batch-trainer steps with rank-4 adapters on the generator and the
    critic (alpha 4, float32 adapters; ratio 1: both models on both steps),
    the JAX trainer's adapters and draws replayed: losses and grad norms
    within GRAD_TOL, each adapter's change within UPDATE_TOL, the bases
    untouched.  Step 0 moves only B (A's gradient carries B = 0); step 1
    moves both."""
    geom = tiny_geometry()
    jcfg, tcfg = j_tiny(), tiny_dit_config()
    trees = [jax.tree.map(np.asarray, JD.init_dit_params(jax.random.PRNGKey(i), jcfg,
                                                         jnp.float32, zero_head=False))
             for i in range(3)]
    kw = dict(num_frame_per_block=1, num_training_frames=3, slice_last_frames=3,
              dfake_gen_update_ratio=1, lr=1e-3, lr_critic=3e-4, lora_rank=4, lora_alpha=4.0,
              lora_dtype="float32")
    copy = lambda t: jax.tree.map(jnp.array, t)  # noqa: E731
    jtr = JTrainer(JTrainerConfig(**kw, attn_impl="xla"), jcfg, geom, *(copy(t) for t in trees))
    ttr = ScoreDistillationTrainer(TrainerConfig(**kw), tcfg, geom,
                                   *(dit_params_from_jax(t) for t in trees), device="cpu")
    assert ttr.use_lora and ttr.critic_lora_on and ttr.lora_scale == 1.0
    for key in ("gen_lora", "critic_lora"):
        _copy_adapters(ttr.state[key], lora_params_from_jax(jax.tree.map(np.asarray,
                                                                          jtr.state[key])))
    before = {k: map_tree(lambda t: t.detach().clone(), ttr.state[k])
              for k in ("gen_lora", "critic_lora", "gen_params", "critic_params")}
    rng = np.random.default_rng(33)
    noise = rng.standard_normal((1, 3, geom.channels, geom.height, geom.width)).astype(np.float32)
    pe_c = rng.standard_normal((1, tcfg.text_len, tcfg.text_dim)).astype(np.float32)
    pe_u = (pe_c * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(12)
    jnoise = jnp.asarray(noise)
    for micro in range(2):
        r = jax.random.fold_in(key, micro)
        r_exit, r_len, r_g, r_exit2, r_len2, r_c = jax.random.split(r, 6)

        def phase(r_exit, r_len, r_phase):
            exit_idx, nb, _ = jtr._sample_rollout_geometry(jnoise, r_exit, r_len)
            r_roll, r_second = jax.random.split(r_phase)
            t_from, t_to = jro.denoised_timestep_bounds(jtr.sched, jtr.rcfg, exit_idx)
            st, sn = jax_score_draws(r_second, (1, nb) + noise.shape[2:],
                                     *tdmd.score_timestep_range(ttr.dcfg, t_from, t_to))
            return PhaseDraws(exit_idx, nb,
                              jax_rollout_draws(r_roll, nb, exit_idx, (1, 1) + noise.shape[2:]),
                              st, sn)

        draws = StepDraws(generator=phase(r_exit, r_len, r_g), critic=phase(r_exit2, r_len2, r_c))
        jm = jtr.train_step(jnoise, jnp.asarray(pe_c), jnp.asarray(pe_u), key)
        tm = ttr.train_step(torch.from_numpy(noise), torch.from_numpy(pe_c),
                            torch.from_numpy(pe_u), draws)
        for k in ("generator_loss", "critic_loss", "generator_grad_norm", "critic_grad_norm",
                  "dmdtrain_gradient_norm"):
            _close(tm[k], jm[k], GRAD_TOL)
        assert tm["generator_grad_norm"] > 0 and tm["critic_grad_norm"] > 0
    for k in ("gen_params", "critic_params"):
        assert all(torch.equal(a, b) for a, b in zip(param_leaves(ttr.state[k]),
                                                      param_leaves(before[k])))
    check_updates(jtr, ttr, [(k, lora_params_from_jax, before[k])
                             for k in ("gen_lora", "critic_lora")])
    assert len(ttr.gen_leaves) == len(param_leaves(ttr.state["gen_lora"]))
    assert len(param_leaves(ttr.state["ema_params"])) == len(ttr.gen_leaves)
