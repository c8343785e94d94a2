"""Streaming long tuning of the port held against the JAX package at its
tiny streaming geometry (``tests/test_streaming.py``: one-frame blocks,
3-frame chunks, sequences of at most 8 frames, at least 2 new frames per
chunk, a switch at frame 4; the tiny VAE with mean 0 and std 1), float32 on
the CPU with the JAX package's random draws replayed: the rollout
continuing a cache, the first-frame re-encode, and streaming steps of the
two trainers (without LoRA and with the untrained seed chunk; with LoRA)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longlive_torch.config import CacheConfig, tiny_dit_config, tiny_geometry
from longlive_torch.models import dit as TD
from longlive_torch.models import vae as TV
from longlive_torch.ops import kv_cache as tkvc
from longlive_torch.ops import scheduler as TS
from longlive_torch.ops.rope import make_rope_tables
from longlive_torch.training import rollout as tro
from longlive_torch.training.streaming import (ChunkDraws, StreamingConfig, StreamingTrainer,
                                               StreamStepDraws)
from longlive_torch.training.trainer import (TrainerConfig, host_adamw_init, map_tree,
                                             param_leaves)
from longlive_torch.utils import checkpoint as TC
from longlive_torch.utils.params import (dit_params_from_jax, lora_params_from_jax,
                                         vae_params_from_jax)
from longlive_tpu.config import CacheConfig as JCacheConfig
from longlive_tpu.config import tiny_dit_config as j_tiny
from longlive_tpu.models import dit as JD
from longlive_tpu.models import vae as JV
from longlive_tpu.ops import scheduler as JS
from longlive_tpu.ops.rope import make_rope_tables as j_rope_tables
from longlive_tpu.training import rollout as jro
from longlive_tpu.training.streaming import StreamingConfig as JStreamingConfig
from longlive_tpu.training.streaming import StreamingTrainer as JStreamingTrainer
from longlive_tpu.training.trainer import TrainerConfig as JTrainerConfig
from longlive_tpu.utils import checkpoint as JC
from test_torch_train_step import (GRAD_TOL, RTOL, _close, _leaf_close, _requires_grad,
                                   check_updates, jax_rollout_draws, jax_score_draws)

STREAM = dict(chunk_size=3, max_length=8, min_new_frame=2, switch_choices=(4,))


@pytest.fixture(scope="module")
def models():
    jcfg = j_tiny()
    trees = [jax.tree.map(np.asarray, JD.init_dit_params(jax.random.PRNGKey(i), jcfg,
                                                         jnp.float32, zero_head=False))
             for i in range(3)]  # generator, critic, teacher
    # the tiny VAE drawn by the port and carried to the JAX package through
    # the reference's state dict (the JAX package's own init is slow here)
    vcfg = JV.tiny_vae_config()
    tcfg = TV.tiny_vae_config()
    vae = JC.vae_params_from_torch(TC.vae_state_dict(TV.init_vae_params(tcfg, seed=9), tcfg),
                                   vcfg)
    vae["mean"], vae["std"] = jnp.zeros(vcfg.z_dim), jnp.ones(vcfg.z_dim)
    return jcfg, tiny_dit_config(), trees, vcfg, jax.tree.map(np.asarray, vae)


class JaxChunkDraws(ChunkDraws):
    """The draws the JAX streaming trainer makes from one fwdbwd's key
    (``_one_streaming_fwdbwd``): rng_sel, rng_exit, rng_noise, rng_step =
    split(rng, 4), then rng_roll, rng_dmd (or rng_crit) = split(rng_step);
    the seed chunk's from split(fold_in(rng, 999), 3)."""

    def __init__(self, rng):
        self.rng = rng
        self.sel, self.exit_key, self.noise_key, step = jax.random.split(rng, 4)
        self.roll, self.second = jax.random.split(step)

    def choice(self, n):
        return int(jax.random.randint(self.sel, (), 0, n))

    def exit_idx(self, num_steps, last_step_only):
        return jro.sample_exit_idx(self.exit_key, num_steps, last_step_only)

    def noise(self, shape):
        return torch.from_numpy(np.array(jax.random.normal(self.noise_key, shape, jnp.float32)))

    def renoise(self, num_blocks, exit_idx, block_shape):
        return jax_rollout_draws(self.roll, num_blocks, exit_idx, tuple(block_shape))

    def score(self, shape, lo, hi):
        return jax_score_draws(self.second, tuple(shape), lo, hi)

    def seed_chunk(self):
        seed = JaxChunkDraws.__new__(JaxChunkDraws)
        seed.exit_key, seed.noise_key, seed.roll = jax.random.split(
            jax.random.fold_in(self.rng, 999), 3)
        return seed


def _geometry():
    jsched = JS.make_schedule(1000, shift=5.0, sigma_min=0.0, extra_one_step=True, training=True)
    tsched = TS.make_schedule(1000, shift=5.0, sigma_min=0.0, extra_one_step=True, training=True)
    steps = tuple(float(x) for x in JS.warp_denoising_steps(jsched, (1000, 750, 500, 250)))
    return jsched, tsched, steps


def _cache_close(tcache, jcache, tol):
    k, v = tkvc.to_standard_layout(tcache)
    _close(k, jcache.k, tol)
    _close(v, jcache.v, tol)
    assert (tcache.ring_base, tcache.sink_filled, tcache.ring_filled) == (
        int(jcache.ring_base), int(jcache.sink_filled), int(jcache.ring_filled))


def test_rollout_continues_a_cache_like_jax(models):
    """Three frames from an empty cache (sink 1 + ring 2, window 4), then
    two more continuing it from frame 3 (the ring wraps): the latents and
    the final cache, then the generator gradients of sum(latents * w) for
    the continued rollout, the port's per-block replay starting from a copy
    of the continued cache against jax.grad over the whole continuation."""
    jcfg, tcfg, (gen, _, _), _, _ = models
    geom = tiny_geometry()
    jsched, tsched, steps = _geometry()
    jr = jro.RolloutConfig(denoise_timesteps=steps, frame_block=1, attn_impl="xla",
                           window_frames=4)
    tr = tro.RolloutConfig(denoise_timesteps=steps, frame_block=1, window_frames=4)
    fs = geom.frame_seq_length
    jcc, tcc = JCacheConfig(1, 2, fs), CacheConfig(1, 2, fs)
    jt, tt = j_rope_tables(jcfg.head_dim, jcfg.rope_max_pos), make_rope_tables(tcfg.head_dim,
                                                                                 tcfg.rope_max_pos)
    rng = np.random.default_rng(20)
    frame = (geom.channels, geom.height, geom.width)
    noise1 = rng.standard_normal((1, 3) + frame).astype(np.float32)
    noise2 = rng.standard_normal((1, 2) + frame).astype(np.float32)
    pe = rng.standard_normal((1, tcfg.text_len, tcfg.text_dim)).astype(np.float32)
    w = rng.standard_normal((1, 2) + frame).astype(np.float32)
    k1, k2, e1, e2 = jax.random.PRNGKey(21), jax.random.PRNGKey(22), 1, 2
    jp = jax.tree.map(jnp.asarray, gen)
    jcross = JD.prepare_cross_kv(jp, jcfg, jnp.asarray(pe), jnp.float32)
    _, jcache1, _ = jro.rollout_trajectory(jp, jcfg, jcc, jt, jsched, jr, jnp.asarray(noise1),
                                           jcross, k1, e1)

    def jlat(p, with_cache=False):
        cross = JD.prepare_cross_kv(p, jcfg, jnp.asarray(pe), jnp.float32)
        lat, cache, _ = jro.rollout_trajectory(p, jcfg, jcc, jt, jsched, jr, jnp.asarray(noise2),
                                               cross, k2, e2, cache=jcache1,
                                               current_start_frame=3)
        return (lat, cache) if with_cache else lat

    jl, jcache2 = jlat(jp, with_cache=True)
    _, jvjp = jax.vjp(jlat, jp)
    (jg,) = jvjp(jnp.asarray(w))

    tp = _requires_grad(dit_params_from_jax(gen))
    block = (1, 1) + frame
    with torch.no_grad():
        cross = TD.prepare_cross_kv(tp, tcfg, torch.from_numpy(pe), torch.float32)
        _, cache = tro.rollout_trajectory(tp, tcfg, tcc, tt, tsched, tr, torch.from_numpy(noise1),
                                          cross, jax_rollout_draws(k1, 3, e1, block), e1)
        _cache_close(cache, jcache1, RTOL)
        start = tkvc.KVCache(k=cache.k.clone(), v=cache.v.clone(), ring_base=cache.ring_base,
                             sink_filled=cache.sink_filled, ring_filled=cache.ring_filled)
        draws2 = jax_rollout_draws(k2, 2, e2, block)
        tl, cache = tro.rollout_trajectory(tp, tcfg, tcc, tt, tsched, tr,
                                           torch.from_numpy(noise2), cross, draws2, e2,
                                           cache=cache, current_start_frame=3)
    _close(tl, jl)
    _cache_close(cache, jcache2, RTOL)
    leaf = TD.CrossKV(cross.k.detach().requires_grad_(), cross.v.detach().requires_grad_())
    cross = TD.prepare_cross_kv(tp, tcfg, torch.from_numpy(pe), torch.float32)
    tl2, _ = tro.rollout_trajectory(tp, tcfg, tcc, tt, tsched, tr, torch.from_numpy(noise2),
                                    leaf, draws2, e2, cotangent=torch.from_numpy(w), cache=start,
                                    current_start_frame=3)
    torch.autograd.backward([cross.k, cross.v], [leaf.k.grad, leaf.v.grad])
    assert torch.equal(tl2, tl)
    _leaf_close(tp, jg, GRAD_TOL)


def test_reencode_matches_jax(models):
    """The first frame of a chunk through the tiny VAE's decode and back
    through its encode, the other frames untouched, against the JAX
    trainer's ``_reencode_first_frame``."""
    _, _, _, vcfg, vae = models
    geom = tiny_geometry()
    chunk = np.random.default_rng(23).standard_normal(
        (1, 3, geom.channels, geom.height, geom.width)).astype(np.float32)
    want = JStreamingTrainer._reencode_first_frame(
        types.SimpleNamespace(vae_params=jax.tree.map(jnp.asarray, vae), vae_cfg=vcfg),
        jnp.asarray(chunk))
    tr = types.SimpleNamespace(vae_params=vae_params_from_jax(vae),
                               vae_cfg=TV.tiny_vae_config())
    got = StreamingTrainer._reencode_first_frame(tr, torch.from_numpy(chunk))
    assert torch.equal(got[:, 1:], torch.from_numpy(chunk[:, 1:]))
    assert not torch.allclose(got[:, :1], torch.from_numpy(chunk[:, :1]))
    _close(got, want)


def build_trainers(models, lora: bool, options=None, **stream):
    """The JAX streaming trainer and the port's on the same models and VAE
    (the adapters carried across under LoRA), learning rates raised as in
    ``tests/test_torch_train_step.py`` so that the updates dominate float32
    rounding; ``options`` more trainer options for both."""
    jcfg, tcfg, (gen, critic, teacher), vcfg, vae = models
    geom = tiny_geometry()
    kw = dict(num_frame_per_block=1, num_training_frames=3, slice_last_frames=3,
              dfake_gen_update_ratio=2, ema_start_step=0, lr=1e-3, lr_critic=3e-4)
    kw.update(options or {})
    if lora:
        kw.update(lora_rank=4, lora_alpha=4.0, lora_dtype="float32")
    copy = lambda t: jax.tree.map(jnp.array, t)  # noqa: E731  (the JAX trainer donates)
    jtr = JStreamingTrainer(JTrainerConfig(**kw, attn_impl="xla"), jcfg, geom, copy(gen),
                            copy(critic), copy(teacher),
                            streaming_cfg=JStreamingConfig(**STREAM, **stream),
                            vae_params=jax.tree.map(jnp.asarray, vae), vae_cfg=vcfg)
    ttr = StreamingTrainer(TrainerConfig(**kw), tcfg, geom, dit_params_from_jax(gen),
                           dit_params_from_jax(critic), dit_params_from_jax(teacher),
                           streaming_cfg=StreamingConfig(**STREAM, **stream),
                           vae_params=vae_params_from_jax(vae), vae_cfg=TV.tiny_vae_config(),
                           device="cpu")
    if lora:
        with torch.no_grad():
            for key in ("gen_lora", "critic_lora"):
                src = lora_params_from_jax(jax.tree.map(np.asarray, jtr.state[key]))
                for dst_l, src_l in zip(ttr.state[key], src):
                    for g, lg in src_l.items():
                        for n, ab in lg.items():
                            for which, t in ab.items():
                                dst_l[g][n][which].copy_(t)
        if ttr.tcfg.opt_on_host:  # the host AdamW's master copies start from these adapters
            for key, leaves in (("gen_opt", ttr.gen_leaves), ("critic_opt", ttr.critic_leaves)):
                ttr.state[key] = host_adamw_init(leaves)
    return jtr, ttr


def run_streaming_steps(jtr, ttr, num_steps: int):
    """``num_steps`` streaming steps of both trainers as ``run_train``
    drives them (a new sequence when the last is exhausted, between steps
    or between a step's two updates), the JAX trainer's draws replayed into
    the port's; each step's metrics, previous frames and cache compared.
    Returns the port's metrics."""
    rng = np.random.default_rng(24)
    shape = (1, ttr.cfg.text_len, ttr.cfg.text_dim)
    pe_c, pe_s = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    pe_u = (pe_c * 0.1).astype(np.float32)
    seqs = {"jax": 0, "port": 0}

    def jax_new():
        jtr.start_new_sequence(jnp.asarray(pe_c), jnp.asarray(pe_u),
                               jax.random.PRNGKey(100 + seqs["jax"]),
                               prompt_switch=jnp.asarray(pe_s))
        seqs["jax"] += 1

    def port_new():
        k = jax.random.PRNGKey(100 + seqs["port"])
        choice = int(jax.random.randint(k, (), 0, len(STREAM["switch_choices"])))
        ttr.start_new_sequence(torch.from_numpy(pe_c), torch.from_numpy(pe_u),
                               prompt_switch=torch.from_numpy(pe_s), switch_choice=choice)
        seqs["port"] += 1

    key = jax.random.PRNGKey(42)
    out = []
    for micro in range(num_steps):
        for trainer, new in ((jtr, jax_new), (ttr, port_new)):
            if not trainer.can_generate_more():
                new()
        r = jax.random.fold_in(key, micro)
        draws = StreamStepDraws(
            generator=(JaxChunkDraws(jax.random.fold_in(r, 1)) if ttr.trains_generator(micro)
                       else None),
            critic=JaxChunkDraws(jax.random.fold_in(r, 2)))
        jm = jtr.streaming_train_step(key, new_sequence_cb=jax_new)
        tm = ttr.streaming_train_step(draws, new_sequence_cb=port_new)
        assert set(tm) == set(jm)
        for k, v in jm.items():
            if isinstance(v, (bool, int)):
                assert tm[k] == v, (micro, k)
            else:
                _close(tm[k], v, GRAD_TOL)
        s, js = ttr.seq_state, jtr.seq_state
        assert (s["current_length"], s["has_switched"], s["switch_frame_index"]) == (
            js["current_length"], js["has_switched"], js["switch_frame_index"])
        _close(s["previous_frames"], js["previous_frames"], GRAD_TOL)
        _cache_close(s["cache"], js["cache"], GRAD_TOL)
        out.append(tm)
    assert seqs["jax"] == seqs["port"]
    return out


@pytest.mark.parametrize("case", ["seed_chunk", "lora"])
def test_streaming_steps_match_jax(models, case):
    """Three streaming steps of both trainers, the JAX trainer's draws
    replayed; the ring of the 3-frame cache wraps from the second chunk on.

    ``seed_chunk``: no LoRA, ``train_first_chunk: false``.  Step 0 seeds the
    cache with an untrained chunk, then trains the generator on a chunk (2
    new frames after 1 overlap frame, its first frame re-encoded, the
    prompt switch at frame 4 with the recache) and the critic on the next;
    step 1 exhausts the sequence and starts a new one (seed chunk, then the
    critic's chunk); step 2 trains the generator on its last chunk and the
    critic on a third sequence's.

    ``lora``: rank-4 adapters on the generator and the critic (float32),
    the JAX trainer's adapters carried across.  Step 0 trains the generator
    on a fresh 3-frame chunk and the critic on the next (1 overlap frame
    re-encoded, the switch with the recache); step 1 the critic on a
    2-frame chunk; step 2 starts a new sequence.

    Losses, grad norms, the chunk state, the previous frames, the cache and
    the change of every trained leaf against the JAX trainer; under LoRA
    the bases untouched."""
    _, _, (gen, critic, _), _, _ = models
    lora = case == "lora"
    jtr, ttr = build_trainers(models, lora=lora, train_first_chunk=lora)
    if lora:
        trained = [(k, lora_params_from_jax, map_tree(lambda t: t.detach().clone(), ttr.state[k]))
                   for k in ("gen_lora", "critic_lora")]
        bases = {k: map_tree(lambda t: t.detach().clone(), ttr.state[k])
                 for k in ("gen_params", "critic_params")}
    else:
        trained = [(k, dit_params_from_jax, dit_params_from_jax(t))
                   for k, t in (("gen_params", gen), ("critic_params", critic))]
    ms = run_streaming_steps(jtr, ttr, 3)
    if lora:
        assert [m["current_length"] for m in ms] == [5, 7, 5]
        assert [m["switched"] for m in ms] == [True, False, True]
    else:
        assert [m["current_length"] for m in ms] == [7, 5, 5]
        assert [m["switched"] for m in ms] == [True, True, True]
        assert ms[0]["gen_switched"] and ms[0]["gen_overlap"] == 1
    check_updates(jtr, ttr, trained)
    if lora:
        for k, before in bases.items():
            assert all(torch.equal(a, b) for a, b in zip(param_leaves(ttr.state[k]),
                                                          param_leaves(before)))


def test_untrained_seed_chunk_is_a_rollout_of_its_draws(models):
    """``train_first_chunk: false``: before the first trained chunk, a
    3-frame rollout of the seed draws without gradient fills the cache and
    the previous frames (the same rollout run by hand)."""
    _, tcfg, (gen, critic, teacher), _, _ = models
    geom = tiny_geometry()
    tr = StreamingTrainer(TrainerConfig(num_frame_per_block=1, num_training_frames=3,
                                        slice_last_frames=3), tcfg, geom,
                          *(dit_params_from_jax(t) for t in (gen, critic, teacher)),
                          streaming_cfg=StreamingConfig(**dict(STREAM, train_first_chunk=False)),
                          device="cpu")
    pe = torch.randn((1, tcfg.text_len, tcfg.text_dim), generator=torch.Generator().manual_seed(5))
    tr.start_new_sequence(pe, pe * 0.1)
    d = ChunkDraws(torch.Generator().manual_seed(6))
    tr._seed_chunk(d)
    g = torch.Generator().manual_seed(6)
    exit_idx = tro.sample_exit_idx(g, 4, False)
    frame = (geom.channels, geom.height, geom.width)
    noise = torch.randn((1, 3) + frame, generator=g)
    renoise = torch.randn((3, exit_idx + 1, 1, 1) + frame, generator=g)
    with torch.no_grad():
        cross = TD.prepare_cross_kv(tr.state["gen_params"], tcfg, pe, torch.float32)
        lat, cache = tr._rollout(tr.state["gen_params"], noise, cross, renoise, exit_idx)
    assert tr.seq_state["current_length"] == 3
    assert torch.equal(tr.seq_state["previous_frames"], lat)
    assert torch.equal(tr.seq_state["cache"].k, cache.k)
