"""The host-streamed larger teacher (the port's path to Wan2.1-T2V-14B) held
against the JAX package at the tiny config, float32 on the CPU: the
teacher twice the tiny width and heads, its blocks in host memory,
through ``teacher_real_x0(streamed=True)`` and through the trainer with
the levers of the 14B run (a file of its own so that its JAX runs spread
over the test workers; the harness is ``tests/test_torch_levers.py``'s)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from longlive_torch.config import tiny_geometry
from longlive_torch.ops import scheduler as TS
from longlive_torch.ops.rope import make_rope_tables
from longlive_torch.training import dmd as tdmd
from longlive_torch.utils import memory as M
from longlive_torch.utils.params import dit_params_from_jax
from longlive_tpu.ops import scheduler as JS
from longlive_tpu.ops.rope import make_rope_tables as j_rope_tables
from longlive_tpu.training import dmd as jdmd
from longlive_tpu.utils.memory import blocks_to_host as j_blocks_to_host
from test_torch_levers import _trained, big_teacher_config, build, models, run_steps  # noqa: F401
from test_torch_train_step import check_updates, jax_score_draws


def test_streamed_teacher_x0_of_a_larger_teacher_matches_jax(models):  # noqa: F811
    """``teacher_real_x0(streamed=True)`` with the teacher's blocks on the
    host (twice the tiny width and heads) against the JAX package's
    streamed pass (within 1e-4 of max |ref|), and bit for bit against the
    port's resident pass."""
    jcfg, tcfg, _, big = models
    geom = tiny_geometry()
    jbig, tbig = big_teacher_config(jcfg), big_teacher_config(tcfg)
    jsched = JS.make_schedule(1000, shift=5.0, sigma_min=0.0, extra_one_step=True, training=True)
    tsched = TS.make_schedule(1000, shift=5.0, sigma_min=0.0, extra_one_step=True, training=True)
    rng = np.random.default_rng(6)
    lat = rng.standard_normal((1, 3, geom.channels, geom.height, geom.width)).astype(np.float32)
    pe_c = rng.standard_normal((1, tcfg.text_len, tcfg.text_dim)).astype(np.float32)
    pe_u = (pe_c * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(13)
    jdc, tdc = jdmd.DMDConfig(timestep_shift=5.0), tdmd.DMDConfig(timestep_shift=5.0)
    want = np.asarray(jdmd.teacher_real_x0(
        j_blocks_to_host(jax.tree.map(jnp.asarray, big)), jbig,
        j_rope_tables(jbig.head_dim, jbig.rope_max_pos), jsched, jdc, jnp.asarray(lat),
        jnp.asarray(pe_c), jnp.asarray(pe_u), key, attn_impl="xla", streamed=True))
    st, sn = jax_score_draws(key, lat.shape, *tdmd.score_timestep_range(tdc, None, None))
    params = dit_params_from_jax(big)
    tables = make_rope_tables(tbig.head_dim, tbig.rope_max_pos)
    args = (tables, tsched, tdc, torch.from_numpy(lat), torch.from_numpy(pe_c),
            torch.from_numpy(pe_u), st, sn)
    resident = tdmd.teacher_real_x0(params, tbig, *args)
    got = tdmd.teacher_real_x0(M.blocks_to_host(params, "cpu"), tbig, *args, streamed=True)
    assert torch.equal(got, resident)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-4, err


def test_streamed_larger_teacher_trainer_matches_jax(models):  # noqa: F811
    """The levers of the 14B-teacher run at the tiny scale: a teacher twice
    as wide streamed from the host (``staged_phases``, ``teacher_stream``),
    the generator paged out and two micro-steps per update, against the
    JAX trainer with the same options: losses, norms and every parameter's
    change.  The run on the card adds the int8 rollout cache, held by its
    own test in ``tests/test_torch_levers.py``: with it, the codes one side rounds the other way move a
    few leaves' changes by ~1e-3 of their norm (1.01e-3 read on a
    self-attention K bias), the size of this test's limit."""
    options = dict(staged_phases=True, teacher_stream=True, page_generator=True,
                   gradient_accumulation_steps=2)
    jtr, ttr = build(models, big_teacher=True, **options)
    before = _trained(ttr)
    run_steps(jtr, ttr, models, 2)
    check_updates(jtr, ttr, before)
