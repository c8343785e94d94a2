"""The port's full-sequence DiT forwards held against the JAX package's on
the tiny DiT config: ``dit_forward_full`` with a materialized frame mask
(the dense route) and with a ``FrameMaskSpec`` (the frame-masked attention:
the port's plain version against the JAX kernel run interpreted),
``dit_forward_teacher_forcing`` on the dense route and on the kernel route,
with ``aug_t``; and the serving cross-attention under
``LONGLIVE_CROSS_FLASH=1`` (the attention kernel's plain version against
the JAX kernel run interpreted, under every exp2 / mxu_lsum setting).
Same parameters (carried across by utils.params), same numpy inputs,
float32 on the CPU."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longlive_torch.config import tiny_dit_config, tiny_geometry
from longlive_torch.models import dit as TD
from longlive_torch.ops import attention as TA
from longlive_torch.ops import masks as TM
from longlive_torch.ops.rope import make_rope_tables
from longlive_torch.utils.params import dit_params_from_jax
from longlive_tpu.config import tiny_dit_config as j_tiny
from longlive_tpu.models import dit as JD
from longlive_tpu.ops import masks as JM
from longlive_tpu.ops.rope import make_rope_tables as j_rope_tables

TOL = 2e-4  # float32 end to end; the kernels' softmax sums in another order


@functools.lru_cache(maxsize=1)
def _setup():
    tcfg = dataclasses.replace(tiny_dit_config(), num_frame_per_block=2)
    jcfg = dataclasses.replace(j_tiny(), num_frame_per_block=2)
    tree = jax.tree.map(np.asarray, JD.init_dit_params(jax.random.PRNGKey(0), jcfg, jnp.float32,
                                                       zero_head=False))
    rng = np.random.default_rng(5)
    pe = rng.standard_normal((1, tcfg.text_len, tcfg.text_dim)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = dit_params_from_jax(tree)
    return (tcfg, jcfg, tparams, jparams,
            TD.prepare_cross_kv(tparams, tcfg, torch.from_numpy(pe), torch.float32),
            JD.prepare_cross_kv(jparams, jcfg, jnp.asarray(pe), jnp.float32),
            make_rope_tables(tcfg.head_dim, tcfg.rope_max_pos),
            j_rope_tables(jcfg.head_dim, jcfg.rope_max_pos))


def _latents(seed, f):
    geom = tiny_geometry()
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, f, geom.channels, geom.height, geom.width)).astype(np.float32)
    t = rng.uniform(0, 1000, (1, f)).astype(np.float32)
    return x, t


@pytest.mark.parametrize("mask,start", [
    (("block_causal", 2, -1, 0, 0), 0),
    (("block_causal", 2, 4, 0, 0), 3),
    (("sink_window", 2, 4, 1, 0), 2),
])
@pytest.mark.parametrize("route", ["dense", "spec"])
def test_full_forward_matches_jax(mask, start, route):
    """The dense route takes the materialized [F, F] mask on both sides; the
    spec route the frame-masked attention (JAX: its kernel interpreted)."""
    tcfg, jcfg, tparams, jparams, tcross, jcross, ttab, jtab = _setup()
    x, t = _latents(1, 6)
    jspec, tspec = JM.FrameMaskSpec(*mask), TM.FrameMaskSpec(*mask)
    if route == "dense":
        jmask, tmask, impl = jspec.materialize(6), tspec.materialize(6), "xla"
    else:
        jmask, tmask, impl = jspec, tspec, "pallas_interpret"
    jfwd = jax.jit(lambda x, t: JD.dit_forward_full(jparams, jcfg, jtab, x, t, jcross, jmask,
                                                    start, attn_impl=impl))
    ref = np.asarray(jfwd(jnp.asarray(x), jnp.asarray(t)))
    out = TD.dit_forward_full(tparams, tcfg, ttab, torch.from_numpy(x), torch.from_numpy(t),
                              tcross, tmask, start_frame=start)
    assert out.shape == x.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("frames", [4, 5])  # 5: a partial last block
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_teacher_forcing_forward_matches_jax(frames, impl):
    tcfg, jcfg, tparams, jparams, tcross, jcross, ttab, jtab = _setup()
    noisy, t = _latents(2, frames)
    clean, aug_t = _latents(3, frames)
    jimpl = "pallas_interpret" if impl == "pallas" else "xla"
    jfwd = jax.jit(lambda *a: JD.dit_forward_teacher_forcing(jparams, jcfg, jtab, a[0], a[1],
                                                             a[2], jcross, a[3],
                                                             attn_impl=jimpl))
    ref = np.asarray(jfwd(*(jnp.asarray(a) for a in (noisy, clean, t, aug_t))))
    out = TD.dit_forward_teacher_forcing(tparams, tcfg, ttab, *(
        torch.from_numpy(a) for a in (noisy, clean, t)), tcross, torch.from_numpy(aug_t),
        attn_impl=impl)
    assert out.shape == noisy.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


def test_teacher_forcing_defaults():
    """aug_t None runs the clean half at t = 0; "auto" on the CPU is the
    dense route; a noisy block sees the clean frames of the earlier blocks
    only (2-frame blocks)."""
    tcfg, _, tparams, _, tcross, _, ttab, _ = _setup()
    noisy, t = _latents(4, 4)
    clean, _ = _latents(5, 4)
    args = [torch.from_numpy(a) for a in (noisy, clean, t)]
    out = TD.dit_forward_teacher_forcing(tparams, tcfg, ttab, *args, tcross)
    zeros = TD.dit_forward_teacher_forcing(tparams, tcfg, ttab, *args, tcross,
                                           aug_t=torch.zeros_like(args[2]), attn_impl="xla")
    assert torch.equal(out, zeros)
    clean_t = args[1]
    args[1] = clean_t.clone()
    args[1][:, 2:] += 10.0  # block 1's clean frames: no noisy frame sees them
    moved = TD.dit_forward_teacher_forcing(tparams, tcfg, ttab, *args, tcross)
    torch.testing.assert_close(moved, out, rtol=1e-5, atol=1e-5)
    args[1] = clean_t.clone()
    args[1][:, :2] += 10.0  # block 0's: noisy block 1 sees them, noisy block 0 not
    moved = TD.dit_forward_teacher_forcing(tparams, tcfg, ttab, *args, tcross)
    torch.testing.assert_close(moved[:, :2], out[:, :2], rtol=1e-5, atol=1e-5)
    assert (moved[:, 2:] - out[:, 2:]).abs().max() > 1e-3
    with pytest.raises(ValueError):
        TD.dit_forward_teacher_forcing(tparams, tcfg, ttab, *args, tcross, attn_impl="flash")


def test_spec_route_under_grad_raises_and_dense_route_remats():
    """The frame-masked attention is forward only, as in the JAX package;
    the dense route differentiates, with and without per-layer checkpoints."""
    tcfg, _, tparams, _, tcross, _, ttab, _ = _setup()
    x, t = _latents(6, 4)
    x = torch.from_numpy(x).requires_grad_()
    spec = TM.FrameMaskSpec("block_causal", 2)
    with pytest.raises(ValueError, match="forward only"):
        TD.dit_forward_full(tparams, tcfg, ttab, x, torch.from_numpy(t), tcross, spec)
    grads = []
    for remat in (False, True):
        out = TD.dit_forward_full(tparams, tcfg, ttab, x, torch.from_numpy(t), tcross,
                                  spec.materialize(4), remat_layers=remat)
        grads.append(torch.autograd.grad(out.square().sum(), x)[0])
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-6)
    assert grads[0].abs().max() > 0


@pytest.mark.parametrize("exp2,mxu_lsum", [(False, False), (True, False), (False, True),
                                           (True, True)])
def test_cross_flash_matches_jax(monkeypatch, exp2, mxu_lsum):
    """LONGLIVE_CROSS_FLASH=1 routes the serving cross-attention through the
    attention kernel (here its plain version, counted as a cross call) with
    a zero bias; JAX's layer with its kernel interpreted is the reference."""
    tcfg, jcfg, tparams, jparams, tcross, jcross, _, _ = _setup()
    for name, on in (("LONGLIVE_CROSS_FLASH", True), ("LONGLIVE_EXP2", exp2),
                     ("LONGLIVE_MXU_LSUM", mxu_lsum)):
        monkeypatch.setenv(name, "1" if on else "0")
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 40, tcfg.dim)).astype(np.float32)
    jlayer = jax.tree.map(lambda a: a[1], jparams["blocks"])["cross_attn"]
    ref = np.asarray(JD._cross_attention_layer(jlayer, jcfg, jnp.asarray(x), jcross.k[1],
                                               jcross.v[1], "pallas_interpret"))
    calls = []
    real = TA.flash_attention
    monkeypatch.setattr(TA, "flash_attention",
                        lambda *a, **kw: calls.append(kw.get("cross")) or real(*a, **kw))
    out = TD._cross_attention_layer(tparams["blocks"][1]["cross_attn"], tcfg,
                                    torch.from_numpy(x), tcross.k[1], tcross.v[1])
    assert calls == [True]
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)
    monkeypatch.setenv("LONGLIVE_CROSS_FLASH", "0")
    dense = TD._cross_attention_layer(tparams["blocks"][1]["cross_attn"], tcfg,
                                      torch.from_numpy(x), tcross.k[1], tcross.v[1])
    assert calls == [True]
    np.testing.assert_allclose(dense.numpy(), ref, rtol=TOL, atol=TOL)


def test_full_forward_cross_flash_matches_dense(monkeypatch):
    """A whole teacher-forcing forward under LONGLIVE_CROSS_FLASH=1 against
    the same forward with the dense cross-attention (float32: the kernel's
    pre-rounded q is exact)."""
    tcfg, _, tparams, _, tcross, _, ttab, _ = _setup()
    noisy, t = _latents(9, 4)
    clean, _ = _latents(10, 4)
    args = [torch.from_numpy(a) for a in (noisy, clean, t)]
    monkeypatch.setenv("LONGLIVE_CROSS_FLASH", "0")
    ref = TD.dit_forward_teacher_forcing(tparams, tcfg, ttab, *args, tcross, attn_impl="pallas")
    monkeypatch.setenv("LONGLIVE_CROSS_FLASH", "1")
    out = TD.dit_forward_teacher_forcing(tparams, tcfg, ttab, *args, tcross, attn_impl="pallas")
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)
    assert TA.mode_launches["cross"] == 0  # plain versions on the CPU launch nothing
