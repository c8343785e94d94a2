"""The JAX package's VAE route switches against the port's decoder, which
reads none of them.  Each switch picks between two ways of computing the
same convolution (the fused causal-conv kernel or XLA's conv, a tap-split
or a concatenated temporal conv, a channels-first or channels-last head, a
sub-pixel or a nearest-upsample-then-conv upsampler).  Each case runs the
JAX decoder with one switch flipped from its default and holds it against
the port's decoder at the port's VAE tolerance, on the 96-channel tiny
decoder (the width at which the fused route is taken) with the real model's
stage widths, 384 and 96 (``dim_mult=(1, 4)``: the JAX fused route pads a
192-channel stage to 256 lanes, which its attention block does not strip,
a width no real model has).  On the CPU the JAX
package's default is its XLA route; its fused route runs here only
interpreted (``LONGLIVE_VAE_FUSED=interpret``, kept to the convs of >= 96
channels as on a TPU), so the time-conv switch is flipped on that route.
``LONGLIVE_VAE_FUSED_96`` chooses the route of the 96-channel stage on a
TPU only: here it leaves the route as it is."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longlive_torch.models import vae as TV
from longlive_torch.utils.params import vae_params_from_jax
from longlive_tpu.models import vae as JV

ATOL = 2e-4  # the port's VAE tolerance (tests/test_torch_vae.py): float32, pixels in [-1, 1]


@functools.lru_cache(maxsize=1)
def _params():
    jcfg = dataclasses.replace(JV.tiny_vae_config(), dim=96, dim_mult=(1, 4))
    tcfg = dataclasses.replace(TV.tiny_vae_config(), dim=96, dim_mult=(1, 4))
    init = jax.jit(lambda key: JV.init_vae_params(key, jcfg, jnp.float32))
    return jcfg, tcfg, jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("env", [
    {"LONGLIVE_VAE_FUSED": "interpret"},
    {"LONGLIVE_VAE_FUSED_96": "0"},
    {"LONGLIVE_VAE_FUSED": "interpret", "LONGLIVE_VAE_FUSED_TIMECONV": "0"},
    {"LONGLIVE_VAE_TAPSPLIT": "0"},
    {"LONGLIVE_VAE_HEAD_CF": "0"},
    {"LONGLIVE_VAE_SUBPIXEL": "0"},
], ids=["fused", "fused_96", "fused_timeconv", "tapsplit", "head_cf", "subpixel"])
def test_jax_vae_route_switch_matches_port(monkeypatch, env):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    wide_only = JV._fusable
    monkeypatch.setattr(JV, "_fusable", lambda x, p, thread, stride: (
        wide_only(x, p, thread, stride) and "w" in p and min(p["w"].shape[:2]) >= 96))
    jcfg, tcfg, tree = _params()
    lat = np.random.default_rng(4).standard_normal((1, 2, tcfg.z_dim, 2, 8)).astype(np.float32)
    jpx = np.asarray(jax.jit(lambda p, z: JV.vae_decode(p, jcfg, z))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(lat)))
    tpx = TV.vae_decode(vae_params_from_jax(tree), tcfg, torch.from_numpy(lat)).numpy()
    assert tpx.shape == jpx.shape == (1, 3, 3, 4, 16)
    np.testing.assert_allclose(tpx, jpx, atol=ATOL)
