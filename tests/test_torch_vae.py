"""The port's streaming VAE decoder held against the JAX package's
``vae_decode`` and ``vae_decode_scan`` on the tiny VAE config, same
parameters (carried across by utils.params) and latents, float32 on the
CPU.  A second case widens the tiny decoder to 96 channels so the wide
convs take the fused causal-conv path (its plain version on the CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longlive_torch.models import vae as TV
from longlive_torch.ops.vae_conv import pack_weights
from longlive_torch.utils.params import vae_params_from_jax
from longlive_tpu.models import vae as JV

ATOL = 2e-4  # float32 decoder, pixels clipped to [-1, 1]


def _pair(width):
    jcfg = dataclasses.replace(JV.tiny_vae_config(), dim=width)
    tcfg = dataclasses.replace(TV.tiny_vae_config(), dim=width)
    init = jax.jit(lambda key: JV.init_vae_params(key, jcfg, jnp.float32))  # eager init is slow
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    return jcfg, tcfg, tree


@pytest.mark.parametrize("width", [8, 96])
def test_decode_matches_jax(width):
    jcfg, tcfg, tree = _pair(width)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = vae_params_from_jax(tree)
    assert [tuple(s) for s in TV.decoder_cache_shapes(tcfg, 1, 4, 6)] == [
        tuple(s) for s in JV.decoder_cache_shapes(jcfg, 1, 4, 6)]
    rng = np.random.default_rng(4)
    lat = rng.standard_normal((1, 3, tcfg.z_dim, 4, 6)).astype(np.float32)

    jpx = np.asarray(jax.jit(lambda p, z: JV.vae_decode(p, jcfg, z))(jparams, jnp.asarray(lat)))
    tpx = TV.vae_decode(tparams, tcfg, torch.from_numpy(lat)).numpy()
    assert tpx.shape == (1, 1 + 2 * 2, 3, 8, 12)  # one 2x temporal + spatial upsample
    np.testing.assert_allclose(tpx, jpx, atol=ATOL)

    jscan, jcaches = jax.jit(lambda p, z: JV.vae_decode_scan(p, jcfg, z))(
        jparams, jnp.asarray(lat))
    tscan, tcaches = TV.vae_decode_scan(tparams, tcfg, torch.from_numpy(lat))
    np.testing.assert_allclose(tscan.numpy(), np.asarray(jscan), atol=ATOL)
    for a, b in zip(tcaches, jcaches):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def _convs(tree):
    if isinstance(tree, dict):
        if "w" in tree:
            yield tree
        for v in tree.values():
            yield from _convs(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _convs(v)


@pytest.mark.parametrize("width,fused,fused_enc", [(8, 0, 0), (96, 13, 8)],
                         ids=["8-0", "96-13"])
def test_fused_convs_carry_packed_weights(width, fused, fused_enc):
    """Both ways of building the parameters pack the fused convs' weights
    once.  Width 96, decoder: 6 res blocks x 2 convs of >= 96 channels
    (middle 2, upsample stages 2 + 2) and one 192->384 time conv; the
    16->192 conv1 and the 96->3 head are narrow.  Encoder: 4 res blocks x 2
    convs (stage 0, stage 1, middle 2); the strided time conv, the 3->96
    conv1 and the 192->8 head stay plain."""
    _, tcfg, tree = _pair(width)
    for params in (vae_params_from_jax(tree), TV.init_vae_params(tcfg)):
        for side, n in (("decoder", fused), ("encoder", fused_enc)):
            packed = [p for p in _convs(params[side]) if "w_packed" in p]
            assert len(packed) == n
            for p in packed:
                assert torch.equal(p["w_packed"], pack_weights(p["w"]))
        assert not any("w_packed" in p for p in _convs({k: params[k] for k in ("conv1", "conv2")}))
