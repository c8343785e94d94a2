"""The port's streaming VAE encoder held against the JAX package's
``vae_encode``, float32 on the CPU, the same parameters (carried across by
``utils.params.vae_params_from_jax``) and pixels: the cache shapes, the
encode on the tiny config, on ``VAEConfig(dim=8)`` (the full ``dim_mult``:
three spatial and both temporal downsamples) and on the tiny config at
width 96 (its res-block convs on the fused conv's plain version), also
under ``LONGLIVE_VAE_PAIR=1``; and which convs reach the fused conv."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longlive_torch.models import vae as TV
from longlive_torch.ops import vae_conv as VC
from longlive_torch.utils.params import vae_params_from_jax
from longlive_tpu.models import vae as JV

ATOL = 2e-4  # the decoder's tolerance; float32 latents of magnitude ~1
H, W = 16, 24

CONFIGS = {"tiny": JV.tiny_vae_config(), "dim8": JV.VAEConfig(dim=8),
           "tiny96": dataclasses.replace(JV.tiny_vae_config(), dim=96)}


def _tcfg(jcfg):
    return TV.VAEConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})


@functools.lru_cache(maxsize=None)
def _tree(name):
    jcfg = CONFIGS[name]
    init = jax.jit(lambda key: JV.init_vae_params(key, jcfg, jnp.float32))  # eager init is slow
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))


def _pixels(t, seed=0, h=H, w=W):
    return np.random.default_rng(seed).uniform(-1, 1, (1, t, 3, h, w)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_encode(name, t):
    tree = jax.tree.map(jnp.asarray, _tree(name))
    return np.asarray(JV.vae_encode(tree, CONFIGS[name], jnp.asarray(_pixels(t))))


@pytest.mark.parametrize("name,b,h,w", [("full", 1, 480, 832), ("tiny", 2, 16, 24),
                                        ("dim8", 1, 16, 24)])
def test_encoder_cache_shapes_match_jax(name, b, h, w):
    jcfg = JV.VAEConfig() if name == "full" else CONFIGS[name]
    got = [tuple(s) for s in TV.encoder_cache_shapes(_tcfg(jcfg), b, h, w)]
    assert got == [tuple(s) for s in JV.encoder_cache_shapes(jcfg, b, h, w)]
    caches = TV.init_encoder_caches(_tcfg(jcfg), b, h, w)
    assert [tuple(c.shape) for c in caches] == got and not any(c.any() for c in caches)


@pytest.mark.parametrize("pair", [False, True], ids=["", "pair"])
@pytest.mark.parametrize("t", [1, 5, 9])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_vae_encode_matches_jax(monkeypatch, name, t, pair):
    """T = 1 (the first chunk alone), 5 and 9: the tiny configs take chunks
    of 1, 2, 2, ... frames, dim8 of 1, 4, 4 (T 4 -> 2 -> 1 through its two
    temporal stages)."""
    monkeypatch.setenv("LONGLIVE_VAE_PAIR", "1" if pair else "0")
    jcfg = CONFIGS[name]
    tcfg = _tcfg(jcfg)
    got = TV.vae_encode(vae_params_from_jax(_tree(name)), tcfg, torch.from_numpy(_pixels(t)))
    want = _jax_encode(name, t)
    stride = 2 ** sum(jcfg.temperal_downsample)
    down = 2 ** (len(jcfg.dim_mult) - 1)
    assert tuple(got.shape) == (1, 1 + (t - 1) // stride, tcfg.z_dim, H // down, W // down)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("pair", [False, True], ids=["", "pair"])
def test_encoder_routes_res_block_convs_to_the_fused_conv(monkeypatch, pair):
    """At the full widths (96 / 192 / 384, on the plain versions here),
    exactly the res-block convs reach ``fused_causal_conv``: 20 per chunk,
    each a 3x3x3 conv; the strided time convs, the 3->96 conv1 and the
    384->32 head never do.  Under ``LONGLIVE_VAE_PAIR=1`` the 8
    no-shortcut blocks are ``fused_res_block`` calls and the two shortcut
    blocks' 4 convs stay on ``fused_causal_conv``."""
    monkeypatch.setenv("LONGLIVE_VAE_PAIR", "1" if pair else "0")
    convs, pairs = [], []
    conv, res_block = VC.fused_causal_conv, VC.fused_res_block

    def counting_conv(x, cache, w, *a, **k):
        convs.append((tuple(w.shape), tuple(x.shape)))
        return conv(x, cache, w, *a, **k)

    def counting_pair(x, *a, **k):
        pairs.append(tuple(x.shape))
        return res_block(x, *a, **k)

    monkeypatch.setattr(VC, "fused_causal_conv", counting_conv)
    monkeypatch.setattr(VC, "fused_res_block", counting_pair)
    cfg = TV.VAEConfig()
    params = TV.init_vae_params(cfg, torch.float32, "cpu", seed=1)
    out = TV.vae_encode(params, cfg, torch.from_numpy(_pixels(5, h=16, w=16)))
    assert tuple(out.shape) == (1, 2, 16, 2, 2) and torch.isfinite(out).all()
    chunks = 2
    assert len(convs) == (4 if pair else 20) * chunks
    assert len(pairs) == (8 if pair else 0) * chunks
    assert all(w[2:] == (3, 3, 3) and min(w[:2]) >= 96 for w, _ in convs)
    # the new conv shape: 96 -> 192 at half resolution, T 1 then T 4
    new = [x for w, x in convs if w[:2] == (192, 96)]
    assert new == [(1, 8, 8, 96), (4, 8, 8, 96)]
