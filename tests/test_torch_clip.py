"""The port's CLIP (``models/clip.py``) held against the JAX package's,
float32 on the CPU, the same parameters (carried across by
``utils.params.clip_vision_params_from_jax`` / ``clip_text_params_from_jax``):
the vision tower (31 blocks and all, both activations) and the text tower
within 1e-4 of max |ref|; the image preprocessing and the bicubic resize
against ``jax.image.resize`` on a downscale and an upscale; the
state-dict converters bit-equal to JAX's (then carried across) on
synthetic checkpoints, in float32 and bf16; the two GELUs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longlive_torch.models import clip as TC
from longlive_torch.models import nn as TN
from longlive_torch.utils.params import clip_text_params_from_jax, clip_vision_params_from_jax
from longlive_tpu.models import clip as JC
from longlive_tpu.models import nn as JN
from test_torch_checkpoint import assert_trees_equal

TOL = 1e-4  # of max |ref|: float32 end to end, sums in another order

DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-6))


def _tcfg(jcfg, cls):
    return cls(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})


def _vision(jcfg, seed=0):
    tree = jax.tree.map(np.asarray, JC.init_clip_vision_params(jax.random.PRNGKey(seed), jcfg))
    # non-trivial norms and biases, so the converters' placement shows
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
                        tree)
    return tree, clip_vision_params_from_jax(tree)


@pytest.mark.parametrize("activation", ["gelu", "quick_gelu"])
@pytest.mark.parametrize("use_31_block", [True, False])
def test_clip_vision_forward_matches_jax(use_31_block, activation):
    jcfg = dataclasses.replace(JC.tiny_clip_vision_config(), activation=activation)
    tcfg = _tcfg(jcfg, TC.CLIPVisionConfig)
    tree, tparams = _vision(jcfg)
    x = np.random.default_rng(1).standard_normal((2, 3, jcfg.image_size, jcfg.image_size))
    x = x.astype(np.float32)
    want = JC.clip_vision_forward(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(x),
                                  use_31_block=use_31_block)
    got = TC.clip_vision_forward(tparams, tcfg, torch.from_numpy(x), use_31_block=use_31_block)
    assert tuple(got.shape) == (2, jcfg.num_patches + 1, jcfg.dim)
    _close(got, want)


@pytest.mark.parametrize("hw", [(50, 70), (12, 20), (28, 28), (480, 832)],
                         ids=["down", "up", "same", "480x832"])
def test_encode_image_matches_jax(hw):
    """Resize (a downscale, an upscale, none, and the video size to 28),
    normalise, then the 31-block tower."""
    jcfg = JC.tiny_clip_vision_config()
    tree, tparams = _vision(jcfg, seed=2)
    img = np.random.default_rng(3).uniform(-1, 1, (1, 3) + hw).astype(np.float32)
    _close(TC.preprocess_image(torch.from_numpy(img), _tcfg(jcfg, TC.CLIPVisionConfig)),
           JC.preprocess_image(jnp.asarray(img), jcfg))
    want = JC.encode_image(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(img))
    got = TC.encode_image(tparams, _tcfg(jcfg, TC.CLIPVisionConfig), torch.from_numpy(img))
    _close(got, want)


@pytest.mark.parametrize("src,dst", [((480, 832), (224, 224)), ((37, 53), (480, 832)),
                                     ((300, 200), (480, 832)), ((9, 16), (9, 5))],
                         ids=["clip-down", "up", "mixed", "one-axis"])
def test_resize_bicubic_matches_jax(src, dst):
    """The separable weights against ``jax.image.resize(method="bicubic")``
    (Keys a = -0.5, antialiased when downscaling): the run_t2v input resize
    and CLIP's."""
    img = np.random.default_rng(4).uniform(-1, 1, (1, 3) + src).astype(np.float32)
    want = jax.image.resize(jnp.asarray(img), (1, 3) + dst, method="bicubic")
    got = TC.resize_bicubic(torch.from_numpy(img), *dst)
    # JAX's float32 contraction on the CPU reads up to 1.75e-5 from the same
    # weights contracted in float64 ("mixed"); the port's, 2.3e-7
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=5e-5)
    wh, ww = (TC._cubic_weights(a, b, "cpu").double().numpy() for a, b in zip(src, dst))
    exact = np.einsum("bchw,hH,wW->bcHW", img.astype(np.float64), wh, ww, optimize=True)
    np.testing.assert_allclose(got.numpy(), exact, rtol=0, atol=1e-6)
    # not PyTorch's bicubic: a = -0.75 and no antialias
    ti = torch.nn.functional.interpolate(torch.from_numpy(img), size=dst, mode="bicubic",
                                         align_corners=False)
    assert (ti - got).abs().max().item() > 1e-3


def _text(jcfg, seed=0):
    tree = jax.tree.map(np.asarray, JC.init_clip_text_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
                        tree)
    return tree, clip_text_params_from_jax(tree)


def _ids(cfg):
    ids = np.random.default_rng(6).integers(2, cfg.vocab_size, (2, 12))
    ids[0, 8:] = cfg.pad_id  # ragged padding
    ids[1, 5:] = cfg.pad_id
    return ids


@pytest.mark.parametrize("post_norm", [True, False])
def test_clip_text_forward_matches_jax(post_norm):
    jcfg = dataclasses.replace(JC.tiny_clip_text_config(), post_norm=post_norm)
    tcfg = _tcfg(jcfg, TC.CLIPTextConfig)
    tree, tparams = _text(jcfg, seed=5)
    ids = _ids(jcfg)
    jtree = jax.tree.map(jnp.asarray, tree)
    _close(TC.xlm_roberta_forward(tparams, tcfg, torch.from_numpy(ids)),
           JC.xlm_roberta_forward(jtree, jcfg, jnp.asarray(ids)))
    got = TC.clip_text_forward(tparams, tcfg, torch.from_numpy(ids))
    assert tuple(got.shape) == (2, jcfg.out_dim)
    _close(got, JC.clip_text_forward(jtree, jcfg, jnp.asarray(ids)))


def _vision_sd(cfg, rng):
    d, p, mid = cfg.dim, cfg.patch_size, cfg.dim * cfg.mlp_ratio
    sd = {"visual.patch_embedding.weight": (d, 3, p, p), "visual.cls_embedding": (1, 1, d),
          "visual.pos_embedding": (1, cfg.num_patches + 1, d)}
    for n in ("pre_norm", "post_norm"):
        sd[f"visual.{n}.weight"] = sd[f"visual.{n}.bias"] = (d,)
    for i in range(cfg.num_layers):
        pre = f"visual.transformer.{i}"
        for name, (o, k) in {"attn.to_qkv": (3 * d, d), "attn.proj": (d, d),
                             "mlp.0": (mid, d), "mlp.2": (d, mid)}.items():
            sd[f"{pre}.{name}.weight"], sd[f"{pre}.{name}.bias"] = (o, k), (o,)
        for n in ("norm1", "norm2"):
            sd[f"{pre}.{n}.weight"] = sd[f"{pre}.{n}.bias"] = (d,)
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for k, s in sd.items()}


def _text_sd(cfg, rng):
    d, mid = cfg.dim, (cfg.dim + cfg.out_dim) // 2
    sd = {"textual.token_embedding.weight": (cfg.vocab_size, d),
          "textual.type_embedding.weight": (cfg.type_size, d),
          "textual.pos_embedding.weight": (cfg.max_seq_len, d),
          "textual.norm.weight": (d,), "textual.norm.bias": (d,),
          "textual.head.0.weight": (mid, d), "textual.head.2.weight": (cfg.out_dim, mid)}
    for i in range(cfg.num_layers):
        pre = f"textual.blocks.{i}"
        for name, (o, k) in {"attn.q": (d, d), "attn.k": (d, d), "attn.v": (d, d),
                             "attn.o": (d, d), "ffn.0": (4 * d, d), "ffn.2": (d, 4 * d)}.items():
            sd[f"{pre}.{name}.weight"], sd[f"{pre}.{name}.bias"] = (o, k), (o,)
        for n in ("norm1", "norm2"):
            sd[f"{pre}.{n}.weight"] = sd[f"{pre}.{n}.bias"] = (d,)
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for k, s in sd.items()}


@pytest.mark.parametrize("tdt,jdt", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("tower", ["vision", "text"])
def test_clip_converters_bit_equal_to_jax(tower, tdt, jdt):
    rng = np.random.default_rng(7)
    if tower == "vision":
        jcfg = JC.tiny_clip_vision_config()
        sd = _vision_sd(jcfg, rng)
        got = TC.clip_vision_params_from_torch(sd, _tcfg(jcfg, TC.CLIPVisionConfig), tdt)
        jtree = JC.clip_vision_params_from_torch(sd, jcfg, jdt)
        want = clip_vision_params_from_jax(
            jax.tree.map(lambda a: np.asarray(a, np.float32), jtree), tdt)
        ref = TC.init_clip_vision_params(_tcfg(jcfg, TC.CLIPVisionConfig))
    else:
        jcfg = JC.tiny_clip_text_config()
        sd = _text_sd(jcfg, rng)
        got = TC.clip_text_params_from_torch(sd, _tcfg(jcfg, TC.CLIPTextConfig), tdt)
        jtree = JC.clip_text_params_from_torch(sd, jcfg, jdt)
        want = clip_text_params_from_jax(
            jax.tree.map(lambda a: np.asarray(a, np.float32), jtree), tdt)
        ref = TC.init_clip_text_params(_tcfg(jcfg, TC.CLIPTextConfig))
    assert_trees_equal(got, want)
    # the random init has the converted layout
    same = jax.tree.map(lambda a: (a.dtype, tuple(a.shape)), ref)
    assert same == jax.tree.map(lambda a: (torch.float32, tuple(a.shape)), got)


@pytest.mark.parametrize("fn", ["gelu_exact", "quick_gelu"])
@pytest.mark.parametrize("tdt,jdt", DTYPES, ids=["float32", "bfloat16"])
def test_gelus_match_jax(fn, tdt, jdt):
    x = np.random.default_rng(8).standard_normal((4, 33)).astype(np.float32) * 3
    got = getattr(TN, fn)(torch.from_numpy(x).to(tdt))
    want = getattr(JN, fn)(jnp.asarray(x).astype(jdt))
    assert got.dtype == tdt
    tol = 1e-6 if tdt == torch.float32 else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
