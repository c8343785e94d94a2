"""The port's image-to-video path held against the JAX package, float32 on
the CPU at tiny sizes, the same parameters (``dit_params_from_jax``,
``vae_params_from_jax``) and inputs: the i2v DiT parameters carried across;
``prepare_img_cross_kv`` and the i2v ``bidirectional_forward``;
``build_i2v_mask`` bit-equal; ``encode_first_frame_condition`` within the
VAE's 2e-4; ``Image2VideoPipeline`` with explicit noise under UniPC and
DPM++ within 1e-4; the i2v checkpoint converter bit-equal to JAX's on a
synthetic state dict; ``load_clip_vision``'s two branches; the training
rollout conditioned on ``initial_latent``; ``run_t2v.main`` in its tiny
image-to-video mode."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longlive_torch import run_t2v
from longlive_torch.config import CacheConfig, DiTConfig, PipelineConfig, tiny_geometry
from longlive_torch.models import clip as TC
from longlive_torch.models import dit as TD
from longlive_torch.models import vae as TV
from longlive_torch.models.dit_bidirectional import bidirectional_forward, prepare_img_cross_kv
from longlive_torch.ops import scheduler as TS
from longlive_torch.ops.rope import make_rope_tables
from longlive_torch.pipeline import Image2VideoPipeline
from longlive_torch.pipeline.image2video import build_i2v_mask, encode_first_frame_condition
from longlive_torch.training import rollout as tro
from longlive_torch.utils import checkpoint as TCK
from longlive_torch.utils import loading
from longlive_torch.utils.params import dit_params_from_jax, vae_params_from_jax
from longlive_tpu.config import CacheConfig as JCacheConfig
from longlive_tpu.config import DiTConfig as JDiTConfig
from longlive_tpu.models import dit as JD
from longlive_tpu.models import vae as JV
from longlive_tpu.models.dit_bidirectional import bidirectional_forward as j_bidi
from longlive_tpu.models.dit_bidirectional import prepare_img_cross_kv as j_img_kv
from longlive_tpu.ops import scheduler as JS
from longlive_tpu.ops.rope import make_rope_tables as j_rope_tables
from longlive_tpu.pipeline.image2video import Image2VideoPipeline as JImage2Video
from longlive_tpu.pipeline.image2video import build_i2v_mask as j_mask
from longlive_tpu.pipeline.image2video import encode_first_frame_condition as j_first_frame
from longlive_tpu.training import rollout as jro
from longlive_tpu.utils import checkpoint as JCK
from test_torch_checkpoint import assert_trees_equal
from test_torch_train_step import jax_rollout_draws

TOL = 1e-4  # float32 end to end; sums in another order
VAE_TOL = 2e-4  # the port's VAE tolerance (float32 latents of magnitude ~1)
CLIP_DIM = 64
TINY = dict(dim=96, ffn_dim=128, num_heads=4, num_layers=2, in_dim=10, out_dim=4, text_dim=32,
            text_len=16, freq_dim=32, local_attn_size=-1, sink_size=0, num_frame_per_block=1,
            rope_max_pos=64, model_type="i2v", clip_dim=CLIP_DIM)  # in_dim 4 + mask 2 + z 4


@pytest.fixture(scope="module")
def model():
    jcfg = JDiTConfig(**TINY)
    tree = jax.tree.map(np.asarray, JD.init_dit_params(jax.random.PRNGKey(0), jcfg, jnp.float32,
                                                       zero_head=False))
    rng = np.random.default_rng(1)
    cond, null = (rng.standard_normal((1, jcfg.text_len, jcfg.text_dim)).astype(np.float32)
                  for _ in range(2))
    clip_fea = rng.standard_normal((1, 257, CLIP_DIM)).astype(np.float32)
    return jcfg, DiTConfig(**TINY), tree, cond, null, clip_fea


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def test_i2v_params_carry_across(model):
    """JAX's i2v tree (``k_img``, ``v_img``, ``norm_k_img`` per block, the
    ``img_emb`` projection) carried across has the layout of the port's own
    i2v init; a t2v init has none of those keys."""
    _, tcfg, tree, *_ = model
    got = dit_params_from_jax(tree)
    assert {"k_img", "v_img", "norm_k_img"} <= set(got["blocks"][0]["cross_attn"])
    assert set(got["img_emb"]) == {"ln1", "fc1", "fc2", "ln2"}
    np.testing.assert_array_equal(got["img_emb"]["fc1"]["weight"].numpy(),
                                  tree["img_emb"]["fc1"]["kernel"].T)
    np.testing.assert_array_equal(got["blocks"][1]["cross_attn"]["k_img"]["weight"].numpy(),
                                  tree["blocks"]["cross_attn"]["k_img"]["kernel"][1].T)
    assert _shapes(got) == _shapes(TD.init_dit_params(tcfg, zero_head=False))
    t2v = TD.init_dit_params(dataclasses.replace(tcfg, model_type="t2v"))
    assert "img_emb" not in t2v and "k_img" not in t2v["blocks"][0]["cross_attn"]


def test_prepare_img_cross_kv_matches_jax(model):
    jcfg, tcfg, tree, _, _, clip_fea = model
    want = j_img_kv(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(clip_fea))
    got = prepare_img_cross_kv(dit_params_from_jax(tree), tcfg, torch.from_numpy(clip_fea))
    assert tuple(got.k.shape) == (2, 1, 257, 4, 24)
    _close(got.k, want.k)
    _close(got.v, want.v)


def test_i2v_bidirectional_forward_matches_jax(model):
    """The image attention added to the text attention before the shared
    ``o`` projection, on both routes, against JAX's dense route."""
    jcfg, tcfg, tree, cond, _, clip_fea = model
    geom = tiny_geometry()
    x = np.random.default_rng(2).standard_normal(
        (1, 3, jcfg.in_dim, geom.height, geom.width)).astype(np.float32)
    t = np.asarray([600.0], np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    want = j_bidi(jp, jcfg, j_rope_tables(jcfg.head_dim, jcfg.rope_max_pos), jnp.asarray(x),
                  jnp.asarray(t), JD.prepare_cross_kv(jp, jcfg, jnp.asarray(cond), jnp.float32),
                  attn_impl="xla", cross_kv_img=j_img_kv(jp, jcfg, jnp.asarray(clip_fea)))
    tp = dit_params_from_jax(tree)
    tables = make_rope_tables(tcfg.head_dim, tcfg.rope_max_pos)
    cross = TD.prepare_cross_kv(tp, tcfg, torch.from_numpy(cond), torch.float32)
    img = prepare_img_cross_kv(tp, tcfg, torch.from_numpy(clip_fea))
    for impl in ("auto", "train_auto"):
        got = bidirectional_forward(tp, tcfg, tables, torch.from_numpy(x), torch.from_numpy(t),
                                    cross, attn_impl=impl, cross_kv_img=img)
        _close(got, want)
    without = bidirectional_forward(tp, tcfg, tables, torch.from_numpy(x), torch.from_numpy(t),
                                    cross)
    assert (without - got).abs().max().item() > 1e-3  # the image branch counts


@pytest.mark.parametrize("frames,h,w,stride", [(9, 4, 6, 4), (81, 60, 104, 4), (5, 3, 3, 2),
                                               (1, 2, 2, 4)])
def test_build_i2v_mask_bit_equal(frames, h, w, stride):
    got = build_i2v_mask(frames, h, w, stride)
    want = np.asarray(j_mask(frames, h, w, stride))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def vae():
    jcfg = JV.tiny_vae_config()
    init = jax.jit(lambda key: JV.init_vae_params(key, jcfg, jnp.float32))
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(1)))
    tcfg = TV.VAEConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    return jcfg, tcfg, tree


@pytest.mark.parametrize("frames", [5, 9])
def test_encode_first_frame_condition_matches_jax(vae, frames):
    jcfg, tcfg, tree = vae
    img = np.random.default_rng(3).uniform(-1, 1, (1, 3, 16, 24)).astype(np.float32)
    want = j_first_frame(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(img), frames)
    got = encode_first_frame_condition(vae_params_from_jax(tree), tcfg, torch.from_numpy(img),
                                       frames)
    f_lat = 1 + (frames - 1) // 2
    assert tuple(got.shape) == (1, 2 + tcfg.z_dim, f_lat, 8, 12)
    np.testing.assert_array_equal(got[:, :2].numpy(), np.asarray(want)[:, :2])  # the mask
    _close(got, want, VAE_TOL)


@pytest.mark.parametrize("solver", ["unipc", "dpm++"])
def test_image2video_pipeline_matches_jax(model, solver):
    """Explicit noise, 3 steps, guide scale 5, a conditioning tensor y and
    CLIP features shared by both halves of the batch: the latents within
    1e-4."""
    jcfg, tcfg, tree, cond, null, clip_fea = model
    geom = tiny_geometry()
    rng = np.random.default_rng(4)
    noise = rng.standard_normal((1, 3, 4, geom.height, geom.width)).astype(np.float32)
    y = rng.standard_normal((1, 6, 3, geom.height, geom.width)).astype(np.float32)
    want = JImage2Video(jax.tree.map(jnp.asarray, tree), jcfg, attn_impl="xla").generate_latents(
        jnp.asarray(cond), jnp.asarray(null), jnp.asarray(clip_fea), jnp.asarray(y),
        noise=jnp.asarray(noise), sampling_steps=3, solver=solver, dtype=jnp.float32)
    pipe = Image2VideoPipeline(dit_params_from_jax(tree), tcfg, device="cpu")
    got = pipe.generate_latents(torch.from_numpy(cond), torch.from_numpy(null),
                                torch.from_numpy(clip_fea), torch.from_numpy(y),
                                torch.from_numpy(noise), sampling_steps=3, solver=solver,
                                dtype=torch.float32)
    assert tuple(got.shape) == noise.shape
    _close(got, want)
    with pytest.raises(ValueError):
        Image2VideoPipeline(dit_params_from_jax(tree), dataclasses.replace(tcfg, model_type="t2v"),
                            device="cpu")


@pytest.mark.parametrize("tdt,jdt", [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)],
                         ids=["float32", "bfloat16"])
def test_i2v_checkpoint_converter_bit_equal_to_jax(model, tdt, jdt):
    """A synthetic i2v state dict (the port's random i2v parameters written
    out by ``dit_state_dict``): the port's converter against JAX's (then
    carried across), bit for bit; and the round trip."""
    _, tcfg, *_ = model
    params = TD.init_dit_params(tcfg, torch.float32, "cpu", seed=5, zero_head=False)
    sd = TCK.dit_state_dict(params, tcfg)
    assert "img_emb.proj.3.weight" in sd and "blocks.1.cross_attn.norm_k_img.weight" in sd
    got = TCK.dit_params_from_torch(sd, tcfg, tdt)
    jtree = JCK.dit_params_from_torch(sd, JDiTConfig(**TINY), jdt)
    want = dit_params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), jtree), tdt)
    assert_trees_equal(got, want)
    if tdt == torch.float32:
        assert_trees_equal(TCK.dit_params_from_torch(sd, tcfg, torch.float32), params)


def test_load_clip_vision_file_and_random_branches(tmp_path, monkeypatch, capsys):
    """``wan_models/<name>/models_clip_...pth`` through
    ``clip_vision_params_from_torch``; without it, a random init with a
    warning (at the tiny geometry, patched in for the test)."""
    monkeypatch.chdir(tmp_path)
    tiny = TC.tiny_clip_vision_config()
    monkeypatch.setattr(TC, "CLIPVisionConfig", lambda: tiny)
    config = PipelineConfig(model_name="Wan2.1-I2V-tiny")
    params, ccfg = loading.load_clip_vision(config, torch.float32, "cpu")
    assert "CLIP checkpoint" in capsys.readouterr().err and ccfg.dim == 32
    sd = {f"visual.{k}": v for k, v in _clip_sd(params, ccfg).items()}
    os.makedirs(os.path.join("wan_models", config.model_name))
    torch.save(sd, os.path.join("wan_models", config.model_name,
                                "models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth"))
    got, _ = loading.load_clip_vision(config, torch.float32, "cpu")
    want = TC.clip_vision_params_from_torch(sd, ccfg, torch.float32)
    assert torch.equal(got["layers"][2]["fc2"]["weight"], want["layers"][2]["fc2"]["weight"])
    assert torch.equal(got["layers"][2]["fc2"]["weight"], params["layers"][2]["fc2"]["weight"])


def _clip_sd(params, cfg):
    """The vision tower's parameters in the reference's key layout."""
    sd = {"patch_embedding.weight": params["patch_embedding"]["weight"].reshape(
              cfg.dim, 3, cfg.patch_size, cfg.patch_size),
          "cls_embedding": params["cls_embedding"], "pos_embedding": params["pos_embedding"]}
    for n in ("pre_norm", "post_norm"):
        sd[f"{n}.weight"], sd[f"{n}.bias"] = params[n]["scale"], params[n]["bias"]
    names = {"qkv": "attn.to_qkv", "proj": "attn.proj", "fc1": "mlp.0", "fc2": "mlp.2"}
    for i, lp in enumerate(params["layers"]):
        for k, v in lp.items():
            pre = f"transformer.{i}.{names.get(k, k)}"
            sd[f"{pre}.weight"] = v["weight"] if "weight" in v else v["scale"]
            sd[f"{pre}.bias"] = v["bias"]
    return sd


def test_rollout_initial_latent_matches_jax():
    """One conditioning frame committed at t = 0, then three one-frame
    blocks through a 4-frame cache (sink 1, window 3), exit step 1: the
    latents and the cache's fill against JAX's, and the conditioning
    frame changes the latents."""
    from longlive_torch.config import tiny_dit_config
    from longlive_tpu.config import tiny_dit_config as j_tiny

    jcfg, tcfg = j_tiny(), tiny_dit_config()
    tree = jax.tree.map(np.asarray, JD.init_dit_params(jax.random.PRNGKey(3), jcfg, jnp.float32,
                                                       zero_head=False))
    geom = tiny_geometry()
    kw = dict(shift=5.0, sigma_min=0.0, extra_one_step=True, training=True)
    jsched, tsched = JS.make_schedule(1000, **kw), TS.make_schedule(1000, **kw)
    steps = tuple(float(x) for x in JS.warp_denoising_steps(jsched, (1000, 750, 500, 250)))
    jr = jro.RolloutConfig(denoise_timesteps=steps, frame_block=1, attn_impl="xla",
                           window_frames=3)
    tr = tro.RolloutConfig(denoise_timesteps=steps, frame_block=1, window_frames=3)
    fs = geom.frame_seq_length
    jcc, tcc = JCacheConfig(1, 3, fs), CacheConfig(1, 3, fs)
    rng = np.random.default_rng(6)
    noise = rng.standard_normal((1, 3, geom.channels, geom.height, geom.width)).astype(np.float32)
    init = rng.standard_normal((1, 1, geom.channels, geom.height, geom.width)).astype(np.float32)
    pe = rng.standard_normal((1, tcfg.text_len, tcfg.text_dim)).astype(np.float32)
    key, exit_idx = jax.random.PRNGKey(8), 1
    jp = jax.tree.map(jnp.asarray, tree)
    jl, jcache, _ = jro.rollout_trajectory(
        jp, jcfg, jcc, j_rope_tables(jcfg.head_dim, jcfg.rope_max_pos), jsched, jr,
        jnp.asarray(noise), JD.prepare_cross_kv(jp, jcfg, jnp.asarray(pe), jnp.float32), key,
        exit_idx, initial_latent=jnp.asarray(init))
    draws = jax_rollout_draws(key, 3, exit_idx, (1, 1) + noise.shape[2:])
    tp = dit_params_from_jax(tree)
    cross = TD.prepare_cross_kv(tp, tcfg, torch.from_numpy(pe), torch.float32)
    tables = make_rope_tables(tcfg.head_dim, tcfg.rope_max_pos)
    args = (tp, tcfg, tcc, tables, tsched, tr, torch.from_numpy(noise), cross, draws, exit_idx)
    with torch.no_grad():
        tl, tcache = tro.rollout_trajectory(*args, initial_latent=torch.from_numpy(init))
        plain, _ = tro.rollout_trajectory(*args)
    _close(tl, jl)
    assert (tcache.sink_filled, tcache.ring_filled) == (int(jcache.sink_filled),
                                                        int(jcache.ring_filled)) == (1, 3)
    assert (tl - plain).abs().max().item() > 1e-3


def test_run_t2v_tiny_image_to_video(tmp_path):
    """``--image`` (read with imageio, 24 x 24, resized to 16 x 16) through
    CLIP, the first-frame encode and DPM++."""
    import imageio.v2 as imageio

    img = str(tmp_path / "seed.png")
    imageio.imwrite(img, (np.random.default_rng(7).random((24, 24, 3)) * 255).astype("uint8"))
    rec = run_t2v.main(["--prompt", "a red fox", "--tiny_debug", "--size", "16x16",
                        "--frame_num", "5", "--steps", "3", "--image", img, "--solver", "dpm++",
                        "--output", str(tmp_path / "i2v.mp4"), "--device", "cpu"])
    assert os.path.exists(rec["path"]) and os.path.getsize(rec["path"]) > 0
    assert tuple(rec["latents"].shape) == (1, 3, 4, 8, 8)
    assert tuple(rec["pixels"].shape) == (1, 5, 3, 16, 16)
    assert torch.isfinite(rec["pixels"]).all()
