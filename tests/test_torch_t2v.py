"""The port's text-to-video sampler held against the JAX package, float32 on
the CPU at the tiny config, the same parameters (``dit_params_from_jax``)
and inputs: ``bidirectional_forward`` on both routes (``"auto"``, the
serving attention's plain version, and ``"train_auto"``) against JAX's
dense route; ``Text2VideoPipeline`` with explicit noise under UniPC and
DPM++ within 1e-4; and JAX's two behaviour tests of the pipeline (batched
CFG equals two sequential forwards, ``guide_scale=1`` ignores the negative
prompt); then ``run_t2v.main`` in its tiny text-to-video mode."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longlive_torch import run_t2v
from longlive_torch.config import tiny_dit_config, tiny_geometry
from longlive_torch.models import dit as TD
from longlive_torch.models.dit_bidirectional import bidirectional_forward
from longlive_torch.ops import attention as TA
from longlive_torch.ops import solvers as TSV
from longlive_torch.ops.rope import make_rope_tables
from longlive_torch.pipeline import Text2VideoPipeline
from longlive_torch.utils.params import dit_params_from_jax
from longlive_tpu.config import tiny_dit_config as j_tiny
from longlive_tpu.models import dit as JD
from longlive_tpu.models.dit_bidirectional import bidirectional_forward as j_bidi
from longlive_tpu.ops.rope import make_rope_tables as j_rope_tables
from longlive_tpu.pipeline.text2video import Text2VideoPipeline as JText2Video

TOL = 1e-4  # float32 end to end; sums in another order


@pytest.fixture(scope="module")
def model():
    jcfg = j_tiny()
    tree = jax.tree.map(np.asarray, JD.init_dit_params(jax.random.PRNGKey(0), jcfg, jnp.float32,
                                                       zero_head=False))
    rng = np.random.default_rng(1)
    cond = rng.standard_normal((1, jcfg.text_len, jcfg.text_dim)).astype(np.float32)
    null = rng.standard_normal((1, jcfg.text_len, jcfg.text_dim)).astype(np.float32)
    return jcfg, tiny_dit_config(), tree, cond, null


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_bidirectional_forward_routes_match_jax(model):
    """One batch-2 forward at two timesteps: ``"auto"`` (the serving
    attention's plain version, launched as its bias and cross modes on the
    card) and ``"train_auto"`` against JAX's dense route; no kernel
    launches on the CPU."""
    jcfg, tcfg, tree, cond, _ = model
    geom = tiny_geometry()
    x = np.random.default_rng(2).standard_normal(
        (2, 3, geom.channels, geom.height, geom.width)).astype(np.float32)
    t = np.asarray([900.0, 250.0], np.float32)
    pe = np.concatenate([cond, cond * 0.5])
    jp = jax.tree.map(jnp.asarray, tree)
    want = j_bidi(jp, jcfg, j_rope_tables(jcfg.head_dim, jcfg.rope_max_pos), jnp.asarray(x),
                  jnp.asarray(t), JD.prepare_cross_kv(jp, jcfg, jnp.asarray(pe), jnp.float32),
                  attn_impl="xla")
    tp = dit_params_from_jax(tree)
    tables = make_rope_tables(tcfg.head_dim, tcfg.rope_max_pos)
    cross = TD.prepare_cross_kv(tp, tcfg, torch.from_numpy(pe), torch.float32)
    TA.reset_launches()
    for impl in ("auto", "train_auto"):
        got = bidirectional_forward(tp, tcfg, tables, torch.from_numpy(x), torch.from_numpy(t),
                                    cross, attn_impl=impl)
        _close(got, want)
    assert TA.launches == 0 and not any(TA.train_launches.values())
    with pytest.raises(ValueError):
        bidirectional_forward(tp, tcfg, tables, torch.from_numpy(x), torch.from_numpy(t), cross,
                              attn_impl="xla")


@pytest.mark.parametrize("solver", ["unipc", "dpm++"])
def test_text2video_pipeline_matches_jax(model, solver):
    """Explicit noise, 3 steps, guide scale 4: the latents within 1e-4.
    The prompts are conditioned in bf16 in both packages."""
    jcfg, tcfg, tree, cond, null = model
    geom = tiny_geometry()
    noise = np.random.default_rng(3).standard_normal(
        (1, 2, geom.channels, geom.height, geom.width)).astype(np.float32)
    jpipe = JText2Video(jax.tree.map(jnp.asarray, tree), jcfg, attn_impl="xla")
    want = jpipe.generate_latents(jnp.asarray(cond), jnp.asarray(null), noise=jnp.asarray(noise),
                                  sampling_steps=3, guide_scale=4.0, solver=solver,
                                  dtype=jnp.float32)
    pipe = Text2VideoPipeline(dit_params_from_jax(tree), tcfg, device="cpu")
    got = pipe.generate_latents(torch.from_numpy(cond), torch.from_numpy(null),
                                torch.from_numpy(noise), sampling_steps=3, guide_scale=4.0,
                                solver=solver, dtype=torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == noise.shape
    _close(got, want)


def test_batched_cfg_matches_sequential_forwards(model):
    """One batch-2B forward per step equals the two sequential forwards
    (cond, then uncond) of the reference sampler."""
    _, tcfg, tree, cond, null = model
    geom = tiny_geometry()
    noise = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 2, geom.channels, geom.height, geom.width)).astype(np.float32))
    params = dit_params_from_jax(tree)
    pipe = Text2VideoPipeline(params, tcfg, device="cpu")
    got = pipe.generate_latents(torch.from_numpy(cond), torch.from_numpy(null), noise,
                                sampling_steps=3, guide_scale=4.0, dtype=torch.float32)
    ckv_c = pipe.prepare_condition(torch.from_numpy(cond))
    ckv_u = pipe.prepare_condition(torch.from_numpy(null))

    def model_fn(x, t):
        tt = torch.full((x.shape[0],), t)
        c = bidirectional_forward(params, tcfg, pipe.tables, x, tt, ckv_c)
        u = bidirectional_forward(params, tcfg, pipe.tables, x, tt, ckv_u)
        return u + 4.0 * (c - u)

    want = TSV.sample_flow(model_fn, noise, TSV.make_coefficients("unipc", 3, 5.0))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)


def test_guide_scale_one_ignores_negative_prompt(model):
    _, tcfg, tree, cond, null = model
    geom = tiny_geometry()
    noise = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 2, geom.channels, geom.height, geom.width)).astype(np.float32))
    pipe = Text2VideoPipeline(dit_params_from_jax(tree), tcfg, device="cpu")
    c = torch.from_numpy(cond)
    a = pipe.generate_latents(c, torch.from_numpy(null), noise, sampling_steps=2,
                              guide_scale=1.0, dtype=torch.float32)
    b = pipe.generate_latents(c, c * 0.0, noise, sampling_steps=2, guide_scale=1.0,
                              dtype=torch.float32)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


def test_text2video_pipeline_draws_its_noise_and_refuses_unported_options(model):
    _, tcfg, tree, cond, null = model
    geom = tiny_geometry()
    pipe = Text2VideoPipeline(dit_params_from_jax(tree), tcfg, device="cpu")
    shape = (1, 2, geom.channels, geom.height, geom.width)
    kw = dict(latent_shape=shape, sampling_steps=2)
    a = pipe.generate_latents(torch.from_numpy(cond), torch.from_numpy(null),
                              generator=torch.Generator().manual_seed(7), **kw)
    b = pipe.generate_latents(torch.from_numpy(cond), torch.from_numpy(null),
                              generator=torch.Generator().manual_seed(7), **kw)
    assert a.dtype == torch.bfloat16 and tuple(a.shape) == shape and torch.equal(a, b)
    with pytest.raises(ValueError):
        pipe.generate_latents(torch.from_numpy(cond), torch.from_numpy(null), sampling_steps=2)
    for kw in ({"mesh": object()}, {"offload_blocks": True}):
        with pytest.raises(NotImplementedError):
            Text2VideoPipeline(dit_params_from_jax(tree), tcfg, device="cpu", **kw)


def test_run_t2v_tiny_text_to_video(tmp_path):
    out = str(tmp_path / "t2v.mp4")
    rec = run_t2v.main(["--prompt", "a red fox", "--tiny_debug", "--size", "16x16",
                        "--frame_num", "5", "--steps", "3", "--output", out, "--device", "cpu"])
    assert os.path.exists(rec["path"]) and os.path.getsize(rec["path"]) > 0
    assert tuple(rec["latents"].shape) == (1, 3, 4, 8, 8)  # the tiny VAE: time stride 2
    assert tuple(rec["pixels"].shape) == (1, 5, 3, 16, 16)
    assert torch.isfinite(rec["pixels"]).all()
    for flag in (["--sp", "2"], ["--offload_blocks"]):
        with pytest.raises(NotImplementedError):
            run_t2v.main(["--prompt", "x", "--tiny_debug", "--device", "cpu"] + flag)


def test_run_t2v_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(SystemExit):
        run_t2v.main(["--prompt", "x", "--tiny_debug"])
