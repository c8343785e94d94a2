"""The port's sequence-parallel cached decode (``parallel.decode_sp``, the
pipelines over an sp mesh) held against the JAX package's on the CPU: the
JAX side of ``tests/test_decode_sp.py`` and ``tests/test_serve.py``'s sp
renderer, on the 8-device CPU mesh; the port's on 4 gloo ranks, spawned
once for the module, float32, deterministic re-noise, the same parameters
(``dit_params_from_jax``) and numpy inputs.

- one ``sp_dit_forward_cached`` and the cache it writes, at sp 2 and 4
  (JAX's tolerance there, 2e-4);
- over sp 2 (two groups of 2): an 8-frame ``generate_latents`` whose ring
  wraps (window 4), an eager-recache switch (``generate_latents_interactive
  _scanned``, switches at 4 and 6), and ``PipelinedRenderer`` over 6 frames
  (segments of 2; only each group's rank 0 decodes) against the sequential
  decode of JAX's sp latents, as ``tests/test_serve.py`` holds JAX's sp
  renderer; at JAX's multi-block sp tolerance, 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from longlive_tpu.config import PipelineConfig as JPipelineConfig
from longlive_tpu.config import tiny_dit_config as j_tiny
from longlive_tpu.config import tiny_geometry as j_geom
from longlive_tpu.models import dit as JD
from longlive_tpu.models import vae as JV
from longlive_tpu.parallel import mesh as JM
from longlive_tpu.parallel.decode_sp import shard_cache, sp_dit_forward_cached
from longlive_tpu.pipeline import CausalInferencePipeline as JPipeline
from longlive_tpu.pipeline import InteractiveCausalInferencePipeline as JInteractive

from torch_dist import random_tree, start_ranks

FWD_TOL = 2e-4  # tests/test_decode_sp.py, one forward
GEN_TOL = 5e-4  # tests/test_decode_sp.py and test_serve.py, multi-block sp

_PC = dict(denoising_step_list=(1000, 500), warp_denoising_step=True,
           num_frame_per_block=1, timestep_shift=5.0, local_attn_size=4, sink_size=1,
           num_output_frames=8, context_noise=0, global_sink=False)


def _mesh(sp):
    return JM.make_mesh(dp=1, fsdp=1, sp=sp, devices=jax.devices()[:sp])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The port's side on 4 gloo ranks and, while they run, the JAX side."""
    jcfg = j_tiny()
    tree = random_tree(jax.eval_shape(lambda: JD.init_dit_params(
        jax.random.PRNGKey(0), jcfg, jnp.float32, zero_head=False)), 0)
    vtree = random_tree(jax.eval_shape(lambda: JV.init_vae_params(
        jax.random.PRNGKey(1), JV.tiny_vae_config(), jnp.float32)), 1)
    rng = np.random.default_rng(7)
    pes = [rng.standard_normal((1, jcfg.text_len, jcfg.text_dim)).astype(np.float32)
           for _ in range(3)]
    x1 = rng.standard_normal((1, 1, 4, 8, 8)).astype(np.float32)
    noise = rng.standard_normal((1, 8, 4, 8, 8)).astype(np.float32)
    params = jax.tree.map(jnp.asarray, tree)
    cross = JD.prepare_cross_kv(params, jcfg, jnp.asarray(pes[0]), jnp.float32)
    args = dict(tree=tree, vtree=vtree, pc=_PC, pes=pes, x1=x1, noise=noise,
                cross=(np.asarray(cross.k), np.asarray(cross.v)))
    ranks = start_ranks(4, "torch_dist_cases", "decode_sp_cases", args,
                        tmp_path_factory.mktemp("decode_sp"))

    want = {}
    jp = JPipeline(JPipelineConfig(**{**_PC, "kernel_cache": False}), params,
                   geometry=j_geom(), dit_config=jcfg, attn_impl="xla")
    for sp in (2, 4):
        mesh = _mesh(sp)
        flow, cache = sp_dit_forward_cached(
            params, jcfg, jp.cache_cfg, jp.tables, mesh, jnp.asarray(x1),
            jnp.full((1, 1), 750.0, jnp.float32), cross,
            shard_cache(jp.init_cache(1, jnp.float32), mesh), jnp.asarray(0, jnp.int32),
            attn_impl="xla")
        want[f"fwd_{sp}"] = tuple(np.asarray(a) for a in (flow, cache.k, cache.v))

    def jpipe(cls=JPipeline, **knobs):
        return cls(JPipelineConfig(**{**_PC, **knobs}), params, geometry=j_geom(),
                   dit_config=jcfg, attn_impl="xla", mesh=_mesh(2), deterministic_renoise=True)

    jp = jpipe()
    want["gen8"] = np.asarray(jp.generate_latents(jnp.asarray(noise),
                                                  jp.prepare_condition(jnp.asarray(pes[0]))))
    jp = jpipe(JInteractive, eager_recache=True)
    conds = [jp.prepare_condition(jnp.asarray(p)) for p in pes]
    want["eager"] = np.asarray(jp.generate_latents_interactive_scanned(
        jnp.asarray(noise), conds, [4, 6]))
    # the sp render's reference, as JAX's tests/test_serve.py takes it: the
    # sequential decode of the sp generation's latents (a causal generation's
    # first 6 frames are the 8-frame one's: the same 4-frame cache)
    want["render"] = np.asarray(JV.vae_decode_scan(
        jax.tree.map(jnp.asarray, vtree), JV.tiny_vae_config(),
        jnp.asarray(want["gen8"][:, :6]), None, True)[0])
    return dict(args=args, want=want, out=ranks.results())


@pytest.mark.parametrize("sp", [2, 4])
def test_sp_forward_and_cache_match_jax(setup, sp):
    """The flow on every rank, and the cache gathered from the ranks' head
    slices ([L, B, N, S, D] -> JAX's [L, B, S, N, D]); each rank holds N/sp
    heads, and the pipeline's kernel_cache resolves off."""
    flow, k_want, v_want = setup["want"][f"fwd_{sp}"]
    for r in range(4):
        tflow, k, v, shape, kernel_cache = setup["out"][r][f"fwd_{sp}"]
        assert shape[2] == j_tiny().num_heads // sp and kernel_cache is False
        np.testing.assert_allclose(tflow, flow, rtol=FWD_TOL, atol=FWD_TOL)
        for got, want in ((k, k_want), (v, v_want)):
            np.testing.assert_allclose(got.transpose(0, 1, 3, 2, 4), want, rtol=FWD_TOL,
                                       atol=FWD_TOL)


def test_generate_latents_ring_wrap_matches_jax(setup):
    for r in range(4):
        np.testing.assert_allclose(setup["out"][r]["gen8"], setup["want"]["gen8"], rtol=GEN_TOL,
                                   atol=GEN_TOL)


def test_eager_switch_matches_jax(setup):
    """The switch's recache goes through the sp forward (JAX's dry run did
    an eager recache on the serving pipeline)."""
    for r in range(4):
        np.testing.assert_allclose(setup["out"][r]["eager"], setup["want"]["eager"],
                                   rtol=GEN_TOL, atol=GEN_TOL)


def test_renderer_over_sp_matches_jax(setup):
    """Every rank generates; each sp group's rank 0 alone decodes; the
    pixels are JAX's sequential decode of its sp latents."""
    for r in range(4):
        got = setup["out"][r]["render"]
        if setup["out"][r]["sp_rank"] == 0:
            np.testing.assert_allclose(got, setup["want"]["render"], rtol=GEN_TOL, atol=GEN_TOL)
        else:
            assert got is None


@pytest.mark.parametrize("knob", ["kv_int8", "kernel_cache"])
def test_sp_refuses_single_card_cache_modes(setup, knob):
    """The int8 K cache and an explicit ``kernel_cache: true`` are
    single-card modes, refused with a mesh before any group is read (JAX:
    ``kv_int8`` and ``kernel_cache`` with sp raise)."""
    from longlive_torch.config import PipelineConfig, tiny_dit_config, tiny_geometry
    from longlive_torch.pipeline import CausalInferencePipeline
    from longlive_torch.utils.params import dit_params_from_jax

    with pytest.raises(ValueError, match=knob):
        CausalInferencePipeline(PipelineConfig(**{**_PC, knob: True}),
                                dit_params_from_jax(setup["args"]["tree"]),
                                geometry=tiny_geometry(), dit_config=tiny_dit_config(),
                                device="cpu", mesh=object())
