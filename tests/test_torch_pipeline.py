"""``generate_latents`` of the port held against the JAX pipeline on the
tiny config for 8 frames (the 1 + 3 frame cache wraps twice), with the same
parameters and noise and deterministic re-noise, float32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longlive_torch.config import PipelineConfig, tiny_dit_config, tiny_geometry
from longlive_torch.pipeline import CausalInferencePipeline
from longlive_torch.utils.params import dit_params_from_jax
from longlive_tpu.config import PipelineConfig as JPipelineConfig
from longlive_tpu.models import dit as JD
from longlive_tpu.pipeline import CausalInferencePipeline as JPipeline

RTOL, ATOL = 1e-4, 2e-4  # float32; 8 blocks x 5 forwards of accumulated rounding

_PC = dict(num_frame_per_block=1, local_attn_size=4, sink_size=1, num_output_frames=8,
           global_sink=False)


@pytest.mark.parametrize("reuse", [False, True])
def test_generate_latents_matches_jax(reuse):
    from longlive_tpu.config import tiny_dit_config as j_tiny, tiny_geometry as j_geom

    jcfg = j_tiny()
    tree = jax.tree.map(np.asarray,
                        JD.init_dit_params(jax.random.PRNGKey(0), jcfg, jnp.float32,
                                           zero_head=False))
    jpipe = JPipeline(JPipelineConfig(reuse_last_denoise_kv=reuse, **_PC),
                      jax.tree.map(jnp.asarray, tree), geometry=j_geom(), dit_config=jcfg,
                      attn_impl="xla", deterministic_renoise=True)
    assert jpipe.kernel_cache  # the JAX path the port reproduces
    tpipe = CausalInferencePipeline(PipelineConfig(reuse_last_denoise_kv=reuse, **_PC),
                                    dit_params_from_jax(tree), geometry=tiny_geometry(),
                                    dit_config=tiny_dit_config(), device="cpu",
                                    deterministic_renoise=True)
    rng = np.random.default_rng(2)
    pe = rng.standard_normal((1, jcfg.text_len, jcfg.text_dim)).astype(np.float32)
    noise = rng.standard_normal((1, 8, 4, 8, 8)).astype(np.float32)

    jlat = jpipe.generate_latents(jnp.asarray(noise), jpipe.prepare_condition(jnp.asarray(pe)))
    tlat = tpipe.generate_latents(torch.from_numpy(noise),
                                  tpipe.prepare_condition(torch.from_numpy(pe)))
    assert tlat.shape == noise.shape
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), rtol=RTOL, atol=ATOL)


def test_unported_knobs_raise():
    params = {"patch_embedding": {"weight": torch.zeros(1)}}
    for knob in (dict(kv_int8=True), dict(fused_rope=True), dict(kernel_cache=False),
                 dict(switch_frame_indices=(4,))):
        with pytest.raises(NotImplementedError):
            CausalInferencePipeline(PipelineConfig(**{**_PC, **knob}), params,
                                    dit_config=tiny_dit_config(), device="cpu")
