"""Interactive and tuned serving of the port held against the JAX pipelines
(``attn_impl="xla"``) on the tiny config: fused q RoPE, the one-shot,
eager and reactive KV-recache loops, the per-frame cache writes of a ring
that is no multiple of the block, and the ``run_interactive`` CLI.  Same
parameters (carried across by utils.params), same numpy inputs,
deterministic re-noise, float32 on the CPU."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from longlive_torch import run_interactive
from longlive_torch.config import PipelineConfig, tiny_dit_config, tiny_geometry
from longlive_torch.pipeline import InteractiveCausalInferencePipeline
from longlive_torch.utils.params import dit_params_from_jax
from longlive_tpu.config import PipelineConfig as JPipelineConfig
from longlive_tpu.config import tiny_dit_config as j_tiny, tiny_geometry as j_geom
from longlive_tpu.models import dit as JD
from longlive_tpu.pipeline import InteractiveCausalInferencePipeline as JPipeline

# float32 on both sides; 8 blocks x 5 forwards plus recache forwards of
# accumulated summation-order rounding
RTOL, ATOL = 1e-4, 2e-4

_PC = dict(num_frame_per_block=1, local_attn_size=4, sink_size=1, num_output_frames=8)


@pytest.fixture(scope="module")
def tree():
    p = JD.init_dit_params(jax.random.PRNGKey(0), j_tiny(), jnp.float32, zero_head=False)
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(5)
    cfg = tiny_dit_config()
    pes = [rng.standard_normal((1, cfg.text_len, cfg.text_dim)).astype(np.float32)
           for _ in range(3)]
    noise = rng.standard_normal((1, 8, 4, 8, 8)).astype(np.float32)
    return pes, noise


def _pipes(tree, dit=None, **pc):
    """(JAX pipeline, port pipeline) on the same parameters and config;
    ``dit`` overrides the tiny DiT config's window and block."""
    conf = {**_PC, **pc}
    jcfg = dataclasses.replace(j_tiny(), **(dit or {}))
    tcfg = dataclasses.replace(tiny_dit_config(), **(dit or {}))
    jp = JPipeline(JPipelineConfig(**conf), jax.tree.map(jnp.asarray, tree),
                   geometry=j_geom(), dit_config=jcfg, attn_impl="xla",
                   deterministic_renoise=True)
    tp = InteractiveCausalInferencePipeline(PipelineConfig(**conf), dit_params_from_jax(tree),
                                            geometry=tiny_geometry(), dit_config=tcfg,
                                            device="cpu", deterministic_renoise=True)
    return jp, tp


def _conds(jp, tp, pes):
    return ([jp.prepare_condition(jnp.asarray(p)) for p in pes],
            [tp.prepare_condition(torch.from_numpy(p)) for p in pes])


def _close(tlat, jlat):
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), rtol=RTOL, atol=ATOL)


def test_fused_rope_generation_matches_jax(tree, inputs):
    pes, noise = inputs
    jp, tp = _pipes(tree, fused_rope=True)
    jc, tc = _conds(jp, tp, pes[:1])
    _close(tp.generate_latents(torch.from_numpy(noise), tc[0]),
           jp.generate_latents(jnp.asarray(noise), jc[0]))


@pytest.mark.parametrize("fpb,local,sink,kernel_cache", [
    (1, 4, 1, False),  # kernel_cache off: the same numbers on the one layout
    (2, 5, 1, None),   # sink 1 + ring 4 with 2-frame blocks: per-frame writes
])
def test_cache_forms_match_jax(tree, inputs, fpb, local, sink, kernel_cache):
    pes, noise = inputs
    dit = dict(local_attn_size=local, sink_size=sink, num_frame_per_block=fpb)
    jp, tp = _pipes(tree, dit, num_frame_per_block=fpb, local_attn_size=local,
                    sink_size=sink, kernel_cache=kernel_cache)
    assert tp.kernel_cache == jp.kernel_cache is False
    jc, tc = _conds(jp, tp, pes[:1])
    _close(tp.generate_latents(torch.from_numpy(noise), tc[0]),
           jp.generate_latents(jnp.asarray(noise), jc[0]))


@pytest.mark.parametrize("global_sink", [False, True])
def test_interactive_oneshot_matches_jax(tree, inputs, global_sink):
    pes, noise = inputs
    jp, tp = _pipes(tree, global_sink=global_sink)
    jc, tc = _conds(jp, tp, pes[:2])
    _close(tp.generate_latents_interactive(torch.from_numpy(noise), tc, [4]),
           jp.generate_latents_interactive(jnp.asarray(noise), jc, [4]))


def test_interactive_eager_matches_jax(tree, inputs):
    """Three segments: the second switch's replay window reaches back into
    the first segment."""
    pes, noise = inputs
    jp, tp = _pipes(tree, global_sink=False, eager_recache=True)
    jc, tc = _conds(jp, tp, pes)
    _close(tp.generate_latents_interactive_scanned(torch.from_numpy(noise), tc, [4, 6]),
           jp.generate_latents_interactive_scanned(jnp.asarray(noise), jc, [4, 6]))


@pytest.mark.parametrize("global_sink,switch", [(False, 5), (True, 5), (True, 3)])
def test_reactive_matches_jax(tree, inputs, global_sink, switch):
    pes, noise = inputs
    jp, tp = _pipes(tree, global_sink=global_sink, reactive_recache_frames=2)
    jc, tc = _conds(jp, tp, pes[:2])
    tlat = tp.generate_latents_reactive(torch.from_numpy(noise), tc[0],
                                        lambda s: tc[1] if s == switch else None)
    jlat = jp.generate_latents_reactive(jnp.asarray(noise), jc[0],
                                        lambda s: jc[1] if s == switch else None)
    _close(tlat, jlat)


def test_eager_single_chunk_equals_oneshot(tree, inputs):
    """A one-chunk EagerRecache runs the one-shot recache's forward (same
    mask, offsets, write set and RoPE start), so the caches agree."""
    pes, noise = inputs
    _, tp = _pipes(tree, global_sink=False)
    tc = [tp.prepare_condition(torch.from_numpy(p)) for p in pes[:2]]
    fpb = tp.frame_block
    lat, cache = tp._block_step(tp.init_cache(1), tc[0], torch.from_numpy(noise[:, :fpb]), 0,
                                None)
    n = min(tp.cfg.local_attn_size, fpb)  # == fpb: one chunk
    one_shot = tp._recache_fn(n, False)(tp.params, cache, tc[1], lat[:, fpb - n:], fpb - n)
    er = tp.begin_eager_recache(1, switch_frame=fpb)
    assert er.feed(tc[1], lat, 0) == n
    eager = er.finish()
    for a, b in ((one_shot.k, eager.k), (one_shot.v, eager.v)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    for f in ("ring_base", "sink_filled", "ring_filled"):
        assert getattr(one_shot, f) == getattr(eager, f), f


def test_odd_recache_raises_under_kernel_cache_else_warns(tree, capsys):
    dit = dict(local_attn_size=4, sink_size=2, num_frame_per_block=2)
    pc = dict(num_frame_per_block=2, local_attn_size=4, sink_size=2)
    _, tp = _pipes(tree, dit, **pc)
    assert tp.kernel_cache  # auto: the ring invariant holds
    with pytest.raises(ValueError, match="block-aligned"):
        tp._recache_fn(3, False)
    _, tp = _pipes(tree, dit, kernel_cache=False, **pc)
    tp._recache_fn(3, False)
    assert "odd-sized recache" in capsys.readouterr().err
    assert not tp._contig


@pytest.mark.parametrize("profile", [True, False])  # one-shot loop / eager loop
def test_run_interactive_cli_writes_video(tmp_path, capsys, profile):
    cfg = {"tiny_debug": True, "model_kwargs": {"local_attn_size": 4, "sink_size": 1},
           "num_frame_per_block": 1, "num_output_frames": 6, "switch_frame_indices": "3",
           "global_sink": False, "eager_recache": True, "profile": profile,
           "output_folder": str(tmp_path / "out")}
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    (rec,) = run_interactive.main(["--config_path", str(path), "--device", "cpu"])
    assert os.path.getsize(rec["path"]) > 0
    assert tuple(rec["latents"].shape) == (1, 6, 4, 8, 8)
    assert rec["pixels"].shape[:3] == (1, 1 + 2 * 5, 3)  # the tiny VAE upsamples time 2x
    assert torch.isfinite(rec["pixels"]).all()
    assert ("recache overhead" in capsys.readouterr().out) == profile
    with pytest.raises(NotImplementedError, match="item 14"):
        run_interactive.main(["--config_path", str(path), "--device", "cpu", "--sp", "2"])
