"""Pipelined serving in the port (``generate_latents_scanned``,
``PipelinedRenderer``, ``run_inference --decode_device``) on the tiny config,
float32 on the CPU: held bit for bit against the port's own serial path, and
against the JAX package's ``generate_latents_scanned`` / ``PipelinedRenderer``
on the same parameters and noise with deterministic re-noise (JAX's
``tests/test_serve.py`` tolerance, 2e-4; the latents at
``tests/test_torch_pipeline.py``'s)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from longlive_torch import run_inference
from longlive_torch.config import PipelineConfig, tiny_dit_config, tiny_geometry
from longlive_torch.models import vae as TV
from longlive_torch.pipeline import CausalInferencePipeline, PipelinedRenderer
from longlive_torch.utils.params import dit_params_from_jax, vae_params_from_jax

RENDER_TOL = 2e-4  # JAX's tests/test_serve.py
LAT_RTOL, LAT_ATOL = 1e-4, 2e-4  # tests/test_torch_pipeline.py

_PC = dict(denoising_step_list=(1000, 500), warp_denoising_step=True, num_frame_per_block=1,
           timestep_shift=5.0, local_attn_size=4, sink_size=1, num_output_frames=8,
           context_noise=0, global_sink=False)


@pytest.fixture(scope="module")
def setup():
    from longlive_tpu.config import PipelineConfig as JPipelineConfig
    from longlive_tpu.config import tiny_dit_config as j_tiny
    from longlive_tpu.config import tiny_geometry as j_geom
    from longlive_tpu.models import dit as JD
    from longlive_tpu.models import vae as JV
    from longlive_tpu.pipeline import CausalInferencePipeline as JPipeline

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LONGLIVE_AOT", "0")  # no executable cache written by the JAX programs
        jcfg = j_tiny()
        tree = jax.tree.map(np.asarray, JD.init_dit_params(jax.random.PRNGKey(0), jcfg,
                                                           jnp.float32, zero_head=False))
        vtree = jax.tree.map(np.asarray, JV.init_vae_params(jax.random.PRNGKey(1),
                                                            JV.tiny_vae_config(), jnp.float32))
        jpipe = JPipeline(JPipelineConfig(**_PC), jax.tree.map(jnp.asarray, tree),
                          geometry=j_geom(), dit_config=jcfg, attn_impl="xla",
                          deterministic_renoise=True)
        rng = np.random.default_rng(3)
        pes = rng.standard_normal((2, 2, jcfg.text_len, jcfg.text_dim)).astype(np.float32)
        noise = rng.standard_normal((2, 8, 4, 8, 8)).astype(np.float32)
        yield dict(jpipe=jpipe, jvae=jax.tree.map(jnp.asarray, vtree), jvcfg=JV.tiny_vae_config(),
                   params=dit_params_from_jax(tree), vae=vae_params_from_jax(vtree),
                   pes=pes, noise=noise, JV=JV)


def _pipe(s, deterministic=False, **knobs):
    return CausalInferencePipeline(PipelineConfig(**{**_PC, **knobs}), s["params"],
                                   geometry=tiny_geometry(), dit_config=tiny_dit_config(),
                                   device="cpu", deterministic_renoise=deterministic)


def _gen(seed=5):
    return torch.Generator().manual_seed(seed)


def _serial_pixels(s, pipe, noise, cross, generator):
    lat = pipe.generate_latents(noise, cross, generator=generator)
    return lat, TV.vae_decode_scan(s["vae"], TV.tiny_vae_config(), lat)[0]


def test_scanned_segments_match_one_call_and_jax(setup):
    """Segments of 3, 3 and 2 frames continuing one cache (the 1 + 3 frame
    ring wraps) and one generator: the bits of one ``generate_latents``;
    with deterministic re-noise, JAX's segments within the pipeline
    tolerance."""
    s = setup
    noise, spans = torch.from_numpy(s["noise"][:1]), [(0, 3), (3, 6), (6, 8)]

    def segments(pipe, generator):
        cross, cache, outs = pipe.prepare_condition(torch.from_numpy(s["pes"][0, :1])), None, []
        for a, b in spans:
            lat, cache = pipe.generate_latents_scanned(noise[:, a:b], cross, generator, cache, a)
            outs.append(lat)
        return torch.cat(outs, dim=1)

    pipe = _pipe(s)
    want = pipe.generate_latents(noise, pipe.prepare_condition(torch.from_numpy(s["pes"][0, :1])),
                                 generator=_gen())
    assert torch.equal(segments(pipe, _gen()), want)

    jpipe = s["jpipe"]
    jcross = jpipe.prepare_condition(jnp.asarray(s["pes"][0, :1]))
    jcache, jouts = None, []
    for a, b in spans:
        lat, jcache, _ = jpipe.generate_latents_scanned(jnp.asarray(s["noise"][:1, a:b]), jcross,
                                                        cache=jcache, start_frame=a)
        jouts.append(np.asarray(lat))
    np.testing.assert_allclose(segments(_pipe(s, deterministic=True), None).numpy(),
                               np.concatenate(jouts, axis=1), rtol=LAT_RTOL, atol=LAT_ATOL)


def test_render_matches_serial_and_jax(setup):
    """``render`` in segments of 2 frames: the port's serial generate +
    decode bit for bit; with deterministic re-noise, JAX's
    ``PipelinedRenderer`` within 2e-4."""
    s = setup
    noise = torch.from_numpy(s["noise"][:1, :6])
    pipe = _pipe(s)
    cross = pipe.prepare_condition(torch.from_numpy(s["pes"][0, :1]))
    _, want = _serial_pixels(s, pipe, noise, cross, _gen())
    renderer = PipelinedRenderer(pipe, s["vae"], TV.tiny_vae_config(), segment_frames=2)
    assert renderer.decode_device == torch.device("cpu")
    got = renderer.render(noise, cross, generator=_gen(), dtype=torch.float32)
    assert torch.equal(got, want)

    from longlive_tpu.pipeline import PipelinedRenderer as JRenderer

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LONGLIVE_AOT", "0")
        jr = JRenderer(s["jpipe"], s["jvae"], s["jvcfg"], segment_frames=2,
                       decode_device=jax.devices()[0])
        jpx = jr.render(jnp.asarray(s["noise"][:1, :6]),
                        s["jpipe"].prepare_condition(jnp.asarray(s["pes"][0, :1])),
                        dtype=jnp.float32)
    dpipe = _pipe(s, deterministic=True)
    got = PipelinedRenderer(dpipe, s["vae"], TV.tiny_vae_config(), segment_frames=2).render(
        noise, dpipe.prepare_condition(torch.from_numpy(s["pes"][0, :1])),
        dtype=torch.float32)
    assert got.shape == jpx.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(jpx), rtol=RENDER_TOL, atol=RENDER_TOL)


def test_per_stream_decode_matches_batched(setup):
    """B = 2 decoded as two B = 1 chains with their own conv caches: the
    batched decode's pixels (the VAE mixes no samples), within JAX's
    tolerance: the CPU's convolutions sum in an order that depends on the
    batch (1.5e-6 apart here)."""
    s = setup
    noise = torch.from_numpy(s["noise"][:, :6])
    pipe = _pipe(s)
    cross = pipe.prepare_condition(torch.from_numpy(s["pes"][0]))
    _, want = _serial_pixels(s, pipe, noise, cross, _gen())
    got = PipelinedRenderer(pipe, s["vae"], TV.tiny_vae_config(), segment_frames=2,
                            per_stream_decode=True).render(noise, cross, generator=_gen(),
                                                           dtype=torch.float32)
    assert got.shape == want.shape == (2, 11, 3, 16, 16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RENDER_TOL, atol=RENDER_TOL)


def test_poll_switch_matches_manual_reactive_switch(setup):
    """A switch polled at frame 4: generate 4 frames, ``reactive_switch``,
    generate 2 under the new prompt, decode; bit for bit."""
    s = setup
    noise = torch.from_numpy(s["noise"][:1, :6])
    pipe = _pipe(s)
    ca, cb = (pipe.prepare_condition(torch.from_numpy(s["pes"][i, :1])) for i in (0, 1))
    g = _gen()
    lat_a, cache = pipe.generate_latents_scanned(noise[:, :4], ca, g)
    cache = pipe.reactive_switch(cache, lat_a, cb, 4)
    lat_b, _ = pipe.generate_latents_scanned(noise[:, 4:], cb, g, cache, 4)
    want = TV.vae_decode_scan(s["vae"], TV.tiny_vae_config(), torch.cat([lat_a, lat_b], 1))[0]
    polls = []

    def poll(start):
        polls.append(start)
        return cb if start == 4 else None

    got = PipelinedRenderer(pipe, s["vae"], TV.tiny_vae_config(), segment_frames=2).render(
        noise, ca, generator=_gen(), dtype=torch.float32, poll_switch=poll)
    assert polls == [0, 2, 4]
    assert torch.equal(got, want)


def _tiny_yaml(tmp_path, **extra):
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump({
        "tiny_debug": True, "model_kwargs": {"local_attn_size": 4, "sink_size": 1},
        "num_frame_per_block": 1, "num_output_frames": 5, "profile": False,
        "output_folder": "out", **extra}))
    return str(path)


@pytest.mark.parametrize("samples", [1, 2])
def test_run_inference_decode_device_writes_the_serial_pixels(tmp_path, monkeypatch, samples):
    """The serial CLI decodes each sample alone: so does the renderer under
    ``--per_stream_decode`` (bit for bit); its batched decode of 2 samples
    is held to the tolerance above."""
    monkeypatch.chdir(tmp_path)
    cfg = _tiny_yaml(tmp_path, num_samples=samples)
    serial = run_inference.main(["--config_path", cfg, "--device", "cpu"])
    for extra in ([], ["--per_stream_decode"]):
        piped = run_inference.main(["--config_path", cfg, "--device", "cpu", "--decode_device",
                                    "0", "--segment_frames", "2"] + extra)
        assert len(piped) == len(serial) == samples
        for a, b in zip(serial, piped):
            assert a["path"] == b["path"] and os.path.getsize(b["path"]) > 0
            assert b["latents"] is None and b["decode_s"] is None and b["render_s"] > 0
            if samples == 1 or extra:
                assert torch.equal(a["pixels"], b["pixels"])
            else:
                np.testing.assert_allclose(b["pixels"].numpy(), a["pixels"].numpy(),
                                           rtol=RENDER_TOL, atol=RENDER_TOL)


def test_bad_segment_frames_raise(setup, tmp_path, monkeypatch):
    s = setup
    for seg in (0, -3):
        with pytest.raises(ValueError, match="segment_frames"):
            PipelinedRenderer(_pipe(s), s["vae"], TV.tiny_vae_config(), segment_frames=seg)
    blocky = CausalInferencePipeline(
        PipelineConfig(**{**_PC, "num_frame_per_block": 3, "local_attn_size": 6,
                          "sink_size": 3}), s["params"], geometry=tiny_geometry(),
        dit_config=tiny_dit_config(), device="cpu")
    with pytest.raises(ValueError, match="frame block 3"):
        PipelinedRenderer(blocky, s["vae"], TV.tiny_vae_config(), segment_frames=4)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="segment_frames"):
        run_inference.main(["--config_path", _tiny_yaml(tmp_path), "--device", "cpu",
                            "--decode_device", "0", "--segment_frames", "0"])


@pytest.mark.parametrize("index", ["1", "7", "-1"])
def test_decode_device_beyond_the_cpu_exits(tmp_path, monkeypatch, index):
    """With ``--device cpu`` the decode runs on the CPU: an index other than
    0 exits with an error naming it, before any parameter is built."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match=f"--decode_device {index}: with --device cpu"):
        run_inference.main(["--config_path", _tiny_yaml(tmp_path), "--device", "cpu",
                            "--decode_device", index])


def test_card_decode_takes_one_stream_at_a_time(setup, monkeypatch):
    """A decode on a card runs each of B streams as its own B = 1 chain,
    with or without ``per_stream_decode`` (K2 takes batch 1 only); the CPU
    keeps the batched decode unless asked.  The device is only named here:
    the recorded calls run the plain decode on the CPU."""
    s = setup
    lat = torch.from_numpy(s["noise"][:, :2])
    calls = []
    decode = TV.vae_decode_scan

    def record(params, cfg, z, *args):
        calls.append(z.shape[0])
        return decode(params, cfg, z, *args)

    monkeypatch.setattr(TV, "vae_decode_scan", record)
    for device, per_stream, want in (("cpu", False, [2]), ("cpu", True, [1, 1]),
                                     ("cuda", False, [1, 1]), ("cuda", True, [1, 1])):
        r = PipelinedRenderer(_pipe(s), s["vae"], TV.tiny_vae_config(), segment_frames=2,
                              per_stream_decode=per_stream)
        r.decode_device = torch.device(device)
        calls.clear()
        px, _ = r._decode(lat, None, True)
        assert calls == want and px.shape[0] == 2, (device, per_stream)
