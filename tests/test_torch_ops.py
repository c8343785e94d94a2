"""Scheduler, embeddings, RoPE and the KV-cache index math of the port held
against the JAX package on the same inputs (float32, CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longlive_torch.config import CacheConfig
from longlive_torch.ops import embeddings as TE
from longlive_torch.ops import kv_cache as TK
from longlive_torch.ops import rope as TR
from longlive_torch.ops import scheduler as TS
from longlive_tpu.config import CacheConfig as JCacheConfig
from longlive_tpu.ops import embeddings as JE
from longlive_tpu.ops import kv_cache as JK
from longlive_tpu.ops import rope as JR
from longlive_tpu.ops import scheduler as JS

RTOL, ATOL = 1e-5, 1e-5  # float32 elementwise math on both sides


def _sched_pair():
    kw = dict(shift=5.0, sigma_min=0.0, extra_one_step=True, training=True)
    return TS.make_schedule(1000, **kw), JS.make_schedule(1000, **kw)


def test_schedule_tables_and_warp():
    ts, js = _sched_pair()
    for f in ("sigmas", "timesteps", "weights"):
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                   rtol=RTOL, atol=ATOL)
    steps = [1000, 750, 500, 250]
    np.testing.assert_allclose(TS.warp_denoising_steps(ts, steps),
                               JS.warp_denoising_steps(js, steps), rtol=RTOL)


def test_add_noise_and_flow_to_x0():
    ts, js = _sched_pair()
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((6, 4, 8, 8)).astype(np.float32)
    noise = rng.standard_normal((6, 4, 8, 8)).astype(np.float32)
    t = np.asarray([999.0, 937.5, 833.3, 625.0, 0.0, 400.2], np.float32)
    np.testing.assert_allclose(
        TS.add_noise(ts, torch.from_numpy(x0), torch.from_numpy(noise), torch.from_numpy(t)).numpy(),
        np.asarray(JS.add_noise(js, jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        TS.convert_flow_to_x0(ts, torch.from_numpy(noise), torch.from_numpy(x0),
                              torch.from_numpy(t)).numpy(),
        np.asarray(JS.convert_flow_to_x0(js, jnp.asarray(noise), jnp.asarray(x0), jnp.asarray(t))),
        rtol=RTOL, atol=ATOL)


def test_sinusoidal_embedding():
    pos = np.asarray([0.0, 1.5, 250.0, 999.0], np.float32)
    np.testing.assert_allclose(TE.sinusoidal_embedding_1d(256, torch.from_numpy(pos)).numpy(),
                               np.asarray(JE.sinusoidal_embedding_1d(256, jnp.asarray(pos))),
                               rtol=1e-4, atol=1e-4)  # sin/cos of angles up to ~1e3


@pytest.mark.parametrize("head_dim,start", [(128, 0), (128, 7), (24, 3)])
def test_rope_halfsplit_premul(head_dim, start):
    tt, jt = TR.make_rope_tables(head_dim, 64), JR.make_rope_tables(head_dim, 64)
    f, h, w, n = 2, 3, 4, 2
    tc, tsn = TR.rope_multipliers(tt, f, h, w, start)
    jc, jsn = JR.rope_multipliers(jt, f, h, w, start)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tsn.numpy(), np.asarray(jsn), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(TR.halfsplit_qk_perm(head_dim, n),
                                  JR.halfsplit_qk_perm(head_dim, n))
    rng = np.random.default_rng(1)
    s = f * h * w
    x = rng.standard_normal((1, s, n, head_dim)).astype(np.float32)
    pre = rng.standard_normal((1, s, n * head_dim)).astype(np.float32)
    for layout in ("halfsplit", "interleaved"):
        out_t = TR.apply_rotary(torch.from_numpy(x), tc, tsn, premul=torch.from_numpy(pre),
                                layout=layout)
        out_j = JR.apply_rotary(jnp.asarray(x), jc, jsn, premul=jnp.asarray(pre), layout=layout)
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("sink,ring,fpb,fs", [(3, 9, 3, 5), (1, 3, 1, 4), (2, 4, 2, 3)])
def test_cache_index_math_through_warmup_and_ring_wrap(sink, ring, fpb, fs):
    """Blocks march past several ring wraps; offsets, masks (with and without
    a window cap) and the counters agree with the JAX cache at every block."""
    tcfg = CacheConfig(sink_frames=sink, ring_frames=ring, frame_seq=fs)
    jcfg = JCacheConfig(sink_frames=sink, ring_frames=ring, frame_seq=fs)
    tc = TK.init_cache(tcfg, 1, 1, 1, 2, torch.float32)
    jc = JK.init_cache(jcfg, 1, 1, 1, 2, jnp.float32)
    for start in range(0, 3 * (sink + ring) + fpb, fpb):
        assert TK.block_write_offsets(tcfg, tc, start, fpb) == [
            int(o) for o in JK.block_write_offsets(jcfg, jc, start, fpb)]
        for window in (None, sink + ring - fpb):
            np.testing.assert_array_equal(
                TK.validity_mask(tcfg, tc, start, fpb, window_frames=window).numpy(),
                np.asarray(JK.validity_mask(jcfg, jc, start, fpb, window_frames=window)))
        tc, jc = TK.advance(tcfg, tc, start, fpb), JK.advance(jcfg, jc, start, fpb)
        assert (tc.ring_base, tc.sink_filled, tc.ring_filled) == (
            int(jc.ring_base), int(jc.sink_filled), int(jc.ring_filled))
