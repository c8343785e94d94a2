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


def test_training_conversions_and_weights():
    """convert_x0_to_flow / _noise, training_weight / _target against the
    JAX scheduler (the training schedule's weights are compared above)."""
    ts, js = _sched_pair()
    rng = np.random.default_rng(1)
    x0, xt = (rng.standard_normal((5, 4, 8, 8)).astype(np.float32) for _ in range(2))
    t = np.asarray([999.0, 937.5, 500.0, 20.0, 980.0], np.float32)
    tt, jt = torch.from_numpy(t), jnp.asarray(t)
    for name in ("convert_x0_to_flow", "convert_x0_to_noise"):
        np.testing.assert_allclose(
            getattr(TS, name)(ts, torch.from_numpy(x0), torch.from_numpy(xt), tt).numpy(),
            np.asarray(getattr(JS, name)(js, jnp.asarray(x0), jnp.asarray(xt), jt)),
            rtol=1e-4, atol=1e-4)  # divides by sigma, down to ~0.1 here
    np.testing.assert_allclose(TS.training_weight(ts, tt).numpy(),
                               np.asarray(JS.training_weight(js, jt)), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        TS.training_target(torch.from_numpy(x0), torch.from_numpy(xt)).numpy(),
        np.asarray(JS.training_target(jnp.asarray(x0), jnp.asarray(xt))))

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


@pytest.mark.parametrize("sink,ring,fpb,window", [(3, 18, 3, 12), (1, 5, 1, 4), (3, 9, 3, None)])
def test_validity_mask_excluding_the_block_matches_jax(sink, ring, fpb, window):
    """The training form's mask (the block's own slots excluded) through
    warm-up and ring wraps, with and without a window."""
    tcfg = CacheConfig(sink_frames=sink, ring_frames=ring, frame_seq=2)
    jcfg = JCacheConfig(sink_frames=sink, ring_frames=ring, frame_seq=2)
    tc = TK.init_cache(tcfg, 1, 1, 1, 2, torch.float32)
    jc = JK.init_cache(jcfg, 1, 1, 1, 2, jnp.float32)
    for start in range(0, 2 * (sink + ring) + fpb, fpb):
        np.testing.assert_array_equal(
            TK.validity_mask(tcfg, tc, start, fpb, window_frames=window,
                             exclude_block=True).numpy(),
            np.asarray(JK.validity_mask(jcfg, jc, start, fpb, window_frames=window,
                                        exclude_block=True)))
        tc, jc = TK.advance(tcfg, tc, start, fpb), JK.advance(jcfg, jc, start, fpb)

@pytest.mark.parametrize("sink,ring,end,n", [(3, 9, 40, 12), (3, 6, 9, 6), (1, 3, 2, 2), (2, 4, 7, 1)])
def test_recache_state_and_zero_cache(sink, ring, end, n):
    tcfg = CacheConfig(sink_frames=sink, ring_frames=ring, frame_seq=2)
    jcfg = JCacheConfig(sink_frames=sink, ring_frames=ring, frame_seq=2)
    tc = TK.init_cache(tcfg, 2, 1, 1, 4, torch.float32)
    tc.k.normal_()
    tc.v.normal_()
    tc = TK.advance(tcfg, tc, 0, sink + 2)
    jc = JK.init_cache(jcfg, 2, 1, 1, 4, jnp.float32)
    jc = JK.advance(jcfg, jc, 0, sink + 2)
    tz, jz = TK.zero_cache(tc), JK.zero_cache(jc)
    assert not tz.k.any() and not tz.v.any() and tz.k.data_ptr() == tc.k.data_ptr()
    assert (tz.ring_base, tz.sink_filled, tz.ring_filled) == (
        int(jz.ring_base), int(jz.sink_filled), int(jz.ring_filled))
    tr, jr = TK.recache_state(tcfg, tz, end, n), JK.recache_state(jcfg, jz, end, n)
    assert (tr.ring_base, tr.sink_filled, tr.ring_filled) == (
        int(jr.ring_base), int(jr.sink_filled), int(jr.ring_filled))


@pytest.mark.parametrize("offsets,write_frames", [
    ([0, 4, 8], None),           # consecutive: one copy
    ([8, 12, 4], None),          # the ring wraps inside the block
    ([0, 4, 8, 12], (1, 2, 3)),  # a recache keeping the sink frame
    ([12, 0], (0,)),
])
def test_write_block_kv_per_frame_matches_jax(offsets, write_frames):
    fs, n, d = 4, 2, 3
    cfg = CacheConfig(sink_frames=1, ring_frames=3, frame_seq=fs)
    rng = np.random.default_rng(4)
    f = len(offsets)
    new_k = rng.standard_normal((1, f * fs, n, d)).astype(np.float32)
    new_v = rng.standard_normal((1, f * fs, n, d)).astype(np.float32)
    base = rng.standard_normal((2, 1, n, cfg.size_tokens, d)).astype(np.float32)
    tc = TK.init_cache(cfg, 2, 1, n, d, torch.float32)
    tc.k.copy_(torch.from_numpy(base))
    tc.v.copy_(torch.from_numpy(-base))
    TK.write_block_kv(cfg, tc, 1, torch.from_numpy(new_k), torch.from_numpy(new_v), offsets,
                      write_frames)
    # JAX: the layer in standard layout, only the frames written
    frames = range(f) if write_frames is None else write_frames
    sel = np.concatenate([np.arange(i * fs, (i + 1) * fs) for i in frames])
    jk, jv = JK.write_block_kv(
        cfg, jnp.asarray(base[1].transpose(0, 2, 1, 3)), jnp.asarray(-base[1].transpose(0, 2, 1, 3)),
        jnp.asarray(new_k[:, sel]), jnp.asarray(new_v[:, sel]),
        jnp.asarray([offsets[i] for i in frames], jnp.int32))
    tk, tv = TK.to_standard_layout(tc)
    np.testing.assert_array_equal(tk[1].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv[1].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tk[0].numpy(), base[0].transpose(0, 2, 1, 3))
