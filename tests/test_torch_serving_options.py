"""The opt-in serving switches of the port held against the JAX package's:
``LONGLIVE_EXP2`` and ``LONGLIVE_MXU_LSUM`` in every mode of the attention
kernel's plain version (JAX: the Pallas ``_flash_kernel`` in interpret
mode), the two-segment mode with dead-tile elision and its live-tile list,
the serving two-segment cached forward (``LONGLIVE_TWO_SEGMENT``), the fused
residual block (``LONGLIVE_VAE_PAIR``) and a tiny pipeline generation plus
decode with all four switches on and ``kernel_cache: false``.  Float32 on
the CPU, the same numpy inputs on both sides."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import longlive_tpu.ops.attention as JA
from longlive_torch.config import CacheConfig, PipelineConfig, tiny_dit_config, tiny_geometry
from longlive_torch.models import dit as TD
from longlive_torch.models import vae as TV
from longlive_torch.ops import attention as TA
from longlive_torch.ops import kv_cache as TK
from longlive_torch.ops import vae_conv as TVC
from longlive_torch.ops.rope import make_rope_tables
from longlive_torch.pipeline import CausalInferencePipeline
from longlive_torch.utils.params import dit_params_from_jax, vae_params_from_jax
from longlive_tpu.config import CacheConfig as JCacheConfig
from longlive_tpu.config import PipelineConfig as JPipelineConfig
from longlive_tpu.models import dit as JD
from longlive_tpu.models import vae as JV
from longlive_tpu.ops import kv_cache as JK
from longlive_tpu.ops import vae_conv as JVC
from longlive_tpu.ops.rope import make_rope_tables as j_rope_tables
from longlive_tpu.pipeline import CausalInferencePipeline as JPipeline

ATTN_TOL = 2e-4   # attention modes and two-segment flows: softmax sums in another order
CACHE_TOL = 1e-5  # caches and the fused residual block

SWITCHES = ("LONGLIVE_TWO_SEGMENT", "LONGLIVE_EXP2", "LONGLIVE_MXU_LSUM", "LONGLIVE_VAE_PAIR")

ATTN_MODES = ["bias", "q_rope", "qk_int8 stored scales", "qk_int8", "two_segment",
              "two_segment skip_ranges", "two_segment qk_int8"]


def _set(monkeypatch, **env):
    for name, on in env.items():
        monkeypatch.setenv(name, "1" if on else "0")


@pytest.mark.parametrize("exp2,mxu_lsum", [(False, False), (True, False), (False, True),
                                           (True, True)])
@pytest.mark.parametrize("mode", ATTN_MODES)
def test_plain_flash_modes_match_pallas(monkeypatch, mode, exp2, mxu_lsum):
    """Every mode x exp2 x mxu_lsum.  The cache has 200 tokens (ragged
    against the port's 64-token and JAX's 32-token tiles), a masked tail and
    the block's slots [64, 128) masked: the two-segment cases attend the
    block's 40 tokens as segment 2, ``skip_ranges`` elides those slots."""
    rng = np.random.default_rng(21)
    b, n, d, sq, s, s2 = 1, 2, 128, 24, 200, 40
    q = rng.standard_normal((b, sq, n, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, n, d)).astype(np.float32) for _ in range(2))
    k2, v2 = (rng.standard_normal((b, s2, n, d)).astype(np.float32) for _ in range(2))
    cos, sin = (rng.uniform(-1, 1, (sq, d // 2)).astype(np.float32) for _ in range(2))
    valid = np.arange(s) < 170
    two = mode.startswith("two_segment")
    if two:
        valid[64:128] = False
    bias = np.where(valid, 0.0, -1e30).astype(np.float32)[None]
    qk_int8 = "qk_int8" in mode
    skip = [(64, 128)] if "skip_ranges" in mode else None
    heads = lambda a: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        a.transpose(0, 2, 1, 3).reshape(b * n, -1, d)))

    jk, jsc, tk, tsc = jnp.asarray(k), None, heads(k), None
    if mode == "qk_int8 stored scales":
        jk, jsc = JA.quantize_k_tokens(jnp.asarray(k))
        tk = heads(np.asarray(jk))
        tsc = torch.from_numpy(np.ascontiguousarray(
            np.asarray(jsc).transpose(0, 2, 1).reshape(b * n, s)))
    rope = (cos, sin) if mode == "q_rope" else None
    ref = JA._flash_attention_jit(
        jnp.asarray(q), jk, jnp.asarray(v), jnp.asarray(bias), 16, 32, None, qk_int8,
        jnp.asarray(k2) if two else None, jnp.asarray(v2) if two else None, jsc,
        None if skip is None else jnp.asarray(skip, jnp.int32), None,
        None if rope is None else tuple(map(jnp.asarray, rope)), True,
        exp2=exp2, mxu_lsum=mxu_lsum)

    _set(monkeypatch, LONGLIVE_EXP2=exp2, LONGLIVE_MXU_LSUM=mxu_lsum)
    TA.reset_launches()
    out = TA.flash_attention(
        torch.from_numpy(q), tk, heads(v), torch.from_numpy(bias),
        q_rope=None if rope is None else tuple(map(torch.from_numpy, rope)),
        qk_int8=qk_int8, k_scales=tsc, k2=torch.from_numpy(k2) if two else None,
        v2=torch.from_numpy(v2) if two else None, skip_ranges=skip)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=ATTN_TOL, atol=ATTN_TOL)
    assert TA.launches == 0 and not any(TA.flag_launches.values())  # CPU: no kernel


def test_flash_mode_rules():
    q = torch.zeros((1, 8, 2, 128))
    kv = torch.zeros((2, 16, 128))
    bias = torch.zeros((1, 16))
    blk = torch.zeros((1, 8, 2, 128))
    rope = (torch.zeros((8, 64)), torch.zeros((8, 64)))
    with pytest.raises(ValueError, match="q_rope"):
        TA.flash_attention(q, kv, kv, bias, q_rope=rope, k2=blk, v2=blk)
    with pytest.raises(ValueError, match="q_rope"):
        TA.flash_attention(q, kv, kv, bias, q_rope=rope, skip_ranges=[(0, 8)])
    with pytest.raises(ValueError, match="k2 and v2"):
        TA.flash_attention(q, kv, kv, bias, k2=blk)


@pytest.mark.parametrize("ranges,s", [
    ([(64, 128)], 256),                    # one tile covered exactly
    ([(70, 130), (130, 190)], 250),        # covered only across two ranges; ragged tail
    ([(10, 60)], 128),                     # inside one tile: nothing dead
    # the decode's block slots on a 12-frame cache (sink 3 + ring 9) after
    # the ring wrapped: frames at slots 11, 3 and 4
    ([(11 * 1560, 12 * 1560), (3 * 1560, 4 * 1560), (4 * 1560, 5 * 1560)], 12 * 1560),
])
def test_live_tiles_match_jax(ranges, s):
    nkv1 = -(-s // TA.KV_TILE)
    _, live = JA._skip_tile_arrays(jnp.asarray(ranges, jnp.int32).reshape(-1, 2), nkv1, 0,
                                   TA.KV_TILE)
    assert TA.live_kv_tiles(ranges, s) == [bool(x) for x in np.asarray(live)]


def _dit_pair():
    from longlive_tpu.config import tiny_dit_config as j_tiny

    tcfg, jcfg = tiny_dit_config(), j_tiny()
    tree = jax.tree.map(np.asarray, JD.init_dit_params(jax.random.PRNGKey(0), jcfg, jnp.float32,
                                                       zero_head=False))
    return tcfg, jcfg, dit_params_from_jax(tree), jax.tree.map(jnp.asarray, tree)


def test_two_segment_forward_matches_jax(monkeypatch):
    """LONGLIVE_TWO_SEGMENT=1 on a standard-layout cache, one frame per
    block over 7 frames (sink 1 + ring 3: the sink fills, the ring fills
    and wraps), each forward committing: the flow against the JAX package's
    two-segment forward with the interpreted kernel (dead-tile elision
    on), the cache against JAX's, and the flow against the port's own
    write-then-attend form.  Then ``commit_writes=False`` leaves the cache
    untouched."""
    tcfg, jcfg, tparams, jparams = _dit_pair()
    geom = tiny_geometry()
    fs = geom.frame_seq_length
    tccfg = CacheConfig(sink_frames=1, ring_frames=3, frame_seq=fs)
    jccfg = JCacheConfig(sink_frames=1, ring_frames=3, frame_seq=fs)
    ttables = make_rope_tables(tcfg.head_dim, tcfg.rope_max_pos)
    jtables = j_rope_tables(jcfg.head_dim, jcfg.rope_max_pos)
    _set(monkeypatch, LONGLIVE_TWO_SEGMENT=True)

    @jax.jit
    def jfwd(x, t, cross, cache, start):
        return JD.dit_forward_cached(jparams, jcfg, jccfg, jtables, x, t, cross, cache, start,
                                     attn_impl="pallas_interpret")

    rng = np.random.default_rng(5)
    pe = rng.standard_normal((1, tcfg.text_len, tcfg.text_dim)).astype(np.float32)
    jcross = JD.prepare_cross_kv(jparams, jcfg, jnp.asarray(pe), jnp.float32)
    tcross = TD.prepare_cross_kv(tparams, tcfg, torch.from_numpy(pe), torch.float32)
    L, N, hd = tcfg.num_layers, tcfg.num_heads, tcfg.head_dim
    jcache = JK.init_cache(jccfg, L, 1, N, hd, jnp.float32)
    tcache = TK.init_cache(tccfg, L, 1, N, hd, torch.float32)
    wcache = TK.init_cache(tccfg, L, 1, N, hd, torch.float32)
    shape = (1, 1, geom.channels, geom.height, geom.width)
    for start in range(7):
        x = rng.standard_normal(shape).astype(np.float32)
        t = np.full((1, 1), 500.0, np.float32)
        jflow, jcache = jfwd(jnp.asarray(x), jnp.asarray(t), jcross, jcache,
                             jnp.asarray(start, jnp.int32))
        args = (tparams, tcfg, tccfg, ttables, torch.from_numpy(x), torch.from_numpy(t), tcross)
        tflow, tcache = TD.dit_forward_cached(*args, tcache, start)
        wflow, wcache = TD.dit_forward_cached(*args, wcache, start, serving_two_segment=False)
        np.testing.assert_allclose(tflow.numpy(), np.asarray(jflow), rtol=ATTN_TOL,
                                   atol=ATTN_TOL)
        np.testing.assert_allclose(tflow.numpy(), wflow.numpy(), rtol=CACHE_TOL, atol=CACHE_TOL)
    tk, tv = TK.to_standard_layout(tcache)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jcache.k), rtol=CACHE_TOL, atol=CACHE_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jcache.v), rtol=CACHE_TOL, atol=CACHE_TOL)
    np.testing.assert_allclose(tcache.k.numpy(), wcache.k.numpy(), rtol=CACHE_TOL,
                               atol=CACHE_TOL)
    assert (tcache.sink_filled, tcache.ring_filled) == (
        int(jcache.sink_filled), int(jcache.ring_filled))

    fresh = TK.init_cache(tccfg, L, 1, N, hd, torch.float32)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    t = torch.full((1, 1), 500.0)
    flow_c, kept = TD.dit_forward_cached(tparams, tcfg, tccfg, ttables, x, t, tcross, fresh, 0,
                                         commit_writes=False)
    assert float(kept.k.abs().max()) == 0.0 and float(kept.v.abs().max()) == 0.0
    flow_w, _ = TD.dit_forward_cached(tparams, tcfg, tccfg, ttables, x, t, tcross, fresh, 0)
    np.testing.assert_allclose(flow_c.numpy(), flow_w.numpy(), rtol=1e-6, atol=1e-6)
    # kernel_cache keeps the write-then-attend form, as the JAX package's
    # kernel-layout cache does
    with pytest.raises(ValueError, match="kernel_cache"):
        TD.dit_forward_cached(tparams, tcfg, tccfg, ttables, x, t, tcross, fresh, 0,
                              serving_two_segment=True, kernel_cache=True)


def _pair_inputs(rng, t, c, h, w):
    """Random block inputs; the weights at the decoder's scale, std
    1 / sqrt(27 C) (``init_vae_params``' fan-in rule)."""
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    std = 1.0 / np.sqrt(27 * c)
    return dict(x=f32(t, h, w, c), cache1=f32(2, h, w, c), cache2=f32(2, h, w, c),
                w1=f32(c, c, 3, 3, 3) * std, b1=f32(c), gamma1=f32(c),
                w2=f32(c, c, 3, 3, 3) * std, b2=f32(c), gamma2=f32(c))


@pytest.mark.parametrize("t", [1, 2, 4])
def test_fused_res_block_plain_matches_pallas(t):
    """Two chunks of T frames, each chunk's new caches threaded into the
    next (T = 1: the new caches are [old frame 1, the new frame])."""
    rng = np.random.default_rng(30 + t)
    c, h, w = 96, 8, 16
    a = _pair_inputs(rng, t, c, h, w)
    jc1, jc2 = jnp.asarray(a["cache1"]), jnp.asarray(a["cache2"])
    tc1, tc2 = torch.from_numpy(a["cache1"]), torch.from_numpy(a["cache2"])
    params = {k: a[k] for k in ("w1", "b1", "gamma1", "w2", "b2", "gamma2")}
    for chunk in range(2):
        x = a["x"] if chunk == 0 else rng.standard_normal((t, h, w, c)).astype(np.float32)
        jout, jc1, jc2 = JVC.fused_res_block(jnp.asarray(x), jc1, jc2,
                                             **{k: jnp.asarray(v) for k, v in params.items()},
                                             interpret=True)
        tout, tc1, tc2 = TVC.fused_res_block(torch.from_numpy(x), tc1, tc2,
                                             **{k: torch.from_numpy(v) for k, v in params.items()})
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout)[..., :c], atol=CACHE_TOL)
        np.testing.assert_allclose(tc1.numpy(), np.asarray(jc1)[..., :c], atol=CACHE_TOL)
        np.testing.assert_allclose(tc2.numpy(), np.asarray(jc2)[..., :c], atol=CACHE_TOL)
        jc1, jc2 = jc1[..., :c], jc2[..., :c]
    assert TVC.pair_launches == 0  # CPU tensors never reach the kernel


@pytest.mark.parametrize("t", [1, 2])
def test_res_block_pair_dispatch_matches_jax(monkeypatch, t):
    """``res_block`` under LONGLIVE_VAE_PAIR=1 against the JAX package's
    (its pair kernel interpreted), and against the port's two-conv chain:
    the same output and the same two threaded cache entries."""
    rng = np.random.default_rng(40 + t)
    c, h, w = 96, 8, 16
    a = _pair_inputs(rng, t, c, h, w)
    p = {"norm1": a["gamma1"], "norm2": a["gamma2"],
         "conv1": {"w": a["w1"], "b": a["b1"]}, "conv2": {"w": a["w2"], "b": a["b2"]}}
    caches = [a["cache1"][None], a["cache2"][None]]
    monkeypatch.setenv("LONGLIVE_VAE_FUSED", "interpret")
    _set(monkeypatch, LONGLIVE_VAE_PAIR=True)
    jth = JV._CacheThread([jnp.asarray(cc) for cc in caches])
    jout = JV.res_block(jnp.asarray(a["x"][None]), jax.tree.map(jnp.asarray, p), jth)
    tp = jax.tree.map(torch.from_numpy, p)
    tth = TV._CacheThread([torch.from_numpy(cc) for cc in caches])
    tout = TV.res_block(torch.from_numpy(a["x"][None]), tp, tth)
    assert TV._pair_fusable(torch.from_numpy(a["x"][None]), tp, tth)
    _set(monkeypatch, LONGLIVE_VAE_PAIR=False)
    cth = TV._CacheThread([torch.from_numpy(cc) for cc in caches])
    chain = TV.res_block(torch.from_numpy(a["x"][None]), tp, cth)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout)[..., :c], atol=CACHE_TOL)
    np.testing.assert_array_equal(tout.numpy(), chain.numpy())
    assert len(tth.out) == len(jth.out) == len(cth.out) == 2
    for mine, theirs, own in zip(tth.out, jth.out, cth.out):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs)[..., :c], atol=CACHE_TOL)
        np.testing.assert_array_equal(mine.numpy(), own.numpy())


def test_pair_gate_rules(monkeypatch):
    c = 96
    conv = lambda: {"w": torch.zeros((c, c, 3, 3, 3)), "b": torch.zeros(c)}  # noqa: E731
    p = {"norm1": torch.ones(c), "norm2": torch.ones(c), "conv1": conv(), "conv2": conv()}
    x = torch.zeros((1, 1, 8, 8, c))
    th = TV._CacheThread([torch.zeros((1, 2, 8, 8, c))] * 2)
    _set(monkeypatch, LONGLIVE_VAE_PAIR=True)
    assert TV._pair_fusable(x, p, th)
    assert not TV._pair_fusable(x, p, TV._CacheThread(None))  # uncached decode
    assert not TV._pair_fusable(x, dict(p, shortcut=conv()), th)
    assert not TV._pair_fusable(x, dict(p, conv2={"w": p["conv2"]["w"]}), th)  # no bias
    monkeypatch.setenv("LONGLIVE_VAE_INT8", "1")
    assert not TV._pair_fusable(x, p, th)
    monkeypatch.setenv("LONGLIVE_VAE_INT8", "0")
    _set(monkeypatch, LONGLIVE_VAE_PAIR=False)
    assert not TV._pair_fusable(x, p, th)
    # the kernel's tile rule: norm2 in conv1's epilogue where one CTA's N
    # covers C (96, 192), else a norm pass after K2's conv1; conv2 is K2's
    assert TVC.pair_tiles(60, 104, 384)[0].bn == TVC.pair_tiles(120, 208, 384)[0].bn == 96
    assert TVC.pair_tiles(480, 832, 96)[0].bn == 96 and TVC.pair_tiles(240, 416, 192)[0].bn == 192
    assert TVC.pair_tiles(240, 416, 192)[1] == TVC.conv_tiles(240, 416, 192, 192, 3)


def test_serving_options_pipeline_matches_jax(monkeypatch):
    """A tiny generation (6 frames, the 1 + 3 frame cache wraps) plus its
    decode with all four switches on and ``kernel_cache: false``, against
    the JAX pipeline with the same switches, its kernels interpreted and
    deterministic re-noise.  The decoder is widened to dim 64: its middle
    and first stage run at 128 channels, so their four res blocks take the
    port's pair path; the JAX package's decoder, whose fused kernels run
    only on a TPU or interpreted, takes its plain path here (its pair
    kernel is held to the port's in the tests above)."""
    from longlive_tpu.config import tiny_geometry as j_geom

    _set(monkeypatch, **{name: True for name in SWITCHES})
    monkeypatch.setenv("LONGLIVE_VAE_FUSED", "interpret")
    monkeypatch.setenv("LONGLIVE_AOT", "0")  # no executable cached under other switches
    pc = dict(num_frame_per_block=1, local_attn_size=4, sink_size=1, num_output_frames=6,
              global_sink=False, kernel_cache=False)
    tcfg, jcfg, tparams, jparams = _dit_pair()
    jpipe = JPipeline(JPipelineConfig(**pc), jparams, geometry=j_geom(), dit_config=jcfg,
                      attn_impl="pallas_interpret", deterministic_renoise=True)
    tpipe = CausalInferencePipeline(PipelineConfig(**pc), tparams, geometry=tiny_geometry(),
                                    dit_config=tcfg, device="cpu", deterministic_renoise=True)
    assert not jpipe.kernel_cache and not tpipe.kernel_cache
    rng = np.random.default_rng(6)
    pe = rng.standard_normal((1, jcfg.text_len, jcfg.text_dim)).astype(np.float32)
    noise = rng.standard_normal((1, 6, 4, 8, 8)).astype(np.float32)
    jlat = jpipe.generate_latents(jnp.asarray(noise), jpipe.prepare_condition(jnp.asarray(pe)))
    tlat = tpipe.generate_latents(torch.from_numpy(noise),
                                  tpipe.prepare_condition(torch.from_numpy(pe)))
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), rtol=ATTN_TOL, atol=ATTN_TOL)

    jvcfg = dataclasses.replace(JV.tiny_vae_config(), dim=64, z_dim=4)
    tvcfg = dataclasses.replace(TV.tiny_vae_config(), dim=64, z_dim=4)
    tree = jax.tree.map(np.asarray, jax.jit(
        functools.partial(JV.init_vae_params, cfg=jvcfg, dtype=jnp.float32))(
            jax.random.PRNGKey(1)))
    monkeypatch.delenv("LONGLIVE_VAE_FUSED")
    z = np.array(jlat)[:, :2]
    jpx = jax.jit(lambda p_, z_: JV.vae_decode(p_, jvcfg, z_))(jax.tree.map(jnp.asarray, tree),
                                                               jnp.asarray(z))
    plain, calls = TVC.fused_res_block_plain, []
    monkeypatch.setattr(TVC, "fused_res_block_plain", lambda *a: calls.append(1) or plain(*a))
    tpx = TV.vae_decode(vae_params_from_jax(tree), tvcfg, torch.from_numpy(z))
    np.testing.assert_allclose(tpx.numpy(), np.asarray(jpx), atol=ATTN_TOL)
    assert len(calls) == 4 * 2  # 4 no-shortcut 128-channel blocks per latent frame
