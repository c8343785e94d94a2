"""The quantized serving mode of the port held against the JAX package:
int8 block linears (``quantize_dit_params``, the fused kernel's plain
version under ``LONGLIVE_INT8_FUSED``), the int8 K cache (``kv_int8``) and
the int8 recache (``recache_attn_impl: pallas_qk8``), the int8 VAE convs
(``LONGLIVE_VAE_INT8=1``).  The JAX side runs its Pallas kernels
interpreted (``LONGLIVE_INT8_FUSED=interpret``, ``attn_impl=
"pallas_interpret"``, ``recache_attn_impl="pallas_qk8_interpret"``,
``LONGLIVE_VAE_FUSED=interpret``).  Same parameters (carried across by
utils.params) and numpy inputs, float32 on the CPU.

Tolerances: every integer product is exact on both sides, but the float32
activations feeding a quantizer differ by summation-order ulps, and a value
that sits on a rounding boundary then lands one int8 step away.  One step
moves an output by about its scale over 127, i.e. ~1% of the largest
element of that row, and a flip in one layer propagates through the
later ones; the limits below are stated per test against that."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longlive_torch.config import CacheConfig, LatentGeometry, PipelineConfig
from longlive_torch.config import tiny_dit_config
from longlive_torch.models import dit as TD
from longlive_torch.ops import attention as TA
from longlive_torch.ops import kv_cache as TK
from longlive_torch.ops import quant as TQ
from longlive_torch.ops.rope import make_rope_tables
from longlive_torch.pipeline import InteractiveCausalInferencePipeline
from longlive_torch.utils.params import dit_params_from_jax
from longlive_tpu.config import CacheConfig as JCacheConfig
from longlive_tpu.config import LatentGeometry as JLatentGeometry
from longlive_tpu.config import PipelineConfig as JPipelineConfig
from longlive_tpu.config import tiny_dit_config as j_tiny
from longlive_tpu.models import dit as JD
from longlive_tpu.ops import kv_cache as JK
from longlive_tpu.ops import quant as JQ
from longlive_tpu.ops.rope import make_rope_tables as j_rope_tables
from longlive_tpu.pipeline import InteractiveCausalInferencePipeline as JPipeline

# dim 128 and 256-token frames put the q/k/v/o, cross q/o and fc1 linears
# inside the fused kernel's shape rule (K % 128 == 0, M >= 256); fc2
# (K = 192) and the cross k/v (M = 16 text tokens) take linear_int8
_WIDE = dict(dim=128, ffn_dim=192, num_heads=2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _quantized_tree(jcfg):
    p = JD.init_dit_params(jax.random.PRNGKey(0), jcfg, jnp.float32, zero_head=False)
    return jax.tree.map(np.asarray, JQ.quantize_dit_params(p))


def test_quantized_cached_forward_matches_jax(monkeypatch):
    """Denoise forwards and the kv_only commit over 4 one-frame blocks
    (1 sink + 2 ring frames: the ring wraps) with int8 linears and the int8
    K cache, each forward fed the same inputs on both sides: flows, the
    int8 keys, their scales and V.  Limits (readings on an x86 CPU in
    brackets): flows 5e-3 relative RMS (6.6e-4: a flip in one linear moves
    one token's row); keys at most one step apart in at most 1e-3 of them
    (1.1e-4) and scales off by more than 1e-6 relative in at most 1% of the
    tokens (6.5e-4), both where a flip upstream moved a token's projection;
    the dequantized keys and V 2e-3 relative RMS (2.3e-4, 1.0e-4)."""
    monkeypatch.setenv("LONGLIVE_INT8_FUSED", "interpret")
    jcfg, tcfg = (dataclasses.replace(c, **_WIDE) for c in (j_tiny(), tiny_dit_config()))
    geom = LatentGeometry(channels=4, height=32, width=32)
    fs = geom.frame_seq_length
    tree = _quantized_tree(jcfg)
    tparams, jparams = dit_params_from_jax(tree), jax.tree.map(jnp.asarray, tree)
    assert "w_int8" in tparams["blocks"][0]["ffn"]["fc1"]
    tccfg = CacheConfig(sink_frames=1, ring_frames=2, frame_seq=fs)
    jccfg = JCacheConfig(sink_frames=1, ring_frames=2, frame_seq=fs)
    ttables = make_rope_tables(tcfg.head_dim, tcfg.rope_max_pos)
    jtables = j_rope_tables(jcfg.head_dim, jcfg.rope_max_pos)

    def jfwd(x, t, cross, cache, start, advance, kv_only):
        return JD.dit_forward_cached(jparams, jcfg, jccfg, jtables, x, t, cross, cache,
                                     jnp.asarray(start, jnp.int32), attn_impl="pallas_interpret",
                                     advance_counters=advance, kv_only=kv_only)

    jfwd = jax.jit(jfwd, static_argnames=("advance", "kv_only"))
    rng = np.random.default_rng(0)
    pe = rng.standard_normal((1, tcfg.text_len, tcfg.text_dim)).astype(np.float32)
    jcross = JD.prepare_cross_kv(jparams, jcfg, jnp.asarray(pe), jnp.float32)
    tcross = TD.prepare_cross_kv(tparams, tcfg, torch.from_numpy(pe), torch.float32)
    assert _rel(tcross.k.numpy(), jcross.k) < 1e-5

    L, N, hd = tcfg.num_layers, tcfg.num_heads, tcfg.head_dim
    jcache = JK.init_cache(jccfg, L, 1, N, hd, jnp.float32, k_int8=True)
    tcache = TK.init_cache(tccfg, L, 1, N, hd, torch.float32, k_int8=True)
    TQ.reset_launches()
    TA.reset_launches()
    for start in range(4):
        for t_val, kv_only in ((1000.0, False), (250.0, False), (0.0, True)):
            x = rng.standard_normal((1, 1, 4, 32, 32)).astype(np.float32)
            t = np.full((1, 1), t_val, np.float32)
            jflow, jcache = jfwd(jnp.asarray(x), jnp.asarray(t), jcross, jcache, start,
                                 kv_only, kv_only)
            tflow, tcache = TD.dit_forward_cached(
                tparams, tcfg, tccfg, ttables, torch.from_numpy(x), torch.from_numpy(t),
                tcross, tcache, start, advance_counters=kv_only, kv_only=kv_only)
            if not kv_only:
                assert _rel(tflow.numpy(), jflow) < 5e-3, (start, t_val)
        tk = tcache.k.transpose(2, 3).numpy()
        jk = np.asarray(jcache.k)
        assert tk.dtype == jk.dtype == np.int8
        flips = np.abs(tk.astype(np.int32) - jk.astype(np.int32))
        assert flips.max() <= 1 and flips.mean() <= 1e-3, (flips.max(), flips.mean())
        sc, jsc = tcache.k_scale.transpose(2, 3).numpy(), np.asarray(jcache.k_scale)
        assert (np.abs(sc - jsc) > 1e-6 * np.abs(jsc)).mean() <= 1e-2
        assert _rel(tk * sc[..., None], jk * jsc[..., None]) < 2e-3
        assert _rel(tcache.v.transpose(2, 3).numpy(), jcache.v) < 2e-3
    assert TQ.launches == 0 and TA.launches == 0  # CPU tensors: the plain versions
    assert TQ.linear_int8_calls > 0


@pytest.fixture(scope="module")
def trees():
    p = JD.init_dit_params(jax.random.PRNGKey(0), j_tiny(), jnp.float32, zero_head=False)
    return {"float": jax.tree.map(np.asarray, p),
            "int8": jax.tree.map(np.asarray, JQ.quantize_dit_params(p))}


_PC = dict(num_frame_per_block=1, local_attn_size=4, sink_size=1, num_output_frames=8,
           global_sink=False, reactive_recache_frames=2)


def _reactive_pair(tree, mode):
    """(port latents, JAX latents) of 8 frames with one reactive switch at
    frame 5 (a 2-frame replay) in ``mode``: the int8 K cache (the JAX side
    attends with the int8 kernel interpreted) or the int8 QK recache on a
    bf16 cache."""
    if mode == "kv_int8":
        jconf, tconf, impl = dict(kv_int8=True), dict(kv_int8=True), "pallas_interpret"
    else:
        jconf = dict(recache_attn_impl="pallas_qk8_interpret")
        tconf, impl = dict(recache_attn_impl="pallas_qk8"), "xla"
    jp = JPipeline(JPipelineConfig(**_PC, **jconf), jax.tree.map(jnp.asarray, tree),
                   geometry=JLatentGeometry(channels=4, height=8, width=8), dit_config=j_tiny(),
                   attn_impl=impl, deterministic_renoise=True)
    tp = InteractiveCausalInferencePipeline(
        PipelineConfig(**_PC, **tconf), dit_params_from_jax(tree),
        geometry=LatentGeometry(channels=4, height=8, width=8), dit_config=tiny_dit_config(),
        device="cpu", deterministic_renoise=True)
    assert tp.kernel_cache == jp.kernel_cache
    assert tp.init_cache(1).k.dtype == (torch.int8 if mode == "kv_int8" else torch.float32)
    rng = np.random.default_rng(5)
    cfg = tiny_dit_config()
    pes = [rng.standard_normal((1, cfg.text_len, cfg.text_dim)).astype(np.float32)
           for _ in range(2)]
    noise = rng.standard_normal((1, 8, 4, 8, 8)).astype(np.float32)
    jc = [jp.prepare_condition(jnp.asarray(p)) for p in pes]
    tc = [tp.prepare_condition(torch.from_numpy(p)) for p in pes]
    tlat = tp.generate_latents_reactive(torch.from_numpy(noise), tc[0],
                                        lambda s: tc[1] if s == 5 else None)
    jlat = jp.generate_latents_reactive(jnp.asarray(noise), jc[0],
                                        lambda s: jc[1] if s == 5 else None)
    assert np.isfinite(tlat.numpy()).all()
    return tlat.numpy(), np.asarray(jlat)


# (mode, parameters, limit on the latents' relative RMS, reading on an x86
# CPU).  Float linears isolate the attention mode: pallas_qk8 quantizes
# only in the recache and reads float32 noise (a recache in bf16 attention
# instead reads 2.4e-5 here, so 1e-5 tells the two apart); kv_int8
# quantizes q and K in every forward, and a one-step flip there moves a
# frame by ~1e-3.  With int8 linears (~2e4 quantized values per forward) a
# one-step flip moves the frame it lands in by ~2e-2 and flips do land, so
# that case is held at 5e-2 (readings 1.2e-2 and 1.5e-2): it checks that
# the quantized parameters run through the whole loop.
@pytest.mark.parametrize("mode,params,limit", [
    ("pallas_qk8", "float", 1e-5),     # 7.4e-7
    ("kv_int8", "float", 1e-2),        # 2.6e-3
    ("kv_int8", "int8", 5e-2),         # 1.2e-2
])
def test_reactive_generation_matches_jax(monkeypatch, trees, mode, params, limit):
    monkeypatch.setenv("LONGLIVE_INT8_FUSED", "interpret")
    tlat, jlat = _reactive_pair(trees[params], mode)
    assert _rel(tlat, jlat) < limit


def test_int8_streaming_vae_decode_matches_jax(monkeypatch):
    """Two latent frames (the first-frame path, then the time conv)
    through a decoder of the real widths (384 and 96 channels, one
    upsample) with LONGLIVE_VAE_INT8=1: every fused conv in int8 on both
    sides.  The JAX package's interpret mode sends every conv of the fused
    shapes to the kernel; its TPU rule keeps the narrow ones (fewer than 96
    channels: conv1 and the RGB head) on the XLA path, as the port does, so
    the test restores that rule.  Limit 1e-2 relative RMS on the pixels:
    ~13 quantized convs per frame at random weights, each one-step flip
    shifting its outputs by ~1% of a row's range (reading on an x86 CPU
    1.7e-3; the int8 decode reads 2.8e-2 against the bf16 one, so the limit
    also tells the modes apart)."""
    from longlive_torch.models import vae as TV
    from longlive_torch.utils.params import vae_params_from_jax
    from longlive_tpu.models import vae as JV

    jcfg = dataclasses.replace(JV.tiny_vae_config(), dim=96, dim_mult=(1, 4))
    tcfg = dataclasses.replace(TV.tiny_vae_config(), dim=96, dim_mult=(1, 4))
    tree = jax.tree.map(np.asarray, jax.jit(lambda k: JV.init_vae_params(k, jcfg, jnp.float32))(
        jax.random.PRNGKey(0)))
    tparams, jparams = vae_params_from_jax(tree), jax.tree.map(jnp.asarray, tree)
    lat = np.random.default_rng(4).standard_normal((1, 2, tcfg.z_dim, 2, 8)).astype(np.float32)

    wide_only = JV._fusable

    def fusable(x, p, thread, stride):
        w = p.get("w")
        return (wide_only(x, p, thread, stride) and w is not None
                and w.shape[0] >= 96 and w.shape[1] >= 96)

    monkeypatch.setattr(JV, "_fusable", fusable)
    monkeypatch.setenv("LONGLIVE_VAE_FUSED", "interpret")
    monkeypatch.setenv("LONGLIVE_VAE_INT8", "1")
    jpx = np.asarray(JV.vae_decode(jparams, jcfg, jnp.asarray(lat)))
    from longlive_torch.ops import vae_conv as TVC

    TVC.reset_launches()
    tpx = TV.vae_decode(tparams, tcfg, torch.from_numpy(lat)).numpy()
    assert tpx.shape == jpx.shape == (1, 1 + 2, 3, 4, 16)
    assert np.isfinite(tpx).all()
    assert _rel(tpx, jpx) < 1e-2
    monkeypatch.setenv("LONGLIVE_VAE_INT8", "0")
    bf16_px = TV.vae_decode(tparams, tcfg, torch.from_numpy(lat)).numpy()
    assert _rel(tpx, bf16_px) > 1e-2  # the int8 convs were in effect
