"""``dit_forward_cached`` of the port held against the JAX package's
cached forwards: over consecutive blocks against the kernel-layout form
(four denoise passes threading the cache, then the kv_only commit, through
warm-up and a ring wrap), and as a KV-recache with explicit cache plumbing
against the write-then-attend form.  Same parameters (carried across by
utils.params), same inputs, float32 on the CPU; flows and the cache (in
standard layout) compared."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longlive_torch.config import CacheConfig, tiny_dit_config, tiny_geometry
from longlive_torch.models import dit as TD
from longlive_torch.ops import kv_cache as TK
from longlive_torch.ops.rope import make_rope_tables
from longlive_torch.utils.params import dit_params_from_jax
from longlive_tpu.config import CacheConfig as JCacheConfig
from longlive_tpu.models import dit as JD
from longlive_tpu.ops import kv_cache as JK
from longlive_tpu.ops.rope import make_rope_tables as j_rope_tables

RTOL, ATOL = 1e-4, 1e-4  # float32 end to end; summation order differs


def _jax_params(cfg):
    p = JD.init_dit_params(jax.random.PRNGKey(0), cfg, jnp.float32, zero_head=False)
    return jax.tree.map(np.asarray, p)


def test_param_conversion_keeps_rope_permutation():
    from longlive_tpu.config import tiny_dit_config as j_tiny

    tree = _jax_params(j_tiny())
    tp = dit_params_from_jax(tree)
    np.testing.assert_array_equal(tp["blocks"][1]["self_attn"]["q"]["weight"].numpy(),
                                  tree["blocks"]["self_attn"]["q"]["kernel"][1].T)
    np.testing.assert_array_equal(tp["blocks"][0]["self_attn"]["norm_k"]["scale"].numpy(),
                                  tree["blocks"]["self_attn"]["norm_k"]["scale"][0])
    assert len(tp["blocks"]) == 2


def test_cached_forward_matches_jax_across_blocks():
    from longlive_tpu.config import tiny_dit_config as j_tiny, tiny_geometry as j_geom

    tcfg, jcfg = tiny_dit_config(), j_tiny()
    geom = tiny_geometry()
    tree = _jax_params(jcfg)
    tparams = dit_params_from_jax(tree)
    jparams = jax.tree.map(jnp.asarray, tree)

    fs = geom.frame_seq_length
    tccfg = CacheConfig(sink_frames=1, ring_frames=3, frame_seq=fs)
    jccfg = JCacheConfig(sink_frames=1, ring_frames=3, frame_seq=fs)
    ttables = make_rope_tables(tcfg.head_dim, tcfg.rope_max_pos)
    jtables = j_rope_tables(jcfg.head_dim, jcfg.rope_max_pos)

    @functools.partial(jax.jit, static_argnames=("advance", "kv_only"))
    def jfwd(x, t, cross, cache, start, advance, kv_only):
        return JD.dit_forward_cached(jparams, jcfg, jccfg, jtables, x, t, cross, cache,
                                     start, advance_counters=advance, kv_only=kv_only)

    rng = np.random.default_rng(0)
    pe = rng.standard_normal((1, tcfg.text_len, tcfg.text_dim)).astype(np.float32)
    jcross = JD.prepare_cross_kv(jparams, jcfg, jnp.asarray(pe), jnp.float32)
    tcross = TD.prepare_cross_kv(tparams, tcfg, torch.from_numpy(pe), torch.float32)
    np.testing.assert_allclose(tcross.k.numpy(), np.asarray(jcross.k), rtol=RTOL, atol=ATOL)

    L, N, hd = tcfg.num_layers, tcfg.num_heads, tcfg.head_dim
    jcache = JK.init_cache_kl(jccfg, L, 1, N, hd, jnp.float32)
    tcache = TK.init_cache(tccfg, L, 1, N, hd, torch.float32)
    shape = (1, 1, geom.channels, geom.height, geom.width)
    for start in range(6):  # 1 sink frame + 3 ring frames: wraps at frame 4
        for t_val, kv_only in ((1000.0, False), (750.0, False), (250.0, False), (0.0, True)):
            x = rng.standard_normal(shape).astype(np.float32)
            t = np.full((1, 1), t_val, np.float32)
            commit = kv_only
            jflow, jcache = jfwd(jnp.asarray(x), jnp.asarray(t), jcross, jcache,
                                 jnp.asarray(start, jnp.int32), commit, kv_only)
            tflow, tcache = TD.dit_forward_cached(
                tparams, tcfg, tccfg, ttables, torch.from_numpy(x), torch.from_numpy(t),
                tcross, tcache, start, advance_counters=commit, kv_only=kv_only)
            np.testing.assert_allclose(tflow.numpy(), np.asarray(jflow), rtol=RTOL, atol=ATOL)
        jstd = JK.from_kernel_layout(jccfg, jcache, L, 1, N)
        tk, tv = TK.to_standard_layout(tcache)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jstd.k), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jstd.v), rtol=RTOL, atol=ATOL)
        assert (tcache.sink_filled, tcache.ring_filled) == (
            int(jcache.sink_filled), int(jcache.ring_filled))


@pytest.mark.parametrize("global_sink", [False, True])
def test_recache_forward_matches_jax(global_sink):
    """One explicit-plumbing kv_only recache forward (replay 4 frames under
    a new prompt, offsets from slot 0, the sink kept or overwritten) held
    against the JAX package's build_recache_fn on a standard-layout cache
    holding the same stale contents."""
    from longlive_torch.pipeline.causal_inference import build_recache_fn
    from longlive_tpu.config import tiny_dit_config as j_tiny
    from longlive_tpu.pipeline.causal_inference import build_recache_fn as j_build

    tcfg, jcfg = tiny_dit_config(), j_tiny()
    geom = tiny_geometry()
    tree = _jax_params(jcfg)
    tparams, jparams = dit_params_from_jax(tree), jax.tree.map(jnp.asarray, tree)
    fs = geom.frame_seq_length
    tccfg = CacheConfig(sink_frames=1, ring_frames=3, frame_seq=fs)
    jccfg = JCacheConfig(sink_frames=1, ring_frames=3, frame_seq=fs)
    ttables = make_rope_tables(tcfg.head_dim, tcfg.rope_max_pos)
    jtables = j_rope_tables(jcfg.head_dim, jcfg.rope_max_pos)
    n, start = 4, 6
    args = (0.0, n, global_sink, not global_sink, 4)
    tfn = build_recache_fn(tcfg, tccfg, ttables, *args)
    jfn = j_build(jcfg, jccfg, jtables, *args, attn_impl="xla")

    rng = np.random.default_rng(7)
    L, N, hd = tcfg.num_layers, tcfg.num_heads, tcfg.head_dim
    stale = rng.standard_normal((2, L, 1, N, tccfg.size_tokens, hd)).astype(np.float32)
    replay = rng.standard_normal((1, n, geom.channels, geom.height, geom.width)).astype(np.float32)
    pe = rng.standard_normal((1, tcfg.text_len, tcfg.text_dim)).astype(np.float32)
    tcache = TK.init_cache(tccfg, L, 1, N, hd, torch.float32)
    tcache.k.copy_(torch.from_numpy(stale[0]))
    tcache.v.copy_(torch.from_numpy(stale[1]))
    tcache = TK.advance(tccfg, tcache, 0, 6)
    jcache = JK.init_cache(jccfg, L, 1, N, hd, jnp.float32)
    jcache = dataclasses.replace(JK.advance(jccfg, jcache, 0, 6),
                                 k=jnp.asarray(stale[0].transpose(0, 1, 3, 2, 4)),
                                 v=jnp.asarray(stale[1].transpose(0, 1, 3, 2, 4)))

    tout = tfn(tparams, tcache, TD.prepare_cross_kv(tparams, tcfg, torch.from_numpy(pe),
                                                    torch.float32),
               torch.from_numpy(replay), start)
    jout = jfn(jparams, jcache, JD.prepare_cross_kv(jparams, jcfg, jnp.asarray(pe), jnp.float32),
               jnp.asarray(replay), jnp.asarray(start, jnp.int32))
    tk, tv = TK.to_standard_layout(tout)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jout.k), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jout.v), rtol=RTOL, atol=ATOL)
    assert (tout.ring_base, tout.sink_filled, tout.ring_filled) == (
        int(jout.ring_base), int(jout.sink_filled), int(jout.ring_filled))
