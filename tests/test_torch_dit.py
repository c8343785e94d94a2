"""``dit_forward_cached`` of the port held against the JAX package's
kernel-layout cached forward over consecutive blocks: four denoise passes
threading the cache, then the kv_only commit, through warm-up and a ring
wrap.  Same parameters (carried across by utils.params), same inputs,
float32 on the CPU; flows and the cache (in standard layout) compared."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
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
