"""The training forms of the models held against the JAX package: the
causal DiT's training form (``dit_forward_cached(two_segment=True,
remat_layers=True, window_frames=...)``) over consecutive blocks, flows,
committed cache and parameter gradients; and ``bidirectional_forward``,
its value and its parameter gradients under ``remat_layers``.  Same
parameters (carried across by utils.params), same numpy inputs, float32
on the CPU; attention on the JAX side is its ``xla`` route, what
``train_auto`` resolves to there."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from longlive_torch.config import CacheConfig, tiny_dit_config, tiny_geometry
from longlive_torch.models import dit as TD
from longlive_torch.models.dit_bidirectional import bidirectional_forward
from longlive_torch.ops import kv_cache as TK
from longlive_torch.ops.rope import make_rope_tables
from longlive_torch.utils.params import dit_params_from_jax
from longlive_tpu.config import CacheConfig as JCacheConfig
from longlive_tpu.config import tiny_dit_config as j_tiny
from longlive_tpu.models import dit as JD
from longlive_tpu.models.dit_bidirectional import bidirectional_forward as j_bidi
from longlive_tpu.ops import kv_cache as JK
from longlive_tpu.ops.rope import make_rope_tables as j_rope_tables

RTOL, ATOL = 1e-4, 1e-4  # float32 end to end; summation order differs
GRAD_TOL = 2e-4           # gradients pass through one more chain of sums


def _setup(seed=0):
    jcfg, tcfg = j_tiny(), tiny_dit_config()
    tree = jax.tree.map(np.asarray, JD.init_dit_params(jax.random.PRNGKey(seed), jcfg,
                                                       jnp.float32, zero_head=False))
    return jcfg, tcfg, tree


def _grad_tree(tparams):
    """The port's parameter gradients in the JAX tree's layout ([L]-stacked,
    kernels [in, out]), as numpy."""
    def g(t):
        return np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy()

    def conv(node):
        if isinstance(node, dict):
            if "weight" in node:
                out = {"kernel": g(node["weight"]).T}
                if "bias" in node:
                    out["bias"] = g(node["bias"])
                return out
            return {k: conv(v) for k, v in node.items()}
        return g(node)

    out = {k: conv(v) for k, v in tparams.items() if k != "blocks"}
    per = [conv(b) for b in tparams["blocks"]]
    out["blocks"] = jax.tree.map(lambda *xs: np.stack(xs), *per)
    return out


def _requires_grad(tree):
    for t in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, torch.Tensor)):
        t.requires_grad_(True)


def _assert_trees_close(got, want, tol):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_g) == len(flat_w)
    for path, g in flat_g:
        w = np.asarray(flat_w[path])
        scale = max(np.abs(w).max(), 1e-3)
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * scale,
                                   err_msg=jax.tree_util.keystr(path))


def test_training_forward_matches_jax_across_blocks():
    """Seven one-frame blocks through a 6-frame cache (sink 1 + ring 5)
    with a 4-frame window, so the window mask, the excluded block slots and
    the ring wrap are all exercised.  Per block: one denoise forward
    (no commit; flow compared) and the kv_only commit (cache compared).
    At block 5 the denoise forward's parameter gradients of sum(flow * w)
    are held against jax.grad as well (remat on both sides)."""
    jcfg, tcfg, tree = _setup()
    geom = tiny_geometry()
    tparams = dit_params_from_jax(tree)
    jparams = jax.tree.map(jnp.asarray, tree)
    fs = geom.frame_seq_length
    tccfg = CacheConfig(sink_frames=1, ring_frames=5, frame_seq=fs)
    jccfg = JCacheConfig(sink_frames=1, ring_frames=5, frame_seq=fs)
    ttables = make_rope_tables(tcfg.head_dim, tcfg.rope_max_pos)
    jtables = j_rope_tables(jcfg.head_dim, jcfg.rope_max_pos)
    window = 4

    def jfwd(p, x, t, cross, cache, start, commit, kv_only):
        return JD.dit_forward_cached(p, jcfg, jccfg, jtables, x, t, cross, cache, start,
                                     attn_impl="xla", window_frames=window, remat_layers=True,
                                     two_segment=True, commit_writes=commit, kv_only=kv_only)

    rng = np.random.default_rng(1)
    pe = rng.standard_normal((1, tcfg.text_len, tcfg.text_dim)).astype(np.float32)
    jcross = JD.prepare_cross_kv(jparams, jcfg, jnp.asarray(pe), jnp.float32)
    tcross = TD.prepare_cross_kv(tparams, tcfg, torch.from_numpy(pe), torch.float32)
    L, N, hd = tcfg.num_layers, tcfg.num_heads, tcfg.head_dim
    jcache = JK.init_cache(jccfg, L, 1, N, hd, jnp.float32)
    tcache = TK.init_cache(tccfg, L, 1, N, hd, torch.float32)
    shape = (1, 1, geom.channels, geom.height, geom.width)
    for start in range(7):
        x = rng.standard_normal(shape).astype(np.float32)
        t = np.full((1, 1), 750.0, np.float32)
        jflow, _ = jfwd(jparams, jnp.asarray(x), jnp.asarray(t), jcross, jcache, start,
                        False, False)
        with torch.no_grad():
            tflow, _ = TD.dit_forward_cached(
                tparams, tcfg, tccfg, ttables, torch.from_numpy(x), torch.from_numpy(t), tcross,
                tcache, start, two_segment=True, remat_layers=True, window_frames=window,
                commit_writes=False)
        np.testing.assert_allclose(tflow.numpy(), np.asarray(jflow), rtol=RTOL, atol=ATOL)

        if start == 5:
            w = rng.standard_normal(tflow.shape).astype(np.float32)
            jg = jax.grad(lambda p: jnp.sum(jfwd(p, jnp.asarray(x), jnp.asarray(t), jcross,
                                                 jcache, start, False, False)[0] * w))(jparams)
            _requires_grad(tparams)
            flow, _ = TD.dit_forward_cached(
                tparams, tcfg, tccfg, ttables, torch.from_numpy(x), torch.from_numpy(t), tcross,
                tcache, start, two_segment=True, remat_layers=True, window_frames=window,
                commit_writes=False)
            (flow * torch.from_numpy(w)).sum().backward()
            got = _grad_tree(tparams)
            for name in ("text_embedding",):  # cross K/V were prepared outside
                got.pop(name)
                jg.pop(name)
            _assert_trees_close(got, jg, GRAD_TOL)
            tparams = dit_params_from_jax(tree)

        ctx = rng.standard_normal(shape).astype(np.float32)
        t0 = np.zeros((1, 1), np.float32)
        _, jcache = jfwd(jparams, jnp.asarray(ctx), jnp.asarray(t0), jcross, jcache, start,
                         True, True)
        with torch.no_grad():
            _, tcache = TD.dit_forward_cached(
                tparams, tcfg, tccfg, ttables, torch.from_numpy(ctx), torch.from_numpy(t0),
                tcross, tcache, start, two_segment=True, remat_layers=True,
                window_frames=window, kv_only=True)
        tk, tv = TK.to_standard_layout(tcache)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jcache.k), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jcache.v), rtol=RTOL, atol=ATOL)
        assert (tcache.sink_filled, tcache.ring_filled) == (
            int(jcache.sink_filled), int(jcache.ring_filled))


def test_bidirectional_forward_and_gradients_match_jax():
    jcfg, tcfg, tree = _setup(seed=2)
    geom = tiny_geometry()
    tparams = dit_params_from_jax(tree)
    jparams = jax.tree.map(jnp.asarray, tree)
    ttables = make_rope_tables(tcfg.head_dim, tcfg.rope_max_pos)
    jtables = j_rope_tables(jcfg.head_dim, jcfg.rope_max_pos)
    rng = np.random.default_rng(4)
    pe = rng.standard_normal((2, tcfg.text_len, tcfg.text_dim)).astype(np.float32)
    x = rng.standard_normal((2, 3, geom.channels, geom.height, geom.width)).astype(np.float32)
    t = np.asarray([500.0, 125.0], np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(p):
        cross = JD.prepare_cross_kv(p, jcfg, jnp.asarray(pe), jnp.float32)
        flow = j_bidi(p, jcfg, jtables, jnp.asarray(x), jnp.asarray(t), cross,
                      attn_impl="xla", remat_layers=True)
        return jnp.sum(flow * w), flow

    (_, jflow), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    _requires_grad(tparams)
    cross = TD.prepare_cross_kv(tparams, tcfg, torch.from_numpy(pe), torch.float32)
    flow = bidirectional_forward(tparams, tcfg, ttables, torch.from_numpy(x),
                                 torch.from_numpy(t), cross, attn_impl="train_auto",
                                 remat_layers=True)
    (flow * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(flow.detach().numpy(), np.asarray(jflow), rtol=RTOL, atol=ATOL)
    _assert_trees_close(_grad_tree(tparams), jg, GRAD_TOL)
