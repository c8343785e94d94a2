"""The port's int8 linears (``ops.quant``) held against the JAX package's
``ops.quant``: the quantizers exactly (int8 values and scales), the
separate-quantize route ``linear_int8`` and the plain version of the fused
kernel (K5) against JAX's kernel run in interpret mode, the parameter
transforms and their conversion, and the fused qkv projection against
separate q/k/v in a cached forward.  Same numpy inputs, float32 on the
CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longlive_torch.config import CacheConfig, tiny_dit_config, tiny_geometry
from longlive_torch.models import dit as TD
from longlive_torch.models import nn as TN
from longlive_torch.ops import kv_cache as TK
from longlive_torch.ops import quant as TQ
from longlive_torch.ops.rope import make_rope_tables
from longlive_torch.utils.params import dit_params_from_jax
from longlive_tpu.config import tiny_dit_config as j_tiny
from longlive_tpu.models import dit as JD
from longlive_tpu.ops import quant as JQ

# The integer products are exact on both sides, so the outputs differ only
# by the float32 rescale's rounding (the same multiplies in the same order;
# XLA may fuse the bias add): 1e-6 relative.
RTOL, ATOL = 1e-6, 1e-7


def _x(rng, shape, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    x.reshape(-1, shape[-1])[0] = 0.0  # an all-zero row takes the 1e-8 floor
    x.reshape(-1, shape[-1])[1] *= 1e-9  # a row below it
    return x


def test_quantizers_equal_jax():
    rng = np.random.default_rng(0)
    w = _x(rng, (96, 160), 0.05)  # [out, in]
    tq = TQ.quantize_weight(torch.from_numpy(w))
    jq = JQ.quantize_weight(jnp.asarray(w.T))
    np.testing.assert_array_equal(tq["w_int8"].numpy(), np.asarray(jq["w_int8"]).T)
    np.testing.assert_array_equal(tq["w_scale"].numpy(), np.asarray(jq["w_scale"]))
    assert tq["w_int8"].dtype == torch.int8 and tq["w_int8"].is_contiguous()

    x = _x(rng, (3, 7, 160))
    txq, tsx = TQ.quantize_activations(torch.from_numpy(x))
    jxq, jsx = JQ.quantize_activations(jnp.asarray(x))
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))


@pytest.mark.parametrize("m,k,n,bias", [
    (300, 256, 64, True),    # the fused kernel's shapes
    (100, 256, 64, False),   # M < 256
    (260, 4224, 32, True),   # K > 4096 (fc2's route)
])
def test_linear_int8_matches_jax(m, k, n, bias):
    rng = np.random.default_rng(1)
    x = _x(rng, (2, m // 2, k))
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    tp = TQ.quantize_weight(torch.from_numpy(w))
    jp = JQ.quantize_weight(jnp.asarray(w.T))
    if bias:
        b = rng.standard_normal(n).astype(np.float32)
        tp["bias"], jp["bias"] = torch.from_numpy(b), jnp.asarray(b)
    before = TQ.linear_int8_calls
    got = TQ.linear_int8(torch.from_numpy(x), tp).numpy()
    assert TQ.linear_int8_calls == before + 1
    np.testing.assert_allclose(got, np.asarray(JQ.linear_int8(jnp.asarray(x), jp)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("m,k,n,route", [
    (512, 256, 384, "fused"),
    (300, 128, 1024, "fused"),
    (255, 256, 64, "linear_int8"),   # M < 256
    (256, 192, 64, "linear_int8"),   # K % 128 != 0
    (256, 4224, 64, "linear_int8"),  # K > 4096
])
def test_fused_linear_matches_jax_interpret(monkeypatch, m, k, n, route):
    """The port's linear_int8_fused on CPU tensors (the kernel's plain
    version inside the shape rule, linear_int8 outside it) against JAX's
    linear_int8_fused with the Pallas kernel interpreted; both reached
    through models.nn.linear under LONGLIVE_INT8_FUSED."""
    from longlive_tpu.models import nn as JN

    monkeypatch.setenv("LONGLIVE_INT8_FUSED", "interpret")
    rng = np.random.default_rng(2)
    x = _x(rng, (m, k))
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    tp = dict(TQ.quantize_weight(torch.from_numpy(w)), bias=torch.from_numpy(b))
    jp = dict(JQ.quantize_weight(jnp.asarray(w.T)), bias=jnp.asarray(b))
    TQ.reset_launches()
    got = TN.linear(torch.from_numpy(x), tp).numpy()
    assert TQ.launches == 0  # CPU tensors never reach the kernel
    assert TQ.linear_int8_calls == (route == "linear_int8")
    want = np.asarray(JN.linear(jnp.asarray(x), jp))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if route == "fused":
        np.testing.assert_allclose(TQ.linear_int8_fused_plain(torch.from_numpy(x), tp).numpy(),
                                   want, rtol=RTOL, atol=ATOL)
    monkeypatch.setenv("LONGLIVE_INT8_FUSED", "0")
    TQ.reset_launches()
    TN.linear(torch.from_numpy(x), tp)
    assert TQ.linear_int8_calls == 1


@pytest.mark.parametrize("m,k", [(300, 256), (257, 4096), (260, 128)])
def test_quantize_pass_equals_jax_kernel_formula(m, k):
    """K5's quantize pass (its plain version, which the GPU kernel equals
    bit for bit) against the JAX kernel's formula (``_mm_q_kernel``:
    amax, 127 / amax, clip(round(x * r)), amax * (1 / 127)), exactly."""
    rng = np.random.default_rng(3)
    x = _x(rng, (m, k))
    xq, sx = TQ.quantize_rows_plain(torch.from_numpy(x))
    xf = jnp.asarray(x)
    amax = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-8)
    jq = jnp.clip(jnp.round(xf * (127.0 / amax)), -127, 127).astype(jnp.int8)
    assert xq.dtype == torch.int8 and sx.dtype == torch.float32 and sx.shape == (m,)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(amax * (1.0 / 127.0))[:, 0])


# The int8 serving path's linear shapes (M 512: the cross k, v; 4680: a
# 3-frame block; 9360: the reactive replay; N 1536: q, k, v, o; 8960: fc1;
# K 8960: fc2) and the cuda tests' ragged ones
@pytest.mark.parametrize("m,k,n,route", [
    (512, 1536, 1536, "fused"), (512, 1536, 8960, "fused"), (4680, 1536, 1536, "fused"),
    (4680, 1536, 8960, "fused"), (9360, 1536, 1536, "fused"), (9360, 1536, 8960, "fused"),
    (4680, 8960, 1536, "linear_int8"), (300, 4096, 1000, "fused"), (257, 128, 8, "fused"),
])
def test_fused_route_at_path_shapes(monkeypatch, m, k, n, route):
    """The port's shape rule for K5 sends every path shape where the JAX
    package's sends it (its kernel, or the separate-quantize route), with
    the products on both sides replaced by recorders; a CPU tensor never
    reaches the kernel."""
    seen = []

    def record(name):
        def fn(x, *args, **kwargs):
            seen.append(name)
            return torch.zeros((m, n)) if isinstance(x, torch.Tensor) else jnp.zeros((m, n))
        return fn

    monkeypatch.setenv("LONGLIVE_INT8_FUSED", "interpret")
    monkeypatch.setattr(TQ, "linear_int8_fused_plain", record("fused"))
    monkeypatch.setattr(TQ, "linear_int8", record("linear_int8"))
    monkeypatch.setattr(JQ, "_mm_q_call", record("fused"))
    monkeypatch.setattr(JQ, "linear_int8", record("linear_int8"))
    tp = {"w_int8": torch.zeros((n, k), dtype=torch.int8),
          "w_scale": torch.ones(n), "bias": torch.zeros(n)}
    jp = {"w_int8": jnp.zeros((k, n), jnp.int8), "w_scale": jnp.ones(n), "bias": jnp.zeros(n)}
    TQ.reset_launches()
    out = TQ.linear_int8_fused(torch.zeros((m, k), dtype=torch.bfloat16), tp)
    JQ.linear_int8_fused(jnp.zeros((m, k), jnp.bfloat16), jp)
    assert seen == [route, route]
    assert out.shape == (m, n) and TQ.launches == 0


def _jax_tree(cfg):
    p = JD.init_dit_params(jax.random.PRNGKey(0), cfg, jnp.float32, zero_head=False)
    return jax.tree.map(np.asarray, p)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    elif tree is not None:
        yield prefix, tree


def test_quantize_and_fuse_params_match_jax_conversion():
    """quantize_dit_params (+ fuse_qkv_params) in the port equals the JAX
    transforms carried across by dit_params_from_jax, leaf for leaf."""
    tree = _jax_tree(j_tiny())
    jq = jax.tree.map(np.asarray, JQ.quantize_dit_params(tree))
    jf = jax.tree.map(np.asarray, JQ.fuse_qkv_params(JQ.quantize_dit_params(tree)))
    tq = TQ.quantize_dit_params(dit_params_from_jax(tree))
    for ours, theirs in ((tq, dit_params_from_jax(jq)),
                         (TQ.fuse_qkv_params(tq), dit_params_from_jax(jf))):
        a, b = dict(_leaves(ours)), dict(_leaves(theirs))
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key].numpy(), b[key].numpy(), err_msg=key)
    blk = tq["blocks"][0]
    assert blk["self_attn"]["q"]["w_int8"].shape == (96, 96)
    assert blk["ffn"]["fc2"]["w_int8"].is_contiguous()
    assert "w_int8" not in tq["head"]["head"]  # only the block linears


@pytest.mark.parametrize("quant", [False, True])
def test_fused_qkv_is_exact_in_cached_forward(quant):
    """One cached forward and its kv_only commit with a fused qkv linear
    are bit-identical to separate q/k/v (bf16-path and int8 linears)."""
    cfg, geom = tiny_dit_config(), tiny_geometry()
    params = TD.init_dit_params(cfg, torch.float32, "cpu", seed=0, zero_head=False)
    p0 = TQ.quantize_dit_params(params) if quant else params
    p1 = TQ.fuse_qkv_params(p0)
    assert "qkv" in p1["blocks"][0]["self_attn"] and "q" in p0["blocks"][0]["self_attn"]
    tables = make_rope_tables(cfg.head_dim, cfg.rope_max_pos)
    g = torch.Generator().manual_seed(1)
    cross = TD.prepare_cross_kv(p0, cfg, torch.randn((1, cfg.text_len, cfg.text_dim),
                                                     generator=g), torch.float32)
    ccfg = CacheConfig(sink_frames=1, ring_frames=2, frame_seq=geom.frame_seq_length)
    x = torch.randn((1, 1, geom.channels, geom.height, geom.width), generator=g)
    t = torch.full((1, 1), 250.0)

    def run(p):
        cache = TK.init_cache(ccfg, cfg.num_layers, 1, cfg.num_heads, cfg.head_dim,
                              torch.float32, k_int8=quant)
        flow, cache = TD.dit_forward_cached(p, cfg, ccfg, tables, x, t, cross, cache, 0)
        _, cache = TD.dit_forward_cached(p, cfg, ccfg, tables, x, t, cross, cache, 1,
                                         kv_only=True)
        return flow, cache

    (f0, c0), (f1, c1) = run(p0), run(p1)
    assert torch.equal(f0, f1)
    for a, b in ((c0.k, c1.k), (c0.v, c1.v), (c0.k_scale, c1.k_scale)):
        assert (a is None and b is None) or torch.equal(a, b)
    assert dataclasses.replace(c1).k_scale is c1.k_scale
