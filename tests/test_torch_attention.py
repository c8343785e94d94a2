"""The plain version of the port's attention kernel (flash_attention on a
CPU tensor) held against the JAX Pallas ``_flash_kernel`` run in interpret
mode in its bias + kv_layer, q_rope and qk_int8 (with and without stored K
scales) modes, D = 128, with masked cache slots and ragged q and KV tiles."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import longlive_tpu.ops.attention as JA
from longlive_torch.ops import attention as TA

# float32 on both sides; the Pallas kernel accumulates the online softmax
# tile by tile, the plain version over the whole row at once
RTOL, ATOL = 1e-4, 1e-4


@pytest.mark.parametrize("valid_tokens,layer", [(48, 0), (96, 2), (128, 1)])
def test_plain_flash_matches_pallas_kv_layer(valid_tokens, layer):
    rng = np.random.default_rng(11)
    L, b, n, d, s, sq = 3, 1, 2, 128, 128, 40
    k_cache = rng.standard_normal((L, b, n, s, d)).astype(np.float32)
    v_cache = rng.standard_normal((L, b, n, s, d)).astype(np.float32)
    q = rng.standard_normal((b, sq, n, d)).astype(np.float32)
    # warm-up style mask: leading valid slots, a masked gap, the block's slots
    valid = np.zeros(s, bool)
    valid[:valid_tokens] = True
    valid[-16:] = True
    bias = np.where(valid, 0.0, -1e30).astype(np.float32)[None]

    ref = JA.flash_attention(
        jnp.asarray(q), jnp.asarray(k_cache.reshape(L * b * n, s, d)),
        jnp.asarray(v_cache.reshape(L * b * n, s, d)), jnp.asarray(bias),
        block_q=8, block_kv=32, kv_layer=jnp.asarray(layer, jnp.int32), interpret=True)
    out = TA.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k_cache[layer].reshape(b * n, s, d)),
        torch.from_numpy(v_cache[layer].reshape(b * n, s, d)), torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    assert TA.launches == 0  # CPU tensors never reach the kernel


@pytest.mark.parametrize("sq,s,valid_tokens", [(40, 96, 80), (17, 64, 64), (64, 160, 100)])
def test_plain_q_rope_matches_pallas(sq, s, valid_tokens):
    """q_rope: q un-roped, rotated (halfsplit, softmax scale folded in) in
    the prologue; cos/sin indexed by query row; q tiles of 16 rows leave
    ragged rows at every Sq here."""
    rng = np.random.default_rng(12)
    L, b, n, d, layer = 2, 1, 2, 128, 1
    k_cache = rng.standard_normal((L, b, n, s, d)).astype(np.float32)
    v_cache = rng.standard_normal((L, b, n, s, d)).astype(np.float32)
    q = rng.standard_normal((b, sq, n, d)).astype(np.float32)
    cos = rng.uniform(-1, 1, (sq, d // 2)).astype(np.float32)
    sin = rng.uniform(-1, 1, (sq, d // 2)).astype(np.float32)
    bias = np.where(np.arange(s) < valid_tokens, 0.0, -1e30).astype(np.float32)[None]

    ref = JA.flash_attention(
        jnp.asarray(q), jnp.asarray(k_cache.reshape(L * b * n, s, d)),
        jnp.asarray(v_cache.reshape(L * b * n, s, d)), jnp.asarray(bias),
        block_q=16, block_kv=32, kv_layer=jnp.asarray(layer, jnp.int32),
        q_rope=(jnp.asarray(cos), jnp.asarray(sin)), interpret=True)
    out = TA.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k_cache[layer].reshape(b * n, s, d)),
        torch.from_numpy(v_cache[layer].reshape(b * n, s, d)), torch.from_numpy(bias),
        q_rope=(torch.from_numpy(cos), torch.from_numpy(sin)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    assert TA.launches == 0 and not any(TA.mode_launches.values())


def test_quantize_k_tokens_equals_jax():
    rng = np.random.default_rng(13)
    k = rng.standard_normal((1, 40, 2, 128)).astype(np.float32)
    k[0, 3] = 0.0  # all-zero tokens take the 1e-30 floor
    tk, tsc = TA.quantize_k_tokens(torch.from_numpy(k))
    jk, jsc = JA.quantize_k_tokens(jnp.asarray(k))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    np.testing.assert_array_equal(
        TA.dequantize_k(tk, tsc, torch.float32).numpy(),
        np.asarray(JA.dequantize_k(jk, jsc, jnp.float32)))


# qk_int8: the integer QK^T is exact on both sides and q is quantized by the
# same formula; the logits then differ only by float32 summation order in
# the softmax, as in the bf16 modes
@pytest.mark.parametrize("stored,sq,s,valid_tokens", [
    (True, 40, 96, 80), (True, 17, 100, 64), (False, 40, 96, 80), (False, 64, 150, 150)])
def test_plain_qk_int8_matches_pallas(stored, sq, s, valid_tokens):
    """The int8 K cache (k int8 with its stored scales) and the per-call
    quantized K of the pallas_qk8 recache; masked slots and KV lengths
    that are no multiple of the 32-token tiles (padded slots)."""
    rng = np.random.default_rng(14)
    b, n, d = 1, 2, 128
    q = rng.standard_normal((b, sq, n, d)).astype(np.float32)
    k = rng.standard_normal((b, s, n, d)).astype(np.float32)
    v = rng.standard_normal((b, s, n, d)).astype(np.float32)
    valid = np.arange(s) < valid_tokens
    valid[5:9] = False
    bias = np.where(valid, 0.0, -1e30).astype(np.float32)[None]
    heads = lambda a: np.ascontiguousarray(a.transpose(0, 2, 1, 3).reshape(b * n, s, d))
    if stored:
        jk, jsc = JA.quantize_k_tokens(jnp.asarray(k))
        ref = JA.flash_attention(jnp.asarray(q), jk, jnp.asarray(v), jnp.asarray(bias),
                                 block_q=16, block_kv=32, qk_int8=True, k_scales=jsc,
                                 interpret=True)
        tk = torch.from_numpy(heads(np.asarray(jk)))
        tsc = torch.from_numpy(np.ascontiguousarray(np.asarray(jsc).transpose(0, 2, 1)
                                                    .reshape(b * n, s)))
    else:
        ref = JA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(bias), block_q=16, block_kv=32, qk_int8=True,
                                 interpret=True)
        tk, tsc = torch.from_numpy(heads(k)), None
    TA.reset_launches()
    out = TA.flash_attention(torch.from_numpy(q), tk, torch.from_numpy(heads(v)),
                             torch.from_numpy(bias), qk_int8=True, k_scales=tsc)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    assert TA.launches == 0 and TA.mode_launches["qk_int8"] == 0


def test_qk_int8_mode_rules():
    q = torch.zeros((1, 8, 2, 128))
    kv = torch.zeros((2, 16, 128))
    bias = torch.zeros((1, 16))
    rope = (torch.zeros((8, 64)), torch.zeros((8, 64)))
    with pytest.raises(ValueError, match="q_rope"):
        TA.flash_attention(q, kv, kv, bias, q_rope=rope, qk_int8=True)
    with pytest.raises(ValueError, match="qk_int8"):
        TA.flash_attention(q, kv.to(torch.int8), kv, bias, k_scales=torch.ones((2, 16)))


def test_dense_attention_matches_jax():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 12, 2, 32)).astype(np.float32)
    k = rng.standard_normal((1, 20, 2, 32)).astype(np.float32)
    v = rng.standard_normal((1, 20, 2, 32)).astype(np.float32)
    np.testing.assert_allclose(
        TA.dense_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)).numpy(),
        np.asarray(JA.dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))),
        rtol=RTOL, atol=ATOL)


def test_cuda_wrapper_rejects_meta_device():
    q = torch.empty((1, 8, 2, 128), device="meta")
    kv = torch.empty((2, 16, 128), device="meta")
    with pytest.raises(ValueError):
        TA.flash_attention(q, kv, kv, torch.empty((1, 16), device="meta"))


@pytest.mark.parametrize("ranges,s", [
    ([(128, 320)], 400),                   # one kernel tile dead, the next half dead
    ([(64, 192)], 300),                    # two mask tiles dead, no kernel tile
    ([(0, 256)], 256),                     # every tile dead
    ([(256, 333)], 333),                   # the ragged last tile, its half past s
    ([(11 * 1560, 12 * 1560), (3 * 1560, 4 * 1560), (4 * 1560, 5 * 1560)], 12 * 1560),
])
def test_kernel_live_tiles_match_live_kv_tiles(ranges, s):
    """The kernel's 128-token tiles, derived from the 64-token mask it is
    given, equal the mask computed at the kernel's tile directly: a tile is
    skipped only when the ranges cover all of it."""
    live = TA.live_kv_tiles(ranges, s)
    assert TA.kernel_live_tiles(live) == TA.live_kv_tiles(ranges, s, tile=TA.KERNEL_KV_TILE)


@pytest.mark.parametrize("items,tiles,want", [
    (444, 147, (396, 2)),   # the decode: 3.36 waves, its last 48 items in halves
    (888, 110, (792, 4)),   # the reactive replay: 96 items left, in quarters
    (1764, 147, (1716, 2)),  # the 12-frame recache
    (444, 4, (444, 1)),     # the cross-attention's 4 tiles: too few to share
    (264, 100, (264, 1)),   # whole waves
    (48, 100, (0, 2)),      # less than a wave
])
def test_split_plan(items, tiles, want):
    """The kernel's grid on 132 SMs: the last wave's remainder split so
    that it takes the fewest rounds, each CTA keeping 4 tiles at least."""
    assert TA.split_plan(items, 132, tiles) == want


def test_split_plan_rules():
    for items in range(1, 700, 7):
        for tiles in (1, 7, 8, 16, 300):
            nfull, k = TA.split_plan(items, 132, tiles)
            assert 1 <= k <= TA.KERNEL_MAX_SPLIT
            assert (nfull == items) == (k == 1)
            assert items - nfull < 132 and (nfull % 132 == 0 or k == 1)
            assert k == 1 or tiles >= k * TA.KERNEL_MIN_SHARE
