"""The plain version of the port's fused causal-conv kernel (fused_causal_conv
on a CPU tensor) held against the JAX Pallas ``_fused_kernel`` run in
interpret mode: output and new cache, (3,3,3) with norm + bias + residual and
the (3,1,1) time conv, T in {1, 2}."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longlive_torch.ops import vae_conv as TV
from longlive_tpu.ops.vae_conv import fused_causal_conv as jax_fused

ATOL = 2e-4  # float32; the Pallas kernel sums its taps in another order


@pytest.mark.parametrize(
    "t,c,o,norm,res,khw",
    [
        (1, 8, 8, True, True, 3),
        (2, 8, 12, True, True, 3),
        (2, 8, 8, False, False, 3),
        (1, 8, 16, False, False, 1),  # time conv
        (2, 8, 16, False, False, 1),
    ],
)
def test_plain_conv_matches_pallas(t, c, o, norm, res, khw):
    rng = np.random.default_rng(5)
    h, w = 8, 16
    x = rng.standard_normal((t, h, w, c)).astype(np.float32)
    cache = rng.standard_normal((2, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((o, c, 3, khw, khw)) * 0.1).astype(np.float32)
    b = rng.standard_normal((o,)).astype(np.float32)
    gamma = rng.standard_normal((c,)).astype(np.float32) if norm else None
    residual = rng.standard_normal((t, h, w, o)).astype(np.float32) if res else None

    j = lambda a: None if a is None else jnp.asarray(a)
    tt = lambda a: None if a is None else torch.from_numpy(a)
    ref_out, ref_cache = jax_fused(j(x), j(cache), j(wt), j(b), j(gamma), j(residual),
                                   interpret=True)
    out, new_cache = TV.fused_causal_conv(tt(x), tt(cache), tt(wt), tt(b), tt(gamma),
                                          tt(residual))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out)[..., :o], atol=ATOL)
    np.testing.assert_allclose(new_cache.numpy(), np.asarray(ref_cache)[..., :c], atol=1e-5)
    assert TV.launches == 0  # CPU tensors never reach the kernel


def _conv_tile_shapes():
    """(H, W, C, O, kernel rows) of every fused conv of the 480x832 decoder
    and encoder (``chip_smoke.CONV_CASES``; the first latent frame runs each
    at T = 1, the later ones at T = 1, 2 or 4, and the tiles do not depend
    on T) and of the CUDA tests' cases."""
    import chip_smoke
    from test_torch_kernels_cuda import CONV_CASES as CUDA_CASES

    shapes = {(h, w, c, o, k) for _, _, h, w, c, o, k, *_ in chip_smoke.CONV_CASES}
    shapes |= {(h, w, c, o, k) for _, h, w, c, o, k, *_ in CUDA_CASES}
    return sorted(shapes)


# (N, m64 tiles per consumer warpgroup, channels per K step) of each
# instantiation of csrc/causal_conv.cu's bf16 conv
CONV_INSTANTIATIONS = {(96, 1, 32), (96, 1, 64), (96, 2, 32), (192, 1, 32), (192, 1, 64)}


@pytest.mark.parametrize("h,w,c,o,kh", _conv_tile_shapes())
def test_conv_tiles_fit_the_kernel(h, w, c, o, kh):
    """The bf16 kernel's tile choice for each shape is one it can run: KC
    divides C and N divides O; every TMA box dimension is <= 256 and the
    inner box fits its swizzle width; the ring fits a CTA's shared memory."""
    tl = TV.conv_tiles(h, w, c, o, kh)
    assert c % tl.kc == 0 and o % tl.bn == 0
    assert (tl.bn, tl.mt, tl.kc) in CONV_INSTANTIATIONS
    assert tl.bh * tl.bw == 128 * tl.mt and tl.bw % 8 == 0
    for box in ((tl.kc, tl.bw, tl.bh + kh - 1, 1), (tl.kc, tl.bn, kh, 1)):  # input, weights
        assert all(1 <= d <= 256 for d in box), box
    assert tl.kc * 2 <= (128 if tl.kc == 64 else 64)  # 128- or 64-byte swizzle
    assert tl.stages >= 2
    assert tl.smem == 1024 + tl.stages * (tl.stage + 16) <= TV.SMEM_LIMIT


def test_pack_weights_layout():
    w = torch.arange(2 * 3 * 3 * 3 * 1, dtype=torch.float32).reshape(2, 3, 3, 3, 1)
    p = TV.pack_weights(w)
    assert p.shape == (3, 3, 1, 2, 3)
    assert p[2, 1, 0, 1, 0] == w[1, 0, 2, 1, 0]


def _jax_int8_packed(wt, gamma, kh, kw):
    """JAX's pack_weights_int8 for the kernel's padded widths and output
    tile, laid out like the port's (wq [3, kh, kw, O, C], sc [kw, O], ginv
    [C])."""
    from longlive_tpu.ops.vae_conv import _aligned, _pick_tiles, pack_weights_int8

    o, c = wt.shape[:2]
    cp, op = _aligned(c), _aligned(o)
    bo = _pick_tiles(cp, op, 8, 16, 4, kh, kw)[1]
    g = None
    if gamma is not None:
        g = jnp.maximum(jnp.abs(jnp.pad(jnp.asarray(gamma), (0, cp - c))), 1e-6)
    wq, sc, ginv = pack_weights_int8(jnp.asarray(wt), cp, op, bo, kh, g)
    wq = np.asarray(wq).reshape(op // bo, 3, kh, cp, kw, bo).transpose(1, 2, 4, 0, 5, 3)
    sc = np.asarray(sc).reshape(op // bo, kw, bo).transpose(1, 0, 2)
    return (wq.reshape(3, kh, kw, op, cp)[:, :, :, :o, :c], sc.reshape(kw, op)[:, :o],
            np.asarray(ginv)[0, :c])


@pytest.mark.parametrize("c,o,khw,norm", [(96, 96, 3, True), (192, 96, 3, False),
                                          (384, 768, 1, False)])
def test_pack_weights_int8_equals_jax(c, o, khw, norm):
    rng = np.random.default_rng(6)
    wt = (rng.standard_normal((o, c, 3, khw, khw)) * 0.05).astype(np.float32)
    gamma = rng.standard_normal(c).astype(np.float32) if norm else None
    wq, sc, ginv = TV.pack_weights_int8(torch.from_numpy(wt),
                                        None if gamma is None else torch.from_numpy(gamma))
    jwq, jsc, jginv = _jax_int8_packed(wt, gamma, khw, khw)
    assert wq.dtype == torch.int8 and wq.shape == (3, khw, khw, o, c)
    np.testing.assert_array_equal(wq.numpy(), jwq)
    np.testing.assert_array_equal(sc.numpy(), jsc)
    np.testing.assert_array_equal(ginv.numpy(), jginv)


def test_pick_tiles_matches_jax():
    from longlive_tpu.ops.vae_conv import _pick_tiles

    for args in ((128, 128, 480, 832, 2, 3, 3), (256, 256, 240, 416, 2, 3, 3),
                 (384, 384, 60, 104, 2, 3, 3), (384, 768, 120, 208, 2, 1, 1),
                 (256, 256, 16, 16, 4, 3, 3), (128, 128, 8, 16, 4, 3, 3)):
        assert TV.pick_tiles(*args) == _pick_tiles(*args, budget=20e6), args
    # the decoder's widest stage at 480x832 (bf16): 2 rows per scale
    assert TV.row_tile(torch.empty((4, 480, 832, 96), dtype=torch.bfloat16),
                       torch.empty((96, 96, 3, 3, 3))) == 2


# The int8 variant against the JAX kernel interpreted, both float32.  The
# integer products are exact on both sides and the scales are computed the
# same way; the normalised activations may differ by one float32 ulp
# (another summation order of the per-pixel norm), which can move a value
# across an int8 rounding boundary: one step of one element moves an output
# by s_act * s_w * |q_w| <= ~2e-4 here (s_act ~ max|a| / 127, s_w ~ max|w| /
# 127), so the limit is 1e-3 absolute against outputs of magnitude ~1-10.
INT8_ATOL = 1e-3


@pytest.mark.parametrize("t,h,w,c,o,norm,res,khw", [
    (1, 8, 16, 96, 96, True, True, 3),      # res conv2 at the 96 stage
    (2, 16, 16, 192, 192, True, False, 3),  # two row tiles of 8 (th < H)
    (1, 8, 16, 96, 192, False, True, 3),
    (2, 8, 16, 384, 768, False, False, 1),  # time conv
])
def test_plain_int8_conv_matches_pallas(monkeypatch, t, h, w, c, o, norm, res, khw):
    from longlive_tpu.models import nn as JN
    from longlive_tpu.models import vae as JV

    monkeypatch.setenv("LONGLIVE_VAE_INT8", "1")
    rng = np.random.default_rng(8)
    x = rng.standard_normal((t, h, w, c)).astype(np.float32)
    cache = rng.standard_normal((2, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((o, c, 3, khw, khw)) * 0.05).astype(np.float32)
    b = rng.standard_normal((o,)).astype(np.float32)
    gamma = (1.0 + 0.3 * rng.standard_normal((c,))).astype(np.float32) if norm else None
    residual = rng.standard_normal((t, h, w, o)).astype(np.float32) if res else None
    if norm:  # a streaming cache holds normalised frames
        cache = np.array(JN.silu(JV.rms_norm_channel(jnp.asarray(cache)[None],
                                                       jnp.asarray(gamma))[0]))

    j = lambda a: None if a is None else jnp.asarray(a)
    tt = lambda a: None if a is None else torch.from_numpy(a)
    ref_out, ref_cache = jax_fused(j(x), j(cache), j(wt), j(b), j(gamma), j(residual),
                                   interpret=True)
    TV.reset_launches()
    out, new_cache = TV.fused_causal_conv(tt(x), tt(cache), tt(wt), tt(b), tt(gamma),
                                          tt(residual))
    assert TV.launches == 0
    th = TV.row_tile(tt(x), tt(wt))
    assert th == (8 if h == 16 else h)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out)[..., :o], rtol=0,
                               atol=INT8_ATOL)
    np.testing.assert_allclose(new_cache.numpy(), np.asarray(ref_cache)[..., :c], atol=1e-5)
    # the float32 conv of the bf16 variant is ~1e-2 away: int8 is in effect
    exact, _ = TV.fused_causal_conv_plain(tt(x), tt(cache), tt(wt), tt(b), tt(gamma),
                                          tt(residual))
    assert np.abs(exact.numpy() - out.numpy()).max() > 10 * INT8_ATOL


def _conv_int8_tile_shapes():
    """(T, H, W, C, O, kernel rows/cols) of every fused conv of the 480x832
    decoder and encoder (``chip_smoke.CONV_CASES``) and of the int8 CUDA
    tests."""
    import chip_smoke
    from test_torch_kernels_cuda import CONV_INT8_CASES

    shapes = {(t, h, w, c, o, k) for _, t, h, w, c, o, k, *_ in chip_smoke.CONV_CASES}
    shapes |= {(t, h, w, c, o, k) for t, h, w, c, o, k, *_ in CONV_INT8_CASES}
    return sorted(shapes)


# (N, channels per K step, float sum of the kernel columns) of each
# instantiation of csrc/causal_conv.cu's int8 conv
CONV_INT8_INSTANTIATIONS = {(96, 64, True), (96, 128, True), (192, 64, False), (192, 128, False)}


@pytest.mark.parametrize("t,h,w,c,o,k", _conv_int8_tile_shapes())
def test_conv_int8_tiles_fit_the_kernel(t, h, w, c, o, k):
    """The int8 kernel's tile choice for each shape is one it can run: an
    instantiation (N = 192, without the float sum, only for kw = 1); a
    128-pixel box inside one row tile (its rows divide the row tile, so one
    activation scale covers it); every TMA box dimension <= 256 and the
    inner one a 64- or 128-byte swizzle row; the ring in shared memory."""
    th = TV.row_tile(torch.empty((t, h, w, c), dtype=torch.bfloat16),
                     torch.empty((o, c, 3, k, k)))
    tl = TV.conv_int8_tiles(h, w, c, o, k, k, th)
    fold = tl.bn == 96
    assert (tl.bn, tl.kc, fold) in CONV_INT8_INSTANTIATIONS
    assert fold or k == 1
    assert o % tl.bn == 0 and c % 16 == 0 and tl.mt == 1
    assert th % tl.bh == 0 and tl.bh * tl.bw == 128 and tl.bw % 8 == 0
    for box in ((tl.kc, tl.bw, tl.bh + k - 1, 1), (tl.kc, tl.bn, k, 1)):  # Q, weights
        assert all(1 <= d <= 256 for d in box), box
    assert tl.kc in (64, 128)  # int8 bytes: a 64- or 128-byte swizzle row
    assert -(-c // tl.kc) * tl.kc - c < tl.kc  # only the last K chunk is zero-filled
    assert tl.stages >= 2
    assert tl.smem == 1024 + tl.stages * (tl.stage + 16) <= TV.SMEM_LIMIT


@pytest.mark.parametrize("t,h,w,c,o,khw,th", [
    (1, 7, 10, 32, 96, 3, 2),   # T = 1, H not a multiple of the row tile
    (3, 10, 9, 32, 96, 3, 4),   # T = 3, two full row tiles and a ragged one
    (3, 6, 5, 16, 8, 1, 4),     # kh = kw = 1, ragged
    (1, 5, 6, 16, 8, 1, 2),
    (3, 8, 7, 16, 16, 3, 8),    # one row tile: its halo rows are outside the image
])
def test_quantized_operand_contracts_to_plain_int8(t, h, w, c, o, khw, th):
    """The int8 kernel's operand in plain PyTorch (Q per output frame,
    temporal tap and row tile, with halo rows), contracted one kernel column
    at a time with the packed int8 weights, rescaled and summed over dx in
    order, equals ``_conv_int8_plain`` bit for bit (which
    ``test_plain_int8_conv_matches_pallas`` holds against the JAX kernel)."""
    rng = np.random.default_rng(9)
    full = torch.from_numpy(rng.standard_normal((t + 2, h, w, c)).astype(np.float32))
    wt = torch.from_numpy((rng.standard_normal((o, c, 3, khw, khw)) * 0.05).astype(np.float32))
    gamma = torch.from_numpy((1.0 + 0.3 * rng.standard_normal(c)).astype(np.float32))
    wq, sc, ginv = TV.pack_weights_int8(wt, gamma)
    q, s = TV.quantized_operand_plain(full, ginv, th, khw)
    nr, ph, pw = -(-h // th), khw // 2, khw // 2
    assert q.dtype == torch.int8 and q.shape == (t, 3, nr, th + 2 * ph, w, c)
    assert s.shape == (t, nr)
    rows = torch.arange(h)
    tile, local = rows // th, rows % th  # a row's tile, and its row there (after ph halo rows)
    qp = torch.nn.functional.pad(q.long(), (0, 0, pw, pw))
    y = None
    for dx in range(khw):
        op = torch.stack([qp[:, :, tile, local + dy, dx:dx + w] for dy in range(khw)], dim=2)
        prod = torch.einsum("tayhwc,ayoc->thwo", op, wq[:, :, dx].long())  # exact
        term = prod.float() * (s[:, tile][:, :, None, None] * sc[dx])
        y = term if y is None else y + term
    assert torch.equal(y, TV._conv_int8_plain(full, (wq, sc, ginv), th))
