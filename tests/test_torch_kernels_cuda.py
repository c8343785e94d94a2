"""The port's CUDA kernels against their plain versions at small, ragged
shapes (query and KV tiles cut short, pixel tiles spanning image rows, a
frame smaller than one tile).  Needs a GPU: marked ``cuda`` and skipped
without one.  On the GPU host, which has no JAX (tests/conftest.py imports
it): ``python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py``."""

import math

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


# bf16 outputs, each rounded once; the kernels sum in another order than the
# plain versions (K1: tiled online softmax; K2: taps and per-pixel norms).
# Limits scale with the output: max error <= max |ref| / 64 and relative RMS
# error <= 1e-2 (the rule chip_smoke.py holds the main-path shapes to).
def _assert_agrees(out, ref):
    o, r = out.float(), ref.float()
    assert (o - r).abs().max().item() <= r.abs().max().item() / 64
    assert ((o - r).norm() / r.norm()).item() <= 1e-2


@pytest.mark.parametrize("sq,s,valid", [(40, 100, 100), (130, 64, 30), (1, 257, 200)])
def test_flash_attention_kernel_matches_plain(dev, sq, s, valid):
    from longlive_torch.ops import attention as A

    g = torch.Generator(device=dev).manual_seed(0)
    b, n, d = 1, 3, 128
    q = torch.randn((b, sq, n, d), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((b * n, s, d), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((b * n, s, d), generator=g, device=dev).to(torch.bfloat16)
    bias = torch.where(torch.arange(s, device=dev) < valid, 0.0, A.NEG_INF).float()[None]
    before = A.launches
    out = A.flash_attention(q, k, v, bias.contiguous())
    ref = A.flash_attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    assert A.launches == before + 1
    _assert_agrees(out, ref)
    with pytest.raises(ValueError):
        A.flash_attention(q[..., :64].contiguous(), k[..., :64].contiguous(),
                          v[..., :64].contiguous(), bias.contiguous())


@pytest.mark.parametrize("sq,s,valid", [(40, 100, 100), (130, 64, 30), (1, 257, 200),
                                         (300, 200, 150)])
def test_flash_attention_q_rope_kernel_matches_plain(dev, sq, s, valid):
    """q_rope mode at ragged q rows (cos/sin rows past Sq are never read:
    they are cut exactly at Sq here) and ragged KV tiles."""
    from longlive_torch.ops import attention as A

    g = torch.Generator(device=dev).manual_seed(3)
    b, n, d = 1, 3, 128
    q = torch.randn((b, sq, n, d), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((b * n, s, d), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((b * n, s, d), generator=g, device=dev).to(torch.bfloat16)
    ang = torch.rand((sq, d // 2), generator=g, device=dev) * 6.3
    rope = (ang.cos().contiguous(), ang.sin().contiguous())
    bias = torch.where(torch.arange(s, device=dev) < valid, 0.0, A.NEG_INF).float()[None]
    before = dict(A.mode_launches)
    out = A.flash_attention(q, k, v, bias.contiguous(), q_rope=rope)
    ref = A.flash_attention_plain(q, k, v, bias, q_rope=rope)
    torch.cuda.synchronize()
    assert A.mode_launches["q_rope"] == before["q_rope"] + 1
    assert A.mode_launches["bias"] == before["bias"]
    _assert_agrees(out, ref)
    with pytest.raises(ValueError):
        A.flash_attention(q, k, v, bias.contiguous(), q_rope=(rope[0][:-1], rope[1]))


# K2's cases (t, h, w, c, o, kernel rows/cols, norm, residual).  The edges
# of its tiling (ops.vae_conv.conv_tiles, which tests/test_torch_vae_conv.py
# checks on the CPU for these shapes): T = 1, where the cache frames cross
# into x; W not a multiple of the box width (13, 20, 50, 104); H smaller
# than a box; C = 32 and 96 (32 channels per K step) and C % 64 == 0 (64);
# O = 768 (eight N tiles); 1x1 kernels at N = 96 and 192; the decoder's
# 384-wide stage.
CONV_CASES = [
    (1, 5, 13, 32, 96, 3, True, True),    # 65-pixel frame, one partial tile
    (2, 9, 30, 64, 192, 3, True, False),  # tiles span rows
    (4, 6, 50, 96, 96, 3, False, True),
    (2, 7, 20, 96, 192, 1, False, False),  # time conv
    (2, 2, 104, 96, 96, 3, True, True),    # a 2 x 128 box over 2 x 104
    (1, 30, 104, 128, 768, 3, True, True),  # T = 1, eight N tiles, H % 16 != 0
    (4, 40, 104, 96, 192, 3, True, False),
    (1, 12, 40, 128, 384, 1, False, False),  # 1x1, 64 channels per K step, N = 192
    (1, 8, 16, 32, 96, 1, False, True),    # 1x1, 32 channels per K step, N = 96
    (1, 60, 104, 384, 384, 3, True, True),  # the decoder's 384-wide res conv2
    (4, 240, 416, 96, 192, 3, True, False),  # the encoder's stage-1 shortcut-block conv1
    (1, 240, 416, 96, 192, 3, True, False),  # the same in the first chunk
]


@pytest.mark.parametrize("t,h,w,c,o,k,norm,res", CONV_CASES)
def test_causal_conv_kernel_matches_plain(dev, t, h, w, c, o, k, norm, res):
    from longlive_torch.ops import vae_conv as VC

    g = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16
    x = torch.randn((t, h, w, c), generator=g, device=dev).to(bf)
    cache = torch.randn((2, h, w, c), generator=g, device=dev).to(bf)
    std = 1.0 / math.sqrt(c * 3 * k * k)
    wt = ((torch.rand((o, c, 3, k, k), generator=g, device=dev) * 2 - 1) * std).to(bf)
    b = torch.randn((o,), generator=g, device=dev)
    gamma = torch.randn((c,), generator=g, device=dev) if norm else None
    resid = torch.randn((t, h, w, o), generator=g, device=dev).to(bf) if res else None
    before = VC.launches
    out, nx = VC.fused_causal_conv(x, cache, wt, b, gamma, resid)
    ref, ref_nx = VC.fused_causal_conv_plain(x, cache, wt, b, gamma, resid)
    torch.cuda.synchronize()
    assert VC.launches == before + 1
    _assert_agrees(out, ref)
    _assert_agrees(nx, ref_nx)
    out_p, nx_p = VC.fused_causal_conv(x, cache, wt, b, gamma, resid,
                                       w_packed=VC.pack_weights(wt))
    assert torch.equal(out_p, out) and torch.equal(nx_p, nx)
    assert VC.launches == before + 2
    with pytest.raises(ValueError):
        VC.fused_causal_conv(x.float(), cache, wt, b, gamma, resid)


@pytest.mark.parametrize("sq,s,valid,stored", [(40, 100, 100, True), (130, 64, 30, True),
                                                (1, 257, 200, False), (300, 200, 150, False)])
def test_flash_attention_qk_int8_kernel_matches_plain(dev, sq, s, valid, stored):
    """qk_int8 mode: K int8 with stored scales (the int8 K cache) or bf16
    quantized per call (pallas_qk8), at ragged q and KV tiles."""
    from longlive_torch.ops import attention as A

    g = torch.Generator(device=dev).manual_seed(4)
    b, n, d = 1, 3, 128
    q = torch.randn((b, sq, n, d), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((b * n, s, d), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((b * n, s, d), generator=g, device=dev).to(torch.bfloat16)
    ks = None
    if stored:
        k, ks = A.quantize_k_tokens(k)
    bias = torch.where(torch.arange(s, device=dev) < valid, 0.0, A.NEG_INF).float()[None]
    before = dict(A.mode_launches)
    out = A.flash_attention(q, k, v, bias.contiguous(), qk_int8=True, k_scales=ks)
    ref = A.flash_attention_plain(q, k, v, bias, qk_int8=True, k_scales=ks)
    torch.cuda.synchronize()
    assert A.mode_launches == dict(before, qk_int8=before["qk_int8"] + 1)
    _assert_agrees(out, ref)
    if stored:
        with pytest.raises(ValueError):  # the stored scales cover every token
            A.flash_attention(q, k, v, bias.contiguous(), qk_int8=True, k_scales=ks[:, :-1])


@pytest.mark.parametrize("m,k,n", [(4680, 1536, 1536), (9360, 1536, 1536), (300, 4096, 1000),
                                   (257, 128, 8)])
def test_int8_linear_kernel_matches_plain(dev, m, k, n):
    """K5 (its quantize pass, then the s8 wgmma GEMM on 128 x 128 tiles;
    ragged last M and N tiles, N below one tile, K = 4096 and one 128-byte
    K chunk) is bit-equal to its plain version: the quantize pass writes
    ``quantize_rows_plain``'s int8 rows and scales, the integer product is
    exact and the rescale runs the same float32 operations in the same
    order.  M 9360 is the reactive replay's."""
    from longlive_torch.ops import quant as Q

    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    p = Q.quantize_weight(torch.randn((n, k), generator=g, device=dev) * 0.02)
    p["bias"] = torch.randn((n,), generator=g, device=dev).to(torch.bfloat16)
    before = Q.launches
    out = Q.linear_int8_fused(x, p)
    xq, sx = Q.kernel_quantized_rows(x)
    torch.cuda.synchronize()
    assert Q.launches == before + 1
    pq, psx = Q.quantize_rows_plain(x)
    assert torch.equal(xq, pq) and torch.equal(sx, psx)
    assert torch.equal(out, Q.linear_int8_fused_plain(x, p))
    _assert_agrees(out, Q.linear_int8(x, p))  # the other quantizer: one-step differences
    with pytest.raises(ValueError):
        Q.linear_int8_fused(x.float(), p)


# The int8 variant's cases (tests/test_torch_vae_conv.py checks their tiles
# on the CPU): a partial box; boxes over ragged row tiles (H % TH != 0); the
# time conv at N = 192 (one K chunk of 96 channels, zero-filled past C) and
# at O = 768 with 128-channel K steps; C = 96 (two K chunks, the second
# half zero-filled) at T = 1 and 3; 128-channel K steps with the float sum.
CONV_INT8_CASES = [
    (1, 5, 13, 32, 96, 3, True, True),
    (2, 9, 30, 64, 192, 3, True, False),   # tiles span rows and row tiles
    (2, 7, 20, 96, 192, 1, False, False),  # time conv
    (1, 7, 20, 96, 96, 3, True, True),     # C = 96, T = 1, H ragged (TH 2)
    (3, 9, 50, 96, 192, 3, True, False),   # C = 96, T = 3, H and W ragged
    (2, 6, 30, 384, 768, 1, False, False),  # the decoder's time conv, W ragged
    (1, 12, 40, 128, 384, 3, True, True),  # 128-channel K steps, three N tiles
    (4, 240, 416, 96, 192, 3, True, False),  # the encoder's 96 -> 192 conv1, two N tiles
    (1, 240, 416, 96, 192, 3, True, False),
]


@pytest.mark.parametrize("t,h,w,c,o,k,norm,res", CONV_INT8_CASES)
def test_causal_conv_int8_kernel_matches_plain(dev, monkeypatch, t, h, w, c, o, k, norm, res):
    """K2's int8 variant against its plain version; its pre-pass's operand
    (Q and the activation scales) bit-equal to ``quantized_operand_plain``
    on the frames it quantized, which agree with the plain normalisation."""
    from longlive_torch.ops import vae_conv as VC

    monkeypatch.setenv("LONGLIVE_VAE_INT8", "1")
    g = torch.Generator(device=dev).manual_seed(2)
    bf = torch.bfloat16
    x = torch.randn((t, h, w, c), generator=g, device=dev).to(bf)
    cache = torch.randn((2, h, w, c), generator=g, device=dev).to(bf)
    std = 1.0 / math.sqrt(c * 3 * k * k)
    wt = ((torch.rand((o, c, 3, k, k), generator=g, device=dev) * 2 - 1) * std).to(bf)
    b = torch.randn((o,), generator=g, device=dev)
    gamma = 1.0 + 0.1 * torch.randn((c,), generator=g, device=dev) if norm else None
    resid = torch.randn((t, h, w, o), generator=g, device=dev).to(bf) if res else None
    pk = VC.pack_weights_int8(wt, gamma)
    before = dict(VC.mode_launches)
    out, nx = VC.fused_causal_conv(x, cache, wt, b, gamma, resid, w_int8=pk)
    ref, ref_nx = VC.fused_causal_conv_plain(x, cache, wt, b, gamma, resid, w_int8=pk)
    torch.cuda.synchronize()
    assert VC.mode_launches == dict(before, int8=before["int8"] + 1)
    _assert_agrees(out, ref)
    _assert_agrees(nx, ref_nx)
    out2, _ = VC.fused_causal_conv(x, cache, wt, b, gamma, resid)  # packed per call
    assert torch.equal(out2, out)
    q, s, full = VC.kernel_quantized_operand(x, cache, wt, gamma, pk)
    q_ref, s_ref = VC.quantized_operand_plain(full, pk[2], VC.row_tile(x, wt), k)
    torch.cuda.synchronize()
    assert VC.mode_launches == dict(before, int8=before["int8"] + 2)  # the pre-pass is not one
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
    _assert_agrees(full, torch.cat([cache, VC.norm_silu(x, gamma) if norm else x]))


def _check_train_kernels(q, k, v, dout, valid):
    """K4's forward and backward through autograd against the plain
    versions: one launch of each kernel, agreement, and a second backward
    bit-identical to the first (no atomics)."""
    from longlive_torch.ops import attention as A

    before = dict(A.train_launches)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = A.flash_attention_train(qg, kg, vg, valid)
    out.backward(dout)
    ref, lse = A.flash_attention_train_plain(q, k, v, valid)
    rdq, rdk, rdv = A.flash_attention_train_backward_plain(q, k, v, ref, lse, dout, valid)
    torch.cuda.synchronize()
    assert A.train_launches == {"fwd": before["fwd"] + 1, "bwd_dq": before["bwd_dq"] + 1,
                                "bwd_dkdv": before["bwd_dkdv"] + 1}
    _assert_agrees(out, ref)
    for got, want in ((qg.grad, rdq), (kg.grad, rdk), (vg.grad, rdv)):
        _assert_agrees(got, want)
    # no atomics: a second backward is bit-identical
    qg2, kg2, vg2 = (t.clone().requires_grad_() for t in (q, k, v))
    A.flash_attention_train(qg2, kg2, vg2, valid).backward(dout)
    assert torch.equal(qg2.grad, qg.grad) and torch.equal(kg2.grad, kg.grad)
    assert torch.equal(vg2.grad, vg.grad)


def _train_inputs(dev, b, sq, skv, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    shapes = ((b, sq, n, 128), (b, skv, n, 128), (b, skv, n, 128), (b, sq, n, 128))
    return g, [torch.randn(s, generator=g, device=dev).to(torch.bfloat16) for s in shapes]


# K4 at ragged shapes: (B, Sq, Skv, N, mask): no mask, a kv-valid mask with
# a fully masked tile, a per-batch mask, the 512-token cross shape cut short
@pytest.mark.parametrize("b,sq,skv,n,masked", [
    (1, 40, 100, 3, False), (1, 130, 200, 2, True), (2, 77, 257, 2, True),
    (1, 300, 77, 3, False)])
def test_flash_attention_train_kernels_match_plain(dev, b, sq, skv, n, masked):
    g, (q, k, v, dout) = _train_inputs(dev, b, sq, skv, n, 5)
    valid = None
    if masked:
        valid = torch.rand((b, skv), generator=g, device=dev) > 0.5
        # one whole kv tile of the forward kernel (two of the dQ and dK/dV kernels)
        valid[:, 128:256] = False
    _check_train_kernels(q, k, v, dout, valid)


def _train_mask(kind, b, skv, dev):
    """kv-valid masks whose dead, partial and full tiles the kernels skip or
    mask (forward tiles of 128 tokens, dQ and dK/dV tiles of 64)."""
    valid = torch.zeros((b, skv), dtype=torch.bool, device=dev)
    if kind == "rollout":  # sink run, recent-window run, block run; dead tiles between
        valid[:, :150] = True
        valid[:, 600:900] = True
        valid[:, skv - 300:] = True
    elif kind == "per_batch":  # the batch rows' live tiles differ
        valid[0, :200] = True
        valid[1, 450:] = True
    elif kind == "last_ragged":  # only the last, ragged tile is live
        valid[:, skv - 5:] = True
    elif kind == "past_list":  # a run after a dead prefix; batch row 1 fully masked
        valid[0, 300000:300200] = True
        valid[0, skv - 100:] = True
    else:  # random tokens everywhere: every tile partial
        valid = torch.arange(skv, device=dev) % 3 != 1
        valid = valid[None].expand(b, skv).contiguous()
    return valid


# (mask, B, Sq, Skv, N): no Sq or Skv a multiple of any tile; Skv below one
# tile; Sq = 1; N = 12 at a mid size; a kv past the forward and dQ kernels'
# tile lists (4096 x 128 + 300 tokens), which they walk whole, every tile
# masked per token
@pytest.mark.parametrize("kind,b,sq,skv,n", [
    ("rollout", 1, 300, 1337, 2), ("per_batch", 2, 130, 700, 2), ("last_ragged", 1, 65, 389, 2),
    (None, 1, 100, 50, 2), ("last_ragged", 1, 70, 50, 2), (None, 1, 1, 300, 2),
    ("rollout", 1, 1, 1337, 3), ("dense", 1, 1000, 1500, 12), ("past_list", 2, 70, 524588, 1)])
def test_flash_attention_train_kernels_skip_dead_tiles(dev, kind, b, sq, skv, n):
    from longlive_torch.ops import attention as A

    # the masks are laid out for these tiles
    assert A.train_kv_tiles() == {"fwd": 128, "bwd_dq": 64, "bwd_dkdv": 64, "max_listed": 4096}
    _, (q, k, v, dout) = _train_inputs(dev, b, sq, skv, n, 9)
    _check_train_kernels(q, k, v, dout, None if kind is None else _train_mask(kind, b, skv, dev))


def test_flash_attention_train_two_segment_and_empty_rows(dev):
    """attend_train's two-segment form (a half-masked cache beside a fully
    valid block) against the plain versions, and a fully masked batch row
    giving zeros and zero gradients (no NaN)."""
    from longlive_torch.ops import attention as A

    g = torch.Generator(device=dev).manual_seed(6)
    d, bf = 128, torch.bfloat16
    b, sq, s_cache, n = 2, 90, 160, 2
    q, k2, v2 = (torch.randn((b, sq, n, d), generator=g, device=dev).to(bf) for _ in range(3))
    kc, vc = (torch.randn((b, s_cache, n, d), generator=g, device=dev).to(bf) for _ in range(2))
    valid = torch.arange(s_cache, device=dev) < 70
    qg, k2g, v2g = (t.clone().requires_grad_() for t in (q, k2, v2))
    out = A.attend_train(qg, kc, vc, valid, k2=k2g, v2=v2g)
    out.float().square().sum().backward()
    kcat, vcat = torch.cat([kc, k2], 1), torch.cat([vc, v2], 1)
    vcat_valid = torch.cat([valid, torch.ones(sq, dtype=torch.bool, device=dev)])
    ref, lse = A.flash_attention_train_plain(q, kcat, vcat, vcat_valid)
    rdq, rdk, rdv = A.flash_attention_train_backward_plain(
        q, kcat, vcat, ref, lse, (2 * out.detach().float()).to(bf), vcat_valid)
    _assert_agrees(out, ref)
    _assert_agrees(qg.grad, rdq)
    _assert_agrees(k2g.grad, rdk[:, s_cache:])
    _assert_agrees(v2g.grad, rdv[:, s_cache:])

    empty = torch.ones((b, s_cache), dtype=torch.bool, device=dev)
    empty[1] = False
    qe, ke, ve = (t.clone().requires_grad_() for t in (q, kc, vc))
    oe = A.flash_attention_train(qe, ke, ve, empty)
    oe.float().sum().backward()
    torch.cuda.synchronize()
    assert torch.equal(oe[1], torch.zeros_like(oe[1]))
    for t in (oe, qe.grad, ke.grad, ve.grad):
        assert torch.isfinite(t).all()
    assert torch.equal(qe.grad[1], torch.zeros_like(qe.grad[1]))
    with pytest.raises(ValueError):
        A.flash_attention_train(q.float(), kc.float(), vc.float())
    with pytest.raises(ValueError):
        A.flash_attention_train(q[..., :64].contiguous(), kc[..., :64].contiguous(),
                                vc[..., :64].contiguous())


@pytest.mark.parametrize("exp2,lsum", [(0, 0), (1, 0), (0, 1), (1, 1)])
@pytest.mark.parametrize("sq,s,s2,slots,int8", [
    (40, 300, 70, (64, 192), False),   # ragged segment 2, two whole tiles elided
    (130, 256, 64, (0, 256), False),   # no cache token valid: segment 2 alone
    (17, 200, 33, (64, 128), True),    # K quantized per call, segment 2 too
    (200, 400, 130, (128, 320), False),  # one 128-token tile elided, the next half dead
    (70, 256, 200, (0, 256), True),    # int8, every cache tile dead
])
def test_flash_attention_two_segment_kernel_matches_plain(dev, monkeypatch, exp2, lsum, sq, s,
                                                          s2, slots, int8):
    """Two-segment mode: the cache's slots ``slots`` masked and elided, the
    block as segment 2 in its [B, S2, N, D] layout, under each switch."""
    from longlive_torch.ops import attention as A

    monkeypatch.setenv("LONGLIVE_EXP2", str(exp2))
    monkeypatch.setenv("LONGLIVE_MXU_LSUM", str(lsum))
    g = torch.Generator(device=dev).manual_seed(9)
    b, n, d = 1, 3, 128
    bf = torch.bfloat16
    q, k2, v2 = (torch.randn((b, m, n, d), generator=g, device=dev).to(bf)
                 for m in (sq, s2, s2))
    k, v = (torch.randn((b * n, s, d), generator=g, device=dev).to(bf) for _ in range(2))
    tok = torch.arange(s, device=dev)
    valid = ~((tok >= slots[0]) & (tok < slots[1]))
    bias = torch.where(valid, 0.0, A.NEG_INF).float()[None].contiguous()
    skip = [slots]
    before, flags = dict(A.mode_launches), dict(A.flag_launches)
    out = A.flash_attention(q, k, v, bias, qk_int8=int8, k2=k2, v2=v2, skip_ranges=skip)
    ref = A.flash_attention_plain(q, k, v, bias, qk_int8=int8, k2=k2, v2=v2, skip_ranges=skip,
                                  exp2=bool(exp2), mxu_lsum=bool(lsum))
    torch.cuda.synchronize()
    assert A.mode_launches == dict(before, two_segment=before["two_segment"] + 1)
    assert A.flag_launches == {"exp2": flags["exp2"] + exp2, "mxu_lsum": flags["mxu_lsum"] + lsum}
    assert torch.isfinite(out).all()
    _assert_agrees(out, ref)
    # elision changes no result: the same call computing the dead tiles
    _assert_agrees(A.flash_attention(q, k, v, bias, qk_int8=int8, k2=k2, v2=v2), ref)
    with pytest.raises(ValueError):
        A.flash_attention(q, k, v, bias, k2=k2[:, :, :2].contiguous(), v2=v2)


@pytest.mark.parametrize("mode", ["bias", "q_rope", "qk_int8"])
def test_flash_attention_switches_kernel_matches_plain(dev, monkeypatch, mode):
    """exp2 and mxu_lsum together in the single-segment modes."""
    from longlive_torch.ops import attention as A

    monkeypatch.setenv("LONGLIVE_EXP2", "1")
    monkeypatch.setenv("LONGLIVE_MXU_LSUM", "1")
    g = torch.Generator(device=dev).manual_seed(10)
    b, n, d, sq, s = 1, 3, 128, 130, 257
    q = torch.randn((b, sq, n, d), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b * n, s, d), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    bias = torch.where(torch.arange(s, device=dev) < 200, 0.0, A.NEG_INF).float()[None]
    kw = {}
    if mode == "q_rope":
        ang = torch.rand((sq, d // 2), generator=g, device=dev) * 6.3
        kw["q_rope"] = (ang.cos().contiguous(), ang.sin().contiguous())
    if mode == "qk_int8":
        k, ks = A.quantize_k_tokens(k)
        kw.update(qk_int8=True, k_scales=ks)
    out = A.flash_attention(q, k, v, bias.contiguous(), **kw)
    ref = A.flash_attention_plain(q, k, v, bias, exp2=True, mxu_lsum=True, **kw)
    torch.cuda.synchronize()
    _assert_agrees(out, ref)


# the four decoder geometries of the no-shortcut res blocks, a ragged frame
# (tiles cut at the image's edges), 384 wide over 4 frames (a norm pass
# after conv1), T = 1 at C = 96 and 192 (norm2 in conv1's epilogue, the new
# cache2's frame 0 copied), and the 384-wide stage over 4 frames
@pytest.mark.parametrize("t,h,w,c", [(1, 60, 104, 384), (2, 120, 208, 384), (4, 240, 416, 192),
                                     (4, 480, 832, 96), (3, 13, 21, 96), (4, 20, 28, 384),
                                     (1, 30, 50, 96), (1, 24, 40, 192), (4, 60, 104, 384)])
def test_res_block_pair_kernel_matches_plain(dev, t, h, w, c):
    """K6 against its plain version and against two K2 launches: the
    output and both new caches."""
    from longlive_torch.ops import vae_conv as VC

    g = torch.Generator(device=dev).manual_seed(11)
    bf = torch.bfloat16
    x = torch.randn((t, h, w, c), generator=g, device=dev).to(bf)
    c1, c2 = (torch.randn((2, h, w, c), generator=g, device=dev).to(bf) for _ in range(2))
    std = 1.0 / math.sqrt(27 * c)
    w1, w2 = (((torch.rand((c, c, 3, 3, 3), generator=g, device=dev) * 2 - 1) * std).to(bf)
              for _ in range(2))
    b1, b2 = (torch.randn((c,), generator=g, device=dev) * 0.1 for _ in range(2))
    g1, g2 = (1.0 + 0.1 * torch.randn((c,), generator=g, device=dev) for _ in range(2))
    before = VC.pair_launches
    got = VC.fused_res_block(x, c1, c2, w1, b1, g1, w2, b2, g2)
    ref = VC.fused_res_block_plain(x, c1, c2, w1, b1, g1, w2, b2, g2)
    y, n1 = VC.fused_causal_conv(x, c1, w1, b1, g1)
    chain = VC.fused_causal_conv(y, c2, w2, b2, g2, residual=x) + (n1,)
    torch.cuda.synchronize()
    assert VC.pair_launches == before + 1
    for a, r in zip(got, ref):
        _assert_agrees(a, r)
    for a, r in zip(got, (chain[0], chain[2], chain[1])):
        _assert_agrees(a, r)
    with pytest.raises(ValueError):
        VC.fused_res_block(x[..., :64].contiguous(), c1[..., :64].contiguous(),
                           c2[..., :64].contiguous(), w1[:64, :64].contiguous(), b1[:64],
                           g1[:64], w2[:64, :64].contiguous(), b2[:64], g2[:64])


@pytest.mark.parametrize("mode", ["bias", "q_rope", "qk_int8", "qk_int8_stored", "two_segment"])
def test_flash_attention_kernel_batch_two(dev, mode):
    """B = 2 (the tensor maps' batch and head offsets) at ragged Sq and S,
    each batch with its own bias."""
    from longlive_torch.ops import attention as A

    g = torch.Generator(device=dev).manual_seed(13)
    b, n, d, sq, s, s2 = 2, 3, 128, 150, 333, 90
    bf = torch.bfloat16
    q = torch.randn((b, sq, n, d), generator=g, device=dev).to(bf)
    k, v = (torch.randn((b * n, s, d), generator=g, device=dev).to(bf) for _ in range(2))
    tok = torch.arange(s, device=dev)
    bias = torch.stack([torch.where(tok < 250, 0.0, A.NEG_INF),
                        torch.where(tok >= 40, 0.0, A.NEG_INF)]).float().contiguous()
    kw = {}
    if mode == "q_rope":
        ang = torch.rand((sq, d // 2), generator=g, device=dev) * 6.3
        kw["q_rope"] = (ang.cos().contiguous(), ang.sin().contiguous())
    if mode.startswith("qk_int8"):
        kw["qk_int8"] = True
        if mode == "qk_int8_stored":
            k, kw["k_scales"] = A.quantize_k_tokens(k)
    if mode == "two_segment":
        kw.update(k2=torch.randn((b, s2, n, d), generator=g, device=dev).to(bf),
                  v2=torch.randn((b, s2, n, d), generator=g, device=dev).to(bf),
                  skip_ranges=[(256, 333)])
        bias[:, 256:] = A.NEG_INF
    out = A.flash_attention(q, k, v, bias, **kw)
    ref = A.flash_attention_plain(q, k, v, bias, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    _assert_agrees(out, ref)


@pytest.mark.parametrize("mode", ["bias", "q_rope", "qk_int8", "two_segment", "exp2_lsum"])
def test_flash_attention_kernel_split_items(dev, monkeypatch, mode):
    """Items split over several CTAs (the last wave's remainder, here the
    whole grid of 9 items): each CTA walks a share of the tile list and the
    last one merges the shares."""
    from longlive_torch.ops import attention as A

    g = torch.Generator(device=dev).manual_seed(18)
    b, n, d, sq, s, s2 = 1, 3, 128, 300, 2000, 300
    bf = torch.bfloat16
    q = torch.randn((b, sq, n, d), generator=g, device=dev).to(bf)
    k, v = (torch.randn((b * n, s, d), generator=g, device=dev).to(bf) for _ in range(2))
    bias = torch.where(torch.arange(s, device=dev) < 1700, 0.0, A.NEG_INF).float()[None]
    bias = bias.contiguous()
    kw, tiles = {}, -(-s // A.KERNEL_KV_TILE)
    if mode == "q_rope":
        ang = torch.rand((sq, d // 2), generator=g, device=dev) * 6.3
        kw["q_rope"] = (ang.cos().contiguous(), ang.sin().contiguous())
    if mode == "qk_int8":
        k, ks = A.quantize_k_tokens(k)
        kw.update(qk_int8=True, k_scales=ks)
    if mode == "two_segment":
        kw.update(k2=torch.randn((b, s2, n, d), generator=g, device=dev).to(bf),
                  v2=torch.randn((b, s2, n, d), generator=g, device=dev).to(bf),
                  skip_ranges=[(1700, 2000)])
        tiles = sum(A.kernel_live_tiles(A.live_kv_tiles([(1700, 2000)], s))) + 3
    if mode == "exp2_lsum":
        monkeypatch.setenv("LONGLIVE_EXP2", "1")
        monkeypatch.setenv("LONGLIVE_MXU_LSUM", "1")
    items = -(-sq // A.KERNEL_Q_TILE) * b * n
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert A.split_plan(items, sms, tiles)[0] < items
    out = A.flash_attention(q, k, v, bias, **kw)
    ref = A.flash_attention_plain(q, k, v, bias, exp2=mode == "exp2_lsum",
                                  mxu_lsum=mode == "exp2_lsum", **kw)
    again = A.flash_attention(q, k, v, bias, **kw)  # the counters are zero again
    torch.cuda.synchronize()
    assert all(int(c.abs().sum()) == 0 for c in A._COUNTERS.values())
    assert torch.isfinite(out).all()
    _assert_agrees(out, ref)
    _assert_agrees(again, ref)


@pytest.mark.parametrize("exp2", [False, True])
@pytest.mark.parametrize("b,sq,n", [(1, 200, 3), (2, 130, 12)])
def test_flash_attention_q_quantize_is_bit_equal(dev, exp2, b, sq, n):
    """The qk_int8 mode quantizes q in the kernel's prologue: q8 and its
    scales equal the plain pass (_qk_int8_operands) bit for bit, rows past
    a tile's end included."""
    from longlive_torch.ops import attention as A

    g = torch.Generator(device=dev).manual_seed(16)
    q = (torch.randn((b, sq, n, 128), generator=g, device=dev) * 3).to(torch.bfloat16)
    q[0, 5] = 0  # an all-zero row: amax = 1e-30
    before = A.launches
    q8, qs = A.kernel_quantized_q(q, exp2=exp2)
    ref8, refs, _, _ = A._qk_int8_operands(q, q, None, A.softmax_scale(128, exp2))
    torch.cuda.synchronize()
    assert A.launches == before
    assert torch.equal(q8, ref8)
    assert torch.equal(qs, refs)


def test_flash_attention_kernel_tiles(dev):
    """The library's tiles are the ones the Python side assumes."""
    import ctypes

    from longlive_torch.ops import attention as A
    from longlive_torch.ops import kernels

    tiles = (ctypes.c_int * 2)()
    kernels.load("flash_attention").longlive_flash_attention_tiles(tiles)
    assert tiles[0] == A.KERNEL_Q_TILE
    assert tiles[1] == A.KERNEL_KV_TILE and tiles[1] % A.KV_TILE == 0


def test_flash_attention_cross_kernel_matches_plain(dev):
    """K1 at the cross-attention's form (LONGLIVE_CROSS_FLASH=1): ragged
    query rows over a 512-token prompt with a zero bias, counted as cross."""
    from longlive_torch.ops import attention as A

    g = torch.Generator(device=dev).manual_seed(12)
    b, n, d, sq, s = 1, 3, 128, 300, 512
    q = torch.randn((b, sq, n, d), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b * n, s, d), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    bias = torch.zeros((b, s), dtype=torch.float32, device=dev)
    before = dict(A.mode_launches)
    out = A.flash_attention(q, k, v, bias, cross=True)
    ref = A.flash_attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    assert A.mode_launches["cross"] == before["cross"] + 1
    assert A.mode_launches["bias"] == before["bias"]
    _assert_agrees(out, ref)


# K1 at the bidirectional samplers' forms, cut small: the self-attention of
# both CFG halves (B 2, every key valid, ragged tiles), and the image
# cross-attention over 257 CLIP tokens (a KV length no multiple of the
# 128-token tile) and the text one over 512, counted as cross
@pytest.mark.parametrize("sq,s,cross", [(1000, 1000, False), (2000, 2000, False),
                                        (1000, 257, True), (130, 512, True)])
def test_flash_attention_bidirectional_shapes_match_plain(dev, sq, s, cross):
    from longlive_torch.ops import attention as A

    g = torch.Generator(device=dev).manual_seed(21)
    b, n, d = 2, 12, 128
    q = torch.randn((b, sq, n, d), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b * n, s, d), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    bias = torch.zeros((b, s), dtype=torch.float32, device=dev)
    before = dict(A.mode_launches)
    out = A.flash_attention(q, k, v, bias, cross=cross)
    ref = A.flash_attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    mode = "cross" if cross else "bias"
    assert A.mode_launches[mode] == before[mode] + 1
    _assert_agrees(out, ref)


def test_bidirectional_forward_routes_on_cuda(dev):
    """An i2v bidirectional forward (head dim 128) on the card: ``"auto"``
    launches K1 once per layer as the self-attention and twice as the
    cross-attentions (text, image) and nothing of K4; ``"train_auto"`` K4's
    forward three times per layer; the two agree."""
    from longlive_torch.config import DiTConfig
    from longlive_torch.models import dit as D
    from longlive_torch.models.dit_bidirectional import bidirectional_forward, prepare_img_cross_kv
    from longlive_torch.ops import attention as A
    from longlive_torch.ops.rope import make_rope_tables

    cfg = DiTConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=2, in_dim=36, out_dim=16,
                    text_dim=64, text_len=16, freq_dim=64, local_attn_size=-1, sink_size=0,
                    rope_max_pos=64, model_type="i2v", clip_dim=64)
    params = D.init_dit_params(cfg, torch.bfloat16, dev, seed=1, zero_head=False)
    g = torch.Generator(device=dev).manual_seed(22)
    cross = D.prepare_cross_kv(params, cfg, torch.randn((2, 16, 64), generator=g, device=dev))
    img = prepare_img_cross_kv(params, cfg, torch.randn((2, 257, 64), generator=g, device=dev))
    tables = make_rope_tables(cfg.head_dim, cfg.rope_max_pos, device=dev)
    x = torch.randn((2, 3, 36, 10, 12), generator=g, device=dev)
    t = torch.tensor([800.0, 300.0], device=dev)
    outs = {}
    with torch.no_grad():
        for impl in ("auto", "train_auto"):
            A.reset_launches()
            outs[impl] = bidirectional_forward(params, cfg, tables, x, t, cross, attn_impl=impl,
                                               cross_kv_img=img)
            torch.cuda.synchronize()
            if impl == "auto":
                assert A.mode_launches["bias"] == 2 and A.mode_launches["cross"] == 4
                assert A.train_launches["fwd"] == 0
            else:
                assert A.launches == 0 and A.train_launches["fwd"] == 6
    a, b = outs["auto"].float(), outs["train_auto"].float()
    assert torch.isfinite(a).all() and ((a - b).norm() / b.norm()).item() <= 2e-2


# (kind, frame_seq, frames, nfb, local, sink, heads): frames cut against the
# 128 x 128 tiles, a ragged last kv and q tile (S % 128 != 0), a partial
# last block, and 128-token frames with a one-frame window (each CTA's live
# list is the single tile on its diagonal)
MASKED_CASES = [
    ("teacher_forcing", 30, 5, 3, -1, 0, 2),
    ("teacher_forcing", 40, 6, 3, -1, 0, 1),
    ("block_causal", 30, 7, 3, -1, 0, 2),
    ("block_causal", 50, 9, 3, 4, 0, 1),
    ("sink_window", 30, 9, 3, 6, 1, 2),
    ("sink_window", 64, 6, 1, 4, 1, 1),
    ("block_causal", 128, 5, 1, 1, 0, 2),
]


def _masked_inputs(dev, kind, fs, f, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    s = (2 if kind == "teacher_forcing" else 1) * f * fs
    return [torch.randn((1, s, n, 128), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(3)]


@pytest.mark.parametrize("kind,fs,f,nfb,local,sink,n", MASKED_CASES)
def test_frame_masked_kernel_matches_plain(dev, kind, fs, f, nfb, local, sink, n):
    """K3 against its plain version; elided bit-equal to unelided."""
    from longlive_torch.ops import attention as A

    q, k, v = _masked_inputs(dev, kind, fs, f, n, 13)
    kw = dict(mask_kind=kind, frame_seq=fs, nfb=nfb, local=local, sink=sink,
              clean_frames=f if kind == "teacher_forcing" else 0)
    if (fs, local) == (128, 1):
        s = q.shape[1]
        assert A.frame_mask_live_tiles(kind, s, s, A.MASKED_TILE_Q, A.MASKED_TILE_KV, fs, nfb,
                                       local, sink).sum(1).eq(1).all()
    before = A.masked_launches[kind]
    out = A.flash_attention_frame_masked(q, k, v, elide_dead_tiles=True, **kw)
    full = A.flash_attention_frame_masked(q, k, v, elide_dead_tiles=False, **kw)
    ref = A.flash_attention_frame_masked_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert A.masked_launches[kind] == before + 2
    assert torch.isfinite(out).all()
    _assert_agrees(out, ref)
    assert torch.equal(out, full)


def test_frame_masked_kernel_refuses(dev):
    from longlive_torch.ops import attention as A

    q, k, v = _masked_inputs(dev, "block_causal", 16, 4, 1, 14)
    kw = dict(mask_kind="block_causal", frame_seq=16)
    with pytest.raises(ValueError):
        A.flash_attention_frame_masked(q[..., :64].contiguous(), k[..., :64].contiguous(),
                                       v[..., :64].contiguous(), **kw)
    with pytest.raises(ValueError):
        A.flash_attention_frame_masked(q.float(), k.float(), v.float(), **kw)
    with pytest.raises(ValueError, match="forward only"):
        A.flash_attention_frame_masked(q.requires_grad_(), k, v, **kw)


def test_teacher_forcing_auto_takes_kernel_on_cuda(dev):
    """attn_impl="auto" on a CUDA tensor is the kernel route, never the
    dense bias: at the tiny config's head dim 24 the kernel refuses."""
    from longlive_torch.config import tiny_dit_config, tiny_geometry
    from longlive_torch.models import dit as D
    from longlive_torch.ops.rope import make_rope_tables

    cfg, geom = tiny_dit_config(), tiny_geometry()
    assert cfg.head_dim != 128
    params = D.init_dit_params(cfg, torch.float32, dev, zero_head=False)
    cross = D.prepare_cross_kv(params, cfg, torch.randn(1, cfg.text_len, cfg.text_dim,
                                                        device=dev), torch.float32)
    tables = make_rope_tables(cfg.head_dim, cfg.rope_max_pos, device=dev)
    x = torch.randn(1, 2, geom.channels, geom.height, geom.width, device=dev)
    t = torch.full((1, 2), 500.0, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        D.dit_forward_teacher_forcing(params, cfg, tables, x, torch.randn_like(x), t, cross)
