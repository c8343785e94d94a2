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


@pytest.mark.parametrize("t,h,w,c,o,k,norm,res", [
    (1, 5, 13, 32, 96, 3, True, True),    # 65-pixel frame, one partial tile
    (2, 9, 30, 64, 192, 3, True, False),  # tiles span rows
    (4, 6, 50, 96, 96, 3, False, True),
    (2, 7, 20, 96, 192, 1, False, False),  # time conv
])
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
