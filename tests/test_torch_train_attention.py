"""K4's plain versions (the training attention) held against what the JAX
package's ``train_auto`` route resolves to on the CPU: ``attend(...,
impl="xla")`` for the value and ``jax.vjp`` of it for the gradients.  Same
numpy inputs, float32 on the CPU; plus a float64 ``gradcheck``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longlive_torch.ops import attention as TA
from longlive_tpu.ops.attention import attend as j_attend

TOL = 2e-5  # float32 on both sides; the plain version sums per head in chunks


def _arrays(rng, b, sq, skv, n, d, s2=0):
    shapes = [(b, sq, n, d), (b, skv, n, d), (b, skv, n, d), (b, sq, n, d)]
    if s2:
        shapes += [(b, s2, n, d), (b, s2, n, d)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# (label, B, Sq, Skv, N, D, second segment, mask kind); lengths are no
# multiple of any tile, the cross case has Skv = text_len of the tiny config
CASES = [
    ("no mask", 1, 37, 53, 2, 24, 0, None),
    ("kv-valid mask [B, Skv]", 2, 29, 41, 3, 16, 0, "batch"),
    ("kv-valid mask [Skv]", 1, 64, 70, 2, 24, 0, "shared"),
    ("two-segment", 1, 21, 45, 2, 24, 21, "shared"),
    ("cross (Skv = text_len)", 2, 64, 16, 4, 24, 0, None),
]


@pytest.mark.parametrize("label,b,sq,skv,n,d,s2,mask", CASES, ids=[c[0] for c in CASES])
def test_plain_forward_and_backward_match_jax(label, b, sq, skv, n, d, s2, mask):
    rng = np.random.default_rng(sum(map(ord, label)))
    arrs = _arrays(rng, b, sq, skv, n, d, s2)
    q, k, v, g = arrs[:4]
    k2 = v2 = None
    if s2:
        k2, v2 = arrs[4:]
    valid = None
    if mask == "batch":
        valid = rng.random((b, skv)) > 0.4
    elif mask == "shared":
        valid = rng.random(skv) > 0.5
        valid[:3] = True

    def jf(q, k, v, *seg):
        return j_attend(q, k, v, None if valid is None else jnp.asarray(valid), impl="xla",
                        k2=seg[0] if seg else None, v2=seg[1] if seg else None)

    jargs = [jnp.asarray(a) for a in ([q, k, v] + ([k2, v2] if s2 else []))]
    jout, vjp = jax.vjp(jf, *jargs)
    jgrads = vjp(jnp.asarray(g))

    targs = [torch.from_numpy(a).requires_grad_() for a in ([q, k, v] + ([k2, v2] if s2 else []))]
    tvalid = None if valid is None else torch.from_numpy(valid)
    if s2:
        tout = TA.attend_train(targs[0], targs[1], targs[2], tvalid, k2=targs[3], v2=targs[4])
    else:
        tout = TA.flash_attention_train(targs[0], targs[1], targs[2], tvalid)
    tout.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=TOL, atol=TOL)
    for t, jg in zip(targs, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=TOL, atol=TOL)


def test_plain_lse_and_empty_rows():
    """lse is the logsumexp of the scaled, masked logits; a batch row with no
    valid token gives zeros, lse = EMPTY_LSE and zero gradients."""
    rng = np.random.default_rng(3)
    q, k, v, g = (torch.from_numpy(a) for a in _arrays(rng, 2, 9, 13, 2, 8))
    valid = torch.ones((2, 13), dtype=torch.bool)
    valid[0, 5:] = False
    valid[1] = False
    out, lse = TA.flash_attention_train_plain(q, k, v, valid)
    s = torch.einsum("bqnd,bknd->bnqk", q, k) / np.sqrt(8)
    want = torch.logsumexp(s[0, :, :, :5], dim=-1)
    np.testing.assert_allclose(lse[0].numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    assert torch.all(lse[1] == TA.EMPTY_LSE) and torch.all(out[1] == 0)
    dq, dk, dv = TA.flash_attention_train_backward_plain(q, k, v, out, lse, g, valid)
    for t in (dq, dk, dv):
        assert torch.isfinite(t).all() and torch.all(t[1] == 0)
    assert torch.all(dk[0, 5:] == 0) and torch.all(dv[0, 5:] == 0)


def test_gradcheck_float64():
    torch.manual_seed(0)
    q = torch.randn(1, 6, 2, 8, dtype=torch.float64, requires_grad=True)
    k = torch.randn(1, 9, 2, 8, dtype=torch.float64, requires_grad=True)
    v = torch.randn(1, 9, 2, 8, dtype=torch.float64, requires_grad=True)
    valid = torch.tensor([[1, 1, 0, 1, 0, 1, 1, 1, 0]], dtype=torch.bool)
    assert torch.autograd.gradcheck(lambda a, b, c: TA.flash_attention_train(a, b, c, valid),
                                    (q, k, v))


def test_cpu_only_operands_reach_the_plain_version():
    """On the CPU nothing launches; an unknown device raises."""
    before = dict(TA.train_launches)
    q = torch.randn(1, 4, 1, 8)
    TA.flash_attention_train(q, q, q)
    assert TA.train_launches == before
    with pytest.raises(ValueError):
        TA.flash_attention_train(q.to("meta"), q.to("meta"), q.to("meta"))


def _dead_tile_mask(kind, b, skv):
    """kv-valid masks with whole dead runs between live ones, [B, Skv]."""
    valid = np.zeros((b, skv), dtype=bool)
    if kind == "rollout":  # sink run, recent-window run, block run
        valid[:, :9] = True
        valid[:, 40:63] = True
        valid[:, skv - 17:] = True
    elif kind == "per_batch":  # the rows' live runs differ
        valid[0, :20] = True
        valid[1, 50:70] = True
        valid[1, skv - 3:] = True
    else:  # only the ragged tail is live
        valid[:, skv - 5:] = True
    return valid


# Skipping a dead kv tile in the kernels rests on this: attention over a
# mask equals attention over the valid tokens alone.  float64 on both sides
# (no bf16 rounding of P), so the two agree to float64 rounding: the masked
# entries add exact zeros and only the order of the sums differs.
@pytest.mark.parametrize("kind,b", [("rollout", 1), ("per_batch", 2), ("tail", 1)])
def test_plain_masked_equals_plain_over_valid_tokens(kind, b):
    skv = 101
    rng = np.random.default_rng(17)
    q, k, v, dout = (torch.from_numpy(a).double() for a in _arrays(rng, b, 23, skv, 2, 16))
    valid = torch.from_numpy(_dead_tile_mask(kind, b, skv))
    out, lse = TA.flash_attention_train_plain(q, k, v, valid)
    dq, dk, dv = TA.flash_attention_train_backward_plain(q, k, v, out, lse, dout, valid)
    for bi in range(b):
        idx = valid[bi].nonzero()[:, 0]
        kc, vc = k[bi:bi + 1, idx], v[bi:bi + 1, idx]
        oc, lc = TA.flash_attention_train_plain(q[bi:bi + 1], kc, vc)
        dqc, dkc, dvc = TA.flash_attention_train_backward_plain(q[bi:bi + 1], kc, vc, oc, lc,
                                                                dout[bi:bi + 1])
        for got, want in ((out[bi], oc[0]), (lse[bi], lc[0]), (dq[bi], dqc[0]),
                          (dk[bi, idx], dkc[0]), (dv[bi, idx], dvc[0])):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)
        assert torch.all(dk[bi, ~valid[bi]] == 0) and torch.all(dv[bi, ~valid[bi]] == 0)


def _layout_tile_states(valid_frames, fs, frames, tile):
    """Tile states from the frame layout alone: tile t covers tokens
    [t tile, t tile + tile), a token is valid when its frame is, and tokens
    past the sequence count as invalid."""
    skv = frames * fs
    states = []
    for t0 in range(0, skv, tile):
        n = sum(max(0, min(t0 + tile, (f + 1) * fs) - max(t0, f * fs)) for f in valid_frames)
        states.append(TA.TILE_DEAD if n == 0 else TA.TILE_FULL if n == tile else TA.TILE_PARTIAL)
    return states


# The training rollout's self-attention mask (configs/longlive_train_init.yaml:
# 3-frame blocks, sink 3, window 12, a 21-frame cache beside the block) at a
# reduced frame size of 40 tokens, block by block over a 7-block rollout,
# against the frames the layout says are valid: sink frames [0, min(3,
# start)), ring frames [max(3, end - 9), start) at slot 3 + (f - 3) % 18,
# and the block itself after the 21 cache slots.
@pytest.mark.parametrize("tile", [64, 128])  # the kernels' (ops.attention.train_kv_tiles)
def test_rollout_mask_tile_states(tile):
    from longlive_torch.config import CacheConfig
    from longlive_torch.ops import kv_cache as kvc

    fs, sink, ring, window, nfb = 40, 3, 18, 12, 3
    cc = CacheConfig(sink_frames=sink, ring_frames=ring, frame_seq=fs)
    live_frames = []
    for blk in range(7):
        start, end = blk * nfb, blk * nfb + nfb
        state = kvc.KVCache(k=torch.empty(0), v=torch.empty(0), ring_base=sink,
                            sink_filled=min(start, sink),
                            ring_filled=min(max(start - sink, 0), ring))
        cache_valid = kvc.validity_mask(cc, state, start, nfb, window_frames=window,
                                        exclude_block=True)
        valid = torch.cat([cache_valid, torch.ones(nfb * fs, dtype=torch.bool)])
        frames = list(range(min(sink, start)))
        frames += [sink + (f - sink) % ring for f in range(max(sink, end - (window - sink)), start)]
        frames += [sink + ring + i for i in range(nfb)]
        live_frames.append(len(frames))
        want = _layout_tile_states(frames, fs, sink + ring + nfb, tile)
        assert TA.train_kv_tile_states(valid, valid.numel(), tile)[0].tolist() == want
    assert live_frames == [3, 6, 9, 12, 12, 12, 12]
