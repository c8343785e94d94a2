"""The port's frame masks and its frame-masked attention held against the
JAX package's: every mask function of ``ops/masks.py`` (exactly equal),
the live-tile map at the port kernel's tiles against
``_frame_mask_tile_arrays`` (and its dead tiles against the per-element
mask), and the frame-masked attention's plain version against
``flash_attention_frame_masked`` run interpreted, at the JAX package's own
test cases, and against its dense route where the JAX kernel departs from
it (a partial last block over a padded kv tail).  Float32 on the CPU, the same numpy inputs
on both sides."""

import numpy as np
import pytest
import torch

import longlive_tpu.ops.attention as JA
from longlive_torch.ops import attention as TA
from longlive_torch.ops import masks as TM
from longlive_tpu.ops import masks as JM

ATTN_TOL = 2e-4  # float32: tiled online softmax (JAX) against whole rows (port)


@pytest.mark.parametrize("name,args", [
    ("blockwise_causal_frame_mask", (7, 1, -1)),
    ("blockwise_causal_frame_mask", (9, 3, -1)),
    ("blockwise_causal_frame_mask", (10, 3, 4)),
    ("blockwise_causal_frame_mask_i2v", (10, 3, -1)),
    ("blockwise_causal_frame_mask_i2v", (8, 3, 4)),
    ("teacher_forcing_frame_mask", (6, 3)),
    ("teacher_forcing_frame_mask", (7, 3)),  # a partial last block
    ("teacher_forcing_frame_mask", (5, 1)),
    ("sink_window_frame_mask", (9, 3, 3, 6)),
    ("sink_window_frame_mask", (8, 1, 1, 3)),
])
def test_mask_functions_match_jax(name, args):
    np.testing.assert_array_equal(getattr(TM, name)(*args).numpy(),
                                  np.asarray(getattr(JM, name)(*args)))


@pytest.mark.parametrize("spec", [
    ("block_causal", 3, -1, 0, 0), ("block_causal", 2, 4, 0, 0),
    ("sink_window", 3, 12, 3, 0), ("teacher_forcing", 3, -1, 0, 7),
])
def test_frame_mask_spec_and_expansion_match_jax(spec):
    t = TM.FrameMaskSpec(*spec).materialize(7)
    j = JM.FrameMaskSpec(*spec).materialize(7)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(TM.expand_frame_mask(t, 3).numpy(),
                                  np.asarray(JM.expand_frame_mask(j, 3)))


def test_frame_mask_spec_rejects_unknown_kind():
    with pytest.raises(ValueError):
        TM.FrameMaskSpec("causal").materialize(4)


# (kind, frame_seq, frames, nfb, local, sink): tokens per frame against the
# port kernel's 128 x 128 tiles, ragged last tiles, a partial last block
LIVE_CASES = [
    ("teacher_forcing", 40, 6, 3, -1, 0),
    ("teacher_forcing", 30, 7, 3, -1, 0),
    ("teacher_forcing", 1560, 21, 3, -1, 0),  # the 21-frame training geometry
    ("block_causal", 40, 9, 3, -1, 0),
    ("block_causal", 50, 10, 3, 4, 0),
    ("sink_window", 40, 9, 3, 4, 1),
    ("sink_window", 1560, 21, 3, 12, 3),
]


@pytest.mark.parametrize("kind,fs,f,nfb,local,sink", LIVE_CASES)
def test_live_tiles_match_jax(kind, fs, f, nfb, local, sink):
    """The JAX function takes the padded lengths; the port's whole-tile
    ranges count the same padding."""
    tf = kind == "teacher_forcing"
    s = (2 if tf else 1) * f * fs
    cf = f if tf else 0
    bq, bkv = TA.MASKED_TILE_Q, TA.MASKED_TILE_KV
    sq_p, skv_p = -(-s // bq) * bq, -(-s // bkv) * bkv
    _, live, n_live, n_total = JA._frame_mask_tile_arrays(kind, sq_p, skv_p, bq, bkv, fs, nfb,
                                                          local, sink, cf)
    got = TA.frame_mask_live_tiles(kind, s, s, bq, bkv, fs, nfb, local, sink, cf)
    assert got.shape == (sq_p // bq, skv_p // bkv)
    np.testing.assert_array_equal(got.numpy().reshape(-1), np.asarray(live).astype(bool))
    assert 0 < n_live < n_total


@pytest.mark.parametrize("kind,fs,f,nfb,local,sink", LIVE_CASES)
def test_cta_order_is_heaviest_first(kind, fs, f, nfb, local, sink):
    """The kernel's CTAs take the q tiles as a permutation in descending
    order of their live kv tiles (ties in tile order)."""
    tf = kind == "teacher_forcing"
    s = (2 if tf else 1) * f * fs
    cf = f if tf else 0
    order = TA.frame_mask_cta_order(kind, s, s, fs, nfb, local, sink, cf)
    nq = -(-s // TA.MASKED_TILE_Q)
    assert order.dtype == torch.int32
    assert torch.equal(torch.sort(order).values, torch.arange(nq, dtype=torch.int32))
    count = TA.frame_mask_live_tiles(kind, s, s, TA.MASKED_TILE_Q, TA.MASKED_TILE_KV, fs, nfb,
                                     local, sink, cf).sum(1)[order.long()]
    assert (count[:-1] >= count[1:]).all()
    ties = count[:-1] == count[1:]
    assert (order[:-1][ties] < order[1:][ties]).all()


def _qkv(seed, s, n, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((1, s, n, 128)) * sc).astype(np.float32)
            for sc in (scale, scale, 1.0)]


# the JAX package's cases (tests/test_attention.py): kind, frame_seq,
# frames, nfb, local, sink, heads, its block_q / block_kv
PLAIN_CASES = [
    ("block_causal", 16, 6, 2, -1, 0, 2, 32, 64),
    ("block_causal", 16, 6, 2, 3, 0, 2, 32, 64),
    ("sink_window", 16, 6, 2, 4, 1, 2, 32, 64),
    ("teacher_forcing", 8, 4, 2, -1, 0, 1, 32, 32),
    ("teacher_forcing", 8, 4, 3, -1, 0, 1, 32, 48),  # f % nfb != 0, padded kv
    ("teacher_forcing", 40, 6, 3, -1, 0, 1, 128, 128),
    ("block_causal", 40, 9, 3, -1, 0, 1, 128, 128),
    ("sink_window", 40, 9, 3, 4, 1, 1, 128, 128),
]


@pytest.mark.parametrize("kind,fs,f,nfb,local,sink,n,bq,bkv", PLAIN_CASES)
def test_masked_plain_matches_pallas(kind, fs, f, nfb, local, sink, n, bq, bkv):
    tf = kind == "teacher_forcing"
    s = (2 if tf else 1) * f * fs
    q, k, v = _qkv(7, s, n, 0.5)
    kw = dict(mask_kind=kind, frame_seq=fs, nfb=nfb, local=local, sink=sink,
              clean_frames=f if tf else 0)
    ref = JA.flash_attention_frame_masked(q, k, v, block_q=bq, block_kv=bkv, interpret=True,
                                          **kw)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out = TA.flash_attention_frame_masked(*t, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=ATTN_TOL, atol=ATTN_TOL)
    # the elision switch changes no bit
    assert torch.equal(TA.flash_attention_frame_masked(*t, elide_dead_tiles=False, **kw), out)


@pytest.mark.parametrize("kind,fs,f,nfb,local,sink", [c for c in LIVE_CASES if c[1] < 1000])
def test_dead_tiles_hold_no_unmasked_pair(kind, fs, f, nfb, local, sink):
    """What makes the kernel's elision exact: every (q, kv) pair of a tile
    the live map calls dead is masked, padding past the sequence included
    (the kernel's per-element mask, kv >= S masked)."""
    tf = kind == "teacher_forcing"
    s = (2 if tf else 1) * f * fs
    bq, bkv = TA.MASKED_TILE_Q, TA.MASKED_TILE_KV
    live = TA.frame_mask_live_tiles(kind, s, s, bq, bkv, fs, nfb, local, sink, f if tf else 0)
    idx = torch.arange(s)
    mask = TA._frame_token_mask(kind, idx, idx, fs, nfb, local, sink, f if tf else 0)
    live_pairs = live.repeat_interleave(bq, 0)[:s].repeat_interleave(bkv, 1)[:, :s]
    assert not (mask & ~live_pairs).any()
    assert (~live_pairs).any()


# block_causal and sink_window with f % nfb != 0 and a padded kv tail
# (112 tokens, JAX's block_kv 64): the JAX kernel leaves its padded zero
# keys (frame 7, inside the partial last block's frame range) unmasked for
# the last frame's queries; the port masks kv >= S, as JAX's dense route
# (the materialized [F, F] mask) does
PARTIAL_CASES = [
    ("block_causal", 16, 7, 3, -1, 0),
    ("sink_window", 16, 7, 3, 4, 1),
]


@pytest.mark.parametrize("kind,fs,f,nfb,local,sink", PARTIAL_CASES)
def test_masked_plain_partial_block_matches_dense(kind, fs, f, nfb, local, sink):
    s = f * fs
    q, k, v = _qkv(10, s, 2, 0.5)
    kw = dict(mask_kind=kind, frame_seq=fs, nfb=nfb, local=local, sink=sink)
    fm = JM.FrameMaskSpec(kind, nfb, local, sink).materialize(f)
    bias = np.where(np.asarray(JM.expand_frame_mask(fm, fs)), 0.0, -1e30).astype(np.float32)
    dense = np.asarray(JA.dense_attention(q, k, v, bias[None, None]))
    out = TA.flash_attention_frame_masked(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(out.numpy(), dense, rtol=ATTN_TOL, atol=ATTN_TOL)
    kern = np.asarray(JA.flash_attention_frame_masked(q, k, v, block_q=32, block_kv=64,
                                                      interpret=True, **kw))
    # the JAX kernel departs on the last frame's rows only
    np.testing.assert_allclose(kern[:, :(f - 1) * fs], dense[:, :(f - 1) * fs],
                               rtol=ATTN_TOL, atol=ATTN_TOL)
    assert np.abs(kern[:, (f - 1) * fs:] - dense[:, (f - 1) * fs:]).max() > 100 * ATTN_TOL


def test_masked_attention_under_grad_raises():
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(9, 48, 1))
    kw = dict(mask_kind="teacher_forcing", frame_seq=8, nfb=1, clean_frames=3)
    with pytest.raises(ValueError, match="forward only"):
        TA.flash_attention_frame_masked(q, k, v, **kw)
    with torch.no_grad():
        assert TA.flash_attention_frame_masked(q, k, v, **kw).shape == q.shape
    with pytest.raises(ValueError, match="mask_kind"):
        TA.flash_attention_frame_masked(q.detach(), k.detach(), v.detach(), mask_kind="causal",
                                        frame_seq=8)
