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
