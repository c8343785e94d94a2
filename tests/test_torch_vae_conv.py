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


def test_pack_weights_layout():
    w = torch.arange(2 * 3 * 3 * 3 * 1, dtype=torch.float32).reshape(2, 3, 3, 3, 1)
    p = TV.pack_weights(w)
    assert p.shape == (3, 3, 1, 2, 3)
    assert p[2, 1, 0, 1, 0] == w[1, 0, 2, 1, 0]
