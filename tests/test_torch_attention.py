"""The plain version of the port's attention kernel (flash_attention on a
CPU tensor) held against the JAX Pallas ``_flash_kernel`` run in interpret
mode in its bias + kv_layer mode, D = 128, with masked cache slots."""

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
