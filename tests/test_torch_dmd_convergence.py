"""The port's DMD learning check (``scripts/torch_dmd_convergence.py``):
the toy target equals the JAX harness's, a 2-step run finishes with a
finite curve, and (slow) the margins of ``tests/test_dmd_convergence.py``:
the generator moves toward the teacher's distribution, and the sign-flipped
control does not."""

import math
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))


def test_make_mu_matches_jax_and_short_run_is_finite():
    import dmd_convergence as JH
    import torch_dmd_convergence as H

    from longlive_torch.config import tiny_geometry
    from longlive_tpu.config import tiny_geometry as j_geom

    np.testing.assert_allclose(H.make_mu(tiny_geometry(), 4).numpy(),
                               np.asarray(JH.make_mu(j_geom(), 4)), rtol=1e-6, atol=1e-6)
    for streaming in (False, True):
        r = H.run(steps=2, eval_every=1, teacher_steps=2, verbose=False, streaming=streaming)
        assert [s for s, _ in r["curve"]] == [0, 1, 2]
        assert all(math.isfinite(v) and v > 0 for _, v in r["curve"])
        assert math.isfinite(r["teacher_fm_loss"]) and len(r["critic_losses"]) == 2
        assert r["streaming"] == streaming


@pytest.mark.slow
def test_dmd_training_learns_and_sign_flip_fails():
    import torch_dmd_convergence as H

    common = dict(steps=60, eval_every=20, teacher_steps=300, verbose=False)
    pos = H.run(flip_sign=False, **common)
    assert pos["final_mse"] < 0.8 * pos["initial_mse"], pos["curve"]
    first_third = [v for s, v in pos["curve"] if s <= common["steps"] // 3]
    assert pos["final_mse"] < min(first_third), pos["curve"]

    neg = H.run(flip_sign=True, **common)
    assert neg["final_mse"] > 0.95 * neg["initial_mse"], neg["curve"]
    assert neg["final_mse"] > 2.0 * pos["final_mse"]
