"""The port's flow solvers (``ops/solvers.py``) and the Euler flow step
(``ops/scheduler.py::step``) held against the JAX package: the UniPC and
DPM++ coefficient tables bit-equal (float32) over steps, shifts, orders and
variants; ``sample_flow`` with the same deterministic model within 1e-6
relative, from float32 and from bf16 noise; the Euler step on the CPU in
float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longlive_torch.ops import scheduler as TS
from longlive_torch.ops import solvers as TSV
from longlive_tpu.ops import scheduler as JS
from longlive_tpu.ops import solvers as JSV

FIELDS = ("timesteps", "sigmas", "ax", "am0", "am1", "am2", "bxt", "bx", "bmt", "bm1", "bm2")


def _assert_coeffs_equal(got, want):
    for f in FIELDS:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.dtype == np.float32 and w.dtype == np.float32, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("steps", [1, 2, 3, 8, 50])
@pytest.mark.parametrize("shift", [1.0, 5.0, 8.0])
@pytest.mark.parametrize("kw", [{}, {"solver_order": 1}, {"solver_type": "bh1"}],
                         ids=["order2-bh2", "order1", "bh1"])
def test_unipc_coefficients_bit_equal(steps, shift, kw):
    _assert_coeffs_equal(TSV.unipc_coefficients(steps, shift, **kw),
                         JSV.unipc_coefficients(steps, shift, **kw))


@pytest.mark.parametrize("steps", [1, 2, 3, 8, 20, 50])
@pytest.mark.parametrize("shift", [1.0, 5.0])
@pytest.mark.parametrize("kw", [{}, {"solver_order": 1}, {"solver_order": 3},
                                {"solver_type": "heun"}, {"solver_order": 3, "solver_type": "heun"},
                                {"lower_order_final": False}],
                         ids=["order2-midpoint", "order1", "order3", "heun", "order3-heun",
                              "no-lof"])
def test_dpmpp_coefficients_bit_equal(steps, shift, kw):
    _assert_coeffs_equal(TSV.dpmpp_coefficients(steps, shift, **kw),
                         JSV.dpmpp_coefficients(steps, shift, **kw))


def test_make_coefficients_dispatch():
    for name in ("unipc", "dpm++", "dpmpp"):
        _assert_coeffs_equal(TSV.make_coefficients(name, 6, 3.0),
                             JSV.make_coefficients(name, 6, 3.0))
    with pytest.raises(NotImplementedError):
        TSV.make_coefficients("euler", 4, 5.0)
    np.testing.assert_array_equal(TSV.unipc_sigmas(7, 5.0), JSV.unipc_sigmas(7, 5.0))
    np.testing.assert_array_equal(TSV.dpmpp_sigmas(7, 5.0), JSV.dpmpp_sigmas(7, 5.0))


def _model(xp, x, t):
    """A deterministic, nonlinear stand-in for the DiT: the same float32
    arithmetic in both packages."""
    return xp.tanh(x * 0.7 + t * 1e-3) - 0.25 * x


@pytest.mark.parametrize("noise_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("solver,steps", [("unipc", 6), ("dpm++", 6), ("dpm++", 2),
                                          ("unipc", 1)])
def test_sample_flow_matches_jax(solver, steps, noise_dtype):
    noise = np.random.default_rng(3).standard_normal((2, 3, 4, 5)).astype(np.float32)
    jd = getattr(jnp, noise_dtype)
    td = getattr(torch, noise_dtype)
    want = JSV.sample_flow(lambda x, t: _model(jnp, x.astype(jnp.float32), t),
                           jnp.asarray(noise).astype(jd), JSV.make_coefficients(solver, steps, 5.0))
    got = TSV.sample_flow(lambda x, t: _model(torch, x.float(), t),
                          torch.from_numpy(noise).to(td), TSV.make_coefficients(solver, steps, 5.0))
    assert got.dtype == td
    w = np.asarray(want.astype(jnp.float32))
    g = got.float().numpy()
    if noise_dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * np.abs(w).max())
    else:  # the result is rounded to bf16 once: at most one ulp apart
        np.testing.assert_allclose(g, w, rtol=2 ** -7, atol=1e-6 * np.abs(w).max())


def test_sample_flow_model_sees_noise_dtype_and_float_timesteps():
    seen = []
    coeffs = TSV.make_coefficients("unipc", 3, 5.0)

    def model(x, t):
        seen.append((x.dtype, t))
        return torch.zeros_like(x)

    TSV.sample_flow(model, torch.zeros(1, 2, dtype=torch.bfloat16), coeffs)
    assert seen == [(torch.bfloat16, float(t)) for t in coeffs.timesteps]


@pytest.mark.parametrize("to_final", [False, True])
def test_scheduler_step_matches_jax(to_final):
    kw = dict(shift=5.0, sigma_min=0.0, extra_one_step=True)
    js, ts = JS.make_schedule(1000, **kw), TS.make_schedule(1000, **kw)
    rng = np.random.default_rng(5)
    flow = rng.standard_normal((3, 4, 6, 6)).astype(np.float32)
    sample = rng.standard_normal((3, 4, 6, 6)).astype(np.float32)
    t = np.asarray([ts.timesteps[0].item(), ts.timesteps[500].item(),
                    ts.timesteps[-1].item()], np.float32)  # the last: sigma_next 0
    want = JS.step(js, jnp.asarray(flow), jnp.asarray(t), jnp.asarray(sample), to_final)
    got = TS.step(ts, torch.from_numpy(flow), torch.from_numpy(t), torch.from_numpy(sample),
                  to_final)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # a bf16 flow is stepped in float32, as in JAX
    got16 = TS.step(ts, torch.from_numpy(flow).bfloat16(), torch.from_numpy(t)[0],
                    torch.from_numpy(sample), to_final)
    want16 = JS.step(js, jnp.asarray(flow).astype(jnp.bfloat16), jnp.asarray(t)[0],
                     jnp.asarray(sample), to_final)
    assert got16.dtype == torch.float32 and want16.dtype == jnp.float32
    np.testing.assert_allclose(got16.numpy(), np.asarray(want16), rtol=1e-6, atol=1e-6)
