"""Flow-matching multistep ODE solvers (UniPC, DPM-Solver++) for the
bidirectional Wan samplers (text-to-video and image-to-video).

For a fixed (num_steps, shift, solver_order) every per-step coefficient,
the warm-up and lower-order-final order schedule and the UniPC corrector
order included, is a constant.  So:

1. the coefficients are computed on the host in float64 numpy
   (``unipc_coefficients``, ``dpmpp_coefficients``) and kept as float32
   arrays; each sampler step is then a 5-term linear combination of
   (x, x_prev, m_t, m_{i-1}, m_{i-2});
2. ``sample_flow`` is a loop over the steps whose only real work is the
   model call.

The math, with x0 = x_t - sigma_t * v (predict_x0, flow prediction):
UniPC-p predictor with the B(h) variants bh1 / bh2, the UniPC-c corrector,
DPM-Solver++ of orders 1-3 (midpoint / heun), the sigma grids with the
shift warp and the final zero.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SolverCoeffs:
    """Per-step tables for ``sample_flow``, each [N] float32 numpy.

    Predictor:  x_{i+1} = ax*x + am0*m_i + am1*m_{i-1} + am2*m_{i-2}
    Corrector:  x_i    <- bxt*x_i + bx*x_{i-1} + bmt*m_i + bm1*m_{i-1}
                          + bm2*m_{i-2}
    where m_j is the x0-prediction of step j (m_i from the current model
    call).  DPM++ has no corrector: bxt == 1, the rest 0.
    """

    timesteps: np.ndarray  # the value fed to the model (truncated to an integer)
    sigmas: np.ndarray  # sigma at each step (for the x0 conversion)
    ax: np.ndarray
    am0: np.ndarray
    am1: np.ndarray
    am2: np.ndarray
    bxt: np.ndarray
    bx: np.ndarray
    bmt: np.ndarray
    bm1: np.ndarray
    bm2: np.ndarray


def _pack(timesteps, sigmas, pred, corr) -> SolverCoeffs:
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return SolverCoeffs(
        timesteps=f(timesteps), sigmas=f(sigmas),
        ax=f(pred[:, 0]), am0=f(pred[:, 1]), am1=f(pred[:, 2]), am2=f(pred[:, 3]),
        bxt=f(corr[:, 0]), bx=f(corr[:, 1]), bmt=f(corr[:, 2]),
        bm1=f(corr[:, 3]), bm2=f(corr[:, 4]),
    )


def flow_shift_warp(sigmas: np.ndarray, shift: float) -> np.ndarray:
    """sigma' = s*sigma / (1 + (s-1)*sigma)."""
    return shift * sigmas / (1.0 + (shift - 1.0) * sigmas)


def unipc_sigmas(num_steps: int, shift: float,
                 num_train_timesteps: int = 1000) -> np.ndarray:
    """UniPC's sigma grid from sigma_max = 1 - 1/T, shift-warped, with the
    final sigma 0 appended."""
    sigma_max = 1.0 - 1.0 / num_train_timesteps
    s = np.linspace(sigma_max, 0.0, num_steps + 1, dtype=np.float64)[:-1]
    s = flow_shift_warp(s, shift)
    return np.concatenate([s, [0.0]])


def dpmpp_sigmas(num_steps: int, shift: float,
                 num_train_timesteps: int = 1000) -> np.ndarray:
    """DPM++'s sigma grid (starting at exactly 1.0), shift-warped, with the
    final zero appended."""
    s = np.linspace(1.0, 0.0, num_steps + 1, dtype=np.float64)[:num_steps]
    s = flow_shift_warp(s, shift)
    return np.concatenate([s, [0.0]])


def _lambdas(sigmas: np.ndarray) -> np.ndarray:
    """lambda = log(alpha) - log(sigma), alpha = 1 - sigma."""
    with np.errstate(divide="ignore"):
        return np.log(1.0 - sigmas) - np.log(sigmas)


def _timesteps_of(sigmas: np.ndarray, num_train_timesteps: int) -> np.ndarray:
    # truncated to an integer before it is fed to the model
    return np.trunc(sigmas[:-1] * num_train_timesteps)


def unipc_coefficients(
    num_steps: int,
    shift: float = 5.0,
    solver_order: int = 2,
    solver_type: str = "bh2",
    lower_order_final: bool = True,
    num_train_timesteps: int = 1000,
    sigmas: Optional[np.ndarray] = None,
) -> SolverCoeffs:
    """The whole UniPC-p / UniC predictor-corrector schedule, its
    ``lower_order_nums`` warm-up and ``this_order`` bookkeeping unrolled."""
    if solver_type not in ("bh1", "bh2"):
        raise ValueError(f"UniPC solver_type {solver_type!r}: bh1 or bh2")
    # an order-3 corrector would need m_{i-3}, which the sampler state does
    # not carry; order 2 is the shipped one
    if not 1 <= solver_order <= 2:
        raise ValueError(f"UniPC solver_order {solver_order}: 1 or 2")
    if sigmas is None:
        sigmas = unipc_sigmas(num_steps, shift, num_train_timesteps)
    sigmas = np.asarray(sigmas, np.float64)
    n = len(sigmas) - 1
    lam = _lambdas(sigmas)
    alpha = 1.0 - sigmas

    # the order schedule, deterministic
    pred_orders, corr_orders = [], []
    lower_order_nums = 0
    prev_order = 0
    for i in range(n):
        corr_orders.append(prev_order if i > 0 else 0)
        order = min(solver_order, n - i) if lower_order_final else solver_order
        order = min(order, lower_order_nums + 1)
        pred_orders.append(order)
        if lower_order_nums < solver_order:
            lower_order_nums += 1
        prev_order = order

    def bh_terms(h):
        """(hh, h_phi_1, B_h) for hh = -h (predict_x0)."""
        hh = -h
        h_phi_1 = np.expm1(hh)
        b_h = hh if solver_type == "bh1" else np.expm1(hh)
        return hh, h_phi_1, b_h

    def rb_system(order, rks, hh, h_phi_1, b_h):
        """The R rows and b entries of the order conditions."""
        rr, bb = [], []
        h_phi_k = h_phi_1 / hh - 1.0
        factorial_i = 1.0
        for i in range(1, order + 1):
            rr.append(np.power(rks, i - 1))
            bb.append(h_phi_k * factorial_i / b_h)
            factorial_i *= i + 1
            h_phi_k = h_phi_k / hh - 1.0 / factorial_i
        return np.stack(rr), np.asarray(bb)

    pred = np.zeros((n, 4))
    corr = np.zeros((n, 5))
    for i in range(n):
        # corrector of order c
        c = corr_orders[i]
        if c == 0:
            corr[i, 0] = 1.0  # identity: keep this sample
        else:
            h = lam[i] - lam[i - 1]
            hh, h_phi_1, b_h = bh_terms(h)
            rks = [(lam[i - 1 - j] - lam[i - 1]) / h for j in range(1, c)] + [1.0]
            rks = np.asarray(rks)
            r_mat, b_vec = rb_system(c, rks, hh, h_phi_1, b_h)
            rhos_c = np.asarray([0.5]) if c == 1 else np.linalg.solve(r_mat, b_vec)
            corr[i, 1] = sigmas[i] / sigmas[i - 1]  # on the last sample
            corr[i, 2] = -alpha[i] * b_h * rhos_c[-1]  # on m_t (the D1_t term)
            # on m_{i-1}: -alpha*h_phi_1, + D1_t's +m0, + each D1s' +m0/rk
            corr[i, 3] = -alpha[i] * h_phi_1 + alpha[i] * b_h * rhos_c[-1]
            for j in range(1, c):  # D1s_j = (m_{i-1-j} - m0) / rk_j
                corr[i, 3] += alpha[i] * b_h * rhos_c[j - 1] / rks[j - 1]
                corr[i, 4 + (j - 1)] -= alpha[i] * b_h * rhos_c[j - 1] / rks[j - 1]

        # predictor of order p
        p = pred_orders[i]
        h = lam[i + 1] - lam[i]
        hh, h_phi_1, b_h = bh_terms(h)
        rks = [(lam[i - j] - lam[i]) / h for j in range(1, p)] + [1.0]
        rks = np.asarray(rks)
        pred[i, 0] = sigmas[i + 1] / sigmas[i] if sigmas[i + 1] > 0 else 0.0
        pred[i, 1] = -alpha[i + 1] * h_phi_1
        if p >= 2:
            r_mat, b_vec = rb_system(p, rks, hh, h_phi_1, b_h)
            rhos_p = (np.asarray([0.5]) if p == 2
                      else np.linalg.solve(r_mat[:-1, :-1], b_vec[:-1]))
            for j in range(1, p):  # D1s_j = (m_{i-j} - m0) / rk_j
                pred[i, 1] += alpha[i + 1] * b_h * rhos_p[j - 1] / rks[j - 1]
                pred[i, 1 + j] -= alpha[i + 1] * b_h * rhos_p[j - 1] / rks[j - 1]

    return _pack(_timesteps_of(sigmas, num_train_timesteps), sigmas[:-1], pred, corr)


def dpmpp_coefficients(
    num_steps: int,
    shift: float = 5.0,
    solver_order: int = 2,
    solver_type: str = "midpoint",
    lower_order_final: bool = True,
    euler_at_final: bool = False,
    num_train_timesteps: int = 1000,
    sigmas: Optional[np.ndarray] = None,
) -> SolverCoeffs:
    """The multistep DPM-Solver++ schedule (final sigma zero)."""
    if solver_type not in ("midpoint", "heun"):
        raise ValueError(f"DPM++ solver_type {solver_type!r}: midpoint or heun")
    if not 1 <= solver_order <= 3:
        raise ValueError(f"DPM++ solver_order {solver_order}: 1, 2 or 3")
    if sigmas is None:
        sigmas = dpmpp_sigmas(num_steps, shift, num_train_timesteps)
    sigmas = np.asarray(sigmas, np.float64)
    n = len(sigmas) - 1
    lam = _lambdas(sigmas)
    alpha = 1.0 - sigmas

    pred = np.zeros((n, 4))
    corr = np.zeros((n, 5))
    corr[:, 0] = 1.0  # no corrector in DPM++
    lower_order_nums = 0
    for i in range(n):
        # a final sigma of zero forces first order at the last step; below
        # 15 steps the one before it is second order at most
        lof = i == n - 1
        los = (i == n - 2) and lower_order_final and n < 15
        h = lam[i + 1] - lam[i]
        emh1 = np.expm1(-h)  # exp(-h) - 1
        pred[i, 0] = sigmas[i + 1] / sigmas[i] if sigmas[i + 1] > 0 else 0.0
        if solver_order == 1 or lower_order_nums < 1 or lof:
            pred[i, 1] = -alpha[i + 1] * emh1
        elif solver_order == 2 or lower_order_nums < 2 or los:
            h0 = lam[i] - lam[i - 1]
            r0 = h0 / h
            if solver_type == "midpoint":
                pred[i, 1] = -alpha[i + 1] * emh1 * (1.0 + 0.5 / r0)
                pred[i, 2] = alpha[i + 1] * emh1 * 0.5 / r0
            else:  # heun
                k = alpha[i + 1] * (emh1 / h + 1.0)
                pred[i, 1] = -alpha[i + 1] * emh1 + k / r0
                pred[i, 2] = -k / r0
        else:  # third order
            h0, h1 = lam[i] - lam[i - 1], lam[i - 1] - lam[i - 2]
            r0, r1 = h0 / h, h1 / h
            kd1 = alpha[i + 1] * (emh1 / h + 1.0)
            kd2 = -alpha[i + 1] * ((emh1 + h) / h**2 - 0.5)
            # D1 = D1_0 + (r0/(r0+r1))(D1_0 - D1_1); D2 = (D1_0 - D1_1)/(r0+r1)
            c10 = (1.0 + r0 / (r0 + r1)) / r0  # D1's m0-m1 weight
            c11 = (r0 / (r0 + r1)) / r1  # D1's -(m1-m2) weight
            d20 = 1.0 / (r0 + r1) / r0
            d21 = 1.0 / (r0 + r1) / r1
            pred[i, 1] = -alpha[i + 1] * emh1 + kd1 * c10 + kd2 * d20
            pred[i, 2] = -kd1 * (c10 + c11) - kd2 * (d20 + d21)
            pred[i, 3] = kd1 * c11 + kd2 * d21
        if lower_order_nums < solver_order:
            lower_order_nums += 1

    return _pack(_timesteps_of(sigmas, num_train_timesteps), sigmas[:-1], pred, corr)


def make_coefficients(solver: str, num_steps: int, shift: float, **kw) -> SolverCoeffs:
    """'unipc' | 'dpm++' (also 'dpmpp')."""
    if solver == "unipc":
        return unipc_coefficients(num_steps, shift, **kw)
    if solver in ("dpm++", "dpmpp"):
        return dpmpp_coefficients(num_steps, shift, **kw)
    raise NotImplementedError(f"Unsupported solver: {solver}")


def sample_flow(model_fn: Callable[[torch.Tensor, float], torch.Tensor],
                noise: torch.Tensor, coeffs: SolverCoeffs) -> torch.Tensor:
    """Runs the sampler, one model call per step.

    ``model_fn(x, t)`` returns the flow prediction at timestep ``t`` (a
    Python float); classifier-free guidance and the conditioning are the
    caller's closure.  x reaches the model in ``noise``'s dtype; the solver
    state (x, m_{i-1}, m_{i-2}, x_prev) stays float32 whatever that dtype,
    and each coefficient is a float32 value.  The result is in ``noise``'s
    dtype.  The JAX package's scanned ``sample_flow`` and its host-loop
    ``sample_flow_eager`` are this one loop here."""
    c = {k: [float(a) for a in getattr(coeffs, k)]
         for k in ("timesteps", "sigmas", "ax", "am0", "am1", "am2", "bxt", "bx", "bmt",
                   "bm1", "bm2")}
    x = noise.float()
    z = torch.zeros_like(x)
    m1, m2, x_prev = z, z, z
    for i in range(len(c["timesteps"])):
        v = model_fn(x.to(noise.dtype), c["timesteps"][i]).float()
        mt = x - c["sigmas"][i] * v  # the x0 conversion
        xc = (c["bxt"][i] * x + c["bx"][i] * x_prev + c["bmt"][i] * mt
              + c["bm1"][i] * m1 + c["bm2"][i] * m2)
        xn = c["ax"][i] * xc + c["am0"][i] * mt + c["am1"][i] * m1 + c["am2"][i] * m2
        x, m1, m2, x_prev = xn, mt, m1, xc
    return x.to(noise.dtype)
