"""Reference noise schedules in float64: LongLive's few-step causal
schedule and Wan2.1's UniPC (bh2, order 2, lower-order final) sampler.

The UniPC coefficients follow ``FlowUniPCMultistepScheduler`` of Wan2.1
(predict_x0, flow prediction), unrolled into per-step constants: the
predictor x_{i+1} = ax x + am0 m_i + am1 m_{i-1}, the corrector
x_i <- bxt x_i + bx x_{i-1} + bmt m_i + bm1 m_{i-1}.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def causal_sigmas(shift: float, steps: Sequence[int], warp: bool = True,
                  num_train: int = 1000) -> List[float]:
    """(timestep, sigma) pairs of LongLive's denoising list: sigmas
    linspace(1, 0, T + 1)[:-1], shift-warped; timestep = 1000 sigma; a warped
    step s reads entry T - s of [timesteps, 0]."""
    s = np.linspace(1.0, 0.0, num_train + 1)[:-1]
    s = shift * s / (1.0 + (shift - 1.0) * s)
    if not warp:
        raise ValueError("the benchmark's configurations warp their denoising steps")
    sig = np.concatenate([s, [0.0]])
    return [float(sig[num_train - int(x)]) for x in steps]


def unipc_table(num_steps: int, shift: float, num_train: int = 1000) -> Dict[str, np.ndarray]:
    """Per-step constants of UniPC-bh2 of order 2 with the lower-order final
    step, and the integer timesteps fed to the model."""
    sigma_max = 1.0 - 1.0 / num_train
    s = np.linspace(sigma_max, 0.0, num_steps + 1)[:-1]
    s = shift * s / (1.0 + (shift - 1.0) * s)
    sig = np.concatenate([s, [0.0]])
    n = num_steps
    with np.errstate(divide="ignore"):
        lam = np.log(1.0 - sig) - np.log(sig)
    alpha = 1.0 - sig
    # predictor orders: 1 while warming up and at the last step, else 2; the
    # corrector of step i has the order of predictor i - 1
    order = [min(2, n - i, i + 1) for i in range(n)]
    t = {k: np.zeros(n) for k in ("ax", "am0", "am1", "bxt", "bx", "bmt", "bm1", "bm2")}
    for i in range(n):
        c = order[i - 1] if i > 0 else 0
        if c == 0:
            t["bxt"][i] = 1.0
        else:
            h = lam[i] - lam[i - 1]
            b_h = h_phi_1 = np.expm1(-h)
            if c == 1:
                rhos = np.array([0.5])
            else:
                rk = (lam[i - 2] - lam[i - 1]) / h
                hk1 = h_phi_1 / -h - 1.0
                hk2 = hk1 / -h - 0.5
                rhos = np.linalg.solve(np.array([[1.0, 1.0], [rk, 1.0]]),
                                       np.array([hk1 / b_h, 2.0 * hk2 / b_h]))
            a = alpha[i]
            t["bx"][i] = sig[i] / sig[i - 1]
            t["bmt"][i] = -a * b_h * rhos[-1]
            t["bm1"][i] = -a * h_phi_1 + a * b_h * rhos[-1]
            if c == 2:
                t["bm1"][i] += a * b_h * rhos[0] / rk
                t["bm2"][i] = -a * b_h * rhos[0] / rk
        h = lam[i + 1] - lam[i]
        b_h = h_phi_1 = np.expm1(-h)
        a = alpha[i + 1]
        t["ax"][i] = sig[i + 1] / sig[i] if sig[i + 1] > 0 else 0.0
        t["am0"][i] = -a * h_phi_1
        if order[i] == 2:
            rk = (lam[i - 1] - lam[i]) / h
            t["am0"][i] += a * b_h * 0.5 / rk
            t["am1"][i] = -a * b_h * 0.5 / rk
    t["sigma"] = sig[:-1]
    t["timestep"] = np.trunc(sig[:-1] * num_train)
    return t


class UniPC:
    """The sampler state in float64 (torch tensors): ``model_input`` is the
    x the next model call sees; ``step(v)`` takes that call's flow."""

    def __init__(self, noise, table: Dict[str, np.ndarray]):
        self.t = table
        self.i = 0
        self.x = noise.double()
        self.m1 = self.m2 = self.x_prev = None

    @property
    def timestep(self) -> float:
        return float(self.t["timestep"][self.i])

    def step(self, v) -> None:
        t, i = self.t, self.i
        mt = self.x - t["sigma"][i] * v.double()
        xc = self.x
        if i > 0:
            xc = (t["bxt"][i] * self.x + t["bx"][i] * self.x_prev + t["bmt"][i] * mt
                  + t["bm1"][i] * self.m1)
            if i > 1:
                xc = xc + t["bm2"][i] * self.m2
        xn = t["ax"][i] * xc + t["am0"][i] * mt
        if i > 0:
            xn = xn + t["am1"][i] * self.m1
        self.x, self.m2, self.m1, self.x_prev = xn, self.m1, mt, xc
        self.i += 1
