"""Explicit NMPC Van de Vusse demo — configuration transcribed from
Explicit NMPC/main.m:20-64 (fixed tuning N=5, Nu=[2 2], Q=[1.0214 0.9999],
W=[1e-4 1e-4]); the port of the JAX package's
``cases/vandevusse_explicit.py``."""

from __future__ import annotations

import numpy as np

from mpc_tuning_tpu_torch.models.ode import (VDV_U0, VDV_X0,
                                             newton_steady_state,
                                             vandevusse_rhs)
from mpc_tuning_tpu_torch.sim.explicit_nmpc import ExplicitNMPC

NIT = 150
TS = 0.05
INK = 4  # main.m:53


def make_controller(substeps: int = 10, sqp_iters: int = 5,
                    qp_iters: int = 25, noise: float = 0.01) -> ExplicitNMPC:
    return ExplicitNMPC(
        rhs=vandevusse_rhs, nx=3, ny=2, nu=2, xc=(1, 2), Ts=TS,
        N=5, Nu=(2, 2),
        Q=np.array([1.0214, 0.9999]), W=np.array([1.0e-4, 1.0e-4]),
        ub=np.array([150.0, 150.0]), lb=np.array([0.0, 40.0]),
        substeps=substeps, sqp_iters=sqp_iters, qp_iters=qp_iters,
        noise=noise,
    )


def make_reference(x0: np.ndarray, nit: int = NIT) -> np.ndarray:
    """main.m:56-58 setpoint staircase (1-indexed)."""
    r = np.zeros((nit, 2))
    r[:, 0] = x0[1]
    r[9:, 0] = 1.2
    r[49:, 0] = 1.0
    r[:, 1] = x0[2]
    r[80:, 1] = 130.0
    r[110:, 1] = 120.0
    return r


def run(nit: int = NIT, seed: int = 0, noise: float = 0.01, device="cuda",
        **kwargs):
    """The demo's closed loop from the steady state, its measurement noise
    drawn from a torch.Generator seeded with ``seed`` (``noise`` = 0: the
    noise-free loop), on ``device`` (the card by default).  Returns (r, y,
    u) NumPy arrays."""
    x0 = newton_steady_state(vandevusse_rhs, VDV_X0, VDV_U0)
    u0 = np.asarray(VDV_U0)
    ctl = make_controller(noise=noise, **kwargs)
    r = make_reference(x0, nit)
    n = ctl.draw_noise(nit, seed) if noise else None
    y, u = ctl.simulate(x0, u0, r, nit, inK=INK, noise=n, device=device)
    return r, y, u
