"""Trajectory rollout for discrete state-space models.

``dlsim`` is the float64 NumPy rollout, the equivalent of MATLAB
``lsim(P, u, t, 'zoh')`` sampled at kTs (MPC-Tuning/WoodBerry.m:98).
"""

from __future__ import annotations

import numpy as np

__all__ = ["dlsim"]


def dlsim(ss, U: np.ndarray, x0: np.ndarray | None = None) -> np.ndarray:
    """Simulate y(k) for k=0..T-1 given inputs U (T, nu). Host float64."""
    U = np.asarray(U, dtype=np.float64)
    T = U.shape[0]
    x = np.zeros(ss.nx) if x0 is None else np.asarray(x0, dtype=np.float64)
    Y = np.zeros((T, ss.ny))
    for k in range(T):
        Y[k] = ss.C @ x + ss.D @ U[k]
        x = ss.A @ x + ss.B @ U[k]
    return Y
