"""Trajectory rollout for discrete state-space models.

``dlsim`` is the float64 NumPy rollout, the equivalent of MATLAB
``lsim(P, u, t, 'zoh')`` sampled at kTs (MPC-Tuning/WoodBerry.m:98);
``dlsim_torch`` is the same recursion on torch tensors, on the device of
its inputs (the JAX package's ``dlsim_jax``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["dlsim", "dlsim_torch"]


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


def dlsim_torch(A, B, C, D, U, x0=None):
    """y(k) = C x(k) + D u(k), x(k+1) = A x(k) + B u(k) for the inputs U
    (T, nu), from x0 (zeros by default), on the tensors' device and dtype.
    Returns (Y (T, ny), x_final)."""
    x = (torch.zeros(A.shape[0], dtype=A.dtype, device=A.device)
         if x0 is None else x0)
    Y = torch.empty((U.shape[0], C.shape[0]), dtype=A.dtype, device=A.device)
    for k in range(U.shape[0]):
        Y[k] = C @ x + D @ U[k]
        x = A @ x + B @ U[k]
    return Y, x
