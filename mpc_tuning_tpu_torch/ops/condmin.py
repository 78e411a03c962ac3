"""Condition-number-minimizing diagonal scaling.

Equivalent of DTC-GPC/CondMin.m:31-73: find diagonal L
(outputs) and R (inputs) with entries in [0,1], started from 0.1, that
minimize cond(L K R) of the DC-gain matrix K.  The reference calls MATLAB
``fmincon`` with an SVD-based objective; here we use L-BFGS-B with the
analytic SVD gradient

    d cond / dM = (1/s_n) u_1 v_1' - (s_1/s_n^2) u_n v_n'

Note the optimum is a manifold (cond is invariant under L -> aL, R -> R/a);
any point on it is an equally valid conditioning.  Tests check we reach a
condition number <= the one implied by the reference's committed artifacts
rather than bit-identical L/R.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import minimize

__all__ = ["condmin", "cond_of"]


def cond_of(K: np.ndarray, l: np.ndarray, r: np.ndarray) -> float:
    return float(np.linalg.cond(np.diag(l) @ K @ np.diag(r)))


def _obj_grad(x: np.ndarray, K: np.ndarray, m: int, n: int):
    l, r = x[:m], x[m:]
    M = (l[:, None] * K) * r[None, :]
    U, s, Vt = np.linalg.svd(M)
    c = s[0] / s[-1]
    G = (1.0 / s[-1]) * np.outer(U[:, 0], Vt[0, :]) - (s[0] / s[-1] ** 2) * np.outer(
        U[:, -1], Vt[-1, :]
    )
    KR = K * r[None, :]
    LK = l[:, None] * K
    gl = np.sum(G * KR, axis=1)
    gr = np.sum(G * LK, axis=0)
    return c, np.concatenate([gl, gr])


def condmin(
    K: np.ndarray, x0: float = 0.1, n_restarts: int = 4, seed: int = 0
) -> tuple[np.ndarray, np.ndarray, float]:
    """Returns (L, R, S) with L (m,m) and R (n,n) diagonal, S = cond(LKR)."""
    K = np.asarray(K, dtype=np.float64)
    m, n = K.shape
    rng = np.random.default_rng(seed)
    starts = [np.full(m + n, x0)]
    for _ in range(n_restarts - 1):
        starts.append(rng.uniform(0.05, 0.95, size=m + n))

    best = None
    for s0 in starts:
        res = minimize(
            _obj_grad,
            s0,
            args=(K, m, n),
            jac=True,
            method="L-BFGS-B",
            bounds=[(1e-8, 1.0)] * (m + n),
            options={"maxiter": 500, "ftol": 1e-14, "gtol": 1e-12},
        )
        if best is None or res.fun < best.fun:
            best = res
    l, r = best.x[:m], best.x[m:]
    return np.diag(l), np.diag(r), float(best.fun)
