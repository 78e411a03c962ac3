"""Goal-attainment weight optimization (the continuous half of the hybrid).

The reference calls MATLAB ``fgoalattain`` with goal = 0.001, weight vector
w, EqualityGoalCount = all (MPC_TFob.m:61-67): minimize the attainment
factor gamma such that F_i(x) - w_i*gamma <= goal_i, driving the weighted
objectives toward equality.  That is exactly the minimax program

    min_x  gamma(x) = max_i (F_i(x) - goal_i) / w_i ,   x >= lb

which we solve with a deterministic CMA-ES over log-parametrized weights —
every generation is ONE batch of closed-loop simulations, so the
whole population runs on the device together instead of fgoalattain's sequential
finite differences (DiffMinChange=0.5, MPCTuning.m:88-91).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mpc_tuning_tpu_torch.tuning.objectives import TuningProblem, gam_sse_batch

__all__ = ["gam_solve", "GAMResult"]


@dataclasses.dataclass
class GAMResult:
    x: np.ndarray  # best decision vector [delta, lambda] (>= lb)
    gamma: float  # attainment factor (negative = over-achievement)
    F: np.ndarray  # per-output SSE at the best x
    evals: int


def gam_solve(
    problem: TuningProblem,
    N: int,
    Nu: int,
    x0: np.ndarray,
    lb: float = 1e-5,
    popsize: int = 16,
    generations: int = 30,
    sigma0: float = 0.5,
    seed: int = 0,
    tol_gamma: float = 1e-3,
) -> GAMResult:
    """Deterministic CMA-ES on y = log(x)."""
    w = np.asarray(problem.w, dtype=np.float64)
    n = len(x0)
    rng = np.random.default_rng(seed)

    def gamma_of(F_rows: np.ndarray) -> np.ndarray:
        return np.max((F_rows - problem.goal) / w[None, :], axis=1)

    y_mean = np.log(np.maximum(np.asarray(x0, dtype=np.float64), lb))
    sigma = sigma0
    C = np.eye(n)
    p_sigma = np.zeros(n)
    p_c = np.zeros(n)
    mu = popsize // 2
    wts = np.log(mu + 0.5) - np.log(np.arange(1, mu + 1))
    wts /= wts.sum()
    mu_eff = 1.0 / np.sum(wts**2)
    c_sigma = (mu_eff + 2) / (n + mu_eff + 5)
    d_sigma = 1 + 2 * max(0, np.sqrt((mu_eff - 1) / (n + 1)) - 1) + c_sigma
    c_c = (4 + mu_eff / n) / (n + 4 + 2 * mu_eff / n)
    c_1 = 2 / ((n + 1.3) ** 2 + mu_eff)
    c_mu = min(1 - c_1, 2 * (mu_eff - 2 + 1 / mu_eff) / ((n + 2) ** 2 + mu_eff))
    chi_n = np.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n * n))

    best_x, best_gamma, best_F = None, np.inf, None
    evals = 0
    eig_B, eig_D = np.eye(n), np.ones(n)

    for gen in range(generations):
        # sample population; lane 0 is the incumbent mean itself (elitist
        # evaluation lane — the mean is the recombination point CMA steers
        # toward but never scores without this)
        Z = rng.standard_normal((popsize, n))
        Z[0] = 0.0
        Ymut = y_mean[None, :] + sigma * (Z * eig_D[None, :]) @ eig_B.T
        X = np.exp(Ymut)
        X = np.maximum(X, lb)
        F_rows = gam_sse_batch(problem, N, Nu, X)
        evals += popsize
        # failure containment: a diverged closed loop (unstable candidate)
        # yields inf/NaN SSE; treat as a huge-but-finite cost so the search
        # continues (the reference wraps every sim in try/catch and leaves
        # the objective unchanged, GAM_fun.m:80-91)
        F_rows = np.where(np.isfinite(F_rows), F_rows, 1e30)
        g = gamma_of(F_rows)

        order = np.argsort(g)
        if g[order[0]] < best_gamma:
            best_gamma = float(g[order[0]])
            best_x = X[order[0]].copy()
            best_F = F_rows[order[0]].copy()

        # lane 0 is the injected mean (Z[0]=0): it competes for elitism
        # above, but is EXCLUDED from recombination and the p_sigma /
        # covariance updates — a zero mutation row would shrink the rank-mu
        # update and bias p_sigma/sigma downward whenever the mean ranks
        # top-mu (standard CMA-ES injection handling).
        sel = order[order != 0][:mu]
        y_old = y_mean
        y_mean = (wts[None, :] @ Ymut[sel]).ravel()

        y_w = (y_mean - y_old) / sigma
        C_inv_sqrt = eig_B @ np.diag(1.0 / eig_D) @ eig_B.T
        p_sigma = (1 - c_sigma) * p_sigma + np.sqrt(
            c_sigma * (2 - c_sigma) * mu_eff
        ) * (C_inv_sqrt @ y_w)
        h_sig = float(
            np.linalg.norm(p_sigma)
            / np.sqrt(1 - (1 - c_sigma) ** (2 * (gen + 1)))
            < (1.4 + 2 / (n + 1)) * chi_n
        )
        p_c = (1 - c_c) * p_c + h_sig * np.sqrt(c_c * (2 - c_c) * mu_eff) * y_w
        artmp = (Ymut[sel] - y_old[None, :]) / sigma
        C = (
            (1 - c_1 - c_mu) * C
            + c_1 * (np.outer(p_c, p_c) + (1 - h_sig) * c_c * (2 - c_c) * C)
            + c_mu * (artmp.T * wts) @ artmp
        )
        sigma = sigma * np.exp((c_sigma / d_sigma) * (np.linalg.norm(p_sigma) / chi_n - 1))
        sigma = float(np.clip(sigma, 1e-8, 5.0))

        C = 0.5 * (C + C.T)
        eig_vals, eig_B = np.linalg.eigh(C)
        eig_D = np.sqrt(np.maximum(eig_vals, 1e-20))

        # fgoalattain-like loose termination (StepTolerance 0.01 analogue)
        if sigma < 0.01 and gen > 5:
            break

    return GAMResult(x=best_x, gamma=best_gamma, F=best_F, evals=evals)
