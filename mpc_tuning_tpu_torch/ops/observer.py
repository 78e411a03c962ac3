"""Default MPC state estimator: output-disturbance-augmented Kalman filter.

Replicates the documented MATLAB MPC Toolbox default estimator that is
implicit in every ``sim``/``mpcmove`` call of the reference
(SURVEY.md section 2.5; MPC-Tuning/MPC_Tuning/closedloop_toolbox.m:50):

 * augment the (scaled) prediction model with one integrator per measured
   output (integrated white noise, unit magnitude in scaled units);
 * unit white measurement noise on each output;
 * steady-state Kalman gain from the DARE;
 * "current" estimator form  x(k|k) = x(k|k-1) + M (y(k) - C x(k|k-1)).

All setup-time float64 host code.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.linalg import solve_discrete_are

__all__ = ["AugmentedModel", "augment_with_output_disturbance"]


@dataclasses.dataclass
class AugmentedModel:
    A: np.ndarray  # (nxa, nxa)
    Bu: np.ndarray  # (nxa, nu)
    Bv: np.ndarray  # (nxa, nd)
    C: np.ndarray  # (ny, nxa)
    Dv: np.ndarray  # (ny, nd)
    M: np.ndarray  # (nxa, ny) current-form Kalman gain
    nx_plant: int

    @property
    def nx(self) -> int:
        return self.A.shape[0]


def augment_with_output_disturbance(
    A: np.ndarray,
    Bu: np.ndarray,
    Bv: np.ndarray,
    C: np.ndarray,
    Dv: np.ndarray,
    q_plant: float = 0.0,
) -> AugmentedModel:
    """Augment with per-output integrators and design the Kalman gain.

    q_plant optionally adds white process noise on the plant states
    (MATLAB's default has none when the model declares no unmeasured
    disturbance inputs).
    """
    nx = A.shape[0]
    ny = C.shape[0]
    A_aug = np.block([[A, np.zeros((nx, ny))], [np.zeros((ny, nx)), np.eye(ny)]])
    Bu_aug = np.vstack([Bu, np.zeros((ny, Bu.shape[1]))])
    Bv_aug = np.vstack([Bv, np.zeros((ny, Bv.shape[1]))])
    C_aug = np.hstack([C, np.eye(ny)])

    Q = np.zeros((nx + ny, nx + ny))
    Q[nx:, nx:] = np.eye(ny)  # unit white noise driving the integrators
    if q_plant > 0:
        Q[:nx, :nx] = q_plant * np.eye(nx)
    R = np.eye(ny)  # unit measurement noise

    P = solve_discrete_are(A_aug.T, C_aug.T, Q, R)
    M = P @ C_aug.T @ np.linalg.inv(C_aug @ P @ C_aug.T + R)
    return AugmentedModel(A=A_aug, Bu=Bu_aug, Bv=Bv_aug, C=C_aug, Dv=Dv, M=M,
                          nx_plant=nx)
