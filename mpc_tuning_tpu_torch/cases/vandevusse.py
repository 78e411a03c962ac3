"""Van de Vusse CSTR NMPC tuning case — configuration transcribed from
MPC-Tuning/VanDeVusse_NMPC.m:33-204 (the port of the JAX package's
``cases/vandevusse.py``).

2 outputs (Cb, T = states 2, 3), 2 MVs (feed flow F, coolant temp Tk),
Ts = 0.05 h, nit = 60, nbp = 5, nbc = 4, pareto w = [0.7, 0.3].
Nonlinear branch: no conditioning (MPCTuning.m:202-255), direct state
feedback, reference trajectory from a fast diagonal Pref offset to the
steady state.  Every candidate evaluation runs on ``device``: the card by
default (the rollout kernel steps either integrator, RK4 or the stiff
TR-BDF2 that stands in for the reference's ode15s), "cpu" for the plain
versions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpc_tuning_tpu_torch.cases._common import diag_pref, ref_trajectory
from mpc_tuning_tpu_torch.models.ode import (VDV_U0, VDV_X0,
                                             newton_steady_state,
                                             vandevusse_rhs)
from mpc_tuning_tpu_torch.ops.kernels import require_device
from mpc_tuning_tpu_torch.sim.nmpc_loop import NMPCLoop, NMPCSpec
from mpc_tuning_tpu_torch.tuning.api import hybrid_tune
from mpc_tuning_tpu_torch.tuning.objectives import TuningProblem
from mpc_tuning_tpu_torch.utils.io import save_tuning

NIT = 60
TS = 0.05
NBP, NBC = 5, 4
W_PARETO = np.array([0.7, 0.3])  # VanDeVusse_NMPC.m:202

UB = np.array([150.0, 150.0])  # F, Q upper (VanDeVusse_NMPC.m:49-57)
LB = np.array([0.0, 40.0])
XMIN = np.array([0.0, 0.0, 40.0])  # Ca, Cb, Q(T) lower
XMAX = np.array([6.0, 1.2, 150.0])
X0_WEIGHTS = np.array([1.0, 1.0, 0.1, 0.1])  # delta0, lambda0 (:195-198)


@dataclasses.dataclass
class VdVCase:
    spec: NMPCSpec
    r: np.ndarray
    Yref: np.ndarray
    nit: int
    w: np.ndarray
    nbp: int
    nbc: int
    x0: np.ndarray
    u0: np.ndarray


def make_case(nit: int = NIT, nbp: int = NBP, nbc: int = NBC,
              substeps: int = 10, sqp_iters: int = 4, qp_iters: int = 25,
              integrator: str = "rk4") -> VdVCase:
    # steady state via Newton (fsolve equivalent, VanDeVusse_NMPC.m:72-79)
    x0 = newton_steady_state(vandevusse_rhs, VDV_X0, VDV_U0)
    u0 = np.asarray(VDV_U0)

    # setpoints (VanDeVusse_NMPC.m:88-90, 1-indexed)
    r = np.zeros((nit, 2))
    r[:, 0] = x0[1]
    r[9:, 0] = 1.0
    r[:, 1] = x0[2]
    r[40:, 1] = 130.0

    # Yref: fast first-order Pref on the setpoint deviation + steady offset
    # (VanDeVusse_NMPC.m:170-186)
    pref = diag_pref([0.05, 0.0875], [0.0, 0.0], TS)
    Yref = ref_trajectory(pref, r - x0[1:][None, :], TS) + x0[1:][None, :]

    spec = NMPCSpec(
        rhs=vandevusse_rhs, nx=3, ny=2, nu=2, xc=(1, 2), Ts=TS,
        p_max=2**nbp - 1, m_max=2**nbc - 1,
        umin=LB, umax=UB,
        ymin=XMIN[1:], ymax=XMAX[1:],
        sf_u=UB - LB,  # ScaleFactors from ranges (VanDeVusse_NMPC.m:148-164)
        sf_y=XMAX[1:] - XMIN[1:],
        x0=x0, u0=u0,
        substeps=substeps, sqp_iters=sqp_iters, qp_iters=qp_iters,
        integrator=integrator,  # init.integrator slot (VanDeVusse_NMPC.m:85)
    )
    return VdVCase(spec=spec, r=r, Yref=Yref, nit=nit, w=W_PARETO,
                   nbp=nbp, nbc=nbc, x0=x0, u0=u0)


def build_problem(case: VdVCase, dtype=torch.float64,
                  device="cuda") -> TuningProblem:
    """The case's TuningProblem: every evaluation on ``device`` (the card
    by default; a host without one raises unless device="cpu")."""
    require_device(device)
    return TuningProblem(
        loop=NMPCLoop(spec=case.spec), r=case.r, v=np.zeros((case.nit, 0)),
        Yref=case.Yref, nit=case.nit, w=case.w,
        band_mask=np.zeros(2, dtype=bool),
        dmin=np.zeros(2, dtype=np.int64),  # nonlinear: dmin = 0 (VNS2.m:68-73)
        nbp=case.nbp, nbc=case.nbc, dtype=dtype, device=device,
        qp_iters=case.spec.qp_iters,
    )


def run(nit: int = NIT, checkpoint_dir: str | None = "checkpoints",
        verbose: bool = True, dtype=torch.float64, device="cuda", mesh=None,
        **tuner_kwargs):
    """MPCTuning-equivalent for the nonlinear case (VanDeVusse_NMPC.m:204)
    followed by the final closed loop (VanDeVusse_NMPC.m:244).  ``mesh``
    (``parallel.sweep.candidate_mesh``): the tune's candidate batches are
    sharded over its devices (``TuningProblem.mesh``); the final closed
    loop runs on ``device``."""
    case = make_case(nit=nit)
    problem = build_problem(case, dtype, device)
    problem.mesh = mesh
    best, delta, lam, Fva, Fvf, history = hybrid_tune(
        problem, case.nbp, case.nbc, X0_WEIGHTS, verbose=verbose,
        **tuner_kwargs)
    if checkpoint_dir is not None:
        save_tuning(checkpoint_dir, "VanDeVusse_NMPC", best["N"], best["Nu"],
                    delta, lam, np.eye(2), np.eye(2), [Fva, Fvf])
    y, u = problem.loop.simulate(case.r, problem.v, case.nit,
                                 int(best["N"]), int(np.max(best["Nu"])),
                                 delta, lam, dtype=dtype, device=device)
    return case, dict(N=int(best["N"]), Nu=best["Nu"], delta=delta, lam=lam,
                      Fvns=Fva, Fgam=Fvf, history=history), (y, u)
