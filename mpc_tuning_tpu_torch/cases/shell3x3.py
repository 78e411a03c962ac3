"""Shell heavy-oil fractionator 3x3 tracking case — configuration transcribed
from MPC-Tuning/Shell3x3.m:30-163.

``run`` tunes, simulates the tuned controller and runs the open-vs-closed
horizon check (the per-output selector protocol, ``cases/verify_horizons``).
"""

from __future__ import annotations

import numpy as np

from mpc_tuning_tpu_torch.cases._common import diag_pref, ref_trajectory
from mpc_tuning_tpu_torch.models import plants
from mpc_tuning_tpu_torch.tuning.api import (LinearCase, TuningResult,
                                           mpc_tuning)

NIT = 500
TS = 4.0
INK = 10
NBP, NBC = 7, 4
W_PARETO = np.array([0.05, 0.40, 0.55])  # Shell3x3.m:161


def make_case(rest: bool = True, caso: int = 1, nit: int = NIT,
              nbp: int = NBP, nbc: int = NBC) -> LinearCase:
    p = plants.shell3x3()

    # staircase setpoints (Shell3x3.m:89-92, 1-indexed)
    Xsp = np.zeros((nit, 3))
    Xsp[INK - 1 : 80, 0] = 0.2
    Xsp[199:400, 0] = 0.1
    Xsp[INK - 1 : 80, 1] = 0.2
    Xsp[79:200, 1] = 0.4
    Xsp[199:400, 1] = 0.3
    Xsp[INK - 1 : 80, 2] = 0.2
    Xsp[79:200, 2] = 0.1

    taus = [5.0, 9.0, 5.7] if caso == 1 else [30.0, 30.0, 30.0]
    pref = diag_pref(taus, [27.0, 14.0, 0.0], TS)  # Shell3x3.m:71-77
    Yref = ref_trajectory(pref, Xsp, TS)

    mdv = np.zeros((nit, 0))

    big = 1e30
    if rest:
        umax = np.array([0.5, 0.5, 0.5])
        umin = np.array([-1.0, -1.0, -1.0])  # Shell3x3.m:122-124
        dumax = np.array([0.05, 0.05, 0.05])
    else:
        umax = np.full(3, big); umin = -umax; dumax = np.full(3, big)

    return LinearCase(
        name="Shell3x3",
        plant=p.G, n_mv=3, n_md=0, Ts=TS,
        Xsp=Xsp, Yref=Yref, mdv=mdv, nit=nit,
        w=W_PARETO,
        umin=umin, umax=umax, dumin=-dumax, dumax=dumax,
        ymin=np.full(3, -np.inf), ymax=np.full(3, np.inf),
        ov_weight0=np.array([1.0, 1.0, 1.0]), mvrate_weight0=np.array([0.1, 0.1, 0.1]),
        nbp=nbp, nbc=nbc,
    )


def final_simulation(case: LinearCase, res: TuningResult, nominal: bool = True,
                     nit: int | None = None):
    """Closed loop of the tuned controller against the (possibly
    mismatched) real plant, at float64 on the tuner's device and at its QP
    budget (as the JAX package's, whose MPCLoop.simulate defaults to
    float64).  Returns (y, u) in raw units."""
    nit = nit or case.nit
    real = plants.shell3x3() if nominal else plants.shell3x3(0.2, 0.2, 0.3)
    prob = res.problem
    plant_c = real.G.scaled(res.L, res.R).c2d(case.Ts).to_ss()
    from mpc_tuning_tpu_torch.sim.mpc_loop import MPCLoop

    loop = MPCLoop(ctl=prob.loop.ctl, plant_ss=plant_c)
    y_c, u_c = loop.simulate(prob.r, prob.v, nit, res.N, int(np.max(res.Nu)),
                             res.delta, res.lam, qp_iters=prob.qp_iters,
                             device=prob.device)
    y = (np.linalg.inv(res.L) @ y_c.T).T
    u = u_c * res.Ru[None, :]
    return y, u


def run(tuning: bool = True, rest: bool = True, caso: int = 1,
        nominal: bool = True, nit: int = NIT, **tuner_kwargs):
    """The case end to end: tune -> final simulation -> open-vs-closed
    horizon check (Shell3x3.m:195-241), all on the tuner's device
    (``tuner_kwargs['device']``, the card by default). Returns (case, res,
    (y, u), check)."""
    from mpc_tuning_tpu_torch.cases.verify_horizons import verify_horizons

    case = make_case(rest=rest, caso=caso, nit=nit)
    res = mpc_tuning(case, **tuner_kwargs)
    y, u = final_simulation(case, res, nominal=nominal)
    check = verify_horizons(res.problem.loop, res.L, res.N,
                            int(np.max(res.Nu)), res.delta, res.lam,
                            device=res.problem.device)
    return case, res, (y, u), check
