"""Wood-Berry 2x2 distillation case — configuration transcribed from
MPC-Tuning/WoodBerry.m:22-156.

Flags follow the reference convention: ``tuning`` (run the hybrid tuner vs
reload a checkpoint), ``rest`` (constraints), ``caso`` (fast/slow Pref),
``nominal`` (plant-model mismatch fault injection).
"""

from __future__ import annotations

import numpy as np

from mpc_tuning_tpu_torch.cases._common import diag_pref, ref_trajectory
from mpc_tuning_tpu_torch.models import plants
from mpc_tuning_tpu_torch.tuning.api import (LinearCase, TuningResult,
                                           mpc_tuning)

NIT = 400
TS = 1.0
INK = 10
NBP, NBC = 7, 4
W_PARETO = np.array([0.1, 0.50])  # WoodBerry.m:154


def make_case(rest: bool = True, caso: int = 1, nit: int = NIT,
              nbp: int = NBP, nbc: int = NBC) -> LinearCase:
    p = plants.wood_berry()

    Xsp = np.zeros((nit, 2))
    Xsp[INK - 1 :, 0] = 0.8  # WoodBerry.m:87-89 (1-indexed k=10)
    Xsp[199:, 1] = 0.5
    mdv = np.zeros((nit, 1))
    mdv[299:, 0] = -0.25  # WoodBerry.m:92-94

    taus = [10.0, 7.0] if caso == 1 else [15.0, 12.0]
    pref = diag_pref(taus, [1.0, 1.0], TS)  # WoodBerry.m:69-75
    Yref = ref_trajectory(pref, Xsp, TS)

    big = 1e30
    if rest:
        umax = np.array([0.5, 0.5])
        dumax = np.array([0.05, 0.05])  # WoodBerry.m:118-125
    else:
        umax = np.full(2, big)
        dumax = np.full(2, big)

    return LinearCase(
        name="WoodBerry",
        plant=p.full, n_mv=2, n_md=1, Ts=TS,
        Xsp=Xsp, Yref=Yref, mdv=mdv, nit=nit,
        w=W_PARETO,
        umin=-umax, umax=umax, dumin=-dumax, dumax=dumax,
        ymin=np.full(2, -np.inf), ymax=np.full(2, np.inf),
        ov_weight0=np.array([1.0, 1.0]), mvrate_weight0=np.array([0.1, 0.1]),
        nbp=nbp, nbc=nbc,
    )


def final_simulation(case: LinearCase, res: TuningResult, nominal: bool = True,
                     nit: int | None = None):
    """Closed loop of the tuned controller against the (possibly mismatched)
    real plant (WoodBerry.m:266-285: options.Model = L*Ps*R with Ps != model
    when nominal=false), at float64 on the tuner's device and at its QP
    budget (as the JAX package's, whose MPCLoop.simulate defaults to
    float64).  Returns (y, u) in raw units."""
    nit = nit or case.nit
    real = plants.wood_berry() if nominal else plants.wood_berry(deltak=0.2, deltaL=1.0)
    prob = res.problem
    plant_c = real.full.scaled(res.L, res.R).c2d(case.Ts).to_ss()
    from mpc_tuning_tpu_torch.sim.mpc_loop import MPCLoop

    loop = MPCLoop(ctl=prob.loop.ctl, plant_ss=plant_c)
    y_c, u_c = loop.simulate(prob.r, prob.v, nit, res.N, int(np.max(res.Nu)),
                             res.delta, res.lam, qp_iters=prob.qp_iters,
                             device=prob.device)
    Linv = np.linalg.inv(res.L)
    y = (Linv @ y_c.T).T
    u = u_c * res.Ru[None, :]
    return y, u


def run(tuning: bool = True, rest: bool = True, caso: int = 1,
        nominal: bool = True, nit: int = NIT, **tuner_kwargs):
    """The case end to end: tune -> final simulation -> open-vs-closed
    horizon check, the reference's built-in sanity protocol
    (WoodBerry.m:186-251), all on the tuner's device
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
