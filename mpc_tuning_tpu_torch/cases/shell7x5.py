"""Shell 7x5 non-square band-control case — configuration transcribed from
MPC-Tuning/Shell7x5.m:28-204.

7 outputs, 3 MVs, 2 MDs; all OV weights zero => pure band control through
soft output constraints with per-output ECR softening and ScaleFactors.
``run`` tunes, simulates the tuned controller and runs the open-vs-closed
horizon check (the non-square pulse protocol, ``cases/verify_horizons``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mpc_tuning_tpu_torch.cases._common import ref_trajectory
from mpc_tuning_tpu_torch.models import lti, plants
from mpc_tuning_tpu_torch.tuning.api import (LinearCase, TuningResult,
                                           mpc_tuning)

NIT = 200
TS = 4.0
INK = 10
TMD = 20  # measured-disturbance entry step (Shell7x5.m:121)
NBP, NBC = 7, 4
W_PARETO = np.array([1e-4, 1e-4, 1.0, 0.5, 1.0, 0.5, 1.0])  # Shell7x5.m:202

YMN = np.array([-0.005, -0.005, -0.5, -0.5, -0.5, -0.5, -0.5])
YMX = np.array([0.005, 0.005, 0.5, 0.5, 0.5, 0.5, 0.5])
UMX = np.array([0.5, 0.5, 0.5])


@dataclasses.dataclass(frozen=True)
class TunedPoint:
    """One tuned parameter set in its own conditioning frame: L and R the
    diagonals of the output and input scalings (R with the MD columns)."""

    N: int
    Nu: np.ndarray
    delta: np.ndarray
    lam: np.ndarray
    L: np.ndarray
    R: np.ndarray


# The reference's own tuning of this case (BASELINE.md): every output
# weight 0 (band control), Nu 2 on every input.
REF_TUNED = TunedPoint(
    N=27, Nu=np.array([2, 2, 2]), delta=np.zeros(7),
    lam=np.array([0.0559, 0.0167, 1.6102]),
    L=np.array([0.4401, 0.2319, 0.6265, 0.5431, 0.6006, 0.2069, 0.3942]),
    R=np.array([0.2640, 0.1351, 0.1156, 0.7819, 0.4665]),
)


def make_case(nit: int = NIT, nbp: int = NBP, nbc: int = NBC) -> LinearCase:
    p = plants.shell7x5()

    Xsp = np.zeros((nit, 7))  # band control: no setpoints (Shell7x5.m:117)
    mdv = np.zeros((nit, 2))
    mdv[TMD - 1 :, :] = 0.5  # Shell7x5.m:122-123

    # impulse-shaped Yref from the expected MD rejection (Shell7x5.m:125-133)
    pref_rows = [[lti.tf([1.0], [50.0, 1.0]) if i == j else lti.tf([0.0], [1.0])
                  for j in range(7)] for i in range(7)]
    # Pref.iodelay = diag(min over the FULL [G D] row delays) (Shell7x5.m:115)
    pref = lti.TransferFunction(pref_rows).set_iodelay(
        np.diag(p.full.iodelay.min(axis=1))
    )
    Xref = np.zeros((nit, 7))
    for i in range(7):
        Xref[TMD - 1 : TMD + 5, i] = YMX[i]
    Yref = ref_trajectory(pref, Xref, TS)

    # ECR softening (Shell7x5.m:155-165)
    v_ecr = np.ones(7)
    v_ecr[0] = 0.1
    v_ecr[1] = 0.5

    return LinearCase(
        name="Shell7x5",
        plant=p.full, n_mv=3, n_md=2, Ts=TS,
        Xsp=Xsp, Yref=Yref, mdv=mdv, nit=nit,
        w=W_PARETO,
        umin=-UMX, umax=UMX,
        dumin=np.full(3, -1e30), dumax=np.full(3, 1e30),  # no rate limits set
        ymin=YMN, ymax=YMX,
        v_ymin=v_ecr, v_ymax=v_ecr,
        ov_weight0=np.zeros(7),  # pure band control (Shell7x5.m:188)
        mvrate_weight0=np.array([0.1, 0.1, 0.1]),
        rho_eps=10000.0,  # Shell7x5.m:189
        sf_u=UMX - (-UMX),  # ScaleFactors from ranges (Shell7x5.m:168-183)
        sf_y=YMX - YMN,
        sf_v=np.array([0.5, 0.5]),
        nbp=nbp, nbc=nbc,
    )


def final_simulation(case: LinearCase, res: TuningResult, nominal: bool = True,
                     nit: int | None = None):
    """Closed loop of the tuned controller against the (possibly
    mismatched, Shell7x5.m:37-42) real plant: a B = 1 'band_sim' loop at
    the tuner's own dtype and device.  The band engine runs its fixed
    stage counts; ``qp_iters`` only sizes the open leg.  Returns (y, u) in
    raw units."""
    nit = nit or case.nit
    real = plants.shell7x5() if nominal else plants.shell7x5(0.2, 0.2, 0.3, 0.5, 0.5)
    prob = res.problem
    plant_c = real.full.scaled(res.L, res.R).c2d(case.Ts).to_ss()
    from mpc_tuning_tpu_torch.sim.mpc_loop import MPCLoop

    loop = MPCLoop(ctl=prob.loop.ctl, plant_ss=plant_c)
    y_c, u_c = loop.simulate(prob.r, prob.v, nit, res.N, int(np.max(res.Nu)),
                             res.delta, res.lam, dtype=prob.dtype,
                             qp_iters=prob.qp_iters, engine="band_sim",
                             device=prob.device)
    y = (np.linalg.inv(res.L) @ y_c.T).T
    u = u_c * res.Ru[None, :]
    return y, u


def run(nominal: bool = True, nit: int = NIT, **tuner_kwargs):
    """The case end to end: tune -> final simulation -> open-vs-closed
    horizon check (non-square pulse protocol, Shell7x5.m:242-291), all on
    the tuner's device (``tuner_kwargs['device']``, the card by default);
    the check's legs run the split band engine ('band_sim',
    ``cases/verify_horizons``). Returns (case, res, (y, u), check)."""
    from mpc_tuning_tpu_torch.cases.verify_horizons import verify_horizons

    # the band-control QP (tight +-0.005 bands, ~600 soft rows) needs more
    # interior-point iterations than the tracking cases
    tuner_kwargs.setdefault("qp_iters", 60)
    case = make_case(nit=nit)
    res = mpc_tuning(case, **tuner_kwargs)
    y, u = final_simulation(case, res, nominal=nominal)
    check = verify_horizons(res.problem.loop, res.L, res.N,
                            int(np.max(res.Nu)), res.delta, res.lam,
                            v_const=res.problem.v[-1],
                            device=res.problem.device)
    return case, res, (y, u), check
