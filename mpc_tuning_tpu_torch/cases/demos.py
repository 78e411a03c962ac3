"""Standalone controller demos with the reference's hardcoded tuned values
(the port of the JAX package's ``cases/demos.py``: the checkpoint
reproduction path, no tuner in the loop).

 * Shell 3x3 linear MPC with the committed tuning N=24, Nu=[6 2 2],
   delta=[0.0107 0.0040 0.0008], lambda=[1e-4 6e-4 1.5e-3]
   (Matlab-Toolbox/MPC/MPC_Lineal_Shell3x3.m:152-155, matching
   Shell3x3_Tuning_25Jul2023_12_06.mat — BASELINE.md), its closed loop
   through the cold masked PDIP engine 'pdip' (the JAX package's
   ``MPCLoop.simulate`` default).
 * Van de Vusse NMPC with N=3, Nu=[2 2], delta=[0.0930 0.1133],
   lambda=[0.2460 0.1231] (Matlab-Toolbox/NMPC/VanDeVusse_NMPC.m:168-171).

These double as the reproduction path of the reference's `tuning=false`
reload branch (WoodBerry.m:163-178) when pointed at a saved checkpoint.
Both run on ``device``, the card by default ("cpu" for the plain
versions).
"""

from __future__ import annotations

import numpy as np
import torch

from mpc_tuning_tpu_torch.utils.io import load_tuning

__all__ = ["SHELL3X3_REF_TUNING", "VDV_REF_TUNING", "shell3x3_demo",
           "vandevusse_demo"]

SHELL3X3_REF_TUNING = dict(
    N=24, Nu=np.array([6, 2, 2]),
    delta=np.array([0.010655, 0.0040421, 0.00079143]),
    lam=np.array([9.2519e-05, 0.00055259, 0.0015191]),
    L=np.diag([0.4358, 0.4206, 0.5933]),
    R=np.diag([0.6619, 0.2756, 0.4117]),
)

VDV_REF_TUNING = dict(
    N=3, Nu=np.array([2, 2]),
    delta=np.array([0.0930, 0.1133]),
    lam=np.array([0.2460, 0.1231]),
)


def shell3x3_demo(nit: int = 500, tuning: dict | None = None,
                  checkpoint: str | None = None, nominal: bool = True,
                  dtype=torch.float64, device="cuda"):
    """MPC_Lineal_Shell3x3.m equivalent: fixed tuning, closed loop, raw
    units.  Returns (case, tuning, (y (nit, 3), u (nit, 3)))."""
    from mpc_tuning_tpu_torch.cases import shell3x3
    from mpc_tuning_tpu_torch.models import plants
    from mpc_tuning_tpu_torch.sim.mpc_loop import MPCLoop
    from mpc_tuning_tpu_torch.tuning.api import build_problem

    t = dict(SHELL3X3_REF_TUNING)
    if checkpoint is not None:
        d = load_tuning(checkpoint)
        t.update(N=int(np.max(d["N"])), Nu=d["Nu"], delta=d["delta"],
                 lam=d["lam"], L=d["L"], R=d["R"])
    if tuning is not None:
        t.update(tuning)

    case = shell3x3.make_case(nit=nit)
    problem, _ = build_problem(case, dtype=dtype, L=t["L"], R=t["R"],
                               device=device)
    real = plants.shell3x3() if nominal else plants.shell3x3(0.2, 0.2, 0.3)
    plant_c = real.G.scaled(t["L"], t["R"]).c2d(case.Ts).to_ss()
    loop = MPCLoop(ctl=problem.loop.ctl, plant_ss=plant_c)
    with torch.inference_mode():  # no derivatives: no autograd per op
        y_c, u_c = loop.simulate(problem.r, problem.v, nit,
                                 int(t["N"]), int(np.max(t["Nu"])),
                                 t["delta"], t["lam"], dtype=dtype,
                                 engine="pdip", device=device)
    Ru = np.diag(t["R"])
    y = (np.linalg.inv(t["L"]) @ y_c.T).T
    u = u_c * Ru[None, :]
    return case, t, (y, u)


def vandevusse_demo(nit: int = 60, tuning: dict | None = None,
                    checkpoint: str | None = None, dtype=torch.float64,
                    device="cuda"):
    """Matlab-Toolbox/NMPC/VanDeVusse_NMPC.m equivalent with fixed tuning.
    Returns (case, tuning, (y (nit, 2), u (nit, 2)))."""
    from mpc_tuning_tpu_torch.cases import vandevusse

    t = dict(VDV_REF_TUNING)
    if checkpoint is not None:
        d = load_tuning(checkpoint)
        t.update(N=int(np.max(d["N"])), Nu=d["Nu"], delta=d["delta"],
                 lam=d["lam"])
    if tuning is not None:
        t.update(tuning)

    case = vandevusse.make_case(nit=nit)  # forward-mode AD: outside
    problem = vandevusse.build_problem(case, dtype, device)
    with torch.inference_mode():
        y, u = problem.loop.simulate(case.r, problem.v, nit,
                                     int(t["N"]), int(np.max(t["Nu"])),
                                     t["delta"], t["lam"], dtype=dtype,
                                     device=device)
    return case, t, (y, u)
