"""Open-loop vs closed-loop horizon check (the port of the JAX package's
``cases/verify_horizons.py``).

The reference's built-in physical check (MPC-Tuning/WoodBerry.m:186-232,
commentary at :186-202; the same protocol in Shell3x3.m:195-241): solve the
MPC once at rest toward a unit setpoint, play the whole optimal sequence
out, and compare it with the receding-horizon closed loop; with well chosen
horizons the two nearly coincide.  Square systems run the per-output
selector protocol; non-square and band systems run the reference's pulse
protocol (Shell7x5.m:242-261: a unit setpoint pulse on the first 5
samples, the measured disturbances held constant, one simulation).

Returns the per-output data and a mismatch score usable as a regression
signal.

Engines.  The port names its closed-loop engine (one of
``sim/mpc_loop.ENGINES``) instead of the JAX package's qp-method string:
'pdip' (the cold masked PDIP each step, the JAX package's default
``qp_method='pdip'``) for tracking loops and 'band_sim' (the slack LP of
20 iterations, then the slack-frozen stage 2 of 12) for band loops, the
only engine a band loop runs.  The warm 'pdip_sim' is another algorithm:
at Shell3x3's tuned N 8, Nu 2 its 30 iterations leave the closed leg
8.8e-4 from the cold PDIP's, and the mismatch 3.0e-3
(``scripts/horizons_vs_jax.py``).  The band open leg is
``MPCLoop.open_loop`` of a band loop: the cold slack LP of 20 iterations,
then the slack-frozen stage 2 of ``qp_iters`` (the JAX package's
``open_loop(..., qp_split=True, qp_lp=20)``).  This departs from the JAX
package's band default, ``qp_method='pdip'``: the joint PDIP without the
split stalls ~5e-2 off the optimum on band steps (ADVICE.md), so the
port's band legs match the JAX package called with
``qp_method='pdip_ws_lanes+lp20+split12'``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpc_tuning_tpu_torch.sim.mpc_loop import MPCLoop

__all__ = ["verify_horizons", "HorizonCheck"]

MISMATCH_OK = 0.2  # every output's normalized L2 mismatch below this


@dataclasses.dataclass
class HorizonCheck:
    y_closed: np.ndarray  # (ny, nit) closed loop, output i under selector i
    y_open: np.ndarray  # (ny, nit) single-shot playback
    u_closed: np.ndarray
    u_open: np.ndarray
    mismatch: np.ndarray  # (ny,) normalized L2 mismatch per output

    @property
    def ok(self) -> bool:
        return bool(np.all(self.mismatch < MISMATCH_OK))

    def as_json(self) -> dict:
        return {"mismatch": [round(float(x), 4) for x in self.mismatch],
                "ok": self.ok}


def verify_horizons(loop: MPCLoop, L: np.ndarray, N: int, Nu: int,
                    delta, lam, nit: int | None = None,
                    dtype=torch.float64, v_const: np.ndarray | None = None,
                    pulse: int = 5, engine: str | None = None,
                    qp_iters: int = 30, device="cuda") -> HorizonCheck:
    """Run the protocol at the tuned horizons (conditioned units) on
    ``device``.  ``engine``: the closed leg's engine, by default
    'band_sim' for band loops and 'pdip' (the JAX package's cold PDIP)
    otherwise."""
    band = loop.ctl.spec.has_y_constraints
    engine = engine or ("band_sim" if band else "pdip")
    ny = loop.ctl.spec.model.ny
    nu = loop.ctl.spec.n_mv
    nd = loop.ctl.spec.n_md
    nit = nit or (N + 30)  # WoodBerry.m:203 / Shell7x5.m:242
    kw = dict(dtype=dtype, qp_iters=qp_iters, device=device)

    r_unit = np.asarray(L @ np.ones(ny))
    if v_const is None:
        v = np.zeros((nit, nd))
    else:
        v = np.tile(np.asarray(v_const, dtype=np.float64), (nit, 1))

    if ny == nu:
        # per-output selector protocol (WoodBerry.m:203-232)
        y_c = np.zeros((ny, nit))
        y_o = np.zeros((ny, nit))
        u_c = np.zeros((ny, nit))
        u_o = np.zeros((ny, nit))
        for i in range(ny):
            sel = np.zeros(ny)
            sel[i] = 1.0
            r = np.tile(r_unit * sel, (nit, 1))
            yc, uc = loop.simulate(r, v, nit, N, Nu, delta, lam,
                                   engine=engine, **kw)
            yo, uo = loop.open_loop(r_unit * sel, v, nit, N, Nu, delta, lam,
                                    **kw)
            y_c[i] = yc[:, i]
            y_o[i] = yo[:, i]
            u_c[i] = uc[:, i]
            u_o[i] = uo[:, i]
    else:
        # non-square pulse protocol (Shell7x5.m:242-261): unit setpoint on
        # the first `pulse` samples, MD held, ONE closed + open sim
        r = np.zeros((nit, ny))
        r[:pulse] = r_unit
        yc, uc = loop.simulate(r, v, nit, N, Nu, delta, lam, engine=engine,
                               **kw)
        yo, uo = loop.open_loop(r[-1], v, nit, N, Nu, delta, lam, **kw)
        y_c, y_o = yc.T, yo.T
        u_c, u_o = uc.T, uo.T

    mismatch = np.linalg.norm(y_c - y_o, axis=1) / (
        np.linalg.norm(y_o, axis=1) + 1e-12
    )
    return HorizonCheck(y_closed=y_c, y_open=y_o, u_closed=u_c, u_open=u_o,
                        mismatch=mismatch)
