"""The open-vs-closed horizon check (``cases/verify_horizons``) of both
packages on the CPU at float64, at the tuned points of ``chip_smoke.py``'s
tunes on the card (phase 3f reads ok False at all three):

  * Wood-Berry, phase 3's tune: N 7, Nu 3, delta [0.263334, 0.670454],
    lambda [0.097199, 0.05639] (the full case, its own conditioning);
  * Shell3x3, phase 3c's tune (the case at nit 250): N 8, Nu 2, delta
    [2.358838, 0.426045, 0.810902], lambda [0.066399, 0.246926, 0.085728];
  * Shell7x5, phase 3b's band tune: N 37, Nu 3, delta 0, lambda
    [0.213821, 0.00761, 0.030921], the measured disturbance held at its
    final value; the JAX package called with the split band engine the
    port's band legs run ('pdip_ws_lanes+lp20+split12').

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/horizons_vs_jax.py \\
        [--cases woodberry shell3x3 shell7x5]

Prints, per case, each package's mismatch vector and ok, the largest
difference of the four legs and the seconds each package took (the band
case several minutes on one CPU core).  Imports both packages; the port
runs its plain versions (device "cpu").
"""

from __future__ import annotations

import argparse
import time

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from mpc_tuning_tpu.cases import shell3x3 as s3_jax  # noqa: E402
from mpc_tuning_tpu.cases import shell7x5 as s7_jax  # noqa: E402
from mpc_tuning_tpu.cases import woodberry as wb_jax  # noqa: E402
from mpc_tuning_tpu.cases.verify_horizons import \
    verify_horizons as verify_jax  # noqa: E402
from mpc_tuning_tpu.tuning import api as api_jax  # noqa: E402
from mpc_tuning_tpu_torch.cases import shell3x3 as s3_torch  # noqa: E402
from mpc_tuning_tpu_torch.cases import shell7x5 as s7_torch  # noqa: E402
from mpc_tuning_tpu_torch.cases import woodberry as wb_torch  # noqa: E402
from mpc_tuning_tpu_torch.cases.verify_horizons import \
    verify_horizons  # noqa: E402
from mpc_tuning_tpu_torch.sim.mpc_loop import (BAND_LP_ITERS,  # noqa: E402
                                               BAND_S2_ITERS)
from mpc_tuning_tpu_torch.tuning import api as api_torch  # noqa: E402

JAX_BAND = f"pdip_ws_lanes+lp{BAND_LP_ITERS}+split{BAND_S2_ITERS}"
# (JAX case module, port case module, make_case keywords, N, Nu, delta,
# lambda): the tuned points as chip_smoke.py printed them (PERF.md §7)
POINTS = {
    "woodberry": (wb_jax, wb_torch, {}, 7, 3, [0.263334, 0.670454],
                  [0.097199, 0.05639]),
    "shell3x3": (s3_jax, s3_torch, dict(nit=250), 8, 2,
                 [2.358838, 0.426045, 0.810902],
                 [0.066399, 0.246926, 0.085728]),
    "shell7x5": (s7_jax, s7_torch, {}, 37, 3, [0.0] * 7,
                 [0.213821, 0.00761, 0.030921]),
}
FIELDS = ("y_closed", "y_open", "u_closed", "u_open")


def checks(name):
    """(the JAX package's HorizonCheck, the port's, JAX seconds, port
    seconds) at the tuned point of ``name``."""
    mod_j, mod_t, case_kw, N, Nu, delta, lam = POINTS[name]
    pj, info = api_jax.build_problem(mod_j.make_case(**case_kw),
                                     dtype=jnp.float64)
    pt, _ = api_torch.build_problem(mod_t.make_case(**case_kw),
                                    dtype=torch.float64, device="cpu")
    L = info[0]
    args = (L, N, Nu, np.asarray(delta), np.asarray(lam))
    band = pt.loop.ctl.spec.has_y_constraints
    kw_j = dict(v_const=pj.v[-1], qp_method=JAX_BAND) if band else {}
    kw_t = dict(v_const=pt.v[-1]) if band else {}
    t0 = time.perf_counter()
    cj = verify_jax(pj.loop, *args, **kw_j)
    t1 = time.perf_counter()
    ct = verify_horizons(pt.loop, *args, dtype=torch.float64, device="cpu",
                         **kw_t)
    return cj, ct, t1 - t0, time.perf_counter() - t1


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", nargs="+", default=list(POINTS),
                    choices=list(POINTS))
    args = ap.parse_args()
    torch.set_num_threads(1)
    for name in args.cases:
        cj, ct, sj, st = checks(name)
        legs = max(float(np.abs(getattr(ct, k) - getattr(cj, k)).max())
                   for k in FIELDS)
        print(f"{name}: jax mismatch {cj.mismatch.tolist()} ok {cj.ok} "
              f"({sj:.1f} s) | port mismatch {ct.mismatch.tolist()} ok "
              f"{ct.ok} ({st:.1f} s) | max |d mismatch| "
              f"{float(np.abs(ct.mismatch - cj.mismatch).max()):.3e}, legs "
              f"{legs:.3e}", flush=True)


if __name__ == "__main__":
    main()
