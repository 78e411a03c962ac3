"""The Shell3x3 tune at the budget of ``chip_smoke.py`` phase 3c, the JAX
package against the PyTorch port, both at float64 on the CPU.  Like the
tests, this check imports both packages.

    PYTHONPATH=. python scripts/shell3x3_tune_vs_jax.py {jax,port} \
        [--nit 500] [--threads 4]

Budget (phase 3c): the full case (nit 500, nbp/nbc 7/4), popsize 8, 3
generations, 1 alternation, seed 0, qp_iters 15, no joint polish, the
case's initial weights.  Both packages run their decision-grade float64
engine, the warm lane-major PDIP 'pdip_ws_lanes', at both stages (the JAX
package's CPU 'auto'; the port's plain version of it).  Phase 3c itself
runs float32 on the card through 'pdip_ws_fused' / 'admm_fused', so its
result is compared with these, not held to them.  Prints N, Nu, delta,
lam, Fvns, Fgam and the wall time.  Run the two packages in two
processes side by side.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

BUDGET = dict(gam_popsize=8, gam_generations=3, max_alternations=1, seed=0,
              joint_polish=False)


def tune(api, case, problem, label):
    x0 = np.concatenate([case.ov_weight0, case.mvrate_weight0])
    problem.qp_method = problem.vns_qp_method = "pdip_ws_lanes"
    t0 = time.perf_counter()
    best, d, l, Fv, Fg, _ = api.hybrid_tune(problem, case.nbp, case.nbc, x0,
                                            verbose=True, **BUDGET)
    print(f"{label} Shell3x3 tune (CPU f64, nit {case.nit}, popsize 8, 3 "
          f"generations, 1 alternation, seed 0, qp_iters 15, no joint "
          f"polish, pdip_ws_lanes): N={best['N']} "
          f"Nu={np.asarray(best['Nu']).tolist()} "
          f"delta={np.round(d, 6).tolist()} lam={np.round(l, 6).tolist()} "
          f"Fvns={Fv!r} Fgam={Fg!r} in {time.perf_counter() - t0:.1f} s",
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("package", choices=("jax", "port"))
    ap.add_argument("--nit", type=int, default=500)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp

        from mpc_tuning_tpu.cases import shell3x3
        from mpc_tuning_tpu.tuning import api

        case = shell3x3.make_case(nit=args.nit)
        problem, _ = api.build_problem(case, dtype=jnp.float64, qp_iters=15)
        tune(api, case, problem, "JAX")
    else:
        import torch

        torch.set_num_threads(args.threads)
        from mpc_tuning_tpu_torch.cases import shell3x3
        from mpc_tuning_tpu_torch.tuning import api

        case = shell3x3.make_case(nit=args.nit)
        problem, _ = api.build_problem(case, dtype=torch.float64,
                                       qp_iters=15, device="cpu")
        tune(api, case, problem, "port")


if __name__ == "__main__":
    main()
