"""How far two correct float64 evaluations of the Shell3x3 VNS objective
can differ: the PyTorch port's VNS cost F through the decision-grade
per-step engine 'pdip_ws_lanes' (15 PDIP iterations per step), on the CPU,
at the given weights and at the same weights moved by one ulp.

    PYTHONPATH=. python scripts/rescore_spread_torch.py [--pairs 15,9 15,7 11,9]
        [--delta 2.365784 0.36274 1.289007] [--lam 0.048031 0.089506 0.11518]
        [--qp-iters 15] [--threads 4]

The defaults are the Shell3x3 tune of ``chip_smoke.py`` phase 3c (its
incumbent's neighbourhood and weights, as printed to six digits).  Prints,
per (N, Nu), F and the relative change of F and of its parts (j21, j22,
Jnu) under the one-ulp move; a change far above 1e-15 means the objective
itself, not the hardware that evaluates it, sets how closely two correct
evaluations agree.  Runs on the CPU in about a minute.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from mpc_tuning_tpu_torch.cases import shell3x3
from mpc_tuning_tpu_torch.tuning.api import build_problem
from mpc_tuning_tpu_torch.tuning.objectives import vns_objective_batch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", nargs="+", default=["15,9", "15,7", "11,9"])
    ap.add_argument("--delta", nargs=3, type=float,
                    default=[2.365784, 0.36274, 1.289007])
    ap.add_argument("--lam", nargs=3, type=float,
                    default=[0.048031, 0.089506, 0.11518])
    ap.add_argument("--qp-iters", type=int, default=15)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    pairs = [tuple(int(v) for v in p.split(",")) for p in args.pairs]
    p, _ = build_problem(shell3x3.make_case(), dtype=torch.float64,
                         qp_iters=args.qp_iters, device="cpu")
    p.qp_method = p.vns_qp_method = "pdip_ws_lanes"
    delta, lam = np.array(args.delta), np.array(args.lam)
    k = len(pairs)
    # each pair twice: at the weights, and at the weights one ulp up
    N = np.array([n for n, _ in pairs] * 2)
    Nu = np.array([m for _, m in pairs] * 2)
    D = np.vstack([np.tile(delta, (k, 1)),
                   np.tile(np.nextafter(delta, np.inf), (k, 1))])
    Lm = np.vstack([np.tile(lam, (k, 1)),
                    np.tile(np.nextafter(lam, np.inf), (k, 1))])
    F, parts = vns_objective_batch(p, N, Nu, D, Lm, return_parts=True)
    for i, (n, m) in enumerate(pairs):
        rel = lambda x: abs(x[k + i] - x[i]) / max(abs(x[i]), 1e-300)
        print(f"(N, Nu) = ({n}, {m}) qp_iters {args.qp_iters}: F "
              f"{F[i]:.12g}, one ulp up {F[k + i]:.12g}, relative change "
              f"{rel(F):.3e} (j21 {rel(parts['j21']):.3e}, j22 "
              f"{rel(parts['j22']):.3e}, Jnu {rel(parts['Jnu']):.3e})",
              flush=True)


if __name__ == "__main__":
    main()
