"""Whether float32 PDIP's scatter changes the Wood-Berry tune's GAM
decisions: the GAM stage (CMA-ES on the weights, popsize 8, 4
generations) through the whole-sim PDIP kernel (``closed_sim_pdip``, the
GAM engine at both dtypes) on the card, at float32 and at float64.

    PYTHONPATH=. python scripts/gam_f32_vs_f64_torch.py [--popsize 8]
        [--generations 4] [--qp-iters 15]

The stages are the two the tune (``chip_smoke.py`` phase 3: popsize 8, 4
generations, 2 alternations, seed 0) runs: (N, Nu) = (127, 2) from the
case's starting weights with seed 0, then (7, 3), the tune's horizons,
with seed 1 from the first stage's float32 result.  Each stage runs
``tuning/gam.gam_solve`` once per dtype; every generation's candidates are
also re-scored at the other dtype, so a decision is compared on identical
inputs too.  A generation's decision is the ranking of its candidates by
the attainment factor gamma (which of them recombine, and the elite).
Prints both decision sequences per stage, whether they agree, the largest
relative difference of the per-output SSE on identical candidates, and
each run's result.  Needs one card (about a minute).
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from mpc_tuning_tpu_torch.cases import woodberry
from mpc_tuning_tpu_torch.ops import kernels as K
from mpc_tuning_tpu_torch.tuning import gam
from mpc_tuning_tpu_torch.tuning.api import build_problem
from mpc_tuning_tpu_torch.tuning.objectives import gam_sse_batch


def run(problem, other, N, Nu, x0, popsize, generations, seed):
    """gam_solve on ``problem``, each generation's candidates re-scored on
    ``other``; returns (result, [(X, F, F_other) per generation])."""
    gens = []

    def recorder(p, N_, Nu_, X):
        F = gam_sse_batch(p, N_, Nu_, X)
        gens.append((X.copy(), F, gam_sse_batch(other, N_, Nu_, X)))
        return F

    gam.gam_sse_batch = recorder
    try:
        res = gam.gam_solve(problem, N, Nu, x0, popsize=popsize,
                            generations=generations, seed=seed)
    finally:
        gam.gam_sse_batch = gam_sse_batch
    return res, gens


def ranking(problem, F):
    """Candidates by gamma, best first (failed loops as gam_solve scores
    them)."""
    F = np.where(np.isfinite(F), F, 1e30)
    w = np.asarray(problem.w, dtype=np.float64)
    return np.argsort(np.max((F - problem.goal) / w[None, :], axis=1),
                      kind="stable").tolist()


def rel(a, b) -> float:
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--popsize", type=int, default=8)
    ap.add_argument("--generations", type=int, default=4)
    ap.add_argument("--qp-iters", type=int, default=15)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    case = woodberry.make_case()
    probs = {dt: build_problem(case, dtype=dt, qp_iters=args.qp_iters,
                               device="cuda")[0]
             for dt in (torch.float32, torch.float64)}
    f32, f64 = probs[torch.float32], probs[torch.float64]
    x0 = np.concatenate([case.ov_weight0, case.mvrate_weight0])
    K.reset_launches()
    agree_all = True
    for N, Nu, seed in ((127, 2, 0), (7, 3, 1)):
        r32, g32 = run(f32, f64, N, Nu, x0, args.popsize, args.generations,
                       seed)
        r64, g64 = run(f64, f32, N, Nu, x0, args.popsize, args.generations,
                       seed)
        print(f"stage (N, Nu) = ({N}, {Nu}), seed {seed}, x0 "
              f"{np.round(x0, 6).tolist()}:", flush=True)
        for gi, ((X32, F32, F32_64), (X64, F64_, F64_32)) in enumerate(
                zip(g32, g64)):
            rk32, rk64 = ranking(f32, F32), ranking(f64, F64_)
            same_x = bool(np.array_equal(X32, X64))
            print(f"  gen {gi}: ranking f32 {rk32} f64 {rk64} (same "
                  f"candidates: {same_x}); on f32's candidates f64 ranks "
                  f"{ranking(f64, F32_64)}, max relative SSE gap "
                  f"{rel(F32, F32_64):.3e}", flush=True)
            agree_all &= rk32 == rk64 and same_x
        for tag, r in (("f32", r32), ("f64", r64)):
            print(f"  result {tag}: x {np.round(r.x, 6).tolist()} gamma "
                  f"{r.gamma:.6g} F {np.round(r.F, 6).tolist()}", flush=True)
        x0 = r32.x
    print(f"decision sequences agree: {agree_all}; launches "
          f"{ {k: v for k, v in K.launch_counts().items() if v} }",
          flush=True)


if __name__ == "__main__":
    main()
