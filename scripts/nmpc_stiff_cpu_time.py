"""Time the plain stiff NMPC closed batch on the CPU: the Van de Vusse case
with TR-BDF2 at tests/test_torch_nmpc_stiff.py's size (nit 12, nbp/nbc
3/2, substeps 2, SQP 2, QP 10, B = 4, float64, one thread), through
``NMPCLoop.closed_batch(..., device="cpu")``.

    PYTHONPATH=. python scripts/nmpc_stiff_cpu_time.py [--reps 2]

Prints the seconds of each run.  To compare two trees on one host, run it
with each tree first on PYTHONPATH (the package it imports is the one
timed).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from mpc_tuning_tpu_torch.cases import vandevusse
from mpc_tuning_tpu_torch.sim.nmpc_loop import NMPCLoop

CASE_KW = dict(nit=12, nbp=3, nbc=2, substeps=2, sqp_iters=2, qp_iters=10,
               integrator="tr_bdf2")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    torch.set_num_threads(1)
    case = vandevusse.make_case(**CASE_KW)
    loop = NMPCLoop(spec=case.spec)
    rng = np.random.default_rng(7)
    B, nit = 4, CASE_KW["nit"]
    batch = (np.broadcast_to(case.r, (B, nit, 2)), None,
             np.array([7, 5, 3, 7]), np.array([3, 2, 2, 3]),
             rng.uniform(0.2, 2.0, (B, 2)), rng.uniform(0.05, 0.5, (B, 2)),
             nit)
    for rep in range(args.reps):
        t0 = time.perf_counter()
        loop.closed_batch(*batch, device="cpu")
        print(f"stiff plain closed batch (B={B}, nit={nit}, TR-BDF2, "
              f"float64, CPU, one thread) run {rep}: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)


if __name__ == "__main__":
    main()
