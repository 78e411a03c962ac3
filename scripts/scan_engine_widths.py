"""Does a lane's closed loop on the card depend on the batch's width?

    PYTHONPATH=. python scripts/scan_engine_widths.py     # one card

Per-step engine (and, for comparison, the whole-sim kernels): the lanes
5.. of a seeded Shell3x3 batch (B = 37, nit 40, caps (32, 4), float64)
run again in batches of 1, 2, 3 and 13; prints whether their U are the
same bits and max |dU|.  Then single products at those widths: a shared
matrix times the lanes (torch.matmul) and a batched matrix-vector
product (torch.bmm)."""

import numpy as np
import torch

from mpc_tuning_tpu_torch.cases import shell3x3
from mpc_tuning_tpu_torch.sim.mpc_loop import STEP_ENGINES
from mpc_tuning_tpu_torch.tuning.api import build_problem

F64 = torch.float64
NIT, B, WIDTHS = 40, 37, (1, 2, 3, 13)


def main():
    problem, _ = build_problem(shell3x3.make_case(nit=NIT), device="cuda")
    rng = np.random.default_rng(3)
    cand = (rng.integers(5, 33, size=B), rng.integers(1, 5, size=B),
            rng.uniform(0.2, 2.0, (B, 3)), rng.uniform(0.01, 0.5, (B, 3)))
    r_b = np.broadcast_to(problem.r[:NIT], (B, NIT, 3))

    def run(engine, idx):
        iters = 40 if "admm" in engine else 15
        return problem.loop.closed_batch(
            r_b[idx], problem.v, *(x[idx] for x in cand), NIT, F64, iters,
            engine=engine, device="cuda", caps=(32, 4))

    for engine in STEP_ENGINES + ("pdip_sim", "admm_sim"):
        _, U = run(engine, np.arange(B))
        row = []
        for w in WIDTHS:
            _, Us = run(engine, np.arange(5, 5 + w))
            ref = U[5:5 + w]
            row.append(f"B={w}: eq={torch.equal(Us, ref)} "
                       f"dU={float((Us - ref).abs().max()):.2e}")
        print(engine, " | ".join(row), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    for m, k in ((46, 381), (3, 10), (381, 20)):
        A = torch.randn((m, k), generator=g, device="cuda", dtype=F64)
        X = torch.randn((k, B), generator=g, device="cuda", dtype=F64)
        full = A @ X
        print("matmul", m, k, [bool(torch.equal(
            A @ X[:, 5:5 + w].contiguous(), full[:, 5:5 + w]))
            for w in WIDTHS])
    H = torch.randn((B, 25, 25), generator=g, device="cuda", dtype=F64)
    v = torch.randn((B, 25, 1), generator=g, device="cuda", dtype=F64)
    full = torch.bmm(H, v)
    print("bmm", [bool(torch.equal(torch.bmm(H[5:5 + w], v[5:5 + w]),
                                   full[5:5 + w])) for w in WIDTHS])


if __name__ == "__main__":
    main()
