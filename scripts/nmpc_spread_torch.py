"""How far two correct NMPC closed loops of the Van de Vusse case can
differ (float64, or float32 with ``--dtype``), beside how far the card's
loop is from the plain one.  The full case (substeps 10, SQP 4, QP 25)
on seeded candidates; every pair follows one U
(``nmpc_closed_core(..., u_follow=, solve_steps=)``) and solves its own
control at the window steps only.

    PYTHONPATH=. python scripts/nmpc_spread_torch.py [--B 8] [--caps 31 15]
        [--nit 60] [--windows 1-12 38-47] [--seed 0] [--threads 4] [--card]
        [--integrator rk4|tr_bdf2] [--vns-last [N NU DELTA1 DELTA2 LAM1
        LAM2]] [--bench] [--dtype float64|float32]

The case integrates with ``--integrator`` (``make_case``'s; phase 3d's
tune runs RK4, phase 3k's TR-BDF2).  The candidates: B seeded ones
spanning the bucket ``--caps`` with the case's setpoints, or
(``--vns-last``) the last batch of a Van de Vusse tune of ``chip_smoke.py``:
the order-3 VNS neighbourhood of its result (by default phase 3d's, N 31,
Nu [2, 2], at its weights, printed to six digits; else the six numbers
given, Nu one value for both inputs), two selector lanes per candidate,
each with the case setpoints of one output only (B = 36 at N 31, Nu 2),
or (``--bench``) the first B lanes of the Van de Vusse row of
``mpc_tuning_tpu_torch/bench.py`` (``bench.vdv_draws``, at their bucket
(16, 2)).  ``--dtype``: the loops' precision (float64 by default; the
bench row runs at float32).

On the CPU (default): the plain loop, run once solving every step, then in
pairs following that run's U with their inputs one ulp apart: the followed
U one ulp up vs down, and the weights delta, lambda one ulp up vs down
(about eight minutes).  ``--card`` (needs one GPU): the loop on the card
(the kernels) runs free; then the plain loop follows its U on the CPU and
again on the card (the plain versions on CUDA tensors: other arithmetic,
cuSOLVER and cuBLAS in place of LAPACK and the CPU's BLAS).  The plain
loop on the card against the one on the CPU is the witness; the kernels'
loop against the plain one on the CPU is what ``chip_smoke.py`` phase 3d
reads (about five minutes at B = 36).

Prints, per pair, the largest |dU| and |dY|, raw and in the controller's
scaled units (U / sf_u, Y / sf_y), U over the window steps and Y over every
step: the witnesses that the closed-loop gate of ``chip_smoke.py``
(phases 2d and 3d, F64_SIM_GATE in scaled units) is set against.  The
defaults are the bucket and windows of phase 3d.
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from mpc_tuning_tpu_torch.cases import vandevusse
from mpc_tuning_tpu_torch.models.ode import nmpc_rollout_plain
from mpc_tuning_tpu_torch.ops import kernels as K
from mpc_tuning_tpu_torch.ops import qp
from mpc_tuning_tpu_torch.sim import nmpc_loop
from mpc_tuning_tpu_torch.sim.nmpc_loop import nmpc_closed_core
from mpc_tuning_tpu_torch.tuning.vns import (_neighborhood, bits_to_int,
                                             int_to_bits)


def windows(spec: list[str]) -> list[int]:
    steps = []
    for w in spec:
        a, b = (int(v) for v in w.split("-"))
        steps += range(a, b + 1)
    return steps


@contextlib.contextmanager
def plain_on_card():
    """The NMPC loop through the plain versions, whatever the device."""
    saved = nmpc_loop.nmpc_rollout, qp.spd_factor, qp.spd_factor_solve
    nmpc_loop.nmpc_rollout = nmpc_rollout_plain
    qp.spd_factor, qp.spd_factor_solve = (K.spd_factor_plain,
                                          K.spd_factor_solve_plain)
    try:
        yield
    finally:
        nmpc_loop.nmpc_rollout, qp.spd_factor, qp.spd_factor_solve = saved


PHASE_3D = (31, 2, 0.412407, 0.162317, 0.08433, 0.656057)


def vns_last_batch(case, nit, result=PHASE_3D):
    """(N, Nu, (r, delta, lam)) of the lanes of the order-3 VNS
    neighbourhood of a tune's result (N, Nu, delta1, delta2, lam1, lam2),
    as ``vns_objective_batch`` lays them out for a nonlinear square
    case."""
    N0, Nu0, d1, d2, l1, l2 = result
    x2 = np.stack([int_to_bits(int(Nu0), case.nbc)] * 2)
    cands = _neighborhood(int_to_bits(int(N0), case.nbp), x2, 3)
    Ns = np.array([bits_to_int(a) for a, _ in cands])
    Nus = np.array([max(bits_to_int(row) for row in b) for _, b in cands])
    sel = np.zeros((2, nit, 2))
    for i in range(2):
        sel[i, :, i] = case.r[:nit, i]
    B = 2 * len(cands)
    r = np.broadcast_to(sel[None], (len(cands), 2, nit, 2)).reshape(B, nit, 2)
    d = np.broadcast_to([d1, d2], (B, 2))
    l = np.broadcast_to([l1, l2], (B, 2))
    return np.repeat(Ns, 2), np.repeat(Nus, 2), (r, d, l)


def report(name, spec, steps, wins, nit, a, b, seconds):
    (Ya, Ua), (Yb, Ub) = ((Y.cpu(), U.cpu()) for Y, U in (a, b))
    sfu = torch.as_tensor(np.asarray(spec.sf_u), dtype=Ua.dtype)
    sfy = torch.as_tensor(np.asarray(spec.sf_y), dtype=Ua.dtype)
    dU = (Ua - Ub)[:, steps].abs()
    dY = (Ya - Yb).abs()
    per = ", ".join(
        f"steps {w} {float(((Ua - Ub)[:, ks].abs() / sfu).max()):.3e}"
        for w in wins for ks in [[k for k in windows([w]) if 1 <= k < nit]])
    print(f"{name} ({seconds:.1f} s): scaled U {float((dU / sfu).max()):.3e}"
          f" Y {float((dY / sfy).max()):.3e}; raw U {float(dU.max()):.3e} Y "
          f"{float(dY.max()):.3e}; scaled U by window: {per}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--B", type=int, default=8)
    ap.add_argument("--caps", type=int, nargs=2, default=[31, 15])
    ap.add_argument("--nit", type=int, default=60)
    ap.add_argument("--windows", nargs="+", default=["1-12", "38-47"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--card", action="store_true")
    ap.add_argument("--integrator", default="rk4",
                    choices=["rk4", "tr_bdf2"])
    ap.add_argument("--vns-last", nargs="*", type=float, default=None,
                    metavar="N NU DELTA1 DELTA2 LAM1 LAM2")
    ap.add_argument("--bench", action="store_true")
    ap.add_argument("--dtype", default="float64",
                    choices=["float64", "float32"])
    args = ap.parse_args()
    dtype = getattr(torch, args.dtype)
    if args.vns_last not in (None, []) and len(args.vns_last) != 6:
        ap.error("--vns-last takes no value or six")
    torch.set_num_threads(args.threads)
    case = vandevusse.make_case(integrator=args.integrator)
    problem = vandevusse.build_problem(case, device="cpu")
    rng = np.random.default_rng(args.seed)
    (p_cap, m_cap), nit = args.caps, args.nit
    if args.vns_last is not None:
        N, Nu, vals = vns_last_batch(case, nit, args.vns_last or PHASE_3D)
        p_cap, m_cap = int(N.max()), int(Nu.max())
    elif args.bench:
        from mpc_tuning_tpu_torch.bench import vdv_draws
        from mpc_tuning_tpu_torch.sim.mpc_loop import horizon_caps

        N, Nu, d, l = vdv_draws(args.B)
        p_cap, m_cap = horizon_caps(case.spec.p_max, case.spec.m_max, N, Nu)
        vals = (np.broadcast_to(case.r[:nit], (args.B, nit, 2)), d, l)
    else:
        N = rng.integers(m_cap + 1, p_cap + 1, size=args.B)
        Nu = rng.integers(2, m_cap + 1, size=args.B)
        N[0], Nu[0] = p_cap, m_cap
        vals = (np.broadcast_to(case.r[:nit], (args.B, nit, 2)),
                rng.uniform(0.05, 2.0, (args.B, 2)),
                rng.uniform(0.05, 0.5, (args.B, 2)))
    B = len(N)
    batch = lambda dev: problem.loop._batch(
        problem.v, N, Nu, (p_cap, m_cap), dtype, dev, *vals)
    spec, c, Nt, Nut, (r, d, l) = batch("cpu")
    steps = [k for k in windows(args.windows) if 1 <= k < nit]
    which = ("the last batch" if args.vns_last is not None
             else "the bench row" if args.bench else f"seed={args.seed}")
    head = (f"VdV NMPC {args.dtype}, B={B} caps=({p_cap},{m_cap}) nit={nit} "
            f"substeps={spec.substeps} sqp={spec.sqp_iters} "
            f"qp={spec.qp_iters} "
            f"integrator={spec.integrator} {which}"
            f"; U solved at steps "
            f"{args.windows}")
    follow = lambda cc, rr, NN, NNu, dd, ll, uf: nmpc_closed_core(
        spec, cc, rr, NN, NNu, dd, ll, u_follow=uf, solve_steps=set(steps))

    if args.card:
        _, cg, Ng, Nug, (rg, dg, lg) = batch("cuda")
        t0 = time.perf_counter()
        kern = nmpc_closed_core(spec, cg, rg, Ng, Nug, dg, lg)
        torch.cuda.synchronize()
        print(f"{head}; the loop on the card (kernels) "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        Uk = kern[1]
        t0 = time.perf_counter()
        cpu = follow(c, r, Nt, Nut, d, l, Uk.cpu())
        t_cpu = time.perf_counter() - t0
        t0 = time.perf_counter()
        with plain_on_card():
            card = follow(cg, rg, Ng, Nug, dg, lg, Uk)
            torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        report("witness: plain loop on the card vs on the CPU", spec, steps,
               args.windows, nit, card, cpu, t_card)
        report("reading: the card's loop (kernels) vs the plain loop on the "
               "CPU", spec, steps, args.windows, nit, kern, cpu, t_cpu)
        return

    t0 = time.perf_counter()
    _, U = nmpc_closed_core(spec, c, r, Nt, Nut, d, l)
    print(f"{head}; the plain loop on the CPU solving every step "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    inf = torch.tensor(float("inf"), dtype=U.dtype)
    up = lambda x, s: torch.nextafter(x, s * inf)
    pairs = {"followed U": lambda s: (up(U, s), d, l),
             "weights": lambda s: (U, up(d, s), up(l, s))}
    for name, inputs in pairs.items():
        t0 = time.perf_counter()
        a, b = (follow(c, r, Nt, Nut, dd, ll, uf)
                for uf, dd, ll in (inputs(1), inputs(-1)))
        report(f"{name} one ulp up vs down", spec, steps, args.windows, nit,
               a, b, time.perf_counter() - t0)


if __name__ == "__main__":
    main()
