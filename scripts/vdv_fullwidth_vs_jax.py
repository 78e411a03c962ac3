"""The Van de Vusse NMPC tune's decision at full width, the PyTorch port
against the JAX package, both at float64 on the CPU.  Like the tests, this
check imports both packages.

    PYTHONPATH=. python scripts/vdv_fullwidth_vs_jax.py \
        [--N 31 --Nu 2 2 --delta 0.412407 0.162317 --lam 0.08433 0.656057]
        [--tune] [--threads 4]

Default: the VNS cost F of the incumbent (N, Nu) and of its whole order
1-3 VNS neighbourhood (``tuning/vns._neighborhood``), at the given weights,
through each package's ``vns_objective_batch`` on the full case (nit 60,
nbp/nbc 5/4, substeps 10, SQP 4, QP 25; one batch each).  Prints, per
candidate, both F values and their relative difference, and each package's
argmin over the valid candidates.  The defaults are the incumbent and
weights of ``chip_smoke.py`` phase 3d (printed to six digits).  The port's
plain loop takes ~5 minutes, the JAX one ~1.

``--tune`` runs the JAX package's full-width hybrid tune instead, with
phase 3d's budget (popsize 8, 3 generations, 1 alternation, seed 0, no
joint polish), for comparison with the port's tune on the card.
"""

from __future__ import annotations

import argparse
import time

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import torch  # noqa: E402

from mpc_tuning_tpu.cases import vandevusse as vdv_jax  # noqa: E402
from mpc_tuning_tpu.tuning import api as api_jax  # noqa: E402
from mpc_tuning_tpu.tuning.objectives import (  # noqa: E402
    vns_objective_batch as vns_jax)
from mpc_tuning_tpu_torch.cases import vandevusse as vdv_torch  # noqa: E402
from mpc_tuning_tpu_torch.tuning.objectives import (  # noqa: E402
    vns_objective_batch as vns_torch)
from mpc_tuning_tpu_torch.tuning.vns import (  # noqa: E402
    _neighborhood, bits_to_int, int_to_bits)


def neighbourhood(N, Nu, nbp, nbc):
    """The incumbent and its order 1-3 neighbours: (N, max Nu, valid) as
    vns_search decodes and screens them (dmin = 0 for this case)."""
    x1 = int_to_bits(N, nbp)
    x2 = np.stack([int_to_bits(v, nbc) for v in Nu])
    cands = [(x1, x2)]
    for order in (1, 2, 3):
        cands += _neighborhood(x1, x2, order)
    Ns, Nus, valid = [], [], []
    for c1, c2 in cands:
        n = bits_to_int(c1)
        nu = np.array([bits_to_int(row) for row in c2])
        Ns.append(n)
        Nus.append(int(nu.max()))
        valid.append(n > nu.max() and n != 0 and (nu > 1).all())
    return np.array(Ns), np.array(Nus), np.array(valid)


def compare_neighbourhood(args):
    case_t, case_j = vdv_torch.make_case(), vdv_jax.make_case()
    pt = vdv_torch.build_problem(case_t, device="cpu")
    pj = vdv_jax.build_problem(case_j)
    Ns, Nus, valid = neighbourhood(args.N, args.Nu, case_t.nbp, case_t.nbc)
    d, l = np.array(args.delta), np.array(args.lam)
    t0 = time.perf_counter()
    Fj = np.asarray(vns_jax(pj, Ns, Nus, d, l))
    tj = time.perf_counter() - t0
    t0 = time.perf_counter()
    Ft = np.asarray(vns_torch(pt, Ns, Nus, d, l))
    tt = time.perf_counter() - t0
    print(f"VdV full width (nit {case_t.nit}, p_max {case_t.spec.p_max}, "
          f"m_max {case_t.spec.m_max}, substeps {case_t.spec.substeps}) "
          f"f64 CPU, delta {d.tolist()} lam {l.tolist()}: {len(Ns)} "
          f"candidates (the incumbent first); JAX {tj:.1f} s, port "
          f"{tt:.1f} s")
    print(f"{'N':>3} {'Nu':>3} {'valid':>5} {'F jax':>22} {'F port':>22} "
          f"{'rel diff':>9}")
    for n, nu, ok, fj, ft in zip(Ns, Nus, valid, Fj, Ft):
        rel = abs(ft - fj) / abs(fj)
        print(f"{n:3d} {nu:3d} {str(bool(ok)):>5} {fj:22.15g} {ft:22.15g} "
              f"{rel:9.2e}")
    rel = np.abs(Ft - Fj) / np.abs(Fj)
    mask = lambda F: np.where(valid, F, np.inf)
    aj, at = int(np.argmin(mask(Fj))), int(np.argmin(mask(Ft)))
    print(f"max rel diff {rel.max():.3e}; argmin JAX (N {Ns[aj]}, Nu "
          f"{Nus[aj]}) F {Fj[aj]:.15g}; argmin port (N {Ns[at]}, Nu "
          f"{Nus[at]}) F {Ft[at]:.15g}; incumbent lowest: JAX {aj == 0}, "
          f"port {at == 0}")


def jax_tune():
    case = vdv_jax.make_case()
    problem = vdv_jax.build_problem(case)
    t0 = time.perf_counter()
    best, d, l, Fv, Fg, _ = api_jax.hybrid_tune(
        problem, case.nbp, case.nbc, np.array([1.0, 1.0, 0.1, 0.1]),
        gam_popsize=8, gam_generations=3, max_alternations=1, seed=0,
        verbose=True, joint_polish=False)
    print(f"JAX full-width tune (CPU f64, popsize 8, 3 generations, 1 "
          f"alternation, seed 0, no joint polish): N={best['N']} "
          f"Nu={np.asarray(best['Nu']).tolist()} "
          f"delta={np.round(d, 6).tolist()} lam={np.round(l, 6).tolist()} "
          f"Fvns={Fv:.6g} Fgam={Fg:.6g} in {time.perf_counter() - t0:.1f} s")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--N", type=int, default=31)
    ap.add_argument("--Nu", type=int, nargs=2, default=[2, 2])
    ap.add_argument("--delta", type=float, nargs=2,
                    default=[0.412407, 0.162317])
    ap.add_argument("--lam", type=float, nargs=2, default=[0.08433, 0.656057])
    ap.add_argument("--tune", action="store_true")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    if args.tune:
        jax_tune()
    else:
        compare_neighbourhood(args)


if __name__ == "__main__":
    main()
