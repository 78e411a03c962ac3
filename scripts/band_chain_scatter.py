"""How far correct runs of the band loop's solve chain end from the LP
optimum where the stage-0 LP does not converge, and so how many of them
the relative certificate (``ops/band_cert.hold_relative``) has to sample.

    PYTHONPATH=. python scripts/band_chain_scatter.py [--replicas 1024]

On the CPU at float64: Shell7x5 at caps (127, 15), B = 4 seeded
candidates (phase 2b's seed), nit 30.  For each lane it runs the plain
band loop on the batch, harvests and certifies each step's QP along the
run's U, and prints the run's largest slack miss (``run_steps``) beside
the two exact chains' (as harvested and reordered) and the quantiles of
``--replicas`` chains whose QPs each differ by a rounding
(``chain_steps``).  Then, from those chains, the chance that a correct
chain misses by more than twice the largest of W others, per W: the
chance that ``hold_relative`` would refuse a correct run on that lane
with W chains.  Then ``hold_relative``'s verdict on the run.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from mpc_tuning_tpu_torch.cases import shell7x5
from mpc_tuning_tpu_torch.ops import band_cert as bc
from mpc_tuning_tpu_torch.ops import kernels as K
from mpc_tuning_tpu_torch.tools import band_spread as bs
from mpc_tuning_tpu_torch.tuning.api import build_problem

CAPS, B, NIT = (127, 15), 4, 30


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--replicas", type=int, default=1024)
    ap.add_argument("--lanes", type=int, nargs="*", default=list(range(B)))
    ap.add_argument("--threads", type=int, default=4)
    a = ap.parse_args()
    torch.set_num_threads(a.threads)
    problem, _ = build_problem(shell7x5.make_case(nit=NIT), device="cpu")
    (t, lc, Hp, r_l, dims), N, Nu = bs.band_inputs(
        problem, CAPS, B, NIT, torch.float64, CAPS[0], device="cpu")
    _, U, E = K.closed_sim_band_plain(t, lc, Hp, r_l, NIT, 20, 12, dims)
    lam = bs.band_candidates(CAPS, B, CAPS[0])[2]
    U, E = U.numpy(), E.numpy()
    rng = np.random.default_rng(1)
    print(f"Shell7x5 caps {CAPS} B={B} nit={NIT}, the plain loop's run on "
          f"the batch; slack miss relative to 1 + |eps_min| (the frozen "
          f"slack less the split margin); torch {torch.__version__}, "
          f"{a.threads} threads", flush=True)
    for b in a.lanes:
        t0 = time.perf_counter()
        cand = (N[b], Nu[b], np.zeros(7), lam[b])
        caps = (int(N[b]), int(Nu[b]))
        qps, c, cand_d = bc.harvest_qps(problem, *cand, U[:, :, b], NIT, caps)
        certs = bc.certify_steps(c, cand_d, qps, U.shape[1])
        run = bc.run_steps(c, certs, U[:, :, b], E[:, b])[0]
        k = int(np.nanargmax(run))
        exact = [bc.chain_steps(*d, certs, 20, 12)["deps_rel_frozen"][:, 0]
                 for d in ((qps, c, cand_d),
                           bc._reordered(qps, c, cand_d, U.shape[1]))]
        ens = bc.chain_steps(qps, c, cand_d, certs, 20, 12,
                             a.replicas)["deps_rel_frozen"]
        worst = np.fmax.reduce(ens, axis=0)  # each rounded chain's largest
        q = np.quantile(worst, (0.5, 0.9, 0.99, 1.0))
        chance = {}
        for w in (2, 16, 64, 256):
            if w < len(worst):
                tops = np.array([worst[rng.choice(len(worst), w, False)].max()
                                 for _ in range(2000)])
                chance[w] = float(np.mean([(worst > 2 * x).mean()
                                           for x in tops]))
        out = bc.hold_relative(problem, *cand, U[:, :, b], E[:, b], caps=caps)
        print(f"lane {b} (N {N[b]}, Nu {Nu[b]}): run's largest miss "
              f"{run[k]:.3e} at step {k} (eps_min {certs[k][1]:.6g}); exact "
              f"chains there {exact[0][k]:.3e} / {exact[1][k]:.3e}; "
              f"largest of {a.replicas} rounded chains there "
              f"{np.nanmax(ens[k]):.3e}; the rounded chains' largest miss "
              f"p50/p90/p99/max "
              + "/".join(f"{v:.3e}" for v in q)
              + "; chance a correct chain misses by more than twice the "
              "largest of W others: "
              + ", ".join(f"W={w} {p:.4f}" for w, p in chance.items())
              + f" | hold_relative: {out['chains']} chains, slack step "
              f"{out['eps_step']} {out['eps_run']:.3e} (limit "
              f"{out['eps_limit']:.3e}), "
              f"{'passes' if out['ok'] else 'FAILS'} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
