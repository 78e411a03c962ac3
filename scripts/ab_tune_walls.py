"""Time the PyTorch port's tunes of ``chip_smoke.py`` phases 3, 3b, 3d and
3k for one source tree, to compare two trees on the same card, or to take
each tune's wall alone on the card and host.

    python scripts/ab_tune_walls.py ROOT [--unpadded] [--nmpc]

ROOT is a checkout of the repo (for example a ``git archive`` of the parent
commit unpacked into a gitignored directory); its ``mpc_tuning_tpu_torch``
is imported.  It runs, as ``chip_smoke.py`` does, the Wood-Berry tune
(float32, popsize 8, 4 generations, 2 alternations, qp_iters 15, seed 0;
phase 3), the Shell7x5 band tune (float64, popsize 8, 3 generations, 1
alternation, qp_iters 60; phase 3b) and the Van de Vusse NMPC tune
(float64, popsize 8, 3 generations, 1 alternation, no joint polish) with
RK4 (phase 3d) and with TR-BDF2 (phase 3k), one after another in this one
process, and prints each one's wall (host clock around the tune, ending in
a device sync), its result and its kernel launches.  ``--nmpc`` runs the
two Van de Vusse tunes only, after a short untimed one with each
integrator that builds and loads their kernels.  ``--unpadded`` runs
the eager loops at the batch's own width on the card (``card_lanes`` set
to 1, a tree that has it) to isolate the cost of their padding.  Run the
trees in turn in one call (parent, change, change, parent).  Needs one
CUDA card.
"""

import argparse
import sys
import time

ap = argparse.ArgumentParser()
ap.add_argument("root")
ap.add_argument("--unpadded", action="store_true")
ap.add_argument("--nmpc", action="store_true")
args = ap.parse_args()
sys.path.insert(0, args.root)
import numpy as np  # noqa: E402
import torch  # noqa: E402

from mpc_tuning_tpu_torch.cases import shell7x5, vandevusse, woodberry  # noqa: E402
from mpc_tuning_tpu_torch.ops import kernels as K  # noqa: E402
from mpc_tuning_tpu_torch.tuning.api import hybrid_tune, mpc_tuning  # noqa: E402

assert K.__file__.startswith(args.root), K.__file__
tag = args.root + (" unpadded" if args.unpadded else "")
if args.unpadded:
    from mpc_tuning_tpu_torch.sim import mpc_loop, nmpc_loop

    mpc_loop.card_lanes = nmpc_loop.card_lanes = lambda device: 1


def timed(name, run):
    K.reset_launches()
    t0 = time.perf_counter()
    N, Nu, F = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in K.launch_counts().items() if v}
    print(f"AB {tag}: {name} wall_s={wall:.2f} N={N} "
          f"Nu={np.asarray(Nu).tolist()} Fvns={F!r} launches={counts}",
          flush=True)


def tracking(case, dtype, qp_iters, gens, alts):
    res = mpc_tuning(case, dtype=dtype, device="cuda", qp_iters=qp_iters,
                     gam_popsize=8, gam_generations=gens,
                     max_alternations=alts, seed=0, checkpoint_dir=None,
                     verbose=False)
    return res.N, res.Nu, res.Fvns


def nmpc(integrator, short=False):
    kw = dict(nit=10, nbp=2, nbc=2) if short else {}
    case = vandevusse.make_case(integrator=integrator, **kw)
    problem = vandevusse.build_problem(case, device="cuda")
    best, _, _, Fvns, _, _ = hybrid_tune(
        problem, case.nbp, case.nbc, vandevusse.X0_WEIGHTS,
        gam_popsize=2 if short else 8, gam_generations=1 if short else 3,
        max_alternations=1, seed=0, verbose=False, joint_polish=False)
    return int(best["N"]), best["Nu"], Fvns


# the first tune builds the kernels: short tunes first, untimed
if args.nmpc:
    for integrator in ("rk4", "tr_bdf2"):
        nmpc(integrator, short=True)
else:
    mpc_tuning(woodberry.make_case(nit=40, nbp=4, nbc=2),
               dtype=torch.float32, device="cuda", qp_iters=5,
               gam_popsize=4, gam_generations=1, max_alternations=1, seed=0,
               checkpoint_dir=None, verbose=False)
    timed("3 woodberry", lambda: tracking(woodberry.make_case(),
                                          torch.float32, 15, 4, 2))
    timed("3b shell7x5", lambda: tracking(shell7x5.make_case(),
                                          torch.float64, 60, 3, 1))
timed("3d vandevusse rk4", lambda: nmpc("rk4"))
timed("3k vandevusse tr_bdf2", lambda: nmpc("tr_bdf2"))
