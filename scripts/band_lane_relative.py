"""Hold chosen lanes of a band kernel's run by the relative certificate
(``ops/band_cert.hold_relative``), on one card.

    PYTHONPATH=. python scripts/band_lane_relative.py --caps 127,2 \\
        --lanes 93

Runs this tree's ``closed_sim_band`` on ``chip_smoke.py`` phase 2b's
inputs at one bucket (Shell7x5, B = 256, nit 200, the seeded candidates of
``tools/band_spread.band_inputs``) and holds each lane in ``--lanes`` step
by step against the certificate relative to correct plain chains on the
same QPs (the rounded chains on the card), printing the verdict: the
chains sampled, and the step where the run is nearest its slack and its
first-move limit, with its error and the limit there.  To hold another
build of the kernel (an arithmetic variant, a redesign in git history),
run it from a checkout of that build with this tree's ``ops/band_cert.py``.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from mpc_tuning_tpu_torch.cases import shell7x5
from mpc_tuning_tpu_torch.ops import band_cert as bc
from mpc_tuning_tpu_torch.ops import kernels as K
from mpc_tuning_tpu_torch.tools.band_spread import (band_candidates,
                                                    band_inputs)
from mpc_tuning_tpu_torch.tuning.api import build_problem


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--caps", required=True,
                    type=lambda s: tuple(int(x) for x in s.split(",")))
    ap.add_argument("--lanes", required=True, type=int, nargs="+")
    a = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    B, nit = 256, 200
    problem, _ = build_problem(shell7x5.make_case(), device="cuda")
    (t, lc, Hp, r_l, dims), N, Nu = band_inputs(
        problem, a.caps, B, nit, torch.float64, a.caps[0])
    _, U, E = K.closed_sim_band(t, lc, Hp, r_l, nit, 20, 12, dims)
    U, E = U.cpu().numpy(), E.cpu().numpy()
    lam = band_candidates(a.caps, B, a.caps[0])[2]
    with bc.certify_pool(8) as pool:
        for b in a.lanes:
            t0 = time.perf_counter()
            h = bc.hold_relative(problem, N[b], Nu[b], np.zeros(7), lam[b],
                                 U[:, :, b], E[:, b],
                                 caps=(int(N[b]), int(Nu[b])), pool=pool,
                                 device="cuda")
            print(f"{a.caps} lane {b} (N {N[b]}, Nu {Nu[b]}): run slack "
                  f"{h['run']['deps_rel']:.3e} du "
                  f"{h['run']['du_well_posed']:.3e}; exact chains slack "
                  f"{h['plain']['deps_rel_frozen']:.3e} / "
                  f"{h['reordered']['deps_rel_frozen']:.3e} du "
                  f"{h['plain']['du_well_posed']:.3e} / "
                  f"{h['reordered']['du_well_posed']:.3e}; {h['chains']} "
                  f"chains; nearest its limit: slack step {h['eps_step']} "
                  f"{h['eps_run']:.3e} (limit {h['eps_limit']:.3e}), du "
                  f"step {h['du_step']} {h['du_run']:.3e} (limit "
                  f"{h['du_limit']:.3e}): "
                  f"{'passes' if h['ok'] else 'FAILS'} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
