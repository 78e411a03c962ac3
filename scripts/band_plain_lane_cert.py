"""The plain band loop's own run of one of ``chip_smoke.py`` phase 2b's
seeded lanes (Shell7x5, f64, nit 200, ``tools/band_spread.band_candidates``
at ``caps``, seed caps[0], lane ``lane`` of 256) on the CPU, held by the
per-step LP certificate (``ops/band_cert.hold``): whether the algorithm
itself reaches the certificate's gates on that lane.

    PYTHONPATH=. python scripts/band_plain_lane_cert.py 32,4 62

Prints one JSON line.  CPU only (about a minute a lane).
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from mpc_tuning_tpu_torch.cases import shell7x5
from mpc_tuning_tpu_torch.ops import band_cert
from mpc_tuning_tpu_torch.ops import kernels as K
from mpc_tuning_tpu_torch.tools.band_spread import band_candidates
from mpc_tuning_tpu_torch.tuning.api import build_problem


def main():
    caps = tuple(int(v) for v in sys.argv[1].split(","))
    lane = int(sys.argv[2])
    nit = 200
    problem, _ = build_problem(shell7x5.make_case(), device="cpu")
    N, Nu, lam = band_candidates(caps, 256, caps[0])
    n, m, lam = int(N[lane]), int(Nu[lane]), lam[lane]
    t, lc, Hp, r_l, dims = problem.loop.sim_inputs(
        problem.r[None, :nit], problem.v, [n], [m], np.zeros((1, 7)),
        lam[None], nit, torch.float64, "band_sim", "cpu", caps=caps)
    _, U, E = K.closed_sim_band_plain(t, lc, Hp, r_l, nit, 20, 12, dims)
    with band_cert.certify_pool(6) as pool:
        held = band_cert.hold(problem, n, m, np.zeros(7), lam,
                              U[:, :, 0].numpy(), E[:, 0].numpy(),
                              caps=(n, m), pool=pool)
    print(json.dumps(dict(caps=caps, lane=lane, N=n, Nu=m, plain=held)),
          flush=True)


if __name__ == "__main__":
    main()
