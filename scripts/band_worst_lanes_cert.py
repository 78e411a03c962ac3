"""The band kernel's worst lanes against the plain version, certified step
by step: ``chip_smoke.py`` phase 2b's inputs (Shell7x5, f64, B = 256, nit
200, the seeded candidates of ``tools/band_spread.band_inputs``) at the
buckets ``--caps``; per bucket the lanes with the largest per-lane
statistics of ``band_lane_errors`` (u, e; the plain version following the
kernel's U) and, for each, the per-step LP certificate of the kernel's own
run of that lane (``ops/band_cert.hold``: slack at the LP minimum on every
step, first move at the certified one where du is well posed).

    PYTHONPATH=.:scripts python scripts/band_worst_lanes_cert.py \\
        [--caps 32,4 127,15 127,2] [--lanes 2] [--out FILE]

Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess

import numpy as np
import torch

from mpc_tuning_tpu_torch.cases import shell7x5
from mpc_tuning_tpu_torch.ops import band_cert
from mpc_tuning_tpu_torch.ops import kernels as K
from mpc_tuning_tpu_torch.tools.band_spread import (band_candidates,
                                                    band_inputs,
                                                    band_lane_errors)
from mpc_tuning_tpu_torch.tuning.api import build_problem


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--caps", nargs="+", default=["32,4", "127,15", "127,2"])
    ap.add_argument("--lanes", type=int, default=2)
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    problem, _ = build_problem(shell7x5.make_case(), device="cuda")
    rows = []
    with band_cert.certify_pool(min(8, os.cpu_count() or 1)) as pool:
        for spec in args.caps:
            caps = tuple(int(v) for v in spec.split(","))
            (t, lc, Hp, r_l, dims), N, Nu = band_inputs(
                problem, caps, 256, 200, torch.float64, caps[0])
            a = (t, lc, Hp, r_l, 200, 20, 12, dims)
            out = K.closed_sim_band(*a)
            errs = band_lane_errors(out, K.closed_sim_band_plain(
                *a, u_follow=out[1]))
            lam_b = band_candidates(caps, 256, caps[0])[2]
            picked = []
            for stat in ("u", "e"):
                for i in torch.argsort(errs[stat], descending=True)[
                        :args.lanes].tolist():
                    if i not in picked:
                        picked.append(i)
            U, E = out[1].cpu().numpy(), out[2].cpu().numpy()
            for i in picked:
                h = band_cert.hold(problem, N[i], Nu[i], np.zeros(7), lam_b[i],
                                   U[:, :, i], E[:, i],
                                   caps=(int(N[i]), int(Nu[i])), pool=pool)
                rows.append(dict(caps=caps, lane=i, N=int(N[i]),
                                 Nu=int(Nu[i]),
                                 u=float(errs["u"][i]), e=float(errs["e"][i]),
                                 cert=h))
                print(json.dumps(rows[-1]), flush=True)
    if args.out:
        args.out.write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
