"""Where the Wood-Berry tune's time goes on the card: the tune of
``chip_smoke.py`` phase 3 (float32, popsize 8, 4 generations, 2
alternations, qp_iters 15, seed 0), once plain for its wall and launch
counts, then once under torch.profiler (CUDA activity only) for the device
time of every kernel it ran.

    PYTHONPATH=. python scripts/wb_tune_profile_torch.py [--top 12]

Prints the card, the tune's wall (the kernels built first) and launches,
the profiled run's wall, its device busy time and idle share (of either
wall), the device time by group (the whole-sim kernels, the SPD factor
and solve kernels, and every other kernel: the open leg's eager PyTorch
ops) and the ``--top`` kernels by device time.  Needs one card (about two
minutes).
"""

from __future__ import annotations

import argparse
import collections
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from mpc_tuning_tpu_torch.cases import woodberry
from mpc_tuning_tpu_torch.ops import _build
from mpc_tuning_tpu_torch.ops import kernels as K
from mpc_tuning_tpu_torch.tuning.api import mpc_tuning

# kernel-name fragments of the port's kernels, by group
GROUPS = (("closed_sim_admm", "closed_sim_admm_kernel"),
          ("closed_sim_pdip", "closed_sim_pdip_kernel"),
          ("spd_factor", "spd_factor_kernel"),
          ("spd_factor_solve", "spd_factor_solve_kernel"))


def tune():
    t0 = time.perf_counter()
    res = mpc_tuning(woodberry.make_case(), dtype=torch.float32,
                     device="cuda", qp_iters=15, gam_popsize=8,
                     gam_generations=4, max_alternations=2, seed=0,
                     checkpoint_dir=None, verbose=False)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _build.library()  # the build is set-up, not the tune's
    K.reset_launches()
    res, wall = tune()
    print(f"tune: N={res.N} Nu={np.asarray(res.Nu).tolist()} "
          f"Fvns={res.Fvns:.6g} wall {wall:.2f} s, launches "
          f"{ {k: v for k, v in K.launch_counts().items() if v} }",
          flush=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, pwall = tune()
    by_name = collections.Counter()
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            by_name[e.key] += us
    busy = sum(by_name.values()) / 1e6
    groups = collections.Counter()
    for name, us in by_name.items():
        g = next((g for g, frag in GROUPS if frag in name), "other")
        groups[g] += us / 1e6
    print(f"profiled tune: wall {pwall:.2f} s, device busy {busy:.3f} s, "
          f"idle share {1 - busy / pwall:.3f} (of the plain run's wall "
          f"{1 - busy / wall:.3f}); device s by group "
          + ", ".join(f"{g} {s:.3f}" for g, s in groups.most_common()),
          flush=True)
    for name, us in by_name.most_common(args.top):
        print(f"  {us / 1e6:9.4f} s  {name[:110]}", flush=True)


if __name__ == "__main__":
    main()
