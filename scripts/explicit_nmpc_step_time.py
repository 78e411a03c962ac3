"""The explicit NMPC demo's loop on one card with nothing beside it:
``chip_smoke.py`` phase 3h's batch (three noise lanes, nit 100, substeps
6, SQP 4, QP 20, float64), its seconds, ms a step and kernel launches.

    PYTHONPATH=. python scripts/explicit_nmpc_step_time.py [--runs 2]

Phase 3h runs the same loop in a process of its own beside phases
3j-3f, so its time there is contended; this is the loop alone, after one
run that builds the kernels and warms the card.  Needs one card.
"""

from __future__ import annotations

import argparse
import subprocess

import chip_smoke as cs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=2)
    runs = ap.parse_args().runs
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cs.explicit_nmpc_card()  # build and warm-up
    for i in range(runs):
        _, _, wall, launches = cs.explicit_nmpc_card()
        print(f"run {i}: {wall:.3f} s, {wall / cs.ENMPC_NIT * 1e3:.1f} ms a "
              f"step, launches {({k: v for k, v in launches.items() if v})}",
              flush=True)


if __name__ == "__main__":
    main()
