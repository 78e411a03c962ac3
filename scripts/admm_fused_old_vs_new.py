"""The single-solve ADMM kernel admm_fused (ops/csrc/qp_fused.cu, one warp
per lane) against the one-thread-per-lane design it replaced
(ops/csrc/reference/admm_fused_one_thread.cu, ``K.admm_fused_one_thread``),
on one card.

    PYTHONPATH=. python scripts/admm_fused_old_vs_new.py [--tune] \\
        [--out FILE]

  * bits: on chip_smoke.py phase 2c's inputs (Shell3x3 step 85's QPs at
    caps (32, 4) and (127, 15), B = 1024 and 37, float64 and float32) the
    count of elements of the new state (x, zc, y) where the two differ;
  * times: at the record's shape (Wood-Berry step 40, B = 8192 (64, 8))
    and at chip_smoke.ADMM_FUSED_SHAPES, float32, 40 iterations, old,
    new, new, old in turns, each turn CUDA-event ms per call (20 calls
    after a warm-up) and device ms per call (chip_smoke.device_ms), with
    the bound chip_smoke.py computes;
  * with --tune: chip_smoke.py phase 3c's Shell3x3 tune (nit S3_NIT) through
    each design in turn (the one-thread design routed in as the engine's
    QP), its result, wall and admm_fused launches.
Prints one line per row and, with --out, writes them as JSON.  Needs one
card and nvcc.
"""

from __future__ import annotations

import argparse
import itertools
import json
import pathlib
import subprocess
import time

import numpy as np
import torch

import chip_smoke as cs
from mpc_tuning_tpu_torch.cases import shell3x3, woodberry
from mpc_tuning_tpu_torch.ops import _build
from mpc_tuning_tpu_torch.ops import kernels as K
from mpc_tuning_tpu_torch.sim import mpc_loop
from mpc_tuning_tpu_torch.tuning import api
from mpc_tuning_tpu_torch.tuning.api import build_problem


def bits(s3):
    rows = []
    for dtype, caps, B in itertools.product(
            (torch.float64, torch.float32), ((32, 4), (127, 15)), (1024, 37)):
        args = cs.step_qp_args(s3, caps, B, dtype, "admm_fused", caps[0])[0]
        a, b = K.admm_fused_one_thread(*args), K.admm_fused(*args)
        torch.cuda.synchronize()
        rows.append(dict(dtype=str(dtype)[6:], caps=caps, B=B,
                         elements=sum(x.numel() for x in a),
                         differ=sum(int((x != y).sum()) for x, y in zip(a, b))))
        print(json.dumps(rows[-1]), flush=True)
    return rows


def times(wb, s3):
    rows = []
    shapes = [("woodberry", wb, (64, 8), 8192, 40, 1)] + [
        ("shell3x3", s3, caps, B, cs.STEP_TAKE, caps[0])
        for caps, B in cs.ADMM_FUSED_SHAPES]
    for case, problem, caps, B, take, seed in shapes:
        args, N, Nu, t, dims = cs.step_qp_args(problem, caps, B,
                                               torch.float32, "admm_fused",
                                               seed, take=take)
        new = lambda: K.admm_fused(*args)
        old = lambda: K.admm_fused_one_thread(*args)
        turns = {"old": [], "new": []}
        for side in ("old", "new", "new", "old"):
            fn = old if side == "old" else new
            turns[side].append((cs.timed(fn, 20)[0], cs.device_ms(fn)))
        G = args[7]
        read = [x for x in args if isinstance(x, torch.Tensor)] + [args[6]]
        read += [G[k] for k in K._QP_CSR]
        bound, by = cs.bound_ms(
            cs.nbytes(read, args[6]),
            cs.sim_flops("closed_sim_admm", t, dims, 1, 40, N, Nu,
                         loop=False), torch.float32)
        rows.append(dict(case=case, caps=caps, B=B, n=dims["n"],
                         mc=dims["mc"], old=turns["old"], new=turns["new"],
                         bound_ms=bound, bound_by=by))
        print(json.dumps(rows[-1]), flush=True)
    return rows


def tune(kernel):
    """Phase 3c's Shell3x3 tune with ``kernel`` as the ADMM engine's QP."""
    case = shell3x3.make_case(nit=cs.S3_NIT)
    problem, _ = api.build_problem(case, dtype=torch.float32, qp_iters=15,
                                   device="cuda")
    problem.qp_method, problem.vns_qp_method = "pdip_ws_fused", "admm_fused"
    problem.admm_iters = 40
    x0 = np.concatenate([case.ov_weight0, case.mvrate_weight0])
    calls = [0]

    def counted(*a):
        calls[0] += 1
        return kernel(*a)

    saved = mpc_loop.admm_fused
    mpc_loop.admm_fused = counted
    try:
        t0 = time.perf_counter()
        best, delta, lam, Fvns, Fgam, _ = api.hybrid_tune(
            problem, case.nbp, case.nbc, x0, gam_popsize=8,
            gam_generations=3, max_alternations=1, seed=0, verbose=False,
            joint_polish=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        mpc_loop.admm_fused = saved
    return dict(N=int(best["N"]), Nu=np.asarray(best["Nu"]).tolist(),
                delta=np.asarray(delta).tolist(), lam=np.asarray(lam).tolist(),
                Fvns=float(Fvns), Fgam=float(Fgam), wall_s=wall,
                admm_fused_launches=calls[0])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tune", action="store_true")
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    _build.library()
    _build.reference_library()
    wb, _ = build_problem(woodberry.make_case(), device="cuda")
    s3, _ = build_problem(shell3x3.make_case(), device="cuda")
    res = dict(card=card, bits=bits(s3), times=times(wb, s3))
    print(f"admm_fused: {sum(r['differ'] for r in res['bits'])} of "
          f"{sum(r['elements'] for r in res['bits'])} elements differ",
          flush=True)
    if args.tune:
        res["tune"] = {}
        for name, kernel in (("old", K.admm_fused_one_thread),
                             ("new", K.admm_fused)):
            res["tune"][name] = tune(kernel)
            print(f"tune {name}: {json.dumps(res['tune'][name])}", flush=True)
    if args.out:
        args.out.write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
