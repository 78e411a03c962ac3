"""The single-solve PDIP kernel pdip_fused and the lane-major solve
solve_lanes (one warp per lane / system) against the one-thread designs
they replaced (ops/csrc/reference: ``K.pdip_fused_one_thread``,
``K.solve_lanes_one_thread``), on one card.

    PYTHONPATH=. python scripts/pdip_fused_old_vs_new.py [--tune] \\
        [--nit 500,250] [--out FILE]

  * distance: on chip_smoke.py phase 2c's inputs (Shell3x3 step 85's QPs
    at caps (32, 4) and (127, 15), B = 1024 and 37, float64 and float32)
    the lane quantiles of the new kernel's distance from the old design
    (chip_smoke.qp_lane_errors: the first move du, z, lam) and the count
    of elements that differ;
  * times: pdip_fused at the record's shape (Wood-Berry step 40, B = 2048,
    caps (32, 4), (N, Nu) = (20, 4)) and at the Shell3x3 tune's GAM
    batches (B = 8: the first bucket (127, 2), N 127, Nu 2, and the
    tuned incumbent's, (8, 7) in bucket (8, 8)), float32, 15 iterations;
    solve_lanes at f32 B = 1024 n = 17 and at the f64 re-score's shapes
    (B = 30, n = 25 and B = 45, n = 46); old, new, new, old in turns,
    each turn CUDA-event ms per call (20 calls after a warm-up) and device
    ms per call (chip_smoke.device_ms), with the bound chip_smoke.py
    computes;
  * with --tune: chip_smoke.py phase 3c's Shell3x3 tune at each of
    ``--nit`` through each design of pdip_fused in turn (the one-thread
    design routed in as the GAM engine's QP; old, new, new, old), its
    result, wall and pdip_fused launches.
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
from mpc_tuning_tpu_torch.tools.band_spread import lane_quantiles
from mpc_tuning_tpu_torch.tuning import api
from mpc_tuning_tpu_torch.tuning.api import build_problem


def distance(s3):
    rows = []
    for dtype, caps, B in itertools.product(
            (torch.float64, torch.float32), ((32, 4), (127, 15)), (1024, 37)):
        args, _, _, _, dims = cs.step_qp_args(s3, caps, B, dtype,
                                              "pdip_ws_fused", caps[0])
        a, b = K.pdip_fused_one_thread(*args), K.pdip_fused(*args)
        torch.cuda.synchronize()
        err = cs.qp_lane_errors("pdip_fused", args, b, a, dims["nu"])
        rows.append(dict(dtype=str(dtype)[6:], caps=caps, B=B,
                         elements=sum(x.numel() for x in a),
                         differ=sum(int((x != y).sum()) for x, y in zip(a, b)),
                         **{k: [float(q) for q in lane_quantiles(v)]
                            for k, v in err.items()}))
        print(json.dumps(rows[-1]), flush=True)
    return rows


def turns(new, old):
    out = {"old": [], "new": []}
    for side in ("old", "new", "new", "old"):
        fn = old if side == "old" else new
        out[side].append((cs.timed(fn, 20)[0], cs.device_ms(fn)))
    return out


def pdip_times(wb, s3):
    rows = []
    shapes = [("woodberry", wb, (32, 4), 2048, 40, 2, 20, 4),
              ("shell3x3", s3, (127, 2), 8, cs.STEP_TAKE, 127, 127, 2),
              ("shell3x3", s3, (8, 8), 8, cs.STEP_TAKE, 8, 8, 7)]
    for case, problem, caps, B, take, seed, N, Nu in shapes:
        args, N_b, Nu_b, t, dims = cs.step_qp_args(
            problem, caps, B, torch.float32, "pdip_ws_fused", seed,
            take=take, N=N, Nu=Nu)
        out = K.pdip_fused(*args)
        bound, by = cs.bound_ms(
            cs.nbytes(cs.qp_reads("pdip_fused", args), out),
            cs.sim_flops("closed_sim_pdip", t, dims, 1, 15, N_b, Nu_b,
                         loop=False), torch.float32)
        rows.append(dict(kernel="pdip_fused", case=case, caps=caps, B=B,
                         n=dims["n"], mc=dims["mc"],
                         **turns(lambda: K.pdip_fused(*args),
                                 lambda: K.pdip_fused_one_thread(*args)),
                         bound_ms=bound, bound_by=by))
        print(json.dumps(rows[-1]), flush=True)
    return rows


def solve_times():
    rows = []
    for dtype, B, n in ((torch.float32, 1024, 17), (torch.float64, 30, 25),
                        (torch.float64, 45, 46)):
        M, rhs = cs.spd_batch(B, n, dtype, seed=0)
        L = K.factor_lanes_plain(M.permute(1, 2, 0).contiguous()).contiguous()
        r = rhs.T.contiguous()
        tri = n * (n + 1) // 2
        bound, by = cs.bound_ms(B * (tri + 2 * n) * M.element_size(),
                                B * 2 * n * n, dtype)
        rows.append(dict(kernel="solve_lanes", dtype=str(dtype)[6:], B=B,
                         n=n, **turns(lambda: K.solve_lanes(L, r),
                                      lambda: K.solve_lanes_one_thread(L, r)),
                         bound_ms=bound, bound_by=by))
        print(json.dumps(rows[-1]), flush=True)
    return rows


def tune(kernel, nit):
    """Phase 3c's Shell3x3 tune at ``nit`` with ``kernel`` as the GAM
    engine's QP."""
    case = shell3x3.make_case(nit=nit)
    problem, _ = api.build_problem(case, dtype=torch.float32, qp_iters=15,
                                   device="cuda")
    problem.qp_method, problem.vns_qp_method = "pdip_ws_fused", "admm_fused"
    problem.admm_iters = 40
    x0 = np.concatenate([case.ov_weight0, case.mvrate_weight0])
    calls = [0]

    def counted(*a):
        calls[0] += 1
        return kernel(*a)

    saved = mpc_loop.pdip_fused
    mpc_loop.pdip_fused = counted
    try:
        t0 = time.perf_counter()
        best, delta, lam, Fvns, Fgam, _ = api.hybrid_tune(
            problem, case.nbp, case.nbc, x0, gam_popsize=8,
            gam_generations=3, max_alternations=1, seed=0, verbose=False,
            joint_polish=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        mpc_loop.pdip_fused = saved
    return dict(nit=nit, N=int(best["N"]),
                Nu=np.asarray(best["Nu"]).tolist(),
                delta=np.asarray(delta).tolist(), lam=np.asarray(lam).tolist(),
                Fvns=float(Fvns), Fgam=float(Fgam), wall_s=wall,
                pdip_fused_launches=calls[0])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tune", action="store_true")
    ap.add_argument("--nit", default="500,250")
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
    res = dict(card=card, distance=distance(s3),
               times=pdip_times(wb, s3) + solve_times())
    if args.tune:
        res["tune"] = []
        kernels = {"old": K.pdip_fused_one_thread, "new": K.pdip_fused}
        for nit in map(int, args.nit.split(",")):
            for name in ("old", "new", "new", "old"):
                res["tune"].append(dict(design=name,
                                        **tune(kernels[name], nit)))
                print(f"tune: {json.dumps(res['tune'][-1])}", flush=True)
    if args.out:
        args.out.write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
