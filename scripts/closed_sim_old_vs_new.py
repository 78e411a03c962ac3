"""The whole-sim kernels (ops/csrc/closed_sim.cu) against an earlier
version of that source, the one-thread-per-lane design, on one card.

    mkdir -p .chip_archive/old
    git archive <commit> mpc_tuning_tpu_torch/ops/csrc \\
        | tar -x -C .chip_archive/old
    PYTHONPATH=. python scripts/closed_sim_old_vs_new.py \\
        --old .chip_archive/old/mpc_tuning_tpu_torch/ops/csrc [--out FILE]

The old source is built with nvcc beside the port's library (its own
shared library, its C launcher with the lane-major scratch buffer `work`
and its export mpc_closed_sim_work_rows).  Then, on the Wood-Berry case:
  * bits: on chip_smoke.py phase 2a's inputs (caps (64, 8) and (127, 15),
    B = 1024, 2 and 37, nit 60, float64 and float32; ADMM 40 iterations,
    PDIP 30) the count of elements of Y and U where the two kernels
    differ, and the largest difference;
  * times: at chip_smoke.py's ADMM_SHAPES and PDIP_SHAPES (nit 400,
    float32), old, new, new, old in turns, each turn CUDA-event ms per
    call (3 calls after a warm-up) and device ms per call
    (chip_smoke.device_ms), with the bound chip_smoke.py computes and the
    launches a WB tune makes of each kernel (phase 3's counts, given by
    --launches).
Also the SPD factor kernels (spd.cu) of the two versions: the count of
elements where they differ (n 1-64, B 1 / 37 / 1024, both layouts and
dtypes).  Prints one line per row and, with --out, writes them as JSON.
Needs one card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import pathlib
import subprocess

import torch

import chip_smoke as cs
from mpc_tuning_tpu_torch.cases import woodberry
from mpc_tuning_tpu_torch.ops import _build
from mpc_tuning_tpu_torch.ops import kernels as K
from mpc_tuning_tpu_torch.tuning.api import build_problem

# argument order of the old C launcher
OLD_PTRS = K._SIM_TABLES + (
    "g_ptr", "g_col", "g_val", "gt_ptr", "gt_row", "gt_val",
    "r", "q", "hbase", "su", "rowm", "colm", "Dinv", "e", "par", "sfy", "sfu",
    "Hm", "Y", "U", "work")


def build_old(csrc: pathlib.Path, src: str):
    so = csrc / f"libold_{src}.so"
    cmd = [_build._nvcc(), *_build._NVCC_FLAGS, "-shared", "-o", str(so),
           str(csrc / f"{src}.cu")]
    subprocess.run(cmd, check=True)
    return ctypes.CDLL(str(so))


def old_sim_lib(csrc: pathlib.Path):
    lib = build_old(csrc, "closed_sim")
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.mpc_closed_sim_work_rows.argtypes = [i, d]
    lib.mpc_closed_sim_work_rows.restype = ctypes.c_longlong
    lib.mpc_closed_sim.argtypes = [i, i, ctypes.POINTER(vp), d,
                                   ctypes.POINTER(ctypes.c_double), vp]
    lib.mpc_closed_sim.restype = i
    return lib


def old_sim(lib, pdip, t, lc, Hm, r_l, nit, iters, dims, scal):
    """The old launcher's call (its wrapper's arithmetic)."""
    B = r_l.shape[2]
    nxa, nxp, pny = t["A"].shape[0], t["Apl"].shape[0], t["SxF"].shape[0]
    vals = dict(B=B, nit=nit, iters=iters, ny=dims["ny"], nu=dims["nu"],
                nxa=nxa, nxp=nxp, pny=pny, n=dims["n"], mc=dims["mc"],
                m_max=dims["m_max"])
    dims_c = (ctypes.c_int * len(K._SIM_DIMS))(*[vals[k] for k in K._SIM_DIMS])
    kw = dict(dtype=r_l.dtype, device=r_l.device)
    Y = torch.empty((nit, dims["ny"], B), **kw)
    U = torch.empty((nit, dims["nu"], B), **kw)
    work = torch.empty((lib.mpc_closed_sim_work_rows(int(pdip), dims_c) * B,),
                       **kw)
    rk, ck = ("rmask", "cmask") if pdip else ("arow", "acol")
    bufs = dict(t, **K.g_shared(t["G0"]), r=r_l, rowm=lc[rk], colm=lc[ck],
                Hm=Hm, Y=Y, U=U, work=work)
    bufs.update({k: lc[k] for k in ("q", "hbase", "su", "sfy", "sfu", "Dinv",
                                    "e", "par") if k in lc})
    ptrs = (ctypes.c_void_p * len(OLD_PTRS))(
        *[bufs[k].data_ptr() if k in bufs and bufs[k] is not None
          and bufs[k].numel() else None for k in OLD_PTRS])
    code = lib.mpc_closed_sim(int(pdip), int(r_l.dtype == torch.float64), ptrs,
                              dims_c, (ctypes.c_double * 3)(*scal),
                              ctypes.c_void_p(
                                  torch.cuda.current_stream().cuda_stream))
    if code:
        raise RuntimeError(f"old closed_sim: CUDA error {code}")
    return Y, U


def calls(lib, engine, inp, nit, iters):
    """(old, new) zero-argument calls of one engine on ``inp``."""
    from mpc_tuning_tpu_torch.ops.qp import WS_EPS, pdip_constants

    t, lc, Hm, r_l, dims = inp
    if engine == "admm_sim":
        scal = (1e-6, 1.6, 0.0)
        new = lambda: K.closed_sim_admm(t, lc, Hm, r_l, nit, iters, 1e-6, 1.6,
                                        dims)
    else:
        scal = (WS_EPS, *pdip_constants(r_l.dtype))
        new = lambda: K.closed_sim_pdip(t, lc, Hm, r_l, nit, iters, dims)
    old = lambda: old_sim(lib, engine == "pdip_sim", t, lc, Hm, r_l, nit,
                          iters, dims, scal)
    return old, new


def bits(lib, problem):
    rows = []
    for dtype, caps, (engine, iters), B in itertools.product(
            (torch.float64, torch.float32), ((64, 8), (127, 15)),
            (("admm_sim", 40), ("pdip_sim", 30)), (1024, 2, 37)):
        inp, _, _ = cs.sim_inputs(problem, caps, B, 60, dtype, engine,
                                  seed=caps[0])
        old, new = calls(lib, engine, inp, 60, iters)
        a, b = old(), new()
        torch.cuda.synchronize()
        differ = sum(int(((x != y) & ~(x.isnan() & y.isnan())).sum())
                     for x, y in zip(a, b))
        rows.append(dict(engine=engine, dtype=str(dtype)[6:], caps=caps, B=B,
                         elements=sum(x.numel() for x in a), differ=differ,
                         max_abs=max(cs.maxabs(x, y) for x, y in zip(a, b))))
        print(json.dumps(rows[-1]), flush=True)
    return rows


def factor_bits(csrc: pathlib.Path):
    """Elements where the old and the new SPD factor kernels (spd.cu, both
    layouts, both dtypes) differ, n 1-64, B 1 / 37 / 1024."""
    old = build_old(csrc, "spd")
    vp, i = ctypes.c_void_p, ctypes.c_int
    old.mpc_spd_factor.argtypes = [i, i, vp, vp, i, i, vp]
    new = _build.library()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    differ = cases = 0
    for dtype, lanes, n, B in itertools.product(
            (torch.float32, torch.float64), (0, 1), (1, 5, 17, 31, 46, 64),
            (1, 37, 1024)):
        M = cs.spd_batch(B, n, dtype)[0]
        if lanes:
            M = M.permute(1, 2, 0).contiguous()
        outs = []
        for lib in (old, new):
            L = torch.full_like(M, 7.0)
            if lib.mpc_spd_factor(int(dtype == torch.float64), lanes,
                                  M.data_ptr(), L.data_ptr(), B, n, stream):
                raise RuntimeError(f"spd_factor n={n} B={B}: launch failed")
            outs.append(L)
        torch.cuda.synchronize()
        differ += int((outs[0] != outs[1]).sum())
        cases += 1
    print(f"spd_factor old vs new: {differ} elements differ over {cases} "
          f"cases", flush=True)
    return dict(cases=cases, differ=differ)


def times(lib, problem, launches):
    rows = []
    f32 = torch.float32
    for engine, name, iters, shapes in (
            ("admm_sim", "closed_sim_admm", 40, cs.ADMM_SHAPES),
            ("pdip_sim", "closed_sim_pdip", 15, cs.PDIP_SHAPES)):
        for caps, B, seed, fixed in shapes:
            inp, N, Nu = cs.sim_inputs(problem, caps, B, 400, f32, engine,
                                       seed, **fixed)
            old, new = calls(lib, engine, inp, 400, iters)
            turns = {"old": [], "new": []}
            for side in ("old", "new", "new", "old"):
                fn = old if side == "old" else new
                turns[side].append((cs.timed(fn, 3)[0],
                                    cs.device_ms(fn, reps=3)))
            t, lc, Hm, r_l, dims = inp
            out = new()
            read = {k: v for k, v in t.items() if k != "T2T"}
            bound, by = cs.bound_ms(
                cs.nbytes(read, lc, Hm, r_l, out),
                cs.sim_flops(name, t, dims, 400, iters, N, Nu), f32)
            rows.append(dict(kernel=name, B=B, caps=caps, n=dims["n"],
                             old=turns["old"], new=turns["new"],
                             bound_ms=bound, bound_by=by,
                             tune_launches=launches.get(name)))
            print(json.dumps(rows[-1]), flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True, type=pathlib.Path,
                    help="directory of the earlier ops/csrc sources")
    ap.add_argument("--out", type=pathlib.Path)
    ap.add_argument("--launches", type=json.loads, default={},
                    help='e.g. \'{"closed_sim_admm": 252}\'')
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    lib = old_sim_lib(args.old)
    _build.library()
    problem, _ = build_problem(woodberry.make_case(), device="cuda")
    res = dict(card=card, factor=factor_bits(args.old),
               bits=bits(lib, problem),
               times=times(lib, problem, args.launches))
    admm = [r for r in res["bits"] if r["engine"] == "admm_sim"]
    print(f"ADMM: {sum(r['differ'] for r in admm)} of "
          f"{sum(r['elements'] for r in admm)} elements differ", flush=True)
    if args.out:
        args.out.write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
