"""The band whole-sim kernel (ops/csrc/closed_sim_band.cu) of this tree,
a thread-block cluster per candidate, against a build of the
block-per-candidate design it replaced (``--old``: an ``ops/csrc`` with
that C interface, unpacked with ``git archive``), on one card.

    mkdir -p .chip_archive/old
    git archive <commit> mpc_tuning_tpu_torch/ops/csrc \\
        | tar -x -C .chip_archive/old
    PYTHONPATH=.:scripts python scripts/band_old_vs_new.py \\
        --old .chip_archive/old/mpc_tuning_tpu_torch/ops/csrc \\
        [--no-times | --no-gates] [--cpu-caps '[[127, 15]]'] [--out FILE]

The old source is built with nvcc beside the port's library (its own
shared library and C launcher, with G0's rows as CSR and per-entry term
lists, its y_hi block GbT and its global scratch ``work``).  Then, on the
Shell7x5 case at float64 (lp / s2 iterations 20 / 12, nit 200):
  * times at chip_smoke.BAND_SHAPES (the bench shape and the band
    tune's batches), old, new, new, old in turns, each turn
    CUDA-event ms per call (3 calls after a warm-up) and device
    ms per call (chip_smoke.device_ms), with the bound chip_smoke.py
    computes;
  * on chip_smoke.py phase 2b's inputs (B = 256 at each of
    tools/band_spread.BAND_CAPS), each kernel held at phase 2b's gate:
    the plain version following the kernel's U, at twice the witness
    measured along that U (tools/band_spread.band_witness / band_gate;
    the kernel's quantiles, the live limits and the frozen BAND_LIMITS
    printed side by side), each bucket's tightest lane; and, per lane,
    max |dU| and max |dE| / max(1, |E|) between the two kernels (two
    correct runs of a band loop differ where du is ill-posed, so these are
    lane quantiles, not a gate);
  * the per-step certificate of each kernel (chip_smoke.band_cert_hold:
    the reference's tuned point and two seeded lanes, and each bucket's
    tightest lane and lanes over the live limits relative to the plain
    chain).
Prints one line per row and, with --out, writes them as JSON.  Needs one
card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import time

import torch

import chip_smoke as cs
from mpc_tuning_tpu_torch.cases import shell7x5
from mpc_tuning_tpu_torch.ops import _build
from mpc_tuning_tpu_torch.ops import kernels as K
from mpc_tuning_tpu_torch.tools.band_spread import (BAND_CAPS,
                                                    band_candidates,
                                                    band_gate, band_inputs,
                                                    band_lane_errors,
                                                    band_limits,
                                                    band_witness_max,
                                                    band_witness_pairs,
                                                    lane_quantiles,
                                                    tightest_lane)
from mpc_tuning_tpu_torch.tuning.api import build_problem

# argument order and dims of the old C launcher (enum BP_* / BD_*)
OLD_TABLES = ("Cpl", "Apl", "Bplu", "C", "Mk", "A", "Bu", "SxF", "SstF",
              "ThT", "Vt")
OLD_LANES = ("q", "hbu", "su", "hbyh", "rmyh", "hbyl", "rmyl", "rmask",
             "cmask", "cmask2", "lpd", "sfy", "sfu")
OLD_PTRS = OLD_TABLES + (
    "s_ptr", "s_col", "s_val", "st_ptr", "st_row", "st_val", "e_ptr", "e_row",
    "e_coef", "GbT", "scol") + OLD_LANES + ("Hp", "r", "Y", "U", "E", "work")
OLD_DIMS = ("B", "nit", "lp_iters", "s2_iters", "ny", "nu", "nxa", "nxp",
            "pny", "n", "mc", "nmv")


def old_band_lib(so: pathlib.Path):
    """Load an old-layout band library and declare its C functions."""
    lib = ctypes.CDLL(str(so))
    vp, d = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)
    lib.mpc_closed_sim_band_work_per_lane.argtypes = [d]
    lib.mpc_closed_sim_band_work_per_lane.restype = ctypes.c_longlong
    lib.mpc_closed_sim_band.argtypes = [ctypes.POINTER(vp), d,
                                        ctypes.POINTER(ctypes.c_double), vp]
    lib.mpc_closed_sim_band.restype = ctypes.c_int
    return lib


def build_old(csrc: pathlib.Path, out: pathlib.Path | None = None):
    """nvcc the old closed_sim_band.cu into its own library."""
    so = out or csrc / "libold_closed_sim_band.so"
    subprocess.run([_build._nvcc(), *_build._NVCC_FLAGS, "-shared", "-o",
                    str(so), str(csrc / "closed_sim_band.cu")], check=True)
    return old_band_lib(so)


def old_band(lib, tables, lc, Hp_t, r_l, nit, lp_iters, s2_iters, dims):
    """The old launcher's call (its wrapper's arithmetic); (Y, U, E)."""
    from mpc_tuning_tpu_torch.ops.qp import (WS_EPS, pdip_constants,
                                             split_margins)

    t = tables
    ny, nu, n, mc, m_max = (dims[k] for k in ("ny", "nu", "n", "mc", "m_max"))
    B = r_l.shape[2]
    pny = t["SxF"].shape[0]
    nmv = 4 * m_max * nu
    G0 = t["G0"]
    Gs = G0.clone()
    Gs[nmv:nmv + 2 * pny] = 0.0
    sparse = dict(zip(("s_ptr", "s_col", "s_val", "st_ptr", "st_row",
                       "st_val", "e_ptr", "e_row", "e_coef"),
                      K._csr(Gs) + K._csr(Gs.T.contiguous())
                      + K._entry_terms(Gs)))
    vals = dict(B=B, nit=nit, lp_iters=lp_iters, s2_iters=s2_iters, ny=ny,
                nu=nu, nxa=t["A"].shape[0], nxp=t["Apl"].shape[0], pny=pny,
                n=n, mc=mc, nmv=nmv)
    dims_c = (ctypes.c_int * len(OLD_DIMS))(*[vals[k] for k in OLD_DIMS])
    kw = dict(dtype=torch.float64, device=r_l.device)
    Y = torch.empty((nit, ny, B), **kw)
    U = torch.empty((nit, nu, B), **kw)
    E = torch.empty((nit, B), **kw)
    per_lane = lib.mpc_closed_sim_band_work_per_lane(dims_c)
    bufs = dict({k: t[k] for k in OLD_TABLES}, **sparse,
                GbT=G0[nmv:nmv + pny, :-1].T.contiguous(),
                scol=G0[:, -1].contiguous(),
                Hp=Hp_t.permute(2, 0, 1).contiguous(), r=r_l, Y=Y, U=U, E=E,
                work=torch.empty((max(per_lane, 1) * B,), **kw))
    bufs.update({k: lc[k].T.contiguous() for k in OLD_LANES})
    ptrs = (ctypes.c_void_p * len(OLD_PTRS))(
        *[bufs[k].data_ptr() if bufs[k].numel() else None for k in OLD_PTRS])
    ridge, w_cap = pdip_constants(torch.float64)
    m_rel, m_abs = split_margins(torch.float64)
    scal = (ctypes.c_double * 5)(WS_EPS, ridge, w_cap, m_rel, m_abs)
    code = lib.mpc_closed_sim_band(
        ptrs, dims_c, scal,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if code:
        raise RuntimeError(f"old closed_sim_band: CUDA error {code}")
    return Y, U, E


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def times(lib, problem, reps):
    rows = []
    f64 = torch.float64
    for caps, B, seed in cs.BAND_SHAPES:
        inp, N, Nu = band_inputs(problem, caps, B, 200, f64, seed)
        t, lc, Hp, r_l, dims = inp
        args = (t, lc, Hp, r_l, 200, 20, 12, dims)
        old = lambda: old_band(lib, *args)
        new = lambda: K.closed_sim_band(*args)
        turns = {"old": [], "new": []}
        for side in ("old", "new", "new", "old"):
            fn = old if side == "old" else new
            turns[side].append((cs.timed(fn, reps)[0],
                                cs.device_ms(fn, reps=reps)))
        out = new()
        read = {k: v for k, v in t.items() if k != "T2T"}
        bound, by = cs.bound_ms(
            cs.nbytes(read, lc, Hp, r_l, out),
            cs.sim_flops("closed_sim_band", t, dims, 200, 0, N, Nu, lp=20,
                         s2=12), f64)
        rows.append(dict(B=B, caps=caps, n=dims["n"],
                         old=turns["old"], new=turns["new"], bound_ms=bound,
                         bound_by=by))
        print(json.dumps(rows[-1]), flush=True)
    return rows


def gates(lib, problem, cpu_caps=()):
    """Each kernel at phase 2b's gate, phase 2b's inputs, with the lane
    quantiles of each witness pair (and, at the buckets ``cpu_caps``, of
    the plain version on the CPU against the same on the card, printed,
    not gated); per-lane |dU| and |dE| quantiles between the kernels.
    Returns the rows and, per kernel, its buckets' tightest lanes
    (chip_smoke.band_cert_hold's ``tight``)."""
    rows, tight = [], {"old": [], "new": []}
    cpu = lambda d: {k: v.cpu() for k, v in d.items()}
    for caps in BAND_CAPS:
        inp, N, Nu = band_inputs(problem, caps, 256, 200, torch.float64,
                                 caps[0])
        t, lc, Hp, r_l, dims = inp
        args, kwargs = (t, lc, Hp, r_l, 200, 20, 12), dict(dims=dims)
        lam = band_candidates(caps, 256, caps[0])[2]
        outs = {}
        for name, fn in (("old", lambda: old_band(lib, *args, dims)),
                         ("new", lambda: K.closed_sim_band(*args, **kwargs))):
            out_k = fn()
            t0 = time.perf_counter()
            out_p = K.closed_sim_band_plain(*args, **kwargs,
                                            u_follow=out_k[1])
            pairs = band_witness_pairs(args, kwargs, out_k[1], out_p)
            plain_s = time.perf_counter() - t0
            errs = band_lane_errors(out_k, out_p)
            witness = band_witness_max(list(pairs.values()))
            ok, txt, over = band_gate(errs, witness, caps)
            if caps in cpu_caps:
                out_c = K.closed_sim_band_plain(
                    cpu(t), cpu(lc), Hp.cpu(), r_l.cpu(), 200, 20, 12,
                    dims, u_follow=out_k[1].cpu())
                pairs["plain cpu vs plain card (not in the gate)"] = \
                    band_lane_errors(out_c, [x.cpu() for x in out_p])
            b = tightest_lane(errs, witness)
            U, E = out_k[1].cpu().numpy(), out_k[2].cpu().numpy()
            for lane in [b] + [x for x in over or [] if x != b]:
                tight[name].append((caps, lane, N, Nu, lam, U[:, :, lane],
                                    E[:, lane], "over the limits"
                                    if lane in (over or []) else "tightest"))
            outs[name] = out_k
            rows.append(dict(kernel=name, caps=caps, ok=ok, over=over,
                             gate=txt,
                             plain_runs_s=plain_s,
                             pairs={p: {k: lane_quantiles(v)
                                        for k, v in e.items()}
                                    for p, e in pairs.items()},
                             limits=band_limits(witness),
                             kernel_q={k: lane_quantiles(v)
                                       for k, v in errs.items()},
                             tightest=dict(lane=b, N=int(N[b]), Nu=int(Nu[b]),
                                           u=float(errs["u"][b]),
                                           witness=float(witness["u"][b]))))
            print(json.dumps(rows[-1]), flush=True)
        a, b = outs["old"], outs["new"]
        du = (a[1] - b[1]).abs().amax((0, 1))
        de = ((a[2] - b[2]).abs() / a[2].abs().clamp_min(1.0)).amax(0)
        rows.append(dict(kernel="old vs new", caps=caps, u=lane_quantiles(du),
                         e=lane_quantiles(de),
                         identical_lanes=int(((a[1] == b[1]).all(0).all(0)
                                              & (a[2] == b[2]).all(0)).sum())))
        print(json.dumps(rows[-1]), flush=True)
    return rows, tight


def certs(lib, problem, tight):
    """The per-step certificate of each kernel (chip_smoke.band_cert_hold:
    the tuned point, the seeded lanes and the tightest lanes)."""
    rows = {}
    for name, fn in (("old", lambda *a: old_band(lib, *a)),
                     ("new", K.closed_sim_band)):
        rows[name] = cs.band_cert_hold(fn, problem, tight[name])
        print(f"cert {name}: {json.dumps(rows[name])}", flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True, type=pathlib.Path,
                    help="directory of the earlier ops/csrc sources")
    ap.add_argument("--out", type=pathlib.Path)
    ap.add_argument("--no-times", action="store_true")
    ap.add_argument("--no-gates", action="store_true",
                    help="times only (no gates, no certificates)")
    ap.add_argument("--cpu-caps", type=json.loads, default=[],
                    help="buckets with the CPU witness, e.g. '[[127, 15]]'")
    args = ap.parse_args()
    c = card()
    print(c, flush=True)
    lib = build_old(args.old)
    _build.library()
    problem, _ = build_problem(shell7x5.make_case(), device="cuda")
    res = dict(card=c)
    if not args.no_times:
        res["times"] = times(lib, problem, 3)
    if not args.no_gates:
        res["gates"], tight = gates(lib, problem,
                                    [tuple(x) for x in args.cpu_caps])
        res["cert"] = certs(lib, problem, tight)
    if args.out:
        args.out.write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
