"""Where the Shell7x5 band tune's time goes on the card: the tune of
``chip_smoke.py`` phase 3b (float64, popsize 8, 3 generations, 1
alternation, qp_iters 60, seed 0), once plain for its wall, launch counts,
the band kernel's device time by launch shape (CUDA events around each
launch, summed per (B, caps)) and its search trace (verbose), with the
per-step certificate (ops/band_cert.hold) of the closed loop its result
scores, then once under torch.profiler (CUDA activity only) for the
device time of every kernel it ran.

    PYTHONPATH=.:scripts python scripts/band_tune_profile_torch.py \\
        [--old DIR] [--top 12] [--out FILE]

With ``--old`` (an earlier ops/csrc, see scripts/band_old_vs_new.py) the
same two runs follow with that source's band kernel in place of this
tree's, on the same card: before and after.  Prints the card, per run the
tune's result, wall and launches, the band kernel's launches and ms by
shape, the profiled run's wall, device busy time and idle share (of
either wall), the device time by group (the band kernel, the SPD factor
and solve kernels, every other kernel: the open leg's eager PyTorch ops)
and the ``--top`` kernels by device time.  Needs one card (about four
minutes; fifteen with ``--old``).
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from mpc_tuning_tpu_torch.cases import shell7x5
from mpc_tuning_tpu_torch.ops import _build, band_cert
from mpc_tuning_tpu_torch.ops import kernels as K
from mpc_tuning_tpu_torch.sim import mpc_loop
from mpc_tuning_tpu_torch.tuning.api import mpc_tuning

GROUPS = (("closed_sim_band", "closed_sim_band_kernel"),
          ("spd_factor", "spd_factor_kernel"),
          ("spd_factor_solve", "spd_factor_solve_kernel"))


def tune(verbose=False):
    t0 = time.perf_counter()
    res = mpc_tuning(shell7x5.make_case(), dtype=torch.float64,
                     device="cuda", qp_iters=60, gam_popsize=8,
                     gam_generations=3, max_alternations=1, seed=0,
                     checkpoint_dir=None, verbose=verbose)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def certify_result(res, kernel):
    """The per-step certificate (ops/band_cert.hold) of the closed loop
    that the tune's result scores: its N, its largest Nu (the loop applies
    max(Nu) to every input) and weights, run by ``kernel`` (B = 1)."""
    problem, nit = res.problem, res.problem.nit
    N, Nu = int(res.N), int(np.max(res.Nu))
    lam = np.asarray(res.lam)
    r_b = np.broadcast_to(problem.r[:nit], (1, nit, problem.my))
    t, lc, Hp, r_l, dims = problem.loop.sim_inputs(
        r_b, problem.v, [N], [Nu], np.asarray(res.delta)[None], lam[None],
        nit, torch.float64, "band_sim", "cuda")
    _, U, E = kernel(t, lc, Hp, r_l, nit, 20, 12, dims)
    with band_cert.certify_pool(8) as pool:
        return band_cert.hold(problem, N, Nu, np.asarray(res.delta), lam,
                              U[:, :, 0].cpu().numpy(),
                              E[:, 0].cpu().numpy(), caps=(N, Nu), pool=pool)


def route(kernel):
    """Send the tune's band launches through ``kernel`` (closed_sim_band's
    arguments), each between two CUDA events kept by launch shape."""
    events = []

    def call(tables, lane_consts, Hp_t, r_l, nit, lp_iters, s2_iters, dims):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = kernel(tables, lane_consts, Hp_t, r_l, nit, lp_iters, s2_iters,
                     dims)
        stop.record()
        caps = (tables["SxF"].shape[0] // dims["ny"], dims["m_max"])
        events.append(((r_l.shape[2], caps), start, stop))
        return out

    mpc_loop.closed_sim_band = call
    return events


def by_shape(events):
    torch.cuda.synchronize()
    rows = collections.defaultdict(lambda: [0, 0.0])
    for key, start, stop in events:
        rows[key][0] += 1
        rows[key][1] += start.elapsed_time(stop)
    return {f"B={b} caps={c}": dict(launches=k, ms=ms, ms_per_launch=ms / k)
            for (b, c), (k, ms) in sorted(rows.items(),
                                          key=lambda kv: -kv[1][1])}


def runs(name, kernel, top):
    events = route(kernel)
    K.reset_launches()
    res, wall = tune(verbose=True)
    shapes = by_shape(events)
    band_ms = sum(r["ms"] for r in shapes.values())
    cert = certify_result(res, kernel)
    print(f"[{name}] tune: N={res.N} Nu={np.asarray(res.Nu).tolist()} "
          f"lam={np.asarray(res.lam).tolist()} Fvns={res.Fvns!r} Fgam="
          f"{res.Fgam!r} wall {wall:.2f} s; its loop (N, max Nu) against "
          f"the certificate: {json.dumps(cert)}; launches "
          f"{ {k: v for k, v in K.launch_counts().items() if v} }; band "
          f"kernel {len(events)} launches, {band_ms / 1e3:.3f} s by events: "
          + json.dumps(shapes), flush=True)
    route(kernel)
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
    for kname, us in by_name.items():
        g = next((g for g, frag in GROUPS if frag in kname), "other")
        groups[g] += us / 1e6
    print(f"[{name}] profiled tune: wall {pwall:.2f} s, device busy "
          f"{busy:.3f} s, idle share {1 - busy / pwall:.3f} (of the plain "
          f"run's wall {1 - busy / wall:.3f}); device s by group "
          + ", ".join(f"{g} {s:.3f}" for g, s in groups.most_common()),
          flush=True)
    for kname, us in by_name.most_common(top):
        print(f"  {us / 1e6:9.4f} s  {kname[:110]}", flush=True)
    return dict(N=int(res.N), Nu=np.asarray(res.Nu).tolist(),
                lam=np.asarray(res.lam).tolist(), Fvns=float(res.Fvns),
                cert=cert, wall_s=wall, band_shapes=shapes,
                band_event_s=band_ms / 1e3, profiled_wall_s=pwall,
                busy_s=busy, idle_share=1 - busy / pwall,
                groups=dict(groups))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=pathlib.Path,
                    help="directory of an earlier ops/csrc")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    _build.library()  # the build is set-up, not the tune's
    kernel = K.closed_sim_band
    res = dict(card=card, new=runs("new", kernel, args.top))
    if args.old:
        from band_old_vs_new import build_old, old_band

        lib = build_old(args.old)

        def old(*a):
            out = old_band(lib, *a)
            K.closed_sim_band.launches += 1
            return out

        res["old"] = runs("old", old, args.top)
    mpc_loop.closed_sim_band = kernel
    if args.out:
        args.out.write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
