"""The port's bench (the counterpart of the root ``bench.py``): batched
closed-loop MPC tuning sims/s on the production engine policy, run through
the port's entry points on the card, beside its other rows.

    python -m mpc_tuning_tpu_torch.bench [--batch B] [--method ENGINE]
                                         [--qp-iters N]
    mpc-tuning-bench-torch               # the same, installed
    python -m mpc_tuning_tpu_torch.bench --cpu [--tune-budget POP,GENS,ALTS]

Rows, each at ``bench.py``'s workload (its draws, from the same seeds in
the same order), each timed as ``bench.py`` times it (a warm-up, then the
median, best and samples of REPS runs, each ending in a device sync):
  * the DTC-GPC Wood-Berry loop (B 1024, nit 400, float32; eager torch);
  * the headline: Wood-Berry, B 8192, (N, Nu) drawn from [16, 64) x [2, 7)
    (bucket (64, 8)), nit 400, float32, the VNS stage's engine
    'admm_sim' (the whole-sim ADMM kernel, 40 iterations) through
    ``MPCLoop.closed_batch``;
  * the GAM stage's engine 'pdip_sim' (the whole-sim PDIP kernel, 15
    iterations), B 2048, (N, Nu) = (20, 4), bucket (32, 4);
  * the Shell7x5 band loop ('band_sim', the band kernel: LP 20 + split
    12), B 256 at the reference's tuned L, R, delta, nit 200, at float64:
    the port runs band loops at float64 only (``bench.py`` runs this row
    at float32);
  * the Van de Vusse NMPC loop (``NMPCLoop.closed_batch``: the rollout
    kernel, the SQP's dense PDIP around the SPD kernels), B 256, nit 60;
  * the wall of a Wood-Berry hybrid tune at ``bench.py``'s budget;
  * the single-QP latency: one masked PDIP solve (15 iterations, B 1),
    the median of 30 host-timed calls.

Each row is held (``run_holds``), after every row is timed: its first
HELD_LANES lanes against the plain version of the same engine on those
lanes (a lane's bits follow neither its slot nor the batch's size), at
the gates ``chip_smoke.py`` holds that path at.  A row whose hold fails,
or that raises, is an error: the bench exits non-zero, and nothing falls
back to the CPU or to a plain version.  Prints one JSON line in
``bench.py``'s form (``bench_line``); the device is the card's name and
power limit as nvidia-smi gives them.  A row's ``launches`` are one run's
(its warm-up's).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

__all__ = ["main", "flops_per_sim_pdip", "flops_per_sim_admm", "time_reps",
           "wb_draws", "band_draws", "vdv_draws", "dtc_signals",
           "dtc_row", "wb_row", "band_row", "vdv_row", "tune_row",
           "qp_p50_row", "hold_tracking", "hold_band", "hold_vdv",
           "hold_dtc", "hold_tune", "hold_qp", "run_holds", "run_rows",
           "bench_line", "card_line", "HoldFailed"]

# bench.py's depths: the tracking rows', the Shell7x5 and Van de Vusse
# cases' own; no row runs deeper than NIT (the tests cut it)
NIT = 400
BAND_NIT, VDV_NIT = 200, 60
REPS = 5  # timed runs a row after its warm-up, as bench.py's _time_reps
HELD_LANES = 8
# the gates of chip_smoke.py's holds of these paths (phases 2a, 3, 3g)
F64_SIM_GATE = 1e-9      # max |dY|, |dU| kernel vs plain, float64
F32_SIM_GATE = 1e-3      # max |dY|, |dU|, float32
# float32 PDIP over random candidates: U within F32_SIM_GATE on the median
# lane, and within two move limits (2 x dumax = 0.1) on every lane
F32_PDIP_U_CAP = 0.1
DTC_F32_GATE = 1e-5      # DTC-GPC float32 against float64
LOOP_GATE = 1e-2         # tuned closed loop y: float32 card vs float64 CPU
# The Van de Vusse loop at float32 against the plain loop on the CPU
# following its U, in the controller's scaled units (U / sf_u, Y / sf_y):
# Y at every step, U at the steps of VDV_HOLD_WINDOWS (as chip_smoke.py
# phase 3d holds the float64 loop): twice what two correct float32 loops
# differ by, 5.521e-05 (the weights one ulp up against one ulp down; the
# followed U one ulp apart 4.404e-05), rounded up to two digits
# (scripts/nmpc_spread_torch.py --bench --dtype float32, on the CPU;
# PERF.md §6).
VDV_F32_GATE = 1.2e-4
VDV_HOLD_WINDOWS = ((1, 12), (38, 47))
# peak float32 rate of one H100 SXM outside the tensor cores (NVIDIA data
# sheet; TF32 is off by the precision pin): est_mfu_pct's denominator
PEAK_FP32_FLOPS = 67e12
# bench.py's batches on the accelerator and on the CPU
CARD_SIZES = dict(wb=8192, dtc=1024, gam=2048, band=256, vdv=256)
CPU_SIZES = dict(wb=64, dtc=8, gam=8, band=2, vdv=2)
# the headline's engines: the tracking engines whose plain version is the
# whole-sim plain loop (the whole-sim kernels and the lane-major per-step
# engines)
HEAD_ENGINES = ("admm_sim", "pdip_sim", "pdip_ws_fused", "pdip_ws_lanes",
                "admm_fused")
TUNE_BUDGET = (8, 4, 2)  # popsize, generations, alternations
QP_P50_CALLS = 30


class HoldFailed(RuntimeError):
    """A bench row's result is off its plain version's."""


# ------------------------------------------------------ FLOP models

def flops_per_sim_pdip(d, iters, nit=NIT):
    """Dominant interior-point terms per closed-loop sim (``bench.py``'s
    model)."""
    n = d["m_max"] * d["nu"] + 1
    mc_rows = 4 * d["m_max"] * d["nu"] + 1
    if d["with_y"]:
        mc_rows += 2 * d["p_max"] * d["ny"]
    per_iter = (2 * mc_rows * n * n + n ** 3 / 3 + 4 * n * n
                + 8 * mc_rows * n)
    per_step = iters * per_iter + 2 * d["p_max"] * d["ny"] * n
    return per_step * nit


def flops_per_sim_admm(d, iters, nit=NIT):
    """Dominant warm-ADMM terms per closed-loop sim (``bench.py``'s model;
    Minv is precomputed once per candidate)."""
    n = d["m_max"] * d["nu"] + 1
    mc_rows = 4 * d["m_max"] * d["nu"] + 1
    if d["with_y"]:
        mc_rows += 2 * d["p_max"] * d["ny"]
    per_iter = 4 * mc_rows * n + 2 * n * n + 8 * mc_rows
    per_step = iters * per_iter + 2 * d["p_max"] * d["ny"] * n
    return per_step * nit


# ----------------------------------------------------------- timing

def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _counted(fn):
    """(fn(), the kernel launches it made)."""
    from mpc_tuning_tpu_torch.ops import kernels as K

    before = K.launch_counts()
    out = fn()
    after = K.launch_counts()
    return out, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}


def time_reps(fn, device, reps=REPS):
    """``fn`` once (the warm-up), then ``reps`` times, each run ended by a
    device sync; returns (median s, best s, samples, the last output, the
    kernel launches of one run: the warm-up's)."""
    out, launches = _counted(fn)
    _sync(device)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        times.append(time.perf_counter() - t0)
    return (float(np.median(times)), float(np.min(times)), times, out,
            launches)


def _timed_row(fn, B, device, reps):
    """Time ``fn`` (time_reps); returns (the row's rate fields, the last
    output, one run's launches)."""
    dt, best, times, out, launches = time_reps(fn, device, reps)
    if not all(bool(torch.isfinite(x).all()) for x in out):
        raise HoldFailed("non-finite output")
    stats = dict(value=round(B / dt, 2), unit="sims/s",
                 seconds_per_batch=round(dt, 4),
                 best_sims_per_s=round(B / best, 2),
                 rep_seconds=[round(t, 4) for t in times])
    return stats, out, launches


def _lane_max(x):
    """Per-lane max |x| of a (B, nit, k) tensor, (B,)."""
    return x.abs().amax((1, 2))


# ------------------------------------------------------------- draws

def wb_draws(B, ny=2, nu=2, N_fix=None, Nu_fix=None):
    """``bench.py``'s Wood-Berry candidates (bench_wb, seed 0): (N, Nu,
    delta, lam)."""
    rng = np.random.default_rng(0)
    N = np.full(B, N_fix) if N_fix else rng.integers(16, 64, size=B)
    Nu = np.full(B, Nu_fix) if Nu_fix else rng.integers(2, 7, size=B)
    return (N, Nu, rng.uniform(0.2, 2.0, size=(B, ny)),
            rng.uniform(0.01, 0.5, size=(B, nu)))


def band_draws(B, delta_ref):
    """``bench.py``'s Shell7x5 candidates (bench_shell7x5, seed 1): (N,
    Nu, delta (the reference's tuned one), lam)."""
    rng = np.random.default_rng(1)
    N = rng.integers(8, 40, size=B)
    Nu = rng.integers(2, 5, size=B)
    delta = np.broadcast_to(delta_ref, (B, 7))
    return N, Nu, delta, rng.uniform(0.02, 2.0, size=(B, 3))


def vdv_draws(B):
    """``bench.py``'s Van de Vusse candidates (bench_vdv, seed 2): (N, Nu,
    delta, lam), the weights the reference's own tuning."""
    rng = np.random.default_rng(2)
    N = rng.integers(3, 12, size=B)
    Nu = rng.integers(2, 3, size=B)
    return (N, Nu, np.broadcast_to([0.0930, 0.1133], (B, 2)),
            np.broadcast_to([0.2460, 0.1231], (B, 2)))


def dtc_signals(nit):
    """``bench.py``'s DTC-GPC scenario (bench_dtc_gpc): r1 = 0.8 from step
    10, r2 = 0.5 from step 200, the feed disturbance -0.25 from 300."""
    r = np.zeros((nit, 2))
    r[10:, 0] = 0.8
    r[200:, 1] = 0.5
    q = np.zeros((nit, 1))
    q[300:, 0] = -0.25
    return r, q


# ------------------------------------------------------------- holds

def hold_tracking(loop, engine, iters, dtype, r_b, v, N, Nu, delta, lam,
                  nit, caps, Y, U, device):
    """The held lanes of a tracking run (their inputs, and Y, U (lanes, nit,
    k) on the CPU) of the whole-sim or lane-major per-step ``engine``
    against its plain version on ``device``, following their U step by
    step, at phase 2a's gates: float64 F64_SIM_GATE; float32 ADMM
    F32_SIM_GATE, PDIP Y at F32_SIM_GATE, U at F32_SIM_GATE on the median
    lane and F32_PDIP_U_CAP on every lane, a lane over the cap held by
    correct runs one rounding away (``tools/pdip_spread.pdip_u_hold``).
    Returns a summary; raises HoldFailed."""
    from mpc_tuning_tpu_torch.ops import kernels as K
    from mpc_tuning_tpu_torch.sim.mpc_loop import (ADMM_ENGINES,
                                                   ADMM_OVER_RELAX,
                                                   ADMM_SIGMA)

    t, lc, Hm, r_l, dims = loop.sim_inputs(r_b, v, N, Nu, delta, lam, nit,
                                           dtype, engine, device, caps)
    uf = U.permute(1, 2, 0).contiguous().to(device)
    admm = engine in ADMM_ENGINES
    # the plain version's own U, solved from the states the run solved in
    if admm:
        Yp, Up = K.closed_sim_admm_plain(t, lc, Hm, r_l, nit, iters,
                                         ADMM_SIGMA, ADMM_OVER_RELAX, dims,
                                         u_follow=uf)
    else:
        Yp, Up = K.closed_sim_pdip_plain(t, lc, Hm, r_l, nit, iters, dims,
                                         u_follow=uf)
    dy = _lane_max(Y - Yp.permute(2, 0, 1).cpu())
    du = _lane_max(U - Up.permute(2, 0, 1).cpu())
    ey, eu, med = float(dy.max()), float(du.max()), float(du.median())
    text = (f"lanes 0-{len(N) - 1} vs plain ({engine}): Y {ey:.3e} U "
            f"{eu:.3e} (median lane {med:.3e})")
    if dtype == torch.float64:
        ok = max(ey, eu) <= F64_SIM_GATE
    elif admm:
        ok = max(ey, eu) <= F32_SIM_GATE
    else:
        ok = (ey <= F32_SIM_GATE and med <= F32_SIM_GATE
              and eu <= F32_PDIP_U_CAP)
        if not ok:  # lanes over the cap: by correct runs one rounding away
            from mpc_tuning_tpu_torch.tools.pdip_spread import pdip_u_hold

            ok, held = pdip_u_hold(K.closed_sim_pdip_plain,
                                   (t, lc, Hm, r_l, nit, iters),
                                   dict(dims=dims), Y.permute(1, 2, 0).to(
                                       device), uf, F32_SIM_GATE,
                                   F32_PDIP_U_CAP)
            text += f" [{held}]"
    if not ok:
        raise HoldFailed(f"{text}: above its gate")
    return text


def hold_band(loop, r_b, v, N, Nu, delta, lam, nit, caps, Y, U, device):
    """The held lanes of a band run (their inputs, and Y, U (lanes, nit, k)
    on the CPU) against the plain band loop on ``device`` following their
    U, at the live gate of ``tools/band_spread.band_gate`` (twice what two
    correct runs differ by along the same U, measured here).  The frozen
    slack E the gate also holds is the band kernel's on those lanes alone,
    whose Y and U must be the run's bits (a lane's bits follow neither its
    slot nor B).  Lanes over a limit that the gate leaves to the LP
    certificate are decided by ``ops/band_cert.hold_relative``, its
    certificates in this process.  Returns a summary; raises
    HoldFailed."""
    import types

    from mpc_tuning_tpu_torch.ops import kernels as K
    from mpc_tuning_tpu_torch.sim.mpc_loop import BAND_LP_ITERS, BAND_S2_ITERS
    from mpc_tuning_tpu_torch.tools.band_spread import (band_gate,
                                                        band_lane_errors,
                                                        band_witness)

    t, lc, Hm, r_l, dims = loop.sim_inputs(r_b, v, N, Nu, delta, lam, nit,
                                           torch.float64, "band_sim", device,
                                           caps)
    args, kwargs = (t, lc, Hm, r_l, nit, BAND_LP_ITERS, BAND_S2_ITERS), dict(
        dims=dims)
    out_k = K.closed_sim_band(*args, **kwargs)
    lanes = (Y.permute(1, 2, 0), U.permute(1, 2, 0))
    if not all(torch.equal(a.cpu(), b) for a, b in zip(out_k, lanes)):
        raise HoldFailed(f"band lanes 0-{len(N) - 1}: the run's Y, U are "
                         "not the kernel's bits on those lanes alone")
    out_p = K.closed_sim_band_plain(*args, **kwargs, u_follow=out_k[1])
    witness = band_witness(args, kwargs, out_k[1], out_p)
    ok, text, over = band_gate(band_lane_errors(out_k, out_p), witness, caps)
    text = f"lanes 0-{len(N) - 1} vs plain (band_sim): {text}"
    if over is None:
        raise HoldFailed(f"{text}: above its gate")
    if over:
        from mpc_tuning_tpu_torch.ops import band_cert as bc

        U_k, E_k = out_k[1].cpu().numpy(), out_k[2].cpu().numpy()
        rel = {b: bc.hold_relative(
            types.SimpleNamespace(loop=loop, r=r_b[b], v=v), N[b], Nu[b],
            delta[b], lam[b], U_k[:, :, b], E_k[:, b],
            caps=(int(N[b]), int(Nu[b])), device=device) for b in over}
        text += "; lanes over it by the certificate: " + ", ".join(
            f"{b} {'ok' if h['ok'] else 'off'}" for b, h in rel.items())
        if not all(h["ok"] for h in rel.values()):
            raise HoldFailed(f"{text}: off its certificate")
    return text


def _scaled(x, sf):
    return x / torch.as_tensor(np.asarray(sf), dtype=x.dtype,
                               device=x.device)


def hold_vdv(loop, r_b, N, Nu, delta, lam, nit, dtype, caps, Y, U):
    """The held lanes of a Van de Vusse run (their inputs, and Y, U on the
    CPU) against the plain loop on the CPU following their U, in the
    controller's scaled units:
    Y at every step, U at the steps of VDV_HOLD_WINDOWS (the plain loop
    solves there only).  Gate: F64_SIM_GATE at float64, VDV_F32_GATE at
    float32.  Returns a summary; raises HoldFailed."""
    from mpc_tuning_tpu_torch.sim.nmpc_loop import nmpc_closed_core

    steps = [k for a, b in VDV_HOLD_WINDOWS for k in range(a, b + 1)
             if 1 <= k < nit]
    spec, c, Nt, Nut, (r, d, l) = loop._batch(
        None, N, Nu, caps, dtype, "cpu", np.asarray(r_b)[:, :nit], delta,
        lam)
    Yp, Up = nmpc_closed_core(spec, c, r, Nt, Nut, d, l, u_follow=U,
                              solve_steps=set(steps))
    ey = float(_scaled((Y - Yp).abs(), spec.sf_y).max())
    eu = float(_scaled((U - Up)[:, steps].abs(), spec.sf_u).max()
               if steps else 0.0)
    gate = F64_SIM_GATE if dtype == torch.float64 else VDV_F32_GATE
    text = (f"lanes 0-{len(N) - 1} vs the plain loop on the CPU, scaled: Y "
            f"{ey:.3e} (every step) U {eu:.3e} (steps "
            f"{list(VDV_HOLD_WINDOWS)}), gate {gate:g}")
    if not max(ey, eu) <= gate:
        raise HoldFailed(f"{text}: above its gate")
    return text


def hold_dtc(ctl, r_b, q_b, nit, Y, U, device):
    """The held lanes of the float32 DTC-GPC run (their signals, and Y, U
    on the CPU) against the same lanes at float64 on ``device``, at
    DTC_F32_GATE (phase 3g's gate).  Returns a summary; raises
    HoldFailed."""
    Y64, U64 = ctl.simulate_scan_batch(r_b, q_b, nit, dtype=torch.float64,
                                       device=device)
    e = max(float((Y.double() - Y64.cpu()).abs().max()),
            float((U.double() - U64.cpu()).abs().max()))
    text = (f"lanes 0-{len(r_b) - 1} float32 vs float64: {e:.3e} (gate "
            f"{DTC_F32_GATE:g})")
    if not e <= DTC_F32_GATE:
        raise HoldFailed(f"{text}: above its gate")
    return text


def hold_tune(case, res, qp_iters, device):
    """Phase 3's checks of a Wood-Berry tune: a valid result (N above every
    Nu, Nu >= 2, finite positive weights, finite objectives) and the tuned
    closed loop at the tune's dtype on ``device`` within LOOP_GATE of the
    float64 plain loop on the CPU.  Returns a summary; raises
    HoldFailed."""
    from mpc_tuning_tpu_torch.tuning.api import build_problem

    Nu = np.asarray(res.Nu)
    weights = np.concatenate([res.delta, res.lam])
    if not (res.N > Nu.max() and (Nu >= 2).all()
            and np.isfinite(weights).all() and (weights > 0).all()
            and np.isfinite([res.Fvns, res.Fgam]).all()):
        raise HoldFailed(f"invalid tuning result N={res.N} Nu={Nu} "
                         f"weights={weights}")
    ref, _ = build_problem(case, dtype=torch.float64, qp_iters=qp_iters,
                           L=res.L, R=res.R, device="cpu")
    sim = lambda p: p.loop.simulate(p.r, p.v, p.nit, res.N, int(Nu.max()),
                                    res.delta, res.lam, dtype=p.dtype,
                                    qp_iters=qp_iters, device=p.device)
    (y, u), (y64, u64) = sim(res.problem), sim(ref)
    dy = float(np.abs(y - y64).max())
    du = float(np.abs(u - u64).max())
    text = (f"valid; tuned loop at {str(res.problem.dtype)[6:]} on "
            f"{device} vs float64 on the CPU: dy {dy:.3e} du {du:.3e} (gate "
            f"dy {LOOP_GATE:g})")
    if not (np.isfinite(y).all() and np.isfinite(u).all()
            and dy <= LOOP_GATE):
        raise HoldFailed(f"{text}: above its gate")
    return text


def hold_qp(z, args, iters):
    """The single QP's solution z against the same solve through the plain
    versions (``args``, its inputs, on the CPU), at F32_SIM_GATE /
    F64_SIM_GATE on max |dz|.  Returns a summary; raises HoldFailed."""
    from mpc_tuning_tpu_torch.ops.qp import solve_qp_masked

    zp = solve_qp_masked(*args, iters=iters)[0]
    e = float((z - zp).abs().max())
    gate = F64_SIM_GATE if z.dtype == torch.float64 else F32_SIM_GATE
    text = f"z vs plain: {e:.3e} (gate {gate:g})"
    if not torch.isfinite(z).all() or e > gate:
        raise HoldFailed(f"{text}: above its gate")
    return text


# -------------------------------------------------------------- rows

def _row(metric, stats, launches, held, **fields):
    """A row: its JSON fields; "held" its hold, (function, arguments), until
    ``run_holds`` replaces it by the hold's summary (the functions and
    arguments pickle: a caller may run them in worker processes)."""
    return {"metric": metric, **stats, **fields, "launches": launches,
            "held": held}


def _lanes(x):
    """The held lanes of a (B, ...) tensor, on the CPU (a hold may run in
    another process), or of a NumPy array."""
    s = slice(0, min(HELD_LANES, len(x)))
    return x[s].cpu() if isinstance(x, torch.Tensor) else np.asarray(x)[s]


def run_holds(rows):
    """Each row's hold, one after another: "held" becomes the hold's
    summary (a row already held is left as it is).  A failed hold raises
    HoldFailed.  Returns rows."""
    for row in rows:
        if not isinstance(row["held"], str):
            fn, args = row["held"]
            row["held"] = fn(*args)
    return rows


def dtc_row(B, nit=NIT, dtype=torch.float32, device="cuda", reps=REPS):
    """DTC-GPC Wood-Berry (``bench.py``'s bench_dtc_gpc: p = m = [3, 3],
    delta = lambda = 1, condmin L and R, n_md 1) through
    ``DTCGPC.simulate_scan_batch``."""
    from mpc_tuning_tpu_torch.models import plants
    from mpc_tuning_tpu_torch.ops import condmin as cm
    from mpc_tuning_tpu_torch.sim.gpc_loop import DTCGPC

    plant = plants.wood_berry()
    L, R, _ = cm.condmin(plant.G.dcgain())
    ctl = DTCGPC.build(plant=plant.G, model=plant.G, Ts=1.0,
                       p=np.array([3, 3]), m=np.array([3, 3]),
                       delta=np.array([1.0, 1.0]), lam=np.array([1.0, 1.0]),
                       L=L, R=R, n_md=1, disturbance=plant.D)
    r, q = dtc_signals(nit)
    r_b, q_b = np.broadcast_to(r, (B, nit, 2)), np.broadcast_to(q, (B, nit, 1))
    stats, (Y, U), launches = _timed_row(
        lambda: ctl.simulate_scan_batch(r_b, q_b, nit, dtype=dtype,
                                        device=device), B, device, reps)
    held = (hold_dtc, (ctl, _lanes(r_b), _lanes(q_b), nit, _lanes(Y),
                       _lanes(U), device))
    return _row("dtc_gpc_closedloop_sims_per_s", stats, launches, held,
                nit=nit, batch=B, dtype=str(dtype)[6:],
                gpc_solves_per_s_chip=round(stats["value"] * nit))


def wb_row(problem, B, engine, iters, dtype=torch.float32, nit=NIT,
           N_fix=None, Nu_fix=None, device="cuda", reps=REPS):
    """A Wood-Berry row (``bench.py``'s bench_wb) through
    ``MPCLoop.closed_batch`` at the batch's capacity bucket.  Returns (the
    row, the capped dims)."""
    from mpc_tuning_tpu_torch.sim.mpc_loop import horizon_caps

    loop = problem.loop
    dims = loop.dims
    N, Nu, delta, lam = wb_draws(B, dims["ny"], dims["nu"], N_fix, Nu_fix)
    caps = horizon_caps(dims["p_max"], dims["m_max"], N, Nu)
    r_b = np.broadcast_to(problem.r[:nit], (B, nit, dims["ny"]))
    stats, (Y, U), launches = _timed_row(
        lambda: loop.closed_batch(r_b, problem.v, N, Nu, delta, lam, nit,
                                  dtype, iters, engine=engine, device=device,
                                  caps=caps), B, device, reps)
    held = (hold_tracking, (loop, engine, iters, dtype, _lanes(r_b),
                            problem.v, *map(_lanes, (N, Nu, delta, lam)),
                            nit, caps, _lanes(Y), _lanes(U), device))
    d = dict(loop.capped(*caps).dims)
    return _row("wb_constrained_closedloop_tuning_sims_per_s", stats,
                launches, held, qp_method=engine, qp_iters=iters, batch=B,
                caps=list(caps)), d


def band_row(B, nit=None, device="cuda", reps=REPS):
    """The Shell7x5 band row (``bench.py``'s bench_shell7x5: the reference's
    tuned L, R and delta) through ``MPCLoop.closed_batch`` with
    'band_sim', at float64."""
    from mpc_tuning_tpu_torch.cases import shell7x5
    from mpc_tuning_tpu_torch.cases.cross_eval import REF_TUNED
    from mpc_tuning_tpu_torch.sim.mpc_loop import (BAND_LP_ITERS,
                                                   BAND_S2_ITERS,
                                                   horizon_caps)
    from mpc_tuning_tpu_torch.tuning.api import build_problem

    dtype = torch.float64
    ref = REF_TUNED["Shell7x5"]
    case = shell7x5.make_case()
    problem, _ = build_problem(case, dtype=dtype, L=np.diag(ref.L),
                               R=np.diag(ref.R), device=device)
    loop = problem.loop
    nit = case.nit if nit is None else nit
    N, Nu, delta, lam = band_draws(B, ref.delta)
    caps = horizon_caps(loop.dims["p_max"], loop.dims["m_max"], N, Nu)
    r_b = np.broadcast_to(problem.r[:nit], (B, nit, 7))
    stats, (Y, U), launches = _timed_row(
        lambda: loop.closed_batch(r_b, problem.v, N, Nu, delta, lam, nit,
                                  dtype, 0, engine="band_sim", device=device,
                                  caps=caps), B, device, reps)
    held = (hold_band, (loop, _lanes(r_b), problem.v,
                        *map(_lanes, (N, Nu, delta, lam)), nit, caps,
                        _lanes(Y), _lanes(U), device))
    return _row("shell7x5_band_closedloop_sims_per_s", stats, launches, held,
                qp_method="band_sim",
                qp_iters=f"LP {BAND_LP_ITERS} + split {BAND_S2_ITERS}",
                nit=nit, batch=B, caps=list(caps), dtype="float64",
                dtype_note="band loops run at float64 only "
                           "(sim/mpc_loop.require_band_dtype); bench.py "
                           "runs this row at float32",
                qp_solves_per_s_chip=round(stats["value"] * nit))


def vdv_row(B, nit=None, dtype=torch.float32, device="cuda", reps=REPS):
    """The Van de Vusse NMPC row (``bench.py``'s bench_vdv: the case's own
    QP iterations) through ``NMPCLoop.closed_batch``."""
    from mpc_tuning_tpu_torch.cases import vandevusse
    from mpc_tuning_tpu_torch.sim.mpc_loop import horizon_caps

    case = vandevusse.make_case()
    problem = vandevusse.build_problem(case, dtype=dtype, device=device)
    loop = problem.loop
    nit = case.nit if nit is None else nit
    N, Nu, delta, lam = vdv_draws(B)
    caps = horizon_caps(case.spec.p_max, case.spec.m_max, N, Nu)
    r_b = np.broadcast_to(problem.r[:nit], (B, nit, 2))
    stats, (Y, U), launches = _timed_row(
        lambda: loop.closed_batch(r_b, problem.v, N, Nu, delta, lam, nit,
                                  dtype, caps=caps, device=device),
        B, device, reps)
    held = (hold_vdv, (loop, *map(_lanes, (r_b, N, Nu, delta, lam)), nit,
                       dtype, caps, _lanes(Y), _lanes(U)))
    return _row("vdv_nmpc_sims_per_s", stats, launches, held, nit=nit,
                batch=B, caps=list(caps), dtype=str(dtype)[6:],
                integrator=case.spec.integrator,
                nlp_solves_per_s_chip=round(stats["value"] * nit))


def tune_row(nit=NIT, budget=TUNE_BUDGET, dtype=torch.float32,
             device="cuda", qp_iters=15):
    """The wall of a Wood-Berry hybrid tune (``bench.py``'s: popsize 8, 4
    generations, at most 2 alternations, qp_iters 15, seed 0), ended by a
    device sync.  Returns (the row, the TuningResult, the case)."""
    from mpc_tuning_tpu_torch.cases import woodberry
    from mpc_tuning_tpu_torch.tuning.api import mpc_tuning

    case = woodberry.make_case(nit=nit)
    pop, gens, alts = budget

    def tune():
        res = mpc_tuning(case, dtype=dtype, qp_iters=qp_iters,
                         gam_popsize=pop, gam_generations=gens,
                         max_alternations=alts, seed=0, checkpoint_dir=None,
                         verbose=False, device=device)
        _sync(device)
        return res

    t0 = time.perf_counter()
    res, launches = _counted(tune)
    wall = time.perf_counter() - t0
    row = _row("wb_hybrid_tune_wall_s", dict(value=round(wall, 2), unit="s"),
               launches, (hold_tune, (case, res, qp_iters, device)),
               budget=f"popsize {pop} x {gens} gens x <={alts} alternations, "
                      f"qp_iters {qp_iters}, nit {nit}, nbp {case.nbp}/nbc "
                      f"{case.nbc}", dtype=str(dtype)[6:],
               N=int(res.N), Nu=np.asarray(res.Nu).tolist(),
               Fvns=round(float(res.Fvns), 4))
    return row, res, case


def qp_p50_row(problem, d, dtype=torch.float32, device="cuda", iters=15):
    """The single-QP latency (``bench.py``'s): the candidate N 20, Nu 4,
    delta 1, lambda 0.1 at the bucket ``d`` (the headline's), its step
    data at r[10] from rest, one masked PDIP solve of ``iters`` iterations
    (``ops/qp.solve_qp_masked``: the SPD factor and solve kernels), B 1:
    the median of QP_P50_CALLS host-timed calls, each ended by a device
    sync, after one warm-up.  Returns its row (the value in µs)."""
    from mpc_tuning_tpu_torch.ops.mpc_qp import (assemble_candidate,
                                                 qp_step_data)
    from mpc_tuning_tpu_torch.ops.qp import solve_qp_masked

    loop = problem.loop.capped(d["p_max"], d["m_max"])
    c = loop.arrays(dtype, device)
    kw = dict(dtype=dtype, device=device)
    idx = lambda v: torch.tensor([v], dtype=torch.long, device=device)
    cand = assemble_candidate(c, idx(20), idx(4),
                              torch.tensor([[1.0, 1.0]], **kw),
                              torch.tensor([[0.1, 0.1]], **kw),
                              d["p_max"], d["m_max"], d["ny"], d["nu"],
                              d["rho"], d["with_y"])
    nxa = c["A"].shape[0]
    f1, h1, _ = qp_step_data(c, cand, torch.zeros((1, nxa), **kw),
                             torch.zeros((1, d["nu"]), **kw),
                             torch.as_tensor(problem.r[10][None], **kw),
                             torch.zeros(problem.v.shape[1], **kw),
                             d["p_max"], d["m_max"], d["ny"], d["nu"],
                             d["with_y"])
    args = (cand["H"], f1, c["G0"], c["T2"], cand["rmask"], cand["cmask_z"],
            h1)

    def solve():
        z = solve_qp_masked(*args, iters=iters)[0]
        _sync(device)
        return z

    z, launches = _counted(solve)  # the warm-up's launches: one solve's
    lat = []
    for _ in range(QP_P50_CALLS):
        t0 = time.perf_counter()
        z = solve()
        lat.append(time.perf_counter() - t0)
    return _row("qp_p50_latency_us", dict(value=1e6 * float(np.median(lat)),
                                          unit="us"), launches,
                (hold_qp, (z.cpu(), tuple(a.cpu() for a in args), iters)))


# -------------------------------------------------------------- main

def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _args(argv):
    ap = argparse.ArgumentParser(
        prog="mpc-tuning-bench-torch",
        description="bench.py's rows on the port's hand-written kernels, on "
                    "the card; prints one JSON line")
    ap.add_argument("--batch", type=int, default=None,
                    help="the headline's batch (bench.py's BENCH_BATCH; "
                         "8192, --cpu 64); the GAM row takes at most 2048")
    ap.add_argument("--method", default="auto",
                    choices=("auto",) + HEAD_ENGINES,
                    help="the headline's engine (bench.py's BENCH_METHOD; "
                         "'auto': the VNS stage's float32 engine, admm_sim)")
    ap.add_argument("--qp-iters", type=int, default=None,
                    help="the headline's QP iterations (bench.py's "
                         "BENCH_QP_ITERS; 40 for an ADMM engine, else 15)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU through the plain versions at "
                         "bench.py's CPU batches (for the tests)")
    ap.add_argument("--tune-budget", default=None, metavar="POP,GENS,ALTS",
                    help="cut the tune row's budget (for the tests)")
    return ap.parse_args(argv)


def run_rows(device="cuda", sizes=CARD_SIZES, batch=None, method="auto",
             qp_iters=None, reps=REPS):
    """Every row but the tune's, timed one after another (reps runs each
    after its warm-up), none held yet: the DTC-GPC row first, as bench.py
    runs it, then the headline (``batch``, ``method``, ``qp_iters``:
    bench.py's BENCH_BATCH, BENCH_METHOD and BENCH_QP_ITERS), the GAM and
    band rows, the single QP and the Van de Vusse row.  Returns dict(head,
    qp, extra (the DTC-GPC, GAM, band and Van de Vusse rows), dims (the
    headline's capped dims), method, iters, nit)."""
    from mpc_tuning_tpu_torch.cases import woodberry
    from mpc_tuning_tpu_torch.sim.mpc_loop import ADMM_ENGINES
    from mpc_tuning_tpu_torch.tuning.api import build_problem
    from mpc_tuning_tpu_torch.tuning.objectives import resolve_qp_method

    nit = NIT
    if nit <= 10:
        raise ValueError(f"NIT {nit}: the single QP steps at r[10]")
    dtype = torch.float32
    B = batch or sizes["wb"]
    method = resolve_qp_method(method, stage="vns")
    iters = qp_iters or (40 if method in ADMM_ENGINES else 15)
    case = woodberry.make_case(nit=nit)
    problem, _ = build_problem(case, dtype=dtype, qp_iters=iters,
                               device=device)
    dtc = dtc_row(sizes["dtc"], nit, dtype, device, reps)
    head, d = wb_row(problem, B, method, iters, dtype, nit, device=device,
                     reps=reps)
    gam, _ = wb_row(problem, min(B, sizes["gam"]), "pdip_sim", 15, dtype,
                    nit, N_fix=20, Nu_fix=4, device=device, reps=reps)
    gam.update(metric="wb_gam_pdip_fused_sims_per_s",
               population="fixed (N,Nu)=(20,4), varying weights")
    band = band_row(sizes["band"], min(BAND_NIT, nit), device, reps)
    qp = qp_p50_row(problem, d, dtype, device)
    vdv = vdv_row(sizes["vdv"], min(VDV_NIT, nit), device=device, reps=reps)
    return dict(head=head, qp=qp, extra=[dtc, gam, band, vdv], dims=d,
                method=method, iters=iters, nit=nit)


def bench_line(rows, tune, device_name):
    """The JSON line, in ``bench.py``'s form, of ``run_rows``' rows and
    the tune row ``tune``, all held; ``device_name``: the card's line
    (``card_line``) or "cpu"."""
    from mpc_tuning_tpu_torch.sim.mpc_loop import ADMM_ENGINES

    head, qp, d = rows["head"], rows["qp"], rows["dims"]
    method, iters, nit = rows["method"], rows["iters"], rows["nit"]
    is_admm = method in ADMM_ENGINES
    sims_per_s = head["value"]
    fl = (flops_per_sim_admm(d, iters, nit) if is_admm
          else flops_per_sim_pdip(d, iters, nit))
    return {
        "metric": "wb_constrained_closedloop_tuning_sims_per_s",
        "value": sims_per_s,
        "unit": "sims/s",
        "detail": {
            "device": device_name,
            "batch": head["batch"], "nit": nit,
            "p_max": d["p_max"], "m_max": d["m_max"],
            "qp_iters": iters, "qp_method": method, "dtype": "float32",
            "matmul_precision": "highest",
            "engine_policy": "resolve_qp_method: VNS tracking at float32 = "
                             "admm_sim (the whole-sim ADMM kernel, one "
                             "launch a batch); GAM = pdip_sim (the "
                             "whole-sim PDIP kernel); band = band_sim (LP "
                             "20 + split 12, float64 only)",
            "seconds_per_batch": head["seconds_per_batch"],
            "best_sims_per_s": head["best_sims_per_s"],
            "rep_seconds": head["rep_seconds"],
            "launches": head["launches"],
            "held": head["held"],
            "qp_solves_per_s_chip": round(sims_per_s * nit, 0),
            "qp_p50_latency_us": round(qp["value"], 1),
            "qp_p50_launches": qp["launches"],
            "qp_p50_held": qp["held"],
            "est_flops_per_sim": round(fl),
            "flops_model": "admm" if is_admm else "pdip",
            # a card's share only: no CPU run is held against its peak
            "est_mfu_pct": None if device_name == "cpu" else round(
                100.0 * fl * sims_per_s / PEAK_FP32_FLOPS, 4),
            "mfu_peak_flops": PEAK_FP32_FLOPS,
            "mfu_peak": "H100 SXM float32 outside the tensor cores (TF32 "
                        "off by the precision pin)",
            "extra_metrics": rows["extra"] + [tune],
        },
    }


def main(argv=None):
    """Run every row (``run_rows``, then the tune's), hold each
    (``run_holds``) and print the JSON line (``bench_line``); returns its
    dict."""
    from mpc_tuning_tpu_torch.ops.kernels import require_device

    a = _args(argv)
    device = "cpu" if a.cpu else "cuda"
    require_device(device)
    rows = run_rows(device, CPU_SIZES if a.cpu else CARD_SIZES, a.batch,
                    a.method, a.qp_iters, REPS)
    run_holds([rows["head"], rows["qp"], *rows["extra"]])
    budget = (TUNE_BUDGET if a.tune_budget is None
              else tuple(int(v) for v in a.tune_budget.split(",")))
    tune = tune_row(NIT, budget, torch.float32, device)[0]
    run_holds([tune])
    line = bench_line(rows, tune, "cpu" if a.cpu else card_line())
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
