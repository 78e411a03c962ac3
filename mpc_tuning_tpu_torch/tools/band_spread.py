"""How far two correct float64 runs of the band loop differ, and the gate
that holds a band kernel by it: ``band_witness`` measures that spread
along the trajectory of the kernel under test, in the same run, and
``band_gate`` holds the kernel at twice it.

    python3 -m mpc_tuning_tpu_torch.tools.band_spread          # one card
    python3 -m mpc_tuning_tpu_torch.tools.band_spread --cpu    # + ~9 min

Two correct runs of a band loop differ where du is ill-posed (degenerate
band steps), by an amount that depends on the trajectory: a limit fixed
from one kernel's runs holds that kernel's trajectories, not a kernel.
So the band kernel is held step by step (the plain version following the
kernel's U) at limits measured along the same U, in the same run
(``band_witness_pairs``): the plain version following U moved by one ulp
up and down (``torch.nextafter``), each step's QP solved from the same
state or from one a rounding away, and following U with its rows and
later variables in reverse order (``reordered``), the same loop summed
and factored in another order, as the plain version on the CPU is and as
the kernel's own arithmetic is.  The frozen ``BAND_LIMITS`` were built
from the same kinds of witness (the CPU run in place of the reordered
one) along one kernel's U.

The script, at each capacity bucket of ``chip_smoke.py`` phase 2b
(Shell7x5, B = 256, nit = 200, the same seeded candidates: delta 0,
lambda log-uniform in [1e-3, 3], N and Nu spanning the bucket), runs the
band kernel once and prints, over the lanes, quantiles of the per-lane
statistics of ``band_lane_errors`` for each pair of correct runs, for the
kernel against the plain version on the card, the live limits and the
frozen ``BAND_LIMITS`` beside them, and the worst lanes; with ``--cpu``
also the plain version following the kernel's U on the CPU (the same
algorithm in another summation order).  Then the float32 plain loop on
the card, running free on the same candidates, and the float64 kernel's
own loop, against the hard input bounds.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

__all__ = ["BAND_CAPS", "BAND_LIMITS", "BAND_FACTOR", "BAND_FLOORS",
           "band_candidates", "band_inputs", "band_lane_errors",
           "reordered", "band_witness_pairs", "band_witness_max",
           "band_witness",
           "band_limits", "band_gate", "tightest_lane", "ADJUDICATED_LANES",
           "lane_quantiles", "bound_excess"]

BAND_CAPS = ((32, 4), (127, 2), (127, 15))
QUANTILES = (0.5, 0.9, 0.99, 1.0)
# The band kernel against the plain version following its U, per lane
# statistic of band_lane_errors, is held at each lane QUANTILE to
# BAND_FACTOR times the witness's quantile (band_witness: per lane the
# largest of band_witness_pairs, measured along the kernel's own U in the
# same run) plus BAND_FLOORS; Y, the plant
# replayed on the kernel's U, to BAND_Y_LIMIT on every lane.  The factor
# is the one the frozen limits below were built with.  Each floor is at or
# below the smallest frozen limit of its statistic and only matters where
# the witness reads ~0 (a lane with no ill-posed step), where the kernel's
# own rounding is what the floor admits.
BAND_FACTOR = 2.0
BAND_FLOORS = dict(u=1e-7, u_step=1e-13, e=1e-11)
BAND_Y_LIMIT = 1e-8
# The frozen limits the gate held until the live witness replaced them,
# printed beside the live ones for comparison (not a gate): per bucket and
# statistic, twice the largest of three witnesses that this script printed
# along the block-per-candidate kernel's U (plain CPU vs plain card; plain
# card against itself with U one ulp up; one ulp up against one ulp down)
# on an NVIDIA H100 80GB HBM3 at 700 W, rounded up to two digits.
BAND_LIMITS = {
    (32, 4): dict(u=(1.3e-5, 3.2e-4, 5.1e-3, 7.1e-3),
                  u_step=(1.3e-13, 9.9e-11, 3.8e-9, 2.8e-7),
                  e=(1.4e-11, 1.2e-10, 8.4e-9, 5.3e-8)),
    (127, 2): dict(u=(6.8e-5, 3.5e-3, 0.12, 1.0),
                   u_step=(1.1e-12, 3.7e-9, 1.5e-7, 2.0e-7),
                   e=(4.8e-11, 1.2e-9, 1.3e-7, 4.5e-5)),
    (127, 15): dict(u=(1.1e-4, 4.8e-3, 0.41, 1.7),
                    u_step=(9.0e-10, 5.3e-8, 8.1e-7, 5.1e-6),
                    e=(4.6e-10, 1.8e-6, 1.4e-3, 0.13)),
}
# batches of fewer lanes are held on their worst lane alone
QUANTILE_LANES = 64
# A batch that misses its live limits only on this many lanes or fewer
# (about the p98 to max columns of a 256-lane batch, or a small batch's
# worst lanes), Y held, is decided lane by lane by the certificate
# relative to correct runs of the plain solve chain
# (ops/band_cert.hold_relative): two correct runs' tails scatter by
# several times at a quantile, and a lane where the kernel differs more
# than the witnesses did is a fault only if, on some step, its kernel
# ends further from the LP / QP optimum than correct chains do.
ADJUDICATED_LANES = 6


def band_candidates(caps, B, seed):
    """B seeded Shell7x5 candidates (N, Nu, lambda): lambda log-uniform in
    [1e-3, 3], N and Nu spanning the bucket ``caps`` (lane 0 at the
    bucket's corner); delta is 0 (band control)."""
    rng = np.random.default_rng(seed)
    p_cap, m_cap = caps
    N = rng.integers(m_cap + 1, p_cap + 1, size=B)
    Nu = rng.integers(1, m_cap + 1, size=B)
    N[0], Nu[0] = caps
    lam = np.exp(rng.uniform(np.log(1e-3), np.log(3.0), size=(B, 3)))
    return N, Nu, lam


def band_inputs(problem, caps, B, nit, dtype, seed, device="cuda"):
    """band_sim inputs for the B candidates of ``band_candidates``.
    Returns ((tables, lane_consts, Hp, r_l, dims), N, Nu)."""
    N, Nu, lam = band_candidates(caps, B, seed)
    r_b = np.broadcast_to(problem.r[:nit], (B, nit, 7))
    return problem.loop.sim_inputs(r_b, problem.v, N, Nu, np.zeros((B, 7)),
                                   lam, nit, dtype, "band_sim", device,
                                   caps=caps), N, Nu


def band_lane_errors(a, b):
    """Per-lane errors of the band run ``a`` = (Y, U, E) against ``b``, each
    a (B,) tensor: 'y' max |dY|; 'u' max |dU| over steps and MVs; 'u_step'
    the median over steps of each step's max |dU| (du is ill-posed on
    degenerate band steps, which are a minority of a lane's steps: a
    kernel wrong on a lane is wrong on its typical step); 'e' max over
    steps of |dE| / max(|E_b|, 1), E each step's frozen slack."""
    dy = (a[0] - b[0]).abs().amax((0, 1))
    step = (a[1] - b[1]).abs().amax(1)                      # (nit, B)
    de = ((a[2] - b[2]).abs() / b[2].abs().clamp_min(1.0)).amax(0)
    return dict(y=dy, u=step.amax(0), u_step=step.median(0).values, e=de)


def lane_quantiles(x):
    """QUANTILES of a (B,) tensor over its lanes (the last is the max)."""
    return [float(v) for v in torch.quantile(x.double().cpu(),
                                             torch.tensor(QUANTILES,
                                                          dtype=torch.float64))]


def reordered(args, kwargs):
    """The band loop's arguments (``closed_sim_band_plain``'s) with its
    rows and its later variables in reverse order: the blocks of nu input
    rows, the p blocks of ny band rows in both bands (G0, T2T, rmask, the
    rhs constants) and of the free response (SxF, SstF, ThT, q, Vt's last
    p ny rows), and the move blocks after the first (G0's and ThT's
    columns, Hp, cmask, cmask2, lpd; the first move, which the loop
    applies, and the slack stay first and last).  The same QPs and the
    same loop, with every sum over rows taken in another order and each
    step's normal matrix factored in another pivot order."""
    t, lc, Hp, r_l, *rest = args
    dims = kwargs["dims"]
    ny, nu, m_max, mc, n = (dims[k] for k in ("ny", "nu", "m_max", "mc", "n"))
    pny = t["SxF"].shape[0]
    nmv = 4 * m_max * nu
    dev = r_l.device
    ar = lambda k: torch.arange(k, device=dev)

    def blocks(count, width):
        return ar(count * width).view(count, width).flip(0).flatten()

    hz = blocks(pny // ny, ny)
    rows = torch.cat([blocks(4 * m_max, nu), nmv + hz, nmv + pny + hz,
                      ar(1) + mc - 1])
    cols = torch.cat([ar(nu), nu + blocks(m_max - 1, nu), ar(1) + n - 1])
    nv = t["Vt"].shape[0]
    vt = torch.cat([ar(nv - pny), nv - pny + hz])
    G0 = t["G0"][rows][:, cols]
    t = dict(t, G0=G0, T2T=t["T2T"][(cols[:, None] * n + cols).flatten()][
        :, rows], SxF=t["SxF"][hz], SstF=t["SstF"][hz],
             ThT=t["ThT"][cols][:, hz], Vt=t["Vt"][vt])
    lc = dict(lc, rmask=lc["rmask"][rows], q=lc["q"][hz],
              hbu=lc["hbu"][rows[:nmv]], su=lc["su"][rows[:nmv]],
              **{k: lc[k][hz] for k in ("hbyh", "rmyh", "hbyl", "rmyl")},
              **{k: lc[k][cols] for k in ("cmask", "cmask2", "lpd")})
    return (t, lc, Hp[cols][:, cols], r_l, *rest)


def band_witness_pairs(args, kwargs, U_k, exact=None):
    """Two correct runs of the band loop along the kernel's U_k, compared:
    {pair: band_lane_errors}.  The plain version
    (``closed_sim_band_plain(*args, **kwargs)``) following U_k (``exact``,
    run here unless given), following U_k moved one ulp up and one ulp
    down (each step's QP solved from the same state, or from one a
    rounding away), and following U_k with its rows and later variables
    in reverse order (``reordered``: the same loop summed and factored in
    another order, as the kernel's own arithmetic is)."""
    from mpc_tuning_tpu_torch.ops.kernels import closed_sim_band_plain

    inf = torch.tensor(float("inf"), dtype=U_k.dtype, device=U_k.device)
    run = lambda a, u: closed_sim_band_plain(*a, **kwargs, u_follow=u)
    if exact is None:
        exact = run(args, U_k)
    up, down = (run(args, torch.nextafter(U_k, s * inf)) for s in (1, -1))
    rev = run(reordered(args, kwargs), U_k)
    return {"ulp up vs down": band_lane_errors(up, down),
            "exact vs ulp up": band_lane_errors(exact, up),
            "reordered vs exact": band_lane_errors(rev, exact)}


def band_witness_max(pairs):
    """Per lane and statistic the largest of a list of band_lane_errors."""
    return {k: torch.stack([p[k].cpu() for p in pairs]).amax(0)
            for k in pairs[0]}


def band_witness(args, kwargs, U_k, exact=None):
    """What two correct runs of the band loop differ by along the kernel's
    U_k: per lane and statistic the largest of ``band_witness_pairs``."""
    return band_witness_max(
        list(band_witness_pairs(args, kwargs, U_k, exact).values()))


def _columns(lanes):
    """The lane-quantile columns a batch of ``lanes`` lanes is held at."""
    return (range(len(QUANTILES)) if lanes >= QUANTILE_LANES
            else [len(QUANTILES) - 1])


def band_limits(witness):
    """The live limits of ``band_gate`` for the witness ``band_witness``
    gave: per statistic, BAND_FACTOR times each of its lane QUANTILES plus
    the statistic's floor."""
    return {k: [BAND_FACTOR * q + floor for q in lane_quantiles(witness[k])]
            for k, floor in BAND_FLOORS.items()}


def band_gate(errs, witness, caps=None):
    """Whether band_lane_errors ``errs`` of a batch (the kernel against the
    plain version following its U) meet the live limits of ``witness``
    (``band_limits``): Y on every lane, and each statistic's lane
    quantiles (its worst lane alone below QUANTILE_LANES lanes).  The
    summary prints, per statistic, the kernel's quantiles, the live limits
    and the frozen BAND_LIMITS of the smallest bucket covering ``caps``
    (none when no bucket covers it).  Returns (ok, summary, over): where
    the limits are missed, ``over`` lists the lanes above a missed
    column's limit for the certificate to decide (ADJUDICATED_LANES at
    most), or is None where that cannot clear the batch (Y missed, or
    more lanes over); [] where the limits hold."""
    cols = _columns(errs["u"].numel())
    cover = [c for c in BAND_CAPS
             if caps is not None and c[0] >= caps[0] and c[1] >= caps[1]]
    frozen = (BAND_LIMITS[min(cover, key=lambda c: c[0] * c[1])] if cover
              else None)
    ey = float(errs["y"].max())
    ok = ey <= BAND_Y_LIMIT
    over = set()
    parts = [f"y max {ey:.3e} (limit {BAND_Y_LIMIT:g})"]
    fmt = lambda xs: "/".join(f"{xs[i]:.3g}" for i in cols)
    for k, lim in band_limits(witness).items():
        q = lane_quantiles(errs[k])
        missed = [i for i in cols if q[i] > lim[i]]
        if missed:
            ok = False
            x = errs[k].cpu()
            over.update(int(b) for b in torch.nonzero(
                x > min(lim[i] for i in missed)).flatten())
        parts.append(f"{k} kernel " + "/".join(f"{q[i]:.3e}" for i in cols)
                     + f" live limit {fmt(lim)} frozen "
                     + (fmt(frozen[k]) if frozen else "none"))
    if ok:
        return True, " ".join(parts), []
    adjudicable = ey <= BAND_Y_LIMIT and len(over) <= ADJUDICATED_LANES
    parts.append(f"lanes over: {sorted(over)}"
                 + ("" if adjudicable else " (too many, or Y: no decision "
                    "by the certificate)"))
    return False, " ".join(parts), sorted(over) if adjudicable else None


def tightest_lane(errs, witness):
    """The lane where the kernel's max |dU| is largest against its own
    witness (each over the lane's live limit, BAND_FACTOR witness +
    floor): the lane the gate holds most tightly."""
    lim = BAND_FACTOR * witness["u"].cpu() + BAND_FLOORS["u"]
    return int((errs["u"].cpu() / lim).argmax())


def bound_excess(U, problem):
    """Largest step of U (nit, nu, B) outside the hard input bounds, in the
    loop's units (0 when every step keeps them)."""
    ctl = problem.loop.ctl
    hi = torch.as_tensor(ctl.umax_s * ctl.spec.sf_u, dtype=U.dtype,
                         device=U.device)[None, :, None]
    lo = torch.as_tensor(ctl.umin_s * ctl.spec.sf_u, dtype=U.dtype,
                         device=U.device)[None, :, None]
    return float(torch.maximum(U - hi, lo - U).clamp_min(0.0).max())


def _fmt(errs):
    return " ".join(f"{k} " + "/".join(f"{v:.3e}" for v in lane_quantiles(x))
                    for k, x in errs.items())


def _worst(name, errs, others, N, Nu):
    """The lane where ``errs[name]`` is largest, with the witnesses there."""
    i = int(errs[name].argmax())
    return (f"worst {name} lane {i} (N {N[i]}, Nu {Nu[i]}): kernel "
            f"{float(errs[name][i]):.3e}, "
            + ", ".join(f"{k} {float(o[name][i]):.3e}"
                        for k, o in others.items()))


def main():
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA device", flush=True)
        sys.exit(1)
    from mpc_tuning_tpu_torch.cases import shell7x5
    from mpc_tuning_tpu_torch.ops import kernels as K
    from mpc_tuning_tpu_torch.tuning.api import build_problem

    with_cpu = "--cpu" in sys.argv[1:]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, {torch.get_num_threads()} "
          f"CPU threads; per-lane statistics, lane quantiles "
          f"{'/'.join(f'p{round(q * 100)}' for q in QUANTILES[:-1])}/max",
          flush=True)
    problem, _ = build_problem(shell7x5.make_case(), device="cuda")
    B, nit = 256, 200
    cpu = lambda d: {k: v.cpu() for k, v in d.items()}
    host = lambda out: [x.cpu() for x in out]
    for caps in BAND_CAPS:
        (t, lc, Hp, r_l, dims), N, Nu = band_inputs(
            problem, caps, B, nit, torch.float64, caps[0])
        args, kwargs = (t, lc, Hp, r_l, nit, 20, 12), dict(dims=dims)
        Uk = K.closed_sim_band(*args, **kwargs)
        out_k, Uk = host(Uk), Uk[1]
        t0 = time.perf_counter()
        out_p = K.closed_sim_band_plain(*args, **kwargs, u_follow=Uk)
        pairs = band_witness_pairs(args, kwargs, Uk, out_p)
        txt = f"plain card, four runs {time.perf_counter() - t0:.1f} s"
        out_p = host(out_p)
        if with_cpu:
            t0 = time.perf_counter()
            out_c = K.closed_sim_band_plain(cpu(t), cpu(lc), Hp.cpu(),
                                            r_l.cpu(), nit, 20, 12, dims,
                                            u_follow=Uk.cpu())
            txt += f", plain cpu {time.perf_counter() - t0:.1f} s"
            pairs["plain cpu vs plain card (not in the gate)"] = \
                band_lane_errors(out_c, out_p)
        errs = band_lane_errors(out_k, out_p)
        witness = band_witness_max(
            [v for k, v in pairs.items() if "not in the gate" not in k])
        ok, gate, _ = band_gate(errs, witness, caps)
        print(f"[{caps} f64 B={B} nit={nit}] {txt} | "
              + " | ".join(f"{k}: {_fmt(v)}" for k, v in pairs.items())
              + f" | kernel vs plain card: {_fmt(errs)} | gate "
              f"{'passes' if ok else 'FAILS'}: {gate} | "
              + " | ".join(_worst(k, errs, pairs, N, Nu)
                           for k in ("u", "u_step", "e"))
              + f" | kernel outside the input bounds by "
              f"{bound_excess(Uk, problem):.3e}, plain card (following) by "
              f"{bound_excess(out_p[1], problem):.3e}", flush=True)
        t32 = {k: v.float() for k, v in t.items()}
        lc32 = {k: v.float() for k, v in lc.items()}
        U32 = K.closed_sim_band_plain(t32, lc32, Hp.float(), r_l.float(), nit,
                                      20, 12, dims)[1]
        du32 = (U32.double() - Uk).abs().amax((0, 1))
        print(f"[{caps} f32 B={B} nit={nit}] plain card, free run: outside "
              f"the input bounds by {bound_excess(U32, problem):.3e} (max "
              f"|U| {float(U32.abs().max()):.3f}; float64 kernel "
              f"{float(Uk.abs().max()):.3f}); U vs the float64 kernel, "
              f"lane max {'/'.join(f'{v:.3e}' for v in lane_quantiles(du32))}",
              flush=True)


if __name__ == "__main__":
    main()
