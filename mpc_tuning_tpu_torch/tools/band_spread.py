"""How far two correct float64 runs of the band loop differ: the evidence
behind ``chip_smoke.py``'s band limits, and behind band cases running at
float64 only.

    python3 -m mpc_tuning_tpu_torch.tools.band_spread          # one card
    python3 -m mpc_tuning_tpu_torch.tools.band_spread --cpu    # + ~9 min

At each capacity bucket of ``chip_smoke.py`` phase 2b (Shell7x5, B = 256,
nit = 200, the same seeded candidates: delta 0, lambda log-uniform in
[1e-3, 3], N and Nu spanning the bucket) the band kernel runs once, then
the plain version follows the kernel's U on the card, and again following
the kernel's U moved by one ulp up and down (``torch.nextafter``): each
step's QP is solved from the same state, or from one a rounding away.
With ``--cpu`` the plain version also follows the kernel's U on the CPU
(the same algorithm in another summation order).  Per bucket it prints,
over the lanes, quantiles of the per-lane statistics of
``band_lane_errors`` for each pair of correct runs (the witnesses: what two
correct runs differ by) and for the kernel against the plain version on
the card (what phase 2b holds), and the worst lanes.  Then the float32
plain loop on the card, running free on the same candidates, and the
float64 kernel's own loop, against the hard input bounds.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

__all__ = ["BAND_CAPS", "BAND_LIMITS", "band_candidates", "band_inputs",
           "band_lane_errors",
           "band_gate", "lane_quantiles", "bound_excess"]

BAND_CAPS = ((32, 4), (127, 2), (127, 15))
QUANTILES = (0.5, 0.9, 0.99, 1.0)
# The band kernel against the plain version on the card, both float64 and
# the plain version following the kernel's U: per bucket and per-lane
# statistic of band_lane_errors, limits on its lane QUANTILES.  Each is
# twice the largest of the three witnesses this script printed (plain CPU
# vs plain card; plain card against itself with U one ulp up; one ulp up
# against one ulp down) on an NVIDIA H100 80GB HBM3 at 700 W, rounded up
# to two digits (PERF.md); the witnesses scatter among themselves by up
# to ~3x at a quantile.  Y, the plant replayed on the kernel's U, is held
# to BAND_Y_LIMIT on every lane.
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
BAND_Y_LIMIT = 1e-8
# batches of fewer lanes are held on their worst lane alone
QUANTILE_LANES = 64


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


def band_gate(errs, caps):
    """Whether band_lane_errors ``errs`` of a batch at bucket ``caps`` meet
    the limits of the smallest BAND_LIMITS bucket covering it: Y on every
    lane, and each statistic's lane quantiles (its worst lane alone below
    QUANTILE_LANES lanes).  Returns (ok, summary)."""
    cover = [c for c in BAND_CAPS if c[0] >= caps[0] and c[1] >= caps[1]]
    if not cover:
        raise ValueError(f"no band limits cover the bucket {caps}")
    lim = BAND_LIMITS[min(cover, key=lambda c: c[0] * c[1])]
    cols = (range(len(QUANTILES)) if errs["u"].numel() >= QUANTILE_LANES
            else [len(QUANTILES) - 1])
    ey = float(errs["y"].max())
    ok = ey <= BAND_Y_LIMIT
    parts = [f"y max {ey:.3e}"]
    for k, limits in lim.items():
        q = lane_quantiles(errs[k])
        ok &= all(q[i] <= limits[i] for i in cols)
        parts.append(f"{k} " + "/".join(f"{q[i]:.3e}" for i in cols) + " ("
                     + "/".join(f"{limits[i]:g}" for i in cols) + ")")
    return ok, " ".join(parts)


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
    inf = torch.tensor(float("inf"), dtype=torch.float64, device="cuda")
    for caps in BAND_CAPS:
        (t, lc, Hp, r_l, dims), N, Nu = band_inputs(
            problem, caps, B, nit, torch.float64, caps[0])
        args = (t, lc, Hp, r_l, nit, 20, 12, dims)
        Uk = K.closed_sim_band(*args)
        out_k, Uk = host(Uk), Uk[1]
        t0 = time.perf_counter()
        out_p = host(K.closed_sim_band_plain(*args, u_follow=Uk))
        card_s = time.perf_counter() - t0
        up = host(K.closed_sim_band_plain(
            *args, u_follow=torch.nextafter(Uk, inf)))
        dn = host(K.closed_sim_band_plain(
            *args, u_follow=torch.nextafter(Uk, -inf)))
        pairs = {"plain card vs plain card, U one ulp up":
                 band_lane_errors(up, out_p),
                 "plain card, U one ulp up vs one ulp down":
                 band_lane_errors(up, dn)}
        txt = f"plain card {card_s:.1f} s"
        if with_cpu:
            t0 = time.perf_counter()
            out_c = K.closed_sim_band_plain(cpu(t), cpu(lc), Hp.cpu(),
                                            r_l.cpu(), nit, 20, 12, dims,
                                            u_follow=Uk.cpu())
            txt += f", plain cpu {time.perf_counter() - t0:.1f} s"
            pairs["plain cpu vs plain card"] = band_lane_errors(out_c, out_p)
            pairs["kernel vs plain cpu"] = band_lane_errors(out_k, out_c)
        errs = band_lane_errors(out_k, out_p)
        witnesses = {k: v for k, v in pairs.items() if "kernel" not in k}
        print(f"[{caps} f64 B={B} nit={nit}] {txt} | "
              + " | ".join(f"{k}: {_fmt(v)}" for k, v in pairs.items())
              + f" | kernel vs plain card: {_fmt(errs)} | "
              + " | ".join(_worst(k, errs, witnesses, N, Nu)
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
