"""Per-step certificate of the band (y-constrained) QP, and the harvest of
the QPs a band loop solved along a given input trajectory.

Band cases run every output weight at zero, so each step's QP objective
is a move suppression of lambda^2 scale plus rho_eps eps^2 (rho_eps >=
1e4): its optimal ECR slack eps equals the minimum of the linear program
min eps over the same constraints.  ``certify`` computes that minimum
exactly with scipy's HiGHS ``linprog`` and the certified move by the
slack-frozen QP re-solve, with ``du_sens``, the move's change when the
frozen slack moves by 1e-6 relative: on the degenerate band steps
(near-parallel band rows) du_sens is ~1e4-1e6 and du is ill-posed at any
fixed tolerance, so du is held only where du_sens is small; elsewhere the
slack and the objective are.

``harvest_qps`` teacher-forces an input trajectory (for instance a
kernel's U) through a host replica of the closed loop's step recursion,
so every harvested QP is exactly the one that loop solved, with no drift.
``engine_step_errors`` replays the '+lp20+split12' chain of the plain band
loop (``ops/kernels.closed_sim_band_plain``) over harvested QPs and scores
it against the certificate.  Host float64 (numpy, scipy and the plain
PyTorch QP solvers on the CPU).

The same certificate as the JAX package's ``ops/band_cert.py``; the
reference semantics are the per-step QP of the MATLAB toolbox's
closedloop_toolbox.m:50 at the Shell7x5.m:100-189 band, ECR and
ScaleFactor settings.
"""

from __future__ import annotations

import numpy as np
import torch

from mpc_tuning_tpu_torch.ops.mpc_qp import assemble_candidate, qp_step_data
from mpc_tuning_tpu_torch.ops.qp import (pdip_lanes, seed_slack,
                                         solve_qp_masked, split_margins,
                                         split_stage2)

__all__ = ["harvest_qps", "certify", "certify_pool", "certify_steps",
           "engine_step_errors",
           "kernel_slack", "hold", "hold_certified", "HOLD_EPS_REL", "HOLD_DU", "DU_SENS_BAR",
           "F64"]

# The per-step gates of a band loop's run (the JAX oracle's,
# tests/test_band_oracle.py): its slack within HOLD_EPS_REL of the LP
# minimum, relative to 1 + |eps_min|, on every step; its first move within
# HOLD_DU of the certified move where du is well posed (du_sens <
# DU_SENS_BAR).
HOLD_EPS_REL = 1e-6
HOLD_DU = 1e-3
DU_SENS_BAR = 1e-4

F64 = torch.float64


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def harvest_qps(problem, N, Nu, delta, lam, u_traj, nit, caps=None):
    """The QPs (f, h) of each of the first ``nit`` steps of the closed loop
    of one candidate (N, Nu = max over inputs, delta (ny,), lam (nu,)) that
    applies the raw inputs ``u_traj`` (nit, nu).  ``caps`` restricts the
    controller to that capacity bucket (exact for the candidate when N and
    Nu fit; smaller and faster QPs); None keeps the full (p_max, m_max).
    Returns (qps, c, cand): qps a list of (f (n,), h (mc,)), c the loop's
    arrays and cand the candidate's QP data, both dicts of numpy arrays."""
    loop = problem.loop if caps is None else problem.loop.capped(*caps)
    d = loop.dims
    ct = loop.arrays(F64, "cpu")
    c = {k: v.numpy() for k, v in ct.items()}
    cand_t = assemble_candidate(
        ct, torch.tensor([int(N)]), torch.tensor([int(Nu)]),
        _t(delta)[None], _t(lam)[None], d["p_max"], d["m_max"], d["ny"],
        d["nu"], d["rho"], d["with_y"])
    cand = {k: v[0].numpy() for k, v in cand_t.items() if k != "admm"}

    nxp, nxa, nu = c["A_pl"].shape[0], c["A"].shape[0], d["nu"]
    x_pl, x_hat_pred, u_prev = np.zeros(nxp), np.zeros(nxa), np.zeros(nu)
    r = np.asarray(problem.r[:nit])
    v = np.asarray(problem.v[:nit])
    nd = v.shape[1]
    sf_y, sf_u, sf_v = c["sf_y"], c["sf_u"], c["sf_v"]
    u_traj = np.asarray(u_traj, dtype=np.float64)
    qps = []
    for k in range(nit):
        y_s = (c["C_pl"] @ x_pl) / sf_y
        v_s = v[k] / sf_v if nd else v[k]
        innov = y_s - c["C"] @ x_hat_pred - (c["Dv"] @ v_s if nd else 0.0)
        x_hat = x_hat_pred + c["M"] @ innov
        f, h, _ = qp_step_data(ct, cand_t, _t(x_hat)[None], _t(u_prev)[None],
                               _t(r[k] / sf_y)[None], _t(v_s), d["p_max"],
                               d["m_max"], d["ny"], nu, d["with_y"])
        qps.append((f[0].numpy(), h[0].numpy()))
        u_s = u_traj[k] / sf_u
        x_hat_pred = c["A"] @ x_hat + c["Bu"] @ u_s + (
            c["Bv"] @ v_s if nd else 0.0)
        x_pl = c["A_pl"] @ x_pl + c["B_pl"] @ np.concatenate([u_traj[k], v[k]])
        u_prev = u_s
    return qps, c, cand


def certify(c, cand, f, h, nu):
    """LP and frozen-QP certified optimum of one harvested QP: (z_star,
    eps_min, du_sens), or (None, None, None) if the LP solver fails."""
    from scipy.optimize import linprog

    G0 = c["G0"]
    rmask, cmask = cand["rmask"], cand["cmask_z"]
    n = G0.shape[1]
    cobj = np.zeros(n)
    cobj[-1] = 1.0
    res = linprog(cobj, A_ub=rmask[:, None] * G0 * cmask[None, :], b_ub=h,
                  bounds=[(None, None)] * n, method="highs")
    if res.status != 0:
        return None, None, None
    eps_min = float(res.x[-1])
    cmask2 = cmask.copy()
    cmask2[-1] = 0.0
    H, G0t, T2, rm = (_t(cand["H"])[None], _t(G0), _t(c["T2"]),
                      _t(rmask)[None])

    def frozen(ehat):
        h2 = h - G0[:, -1] * rmask * ehat
        z = solve_qp_masked(H, _t(f)[None], G0t, T2, rm, _t(cmask2)[None],
                            _t(h2)[None], iters=200)[0]
        return z[0].numpy()

    z = frozen(max(eps_min, 0.0) * (1.0 + 1e-9) + 1e-11)
    z1 = frozen(max(eps_min, 0.0) * (1.0 + 1e-6) + 1e-8)
    return z, eps_min, float(np.abs(z[:nu] - z1[:nu]).max())


def _certify_one(job):
    torch.set_num_threads(1)
    return certify(*job)


def certify_pool(workers):
    """A pool of ``workers`` processes for ``certify_steps``, spawned (so a
    parent that holds a GPU context forks none; the parent's main module
    must be import-safe, as a script's ``if __name__ == "__main__"``
    makes it)."""
    import concurrent.futures
    import multiprocessing

    return concurrent.futures.ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"))


def certify_steps(c, cand, qps, nu, pool=None):
    """``certify`` of every harvested QP, in this process or over ``pool``
    (``certify_pool``); a list of (z_star, eps_min, du_sens)."""
    jobs = [(c, cand, f, h, nu) for f, h in qps]
    if pool is None:
        return [certify(*j) for j in jobs]
    return list(pool.map(_certify_one, jobs, chunksize=4))


def kernel_slack(E):
    """The slack the band loop's stage 0 reached, from its frozen slack
    E = (max(eps_1, 0) + extra) (1 + m_rel) + m_abs (``ops/qp.split_stage2``):
    max(eps_1, 0) + extra, where extra >= 0 is eps_1's residual soft-row
    violation per unit of slack coefficient.  So it is the least slack
    that makes the stage-0 move feasible: it equals max(eps_1, 0) when the
    LP ended feasible, and is an upper bound of it otherwise."""
    m_rel, m_abs = split_margins(F64)
    return (np.asarray(E, dtype=np.float64) - m_abs) / (1.0 + m_rel)


def engine_step_errors(problem, qps, c, cand, lp_iters, s2_iters,
                       du_sens_bar=1e-4, certs=None):
    """Replay the plain band loop's solve chain (slack seeding, the
    ``lp_iters`` stage-0 slack LP, the slack-frozen ``s2_iters`` stage 2,
    the LP's (z, lam) carried to the next step) over the harvested QPs and
    score it against the certificate.  Returns a dict: the largest relative
    slack error over all steps (``deps_rel``), the largest du error over
    the well-posed steps (du_sens < du_sens_bar), the largest objective
    excess over the ill-posed ones, and step counts.  ``certs``: the
    steps' certificates (``certify_steps``), computed here if None."""
    nu = problem.loop.dims["nu"]
    G0 = _t(c["G0"])
    T2T = _t(c["T2"]).T.contiguous()
    rm, cm = _t(cand["rmask"])[:, None], _t(cand["cmask_z"])[:, None]
    H = cand["H"]
    Hp = _t(H)[:, :, None]
    H_lp = _t(cand["H_lp"])[:, :, None]
    f_lp = _t(cand["f_lp"])[:, None]
    n, mc = G0.shape[1], G0.shape[0]
    warm = (torch.zeros((n, 1), dtype=F64), torch.ones((mc, 1), dtype=F64))
    out = {"deps_rel": 0.0, "du_well_posed": 0.0, "dobj_ill_posed": 0.0,
           "n_steps": len(qps), "n_well_posed": 0, "n_eps_pos": 0}
    if certs is None:
        certs = certify_steps(c, cand, qps, nu)
    for (f, h), (z_star, eps_min, du_sens) in zip(qps, certs):
        if z_star is None:
            continue
        well = du_sens < du_sens_bar
        out["n_well_posed"] += int(well)
        out["n_eps_pos"] += int(eps_min > 1e-9)
        ht, ft = _t(h)[:, None], _t(f)[:, None]
        z0, l0 = seed_slack(*warm, G0, rm, cm, ht)
        z1, l1, _ = pdip_lanes(H_lp, f_lp, G0, T2T, rm, cm, ht, lp_iters,
                               (z0, l0))
        warm = (z1, l1)
        h2, cm2, z2, _ = split_stage2(z1, G0, rm, cm, ht)
        z2 = pdip_lanes(Hp, ft, G0, T2T, rm, cm2, h2, s2_iters,
                        (z2, l1))[0][:, 0].numpy()
        eps_1 = float(z1[-1, 0])
        out["deps_rel"] = max(out["deps_rel"],
                              abs(eps_1 - eps_min) / (1.0 + abs(eps_min)))
        if well:
            out["du_well_posed"] = max(
                out["du_well_posed"], float(np.abs(z2[:nu] - z_star[:nu]).max()))
        else:
            obj = lambda z: 0.5 * z @ H @ z + f @ z
            out["dobj_ill_posed"] = max(out["dobj_ill_posed"],
                                        float(obj(z2) - obj(z_star)))
    return out


def hold(problem, N, Nu, delta, lam, U, E, caps=None, pool=None):
    """Hold one band loop's run (U (nit, nu) raw inputs, E (nit,) frozen
    slacks, of one candidate) step by step against the certificate: the
    QPs are harvested along its own U (teacher-forced) and each certified
    (``certify_steps``, over ``pool`` if given), then ``hold_certified``."""
    U = np.asarray(U, dtype=np.float64)
    qps, c, cand = harvest_qps(problem, N, Nu, delta, lam, U, U.shape[0],
                               caps)
    return hold_certified(c, certify_steps(c, cand, qps, U.shape[1], pool),
                          U, E)


def hold_certified(c, certs, U, E):
    """The run's slack (``kernel_slack(E)``) and first move (U's increment
    in the QP's scaled units) against the certificates ``certs`` of its
    harvested steps.  Returns a dict: steps, well-posed steps, steps with
    eps_min > 1e-9, uncertified steps, the largest relative slack error
    over all steps and the largest first-move error over the well-posed
    ones, and ``ok`` at HOLD_EPS_REL / HOLD_DU.

    The slack E - the split margin is max(eps_1, 0) + extra, the stage-0
    slack plus its residual soft-row violation: where extra > 0 it is an
    upper bound of the LP's own slack, the least slack that makes the
    stage-0 move feasible, and the slack the loop froze for stage 2.  It is
    held two-sided like the slack itself: an extra that moved the frozen
    slack off the minimum fails the gate as an LP that stopped short
    would."""
    U = np.asarray(U, dtype=np.float64)
    nit, nu = U.shape
    eps_k = kernel_slack(E)
    du_k = np.diff(U / c["sf_u"], axis=0, prepend=np.zeros((1, nu)))
    out = dict(steps=nit, well_posed=0, eps_pos=0, uncertified=0,
               deps_rel=0.0, du_well_posed=0.0)
    for k, (z_star, eps_min, du_sens) in enumerate(certs):
        if z_star is None:
            out["uncertified"] += 1
            continue
        out["eps_pos"] += int(eps_min > 1e-9)
        out["deps_rel"] = max(out["deps_rel"], abs(float(eps_k[k]) - eps_min)
                              / (1.0 + abs(eps_min)))
        if du_sens < DU_SENS_BAR:
            out["well_posed"] += 1
            out["du_well_posed"] = max(out["du_well_posed"], float(
                np.abs(du_k[k] - z_star[:nu]).max()))
    out["ok"] = (out["uncertified"] == 0 and out["deps_rel"] < HOLD_EPS_REL
                 and out["du_well_posed"] < HOLD_DU)
    return out
