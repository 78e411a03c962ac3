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
           "chain_steps", "engine_step_errors", "kernel_slack", "run_steps",
           "hold", "hold_certified", "hold_relative",
           "HOLD_EPS_REL", "HOLD_DU", "DU_SENS_BAR", "REL_REPLICAS", "F64"]

# The per-step gates of a band loop's run (the JAX oracle's,
# tests/test_band_oracle.py): its slack within HOLD_EPS_REL of the LP
# minimum, relative to 1 + |eps_min|, on every step; its first move within
# HOLD_DU of the certified move where du is well posed (du_sens <
# DU_SENS_BAR).
HOLD_EPS_REL = 1e-6
HOLD_DU = 1e-3
DU_SENS_BAR = 1e-4
# hold_relative's sample of correct chains that round differently, drawn
# where two chains do not clear a run: where the 20-iteration LP does not
# converge, a correct chain's miss has a long tail, with rare atoms
# (scripts/band_chain_scatter.py: on one (127, 15) lane's jump step,
# median 2.6e-6, p99 2.6e-5, 0.6 % of chains at 4.14e-5), so the largest
# of two misses is often under half of a third's.  On the card a batch of
# 1024 costs about what one chain does.
REL_REPLICAS = 1024

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


def chain_steps(qps, c, cand, certs, lp_iters, s2_iters, replicas=None,
                device="cpu", du_sens_bar=DU_SENS_BAR):
    """Per step, how far the plain band loop's solve chain (slack seeding,
    the ``lp_iters`` stage-0 slack LP, the slack-frozen ``s2_iters`` stage
    2, the LP's (z, lam) carried to the next step) ends from the
    certificates ``certs`` of the harvested QPs ``qps``.  With ``replicas``
    None, the chain on the QPs as harvested; else ``replicas`` chains in
    one batch on ``device``, each with every nonzero element of each
    step's f and h moved one ulp up, down or not at all (seeded): correct
    runs that round differently, as two runs of the loop do.  Returns a dict of (steps, chains) float64 arrays:
    ``deps_rel`` (the LP's slack eps_1), ``deps_rel_frozen``
    (the frozen slack less the split margin, the measure ``hold_certified``
    takes of a loop's run), both relative to 1 + |eps_min|; ``du`` (the
    first move, NaN where du is ill-posed, du_sens >= du_sens_bar) and
    ``dobj`` (the objective's excess, NaN where du is well posed); all NaN
    on an uncertified step."""
    from mpc_tuning_tpu_torch.ops.kernels import (factor_lanes_plain,
                                                  lane_sum_plain,
                                                  solve_lanes_plain)

    W = 1 if replicas is None else int(replicas)
    rng = np.random.default_rng(0)
    kw = dict(dtype=F64, device=device)
    T = lambda x: torch.as_tensor(np.asarray(x), **kw)
    lanes = lambda x: x.unsqueeze(-1).expand(*x.shape, W).contiguous()

    def rounded(x):
        x = np.repeat(np.asarray(x, dtype=np.float64)[:, None], W, axis=1)
        if replicas is None:
            return T(x)
        move = rng.integers(-1, 2, size=x.shape) * (x != 0)
        return T(np.where(move > 0, np.nextafter(x, np.inf),
                          np.where(move < 0, np.nextafter(x, -np.inf), x)))

    plain = dict(factor=factor_lanes_plain, solve=solve_lanes_plain,
                 total=lane_sum_plain)
    nu = len(c["sf_u"])
    G0 = T(c["G0"])
    T2T = T(c["T2"]).T.contiguous()
    rm, cm = lanes(T(cand["rmask"])), lanes(T(cand["cmask_z"]))
    H = cand["H"]
    Hp, H_lp, f_lp = (lanes(T(cand[k])) for k in ("H", "H_lp", "f_lp"))
    n, mc = G0.shape[1], G0.shape[0]
    warm = (torch.zeros((n, W), **kw), torch.ones((mc, W), **kw))
    out = {k: np.full((len(qps), W), np.nan)
           for k in ("deps_rel", "deps_rel_frozen", "du", "dobj")}
    for k, ((f, h), (z_star, eps_min, du_sens)) in enumerate(zip(qps, certs)):
        if z_star is None:
            continue
        ht, ft = rounded(h), rounded(f)
        z0, l0 = seed_slack(*warm, G0, rm, cm, ht)
        z1, l1, _ = pdip_lanes(H_lp, f_lp, G0, T2T, rm, cm, ht, lp_iters,
                               (z0, l0), **plain)
        warm = (z1, l1)
        h2, cm2, z2, ehat = split_stage2(z1, G0, rm, cm, ht)
        z2 = pdip_lanes(Hp, ft, G0, T2T, rm, cm2, h2, s2_iters, (z2, l1),
                        **plain)[0].cpu().numpy()
        rel = lambda e: np.abs(e - eps_min) / (1.0 + abs(eps_min))
        out["deps_rel"][k] = rel(z1[-1].cpu().numpy())
        out["deps_rel_frozen"][k] = rel(kernel_slack(ehat[0].cpu().numpy()))
        if du_sens < du_sens_bar:
            out["du"][k] = np.abs(z2[:nu] - z_star[:nu, None]).max(0)
        else:
            obj = lambda z: 0.5 * np.einsum("iw,ij,jw->w", z, H, z) + f @ z
            out["dobj"][k] = obj(z2) - obj(z_star[:, None])
    return out


def engine_step_errors(problem, qps, c, cand, lp_iters, s2_iters,
                       du_sens_bar=1e-4, certs=None):
    """Replay the plain band loop's solve chain over the harvested QPs and
    score it against the certificate (``chain_steps`` on the QPs as
    harvested).  Returns a dict: the largest relative slack error over all
    steps (``deps_rel``: the LP's slack eps_1; and ``deps_rel_frozen``: the
    frozen slack less the split margin), the largest du error over the
    well-posed steps (du_sens < du_sens_bar), the largest objective excess
    over the ill-posed ones, and step counts.  ``certs``: the steps'
    certificates (``certify_steps``), computed here if None."""
    nu = problem.loop.dims["nu"]
    if certs is None:
        certs = certify_steps(c, cand, qps, nu)
    steps = chain_steps(qps, c, cand, certs, lp_iters, s2_iters,
                        du_sens_bar=du_sens_bar)
    top = lambda x: float(np.nanmax(x, initial=0.0))
    return {"deps_rel": top(steps["deps_rel"]),
            "deps_rel_frozen": top(steps["deps_rel_frozen"]),
            "du_well_posed": top(steps["du"]),
            "dobj_ill_posed": top(steps["dobj"]),
            "n_steps": len(qps),
            "n_well_posed": int(np.sum(~np.isnan(steps["du"][:, 0]))),
            "n_eps_pos": sum(int(e > 1e-9) for z, e, _ in certs
                             if z is not None)}


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


def run_steps(c, certs, U, E):
    """Per step of one band loop's run (U (nit, nu) raw inputs, E (nit,)
    frozen slacks), how far it ends from the certificates ``certs`` of the
    QPs harvested along U: (deps_rel, du), (nit,) arrays.  deps_rel is the
    run's slack (``kernel_slack(E)``) off the LP minimum, relative to 1 +
    |eps_min|; du its first move (U's increment in the QP's scaled units)
    off the certified one, NaN where du is ill-posed (du_sens >=
    DU_SENS_BAR); both NaN on an uncertified step."""
    U = np.asarray(U, dtype=np.float64)
    nit, nu = U.shape
    eps_k = kernel_slack(E)
    du_k = np.diff(U / c["sf_u"], axis=0, prepend=np.zeros((1, nu)))
    deps, du = np.full(nit, np.nan), np.full(nit, np.nan)
    for k, (z_star, eps_min, du_sens) in enumerate(certs):
        if z_star is None:
            continue
        deps[k] = abs(float(eps_k[k]) - eps_min) / (1.0 + abs(eps_min))
        if du_sens < DU_SENS_BAR:
            du[k] = float(np.abs(du_k[k] - z_star[:nu]).max())
    return deps, du


def hold_certified(c, certs, U, E):
    """The run's slack and first move (``run_steps``) against the
    certificates ``certs`` of its harvested steps.  Returns a dict: steps,
    well-posed steps, steps with eps_min > 1e-9, uncertified steps, the
    largest relative slack error over all steps and the largest first-move
    error over the well-posed ones, and ``ok`` at HOLD_EPS_REL / HOLD_DU.

    The slack E - the split margin is max(eps_1, 0) + extra, the stage-0
    slack plus its residual soft-row violation: where extra > 0 it is an
    upper bound of the LP's own slack, the least slack that makes the
    stage-0 move feasible, and the slack the loop froze for stage 2.  It is
    held two-sided like the slack itself: an extra that moved the frozen
    slack off the minimum fails the gate as an LP that stopped short
    would."""
    deps, du = run_steps(c, certs, U, E)
    top = lambda x: float(np.nanmax(x, initial=0.0))
    out = dict(steps=len(deps), well_posed=int(np.sum(~np.isnan(du))),
               eps_pos=sum(int(e > 1e-9) for z, e, _ in certs
                           if z is not None),
               uncertified=int(np.sum(np.isnan(deps))),
               deps_rel=top(deps), du_well_posed=top(du))
    out["ok"] = (out["uncertified"] == 0 and out["deps_rel"] < HOLD_EPS_REL
                 and out["du_well_posed"] < HOLD_DU)
    return out


def _reordered(qps, c, cand, nu):
    """The harvested QPs with their rows and their variables after the
    first move (but the slack) in reverse order: the same QPs, whose
    solve chain sums and factors in another order."""
    mc, n = c["G0"].shape
    rows = np.arange(mc)[::-1]
    cols = np.concatenate([np.arange(nu), np.arange(nu, n - 1)[::-1],
                           [n - 1]])
    c = dict(c, G0=c["G0"][rows][:, cols],
             T2=c["T2"][rows][:, (cols[:, None] * n + cols).ravel()])
    cand = dict(cand, H=cand["H"][cols][:, cols],
                H_lp=cand["H_lp"][cols][:, cols], f_lp=cand["f_lp"][cols],
                rmask=cand["rmask"][rows], cmask_z=cand["cmask_z"][cols])
    return [(f[cols], h[rows]) for f, h in qps], c, cand


def hold_relative(problem, N, Nu, delta, lam, U, E, caps=None, pool=None,
                  lp_iters=20, s2_iters=12, replicas=REL_REPLICAS,
                  device="cpu"):
    """One band loop's run (as ``hold``) held step by step against the
    certificate relative to correct runs of the plain loop's solve chain
    on the same QPs (harvested along the run's U, certified once).  On
    each step the run's slack error (``run_steps``) is at most
    max(HOLD_EPS_REL, twice the largest of the chains' on that step,
    ``deps_rel_frozen``), and its first-move error, where du is well
    posed, at most max(HOLD_DU, twice theirs): where the 20 + 12
    iterations do not reach the optimum, the run may miss it by as much as
    a correct run does; on the steps where they do, the absolute gates
    hold.  The chains: the QPs as harvested and with their rows and later
    variables in reverse order (``_reordered``); where the run misses the
    limits these two set, also ``replicas`` chains whose QPs each differ
    by a rounding (``chain_steps``, on ``device``), since where the LP
    does not converge a correct run's miss scatters with a long tail that
    two chains do not sample.  Returns {"run": hold_certified's dict,
    "plain", "reordered": engine-style summaries of the two chains,
    "chains": chains sampled, "eps_limits" / "du_limits": the per-step
    limits, "eps_step", "eps_run", "eps_limit" (and "du_*"): the step
    where the run is nearest its slack (first-move) limit, its error and
    the limit there, "ok"}."""
    U = np.asarray(U, dtype=np.float64)
    nu = U.shape[1]
    qps, c, cand = harvest_qps(problem, N, Nu, delta, lam, U, U.shape[0],
                               caps)
    certs = certify_steps(c, cand, qps, nu, pool)
    run = hold_certified(c, certs, U, E)
    r_eps, r_du = run_steps(c, certs, U, E)
    chains = {name: chain_steps(*data, certs, lp_iters, s2_iters)
              for name, data in (("plain", (qps, c, cand)),
                                 ("reordered", _reordered(qps, c, cand,
                                                          nu)))}
    top = lambda x: float(np.nanmax(x, initial=0.0))
    out = {name: dict(deps_rel_frozen=top(ch["deps_rel_frozen"]),
                      du_well_posed=top(ch["du"]))
           for name, ch in chains.items()}

    def verdict(sampled):
        worst = lambda k: np.fmax.reduce(
            np.concatenate([ch[k] for ch in sampled], axis=1), axis=1)
        res = dict(run=run, chains=sum(ch["du"].shape[1] for ch in sampled))
        ok = run["uncertified"] == 0
        for key, r, chain, floor in (("eps", r_eps, worst("deps_rel_frozen"),
                                      HOLD_EPS_REL),
                                     ("du", r_du, worst("du"), HOLD_DU)):
            lim = np.fmax(floor, 2.0 * chain)
            ratio = np.where(np.isnan(r), -np.inf, r / lim)
            k = int(np.argmax(ratio))
            ok = ok and not (ratio > 1.0).any()
            res.update({f"{key}_step": k, f"{key}_run": float(r[k]),
                        f"{key}_limit": float(lim[k]), f"{key}_limits": lim})
        return dict(res, ok=ok)

    res = verdict(list(chains.values()))
    if not res["ok"] and run["uncertified"] == 0 and replicas:
        res = verdict(list(chains.values()) + [chain_steps(
            qps, c, cand, certs, lp_iters, s2_iters, replicas,
            device=device)])
    return dict(res, **out)
