"""Top-level hybrid MPC tuning — the equivalent of
MPC-Tuning/MPC_Tuning/MPCTuning.m + MPC_TFob.m for linear
plants.

Pipeline (MPCTuning.m:152-343):
 1. condition the full [G D] plant by minimum-condition-number diagonal
    scaling (CondMin over the DC gain), rescale constraints, setpoints,
    Yref, measured disturbances and ScaleFactors;
 2. bit-encode horizons: N in nbp bits (init 2^nbp-1), per-input Nu in nbc
    bits (init 2);
 3. alternate GAM (continuous weights, gam.py) with VNS (integer horizons,
    vns.py) until the GAM cost stops improving (MPC_TFob.m:108-130);
 4. apply the tuning and write a checkpoint artifact.

All candidate evaluations inside are batched closed-loop simulations on
the chosen device; this host driver only orchestrates.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpc_tuning_tpu_torch.models.lti import TransferFunction
from mpc_tuning_tpu_torch.ops.condmin import condmin
from mpc_tuning_tpu_torch.ops.kernels import require_device
from mpc_tuning_tpu_torch.ops.mpc_qp import MPCSpec, build_controller, pin_precision
from mpc_tuning_tpu_torch.sim.mpc_loop import MPCLoop
from mpc_tuning_tpu_torch.tuning.gam import gam_solve
from mpc_tuning_tpu_torch.tuning.objectives import TuningProblem, vns_objective_batch
from mpc_tuning_tpu_torch.tuning.vns import VNSResult, bits_to_int, int_to_bits, vns_search
from mpc_tuning_tpu_torch.utils.io import save_tuning

__all__ = ["mpc_tuning", "TuningResult", "LinearCase"]


@dataclasses.dataclass
class LinearCase:
    """Case description in raw (unconditioned) units — mirrors what the
    reference drivers configure on the mpc object (WoodBerry.m:100-148)."""

    name: str
    plant: TransferFunction  # full [G D] continuous model used for tuning
    n_mv: int
    n_md: int
    Ts: float
    Xsp: np.ndarray  # (nit, my)
    Yref: np.ndarray  # (nit, my)
    mdv: np.ndarray  # (nit, n_md)
    nit: int
    w: np.ndarray  # pareto weights
    umin: np.ndarray
    umax: np.ndarray
    dumin: np.ndarray
    dumax: np.ndarray
    ymin: np.ndarray
    ymax: np.ndarray
    ov_weight0: np.ndarray  # initial Weights.OV (zeros mark band outputs)
    mvrate_weight0: np.ndarray  # initial Weights.MVRate
    v_ymin: np.ndarray | None = None
    v_ymax: np.ndarray | None = None
    rho_eps: float = 1e5
    sf_u: np.ndarray | None = None
    sf_y: np.ndarray | None = None
    sf_v: np.ndarray | None = None
    nbp: int = 7
    nbc: int = 4


@dataclasses.dataclass
class TuningResult:
    N: int
    Nu: np.ndarray
    delta: np.ndarray
    lam: np.ndarray
    L: np.ndarray
    R: np.ndarray
    Ru: np.ndarray
    Rv: np.ndarray
    Fvns: float
    Fgam: float
    cond_before: float
    cond_after: float
    problem: TuningProblem
    checkpoint: str | None
    history: list


def _condition_case(case: LinearCase):
    """MPCTuning.m:152-200: CondMin over the full [G D] DC gain."""
    K = case.plant.dcgain()
    L, R, S = condmin(K)
    ld = np.diag(L)
    rd = np.diag(R)
    Ru = rd[: case.n_mv]
    Rv = rd[case.n_mv :]
    cond_before = float(np.linalg.cond(K))
    return L, R, Ru, Rv, S, cond_before


def build_problem(case: LinearCase, dtype=torch.float64, qp_iters: int = 30,
                  L=None, R=None, device="cuda", mesh=None):
    """Condition + assemble the TuningProblem (device-side evaluators).

    ``device`` is where every candidate evaluation runs: the card by
    default (a host without one raises), "cpu" for the plain versions.
    ``mesh`` (``parallel.sweep.candidate_mesh``): shard every candidate
    batch over its devices instead (``TuningProblem.mesh``)."""
    require_device(device)
    if L is None or R is None:
        L, R, Ru, Rv, S, cond_before = _condition_case(case)
    else:
        Ru = np.diag(R)[: case.n_mv]
        Rv = np.diag(R)[case.n_mv :]
        S = float(np.linalg.cond(L @ case.plant.dcgain() @ R))
        cond_before = float(np.linalg.cond(case.plant.dcgain()))
    ld = np.diag(L)

    model_c = case.plant.scaled(L, R).c2d(case.Ts)
    model_ss = model_c.to_ss()

    p_max = 2**case.nbp - 1
    m_max = 2**case.nbc - 1

    sf_u = np.ones(case.n_mv) if case.sf_u is None else case.sf_u / Ru
    sf_y = np.ones(model_ss.ny) if case.sf_y is None else case.sf_y * ld
    sf_v = (np.ones(case.n_md) if case.sf_v is None else case.sf_v / np.where(Rv == 0, 1, Rv))

    spec = MPCSpec(
        model=model_ss, n_mv=case.n_mv, n_md=case.n_md,
        p_max=p_max, m_max=m_max,
        umin=case.umin / Ru, umax=case.umax / Ru,
        dumin=case.dumin / Ru, dumax=case.dumax / Ru,
        ymin=ld * case.ymin, ymax=ld * case.ymax,
        v_ymin=case.v_ymin, v_ymax=case.v_ymax,
        rho_eps=case.rho_eps, sf_u=sf_u, sf_y=sf_y, sf_v=sf_v,
    )
    ctl = build_controller(spec)
    loop = MPCLoop(ctl=ctl, plant_ss=model_ss)  # tuning: plant == model

    # per-output minimum delay (MPCTuning.m:257-262)
    _, _, dp = model_c.descomp()
    dmin = dp.min(axis=1)

    r_c = (L @ case.Xsp[: case.nit].T).T
    Yref_c = (L @ case.Yref[: case.nit].T).T
    mdv_c = case.mdv[: case.nit] / np.where(Rv == 0, 1.0, Rv)[None, :] if case.n_md else case.mdv[: case.nit]

    problem = TuningProblem(
        loop=loop, r=r_c, v=mdv_c, Yref=Yref_c, nit=case.nit,
        w=np.asarray(case.w, dtype=np.float64),
        band_mask=np.asarray(case.ov_weight0) == 0.0,
        dmin=dmin, nbp=case.nbp, nbc=case.nbc,
        dtype=dtype, device=device, qp_iters=qp_iters, mesh=mesh,
    )
    return problem, (L, R, Ru, Rv, S, cond_before)


def _joint_weight_polish(problem, N: int, Nu: int, weight_pool,
                         popsize: int = 8, generations: int = 8,
                         sigma0: float = 0.35, seed: int = 1234,
                         global_samples: int = 32,
                         verbose: bool = True):
    """Chebyshev knee selection over weight space at FIXED horizons.

    The reference ships a glued quadruple — best-VNS horizons + last-GAM
    weights (MPC_TFob.m:134-140) — whose weights can be strongly
    single-objective: the gamma-optimal weights of a late fgoalattain can
    be orders of magnitude worse on the VNS objective (measured on Van de
    Vusse: gamma 4.8 but F_vns 7.6e4).  This extension evaluates a weight
    pool (every GAM result of the run + the glued pair) on BOTH tuner
    objectives and refines with a small log-space (1+lambda)-ES on the
    Chebyshev scalarization w.r.t. the run's own ideal point,

        s(x) = max( F_vns(x)/F*,  gamma(x)/gamma* ),

    a standard multi-objective knee selection that uses no external
    information.  Ships the argmin-s point; it can only improve the
    balance of the returned quadruple.  Returns (x, F_vns, gamma)."""
    from mpc_tuning_tpu_torch.tuning.objectives import gam_sse_batch, vns_objective_batch

    my = problem.my
    rng = np.random.default_rng(seed)
    w = np.asarray(problem.w, dtype=np.float64)

    def eval_xs(X):
        X = np.maximum(np.abs(np.asarray(X, dtype=np.float64)), 1e-5)
        S = gam_sse_batch(problem, N, Nu, X)
        S = np.where(np.isfinite(S), S, 1e30)
        g = np.max((S - problem.goal) / w[None, :], axis=1)
        F = np.empty(len(X))
        for i in range(len(X)):
            Fi = vns_objective_batch(problem, np.array([N]), np.array([Nu]),
                                     X[i, :my], X[i, my:])[0]
            F[i] = Fi if np.isfinite(Fi) else 1e30
        return F, g

    pool = np.array([np.maximum(np.abs(np.asarray(p, np.float64)), 1e-5)
                     for p in weight_pool])
    F, g = eval_xs(pool)
    Fstar = max(float(F.min()), 1e-12)
    gstar = max(float(g.min()), 1e-12)

    cand_x = list(pool)
    cand_F = list(F)
    cand_g = list(g)

    def scal(Fv, gv):
        return np.maximum(np.asarray(Fv) / Fstar, np.asarray(gv) / gstar)

    n = pool.shape[1]

    # global log-uniform sampling over a pool-informed range: the two
    # objectives' preferred basins can be disjoint and far from every pool
    # point (measured on VdV — a 48-point random sweep found the
    # dominating knee region that local search from the pool missed)
    if global_samples:
        lo = float(np.clip(pool.min() / 5.0, 1e-3, None))
        hi = float(np.clip(pool.max() * 5.0, None, 50.0))
        Xg = np.exp(rng.uniform(np.log(lo), np.log(hi),
                                size=(global_samples, n)))
        Fg, gg = eval_xs(Xg)
        Fstar = max(min(Fstar, float(Fg.min())), 1e-12)
        gstar = max(min(gstar, float(gg.min())), 1e-12)
        cand_x.extend(Xg)
        cand_F.extend(Fg)
        cand_g.extend(gg)

    def run_es(y0):
        nonlocal Fstar, gstar
        y = y0
        sigma = sigma0
        for gen in range(generations):
            Z = rng.standard_normal((popsize, n))
            Z[0] = 0.0
            X = np.exp(y[None, :] + sigma * Z)
            F, g = eval_xs(X)
            Fstar = max(min(Fstar, float(F.min())), 1e-12)
            gstar = max(min(gstar, float(g.min())), 1e-12)
            cand_x.extend(X)
            cand_F.extend(F)
            cand_g.extend(g)
            y = np.log(cand_x[int(np.argmin(scal(cand_F, cand_g)))])
            sigma *= 0.85

    # multi-start: the two objectives can prefer DISJOINT weight basins
    # (measured on VdV), so restart from the knee incumbent, the
    # F-minimizing pool point, and the gamma-minimizing pool point — the
    # shared archive + shared ideal point make the runs cooperative
    starts = {int(np.argmin(scal(cand_F, cand_g))),
              int(np.argmin(cand_F)), int(np.argmin(cand_g))}
    for si in starts:
        run_es(np.log(cand_x[si]))

    s_all = scal(cand_F, cand_g)
    bi = int(np.argmin(s_all))
    if verbose:
        print(f"[joint] knee s={s_all[bi]:.4g} F={cand_F[bi]:.6g} "
              f"gamma={cand_g[bi]:.4g} x={np.round(cand_x[bi], 4)} "
              f"(ideal F*={Fstar:.6g} gamma*={gstar:.4g})")
    return cand_x[bi], float(cand_F[bi]), float(cand_g[bi])


def hybrid_tune(
    problem: TuningProblem,
    nbp: int,
    nbc: int,
    x0: np.ndarray,
    gam_popsize: int = 16,
    gam_generations: int = 25,
    max_alternations: int = 10,
    seed: int = 0,
    verbose: bool = True,
    final_polish: bool = True,
    joint_polish: bool = True,
    state_path: str | None = None,
    resume: bool = False,
):
    """The GAM <-> VNS alternation of MPC_TFob.m:56-132 over any
    TuningProblem (linear toolbox-MPC or NMPC).

    ``state_path``: persist the full tuning state (incumbent bits, weights,
    objective incumbents, stop counter, alternation index) after every
    alternation; ``resume=True`` continues a killed run from that file and
    reproduces the uninterrupted result exactly (the CMA-ES inner search is
    re-seeded per alternation with seed+it, so no RNG state needs saving).
    The reference's only checkpoint is the final .mat (MPCTuning.m:370-381)
    — mid-run resume is an addition of this framework (SURVEY.md section 5).

    ``final_polish``: the reference ships a glued result — horizons from the
    best VNS (which ran at the then-best weights) and weights from the LAST
    fgoalattain (MPC_TFob.m:134-140) — so the shipped quadruple can be
    inconsistent.  The polish runs one extra VNS descent at the SHIPPED
    weights, starting from the incumbent horizons, accepting only strict
    improvements of F evaluated at that final weight set.  It can only
    lower the objective of the returned (N, Nu, delta, lambda)."""
    my, nu = problem.my, problem.nu

    # bit-encoded horizons: init N=2^nbp-1, Nu=2 (MPCTuning.m:283-289)
    Xv1 = np.ones(nbp, dtype=np.int64)
    Xv2 = np.stack([int_to_bits(2, nbc) for _ in range(nu)])
    N = bits_to_int(Xv1)
    Nu = np.array([2] * nu)

    x0 = np.maximum(np.abs(np.asarray(x0, dtype=np.float64)), 1e-5)
    x0_init = x0.copy()  # the run's starting weights (joint-polish seed)

    Fv = 1e30  # global VNS incumbent (MPCTuning.m:292 / VNS2 global Fv)
    Fva = 1e9
    Fvf = 1e15
    hi = 0
    best = dict(N=N, Nu=Nu, Xv1=Xv1, Xv2=Xv2, delta=None, lam=None)
    history = []
    delta = lam = None
    start_it = 0

    if resume and state_path is not None:
        import json as _json
        import os as _os

        if _os.path.exists(state_path):
            with open(state_path) as fh:
                s = _json.load(fh)
            arr = lambda v: None if v is None else np.asarray(v)
            best = dict(
                N=int(s["best"]["N"]), Nu=arr(s["best"]["Nu"]),
                Xv1=arr(s["best"]["Xv1"]).astype(np.int64),
                Xv2=arr(s["best"]["Xv2"]).astype(np.int64),
                delta=arr(s["best"]["delta"]), lam=arr(s["best"]["lam"]),
            )
            x0 = np.asarray(s["x0"])
            Fv, Fva, Fvf, hi = s["Fv"], s["Fva"], s["Fvf"], s["hi"]
            delta, lam = arr(s["delta"]), arr(s["lam"])
            history = s["history"]
            start_it = int(s["it"]) + 1
            if hi > 0:  # stop rule had already fired — nothing left to run
                start_it = max_alternations
            if verbose:
                print(f"[resume] alternation {start_it}, Fva={Fva}, hi={hi}")

    def _save_state(it):
        if state_path is None:
            return
        import json as _json

        lst = lambda v: None if v is None else np.asarray(v).tolist()
        with open(state_path, "w") as fh:
            _json.dump({
                "it": it, "x0": x0.tolist(),
                "Fv": Fv, "Fva": Fva, "Fvf": Fvf, "hi": hi,
                "delta": lst(delta), "lam": lst(lam),
                "best": {"N": int(best["N"]), "Nu": lst(best["Nu"]),
                         "Xv1": lst(best["Xv1"]), "Xv2": lst(best["Xv2"]),
                         "delta": lst(best["delta"]), "lam": lst(best["lam"])},
                "history": history,
            }, fh)

    for it in range(start_it, max_alternations):
        # ---- GAM: continuous weights at current incumbent horizons
        g = gam_solve(
            problem, int(best["N"]), int(np.max(best["Nu"])), x0,
            popsize=gam_popsize, generations=gam_generations, seed=seed + it,
        )
        x0 = g.x.copy()
        delta = np.where(problem.band_mask, 0.0, np.abs(g.x[:my]))
        lam = np.abs(g.x[my:])
        Fgam = round(float(np.sum(g.F)), 2)
        if verbose:
            tag = "over" if g.gamma < 0 else "under"
            print(f"[GAM {it}] Fgam={Fgam} gamma={g.gamma:.4g} ({tag}-achievement) "
                  f"delta={np.round(delta,4)} lambda={np.round(lam,4)}")

        if Fgam >= Fvf:
            hi += 1
        else:
            Fvf = Fgam
            best["delta"] = delta.copy()
            best["lam"] = lam.copy()

        # ---- VNS: integer horizons at last accepted weights
        d_use = best["delta"] if best["delta"] is not None else delta
        l_use = best["lam"] if best["lam"] is not None else lam
        vr = vns_search(problem, best["Xv1"], best["Xv2"], d_use, l_use, Fv,
                        verbose=verbose)
        Fv = vr.Fv
        if vr.Fv < Fva:
            Fva = vr.Fv
            best.update(N=vr.N, Nu=vr.Nu, Xv1=vr.Xv1, Xv2=vr.Xv2)

        history.append(dict(it=it, Fgam=Fgam, gamma=float(g.gamma), Fvns=vr.Fv,
                            N=int(vr.N), Nu=vr.Nu.tolist(),
                            delta=delta.tolist(), lam=lam.tolist()))
        _save_state(it)
        if hi > 0:
            break  # stop rule (MPC_TFob.m:108-130)

    # the reference applies the LAST GAM weights (MPC_TFob.m:137-140)
    if final_polish and delta is not None:
        F0 = float(vns_objective_batch(
            problem, np.array([int(best["N"])]),
            np.array([int(np.max(best["Nu"]))]), delta, lam)[0])
        vr = vns_search(problem, best["Xv1"], best["Xv2"], delta, lam, F0,
                        verbose=verbose)
        if vr.Fv < F0:
            best.update(N=vr.N, Nu=vr.Nu, Xv1=vr.Xv1, Xv2=vr.Xv2)
        Fva = min(vr.Fv, F0)
        history.append(dict(it="polish", Fvns=Fva, N=int(best["N"]),
                            Nu=np.asarray(best["Nu"]).tolist(),
                            delta=delta.tolist(), lam=lam.tolist()))
        if verbose:
            print(f"[polish] F(final pair)={Fva:.6g} N={best['N']} "
                  f"Nu={np.asarray(best['Nu']).tolist()}")

    # ---- joint (Chebyshev) weight polish at the shipped horizons: knee
    # selection over BOTH tuner objectives (see _joint_weight_polish)
    if joint_polish and delta is not None:
        pool = [np.concatenate([np.asarray(h["delta"]), np.asarray(h["lam"])])
                for h in history if not isinstance(h.get("it"), str)]
        pool.append(np.concatenate([delta, lam]))
        pool.append(x0_init)  # the run's starting weights: often the only
        # pool point in the F-good basin when GAM moved far (measured VdV)
        x_j, F_j, g_j = _joint_weight_polish(
            problem, int(best["N"]), int(np.max(best["Nu"])), pool,
            seed=seed + 999, verbose=verbose)
        delta = np.where(problem.band_mask, 0.0, np.abs(x_j[:my]))
        lam = np.abs(x_j[my:])
        best["delta"] = delta.copy()
        best["lam"] = lam.copy()
        # The returned/checkpointed Fvns must be the SHIPPED pair's own
        # objective (the Chebyshev knee can deliberately trade F for gamma;
        # reporting the pre-polish incumbent next to knee weights would
        # claim a value the shipped parameters cannot achieve).  The
        # monotone pre-polish incumbent stays available in the history
        # "joint" entry as Fvns_incumbent.
        history.append(dict(it="joint", Fvns=F_j, gamma=g_j,
                            Fvns_incumbent=Fva,
                            N=int(best["N"]),
                            Nu=np.asarray(best["Nu"]).tolist(),
                            delta=delta.tolist(), lam=lam.tolist()))
        Fva = F_j
    return best, delta, lam, Fva, Fvf, history


def mpc_tuning(
    case: LinearCase,
    dtype=torch.float64,
    qp_iters: int = 30,
    gam_popsize: int = 16,
    gam_generations: int = 25,
    max_alternations: int = 10,
    seed: int = 0,
    checkpoint_dir: str | None = "checkpoints",
    verbose: bool = True,
    L=None,
    R=None,
    state_path: str | None = None,
    resume: bool = False,
    device="cuda",
    mesh=None,
) -> TuningResult:
    """The hybrid tune of one linear case.

    ``device``: where every candidate evaluation runs — the card by
    default, through the hand-written kernels (a host without one raises);
    "cpu" takes the kernels' plain versions.
    ``dtype``: float64 is the decision-grade path; float32 the speed path
    of tracking cases (band cases run at float64 only and raise at float32).
    L/R override pins the conditioning scale (e.g. the reference's
    committed L/R for frame-identical tuning-outcome parity runs).

    ``state_path``/``resume``: mid-run checkpointing — the tuning state is
    persisted after every GAM<->VNS alternation and a killed run continues
    from the file, reproducing the uninterrupted result exactly.  When
    ``state_path`` is None but a checkpoint_dir is given, the state goes to
    <checkpoint_dir>/<case>_tuning_state.json (the same schema as the JAX
    package's).  ``mesh`` (``parallel.sweep.candidate_mesh``): every
    candidate batch of the alternation, the final polish and the joint
    polish is sharded over its devices, each shard on the engine the
    unsharded batch runs."""
    pin_precision()
    problem, (L, R, Ru, Rv, S, cond_before) = build_problem(
        case, dtype, qp_iters, L=L, R=R, device=device, mesh=mesh)
    x0 = np.concatenate([case.ov_weight0, case.mvrate_weight0])

    if state_path is None and checkpoint_dir is not None:
        import os as _os

        _os.makedirs(checkpoint_dir, exist_ok=True)
        state_path = _os.path.join(checkpoint_dir,
                                   f"{case.name}_tuning_state.json")

    best, delta, lam, Fva, Fvf, history = hybrid_tune(
        problem, case.nbp, case.nbc, x0,
        gam_popsize=gam_popsize, gam_generations=gam_generations,
        max_alternations=max_alternations, seed=seed, verbose=verbose,
        state_path=state_path, resume=resume,
    )

    final_delta, final_lam = delta, lam
    ckpt = None
    if checkpoint_dir is not None:
        ckpt = save_tuning(
            checkpoint_dir, case.name, best["N"], best["Nu"],
            final_delta, final_lam, L, R, [Fva, Fvf],
            meta=dict(cond_before=cond_before, cond_after=S),
        )
    if verbose:
        print(f"N={best['N']}; Nu={best['Nu']}; delta=[{np.round(final_delta,4)}]; "
              f"lambda=[{np.round(final_lam,4)}]; Fob=[{Fva};{Fvf}]")

    return TuningResult(
        N=int(best["N"]), Nu=best["Nu"], delta=final_delta, lam=final_lam,
        L=L, R=R, Ru=Ru, Rv=Rv, Fvns=Fva, Fgam=Fvf,
        cond_before=cond_before, cond_after=S,
        problem=problem, checkpoint=ckpt, history=history,
    )
