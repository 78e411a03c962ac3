"""Tuning-outcome parity cross-evaluation against the reference's committed
tuned artifacts (the port of the JAX package's ``cases/cross_eval.py``) —
the only ground truth the reference ships
(MPC-Tuning/MPC_Tuning/MPCTuning.m:370-381 writes them; the values are
tabulated in BASELINE.md).

For each case, BOTH parameter sets — the reference's tuned values and this
repo's tuned values (the committed ``checkpoints/*.npz``, read with NumPy;
nothing is written under ``checkpoints/``) — are evaluated on the SAME
objectives in the SAME engine and the SAME conditioned frame (the
reference's committed L/R scale).  Repo weights are frame-converted
exactly:

    delta'_i = delta_i * L_repo,ii / L_ref,ii
    lambda'_j = lambda_j * R_ref,jj / R_repo,jj

(the closed loop in raw units is invariant under this conversion: the MPC
stage cost terms delta_i*y_c,i = delta_i*L_ii*y_i and
lambda_j*du_c,j = lambda_j*du_j/R_jj are held fixed).

Objectives evaluated (exactly the tuner's own, at float64 on ``device``):
  * F_vns = sum(j21 + j22) + N + sum(Jnu)   (VNS2.m:171-195)
  * GAM per-output SSE vs Yref at the case setpoints (GAM_fun.m:109-117)
    and the attainment factor gamma = max_i (SSE_i - goal) / w_i
    (the fgoalattain program of MPC_TFob.m:61-67).

A parameter set is *better* when its F_vns is lower (the discrete search's
acceptance criterion).  The linear cases also carry the open-vs-closed
horizon check of both parameter sets (``cases/verify_horizons``): the
closed leg through the cold masked PDIP 'pdip' on tracking cases and
'band_sim' on the band case, as the JAX package picks 'pdip' and
'pdip_ws_lanes+lp20+split12'.

Artifact paths are relative to the repository root (the parent of this
package), wherever the caller's working directory is.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import torch

from mpc_tuning_tpu_torch.tuning.objectives import (TuningProblem,
                                                    gam_sse_batch,
                                                    vns_objective_batch)

__all__ = [
    "TunedPoint", "REF_TUNED", "REPO_TUNED_REFSCALE", "REPO_TUNED",
    "load_repo_point", "eval_point", "convert_weights", "cross_eval_case",
    "cross_eval_all",
]

REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class TunedPoint:
    """One tuned parameter set in its own conditioned frame."""

    N: int
    Nu: np.ndarray
    delta: np.ndarray
    lam: np.ndarray
    L: np.ndarray | None = None  # diag entries; None => identity (nonlinear)
    R: np.ndarray | None = None  # diag entries incl. MD columns


# Reference tuned artifacts (BASELINE.md; .mat files listed in SURVEY.md §6).
REF_TUNED = {
    "Shell3x3": TunedPoint(
        N=24, Nu=np.array([6, 2, 2]),
        delta=np.array([0.01066, 0.00402, 0.00079]),
        lam=np.array([9.25e-5, 5.52e-4, 1.52e-3]),
        L=np.array([0.4358, 0.4206, 0.5933]),
        R=np.array([0.6619, 0.2756, 0.4117]),
    ),
    # caso 2 ships no scale field in BASELINE.md; CondMin depends only on the
    # DC gain (same plant), so the caso-1 scale applies.
    "Shell3x3_caso2": TunedPoint(
        N=12, Nu=np.array([4, 2, 2]),
        delta=np.array([0.0498, 0.0397, 0.0105]),
        lam=np.array([0.0652, 0.0017, 0.0766]),
        L=np.array([0.4358, 0.4206, 0.5933]),
        R=np.array([0.6619, 0.2756, 0.4117]),
    ),
    "Shell7x5": TunedPoint(
        N=27, Nu=np.array([2, 2, 2]),
        delta=np.zeros(7),
        lam=np.array([0.0559, 0.0167, 1.6102]),
        L=np.array([0.4401, 0.2319, 0.6265, 0.5431, 0.6006, 0.2069, 0.3942]),
        R=np.array([0.2640, 0.1351, 0.1156, 0.7819, 0.4665]),
    ),
    "VanDeVusse_NMPC": TunedPoint(
        N=3, Nu=np.array([2, 2]),
        delta=np.array([0.0930, 0.1133]),
        lam=np.array([0.2460, 0.1231]),
    ),
}


def _artifact(path) -> pathlib.Path:
    """A committed artifact's path: a relative one is taken from the
    repository root."""
    path = pathlib.Path(path)
    return path if path.is_absolute() else REPO_ROOT / path


def load_repo_point(npz_path: str) -> TunedPoint:
    """Repo tuned artifact (utils/io.save_tuning schema)."""
    d = np.load(_artifact(npz_path), allow_pickle=False)
    L = np.diag(np.asarray(d["L"])) if "L" in d.files else None
    R = np.diag(np.asarray(d["R"])) if "R" in d.files else None
    return TunedPoint(
        N=int(d["N"]), Nu=np.asarray(d["Nu"]),
        delta=np.asarray(d["delta"]), lam=np.asarray(d["lam"]),
        L=L, R=R,
    )


# Committed tuning runs.  REPO_TUNED_REFSCALE (preferred) are tuned with the
# conditioning pinned to the reference's L/R: directly comparable, no frame
# conversion.  REPO_TUNED are runs at the repo's own CondMin scale, needing
# the exact weight conversion above.  Both were tuned by the JAX package.
REPO_TUNED_REFSCALE = {
    "Shell3x3": "checkpoints/Shell3x3_refscale_Tuning_21Aug2026_06_30.npz",
    "Shell3x3_caso2": "checkpoints/Shell3x3_caso2_refscale_Tuning_21Aug2026_06_32.npz",
    "Shell7x5": "checkpoints/Shell7x5_refscale_round5_Tuning_21Aug2026_18_50.npz",
    "VanDeVusse_NMPC": "checkpoints/VanDeVusse_NMPC_refscale_Tuning_21Aug2026_05_32.npz",
}
REPO_TUNED = {
    "Shell3x3": "checkpoints/Shell3x3_Tuning_17Aug2026_11_38.npz",
    "Shell7x5": "checkpoints/Shell7x5_f64polish_Tuning_21Aug2026_18_36.npz",
    "VanDeVusse_NMPC": "checkpoints/VanDeVusse_NMPC_Tuning_18Aug2026_07_21.npz",
}


def convert_weights(point: TunedPoint, L_to: np.ndarray | None,
                    R_to: np.ndarray | None, n_mv: int):
    """Express ``point``'s weights in the (L_to, R_to) conditioned frame."""
    delta, lam = point.delta, point.lam
    if L_to is not None and point.L is not None:
        delta = delta * point.L / L_to
    if R_to is not None and point.R is not None:
        lam = lam * R_to[:n_mv] / point.R[:n_mv]
    return np.abs(delta), np.abs(lam)


def eval_point(problem: TuningProblem, N: int, Nu: np.ndarray,
               delta: np.ndarray, lam: np.ndarray) -> dict:
    """Evaluate both tuner objectives at one (N, Nu, delta, lambda)."""
    Nu = np.asarray(Nu)
    F, parts = vns_objective_batch(
        problem, np.array([int(N)]), np.array([int(Nu.max())]),
        delta, lam, return_parts=True,
    )
    sse = gam_sse_batch(problem, int(N), int(Nu.max()),
                        np.concatenate([delta, lam])[None, :])[0]
    gamma = float(np.max((sse - problem.goal) / problem.w))
    return {
        "N": int(N), "Nu": [int(x) for x in Nu],
        "delta": [float(x) for x in delta], "lambda": [float(x) for x in lam],
        "F_vns": float(F[0]),
        "j21": float(parts["j21"][0]), "j22": float(parts["j22"][0]),
        "Jnu": float(parts["Jnu"][0]),
        "gam_sse": [float(x) for x in sse],
        "Fgam": round(float(np.sum(sse)), 2),
        "gamma": gamma,
    }


def _problem(name: str, ref: TunedPoint, device, nit=None):
    """(problem, n_mv) of case ``name`` at float64 on ``device`` (linear
    cases in the reference's L/R frame); ``nit`` cuts the case's steps."""
    from mpc_tuning_tpu_torch.tuning.api import build_problem

    kw = {} if nit is None else {"nit": nit}
    if name == "VanDeVusse_NMPC":
        from mpc_tuning_tpu_torch.cases import vandevusse

        case = vandevusse.make_case(**kw)
        return vandevusse.build_problem(case, torch.float64, device), 2
    if name in ("Shell3x3", "Shell3x3_caso2"):
        from mpc_tuning_tpu_torch.cases import shell3x3

        case = shell3x3.make_case(caso=1 if name == "Shell3x3" else 2, **kw)
    elif name == "Shell7x5":
        from mpc_tuning_tpu_torch.cases import shell7x5

        case = shell7x5.make_case(**kw)
    else:
        raise KeyError(name)
    problem, _ = build_problem(case, torch.float64, L=np.diag(ref.L),
                               R=np.diag(ref.R), device=device)
    if name == "Shell7x5":
        problem.qp_iters = 60
    return problem, case.n_mv


def cross_eval_case(name: str, qp_iters: int | None = None, device="cuda",
                    nit: int | None = None) -> dict:
    """Evaluate ref-tuned and repo-tuned parameter sets for one case, in the
    reference's conditioned frame, on the production engine, at float64
    on ``device``.  ``nit``: the case's steps (None: the case's own)."""
    ref = REF_TUNED[name]
    problem, n_mv = _problem(name, ref, device, nit)
    if qp_iters is not None:
        problem.qp_iters = qp_iters
    # the evaluations take no derivative: no autograd bookkeeping per op
    # (the case set-up above may: Van de Vusse's steady state)
    with torch.inference_mode():
        return _cross_eval_row(name, ref, problem, n_mv, device)


def _cross_eval_row(name, ref, problem, n_mv, device) -> dict:
    out = {"case": name}
    out["ref"] = eval_point(problem, ref.N, ref.Nu, ref.delta, ref.lam)

    repo = None
    npz = REPO_TUNED_REFSCALE.get(name)
    if npz is not None:
        try:
            repo = load_repo_point(npz)
            d, l = repo.delta, repo.lam  # same frame already
            out["repo_frame"] = "reference L/R (refscale run)"
        except FileNotFoundError:
            repo = None
    if repo is None and name in REPO_TUNED:
        try:
            repo = load_repo_point(REPO_TUNED[name])
            d, l = convert_weights(repo, ref.L, ref.R, n_mv)
            out["repo_frame"] = "own CondMin scale, weights frame-converted"
        except FileNotFoundError:
            repo = None
    if repo is not None:
        out["repo"] = eval_point(problem, repo.N, repo.Nu, d, l)
        out["repo_better_vns"] = out["repo"]["F_vns"] <= out["ref"]["F_vns"]
        if name != "VanDeVusse_NMPC":
            # the reference drivers' open-vs-closed horizon sanity check at
            # the tuned horizons (WoodBerry.m:186-251 / Shell7x5.m:242-291).
            # The reference PLOTS this (no numeric gate); both parameter
            # sets' scores are kept for comparison.
            from mpc_tuning_tpu_torch.cases.verify_horizons import \
                verify_horizons

            v_const = problem.v[-1] if problem.v.shape[1] else None
            band = bool(np.any(problem.band_mask))
            vkw = dict(v_const=v_const,
                       engine="band_sim" if band else "pdip",
                       qp_iters=problem.qp_iters, device=device)
            chk = verify_horizons(problem.loop, np.diag(ref.L), int(repo.N),
                                  int(repo.Nu.max()), d, l, **vkw)
            out["horizon_check"] = chk.as_json()
            chk_r = verify_horizons(problem.loop, np.diag(ref.L), int(ref.N),
                                    int(ref.Nu.max()), ref.delta, ref.lam,
                                    **vkw)
            out["horizon_check_ref"] = chk_r.as_json()
    return out


def cross_eval_all(out_json: str | None = None,
                   cases=("Shell3x3", "Shell3x3_caso2", "Shell7x5",
                          "VanDeVusse_NMPC"), device="cuda") -> list[dict]:
    """Every case's row, printed as it comes; ``out_json`` also writes the
    rows there (None: nowhere)."""
    rows = []
    for name in cases:
        r = cross_eval_case(name, device=device)
        rows.append(r)
        print(json.dumps(r), flush=True)
    if out_json:
        with open(out_json, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    import sys

    cross_eval_all(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
