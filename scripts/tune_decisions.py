"""Where a tune parts when one kernel is swapped for the design it
replaced, on one card: a tune of ``chip_smoke.py`` run twice, every VNS
objective call recorded with its candidates (per-input control horizons)
and F at full precision, and each VNS search's decisions replayed from
them (the first candidate with F below the incumbent's,
``tuning/vns.vns_search``).

    PYTHONPATH=.:scripts python scripts/tune_decisions.py band --old DIR \\
        [--out FILE]
    PYTHONPATH=.:scripts python scripts/tune_decisions.py shell3x3 \\
        [--out FILE]

``band``: the Shell7x5 band tune of phase 3b (float64, popsize 8, 3
generations, 1 alternation, qp_iters 60, seed 0) with this tree's band
kernel and with a build of the block-per-candidate design (``--old``: its
``ops/csrc``, as ``scripts/band_old_vs_new.py`` takes it); ``shell3x3``:
the Shell3x3 tune of phase 3c (per-step engines, float32, nit S3_NIT, no
joint polish) with this tree's ``spd_factor_solve`` and with its
one-thread design (``ops/csrc/reference``).  Prints each run's result,
then the first objective call at which the two runs' candidates or
decisions differ: the incumbent's F and the pick in each run, and for
the picks and the candidates whose F lies within 1e-5 (relative) of the
incumbent's, their horizons and F in both runs.  ``band`` then holds
this tree's band kernel step by step by the LP certificate
(``ops/band_cert.hold``) on the closed loop that call scores for this
tree's pick.  Needs one card and nvcc (band about five minutes,
shell3x3 one).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess

import numpy as np
import torch

import chip_smoke as cs
from mpc_tuning_tpu_torch.cases import shell3x3, shell7x5
from mpc_tuning_tpu_torch.ops import _build, band_cert, qp
from mpc_tuning_tpu_torch.ops import kernels as K
from mpc_tuning_tpu_torch.sim import mpc_loop
from mpc_tuning_tpu_torch.tuning import api, objectives, vns


def band_tune():
    res = api.mpc_tuning(shell7x5.make_case(), dtype=torch.float64,
                         device="cuda", qp_iters=60, gam_popsize=8,
                         gam_generations=3, max_alternations=1, seed=0,
                         checkpoint_dir=None, verbose=False)
    return dict(N=int(res.N), Nu=np.asarray(res.Nu).tolist(),
                Fvns=float(res.Fvns), problem=res.problem)


def shell3x3_tune():
    case = shell3x3.make_case(nit=cs.S3_NIT)
    problem, _ = api.build_problem(case, dtype=torch.float32, qp_iters=15,
                                   device="cuda")
    problem.qp_method, problem.vns_qp_method = "pdip_ws_fused", "admm_fused"
    problem.admm_iters = 40
    x0 = np.concatenate([case.ov_weight0, case.mvrate_weight0])
    best, _, _, Fvns, _, _ = api.hybrid_tune(
        problem, case.nbp, case.nbc, x0, gam_popsize=8, gam_generations=3,
        max_alternations=1, seed=0, verbose=False, joint_polish=False)
    return dict(N=int(best["N"]), Nu=np.asarray(best["Nu"]).tolist(),
                Fvns=float(Fvns), problem=problem)


def recorded(tune):
    """``tune()``'s result and, per VNS objective call, its candidates, F
    and, inside a VNS search, the incumbent's F and the pick (None: no
    improvement)."""
    calls, state = [], {}
    objective, neighborhood, search = (objectives.vns_objective_batch,
                                       vns._neighborhood, vns.vns_search)

    def hood(Xv1, Xv2, order):
        cands = neighborhood(Xv1, Xv2, order)
        state["cands"] = [(vns.bits_to_int(x1),
                           [vns.bits_to_int(r) for r in x2])
                          for x1, x2 in cands]
        return cands

    def searched(problem, Xv1, Xv2, delta, lam, Fv, *a, **kw):
        state["Fv"] = Fv
        try:
            return search(problem, Xv1, Xv2, delta, lam, Fv, *a, **kw)
        finally:
            state.pop("Fv")

    def record(problem, N_b, Nu_b, delta, lam, *a, **kw):
        out = objective(problem, N_b, Nu_b, delta, lam, *a, **kw)
        F = np.asarray(out[0] if kw.get("return_parts") else out)
        row = dict(N=np.asarray(N_b).tolist(), Nu=np.asarray(Nu_b).tolist(),
                   delta=np.asarray(delta).tolist(),
                   lam=np.asarray(lam).tolist(), F=F.tolist())
        if "Fv" in state:  # vns_search's own test, on its own candidates
            dmin = int(np.max(problem.dmin))
            ok = np.array([N > max(Nu) and N != 0 and min(Nu) > 1
                           and N > dmin for N, Nu in state["cands"]])
            better = np.where(ok & np.isfinite(F) & (F < state["Fv"]))[0]
            row.update(cands=state["cands"], Fv=state["Fv"],
                       pick=int(better[0]) if len(better) else None)
            if len(better):
                state["Fv"] = float(F[better[0]])
        calls.append(row)
        return out

    vns._neighborhood, vns.vns_search = hood, searched
    api.vns_search = searched
    vns.vns_objective_batch = api.vns_objective_batch = record
    objectives.vns_objective_batch = record
    try:
        res = tune()
        torch.cuda.synchronize()
    finally:
        vns._neighborhood, vns.vns_search = neighborhood, search
        api.vns_search = search
        vns.vns_objective_batch = api.vns_objective_batch = objective
        objectives.vns_objective_batch = objective
    return res, calls


def first_parting(a, b):
    """The index of the first call whose candidates or pick differ between
    the two runs' records (None if they never do).  The weights are not
    compared (printed at the parting)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if any(x.get(k) != y.get(k) for k in ("N", "Nu", "cands", "pick")):
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def certify(problem, call, pick):
    """The per-step certificate of this tree's band kernel on the closed
    loop that ``call`` scores for candidate ``pick`` (B = 1)."""
    nit = problem.nit
    N, Nu = call["N"][pick], call["Nu"][pick]
    delta = np.asarray(call["delta"]).reshape(-1)
    lam = np.asarray(call["lam"]).reshape(-1)
    r_b = np.broadcast_to(problem.r[:nit], (1, nit, problem.my))
    t, lc, Hp, r_l, dims = problem.loop.sim_inputs(
        r_b, problem.v, [N], [Nu], delta[None], lam[None], nit,
        torch.float64, "band_sim", "cuda")
    _, U, E = K.closed_sim_band(t, lc, Hp, r_l, nit, 20, 12, dims)
    with band_cert.certify_pool(8) as pool:
        return band_cert.hold(problem, N, Nu, delta, lam,
                              U[:, :, 0].cpu().numpy(),
                              E[:, 0].cpu().numpy(), caps=(N, Nu), pool=pool)


def swapped(which, old):
    """(tune, a context-free swap to the replaced design, its undo)."""
    if which == "band":
        from band_old_vs_new import build_old, old_band

        lib = build_old(old)

        def band(tables, lane_consts, Hp_t, r_l, nit, lp_iters, s2_iters,
                 dims):
            return old_band(lib, tables, lane_consts, Hp_t, r_l, nit,
                            lp_iters, s2_iters, dims)

        kept = mpc_loop.closed_sim_band
        return (band_tune,
                lambda: setattr(mpc_loop, "closed_sim_band", band),
                lambda: setattr(mpc_loop, "closed_sim_band", kept))
    kept = qp.spd_factor_solve
    return (shell3x3_tune,
            lambda: setattr(qp, "spd_factor_solve",
                            K.spd_factor_solve_one_thread),
            lambda: setattr(qp, "spd_factor_solve", kept))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("tune", choices=("band", "shell3x3"))
    ap.add_argument("--old", type=pathlib.Path,
                    help="band: the block-per-candidate ops/csrc")
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args()
    if args.tune == "band" and args.old is None:
        ap.error("band needs --old")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    _build.library()
    _build.reference_library()
    tune, swap, undo = swapped(args.tune, args.old)
    runs = {}
    for name in ("new", "old"):
        if name == "old":
            swap()
        try:
            res, calls = recorded(tune)
        finally:
            undo()
        runs[name] = dict(res, calls=calls)
        print(f"[{name}] N={res['N']} Nu={res['Nu']} Fvns={res['Fvns']!r}, "
              f"{len(calls)} objective calls", flush=True)
    new, old = runs["new"]["calls"], runs["old"]["calls"]
    i = first_parting(new, old)
    out = dict(card=card, tune=args.tune, parting=i,
               **{k: {kk: v for kk, v in r.items()
                      if kk not in ("problem", "calls")}
                  for k, r in runs.items()})
    if i is not None:
        x, y = new[i], old[i]
        Fv = x.get("Fv")
        near = {j for j, f in enumerate(x["F"]) if Fv is not None
                and abs(f - Fv) <= 1e-5 * abs(Fv)}
        near |= {p for p in (x.get("pick"), y.get("pick")) if p is not None}
        rows = [dict(j=j, horizons=x["cands"][j] if "cands" in x else None,
                     F_new=x["F"][j],
                     F_old=y["F"][j] if j < len(y["F"]) else None)
                for j in sorted(near)]
        dw = max(float(np.max(np.abs(np.subtract(x[k], y[k]))))
                 for k in ("delta", "lam"))
        print(f"first parting at objective call {i} of {len(new)}: "
              f"incumbent F new {x.get('Fv')!r} old {y.get('Fv')!r}; pick "
              f"new {x.get('pick')} old {y.get('pick')}; weights differ by "
              f"{dw:.3e}; the picks and the candidates within 1e-5 of the "
              f"incumbent: {json.dumps(rows)}", flush=True)
        out.update(call_new=x, call_old=y, near=rows)
        if args.tune == "band":
            pick = next((p for p in (x.get("pick"), y.get("pick"))
                         if p is not None), int(np.argmin(x["F"])))
            out["cert"] = certify(runs["new"]["problem"], x, pick)
            print(f"certificate of this tree's kernel on call {i}'s "
                  f"candidate {pick} (N {x['N'][pick]}, Nu {x['Nu'][pick]}): "
                  f"{json.dumps(out['cert'])}", flush=True)
    if args.out:
        args.out.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
