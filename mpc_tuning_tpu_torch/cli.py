"""Command-line entry point (the port of the JAX package's ``cli.py``).

  mpc-tuning-run-torch <case> [--nit N] [--nbp B] [--nbc B]
                       [--budget small|full] [--cpu] [--report OUT]
                       [--mesh auto|N]
      run the hybrid tuner on a benchmark case and print the result JSON
      (cases: woodberry, shell3x3, shell7x5, vandevusse)

  mpc-tuning-bench-torch [--batch B] [--method ENGINE] [--qp-iters N]
      the bench (``bench.py``'s rows on the card): one JSON line
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os

import numpy as np
import torch

__all__ = ["run_main", "bench_main", "card_dtype", "mesh_from_arg"]

CASES = ("woodberry", "shell3x3", "shell7x5", "vandevusse")


def card_dtype(case: str):
    """The dtype a run on the card takes: float32 (the JAX package's
    accelerator rule) where the case's entry point accepts it, float64 for
    the band case Shell7x5, whose loops run at float64 only."""
    return torch.float64 if case == "shell7x5" else torch.float32


def mesh_from_arg(arg: str, device: str):
    """``--mesh``: 'auto' shards over every visible card (one shard on the
    CPU), an integer N into N shards, the j-th on card j mod the card
    count (on the CPU all N on the CPU)."""
    from mpc_tuning_tpu_torch.parallel.sweep import candidate_mesh

    if arg == "auto":
        n = torch.cuda.device_count() if device == "cuda" else 1
    else:
        n = int(arg)
    if n < 1:
        raise ValueError(f"--mesh {arg!r}: 'auto' or a positive shard count")
    if device == "cpu":
        return candidate_mesh([torch.device("cpu")] * n)
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("--mesh on the card: torch.cuda.is_available() is "
                           "False; pass --cpu")
    return candidate_mesh([torch.device("cuda", j % cards)
                           for j in range(n)])


def run_main(argv=None):
    ap = argparse.ArgumentParser(
        description="hybrid MPC tuning on the card (PyTorch/CUDA). "
                    "Precision: float64 with --cpu; on the card float32 for "
                    "woodberry, shell3x3 and vandevusse, float64 for "
                    "shell7x5 (band loops run at float64 only).")
    ap.add_argument("case", choices=CASES)
    ap.add_argument("--nit", type=int, default=None)
    ap.add_argument("--nbp", type=int, default=None)
    ap.add_argument("--nbc", type=int, default=None)
    ap.add_argument("--budget", choices=["small", "full"], default="small")
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--state-path", default=None,
                    help="tuning-state JSON for mid-run checkpointing "
                         "(default: <checkpoint-dir>/<case>_tuning_state.json)")
    ap.add_argument("--resume", action="store_true",
                    help="continue a killed run from the state file; "
                         "reproduces the uninterrupted result exactly")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU at float64 (the kernels' plain "
                         "versions); without it the run needs a CUDA card")
    ap.add_argument("--report", default=None,
                    metavar="OUT.html|OUT.png|OUT.npz",
                    help="write the reference drivers' figure sets at the "
                         "tuned parameters (closed loop, open-vs-closed "
                         "horizon verification, tuning history) — "
                         "mpc_tuning_tpu_torch/report.py; .html and .png "
                         "need matplotlib, .npz keeps the figures' inputs "
                         "to render elsewhere (report.render_saved)")
    ap.add_argument("--mesh", default=None, metavar="auto|N",
                    help="shard every candidate evaluation: 'auto' = over "
                         "every visible card, an integer = into N shards "
                         "over the cards in turn (with --cpu, N shards on "
                         "the CPU); tuning/api.mpc_tuning mesh=")
    args = ap.parse_args(argv)
    # a linear case's run takes no derivative: inference mode drops
    # autograd's per-op bookkeeping (the eager PDIP on the CPU ran 1.7x
    # faster).  The NMPC case's steady state differentiates its rhs by
    # forward mode (torch.func), which inference mode does not run.
    linear = args.case != "vandevusse"
    with torch.inference_mode() if linear else contextlib.nullcontext():
        out = _run(args)
    print(json.dumps(out, indent=1))
    return out


def _run(args) -> dict:
    """The tune of ``args.case`` (and its report): the result's JSON dict."""

    device = "cpu" if args.cpu else "cuda"
    dtype = torch.float64 if args.cpu else card_dtype(args.case)
    mesh = None
    if args.mesh:
        mesh = mesh_from_arg(args.mesh, device)
        print(f"# candidate mesh: {mesh.describe()}", flush=True)
    budget = (dict(gam_popsize=8, gam_generations=5, max_alternations=2)
              if args.budget == "small"
              else dict(gam_popsize=16, gam_generations=20, max_alternations=6))

    kw = {}
    if args.nit:
        kw["nit"] = args.nit
    if args.nbp:
        kw["nbp"] = args.nbp
    if args.nbc:
        kw["nbc"] = args.nbc

    state_path = args.state_path
    if state_path is None and args.checkpoint_dir:
        os.makedirs(args.checkpoint_dir, exist_ok=True)
        state_path = os.path.join(args.checkpoint_dir,
                                  f"{args.case}_tuning_state.json")

    if args.case == "vandevusse":
        from mpc_tuning_tpu_torch.cases import vandevusse

        case, res, (y, u) = vandevusse.run(
            checkpoint_dir=args.checkpoint_dir, dtype=dtype, device=device,
            mesh=mesh, **budget, state_path=state_path, resume=args.resume,
            **({"nit": args.nit} if args.nit else {}),
        )
        out = dict(case=args.case, **{k: (v.tolist() if isinstance(v, np.ndarray) else v)
                                      for k, v in res.items() if k != "history"})
        if args.report:
            from mpc_tuning_tpu_torch.report import generate_report

            t = np.arange(len(y)) * case.spec.Ts
            p = generate_report(
                args.report, args.case, t, y, u, r=case.r[: len(y)],
                Yref=case.Yref[: len(y)], history=res["history"],
                summary=dict(N=res["N"], Nu=list(map(int, res["Nu"])),
                             delta=np.round(res["delta"], 4).tolist(),
                             lam=np.round(res["lam"], 4).tolist(),
                             Fvns=res["Fvns"], Fgam=res["Fgam"]))
            out["report"] = p
    else:
        from mpc_tuning_tpu_torch.cases import shell3x3, shell7x5, woodberry
        from mpc_tuning_tpu_torch.tuning.api import mpc_tuning

        mod = {"woodberry": woodberry, "shell3x3": shell3x3,
               "shell7x5": shell7x5}[args.case]
        case = mod.make_case(**kw)
        tkw = dict(budget)
        if args.case == "shell7x5":
            tkw["qp_iters"] = 60
        res = mpc_tuning(case, dtype=dtype,
                         checkpoint_dir=args.checkpoint_dir,
                         state_path=state_path, resume=args.resume,
                         device=device, mesh=mesh, **tkw)
        out = dict(case=args.case, N=res.N, Nu=res.Nu.tolist(),
                   delta=res.delta.tolist(), lam=res.lam.tolist(),
                   Fvns=res.Fvns, Fgam=res.Fgam, checkpoint=res.checkpoint)
        if args.report:
            out["report"] = _linear_report(args, mod, case, res)
    return out


def _linear_report(args, mod, case, res) -> str:
    """The linear cases' report: the final simulation, then the horizon
    verification at float64 on the tuner's device — the closed leg through
    'band_sim' (band cases) or the cold masked PDIP 'pdip' at the tuner's
    QP budget, the open leg through ``MPCLoop.open_loop`` with the case's
    final setpoint and measured disturbance."""
    from mpc_tuning_tpu_torch.report import generate_report

    nit = case.nit
    y, u = mod.final_simulation(case, res)
    prob = res.problem
    Linv = np.linalg.inv(res.L)
    Numax = int(np.max(res.Nu))
    band = bool(np.any(prob.band_mask))
    yc, _ = prob.loop.simulate(prob.r, prob.v, nit, res.N, Numax, res.delta,
                               res.lam, qp_iters=prob.qp_iters,
                               engine="band_sim" if band else "pdip",
                               device=prob.device)
    yo, _ = prob.loop.open_loop(prob.r[nit - 1], prob.v, nit, res.N, Numax,
                                res.delta, res.lam, qp_iters=prob.qp_iters,
                                device=prob.device)
    t = np.arange(nit) * case.Ts
    return generate_report(
        args.report, args.case, t, y, u,
        r=case.Xsp[:nit], Yref=case.Yref[:nit],
        ymin=case.ymin, ymax=case.ymax,
        Yc=(Linv @ np.asarray(yc).T).T,
        Yo=(Linv @ np.asarray(yo).T).T,
        history=res.history,
        summary=dict(N=res.N, Nu=res.Nu.tolist(),
                     delta=np.round(res.delta, 4).tolist(),
                     lam=np.round(res.lam, 4).tolist(),
                     Fvns=res.Fvns, Fgam=res.Fgam))


def bench_main(argv=None):
    """``mpc-tuning-bench-torch``: the port's bench (``bench.main``)."""
    from mpc_tuning_tpu_torch import bench

    bench.main(argv)


if __name__ == "__main__":
    run_main()
