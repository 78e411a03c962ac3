"""Scaling report of the candidate-sharded tuning sweep (the port of the
JAX package's ``parallel/report.py``; BASELINE.md: "tuning sweep evals/s
scaling efficiency").  Three kinds of rows, each labelled:

 1. card rows (``card_rows``, --card): the production tuning workload
    (the Wood-Berry bench shape: nit 400, p_max 127, the whole-sim ADMM
    kernel 'admm_sim' at 40 iterations, float32) at growing candidate
    batches on one card: sims/s, µs a candidate and weak scaling against
    B = 1024.  Per-candidate cost that does not grow with the batch is
    what makes candidate sharding over cards a multiplication of
    per-card throughput.
 2. CPU mesh rows (``cpu_mesh_rows``, --cpu-mesh): the same closed-loop
    batch sharded into 1, 2, 4 CPU shards at a small size; shards on one
    CPU run one after another, so the rows show the sharding's overhead,
    not a speed-up (the tests run them).
 3. the two-process row (``two_process_row``, --two-process): two
    ``torch.distributed`` ranks sharing the card through gloo run one
    tuner alternation at the float32 production shape unsharded and
    sharded (``multihost._alternation_worker``), timed: the
    sharded-over-unsharded overhead.

Each row names its device; nothing is read from ``checkpoints/``.  JSON is
written only where ``--out`` asks for it.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

NIT = 400


def _wb_problem(dtype, qp_iters, device, nit=NIT):
    from mpc_tuning_tpu_torch.cases import woodberry
    from mpc_tuning_tpu_torch.tuning.api import build_problem

    case = (woodberry.make_case(nit=nit) if nit == NIT
            else woodberry.make_case(nit=nit, nbp=5, nbc=3))
    problem, _ = build_problem(case, dtype=dtype, qp_iters=qp_iters,
                               device=device)
    return problem


def _bench_args(problem, B, nit):
    rng = np.random.default_rng(0)
    lo, hi = (16, 64) if nit == NIT else (4, 16)
    return (np.broadcast_to(problem.r[:nit], (B, nit, 2)),
            rng.integers(lo, hi, size=B), rng.integers(2, 7 if nit == NIT
                                                       else 4, size=B),
            rng.uniform(0.2, 2.0, size=(B, 2)),
            rng.uniform(0.01, 0.5, size=(B, 2)))


def _sims_per_s(run, B, device, reps=2) -> float:
    """Candidates a second of ``run()`` (a batch of B), after one warm-up:
    CUDA events on the card, the host clock on the CPU."""
    run()
    if device == "cuda":
        torch.cuda.synchronize()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            run()
        stop.record()
        torch.cuda.synchronize()
        return B / (start.elapsed_time(stop) / 1e3 / reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    return B / ((time.perf_counter() - t0) / reps)


def card_rows(batches=(1024, 2048, 4096, 8192)):
    """The bench shape's sims/s on the card at each batch ('admm_sim', 40
    iterations, float32), with µs a candidate and weak scaling against the
    first batch."""
    if not torch.cuda.is_available():
        raise RuntimeError("card_rows: torch.cuda.is_available() is False")
    problem = _wb_problem(torch.float32, 15, "cuda")
    rows, base = [], None
    for B in batches:
        args = _bench_args(problem, B, NIT)
        caps = problem._caps(args[1], args[2])
        run = lambda: problem.loop.closed_batch(
            args[0], problem.v, *args[1:], NIT, torch.float32, 40,
            engine="admm_sim", device="cuda", caps=caps)
        r = _sims_per_s(run, B, "cuda")
        base = base or r
        rows.append({
            "kind": "card", "card": torch.cuda.get_device_name(0),
            "devices": 1, "batch": B, "caps": list(caps),
            "engine": "admm_sim (40 iterations, float32)",
            "sims_per_s": r, "us_per_candidate": 1e6 / r,
            "weak_scaling_vs_first": r / base})
    return rows


def cpu_mesh_rows(B=8, nit=20, shards=(1, 2, 4)):
    """A float64 closed-loop batch ('pdip_sim', the CPU's plain version)
    through ``TuningProblem.closed_batch`` unsharded and over ``shards``
    CPU shards: sims/s and the overhead against unsharded.  Every sharded
    run must return the unsharded bits."""
    from mpc_tuning_tpu_torch.parallel.sweep import candidate_mesh

    problem = _wb_problem(torch.float64, 10, "cpu", nit=nit)
    args = _bench_args(problem, B, nit)
    rows, ref, r1 = [], None, None
    for k in (None,) + tuple(shards):
        problem.mesh = (None if k is None
                        else candidate_mesh([torch.device("cpu")] * k))
        out = {}
        run = lambda: out.update(Y=problem.closed_batch(*args)[0])
        r = _sims_per_s(run, B, "cpu", reps=1)
        if ref is None:
            ref, r1 = out["Y"], r
        elif not np.array_equal(out["Y"], ref):
            raise AssertionError(f"{k} CPU shards part from unsharded")
        rows.append({"kind": "cpu_mesh", "devices": k or 0, "batch": B,
                     "nit": nit, "sims_per_s": r,
                     "overhead_vs_unsharded": r1 / r - 1.0,
                     "bits_equal_unsharded": True})
    problem.mesh = None
    return rows


def two_process_row(timeout: float = 900.0):
    """Two gloo ranks on the card: one tuner alternation at the float32
    production shape, unsharded then sharded over both ranks
    (``multihost.run_two_process_cpu_selftest(mode="alternation_bench",
    device="cuda")``), with its wall time and the sharded-over-unsharded
    overhead."""
    from mpc_tuning_tpu_torch.parallel.multihost import \
        run_two_process_cpu_selftest

    t0 = time.perf_counter()
    line = run_two_process_cpu_selftest(mode="alternation_bench",
                                        device="cuda", timeout=timeout)
    return parse_two_process_line(line, time.perf_counter() - t0)


def parse_two_process_line(line: str, wall: float) -> dict:
    row = {"kind": "two_gloo_ranks_on_one_card", "processes": 2,
           "ok_line": line, "wall_s_incl_startup": wall,
           "workload": "hybrid_tune, 1 GAM<->VNS alternation, popsize 8 x 2 "
                       "generations, nit 400, nbp/nbc 7/4, qp_iters 15, "
                       "float32"}
    for part in line.split():
        for key in ("wall_unsharded_s", "wall_mesh_s", "mesh_overhead_x"):
            if part.startswith(key + "="):
                row[key] = float(part.split("=")[1])
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--card", action="store_true")
    ap.add_argument("--cpu-mesh", action="store_true")
    ap.add_argument("--two-process", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rows = []
    if args.card:
        rows += card_rows()
    if args.cpu_mesh:
        rows += cpu_mesh_rows()
    if args.two_process:
        rows.append(two_process_row())
    doc = {"rows": rows, "nit": NIT, "workload":
           "Wood-Berry tuning closed loop, p_max 127 / m_max 15"}
    print(json.dumps(doc, indent=1))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(doc, fh, indent=1)


if __name__ == "__main__":
    main()
