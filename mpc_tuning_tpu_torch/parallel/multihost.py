"""Candidate sharding across processes on ``torch.distributed`` (the port of
the JAX package's ``parallel/multihost.py``).

The reference is a single MATLAB process ('UseParallel', false,
MPCTuning.m:89); this is the scale-out half.  The tuning workload is an
embarrassingly parallel candidate grid, so:

 * every process runs the same tuner (SPMD: the same case, budget and
   seed) and builds the same global candidate batches;
 * the batch is padded and cut into ``mesh.size`` shards; each process
   evaluates only its own shards (``host_mesh``: its local devices) on
   the hand-written kernels, and the outputs (Y, U) are all-gathered as
   equal-sized padded tensors, so every process takes the same decisions;
 * the incumbent reduction (``multihost_candidate_argmin``) is an
   all-reduce MIN of the value, then an all-reduce MAX of the negated
   global index of the processes holding it: (min, its lowest index),
   identical on every process.

Backends: "nccl" when each process has a card of its own; "gloo" for CPU
processes and for processes that share one card (NCCL refuses two ranks on
one device).  The caller names the backend; nothing falls back.

Validation on one host: ``python -m mpc_tuning_tpu_torch.parallel.multihost
--two-process-selftest [--mode sweep|alternation|alternation_bench]
[--device cpu|cuda]`` spawns the processes against a local address.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from mpc_tuning_tpu_torch.parallel.sweep import (CandidateMesh,
                                                 global_argmin_shard_map)

__all__ = [
    "initialize",
    "host_mesh",
    "multihost_candidate_argmin",
    "run_two_process_cpu_selftest",
]

BACKENDS = ("gloo", "nccl")


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, backend: str) -> None:
    """``torch.distributed.init_process_group`` against
    ``coordinator_address`` ("host:port", or a full init-method URL) as
    process ``process_id`` of ``num_processes``.  ``backend`` is "gloo" or
    "nccl" (see the module note); with "nccl" the process's card is
    ``cuda:<process_id mod the visible cards>``."""
    import torch.distributed as dist

    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)


def host_mesh(devices=None) -> CandidateMesh:
    """The mesh of the initialized process group: this process's local
    shards ``devices`` (default: its current card, or the CPU on a host
    without one), every process holding as many, in rank order."""
    import torch.distributed as dist

    if devices is None:
        devices = ([torch.device("cuda", torch.cuda.current_device())]
                   if torch.cuda.is_available() else [torch.device("cpu")])
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, len(devices))
    if len(set(counts)) != 1:
        raise ValueError(f"processes hold unequal shard counts {counts}")
    return CandidateMesh(tuple(torch.device(d) for d in devices),
                         process_count=dist.get_world_size(),
                         process_index=dist.get_rank(), distributed=True)


def multihost_candidate_argmin(mesh: CandidateMesh, local_eval_fn,
                               global_args, B_true: int):
    """Evaluate a candidate grid sharded over every process of ``mesh``
    and reduce to the global (min value, argmin index).

    local_eval_fn(*local_shards) -> (B_local,) objective values, the
    shards as tensors on their device.  global_args: NumPy arrays with the
    candidate axis first, IDENTICAL on every process.  Padded lanes
    (index >= B_true) are +inf.  Returns (vmin, gidx), identical on every
    process."""
    return global_argmin_shard_map(mesh, local_eval_fn, global_args, B_true)


# ----------------------------------------------------------- self-tests


def _shard_devices(device: str, backend: str):
    """A self-test process's shards: two on the CPU (shards within and
    across processes), one card otherwise."""
    if device == "cpu":
        return [torch.device("cpu")] * 2
    if backend == "nccl":
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", 0)]  # gloo ranks sharing the first card


def _selftest_worker(coordinator: str, nprocs: int, pid: int, device: str,
                     backend: str, bench_B: int = 0,
                     bench_nit: int = 0) -> None:
    """One process of the sweep self-test: a Wood-Berry candidate grid
    (float32, 'pdip_sim') sharded over every process, reduced by
    ``multihost_candidate_argmin``, and held against the same grid
    evaluated whole in this process.  Default shape tiny; bench_B /
    bench_nit run and time the bench shape."""
    initialize(coordinator, nprocs, pid, backend)
    from mpc_tuning_tpu_torch.cases import woodberry
    from mpc_tuning_tpu_torch.tuning.api import build_problem

    mesh = host_mesh(_shard_devices(device, backend))
    bench = bench_B > 0
    nit = bench_nit if bench else 20
    case = (woodberry.make_case(nit=nit) if bench
            else woodberry.make_case(nit=nit, nbp=4, nbc=2))
    problem, _ = build_problem(case, dtype=torch.float32,
                               qp_iters=15 if bench else 10, device=device)
    B = bench_B if bench else 2 * mesh.size
    rng = np.random.default_rng(0)
    r_b = np.broadcast_to(problem.r[:nit], (B, nit, 2))
    N_b = rng.integers(16, 64, size=B) if bench else np.arange(B) % 4 + 8
    Nu_b = np.full(B, 3)
    delta_b = np.ones((B, 2))
    lam_b = np.full((B, 2), 0.1)
    caps = problem._caps(N_b, Nu_b)
    Yref = problem.Yref[:nit]

    def sse(dev, r, N, Nu, d, l):
        Y, _ = problem.loop.closed_batch(r, problem.v, N, Nu, d, l, nit,
                                         torch.float32, problem.qp_iters,
                                         engine="pdip_sim", device=dev,
                                         caps=caps)
        err = Y.double().cpu().contiguous() - torch.as_tensor(Yref)[None]
        return (err * err).sum((1, 2))

    def local_eval(r, N, Nu, d, l):
        host = lambda t: t.cpu().numpy()
        return sse(r.device, *map(host, (r, N, Nu, d, l)))

    argl = [r_b, N_b, Nu_b, delta_b, lam_b]
    vmin, gidx = multihost_candidate_argmin(mesh, local_eval, argl, B)
    rate = ""
    if bench:  # a timed second pass (the first built the kernels)
        t0 = time.perf_counter()
        vmin, gidx = multihost_candidate_argmin(mesh, local_eval, argl, B)
        rate = f" sims_per_s={B / (time.perf_counter() - t0):.1f}"
    whole = sse(mesh.devices[0], *argl).numpy()
    assert np.isfinite(vmin), vmin
    assert 0 <= gidx < B, gidx
    assert gidx == int(np.argmin(whole)) and vmin == float(whole.min()), (
        gidx, vmin, int(np.argmin(whole)), float(whole.min()))
    if pid == 0:
        print(f"MULTIHOST_OK procs={nprocs} devices={mesh.size} "
              f"backend={backend} device={device} best={gidx} "
              f"objective={vmin:.6g} equals_whole=1{rate}", flush=True)


def _alternation_worker(coordinator: str, nprocs: int, pid: int,
                        device: str, backend: str,
                        bench: bool = False) -> None:
    """One process of the tuner self-test: one GAM <-> VNS alternation of
    the Wood-Berry case (``hybrid_tune``) runs unsharded, then with
    ``problem.mesh`` sharded over every process; the decisions (N, Nu,
    delta, lambda) must be identical and F within 1e-12 (float64) or 1e-6
    (``bench``: the float32 production shape nit 400, nbp/nbc 7/4,
    qp_iters 15, popsize 8 x 2 generations, both legs timed)."""
    initialize(coordinator, nprocs, pid, backend)
    from mpc_tuning_tpu_torch.cases import woodberry
    from mpc_tuning_tpu_torch.tuning.api import build_problem, hybrid_tune

    if bench:
        case = woodberry.make_case(nit=400)
        problem, _ = build_problem(case, dtype=torch.float32, qp_iters=15,
                                   device=device)
        kw = dict(gam_popsize=8, gam_generations=2)
    else:
        case = woodberry.make_case(nit=40, nbp=4, nbc=2)
        problem, _ = build_problem(case, dtype=torch.float64, qp_iters=10,
                                   device=device)
        kw = dict(gam_popsize=4, gam_generations=2)
    kw.update(max_alternations=1, seed=0, verbose=False, final_polish=False,
              joint_polish=False)
    x0 = np.concatenate([case.ov_weight0, case.mvrate_weight0])

    def tune():
        t0 = time.perf_counter()
        out = hybrid_tune(problem, case.nbp, case.nbc, x0, **kw)
        if device == "cuda":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (best_r, d_r, l_r, F_r, _, _), t_ref = tune()
    problem.mesh = host_mesh(_shard_devices(device, backend))
    (best_s, d_s, l_s, F_s, _, _), t_mesh = tune()
    assert best_s["N"] == best_r["N"], (best_s["N"], best_r["N"])
    assert np.array_equal(best_s["Nu"], best_r["Nu"]), (best_s["Nu"],
                                                        best_r["Nu"])
    assert np.array_equal(d_s, d_r), (d_s, d_r)
    assert np.array_equal(l_s, l_r), (l_s, l_r)
    ftol = 1e-6 if bench else 1e-12
    assert abs(F_s - F_r) <= ftol * max(1.0, abs(F_r)), (F_s, F_r)
    if pid == 0:
        extra = (f" wall_unsharded_s={t_ref:.2f} wall_mesh_s={t_mesh:.2f} "
                 f"mesh_overhead_x={t_mesh / max(t_ref, 1e-9):.3f}"
                 if bench else "")
        print(f"MULTIHOST_TUNE_OK procs={nprocs} devices="
              f"{problem.mesh.size} backend={backend} device={device} "
              f"N={best_s['N']} Nu={np.asarray(best_s['Nu']).tolist()} "
              f"objective={F_s:.10g} objective_unsharded={F_r:.10g} "
              f"decisions_identical=1{extra}", flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_two_process_cpu_selftest(nprocs: int = 2, timeout: float = 900.0,
                                 bench_B: int = 0, bench_nit: int = 0,
                                 mode: str = "sweep", device: str = "cpu",
                                 backend: str = "gloo") -> str:
    """Spawn ``nprocs`` processes that join one process group at a local
    address and run one self-test: ``mode`` 'sweep' (a sharded sweep and
    the argmin reduction, ``_selftest_worker``), 'alternation' (one tuner
    alternation, sharded against unsharded, float64) or
    'alternation_bench' (the same at the float32 production shape, timed).
    ``device`` "cuda" puts every process on the card (gloo: the processes
    share the first card; nccl: one card each).  Returns the OK line;
    raises with the processes' output otherwise."""
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.setdefault("OMP_NUM_THREADS", "1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mpc_tuning_tpu_torch.parallel.multihost",
         "--worker", "--coordinator", coord, "--nprocs", str(nprocs),
         "--pid", str(pid), "--bench-B", str(bench_B), "--bench-nit",
         str(bench_nit), "--mode", mode, "--device", device, "--backend",
         backend],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(nprocs)]
    outs, ok = [], True
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(1.0,
                                               deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            ok = False
        outs.append(out)
        ok = ok and p.returncode == 0
    joined = "\n".join(outs)
    tag = ("MULTIHOST_TUNE_OK" if mode.startswith("alternation")
           else "MULTIHOST_OK")
    if not ok or tag not in joined:
        raise RuntimeError(f"multihost self-test failed:\n{joined}")
    return next(l for l in joined.splitlines() if l.startswith(tag))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--two-process-selftest", action="store_true")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--pid", type=int, default=0)
    ap.add_argument("--bench-B", type=int, default=0)
    ap.add_argument("--bench-nit", type=int, default=0)
    ap.add_argument("--mode",
                    choices=["sweep", "alternation", "alternation_bench"],
                    default="sweep")
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cpu")
    ap.add_argument("--backend", choices=BACKENDS, default="gloo")
    args = ap.parse_args(argv)
    if args.worker:
        torch.set_num_threads(1)
        try:
            if args.mode.startswith("alternation"):
                _alternation_worker(args.coordinator, args.nprocs, args.pid,
                                    args.device, args.backend,
                                    bench=args.mode == "alternation_bench")
            else:
                _selftest_worker(args.coordinator, args.nprocs, args.pid,
                                 args.device, args.backend, args.bench_B,
                                 args.bench_nit)
        finally:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
    elif args.two_process_selftest:
        print(run_two_process_cpu_selftest(
            nprocs=args.nprocs, bench_B=args.bench_B,
            bench_nit=args.bench_nit, mode=args.mode, device=args.device,
            backend=args.backend))
    else:
        ap.error("choose --worker or --two-process-selftest")


if __name__ == "__main__":
    main()
