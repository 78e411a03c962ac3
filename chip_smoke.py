"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py            # needs one card; about 15 minutes

Phases, each printing one line (with its wall time):
 1. environment: the card (nvidia-smi name and power limit), torch and CUDA
    versions, and the build of the port's CUDA kernels (one nvcc per
    source, started together);
 2. every kernel of the main paths against its plain PyTorch version on
    the card, the whole-sim kernels step by step (the plain version
    following the kernel's inputs, ``follow_plain``):
    2a the Wood-Berry kernels in float64 and float32 (caps (64,8) and
       (127,15), nit=30, cut from the case's 400 steps to make room for the
       later rows; the whole-sim kernels at B = 1024, the tunes' B = 2 and
       a ragged B = 37 (one warp a lane, 4 or 2 lanes a block);
       SPD factor/solve at n = 5, 17, 31 and 46
       (two rows a lane, over 48 KB of shared memory), each at B = 1024
       and at a ragged B = 37, the solve also beside the one-thread design
       it replaced (reported); spd_solve on the same systems bit for bit
       against spd_factor_solve(spd_factor(M)), and beside its one-thread
       design (reported));
    2b the band kernel on Shell7x5 in float64, the only dtype band cases
       run at (caps (32,4), (127,2), (127,15), B=256, nit=50, the seeded
       candidates of tools/band_spread.band_inputs), held at twice what
       two correct runs differ by along the kernel's own U, measured in
       the same run (tools/band_spread.band_witness / band_gate: the plain
       version following the kernel's U moved one ulp up and down, and
       reordered: its rows and later variables in reverse order); then
       held step by step by the LP certificate (ops/band_cert.hold: every
       step's slack at the LP minimum, the first move where du is well
       posed) at the reference's tuned point and on two seeded lanes, and
       on each bucket's tightest lane relative to correct runs of the
       plain solve chain on the same QPs, step by step
       (ops/band_cert.hold_relative); the certificate's host work a task a
       lane in the CPU workers (cpu_pool), its line printed after 3i;
    2c the per-step engines' kernels in float64 and float32: the lane-major
       factor/solve at n = 7, 17, 46 (B = 1024 and 37) and the
       single-solve PDIP and ADMM kernels on one real Shell3x3 step's QPs
       (caps (32,4), (127,15), B=1024), held at QP_LIMITS, fixed from what
       two correct runs differ by; the warp-per-lane admm_fused also bit
       for bit against the one-thread design it replaced (B = 1024, 37);
       the lane_sum kernel (ops/qp.lane_sum's lane-major sums) at 181 rows,
       B = 1024 and 37, within rows ulps of each lane's sum of |x| of its
       plain version, a prefix of lanes the whole batch's bits;
    2d the NMPC slice's kernels in float64 and float32: spd_solve at n = 5,
       17, 31; nmpc_rollout with each of its steppers, RK4 and TR-BDF2 (Y
       and its Jacobian J, the plant step, the held playback) on 256
       seeded Van de Vusse states at caps (31,15) and (16,2) (the tune's
       mask spread over the inputs) and at the explicit NMPC's shape (N 5,
       per-input Nu (2, 1), 6 substeps; explicit_rollout_args), float32 at
       ROLLOUT_F32_LIMITS / ROLLOUT_TRBDF2_F32_LIMITS, fixed from what two
       correct runs differ by; one float64 NMPC closed-loop batch for each
       integrator (B = 32, nit 10, caps (16,4)) on the card, held step by
       step against the plain loop on the CPU (in a worker);
 3. the first main path: a seeded Wood-Berry hybrid tune in float32 on the
    card through ``mpc_tuning``, the bench's tune row (bench.tune_row:
    bench.py's budget), with every kernel's launch count, the tune's last
    batch of each whole-sim kernel against the plain version, a validity
    check of the result and its closed-loop outputs against the float64
    plain version on the CPU (bench.hold_tune);
 3b. the band main path: a seeded Shell7x5 hybrid tune in float64 on the
    card (the full case: nit 200, nbp/nbc 7/4), launch counts, its last
    band batch against the plain version at 2b's live gate (the plain
    band loops, host-bound, in their own process on the card beside
    3k-3i: band_hold_card; the line prints after 3i), a validity check of
    the result and of ``shell7x5.final_simulation`` on the card;
 3c. the per-step engines' path: a seeded Shell3x3 hybrid tune in float32
    on the card (the case cut to its first 250 steps, nbp/nbc 7/4;
    S3_NIT) through
    ``hybrid_tune`` with GAM 'pdip_ws_fused' and VNS 'admm_fused' (no
    joint weight polish), ``shell3x3.final_simulation`` on the card at
    float64 inside the input bounds, the tuned incumbent's VNS
    neighbourhood re-scored at float64 through 'pdip_ws_lanes' on the card
    against the same on the CPU, launch counts, and the tune's last batch
    of each engine against the plain step loop, as it ran (float32) and
    on its inputs cast to float64;
 3d. the NMPC path: a seeded Van de Vusse hybrid tune in float64 on the
    card (the full case: nit 60, nbp/nbc 5/4, substeps 10, SQP 4, QP 25,
    RK4; no joint weight polish), launch counts, its last closed-loop
    batch against the plain loop on the CPU (Y over every step, U over
    the windows NMPC_HOLD_WINDOWS) at F64_SIM_GATE, and the tuned
    controller's closed loop inside the input bounds with Cb ending at its
    setpoint, printed beside the reference's own tuning;
 3k. the stiff NMPC path: 3d's tune and checks with the case's
    integrator set to TR-BDF2 (make_case(integrator="tr_bdf2"), the
    reference's ode15s case), its last batch held at
    NMPC_TRBDF2_HOLD_GATE; printed beside 3d's RK4 result.  Both tunes
    and their final closed loops run each in its own process on the card
    (start_card_process) beside phases 2-3b, their lines print after 3b;
    so their walls are taken on a card and host that 2-3b share (each
    tune's wall alone: scripts/ab_tune_walls.py ROOT --nmpc);
 3e. spd_solve's own path, its public entry point (no tune calls it),
    and its refusal above the envelope (n = 65);
 3f. the open-vs-closed horizon check (cases/verify_horizons) of the
    tunes of 3, 3b and 3c on the card at float64 (the tracking closed leg
    the cold PDIP 'pdip', as the JAX package's check), against the same on
    the CPU (tracking legs at HORIZON_GATE; band legs at phase 2b's Y
    limit, the closed leg along the card's U);
 3g. the DTC-GPC Wood-Berry closed loop (bench.py's shapes cut to B = 256, nit
    400) at float64 and float32: lanes bit-identical, the replay oracle,
    float32 against float64, the tracking checks;
 3h. the explicit NMPC Van de Vusse demo (nit 100, three lanes; in its
    own process on the card beside 3j-3f; its prediction, offset model
    and plant step through nmpc_rollout) against the same loop on the
    CPU and the staircase checks;
 3i. the front end: the batch-major scan engines 'pdip', 'pdip_ws',
    'pdip_dense' and 'admm' on Wood-Berry (B = 8, nit 60, f64) step by
    step against the plain loop on the CPU following their U; the
    cross-evaluation (cases/cross_eval.cross_eval_all, in its own process
    on the card beside 3j-3h) at the cases' full
    sizes with the claims of tests/test_cross_eval.py, its Shell3x3 rows
    against the CPU's; the fixed-tuning demos (cases/demos) against the
    CPU with their sims/s (utils/profiling.rate_of); the CLI (cli.run_main)
    on a small Wood-Berry tune with its report, then --resume.
    The CPU runs that hold 2d's closed loops, 3d, 3k, 3f, 3h and 3i run
    in spawned worker processes (cpu_pool, started after phase 1; 3i's
    demos and cross-evaluation rows, which need nothing from the card,
    after 2b) beside the card's phases; their lines print once
    collected, after 3i;
 3j. candidate sharding (parallel/): (a) phase 3's Wood-Berry tune, its
    budget and seed, on two shards of the card
    (``candidate_mesh(["cuda:0", "cuda:0"])``): phase 3's N, Nu, delta and
    lambda exactly and Fvns within 1e-6 relative, with the launch counts
    of both runs; (b) a Shell7x5 band batch (float64, B = 8, (48, 4), nit
    200) and a Van de Vusse closed batch (float64, B = 8, nit 60) over two
    shards, bit for bit the whole batches ((a) and (b) host-bound, in
    their own process on the card started after 3, beside 3b-3i; the line
    prints after 3i, so the sharded tune's wall is taken on a card and
    host that those phases share); (c) two gloo
    ranks on the card running one tuner alternation at the float32
    production shape unsharded and sharded (MULTIHOST_TUNE_OK) and one
    single-rank NCCL group reducing a B = 256 sweep through
    multihost_candidate_argmin, started as process groups before 3d
    (beside the host-bound phases) and collected before phase 4;
 4. throughput of each kernel, its plain version and, where one PyTorch
    call computes the same function, that call (recorded, not gated), one
    evaluation through each per-step engine beside the whole-sim kernel
    of the same algorithm, and one NMPC closed-loop evaluation with its
    launches and device time.  The whole-sim kernels are timed at the
    bench shapes and at the batch sizes the tunes launch (ADMM_SHAPES,
    PDIP_SHAPES, BAND_SHAPES), each with its device time and bound.  The
    two SPD factor kernels and spd_factor_solve are timed at
    FACTOR_SHAPES: float32 B=1024 n=17 and the float64 batches the tunes
    launch, (B, n) = (8, 5), (36, 31), (141, 46), each beside
    torch.linalg.cholesky_ex (the solve: torch.cholesky_solve, and the
    one-thread design it replaced) and the plain version, by CUDA events
    and by device time (torch.profiler).  spd_solve beside its one-thread
    design at float32 B=1024 n=17 and float64 B=1024 n=31; DTC-GPC sims/s
    and the explicit NMPC loop's seconds; parallel/report.card_rows (the
    bench shape's sims/s at B = 1024-8192, a record).  nmpc_rollout at
    float64 B = 256 (31, 15) with J with each stepper, a row each under
    'shapes' with its launches on the main path (RK4's at the top level,
    3h's among them), and each stepper with J and without, beside the
    thread-per-column design it replaced, at (31, 15) and (16, 2), B = 8,
    64 and 256 ('timings'); the lane_sum kernel at 181 rows beside its
    plain version and torch's column sum;
 4b. the bench (mpc_tuning_tpu_torch/bench.py, bench.run_rows): bench.py's
    rows on the card, one timed run each after its warm-up, nothing else
    running (DTC-GPC B 1024; the Wood-Berry headline 'admm_sim' B 8192
    (64, 8); the GAM row 'pdip_sim' B 2048 (32, 4); the Shell7x5 band row
    B 256 at float64; the single-QP p50; the Van de Vusse row B 256 nit 60
    at float32, the NMPC loop's whole evaluation; the tune row is phase
    3's); then each row's first 8 lanes held against its plain version,
    all at once in the CPU workers; prints the bench's JSON line
    (bench.bench_line).
Then one JSON line with the per-kernel record, the card's line, and as the
last line ``{"ok": true, "device": {...}}`` (the bench's JSON line comes
earlier, in 4b).  Any failed phase exits
non-zero before that line.
"""

from __future__ import annotations

import itertools
import json
from concurrent.futures import ThreadPoolExecutor
import subprocess
import sys
import time

import numpy as np
import torch

F64_SIM_GATE = 1e-9      # max |dY|, |dU| kernel vs plain, float64 (NMPC: scaled)
F64_SPD_GATE = 1e-10     # max |dL|, |dx|, float64
F32_SIM_GATE = 1e-3      # max |dY|, |dU|, float32
F32_SPD_GATE = 1e-4      # max |dL| / max |L|, max |dx| / max |x|, float32
# float32 PDIP over random candidates: U within F32_SIM_GATE on the median
# lane, and within two move limits (2 x dumax = 0.1: two answers that both
# keep |du| <= 0.05 differ by no more) on every lane
F32_PDIP_U_CAP = 0.1
LOOP_GATE = 1e-2         # tuned closed loop y: float32 card vs float64 CPU
# Band rows: float64 only (band cases refuse float32).  du is ill-posed on
# degenerate band steps, so two correct float64 runs of the same loop
# differ there, by an amount that depends on the trajectory; the limits
# (tools/band_spread.band_gate) are twice what two correct runs differ by
# along the kernel's own U, per lane statistic and lane quantile, measured
# in the same run.
U_BOUND = 0.5            # Shell7x5 |u| limit (raw units)
# Single QP solves (phase 2c) on identical inputs, the kernel against its
# plain version on the card: per-lane max |dz| and max |dlam| /
# max(1, |lam|) (ADMM: x and its duals y), held at lane quantiles p50 /
# p90 / p99 / max.  Each limit is twice the largest of what two correct
# runs differ by (the plain version on the card against the same on the
# CPU; the plain version on the card with the constraint rhs one ulp up
# against one ulp down) over both buckets, rounded up to two digits, as
# phase 2c printed them on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md
# §6; the pdip_fused rows anew for the warp-per-lane kernel, from the
# witnesses of the plain version whose sums run lane by lane,
# ops/qp.lane_sum).  The first move du, which the loop applies, is held
# at F64_SIM_GATE on every lane at float64.
QP_LIMITS = {
    ("pdip_fused", "f64"): dict(z=(1.4e-12, 2.3e-10, 1.1e-9, 1.9e-9),
                                lam=(2.0e-7, 4.6e-5, 2.2e-4, 3.8e-4)),
    ("admm_fused", "f64"): dict(z=(5.9e-14, 2.8e-13, 4.7e-13, 6.0e-13),
                                lam=(5.2e-17, 3.4e-15, 9.6e-15, 4.2e-14)),
    ("pdip_fused", "f32"): dict(z=(2.3e-4, 2.0e-3, 6.3e-3, 5.9e-2),
                                lam=(9.3e-3, 0.25, 1.2, 2.1)),
    ("admm_fused", "f32"): dict(z=(3.0e-5, 1.4e-4, 2.5e-4, 3.4e-4),
                                lam=(2.9e-8, 1.7e-6, 4.5e-6, 8.7e-6)),
}

# peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s; FLOP/s in
# float32 (outside the tensor cores) and float64 (the FP64 tensor cores,
# which compute true float64: the band normal matrix is a GEMM-shaped
# product that could run on them)
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}
# float64 outside the tensor cores (NVIDIA data sheet, H100 SXM): the
# rollout's arithmetic is scalar chains, nothing GEMM-shaped
FP64_SIMT_FLOPS = 33.5e12

SOURCES = {
    "spd_factor": ("mpc_tuning_tpu_torch/ops/csrc/spd.cu",
                   "mpc_tuning_tpu/ops/pallas_kernels.py:217"),
    "spd_factor_solve": ("mpc_tuning_tpu_torch/ops/csrc/spd.cu",
                         "mpc_tuning_tpu/ops/pallas_kernels.py:242"),
    "closed_sim_admm": ("mpc_tuning_tpu_torch/ops/csrc/closed_sim.cu",
                        "mpc_tuning_tpu/ops/pallas_kernels.py:944"),
    "closed_sim_pdip": ("mpc_tuning_tpu_torch/ops/csrc/closed_sim.cu",
                        "mpc_tuning_tpu/ops/pallas_kernels.py:1248"),
    "closed_sim_band": ("mpc_tuning_tpu_torch/ops/csrc/closed_sim_band.cu",
                        "mpc_tuning_tpu/ops/pallas_kernels.py:1611"),
    "factor_lanes": ("mpc_tuning_tpu_torch/ops/csrc/spd.cu",
                     "mpc_tuning_tpu/ops/pallas_kernels.py:284"),
    "solve_lanes": ("mpc_tuning_tpu_torch/ops/csrc/spd.cu",
                    "mpc_tuning_tpu/ops/pallas_kernels.py:302"),
    "pdip_fused": ("mpc_tuning_tpu_torch/ops/csrc/qp_fused.cu",
                   "mpc_tuning_tpu/ops/pallas_kernels.py:568"),
    "admm_fused": ("mpc_tuning_tpu_torch/ops/csrc/qp_fused.cu",
                   "mpc_tuning_tpu/ops/pallas_kernels.py:697"),
    "spd_solve": ("mpc_tuning_tpu_torch/ops/csrc/spd.cu",
                  "mpc_tuning_tpu/ops/pallas_kernels.py:120"),
    # not a Pallas kernel: the NMPC rollout and its jax.jacfwd, which XLA
    # fuses into the NMPC step on the TPU
    "nmpc_rollout": ("mpc_tuning_tpu_torch/ops/csrc/nmpc.cu",
                     "mpc_tuning_tpu/sim/nmpc_loop.py:191"),
    # no TPU kernel: a repair of the port, the lane-major sums of
    # ops/qp.lane_sum (torch's column sum rounded a lane by the batch's
    # width)
    "lane_sum": ("mpc_tuning_tpu_torch/ops/csrc/qp_fused.cu",
                 "none: repairs mpc_tuning_tpu_torch/ops/qp.py lane_sum"),
}
# the plain version of each whole-sim kernel and per-step engine: the
# per-step engines' plain version is the plain step loop of the whole-sim
# kernel that runs the same algorithm
PLAIN = {"closed_sim_admm": "closed_sim_admm_plain",
         "closed_sim_pdip": "closed_sim_pdip_plain",
         "closed_sim_band": "closed_sim_band_plain",
         "pdip_ws_fused": "closed_sim_pdip_plain",
         "pdip_ws_lanes": "closed_sim_pdip_plain",
         "admm_fused": "closed_sim_admm_plain"}


# The nmpc_rollout kernel at float32 against its plain version on the card,
# max |dY| / max |Y| and max |dJ| / max |J| over 256 seeded states: twice
# the larger of what two correct runs differ by (the plain version on the
# card against the same on the CPU; the plain version with the states one
# ulp up against one ulp down), over both buckets, rounded up to two
# digits, as phase 2d printed them on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md §6: witnesses Y 2.190e-07, J 7.964e-07).
ROLLOUT_F32_LIMITS = dict(y=4.4e-07, j=1.6e-06)
# The same for its TR-BDF2 stepper, measured the same way, as phase 2d
# printed them on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6:
# witnesses Y 4.380e-07, J 1.509e-06).
ROLLOUT_TRBDF2_F32_LIMITS = dict(y=8.8e-07, j=3.1e-06)
ROLLOUT_F32 = {"rk4": ROLLOUT_F32_LIMITS, "tr_bdf2": ROLLOUT_TRBDF2_F32_LIMITS}
# phase 4 times the rollout kernel with and without J, and the
# thread-per-column design it replaced, at these buckets and batches
ROLLOUT_TIMING_CAPS = ((31, 15), (16, 2))
ROLLOUT_TIMING_B = (8, 64, 256)
# Both TR-BDF2 witnesses peaked at (16, 2); phase 2d measures them there
# only (the plain TR-BDF2 rollout with J at (31, 15) takes ~10 s a run on
# the card) and holds (31, 15) at the frozen limits.
TRBDF2_WITNESS_CAPS = (16, 2)
# the reference's own tuning of the Van de Vusse case (BASELINE.md:23):
# printed beside phase 3d's result, not a gate (the budgets differ)
VDV_REFERENCE = dict(N=3, Nu=[2, 2], delta=[0.0930, 0.1133],
                     lam=[0.2460, 0.1231])
CB_SETPOINT, CB_TOL = 1.0, 0.1  # phase 3d: Cb ends within 0.1 of 1.0
# phase 3d holds the tune's last batch step by step: the plain loop on the
# CPU steps the plant on the card's U over all 60 steps (Y held at every
# step) and solves its own control at the steps of these windows (U held
# there), around the Cb setpoint step (step 9) and the T setpoint step
# (step 40).  A solved step at p = 31 costs ~3 s on the CPU: all 60 took
# 161.5 s (PERF.md).
NMPC_HOLD_WINDOWS = ((1, 12), (38, 47))
# phase 3k's hold of its last batch, in the controller's scaled units:
# twice what two correct plain loops whose followed U is one ulp apart
# differ by at the window steps, 1.775e-09 at steps 38-47, rounded up to
# two digits (scripts/nmpc_spread_torch.py --integrator tr_bdf2 --vns-last
# 31 2 0.412407 0.162317 0.08433 0.656057: the tune's result on an NVIDIA
# H100 80GB HBM3 at 700 W, the loops on the CPU; PERF.md §6)
NMPC_TRBDF2_HOLD_GATE = 3.6e-9


POOLS = []  # worker pools and processes still open, terminated by fail
PROCS = []  # background process groups (phase 3j's ranks), killed by fail
# the CPU runs of 2b's certificate (a task a lane), 2d (two), 3k (two), 3c
# (three), 3d (two), 3f, 3h, 3i (five) and 4b's Van de Vusse hold
CPU_WORKERS = 4


def fail(msg: str):
    import os
    import signal

    print(f"FAIL: {msg}", flush=True)
    for pool in POOLS:
        pool.terminate()
    for proc in PROCS:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    sys.exit(1)


def _worker_init():
    torch.set_num_threads(2)


def cpu_pool(workers=CPU_WORKERS):
    """Spawned worker processes for the plain CPU runs that hold the card's
    (phases 3c, 3d, 3f, 3h, 3i), so they run while the card goes on;
    ``fail`` terminates them."""
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(workers, _worker_init)
    POOLS.append(pool)
    return pool


def close_pool(pool):
    pool.close()
    pool.join()
    POOLS.remove(pool)


def timed(fn, reps: int = 1, warm: bool = True):
    """Mean milliseconds per call on the card (CUDA events), after one
    warm-up call unless ``warm`` is False; returns (ms, last result)."""
    out = fn() if warm else None
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def maxabs(a, b) -> float:
    return float((a - b).abs().max().item())


def spd_batch(B, n, dtype, seed=None):
    """B seeded SPD matrices (B, n, n) on the card and right-hand sides
    (B, n); the seed defaults to n."""
    g = torch.Generator(device="cuda")
    g.manual_seed(n if seed is None else seed)
    A = torch.randn((B, n, n), generator=g, device="cuda", dtype=dtype)
    M = A @ A.transpose(1, 2) + n * torch.eye(n, device="cuda", dtype=dtype)
    return M, torch.randn((B, n), generator=g, device="cuda", dtype=dtype)


def device_ms(fn, reps: int = 20, tries: int = 3):
    """Device milliseconds per call (torch.profiler, CUDA activity: every
    kernel, copy and fill the call puts on the card) over ``reps`` calls
    after a warm-up: each activity's mean time times its count per call
    (its recorded count over reps, rounded up: the profiler at times drops
    a record, which a plain sum over reps would read as a faster call).  A
    profile that records no device time (it happens) is taken again, up to
    ``tries`` profiles, then None."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = 0.0
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0))
            if t > 0 and e.count:
                us += t / e.count * -(-e.count // reps)
        if us > 0:
            return us / 1e3
    return None


# Phase 4's shapes of the SPD factor kernels: the table's float32 row, then
# the float64 batches the tunes launch: a GAM generation at popsize 8 at
# Van de Vusse's n = 5, phase 3d's last Van de Vusse batch (B = 36 at the
# (31, 15) bucket's n = 31) and Shell's widest bucket (n = 46) at the
# largest batch the tunes launch (~141)
FACTOR_SHAPES = ((torch.float32, 1024, 17), (torch.float64, 8, 5),
                 (torch.float64, 36, 31), (torch.float64, 141, 46))

# Phase 4's shapes of the whole-sim kernels, (caps, B, seed, fixed (N, Nu)),
# float32, nit 400: first the bench row (the record's), then the batch sizes
# the Wood-Berry tune launches: its VNS legs (ADMM, 40 iterations) at B = 2
# (a joint-polish evaluation: one candidate, two selector lanes) and 18 (a
# neighbourhood of 9 candidates), at (64, 8) and B = 2 at the widest
# bucket; its GAM generations (PDIP, 15 iterations) at popsize 8
ADMM_SHAPES = (((64, 8), 8192, 1, {}), ((64, 8), 2, 3, {}),
               ((64, 8), 18, 3, {}), ((127, 15), 2, 3, {}))
PDIP_SHAPES = (((32, 4), 2048, 2, dict(N=20, Nu=4)),
               ((32, 4), 8, 2, dict(N=20, Nu=4)))
# ... and of the band kernel (caps, B, seed), float64, nit 200: the bench
# row (the record's) first, then the band tune's batches: B = 1 at (48, 4)
# (its joint polish, 164 of its ~207 launches), B = 1 and 8 at the first
# GAM bucket and B = 8 at the widest
BAND_SHAPES = (((48, 4), 256, 7), ((48, 4), 1, 7), ((127, 2), 1, 7),
               ((127, 2), 8, 7), ((127, 15), 8, 7))
# phase 2b's per-step certificate: seeded lanes beside the tuned point
CERT_LANES = ((32, 4), 3, 11)  # caps, B (lane 0, the corner, is skipped), seed
# phase 2b's depth: the first 50 of the case's 200 steps, the measured
# disturbance's entry at step 19 and the transient after it (where the
# certificate's tightest steps lay at nit 200: 19-81); at 200 the script
# took 1385.8 s of its 1200 s limit on one NVIDIA H100 80GB HBM3 host at
# 700 W, 2b 514 s of it; at 100, with phase 3j added, it passed 1400 s on
# another such host (2b 261.3 s) and 1637.6 s on a slower one
BAND_HOLD_NIT = 50
# phase 2a's depth: the first 30 of Wood-Berry's 400 steps (its first
# setpoint change at step 10); 60 until the script passed its time limit
KERNEL_NIT = 30


def spd_record(kernel: str):
    """The SPD kernel ``kernel`` (spd_factor on (B, n, n), factor_lanes on
    (n, n, B), or spd_factor_solve with the one-thread design it replaced,
    'old'), its library call (torch.linalg.cholesky_ex, or
    torch.cholesky_solve) and its plain version at each of FACTOR_SHAPES:
    CUDA-event ms per call (20 calls) and device ms per call
    (``device_ms``), with the bound.  Returns the kernel's record (the
    table's keys at the first shape, f32 B=1024 n=17, and every shape
    under 'shapes') and its text, the timings' own seconds last."""
    from mpc_tuning_tpu_torch.ops import kernels as K

    t0 = time.perf_counter()
    solve = kernel == "spd_factor_solve"
    rows = []
    for dtype, B, n in FACTOR_SHAPES:
        M, rhs = spd_batch(B, n, dtype)
        if kernel == "factor_lanes":
            M = M.permute(1, 2, 0).contiguous()
            calls = dict(kernel=lambda: K.factor_lanes(M),
                         library=lambda: torch.linalg.cholesky_ex(
                             M.permute(2, 0, 1)),
                         plain=lambda: K.factor_lanes_plain(M))
        elif solve:
            L = K.spd_factor_plain(M)
            calls = dict(kernel=lambda: K.spd_factor_solve(L, rhs),
                         old=lambda: K.spd_factor_solve_one_thread(L, rhs),
                         library=lambda: torch.cholesky_solve(
                             rhs[:, :, None], L),
                         plain=lambda: K.spd_factor_solve_plain(L, rhs))
        else:
            calls = dict(kernel=lambda: K.spd_factor(M),
                         library=lambda: torch.linalg.cholesky_ex(M),
                         plain=lambda: K.spd_factor_plain(M))
        row = dict(dtype=str(dtype).removeprefix("torch."), B=B, n=n)
        for name, fn in calls.items():
            key = "" if name == "kernel" else name + "_"
            row[key + "ms"] = timed(fn, 20)[0]
            row[key + "device_ms"] = device_ms(fn)
        # both read the lower triangle only; the factor writes all of L
        # (n^3 / 3 multiply-adds), the solve x (n^2 multiply-adds)
        tri = n * (n + 1) // 2
        row["bound_ms"], row["bound_by"] = bound_ms(
            B * (tri + 2 * n if solve else tri + n * n) * M.element_size(),
            B * (2 * n * n if solve else n ** 3 / 3), dtype)
        rows.append(row)
    rec = {k: rows[0][k] for k in ("ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by")}
    rec["shapes"] = rows
    lib = "cholesky_solve" if solve else "cholesky_ex"
    txt = "; ".join(
        f"{r['dtype']} B={r['B']} n={r['n']}: kernel {r['ms']:.5f} ms "
        f"(device {fmt_ms(r['device_ms'])}), "
        + (f"one-thread {r['old_ms']:.5f} (device "
           f"{fmt_ms(r['old_device_ms'])}), " if solve else "")
        + f"{lib} {r['library_ms']:.5f} (device "
        f"{fmt_ms(r['library_device_ms'])}), plain {r['plain_ms']:.5f} "
        f"(device {fmt_ms(r['plain_device_ms'])}), bound "
        f"{r['bound_ms']:.3g} ({r['bound_by']})" for r in rows)
    return rec, txt + f" ({time.perf_counter() - t0:.1f} s)"


def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.5f}"


def nbytes(*xs) -> int:
    """Bytes of the tensors in xs (dicts, tuples and tensors)."""
    total = 0
    for x in xs:
        if isinstance(x, dict):
            total += nbytes(*x.values())
        elif isinstance(x, (tuple, list)):
            total += nbytes(*x)
        elif isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
    return total


def bound_ms(bytes_moved: float, flops: float, dtype, peak=None):
    """(least ms on the card, what bounds it): the bytes read and written
    once over the HBM rate, or the operations over the peak rate (``peak``
    FLOP/s, else PEAK_FLOPS[dtype])."""
    tb = bytes_moved / HBM_BPS * 1e3
    to = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def sim_flops(engine, t, dims, nit, iters, N, Nu, lp=0, s2=0,
              loop=True):
    """Floating-point operations of one whole-sim launch on these inputs:
    per step the estimator and plant products, per QP iteration the
    constraint products, normal matrix, factor and solves on each lane's
    active rows and columns (the kernels skip masked ones; the band kernel
    works on +-row pairs).  ``loop=False``: one step's QP solve alone (the
    single-solve kernels; nit = 1)."""
    ny, nu, n = dims["ny"], dims["nu"], dims["n"]
    nxa, nxp = t["A"].shape[0], t["Apl"].shape[0]
    pny = t["SxF"].shape[0]
    step = loop * 2 * (ny * nxp + ny * nxa + nxa * ny + pny * (nxa + nu)
                       + n * pny + nxa * (nxa + nu) + nxp * (nxp + nu))
    total = 0.0
    nnz = int((t["G0"] != 0).sum())
    for Nb, Nub in zip(np.asarray(N), np.asarray(Nu)):
        nc = int(Nub) * nu
        nn = nc + 1
        if engine == "closed_sim_band":
            pr = int(Nb) * ny
            nsp = dims["mc"] - 2 * pny
            ta = nc * (nc + 1) // 2 + nc + 1
            g = 2 * nc * pr + 6 * pr + 2 * 4 * nc
            gt = 3 * nc * pr + 3 * pr + 2 * 4 * nc
            # normal matrix: Theta's rows scaled by w once (pr nc), then
            # one multiply-add per lower-triangle entry and row
            it = (pr * nc + 2 * ta * pr + 3 * (g + gt) + nn ** 3 / 3
                  + 4 * nn ** 2 + 40 * (2 * pr + nsp) + 2 * nn ** 2)
            total += nit * (step + (lp + s2) * it + 2 * g + 20 * pr)
        else:
            mc = 4 * nc + 1
            sq = 6 * nc * nc  # sum of squared row nonzeros of the u rows
            if engine == "closed_sim_pdip":
                it = (3 * sq + 12 * nnz + 2 * nn ** 2 + nn ** 3 / 3
                      + 4 * nn ** 2 + 30 * mc)
            else:
                it = 2 * nn ** 2 + 4 * nnz + 10 * mc
            total += nit * (step + iters * it)
    return total


def sim_inputs(problem, caps, B, nit, dtype, engine, seed, N=None, Nu=None):
    """Engine inputs for B random candidates of a tracking case
    (Wood-Berry, Shell3x3) that span the capacity bucket ``caps``; returns
    (inputs, N, Nu)."""
    rng = np.random.default_rng(seed)
    p_cap, m_cap = caps
    if N is None:
        N = rng.integers(m_cap + 1, p_cap + 1, size=B)
        Nu = rng.integers(2, m_cap + 1, size=B)
        N[0], Nu[0] = p_cap, m_cap
    else:
        N, Nu = np.full(B, N), np.full(B, Nu)
    delta = rng.uniform(0.2, 2.0, size=(B, problem.my))
    lam = rng.uniform(0.02, 0.5, size=(B, problem.nu))
    r_b = np.broadcast_to(problem.r[:nit], (B, nit, problem.my))
    return problem.loop.sim_inputs(r_b, problem.v, N, Nu, delta, lam, nit,
                                   dtype, engine, "cuda", caps=caps), N, Nu


def phase_env():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    from mpc_tuning_tpu_torch.ops import _build

    t0 = time.perf_counter()
    # the reference designs (ops/csrc/reference, phases 2a, 2c, 4) build
    # beside the port's kernels, every nvcc started together
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(_build.reference_library)
        _build.library()
        ref.result()
    print(f"[1 env] card={card!r} torch={torch.__version__} "
          f"cuda={torch.version.cuda} build_s={_build.build_seconds} "
          f"load_s={time.perf_counter() - t0:.3f}", flush=True)
    return card


def lane_errors(a, b):
    """Per-lane max |a - b| of Y and of U, each (B,), for (Y, U, ...)
    tuples in (nit, rows, B) layout."""
    return ((a[0] - b[0]).abs().amax((0, 1)),
            (a[1] - b[1]).abs().amax((0, 1)))


def follow_plain(name, args, kwargs, out_k):
    """The plain version of whole-sim kernel or per-step engine `name` on
    the same inputs,
    stepping the plant and model on the kernel's U (see ops/kernels.py):
    each step's QP is then solved from the state the kernel solved it in.
    Returns the per-lane (dY, dU) against the kernel's output."""
    from mpc_tuning_tpu_torch.ops import kernels as K

    out_p = getattr(K, PLAIN[name])(*args, **kwargs, u_follow=out_k[1])
    torch.cuda.synchronize()
    return lane_errors(out_k, out_p)


def phase_kernels(problem):
    """2a. Wood-Berry kernels vs plain on the card; returns {name:
    max_abs_err (f64)}.

    The whole-sim kernels are held step by step: the plain version follows
    the kernel's inputs (``follow_plain``).  Run side by side instead, two
    correct float64 loops drift apart by up to 5.3e-9 on a lane, and two
    float32 PDIP loops by up to 0.14: an interior point run to its floor
    turns a last-digit difference into another iterate, and the loop
    carries it through all later steps.  Float32 PDIP answers also scatter
    within one step (ill-conditioned normal matrices at the dual cap), so
    its U gate is F32_SIM_GATE on the median lane and F32_PDIP_U_CAP on
    every lane, a lane over the cap held by correct runs one rounding away
    (tools/pdip_spread.pdip_u_hold); the main path's own float32 batches
    are held to F32_SIM_GATE on every lane in phase 3."""
    from mpc_tuning_tpu_torch.ops import kernels as K
    from mpc_tuning_tpu_torch.tools.pdip_spread import pdip_u_hold

    t0 = time.perf_counter()
    B, nit = 1024, KERNEL_NIT
    err64 = {}
    rows = []
    one_thread = {}  # spd_factor_solve vs the design it replaced, reported
    spd_solve_old = {}  # spd_solve vs the design it replaced, reported
    for dtype in (torch.float64, torch.float32):
        f64 = dtype == torch.float64
        tag = "f64" if f64 else "f32"
        for caps, (engine, iters), Bs in itertools.product(
                ((64, 8), (127, 15)), (("admm_sim", 40), ("pdip_sim", 30)),
                (B, 2, 37)):
            (t, lc, Hm, r_l, dims), _, _ = sim_inputs(
                problem, caps, Bs, nit, dtype, engine, seed=caps[0])
            name = "closed_sim_" + engine[:4]
            args = (t, lc, Hm, r_l, nit, iters)
            kwargs = dict(dims=dims)
            if engine == "admm_sim":
                kwargs.update(sigma=1e-6, over_relax=1.6)
            out_k = getattr(K, name)(*args, **kwargs)
            torch.cuda.synchronize()
            if not all(torch.isfinite(x).all() for x in out_k):
                fail(f"{name} {caps} B={Bs} {tag}: non-finite output")
            dy, du = follow_plain(name, args, kwargs, out_k)
            ey, eu = float(dy.max()), float(du.max())
            med = float(du.median())
            rows.append(f"{name}{caps}B={Bs}:{tag}=Y {ey:.3e} U {eu:.3e} "
                        f"(median lane {med:.3e})")
            if f64:
                err64[name] = max(err64.get(name, 0.0), ey, eu)
                ok = max(ey, eu) <= F64_SIM_GATE
            elif engine == "admm_sim":
                ok = max(ey, eu) <= F32_SIM_GATE
            else:
                ok = (ey <= F32_SIM_GATE and med <= F32_SIM_GATE
                      and eu <= F32_PDIP_U_CAP)
            if not ok and engine == "pdip_sim" and not f64:
                # lanes over the cap: by correct runs one rounding away
                ok, text = pdip_u_hold(getattr(K, PLAIN[name]), args, kwargs,
                                       *out_k[:2], F32_SIM_GATE,
                                       F32_PDIP_U_CAP)
                rows[-1] = f"{name}{caps}B={Bs}:{tag}={text}"
            if not ok:
                fail(f"{rows[-1]}: above its gate")
        for n, Bs in ((n, Bs) for n in (5, 17, 31, 46) for Bs in (B, 37)):
            M, rhs = spd_batch(Bs, n, dtype)
            Lk, Lp = K.spd_factor(M), K.spd_factor_plain(M)
            xk = K.spd_factor_solve(Lk, rhs)
            xp = K.spd_factor_solve_plain(Lp, rhs)
            xo = K.spd_factor_solve_one_thread(Lk, rhs)
            # spd_solve in one launch: the bits of the two kernels above
            xs = K.spd_solve(M, rhs)
            xs1 = K.spd_solve_one_thread(M, rhs)
            torch.cuda.synchronize()
            if not torch.equal(xs.view(torch.uint8), xk.view(torch.uint8)):
                fail(f"spd_solve n={n} B={Bs} {tag}: not the bits of "
                     f"spd_factor_solve(spd_factor(M)), max |dx| "
                     f"{maxabs(xs, xk):.3e}")
            es1 = maxabs(xs, xs1) / (1.0 if f64 else float(xs1.abs().max()))
            spd_solve_old[tag] = max(spd_solve_old.get(tag, 0.0), es1)
            eL, ex, eo = maxabs(Lk, Lp), maxabs(xk, xp), maxabs(xk, xo)
            if f64:
                err64["spd_factor"] = max(err64.get("spd_factor", 0.0), eL)
                err64["spd_factor_solve"] = max(
                    err64.get("spd_factor_solve", 0.0), ex)
            else:
                eL /= float(Lp.abs().max())
                ex /= float(xp.abs().max())
                eo /= float(xo.abs().max())
            one_thread[tag] = max(one_thread.get(tag, 0.0), eo)
            rows.append(f"spd(n={n},B={Bs}):{tag}=L {eL:.3e} x {ex:.3e}")
            if max(eL, ex) > (F64_SPD_GATE if f64 else F32_SPD_GATE):
                fail(f"spd n={n} B={Bs} {dtype}: dL {eL:.3e} dx {ex:.3e}")
    print(f"[2a kernels] B={B} (whole sims also B=2, 37) nit={nit} (the "
          f"case's 400 steps cut to {nit}), "
          f"whole sims with the plain version following the kernel's U; "
          f"gates: f64 {F64_SIM_GATE:g}, f32 {F32_SIM_GATE:g} (f32 PDIP U: "
          f"median lane {F32_SIM_GATE:g}, every lane {F32_PDIP_U_CAP:g}); "
          f"spd f64 {F64_SPD_GATE:g}, f32 {F32_SPD_GATE:g} relative | "
          + " | ".join(rows) + " | spd_factor_solve vs the one-thread design "
          f"(reported, not gated): f64 max |dx| {one_thread['f64']:.3e}, "
          f"f32 {one_thread['f32']:.3e} relative | spd_solve: the bits of "
          f"spd_factor_solve(spd_factor(M)) at every (n, B, dtype) above; vs "
          f"its one-thread design (reported, not gated): f64 max |dx| "
          f"{spd_solve_old['f64']:.3e}, f32 {spd_solve_old['f32']:.3e} "
          f"relative | "
          f"wall_s={time.perf_counter() - t0:.1f}", flush=True)
    return err64


def phase_band_kernels(band_problem, pool):
    """2b. The band kernel vs its plain version, step by step, at float64,
    held at the live witness's limits (tools/band_spread.band_gate); then
    by the LP certificate at the tuned point and seeded lanes, and on each
    bucket's tightest lane relative to the plain chain, the certificate in
    ``pool``'s workers.  Returns (the max |dY|, |dU| over the rows, the
    pending certificate for finish_band_cert).  Every row prints before
    the limits are applied."""
    from mpc_tuning_tpu_torch.ops import kernels as K
    from mpc_tuning_tpu_torch.tools.band_spread import (ADJUDICATED_LANES,
                                                        BAND_CAPS,
                                                        band_candidates,
                                                        band_gate,
                                                        band_inputs,
                                                        band_lane_errors,
                                                        band_witness,
                                                        tightest_lane)

    t0 = time.perf_counter()
    B, nit = 256, BAND_HOLD_NIT
    err64 = 0.0
    rows, bad, tight = [], [], []
    for caps in BAND_CAPS:
        (t, lc, Hp, r_l, dims), N, Nu = band_inputs(
            band_problem, caps, B, nit, torch.float64, caps[0])
        args = (t, lc, Hp, r_l, nit, 20, 12)
        kwargs = dict(dims=dims)
        out_k = K.closed_sim_band(*args, **kwargs)
        torch.cuda.synchronize()
        if not all(torch.isfinite(x).all() for x in out_k):
            fail(f"closed_sim_band {caps}: non-finite output")
        out_p = K.closed_sim_band_plain(*args, **kwargs, u_follow=out_k[1])
        errs = band_lane_errors(out_k, out_p)
        witness = band_witness(args, kwargs, out_k[1], out_p)
        ok, txt, over = band_gate(errs, witness, caps)
        b = tightest_lane(errs, witness)
        rows.append(f"band{caps}: {txt}; tightest lane {b} (N {N[b]}, Nu "
                    f"{Nu[b]}): kernel u {float(errs['u'][b]):.3e}, witness "
                    f"{float(witness['u'][b]):.3e}")
        lam = band_candidates(caps, B, caps[0])[2]
        U, E = out_k[1].cpu().numpy(), out_k[2].cpu().numpy()
        # the tightest lane, and the lanes over the live limits (if any) for
        # the certificate to decide
        for lane in [b] + [x for x in over or [] if x != b]:
            tight.append((caps, lane, N, Nu, lam, U[:, :, lane], E[:, lane],
                          "over the limits" if lane in (over or [])
                          else "tightest"))
        err64 = max(err64, float(errs["y"].max()), float(errs["u"].max()))
        if over is None:
            bad.append(rows[-1])
    print(f"[2b band kernel] Shell7x5 f64 B={B} nit={nit}, the plain version "
          f"following the kernel's U; per-lane statistics, lane quantiles "
          f"p50/p90/p99/max: the kernel, the live limit (twice the witness "
          f"measured along the kernel's U, plus the floor) and the frozen "
          f"tools/band_spread.BAND_LIMITS (printed, not applied); lanes over "
          f"the live limits (at most {ADJUDICATED_LANES}, Y held) go to the "
          f"certificate relative to the plain chain | "
          + " | ".join(rows)
          + f" | wall_s={time.perf_counter() - t0:.1f}", flush=True)
    if bad:
        fail("band rows above their limits, past what the certificate "
             "may decide: " + " | ".join(bad))
    # the certificate, host-side work, in the CPU workers beside the
    # card's later phases (finish_band_cert collects and prints it)
    return err64, band_cert_start(K.closed_sim_band, band_problem, tight,
                                  pool)


def band_cert_collect(pending):
    """The certificate of band_cert_start: {"lanes": {name: hold's dict},
    "relative": {name: hold_relative's dict}, "gates": text, "eps_rel",
    "du_rel", "wall_s" (from its start), "waited_s"}."""
    t0 = time.perf_counter()
    tasks, t_start, gates = pending
    lanes, relative = {}, {}
    for kind, name, job in tasks:
        (lanes if kind == "hold" else relative)[name] = job.get()
    now = time.perf_counter()
    return dict(lanes=lanes, relative=relative, gates=gates[0],
                eps_rel=gates[1], du_rel=gates[2], wall_s=now - t_start,
                waited_s=now - t0)


def band_cert_hold(kernel, band_problem, tight=()):
    """band_cert_start and band_cert_collect in a pool of CPU workers of
    its own (for scripts)."""
    pool = cpu_pool()
    try:
        return band_cert_collect(band_cert_start(kernel, band_problem, tight,
                                                 pool))
    finally:
        close_pool(pool)


def finish_band_cert(pending):
    """2b's certificate (band_cert_start) collected, printed and held."""
    from mpc_tuning_tpu_torch.ops.band_cert import REL_REPLICAS

    held = band_cert_collect(pending)
    lanes, relative = held["lanes"], held["relative"]
    txt = " | ".join(f"{name}: steps {h['steps']} well posed "
                     f"{h['well_posed']} slack > 0 {h['eps_pos']} "
                     f"uncertified {h['uncertified']} slack {h['deps_rel']:.3e}"
                     f" du {h['du_well_posed']:.3e}"
                     for name, h in lanes.items())
    rel = " | ".join(f"{name}: {relative_text(h)}"
                     for name, h in relative.items())
    print(f"[2b band certificate] the kernel's run, B=1 at the tuned point "
          f"and {CERT_LANES[1] - 1} seeded lanes at {CERT_LANES[0]}, nit "
          f"{BAND_HOLD_NIT}, "
          f"each step's QP harvested along its U and certified on the host "
          f"(gates: {held['gates']}) | {txt} | relative to the plain chain "
          f"on the same QPs, each bucket's tightest lane and lanes over the "
          f"live limits (per step, slack at most max({held['eps_rel']:g}, "
          f"twice the largest of the plain chains' on that step), first move "
          f"at most max({held['du_rel']:g}, the same); the chains as "
          f"harvested and reordered, and {REL_REPLICAS} rounded on the card "
          f"where those two do not clear the run) | {rel} | a task a lane in "
          f"the CPU workers, {held['wall_s']:.1f} s from their start, waited "
          f"{held['waited_s']:.1f} s for them", flush=True)
    bad = [k for k, h in lanes.items() if not h["ok"]]
    bad += [k for k, h in relative.items() if not h["ok"]]
    if bad:
        fail(f"band kernel off its certificate on {bad}: {txt} | {rel}")


def relative_text(h):
    """One line of ops/band_cert.hold_relative's verdict ``h``: the step
    where the run is nearest each limit, its error and the limit there."""
    return (f"kernel slack {h['run']['deps_rel']:.3e} du "
            f"{h['run']['du_well_posed']:.3e} (uncertified "
            f"{h['run']['uncertified']}); plain chains slack "
            f"{h['plain']['deps_rel_frozen']:.3e} / "
            f"{h['reordered']['deps_rel_frozen']:.3e} du "
            f"{h['plain']['du_well_posed']:.3e} / "
            f"{h['reordered']['du_well_posed']:.3e} (as harvested / "
            f"reordered); {h['chains']} chains; nearest its limit: slack "
            f"step {h['eps_step']} {h['eps_run']:.3e} (limit "
            f"{h['eps_limit']:.3e}), du step {h['du_step']} "
            f"{h['du_run']:.3e} (limit {h['du_limit']:.3e}): "
            f"{'passes' if h['ok'] else 'FAILS'}")


def band_cert_start(kernel, band_problem, tight, pool):
    """The band kernel ``kernel`` (closed_sim_band's arguments; (Y, U, E))
    held step by step by the LP certificate (ops/band_cert.hold): at the
    reference's tuned point (its own conditioning frame, B = 1, nit
    BAND_HOLD_NIT) and on CERT_LANES' seeded lanes of ``band_problem``; and
    each of ``tight``'s lanes ((caps, lane, N, Nu, lam, U, E, why) of a
    phase 2b bucket) relative to the plain chain
    (ops/band_cert.hold_relative).  The kernel runs here; each lane's
    certificate is a task of ``pool`` (band_cert_lane).  Returns the
    pending certificate for finish_band_cert."""
    from mpc_tuning_tpu_torch.cases import shell7x5
    from mpc_tuning_tpu_torch.ops import band_cert as bc
    from mpc_tuning_tpu_torch.tools.band_spread import band_candidates
    from mpc_tuning_tpu_torch.tuning.api import build_problem

    t0 = time.perf_counter()
    ref = shell7x5.REF_TUNED
    nit = BAND_HOLD_NIT
    tuned, _ = build_problem(shell7x5.make_case(), L=np.diag(ref.L),
                             R=np.diag(ref.R), device="cuda")
    caps, B, seed = CERT_LANES
    N, Nu, lam = band_candidates(caps, B, seed)
    runs = (("tuned", tuned, [ref.N], [int(ref.Nu.max())], ref.lam[None],
             None, [0]),
            ("seeded", band_problem, N, Nu, lam, caps, range(1, B)))
    tasks = []
    for name, problem, N, Nu, lam, caps, take in runs:
        r_b = np.broadcast_to(problem.r[:nit], (len(N), nit, 7))
        t, lc, Hp, r_l, dims = problem.loop.sim_inputs(
            r_b, problem.v, N, Nu, np.zeros((len(N), 7)), lam, nit,
            torch.float64, "band_sim", "cuda", caps=caps)
        _, U, E = kernel(t, lc, Hp, r_l, nit, 20, 12, dims)
        U, E = U.cpu().numpy(), E.cpu().numpy()
        for b in take:
            tasks.append(("hold", f"{name} lane {b} (N {N[b]}, Nu {Nu[b]})",
                          pool.apply_async(band_cert_lane, (
                              "hold", name, N[b], Nu[b], lam[b], U[:, :, b],
                              E[:, b]))))
    for caps, b, N, Nu, lam, U, E, why in tight:
        tasks.append(("relative",
                      f"{caps} lane {b} (N {N[b]}, Nu {Nu[b]}; {why})",
                      pool.apply_async(band_cert_lane, (
                          "relative", "seeded", N[b], Nu[b], lam[b], U, E))))
    gates = (f"slack {bc.HOLD_EPS_REL:g} relative on every step, first move "
             f"{bc.HOLD_DU:g} where du_sens < {bc.DU_SENS_BAR:g}",
             bc.HOLD_EPS_REL, bc.HOLD_DU)
    return tasks, t0, gates


def band_cert_lane(kind, frame, N, Nu, lam, U, E):
    """One lane of 2b's certificate, in a CPU worker: ``kind`` "hold"
    (ops/band_cert.hold) or "relative" (hold_relative, its rounded replica
    chains on the card); ``frame`` "tuned" (the reference's L, R) or
    "seeded" (the case's own conditioning, phase 2b's).  The QPs are
    harvested and certified on the host in this process."""
    from mpc_tuning_tpu_torch.cases import shell7x5
    from mpc_tuning_tpu_torch.ops import band_cert as bc
    from mpc_tuning_tpu_torch.tuning.api import build_problem

    ref = shell7x5.REF_TUNED
    kw = dict(L=np.diag(ref.L), R=np.diag(ref.R)) if frame == "tuned" else {}
    problem = build_problem(shell7x5.make_case(), device="cpu", **kw)[0]
    caps = (int(N), int(Nu))
    if kind == "hold":
        return bc.hold(problem, N, Nu, np.zeros(7), lam, U, E, caps=caps)
    return bc.hold_relative(problem, N, Nu, np.zeros(7), lam, U, E,
                            caps=caps, device="cuda")


STEP_TAKE = 85  # the Shell3x3 step whose QPs phase 2c solves (after the
                # setpoint change at step 80)
# phase 3c's depth: the first 250 of the case's 500 steps (the setpoint
# changes at steps 9, 79 and 199; the return to rest at 399 is cut), cut
# from 500 to make room for phase 3k
S3_NIT = 250


def to_cpu(x, fn=lambda t: t.cpu()):
    """x with ``fn`` (by default: move to the CPU) applied to every tensor
    in it (dicts, tuples)."""
    if isinstance(x, dict):
        return {k: to_cpu(v, fn) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_cpu(v, fn) for v in x)
    return fn(x) if isinstance(x, torch.Tensor) else x


def to_f64(x):
    """x with every floating tensor in it cast to float64."""
    return to_cpu(x, lambda t: t.double() if t.is_floating_point() else t)


def step_qp_args(problem, caps, B, dtype, engine, seed, take=STEP_TAKE,
                 N=None, Nu=None):
    """The arguments of the single-solve kernel of per-step engine
    ``engine`` at step ``take`` of its closed loop on B seeded candidates:
    a real step's QPs, warm start included.  Returns (args, N, Nu, tables,
    dims)."""
    from mpc_tuning_tpu_torch.ops import kernels as K
    from mpc_tuning_tpu_torch.sim import mpc_loop

    (t, lc, Hm, r_l, dims), N, Nu = sim_inputs(problem, caps, B, take + 1,
                                               dtype, engine, seed, N, Nu)
    G = K.g_shared(t["G0"], t.get("T2T"))
    kernel = K.admm_fused if engine == "admm_fused" else K.pdip_fused
    seen = {}

    def qp(*args):
        seen["args"] = args
        return kernel(*args)

    if engine == "admm_fused":
        step = K.admm_step(t, lc, Hm, dims, G, 40, mpc_loop.ADMM_SIGMA,
                           mpc_loop.ADMM_OVER_RELAX, qp)
    else:
        step = K.pdip_step(t, lc, Hm, dims, G, 15, qp)
    K.step_loop(t, lc, r_l, dims, *step)
    torch.cuda.synchronize()
    return seen["args"], N, Nu, t, dims


def qp_lane_errors(name, args, a, b, nu):
    """Per-lane errors of the single QP solve ``a`` against ``b`` by the
    kernel ``name`` (its arguments ``args``; outputs lane-major (rows, B):
    PDIP (z, lam, s), ADMM (x, zc, y) in scaled coordinates): 'du' max
    |d first move| (what the loop applies); 'z' max |dz| (ADMM: dx); 'lam'
    max |dlam| / max(1, |lam|) (ADMM: the duals y)."""
    dual, scale = (1, 1.0) if name == "pdip_fused" else (2, args[4][:nu])
    a, b = to_cpu(a), to_cpu(b)
    scale = to_cpu(scale)
    return dict(du=((a[0][:nu] - b[0][:nu]) * scale).abs().amax(0),
                z=(a[0] - b[0]).abs().amax(0),
                lam=((a[dual] - b[dual]).abs()
                     / b[dual].abs().clamp_min(1.0)).amax(0))


def phase_step_kernels(s3_problem):
    """2c. The per-step engines' kernels vs their plain versions on the
    card; returns {name: max_abs_err (f64)}.  The QP rows print the lane
    quantiles of the kernel against the plain version on the card and of
    two witnesses (two correct runs: the plain version on the card against
    the same on the CPU, and with the constraint rhs one ulp up against
    one ulp down) and are held at QP_LIMITS."""
    from mpc_tuning_tpu_torch.ops import kernels as K
    from mpc_tuning_tpu_torch.tools.band_spread import lane_quantiles

    t0 = time.perf_counter()
    B = 1024
    err64, rows, bad = {}, [], []
    fmt = lambda x: "/".join(f"{v:.3e}" for v in lane_quantiles(x))
    for dtype in (torch.float64, torch.float32):
        f64 = dtype == torch.float64
        tag = "f64" if f64 else "f32"
        for n, Bs in ((n, Bs) for n in (7, 17, 46) for Bs in (B, 37)):
            M, rhs = spd_batch(Bs, n, dtype)
            M, rhs = M.permute(1, 2, 0).contiguous(), rhs.T.contiguous()
            Lk, Lp = K.factor_lanes(M), K.factor_lanes_plain(M)
            xk = K.solve_lanes(Lk, rhs)
            xp = K.solve_lanes_plain(Lp, rhs)
            # the warp solve_lanes gives spd_factor_solve's bits
            same = torch.equal(xk.T, K.spd_factor_solve(
                Lk.permute(2, 0, 1).contiguous(), rhs.T.contiguous()))
            torch.cuda.synchronize()
            eL, ex = maxabs(Lk, Lp), maxabs(xk, xp)
            if f64:
                err64["factor_lanes"] = max(err64.get("factor_lanes", 0.0), eL)
                err64["solve_lanes"] = max(err64.get("solve_lanes", 0.0), ex)
            else:
                eL /= float(Lp.abs().max())
                ex /= float(xp.abs().max())
            rows.append(f"lanes(n={n},B={Bs}):{tag}=L {eL:.3e} x {ex:.3e}"
                        f", x = spd_factor_solve's bits: {same}")
            if max(eL, ex) > (F64_SPD_GATE if f64 else F32_SPD_GATE) or \
                    not same:
                bad.append(rows[-1])
        for Bs in (B, 37):
            # the lane_sum kernel at the Shell3x3 (127, 15) bucket's 181
            # rows: within rows ulps of each lane's sum of |x| of the plain
            # version's sum on the same values (the CPU's, in groups of 8
            # lanes); a prefix of the lanes reads the whole batch's bits
            g = torch.Generator(device="cuda").manual_seed(Bs)
            x = torch.randn((181, Bs), generator=g, device="cuda",
                            dtype=dtype)
            sk = K.lane_sum(x)
            sp = K.lane_sum_plain(x.cpu())
            torch.cuda.synchronize()
            es = float((sk.cpu() - sp).abs().max())
            lim = 181 * torch.finfo(dtype).eps * x.abs().sum(0).cpu()
            prefix = torch.equal(K.lane_sum(x[:, :8].contiguous()),
                                 sk[:, :8])
            if f64:
                err64["lane_sum"] = max(err64.get("lane_sum", 0.0), es)
            rows.append(f"lane_sum(181 rows, B={Bs}):{tag}=max |d| {es:.3e}"
                        f" (limit rows ulps of the sum of |x|, at most "
                        f"{float(lim.max()):.3e}), lanes 0-7 alone the "
                        f"batch's bits: {prefix}")
            if not (bool(((sk.cpu() - sp).abs() <= lim).all()) and prefix):
                bad.append(rows[-1])
        for caps in ((32, 4), (127, 15)):
            for engine, name in (("pdip_ws_fused", "pdip_fused"),
                                 ("admm_fused", "admm_fused")):
                args, _, _, _, dims = step_qp_args(s3_problem, caps, B, dtype,
                                                   engine, caps[0])
                out_k = getattr(K, name)(*args)
                plain = getattr(K, name + "_plain")
                out_p = plain(*args)
                torch.cuda.synchronize()
                if not all(torch.isfinite(x).all() for x in out_k):
                    fail(f"{name} {caps} {tag}: non-finite output")
                errs = qp_lane_errors(name, args, out_k, out_p, dims["nu"])
                # two correct runs: the plain version on the CPU, and on
                # the card with the constraint rhs one ulp up vs down
                inf = torch.tensor(float("inf"), dtype=dtype, device="cuda")
                nudged = [plain(*args[:2], torch.nextafter(args[2], s * inf),
                                *args[3:]) for s in (1, -1)]
                wits = (qp_lane_errors(name, args, to_cpu(out_p),
                                       plain(*to_cpu(args)), dims["nu"]),
                        qp_lane_errors(name, args, *nudged, dims["nu"]))
                lim = QP_LIMITS[(name, tag)]
                head = f"{name}{caps} n={dims['n']} mc={dims['mc']}:{tag}="
                du = float(errs["du"].max())
                rows.append(head + f"du {du:.3e} " + " ".join(
                    f"{k} kernel {fmt(errs[k])} (limits "
                    f"{'/'.join(f'{v:g}' for v in lim[k])}; witnesses cpu "
                    f"{fmt(wits[0][k])}, ulp {fmt(wits[1][k])})"
                    for k in ("z", "lam")))
                if name == "pdip_fused":
                    # the warp-per-lane kernel against the one-thread
                    # design it replaced (reported)
                    old = qp_lane_errors(name, args, out_k,
                                         K.pdip_fused_one_thread(*args),
                                         dims["nu"])
                    rows[-1] += ("; vs the one-thread design: "
                                 + " ".join(f"{k} {fmt(old[k])}"
                                            for k in ("du", "z", "lam")))
                if f64:
                    err64[name] = max(err64.get(name, 0.0),
                                      float(errs["z"].max()))
                if ((f64 and du > F64_SIM_GATE)
                        or any(q > l for k in ("z", "lam")
                               for q, l in zip(lane_quantiles(errs[k]),
                                               lim[k]))):
                    bad.append(rows[-1])
            # the warp-per-lane admm_fused against the one-thread design it
            # replaced, bit for bit, at B and at a ragged 37
            for Bs in (B, 37):
                args = step_qp_args(s3_problem, caps, Bs, dtype, "admm_fused",
                                    caps[0])[0]
                out_k = K.admm_fused(*args)
                out_o = K.admm_fused_one_thread(*args)
                torch.cuda.synchronize()
                differ = sum(int((a != b).sum()) for a, b in zip(out_k, out_o))
                rows.append(f"admm_fused{caps} B={Bs}:{tag} vs the one-thread "
                            f"design: {differ} of "
                            f"{sum(a.numel() for a in out_k)} elements differ")
                if differ:
                    bad.append(rows[-1])
    print(f"[2c step kernels] B={B}; Shell3x3 QPs of step {STEP_TAKE}; "
          f"gates: lanes f64 {F64_SPD_GATE:g}, f32 {F32_SPD_GATE:g} "
          f"relative; QPs: f64 first move du {F64_SIM_GATE:g} on every "
          f"lane, z and lam at QP_LIMITS (lane quantiles p50/p90/p99/max); "
          f"admm_fused bit for bit against its one-thread design, pdip_fused"
          f"'s distance from its one-thread design reported; lane_sum within "
          f"rows ulps of each lane's sum of |x| | "
          + " | ".join(rows)
          + f" | wall_s={time.perf_counter() - t0:.1f}", flush=True)
    if bad:
        fail("step kernel rows above their gates: " + " | ".join(bad))
    return err64


WHOLE_SIM = ("closed_sim_admm", "closed_sim_pdip", "closed_sim_band")


def keep_last_launches(store):
    """Route the evaluators' whole-sim calls and per-step engine runs
    through recorders that keep each one's last call (the plain version's
    arguments and the kernels' output) in `store`, under the kernel's or
    the engine's name; returns a function that undoes it.  The wrappers
    still count."""
    from mpc_tuning_tpu_torch.sim import mpc_loop

    names = WHOLE_SIM + ("step_engine",)
    saved = {name: getattr(mpc_loop, name) for name in names}

    def recorder(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            key = name
            if name == "step_engine":  # as the plain step loop takes them
                key, t, lc, Hm, r_l, dims, iters = args
                args, kwargs = (t, lc, Hm, r_l, r_l.shape[0], iters), {}
                if key == "admm_fused":
                    kwargs.update(sigma=mpc_loop.ADMM_SIGMA,
                                  over_relax=mpc_loop.ADMM_OVER_RELAX)
                kwargs["dims"] = dims
            store[key] = (args, kwargs, out)
            return out
        return call

    for name, fn in saved.items():
        setattr(mpc_loop, name, recorder(name, fn))
    return lambda: [setattr(mpc_loop, k, v) for k, v in saved.items()]


def phase_main_path():
    """3. The seeded Wood-Berry hybrid tune on the card: the bench's tune
    row (``bench.tune_row``: bench.py's budget, its validity check and the
    tuned loop at float32 on the card against float64 on the CPU), its
    launch counts and its last batch of each whole-sim kernel against the
    plain version; returns the launch counts, the row, the tune's result
    and its case (phase 4b's bench takes the row)."""
    from mpc_tuning_tpu_torch import bench
    from mpc_tuning_tpu_torch.ops import kernels as K

    last = {}
    undo = keep_last_launches(last)
    t0 = time.perf_counter()
    K.reset_launches()
    try:
        row, res, case = bench.tune_row()
    finally:
        undo()
    launches = K.launch_counts()
    try:
        bench.run_holds([row])
    except bench.HoldFailed as exc:
        fail(f"the Wood-Berry tune: {exc}")
    wb_kernels = ("spd_factor", "spd_factor_solve", "closed_sim_admm",
                  "closed_sim_pdip")
    if min(launches[k] for k in wb_kernels) <= 0:
        fail(f"a kernel of the main path was never launched: {launches}")

    # the tune's last batch of each whole-sim kernel (the last GAM
    # generation, the last VNS evaluation), held step by step against the
    # plain version at the float32 gate on every lane
    held = []
    for name, (args, kwargs, out_k) in sorted(last.items()):
        dy, du = follow_plain(name, args, kwargs, out_k)
        ey, eu = float(dy.max()), float(du.max())
        held.append(f"{name}(B={out_k[0].shape[2]}, n={kwargs['dims']['n']}"
                    f")=Y {ey:.3e} U {eu:.3e}")
        if max(ey, eu) > F32_SIM_GATE:
            fail(f"main path's last {held[-1]}: above {F32_SIM_GATE:g}")
    Nu = np.asarray(res.Nu)
    print(f"[3 main path] bench.tune_row: mpc_tuning(WB nit=400 nbp/nbc=7/4 "
          f"f32 cuda popsize=8 gens=4 alts=2 qp_iters=15) N={res.N} "
          f"Nu={Nu.tolist()} delta={np.round(res.delta, 6).tolist()} "
          f"lam={np.round(res.lam, 6).tolist()} Fvns={res.Fvns:.6g} "
          f"Fgam={res.Fgam:.6g} wall_s={row['value']:.2f} "
          f"launches={launches} last batches vs plain: {'; '.join(held)} | "
          f"{row['held']} | phase_s={time.perf_counter() - t0:.1f}",
          flush=True)
    return launches, (row, res, case)


def phase_band_main_path():
    """3b. The seeded Shell7x5 band tune on the card at float64; returns
    the launch counts, the tune's result and its last batch's pending hold
    (for finish_band_hold)."""
    from mpc_tuning_tpu_torch.cases import shell7x5
    from mpc_tuning_tpu_torch.ops import kernels as K
    from mpc_tuning_tpu_torch.sim import mpc_loop
    from mpc_tuning_tpu_torch.tuning.api import mpc_tuning

    case = shell7x5.make_case()
    last = {}
    undo = keep_last_launches(last)
    # the candidates of the last band batch, for the certificate
    batch = mpc_loop.MPCLoop.closed_batch

    def closed_batch(self, r_b, v, N_b, Nu_b, delta_b, lam_b, *a, **kw):
        last["candidates"] = (np.asarray(N_b), np.asarray(Nu_b),
                              np.asarray(delta_b), np.asarray(lam_b))
        return batch(self, r_b, v, N_b, Nu_b, delta_b, lam_b, *a, **kw)

    mpc_loop.MPCLoop.closed_batch = closed_batch
    K.reset_launches()
    t0 = time.perf_counter()
    try:
        res = mpc_tuning(case, dtype=torch.float64, device="cuda",
                         qp_iters=60, gam_popsize=8, gam_generations=3,
                         max_alternations=1, seed=0, checkpoint_dir=None,
                         verbose=False)
        torch.cuda.synchronize()
    finally:
        mpc_loop.MPCLoop.closed_batch = batch
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    undo()
    band_kernels = ("closed_sim_band", "spd_factor", "spd_factor_solve")
    if min(launches[k] for k in band_kernels) <= 0:
        fail(f"a kernel of the band path was never launched: {launches}")
    Nu = np.asarray(res.Nu)
    lam = np.asarray(res.lam)
    if not (np.all(np.asarray(res.delta) == 0.0) and res.N > Nu.max()
            and Nu.max() >= 2 and np.isfinite(lam).all() and (lam > 0).all()):
        fail(f"invalid band tuning result N={res.N} Nu={Nu} "
             f"delta={res.delta} lam={lam}")

    # the tune's last band batch, held at the live witness along its U:
    # its plain band loops (host-bound) run in a process of their own on
    # the card beside 3k-3i (band_hold_card), held by finish_band_hold
    args, kwargs, out_k = to_cpu(last["closed_sim_band"])
    caps = (args[0]["SxF"].shape[0] // kwargs["dims"]["ny"],
            kwargs["dims"]["m_max"])
    job = start_card_process(band_hold_card, args, kwargs, out_k)
    held = (job, res, last["candidates"], out_k, caps)

    t1 = time.perf_counter()
    y, u = shell7x5.final_simulation(case, res)
    sim_s = time.perf_counter() - t1
    umax = float(np.abs(u).max())
    if not (np.isfinite(y).all() and np.isfinite(u).all()
            and umax <= U_BOUND + 1e-6):
        fail(f"band final simulation: max |u| {umax:.6g} (limit {U_BOUND})")
    print(f"[3b band path] mpc_tuning(Shell7x5 nit=200 nbp/nbc=7/4 f64 cuda "
          f"popsize=8 gens=3 alts=1 qp_iters=60) N={res.N} Nu={Nu.tolist()} "
          f"delta={np.asarray(res.delta).tolist()} "
          f"lam={np.round(lam, 6).tolist()} Fvns={res.Fvns:.6g} "
          f"Fgam={res.Fgam:.6g} wall_s={wall:.2f} launches={launches} | "
          f"last band batch vs plain: in its own process on the card, "
          f"below after 3i | final_simulation "
          f"(card, f64, {sim_s:.2f} s): max|u| {umax:.6f} |y1| end "
          f"{abs(y[-1, 0]):.6f} |y2| end {abs(y[-1, 1]):.6f} | "
          f"phase_s={time.perf_counter() - t0:.1f} (contended: beside 3j's "
          f"and the NMPC tunes' card processes)", flush=True)
    return launches, res, held


def band_hold_card(args, kwargs, out_k):
    """3b's last band batch on the card in its own process
    (start_card_process): the plain loop following the kernel's U and the
    witness of two correct runs along it (tools/band_spread); returns
    (the kernel's per-lane errors, the witness, the plain runs' seconds)
    on the CPU."""
    from mpc_tuning_tpu_torch.ops import kernels as K
    from mpc_tuning_tpu_torch.tools.band_spread import (band_lane_errors,
                                                        band_witness)

    args, kwargs, out_k = to_cpu((args, kwargs, out_k), lambda t: t.cuda())
    t0 = time.perf_counter()
    out_p = K.closed_sim_band_plain(*args, **kwargs, u_follow=out_k[1])
    errs = band_lane_errors(out_k, out_p)
    witness = band_witness(args, kwargs, out_k[1], out_p)
    return to_cpu(errs), to_cpu(witness), time.perf_counter() - t0


def finish_band_hold(held):
    """3b's last band batch (band_hold_card) at the live witness; the
    lanes over it go to the certificate relative to the plain chain."""
    import os

    from mpc_tuning_tpu_torch.ops import band_cert as bc
    from mpc_tuning_tpu_torch.tools.band_spread import band_gate

    job, res, candidates, out_k, caps = held
    (errs, witness, plain_s), proc_s, waited = collect_card_process(
        job, "3b's last band batch")
    ok, text, over = band_gate(errs, witness, caps)
    text = (f"B={out_k[0].shape[2]} caps={caps}: {text} (plain runs on the "
            f"card {plain_s:.1f} s in their own process, waited "
            f"{waited:.1f} s for it)")
    if over is None:
        fail(f"band main path's last batch {text}: above its gate")
    if over:  # the lanes over the live limits, decided by the certificate
        N_b, Nu_b, d_b, l_b = candidates
        U, E = out_k[1].numpy(), out_k[2].numpy()
        with bc.certify_pool(min(8, os.cpu_count() or 1)) as pool:
            rel = {b: bc.hold_relative(
                res.problem, N_b[b], Nu_b[b], d_b[b], l_b[b], U[:, :, b],
                E[:, b], caps=(int(N_b[b]), int(Nu_b[b])), pool=pool,
                device="cuda") for b in over}
        text += " | certificate relative to the plain chain: " + "; ".join(
            f"lane {b}: {relative_text(h)}" for b, h in rel.items())
        if not all(h["ok"] for h in rel.values()):
            fail(f"band main path's last batch {text}: off its certificate")
    print(f"[3b band path, last batch] vs plain: {text}", flush=True)


# ------------------------------------------------- 3j candidate sharding
#
# Two shards on the one card: every batch of the tune is padded to an even
# count and run as two halves, one after the other on the card's stream,
# by the engine the whole batch runs (parallel/sweep.py).
SHARD_DEVICES = ("cuda:0", "cuda:0")
SHARD_B = 8  # the band and Van de Vusse batches of 3j (b)
SHARD_BAND_CAPS = (48, 4)


def sharding_run():
    """3j (a, b), in a process of its own on the card (start_card_process,
    started after phase 3, beside 3b-3i): phase 3's Wood-Berry tune (its
    budget and seed) on two shards of the card; then a Shell7x5 band batch
    (float64, B = 8 at the (48, 4) bucket, the case's nit 200) and a Van de
    Vusse closed batch (float64, B = 8, nit 60) over two shards against the
    whole batches.  Returns plain values for phase_sharding, which holds
    them."""
    from mpc_tuning_tpu_torch.cases import shell7x5, vandevusse, woodberry
    from mpc_tuning_tpu_torch.ops import kernels as K
    from mpc_tuning_tpu_torch.parallel.sweep import candidate_mesh
    from mpc_tuning_tpu_torch.tuning.api import build_problem, mpc_tuning

    mesh = candidate_mesh(SHARD_DEVICES)
    t0 = time.perf_counter()
    K.reset_launches()
    res = mpc_tuning(woodberry.make_case(), dtype=torch.float32,
                     device="cuda", qp_iters=15, gam_popsize=8,
                     gam_generations=4, max_alternations=2, seed=0,
                     checkpoint_dir=None, verbose=False, mesh=mesh)
    torch.cuda.synchronize()
    out = dict(mesh=mesh.describe(), wall=time.perf_counter() - t0,
               tune_launches=K.launch_counts(), N=res.N,
               Nu=np.asarray(res.Nu), delta=res.delta, lam=res.lam,
               Fvns=res.Fvns, Fgam=res.Fgam, batches=[])

    rng = np.random.default_rng(13)
    K.reset_launches()
    for name, problem in (
            ("band", build_problem(shell7x5.make_case(), device="cuda")[0]),
            ("VdV", vandevusse.build_problem(vandevusse.make_case(),
                                             device="cuda"))):
        B, nit, my, nu = SHARD_B, problem.nit, problem.my, problem.nu
        if name == "band":
            N = rng.integers(SHARD_BAND_CAPS[1] + 1, SHARD_BAND_CAPS[0] + 1,
                             B)
            Nu = rng.integers(2, SHARD_BAND_CAPS[1] + 1, B)
            N[0], Nu[0] = SHARD_BAND_CAPS
        else:
            N, Nu = rng.integers(3, problem.loop.spec.p_max + 1, B), \
                rng.integers(1, 5, B)
        d = np.where(problem.band_mask, 0.0, rng.uniform(0.2, 2.0, (B, my)))
        l = rng.uniform(0.05, 0.5, (B, nu))
        r = np.broadcast_to(problem.r[:nit], (B, nit, my))
        t1 = time.perf_counter()
        Yw, Uw = problem.closed_batch(r, N, Nu, d, l)
        problem.mesh = mesh
        try:
            Ys, Us = problem.closed_batch(r, N, Nu, d, l)
        finally:
            problem.mesh = None
        equal = np.array_equal(Ys, Yw) and np.array_equal(Us, Uw)
        out["batches"].append((equal, (
            f"{name} f64 B={B} caps={problem._caps(N, Nu)} nit={nit}"
            f": shards equal the whole batch {equal} (max |dY| "
            f"{np.abs(Ys - Yw).max():.3e} |dU| "
            f"{np.abs(Us - Uw).max():.3e}, "
            f"{time.perf_counter() - t1:.1f} s)")))
    out["batch_launches"] = K.launch_counts()
    return out


def phase_sharding(job, wb_launches, wb_res, wb_wall):
    """3j (a, b), collected (sharding_run's process): the sharded tune
    gives phase 3's N, Nu, delta and lambda exactly and Fvns within 1e-6
    relative; each sharded batch equals its whole batch bit for bit.
    Returns the launch counts of both."""
    out, process_s, waited_s = collect_card_process(job, "3j (a, b)")
    tune_launches, batch_launches = out["tune_launches"], \
        out["batch_launches"]
    ref = wb_res
    rel = abs(out["Fvns"] - ref.Fvns) / max(1.0, abs(ref.Fvns))
    same = (out["N"] == ref.N and np.array_equal(out["Nu"], ref.Nu)
            and np.array_equal(out["delta"], ref.delta)
            and np.array_equal(out["lam"], ref.lam))
    wb_kernels = ("spd_factor", "spd_factor_solve", "closed_sim_admm",
                  "closed_sim_pdip")
    counts = " ".join(f"{k} {tune_launches[k]}/{wb_launches[k]}"
                      for k in wb_kernels)
    text = (f"(a) WB tune on {out['mesh']} shards (phase 3's budget, "
            f"seed 0): N={out['N']} Nu={out['Nu'].tolist()} "
            f"delta={out['delta'].tolist()} lam={out['lam'].tolist()} "
            f"Fvns={out['Fvns']!r} Fgam={out['Fgam']!r} | phase 3: N={ref.N} "
            f"Nu={np.asarray(ref.Nu).tolist()} delta={ref.delta.tolist()} "
            f"lam={ref.lam.tolist()} Fvns={ref.Fvns!r} Fgam={ref.Fgam!r} | "
            f"Fvns rel {rel:.3e} contended wall_s={out['wall']:.2f} (taken "
            f"in a second card process beside 3b-3i, so not comparable "
            f"with phase 3's tune alone, {wb_wall:.2f} s) launches "
            f"sharded/whole: {counts}")
    if not same or rel > 1e-6:
        fail(f"3j {text}: the sharded tune parts from phase 3's")
    if min(tune_launches[k] for k in wb_kernels) <= 0:
        fail(f"3j {text}: a kernel of the path was never launched")
    held = [t for _, t in out["batches"]]
    for equal, t in out["batches"]:
        if not equal:
            fail(f"3j (b) {t}")
    for k in ("closed_sim_band", "nmpc_rollout", "spd_factor"):
        if batch_launches[k] <= 0:
            fail(f"3j (b): {k} never launched: {batch_launches}")
    print(f"[3j candidate sharding] {text} | (b) {'; '.join(held)} "
          f"launches={batch_launches} | in its own process on the card, "
          f"{process_s:.1f} s from its start, waited {waited_s:.1f} s",
          flush=True)
    return {k: tune_launches[k] + batch_launches[k] for k in tune_launches}


SHARD_RANKS = (  # 3j (c): (what, multihost self-test arguments)
    ("two gloo ranks on the card, one alternation unsharded vs sharded",
     ["--mode", "alternation_bench", "--device", "cuda", "--backend",
      "gloo"]),
    ("one NCCL rank, multihost_candidate_argmin at B=256 nit 400",
     ["--nprocs", "1", "--mode", "sweep", "--device", "cuda", "--backend",
      "nccl", "--bench-B", "256", "--bench-nit", "400"]))


def start_ranks():
    """3j (c), started before the host-bound phases: each self-test of
    SHARD_RANKS in a process group of its own (killed by ``fail``)."""
    import os

    jobs = []
    for what, extra in SHARD_RANKS:
        proc = subprocess.Popen(
            [sys.executable, "-m", "mpc_tuning_tpu_torch.parallel.multihost",
             "--two-process-selftest", *extra], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        PROCS.append(proc)
        jobs.append((what, proc, time.perf_counter()))
    return jobs


def finish_ranks(jobs, timeout=600):
    """3j (c), collected before phase 4's timings: both self-tests' OK
    lines (MULTIHOST_TUNE_OK: the ranks took identical decisions, F
    within 1e-6; MULTIHOST_OK: the NCCL reduction equals the whole
    grid's argmin)."""
    from mpc_tuning_tpu_torch.parallel.report import parse_two_process_line

    t0 = time.perf_counter()
    lines = []
    for what, proc, started in jobs:
        try:
            out, _ = proc.communicate(timeout=max(1.0, timeout - (
                time.perf_counter() - started)))
        except subprocess.TimeoutExpired:
            fail(f"3j (c) {what}: over {timeout} s")
        PROCS.remove(proc)
        ok = [ln for ln in out.splitlines() if ln.startswith("MULTIHOST")]
        if proc.returncode != 0 or not ok:
            fail(f"3j (c) {what}: exit {proc.returncode}\n{out[-4000:]}")
        row = ""
        if "TUNE_OK" in ok[-1]:
            r = parse_two_process_line(ok[-1], time.perf_counter() - started)
            row = (f" (two_process_row: mesh_overhead_x "
                   f"{r.get('mesh_overhead_x')})")
        lines.append(f"{what}: {ok[-1]}{row}")
    print(f"[3j two ranks] {' | '.join(lines)} | waited_s="
          f"{time.perf_counter() - t0:.1f}", flush=True)


def phase_sharding_report():
    """4 (record). parallel/report.card_rows: the bench shape's sims/s at
    B = 1024-8192 on the card, not a gate."""
    from mpc_tuning_tpu_torch.parallel.report import card_rows

    t0 = time.perf_counter()
    rows = card_rows()
    print(f"[4 sharding report] {json.dumps(rows)} | phase_s="
          f"{time.perf_counter() - t0:.1f}", flush=True)


def vns_neighbours(best, dmin_max):
    """The distinct (N, max Nu) pairs of the valid order-1 VNS neighbours
    of the incumbent bits (tuning/vns.py's neighbourhood and validity
    gate; the objective sees only N and the largest Nu, so neighbours that
    flip a bit of a smaller Nu repeat a pair and would tie)."""
    from mpc_tuning_tpu_torch.tuning.vns import _neighborhood, bits_to_int

    pairs = set()
    for x1, x2 in _neighborhood(best["Xv1"], best["Xv2"], 1):
        N = bits_to_int(x1)
        Nu = np.array([bits_to_int(row) for row in x2])
        if N > Nu.max() and N > dmin_max and (Nu > 1).all():
            pairs.add((N, int(Nu.max())))
    Ns, Nus = zip(*sorted(pairs))
    return np.array(Ns), np.array(Nus)


def rescore_cpu(L, R, Ns, Nus, delta, lam):
    """3c's f64 re-score of the incumbent's neighbourhood through
    'pdip_ws_lanes' on the CPU (run in a worker); returns (F, seconds)."""
    from mpc_tuning_tpu_torch.cases import shell3x3
    from mpc_tuning_tpu_torch.tuning import api
    from mpc_tuning_tpu_torch.tuning.objectives import vns_objective_batch

    p64, _ = api.build_problem(shell3x3.make_case(nit=S3_NIT),
                               dtype=torch.float64, qp_iters=15, L=L, R=R,
                               device="cpu")
    p64.qp_method = p64.vns_qp_method = "pdip_ws_lanes"
    t0 = time.perf_counter()
    F = vns_objective_batch(p64, Ns, Nus, delta, lam)
    return F, time.perf_counter() - t0


def plain_follow_cpu(name, args, kwargs, U):
    """The plain step loop ``name`` (ops/kernels) on the CPU following U
    (run in a worker); returns its U."""
    from mpc_tuning_tpu_torch.ops import kernels as K

    return getattr(K, name)(*args, **kwargs, u_follow=U)[1]


def phase_step_path(pool):
    """3c. The seeded Shell3x3 hybrid tune on the card through the
    per-step engines, the f64 final simulation and the f64 re-score of the
    incumbent's neighbourhood; the CPU's runs (the re-score and the plain
    loops beside the last batches) in ``pool``'s workers while the card
    runs its own.  Returns the launch counts, the tune's shapes for phase 4
    (as TUNE_SHAPES) and the tune's result."""
    from mpc_tuning_tpu_torch.cases import shell3x3
    from mpc_tuning_tpu_torch.ops import kernels as K
    from mpc_tuning_tpu_torch.sim import mpc_loop
    from mpc_tuning_tpu_torch.tools.band_spread import lane_quantiles
    from mpc_tuning_tpu_torch.tools.pdip_spread import pdip_u_hold
    from mpc_tuning_tpu_torch.tuning import api
    from mpc_tuning_tpu_torch.tuning.objectives import vns_objective_batch

    case = shell3x3.make_case(nit=S3_NIT)
    problem, info = api.build_problem(case, dtype=torch.float32, qp_iters=15,
                                      device="cuda")
    problem.qp_method, problem.vns_qp_method = "pdip_ws_fused", "admm_fused"
    problem.admm_iters = 40
    x0 = np.concatenate([case.ov_weight0, case.mvrate_weight0])
    last = {}
    undo = keep_last_launches(last)
    K.reset_launches()
    t0 = time.perf_counter()
    # no joint (Chebyshev) weight polish: its ~250 single-candidate
    # evaluations at nit 500 would take most of the script's time limit
    best, delta, lam, Fvns, Fgam, hist = api.hybrid_tune(
        problem, case.nbp, case.nbc, x0, gam_popsize=8, gam_generations=3,
        max_alternations=1, seed=0, verbose=False, joint_polish=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    undo()
    N, Nu = int(best["N"]), np.asarray(best["Nu"])
    weights = np.concatenate([delta, lam])
    if not (N > Nu.max() and (Nu >= 2).all() and np.isfinite(weights).all()
            and (weights > 0).all() and np.isfinite([Fvns, Fgam]).all()):
        fail(f"invalid Shell3x3 tuning result N={N} Nu={Nu} "
             f"weights={weights}")

    bad = []
    L, R, Ru, Rv, S, cond_before = info
    res = api.TuningResult(N=N, Nu=Nu, delta=delta, lam=lam, L=L, R=R, Ru=Ru,
                           Rv=Rv, Fvns=Fvns, Fgam=Fgam,
                           cond_before=cond_before, cond_after=S,
                           problem=problem, checkpoint=None, history=hist)
    t1 = time.perf_counter()
    y, u = shell3x3.final_simulation(case, res)
    sim_s = time.perf_counter() - t1
    excess = max(0.0, float(np.maximum(u - case.umax, case.umin - u).max()))
    if not (np.isfinite(y).all() and np.isfinite(u).all()
            and excess <= 1e-6):
        bad.append(f"final simulation outside the input bounds by "
                   f"{excess:.3e}")

    # the incumbent's VNS neighbourhood re-scored at float64 through the
    # decision-grade 'pdip_ws_lanes': on the card (factor_lanes /
    # solve_lanes) against the plain version on the CPU
    Ns, Nus = vns_neighbours(best, int(np.max(problem.dmin)))
    m_cap = mpc_loop.horizon_caps(127, 15, Ns, Nus)[1]
    shapes = dict(rescore=(problem.my * len(Ns), m_cap * problem.nu + 1),
                  incumbent=(N, int(Nu.max())))
    cpu_rescore = pool.apply_async(rescore_cpu,
                                   (L, R, Ns, Nus, delta, lam))
    cpu_follow = {
        engine: pool.apply_async(plain_follow_cpu, (
            PLAIN[engine], to_cpu(last[engine][0]), last[engine][1],
            last[engine][2][1].cpu()))
        for engine in ("pdip_ws_fused", "admm_fused") if engine in last}
    F = {}
    p64, _ = api.build_problem(case, dtype=torch.float64, qp_iters=15, L=L,
                               R=R, device="cuda")
    p64.qp_method = p64.vns_qp_method = "pdip_ws_lanes"
    t2 = time.perf_counter()
    F["cuda"] = vns_objective_batch(p64, Ns, Nus, delta, lam)
    torch.cuda.synchronize()
    F["cuda_s"] = time.perf_counter() - t2
    launches = K.launch_counts()
    path = ("pdip_fused", "admm_fused", "factor_lanes", "solve_lanes",
            "lane_sum")
    if min(launches[k] for k in path) <= 0:
        bad.append(f"a kernel of the Shell3x3 path was never launched: "
                   f"{launches}")

    # the tune's last batch of each engine, held step by step against the
    # plain step loop (launches made here do not count).  At float32: Y at
    # F32_SIM_GATE on every lane, U at F32_SIM_GATE (ADMM) or within
    # F32_PDIP_U_CAP (PDIP) on every lane; float32 PDIP answers scatter on
    # degenerate steps (phase 2c), and the median-lane limit phase 2a sets
    # over 1024 random candidates is no statistic over the last GAM
    # batch's 8.  Beside it: the per-step |dU| quantiles over all steps and
    # lanes, and what the plain loop on the card and on the CPU differ by.
    # The same batch's inputs, cast to float64, then hold each engine's
    # kernel at F64_SIM_GATE on every lane.
    held = []
    fmt = lambda x: "/".join(f"{v:.3e}" for v in lane_quantiles(x))
    for engine in ("pdip_ws_fused", "admm_fused"):
        if engine not in last:
            fail(f"the Shell3x3 tune never ran engine {engine}")
        args, kwargs, out_k = last[engine]
        plain = getattr(K, PLAIN[engine])
        out_p = plain(*args, **kwargs, u_follow=out_k[1])
        dy, du = lane_errors(out_k, out_p)
        steps = (out_k[1] - out_p[1]).abs().amax(1).flatten()
        ey, eu = float(dy.max()), float(du.max())
        ok = ey <= F32_SIM_GATE and eu <= (
            F32_SIM_GATE if engine == "admm_fused" else F32_PDIP_U_CAP)
        cert = ""
        if engine != "admm_fused" and not ok:  # by runs one ulp away
            ok, cert = pdip_u_hold(plain, args, kwargs, *out_k[:2],
                                   F32_SIM_GATE, F32_PDIP_U_CAP, median=False)
            cert = f" [{cert}]"
        t64, lc64, Hm64, r64 = (to_f64(x) for x in args[:4])
        Y64, U64 = mpc_loop.step_engine(engine, t64, lc64, Hm64, r64,
                                        kwargs["dims"], args[5])
        d64 = lane_errors((Y64, U64), plain(t64, lc64, Hm64, r64,
                                           *args[4:], **kwargs, u_follow=U64))
        e64 = max(float(d64[0].max()), float(d64[1].max()))
        ok = ok and e64 <= F64_SIM_GATE
        wit = (out_p[1].cpu() - cpu_follow[engine].get()).abs().amax(1)
        held.append(f"{engine}(B={out_k[0].shape[2]}, n={kwargs['dims']['n']}"
                    f"): f32 Y {ey:.3e} U {eu:.3e} (per step p50/p90/p99/max "
                    f"{fmt(steps)}; plain card vs cpu {fmt(wit.flatten())})"
                    f"{cert}, the same inputs at f64 Y, U {e64:.3e}")
        if not ok:
            bad.append(held[-1])
    t2 = time.perf_counter()
    F["cpu"], F["cpu_s"] = cpu_rescore.get()
    wait_s = time.perf_counter() - t2
    gap = float(np.max(np.abs(F["cuda"] - F["cpu"]) / np.abs(F["cpu"])))
    i = int(np.argmin(F["cpu"]))
    if not (np.isfinite(F["cuda"]).all() and np.argmin(F["cuda"]) == i):
        bad.append(f"f64 re-score: card argmin {np.argmin(F['cuda'])} vs "
                   f"cpu {np.argmin(F['cpu'])} (F card {F['cuda']}, cpu "
                   f"{F['cpu']})")
    print(f"[3c step engines] hybrid_tune(Shell3x3 nit={case.nit} nbp/nbc=7/4 f32 "
          f"cuda GAM pdip_ws_fused VNS admm_fused popsize=8 gens=3 alts=1 "
          f"qp_iters=15 admm_iters=40, no joint polish) N={N} "
          f"Nu={Nu.tolist()} "
          f"delta={np.round(delta, 6).tolist()} "
          f"lam={np.round(lam, 6).tolist()} Fvns={Fvns:.6g} Fgam={Fgam:.6g} "
          f"wall_s={wall:.2f} launches={launches} | last batches vs plain: "
          f"{'; '.join(held)} | final_simulation (card, f64, {sim_s:.2f} s): "
          f"outside the input bounds by {excess:.3e} | f64 re-score of the "
          f"{len(Ns)} distinct neighbours through pdip_ws_lanes: argmin "
          f"(N, Nu) card ({Ns[np.argmin(F['cuda'])]}, "
          f"{Nus[np.argmin(F['cuda'])]}), cpu ({Ns[i]}, {Nus[i]}), F "
          f"{F['cpu'][i]:.9g}, max relative "
          f"F gap card vs cpu {gap:.3e} (card {F['cuda_s']:.1f} s, cpu "
          f"{F['cpu_s']:.1f} s in a worker, waited {wait_s:.1f} s) | "
          f"phase_s={time.perf_counter() - t0:.1f} (contended: beside 3j's "
          f"card process)",
          flush=True)
    if bad:
        fail("Shell3x3 path: " + " | ".join(bad))
    return launches, shapes, res


def phase_throughput(problem, band_problem):
    """4. Kernel, plain and library times at the bench shapes; returns
    {name: dict(ms, plain_ms, bound_ms, bound_by, library_ms)}."""
    from mpc_tuning_tpu_torch.ops import kernels as K
    from mpc_tuning_tpu_torch.tools.band_spread import band_inputs

    t0 = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    rec, txt = {}, []

    def sim_row(name, dtype, inputs, N, Nu, call, iters, **fl):
        """Event ms per call (3 calls), device ms (``device_ms``) and the
        bound of one whole-sim launch on ``inputs``."""
        t, lc, Hm, r_l, dims = inputs
        ms, out = timed(call, 3)
        read = {k: v for k, v in t.items() if k != "T2T"}  # plain's table
        b, by = bound_ms(nbytes(read, lc, Hm, r_l, out),
                         sim_flops(name, t, dims, r_l.shape[0], iters, N, Nu,
                                   **fl), dtype)
        return dict(B=r_l.shape[2], n=dims["n"], ms=ms,
                    device_ms=device_ms(call, reps=3), bound_ms=b,
                    bound_by=by)

    def sim_record(name, dtype, inputs, N, Nu, call, plain, iters, **fl):
        row = sim_row(name, dtype, inputs, N, Nu, call, iters, **fl)
        row["plain_ms"] = timed(plain, 1, warm=False)[0]
        row["library_ms"] = None
        return row

    # the bench shapes (the record's row), then the tunes' batches
    for name, engine, iters, shapes in (
            ("closed_sim_admm", "admm_sim", 40, ADMM_SHAPES),
            ("closed_sim_pdip", "pdip_sim", 15, PDIP_SHAPES)):
        rows = []
        for caps, B, seed, fixed in shapes:
            inp, N, Nu = sim_inputs(problem, caps, B, 400, f32, engine, seed,
                                    **fixed)
            extra = (1e-6, 1.6) if engine == "admm_sim" else ()
            args = (*inp[:4], 400, iters, *extra, inp[4])
            call = lambda: getattr(K, name)(*args)
            if not rows:
                row = sim_record(name, f32, inp, N, Nu, call,
                                 lambda: getattr(K, name + "_plain")(*args),
                                 iters)
            else:
                row = sim_row(name, f32, inp, N, Nu, call, iters)
            rows.append(dict(row, caps=caps))
        rec[name] = dict(rows[0], shapes=rows)
        txt.append(f"{name} f32 nit=400 iters={iters}: " + "; ".join(
            f"B={r['B']} caps={r['caps']}: kernel {r['ms']:.3f} ms (device "
            f"{fmt_ms(r['device_ms'])}) = {r['B'] * 1e3 / r['ms']:.0f} "
            f"sims/s, bound {r['bound_ms']:.5f} ({r['bound_by']})"
            + (f", plain {r['plain_ms']:.1f} ms" if "plain_ms" in r else "")
            for r in rows))

    fac, fac_txt = spd_record("spd_factor")
    sol, sol_txt = spd_record("spd_factor_solve")
    rec["spd_factor"], rec["spd_factor_solve"] = fac, sol
    txt.append(f"spd_factor {fac_txt} | spd_factor_solve, warp per system "
               f"vs the one-thread design: {sol_txt}")

    # the band kernel at BAND_SHAPES: the record's row, then the tune's
    rows = []
    for caps, B, seed in BAND_SHAPES:
        inp, N, Nu = band_inputs(band_problem, caps, B, 200, f64, seed)
        args = (*inp[:4], 200, 20, 12, inp[4])
        call = lambda: K.closed_sim_band(*args)
        if not rows:
            row = sim_record("closed_sim_band", f64, inp, N, Nu, call,
                             lambda: K.closed_sim_band_plain(*args), 0,
                             lp=20, s2=12)
        else:
            row = sim_row("closed_sim_band", f64, inp, N, Nu, call, 0, lp=20,
                          s2=12)
        t, dims = inp[0], inp[4]
        clusters = K.band_plan(dims["n"], dims["mc"], t["SxF"].shape[0],
                               dims["ny"], dims["nu"], t["A"].shape[0],
                               t["Apl"].shape[0])[0]
        rows.append(dict(row, caps=caps, clusters=clusters))
    rec["closed_sim_band"] = dict(rows[0], shapes=rows)
    txt.append("closed_sim_band f64 nit=200 lp/s2=20/12: " + "; ".join(
        f"B={r['B']} caps={r['caps']} ({r['clusters']} blocks a cluster): "
        f"kernel {r['ms']:.3f} ms (device {fmt_ms(r['device_ms'])}), bound "
        f"{r['bound_ms']:.5f} ({r['bound_by']})"
        + (f", plain {r['plain_ms']:.1f} ms" if "plain_ms" in r else "")
        for r in rows))
    print("[4 throughput] " + " | ".join(txt)
          + f" | wall_s={time.perf_counter() - t0:.1f}", flush=True)
    return rec


# phase 4's rows at the Shell3x3 tune's own batches, as phase 3c returns
# them: the f64 re-score's (lanes, n) through pdip_ws_lanes and the tuned
# incumbent's (N, max Nu); these defaults are the nit-250 tune's
TUNE_SHAPES = {"rescore": (30, 25), "incumbent": (8, 7)}


def qp_reads(name, args):
    """The tensors a single-solve kernel ``name`` reads on ``args``: its
    inputs, the warm state and G0's shared tables (the PDIP's term list
    too)."""
    from mpc_tuning_tpu_torch.ops import kernels as K

    G = args[6] if name == "pdip_fused" else args[7]
    read = [a for a in args if isinstance(a, torch.Tensor)]
    read += [args[5] if name == "pdip_fused" else args[6]]
    keys = K._QP_CSR + (K._QP_TERMS if name == "pdip_fused" else ())
    return read + [G[k] for k in keys]


# Phase 4's shapes of admm_fused beyond the record's (WB B=8192 (64,8)):
# the Shell3x3 tune's VNS batches at its widest bucket, f32, 40 iterations,
# one step's QPs (STEP_TAKE): one candidate's three selector lanes and a
# neighbourhood of 19 candidates
ADMM_FUSED_SHAPES = (((127, 15), 3), ((127, 15), 57))


def admm_fused_record(rec, args, txt):
    """admm_fused's phase-4 record ``rec`` (its ms, plain ms and bound on
    ``args``, the record's shape) with the device ms and the one-thread
    design's ms there, and the same at ADMM_FUSED_SHAPES on Shell3x3
    (under 'shapes'); appends the text to ``txt``."""
    from mpc_tuning_tpu_torch.cases import shell3x3
    from mpc_tuning_tpu_torch.ops import kernels as K
    from mpc_tuning_tpu_torch.tuning.api import build_problem

    def times(a):
        new = lambda: K.admm_fused(*a)
        old = lambda: K.admm_fused_one_thread(*a)
        return dict(ms=timed(new, 20)[0], device_ms=device_ms(new),
                    old_ms=timed(old, 20)[0], old_device_ms=device_ms(old))

    rec = dict(rec, **times(args))
    rows = [dict(case="woodberry", caps=(64, 8), B=args[1].shape[1],
                 **{k: rec[k] for k in ("ms", "device_ms", "old_ms",
                                        "old_device_ms", "bound_ms",
                                        "bound_by")})]
    s3, _ = build_problem(shell3x3.make_case(), device="cuda")
    for caps, B in ADMM_FUSED_SHAPES:
        a, N, Nu, t, dims = step_qp_args(s3, caps, B, torch.float32,
                                         "admm_fused", caps[0])
        b, by = bound_ms(nbytes(qp_reads("admm_fused", a), a[6]),
                         sim_flops("closed_sim_admm", t, dims, 1, 40, N, Nu,
                                   loop=False), torch.float32)
        rows.append(dict(case="shell3x3", caps=caps, B=B, bound_ms=b,
                         bound_by=by, **times(a)))
    rec["shapes"] = rows
    txt.append("admm_fused f32 40 it., one step's QPs, warp per lane vs the "
               "one-thread design: " + "; ".join(
                   f"{r['case']} B={r['B']} caps={r['caps']}: kernel "
                   f"{r['ms']:.4f} ms (device {fmt_ms(r['device_ms'])}), "
                   f"one-thread {r['old_ms']:.4f} ms (device "
                   f"{fmt_ms(r['old_device_ms'])}), bound "
                   f"{r['bound_ms']:.5f} ({r['bound_by']})" for r in rows))
    return rec


def pdip_fused_record(rec, args, txt, incumbent=TUNE_SHAPES["incumbent"]):
    """pdip_fused's phase-4 record ``rec`` (its ms, plain ms and bound on
    ``args``, the record's shape) with the device ms and the one-thread
    design's ms there, and the same at the Shell3x3 tune's GAM batches
    (popsize 8, f32, 15 iterations, step STEP_TAKE's QPs): the first
    bucket (127, 2) and the tuned incumbent's, (N, max Nu) ``incumbent``
    (under 'shapes'); appends the text to ``txt``."""
    from mpc_tuning_tpu_torch.cases import shell3x3
    from mpc_tuning_tpu_torch.ops import kernels as K
    from mpc_tuning_tpu_torch.sim.mpc_loop import horizon_caps
    from mpc_tuning_tpu_torch.tuning.api import build_problem

    def times(a):
        new = lambda: K.pdip_fused(*a)
        old = lambda: K.pdip_fused_one_thread(*a)
        return dict(ms=timed(new, 20)[0], device_ms=device_ms(new),
                    old_ms=timed(old, 20)[0], old_device_ms=device_ms(old))

    rec = dict(rec, **times(args))
    rows = [dict(case="woodberry", caps=(32, 4), B=args[1].shape[1],
                 **{k: rec[k] for k in ("ms", "device_ms", "old_ms",
                                        "old_device_ms", "bound_ms",
                                        "bound_by")})]
    s3, _ = build_problem(shell3x3.make_case(), device="cuda")
    N_inc, Nu_inc = incumbent
    inc_caps = horizon_caps(127, 15, [N_inc], [Nu_inc])
    for caps, N, Nu in (((127, 2), 127, 2), (inc_caps, N_inc, Nu_inc)):
        a, N_b, Nu_b, t, dims = step_qp_args(s3, caps, 8, torch.float32,
                                             "pdip_ws_fused", caps[0], N=N,
                                             Nu=Nu)
        out = K.pdip_fused(*a)
        b, by = bound_ms(nbytes(qp_reads("pdip_fused", a), out),
                         sim_flops("closed_sim_pdip", t, dims, 1, 15, N_b,
                                   Nu_b, loop=False), torch.float32)
        rows.append(dict(case="shell3x3", caps=caps, B=8, N=N, Nu=Nu,
                         bound_ms=b, bound_by=by, **times(a)))
    rec["shapes"] = rows
    txt.append("pdip_fused f32 15 it., one step's QPs, warp per lane vs the "
               "one-thread design: " + "; ".join(
                   f"{r['case']} B={r['B']} caps={r['caps']}: kernel "
                   f"{r['ms']:.4f} ms (device {fmt_ms(r['device_ms'])}), "
                   f"one-thread {r['old_ms']:.4f} ms (device "
                   f"{fmt_ms(r['old_device_ms'])}), bound "
                   f"{r['bound_ms']:.5f} ({r['bound_by']})" for r in rows))
    return rec


def solve_lanes_record(rescore=TUNE_SHAPES["rescore"]):
    """solve_lanes (one warp per system) and the one-thread design it
    replaced, CUDA-event ms per call (20 calls) and device ms per call, at
    the table's shape (f32 B=1024 n=17, with the plain version and
    torch.cholesky_solve) and at phase 3c's f64 re-score through
    pdip_ws_lanes, its (lanes, n) ``rescore``, with the bound (the factor's
    lower triangle and the rhs read, x written).  Returns the record (the
    table's keys at the first shape, every shape under 'shapes') and its
    text."""
    from mpc_tuning_tpu_torch.ops import kernels as K

    B_r, n_r = rescore
    rows = []
    for dtype, B, n in ((torch.float32, 1024, 17), (torch.float64, B_r, n_r)):
        M, rhs = spd_batch(B, n, dtype, seed=0)
        Lt = K.factor_lanes_plain(M.permute(1, 2, 0).contiguous())
        Lt, rt = Lt.contiguous(), rhs.T.contiguous()
        calls = dict(kernel=lambda: K.solve_lanes(Lt, rt),
                     old=lambda: K.solve_lanes_one_thread(Lt, rt))
        if not rows:
            calls.update(plain=lambda: K.solve_lanes_plain(Lt, rt),
                         library=lambda: torch.cholesky_solve(
                             rt.T[:, :, None], Lt.permute(2, 0, 1)))
        row = dict(dtype=str(dtype).removeprefix("torch."), B=B, n=n)
        for name, fn in calls.items():
            key = "" if name == "kernel" else name + "_"
            row[key + "ms"] = timed(fn, 20)[0]
            row[key + "device_ms"] = device_ms(fn)
        tri = n * (n + 1) // 2
        row["bound_ms"], row["bound_by"] = bound_ms(
            B * (tri + 2 * n) * M.element_size(), B * 2 * n * n, dtype)
        rows.append(row)
    rec = {k: rows[0][k] for k in ("ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by")}
    rec["shapes"] = rows
    txt = "; ".join(
        f"{r['dtype']} B={r['B']} n={r['n']}: kernel {r['ms']:.5f} ms "
        f"(device {fmt_ms(r['device_ms'])}), one-thread {r['old_ms']:.5f} "
        f"(device {fmt_ms(r['old_device_ms'])})"
        + (f", cholesky_solve {r['library_ms']:.5f}, plain "
           f"{r['plain_ms']:.5f}" if "plain_ms" in r else "")
        + f", bound {r['bound_ms']:.3g} ({r['bound_by']})" for r in rows)
    return rec, txt


def phase_step_throughput(problem, tune_shapes=TUNE_SHAPES):
    """4, the per-step engines: kernel, plain and library times of their
    kernels at the bench shapes and at the Shell3x3 tune's batches
    (``tune_shapes``, from phase 3c), and one evaluation through each
    per-step engine beside the whole-sim kernel of the same algorithm;
    returns {name: dict(ms, plain_ms, bound_ms, bound_by, library_ms)}."""
    from mpc_tuning_tpu_torch.ops import kernels as K
    from mpc_tuning_tpu_torch.sim import mpc_loop

    t0 = time.perf_counter()
    f32 = torch.float32
    rec, txt = {}, []
    fac, fac_txt = spd_record("factor_lanes")
    sol, sol_txt = solve_lanes_record(tune_shapes["rescore"])
    rec["factor_lanes"], rec["solve_lanes"] = fac, sol
    txt.append(f"factor_lanes {fac_txt} | solve_lanes, warp per system vs "
               f"the one-thread design: {sol_txt}")

    # one step's QP solve at the GAM shape (PDIP) and the VNS headline
    # shape (ADMM), the inputs of a real Wood-Berry step
    shapes = (("pdip_fused", "pdip_ws_fused", "pdip_sim", (32, 4), 2048, 15,
               dict(N=20, Nu=4, seed=2)),
              ("admm_fused", "admm_fused", "admm_sim", (64, 8), 8192, 40,
               dict(seed=1)))
    for name, engine, whole, caps, B, iters, kw in shapes:
        seed = kw.pop("seed")
        args, N, Nu, t, dims = step_qp_args(problem, caps, B, f32, engine,
                                            seed, take=40, **kw)
        ms, out = timed(lambda: getattr(K, name)(*args), 20)
        pm = timed(lambda: getattr(K, name + "_plain")(*args), 1,
                   warm=False)[0]
        read = qp_reads(name, args)
        b, by = bound_ms(nbytes(read, out),
                         sim_flops("closed_sim_" + whole[:4], t, dims, 1,
                                   iters, N, Nu, loop=False), f32)
        rec[name] = dict(ms=ms, plain_ms=pm, bound_ms=b, bound_by=by,
                         library_ms=None)
        if name == "admm_fused":
            rec[name] = admm_fused_record(rec[name], args, txt)
        else:
            rec[name] = pdip_fused_record(rec[name], args, txt,
                                          tune_shapes["incumbent"])
        # one whole evaluation (nit 400) through the per-step engine and
        # through the whole-sim kernel of the same algorithm
        inp, _, _ = sim_inputs(problem, caps, B, 400, f32, engine, seed,
                               **kw)
        step_ms = timed(lambda: mpc_loop.run_engine(engine, *inp, iters), 1,
                        warm=False)[0]
        whole_ms = timed(lambda: mpc_loop.run_engine(whole, *inp, iters), 1,
                         warm=False)[0]
        txt.append(f"{name} B={B} caps={caps} iters={iters} f32, step 40 "
                   f"of a WB loop: kernel "
                   f"{ms:.3f} ms, plain {pm:.1f} ms, bound {b:.5f} ms ({by}); "
                   f"one nit-400 evaluation: engine {engine} {step_ms:.1f} ms "
                   f"vs whole-sim {whole_ms:.1f} ms")
    # the lane_sum kernel at the Shell3x3 (127, 15) bucket's 181 rows:
    # float64 B = 1024 (the record's), float32 B = 1024 and phase 3c's
    # float64 re-score's lanes, beside its plain version (on the card) and
    # torch's column sum; bound: the bytes read once and written once
    for dtype, B in ((torch.float64, 1024), (f32, 1024),
                     (torch.float64, tune_shapes["rescore"][0])):
        g = torch.Generator(device="cuda").manual_seed(B)
        x = torch.randn((181, B), generator=g, device="cuda", dtype=dtype)
        t = dict(ms=timed(lambda: K.lane_sum(x), 50)[0],
                 plain_ms=timed(lambda: K.lane_sum_plain(x), 20)[0],
                 library_ms=timed(lambda: x.sum(0, keepdim=True), 50)[0])
        dev = device_ms(lambda: K.lane_sum(x))
        t["bound_ms"], t["bound_by"] = bound_ms((181 + 1) * B
                                                * x.element_size(),
                                                181 * B, dtype)
        rec.setdefault("lane_sum", t)
        txt.append(f"lane_sum 181 rows B={B} {str(dtype)[6:]}: kernel "
                   f"{t['ms']:.5f} ms (device {fmt_ms(dev)}), plain "
                   f"{t['plain_ms']:.5f}, torch.sum {t['library_ms']:.5f}, "
                   f"bound {t['bound_ms']:.6f} ({t['bound_by']})")
    for B in (8, 18):
        inp, _, _ = sim_inputs(problem, (64, 8), B, 400, f32, "admm_fused", 3)
        e_ms = timed(lambda: mpc_loop.run_engine("admm_fused", *inp, 40), 1,
                     warm=False)[0]
        w_ms = timed(lambda: mpc_loop.run_engine("admm_sim", *inp, 40), 1,
                     warm=False)[0]
        txt.append(f"B={B} (64,8) nit 400: admm_fused engine {e_ms:.1f} ms "
                   f"vs admm_sim {w_ms:.1f} ms")
    print("[4 step throughput] " + " | ".join(txt)
          + f" | wall_s={time.perf_counter() - t0:.1f}", flush=True)
    return rec


def vdv_rollout_args(spec, caps, B, dtype, seed, device="cuda"):
    """Seeded Van de Vusse states, previous inputs and moves around the
    operating point at capacity ``caps``, the tune's move mask (one Nu a
    candidate) spread over the inputs: (capped spec, x, u_prev, du, cmask
    (B, m nu), Nu)."""
    import dataclasses

    spec = dataclasses.replace(spec, p_max=caps[0], m_max=caps[1])
    rng = np.random.default_rng(seed)
    x = spec.x0 + rng.uniform([-0.5, -0.2, -5.0], [0.5, 0.2, 5.0], (B, 3))
    up = spec.u0 + rng.uniform(-5.0, 5.0, (B, 2))
    du = rng.uniform(-2.0, 2.0, (B, caps[1] * 2))
    Nu = rng.integers(1, caps[1] + 1, size=B)
    cm = np.repeat((np.arange(caps[1])[None] < Nu[:, None]).astype(float),
                   2, axis=1)
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    return spec, t(x), t(up), t(du), t(cm), Nu


def explicit_rollout_args(integrator, B, dtype, seed, device="cuda"):
    """The explicit NMPC's rollout at its phase 3h settings (N 5, 6
    substeps) with per-input control horizons Nu (2, 1), the mask per
    column, on seeded states around the operating point: (the controller
    as the rollout's model, x, u_prev, du, cmask (B, m nu))."""
    import dataclasses

    from mpc_tuning_tpu_torch.cases import vandevusse_explicit as vex
    from mpc_tuning_tpu_torch.models.ode import VDV_U0, VDV_X0

    ctl = dataclasses.replace(vex.make_controller(**ENMPC_KW), Nu=(2, 1),
                              integrator=integrator)
    m = max(ctl.Nu)
    rng = np.random.default_rng(seed)
    x = VDV_X0 + rng.uniform([-3.5, -0.5, -5.0], [-2.5, 0.2, 5.0], (B, 3))
    up = VDV_U0 + rng.uniform(-5.0, 5.0, (B, 2))
    du = rng.uniform(-4.0, 4.0, (B, m * 2))
    cm = np.zeros((m, 2))
    for j, nuj in enumerate(ctl.Nu):
        cm[:nuj, j] = 1.0
    cm = np.broadcast_to(cm.reshape(-1), (B, m * 2))
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    return ctl, t(x), t(up), t(du), t(cm)


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def vdv_batch(problem, B, nit, caps, seed):
    """Closed-loop arguments of B seeded Van de Vusse candidates spanning
    the bucket ``caps``."""
    rng = np.random.default_rng(seed)
    N = rng.integers(caps[1] + 1, caps[0] + 1, size=B)
    Nu = rng.integers(2, caps[1] + 1, size=B)
    N[0], Nu[0] = caps
    return (np.broadcast_to(problem.r[:nit], (B, nit, 2)), problem.v, N, Nu,
            rng.uniform(0.05, 2.0, (B, 2)), rng.uniform(0.05, 0.5, (B, 2)),
            nit)


def nmpc_errors(spec, Y, U, Yp, Up):
    """(max |dY| / sf_y, max |dU| / sf_u, raw max |dY|, raw max |dU|) of
    two NMPC loops.  The NMPC signals are in raw units (Van de Vusse: T and
    Tk near 130, the feed up to 150), so they are held in the controller's
    scaled units, its ScaleFactors sf_y / sf_u, as the linear loops are
    held in their conditioned units."""
    Y, U, Yp, Up = (x.cpu() for x in (Y, U, Yp, Up))
    sfy = torch.as_tensor(np.asarray(spec.sf_y), dtype=Y.dtype)
    sfu = torch.as_tensor(np.asarray(spec.sf_u), dtype=U.dtype)
    return (float(((Y - Yp).abs() / sfy).max()),
            float(((U - Up).abs() / sfu).max()), maxabs(Y, Yp),
            maxabs(U, Up))


def phase_nmpc_kernels(problems, pool):
    """2d. The NMPC slice's kernels vs their plain versions on the card:
    spd_solve; nmpc_rollout with each integrator (Y and J, the plant step,
    the held playback); one NMPC closed-loop batch for each integrator on
    the card, its plain loop on the CPU following the card's U started in
    ``pool`` (finish_nmpc_closed collects it).  ``problems``: {integrator:
    the Van de Vusse problem on the card}.  Returns ({name: max_abs_err
    (f64)}, the pending closed-loop holds)."""
    from mpc_tuning_tpu_torch.models import ode
    from mpc_tuning_tpu_torch.ops import kernels as K

    t0 = time.perf_counter()
    err64, rows, bad = {}, [], []
    B = 1024
    for dtype in (torch.float64, torch.float32):
        f64 = dtype == torch.float64
        tag = "f64" if f64 else "f32"
        for n in (5, 17, 31):
            M, rhs = spd_batch(B, n, dtype)
            xk, xp = K.spd_solve(M, rhs), K.spd_solve_plain(M, rhs)
            torch.cuda.synchronize()
            ex = maxabs(xk, xp)
            if f64:
                err64["spd_solve"] = max(err64.get("spd_solve", 0.0), ex)
            else:
                ex /= float(xp.abs().max())
            rows.append(f"spd_solve(n={n}):{tag}=x {ex:.3e}")
            if ex > (F64_SPD_GATE if f64 else F32_SPD_GATE):
                bad.append(rows[-1])

    for integrator, problem in problems.items():
        spec = problem.loop.spec
        for caps in ((31, 15), (16, 2), "explicit"):
            for dtype in (torch.float64, torch.float32):
                f64 = dtype == torch.float64
                tag = "f64" if f64 else "f32"
                if caps == "explicit":  # 3h's N 5, Nu (2, 1), 6 substeps
                    cspec, x, up, du, cm = explicit_rollout_args(
                        integrator, 256, dtype, 5)
                    Nu = np.full(256, max(cspec.Nu))
                    args = (cspec, x, up, du, cm, cspec.N)
                else:
                    cspec, x, up, du, cm, Nu = vdv_rollout_args(
                        spec, caps, 256, dtype, caps[0])
                    args = (cspec, x, up, du, cm, caps[0])
                Yk, Jk = K.nmpc_rollout(*args, jac=True)
                Yp, Jp = ode.nmpc_rollout_plain(*args, jac=True)
                torch.cuda.synchronize()
                if not (torch.isfinite(Yk).all() and torch.isfinite(Jk).all()):
                    fail(f"nmpc_rollout {integrator} {caps} {tag}: non-finite "
                         "output")
                ey, ej = rel(Yk, Yp), rel(Jk, Jp)
                head = (f"nmpc_rollout[{integrator}]{caps}:{tag}=Y {ey:.3e} "
                        f"J {ej:.3e}")
                if f64:
                    # the plant step (m = 0) and the open leg's held playback
                    none = torch.zeros((256, 0), dtype=dtype, device="cuda")
                    step = (cspec, x, up, none, none, 1)
                    es = rel(K.nmpc_rollout(*step, outputs=range(3))[0],
                             ode.nmpc_rollout_plain(*step,
                                                    outputs=range(3))[0])
                    hold = torch.tensor(np.maximum(Nu - 1, 0),
                                        dtype=torch.int32, device="cuda")
                    play = (cspec, x, up, du, cm, 59)
                    eh = rel(K.nmpc_rollout(*play, hold=hold)[0],
                             ode.nmpc_rollout_plain(*play, hold=hold)[0])
                    err64["nmpc_rollout"] = max(
                        err64.get("nmpc_rollout", 0.0), maxabs(Yk, Yp),
                        maxabs(Jk, Jp))
                    rows.append(head + f" plant step {es:.3e} playback "
                                f"{eh:.3e}")
                    if max(ey, ej, es, eh) > 1e-10:
                        bad.append(rows[-1])
                    continue
                lim = ROLLOUT_F32[integrator]
                if integrator == "tr_bdf2" and caps not in (
                        TRBDF2_WITNESS_CAPS, "explicit"):
                    rows.append(head + f" (limits Y {lim['y']:g} J "
                                f"{lim['j']:g}; witnesses at "
                                f"{TRBDF2_WITNESS_CAPS})")
                    if ey > lim["y"] or ej > lim["j"]:
                        bad.append(rows[-1])
                    continue
                # two correct float32 runs: the plain version on the CPU,
                # and with the states one ulp up against one ulp down
                Yc, Jc = ode.nmpc_rollout_plain(*to_cpu(args), jac=True)
                inf = torch.tensor(float("inf"), dtype=dtype, device="cuda")
                (Yu, Ju), (Yd, Jd) = (ode.nmpc_rollout_plain(
                    cspec, torch.nextafter(x, s * inf), *args[2:], jac=True)
                    for s in (1, -1))
                rows.append(head + f" (limits Y {lim['y']:g} J {lim['j']:g}; "
                            f"witnesses cpu Y {rel(Yp.cpu(), Yc):.3e} J "
                            f"{rel(Jp.cpu(), Jc):.3e}, ulp Y "
                            f"{rel(Yu, Yd):.3e} J {rel(Ju, Jd):.3e})")
                if ey > lim["y"] or ej > lim["j"]:
                    bad.append(rows[-1])

    # one closed-loop batch for each integrator on the card, held step by
    # step against the plain loop on the CPU following the card's U (in a
    # worker; finish_nmpc_closed collects it)
    caps, nit, Bc = (16, 4), 10, 32
    pending = {}
    for integrator, problem in problems.items():
        args = vdv_batch(problem, Bc, nit, caps, 5)
        t1 = time.perf_counter()
        Y, U = problem.loop.closed_batch(*args, caps=caps, device="cuda")
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t1
        spec, c, N, Nu, (r, d, l) = problem.loop._batch(
            args[1], args[2], args[3], caps, torch.float64, "cpu",
            np.asarray(args[0])[:, :nit], args[4], args[5])
        pending[integrator] = (pool.apply_async(nmpc_follow_cpu, (
            spec, c, r, N, Nu, d, l, U.cpu(), range(1, nit))), Y.cpu(),
            U.cpu(), card_s)
    print(f"[2d nmpc kernels] gates: spd_solve f64 {F64_SPD_GATE:g}, f32 "
          f"{F32_SPD_GATE:g} relative; nmpc_rollout f64 1e-10 relative, f32 "
          f"ROLLOUT_F32_LIMITS (rk4) and ROLLOUT_TRBDF2_F32_LIMITS (tr_bdf2) "
          f"| " + " | ".join(rows)
          + f" | closed loops: on the CPU in a worker, below after 3i | "
          f"wall_s={time.perf_counter() - t0:.1f}", flush=True)
    if bad:
        fail("NMPC kernel rows above their gates: " + " | ".join(bad))
    return err64, (problems, Bc, nit, caps, pending)


def finish_nmpc_closed(held):
    """2d's closed-loop batches against the plain loop on the CPU
    following the card's U (phase_nmpc_kernels started it in a worker):
    Y and U at every step at F64_SIM_GATE in the controller's scaled
    units."""
    problems, Bc, nit, caps, pending = held
    rows, bad = [], []
    t0 = time.perf_counter()
    for integrator, (job, Y, U, card_s) in pending.items():
        Yp, Up, cpu_s = job.get()
        ey, eu, ry, ru = nmpc_errors(problems[integrator].loop.spec, Y, U,
                                     Yp, Up)
        rows.append(f"{integrator} B={Bc} nit={nit} caps={caps} f64 (card "
                    f"{card_s:.1f} s, plain on the CPU following the card's "
                    f"U {cpu_s:.1f} s in a worker): scaled Y {ey:.3e} U "
                    f"{eu:.3e} (raw {ry:.3e}, {ru:.3e})")
        if not (torch.isfinite(Y).all() and max(ey, eu) <= F64_SIM_GATE):
            bad.append(rows[-1])
    print(f"[2d nmpc closed loops] gate {F64_SIM_GATE:g} in the controller's "
          f"scaled units | " + " | ".join(rows) + f" | waited "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if bad:
        fail("NMPC closed loops above the gate: " + " | ".join(bad))


def nmpc_tune(integrator):
    """The seeded Van de Vusse NMPC tune on the card at float64 with
    ``integrator`` (the case's full width: nit 60, nbp/nbc 5/4, substeps
    10, SQP 4, QP 25; popsize 8, 3 generations, 1 alternation, no joint
    weight polish), then the tuned controller's closed loop on the card.
    Returns a dict of CPU values: the result, the tune's wall and launch
    counts, the last closed-loop batch's arguments and (Y, U), and the
    final simulation's (y, u)."""
    from mpc_tuning_tpu_torch.cases import vandevusse
    from mpc_tuning_tpu_torch.ops import kernels as K
    from mpc_tuning_tpu_torch.sim import nmpc_loop
    from mpc_tuning_tpu_torch.tuning.api import hybrid_tune

    case = vandevusse.make_case(integrator=integrator)
    problem = vandevusse.build_problem(case, device="cuda")
    last = {}
    core = nmpc_loop.nmpc_closed_core

    def recorder(*args, **kwargs):
        last["args"] = args
        out = core(*args, **kwargs)
        last["out"] = out
        return out

    nmpc_loop.nmpc_closed_core = recorder
    K.reset_launches()
    t0 = time.perf_counter()
    try:
        # no joint (Chebyshev) weight polish: its ~250 single-candidate
        # evaluations would outlast the script's time limit
        best, delta, lam, Fvns, Fgam, hist = hybrid_tune(
            problem, case.nbp, case.nbc, vandevusse.X0_WEIGHTS,
            gam_popsize=8, gam_generations=3, max_alternations=1, seed=0,
            verbose=False, joint_polish=False)
        torch.cuda.synchronize()
    finally:
        nmpc_loop.nmpc_closed_core = core
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    N, Nu = int(best["N"]), np.asarray(best["Nu"])
    t1 = time.perf_counter()
    y, u = problem.loop.simulate(case.r, problem.v, case.nit, N,
                                 int(Nu.max()), delta, lam, device="cuda")
    sim_s = time.perf_counter() - t1
    spec, c, r, Nb, Nub, d, l = last["args"]
    return dict(integrator=integrator, N=N, Nu=Nu,
                delta=np.asarray(delta), lam=np.asarray(lam), Fvns=Fvns,
                Fgam=Fgam, wall=wall, launches=launches, y=y, u=u,
                sim_s=sim_s, nit=case.nit, nbp=case.nbp, nbc=case.nbc,
                last=(spec, to_cpu(c), r.cpu(), Nb.cpu(), Nub.cpu(), d.cpu(),
                      l.cpu()),
                out=tuple(x.cpu() for x in last["out"]))


def card_process_main(queue, fn, args):
    """``fn(*args)`` in a spawned process on the card; puts its result,
    pickled (tensors by value: the process ends before the parent reads
    them), or the traceback of its failure, on ``queue``."""
    import pickle

    try:
        queue.put(pickle.dumps(fn(*args)))
    except BaseException:
        import traceback

        queue.put(traceback.format_exc())


def start_card_process(fn, *args):
    """Run ``fn(*args)`` (a function of this module) in its own process on
    the card, so its host-bound eager loops run beside the main process's
    phases; returns the job for collect_card_process."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    proc = ctx.Process(target=card_process_main, args=(queue, fn, args),
                       daemon=True)
    proc.start()
    POOLS.append(proc)
    return proc, queue, time.perf_counter()


def collect_card_process(job, what, timeout=900):
    """The result of a start_card_process job, with the seconds from its
    start and the seconds waited for it here; fails if it failed."""
    import pickle
    import queue as queues

    proc, q, t0 = job
    t1 = time.perf_counter()
    try:
        res = q.get(timeout=timeout)
    except queues.Empty:
        fail(f"{what}: its process returned nothing in {timeout} s")
    proc.join()
    POOLS.remove(proc)
    if isinstance(res, str):
        fail(f"{what}: its process failed:\n{res}")
    now = time.perf_counter()
    return pickle.loads(res), now - t0, now - t1


def collect_tune(job, tag):
    """A Van de Vusse tune's dict (``nmpc_tune`` in its own process), with
    its process's seconds."""
    res, res["process_s"], res["waited_s"] = collect_card_process(
        job, f"{tag}'s tune")
    return res


def phase_nmpc_path(tag, res, pool, gate, beside):
    """3d / 3k. Checks a Van de Vusse tune's dict (``nmpc_tune``): a valid
    result, the NMPC path's kernels launched, the tuned controller's
    closed loop inside the input bounds with Cb ending within CB_TOL of
    its setpoint; prints it beside the reference's tuning and beside
    ``beside``, the other integrator's tune (not gates); starts its last
    batch's plain loop on the CPU in ``pool``'s workers, one window each
    (held at ``gate`` by finish_nmpc_hold).  Returns the launch counts and
    the pending hold."""
    from mpc_tuning_tpu_torch.cases import vandevusse

    N, Nu, delta, lam = res["N"], res["Nu"], res["delta"], res["lam"]
    launches = res["launches"]
    weights = np.concatenate([delta, lam])
    bad = []
    if not (N > Nu.max() and (Nu >= 2).all() and np.isfinite(weights).all()
            and (weights > 0).all()
            and np.isfinite([res["Fvns"], res["Fgam"]]).all()):
        fail(f"{tag}: invalid Van de Vusse tuning result N={N} Nu={Nu} "
             f"weights={weights}")
    path = ("spd_factor", "spd_factor_solve", "nmpc_rollout")
    if min(launches[k] for k in path) <= 0:
        bad.append(f"a kernel of the NMPC path was never launched: "
                   f"{launches}")

    # the tune's last closed-loop batch, step by step against the plain
    # loop on the CPU following its U (launches made there do not count):
    # Y at every step, U at the window steps (elsewhere the plain loop
    # solves nothing and returns the card's U).  The plain loop runs in two
    # workers, one window each (a window's solves need only the plant
    # stepped on the card's U), while the card goes on with the later
    # phases; finish_nmpc_hold collects them.
    spec, c, r, Nb, Nub, d, l = res["last"]
    Y, U = res["out"]
    nit = r.shape[1]
    windows = [[k for k in range(a, b + 1) if k < nit]
               for a, b in NMPC_HOLD_WINDOWS]
    pending = [pool.apply_async(nmpc_follow_cpu, (
        spec, c, r, Nb, Nub, d, l, U, w)) for w in windows]

    # the tuned controller's closed loop (the check of the verify notes):
    # u inside [LB, UB], Cb ends within CB_TOL of its setpoint
    y, u = res["y"], res["u"]
    excess = max(0.0, float(np.maximum(u - vandevusse.UB,
                                       vandevusse.LB - u).max()))
    cb_err = abs(float(y[-1, 0]) - CB_SETPOINT)
    if not (np.isfinite(y).all() and np.isfinite(u).all() and excess <= 1e-6
            and cb_err <= CB_TOL):
        bad.append(f"final simulation: outside [LB, UB] by {excess:.3e}, "
                   f"|Cb end - {CB_SETPOINT}| {cb_err:.3e}")
    ref = VDV_REFERENCE
    other = (f" | beside {beside['integrator']} (not a gate): "
             f"N={beside['N']} Nu={beside['Nu'].tolist()} "
             f"delta={np.round(beside['delta'], 6).tolist()} "
             f"lam={np.round(beside['lam'], 6).tolist()} "
             f"Fvns={beside['Fvns']:.6g} wall_s={beside['wall']:.2f}")
    where = (f" | in its own process beside phases 2-3b: "
             f"{res['process_s']:.1f} s from its start, waited "
             f"{res['waited_s']:.1f} s for it")
    print(f"[{tag} nmpc path, {res['integrator']}] hybrid_tune(VdV "
          f"nit={res['nit']} nbp/nbc={res['nbp']}/{res['nbc']} substeps="
          f"{spec.substeps} sqp={spec.sqp_iters} qp={spec.qp_iters} "
          f"integrator={spec.integrator} f64 cuda popsize=8 gens=3 alts=1 "
          f"seed=0, no joint polish) N={N} "
          f"Nu={Nu.tolist()} delta={np.round(delta, 6).tolist()} "
          f"lam={np.round(lam, 6).tolist()} Fvns={res['Fvns']:.6g} "
          f"Fgam={res['Fgam']:.6g} wall_s={res['wall']:.2f} "
          f"launches={launches} | reference artifact (BASELINE.md, another "
          f"budget; not a gate): N={ref['N']} Nu={ref['Nu']} "
          f"delta={ref['delta']} lam={ref['lam']}{other} | final "
          f"simulation (card, f64, {res['sim_s']:.2f} s): outside [LB, UB] "
          f"by {excess:.3e}, Cb end {float(y[-1, 0]):.6f}, T end "
          f"{float(y[-1, 1]):.4f} | last batch vs plain: on the CPU in "
          f"workers, below after 3i{where}", flush=True)
    if bad:
        fail(f"{tag} NMPC path: " + " | ".join(bad))
    return launches, (tag, gate, pending, spec, Y, U, r.shape[0], windows)


def nmpc_follow_cpu(spec, c, r, Nb, Nub, d, l, U, steps):
    """The plain NMPC loop on the CPU following the card's U, solving at
    ``steps`` (run in a spawned worker); returns (Yp, Up, seconds)."""
    from mpc_tuning_tpu_torch.sim import nmpc_loop

    t0 = time.perf_counter()
    Yp, Up = nmpc_loop.nmpc_closed_core(spec, c, r, Nb, Nub, d, l,
                                        u_follow=U, solve_steps=set(steps))
    return Yp, Up, time.perf_counter() - t0


def finish_nmpc_hold(held):
    """3d's / 3k's last batch against the plain loop on the CPU
    (phase_nmpc_path started it in workers): Y at every step, U at the
    window steps, at the phase's gate in the controller's scaled units."""
    from mpc_tuning_tpu_torch.cases import vandevusse

    tag, gate, pending, spec, Y, U, B, windows = held
    t0 = time.perf_counter()
    # Y is the plant on the card's U in both; U from the window's worker
    (Yp, Up, cpu_s), *rest = [p.get() for p in pending]
    for (_, Uw, secs), w in zip(rest, windows[1:]):
        Up[:, w] = Uw[:, w]
        cpu_s = max(cpu_s, secs)
    steps = [k for w in windows for k in w]
    ey, eu, ry, ru = nmpc_errors(spec, Y, U, Yp, Up)
    # (lane, step) pairs with an input on a bound: all, and those held
    Uc = U.cpu().numpy()
    on = ((Uc >= vandevusse.UB - 1e-6)
          | (Uc <= vandevusse.LB + 1e-6)).any(axis=2)
    held = (f"B={B} caps=({spec.p_max},{spec.m_max}) {spec.integrator}, Y "
            f"at steps 0-{Y.shape[1] - 1}, U at steps {NMPC_HOLD_WINDOWS}: "
            f"scaled Y {ey:.3e} U {eu:.3e} (raw {ry:.3e}, {ru:.3e}; plain "
            f"on the CPU {cpu_s:.1f} s in {len(windows)} workers, waited "
            f"{time.perf_counter() - t0:.1f} s for them); an input on a bound "
            f"at {int(on[:, 1:].sum())} "
            f"(lane, step) pairs, {int(on[:, steps].sum())} of them held")
    print(f"[{tag} nmpc path, last batch] {held} (gate {gate:g})",
          flush=True)
    if max(ey, eu) > gate:
        fail(f"{tag} NMPC path: last batch {held}")


def phase_spd_solve_entry():
    """3e. spd_solve's own path, its public entry point (no tune calls
    it, as in the JAX package): 1024 SPD systems at the NMPC QP's n = 31,
    float64; returns the launch counts."""
    from mpc_tuning_tpu_torch.ops import kernels as K

    M, rhs = spd_batch(1024, 31, torch.float64)
    K.reset_launches()
    x = K.spd_solve(M, rhs)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    res = float((torch.bmm(M, x[:, :, None])[:, :, 0] - rhs).abs().max())
    if launches["spd_solve"] != 1 or not res <= 1e-10:
        fail(f"spd_solve entry point: launches {launches['spd_solve']}, "
             f"max |M x - rhs| {res:.3e}")
    # above the envelope (n = 65) it raises and launches nothing
    M65, rhs65 = spd_batch(8, 65, torch.float64)
    try:
        K.spd_solve(M65, rhs65)
        fail("spd_solve took n = 65, above its envelope")
    except ValueError as e:
        refused = str(e)
    if K.launch_counts()["spd_solve"] != 1:
        fail("spd_solve launched above its envelope")
    print(f"[3e spd_solve] B=1024 n=31 f64: launches 1, max |M x - rhs| "
          f"{res:.3e}; n = 65 refused without a launch ({refused})",
          flush=True)
    return launches


# phase 3f: the tracking cases' horizon-check legs, card against the CPU,
# float64 (as the tests hold the port's check against the JAX package's)
HORIZON_GATE = 1e-8


def band_pulse_inputs(loop, L, N, Nu, delta, lam, v_const, nit, device,
                      pulse=5, lanes=1):
    """The band check's closed leg as cases/verify_horizons runs it (the
    pulse protocol's r and v): (args, kwargs) of closed_sim_band and of its
    plain version on ``device`` for ``lanes`` copies of the candidate (the
    check's own run takes two: ``sim/mpc_loop.pad_lanes``), and (r, v)
    NumPy."""
    from mpc_tuning_tpu_torch.sim.mpc_loop import BAND_LP_ITERS, BAND_S2_ITERS

    ny = L.shape[0]
    r = np.zeros((nit, ny))
    r[:pulse] = L @ np.ones(ny)
    v = np.tile(np.asarray(v_const, dtype=np.float64), (nit, 1))
    rep = lambda x: np.repeat(np.asarray(x)[None], lanes, axis=0)
    t, lc, Hp, r_l, dims = loop.sim_inputs(
        rep(r), v, rep(N), rep(Nu), rep(delta), rep(lam), nit,
        torch.float64, "band_sim", device)
    return ((t, lc, Hp, r_l, nit, BAND_LP_ITERS, BAND_S2_ITERS),
            dict(dims=dims), (r, v))


def band_closed_hold(args, kw, run):
    """The band check's closed leg (the card's closed_sim_band run ``run``
    = (Y, U, E) on the CPU) held as phase 3b holds the tune's last band
    batch: against the plain loop on the CPU following its U at the live
    limits of the witness measured along that U (tools/band_spread
    band_gate; Y at BAND_Y_LIMIT), a lane over them decided by the
    certificate relative to the plain chain (ops/band_cert.hold_relative,
    its replicas on the CPU).  Returns (ok, text)."""
    import types

    from mpc_tuning_tpu_torch.ops import band_cert as bc
    from mpc_tuning_tpu_torch.ops import kernels as K
    from mpc_tuning_tpu_torch.tools.band_spread import (band_gate,
                                                        band_lane_errors,
                                                        band_witness)

    loop, _, N, Nu, delta, lam = args
    pargs, pkw, (r, v) = band_pulse_inputs(*args, kw["v_const"],
                                           run[0].shape[0], "cpu")
    U_k = run[1]
    exact = K.closed_sim_band_plain(*pargs, **pkw, u_follow=U_k)
    dims = pkw["dims"]
    caps = (pargs[0]["SxF"].shape[0] // dims["ny"], dims["m_max"])
    ok, text, over = band_gate(band_lane_errors(run, exact),
                               band_witness(pargs, pkw, U_k, exact), caps)
    text = f"caps={caps}: {text}"
    if over:  # the lane over the live limits, decided by the certificate
        problem = types.SimpleNamespace(loop=loop, r=r, v=v)
        h = bc.hold_relative(problem, N, Nu, delta, lam,
                             U_k[:, :, 0].numpy(), run[2][:, 0].numpy(),
                             caps=(int(N), int(Nu)))
        ok = h["ok"]
        text += " | certificate relative to the plain chain: " + \
            relative_text(h)
    return ok, text


def phase_horizon_checks(results, pool):
    """3f. The open-vs-closed horizon check (cases/verify_horizons) of the
    tunes of phases 3 (Wood-Berry), 3b (Shell7x5, the band pulse protocol)
    and 3c (Shell3x3) on the card at float64.  Each is run again on the
    CPU in one of ``pool``'s workers (``horizon_checks_cpu``), and
    finish_horizon_checks holds the card's against it.  Returns the
    launch counts of the card's checks and the pending hold."""
    from mpc_tuning_tpu_torch.cases.verify_horizons import verify_horizons
    from mpc_tuning_tpu_torch.ops import kernels as K

    t0 = time.perf_counter()
    runs = []
    K.reset_launches()
    for name, res in results.items():
        prob = res.problem
        band = prob.loop.ctl.spec.has_y_constraints
        args = (prob.loop, res.L, res.N, int(np.max(res.Nu)), res.delta,
                res.lam)
        kw = dict(v_const=prob.v[-1]) if band else {}
        t1 = time.perf_counter()
        card = verify_horizons(*args, dtype=torch.float64, device="cuda",
                               **kw)
        torch.cuda.synchronize()
        runs.append((name, band, args, kw, card, time.perf_counter() - t1))
    launches = K.launch_counts()
    if min(launches[k] for k in ("closed_sim_band", "spd_factor",
                                 "spd_factor_solve")) <= 0:
        fail(f"a kernel of the horizon checks was never launched: "
             f"{launches}")
    # the band closed leg's kernel run again on its inputs, for its frozen
    # slacks E (held in the worker); the same run: the card's U and Y bits
    items = []
    for name, band, args, kw, card, _ in runs:
        run = None
        if band:
            kargs, kkw, _ = band_pulse_inputs(*args, kw["v_const"],
                                              card.y_closed.shape[1], "cuda",
                                              lanes=2)
            run = tuple(x[..., :1].contiguous().cpu()
                        for x in K.closed_sim_band(*kargs, **kkw))
            if not (np.array_equal(run[0][:, :, 0].numpy().T, card.y_closed)
                    and np.array_equal(run[1][:, :, 0].numpy().T,
                                       card.u_closed)):
                fail(f"{name}: closed_sim_band on the horizon check's "
                     "closed-leg inputs is not the check's closed leg")
        items.append((band, args, kw, run))
    pending = pool.apply_async(horizon_checks_cpu, (items,))
    return launches, (runs, pending, launches, time.perf_counter() - t0)


def horizon_checks_cpu(items):
    """3f's CPU side (run in a worker): for each (band, args, kw, run) the
    same check on the CPU and, for a band case, the hold of the card's
    closed-leg run ``run`` (``band_closed_hold``); returns [(cpu check,
    band_closed_hold's (ok, text) or None, seconds)]."""
    from mpc_tuning_tpu_torch.cases.verify_horizons import verify_horizons

    out = []
    for band, args, kw, run in items:
        t0 = time.perf_counter()
        cpu = verify_horizons(*args, dtype=torch.float64, device="cpu", **kw)
        held = band_closed_hold(args, kw, run) if band else None
        out.append((cpu, held, time.perf_counter() - t0))
    return out


def finish_horizon_checks(held):
    """3f's hold, each check printed with its mismatch vector and ok: the
    tracking cases' four legs card vs CPU at HORIZON_GATE; the band closed
    leg's kernel run by phase 3b's gate (``band_closed_hold``: Y, U, the
    moves and the frozen slacks against the plain loop following its U),
    the band open leg's Y against the CPU's at phase 2b's Y limit
    (tools/band_spread.BAND_Y_LIMIT; U and the free runs' distance
    reported)."""
    from mpc_tuning_tpu_torch.tools.band_spread import BAND_Y_LIMIT

    runs, pending, launches, card_phase_s = held
    t0 = time.perf_counter()
    cpu_runs = pending.get()
    wait_s = time.perf_counter() - t0
    rows, bad = [], []
    d = lambda a, b: float(np.abs(a - b).max())
    for (name, band, args, kw, card, card_s), (cpu, held, cpu_s) in zip(
            runs, cpu_runs):
        head = (f"{name} (N {args[2]}, Nu {args[3]}, nit "
                f"{card.y_closed.shape[1]}, card {card_s:.2f} s): mismatch "
                f"{np.round(card.mismatch, 6).tolist()} ok {card.ok} (cpu "
                f"{np.round(cpu.mismatch, 6).tolist()} ok {cpu.ok})")
        if band:
            closed_ok, closed_text = held
            eyo = d(cpu.y_open, card.y_open)
            rows.append(
                head + f"; closed leg (closed_sim_band) vs the plain loop "
                f"along its U {closed_text}; open leg Y {eyo:.3e} (limit "
                f"BAND_Y_LIMIT {BAND_Y_LIMIT:g}) U "
                f"{d(cpu.u_open, card.u_open):.3e}; free closed runs Y "
                f"{d(cpu.y_closed, card.y_closed):.3e} U "
                f"{d(cpu.u_closed, card.u_closed):.3e} (cpu {cpu_s:.1f} s)")
            ok = closed_ok and eyo <= BAND_Y_LIMIT
        else:
            e = {k: d(getattr(cpu, k), getattr(card, k)) for k in
                 ("y_closed", "u_closed", "y_open", "u_open")}
            rows.append(head + "; card vs cpu " + " ".join(
                f"{k} {v:.3e}" for k, v in e.items())
                + f" (limit {HORIZON_GATE:g}; cpu {cpu_s:.1f} s)")
            ok = max(e.values()) <= HORIZON_GATE
        if not (ok and card.ok == cpu.ok and np.isfinite(card.mismatch).all()):
            bad.append(rows[-1])
    print("[3f horizon checks] verify_horizons f64 on the card (tracking: "
          "closed leg 'pdip', the cold PDIP of the JAX package's check; "
          "band: 'band_sim' and the split open leg), "
          "the CPU's in a worker | " + " | ".join(rows)
          + f" | launches={launches} | phase_s={card_phase_s:.1f} on the "
          f"card, waited {wait_s:.1f} s for the CPU", flush=True)
    if bad:
        fail("horizon checks: " + " | ".join(bad))


# phase 3g: the DTC-GPC Wood-Berry loop at bench.py's shapes (:246-276),
# its B cut from 1024 to 256 to keep the script inside its time limit
DTC_B, DTC_NIT = 256, 400


def dtc_controller():
    from mpc_tuning_tpu_torch.models import plants
    from mpc_tuning_tpu_torch.ops import condmin as cm
    from mpc_tuning_tpu_torch.sim.gpc_loop import DTCGPC

    plant = plants.wood_berry()
    L, R, _ = cm.condmin(plant.G.dcgain())
    return DTCGPC.build(plant=plant.G, model=plant.G, Ts=1.0,
                        p=np.array([3, 3]), m=np.array([3, 3]),
                        delta=np.array([1.0, 1.0]), lam=np.array([1.0, 1.0]),
                        L=L, R=R, n_md=1, disturbance=plant.D)


def dtc_signals(nit, r2_at, q_at):
    """Setpoints r1 = 0.8 from step 10, r2 = 0.5 from ``r2_at``, the feed
    disturbance -0.25 from ``q_at``."""
    r = np.zeros((nit, 2))
    r[10:, 0] = 0.8
    r[r2_at:, 1] = 0.5
    q = np.zeros((nit, 1))
    q[q_at:, 0] = -0.25
    return r, q


def phase_dtc_path():
    """3g. The DTC-GPC Wood-Berry closed loop on the card (bench.py's
    shapes: p = m = [3, 3], delta = lambda = 1, condmin L and R, n_md 1, B
    = DTC_B lanes of one scenario, nit DTC_NIT): at float64 every lane
    bit-identical and lane 0 against the replay oracle simulate_ref at
    1e-8; float32 against float64 within 1e-5; the physical checks of
    tests/test_dtc_loop.py on its own signals (nit 200).  No kernel: the
    loop is eager torch ops.  Returns (controller, (r_b, q_b))."""
    from mpc_tuning_tpu_torch.ops import kernels as K

    t0 = time.perf_counter()
    ctl = dtc_controller()
    r, q = dtc_signals(DTC_NIT, 200, 300)
    r_b = np.broadcast_to(r, (DTC_B, DTC_NIT, 2))
    q_b = np.broadcast_to(q, (DTC_B, DTC_NIT, 1))
    K.reset_launches()
    out, secs = {}, {}
    for dtype in (torch.float64, torch.float32):
        t1 = time.perf_counter()
        out[dtype] = ctl.simulate_scan_batch(r_b, q_b, DTC_NIT, dtype=dtype,
                                             device="cuda")
        torch.cuda.synchronize()
        secs[dtype] = time.perf_counter() - t1
    launches = {k: v for k, v in K.launch_counts().items() if v}
    Y, U = out[torch.float64]
    same = all(torch.equal(x, x[:1].expand_as(x)) for x in (Y, U))
    t1 = time.perf_counter()
    y_ref, u_ref = ctl.simulate_ref(r, q, DTC_NIT)
    ref_s = time.perf_counter() - t1
    e_ref = max(float(np.abs(Y[0].cpu().numpy() - y_ref).max()),
                float(np.abs(U[0].cpu().numpy() - u_ref).max()))
    Y32, U32 = out[torch.float32]
    e32 = max(maxabs(Y32.double(), Y), maxabs(U32.double(), U))
    r2, q2 = dtc_signals(200, 60, 140)
    y, u = ctl.simulate_scan(r2, q2, 200, device="cuda")
    phys = (np.abs(y[135] - [0.8, 0.5]).max(),
            np.abs(y[-1] - [0.8, 0.5]).max(), np.abs(u).max(),
            np.abs(u[-1] - u[-5]).max())
    phys_ok = (phys[0] <= 5e-3 and phys[1] <= 2e-2 and phys[2] < 2.0
               and phys[3] < 1e-3)
    print(f"[3g dtc-gpc] Wood-Berry p=m=[3,3] delta=lambda=1 condmin L/R "
          f"n_md=1 B={DTC_B} nit={DTC_NIT}: f64 {secs[torch.float64]:.2f} s, "
          f"f32 {secs[torch.float32]:.2f} s (first calls); every lane "
          f"bit-identical {same}; lane 0 vs simulate_ref "
          f"{e_ref:.3e} (limit 1e-8; host oracle {ref_s:.1f} s); f32 vs f64 "
          f"{e32:.3e} (limit 1e-5); nit 200 |y[135] - r| {phys[0]:.3e} "
          f"(5e-3), |y[-1] - r| {phys[1]:.3e} (2e-2), max |u| "
          f"{phys[2]:.4f} (2), |u[-1] - u[-5]| {phys[3]:.3e} (1e-3); kernel "
          f"launches {launches or 'none'} | "
          f"phase_s={time.perf_counter() - t0:.1f}", flush=True)
    if not (same and e_ref <= 1e-8 and e32 <= 1e-5 and phys_ok
            and torch.isfinite(Y32).all()):
        fail("DTC-GPC path above its gates")
    return ctl, (r_b, q_b)


# phase 3h: the explicit NMPC demo at the JAX package's test settings
ENMPC_KW = dict(substeps=6, sqp_iters=4, qp_iters=20)
ENMPC_HOLD_NIT, ENMPC_NIT = 40, 100
ENMPC_GATE = 1e-9  # card vs the CPU, float64, Y and U


def explicit_nmpc_cpu(ctl, x0, u0, r, nit, inK, noise):
    """3h's CPU run (in a worker): (Y, U, seconds)."""
    t0 = time.perf_counter()
    Y, U = ctl.simulate(x0, u0, r, nit, inK=inK, noise=noise, device="cpu")
    return Y, U, time.perf_counter() - t0


def explicit_nmpc_inputs():
    """3h's controller, x0, u0, reference and noise (three lanes)."""
    from mpc_tuning_tpu_torch.cases import vandevusse_explicit as vex
    from mpc_tuning_tpu_torch.models.ode import (VDV_U0, VDV_X0,
                                                 newton_steady_state,
                                                 vandevusse_rhs)

    ctl = vex.make_controller(**ENMPC_KW)
    x0 = newton_steady_state(vandevusse_rhs, VDV_X0, VDV_U0)
    r = vex.make_reference(x0, ENMPC_NIT)
    noise = np.stack([np.zeros((ENMPC_NIT, 3)),
                      ctl.draw_noise(ENMPC_NIT, seed=1),
                      ctl.draw_noise(ENMPC_NIT, seed=0)])
    return ctl, x0, np.asarray(VDV_U0), r, noise


def explicit_nmpc_card():
    """3h's loop on the card (run in its own process, start_card_process):
    (Y, U, the loop's seconds, launch counts)."""
    from mpc_tuning_tpu_torch.cases import vandevusse_explicit as vex
    from mpc_tuning_tpu_torch.ops import kernels as K

    ctl, x0, u0, r, noise = explicit_nmpc_inputs()
    K.reset_launches()
    t0 = time.perf_counter()
    Y, U = ctl.simulate(x0, u0, r, ENMPC_NIT, inK=vex.INK, noise=noise,
                        device="cuda")
    return Y, U, time.perf_counter() - t0, K.launch_counts()


def start_explicit_nmpc(pool):
    """Start 3h: its loop on the card in its own process, the CPU's loop
    in one of ``pool``'s workers; returns both jobs for
    phase_explicit_nmpc."""
    from mpc_tuning_tpu_torch.cases import vandevusse_explicit as vex

    ctl, x0, u0, r, noise = explicit_nmpc_inputs()
    h = ENMPC_HOLD_NIT
    cpu = pool.apply_async(explicit_nmpc_cpu, (ctl, x0, u0, r, h, vex.INK,
                                               noise[:2, :h]))
    return start_card_process(explicit_nmpc_card), cpu, noise


def phase_explicit_nmpc(jobs):
    """3h. The explicit NMPC Van de Vusse demo on the card at float64, one
    batch of three lanes over ENMPC_NIT steps: noise-free, one given noise
    array (seed 1) and ``vandevusse_explicit.run``'s own draw (seed 0), in
    its own process beside phases 3j-3f (start_explicit_nmpc).  The first
    two held over ENMPC_HOLD_NIT steps against the same loop on the CPU
    (in a worker) at ENMPC_GATE; the third checks the staircase (the
    thresholds of tests/test_explicit_nmpc.py).  Returns (the launch
    counts, the card loop's seconds, B)."""
    t0 = time.perf_counter()
    card, cpu, noise = jobs
    (Y, U, wall, launches), proc_s, waited = collect_card_process(
        card, "3h's explicit NMPC")
    h = ENMPC_HOLD_NIT
    if min(launches[k] for k in ("spd_factor", "spd_factor_solve",
                                 "nmpc_rollout")) <= 0:
        fail(f"a kernel of the explicit NMPC path was never launched: "
             f"{launches}")
    Yc, Uc, cpu_s = cpu.get()
    ey, eu = (float(np.abs(a[:2, :h] - b).max()) for a, b in ((Y, Yc),
                                                             (U, Uc)))
    y, u = Y[2], U[2]
    stair = (np.mean(y[38:48, 0]), abs(np.mean(y[90:, 0]) - 1.0),
             abs(np.mean(y[95:, 1]) - 130.0))
    bounds = bool((u[:, 0] >= -1e-6).all() and (u[:, 0] <= 150 + 1e-6).all()
                  and (u[:, 1] >= 40 - 1e-6).all()
                  and (u[:, 1] <= 150 + 1e-6).all())
    ok = (np.isfinite(Y).all() and np.isfinite(U).all() and bounds
          and stair[0] > 1.05 and stair[1] < 0.05 and stair[2] < 0.5
          and max(ey, eu) <= ENMPC_GATE)
    print(f"[3h explicit nmpc] Van de Vusse N=5 Nu=(2,2) substeps=6 sqp=4 "
          f"qp=20 f64: B=3 lanes (noise-free, given noise seed 1, run's draw "
          f"seed 0) nit={ENMPC_NIT} on the card {wall:.2f} s (in its own "
          f"process beside 3j-3f, {proc_s:.1f} s from its start, waited "
          f"{waited:.1f} s for it), launches "
          f"{ {k: v for k, v in launches.items() if v} }; lanes 0-1 vs the "
          f"CPU over {h} steps Y {ey:.3e} U {eu:.3e} (limit {ENMPC_GATE:g}; "
          f"cpu {cpu_s:.1f} s in a worker); staircase (lane 2): mean Cb[38:48] "
          f"{stair[0]:.4f} (> 1.05), |mean Cb[90:] - 1| {stair[1]:.4f} "
          f"(< 0.05), |mean T[95:] - 130| {stair[2]:.4f} (< 0.5), inside "
          f"the input bounds {bounds} | phase_s="
          f"{time.perf_counter() - t0:.1f}", flush=True)
    if not ok:
        fail("explicit NMPC path above its gates")
    return launches, wall, Y.shape[0]


# phase 3i: the front end — the batch-major scan engines, the
# cross-evaluation, the fixed-tuning demos and the CLI, on the card
FRONT_B, FRONT_NIT = 8, 60
FRONT_ITERS = {"pdip": 15, "pdip_ws": 15, "pdip_dense": 15, "admm": 40}
CROSS_EVAL_JSON = "chiprun_out/parity_cross_eval_torch.json"
CROSS_EVAL_HELD = ("Shell3x3", "Shell3x3_caso2")  # held against the CPU
CROSS_EVAL_REL = 1e-8  # F_vns and gamma, card vs CPU, relative
CLI_ARGS = ["woodberry", "--nit", "40", "--nbp", "4", "--nbc", "2",
            "--budget", "small"]


def front_engine_args(problem, seed=12):
    """closed_batch's arguments of FRONT_B seeded Wood-Berry candidates
    over FRONT_NIT steps (the case's setpoint steps at 10 and 60 cut to
    the first)."""
    rng = np.random.default_rng(seed)
    B, nit = FRONT_B, FRONT_NIT
    N = rng.integers(5, 40, size=B)
    Nu = rng.integers(1, 8, size=B)
    return (np.broadcast_to(problem.r[:nit], (B, nit, 2)), problem.v, N, Nu,
            rng.uniform(0.2, 2.0, (B, 2)), rng.uniform(0.01, 0.5, (B, 2)))


def front_engines_cpu(runs):
    """3i's CPU side of the scan engines (in a worker): for each (engine,
    the card's U (B, nit, nu)) the plain step loop on the CPU following the
    card's U (Y, U), and the engine's own free run on the CPU (Y, U);
    returns [(followed, free, seconds)]."""
    from mpc_tuning_tpu_torch.cases import woodberry
    from mpc_tuning_tpu_torch.ops import kernels as K
    from mpc_tuning_tpu_torch.sim.mpc_loop import batch_major_step
    from mpc_tuning_tpu_torch.tuning.api import build_problem

    problem, _ = build_problem(woodberry.make_case(), device="cpu")
    args = front_engine_args(problem)
    out = []
    with torch.inference_mode():
        for engine, U_k in runs:
            t0 = time.perf_counter()
            iters = FRONT_ITERS[engine]
            t, lc, Hm, r_l, dims = problem.loop.sim_inputs(
                *args, FRONT_NIT, torch.float64, engine, "cpu")
            solve, warm = batch_major_step(engine, t, lc, dims, iters)
            Yf, Uf = K.step_loop(t, lc, r_l, dims, solve, warm,
                                 u_follow=U_k.permute(1, 2, 0))
            free = problem.loop.closed_batch(*args, FRONT_NIT, torch.float64,
                                             iters, engine=engine,
                                             device="cpu")
            out.append(((Yf.permute(2, 0, 1), Uf.permute(2, 0, 1)), free,
                        time.perf_counter() - t0))
    return out


def cross_eval_cpu(name):
    """3i's CPU run of one cross-evaluation row (in a worker)."""
    from mpc_tuning_tpu_torch.cases.cross_eval import cross_eval_case

    t0 = time.perf_counter()
    row = cross_eval_case(name, device="cpu")
    return row, time.perf_counter() - t0


def demo_cpu(name):
    """3i's CPU run of one fixed-tuning demo (in a worker): ((y, u),
    seconds)."""
    from mpc_tuning_tpu_torch.cases import demos

    t0 = time.perf_counter()
    out = getattr(demos, name)(device="cpu", **DEMO_ARGS[name])[2]
    return out, time.perf_counter() - t0


def cross_eval_claims(row) -> tuple[list, list]:
    """The claims of tests/test_cross_eval.py on one row: (the failed
    ones, [(claim, margin)]): F_vns repo <= ref, gamma repo <= ref, and
    for the linear cases the per-output horizon envelope (every output
    within max(1.3 x the reference's same output, 1.1 x its worst) and the
    total within 1.3 x the reference's)."""
    if "repo" not in row:
        return [f"{row['case']}: no repo artifact"], []
    margins = [("F_vns", row["ref"]["F_vns"] - row["repo"]["F_vns"]),
               ("gamma", row["ref"]["gamma"] - row["repo"]["gamma"])]
    if "horizon_check" in row:
        repo = np.asarray(row["horizon_check"]["mismatch"], dtype=float)
        ref = np.asarray(row["horizon_check_ref"]["mismatch"], dtype=float)
        envelope = np.maximum(1.3 * ref, 1.1 * ref.max())
        margins += [("envelope", float(np.min(envelope - repo))),
                    ("total", float(1.3 * ref.sum() - repo.sum()))]
    elif row["case"] != "VanDeVusse_NMPC":
        return [f"{row['case']}: no horizon check"], margins
    bad = [f"{row['case']}: {k} margin {m:.6g}" for k, m in margins
           if not (np.isfinite(m) and m >= 0)]
    return bad, margins


def cross_eval_diffs(card, cpu) -> tuple[dict, dict]:
    """Card vs CPU on one row: (F_vns and gamma of both points relative,
    both horizon checks' mismatch (as the rows round it) absolute; each
    claim's card-vs-CPU difference: the absolute differences of the
    quantities its margin is made of)."""
    rel = lambda a, b: abs(a - b) / abs(b)
    d = {f"{p}.{k}": rel(card[p][k], cpu[p][k])
         for p in ("ref", "repo") for k in ("F_vns", "gamma")}
    for k in ("horizon_check", "horizon_check_ref"):
        d[k] = float(np.abs(np.subtract(card[k]["mismatch"],
                                        cpu[k]["mismatch"])).max())
    ab = lambda k: sum(abs(card[p][k] - cpu[p][k]) for p in ("ref", "repo"))
    dm = max(d["horizon_check"], d["horizon_check_ref"])
    ny = len(card["horizon_check"]["mismatch"])
    return d, {"F_vns": ab("F_vns"), "gamma": ab("gamma"),
               "envelope": 2.3 * dm, "total": 2.3 * ny * dm}


def demo_on_card(name):
    """One fixed-tuning demo on the card, timed by the port's rate_of (one
    run, no warm-up: the demo builds its own problem, so a run is its own
    set-up too): ((y, u), sims/s, seconds)."""
    from mpc_tuning_tpu_torch.cases import demos
    from mpc_tuning_tpu_torch.utils.profiling import rate_of

    outs = []

    def run():
        outs.append(getattr(demos, name)(device="cuda",
                                         **DEMO_ARGS[name])[2])
        return outs[-1]

    rate, dt = rate_of(run, reps=1, warmup=False)
    return outs[-1], rate, dt


# 3i's Shell3x3 demo at the first 250 of its 500 steps (the setpoint
# changes at steps 9, 79 and 199); 500 until the script passed its time
# limit
DEMO_S3_NIT = 250
DEMO_ARGS = {"shell3x3_demo": dict(nit=DEMO_S3_NIT), "vandevusse_demo": {}}
CLI_REPORT = "chiprun_out/cli_report_torch.npz"


def cli_on_card():
    """The CLI's Wood-Berry tune on the card (CLI_ARGS, float32) with its
    report, then --resume from its state: (first payload, resumed payload,
    the report's figure count, how it was counted, seconds of each run).
    The report goes to CLI_REPORT, the figures' inputs unrendered (a chip
    host need not have matplotlib); where matplotlib imports, they are
    also rendered to HTML and its embedded figures counted."""
    import contextlib
    import importlib.util
    import io
    import os
    import tempfile

    from mpc_tuning_tpu_torch.cli import run_main
    from mpc_tuning_tpu_torch.report import figure_count, render_saved

    os.makedirs(os.path.dirname(CLI_REPORT), exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        argv = CLI_ARGS + ["--checkpoint-dir", tmp]
        secs = []
        with contextlib.redirect_stdout(io.StringIO()):
            t0 = time.perf_counter()
            first = run_main(argv + ["--report", CLI_REPORT])
            secs.append(time.perf_counter() - t0)
            again = run_main(argv + ["--resume"])
            secs.append(time.perf_counter() - t0 - secs[0])
        figures = figure_count(CLI_REPORT)
        how = "figure sets in the saved inputs (no matplotlib on this host)"
        if importlib.util.find_spec("matplotlib") is not None:
            figures = figure_count(render_saved(CLI_REPORT, f"{tmp}/rep.html"))
            how = "figures embedded in the rendered HTML"
    return first, again, figures, how, secs


def cross_eval_card():
    """3i's cross-evaluation on the card at the cases' full sizes (run in
    its own process, start_card_process): (rows, seconds, launch
    counts)."""
    import contextlib
    import io
    import os

    from mpc_tuning_tpu_torch.cases.cross_eval import cross_eval_all
    from mpc_tuning_tpu_torch.ops import kernels as K

    os.makedirs(os.path.dirname(CROSS_EVAL_JSON), exist_ok=True)
    K.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rows = cross_eval_all(out_json=CROSS_EVAL_JSON, device="cuda")
    torch.cuda.synchronize()
    return rows, time.perf_counter() - t0, K.launch_counts()


def start_front_end_cpu(pool):
    """3i's CPU runs that need nothing from the card (the demos and the
    CROSS_EVAL_HELD rows on the CPU), started in ``pool``'s workers early,
    while the pool is idle; returns them pending."""
    pending = {name: pool.apply_async(demo_cpu, (name,))
               for name in ("vandevusse_demo", "shell3x3_demo")}
    pending.update({name: pool.apply_async(cross_eval_cpu, (name,))
                    for name in CROSS_EVAL_HELD})
    return pending


def phase_front_end(pool, cross_job, pending):
    """3i. The front end on the card at its normal entry points, its CPU
    holds in ``pool``'s workers (``pending``: those start_front_end_cpu
    started early; the scan engines' started here):
      * the batch-major scan engines 'pdip', 'pdip_ws', 'pdip_dense',
        'admm' on Wood-Berry (B = FRONT_B, nit FRONT_NIT, float64), each
        held step by step against the plain loop on the CPU following the
        card's U at F64_SIM_GATE (the free CPU run's distance printed);
      * ``cross_eval_all`` at the cases' full sizes, run in its own
        process (``cross_job``, cross_eval_card; its rows written to
        CROSS_EVAL_JSON): every row has the repo point and the three
        claims of tests/test_cross_eval.py hold; the CROSS_EVAL_HELD rows
        against the same on the CPU (F_vns and gamma at CROSS_EVAL_REL
        relative, the mismatch at HORIZON_GATE);
      * the demos ``shell3x3_demo(nit=DEMO_S3_NIT)`` and
        ``vandevusse_demo()`` (nit 60) against the CPU at F64_SIM_GATE
        (NMPC in scaled units), with their sims/s by
        ``utils/profiling.rate_of``;
      * the CLI: ``run_main`` with CLI_ARGS and a report (CLI_REPORT),
        then --resume: the same N and Nu, a report with 3 figures.
    Returns the launch counts of the card's runs and the pending holds."""
    from mpc_tuning_tpu_torch.cases import woodberry
    from mpc_tuning_tpu_torch.ops import kernels as K
    from mpc_tuning_tpu_torch.sim.mpc_loop import BATCH_MAJOR_ENGINES
    from mpc_tuning_tpu_torch.tuning.api import build_problem

    t0 = time.perf_counter()
    total = dict.fromkeys(K.launch_counts(), 0)
    parts = {}

    def count(part):
        c = K.launch_counts()
        parts[part] = {k: v for k, v in c.items() if v}
        for k, v in c.items():
            total[k] += v
        K.reset_launches()

    problem, _ = build_problem(woodberry.make_case(), device="cuda")
    args = front_engine_args(problem)
    engines = {}
    K.reset_launches()
    for engine in BATCH_MAJOR_ENGINES:
        t1 = time.perf_counter()
        Y, U = problem.loop.closed_batch(*args, FRONT_NIT, torch.float64,
                                         FRONT_ITERS[engine], engine=engine,
                                         device="cuda")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        count(engine)
        engines[engine] = (Y.cpu(), U.cpu(), ms)
    pending["engines"] = pool.apply_async(
        front_engines_cpu, ([(e, v[1]) for e, v in engines.items()],))

    demos = {}
    for name in ("shell3x3_demo", "vandevusse_demo"):
        demos[name] = demo_on_card(name)
        count(name)
    cli = cli_on_card()
    count("cli")
    (rows, cross_s, counts), _, _ = collect_card_process(
        cross_job, "3i's cross-evaluation")
    parts["cross_eval"] = {k: v for k, v in counts.items() if v}
    for k, v in counts.items():
        total[k] += v
    return total, (engines, rows, cross_s, demos, cli, parts, pending,
                   time.perf_counter() - t0)


def finish_front_end(held):
    """3i's holds, once its CPU runs are in: one line each for the scan
    engines, the cross-evaluation, the demos and the CLI; fails on any."""
    from mpc_tuning_tpu_torch.cases import vandevusse

    engines, rows, cross_s, demos, cli, parts, pending, card_s = held
    t0 = time.perf_counter()
    got = {k: p.get() for k, p in pending.items()}
    wait_s = time.perf_counter() - t0
    bad = []

    texts = []
    for (engine, (Y, U, ms)), (fol, free, cpu_s) in zip(engines.items(),
                                                        got["engines"]):
        e = (maxabs(Y, fol[0]), maxabs(U, fol[1]))
        texts.append(
            f"{engine} ({FRONT_ITERS[engine]} it.) {ms:.1f} ms a loop, "
            f"launches {parts[engine]}: followed Y {e[0]:.3e} U {e[1]:.3e}; "
            f"free Y {maxabs(Y, free[0]):.3e} U {maxabs(U, free[1]):.3e} "
            f"(cpu {cpu_s:.1f} s)")
        if not (max(e) <= F64_SIM_GATE and torch.isfinite(U).all()):
            bad.append(f"scan engine {engine}: {texts[-1]}")
        if (engine != "admm") != (parts[engine].get("spd_factor", 0) > 0):
            bad.append(f"scan engine {engine} launches {parts[engine]}")
    print(f"[3i scan engines] Wood-Berry B={FRONT_B} nit={FRONT_NIT} f64 on "
          f"the card vs the plain loop on the CPU following its U (limit "
          f"{F64_SIM_GATE:g}) | " + " | ".join(texts), flush=True)

    texts = []
    for row in rows:
        fails, margins = cross_eval_claims(row)
        bad += fails
        text = (f"{row['case']}: F_vns repo {row['repo']['F_vns']:.10g} ref "
                f"{row['ref']['F_vns']:.10g}, gamma repo "
                f"{row['repo']['gamma']:.6g} ref {row['ref']['gamma']:.6g}"
                if "repo" in row else f"{row['case']}: no repo point")
        if "horizon_check" in row:
            text += (f", mismatch repo {row['horizon_check']['mismatch']} "
                     f"ref {row['horizon_check_ref']['mismatch']}")
        text += " | margins " + " ".join(f"{k} {m:.4g}" for k, m in margins)
        if row["case"] in CROSS_EVAL_HELD:
            cpu, cpu_s = got[row["case"]]
            d, claim_d = cross_eval_diffs(row, cpu)
            text += " | card vs cpu " + " ".join(
                f"{k} {v:.3e}" for k, v in d.items()) + f" (cpu {cpu_s:.1f} s)"
            small = [f"{k} margin {m:.4g} vs card-cpu {claim_d[k]:.3e}"
                     for k, m in margins if abs(m) <= claim_d[k]]
            if small:
                text += " | margins below the card-vs-cpu difference: " + \
                    ", ".join(small)
            if max(d[k] for k in d if "." in k) > CROSS_EVAL_REL or max(
                    d["horizon_check"], d["horizon_check_ref"]) > HORIZON_GATE:
                bad.append(f"cross-eval {row['case']} card vs cpu: {d}")
        texts.append(text)
    print(f"[3i cross-eval] cross_eval_all f64 on the card, all four cases "
          f"at full size, {cross_s:.1f} s, rows in {CROSS_EVAL_JSON}, "
          f"launches {parts['cross_eval']} | " + " | ".join(texts),
          flush=True)

    spec = vandevusse.make_case().spec
    texts = []
    for name, ((y, u), rate, dt) in demos.items():
        (yc, uc), cpu_s = got[name]
        if name == "vandevusse_demo":
            sfy, sfu = np.asarray(spec.sf_y), np.asarray(spec.sf_u)
            e = (float(np.abs((y - yc) / sfy).max()),
                 float(np.abs((u - uc) / sfu).max()))
        else:
            e = (float(np.abs(y - yc).max()), float(np.abs(u - uc).max()))
        texts.append(f"{name} nit {len(y)}: {rate:.4f} sims/s ({dt:.2f} s a "
                     f"sim), launches {parts[name]}; card vs cpu Y {e[0]:.3e} "
                     f"U {e[1]:.3e} (cpu {cpu_s:.1f} s)")
        if not (max(e) <= F64_SIM_GATE and np.isfinite(u).all()):
            bad.append(f"demo {texts[-1]}")
    print(f"[3i demos] f64 on the card against the CPU (limit "
          f"{F64_SIM_GATE:g}; Van de Vusse in scaled units) | "
          + " | ".join(texts), flush=True)

    first, again, figures, how, secs = cli
    same = (first["N"] == again["N"] and first["Nu"] == again["Nu"])
    print(f"[3i cli] run_main {' '.join(CLI_ARGS)} (float32 on the card, "
          f"{secs[0]:.1f} s with the report {CLI_REPORT}): N {first['N']} Nu "
          f"{first['Nu']} Fvns {first['Fvns']:.6g}; --resume ({secs[1]:.1f} "
          f"s): N {again['N']} Nu {again['Nu']} Fvns {again['Fvns']:.6g}; "
          f"report: {figures} {how}; launches {parts['cli']} | phase_s="
          f"{card_s:.1f} on the card, waited {wait_s:.1f} s for the CPU",
          flush=True)
    if not (same and figures == 3 and first["N"] > max(first["Nu"])
            and np.isfinite(first["Fvns"])):
        bad.append(f"cli: {first} / {again} / figures {figures}")
    if bad:
        fail("front end: " + " | ".join(bad))


def phase_dtc_nmpc_throughput(dtc, enmpc):
    """4, the DTC-GPC and explicit NMPC paths: DTC-GPC sims/s at bench.py's
    shape (B = DTC_B, nit DTC_NIT; CUDA events, mean of 3 after a warm-up)
    at float64 and float32, with the device time and idle share of a
    20-step loop of the same batch (torch.profiler); the explicit NMPC
    loop's seconds (phase 3h's run)."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    ctl, (r_b, q_b) = dtc
    txt = []
    for dtype in (torch.float64, torch.float32):
        run = lambda n=DTC_NIT: ctl.simulate_scan_batch(
            r_b, q_b, n, dtype=dtype, device="cuda")
        ms = timed(run, 3)[0]
        run(20)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(20)
            torch.cuda.synchronize()
        short_s = time.perf_counter() - t1
        dev_us = sum(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
                     for e in prof.key_averages())
        busy = (f"a 20-step loop: device {dev_us / 1e3:.2f} ms of "
                f"{short_s * 1e3:.1f} ms, idle share "
                f"{1 - dev_us / 1e6 / short_s:.3f}" if dev_us > 0
                else "device time not measured (the profiler showed none)")
        txt.append(f"DTC-GPC {str(dtype).removeprefix('torch.')} B={DTC_B} "
                   f"nit={DTC_NIT}: {ms:.1f} ms = "
                   f"{DTC_B / (ms / 1e3):.1f} sims/s; {busy}")
    _, wall, B = enmpc
    txt.append(f"explicit NMPC (3h, beside 3j-3f) nit={ENMPC_NIT} B={B}: "
               f"{wall:.2f} s a "
               f"loop, {wall / ENMPC_NIT * 1e3:.1f} ms a step")
    print("[4 dtc / explicit nmpc throughput] " + " | ".join(txt)
          + f" | wall_s={time.perf_counter() - t0:.1f}", flush=True)


def newton_iterations(model, x, u_prev, du, cmask, p):
    """The Newton iterations a TR-BDF2 stage of this rollout runs, on
    average over candidates, stages and substeps: each stage's loop up to
    and including the first iteration that leaves its iterate unchanged
    (the kernel stops there: ops/csrc/nmpc.cu newton_update), counted
    along the plain version's iterates without J (the kernel rounds its
    Newton steps otherwise, so its own count may differ by an iteration
    here and there)."""
    from mpc_tuning_tpu_torch.models import ode

    runs = []
    plain = ode._newton_solve

    def counting(res, jac, x_guess, iters):
        z = x_guess
        done = torch.zeros(z.shape[:-1], dtype=torch.bool, device=z.device)
        n = torch.zeros(z.shape[:-1], dtype=torch.float64, device=z.device)
        for _ in range(iters):
            zn = z - torch.linalg.solve(jac(z), res(z))
            n += (~done).double()
            done |= (zn == z).all(-1)
            z = zn
        runs.append(n.mean())
        return z

    ode._newton_solve = counting
    try:
        ode.nmpc_rollout_plain(model, x, u_prev, du, cmask, p)
    finally:
        ode._newton_solve = plain
    return float(torch.stack(runs).mean())


def rollout_flops(B, ncol, p, substeps, integrator="rk4", newton=6.0):
    """Operations the rollout needs, per candidate and substep: what a
    candidate's tangent columns share once, and each column's own work
    once per column (fx has one zero entry; fu du is 5 operations for
    Van de Vusse's 3 x 2 fu).  RK4, shared: 4 rhs of ~41 operations (the
    3 exp among them), the stage states and sum (39), fx at the 4 stage
    states around their rates (4 x 43) and fu (4 x 3); per column, 4
    stages of fx dx + fu du (21) and the tangent's stage states and sum
    (39).  TR-BDF2, shared: the rhs and fx at x (84), the first guess (6),
    6 trapezoidal and 6 BDF2 Newton iterations (144 / 150: the rhs and fx,
    the residual, I - a fx, its 3 x 3 LU and substitutions, the update;
    ``newton`` of them a stage, those this run's data needs:
    newton_iterations), fx at the converged xg and xn (2 x 53, the rates
    recomputed), the two LU factors of I - a fx (2 x 30) and fu at three
    states (9); per column, fx(x) dx (13), fu du at three states (15), the
    two right-hand sides (12 + 15) and two substitutions (2 x 15)."""
    if integrator == "tr_bdf2":
        shared = (84 + 6 + newton * (144 + 150) + 2 * 53 + 2 * 30 + 9)
        return B * p * substeps * (shared + ncol * (13 + 15 + 27 + 30))
    return B * p * substeps * ((4 * 41 + 39 + 4 * 43 + 12)
                               + ncol * (4 * 21 + 39))


def phase_nmpc_throughput(vdv_problems):
    """4, the NMPC slice: spd_solve, nmpc_rollout with each integrator (a
    row each under 'shapes', RK4's at the top level) and the device time
    of a 4-step NMPC closed loop (B = 256, caps (16, 2), float64) with
    each integrator (the whole evaluation, at float32, is the bench's Van
    de Vusse row, phase 4b; the float64 whole evaluation is not timed);
    returns {name: dict(ms, plain_ms, bound_ms, bound_by, library_ms)}."""
    from mpc_tuning_tpu_torch.models import ode
    from mpc_tuning_tpu_torch.ops import kernels as K

    t0 = time.perf_counter()
    rec, txt = {}, []
    f32, f64 = torch.float32, torch.float64
    # spd_solve (warp per system) beside the one-thread design it replaced,
    # at f32 B=1024 n=17 (the record's) and at 3e's f64 B=1024 n=31
    for dtype, n in ((f32, 17), (f64, 31)):
        M, rhs = spd_batch(1024, n, dtype, seed=0)

        def library():
            L, _ = torch.linalg.cholesky_ex(M)
            return torch.cholesky_solve(rhs[:, :, None], L)

        calls = dict(kernel=lambda: K.spd_solve(M, rhs),
                     old=lambda: K.spd_solve_one_thread(M, rhs),
                     plain=lambda: K.spd_solve_plain(M, rhs), library=library)
        sol = {}
        for name, fn in calls.items():
            key = "" if name == "kernel" else name + "_"
            sol[key + "ms"] = timed(fn, 20)[0]
            if name in ("kernel", "old"):  # both designs' device time
                sol[key + "device_ms"] = device_ms(fn)
        # M's lower triangle (all the factor reads) and rhs read, x
        # written; the factor's n^3 / 3 and the solves' 2 n^2 operations
        # (as PERF.md's kernel table, row 3)
        tri = n * (n + 1) // 2
        sol["bound_ms"], sol["bound_by"] = bound_ms(
            1024 * (tri + 2 * n) * M.element_size(),
            1024 * (n ** 3 / 3 + 2 * n * n), dtype)
        if "spd_solve" not in rec:
            rec["spd_solve"] = {k: sol[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
        tag = str(dtype).removeprefix("torch.")
        txt.append(
            f"spd_solve B=1024 n={n} {tag}: kernel {sol['ms']:.5f} ms "
            f"(device {fmt_ms(sol['device_ms'])}), one-thread "
            f"{sol['old_ms']:.5f} (device {fmt_ms(sol['old_device_ms'])}), "
            f"plain {sol['plain_ms']:.5f}, cholesky_ex + cholesky_solve "
            f"{sol['library_ms']:.5f}, bound {sol['bound_ms']:.5f} "
            f"({sol['bound_by']})")

    # the rollout: the kernel with J, without J (the primal alone) and
    # the thread-per-column design it replaced, in turns, at the tunes'
    # batches and the record's B = 256; the record row f64 B=256 (31, 15)
    # with J, its plain version and its bound (float64 outside the tensor
    # cores)
    caps, rows = (31, 15), []
    for integrator, problem in vdv_problems.items():
        grid = []
        for shape in ROLLOUT_TIMING_CAPS:
            for B in ROLLOUT_TIMING_B:
                cspec, x, up, du, cm, _ = vdv_rollout_args(
                    problem.loop.spec, shape, B, f64, 9)
                a = (cspec, x, up, du, cm, shape[0])
                t = {}
                for name, fn in (
                        ("new", lambda: K.nmpc_rollout(*a, jac=True)),
                        ("primal", lambda: K.nmpc_rollout(*a)),
                        ("old", lambda: K.nmpc_rollout_thread_per_column(
                            *a, jac=True)),
                        ("old_primal",
                         lambda: K.nmpc_rollout_thread_per_column(*a))):
                    t[name] = timed(fn, 5)[0]
                grid.append(dict(caps=list(shape), B=B, **t))
        cspec, x, up, du, cm, _ = vdv_rollout_args(problem.loop.spec, caps,
                                                   256, f64, 9)
        args = (cspec, x, up, du, cm, caps[0])
        ms, out = timed(lambda: K.nmpc_rollout(*args, jac=True), 5)
        pm = timed(lambda: ode.nmpc_rollout_plain(*args, jac=True), 1,
                   warm=False)[0]
        newton = (newton_iterations(*args) if integrator == "tr_bdf2"
                  else 0.0)
        b, by = bound_ms(nbytes(x, up, du, cm, out),
                         rollout_flops(256, 30, caps[0], cspec.substeps,
                                       integrator, newton), f64,
                         FP64_SIMT_FLOPS)
        rec256 = next(g for g in grid
                      if tuple(g["caps"]) == caps and g["B"] == 256)
        rows.append(dict(stepper=integrator, ms=ms, plain_ms=pm,
                         bound_ms=b, bound_by=by, library_ms=None,
                         old_ms=rec256["old"], primal_ms=rec256["primal"],
                         timings=grid))
        its = (f", {newton:.3f} Newton iterations a stage"
               if integrator == "tr_bdf2" else "")
        txt.append(f"nmpc_rollout[{integrator}] B=256 caps={caps} "
                   f"substeps={cspec.substeps} f64 with J: kernel {ms:.4f} "
                   f"ms, plain {pm:.1f} ms, bound {b:.5f} ms ({by}, "
                   f"{FP64_SIMT_FLOPS:g} FLOP/s{its}); ms per launch (with "
                   f"J / without, thread per column with J / without): "
                   + ", ".join(f"{tuple(g['caps'])} B={g['B']} "
                               f"{g['new']:.4f} / {g['primal']:.4f}, "
                               f"{g['old']:.4f} / {g['old_primal']:.4f}"
                               for g in grid))
    # one row a stepper under 'shapes'; the top-level numbers are the
    # first stepper's, RK4, the default path's (vdv_problems' order)
    rec["nmpc_rollout"] = dict(rows[0], shapes=rows)

    # the device time inside a 4-step NMPC closed loop (torch.profiler,
    # CUDA activity only: recording every host op costs ~0.4 ms an op,
    # minutes over the ~1e6 ops of a whole evaluation)
    from torch.profiler import ProfilerActivity, profile

    for integrator, problem in vdv_problems.items():
        loop = problem.loop
        args = vdv_batch(problem, 256, 60, (16, 2), 11)
        head = f"NMPC closed loop[{integrator}] B=256 caps=(16,2)"
        short = args[:6] + (4,)
        t2 = time.perf_counter()
        loop.closed_batch(*short, caps=(16, 2), device="cuda")
        torch.cuda.synchronize()
        short_s = time.perf_counter() - t2
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            loop.closed_batch(*short, caps=(16, 2), device="cuda")
            torch.cuda.synchronize()
        dev_us = sum(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
                     for e in prof.key_averages())
        busy = (f"device time {dev_us / 1e3:.1f} ms of {short_s * 1e3:.1f} "
                f"ms, idle share {1 - dev_us / 1e6 / short_s:.3f}"
                if dev_us > 0 else
                "device time not measured (the profiler showed none)")
        txt.append(f"{head} a 4-step loop (f64): {busy}")
    print("[4 nmpc throughput] " + " | ".join(txt)
          + f" | wall_s={time.perf_counter() - t0:.1f}", flush=True)
    return rec


def phase_bench(wb_tune, pool, card):
    """4b. The bench (mpc_tuning_tpu_torch/bench.py): its rows at bench.py's
    shapes through the port's entry points (``bench.run_rows``), one timed
    run each after the warm-up, with nothing else running; then every
    row's hold at once in ``pool``'s workers; the tune row is phase 3's
    (``wb_tune``).  Prints the bench's JSON line (``bench.bench_line``).
    Returns the launches of the rows' runs, warm-ups included (the tune's
    are phase 3's)."""
    from mpc_tuning_tpu_torch import bench
    from mpc_tuning_tpu_torch.ops import kernels as K

    t0 = time.perf_counter()
    K.reset_launches()
    rows = bench.run_rows(reps=1)
    launches = K.launch_counts()
    timed_s = time.perf_counter() - t0
    held = [rows["head"], rows["qp"], *rows["extra"]]
    jobs = [pool.apply_async(*row["held"]) for row in held]
    try:
        for row, job in zip(held, jobs):
            row["held"] = job.get()
    except bench.HoldFailed as exc:
        fail(f"4b bench: {exc}")
    line = bench.bench_line(rows, wb_tune[0], card)
    print(json.dumps(line), flush=True)
    d = line["detail"]
    print(f"[4b bench] {line['metric']} {line['value']} sims/s: "
          f"{d['held']} | qp_p50_latency_us {d['qp_p50_latency_us']}: "
          f"{d['qp_p50_held']} | "
          + " | ".join(f"{m['metric']} {m['value']} {m['unit']}: "
                       f"{m['held']}" for m in d["extra_metrics"])
          + f" | launches={launches} | rows timed in {timed_s:.1f} s, "
          f"wall_s={time.perf_counter() - t0:.1f}", flush=True)
    return launches


def main():
    t_start = time.perf_counter()
    card = phase_env()
    # 3k's and 3d's tunes, host-bound, each in its own process on the card
    # beside phases 2-3b
    tune_jobs = {integrator: start_card_process(nmpc_tune, integrator)
                 for integrator in ("tr_bdf2", "rk4")}
    pool = cpu_pool()  # started here, while the card's phases need no CPU
    from mpc_tuning_tpu_torch.cases import (shell3x3, shell7x5, vandevusse,
                                            woodberry)
    from mpc_tuning_tpu_torch.tuning.api import build_problem

    problem, _ = build_problem(woodberry.make_case(), device="cuda")
    band_problem, _ = build_problem(shell7x5.make_case(), device="cuda")
    s3_problem, _ = build_problem(shell3x3.make_case(), device="cuda")
    vdv_problems = {integrator: vandevusse.build_problem(
        vandevusse.make_case(integrator=integrator), device="cuda")
        for integrator in ("rk4", "tr_bdf2")}
    err64 = phase_kernels(problem)
    err64["closed_sim_band"], band_cert = phase_band_kernels(band_problem,
                                                             pool)
    # after 2b's certificates, which take the host's cores
    front_cpu = start_front_end_cpu(pool)
    err64.update(phase_step_kernels(s3_problem))
    nmpc_err, nmpc_closed = phase_nmpc_kernels(vdv_problems, pool)
    err64.update(nmpc_err)
    wb_launches, wb_tune = phase_main_path()
    # 3j (a, b), host-bound, in its own process on the card beside 3b-3i
    shard_job = start_card_process(sharding_run)
    band_launches, band_res, band_held = phase_band_main_path()
    wb_res, wb_wall = wb_tune[1], wb_tune[0]["value"]
    stiff, rk4 = (collect_tune(tune_jobs[i], tag)
                  for i, tag in (("tr_bdf2", "3k"), ("rk4", "3d")))
    # 3i's cross-evaluation and 3h's loop, each in its own process beside
    # 3j-3f
    cross_job = start_card_process(cross_eval_card)
    enmpc_jobs = start_explicit_nmpc(pool)
    stiff_launches, stiff_held = phase_nmpc_path(
        "3k", stiff, pool, NMPC_TRBDF2_HOLD_GATE, beside=rk4)
    nmpc_launches, nmpc_held = phase_nmpc_path(
        "3d", rk4, pool, F64_SIM_GATE, beside=stiff)
    launches, tune_shapes, s3_res = phase_step_path(pool)
    ranks = start_ranks()  # beside the host-bound phases 3e-3i
    paths = [wb_launches, band_launches, launches, nmpc_launches,
             stiff_launches, phase_spd_solve_entry()]
    horizon_launches, horizon_held = phase_horizon_checks(
        {"WoodBerry": wb_res, "Shell7x5": band_res, "Shell3x3": s3_res}, pool)
    paths.append(horizon_launches)
    dtc = phase_dtc_path()
    enmpc = phase_explicit_nmpc(enmpc_jobs)
    paths.append(enmpc[0])
    front_launches, front_held = phase_front_end(pool, cross_job, front_cpu)
    paths.append(front_launches)
    paths.append(phase_sharding(shard_job, wb_launches, wb_res, wb_wall))
    finish_band_cert(band_cert)
    finish_band_hold(band_held)
    finish_horizon_checks(horizon_held)
    finish_nmpc_closed(nmpc_closed)
    finish_nmpc_hold(stiff_held)
    finish_nmpc_hold(nmpc_held)
    finish_front_end(front_held)
    finish_ranks(ranks)
    rec = phase_throughput(problem, band_problem)
    rec.update(phase_step_throughput(problem, tune_shapes))
    rec.update(phase_nmpc_throughput(vdv_problems))
    phase_dtc_nmpc_throughput(dtc, enmpc)
    phase_sharding_report()
    paths.append(phase_bench(wb_tune, pool, card))
    close_pool(pool)
    # each stepper's launches on the main path: TR-BDF2 runs only in 3k
    # (every other Van de Vusse path takes make_case()'s RK4)
    total = sum(launches["nmpc_rollout"] for launches in paths)
    per_stepper = {"tr_bdf2": stiff_launches["nmpc_rollout"]}
    per_stepper["rk4"] = total - per_stepper["tr_bdf2"]
    for row in rec["nmpc_rollout"]["shapes"]:
        row["launches"] = per_stepper[row["stepper"]]
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(launches[k] for launches in paths),
         "max_abs_err": err64[k], **rec[k]}
        for k, (src, rep) in SOURCES.items()]}), flush=True)
    print(f"[total] wall_s={time.perf_counter() - t_start:.1f}", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
