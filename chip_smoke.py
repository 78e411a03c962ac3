"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py            # needs one card; about 6 minutes

Phases, each printing one line:
 1. environment: the card (nvidia-smi name and power limit), torch and CUDA
    versions, and the build of the port's CUDA kernels;
 2. every kernel of the main path against its plain PyTorch version on the
    card, in float64 and float32, at the Wood-Berry shapes (caps (64,8) and
    (127,15), B=1024, nit=400; SPD factor/solve at n = 5, 17, 31); the
    whole-sim kernels step by step, the plain version following the
    kernel's inputs (see ``phase_kernels``);
 3. the main path: a seeded Wood-Berry hybrid tune in float32 on the card
    through ``mpc_tuning``, with every kernel's launch count, the tune's
    last batch of each whole-sim kernel against the plain version, a
    validity check of the result and its closed-loop outputs against the
    float64 plain version on the CPU;
 4. throughput of each kernel and its plain version (recorded, not gated).
Then one JSON line with the per-kernel record, and as the last line
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero before
that line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

F64_SIM_GATE = 1e-9      # max |dY|, |dU| kernel vs plain, float64
F64_SPD_GATE = 1e-10     # max |dL|, |dx|, float64
F32_SIM_GATE = 1e-3      # max |dY|, |dU|, float32
F32_SPD_GATE = 1e-4      # max |dL| / max |L|, max |dx| / max |x|, float32
# float32 PDIP over random candidates: U within F32_SIM_GATE on the median
# lane, and within two move limits (2 x dumax = 0.1: two answers that both
# keep |du| <= 0.05 differ by no more) on every lane
F32_PDIP_U_CAP = 0.1
LOOP_GATE = 1e-2         # tuned closed loop y: float32 card vs float64 CPU

SOURCES = {
    "spd_factor": ("mpc_tuning_tpu_torch/ops/csrc/spd.cu",
                   "mpc_tuning_tpu/ops/pallas_kernels.py:217"),
    "spd_factor_solve": ("mpc_tuning_tpu_torch/ops/csrc/spd.cu",
                         "mpc_tuning_tpu/ops/pallas_kernels.py:242"),
    "closed_sim_admm": ("mpc_tuning_tpu_torch/ops/csrc/closed_sim.cu",
                        "mpc_tuning_tpu/ops/pallas_kernels.py:944"),
    "closed_sim_pdip": ("mpc_tuning_tpu_torch/ops/csrc/closed_sim.cu",
                        "mpc_tuning_tpu/ops/pallas_kernels.py:1248"),
}


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def timed(fn, reps: int = 1):
    """Mean milliseconds per call on the card (CUDA events), after one
    warm-up call; returns (ms, last result)."""
    out = fn()
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


def sim_inputs(problem, caps, B, nit, dtype, engine, seed, N=None, Nu=None):
    """Whole-sim kernel inputs for B random Wood-Berry candidates that
    span the capacity bucket ``caps``."""
    rng = np.random.default_rng(seed)
    p_cap, m_cap = caps
    if N is None:
        N = rng.integers(m_cap + 1, p_cap + 1, size=B)
        Nu = rng.integers(2, m_cap + 1, size=B)
        N[0], Nu[0] = p_cap, m_cap
    else:
        N, Nu = np.full(B, N), np.full(B, Nu)
    delta = rng.uniform(0.2, 2.0, size=(B, 2))
    lam = rng.uniform(0.02, 0.5, size=(B, 2))
    r_b = np.broadcast_to(problem.r[:nit], (B, nit, 2))
    return problem.loop.sim_inputs(r_b, problem.v, N, Nu, delta, lam, nit,
                                   dtype, engine, "cuda", caps=caps)


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
    _build.library()
    print(f"[1 env] card={card!r} torch={torch.__version__} "
          f"cuda={torch.version.cuda} build_s={_build.build_seconds} "
          f"load_s={time.perf_counter() - t0:.3f}", flush=True)
    return card


def lane_errors(a, b):
    """Per-lane max |a - b| of Y and of U, each (B,), for (Y, U) pairs in
    (nit, rows, B) layout."""
    (Ya, Ua), (Yb, Ub) = a, b
    return (Ya - Yb).abs().amax((0, 1)), (Ua - Ub).abs().amax((0, 1))


PLAIN = {"closed_sim_admm": "closed_sim_admm_plain",
         "closed_sim_pdip": "closed_sim_pdip_plain"}


def follow_plain(name, args, kwargs, out_k):
    """The plain version of whole-sim kernel `name` on the same inputs,
    stepping the plant and model on the kernel's U (see ops/kernels.py):
    each step's QP is then solved from the state the kernel solved it in.
    Returns the per-lane (dY, dU) against the kernel's output."""
    from mpc_tuning_tpu_torch.ops import kernels as K

    out_p = getattr(K, PLAIN[name])(*args, **kwargs, u_follow=out_k[1])
    torch.cuda.synchronize()
    return lane_errors(out_k, out_p)


def phase_kernels(problem):
    """Kernel vs plain on the card; returns {name: max_abs_err (f64)}.

    The whole-sim kernels are held step by step: the plain version follows
    the kernel's inputs (``follow_plain``).  Run side by side instead, two
    correct float64 loops drift apart by up to 5.3e-9 on a lane, and two
    float32 PDIP loops by up to 0.14: an interior point run to its floor
    turns a last-digit difference into another iterate, and the loop
    carries it through all later steps.  Float32 PDIP answers also scatter
    within one step (ill-conditioned normal matrices at the dual cap), so
    its U gate is F32_SIM_GATE on the median lane and F32_PDIP_U_CAP on
    every lane; the main path's own float32 batches are held to
    F32_SIM_GATE on every lane in phase 3."""
    from mpc_tuning_tpu_torch.ops import kernels as K

    B, nit = 1024, 400
    err64 = {k: 0.0 for k in SOURCES}
    rows = []
    for dtype in (torch.float64, torch.float32):
        f64 = dtype == torch.float64
        tag = "f64" if f64 else "f32"
        for caps in ((64, 8), (127, 15)):
            for engine, iters in (("admm_sim", 40), ("pdip_sim", 30)):
                t, lc, Hm, r_l, dims = sim_inputs(problem, caps, B, nit,
                                                  dtype, engine, seed=caps[0])
                name = "closed_sim_" + engine[:4]
                args = (t, lc, Hm, r_l, nit, iters)
                kwargs = dict(dims=dims)
                if engine == "admm_sim":
                    kwargs.update(sigma=1e-6, over_relax=1.6)
                out_k = getattr(K, name)(*args, **kwargs)
                torch.cuda.synchronize()
                if not all(torch.isfinite(x).all() for x in out_k):
                    fail(f"{name} {caps} {tag}: non-finite output")
                dy, du = follow_plain(name, args, kwargs, out_k)
                ey, eu = float(dy.max()), float(du.max())
                med = float(du.median())
                rows.append(f"{name}{caps}:{tag}=Y {ey:.3e} U {eu:.3e} "
                            f"(median lane {med:.3e})")
                if f64:
                    err64[name] = max(err64[name], ey, eu)
                    ok = max(ey, eu) <= F64_SIM_GATE
                elif engine == "admm_sim":
                    ok = max(ey, eu) <= F32_SIM_GATE
                else:
                    ok = (ey <= F32_SIM_GATE and med <= F32_SIM_GATE
                          and eu <= F32_PDIP_U_CAP)
                if not ok:
                    fail(f"{rows[-1]}: above its gate")
        for n in (5, 17, 31):
            g = torch.Generator(device="cuda").manual_seed(n)
            A = torch.randn((B, n, n), generator=g, device="cuda", dtype=dtype)
            M = A @ A.transpose(1, 2) + n * torch.eye(n, device="cuda",
                                                      dtype=dtype)
            rhs = torch.randn((B, n), generator=g, device="cuda", dtype=dtype)
            Lk, Lp = K.spd_factor(M), K.spd_factor_plain(M)
            xk = K.spd_factor_solve(Lk, rhs)
            xp = K.spd_factor_solve_plain(Lp, rhs)
            torch.cuda.synchronize()
            eL, ex = maxabs(Lk, Lp), maxabs(xk, xp)
            if f64:
                err64["spd_factor"] = max(err64["spd_factor"], eL)
                err64["spd_factor_solve"] = max(err64["spd_factor_solve"], ex)
            else:
                eL /= float(Lp.abs().max())
                ex /= float(xp.abs().max())
            rows.append(f"spd(n={n}):{tag}=L {eL:.3e} x {ex:.3e}")
            if max(eL, ex) > (F64_SPD_GATE if f64 else F32_SPD_GATE):
                fail(f"spd n={n} {dtype}: dL {eL:.3e} dx {ex:.3e}")
    print(f"[2 kernels] B={B} nit={nit}, whole sims with the plain version "
          f"following the kernel's U; gates: f64 {F64_SIM_GATE:g}, f32 "
          f"{F32_SIM_GATE:g} (f32 PDIP U: median lane {F32_SIM_GATE:g}, "
          f"every lane {F32_PDIP_U_CAP:g}); spd f64 {F64_SPD_GATE:g}, f32 "
          f"{F32_SPD_GATE:g} relative | " + " | ".join(rows), flush=True)
    return err64


def keep_last_launches(store):
    """Route the evaluators' whole-sim calls through recorders that keep
    each engine's last call (inputs and the kernel's output) in `store`;
    returns a function that undoes it.  The wrappers still count."""
    from mpc_tuning_tpu_torch.sim import mpc_loop

    saved = {name: getattr(mpc_loop, name) for name in PLAIN}

    def recorder(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            store[name] = (args, kwargs, out)
            return out
        return call

    for name, fn in saved.items():
        setattr(mpc_loop, name, recorder(name, fn))
    return lambda: [setattr(mpc_loop, k, v) for k, v in saved.items()]


def phase_main_path():
    """The seeded hybrid tune on the card; returns the launch counts."""
    from mpc_tuning_tpu_torch.cases import woodberry
    from mpc_tuning_tpu_torch.ops import kernels as K
    from mpc_tuning_tpu_torch.tuning.api import build_problem, mpc_tuning

    case = woodberry.make_case()
    last = {}
    undo = keep_last_launches(last)
    K.reset_launches()
    t0 = time.perf_counter()
    res = mpc_tuning(case, dtype=torch.float32, device="cuda", qp_iters=15,
                     gam_popsize=8, gam_generations=4, max_alternations=2,
                     seed=0, checkpoint_dir=None, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    undo()
    Nu = np.asarray(res.Nu)
    weights = np.concatenate([res.delta, res.lam])
    ok = (res.N > Nu.max() and (Nu >= 2).all() and np.isfinite(weights).all()
          and (weights > 0).all() and np.isfinite([res.Fvns, res.Fgam]).all())
    if not ok:
        fail(f"invalid tuning result N={res.N} Nu={Nu} weights={weights}")
    if min(launches.values()) <= 0:
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

    # the tuned controller's closed loop: float32 kernel on the card vs
    # the float64 plain version on the CPU
    ref, _ = build_problem(case, dtype=torch.float64, qp_iters=15,
                           L=res.L, R=res.R, device="cpu")
    sim = lambda p: p.loop.simulate(p.r, p.v, p.nit, res.N, int(Nu.max()),
                                    res.delta, res.lam, dtype=p.dtype,
                                    qp_iters=15, device=p.device)
    y32, u32 = sim(res.problem)
    y64, u64 = sim(ref)
    dy = float(np.abs(y32 - y64).max())
    du = float(np.abs(u32 - u64).max())
    if not (np.isfinite(y32).all() and np.isfinite(u32).all()
            and dy <= LOOP_GATE):
        fail(f"tuned closed loop f32 card vs f64 cpu: max |dy| {dy:.3e}")
    print(f"[3 main path] mpc_tuning(WB nit=400 nbp/nbc=7/4 f32 cuda "
          f"popsize=8 gens=4 alts=2 qp_iters=15) N={res.N} "
          f"Nu={Nu.tolist()} delta={np.round(res.delta, 6).tolist()} "
          f"lam={np.round(res.lam, 6).tolist()} Fvns={res.Fvns:.6g} "
          f"Fgam={res.Fgam:.6g} wall_s={wall:.2f} launches={launches} "
          f"last batches vs plain: {'; '.join(held)} | "
          f"loop_f32_card_vs_f64_cpu dy={dy:.3e} du={du:.3e}", flush=True)
    return launches


def phase_throughput(problem):
    """Kernel and plain times at the bench shapes; returns {name: (ms,
    plain_ms)}."""
    from mpc_tuning_tpu_torch.ops import kernels as K

    f32 = torch.float32
    t, lc, Hm, r_l, dims = sim_inputs(problem, (64, 8), 8192, 400, f32,
                                      "admm_sim", seed=1)
    args = (t, lc, Hm, r_l, 400, 40, 1e-6, 1.6, dims)
    admm = (timed(lambda: K.closed_sim_admm(*args), 3)[0],
            timed(lambda: K.closed_sim_admm_plain(*args))[0])
    # a VNS-neighbourhood-sized batch (9 candidates x 2 selectors): one
    # thread per lane, so this is the per-lane latency the tuner waits for
    t, lc, Hm, r_l, dims = sim_inputs(problem, (64, 8), 18, 400, f32,
                                      "admm_sim", seed=3)
    args = (t, lc, Hm, r_l, 400, 40, 1e-6, 1.6, dims)
    admm18 = timed(lambda: K.closed_sim_admm(*args), 3)[0]
    t, lc, Hm, r_l, dims = sim_inputs(problem, (32, 4), 2048, 400, f32,
                                      "pdip_sim", seed=2, N=20, Nu=4)
    args = (t, lc, Hm, r_l, 400, 15, dims)
    pdip = (timed(lambda: K.closed_sim_pdip(*args), 3)[0],
            timed(lambda: K.closed_sim_pdip_plain(*args))[0])
    g = torch.Generator(device="cuda").manual_seed(0)
    A = torch.randn((1024, 17, 17), generator=g, device="cuda", dtype=f32)
    M = A @ A.transpose(1, 2) + 17 * torch.eye(17, device="cuda", dtype=f32)
    rhs = torch.randn((1024, 17), generator=g, device="cuda", dtype=f32)
    L = K.spd_factor_plain(M)
    fac = (timed(lambda: K.spd_factor(M), 20)[0],
           timed(lambda: K.spd_factor_plain(M), 20)[0])
    sol = (timed(lambda: K.spd_factor_solve(L, rhs), 20)[0],
           timed(lambda: K.spd_factor_solve_plain(L, rhs), 20)[0])
    print(f"[4 throughput] f32 headline admm_sim B=8192 caps=(64,8) nit=400 "
          f"iters=40: kernel {admm[0]:.1f} ms = {8192e3 / admm[0]:.0f} sims/s,"
          f" plain {admm[1]:.1f} ms = {8192e3 / admm[1]:.0f} sims/s; B=18: "
          f"kernel {admm18:.1f} ms | "
          f"GAM pdip_sim B=2048 (N,Nu)=(20,4) caps=(32,4) iters=15: kernel "
          f"{pdip[0]:.1f} ms = {2048e3 / pdip[0]:.0f} sims/s, plain "
          f"{pdip[1]:.1f} ms = {2048e3 / pdip[1]:.0f} sims/s | spd B=1024 "
          f"n=17: factor {fac[0]:.4f} ms (plain {fac[1]:.4f}), solve "
          f"{sol[0]:.4f} ms (plain {sol[1]:.4f})", flush=True)
    return {"closed_sim_admm": admm, "closed_sim_pdip": pdip,
            "spd_factor": fac, "spd_factor_solve": sol}


def main():
    card = phase_env()
    from mpc_tuning_tpu_torch.cases import woodberry
    from mpc_tuning_tpu_torch.tuning.api import build_problem

    problem, _ = build_problem(woodberry.make_case(), device="cuda")
    err64 = phase_kernels(problem)
    launches = phase_main_path()
    times = phase_throughput(problem)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": err64[k],
         "ms": times[k][0], "plain_ms": times[k][1]}
        for k, (src, rep) in SOURCES.items()]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
