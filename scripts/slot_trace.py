"""Find the first operation that makes a lane's result depend on where a
batch puts it: score one VNS batch in which several slots hold the same
candidate, and compare those lanes bit for bit after every operation; then
score the same batches cut into shards (``TuningProblem.mesh``) and compare
them with the whole batch bit for bit.

    PYTHONPATH=. python scripts/slot_trace.py [--case CASE] [--device cpu] \\
        [--nit NIT] [--tune] [--only BATCH] [--shards 2,3] [--lanes N] \\
        [--out FILE]

``--case``: shell3x3 (default: float32, VNS through 'admm_fused' at 40
iterations and GAM through 'pdip_ws_fused', as ``chip_smoke.py`` phase 3c
sets it), woodberry (float32, the engines ``resolve_qp_method`` picks:
'pdip_sim' / 'admm_sim'), shell7x5 (float64, 'band_sim'; one lane a
candidate: the non-square protocol) or vandevusse (float64, the NMPC
loop).  The batch is the VNS neighbourhood of an incumbent (the distinct
(N, max Nu) pairs) with the incumbent's own (N, max Nu) inserted at the
first, a middle, two neighbouring and the last slot, scored by
``tuning/objectives.vns_objective_batch``.  With ``--tune`` the incumbent
and its weights are phase 3c's tune budget's result on the case at this
``--nit`` (default the case's own; about 12 s on the card for Shell3x3),
and every objective call of the tune in which one (N, max Nu) read two F
is listed and the first traced again; without, (8, [7, 3, 2][:nu]) at the
case's initial weights.  Shell3x3 also scores two batches in the smaller
buckets (32, 8) and (16, 4).

Every PyTorch operation of the call runs under a dispatch mode that, for
each tensor with an axis as long as the batch's lane count, checks that
lanes of one group (the same candidate and selector output) hold the same
bits.  It reports, per stage (the closed leg's tables, the closed loop,
the open leg), the first operations whose inputs were slot-independent
but whose output is not, with the call site in the port; the kernels the
port launches through ctypes are checked the same way around their
wrappers.  Then it compares the closed and open outputs and the parts of
F lane by lane.  Prints one line per finding; ``--out`` writes them as
JSON.  ``--lanes N``: the shard check's batch holds its candidates repeated
in order until it has at least N lanes (above ops/qp.CARD_LANES, the
whole batch runs wider than its shards); ``--only none`` skips the
traces.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import traceback

import numpy as np
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_flatten

from mpc_tuning_tpu_torch.cases import shell3x3, shell7x5, vandevusse, \
    woodberry
from mpc_tuning_tpu_torch.ops import qp
from mpc_tuning_tpu_torch.parallel.sweep import candidate_mesh
from mpc_tuning_tpu_torch.sim import mpc_loop, nmpc_loop
from mpc_tuning_tpu_torch.sim.mpc_loop import horizon_caps
from mpc_tuning_tpu_torch.tuning import api, vns
from mpc_tuning_tpu_torch.tuning.objectives import (gam_sse_batch,
                                                    vns_objective_batch)

CASES = ("shell3x3", "woodberry", "shell7x5", "vandevusse")

MAX_REPORTS = 4  # culprit operations reported per stage
# allocations: their output holds no values yet
UNINITIALISED = {"empty", "empty_like", "new_empty", "empty_strided",
                 "new_empty_strided"}


class LaneGroups:
    """Lanes of one group must hold the same bits: ``rep[l]`` is the first
    lane of lane l's group."""

    def __init__(self, keys):
        first = {}
        self.rep = np.array([first.setdefault(k, i) for i, k in
                             enumerate(keys)])
        self.size = len(keys)
        self._rep_t = {}

    def rep_on(self, device):
        if device not in self._rep_t:
            self._rep_t[device] = torch.as_tensor(self.rep, device=device)
        return self._rep_t[device]

    def differing(self, t):
        """Lanes (along every axis as long as the batch) whose bits differ
        from their group's first lane; None when t has no such axis."""
        if not isinstance(t, torch.Tensor) or t.is_complex() or \
                t.dtype == torch.bool or t.numel() == 0:
            return None
        axes = [a for a, s in enumerate(t.shape) if s == self.size]
        if not axes:
            return None
        bits = t
        if t.is_floating_point():
            bits = t.view({2: torch.int16, 4: torch.int32,
                           8: torch.int64}[t.element_size()])
        bad = set()
        for a in axes:
            same = bits.index_select(a, self.rep_on(t.device)) == bits
            other = [d for d in range(t.dim()) if d != a]
            lane_ok = same.all(dim=other) if other else same
            bad.update(np.flatnonzero(~lane_ok.cpu().numpy()).tolist())
        return sorted(bad)


def repo_stack():
    """The port's frames of the current stack (file:line function)."""
    out = []
    for fr in traceback.extract_stack()[:-3]:
        if "mpc_tuning_tpu_torch" in fr.filename:
            out.append(f"{fr.filename.split('mpc_tuning_tpu_torch/')[-1]}:"
                       f"{fr.lineno} {fr.name}")
    return out[-4:]


class SlotTrace(TorchDispatchMode):
    """Reports operations whose inputs are slot-independent and whose
    output is not, under the current ``stage``."""

    def __init__(self, groups):
        super().__init__()
        self.groups = groups
        self.stage = "setup"
        self.found = {}
        self.ops = {}

    def note(self, what, args, out, bad):
        rows = self.found.setdefault(self.stage, [])
        if len(rows) < MAX_REPORTS:
            shapes = lambda x: [tuple(t.shape) for t in tree_flatten(x)[0]
                                if isinstance(t, torch.Tensor)]
            rows.append(dict(op=what, inputs=shapes(args), outputs=shapes(out),
                             lanes=bad[:12], at=repo_stack()))

    def clean(self, xs):
        for t in tree_flatten(xs)[0]:
            bad = self.groups.differing(t)
            if bad:
                return False
        return True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops[self.stage] = self.ops.get(self.stage, 0) + 1
        if (len(self.found.get(self.stage, ())) >= MAX_REPORTS
                or func.__name__.split(".")[0] in UNINITIALISED):
            return func(*args, **kwargs)
        # the inputs before the call, less those it writes (an in-place or
        # out= op overwrites them)
        written = {a.name for a in func._schema.arguments
                   if a.alias_info is not None and a.alias_info.is_write}
        read = [x for a, x in zip(func._schema.arguments, args)
                if a.name not in written]
        read += [x for k, x in kwargs.items() if k not in written]
        clean = self.clean(read)
        out = func(*args, **kwargs)
        if clean:
            outs = [t for t in tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor)]
            bad = [b for b in map(self.groups.differing, outs) if b]
            if bad:
                self.note(str(func), (args, kwargs), out, bad[0])
        return out

    def kernel(self, name, fn):
        """``fn`` (a wrapper that launches through ctypes, so its writes
        pass no dispatch) checked around the call."""
        def call(*args, **kwargs):
            with _disable_current_modes():
                clean = self.clean((args, kwargs))
            out = fn(*args, **kwargs)
            with _disable_current_modes():
                if clean and not self.clean(out):
                    outs = [t for t in tree_flatten(out)[0]
                            if isinstance(t, torch.Tensor)]
                    bad = next(b for b in map(self.groups.differing, outs)
                               if b)
                    self.note(f"kernel {name}", (args, kwargs), out, bad)
            return out
        return call


def staged(trace, stage, fn):
    def call(*args, **kwargs):
        before, trace.stage = trace.stage, stage
        try:
            return fn(*args, **kwargs)
        finally:
            trace.stage = before
    return call


def tuned(problem, case, x0):
    """Phase 3c's tune on ``problem``, every VNS objective call recorded:
    (incumbent bits dict, delta, lam, calls), each call a dict of its
    candidates' (N, max Nu), weights and F."""
    from mpc_tuning_tpu_torch.tuning import objectives

    calls = []

    def record(problem, N_b, Nu_b, delta, lam, *a, **kw):
        out = objective(problem, N_b, Nu_b, delta, lam, *a, **kw)
        calls.append(dict(pairs=list(zip(np.asarray(N_b).tolist(),
                                         np.asarray(Nu_b).tolist())),
                          delta=np.asarray(delta).tolist(),
                          lam=np.asarray(lam).tolist(),
                          F=np.asarray(out).tolist()))
        return out

    objective = objectives.vns_objective_batch
    mods = (objectives, vns, api)
    for m in mods:
        m.vns_objective_batch = record
    try:
        best, delta, lam, _, _, _ = api.hybrid_tune(
            problem, case.nbp, case.nbc, x0, gam_popsize=8,
            gam_generations=3, max_alternations=1, seed=0, verbose=False,
            joint_polish=False)
    finally:
        for m in mods:
            m.vns_objective_batch = objective
    return best, np.asarray(delta), np.asarray(lam), calls


def parted(calls):
    """The tune's objective calls in which one (N, max Nu) read more than
    one F: [(call index, {pair: the F values of its slots})]."""
    out = []
    for i, c in enumerate(calls):
        seen = {}
        for p, f in zip(map(tuple, c["pairs"]), c["F"]):
            seen.setdefault(p, []).append(f)
        split = {str(p): fs for p, fs in seen.items() if len(set(fs)) > 1}
        if split:
            out.append((i, split))
    return out


def batches(best, buckets=True):
    """The incumbent's VNS neighbourhoods as ``vns_search`` scores them
    (every candidate of order 1, then of order 2, duplicates and invalid
    horizons included: (N, max Nu) per candidate), the order-1
    neighbourhood's distinct pairs with the incumbent's own inserted at
    the first, a middle, two neighbouring and the last slot, and with
    ``buckets`` two Shell3x3 batches in the smaller buckets (32, 8) and
    (16, 4) (n = 25 and 13)."""
    own = (vns.bits_to_int(best["Xv1"]),
           max(vns.bits_to_int(r) for r in best["Xv2"]))
    out = {}
    for order in (1, 2):
        pairs = [(vns.bits_to_int(x1), max(vns.bits_to_int(r) for r in x2))
                 for x1, x2 in vns._neighborhood(best["Xv1"], best["Xv2"],
                                                 order)]
        out[f"order {order}"] = pairs
    pairs = sorted(set(out["order 1"]) - {own})
    mid = len(pairs) // 2
    for at in (len(pairs), mid + 1, mid, 0):
        pairs.insert(at, own)
    out["distinct + incumbent"] = pairs
    if not buckets:
        return out, own
    out["bucket (32, 8)"] = [(20, 6), (32, 8), (9, 3), (20, 6), (20, 6),
                             (17, 5), (12, 8), (20, 6), (31, 2), (20, 6)]
    out["bucket (16, 4)"] = [(12, 3), (16, 4), (12, 3), (12, 3), (9, 2),
                             (14, 4), (12, 3), (5, 3), (12, 3)]
    return out, own


def torch_sum_witness(device, rows=181, lanes=57):
    """Distinct bits among the column sums of a (rows, lanes) float32
    tensor whose columns are one vector: torch's sum over the rows, and
    ``ops/qp.lane_sum``."""
    g = torch.Generator().manual_seed(0)
    v = torch.rand((rows, 1), generator=g, dtype=torch.float32)
    x = v.expand(rows, lanes).contiguous().to(device)
    return dict(rows=rows, lanes=lanes, distinct_torch_sum=len(set(
        x.sum(0).cpu().tolist())), distinct_tree_sum=len(set(
            qp.lane_sum(x)[0].cpu().tolist())))


def make_problem(name, nit, device):
    """(case, problem) of ``--case``, engines and precision as the module
    note says."""
    if name == "vandevusse":
        case = vandevusse.make_case(**({"nit": nit} if nit else {}))
        return case, vandevusse.build_problem(case, torch.float64, device)
    mod = {"shell3x3": shell3x3, "woodberry": woodberry,
           "shell7x5": shell7x5}[name]
    case = mod.make_case(**({"nit": nit} if nit else {}))
    band = name == "shell7x5"
    problem, _ = api.build_problem(
        case, dtype=torch.float64 if band else torch.float32,
        qp_iters=60 if band else 15, device=device)
    if name == "shell3x3":
        problem.qp_method, problem.vns_qp_method = ("pdip_ws_fused",
                                                    "admm_fused")
    problem.admm_iters = 40
    return case, problem


def shard_check(problem, name, pairs, delta, lam, shards):
    """The batch's VNS objective (both legs) and a GAM batch at the
    incumbent's horizons scored whole and over ``shards`` shards on the
    problem's device: do the legs, F and the GAM SSE keep their bits?"""
    N_b, Nu_b = (np.array(x) for x in zip(*pairs))
    X = np.random.default_rng(0).uniform(
        0.05, 2.0, size=(5, problem.my + problem.nu))
    legs = {}

    def keep(fn, k):
        def call(*a, **kw):
            out = fn(problem, *a, **kw)
            legs.setdefault(k, out)  # the VNS objective's call, not GAM's
            return out
        return call

    def score():
        legs.clear()
        for k in ("closed_batch", "open_batch"):
            setattr(problem, k, keep(getattr(type(problem), k), k))
        try:
            F = vns_objective_batch(problem, N_b, Nu_b, delta, lam)
            S = gam_sse_batch(problem, int(N_b[0]), int(Nu_b[0]), X)
        finally:
            for k in ("closed_batch", "open_batch"):
                delattr(problem, k)
        return F, S, dict(legs)

    F0, S0, legs0 = score()
    lines = []
    for k in shards:
        problem.mesh = candidate_mesh([problem.device] * k)
        try:
            F1, S1, legs1 = score()
        finally:
            problem.mesh = None
        row = dict(batch=name, shards=k, lanes=len(legs0["closed_batch"][0]),
                   F_equal=bool(np.array_equal(F1, F0)),
                   F_max_abs=float(np.max(np.abs(F1 - F0))),
                   gam_equal=bool(np.array_equal(S1, S0)),
                   gam_max_abs=float(np.max(np.abs(S1 - S0))))
        for leg in legs0:
            for i, nm in enumerate("YU"):
                a, b = legs0[leg][i], legs1[leg][i]
                row[f"{leg} {nm}"] = float(np.max(np.abs(a - b)))
        lines.append(row)
        print(json.dumps(row), flush=True)
    return lines


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", choices=CASES, default="shell3x3")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nit", type=int, default=None)
    ap.add_argument("--tune", action="store_true")
    ap.add_argument("--only", default=None,
                    help="trace only the batch of this name (e.g. "
                         "'distinct + incumbent')")
    ap.add_argument("--shards", default="2,3",
                    help="shard counts of the shard check ('' skips it)")
    ap.add_argument("--lanes", type=int, default=0,
                    help="lanes of the shard check's batch at least")
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args()
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    case, problem = make_problem(args.case, args.nit, args.device)
    x0 = (vandevusse.X0_WEIGHTS if args.case == "vandevusse" else
          np.concatenate([case.ov_weight0, case.mvrate_weight0]))
    calls = []
    if args.tune:
        best, delta, lam, calls = tuned(problem, case, x0)
    else:
        best = dict(Xv1=vns.int_to_bits(8, case.nbp),
                    Xv2=np.stack([vns.int_to_bits(v, case.nbc)
                                  for v in (7, 3, 2)[:problem.nu]]))
        delta, lam = np.asarray(x0[:problem.my]), np.asarray(x0[problem.my:])
    lines = [dict(case=args.case, delta=delta.tolist(), lam=lam.tolist(),
                  nit=problem.nit, device=args.device,
                  witness=[torch_sum_witness(args.device, r, b)
                           for r, b in ((181, 57), (181, 117), (97, 30))])]
    print(json.dumps(lines[0]), flush=True)
    todo, own = batches(best, buckets=args.case == "shell3x3")
    if args.tune:
        split = parted(calls)
        lines.append(dict(tune_calls=len(calls), candidates=sum(
            len(c["pairs"]) for c in calls), parted=split))
        print(json.dumps(lines[-1]), flush=True)
        if split:  # the first such call, again, at its own weights
            c = calls[split[0][0]]
            lines += trace_batch(problem, f"tune call {split[0][0]}",
                                 [tuple(p) for p in c["pairs"]], own,
                                 np.asarray(c["delta"]),
                                 np.asarray(c["lam"]))
    for name, pairs in todo.items():
        if args.only in (None, name):
            lines += trace_batch(problem, name, pairs, own, delta, lam)
    shards = [int(k) for k in args.shards.split(",") if k]
    if shards:
        name, pairs = "distinct + incumbent", todo["distinct + incumbent"]
        my = problem.my if problem.square else 1
        reps = -(-args.lanes // (len(pairs) * my))
        if reps > 1:
            name, pairs = f"{name}, {reps} times over", pairs * reps
        lines += shard_check(problem, name, pairs, delta, lam, shards)
    if args.out:
        args.out.write_text(json.dumps(lines, indent=1))


def trace_batch(problem, name, pairs, own, delta, lam):
    """Score the batch ``pairs`` ((N, max Nu) per candidate) under the
    trace; returns (and prints) its lines."""
    my = problem.my if problem.square else 1  # lanes a candidate
    s = problem.loop.spec if not problem.linear else problem.loop.ctl.spec
    p_cap, m_cap = horizon_caps(s.p_max, s.m_max, *zip(*pairs))
    nm = m_cap * problem.nu
    py = p_cap * problem.my
    dims = {nm, nm + 1, 4 * nm + 1, py, 2 * py, 4 * nm + 2 * py + 1, p_cap,
            m_cap, problem.nit}
    while len(pairs) * my in dims:  # the lane axis must be the only one
        pairs = pairs + pairs[:1]
    N_b, Nu_b = (np.array(x) for x in zip(*pairs))
    keys = [(int(N), int(Nu), i) for N, Nu in zip(N_b, Nu_b)
            for i in range(my)]
    trace = SlotTrace(LaneGroups(keys))
    cand = np.array(pairs)
    dup = [list(map(int, np.flatnonzero((cand == p).all(1))))
           for p in dict.fromkeys(pairs)]
    lines = [dict(batch=name, candidates=len(pairs), lanes=len(keys),
                  incumbent=own, repeated={str(pairs[d[0]]): d for d in dup
                                           if len(d) > 1})]
    saved = []

    def patch(mod, attr, new):
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, new)

    for k in ("admm_fused", "pdip_fused", "closed_sim_admm",
              "closed_sim_pdip", "closed_sim_band"):
        patch(mpc_loop, k, trace.kernel(k, getattr(mpc_loop, k)))
    patch(nmpc_loop, "nmpc_rollout",
          trace.kernel("nmpc_rollout", nmpc_loop.nmpc_rollout))
    patch(nmpc_loop, "nmpc_closed_core",
          staged(trace, "closed loop", nmpc_loop.nmpc_closed_core))
    patch(nmpc_loop, "nmpc_open_core",
          staged(trace, "open leg", nmpc_loop.nmpc_open_core))
    for k in ("spd_factor", "spd_factor_solve", "factor_lanes",
              "solve_lanes"):
        patch(qp, k, trace.kernel(k, getattr(qp, k)))
    patch(mpc_loop.MPCLoop, "sim_inputs",
          staged(trace, "closed tables", mpc_loop.MPCLoop.sim_inputs))
    patch(mpc_loop, "run_engine",
          staged(trace, "closed loop", mpc_loop.run_engine))
    patch(mpc_loop.MPCLoop, "open_batch",
          staged(trace, "open leg", mpc_loop.MPCLoop.open_batch))
    legs = {}
    for k in ("closed_batch", "open_batch"):
        fn = getattr(problem, k)

        def keep(*a, _fn=fn, _k=k, **kw):
            legs[_k] = _fn(*a, **kw)
            return legs[_k]
        patch(problem, k, keep)
    try:
        with trace:
            F, parts = vns_objective_batch(problem, N_b, Nu_b, delta, lam,
                                           return_parts=True)
        if problem.device != "cpu":
            torch.cuda.synchronize()
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)
    for stage, n_ops in trace.ops.items():
        lines.append(dict(stage=stage, ops=n_ops,
                          first=trace.found.get(stage, [])))

    # per repeated candidate: do its slots' legs and F's parts agree?
    same = {}
    for d in dup:
        if len(d) < 2:
            continue
        row = {}
        for leg, (Y, U) in legs.items():
            for nm, x in (("Y", Y), ("U", U)):
                x = np.asarray(x).reshape(len(pairs), my, *np.shape(x)[1:])
                bits = x.view(np.int32 if x.dtype == np.float32 else np.int64)
                row[f"{leg} {nm}"] = all(np.array_equal(bits[j], bits[d[0]])
                                         for j in d)
        for nm, x in dict(parts, F=F).items():
            row[nm] = [float(x[j]) for j in d] if len(set(
                float(x[j]) for j in d)) > 1 else float(x[d[0]])
        same[str(pairs[d[0]])] = row
    lines.append(dict(batch=name, repeated_candidates=same))
    for ln in lines:
        print(json.dumps(ln), flush=True)
    return lines


if __name__ == "__main__":
    main()
