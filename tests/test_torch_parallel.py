"""Candidate sharding of the port (``parallel/sweep.py``) on CPU shards,
case by case as tests/test_parallel.py holds the JAX package's on its
virtual 8-device mesh: the mesh and padding, the GAM and VNS objectives
sharded equal to unsharded bit for bit and to the JAX package's sharded
evaluation at rtol 1e-10, the band and Van de Vusse batches, the argmin
reduction, one tuner alternation, the mesh reaching the problem from
``build_problem`` and the CLI, and the engine each shard runs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tuning_tpu.cases import woodberry as wb_jax
from mpc_tuning_tpu.parallel.sweep import candidate_mesh as jax_mesh
from mpc_tuning_tpu.tuning import objectives as obj_jax
from mpc_tuning_tpu.tuning.api import build_problem as build_jax
from mpc_tuning_tpu_torch.cases import woodberry
from mpc_tuning_tpu_torch.parallel.sweep import (candidate_mesh,
                                                 global_argmin_shard_map,
                                                 pad_to_multiple,
                                                 replicate_to_host,
                                                 shard_candidates,
                                                 sharded_argmin_sweep)
from mpc_tuning_tpu_torch.tuning import objectives as obj
from mpc_tuning_tpu_torch.tuning.api import build_problem

torch.set_num_threads(1)  # batches of a few lanes: threads only contend

CPU = torch.device("cpu")


def cpu_mesh(k):
    return candidate_mesh([CPU] * k)


def test_mesh_has_8_devices():
    mesh = cpu_mesh(8)
    assert mesh.size == 8 and mesh.devices == (CPU,) * 8
    assert candidate_mesh(["cpu", "cpu"]).devices == (CPU, CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            candidate_mesh()
        with pytest.raises(RuntimeError, match="is_available"):
            candidate_mesh(["cuda"])


def test_pad_to_multiple():
    a = np.arange(10).reshape(10, 1)
    p, n = pad_to_multiple(a, 8)
    assert p.shape == (16, 1) and n == 10
    assert np.all(p[10:] == a[-1])
    q, m = pad_to_multiple(a, 5)
    assert q is a and m == 10


def test_shard_and_gather_round_trip():
    mesh = cpu_mesh(4)
    a = np.arange(24.0).reshape(8, 3)
    (shards,) = shard_candidates(mesh, a)
    assert [tuple(s.shape) for s in shards] == [(2, 3)] * 4
    assert all(s.device == CPU for s in shards)
    assert np.array_equal(replicate_to_host(mesh, shards), a)
    with pytest.raises(ValueError, match="pad_to_multiple"):
        shard_candidates(mesh, a[:6])


def test_sharded_argmin_sweep_masks_padding_and_ties():
    """Padded lanes repeat the last candidate but never win; a tie goes to
    the lowest global index, as the unsharded argmin."""
    mesh = cpu_mesh(4)
    vals = np.array([5.0, 2.0, 9.0, 2.0, 7.0, 1.0])
    p, B = pad_to_multiple(vals, 4)
    F, best, vmin = sharded_argmin_sweep(
        mesh, lambda v: v, shard_candidates(mesh, p), B)
    assert np.array_equal(F, vals) and (best, vmin) == (5, 1.0)
    vals[5] = 2.0
    p, B = pad_to_multiple(vals, 4)
    assert sharded_argmin_sweep(mesh, lambda v: v,
                                shard_candidates(mesh, p), B)[1:] == (1, 2.0)
    assert global_argmin_shard_map(mesh, lambda v: v, (vals,), B) == (2.0, 1)


def test_global_argmin_shard_map():
    mesh = cpu_mesh(8)
    vals = np.array([5.0, 3.0, 9.0, 1.5, 7.0, 2.0, 8.0, 4.0])

    def local_fn(v):
        return v  # the objective is the value itself

    vmin, gidx = global_argmin_shard_map(mesh, local_fn, (vals,), 8)
    assert vmin == 1.5 and gidx == 3


@pytest.fixture(scope="module")
def wb():
    """Wood-Berry nit 60, nbp/nbc 5/3, float64, qp_iters 15: the port's
    problem and the JAX package's, each unsharded and on its 8-shard
    mesh."""
    case_kw = dict(nit=60, nbp=5, nbc=3)
    pt, _ = build_problem(woodberry.make_case(**case_kw),
                          dtype=torch.float64, qp_iters=15, device="cpu")
    pj, _ = build_jax(wb_jax.make_case(**case_kw), dtype=jnp.float64,
                      qp_iters=15)
    return pt, pj


def _both(problem, fn):
    """fn(problem) unsharded, then on 8 CPU shards."""
    problem.mesh = None
    out0 = fn(problem)
    problem.mesh = cpu_mesh(8)
    try:
        out1 = fn(problem)
    finally:
        problem.mesh = None
    return out0, out1


def test_sharded_tuning_problem_matches_unsharded(wb):
    """The GAM objective over 8 shards (6 candidates padded to 8: shards
    of one lane) equals the unsharded evaluation bit for bit, and the
    JAX package's sharded one at rtol 1e-10."""
    pt, pj = wb
    X = np.random.default_rng(0).uniform(0.05, 2.0, size=(6, 4))
    F0, F1 = _both(pt, lambda p: obj.gam_sse_batch(p, 12, 3, X))
    assert np.array_equal(F1, F0)
    pj.mesh = jax_mesh()
    try:
        Fj = obj_jax.gam_sse_batch(pj, 12, 3, X)
    finally:
        pj.mesh = None
    np.testing.assert_allclose(F1, Fj, rtol=1e-10)


def test_sharded_vns_neighbourhood_matches_unsharded(wb):
    """One VNS neighbourhood of Wood-Berry (9 candidates, 18 selector
    lanes over 8 shards) likewise."""
    pt, pj = wb
    N_b = np.array([12, 13, 11, 12, 12, 12, 12, 14, 10])
    Nu_b = np.array([3, 3, 3, 4, 2, 5, 1, 3, 3])
    delta, lam = np.array([1.2, 0.7]), np.array([0.15, 0.08])
    run = lambda p: obj.vns_objective_batch(p, N_b, Nu_b, delta, lam,
                                            return_parts=True)
    (F0, parts0), (F1, parts1) = _both(pt, run)
    assert np.array_equal(F1, F0)
    for k in parts0:
        assert np.array_equal(parts1[k], parts0[k]), k
    pj.mesh = jax_mesh()
    try:
        Fj = obj_jax.vns_objective_batch(pj, N_b, Nu_b, delta, lam)
    finally:
        pj.mesh = None
    np.testing.assert_allclose(F1, Fj, rtol=1e-10)


def test_sharded_band_batch_matches_unsharded():
    """A Shell7x5 band batch ('band_sim''s plain version, float64) over
    three shards equals the whole batch bit for bit, closed and open."""
    from mpc_tuning_tpu_torch.cases import shell7x5

    p, _ = build_problem(shell7x5.make_case(nit=12, nbp=4, nbc=2),
                         dtype=torch.float64, qp_iters=8, device="cpu")
    assert p.engine("gam") == p.engine("vns") == "band_sim"
    rng = np.random.default_rng(1)
    B = 5
    N, Nu = rng.integers(4, 12, B), rng.integers(2, 4, B)
    d, l = rng.uniform(0.2, 2, (B, p.my)), rng.uniform(0.05, 0.5, (B, p.nu))
    r = np.broadcast_to(p.r[:p.nit], (B, p.nit, p.my))
    rfin = np.broadcast_to(p.r[p.nit - 1], (B, p.my))
    for fn in (lambda q: q.closed_batch(r, N, Nu, d, l),
               lambda q: q.open_batch(rfin, N, Nu, d, l)):
        p.mesh = None
        Y0, U0 = fn(p)
        p.mesh = cpu_mesh(3)
        Y1, U1 = fn(p)
        assert np.array_equal(Y1, Y0) and np.array_equal(U1, U0)
    p.mesh = None


def test_sharded_vandevusse_batch_matches_unsharded():
    """A Van de Vusse NMPC batch (float64) over three shards equals the
    whole batch bit for bit, closed and open, through ``problem.mesh``."""
    from mpc_tuning_tpu_torch.cases import vandevusse

    case = vandevusse.make_case(nit=8, substeps=2, sqp_iters=2, qp_iters=8)
    p = vandevusse.build_problem(case, torch.float64, "cpu")
    rng = np.random.default_rng(2)
    B = 4
    N, Nu = rng.integers(3, 8, B), np.full(B, 2)
    d, l = rng.uniform(0.05, 0.5, (B, 2)), rng.uniform(0.05, 0.5, (B, 2))
    r = np.broadcast_to(p.r[:p.nit], (B, p.nit, 2))
    Y0, U0 = p.closed_batch(r, N, Nu, d, l)
    p.mesh = cpu_mesh(3)
    Y1, U1 = p.closed_batch(r, N, Nu, d, l)
    p.mesh = None
    assert np.array_equal(Y1, Y0) and np.array_equal(U1, U0)
    rfin = np.broadcast_to(p.r[p.nit - 1], (B, 2))
    Yo, Uo = p.open_batch(rfin, N, Nu, d, l)
    p.mesh = cpu_mesh(3)
    Ys, Us = p.open_batch(rfin, N, Nu, d, l)
    assert np.array_equal(Ys, Yo) and np.array_equal(Us, Uo)


def test_mesh_hybrid_tune_alternation_matches_unsharded():
    """One GAM <-> VNS alternation with problem.mesh over three CPU shards
    takes the unsharded decisions, F within 1e-12 (the production path
    behind mpc_tuning(mesh=...) / `mpc-tuning-run-torch --mesh`)."""
    from mpc_tuning_tpu_torch.tuning.api import hybrid_tune

    case = woodberry.make_case(nit=40, nbp=4, nbc=2)
    problem, _ = build_problem(case, dtype=torch.float64, qp_iters=10,
                               device="cpu")
    x0 = np.concatenate([case.ov_weight0, case.mvrate_weight0])
    kw = dict(gam_popsize=4, gam_generations=2, max_alternations=1, seed=0,
              verbose=False, final_polish=False, joint_polish=False)
    best_r, d_r, l_r, F_r, _, _ = hybrid_tune(problem, case.nbp, case.nbc,
                                              x0, **kw)
    problem.mesh = cpu_mesh(3)
    best_s, d_s, l_s, F_s, _, _ = hybrid_tune(problem, case.nbp, case.nbc,
                                              x0, **kw)
    assert best_s["N"] == best_r["N"]
    assert np.array_equal(best_s["Nu"], best_r["Nu"])
    assert np.array_equal(d_s, d_r)
    assert np.array_equal(l_s, l_r)
    assert abs(F_s - F_r) <= 1e-12 * max(1.0, abs(F_r))


def test_mesh_build_problem_and_cli_flag(monkeypatch, capsys):
    """build_problem's mesh= reaches the TuningProblem, and the CLI's
    --mesh 2 --cpu reaches mpc_tuning as two CPU shards."""
    from mpc_tuning_tpu_torch import cli
    from mpc_tuning_tpu_torch.tuning import api

    mesh = cpu_mesh(2)
    case = woodberry.make_case(nit=20, nbp=4, nbc=2)
    problem, _ = build_problem(case, dtype=torch.float64, qp_iters=5,
                               mesh=mesh, device="cpu")
    assert problem.mesh is mesh

    seen = {}

    class Stop(Exception):
        pass

    def fake(case, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(api, "mpc_tuning", fake)
    with pytest.raises(Stop):
        cli.run_main(["woodberry", "--nit", "20", "--cpu", "--mesh", "2",
                      "--checkpoint-dir", ""])
    assert seen["mesh"].devices == (CPU, CPU) and seen["device"] == "cpu"
    assert "# candidate mesh: 2 x cpu" in capsys.readouterr().out
    assert cli.mesh_from_arg("auto", "cpu").devices == (CPU,)
    with pytest.raises(ValueError):
        cli.mesh_from_arg("0", "cpu")


@pytest.mark.parametrize("dtype,qp_method,vns_qp_method", [
    (torch.float64, "auto", "auto"),
    (torch.float32, "auto", "auto"),
    (torch.float64, "pdip_ws_fused", "admm_fused"),
])
def test_each_shard_runs_the_unsharded_engine(monkeypatch, dtype, qp_method,
                                              vns_qp_method):
    """Under a mesh each shard's closed loop runs the engine, iteration
    count and capacity bucket ``resolve_qp_method`` picks for the whole
    batch without one: no engine swap, nothing moved off its device."""
    from mpc_tuning_tpu_torch.sim.mpc_loop import MPCLoop

    case = woodberry.make_case(nit=12, nbp=4, nbc=2)
    problem, _ = build_problem(case, dtype=dtype, qp_iters=5, device="cpu")
    problem.qp_method, problem.vns_qp_method = qp_method, vns_qp_method
    calls = []
    orig = MPCLoop.closed_batch

    def spy(self, r_b, v, N_b, Nu_b, *a, **kw):
        calls.append((len(N_b), a[-1], kw["engine"], kw["caps"],
                      kw["device"]))
        return orig(self, r_b, v, N_b, Nu_b, *a, **kw)

    monkeypatch.setattr(MPCLoop, "closed_batch", spy)
    N_b, Nu_b = np.array([6, 9, 12, 5, 7]), np.array([2, 3, 2, 3, 2])
    r_b = np.broadcast_to(problem.r[:12], (5, 12, 2))
    d, l = np.ones((5, 2)), np.full((5, 2), 0.1)
    for stage in ("gam", "vns"):
        want = obj.resolve_qp_method(
            vns_qp_method if stage == "vns" else qp_method, stage=stage,
            f64=dtype == torch.float64)
        calls.clear()
        problem.mesh = None
        problem.closed_batch(r_b, N_b, Nu_b, d, l, stage=stage)
        (whole,) = calls
        calls.clear()
        problem.mesh = cpu_mesh(2)
        problem.closed_batch(r_b, N_b, Nu_b, d, l, stage=stage)
        assert [c[0] for c in calls] == [3, 3]
        assert all(c[1:] == (whole[1], want, whole[3], CPU) for c in calls)
        assert problem.engine(stage) == want
    problem.mesh = None


def test_cpu_mesh_report_rows():
    """parallel/report.cpu_mesh_rows: unsharded, 1, 2 and 4 CPU shards of
    one small batch, every sharded run the unsharded bits."""
    from mpc_tuning_tpu_torch.parallel.report import cpu_mesh_rows

    rows = cpu_mesh_rows(B=4, nit=10)
    assert [r["devices"] for r in rows] == [0, 1, 2, 4]
    assert all(r["sims_per_s"] > 0 and r["bits_equal_unsharded"]
               for r in rows)
