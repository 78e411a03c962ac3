"""The port's per-step engines ('pdip_ws_lanes', 'pdip_ws_fused',
'admm_fused') and the plain versions of their kernels against the JAX
package at float64 on the CPU (its Pallas kernels in interpret mode): the
lane-major factor and solve, single QP solves, whole closed loops, and the
engine contract."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tuning_tpu.cases import woodberry as wb_jax
from mpc_tuning_tpu.ops import qp as qp_jax
from mpc_tuning_tpu.ops.pallas_kernels import factor_lanes as factor_lanes_jax
from mpc_tuning_tpu.ops.pallas_kernels import solve_lanes as solve_lanes_jax
from mpc_tuning_tpu.tuning.api import build_problem as build_jax
from mpc_tuning_tpu_torch.cases import shell3x3 as s3_torch
from mpc_tuning_tpu_torch.cases import shell7x5 as s7_torch
from mpc_tuning_tpu_torch.cases import woodberry as wb_torch
from mpc_tuning_tpu_torch.ops import kernels
from mpc_tuning_tpu_torch.ops import mpc_qp as mq_torch
from mpc_tuning_tpu_torch.sim.mpc_loop import STEP_ENGINES
from mpc_tuning_tpu_torch.tuning import objectives as obj_torch
from mpc_tuning_tpu_torch.tuning.api import build_problem as build_torch

torch.set_num_threads(1)  # B <= 8: threads only contend with other workers

F64 = torch.float64


@pytest.mark.parametrize("n", [8, 16, 48])
def test_factor_solve_lanes_plain_match_pallas(n):
    """The lane-major factor and solve (the JAX kernels need n % 8 == 0
    and B % 128 == 0)."""
    B = 128
    rng = np.random.default_rng(n)
    A = rng.standard_normal((B, n, n))
    M = (A @ A.transpose(0, 2, 1) + n * np.eye(n)).transpose(1, 2, 0)
    rhs = rng.standard_normal((n, B))
    Lj = np.asarray(factor_lanes_jax(jnp.asarray(M)))
    xj = np.asarray(solve_lanes_jax(jnp.asarray(Lj), jnp.asarray(rhs)))
    Lt = kernels.factor_lanes_plain(torch.as_tensor(M))
    xt = kernels.solve_lanes_plain(Lt, torch.as_tensor(rhs))
    np.testing.assert_allclose(Lt.numpy(), Lj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=1e-12)


def test_factor_lanes_plain_failed_factor_is_nan():
    M = torch.eye(4, dtype=F64)[:, :, None].repeat(1, 1, 3)
    M[2, 2, 1] = -1.0
    L = kernels.factor_lanes_plain(M)
    assert torch.isnan(L[:, :, 1]).all()
    assert torch.equal(L[:, :, 0], torch.eye(4, dtype=F64))


@pytest.fixture(scope="module")
def shell3x3_qps():
    """Single QPs at Shell3x3's (32, 4) bucket (n = 13, mc = 49): 6 seeded
    candidates at a seeded estimator state and last input, with seeded
    warm starts."""
    pt, _ = build_torch(s3_torch.make_case(nit=30), device="cpu")
    caps, B = (32, 4), 6
    rng = np.random.default_rng(7)
    N = rng.integers(caps[1] + 1, caps[0] + 1, size=B)
    Nu = rng.integers(1, caps[1] + 1, size=B)
    N[0], Nu[0] = caps
    delta = rng.uniform(0.05, 2.0, size=(B, 3))
    lam = np.exp(rng.uniform(np.log(1e-3), np.log(1.0), size=(B, 3)))
    loop = pt.loop.capped(*caps)
    d = loop.dims
    c = loop.arrays(F64, "cpu")
    cand = mq_torch.assemble_candidate(
        c, torch.as_tensor(N), torch.as_tensor(Nu), torch.as_tensor(delta),
        torch.as_tensor(lam), d["p_max"], d["m_max"], d["ny"], d["nu"],
        d["rho"])
    x_hat = torch.as_tensor(0.3 * rng.standard_normal((B, c["A"].shape[0])))
    u_prev = torch.as_tensor(rng.uniform(-0.8, 0.4, size=(B, 3)))
    r_s = torch.as_tensor(rng.uniform(0.0, 0.4, size=(B, 3)))
    f, h, _ = mq_torch.qp_step_data(c, cand, x_hat, u_prev, r_s,
                                    torch.zeros(0, dtype=F64), d["p_max"],
                                    d["m_max"], d["ny"], d["nu"])
    n, mc = f.shape[1], h.shape[1]
    warm = dict(z=torch.as_tensor(0.01 * rng.standard_normal((B, n))),
                lam=torch.as_tensor(rng.uniform(0.0, 2.0, size=(B, mc))),
                x=torch.as_tensor(0.1 * rng.standard_normal((B, n))),
                zc=torch.as_tensor(0.1 * rng.standard_normal((B, mc))),
                y=torch.as_tensor(0.1 * rng.standard_normal((B, mc))))
    return c, cand, f, h, warm


def test_pdip_fused_plain_matches_jax_fused(shell3x3_qps):
    c, cand, f, h, warm = shell3x3_qps
    iters = 15
    zj, lj, sj = qp_jax.solve_qp_masked_fused(
        *(jnp.asarray(x.numpy()) for x in (cand["H"], f, c["G0"], c["T2"],
                                           cand["rmask"], cand["cmask_z"],
                                           h)),
        iters, (jnp.asarray(warm["z"].numpy()),
                jnp.asarray(warm["lam"].numpy()), None))
    G = kernels.g_shared(c["G0"], c["T2"].T.contiguous())
    zt, lt, st = kernels.pdip_fused_plain(
        cand["H"].permute(1, 2, 0), f.T, h.T, cand["rmask"].T,
        cand["cmask_z"].T, (warm["z"].T, warm["lam"].T), G, iters)
    for a, b in ((zt, zj), (lt, lj), (st, sj)):
        np.testing.assert_allclose(a.T.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-10)


def test_admm_fused_plain_matches_jax_fused(shell3x3_qps):
    c, cand, f, h, warm = shell3x3_qps
    pre = cand["admm"]
    iters = 40
    state = (warm["x"], warm["zc"], warm["y"])
    zj, (xj, zcj, yj) = qp_jax.solve_qp_admm_fused(
        *(jnp.asarray(x.numpy()) for x in (pre["Minv"], pre["rho"],
                                           pre["Dinv"], pre["e"], f, h,
                                           cand["rmask"], cand["cmask_z"],
                                           c["G0"])),
        tuple(jnp.asarray(x.numpy()) for x in state), iters)
    Dinv_m = pre["Dinv"] * cand["cmask_z"]
    x, zc, y = kernels.admm_fused_plain(
        pre["Minv"].permute(1, 2, 0), (f * Dinv_m).T, (h * pre["e"]).T,
        (pre["e"] * cand["rmask"]).T, Dinv_m.T,
        torch.stack([pre["rho"], 1.0 / pre["rho"]]),
        tuple(s.T for s in state), kernels.g_shared(c["G0"]), iters, 1e-6,
        1.6)
    for a, b in ((x, xj), (zc, zcj), (y, yj), (x * pre["Dinv"].T, zj)):
        np.testing.assert_allclose(a.T.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)


NIT, B = 60, 4


@pytest.fixture(scope="module")
def wb():
    case_kw = dict(nit=NIT, nbp=6, nbc=3)
    pj, _ = build_jax(wb_jax.make_case(**case_kw), dtype=jnp.float64)
    pt, _ = build_torch(wb_torch.make_case(**case_kw), dtype=F64,
                        device="cpu")
    rng = np.random.default_rng(11)
    args = (np.array([30, 12, 20, 7]), np.array([5, 2, 3, 6]),
            rng.uniform(0.2, 2.0, (B, 2)), rng.uniform(0.01, 0.5, (B, 2)))
    return pj, pt, args


@pytest.mark.parametrize("engine,jax_method,iters,use_pallas", [
    ("pdip_ws_lanes", "pdip_ws_lanes", 15, False),
    ("pdip_ws_fused", "pdip_ws_fused", 15, True),
    ("admm_fused", "admm_fused@128", 40, True)])
def test_step_engine_matches_jax(wb, engine, jax_method, iters, use_pallas):
    pj, pt, args = wb
    r_b = np.broadcast_to(pj.r[:NIT], (B, NIT, 2))
    Yj, Uj = pj.loop.closed_batch(r_b, pj.v, *args, NIT, jnp.float64, iters,
                                  qp_method=jax_method,
                                  use_pallas=use_pallas)
    Yt, Ut = pt.loop.closed_batch(r_b, pt.v, *args, NIT, F64, iters,
                                  engine=engine, device="cpu")
    np.testing.assert_allclose(Yt.numpy(), np.asarray(Yj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj), rtol=0, atol=1e-10)


@pytest.mark.parametrize("engine", STEP_ENGINES)
def test_band_case_refuses_step_engines(engine):
    pt, _ = build_torch(s7_torch.make_case(nit=10), device="cpu")
    r_b = np.broadcast_to(pt.r[:10], (1, 10, 7))
    with pytest.raises(ValueError, match="band"):
        pt.loop.closed_batch(r_b, pt.v, [8], [2], np.zeros((1, 7)),
                             np.full((1, 3), 0.1), 10, F64, 5, engine=engine,
                             device="cpu")


@pytest.mark.parametrize("name", ["pdip_ws_fused@128", "pdip_ws_fused/subst",
                                  "hybrid", "pdip+lp20"])
def test_unported_engine_names_raise(wb, name):
    _, pt, args = wb
    r_b = np.broadcast_to(pt.r[:NIT], (B, NIT, 2))
    with pytest.raises(ValueError, match="unknown engine"):
        pt.loop.closed_batch(r_b, pt.v, *args, NIT, F64, 5, engine=name,
                             device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        obj_torch.resolve_qp_method(name)


def test_cpu_wrappers_never_launch(shell3x3_qps):
    c, cand, f, h, warm = shell3x3_qps
    kernels.reset_launches()
    M = cand["H"].permute(1, 2, 0)
    kernels.solve_lanes(kernels.factor_lanes(M), f.T)
    G = kernels.g_shared(c["G0"], c["T2"].T.contiguous())
    kernels.pdip_fused(M, f.T, h.T, cand["rmask"].T, cand["cmask_z"].T,
                       (warm["z"].T, warm["lam"].T), G, 3)
    pre = cand["admm"]
    kernels.admm_fused(pre["Minv"].permute(1, 2, 0), f.T, h.T,
                       cand["rmask"].T, cand["cmask_z"].T,
                       torch.stack([pre["rho"], 1.0 / pre["rho"]]),
                       (warm["x"].T, warm["zc"].T, warm["y"].T), G, 3, 1e-6,
                       1.6)
    assert set(kernels.launch_counts().values()) == {0}


def test_tuning_problem_runs_step_engines(wb):
    """Named per-step engines pass the stage policy, and 'admm_fused' runs
    at the problem's admm_iters as 'admm_sim' does."""
    _, pt, args = wb
    r_b = np.broadcast_to(pt.r[:NIT], (B, NIT, 2))
    pt.qp_method, pt.vns_qp_method = "pdip_ws_fused", "admm_fused"
    try:
        Yg, _ = pt.closed_batch(r_b, *args, stage="gam")
        Yv, _ = pt.closed_batch(r_b, *args, stage="vns")
    finally:
        pt.qp_method = pt.vns_qp_method = "auto"
    caps = pt._caps(args[0], args[1])
    for Y, engine, iters in ((Yg, "pdip_ws_fused", pt.qp_iters),
                             (Yv, "admm_fused", pt.admm_iters)):
        ref, _ = pt.loop.closed_batch(r_b, pt.v, *args, NIT, F64, iters,
                                      engine=engine, device="cpu", caps=caps)
        np.testing.assert_array_equal(Y, ref.numpy())
