"""The port's batch-major scan engines ('pdip', 'pdip_ws', 'pdip_dense',
'admm') against the JAX package's engines of the same names at float64 on
the CPU: whole Wood-Berry closed loops, and the QP functions they add
(``solve_qp_admm``, ``qp_kkt_residuals``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tuning_tpu.cases import woodberry as wb_jax
from mpc_tuning_tpu.ops import qp as qp_jax
from mpc_tuning_tpu.tuning.api import build_problem as build_jax
from mpc_tuning_tpu_torch.cases import shell3x3 as s3_torch
from mpc_tuning_tpu_torch.cases import woodberry as wb_torch
from mpc_tuning_tpu_torch.ops import kernels
from mpc_tuning_tpu_torch.ops import mpc_qp as mq_torch
from mpc_tuning_tpu_torch.ops import qp as qp_torch
from mpc_tuning_tpu_torch.sim.mpc_loop import BATCH_MAJOR_ENGINES
from mpc_tuning_tpu_torch.tuning import objectives as obj_torch
from mpc_tuning_tpu_torch.tuning.api import build_problem as build_torch

torch.set_num_threads(1)  # B <= 8: threads only contend with other workers

F64 = torch.float64
NIT, B = 60, 4
ITERS = {"pdip": 15, "pdip_ws": 15, "pdip_dense": 15, "admm": 40}


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


@pytest.mark.parametrize("engine", BATCH_MAJOR_ENGINES)
def test_scan_engine_matches_jax(wb, engine):
    """Y and U of a Wood-Berry batch (four candidates, three capacity
    buckets' worth of horizons) at 1e-10, the per-step engines' tolerance
    against the JAX package."""
    pj, pt, args = wb
    r_b = np.broadcast_to(pj.r[:NIT], (B, NIT, 2))
    Yj, Uj = pj.loop.closed_batch(r_b, pj.v, *args, NIT, jnp.float64,
                                  ITERS[engine], qp_method=engine,
                                  use_pallas=False)
    kernels.reset_launches()
    Yt, Ut = pt.loop.closed_batch(r_b, pt.v, *args, NIT, F64, ITERS[engine],
                                  engine=engine, device="cpu")
    assert set(kernels.launch_counts().values()) == {0}
    np.testing.assert_allclose(Yt.numpy(), np.asarray(Yj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj), rtol=0, atol=1e-10)


@pytest.mark.parametrize("engine", BATCH_MAJOR_ENGINES)
def test_tuning_problem_runs_scan_engine(wb, engine):
    """A named scan engine passes the stage policy through unchanged and
    runs at the problem's QP budget ('admm': its ADMM iterations)."""
    _, pt, args = wb
    assert obj_torch.resolve_qp_method(engine) == engine
    r_b = np.broadcast_to(pt.r[:NIT], (B, NIT, 2))
    pt.qp_method = engine
    try:
        Y, _ = pt.closed_batch(r_b, *args, stage="gam")
    finally:
        pt.qp_method = "auto"
    iters = pt.admm_iters if engine == "admm" else pt.qp_iters
    ref, _ = pt.loop.closed_batch(r_b, pt.v, *args, NIT, F64, iters,
                                  engine=engine, device="cpu",
                                  caps=pt._caps(args[0], args[1]))
    np.testing.assert_array_equal(Y, ref.numpy())


@pytest.fixture(scope="module")
def shell3x3_qps():
    """Single QPs at Shell3x3's (32, 4) bucket (n = 13, mc = 49): 6 seeded
    candidates at a seeded estimator state and last input, with seeded
    ADMM warm states and PDIP iterates."""
    pt, _ = build_torch(s3_torch.make_case(nit=30), device="cpu")
    caps, nb = (32, 4), 6
    rng = np.random.default_rng(7)
    N = rng.integers(caps[1] + 1, caps[0] + 1, size=nb)
    Nu = rng.integers(1, caps[1] + 1, size=nb)
    N[0], Nu[0] = caps
    loop = pt.loop.capped(*caps)
    d = loop.dims
    c = loop.arrays(F64, "cpu")
    cand = mq_torch.assemble_candidate(
        c, torch.as_tensor(N), torch.as_tensor(Nu),
        torch.as_tensor(rng.uniform(0.05, 2.0, size=(nb, 3))),
        torch.as_tensor(np.exp(rng.uniform(np.log(1e-3), 0.0, (nb, 3)))),
        d["p_max"], d["m_max"], d["ny"], d["nu"], d["rho"])
    x_hat = torch.as_tensor(0.3 * rng.standard_normal((nb, c["A"].shape[0])))
    u_prev = torch.as_tensor(rng.uniform(-0.8, 0.4, size=(nb, 3)))
    r_s = torch.as_tensor(rng.uniform(0.0, 0.4, size=(nb, 3)))
    f, h, _ = mq_torch.qp_step_data(c, cand, x_hat, u_prev, r_s,
                                    torch.zeros(0, dtype=F64), d["p_max"],
                                    d["m_max"], d["ny"], d["nu"])
    n, mc = f.shape[1], h.shape[1]
    state = tuple(torch.as_tensor(0.1 * rng.standard_normal((nb, k)))
                  for k in (n, mc, mc))
    return cand, f, h, state


def _jnp(x):
    return jnp.asarray(x.numpy())


def test_solve_qp_admm_matches_jax(shell3x3_qps):
    """Forty warm ADMM iterations from a seeded state: z and the new
    state at 1e-12."""
    cand, f, h, state = shell3x3_qps
    pre = cand["admm"]
    zt, st = qp_torch.solve_qp_admm(pre, f, h, state, 40)
    solve = jax.vmap(lambda p, f_, h_, s: qp_jax.solve_qp_admm(p, f_, h_, s,
                                                               40))
    zj, sj = solve({k: _jnp(v) for k, v in pre.items()}, _jnp(f), _jnp(h),
                   tuple(map(_jnp, state)))
    for a, b in zip((zt,) + st, (zj,) + tuple(sj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)


def test_qp_kkt_residuals_matches_jax(shell3x3_qps):
    """The residual norms of a PDIP solution, batched and for one QP, at
    1e-12 (the primal residual sits at the rounding floor, ~1e-13)."""
    cand, f, h, _ = shell3x3_qps
    H, G = cand["H"], cand["G"]
    z, lam, s = qp_torch.solve_qp(H, f, G, h, 8)
    out = qp_torch.qp_kkt_residuals(H, f, G, h, z, lam, s)
    ref = jax.vmap(qp_jax.qp_kkt_residuals)(*map(_jnp, (H, f, G, h, z, lam,
                                                        s)))
    for a, b in zip(out, ref):
        assert a.shape == (H.shape[0],)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)
    one = qp_torch.qp_kkt_residuals(*(x[2] for x in (H, f, G, h, z, lam, s)))
    for a, b in zip(one, out):
        assert a.shape == () and float(a) == float(b[2])
