"""The port's candidate assembly, ADMM precompute, SPD factor/solve and
masked PDIP against the JAX package at float64 (Pallas kernels in
interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tuning_tpu.cases import woodberry as wb_jax
from mpc_tuning_tpu.ops import mpc_qp as mq_jax
from mpc_tuning_tpu.ops import qp as qp_jax
from mpc_tuning_tpu.ops.pallas_kernels import (_factor_batched_impl,
                                               _solve_batched_impl)
from mpc_tuning_tpu.tuning.api import build_problem as build_jax
from mpc_tuning_tpu_torch.cases import woodberry as wb_torch
from mpc_tuning_tpu_torch.ops import kernels
from mpc_tuning_tpu_torch.ops import mpc_qp as mq_torch
from mpc_tuning_tpu_torch.ops import qp as qp_torch
from mpc_tuning_tpu_torch.tuning.api import build_problem as build_torch

torch.set_num_threads(1)  # small batches: threads only contend with workers

F64 = torch.float64


@pytest.fixture(scope="module")
def loops():
    pj, _ = build_jax(wb_jax.make_case(), dtype=jnp.float64)
    pt, _ = build_torch(wb_torch.make_case(), dtype=F64, device="cpu")
    return pj.loop, pt.loop


def _candidates(rng, B, p_cap, m_cap):
    N = rng.integers(m_cap + 1, p_cap + 1, size=B)
    Nu = rng.integers(1, m_cap + 1, size=B)
    delta = rng.uniform(0.1, 3.0, size=(B, 2))
    lam = rng.uniform(0.01, 1.0, size=(B, 2))
    return N, Nu, delta, lam


def _assemble_both(loops, caps, seed, B=5):
    lj, lt = (l.capped(*caps) for l in loops)
    d = lj.dims
    N, Nu, delta, lam = _candidates(np.random.default_rng(seed), B, *caps)
    cj = lj.arrays(jnp.float64)
    cand_j = jax.vmap(mq_jax.assemble_candidate,
                      in_axes=(None, 0, 0, 0, 0) + (None,) * 6)(
        cj, jnp.asarray(N), jnp.asarray(Nu), jnp.asarray(delta),
        jnp.asarray(lam), d["p_max"], d["m_max"], d["ny"], d["nu"], d["rho"],
        False)
    ct = lt.arrays(F64, "cpu")
    cand_t = mq_torch.assemble_candidate(
        ct, torch.as_tensor(N), torch.as_tensor(Nu), torch.as_tensor(delta),
        torch.as_tensor(lam), d["p_max"], d["m_max"], d["ny"], d["nu"],
        d["rho"])
    return cj, cand_j, ct, cand_t, d


@pytest.mark.parametrize("caps", [(16, 4), (64, 8)])
def test_assemble_candidate_matches_jax(loops, caps):
    _, cand_j, _, cand_t, _ = _assemble_both(loops, caps, seed=caps[0])
    for k in ("H", "G", "QTheta", "rmask", "cmask_z", "cmask_flat",
              "row_mask", "en_du_hi", "en_du_lo", "en_u_hi", "en_u_lo"):
        np.testing.assert_allclose(cand_t[k].numpy(), np.asarray(cand_j[k]),
                                   rtol=0, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("caps", [(16, 4), (64, 8)])
def test_admm_precompute_matches_jax(loops, caps):
    _, cand_j, _, cand_t, _ = _assemble_both(loops, caps, seed=caps[0] + 1)
    for k in ("rho", "Dinv", "e", "Minv"):
        np.testing.assert_allclose(cand_t["admm"][k].numpy(),
                                   np.asarray(cand_j["admm"][k]),
                                   rtol=1e-9, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("n", [5, 17, 31])
@pytest.mark.parametrize("B", [1, 3, 130])
def test_spd_factor_solve_plain_matches_pallas(n, B):
    rng = np.random.default_rng(10 * n + B)
    A = rng.standard_normal((B, n, n))
    M = A @ A.transpose(0, 2, 1) + n * np.eye(n)
    rhs = rng.standard_normal((B, n))
    Lj = np.asarray(_factor_batched_impl(jnp.asarray(M)))
    Lt = kernels.spd_factor(torch.as_tensor(M)).numpy()
    np.testing.assert_allclose(np.tril(Lt), np.tril(Lj), rtol=0, atol=1e-12)
    assert np.array_equal(np.triu(Lt, 1), np.zeros_like(Lt))
    xj = np.asarray(_solve_batched_impl(jnp.asarray(np.tril(Lj)),
                                        jnp.asarray(rhs)))
    xt = kernels.spd_factor_solve(torch.as_tensor(Lt),
                                  torch.as_tensor(rhs)).numpy()
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-12)


@pytest.mark.parametrize("warm", [False, True])
def test_solve_qp_masked_matches_jax(loops, warm):
    """One masked PDIP per candidate from a random estimator state; JAX
    runs its reduced-system factor/solve through the Pallas kernels."""
    caps = (16, 4)
    cj, cand_j, ct, cand_t, d = _assemble_both(loops, caps, seed=7, B=4)
    rng = np.random.default_rng(8)
    nxa = cj["A"].shape[0]
    x_hat = rng.standard_normal((4, nxa)) * 0.3
    u_prev = rng.uniform(-0.3, 0.3, size=(4, 2))
    r_s = rng.uniform(-1.0, 1.0, size=(4, 2))
    v_s = np.array([0.1])
    args = (d["p_max"], d["m_max"], d["ny"], d["nu"])

    f_j, h_j, _ = jax.vmap(
        lambda cand, x, u, r: mq_jax.qp_step_data(cj, cand, x, u, r,
                                                  jnp.asarray(v_s), *args,
                                                  False))(
        cand_j, jnp.asarray(x_hat), jnp.asarray(u_prev), jnp.asarray(r_s))
    f_t, h_t, _ = mq_torch.qp_step_data(
        ct, cand_t, torch.as_tensor(x_hat), torch.as_tensor(u_prev),
        torch.as_tensor(r_s), torch.as_tensor(v_s), *args)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=1e-12)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=1e-12)

    n, mc = f_t.shape[1], h_t.shape[1]
    init_np = None
    if warm:
        init_np = (rng.standard_normal((4, n)) * 0.01,
                   rng.uniform(0.0, 2.0, size=(4, mc)), np.ones((4, mc)))

    def jax_solve(H, f, rm, cm, h, *init):
        return qp_jax.solve_qp_masked(H, f, cj["G0"], cj["T2"], rm, cm, h,
                                      iters=15, use_pallas=True,
                                      init=init if init else None)

    ins = (cand_j["H"], f_j, cand_j["rmask"], cand_j["cmask_z"], h_j)
    out_j = jax.vmap(jax_solve)(*ins, *(jnp.asarray(a) for a in init_np)) \
        if warm else jax.vmap(jax_solve)(*ins)
    out_t = qp_torch.solve_qp_masked(
        cand_t["H"], f_t, ct["G0"], ct["T2"], cand_t["rmask"],
        cand_t["cmask_z"], h_t, iters=15,
        init=tuple(torch.as_tensor(a) for a in init_np) if warm else None)
    for a, b, name in zip(out_t, out_j, ("z", "lam", "s")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-10, err_msg=name)
