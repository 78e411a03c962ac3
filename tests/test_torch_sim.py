"""The port's whole-sim engines (plain versions on the CPU) and open-loop
playback against the JAX package at float64, capacity-bucket exactness,
and the CPU/CUDA executor contract."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tuning_tpu.cases import woodberry as wb_jax
from mpc_tuning_tpu.sim.mpc_loop import (closed_loop_batch_sim_fused,
                                         horizon_caps as caps_jax)
from mpc_tuning_tpu.tuning.api import build_problem as build_jax
from mpc_tuning_tpu_torch.cases import woodberry as wb_torch
from mpc_tuning_tpu_torch.ops import kernels
from mpc_tuning_tpu_torch.sim.mpc_loop import horizon_caps
from mpc_tuning_tpu_torch.tuning.api import build_problem as build_torch

torch.set_num_threads(1)  # B = 4: threads only contend with other workers

F64 = torch.float64
NIT, B = 60, 4


def _problems(**case_kw):
    pj, _ = build_jax(wb_jax.make_case(nit=NIT, **case_kw), dtype=jnp.float64)
    pt, _ = build_torch(wb_torch.make_case(nit=NIT, **case_kw), dtype=F64,
                        device="cpu")
    return pj, pt


@pytest.fixture(scope="module")
def wb():
    return _problems()


def _mixed_candidates(seed=0):
    rng = np.random.default_rng(seed)
    N = rng.integers(16, 64, size=B)
    Nu = rng.integers(2, 7, size=B)
    return (N, Nu, rng.uniform(0.2, 2.0, size=(B, 2)),
            rng.uniform(0.01, 0.5, size=(B, 2)))


def test_admm_sim_matches_jax_whole_sim(wb):
    pj, pt = wb
    N, Nu, delta, lam = _mixed_candidates()
    caps = caps_jax(pj.loop.dims["p_max"], pj.loop.dims["m_max"], N, Nu)
    lj = pj.loop.capped(*caps)
    d = lj.dims
    r_b = np.broadcast_to(pj.r[:NIT], (B, NIT, 2))
    Yj, Uj = closed_loop_batch_sim_fused(
        lj.arrays(jnp.float64), jnp.asarray(r_b), jnp.asarray(pj.v[:NIT]),
        jnp.asarray(N), jnp.asarray(Nu), jnp.asarray(delta),
        jnp.asarray(lam), d["p_max"], d["m_max"], d["ny"], d["nu"],
        d["with_y"], d["rho"], 40, block_lanes=128)
    Yt, Ut = pt.loop.closed_batch(r_b, pt.v, N, Nu, delta, lam, NIT, F64, 40,
                                  engine="admm_sim", device="cpu")
    np.testing.assert_allclose(Yt.numpy(), np.asarray(Yj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj), rtol=0, atol=1e-10)


def test_pdip_sim_matches_jax_whole_sim():
    pj, pt = _problems(nbp=5, nbc=2)
    rng = np.random.default_rng(0)
    r_b = np.broadcast_to(pj.r[:NIT], (B, NIT, 2))
    args = (np.array([8, 12, 16, 20]), np.full(B, 2),
            rng.uniform(0.2, 2.0, (B, 2)), rng.uniform(0.01, 0.5, (B, 2)))
    Yj, Uj = pj.loop.closed_batch(r_b, pj.v, *args, NIT, jnp.float64, 15,
                                  qp_method="pdip_sim_fused@128")
    Yt, Ut = pt.loop.closed_batch(r_b, pt.v, *args, NIT, F64, 15,
                                  engine="pdip_sim", device="cpu")
    np.testing.assert_allclose(Yt.numpy(), np.asarray(Yj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj), rtol=0, atol=1e-10)


def test_open_batch_matches_jax(wb):
    pj, pt = wb
    N, Nu, delta, lam = _mixed_candidates(1)
    rfin = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    Yj, Uj = pj.loop.open_batch(rfin, pj.v, N, Nu, delta, lam, NIT,
                                jnp.float64, 30, use_pallas=False)
    Yt, Ut = pt.loop.open_batch(rfin, pt.v, N, Nu, delta, lam, NIT, F64, 30,
                                device="cpu")
    np.testing.assert_allclose(Yt.numpy(), np.asarray(Yj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj), rtol=0, atol=1e-10)


@pytest.mark.parametrize("engine", ["admm_sim", "pdip_sim"])
def test_capacity_bucketing_exact(wb, engine):
    _, pt = wb
    N, Nu, delta, lam = _mixed_candidates(2)
    d = pt.loop.dims
    assert horizon_caps(d["p_max"], d["m_max"], N, Nu) == (64, 8)
    r_b = np.broadcast_to(pt.r[:NIT], (B, NIT, 2))
    iters = 40 if engine == "admm_sim" else 10
    out = [pt.loop.closed_batch(r_b, pt.v, N, Nu, delta, lam, NIT, F64, iters,
                                engine=engine, caps=caps, device="cpu")
           for caps in ((64, 8), (127, 15))]
    for a, b in zip(*out):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)


def test_open_batch_capacity_bucketing_exact(wb):
    _, pt = wb
    N, Nu, delta, lam = _mixed_candidates(3)
    rfin = np.tile([1.0, 0.0], (B, 1))
    out = [pt.loop.open_batch(rfin, pt.v, N, Nu, delta, lam, NIT, F64, 30,
                              caps=caps, device="cpu") for caps in ((64, 8), (127, 15))]
    for a, b in zip(*out):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("engine", ["admm_sim", "pdip_sim"])
def test_plain_sim_follows_given_inputs(wb, engine):
    """With ``u_follow`` the plain loop steps the plant on the given inputs
    (its Y is the plant's response to them) and still returns its own U;
    following its own U reproduces the free run."""
    _, pt = wb
    N, Nu, delta, lam = _mixed_candidates(5)
    r_b = np.broadcast_to(pt.r[:NIT], (B, NIT, 2))
    t, lc, Hm, r_l, dims = pt.loop.sim_inputs(r_b, pt.v, N, Nu, delta, lam,
                                              NIT, F64, engine, "cpu")
    if engine == "admm_sim":
        run = lambda **kw: kernels.closed_sim_admm_plain(
            t, lc, Hm, r_l, NIT, 40, 1e-6, 1.6, dims, **kw)
    else:
        run = lambda **kw: kernels.closed_sim_pdip_plain(
            t, lc, Hm, r_l, NIT, 10, dims, **kw)
    Y, U = run()
    Yf, Uf = run(u_follow=U)
    np.testing.assert_allclose(Yf.numpy(), Y.numpy(), rtol=0, atol=1e-14)
    np.testing.assert_allclose(Uf.numpy(), U.numpy(), rtol=0, atol=1e-14)

    u_in = U + 0.01 * torch.sin(torch.arange(NIT, dtype=F64))[:, None, None]
    Yg, Ug = run(u_follow=u_in)
    o, nxp = dims["ny"] + t["A"].shape[0], t["Apl"].shape[0]
    bpl = t["Vt"][o:o + nxp].numpy()  # the plant's disturbance column
    x = np.zeros((nxp, B))
    for k in range(NIT):
        np.testing.assert_allclose(Yg[k].numpy(), t["Cpl"].numpy() @ x,
                                   rtol=0, atol=1e-12)
        x = (t["Apl"].numpy() @ x + t["Bplu"].numpy() @ u_in[k].numpy()
             + bpl[:, k:k + 1])
    np.testing.assert_allclose(Ug[0].numpy(), U[0].numpy(), rtol=0, atol=0)
    assert np.abs(Ug.numpy() - U.numpy()).max() > 1e-4  # its own QP answers


def test_cpu_tensors_never_launch_and_cuda_request_raises(wb):
    _, pt = wb
    N, Nu, delta, lam = _mixed_candidates(4)
    r_b = np.broadcast_to(pt.r[:NIT], (B, NIT, 2))
    kernels.reset_launches()
    for engine in ("admm_sim", "pdip_sim", "pdip_ws_fused", "pdip_ws_lanes",
                   "admm_fused"):
        pt.loop.closed_batch(r_b, pt.v, N, Nu, delta, lam, NIT, F64, 5,
                             engine=engine, device="cpu")
    pt.loop.open_batch(np.ones((B, 2)), pt.v, N, Nu, delta, lam, NIT, F64, 5,
                       device="cpu")
    assert kernels.launch_counts() == {
        "spd_factor": 0, "spd_factor_solve": 0, "spd_solve": 0,
        "factor_lanes": 0, "solve_lanes": 0, "pdip_fused": 0,
        "admm_fused": 0, "closed_sim_admm": 0, "closed_sim_pdip": 0,
        "closed_sim_band": 0, "nmpc_rollout": 0, "lane_sum": 0}
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            pt.loop.closed_batch(r_b, pt.v, N, Nu, delta, lam, NIT, F64, 5,
                                 engine="admm_sim", device="cuda")
    with pytest.raises(ValueError):  # an engine the port does not port
        pt.loop.closed_batch(r_b, pt.v, N, Nu, delta, lam, NIT, F64, 5,
                             engine="hybrid_fused", device="cpu")
