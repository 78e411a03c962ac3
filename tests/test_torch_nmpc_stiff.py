"""The port's stiff NMPC path, the Van de Vusse case with TR-BDF2 (the
reference integrates it with ode15s), against the JAX package at float64
on the CPU: the plain TR-BDF2 step on the written-out partials, the closed
loop, open leg and single simulation, and the nonlinear VNS objective (nit
12, nbp/nbc 3/2, substeps 2, SQP 2, QP 10 iterations, B = 4, as
tests/test_torch_nmpc.py runs RK4).

About 60 s on one worker (57 s on one CPU core), most of it the JAX
package's tracing and compiling; the port's plain closed batch takes
~3 s of it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tuning_tpu.cases import vandevusse as vdv_jax
from mpc_tuning_tpu.models import ode as ode_jax
from mpc_tuning_tpu.sim import nmpc_loop as nmpc_jax
from mpc_tuning_tpu.tuning.objectives import vns_objective_batch as vns_jax
from mpc_tuning_tpu_torch import convert
from mpc_tuning_tpu_torch.cases import vandevusse as vdv_torch
from mpc_tuning_tpu_torch.models import ode as ode_torch
from mpc_tuning_tpu_torch.sim.nmpc_loop import NMPCLoop
from mpc_tuning_tpu_torch.tuning.objectives import vns_objective_batch

torch.set_num_threads(1)  # B <= 6: threads only contend with other workers

CASE_KW = dict(nit=12, nbp=3, nbc=2, substeps=2, sqp_iters=2, qp_iters=10,
               integrator="tr_bdf2")
NIT, B = 12, 4


def _states(rng, B):
    x = rng.uniform([1.0, 0.5, 125.0], [2.5, 1.2, 137.0], (B, 3))
    u = rng.uniform([5.0, 110.0], [25.0, 135.0], (B, 2))
    return x, u


# ------------------------------------------------------------ the step


@pytest.mark.parametrize("dt,newton_iters", [(0.005, 6), (0.025, 6),
                                             (0.025, 3)])
def test_tr_bdf2_step_matches_jax(dt, newton_iters):
    """One TR-BDF2 step (Newton Jacobians from the written-out partials)
    against the JAX package's (jax.jacfwd Jacobians), within 1e-12."""
    x, u = _states(np.random.default_rng(11), 6)
    xj = np.asarray(jax.vmap(lambda a, b: ode_jax.tr_bdf2_step(
        ode_jax.vandevusse_rhs, a, b, dt, newton_iters))(
        jnp.asarray(x), jnp.asarray(u)))
    xt = ode_torch.tr_bdf2_step(ode_torch.vandevusse_rhs, torch.tensor(x),
                                torch.tensor(u), dt, newton_iters).numpy()
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-12)


def test_tr_bdf2_integrate_matches_jax():
    """The case's interval (Ts 0.05 h, 10 substeps) from states across the
    operating range, within 1e-12."""
    x, u = _states(np.random.default_rng(12), 6)
    xj = np.asarray(jax.vmap(lambda a, b: ode_jax.integrate(
        ode_jax.vandevusse_rhs, a, b, 0.05, 10, "tr_bdf2"))(
        jnp.asarray(x), jnp.asarray(u)))
    xt = ode_torch.integrate(ode_torch.vandevusse_rhs, torch.tensor(x),
                             torch.tensor(u), 0.05, 10, "tr_bdf2").numpy()
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-12)


def test_tr_bdf2_generic_rhs_matches_written_partials():
    """Another rhs takes its Newton Jacobians from torch.func.jacfwd of the
    rhs alone (``rhs_partials``): the same step as the written-out
    partials' to 1e-13, batched over several states."""
    x, u = (torch.tensor(a) for a in _states(np.random.default_rng(13), 5))
    generic = lambda a, b: ode_torch.vandevusse_rhs(a, b)
    xt = ode_torch.tr_bdf2_step(ode_torch.vandevusse_rhs, x, u, 0.005)
    xg = ode_torch.tr_bdf2_step(generic, x, u, 0.005)
    torch.testing.assert_close(xg, xt, rtol=0, atol=1e-13)


# ------------------------------------------------------------ the loops


def _fields(spec):
    out = {}
    for f in dataclasses.fields(spec):
        if f.name != "rhs":
            v = getattr(spec, f.name)
            out[f.name] = np.asarray(v) if hasattr(v, "shape") else v
    return out


@pytest.fixture(scope="module")
def loops():
    sj = vdv_jax.make_case(**CASE_KW).spec
    st = convert.nmpc_spec_from_numpy(_fields(sj))
    assert st.integrator == "tr_bdf2"
    rng = np.random.default_rng(7)
    batch = dict(N_b=np.array([7, 5, 3, 7]), Nu_b=np.array([3, 2, 2, 3]),
                 delta_b=rng.uniform(0.2, 2.0, (B, 2)),
                 lam_b=rng.uniform(0.05, 0.5, (B, 2)))
    r = vdv_jax.make_case(**CASE_KW).r
    return nmpc_jax.NMPCLoop(spec=sj), NMPCLoop(spec=st), batch, r


def test_closed_batch_matches_jax(loops):
    lj, lt, b, r = loops
    r_b = np.broadcast_to(r, (B, NIT, 2))
    Yj, Uj = lj.closed_batch(jnp.asarray(r_b), None, b["N_b"], b["Nu_b"],
                             b["delta_b"], b["lam_b"], NIT, jnp.float64, 10)
    Yt, Ut = lt.closed_batch(r_b, None, b["N_b"], b["Nu_b"], b["delta_b"],
                             b["lam_b"], NIT, device="cpu")
    np.testing.assert_allclose(Yt.numpy(), np.asarray(Yj), rtol=0, atol=1e-8)
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj), rtol=0, atol=1e-8)


def test_open_batch_matches_jax(loops):
    lj, lt, b, r = loops
    rfin = np.broadcast_to(r[-1], (B, 2))
    Yj, Uj = lj.open_batch(jnp.asarray(rfin), None, b["N_b"], b["Nu_b"],
                           b["delta_b"], b["lam_b"], NIT, jnp.float64, 10)
    Yt, Ut = lt.open_batch(rfin, None, b["N_b"], b["Nu_b"], b["delta_b"],
                           b["lam_b"], NIT, device="cpu")
    np.testing.assert_allclose(Yt.numpy(), np.asarray(Yj), rtol=0, atol=1e-8)
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj), rtol=0, atol=1e-8)


def test_simulate_matches_jax(loops):
    """A single stiff loop at the full (p_max, m_max)."""
    lj, lt, b, r = loops
    args = (r, np.zeros((NIT, 0)), NIT, 3, 2, b["delta_b"][1], b["lam_b"][1])
    yj, uj = lj.simulate(*args)
    yt, ut = lt.simulate(*args, device="cpu")
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-8)
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-8)


def test_stiff_vns_objective_matches_jax():
    """The nonlinear VNS objective (closed and open legs, one selector lane
    per output) on the stiff case's problem, within 1e-8 relative."""
    pj = vdv_jax.build_problem(vdv_jax.make_case(**CASE_KW))
    pt = vdv_torch.build_problem(vdv_torch.make_case(**CASE_KW),
                                 device="cpu")
    assert pt.loop.spec.integrator == "tr_bdf2"
    N, Nu = np.array([7, 4, 6]), np.array([2, 3, 1])
    d, l = np.array([0.6, 1.4]), np.array([0.15, 0.3])
    Fj, parts_j = vns_jax(pj, N, Nu, d, l, return_parts=True)
    Ft, parts_t = vns_objective_batch(pt, N, Nu, d, l, return_parts=True)
    np.testing.assert_allclose(Ft, Fj, rtol=1e-8)
    for k in parts_j:
        np.testing.assert_allclose(parts_t[k], parts_j[k], rtol=1e-8)
