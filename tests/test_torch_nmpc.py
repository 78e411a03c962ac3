"""The port's NMPC slice against the JAX package at float64 on the CPU: the
ODE integrators and steady state, the plain rollout and its sensitivities
(``models/ode.nmpc_rollout_plain``), the dense batched PDIP
(``ops/qp.solve_qp``), ``spd_solve``'s plain version, and the NMPC closed
loop, open leg and single simulation (nit 12, nbp/nbc 3/2, substeps 2,
SQP 2, QP 10 iterations, B = 4)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tuning_tpu.cases import vandevusse as vdv_jax
from mpc_tuning_tpu.models import ode as ode_jax
from mpc_tuning_tpu.ops.pallas_kernels import spd_solve as spd_solve_jax
from mpc_tuning_tpu.ops.qp import solve_qp as solve_qp_jax
from mpc_tuning_tpu.sim import nmpc_loop as nmpc_jax
from mpc_tuning_tpu_torch import convert
from mpc_tuning_tpu_torch.cases import vandevusse as vdv_torch
from mpc_tuning_tpu_torch.models import ode as ode_torch
from mpc_tuning_tpu_torch.ops import kernels as K
from mpc_tuning_tpu_torch.ops.qp import solve_qp
from mpc_tuning_tpu_torch.sim.nmpc_loop import NMPCLoop, nmpc_closed_core

torch.set_num_threads(1)  # B <= 4: threads only contend with other workers

CASE_KW = dict(nit=12, nbp=3, nbc=2, substeps=2, sqp_iters=2, qp_iters=10)
NIT, B = 12, 4


def _states(rng, B):
    """States and inputs around the operating point (the small tests'
    2-substep RK4 leaves its stability region at high feed and
    temperature)."""
    x = rng.uniform([1.0, 0.5, 125.0], [2.5, 1.2, 137.0], (B, 3))
    u = rng.uniform([5.0, 110.0], [25.0, 135.0], (B, 2))
    return x, u


def _fields(spec):
    """The JAX spec's fields but rhs, arrays as NumPy."""
    out = {}
    for f in dataclasses.fields(spec):
        if f.name != "rhs":
            v = getattr(spec, f.name)
            out[f.name] = np.asarray(v) if hasattr(v, "shape") else v
    return out


@pytest.fixture(scope="module")
def specs():
    sj = vdv_jax.make_case(**CASE_KW).spec
    return sj, convert.nmpc_spec_from_numpy(_fields(sj))


# ------------------------------------------------------------ the model


@pytest.mark.parametrize("method", ["rk4", "tr_bdf2"])
def test_integrate_matches_jax(method):
    x, u = _states(np.random.default_rng(1), 5)
    xj = np.stack([np.asarray(ode_jax.integrate(
        ode_jax.vandevusse_rhs, jnp.asarray(a), jnp.asarray(b), 0.05, 4,
        method)) for a, b in zip(x, u)])
    xt = ode_torch.integrate(ode_torch.vandevusse_rhs, torch.tensor(x),
                             torch.tensor(u), 0.05, 4, method).numpy()
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-12)


def test_integrate_rk4_matches_jax():
    x, u = _states(np.random.default_rng(8), 5)
    xj = np.stack([np.asarray(ode_jax.integrate_rk4(
        ode_jax.vandevusse_rhs, jnp.asarray(a), jnp.asarray(b), 0.05, 4))
        for a, b in zip(x, u)])
    xt = ode_torch.integrate_rk4(ode_torch.vandevusse_rhs, torch.tensor(x),
                                 torch.tensor(u), 0.05, 4).numpy()
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-12)


def test_newton_steady_state_matches_jax():
    xj = np.asarray(ode_jax.newton_steady_state(
        ode_jax.vandevusse_rhs, ode_jax.VDV_X0, ode_jax.VDV_U0))
    xt = ode_torch.newton_steady_state(ode_torch.vandevusse_rhs,
                                       ode_torch.VDV_X0, ode_torch.VDV_U0)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-12)


def test_partials_match_jacfwd():
    """The written-out Van de Vusse partials against torch.func.jacfwd of
    the rhs (the generic path of ``rhs_partials``)."""
    x, u = (torch.tensor(a) for a in _states(np.random.default_rng(2), 6))
    fx, fu = ode_torch.vandevusse_partials(x, u)
    gx, gu = ode_torch.rhs_partials(lambda a, b: ode_torch.vandevusse_rhs(a, b))(x, u)
    torch.testing.assert_close(fx, gx, rtol=1e-13, atol=0)
    torch.testing.assert_close(fu, gu, rtol=1e-13, atol=0)


# ------------------------------------------------ rollout and sensitivities


@pytest.mark.parametrize("method", ["rk4", "tr_bdf2"])
def test_rollout_and_jacobian_match_jax(specs, method):
    """Yf and J of ``nmpc_rollout_plain`` against the JAX package's
    ``_rollout_y`` and its ``jax.jacfwd``, within 1e-10 relative."""
    sj, st = (dataclasses.replace(s, integrator=method) for s in specs)
    p, m, nu = sj.p_max, sj.m_max, sj.nu
    rng = np.random.default_rng(3)
    x, up = _states(rng, B)
    du = rng.uniform(-1.0, 1.0, (B, m * nu))
    cm = (np.arange(m)[None] < np.array([[3], [2], [1], [3]])).astype(float)

    def y_of(d, xx, uu, cc):
        u_seq = nmpc_jax._u_sequence(d, uu, cc, m, nu)
        return nmpc_jax._rollout_y(ode_jax.vandevusse_rhs, xx, u_seq, p, m,
                                   sj.substeps, sj.Ts, sj.xc, method).reshape(-1)

    args = [(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), jnp.asarray(e))
            for a, b, c, e in zip(du, x, up, cm)]
    Yj = np.stack([np.asarray(y_of(*a)) for a in args])
    Jj = np.stack([np.asarray(jax.jacfwd(y_of)(*a)) for a in args])
    Yt, Jt = ode_torch.nmpc_rollout_plain(
        st, torch.tensor(x), torch.tensor(up), torch.tensor(du),
        torch.tensor(cm), p, jac=True)
    assert np.isfinite(Jj).all()
    assert np.abs(Yt.numpy() - Yj).max() <= 1e-10 * np.abs(Yj).max()
    assert np.abs(Jt.numpy() - Jj).max() <= 1e-10 * np.abs(Jj).max()


def test_rollout_plant_step_and_playback(specs):
    """m = 0 is one plant interval at u_prev; ``hold`` clamps the playback
    input to the last active move (the JAX open leg's index rule)."""
    _, st = specs
    rng = np.random.default_rng(4)
    x, up = (torch.tensor(a) for a in _states(rng, B))
    none = torch.zeros((B, 0), dtype=torch.float64)
    x1 = ode_torch.nmpc_rollout_plain(st, x, up, none, none, 1,
                                      outputs=range(3))[0]
    torch.testing.assert_close(x1, ode_torch.integrate(
        st.rhs, x, up, st.Ts, st.substeps), rtol=0, atol=0)
    m = st.m_max
    du = torch.tensor(rng.uniform(-3.0, 3.0, (B, m * 2)))
    cm = torch.ones((B, m), dtype=torch.float64)
    hold = torch.tensor([0, 1, 2, 5], dtype=torch.int32)
    U = ode_torch.rollout_inputs(up, du, cm, hold, 6)
    u_seq = up[:, None] + torch.cumsum(du.reshape(B, m, 2), 1)
    for b in range(B):
        for k in range(6):
            idx = min(k, m - 1, int(hold[b]))
            assert torch.equal(U[b, k], u_seq[b, idx])


def test_rollout_envelope():
    """The rollout kernel runs the Van de Vusse rhs with RK4 or TR-BDF2;
    an unknown integrator and another rhs raise before any launch
    (another rhs runs on the CPU)."""
    spec = vdv_torch.make_case(**CASE_KW).spec
    ode_torch.nmpc_envelope(spec)
    ode_torch.nmpc_envelope(dataclasses.replace(spec, integrator="tr_bdf2"))
    with pytest.raises(ValueError, match="unknown integrator 'euler'"):
        ode_torch.nmpc_envelope(dataclasses.replace(spec, integrator="euler"))
    with pytest.raises(ValueError, match="no kernel for rhs"):
        ode_torch.nmpc_envelope(dataclasses.replace(spec, rhs=lambda x, u: -x))
    with pytest.raises(ValueError, match="no kernel for rhs"):
        ode_torch.nmpc_envelope(dataclasses.replace(
            spec, rhs=lambda x, u: -x, integrator="tr_bdf2"))


# ------------------------------------------------------- the QP and SPD solve


def _qp_batch(rng, Bq, n, m):
    A = rng.standard_normal((Bq, n, n))
    H = A @ A.transpose(0, 2, 1) + n * np.eye(n)
    f = rng.standard_normal((Bq, n))
    G = rng.standard_normal((Bq, m, n))
    h = rng.uniform(0.1, 2.0, (Bq, m))
    G[:, -2:] = 0.0
    h[:, -2:] = 1.0  # disabled rows, as the NMPC QP masks them
    return H, f, G, h


@pytest.mark.parametrize("use_pallas", [False, True])
def test_solve_qp_matches_jax(use_pallas):
    H, f, G, h = _qp_batch(np.random.default_rng(5), 3, 7, 16)
    zj = np.asarray(jax.vmap(lambda *a: solve_qp_jax(
        *a, iters=12, use_pallas=use_pallas)[0])(
        *(jnp.asarray(a) for a in (H, f, G, h))))
    zt = solve_qp(*(torch.tensor(a) for a in (H, f, G, h)), iters=12)[0]
    np.testing.assert_allclose(zt.numpy(), zj, rtol=0, atol=1e-9)


def test_solve_qp_warm_start_matches_jax():
    rng = np.random.default_rng(6)
    H, f, G, h = _qp_batch(rng, 3, 7, 16)
    init = (rng.standard_normal((3, 7)) * 0.1, rng.uniform(0, 2, (3, 16)),
            np.ones((3, 16)))
    zj = np.asarray(jax.vmap(lambda H_, f_, G_, h_, z0, l0, s0: solve_qp_jax(
        H_, f_, G_, h_, iters=12, init=(z0, l0, s0))[0])(
        *(jnp.asarray(a) for a in (H, f, G, h) + init)))
    zt = solve_qp(*(torch.tensor(a) for a in (H, f, G, h)), iters=12,
                  init=tuple(torch.tensor(a) for a in init))[0]
    np.testing.assert_allclose(zt.numpy(), zj, rtol=0, atol=1e-9)


@pytest.mark.parametrize("Bs,n", [(1, 4), (5, 31), (130, 16)])
def test_spd_solve_plain_matches_jax(Bs, n):
    """Against the Pallas kernel in interpret mode (as
    tests/test_pallas_kernels.py runs it), at float64."""
    rng = np.random.default_rng(Bs * 100 + n)
    A = rng.standard_normal((Bs, n, n))
    M = A @ A.transpose(0, 2, 1) + n * np.eye(n)
    rhs = rng.standard_normal((Bs, n))
    xj = np.asarray(jax.vmap(spd_solve_jax)(jnp.asarray(M), jnp.asarray(rhs)))
    xt = K.spd_solve_plain(torch.tensor(M), torch.tensor(rhs)).numpy()
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-10)


def test_spd_solve_failed_factor_is_nan():
    M = torch.eye(3, dtype=torch.float64)[None].repeat(2, 1, 1)
    M[1, 2, 2] = -1.0
    x = K.spd_solve(M, torch.ones((2, 3), dtype=torch.float64))
    assert torch.equal(x[0], torch.ones(3, dtype=torch.float64))
    assert torch.isnan(x[1]).all()


# ------------------------------------------------------------ the loops


@pytest.fixture(scope="module")
def loops(specs):
    sj, st = specs
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
    """A single loop at the full (p_max, m_max), as the JAX package runs
    ``simulate`` (no capacity bucket)."""
    lj, lt, b, r = loops
    args = (r, np.zeros((NIT, 0)), NIT, 3, 2, b["delta_b"][0], b["lam_b"][0])
    yj, uj = lj.simulate(*args)
    yt, ut = lt.simulate(*args, device="cpu")
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-8)
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-8)


def test_closed_loop_follows_given_inputs(loops):
    """With u_follow the plain loop steps the plant on the given inputs and
    still returns its own: fed its own U it repeats itself exactly; fed
    another U, its Y is that U's trajectory."""
    _, lt, b, r = loops
    spec, c, N, Nu, (r_t, d, l) = lt._batch(
        None, b["N_b"], b["Nu_b"], None, torch.float64, "cpu",
        np.broadcast_to(r, (B, NIT, 2)), b["delta_b"], b["lam_b"])
    Y, U = nmpc_closed_core(spec, c, r_t, N, Nu, d, l)
    Yf, Uf = nmpc_closed_core(spec, c, r_t, N, Nu, d, l, u_follow=U)
    assert torch.equal(Yf, Y) and torch.equal(Uf, U)
    U2 = U + 0.5
    Y2, _ = nmpc_closed_core(spec, c, r_t, N, Nu, d, l, u_follow=U2)
    x = c["x0"].expand(B, 3)
    for k in range(1, NIT):
        x = ode_torch.integrate(spec.rhs, x, U2[:, k], spec.Ts, spec.substeps)
        torch.testing.assert_close(Y2[:, k], x[:, 1:], rtol=0, atol=0)


def test_closed_loop_solves_only_the_given_steps(loops):
    """With solve_steps the following loop returns, at those steps, the
    U of the loop that solves every step, and the given U elsewhere; its
    Y is unchanged.  Without u_follow it raises."""
    _, lt, b, r = loops
    spec, c, N, Nu, (r_t, d, l) = lt._batch(
        None, b["N_b"], b["Nu_b"], None, torch.float64, "cpu",
        np.broadcast_to(r, (B, NIT, 2)), b["delta_b"], b["lam_b"])
    U2 = nmpc_closed_core(spec, c, r_t, N, Nu, d, l)[1] + 0.5
    Y, U = nmpc_closed_core(spec, c, r_t, N, Nu, d, l, u_follow=U2)
    steps = {2, 3, 9}
    Yw, Uw = nmpc_closed_core(spec, c, r_t, N, Nu, d, l, u_follow=U2,
                              solve_steps=steps)
    assert torch.equal(Yw, Y)
    for k in range(1, NIT):
        assert torch.equal(Uw[:, k], U[:, k] if k in steps else U2[:, k])
    with pytest.raises(ValueError, match="u_follow"):
        nmpc_closed_core(spec, c, r_t, N, Nu, d, l, solve_steps=steps)


def test_measured_disturbance_and_mesh_raise(loops):
    """A measured disturbance raises; ``NMPCLoop`` takes no ``mesh``: a
    candidate mesh shards the batch in ``TuningProblem`` (the sharded
    batch equals the whole one, tests/test_torch_parallel.py)."""
    _, lt, b, r = loops
    args = (np.broadcast_to(r, (B, NIT, 2)), np.zeros((NIT, 1)), b["N_b"],
            b["Nu_b"], b["delta_b"], b["lam_b"], NIT)
    with pytest.raises(ValueError, match="measured disturbances"):
        lt.closed_batch(*args, device="cpu")
    with pytest.raises(TypeError, match="mesh"):
        lt.closed_batch(*((args[0], None) + args[2:]), mesh=object(),
                        device="cpu")
