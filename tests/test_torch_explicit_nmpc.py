"""The port's explicit NMPC (``sim/explicit_nmpc.py``,
``cases/vandevusse_explicit.py``) against the JAX package at float64 on
the CPU, at the JAX package's own test settings (substeps 6, SQP 4, QP
20), nit 24 (the Cb setpoint step at k = 9 and the loop's start at k = 3
inside): Y and U at 1e-8 noise-free and with the JAX package's own noise
draw passed in, one lane each of one batch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tuning_tpu.cases import vandevusse_explicit as vex_jax
from mpc_tuning_tpu_torch.cases import vandevusse_explicit as vex
from mpc_tuning_tpu_torch.models.ode import (VDV_U0, VDV_X0,
                                             newton_steady_state,
                                             vandevusse_rhs)

torch.set_num_threads(1)  # B <= 2: threads only contend with other workers

KW = dict(substeps=6, sqp_iters=4, qp_iters=20)
NIT, SEED = 24, 3


def jax_noise(seed, nit, noise=0.01, nx=3):
    """The measurement noise the JAX loop draws (its _explicit_closed: the
    key split once a step, one normal draw of the state's shape)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(nit):
        key, sub = jax.random.split(key)
        out.append(noise * np.asarray(jax.random.normal(sub, (nx,),
                                                        jnp.float64)))
    return np.stack(out)


@pytest.fixture(scope="module")
def runs():
    """The port's loop on a batch of two noise arrays (zero, and the JAX
    package's draw) and the JAX package's two runs."""
    ctl = vex.make_controller(**KW)
    x0 = newton_steady_state(vandevusse_rhs, VDV_X0, VDV_U0)
    r = vex.make_reference(x0, NIT)
    noise = np.stack([np.zeros((NIT, 3)), jax_noise(SEED, NIT)])
    Y, U = ctl.simulate(x0, np.asarray(VDV_U0), r, NIT, inK=vex.INK,
                        noise=noise, device="cpu")
    jax_runs = [vex_jax.run(nit=NIT, seed=SEED, noise=n, **KW)
                for n in (0.0, 0.01)]
    return ctl, (x0, r), (Y, U), jax_runs


@pytest.mark.parametrize("lane,what", [(0, "noise-free"), (1, "JAX draw")])
def test_explicit_nmpc_matches_jax(runs, lane, what):
    _, (_, r), (Y, U), jax_runs = runs
    rj, yj, uj = jax_runs[lane]
    np.testing.assert_allclose(r, rj, rtol=0, atol=1e-12)  # x0 to an ulp
    np.testing.assert_allclose(Y[lane], yj, rtol=0, atol=1e-8, err_msg=what)
    np.testing.assert_allclose(U[lane], uj, rtol=0, atol=1e-8, err_msg=what)
    assert np.abs(np.diff(U[lane], axis=0)).max() > 1e-3  # the loop acted


def test_steady_state_and_reference_match_jax(runs):
    _, (x0, r), _, _ = runs
    from mpc_tuning_tpu.models.ode import newton_steady_state as nss_jax
    from mpc_tuning_tpu.models.ode import vandevusse_rhs as rhs_jax
    x0j = np.asarray(nss_jax(rhs_jax, VDV_X0, VDV_U0))
    np.testing.assert_allclose(x0, x0j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(r, vex_jax.make_reference(x0j, NIT), rtol=0,
                               atol=1e-12)


def test_run_noise_free_matches_the_batch_lane(runs):
    """``run`` with noise 0 is the noise-free lane of the batch (a lane's
    result does not depend on the others beside it), whatever the
    seed."""
    _, _, (Y, U), _ = runs
    r, y, u = vex.run(nit=12, seed=5, noise=0.0, device="cpu", **KW)
    np.testing.assert_allclose(y, Y[0, :12], rtol=0, atol=1e-12)
    np.testing.assert_allclose(u, U[0, :12], rtol=0, atol=1e-12)


def test_draw_noise_is_seeded():
    ctl = vex.make_controller(noise=0.02)
    a, b = ctl.draw_noise(10, seed=4), ctl.draw_noise(10, seed=4)
    assert a.shape == (10, 3) and np.array_equal(a, b)
    assert not np.array_equal(a, ctl.draw_noise(10, seed=5))
    assert 0.005 < a.std() < 0.05


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vex.run(nit=2, **KW)
    ctl = vex.make_controller(**KW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ctl.simulate(VDV_X0, VDV_U0, np.zeros((2, 2)), 2)


@pytest.mark.parametrize("substeps", [1, 6])
def test_fused_vandevusse_tangent_matches_integrate_tangent(substeps):
    """The explicit NMPC's rollout (``models/ode.vandevusse_rk4_tangent``)
    against the general ``integrate_tangent`` of the same rhs and RK4 on
    seeded states, inputs and tangents: 1e-13 relative."""
    from mpc_tuning_tpu_torch.models import ode

    rng = np.random.default_rng(substeps)
    B, k = 7, 4
    x = torch.tensor(rng.uniform([1.0, 0.5, 125.0], [2.5, 1.2, 137.0],
                                 (B, 3)))
    u = torch.tensor(rng.uniform([5.0, 110.0], [25.0, 135.0], (B, 2)))
    dX = torch.tensor(rng.standard_normal((B, 3, k)))
    dU = torch.tensor(rng.standard_normal((B, 2, k)))
    xa, da = ode.integrate_tangent(vandevusse_rhs, x, u, dX, dU, vex.TS,
                                   substeps)
    xb, db = ode.vandevusse_rk4_tangent(x, u, dX, dU, vex.TS, substeps)
    for a, b in ((xb, xa), (db, da)):
        assert float((a - b).abs().max() / b.abs().max()) < 1e-13


def test_rollout_tangent_picks_the_fused_rollout_for_van_de_vusse_rk4():
    """``models/ode.rollout_tangent``, the explicit NMPC's rollout: the
    bits of ``vandevusse_rk4_tangent`` for the Van de Vusse rhs with RK4,
    and of ``integrate_tangent`` for TR-BDF2 and for another rhs."""
    from mpc_tuning_tpu_torch.models import ode

    rng = np.random.default_rng(11)
    B, k = 3, 2
    x = torch.tensor(rng.uniform([1.0, 0.5, 125.0], [2.5, 1.2, 137.0],
                                 (B, 3)))
    u = torch.tensor(rng.uniform([5.0, 110.0], [25.0, 135.0], (B, 2)))
    dX = torch.tensor(rng.standard_normal((B, 3, k)))
    dU = torch.tensor(rng.standard_normal((B, 2, k)))

    def other(x, u):  # another rhs: Van de Vusse's, not the same object
        return vandevusse_rhs(x, u)

    for rhs, method, want in (
            (vandevusse_rhs, "rk4", lambda: ode.vandevusse_rk4_tangent(
                x, u, dX, dU, vex.TS, 2)),
            (vandevusse_rhs, "tr_bdf2", lambda: ode.integrate_tangent(
                vandevusse_rhs, x, u, dX, dU, vex.TS, 2, "tr_bdf2")),
            (other, "rk4", lambda: ode.integrate_tangent(
                other, x, u, dX, dU, vex.TS, 2))):
        got = ode.rollout_tangent(rhs, x, u, dX, dU, vex.TS, 2, method)
        for a, b in zip(got, want()):
            assert torch.equal(a, b), (rhs, method)
