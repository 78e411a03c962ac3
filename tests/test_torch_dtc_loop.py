"""The port's DTC-GPC closed loop (``sim/gpc_loop.py``) against the JAX
package at float64 on the CPU: the checks of the JAX package's
``tests/test_dtc_loop.py`` run on the port (the recursion against the
O(nit^2) replay oracle, batch against single, the predictor warning, the
Wood-Berry tracking), the recursion against the JAX package's scan at
1e-10, and the port's step loop on the JAX package's own constants at
1e-12 (configuration of DTC-GPC/DTC_GPC_WW.m:17-125)."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tuning_tpu.models import plants as plants_jax
from mpc_tuning_tpu.ops import condmin as cm_jax
from mpc_tuning_tpu.sim.gpc_loop import DTCGPC as DTCGPC_jax
from mpc_tuning_tpu_torch import convert
from mpc_tuning_tpu_torch.models import plants
from mpc_tuning_tpu_torch.models.lti import tf, tfm
from mpc_tuning_tpu_torch.ops import condmin as cm
from mpc_tuning_tpu_torch.sim.gpc_loop import DTCGPC, SCAN_KEYS, scan_loop

torch.set_num_threads(1)  # B <= 8: threads only contend with other workers

F64 = torch.float64
WB = dict(Ts=1.0, p=np.array([3, 3]), m=np.array([3, 3]),
          delta=np.array([1.0, 1.0]), lam=np.array([1.0, 1.0]), n_md=1)


def _build(pl, condmin, cls):
    plant = pl.wood_berry()
    L, R, _ = condmin.condmin(plant.G.dcgain())
    return cls.build(plant=plant.G, model=plant.G, L=L, R=R,
                     disturbance=plant.D, **WB)


@pytest.fixture(scope="module")
def wb_controller():
    return _build(plants, cm, DTCGPC)


@pytest.fixture(scope="module")
def wb_jax():
    return _build(plants_jax, cm_jax, DTCGPC_jax)


def _signals(nit=200):
    r = np.zeros((nit, 2))
    r[10:, 0] = 0.8
    r[60:, 1] = 0.5
    q = np.zeros((nit, 1))
    q[140:, 0] = -0.25
    return r, q


def _scenarios(nit, B=3):
    r_b = np.zeros((B, nit, 2))
    q_b = np.zeros((B, nit, 1))
    for b in range(B):
        r_b[b, 5 + 10 * b:, 0] = 0.5 + 0.2 * b
        r_b[b, 40:, 1] = 0.3
        q_b[b, 60:, 0] = -0.1 * b
    return r_b, q_b


def test_scan_matches_reference_replay(wb_controller):
    nit = 120
    r, q = _signals(nit)
    y_ref, u_ref = wb_controller.simulate_ref(r, q, nit)
    y_scan, u_scan = wb_controller.simulate_scan(r, q, nit, device="cpu")
    np.testing.assert_allclose(y_scan, y_ref, atol=1e-8)
    np.testing.assert_allclose(u_scan, u_ref, atol=1e-8)


def test_scan_batch_matches_single(wb_controller):
    """The batched scenario sweep (one lane per (r, q) profile) equals
    per-scenario single runs."""
    ctl = wb_controller
    nit = 80
    r_b, q_b = _scenarios(nit)
    Yb, Ub = ctl.simulate_scan_batch(r_b, q_b, nit, device="cpu")
    assert Yb.shape == (3, nit, 2) and Ub.shape == (3, nit, 2)
    for b in range(3):
        y1, u1 = ctl.simulate_scan(r_b[b], q_b[b], nit, device="cpu")
        assert np.abs(Yb[b].numpy() - y1).max() < 1e-12
        assert np.abs(Ub[b].numpy() - u1).max() < 1e-12


def test_predictor_validation_flags_unstable_model():
    """An unstable model pole surfaces as a predictor-stability warning at
    build time; the nominal Wood-Berry build does not warn."""
    G_bad = tfm([
        [tf([1.0], [-5.0, 1.0], 1.0), tf([0.5], [8.0, 1.0], 1.0)],
        [tf([0.4], [6.0, 1.0], 1.0), tf([1.2], [7.0, 1.0], 1.0)],
    ])
    kw = dict(Ts=1.0, p=np.array([3, 3]), m=np.array([3, 3]),
              delta=np.array([1.0, 1.0]), lam=np.array([1.0, 1.0]),
              L=np.eye(2), R=np.eye(2))
    with pytest.warns(UserWarning, match="unstable"):
        DTCGPC.build(plant=G_bad, model=G_bad, **kw)
    plant = plants.wood_berry()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        DTCGPC.build(plant=plant.G, model=plant.G, n_md=1,
                     disturbance=plant.D, **kw)


def test_wood_berry_tracking_and_disturbance_rejection(wb_controller):
    nit = 200
    r, q = _signals(nit)
    y, u = wb_controller.simulate_scan(r, q, nit, device="cpu")
    np.testing.assert_allclose(y[135], [0.8, 0.5], atol=5e-3)
    np.testing.assert_allclose(y[-1], [0.8, 0.5], atol=2e-2)
    assert np.all(np.abs(u) < 2.0)
    assert np.all(np.abs(u[-1] - u[-5]) < 1e-3)


def test_scan_constants_match_jax(wb_controller, wb_jax):
    ct = wb_controller.scan_constants(device="cpu")
    cj = wb_jax.scan_constants(jnp.float64)
    assert tuple(ct) == SCAN_KEYS == tuple(cj)
    for k in SCAN_KEYS:
        np.testing.assert_allclose(ct[k].numpy(), np.asarray(cj[k]), rtol=0,
                                   atol=1e-12, err_msg=k)
    assert wb_controller.yd_width == wb_jax.yd_width


def test_simulate_scan_matches_jax(wb_controller, wb_jax):
    nit = 120
    r, q = _signals(nit)
    yt, ut = wb_controller.simulate_scan(r, q, nit, device="cpu")
    yj, uj = wb_jax.simulate_scan(r, q, nit)
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-10)
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-10)


def test_simulate_scan_batch_matches_jax(wb_controller, wb_jax):
    nit = 80
    r_b, q_b = _scenarios(nit, B=5)
    Yt, Ut = wb_controller.simulate_scan_batch(r_b, q_b, nit, device="cpu")
    Yj, Uj = wb_jax.simulate_scan_batch(r_b, q_b, nit)
    np.testing.assert_allclose(Yt.numpy(), np.asarray(Yj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj), rtol=0, atol=1e-10)


def test_step_loop_on_jax_constants(wb_jax):
    """The port's step loop driven by the JAX package's own constants
    (``convert.dtc_constants_from_numpy``) reproduces the JAX scan at
    1e-12."""
    nit = 120
    r, q = _signals(nit)
    cj = {k: np.asarray(v) for k, v in wb_jax.scan_constants().items()}
    c = convert.dtc_constants_from_numpy(cj, device="cpu")
    Y, U = scan_loop(c, torch.as_tensor(r)[None], torch.as_tensor(q)[None],
                     wb_jax.yd_width)
    yj, uj = wb_jax.simulate_scan(r, q, nit)
    np.testing.assert_allclose(Y[0].numpy(), yj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(U[0].numpy(), uj, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="missing"):
        convert.dtc_constants_from_numpy({"A_pl": cj["A_pl"]}, device="cpu")


def test_lanes_do_not_depend_on_the_batch(wb_controller):
    """One scenario in every lane of batches of 1, 8 and 37 reads the same
    bits in every lane (the mat-vecs run lane by lane in one order)."""
    nit = 60
    r, q = _signals(nit)
    out = {}
    for B in (1, 8, 37):
        Y, U = wb_controller.simulate_scan_batch(
            np.broadcast_to(r, (B, nit, 2)), np.broadcast_to(q, (B, nit, 1)),
            nit, device="cpu")
        out[B] = (Y, U)
    for B, (Y, U) in out.items():
        for x, x1 in ((Y, out[1][0]), (U, out[1][1])):
            assert torch.equal(x, x1.expand_as(x)), B


def test_entry_points_default_to_the_card(wb_controller):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    r, q = _signals(10)
    for call in (lambda: wb_controller.simulate_scan(r, q, 10),
                 lambda: wb_controller.simulate_scan_batch(r[None], q[None],
                                                           10),
                 lambda: wb_controller.scan_constants(),
                 lambda: convert.dtc_constants_from_numpy({})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
