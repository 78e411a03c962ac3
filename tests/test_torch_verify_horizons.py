"""The port's open-vs-closed horizon check (``cases/verify_horizons``) and
the cases' ``run`` against the JAX package at float64 on the CPU: the
per-output selector protocol (Wood-Berry at a fixed tuned point), the
band pulse protocol (Shell7x5 at the reference's tuned point, the JAX
package called with the split band engine the port runs), and one
Wood-Berry ``run`` (tune, final simulation, check) at a tiny budget."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tuning_tpu.cases import shell3x3 as s3_jax
from mpc_tuning_tpu.cases import shell7x5 as s7_jax
from mpc_tuning_tpu.cases import woodberry as wb_jax
from mpc_tuning_tpu.cases.verify_horizons import \
    verify_horizons as verify_jax
from mpc_tuning_tpu.tuning import api as api_jax
from mpc_tuning_tpu_torch.cases import shell3x3 as s3_torch
from mpc_tuning_tpu_torch.cases import shell7x5 as s7_torch
from mpc_tuning_tpu_torch.cases import woodberry as wb_torch
from mpc_tuning_tpu_torch.cases.verify_horizons import (HorizonCheck,
                                                        verify_horizons)
from mpc_tuning_tpu_torch.sim.mpc_loop import BAND_LP_ITERS, BAND_S2_ITERS
from mpc_tuning_tpu_torch.tuning import api as api_torch

torch.set_num_threads(1)  # B = 1: threads only contend with other workers

F64 = torch.float64
FIELDS = ("y_closed", "y_open", "u_closed", "u_open", "mismatch")
# Wood-Berry's tuned point of the port's float32 tune on the card (PERF.md)
WB_TUNED = (7, 3, np.array([0.263334, 0.670454]),
            np.array([0.097199, 0.05639]))
# the tuned points of the card's tunes that the check reads ok False at
# (chip_smoke.py phase 3f; scripts/horizons_vs_jax.py runs the band one):
# (JAX case, port case, make_case keywords, N, Nu, delta, lambda)
TUNED_POINTS = {
    "woodberry": (wb_jax, wb_torch, {}, *WB_TUNED),
    "shell3x3": (s3_jax, s3_torch, dict(nit=250), 8, 2,
                 np.array([2.358838, 0.426045, 0.810902]),
                 np.array([0.066399, 0.246926, 0.085728])),
}
JAX_BAND = f"pdip_ws_lanes+lp{BAND_LP_ITERS}+split{BAND_S2_ITERS}"
BAND_NIT = 25  # the band free run's horizon in tests/test_torch_band.py


def _both(mod_j, mod_t, **kw):
    case_kw = dict(nit=kw.pop("nit"))
    pj, info = api_jax.build_problem(mod_j.make_case(**case_kw),
                                     dtype=jnp.float64, **kw)
    pt, _ = api_torch.build_problem(mod_t.make_case(**case_kw), dtype=F64,
                                    device="cpu", **kw)
    return pj, pt, info[0]


def _assert_fields(ct, cj, **tol):
    for k in FIELDS:
        np.testing.assert_allclose(getattr(ct, k), getattr(cj, k), rtol=0,
                                   err_msg=k, **tol)


def test_selector_protocol_matches_jax():
    """Square case: one closed loop and one open leg per output, 1e-8."""
    pj, pt, L = _both(wb_jax, wb_torch, nit=60, qp_iters=15)
    N, Nu, delta, lam = WB_TUNED
    cj = verify_jax(pj.loop, L, N, Nu, delta, lam)
    ct = verify_horizons(pt.loop, L, N, Nu, delta, lam, device="cpu")
    assert ct.y_closed.shape == (2, N + 30)
    _assert_fields(ct, cj, atol=1e-8)
    assert ct.ok == cj.ok and ct.as_json() == cj.as_json()


@pytest.mark.parametrize("name", sorted(TUNED_POINTS))
def test_tuned_points_read_as_jax(name):
    """At the tuned points of the card's Wood-Berry (phase 3) and Shell3x3
    (phase 3c) tunes the check reads ok False, and so does the JAX
    package's: the same mismatch (1e-10) and legs (1e-8) at float64.  The
    closed leg is the cold PDIP of the JAX package's default; the warm
    'pdip_sim' it ran before read Shell3x3's mismatch 1.1406 against
    JAX's 1.1436."""
    mod_j, mod_t, case_kw, N, Nu, delta, lam = TUNED_POINTS[name]
    pj, info = api_jax.build_problem(mod_j.make_case(**case_kw),
                                     dtype=jnp.float64)
    pt, _ = api_torch.build_problem(mod_t.make_case(**case_kw), dtype=F64,
                                    device="cpu")
    args = (info[0], N, Nu, delta, lam)
    cj = verify_jax(pj.loop, *args)
    ct = verify_horizons(pt.loop, *args, device="cpu")
    _assert_fields(ct, cj, atol=1e-8)
    np.testing.assert_allclose(ct.mismatch, cj.mismatch, rtol=0, atol=1e-10)
    assert not ct.ok and not cj.ok


@pytest.fixture(scope="module")
def band():
    ref = s7_torch.REF_TUNED
    LR = dict(L=np.diag(ref.L), R=np.diag(ref.R))
    pj, pt, L = _both(s7_jax, s7_torch, nit=80, qp_iters=60, **LR)
    args = (L, int(ref.N), int(ref.Nu.max()), ref.delta, ref.lam)
    return pj, pt, args


def test_pulse_protocol_matches_jax_split_band_engine(band):
    """Band case, the pulse protocol with the measured disturbance held at
    its final value, BAND_NIT steps: the closed leg ('band_sim') at the
    band free run's 1e-8 and the open leg (the cold slack LP, then stage
    2) at the band open leg's 1e-9 (tests/test_torch_band.py), against the
    JAX package's '+lp20+split12' engine and split open leg."""
    pj, pt, args = band
    kw = dict(nit=BAND_NIT, v_const=pt.v[-1])
    cj = verify_jax(pj.loop, *args, qp_method=JAX_BAND, **kw)
    ct = verify_horizons(pt.loop, *args, device="cpu", **kw)
    assert ct.y_closed.shape == (7, BAND_NIT)
    for k, tol in (("y_closed", 1e-8), ("u_closed", 1e-8), ("y_open", 1e-9),
                   ("u_open", 1e-9)):
        np.testing.assert_allclose(getattr(ct, k), getattr(cj, k), rtol=0,
                                   atol=tol, err_msg=k)
    np.testing.assert_allclose(ct.mismatch, cj.mismatch, rtol=1e-6)
    assert ct.ok == cj.ok


def test_band_check_runs_only_the_split_engine(band):
    """A band loop's closed leg refuses the tracking engines (the joint
    PDIP stalls on band steps), as every band loop of the port does."""
    _, pt, args = band
    with pytest.raises(ValueError, match="band_sim"):
        verify_horizons(pt.loop, *args, nit=5, engine="pdip_sim",
                        device="cpu")


def test_horizon_check_ok_and_json():
    m = np.array([0.05, 0.19999])
    chk = HorizonCheck(*(np.zeros((2, 3)),) * 4, mismatch=m)
    assert chk.ok and chk.as_json() == {"mismatch": [0.05, 0.2], "ok": True}
    chk.mismatch = np.array([0.05, 0.2])
    assert not chk.ok


def test_check_defaults_to_the_card():
    """The check's default device is the card: on a host without one it
    raises, unless device='cpu' is passed."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    pt, _ = api_torch.build_problem(wb_torch.make_case(nit=40), dtype=F64,
                                    qp_iters=10, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        verify_horizons(pt.loop, np.eye(2), 5, 2, np.ones(2), np.ones(2))


def test_woodberry_run_matches_jax(monkeypatch):
    """tune -> final simulation -> horizon check, at a tiny budget (nit
    60, nbp/nbc 4/3, popsize 4, 2 generations, 1 alternation, qp_iters
    15, a joint polish of 2 global samples and one generation of 3): the
    tuned result, the final simulation and the check against the JAX
    package's ``run`` at 1e-8.  (At qp_iters 10 the final simulations
    part by ~4e-6: the JAX package simulates with the cold PDIP, the port
    with the warm one.)  The objectives read N and the largest Nu only, so
    per-input Nu vectors of one largest Nu tie and VNS, which accepts a
    strict improvement only, keeps whichever it met first: here the JAX
    package [3, 3], the port [3, 2], one F.  Everything after the tune
    runs at the largest Nu."""
    for mod in (wb_jax, wb_torch):
        monkeypatch.setattr(mod, "make_case", functools.partial(
            mod.make_case, nbp=4, nbc=3))
    for api in (api_jax, api_torch):
        monkeypatch.setattr(api, "_joint_weight_polish", functools.partial(
            api._joint_weight_polish, popsize=3, generations=1,
            global_samples=2))
    kw = dict(nit=60, qp_iters=15, gam_popsize=4, gam_generations=2,
              max_alternations=1, seed=3, checkpoint_dir=None, verbose=False)
    _, rj, (yj, uj), cj = wb_jax.run(dtype=jnp.float64, **kw)
    case, rt, (yt, ut), ct = wb_torch.run(dtype=F64, device="cpu", **kw)
    assert case.nbp == 4 and rt.problem.device == "cpu"
    assert rt.N == rj.N and np.max(rt.Nu) == np.max(rj.Nu)
    np.testing.assert_allclose([rt.Fvns, rt.Fgam], [rj.Fvns, rj.Fgam],
                               rtol=1e-8)
    np.testing.assert_allclose(rt.delta, rj.delta, rtol=1e-8)
    np.testing.assert_allclose(rt.lam, rj.lam, rtol=1e-8)
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-8)
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-8)
    _assert_fields(ct, cj, atol=1e-8)
