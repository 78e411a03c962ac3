"""The port's Van de Vusse NMPC case against the JAX package at float64 on
the CPU: the case set-up and a seeded small hybrid tune."""

import numpy as np
import pytest
import torch

from mpc_tuning_tpu.cases import vandevusse as vdv_jax
from mpc_tuning_tpu.tuning import api as api_jax
from mpc_tuning_tpu.tuning.objectives import vns_objective_batch as vns_jax
from mpc_tuning_tpu_torch.cases import vandevusse as vdv_torch
from mpc_tuning_tpu_torch.tuning import api as api_torch
from mpc_tuning_tpu_torch.tuning.objectives import vns_objective_batch

torch.set_num_threads(1)  # B <= 14: threads only contend with other workers

CASE_KW = dict(nit=12, nbp=3, nbc=2, substeps=2, sqp_iters=2, qp_iters=10)


def test_make_case_matches_jax():
    """x0 (Newton on the steady state) within 1e-12; the setpoints and
    Yref, built from x0, within 1e-12 and exact where x0 does not enter;
    every other spec field exact."""
    cj, ct = vdv_jax.make_case(), vdv_torch.make_case()
    np.testing.assert_allclose(ct.x0, np.asarray(cj.x0), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ct.r, cj.r, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ct.Yref, np.asarray(cj.Yref), rtol=0,
                               atol=1e-12)
    assert np.array_equal(ct.r[9:, 0], cj.r[9:, 0])
    assert np.array_equal(ct.r[40:, 1], cj.r[40:, 1])
    for name in ("nx", "ny", "nu", "xc", "Ts", "p_max", "m_max", "umin",
                 "umax", "ymin", "ymax", "sf_u", "sf_y", "u0", "rho_eps",
                 "substeps", "sqp_iters", "qp_iters", "integrator"):
        a, b = getattr(ct.spec, name), getattr(cj.spec, name)
        assert np.array_equal(np.asarray(a), np.asarray(b)), name
    assert (ct.nit, ct.nbp, ct.nbc) == (cj.nit, cj.nbp, cj.nbc)
    assert np.array_equal(ct.w, cj.w)


@pytest.fixture(scope="module")
def problems():
    pj = vdv_jax.build_problem(vdv_jax.make_case(**CASE_KW))
    pt = vdv_torch.build_problem(vdv_torch.make_case(**CASE_KW),
                                 device="cpu")
    return pj, pt


def test_nonlinear_vns_objective_matches_jax(problems):
    """The nonlinear selector protocol: each output's lane keeps the case
    setpoints of that output only."""
    pj, pt = problems
    assert not pt.linear and pt.square
    N, Nu = np.array([7, 5, 6]), np.array([2, 3, 2])
    d, l = np.array([0.8, 1.2]), np.array([0.1, 0.2])
    Fj, parts_j = vns_jax(pj, N, Nu, d, l, return_parts=True)
    Ft, parts_t = vns_objective_batch(pt, N, Nu, d, l, return_parts=True)
    np.testing.assert_allclose(Ft, Fj, rtol=1e-8)
    for k in parts_j:
        np.testing.assert_allclose(parts_t[k], parts_j[k], rtol=1e-8)


def test_hybrid_tune_matches_jax(problems):
    """A seeded small hybrid tune (no joint polish) returns JAX's (N, Nu),
    with delta, lambda and F within 1e-8."""
    pj, pt = problems
    x0 = vdv_torch.X0_WEIGHTS
    kw = dict(gam_popsize=4, gam_generations=2, max_alternations=1, seed=0,
              verbose=False, joint_polish=False)
    bj, dj, lj, Fj, Gj, _ = api_jax.hybrid_tune(pj, 3, 2, x0.copy(), **kw)
    bt, dt, lt, Ft, Gt, _ = api_torch.hybrid_tune(pt, 3, 2, x0.copy(), **kw)
    assert int(bt["N"]) == int(bj["N"])
    assert np.array_equal(np.asarray(bt["Nu"]), np.asarray(bj["Nu"]))
    np.testing.assert_allclose(dt, dj, rtol=1e-8)
    np.testing.assert_allclose(lt, lj, rtol=1e-8)
    np.testing.assert_allclose([Ft, Gt], [Fj, Gj], rtol=1e-8)


def test_build_problem_dtype_and_device():
    case = vdv_torch.make_case(**CASE_KW)
    p = vdv_torch.build_problem(case, dtype=torch.float32, device="cpu")
    assert p.dtype == torch.float32 and p.qp_iters == 10
    assert (p.my, p.nu) == (2, 2)
    assert p._caps([7], [3]) == (7, 3)


def test_linear_flag_follows_the_loop():
    """``linear`` is read off the loop: False for an NMPCLoop (the
    nonlinear selector protocol), True for an MPCLoop; it is not a
    constructor argument, so it cannot disagree with the loop."""
    from mpc_tuning_tpu_torch.cases import woodberry
    from mpc_tuning_tpu_torch.tuning.objectives import TuningProblem

    case = vdv_torch.make_case(**CASE_KW)
    assert not vdv_torch.build_problem(case, device="cpu").linear
    wb, _ = api_torch.build_problem(woodberry.make_case(nit=20),
                                    device="cpu")
    assert wb.linear
    with pytest.raises(TypeError):
        TuningProblem(loop=wb.loop, r=wb.r, v=wb.v, Yref=wb.Yref,
                      nit=wb.nit, w=wb.w, band_mask=wb.band_mask,
                      dmin=wb.dmin, nbp=wb.nbp, nbc=wb.nbc, device="cpu",
                      linear=False)
