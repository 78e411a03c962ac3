"""The port's Shell3x3 tracking case against the JAX package at float64 on
the CPU: the case and its controller arrays (exact), a seeded small hybrid
tune through the per-step engines, and ``final_simulation`` of both ported
tracking cases."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tuning_tpu.cases import shell3x3 as s3_jax
from mpc_tuning_tpu.cases import woodberry as wb_jax
from mpc_tuning_tpu.cases.cross_eval import REF_TUNED
from mpc_tuning_tpu.tuning import api as api_jax
from mpc_tuning_tpu_torch import convert
from mpc_tuning_tpu_torch.cases import shell3x3 as s3_torch
from mpc_tuning_tpu_torch.cases import woodberry as wb_torch
from mpc_tuning_tpu_torch.tuning import api as api_torch

torch.set_num_threads(1)  # B <= 8: threads only contend with other workers

CASES = {"WoodBerry": (wb_jax, wb_torch), "Shell3x3": (s3_jax, s3_torch)}
# tuned points: WB's from the port's float32 tune on the card (PERF.md),
# Shell3x3's the reference's (BASELINE.md)
TUNED = {"WoodBerry": (7, np.array([3, 3]), np.array([0.263334, 0.670454]),
                       np.array([0.097199, 0.05639])),
         "Shell3x3": (REF_TUNED["Shell3x3"].N, REF_TUNED["Shell3x3"].Nu,
                      REF_TUNED["Shell3x3"].delta, REF_TUNED["Shell3x3"].lam)}


def _result(api, problem, info, name):
    N, Nu, delta, lam = TUNED[name]
    L, R, Ru, Rv, S, cond_before = info
    return api.TuningResult(N=N, Nu=Nu, delta=delta, lam=lam, L=L, R=R, Ru=Ru,
                            Rv=Rv, Fvns=0.0, Fgam=0.0, cond_before=cond_before,
                            cond_after=S, problem=problem, checkpoint=None,
                            history=[])


@pytest.mark.parametrize("name,qp_iters", [("WoodBerry", 15),
                                           ("Shell3x3", 30)])
def test_final_simulation_runs_at_float64_as_jax(name, qp_iters):
    """After a float32 tune the final simulation still runs at float64, as
    the JAX package's does (its MPCLoop.simulate defaults to float64).  The
    JAX package simulates with the cold PDIP, the port with the warm one;
    at Shell3x3's default budget of 30 iterations both reach the same
    answer (at 15 they differ by 1.6e-9)."""
    mod_j, mod_t = CASES[name]
    nit = 120
    case_j, case_t = mod_j.make_case(nit=nit), mod_t.make_case(nit=nit)
    pj, info_j = api_jax.build_problem(case_j, dtype=jnp.float32,
                                       qp_iters=qp_iters)
    pt, info_t = api_torch.build_problem(case_t, dtype=torch.float32,
                                         qp_iters=qp_iters, device="cpu")
    yj, uj = mod_j.final_simulation(case_j, _result(api_jax, pj, info_j, name))
    yt, ut = mod_t.final_simulation(case_t, _result(api_torch, pt, info_t,
                                                    name))
    assert yt.dtype == np.float64 and ut.dtype == np.float64
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-10)
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-10)


# ------------------------------------------------- the case, set up exactly

CTL_FIELDS = ("A", "Bu", "Bv", "C", "Dv", "M", "Sx", "Sstep", "Sv", "Theta",
              "Tcum", "umin_s", "umax_s", "dumin_s", "dumax_s", "ymin_s",
              "ymax_s")


@pytest.fixture(scope="module")
def problems():
    pj, info_j = api_jax.build_problem(s3_jax.make_case(), dtype=jnp.float64)
    pt, info_t = api_torch.build_problem(s3_torch.make_case(),
                                         dtype=torch.float64, device="cpu")
    return pj, info_j, pt, info_t


def test_shell3x3_problem_exact(problems):
    pj, info_j, pt, info_t = problems
    for a, b in zip(info_j, info_t):  # L, R, Ru, Rv, S, cond_before
        assert np.array_equal(np.asarray(a), np.asarray(b))
    for name in ("r", "v", "Yref", "w", "band_mask", "dmin"):
        assert np.array_equal(getattr(pj, name), getattr(pt, name)), name
    for field in CTL_FIELDS:
        assert np.array_equal(getattr(pj.loop.ctl, field),
                              getattr(pt.loop.ctl, field)), field
    assert (pt.loop.dims["p_max"], pt.loop.dims["m_max"]) == (127, 15)


@pytest.mark.parametrize("caps", [None, (32, 4)])
def test_shell3x3_arrays_from_numpy_exact(problems, caps):
    """The JAX package's controller arrays carried across by
    ``convert.arrays_from_numpy`` equal the port's own, full and capped."""
    pj, _, pt, _ = problems
    lj, lt = pj.loop, pt.loop
    if caps is not None:
        lj, lt = lj.capped(*caps), lt.capped(*caps)
    cj = {k: np.asarray(v) for k, v in lj.arrays(jnp.float64).items()}
    conv = convert.arrays_from_numpy(cj, torch.float64, "cpu")
    own = lt.arrays(torch.float64, "cpu")
    assert conv.keys() == own.keys()
    for k in own:
        assert conv[k].dtype == own[k].dtype and torch.equal(conv[k], own[k]), k


# -------------------------------------- a small tune through the step engines

def test_hybrid_tune_through_step_engines_matches_jax():
    """A seeded small Shell3x3 hybrid tune with the engine pair the JAX
    package runs under a candidate mesh (GAM 'pdip_ws_fused', VNS
    'admm_fused') returns JAX's (N, Nu), weights and objectives."""
    case_kw = dict(nit=60, nbp=4, nbc=2)
    pj, _ = api_jax.build_problem(s3_jax.make_case(**case_kw),
                                  dtype=jnp.float64, qp_iters=10)
    pt, _ = api_torch.build_problem(s3_torch.make_case(**case_kw),
                                    dtype=torch.float64, qp_iters=10,
                                    device="cpu")
    pj.qp_method = pt.qp_method = "pdip_ws_fused"
    pj.vns_qp_method = pt.vns_qp_method = "admm_fused"
    x0 = np.array([1.0, 1.0, 1.0, 0.1, 0.1, 0.1])
    kw = dict(gam_popsize=4, gam_generations=2, max_alternations=1, seed=5,
              verbose=False, joint_polish=False)
    bj, dj, lj, Fj, Gj, _ = api_jax.hybrid_tune(pj, 4, 2, x0.copy(), **kw)
    bt, dt, lt, Ft, Gt, _ = api_torch.hybrid_tune(pt, 4, 2, x0.copy(), **kw)
    assert int(bt["N"]) == int(bj["N"])
    assert np.array_equal(np.asarray(bt["Nu"]), np.asarray(bj["Nu"]))
    np.testing.assert_allclose(dt, dj, rtol=1e-8)
    np.testing.assert_allclose(lt, lj, rtol=1e-8)
    np.testing.assert_allclose([Ft, Gt], [Fj, Gj], rtol=1e-8)
