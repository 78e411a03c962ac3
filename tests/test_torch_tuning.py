"""The port's tuner against the JAX package at float64: the GAM and VNS
objectives, a seeded small hybrid tune (the slice as a whole), and tuning
state written by one package and resumed by the other."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tuning_tpu.cases import woodberry as wb_jax
from mpc_tuning_tpu.tuning import api as api_jax
from mpc_tuning_tpu.tuning import objectives as obj_jax
from mpc_tuning_tpu_torch.cases import woodberry as wb_torch
from mpc_tuning_tpu_torch.tuning import api as api_torch
from mpc_tuning_tpu_torch.tuning import objectives as obj_torch

# batches of B <= 8: intra-op threads only contend with the other test
# workers (a 30x slowdown of the tune under pytest-xdist)
torch.set_num_threads(1)

NIT = 60
CASE_KW = dict(nit=NIT, nbp=4, nbc=3)
TUNE_KW = dict(gam_popsize=4, gam_generations=2, max_alternations=1, seed=3,
               verbose=False, joint_polish=False)
QP_ITERS = 10


def _problems():
    pj, _ = api_jax.build_problem(wb_jax.make_case(**CASE_KW),
                                  dtype=jnp.float64, qp_iters=QP_ITERS)
    pt, _ = api_torch.build_problem(wb_torch.make_case(**CASE_KW),
                                    dtype=torch.float64, qp_iters=QP_ITERS,
                                    device="cpu")
    return pj, pt


@pytest.fixture(scope="module")
def wb():
    return _problems()


def test_gam_sse_batch_matches_jax(wb):
    pj, pt = wb
    X = np.random.default_rng(0).uniform(0.05, 2.0, size=(4, 4))
    Sj = obj_jax.gam_sse_batch(pj, 12, 3, X)
    St = obj_torch.gam_sse_batch(pt, 12, 3, X)
    np.testing.assert_allclose(St, Sj, rtol=1e-9)


@pytest.mark.parametrize("explicit_admm", [False, True])
def test_vns_objective_matches_jax(wb, explicit_admm):
    pj, pt = wb
    if explicit_admm:
        pj.vns_qp_method, pt.vns_qp_method = "admm_sim_fused@128", "admm_sim"
    try:
        N_b = np.array([15, 12, 9, 7])
        Nu_b = np.array([2, 3, 4, 6])
        delta, lam = np.array([1.2, 0.7]), np.array([0.15, 0.08])
        Fj, pj_parts = obj_jax.vns_objective_batch(pj, N_b, Nu_b, delta, lam,
                                                   return_parts=True)
        Ft, pt_parts = obj_torch.vns_objective_batch(pt, N_b, Nu_b, delta, lam,
                                                     return_parts=True)
    finally:
        pj.vns_qp_method = pt.vns_qp_method = "auto"
    np.testing.assert_allclose(Ft, Fj, rtol=1e-9)
    for k in ("j21", "j22", "Jnu"):
        np.testing.assert_allclose(pt_parts[k], pj_parts[k], rtol=1e-9,
                                   atol=1e-12, err_msg=k)


@pytest.fixture(scope="module")
def tuned(wb, tmp_path_factory):
    pj, pt = wb
    d = tmp_path_factory.mktemp("states")
    x0 = np.array([1.0, 1.0, 0.1, 0.1])
    out = {}
    for tag, api, prob in (("jax", api_jax, pj), ("torch", api_torch, pt)):
        path = str(d / f"{tag}_state.json")
        out[tag] = (api.hybrid_tune(prob, 4, 3, x0.copy(), state_path=path,
                                    **TUNE_KW), path)
    return out


def test_hybrid_tune_slice_matches_jax(tuned):
    (bj, dj, lj, Fj, Gj, hj), _ = tuned["jax"]
    (bt, dt, lt, Ft, Gt, ht), _ = tuned["torch"]
    assert int(bt["N"]) == int(bj["N"])
    assert np.array_equal(np.asarray(bt["Nu"]), np.asarray(bj["Nu"]))
    np.testing.assert_allclose(dt, dj, rtol=1e-8)
    np.testing.assert_allclose(lt, lj, rtol=1e-8)
    np.testing.assert_allclose(Ft, Fj, rtol=1e-8)
    np.testing.assert_allclose(Gt, Gj, rtol=1e-8)
    assert len(ht) == len(hj)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_tuning_state_reads_the_same_in_both(wb, tuned, writer, reader):
    """A state file written by one package resumes in the other: the run
    had already finished its alternations, so the resumed tune returns
    the stored incumbents unchanged."""
    (_, _, _, _, Fvf_w, _), path = tuned[writer]
    with open(path) as fh:
        state = json.load(fh)
    prob = dict(jax=wb[0], torch=wb[1])[reader]
    api = dict(jax=api_jax, torch=api_torch)[reader]
    best, delta, lam, _, Fvf, hist = api.hybrid_tune(
        prob, 4, 3, np.ones(4), gam_popsize=4, gam_generations=2,
        max_alternations=1, verbose=False, final_polish=False,
        joint_polish=False, state_path=path, resume=True)
    assert int(best["N"]) == state["best"]["N"]
    assert np.array_equal(np.asarray(best["Nu"]), state["best"]["Nu"])
    np.testing.assert_array_equal(delta, np.asarray(state["delta"]))
    np.testing.assert_array_equal(lam, np.asarray(state["lam"]))
    assert Fvf == Fvf_w == state["Fvf"]
    assert hist == state["history"]


def test_joint_weight_polish_matches_jax(wb):
    """The Chebyshev knee polish at fixed horizons, with a small budget."""
    pj, pt = wb
    pool = [np.array([1.0, 1.0, 0.1, 0.1]), np.array([0.5, 2.0, 0.3, 0.05])]
    kw = dict(popsize=3, generations=1, global_samples=2, verbose=False)
    xj, Fj, gj = api_jax._joint_weight_polish(pj, 12, 3, pool, **kw)
    xt, Ft, gt = api_torch._joint_weight_polish(pt, 12, 3, pool, **kw)
    np.testing.assert_allclose(xt, xj, rtol=1e-8)
    np.testing.assert_allclose([Ft, gt], [Fj, gj], rtol=1e-8)
