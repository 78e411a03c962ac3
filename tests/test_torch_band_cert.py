"""The port's band certificate (``ops/band_cert.py``) against the JAX
package's at float64 on the CPU, and the port of the JAX oracle's
``test_band_lp_certified_every_step`` through the port's '+lp20+split12'
chain (the plain band loop's solve), at the JAX test's gates and depth
(nit 80: the MD entry at step 20 and the band-active phase).

Tolerances: the harvested QPs are built by the same host recursion from
the same trajectory, so they agree to rounding (1e-12).  The LP minimum
comes from the same HiGHS call on QPs equal to rounding (1e-9); du_sens is
a difference of two 200-iteration interior-point solves, each an
ill-conditioned solve on the degenerate steps, so it is held at 1e-9
relative to max(1, du_sens) and the well-posed split (du_sens < 1e-4) must
agree."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tuning_tpu.cases import shell7x5 as s7_jax
from mpc_tuning_tpu.cases.cross_eval import REF_TUNED as JAX_TUNED
from mpc_tuning_tpu.ops import band_cert as cert_jax
from mpc_tuning_tpu.tuning import api as api_jax
from mpc_tuning_tpu_torch.cases import shell7x5 as s7_torch
from mpc_tuning_tpu_torch.ops import band_cert as cert_torch
from mpc_tuning_tpu_torch.ops import kernels
from mpc_tuning_tpu_torch.sim.mpc_loop import BAND_LP_ITERS, BAND_S2_ITERS
from mpc_tuning_tpu_torch.tuning import api as api_torch

torch.set_num_threads(1)  # B = 1: threads only contend with other workers

F64 = torch.float64
REF = s7_torch.REF_TUNED
LR = dict(L=np.diag(REF.L), R=np.diag(REF.R))
NIT = 80
CAPS = (REF.N, int(REF.Nu.max()))  # the tuned point's own bucket: exact
PARITY_STEPS = (5, 25, 40)  # MD entry at 20; the band phase after it


@pytest.fixture(scope="module")
def loop_run():
    """The port's problem in the tuned point's frame and the plain band
    loop's run at that point (B = 1, CPU): U (nit, nu) and E (nit,)."""
    pt, _ = api_torch.build_problem(s7_torch.make_case(nit=NIT), dtype=F64,
                                    qp_iters=60, device="cpu", **LR)
    t, lc, Hp, r_l, dims = pt.loop.sim_inputs(
        pt.r[None, :NIT], pt.v, [REF.N], [int(REF.Nu.max())],
        REF.delta[None], REF.lam[None], NIT, F64, "band_sim", "cpu")
    _, U, E = kernels.closed_sim_band_plain(t, lc, Hp, r_l, NIT,
                                            BAND_LP_ITERS, BAND_S2_ITERS, dims)
    return pt, U[:, :, 0].numpy(), E[:, 0].numpy()


@pytest.fixture(scope="module")
def certified(loop_run):
    """The plain run's QPs on the tuned point's bucket, harvested along its
    U, and their certificates."""
    pt, u, _ = loop_run
    qps, c, cand = cert_torch.harvest_qps(pt, REF.N, int(REF.Nu.max()),
                                          REF.delta, REF.lam, u, NIT,
                                          caps=CAPS)
    return qps, c, cand, cert_torch.certify_steps(c, cand, qps,
                                                  pt.loop.dims["nu"])


def test_tuned_point_matches_jax():
    ref = JAX_TUNED["Shell7x5"]
    assert REF.N == ref.N
    for k in ("Nu", "delta", "lam", "L", "R"):
        assert np.array_equal(getattr(REF, k), getattr(ref, k)), k


def test_harvest_and_certify_match_jax(loop_run):
    """Both packages harvest the QPs along the same U at full capacity and
    certify a pre-MD and two band-phase steps alike."""
    pt, u, _ = loop_run
    pj, _ = api_jax.build_problem(s7_jax.make_case(nit=NIT),
                                  dtype=jnp.float64, qp_iters=60, **LR)
    nit = max(PARITY_STEPS) + 1
    args = (REF.N, int(REF.Nu.max()), REF.delta, REF.lam, u[:nit], nit)
    qj, cj, candj = cert_jax.harvest_qps(pj, *args)
    qt, ct, candt = cert_torch.harvest_qps(pt, *args)
    assert len(qt) == len(qj) == nit
    for (ft, ht), (fj, hj) in zip(qt, qj):
        np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-12)
        np.testing.assert_allclose(ht, hj, rtol=0, atol=1e-12)
    for k in ("H", "rmask", "cmask_z", "H_lp", "f_lp"):
        np.testing.assert_allclose(candt[k], np.asarray(candj[k]), rtol=0,
                                   atol=1e-12, err_msg=k)
    np.testing.assert_allclose(ct["G0"], np.asarray(cj["G0"]), rtol=0,
                               atol=1e-12)
    nu = pt.loop.dims["nu"]
    for k in PARITY_STEPS:
        zt, et, st = cert_torch.certify(ct, candt, *qt[k], nu)
        zj, ej, sj = cert_jax.certify(cj, candj, *qj[k], nu)
        assert abs(et - ej) <= 1e-9, (k, et, ej)
        assert abs(st - sj) <= 1e-9 * max(1.0, sj), (k, st, sj)
        assert (st < 1e-4) == (sj < 1e-4), (k, st, sj)
        if sj < 1e-4:
            np.testing.assert_allclose(zt[:nu], zj[:nu], rtol=0, atol=1e-9)


def test_capped_certificate_matches_full(loop_run):
    """The tuned point's own bucket gives the full-capacity certificate
    (its masked rows and columns are dropped exactly)."""
    pt, u, _ = loop_run
    nu = pt.loop.dims["nu"]
    args = (REF.N, int(REF.Nu.max()), REF.delta, REF.lam, u[:26], 26)
    full = cert_torch.harvest_qps(pt, *args)
    capped = cert_torch.harvest_qps(pt, *args, caps=CAPS)
    for k in (5, 25):
        zf, ef, sf = cert_torch.certify(full[1], full[2], *full[0][k], nu)
        zc, ec, sc = cert_torch.certify(capped[1], capped[2], *capped[0][k],
                                        nu)
        assert abs(ef - ec) <= 1e-9 * (1.0 + abs(ef)), (k, ef, ec)
        if sf < 1e-4:
            np.testing.assert_allclose(zc[:nu], zf[:nu], rtol=0, atol=1e-8)


def test_band_lp_certified_every_step(loop_run, certified):
    """Along the plain band loop's own trajectory, the port's
    '+lp20+split12' chain pins the ECR slack to the exact LP minimum on
    every step (1e-6 relative), reproduces the certified du where du is
    well-posed (1e-3) and is objective-optimal on the degenerate steps
    (1e-6): the gates of the JAX oracle test, on the tuned point's bucket."""
    pt = loop_run[0]
    qps, c, cand, certs = certified
    out = cert_torch.engine_step_errors(pt, qps, c, cand, BAND_LP_ITERS,
                                        BAND_S2_ITERS, certs=certs)
    assert out["n_steps"] == NIT
    assert out["n_eps_pos"] > 20, out
    assert out["deps_rel"] < 1e-6, out
    assert out["du_well_posed"] < 1e-3, out
    assert out["dobj_ill_posed"] < 1e-6, out


def test_plain_loop_holds_the_step_gates(loop_run, certified):
    """chip_smoke.py's per-step hold of the band kernel (``hold``), on the
    plain loop's own run: its frozen slack E, inverted through the split
    margin, and its first moves against the certificates of the QPs
    harvested along its U."""
    _, u, E = loop_run
    _, c, _, certs = certified
    out = cert_torch.hold_certified(c, certs, u, E)
    assert out["steps"] == NIT and out["uncertified"] == 0, out
    assert out["eps_pos"] > 20 and out["well_posed"] > 0, out
    assert out["ok"], out


def test_kernel_slack_inverts_the_split():
    """kernel_slack undoes split_stage2's margin: the frozen slack of a
    stage-0 point with no residual violation gives back its slack."""
    from mpc_tuning_tpu_torch.ops.qp import split_stage2

    G0 = torch.tensor([[1.0, 0.0], [0.0, -1.0]], dtype=F64)
    rm = torch.ones((2, 1), dtype=F64)
    cm = torch.ones((2, 1), dtype=F64)
    for eps in (0.0, 1e-7, 0.25, 33.4):
        z1 = torch.tensor([[0.1], [eps]], dtype=F64)
        h = torch.tensor([[0.5], [0.0]], dtype=F64)
        ehat = split_stage2(z1, G0, rm, cm, h)[3]
        np.testing.assert_allclose(cert_torch.kernel_slack(ehat.numpy()),
                                   eps, rtol=1e-15, atol=1e-17)
