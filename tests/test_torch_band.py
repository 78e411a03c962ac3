"""The port's band (Shell7x5) slice against the JAX package at float64 on
the CPU: the case, the band QP rows and the stage-0 LP fields, the band
open leg, the 'band_sim' closed loop (free-running and step by step), the
objectives, a seeded small hybrid tune, the engine policy and the band
kernel's envelope."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tuning_tpu.cases import shell7x5 as s7_jax
from mpc_tuning_tpu.cases.cross_eval import REF_TUNED
from mpc_tuning_tpu.ops import mpc_qp as mq_jax
from mpc_tuning_tpu.tuning import api as api_jax
from mpc_tuning_tpu.tuning import objectives as obj_jax
from mpc_tuning_tpu_torch import convert
from mpc_tuning_tpu_torch.cases import shell7x5 as s7_torch
from mpc_tuning_tpu_torch.cases import woodberry as wb_torch
from mpc_tuning_tpu_torch.ops import kernels
from mpc_tuning_tpu_torch.ops import mpc_qp as mq_torch
from mpc_tuning_tpu_torch.sim.mpc_loop import BAND_LP_ITERS, BAND_S2_ITERS
from mpc_tuning_tpu_torch.tuning import api as api_torch
from mpc_tuning_tpu_torch.tuning import objectives as obj_torch

torch.set_num_threads(1)  # B <= 8: threads only contend with other workers

F64 = torch.float64
REF = REF_TUNED["Shell7x5"]
LR = dict(L=np.diag(REF.L), R=np.diag(REF.R))
LOOP_NIT = 80  # covers the MD entry at k=20 and the band-active phase


@pytest.fixture(scope="module")
def band():
    """JAX and port problems of the full Shell7x5 case in the reference's
    conditioning frame, qp_iters 60 (the case's own budget)."""
    pj, _ = api_jax.build_problem(s7_jax.make_case(nit=LOOP_NIT),
                                  dtype=jnp.float64, qp_iters=60, **LR)
    pt, _ = api_torch.build_problem(s7_torch.make_case(nit=LOOP_NIT),
                                    dtype=F64, qp_iters=60, device="cpu",
                                    **LR)
    return pj, pt


def test_make_case_exact():
    cj, ct = s7_jax.make_case(), s7_torch.make_case()
    for name in ("Xsp", "Yref", "mdv", "w", "umin", "umax", "dumin", "dumax",
                 "ymin", "ymax", "v_ymin", "v_ymax", "ov_weight0",
                 "mvrate_weight0", "sf_u", "sf_y", "sf_v"):
        assert np.array_equal(getattr(cj, name), getattr(ct, name)), name
    for name in ("name", "n_mv", "n_md", "Ts", "nit", "rho_eps", "nbp", "nbc"):
        assert getattr(cj, name) == getattr(ct, name), name
    assert np.array_equal(cj.plant.dcgain(), ct.plant.dcgain())
    assert np.array_equal(cj.plant.iodelay, ct.plant.iodelay)


@pytest.mark.parametrize("caps", [(16, 2), (32, 4)])
def test_band_rows_and_lp_fields_match_jax(band, caps):
    """assemble_candidate and qp_step_data with the y rows: 1e-12."""
    pj, pt = band
    lj, lt = pj.loop.capped(*caps), pt.loop.capped(*caps)
    d = lj.dims
    assert d["with_y"]
    rng = np.random.default_rng(caps[0])
    B = 4
    N = rng.integers(caps[1] + 1, caps[0] + 1, size=B)
    Nu = rng.integers(1, caps[1] + 1, size=B)
    delta = np.zeros((B, 7))
    lam = np.exp(rng.uniform(np.log(1e-3), np.log(3.0), size=(B, 3)))
    stat = (d["p_max"], d["m_max"], d["ny"], d["nu"])
    cj = lj.arrays(jnp.float64)
    cand_j = jax.vmap(mq_jax.assemble_candidate,
                      in_axes=(None, 0, 0, 0, 0) + (None,) * 6)(
        cj, jnp.asarray(N), jnp.asarray(Nu), jnp.asarray(delta),
        jnp.asarray(lam), *stat, d["rho"], True)
    ct = lt.arrays(F64, "cpu")
    cand_t = mq_torch.assemble_candidate(
        ct, torch.as_tensor(N), torch.as_tensor(Nu), torch.as_tensor(delta),
        torch.as_tensor(lam), *stat, d["rho"], True)
    assert "admm" not in cand_t
    for k in ("H", "G", "H_lp", "f_lp", "rmask", "cmask_z", "row_mask"):
        np.testing.assert_allclose(cand_t[k].numpy(), np.asarray(cand_j[k]),
                                   rtol=0, atol=1e-12, err_msg=k)

    x_hat = rng.standard_normal((B, cj["A"].shape[0])) * 0.3
    u_prev = rng.uniform(-0.3, 0.3, size=(B, 3))
    r_s = np.zeros((B, 7))
    v_s = np.array([0.4, 0.6])
    f_j, h_j, _ = jax.vmap(
        lambda cand, x, u, r: mq_jax.qp_step_data(
            cj, cand, x, u, r, jnp.asarray(v_s), *stat, True))(
        cand_j, jnp.asarray(x_hat), jnp.asarray(u_prev), jnp.asarray(r_s))
    f_t, h_t, _ = mq_torch.qp_step_data(
        ct, cand_t, torch.as_tensor(x_hat), torch.as_tensor(u_prev),
        torch.as_tensor(r_s), torch.as_tensor(v_s), *stat, True)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0, atol=1e-12)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=0, atol=1e-12)


def test_band_open_leg_matches_jax(band):
    """Cold 20-iteration slack LP, then stage 2 at qp_iters: 1e-9 where du
    is well-posed.  Lane 1 (N 12, Nu 3) is a degenerate band QP: a 1e-12
    relative change of the frozen slack moves its U by 1.1e-7, and the two
    packages' slack LPs (batch-major vs lane-major sums) agree to ~4e-12
    relative, so its U is held to the band oracle's 1e-6 instead
    (tests/test_band_oracle.py; ops/band_cert.py on ill-posed du)."""
    pj, pt = band
    N, Nu = np.array([27, 12, 30, 9]), np.array([2, 3, 2, 4])
    delta = np.zeros((4, 7))
    lam = np.array([REF.lam, [0.5, 0.05, 0.2], [0.01, 1.0, 0.3],
                    [2.0, 0.2, 0.02]])
    rfin = np.zeros((4, 7))
    Yj, Uj = pj.loop.open_batch(rfin, pj.v, N, Nu, delta, lam, LOOP_NIT,
                                jnp.float64, 60, use_pallas=False,
                                qp_split=True, qp_lp=BAND_LP_ITERS)
    Yt, Ut = pt.loop.open_batch(rfin, pt.v, N, Nu, delta, lam, LOOP_NIT, F64,
                                60, device="cpu")
    well = [0, 2, 3]
    np.testing.assert_allclose(Yt.numpy()[well], np.asarray(Yj)[well], rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(Ut.numpy()[well], np.asarray(Uj)[well], rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(Ut.numpy()[1], np.asarray(Uj)[1], rtol=0,
                               atol=1e-6)


def test_band_degenerate_lane_is_ill_posed(band, monkeypatch):
    """The reason behind the open leg's two limits: a 1e-12 relative change
    of the frozen slack's margin moves the degenerate lane 1's U by more
    than 1e-8 and the other lanes' by less than 1e-9."""
    from mpc_tuning_tpu_torch.ops import qp

    _, pt = band
    N, Nu = np.array([27, 12, 30, 9]), np.array([2, 3, 2, 4])
    lam = np.array([REF.lam, [0.5, 0.05, 0.2], [0.01, 1.0, 0.3],
                    [2.0, 0.2, 0.02]])
    run = lambda: pt.loop.open_batch(np.zeros((4, 7)), pt.v, N, Nu,
                                     np.zeros((4, 7)), lam, LOOP_NIT, F64,
                                     60, device="cpu")[1].numpy()
    U0 = run()
    m_rel, m_abs = qp.split_margins(F64)
    monkeypatch.setattr(qp, "split_margins",
                        lambda dtype: (m_rel + 1e-12, m_abs))
    dU = np.abs(run() - U0).max(axis=(1, 2))
    assert dU[1] > 1e-8
    assert dU[[0, 2, 3]].max() < 1e-9


JAX_BAND = f"pdip_ws_lanes+lp{BAND_LP_ITERS}+split{BAND_S2_ITERS}"


def test_band_sim_free_run_matches_jax(band):
    """Free-running, NIT = 25, B = 2: 1e-8 (the band loop amplifies
    rounding ~100x per step once the +-0.005 bands act, so a longer free
    run cannot hold a tight limit)."""
    pj, pt = band
    nit, B = 25, 2
    r_b = np.broadcast_to(pj.r[:nit], (B, nit, 7))
    args = (r_b, pj.v, np.array([10, 14]), np.array([2, 2]), np.zeros((B, 7)),
            np.broadcast_to(REF.lam, (B, 3)).copy(), nit)
    Yj, Uj = pj.loop.closed_batch(*args, jnp.float64, 60, qp_method=JAX_BAND)
    Yt, Ut = pt.loop.closed_batch(*args, F64, 60, engine="band_sim",
                                  device="cpu")
    np.testing.assert_allclose(Yt.numpy(), np.asarray(Yj), rtol=0, atol=1e-8)
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj), rtol=0, atol=1e-8)


def test_band_sim_step_by_step_matches_jax(band):
    """NIT = 80 with the plain loop following JAX's U (``u_follow``): every
    step's own U within 1e-6 of JAX's, the band oracle's gate
    (tests/test_band_oracle.py)."""
    pj, pt = band
    B = 2
    N, Nu = np.array([int(REF.N), 20]), np.array([2, 3])
    lam = np.array([REF.lam, [0.3, 0.05, 1.0]])
    r_b = np.broadcast_to(pj.r[:LOOP_NIT], (B, LOOP_NIT, 7))
    args = (r_b, pj.v, N, Nu, np.zeros((B, 7)), lam, LOOP_NIT)
    _, Uj = pj.loop.closed_batch(*args, jnp.float64, 60, qp_method=JAX_BAND)
    t, lc, Hp, r_l, dims = pt.loop.sim_inputs(*args, F64, "band_sim", "cpu")
    u_follow = torch.tensor(np.asarray(Uj)).permute(1, 2, 0).contiguous()
    _, Ut, _ = kernels.closed_sim_band_plain(t, lc, Hp, r_l, LOOP_NIT,
                                          BAND_LP_ITERS, BAND_S2_ITERS, dims,
                                          u_follow=u_follow)
    np.testing.assert_allclose(Ut.numpy(), u_follow.numpy(), rtol=0, atol=1e-6)


def test_band_sim_capacity_bucketing_exact(band):
    """Masked band rows and columns are exact no-ops: a batch run at its
    bucket and at the full maxima agrees to 1e-12."""
    _, pt = band
    nit, B = 30, 2
    r_b = np.broadcast_to(pt.r[:nit], (B, nit, 7))
    args = (r_b, pt.v, np.array([9, 14]), np.array([2, 2]), np.zeros((B, 7)),
            np.broadcast_to(REF.lam, (B, 3)).copy(), nit, F64, 60)
    out = [pt.loop.closed_batch(*args, engine="band_sim", device="cpu",
                                caps=caps) for caps in ((16, 2), (32, 4))]
    for a, b in zip(*out):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def small():
    """Shell7x5 at nit 30, nbp/nbc 4/2 (p_max 15, m_max 3), own frame."""
    kw = dict(nit=30, nbp=4, nbc=2)
    pj, _ = api_jax.build_problem(s7_jax.make_case(**kw), dtype=jnp.float64,
                                  qp_iters=30)
    pt, _ = api_torch.build_problem(s7_torch.make_case(**kw), dtype=F64,
                                    qp_iters=30, device="cpu")
    return pj, pt


def test_band_objectives_match_jax(small):
    """GAM SSE and the non-square single-sim VNS objective F: rtol 1e-7.
    Its parts: rtol 1e-5, since candidate 1 (N 12, Nu 3) is a degenerate
    band QP whose free-running loop carries a 1e-12 slack difference into
    ~1e-6 of j22 (see test_band_open_leg_matches_jax)."""
    pj, pt = small
    X = np.concatenate([np.zeros((3, 7)),
                        np.array([[0.1, 0.1, 0.1], [0.5, 0.02, 1.2],
                                  [0.05, 0.3, 0.01]])], axis=1)
    np.testing.assert_allclose(obj_torch.gam_sse_batch(pt, 12, 2, X),
                               obj_jax.gam_sse_batch(pj, 12, 2, X),
                               rtol=1e-7, atol=1e-14)
    N_b, Nu_b = np.array([15, 12, 8, 5]), np.array([2, 3, 2, 3])
    lam = np.array([0.2, 0.05, 0.5])
    Fj, parts_j = obj_jax.vns_objective_batch(pj, N_b, Nu_b, np.zeros(7), lam,
                                              return_parts=True)
    Ft, parts_t = obj_torch.vns_objective_batch(pt, N_b, Nu_b, np.zeros(7),
                                                lam, return_parts=True)
    np.testing.assert_allclose(Ft, Fj, rtol=1e-7)
    for k in ("j21", "j22", "Jnu"):
        np.testing.assert_allclose(parts_t[k], parts_j[k], rtol=1e-5,
                                   atol=1e-12, err_msg=k)


def test_band_hybrid_tune_matches_jax(small):
    """A tiny seeded tune: JAX's (N, Nu), delta = 0, lambda and F within
    1e-6."""
    pj, pt = small
    x0 = np.concatenate([np.zeros(7), [0.1, 0.1, 0.1]])
    kw = dict(gam_popsize=4, gam_generations=2, max_alternations=1, seed=0,
              verbose=False, joint_polish=False)
    bj, dj, lj, Fj, Gj, _ = api_jax.hybrid_tune(pj, 4, 2, x0.copy(), **kw)
    bt, dt, lt, Ft, Gt, _ = api_torch.hybrid_tune(pt, 4, 2, x0.copy(), **kw)
    assert int(bt["N"]) == int(bj["N"])
    assert np.array_equal(np.asarray(bt["Nu"]), np.asarray(bj["Nu"]))
    assert np.array_equal(dt, np.zeros(7)) and np.array_equal(dj, np.zeros(7))
    np.testing.assert_allclose(lt, lj, rtol=1e-6)
    np.testing.assert_allclose([Ft, Gt], [Fj, Gj], rtol=1e-6)


@pytest.mark.parametrize("stage", ["gam", "vns"])
@pytest.mark.parametrize("f64", [False, True])
def test_band_policy(stage, f64):
    """Band cases resolve to 'band_sim' at every stage at float64 and raise
    at float32; tracking cases never resolve to it."""
    if f64:
        assert obj_torch.resolve_qp_method("auto", stage, f64,
                                           band=True) == "band_sim"
    else:
        with pytest.raises(ValueError, match="float64 only"):
            obj_torch.resolve_qp_method("auto", stage, f64, band=True)
    assert obj_torch.resolve_qp_method("auto", stage, f64) != "band_sim"


def test_band_float32_raises(small):
    """Float32 band loops leave the hard input bounds, so every band entry
    point refuses float32: the problem, the loop and the kernel wrapper."""
    _, pt = small
    with pytest.raises(ValueError, match="float64 only"):
        api_torch.build_problem(s7_torch.make_case(nit=30, nbp=4, nbc=2),
                                dtype=torch.float32, device="cpu")
    r_b = np.broadcast_to(pt.r, (1, 30, 7))
    args = (r_b, pt.v, [8], [2], np.zeros((1, 7)), np.full((1, 3), 0.1), 30,
            torch.float32)
    with pytest.raises(ValueError, match="float64 only"):
        pt.loop.closed_batch(*args, 30, engine="band_sim", device="cpu")
    with pytest.raises(ValueError, match="float64 only"):
        pt.loop.open_batch(np.zeros((1, 7)), *args[1:], 30, device="cpu")
    t, lc, Hp, r_l, dims = pt.loop.sim_inputs(*args[:7], F64, "band_sim",
                                              "cpu")
    f32 = lambda d: {k: v.float() for k, v in d.items()}
    with pytest.raises(ValueError, match="float64 only"):
        kernels.closed_sim_band(f32(t), f32(lc), Hp.float(), r_l.float(), 30,
                                BAND_LP_ITERS, BAND_S2_ITERS, dims)


@pytest.mark.parametrize("engine", ["admm_sim", "pdip_sim"])
def test_band_case_refuses_tracking_engines(small, engine):
    """The port's answer to the JAX package's band fallback that drops the
    split: no engine but 'band_sim' runs a band case, and 'band_sim' runs
    no tracking case."""
    _, pt = small
    pt.qp_method = engine
    try:
        with pytest.raises(ValueError, match="band"):
            obj_torch.gam_sse_batch(pt, 8, 2, np.full((2, 10), 0.1))
    finally:
        pt.qp_method = "auto"
    wb, _ = api_torch.build_problem(wb_torch.make_case(nit=20, nbp=4, nbc=2),
                                    device="cpu")
    with pytest.raises(ValueError, match="band"):
        wb.loop.closed_batch(np.zeros((1, 20, 2)), wb.v, [5], [2],
                             np.ones((1, 2)), np.ones((1, 2)), 20, F64, 5,
                             engine="band_sim", device="cpu")


def test_arrays_from_numpy_band_exact(band):
    pj, pt = band
    cj = {k: np.asarray(v) for k, v in pj.loop.arrays(jnp.float64).items()}
    conv = convert.arrays_from_numpy(cj, F64, "cpu")
    own = pt.loop.arrays(F64, "cpu")
    assert conv.keys() == own.keys()
    for k in own:
        assert torch.equal(conv[k], own[k]), k


def test_band_kernel_envelope(band):
    """The CUDA band kernel's envelope (ops/kernels.band_envelope): the
    Shell7x5 G0 at every bucket up to the full (127, 15) is inside; a
    one-sided band or n > BAND_MAX_N is outside and raises."""
    _, pt = band
    s = pt.loop.ctl.spec
    for caps in ((8, 2), (127, 2), (127, 15)):
        c = pt.loop.capped(*caps).arrays(F64, "cpu")
        n = caps[1] * 3 + 1
        dims = dict(n=n, mc=c["G0"].shape[0], nu=3, m_max=caps[1])
        assert n <= kernels.BAND_MAX_N
        assert kernels.band_envelope(c["G0"], dims, caps[0] * 7) == 12 * caps[1]
    G0 = c["G0"].clone()
    G0[12 * 15 + 2 * 127 * 7 - 1] = 0.0  # last y_lo row dropped: one-sided
    with pytest.raises(ValueError, match="one-sided"):
        kernels.band_envelope(G0, dims, 127 * 7)
    wide = dict(dims, n=kernels.BAND_MAX_N + 1)
    with pytest.raises(ValueError, match="at most"):
        kernels.band_envelope(c["G0"], wide, 127 * 7)
    assert s.has_y_constraints


def test_band_gate_limits():
    """tools/band_spread.band_gate: the live limits are twice the witness's
    lane quantiles plus the statistic's floor; a batch of 64 lanes or more
    is held at every lane quantile, a smaller one on its worst lane; Y on
    every lane; the frozen BAND_LIMITS are printed beside, not applied;
    a batch over its limits on a few lanes names them for the
    certificate."""
    from mpc_tuning_tpu_torch.tools import band_spread as bs

    def errs(B, **vals):
        out = {k: torch.zeros(B, dtype=F64) for k in ("y", "u", "u_step", "e")}
        for k, v in vals.items():
            out[k][:] = v
        return out

    floor = bs.BAND_FLOORS["u"]
    wit = errs(256, u=1e-4)
    at = 2 * 1e-4 + floor
    assert bs.band_gate(errs(256, u=at), wit, (32, 4))[0]
    assert not bs.band_gate(errs(256, u=1.01 * at), wit, (32, 4))[0]
    # every lane at 1e-5 beside a witness of 0 but on one lane: the median
    # lane fails a 256-lane batch; an 8-lane batch is held on its worst lane
    wit = errs(256)
    wit["u"][0] = 1.0
    assert not bs.band_gate(errs(256, u=1e-5), wit, (32, 4))[0]
    assert bs.band_gate(errs(8, u=1e-5), {k: v[:8] for k, v in wit.items()},
                        (32, 4))[0]
    assert not bs.band_gate(errs(256, y=2 * bs.BAND_Y_LIMIT), errs(256),
                            (32, 4))[0]
    ok, txt, over = bs.band_gate(errs(1), errs(1), (200, 2))
    assert ok and over == [] and "frozen none" in txt
    # limits missed on a few lanes: those lanes go to the certificate; on
    # more lanes, or on Y, the batch fails outright (over is None)
    few = errs(256, u=1e-5)
    few["u"][[3, 7]] = 1.0
    assert bs.band_gate(few, errs(256, u=1e-4), (32, 4))[2] == [3, 7]
    many = errs(256, u=1.0)
    assert bs.band_gate(many, errs(256, u=1e-4), (32, 4))[2] is None
    few["y"][3] = 2 * bs.BAND_Y_LIMIT
    assert bs.band_gate(few, errs(256, u=1e-4), (32, 4))[2] is None
    assert "frozen 0.0071" in bs.band_gate(errs(1), errs(1), (32, 4))[1]
