"""The port's bench (``mpc_tuning_tpu_torch/bench.py``) against the root
``bench.py`` and the JAX package on the CPU at float64: the rows' draws
are ``bench.py``'s (its own row functions run with their engine calls
recorded), the FLOP models are its models, each row's Y and U through the
plain path equal the JAX package's same call on the same inputs, ``main``
prints one line with ``bench.py``'s metric names, and a row whose hold is
fed a perturbed output raises.  Sizes: B <= 8, nit <= 60."""

import dataclasses
import importlib.util
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tuning_tpu.cases import shell7x5 as s7_jax
from mpc_tuning_tpu.cases import vandevusse as vdv_jax
from mpc_tuning_tpu.cases import woodberry as wb_jax
from mpc_tuning_tpu.cases.cross_eval import REF_TUNED
from mpc_tuning_tpu.models import plants as plants_jax
from mpc_tuning_tpu.ops import condmin as cm_jax
from mpc_tuning_tpu.sim import gpc_loop as gpc_jax
from mpc_tuning_tpu.sim import mpc_loop as mpc_jax
from mpc_tuning_tpu.sim import nmpc_loop as nmpc_jax
from mpc_tuning_tpu.tuning import api as api_jax
from mpc_tuning_tpu_torch import bench
from mpc_tuning_tpu_torch.cases import vandevusse as vdv_torch
from mpc_tuning_tpu_torch.cases import woodberry as wb_torch
from mpc_tuning_tpu_torch.sim.mpc_loop import BAND_LP_ITERS, BAND_S2_ITERS
from mpc_tuning_tpu_torch.tuning import api as api_torch

torch.set_num_threads(1)  # B <= 8: threads only contend with other workers

F64 = torch.float64
ROOT = pathlib.Path(__file__).resolve().parents[1]
# the NMPC rows' case cut as tests/test_torch_nmpc.py cuts it (nbp 4: the
# bench's N up to 11 fits its p_max 15)
VDV_KW = dict(nit=12, nbp=4, nbc=2, substeps=2, sqp_iters=2, qp_iters=10)
JAX_BAND = f"pdip_ws_lanes+lp{BAND_LP_ITERS}+split{BAND_S2_ITERS}"
# each path's tolerance against the JAX package, as the port's test of
# that path holds it: the whole-sim tracking loops 1e-10
# (tests/test_torch_sim.py), the band free run 1e-8 at nit 25
# (tests/test_torch_band.py), the NMPC closed batch 1e-8
# (tests/test_torch_nmpc.py), DTC-GPC 1e-10 (tests/test_torch_dtc_loop.py)
TOL = dict(wb=1e-10, gam=1e-10, band=1e-8, vdv=1e-8, dtc=1e-10)


@pytest.fixture(scope="module")
def root_bench():
    """The root bench.py, loaded from its path."""
    spec = importlib.util.spec_from_file_location("root_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------- draws


def _record(monkeypatch, owner, name, out):
    """Replace ``owner.name`` by a recorder of its arguments returning
    ``out(*args)``; returns the list of recorded calls."""
    calls = []

    def rec(*args, **kwargs):
        calls.append((args, kwargs))
        return out(*args, **kwargs)

    monkeypatch.setattr(owner, name, rec)
    return calls


def _zeros(B, nit, k):
    return jnp.zeros((B, nit, k))


def test_wb_draws_are_bench_py_draws(root_bench, monkeypatch):
    """bench_wb (bench.py:102-119) on the headline's and the GAM row's
    candidates: N, Nu, delta, lambda and the bucket."""
    pj, _ = api_jax.build_problem(wb_jax.make_case(nit=60),
                                  dtype=jnp.float64)
    B = 8
    calls = _record(monkeypatch, mpc_jax.MPCLoop, "closed_batch",
                    lambda self, r_b, *a, **k: (_zeros(B, 60, 2),) * 2)
    monkeypatch.setattr(root_bench, "NIT", 60)
    for kw in ({}, dict(N_fix=20, Nu_fix=4)):
        calls.clear()
        root_bench.bench_wb(pj, B, "admm_sim_fused", 40, jnp.float64, **kw)
        (_, r_b, v, N, Nu, delta, lam, *_), k = calls[-1]
        ours = bench.wb_draws(B, **kw)
        for a, b in zip(ours, (N, Nu, delta, lam)):
            np.testing.assert_array_equal(a, np.asarray(b))
        caps = mpc_jax.horizon_caps(127, 15, N, Nu)
        assert tuple(k["caps"]) == caps == ((32, 4) if kw else (64, 8))


def test_band_draws_are_bench_py_draws(root_bench, monkeypatch):
    """bench_shell7x5 (bench.py:160-177): N, Nu, lambda, the reference's
    delta."""
    calls = _record(monkeypatch, mpc_jax, "closed_loop_batch",
                    lambda c, r_b, *a: (_zeros(4, 200, 7),) * 2)
    root_bench.bench_shell7x5(4, 60, jnp.float64)
    _, _, _, N, Nu, delta, lam, *_ = calls[-1][0]
    ours = bench.band_draws(4, REF_TUNED["Shell7x5"].delta)
    for a, b in zip(ours, (N, Nu, delta, lam)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_vdv_draws_are_bench_py_draws(root_bench, monkeypatch):
    """bench_vdv (bench.py:223-230): N, Nu and the reference's weights."""
    calls = _record(monkeypatch, nmpc_jax.NMPCLoop, "closed_batch",
                    lambda self, r_b, *a: (_zeros(4, 60, 2),) * 2)
    root_bench.bench_vdv(4, jnp.float64)
    _, r_b, v, N, Nu, delta, lam, *_ = calls[-1][0]
    for a, b in zip(bench.vdv_draws(4), (N, Nu, delta, lam)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_dtc_signals_are_bench_py_signals(root_bench, monkeypatch):
    """bench_dtc_gpc (bench.py:253-266): the setpoint steps and the
    disturbance."""
    calls = _record(monkeypatch, gpc_jax.DTCGPC, "simulate_scan_batch",
                    lambda self, r_b, q_b, nit, **k: (_zeros(3, nit, 2),) * 2)
    root_bench.bench_dtc_gpc(3, jnp.float64)
    _, r_b, q_b, nit = calls[-1][0]
    r, q = bench.dtc_signals(nit)
    np.testing.assert_array_equal(np.asarray(r_b), np.broadcast_to(
        r, (3, nit, 2)))
    np.testing.assert_array_equal(np.asarray(q_b), np.broadcast_to(
        q, (3, nit, 1)))


@pytest.mark.parametrize("model", ["pdip", "admm"])
@pytest.mark.parametrize("caps,with_y", [((64, 8), False), ((32, 4), False),
                                         ((48, 4), True)])
def test_flop_models_are_bench_py_models(root_bench, caps, with_y, model):
    """The FLOP models at the headline's (64, 8), the GAM row's (32, 4) and
    the band row's (48, 4) dims."""
    ny, nu = (7, 3) if with_y else (2, 2)
    d = dict(p_max=caps[0], m_max=caps[1], ny=ny, nu=nu, with_y=with_y)
    ours = getattr(bench, f"flops_per_sim_{model}")(d, 15, 400)
    theirs = getattr(root_bench, f"_flops_per_sim_{model}")(d, 15, 400)
    assert ours == theirs


# ------------------------------------------------- rows against JAX


@pytest.fixture(scope="module")
def captured():
    """Each row run at float64 on the CPU (B <= 8, one timed run), before
    its hold: {row: (the hold's arguments, the row)}."""
    mp = pytest.MonkeyPatch()
    small = vdv_torch.make_case(**VDV_KW)
    mp.setattr(vdv_torch, "make_case", lambda *a, **k: small)
    try:
        pt, _ = api_torch.build_problem(wb_torch.make_case(nit=60),
                                        dtype=F64, device="cpu")
        rows = {"dtc": bench.dtc_row(3, 60, F64, "cpu", reps=1),
                "wb": bench.wb_row(pt, 4, "admm_sim", 40, F64, 60,
                                   device="cpu", reps=1)[0],
                "gam": bench.wb_row(pt, 4, "pdip_sim", 15, F64, 60,
                                    N_fix=20, Nu_fix=4, device="cpu",
                                    reps=1)[0],
                "band": bench.band_row(2, nit=25, device="cpu", reps=1),
                "vdv": bench.vdv_row(2, dtype=F64, device="cpu", reps=1)}
    finally:
        mp.undo()
    return {k: (row["held"][1], row) for k, row in rows.items()}


def _jax_tracking(args, qp_method):
    loop, _, iters, _, r_b, v, N, Nu, delta, lam, nit, caps, *_ = args
    pj, _ = api_jax.build_problem(wb_jax.make_case(nit=60),
                                  dtype=jnp.float64)
    return pj.loop.closed_batch(r_b, pj.v, N, Nu, delta, lam, nit,
                                jnp.float64, iters, qp_method=qp_method,
                                caps=caps)


def _jax_band(args):
    _, r_b, v, N, Nu, delta, lam, nit, caps, *_ = args
    ref = REF_TUNED["Shell7x5"]
    pj, _ = api_jax.build_problem(s7_jax.make_case(), dtype=jnp.float64,
                                  L=np.diag(ref.L), R=np.diag(ref.R))
    return pj.loop.closed_batch(r_b, pj.v, N, Nu, delta, lam, nit,
                                jnp.float64, 60, qp_method=JAX_BAND,
                                caps=caps)


def _jax_vdv(args):
    _, r_b, N, Nu, delta, lam, nit, _, caps, *_ = args
    loop = nmpc_jax.NMPCLoop(spec=vdv_jax.make_case(**VDV_KW).spec)
    return loop.closed_batch(jnp.asarray(r_b), None, N, Nu,
                             np.asarray(delta), np.asarray(lam), nit,
                             jnp.float64, VDV_KW["qp_iters"], caps=caps)


def _jax_dtc(args):
    _, r_b, q_b, nit, *_ = args
    plant = plants_jax.wood_berry()
    L, R, _ = cm_jax.condmin(plant.G.dcgain())
    ctl = gpc_jax.DTCGPC.build(
        plant=plant.G, model=plant.G, Ts=1.0, p=np.array([3, 3]),
        m=np.array([3, 3]), delta=np.array([1.0, 1.0]),
        lam=np.array([1.0, 1.0]), L=L, R=R, n_md=1, disturbance=plant.D)
    return ctl.simulate_scan_batch(np.asarray(r_b), np.asarray(q_b), nit)


JAX_CALLS = {
    "wb": lambda a: _jax_tracking(a, "admm_sim_fused@128"),
    "gam": lambda a: _jax_tracking(a, "pdip_sim_fused@128"),
    "band": _jax_band, "vdv": _jax_vdv, "dtc": _jax_dtc}
# where each hold takes the row's (Y, U)
YU_AT = {"wb": 12, "gam": 12, "band": 9, "vdv": 9, "dtc": 4}


@pytest.mark.parametrize("row", sorted(JAX_CALLS))
def test_row_matches_jax(captured, row):
    """Each row's Y and U (the plain path at float64) against the JAX
    package's same call on the row's inputs, at that path's tolerance."""
    args, out = captured[row]
    Y, U = args[YU_AT[row]:YU_AT[row] + 2]
    Yj, Uj = JAX_CALLS[row](args)
    np.testing.assert_allclose(Y.numpy(), np.asarray(Yj), rtol=0,
                               atol=TOL[row])
    np.testing.assert_allclose(U.numpy(), np.asarray(Uj), rtol=0,
                               atol=TOL[row])
    assert np.isfinite(out["value"])


# --------------------------------------------------------------- main


def test_main_prints_bench_py_metric_names(monkeypatch, capsys):
    """``main(["--cpu", ...])``: one JSON line with bench.py's headline and
    every one of its extra_metrics, each a number, no error entry, each
    row held."""
    small = vdv_torch.make_case(**VDV_KW)
    monkeypatch.setattr(vdv_torch, "make_case", lambda *a, **k: small)
    monkeypatch.setattr(bench, "NIT", 12)
    monkeypatch.setattr(bench, "REPS", 1)
    bench.main(["--cpu", "--batch", "8", "--tune-budget", "2,1,1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "wb_constrained_closedloop_tuning_sims_per_s"
    assert np.isfinite(line["value"]) and line["unit"] == "sims/s"
    detail = line["detail"]
    assert detail["device"] == "cpu" and detail["qp_method"] == "admm_sim"
    assert np.isfinite(detail["qp_p50_latency_us"])
    assert not {"vs_baseline", "qp_p50_includes_dispatch_rtt"} & (
        set(detail) | set(line))
    names = [m["metric"] for m in detail["extra_metrics"]]
    assert names == ["dtc_gpc_closedloop_sims_per_s",
                     "wb_gam_pdip_fused_sims_per_s",
                     "shell7x5_band_closedloop_sims_per_s",
                     "vdv_nmpc_sims_per_s", "wb_hybrid_tune_wall_s"]
    for m in detail["extra_metrics"]:
        assert "error" not in m and np.isfinite(m["value"]), m
        assert m["held"], m


def test_main_needs_the_card_without_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([])


# ------------------------------------------------------------- holds


def _moved(x, by):
    y = x.clone()
    y[0, -1] += by
    return y


@pytest.mark.parametrize("row", ["wb", "gam", "band", "vdv", "dtc"])
def test_hold_refuses_a_moved_output(captured, row):
    """Each row's hold passes the row's own output and raises HoldFailed
    when the first lane's last U is moved by 0.2 (scaled units for the
    NMPC loop: times sf_u)."""
    args = list(captured[row][0])
    hold = {"wb": bench.hold_tracking, "gam": bench.hold_tracking,
            "band": bench.hold_band, "vdv": bench.hold_vdv,
            "dtc": bench.hold_dtc}[row]
    at = YU_AT[row] + 1
    assert isinstance(hold(*args), str)
    by = 0.2
    if row == "vdv":
        by *= float(np.max(args[0].spec.sf_u))
    args[at] = _moved(args[at], by)
    with pytest.raises(bench.HoldFailed):
        hold(*args)


def test_hold_refuses_an_invalid_tune():
    """The tune row's hold refuses a result with N not above its Nu."""
    res = dataclasses.make_dataclass("R", ["N", "Nu", "delta", "lam", "Fvns",
                                           "Fgam"])(
        3, np.array([3, 2]), np.ones(2), np.ones(2), 1.0, 1.0)
    with pytest.raises(bench.HoldFailed, match="invalid"):
        bench.hold_tune(None, res, 15, "cpu")


def test_qp_hold_refuses_a_moved_solution():
    """The single QP's hold passes the row's own solve and refuses its z
    moved by 1e-3."""
    pt, _ = api_torch.build_problem(wb_torch.make_case(nit=60),
                                    dtype=F64, device="cpu")
    row = bench.qp_p50_row(pt, dict(pt.loop.capped(64, 8).dims), F64, "cpu")
    hold, (z, args, iters) = row["held"]
    with pytest.raises(bench.HoldFailed):
        hold(z + 1e-3, args, iters)
    bench.run_holds([row])
    assert np.isfinite(row["value"]) and row["launches"] == {}
    assert "z vs plain" in row["held"]
