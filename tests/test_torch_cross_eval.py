"""The port's tuning-outcome cross-evaluation against the JAX package's at
float64 on the CPU: the artifact tables, the committed artifacts as each
package reads them, the frame conversion, both tuner objectives at the
reference's and the repo's tuned points on the three linear problems (each
built by its own package with the reference's L/R, the steps cut; Van de
Vusse in tests/test_torch_cross_eval_nmpc.py), and the Shell3x3 row with
its horizon checks.

F_vns, Jnu, gamma and the GAM SSE are held at 1e-8 relative, F's
closed-loop parts j21 and j22 at 1e-8 of F_vns: a part can be small beside
the objective it adds to, and then its own relative error grows (Van de
Vusse's reference point: j21 1.1e-8 relative; Shell7x5's repo point: j22
1.5e-8).  Shell7x5's GAM SSE, and gamma read off it, are held at 1e-7
relative, as tests/test_torch_band.py holds the band GAM SSE: band du is
ill-posed on degenerate steps, and at the repo point one output's SSE,
the one gamma takes, parts by 3.5e-8 relative."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tuning_tpu.cases import cross_eval as ce_jax
from mpc_tuning_tpu.cases import shell3x3 as s3_jax
from mpc_tuning_tpu.cases import shell7x5 as s7_jax
from mpc_tuning_tpu.cases import vandevusse as vdv_jax
from mpc_tuning_tpu.tuning.api import build_problem as build_jax
from mpc_tuning_tpu_torch.cases import cross_eval as ce_torch

torch.set_num_threads(1)  # B <= 3: threads only contend with other workers

LINEAR = ["Shell3x3", "Shell3x3_caso2", "Shell7x5"]
# the steps each problem is cut to: the linear cases' first setpoint and
# disturbance changes; Van de Vusse's Cb step at step 9 (its plain NMPC
# loop on the CPU costs seconds a step)
NIT = {"Shell3x3": 60, "Shell3x3_caso2": 60, "Shell7x5": 60,
       "VanDeVusse_NMPC": 12}
REL = 1e-8
REL_BAND_SSE = 1e-7
KEYS = ("F_vns", "j21", "j22", "Jnu", "gam_sse", "gamma")


def assert_objectives_match(out, out_j, where="", band=False):
    """F_vns, Jnu, gamma and the GAM SSE at REL relative (a band case's
    GAM SSE and gamma at REL_BAND_SSE); j21 and j22 at REL of F_vns."""
    for k in KEYS:
        assert np.isfinite(out[k]).all(), (where, k)
        lim = REL_BAND_SSE if band and k in ("gam_sse", "gamma") else REL
        if k in ("j21", "j22"):
            err = abs(out[k] - out_j[k]) / abs(out_j["F_vns"])
        else:
            err = _rel(out[k], out_j[k])
        assert err <= lim, (where, k, out[k], out_j[k], err)


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def _same_point(a, b):
    assert a.N == b.N
    for k in ("Nu", "delta", "lam", "L", "R"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None and y is None) or np.array_equal(x, y), k


def test_tables_equal_jax():
    assert ce_torch.REF_TUNED.keys() == ce_jax.REF_TUNED.keys()
    for name, point in ce_torch.REF_TUNED.items():
        _same_point(point, ce_jax.REF_TUNED[name])
    assert ce_torch.REPO_TUNED_REFSCALE == ce_jax.REPO_TUNED_REFSCALE
    assert ce_torch.REPO_TUNED == ce_jax.REPO_TUNED


def _artifacts():
    return sorted({(name, path) for table in (ce_jax.REPO_TUNED_REFSCALE,
                                              ce_jax.REPO_TUNED)
                   for name, path in table.items()})


@pytest.mark.parametrize("name,path", _artifacts())
def test_load_repo_point_and_convert_weights(name, path, monkeypatch):
    """Each committed artifact reads alike (the port's from any working
    directory: its paths are taken from the repository root) and converts
    into the reference's frame alike."""
    jax_point = ce_jax.load_repo_point(str(ce_torch.REPO_ROOT / path))
    monkeypatch.chdir("/")
    point = ce_torch.load_repo_point(path)
    _same_point(point, jax_point)
    ref = ce_jax.REF_TUNED[name]
    n_mv = len(ref.lam)
    for a, b in zip(ce_torch.convert_weights(point, ref.L, ref.R, n_mv),
                    ce_jax.convert_weights(jax_point, ref.L, ref.R, n_mv)):
        assert np.array_equal(a, b)


def _jax_problem(name, nit):
    ref = ce_jax.REF_TUNED[name]
    if name == "VanDeVusse_NMPC":
        return vdv_jax.build_problem(vdv_jax.make_case(nit=nit))
    if name == "Shell7x5":
        case = s7_jax.make_case(nit=nit)
    else:
        case = s3_jax.make_case(caso=1 if name == "Shell3x3" else 2, nit=nit)
    problem, _ = build_jax(case, dtype=jnp.float64, L=np.diag(ref.L),
                           R=np.diag(ref.R))
    if name == "Shell7x5":
        problem.qp_iters = 60
    return problem


def _points(name):
    ref = ce_jax.REF_TUNED[name]
    repo = ce_jax.load_repo_point(
        str(ce_torch.REPO_ROOT / ce_jax.REPO_TUNED_REFSCALE[name]))
    return {"ref": (ref.N, ref.Nu, ref.delta, ref.lam),
            "repo": (repo.N, repo.Nu, repo.delta, repo.lam)}


def eval_point_both(name, point):
    """eval_point of ``point`` ('ref' or 'repo') on case ``name``, each
    package's problem at NIT[name] steps, held as assert_objectives_match
    says."""
    args = _points(name)[point]
    ref = ce_torch.REF_TUNED[name]
    problem, _ = ce_torch._problem(name, ref, "cpu", NIT[name])
    with torch.inference_mode():  # as cross_eval_case evaluates
        out = ce_torch.eval_point(problem, *args)
    out_j = ce_jax.eval_point(_jax_problem(name, NIT[name]), *args)
    for k in ("N", "Nu", "delta", "lambda"):
        assert out[k] == out_j[k], k
    assert_objectives_match(out, out_j, f"{name} {point}",
                            band=name == "Shell7x5")


@pytest.mark.parametrize("point", ["ref", "repo"])
@pytest.mark.parametrize("name", LINEAR)
def test_eval_point_matches_jax(name, point):
    eval_point_both(name, point)


def test_cross_eval_case_shell3x3_matches_jax(monkeypatch):
    """The Shell3x3 row at nit 120: both points' objectives at 1e-8
    relative, the frame, and both horizon checks (closed leg 'pdip')."""
    nit = 120
    monkeypatch.setattr(s3_jax, "make_case",
                        functools.partial(s3_jax.make_case, nit=nit))
    row_j = ce_jax.cross_eval_case("Shell3x3")
    row = ce_torch.cross_eval_case("Shell3x3", device="cpu", nit=nit)
    assert row.keys() == row_j.keys()
    assert "repo" in row and row["repo_frame"] == row_j["repo_frame"]
    assert row["repo_better_vns"] == row_j["repo_better_vns"]
    for point in ("ref", "repo"):
        assert_objectives_match(row[point], row_j[point], point)
    for k in ("horizon_check", "horizon_check_ref"):
        np.testing.assert_allclose(row[k]["mismatch"], row_j[k]["mismatch"],
                                   rtol=0, atol=1e-8)
        assert row[k]["ok"] == row_j[k]["ok"]
