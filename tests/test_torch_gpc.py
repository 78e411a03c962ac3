"""The port's GPC machinery (``ops/gpc.py``, ``ops/filters.py``: host
NumPy over the port's ``models/{lti,poly}``): the checks of the JAX
package's ``tests/test_gpc.py`` (Diophantine identity, prediction
consistency, filter design, conditioning), run on the port, and its
matrices against the JAX package's at 1e-12."""

import numpy as np
import pytest

from mpc_tuning_tpu.models import plants as plants_jax
from mpc_tuning_tpu.ops import filters as flt_jax
from mpc_tuning_tpu.ops import gpc as gpc_jax
from mpc_tuning_tpu_torch.models import plants, simulate
from mpc_tuning_tpu_torch.ops import condmin as cm
from mpc_tuning_tpu_torch.ops import filters as flt
from mpc_tuning_tpu_torch.ops import gpc


def test_diophantine_identity():
    # 1 = E_j * (A Delta) + z^-j F_j must hold exactly for every j
    A = np.array([1.0, -1.2, 0.35])
    N, d = 6, 2
    E, F = gpc.diophantine(A, N, d)
    AD = np.convolve(A, [1.0, -1.0])
    for row in range(N):
        j = d + 1 + row
        lhs = np.convolve(E[row, :j], AD)
        total = np.zeros(max(len(lhs), j + F.shape[1]))
        total[: len(lhs)] += lhs
        total[j : j + F.shape[1]] += F[row]
        expect = np.zeros_like(total)
        expect[0] = 1.0
        np.testing.assert_allclose(total, expect, atol=1e-10)


def test_diophantine_first_order_closed_form():
    a = 0.9
    E, F = gpc.diophantine(np.array([1.0, -a]), 3, 0)
    # AD = [1, -(1+a), a]; f1 = [1+a, -a]
    np.testing.assert_allclose(F[0], [1 + a, -a], atol=1e-12)
    np.testing.assert_allclose(E[0], [1.0, 0, 0], atol=1e-12)


def _prediction_setup(p, m, round_decimals=4, pl=plants, g=gpc):
    Pnz = pl.wood_berry().G.c2d(1.0)  # integer delays [1 2;2 1]
    mats = g.build_gpc(Pnz, p, m, np.ones(2), np.ones(2), use_dtc=True,
                       round_decimals=round_decimals)
    return Pnz, Pnz.fast_model(), mats


def test_free_plus_forced_matches_rollout():
    """With an exact model and predictor == fast-model output, yf + H dU
    must equal the fast model's actual future trajectory
    (round_decimals=12: the reference's 4-decimal pole rounding off, so
    the identity is exact)."""
    rng = np.random.default_rng(3)
    p, m = np.array([5, 5]), np.array([3, 3])
    _, fast, mats = _prediction_setup(p, m, round_decimals=12)
    fast_ss = fast.to_ss()
    K = 40
    dU = rng.standard_normal((K, 2)) * 0.1
    u = np.cumsum(dU, axis=0)
    y_hist = simulate.dlsim(fast_ss, u)
    k = 25
    duM = mats.duM
    up = np.zeros(int(duM.sum()))  # newest first per input
    off = 0
    for j in range(2):
        for lag in range(int(duM[j])):
            up[off + lag] = dU[k - 1 - lag, j]
        off += int(duM[j])
    Yd = np.zeros(int(np.sum(mats.na + 1)))
    pos = 0
    for i in range(2):
        for lag in range(int(mats.na[i]) + 1):
            Yd[pos] = y_hist[k - lag, i]
            pos += 1
    dU_fut = np.zeros((int(p[0]), 2))
    dU_fut[: int(m[0])] = rng.standard_normal((int(m[0]), 2)) * 0.1
    z = np.concatenate([dU_fut[: int(m[0]), 0], dU_fut[: int(m[1]), 1]])
    y_pred = mats.Hp @ up + mats.S @ Yd + mats.H @ z
    u_fut = u[k - 1] + np.cumsum(dU_fut, axis=0)
    u_all = np.vstack([u[:k], u_fut])
    y_all = simulate.dlsim(fast_ss, np.vstack([u_all, u_all[-1:]]))
    y_true = np.concatenate([y_all[k + 1 : k + 1 + int(p[0]), 0],
                             y_all[k + 1 : k + 1 + int(p[1]), 1]])
    np.testing.assert_allclose(y_pred, y_true, atol=1e-8)


def test_unconstrained_gain_shapes_and_symmetry():
    _, _, mats = _prediction_setup(np.array([3, 3]), np.array([3, 3]))
    assert mats.H.shape == (6, 6)
    assert mats.Km.shape == (2, 6)
    np.testing.assert_allclose(mats.Km[0], mats.K[0], atol=0)
    np.testing.assert_allclose(mats.Km[1], mats.K[3], atol=0)


def test_robust_filter_dc_gain_and_cancellation():
    Pnz = plants.wood_berry().G.c2d(1.0)
    filters, dmin = flt.mimo_filter(Pnz, 0.7, 0.8)
    np.testing.assert_array_equal(dmin, [1, 1])
    for (Nr, Dr), d in zip(filters, dmin):
        assert abs(np.sum(Nr) / np.sum(Dr) - 1.0) < 1e-8
        num = np.zeros(max(len(Dr), len(Nr) + d))
        num[: len(Dr)] += Dr
        num[d : d + len(Nr)] -= Nr
        assert np.min(np.abs(np.roots(num) - 1.0)) < 1e-6


def test_robust_filter_cancels_model_poles():
    # slow pole 0.95 with delay 2 must be a root of Dr - Nr z^-d
    Nr, Dr = flt.design_robust_filter(np.array([0.95]), 0.7, 2)
    num = np.zeros(max(len(Dr), len(Nr) + 2))
    num[: len(Dr)] += Dr
    num[2 : 2 + len(Nr)] -= Nr
    for target in [1.0, 0.95]:
        assert abs(sum(c * target ** (-i) for i, c in enumerate(num))) < 1e-9


def test_condmin_beats_reference_conditioning():
    K = plants.shell3x3().G.dcgain()
    L_ref = np.array([0.4358, 0.4206, 0.5933])
    R_ref = np.array([0.6619, 0.2756, 0.4117])
    c_ref = cm.cond_of(K, L_ref, R_ref)
    L, R, S = cm.condmin(K)
    assert S <= c_ref + 1e-6, (S, c_ref)
    assert np.linalg.cond(K) > S


def test_condmin_wood_berry():
    K = plants.wood_berry().G.dcgain()
    L, R, S = cm.condmin(K)
    assert S < np.linalg.cond(K)
    assert S < 6.0  # minimized condition number of WB gains is ~5.87


@pytest.mark.parametrize("plant,p,m", [("wood_berry", [3, 3], [3, 3]),
                                       ("wood_berry", [5, 8], [2, 3]),
                                       ("shell3x3", [6, 4, 5], [2, 3, 2])])
@pytest.mark.parametrize("use_dtc", [True, False])
def test_build_gpc_matches_jax(plant, p, m, use_dtc):
    """Every matrix of build_gpc against the JAX package's at 1e-12."""
    p, m = np.array(p), np.array(m)
    ny = len(p)
    w = np.linspace(0.5, 2.0, ny)
    mats = []
    for pl, g in ((plants, gpc), (plants_jax, gpc_jax)):
        Pnz = getattr(pl, plant)().G.c2d(4.0 if plant == "shell3x3" else 1.0)
        mats.append(g.build_gpc(Pnz, p, m, w, w[::-1], use_dtc=use_dtc))
    t, j = mats
    for k in ("H", "Hp", "S", "K", "Km", "duM", "na", "N", "Nu"):
        a, b = getattr(t, k), getattr(j, k)
        assert a.shape == b.shape, k
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12, err_msg=k)
    for a, b in zip(t.A_diag, j.A_diag):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("plant", ["wood_berry", "shell3x3"])
def test_filters_match_jax(plant):
    """mimo_filter, the filter bank and the predictor diagnostics against
    the JAX package's at 1e-12."""
    out = []
    for pl, f in ((plants, flt), (plants_jax, flt_jax)):
        Pnz = getattr(pl, plant)().G.c2d(4.0 if plant == "shell3x3" else 1.0)
        filters, dmin = f.mimo_filter(Pnz, 0.7, 0.8)
        bank = f.FilterBank.from_filters(filters)
        diag = f.predictor_diagnostics(filters, bank,
                                       Pnz.fast_model().to_ss(), Pnz.to_ss())
        out.append((filters, dmin, bank, diag))
    (ft, dt, bt, gt), (fj, dj, bj, gj) = out
    np.testing.assert_array_equal(dt, dj)
    for (nt, at), (nj, aj) in zip(ft, fj):
        np.testing.assert_allclose(nt, nj, rtol=0, atol=1e-12)
        np.testing.assert_allclose(at, aj, rtol=0, atol=1e-12)
    for k in ("A", "B", "C", "D"):
        np.testing.assert_allclose(getattr(bt, k), getattr(bj, k), rtol=0,
                                   atol=1e-12, err_msg=k)
    assert (gt["dc_ok"], gt["stable"]) == (gj["dc_ok"], gj["stable"])
    np.testing.assert_allclose([gt["rho"], *gt["dc"]],
                               [gj["rho"], *gj["dc"]], rtol=0, atol=1e-12)


def test_tf2ss_z_biproper_matches_jax():
    b, a = np.array([0.5, -0.2, 0.1]), np.array([2.0, -1.0, 0.3])
    for x, y in zip(flt.tf2ss_z(b, a), flt_jax.tf2ss_z(b, a)):
        np.testing.assert_array_equal(x, y)
