"""The port's native active-set QP oracle (``ops/native_qp.py``) on every
QP of tests/test_native_qp.py: its solutions equal the JAX package's
oracle bit for bit (the same C++ code, flags and anti-cycling draw), meet
that file's KKT tolerances and agree with the port's dense PDIP
``ops/qp.solve_qp`` (on the CPU).  It builds into the port's ``_build/``,
never into ``native/``, without a race between processes."""

import multiprocessing
import pathlib

import numpy as np
import pytest
import torch

from mpc_tuning_tpu.ops.native_qp import qp_solve_exact as exact_jax
from mpc_tuning_tpu_torch.ops import native_qp
from mpc_tuning_tpu_torch.ops.native_qp import native_available, qp_solve_exact
from mpc_tuning_tpu_torch.ops.qp import solve_qp

torch.set_num_threads(1)  # one QP at a time: threads only contend

pytestmark = pytest.mark.skipif(not native_available(), reason="no g++")


def _random_qp(rng, n, m):
    A = rng.standard_normal((n, n))
    H = A @ A.T + n * np.eye(n)
    f = rng.standard_normal(n)
    G = rng.standard_normal((m, n))
    h = np.abs(rng.standard_normal(m)) + 0.3
    return H, f, G, h


def _pdip(H, f, G, h, iters=30):
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)[None]
    return solve_qp(t(H), t(f), t(G), t(h), iters)[0][0].numpy()


def _same_as_jax(args, **kw):
    x, lam, status = qp_solve_exact(*args, **kw)
    xj, lamj, statusj = exact_jax(*args, **kw)
    assert status == statusj
    assert np.array_equal(x, xj) and np.array_equal(lam, lamj)
    return x, lam, status


@pytest.mark.parametrize("seed", range(8))
def test_native_matches_jax_and_pdip(seed):
    rng = np.random.default_rng(seed)
    H, f, G, h = _random_qp(rng, 10, 24)
    x, lam, status = _same_as_jax((H, f, G, h))
    assert status == 0
    assert np.linalg.norm(H @ x + f + G.T @ lam) < 1e-8
    assert np.max(G @ x - h) < 1e-8
    assert np.all(lam >= -1e-10)
    np.testing.assert_allclose(_pdip(H, f, G, h), x, atol=1e-6)
    # CPU tensors in, NumPy out, the same bits
    xt, lamt, st = qp_solve_exact(*(torch.as_tensor(a) for a in (H, f, G, h)))
    assert st == 0 and np.array_equal(xt, x) and np.array_equal(lamt, lam)


def test_native_unconstrained_interior():
    rng = np.random.default_rng(99)
    H, f, G, h = _random_qp(rng, 6, 10)
    h = h + 100.0
    x, lam, status = _same_as_jax((H, f, G, h))
    assert status == 0
    np.testing.assert_allclose(x, np.linalg.solve(H, -f), atol=1e-10)
    assert np.all(lam == 0)


def test_native_on_mpc_qp():
    """The condensed Wood-Berry MPC QP (masked rows included), assembled
    by the port on the CPU."""
    from mpc_tuning_tpu_torch.cases import woodberry
    from mpc_tuning_tpu_torch.ops.mpc_qp import (assemble_candidate,
                                                 qp_step_data)
    from mpc_tuning_tpu_torch.tuning.api import build_problem

    problem, _ = build_problem(woodberry.make_case(nit=50, nbp=5, nbc=3),
                               dtype=torch.float64, device="cpu")
    loop = problem.loop
    c = loop.arrays(torch.float64, "cpu")
    d = loop.dims
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    cand = assemble_candidate(c, torch.tensor([12]), torch.tensor([3]),
                              t([[1.0, 1.0]]), t([[0.1, 0.1]]), d["p_max"],
                              d["m_max"], d["ny"], d["nu"], d["rho"],
                              d["with_y"])
    rng = np.random.default_rng(5)
    x_hat = t(rng.standard_normal((1, c["A"].shape[0])) * 0.05)
    f, h, _ = qp_step_data(c, cand, x_hat, t([[0.1, -0.05]]),
                           t([[0.4, 0.2]]), torch.zeros(0, dtype=torch.float64),
                           d["p_max"], d["m_max"], d["ny"], d["nu"],
                           d["with_y"])
    H0 = cand["H"][0].numpy()
    G = cand["G"][0].numpy()
    H = H0 + 1e-9 * np.eye(H0.shape[0])
    x, lam, status = _same_as_jax((H, f[0].numpy(), G, h[0].numpy()),
                                  max_iter=500)
    assert status == 0
    np.testing.assert_allclose(_pdip(H0, f[0], G, h[0], iters=40), x,
                               atol=1e-5)


def test_native_anti_cycling_matches_jax():
    """A degenerate QP (more tied active rows than variables) that runs
    the perturb-and-polish path: the same perturbation, the same bits."""
    rng = np.random.default_rng(7)
    n = 4
    H = np.eye(n) * 2.0
    f = -np.ones(n) * 4.0
    G = np.vstack([np.eye(n)] * 3 + [rng.standard_normal((2, n)) * 0])
    h = np.ones(3 * n + 2)
    for it in (1, 2, 3):
        _same_as_jax((H, f, G, h), max_iter=it)


def _build_in(dirname):
    native_qp._BUILD = pathlib.Path(dirname)
    native_qp._lib = None
    return native_qp.native_available()


def test_native_builds_into_build_dir_without_a_race(tmp_path):
    """Four processes building into one empty directory at once all load
    the oracle; the directory holds the one keyed library and no leftover
    temporary, and the source's own build lands in ``_build/``."""
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(4) as pool:
        assert all(pool.map(_build_in, [str(tmp_path)] * 4))
    built = sorted(p.name for p in tmp_path.iterdir())
    assert built == [native_qp._so_path().name]
    assert native_qp._so_path().parent.name == "_build"
    assert native_qp._so_path().parent.parent.name == "mpc_tuning_tpu_torch"
