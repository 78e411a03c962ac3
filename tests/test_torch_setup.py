"""The port's host setup against the JAX package: the conditioned Wood-Berry
problem, the controller arrays and the state conversion must be exactly
equal (both sides run the same float64 NumPy/SciPy code)."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tuning_tpu.cases import woodberry as wb_jax
from mpc_tuning_tpu.tuning.api import build_problem as build_jax
from mpc_tuning_tpu_torch import convert
from mpc_tuning_tpu_torch.cases import woodberry as wb_torch
from mpc_tuning_tpu_torch.tuning.api import build_problem as build_torch

CTL_FIELDS = ("A", "Bu", "Bv", "C", "Dv", "M", "Sx", "Sstep", "Sv", "Theta",
              "Tcum", "umin_s", "umax_s", "dumin_s", "dumax_s", "ymin_s",
              "ymax_s")


@pytest.fixture(scope="module")
def problems():
    pj, info_j = build_jax(wb_jax.make_case(), dtype=jnp.float64)
    pt, info_t = build_torch(wb_torch.make_case(), dtype=torch.float64,
                              device="cpu")
    return pj, info_j, pt, info_t


@pytest.mark.parametrize("field", CTL_FIELDS)
def test_controller_field_exact(problems, field):
    pj, _, pt, _ = problems
    a = getattr(pj.loop.ctl, field)
    b = getattr(pt.loop.ctl, field)
    assert np.array_equal(a, b), field


def test_conditioning_and_problem_exact(problems):
    pj, info_j, pt, info_t = problems
    for a, b in zip(info_j, info_t):  # L, R, Ru, Rv, S, cond_before
        assert np.array_equal(np.asarray(a), np.asarray(b))
    for name in ("r", "v", "Yref", "w", "band_mask", "dmin"):
        assert np.array_equal(getattr(pj, name), getattr(pt, name)), name
    assert pj.nit == pt.nit and pj.nbp == pt.nbp and pj.nbc == pt.nbc


@pytest.mark.parametrize("caps", [None, (64, 8)])
def test_controller_tables_exact(problems, caps):
    """G0, T2 and every other controller array, at full size and capped."""
    pj, _, pt, _ = problems
    lj, lt = pj.loop, pt.loop
    if caps is not None:
        lj, lt = lj.capped(*caps), lt.capped(*caps)
    cj = {k: np.asarray(v) for k, v in lj.arrays(jnp.float64).items()}
    ct = {k: v.numpy() for k, v in lt.arrays(torch.float64, "cpu").items()}
    assert cj.keys() == ct.keys()
    for k in cj:
        assert np.array_equal(cj[k], ct[k]), k


def test_arrays_from_numpy_matches_port_arrays(problems):
    pj, _, pt, _ = problems
    cj = {k: np.asarray(v) for k, v in pj.loop.arrays(jnp.float64).items()}
    conv = convert.arrays_from_numpy(cj, torch.float64, "cpu")
    own = pt.loop.arrays(torch.float64, "cpu")
    assert conv.keys() == own.keys()
    for k in own:
        assert conv[k].dtype == own[k].dtype and conv[k].device == own[k].device
        assert torch.equal(conv[k], own[k]), k


def test_entry_points_default_to_the_card():
    """Without an explicit device the port runs on the card; on a host
    without one the entry points raise instead of carrying on on the CPU."""
    case = wb_torch.make_case(nit=20)
    if torch.cuda.is_available():
        problem, _ = build_torch(case)
        assert torch.device(problem.device).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_torch(case)
    problem, _ = build_torch(case, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        problem.loop.arrays()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.arrays_from_numpy({"A": np.eye(2)})


def test_nmpc_entry_points_default_to_the_card():
    """The Van de Vusse problem and the NMPC loop's methods run on the card
    unless the CPU is asked for; on a host without one they raise."""
    from mpc_tuning_tpu_torch.cases import vandevusse

    case = vandevusse.make_case(nit=4, nbp=2, nbc=1, substeps=1,
                                sqp_iters=1, qp_iters=2)
    if torch.cuda.is_available():
        assert torch.device(vandevusse.build_problem(case).device).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vandevusse.build_problem(case)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vandevusse.run(nit=4, checkpoint_dir=None, verbose=False)
    loop = vandevusse.build_problem(case, device="cpu").loop
    r, v = case.r, np.zeros((4, 0))
    one = ([3], [1], [[1.0, 1.0]], [[0.1, 0.1]], 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loop.closed_batch(r[None], v, *one)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loop.open_batch(r[-1:], v, *one)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loop.simulate(r, v, 4, 3, 1, [1.0, 1.0], [0.1, 0.1])
    y, u = loop.simulate(r, v, 4, 3, 1, [1.0, 1.0], [0.1, 0.1], device="cpu")
    assert y.shape == (4, 2) and np.isfinite(u).all()


def test_port_imports_no_jax():
    """Every module of the port (pkgutil.walk_packages), imported in one
    fresh process, brings in no jax, jaxlib or mpc_tuning_tpu module."""
    code = (
        "import importlib, pkgutil, sys\n"
        "before = set(sys.modules)\n"
        "import mpc_tuning_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'mpc_tuning_tpu_torch.bench' in names, names\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'mpc_tuning_tpu'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
