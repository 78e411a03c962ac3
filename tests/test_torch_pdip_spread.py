"""The float32 whole-sim PDIP hold (``tools/pdip_spread.pdip_u_hold``) on
the CPU's plain loop: a correct run passes, a U moved at one step is
refused (no run one rounding away reproduces it), a lane over the cap is
passed only by a run following U moved by whole ulps, and ``ulp_moved``
moves by whole ulps."""

import numpy as np
import pytest
import torch

from mpc_tuning_tpu_torch.cases import woodberry
from mpc_tuning_tpu_torch.ops import kernels as K
from mpc_tuning_tpu_torch.tools.pdip_spread import (ULP_MOVES, pdip_u_hold,
                                                    ulp_moved)
from mpc_tuning_tpu_torch.tuning.api import build_problem

torch.set_num_threads(1)  # B 4: threads only contend with other workers

F32 = torch.float32
GATE, CAP = 1e-3, 0.1  # chip_smoke.py's F32_SIM_GATE and F32_PDIP_U_CAP
NIT, B = 20, 4


@pytest.fixture(scope="module")
def run():
    """A float32 Wood-Berry PDIP loop of B candidates on the CPU: (the
    plain loop's arguments, its keyword arguments, its own Y and U)."""
    problem, _ = build_problem(woodberry.make_case(nit=NIT), dtype=F32,
                               device="cpu")
    rng = np.random.default_rng(3)
    N, Nu = rng.integers(16, 64, size=B), rng.integers(2, 7, size=B)
    r_b = np.broadcast_to(problem.r[:NIT], (B, NIT, 2))
    t, lc, Hm, r_l, dims = problem.loop.sim_inputs(
        r_b, problem.v, N, Nu, rng.uniform(0.2, 2.0, (B, 2)),
        rng.uniform(0.01, 0.5, (B, 2)), NIT, F32, "pdip_sim", "cpu")
    args, kwargs = (t, lc, Hm, r_l, NIT, 15), dict(dims=dims)
    return (args, kwargs) + K.closed_sim_pdip_plain(*args, **kwargs)


def test_a_correct_run_passes(run):
    args, kwargs, Y, U = run
    ok, text = pdip_u_hold(K.closed_sim_pdip_plain, args, kwargs, Y, U, GATE,
                           CAP)
    assert ok and "over the cap" not in text, text


@pytest.mark.parametrize("step", [3, NIT - 1])
def test_a_moved_step_is_refused(run, step):
    """The control: lane 2's U moved by 0.2 at one step is over the cap in
    the plain run and in every run one rounding away (each solves that
    step itself)."""
    args, kwargs, Y, U = run
    moved = U.clone()
    moved[step, 0, 2] += 0.2
    Ym = K.closed_sim_pdip_plain(*args, **kwargs, u_follow=moved)[0]
    ok, text = pdip_u_hold(K.closed_sim_pdip_plain, args, kwargs, Ym, moved,
                           GATE, CAP, median=False)
    assert not ok and "2 (U " in text and "no run one rounding away" in text


def test_a_lane_matched_one_ulp_away_passes(run):
    """A lane over the cap passes when a run following U moved by ulps is
    within it, and only then (a stand-in plain version that lands off lane
    1 unless it follows U two ulps up)."""
    args, kwargs, Y, U = run

    def plain(*a, u_follow, **k):
        off = not torch.equal(u_follow, ulp_moved(U, 2))
        out = U.clone()
        out[:, :, 1] += 0.3 * off
        return Y, out

    ok, text = pdip_u_hold(plain, args, kwargs, Y, U, GATE, CAP)
    assert ok and "1 (U 3.000e-01; +2 ulp run 0.000e+00)" in text, text
    ok, text = pdip_u_hold(lambda *a, u_follow, **k: (Y, U + 0.3), args,
                           kwargs, Y, U, GATE, CAP)
    assert not ok, text


@pytest.mark.parametrize("k", ULP_MOVES)
def test_ulp_moved(k):
    x = torch.tensor([1.0, -3.5, 0.25, 1e-30], dtype=F32)
    y = ulp_moved(x, k)
    step = torch.nextafter(x, torch.full_like(x, np.sign(k) * np.inf))
    assert torch.equal(ulp_moved(x, np.sign(k)), step)
    assert bool(((y > x) if k > 0 else (y < x)).all())
    assert torch.equal(ulp_moved(y, -k), x)
