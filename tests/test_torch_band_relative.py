"""The band kernel's relative certificate (``ops/band_cert.hold_relative``)
where the stage-0 LP does not converge, on the CPU at float64, with the
plain band loop standing in for the kernel.  Shell7x5 at caps (127, 15),
B = 4 seeded candidates (phase 2b's seed), nit 20: on lane 2 (N 83, Nu 14)
the disturbance enters at step 19 and the LP minimum jumps from 0 to
0.27; 20 warm-started iterations end short of it, and how far short
depends on rounding.  The run of the loop in its batch of four is held
there by the chains that round differently, and a slack moved on a step
where the LP converges is refused all the same: the limits are per step."""

import numpy as np
import pytest
import torch

from mpc_tuning_tpu_torch.cases import shell7x5
from mpc_tuning_tpu_torch.ops import band_cert as bc
from mpc_tuning_tpu_torch.ops import kernels as K
from mpc_tuning_tpu_torch.tools import band_spread as bs
from mpc_tuning_tpu_torch.tuning.api import build_problem

torch.set_num_threads(2)

CAPS, B, NIT, LANE = (127, 15), 4, 20, 2
JUMP, CONVERGED = 19, 10  # the jump step, and an earlier converged step
# rounded chains (fewer than hold_relative's default, which the card runs
# in one batch): the run held here is well inside their scatter
REPLICAS = 256


@pytest.fixture(scope="module")
def lane_run():
    """The problem, LANE's candidate, and its U and E from the plain loop
    run on the batch of B candidates."""
    problem, _ = build_problem(shell7x5.make_case(nit=NIT), device="cpu")
    (t, lc, Hp, r_l, dims), N, Nu = bs.band_inputs(
        problem, CAPS, B, NIT, torch.float64, CAPS[0], device="cpu")
    _, U, E = K.closed_sim_band_plain(t, lc, Hp, r_l, NIT, 20, 12, dims)
    lam = bs.band_candidates(CAPS, B, CAPS[0])[2]
    cand = (N[LANE], Nu[LANE], np.zeros(7), lam[LANE])
    return problem, cand, U[:, :, LANE].numpy(), E[:, LANE].numpy()


def hold(lane_run, E=None):
    problem, cand, U, E0 = lane_run
    return bc.hold_relative(problem, *cand, U, E0 if E is None else E,
                            caps=tuple(map(int, cand[:2])), replicas=REPLICAS)


def test_plain_run_is_held_across_the_jump(lane_run):
    """The loop's own run passes; the step it is nearest its limit at is
    the jump, where the limit is above the absolute slack gate."""
    out = hold(lane_run)
    assert out["ok"], out
    assert out["run"]["uncertified"] == 0 and out["eps_step"] == JUMP, out
    assert out["eps_limit"] > bc.HOLD_EPS_REL, out


def test_moved_slack_on_a_converged_step_is_refused(lane_run):
    """The slack on a converged step moved by 2e-5 relative: less than the
    chains' own limit at the jump, so a limit taken over all steps would
    pass it, but the step's own limit is the absolute gate."""
    E = lane_run[3].copy()
    shift = 2e-5
    E[CONVERGED] += shift * (1.0 + abs(E[CONVERGED]))
    out = hold(lane_run, E)
    assert not out["ok"] and out["eps_step"] == CONVERGED, out
    assert out["chains"] == 2 + REPLICAS, out
    assert out["eps_limits"][CONVERGED] == bc.HOLD_EPS_REL, out
    assert out["eps_limits"][JUMP] > shift, out
