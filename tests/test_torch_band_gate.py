"""The band kernel's hold (``tools/band_spread.band_witness`` /
``band_gate``, ``ops/band_cert.hold_relative``) on the CPU, at float64,
with the plain band loop standing in for the kernel: the gate passes the
plain loop against itself following its own U, and refuses a run whose
move on one well-posed step, or whose Y, was moved; the relative
certificate accepts the plain loop's run and refuses one whose slack on
one step was moved.  Shell7x5 at caps (32, 4), B = 8 seeded candidates,
nit 60 (the certificate holds a lane's first 30 steps)."""

import numpy as np
import pytest
import torch

from mpc_tuning_tpu_torch.cases import shell7x5
from mpc_tuning_tpu_torch.ops import band_cert as bc
from mpc_tuning_tpu_torch.ops import kernels as K
from mpc_tuning_tpu_torch.tools import band_spread as bs
from mpc_tuning_tpu_torch.tuning.api import build_problem

torch.set_num_threads(1)  # B <= 8: threads only contend with other workers

F64 = torch.float64
CAPS, B, NIT, SEED = (32, 4), 8, 60, 32
LANE, STEP = 2, 5   # a lane and an early well-posed step of it
CERT_NIT = 30


@pytest.fixture(scope="module")
def band():
    """The problem, the loop's arguments, the plain loop's free run and
    the plain loop following that run's U."""
    problem, _ = build_problem(shell7x5.make_case(nit=NIT), device="cpu")
    (t, lc, Hp, r_l, dims), N, Nu = bs.band_inputs(problem, CAPS, B, NIT, F64,
                                                   SEED, device="cpu")
    args, kwargs = (t, lc, Hp, r_l, NIT, 20, 12), dict(dims=dims)
    run = K.closed_sim_band_plain(*args, **kwargs)
    follow = K.closed_sim_band_plain(*args, **kwargs, u_follow=run[1])
    return problem, args, kwargs, run, follow, N, Nu


def gate(band, run):
    """band_gate of ``run`` (a kernel's (Y, U, E)) against the plain loop
    following its U, at the witness measured along that U."""
    _, args, kwargs, *_ = band
    exact = K.closed_sim_band_plain(*args, **kwargs, u_follow=run[1])
    witness = bs.band_witness(args, kwargs, run[1], exact)
    return bs.band_gate(bs.band_lane_errors(run, exact), witness, CAPS)


def test_plain_loop_passes_against_itself(band):
    *_, run, follow, _, _ = band
    ok, txt, over = gate(band, run)
    assert ok and over == [], txt
    assert float(bs.band_lane_errors(run, follow)["u"].max()) < 1e-6


def test_perturbed_move_fails(band):
    """The run's move on one well-posed step of one lane moved by 1e-6
    (its Y and E those of the loop that applied it): the gate refuses it,
    at a quantile the perturbation moves (the lane's median step), and
    names that lane for the certificate to decide."""
    problem, _, _, run, _, N, Nu = band
    lam = bs.band_candidates(CAPS, B, SEED)[2]
    u = run[1][:STEP + 1, :, LANE].numpy()
    qps, c, cand = bc.harvest_qps(problem, N[LANE], Nu[LANE], np.zeros(7),
                                  lam[LANE], u, STEP + 1,
                                  caps=(int(N[LANE]), int(Nu[LANE])))
    du_sens = bc.certify(c, cand, *qps[STEP], problem.loop.dims["nu"])[2]
    assert du_sens < bc.DU_SENS_BAR  # the step's du is well posed
    U = run[1].clone()
    U[STEP, 0, LANE] += 1e-6
    _, args, kwargs, *_ = band
    applied = K.closed_sim_band_plain(*args, **kwargs, u_follow=U)
    ok, txt, over = gate(band, (applied[0], U, applied[2]))
    assert not ok and LANE in over, txt


def test_perturbed_y_fails(band):
    *_, run, _, _, _ = band
    Y = run[0].clone()
    Y[NIT // 2, 0, LANE] += 1e-7
    ok, txt, over = gate(band, (Y, run[1], run[2]))
    assert not ok and over is None, txt  # no certificate clears a wrong Y


def test_band_limits_and_floors():
    """Live limits are BAND_FACTOR x the witness's lane quantiles plus the
    statistic's floor; each floor is at or below the smallest frozen limit
    of its statistic; the tightest lane is the one furthest over its own
    witness in U."""
    wit = {k: torch.tensor([0.0, 1e-9, 1e-3, 2e-3], dtype=F64)
           for k in ("y", "u", "u_step", "e")}
    lim = bs.band_limits(wit)
    for k, floor in bs.BAND_FLOORS.items():
        q = bs.lane_quantiles(wit[k])
        assert lim[k] == [bs.BAND_FACTOR * v + floor for v in q]
        assert floor <= min(min(v[k]) for v in bs.BAND_LIMITS.values())
    errs = dict(wit, u=torch.tensor([1e-7, 1e-8, 1e-3, 1e-3], dtype=F64))
    assert bs.tightest_lane(errs, wit) == 0


@pytest.fixture(scope="module")
def cert_lane(band):
    """The plain run's first CERT_NIT steps on LANE, its candidate."""
    problem, _, _, run, _, N, Nu = band
    lam = bs.band_candidates(CAPS, B, SEED)[2]
    U = run[1][:CERT_NIT, :, LANE].numpy()
    E = run[2][:CERT_NIT, LANE].numpy()
    return problem, (N[LANE], Nu[LANE], np.zeros(7), lam[LANE]), U, E


def test_relative_certificate_accepts_the_plain_chain(cert_lane):
    problem, cand, U, E = cert_lane
    out = bc.hold_relative(problem, *cand, U, E, caps=tuple(map(int, cand[:2])))
    assert out["ok"], out
    assert out["run"]["eps_pos"] > 0


def test_relative_certificate_refuses_a_moved_slack(cert_lane):
    """The slack on one step with a positive LP slack moved by 1e-4
    relative to 1 + |E|: the plain chain reaches the LP minimum there, so
    the run is refused."""
    problem, cand, U, E = cert_lane
    k = int(np.argmax(E))
    E = E.copy()
    E[k] += 1e-4 * (1.0 + abs(E[k]))
    out = bc.hold_relative(problem, *cand, U, E, caps=tuple(map(int, cand[:2])),
                           replicas=256)
    assert not out["ok"], out
    assert out["plain"]["deps_rel_frozen"] < 1e-6
