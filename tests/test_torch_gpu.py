"""The port's CUDA kernels against their plain PyTorch versions on the card
(small Wood-Berry and Shell7x5 shapes).  Skipped on hosts without a CUDA
device; on a GPU host run
``python -m pytest --noconftest tests/test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

from mpc_tuning_tpu_torch.cases import shell7x5, woodberry
from mpc_tuning_tpu_torch.ops import kernels as K
from mpc_tuning_tpu_torch.tools.band_spread import (band_gate, band_inputs,
                                                    band_lane_errors)
from mpc_tuning_tpu_torch.tuning.api import build_problem

pytestmark = pytest.mark.gpu

F64 = torch.float64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _inputs(engine, B=40, nit=60, caps=(64, 8)):
    problem, _ = build_problem(woodberry.make_case(nit=nit), device="cuda")
    rng = np.random.default_rng(0)
    N = rng.integers(caps[1] + 1, caps[0] + 1, size=B)
    Nu = rng.integers(2, caps[1] + 1, size=B)
    r_b = np.broadcast_to(problem.r, (B, nit, 2))
    return problem.loop.sim_inputs(
        r_b, problem.v, N, Nu, rng.uniform(0.2, 2.0, (B, 2)),
        rng.uniform(0.05, 0.5, (B, 2)), nit, F64, engine, "cuda", caps=caps)


@pytest.mark.parametrize("n", [5, 17, 31])
def test_spd_kernels_match_plain(cuda, n):
    g = torch.Generator(device=cuda).manual_seed(n)
    A = torch.randn((300, n, n), generator=g, device=cuda, dtype=F64)
    M = A @ A.transpose(1, 2) + n * torch.eye(n, device=cuda, dtype=F64)
    rhs = torch.randn((300, n), generator=g, device=cuda, dtype=F64)
    before = K.launch_counts()
    L = K.spd_factor(M)
    x = K.spd_factor_solve(L, rhs)
    after = K.launch_counts()
    assert after["spd_factor"] == before["spd_factor"] + 1
    assert after["spd_factor_solve"] == before["spd_factor_solve"] + 1
    torch.testing.assert_close(L, K.spd_factor_plain(M), rtol=0, atol=1e-10)
    torch.testing.assert_close(x, K.spd_factor_solve_plain(L, rhs), rtol=0,
                               atol=1e-10)


def test_closed_sim_admm_matches_plain(cuda):
    t, lc, Minv, r_l, dims = _inputs("admm_sim")
    args = (t, lc, Minv, r_l, r_l.shape[0], 40, 1e-6, 1.6, dims)
    for a, b in zip(K.closed_sim_admm(*args), K.closed_sim_admm_plain(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-9)


def test_closed_sim_pdip_matches_plain(cuda):
    t, lc, Hp, r_l, dims = _inputs("pdip_sim")
    args = (t, lc, Hp, r_l, r_l.shape[0], 15, dims)
    for a, b in zip(K.closed_sim_pdip(*args), K.closed_sim_pdip_plain(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-9)


def _band_inputs(cuda, caps, B=4, nit=30):
    problem, _ = build_problem(shell7x5.make_case(nit=nit), device=cuda)
    (t, lc, Hp, r_l, dims), _, _ = band_inputs(problem, caps, B, nit, F64,
                                               caps[0], device=cuda)
    return t, lc, Hp, r_l, nit, 20, 12, dims


@pytest.mark.parametrize("caps", [(32, 4), (127, 15)])
def test_closed_sim_band_matches_plain(cuda, caps):
    """Step by step (the plain version follows the kernel's U), at the
    limits of chip_smoke.py's band rows (tools/band_spread.BAND_LIMITS).
    (127, 15) keeps the per-lane vectors in global scratch, (32, 4) in
    shared memory."""
    args = _band_inputs(cuda, caps)
    before = K.closed_sim_band.launches
    out_k = K.closed_sim_band(*args)
    assert K.closed_sim_band.launches == before + 1
    assert all(torch.isfinite(x).all() for x in out_k)
    out_p = K.closed_sim_band_plain(*args, u_follow=out_k[1])
    ok, txt = band_gate(band_lane_errors(out_k, out_p), caps)
    assert ok, txt


def test_closed_sim_band_refuses_float32(cuda):
    t, lc, Hp, r_l, *rest = _band_inputs(cuda, (32, 4))
    f32 = lambda d: {k: v.float() for k, v in d.items()}
    with pytest.raises(ValueError, match="float64 only"):
        K.closed_sim_band(f32(t), f32(lc), Hp.float(), r_l.float(), *rest)


def test_wrong_dtype_or_layout_raises(cuda):
    t, lc, Hp, r_l, dims = _inputs("pdip_sim", B=8)
    with pytest.raises(ValueError):
        K.closed_sim_pdip(t, lc, Hp.transpose(0, 1), r_l, r_l.shape[0], 5,
                          dims)
    with pytest.raises(ValueError):
        K.spd_factor(torch.eye(4, device=cuda, dtype=torch.float16)[None])
