"""The band kernel's cluster-size rule and envelope (``ops/kernels.band_plan``
/ ``band_envelope``, the arithmetic of ``ops/csrc/closed_sim_band.cu``'s
band_plan): blocks a cluster and shared memory a block at the Shell7x5
buckets, the largest admitted and the first refused shapes, and that every
bucket a Shell7x5 tune can reach fits.  Host arithmetic only; the C side's
own arithmetic is held against this in ``tests/test_torch_gpu.py``."""

import pytest
import torch

from mpc_tuning_tpu_torch.cases import shell7x5
from mpc_tuning_tpu_torch.ops import kernels as K
from mpc_tuning_tpu_torch.sim.mpc_loop import horizon_caps
from mpc_tuning_tpu_torch.tuning.api import build_problem

SMEM = K.FACTOR_SMEM_MAX  # 227 KB a block on the H100
NY, NU, NXA, NXP = 7, 3, 77, 70  # Shell7x5's outputs, inputs and states


def shape(p_cap, m_cap, extra_pairs=0):
    """(n, mc, pny, ny, nu, nxa, nxp) of a Shell7x5 bucket, with
    ``extra_pairs`` band pairs more."""
    pny = p_cap * NY + extra_pairs
    n = m_cap * NU + 1
    return (n, 4 * m_cap * NU + 2 * pny + 1, pny, NY, NU, NXA, NXP)


# (blocks a cluster, bytes a block): the smallest of 1, 2, 4 blocks whose
# slice of the K-rows (the mc - pny non-band rows and band pairs) fits
PLANS = {(32, 4): (1, 119080), (48, 4): (1, 151784), (127, 2): (2, 148784),
         (127, 15): (4, 213520)}


@pytest.mark.parametrize("caps", sorted(PLANS))
def test_band_plan_arithmetic(caps):
    assert K.band_plan(*shape(*caps)) == PLANS[caps]


def test_one_block_too_few_at_the_first_gam_bucket():
    """(127, 2) takes two blocks: its 914 K-rows need ~260 KB in one."""
    assert K._band_bytes(1, *shape(127, 2)) > SMEM
    assert K._band_bytes(2, *shape(127, 2)) <= SMEM


EDGE_EXTRA = 138


def test_band_plan_edge():
    """At the widest bucket the band pairs run up to 1027 (138 more than
    Shell7x5's 889) before four blocks need more than 227 KB; one more is
    refused."""
    extra = 0
    while K.band_plan(*shape(127, 15, extra + 1))[0]:
        extra += 1
    assert extra == EDGE_EXTRA
    C, b = K.band_plan(*shape(127, 15, extra))
    assert C == K.BAND_MAX_CLUSTER and SMEM - 1024 < b <= SMEM
    assert K.band_plan(*shape(127, 15, extra + 1))[0] == 0


def test_band_envelope_refuses_what_no_cluster_holds():
    problem, _ = build_problem(shell7x5.make_case(nit=20), device="cpu")
    c = problem.loop.capped(127, 15).arrays(torch.float64, "cpu")
    dims = dict(n=46, mc=c["G0"].shape[0], nu=NU, ny=NY, m_max=15)
    assert K.band_envelope(c["G0"], dims, 127 * NY, NXA, NXP) == 180
    # the same G0 checked against the estimator of a far larger model
    with pytest.raises(ValueError, match="shared memory"):
        K.band_envelope(c["G0"], dims, 127 * NY, 4000, NXP)


def test_every_band_bucket_fits():
    """Every capacity bucket a Shell7x5 tune can reach, up to (127, 15),
    is inside the envelope, with the blocks a cluster growing with it."""
    problem, _ = build_problem(shell7x5.make_case(nit=20), device="cpu")
    d = problem.loop.dims
    p_max, m_max = d["p_max"], d["m_max"]
    buckets = {horizon_caps(p_max, m_max, [N], [Nu])
               for N in range(2, p_max + 1)
               for Nu in range(1, min(N, m_max + 1))}
    assert (127, 15) in buckets
    seen = set()
    for p_cap, m_cap in sorted(buckets):
        c = problem.loop.capped(p_cap, m_cap).arrays(torch.float64, "cpu")
        s = shape(p_cap, m_cap)
        assert (c["G0"].shape[0], c["A"].shape[0], c["A_pl"].shape[0]) == \
            (s[1], NXA, NXP)
        C, b = K.band_plan(*s)
        assert C in (1, 2, 4) and b <= SMEM, (p_cap, m_cap, C, b)
        seen.add(C)
    assert seen == {1, 2, 4}
