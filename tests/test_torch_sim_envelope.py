"""The envelope of the whole-sim kernels (``ops/kernels.sim_envelope``, the
arithmetic of ``ops/csrc/closed_sim.cu``): lanes and shared memory per
block, the largest admitted and the first refused shapes, and that every
capacity bucket the Wood-Berry and Shell3x3 tunes build fits at both
dtypes.  Host arithmetic only; the kernels themselves are held against
their plain versions in ``tests/test_torch_gpu.py``."""

import pytest
import torch

from mpc_tuning_tpu_torch.cases import shell3x3, woodberry
from mpc_tuning_tpu_torch.ops.kernels import sim_envelope
from mpc_tuning_tpu_torch.sim.mpc_loop import horizon_caps
from mpc_tuning_tpu_torch.tuning.api import build_problem

F32, F64 = torch.float32, torch.float64
# (n, mc, pny, ny, nu, nxa, nxp) of two buckets: Wood-Berry (64, 8) and
# Shell3x3 (127, 15), the widest a tracking tune builds
WB_64_8 = (17, 65, 128, 2, 2, 21, 19)
S3_127_15 = (46, 181, 381, 3, 3, 33, 30)
# bytes a block: 4 lanes of 4 bytes or 2 lanes of 8 bytes, so both dtypes
# need the same bytes
SMEM = {(False, WB_64_8): 18800, (True, WB_64_8): 28896,
        (False, S3_127_15): 72992, (True, S3_127_15): 122800}


@pytest.mark.parametrize("dtype,per_block", [(F32, 4), (F64, 2)])
@pytest.mark.parametrize("pdip,shape", sorted(SMEM, key=str),
                         ids=lambda x: str(x))
def test_sim_envelope_arithmetic(pdip, shape, dtype, per_block):
    assert sim_envelope(pdip, dtype, *shape) == (per_block, SMEM[pdip, shape])


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("pdip,mc_max", [(True, 752), (False, 1604)])
def test_sim_envelope_first_refused(pdip, mc_max, dtype):
    """At Shell3x3's widest bucket the rows mc run up to 752 (PDIP) or 1604
    (ADMM) before a block's lanes need more than 227 KB; n runs up to 64,
    the factor's two rows a lane; n = 0 and dtypes without a kernel are
    refused."""
    n, mc, pny, *rest = S3_127_15
    assert sim_envelope(pdip, dtype, n, mc_max, pny, *rest)[1] <= 232448
    with pytest.raises(ValueError, match="whole-sim"):
        sim_envelope(pdip, dtype, n, mc_max + 1, pny, *rest)
    sim_envelope(pdip, dtype, 64, mc, pny, *rest)
    for bad_n in (65, 0):
        with pytest.raises(ValueError, match="whole-sim"):
            sim_envelope(pdip, dtype, bad_n, mc, pny, *rest)
    with pytest.raises(ValueError, match="float32 or float64"):
        sim_envelope(pdip, torch.float16, *S3_127_15)


@pytest.mark.parametrize("mod", [woodberry, shell3x3],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_every_tracking_bucket_fits(mod):
    """Every capacity bucket a tune can reach (each (N, Nu) up to the case's
    (127, 15)) is inside the envelope for both engines at both dtypes; the
    widest is Shell3x3's n = 46, mc = 181, pny = 381."""
    problem, _ = build_problem(mod.make_case(nit=20), dtype=F64, device="cpu")
    d = problem.loop.dims
    p_max, m_max, ny, nu = d["p_max"], d["m_max"], d["ny"], d["nu"]
    buckets = {horizon_caps(p_max, m_max, [N], [Nu])
               for N in range(2, p_max + 1)
               for Nu in range(1, min(N, m_max + 1))}
    assert (p_max, m_max) == (127, 15) and (127, 15) in buckets
    widest = None
    for p_cap, m_cap in sorted(buckets):
        c = problem.loop.capped(p_cap, m_cap).arrays(F64, "cpu")
        shape = (m_cap * nu + 1, c["G0"].shape[0], p_cap * ny, ny, nu,
                 c["A"].shape[0], c["A_pl"].shape[0])
        assert c["G0"].shape[1] == shape[0]
        for pdip in (False, True):
            for dtype in (F32, F64):
                sim_envelope(pdip, dtype, *shape)  # raises outside
        widest = shape
    assert widest == ((31, 121, 254, 2, 2, 21, 19) if mod is woodberry
                      else S3_127_15)
