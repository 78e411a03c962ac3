"""The envelope of the single-solve ADMM kernel (``ops/kernels.
admm_fused_envelope``, the arithmetic of ``ops/csrc/qp_fused.cu``'s
QpShape / AdmmLayout): lanes and shared memory per block, the largest
admitted and the first refused shapes, and that every capacity bucket the
Wood-Berry and Shell3x3 tunes build fits at both dtypes.  Host arithmetic
only; the kernel itself is held against its plain version and the
one-thread design in ``tests/test_torch_gpu.py``."""

import pytest
import torch

from mpc_tuning_tpu_torch.cases import shell3x3, woodberry
from mpc_tuning_tpu_torch.ops.kernels import admm_fused_envelope
from mpc_tuning_tpu_torch.sim.mpc_loop import horizon_caps
from mpc_tuning_tpu_torch.tuning.api import build_problem

F32, F64 = torch.float32, torch.float64
# (n, mc) of Wood-Berry (64, 8) and Shell3x3 (127, 15), the widest bucket a
# tracking tune builds, and bytes a block: 4 lanes of 4 bytes or 2 lanes of
# 8 bytes, so both dtypes need the same bytes
SMEM = {(17, 65): 9872, (46, 181): 49120}


@pytest.mark.parametrize("dtype,per_block", [(F32, 4), (F64, 2)])
@pytest.mark.parametrize("shape", sorted(SMEM))
def test_admm_fused_envelope_arithmetic(shape, dtype, per_block):
    assert admm_fused_envelope(dtype, *shape) == (per_block, SMEM[shape])


@pytest.mark.parametrize("dtype", [F32, F64])
def test_admm_fused_envelope_first_refused(dtype):
    """At n = 46 the rows mc run up to 3045, at mc = 181 the variables n up
    to 115, before a block's lanes need more than 227 KB; empty shapes and
    dtypes without a kernel are refused."""
    assert admm_fused_envelope(dtype, 46, 3045)[1] == 232416
    assert admm_fused_envelope(dtype, 115, 181)[1] <= 232448
    for n, mc in ((46, 3046), (116, 181), (0, 181), (46, 0)):
        with pytest.raises(ValueError, match="admm_fused"):
            admm_fused_envelope(dtype, n, mc)
    with pytest.raises(ValueError, match="float32 or float64"):
        admm_fused_envelope(torch.float16, 46, 181)


@pytest.mark.parametrize("mod", [woodberry, shell3x3],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_every_tracking_bucket_fits_admm_fused(mod):
    """Every capacity bucket a tune can reach (each (N, Nu) up to the case's
    (127, 15)) is inside the envelope at both dtypes; the widest is
    Shell3x3's n = 46, mc = 181."""
    problem, _ = build_problem(mod.make_case(nit=20), dtype=F64, device="cpu")
    d = problem.loop.dims
    p_max, m_max, nu = d["p_max"], d["m_max"], d["nu"]
    buckets = {horizon_caps(p_max, m_max, [N], [Nu])
               for N in range(2, p_max + 1)
               for Nu in range(1, min(N, m_max + 1))}
    assert (p_max, m_max) == (127, 15) and (127, 15) in buckets
    widest = None
    for p_cap, m_cap in sorted(buckets):
        G0 = problem.loop.capped(p_cap, m_cap).arrays(F64, "cpu")["G0"]
        shape = (m_cap * nu + 1, G0.shape[0])
        assert G0.shape[1] == shape[0]
        for dtype in (F32, F64):
            admm_fused_envelope(dtype, *shape)  # raises outside
        widest = shape
    assert widest == ((31, 121) if mod is woodberry else (46, 181))
