"""The envelope of the SPD factor kernels (``ops/kernels.factor_envelope``,
the arithmetic of ``ops/csrc/spd.cu``): matrices per block and shared
memory per block, the first n it refuses, and that every factor the four
tunes launch fits it.  Host arithmetic only; the kernels themselves are
held against their plain versions in ``tests/test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

from mpc_tuning_tpu_torch.cases import shell3x3, shell7x5, vandevusse, woodberry
from mpc_tuning_tpu_torch.ops.kernels import factor_envelope
from mpc_tuning_tpu_torch.sim.mpc_loop import horizon_caps
from mpc_tuning_tpu_torch.tuning.api import build_problem

# W matrices per block times n rows at stride n | 1: 8 x 4 bytes at
# float32 and 4 x 8 bytes at float64, so both dtypes need the same bytes
SMEM = {5: 800, 17: 9248, 31: 30752, 46: 69184, 64: 133120}


@pytest.mark.parametrize("dtype,per_block", [(torch.float32, 8),
                                             (torch.float64, 4)])
@pytest.mark.parametrize("n", sorted(SMEM))
def test_factor_envelope_arithmetic(n, dtype, per_block):
    assert factor_envelope(n, dtype) == (per_block, SMEM[n])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_factor_envelope_first_refused_n(dtype):
    """n = 64 is the largest n, two rows a lane (133,120 bytes, under the
    227 KB a block may hold); n = 65, which would need a third, is
    refused, as are n < 1 and dtypes without a kernel."""
    assert factor_envelope(64, dtype)[1] == 133120
    for n in (65, 85, 96, 0):
        with pytest.raises(ValueError, match="SPD factor kernels"):
            factor_envelope(n, dtype)
    with pytest.raises(ValueError, match="float32 or float64"):
        factor_envelope(5, torch.float16)


def _tune_sizes(mod):
    """(p_max, m_max, nu) of a case's full-width problem."""
    if mod is vandevusse:
        s = vandevusse.build_problem(vandevusse.make_case(),
                                     device="cpu").loop.spec
        return s.p_max, s.m_max, s.nu
    problem, _ = build_problem(mod.make_case(), dtype=torch.float64,
                               device="cpu")
    d = problem.loop.dims
    return d["p_max"], d["m_max"], d["nu"]


@pytest.mark.parametrize("mod", [woodberry, shell7x5, shell3x3, vandevusse],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_every_tune_factor_fits(mod):
    """Every capacity bucket a tune can reach (every Nu up to m_max) gives
    QPs of n = m_cap nu + 1 variables (NMPC: the same count); each fits at
    both dtypes, up to Shell's n = 46."""
    p_max, m_max, nu = _tune_sizes(mod)
    ns = {horizon_caps(p_max, m_max, np.array([p_max]),
                       np.array([m]))[1] * nu + 1
          for m in range(1, m_max + 1)}
    assert max(ns) == m_max * nu + 1 and max(ns) <= 46
    for n in sorted(ns):
        for dtype in (torch.float32, torch.float64):
            factor_envelope(n, dtype)  # raises outside the envelope
