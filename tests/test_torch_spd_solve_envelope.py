"""The batch-major solve ``spd_factor_solve`` at the edges of its
warp-per-system design (``ops/csrc/spd.cu``): its envelope
(``ops/kernels.factor_solve_envelope``, the factors' tiles: systems and
shared memory per block, the first n refused at both dtypes), and its
plain version against the JAX package's ``_solve_batched_impl`` (the
Pallas kernel in interpret mode) at n = 1 (one lane), 32 (one row a lane,
full), 33 (the first with two rows a lane) and 64 (the envelope's edge),
at float64.  The kernel itself is held against the plain version and the
one-thread design it replaced in ``tests/test_torch_gpu.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tuning_tpu.ops.pallas_kernels import _solve_batched_impl
from mpc_tuning_tpu_torch.ops import kernels as K

torch.set_num_threads(1)  # small batches: threads only contend with workers

# W systems per block times n rows at stride n | 1: 8 x 4 bytes at float32
# and 4 x 8 bytes at float64, as the factors' tiles
SMEM = {1: 32, 17: 9248, 32: 33792, 33: 34848, 46: 69184, 64: 133120}


@pytest.mark.parametrize("dtype,per_block", [(torch.float32, 8),
                                             (torch.float64, 4)])
@pytest.mark.parametrize("n", sorted(SMEM))
def test_solve_envelope_arithmetic(n, dtype, per_block):
    assert K.factor_solve_envelope(n, dtype) == (per_block, SMEM[n])
    assert K.factor_solve_envelope(n, dtype) == K.factor_envelope(n, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_solve_envelope_first_refused_n(dtype):
    """n = 64 (two rows a lane) is the largest n the solve takes, as the
    factor; n = 65 is refused with the solve named, as are n < 1 and
    dtypes without a kernel."""
    assert K.factor_solve_envelope(64, dtype)[1] == 133120
    for n in (65, 0):
        with pytest.raises(ValueError, match="spd_factor_solve: n = "):
            K.factor_solve_envelope(n, dtype)
    with pytest.raises(ValueError, match="float32 or float64"):
        K.factor_solve_envelope(5, torch.float16)


def _system(n, B, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n))
    L = np.linalg.cholesky(A @ A.transpose(0, 2, 1) + n * np.eye(n))
    return L, rng.standard_normal((B, n))


@pytest.mark.parametrize("B", [1, 37])
@pytest.mark.parametrize("n", [1, 32, 33, 64])
def test_solve_plain_matches_pallas_at_the_edges(n, B):
    L, rhs = _system(n, B, 100 * n + B)
    xj = np.asarray(_solve_batched_impl(jnp.asarray(L), jnp.asarray(rhs)))
    xt = K.spd_factor_solve(torch.as_tensor(L), torch.as_tensor(rhs))
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", [1, 33])
def test_solve_plain_reads_the_lower_triangle_only(n):
    """The kernel stages only L's lower triangle; the plain version
    likewise gives the same bits with anything above the diagonal."""
    L, rhs = _system(n, 5, n)
    junk = L + np.triu(np.full((n, n), 7.5), 1)
    x = K.spd_factor_solve(torch.as_tensor(L), torch.as_tensor(rhs))
    xj = K.spd_factor_solve(torch.as_tensor(junk), torch.as_tensor(rhs))
    assert torch.equal(x, xj)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_solve_lanes_envelope_names_the_kernel(dtype):
    """The lane-major solve_lanes runs the same tiles: it takes n = 64 and
    refuses n = 65 with its own name."""
    assert K.factor_solve_envelope(64, dtype, "solve_lanes") == \
        K.factor_solve_envelope(64, dtype)
    with pytest.raises(ValueError, match="solve_lanes: n = 65"):
        K.factor_solve_envelope(65, dtype, "solve_lanes")
