"""``spd_solve`` (factor and solve in one launch) at the edges of its
warp-per-system design (``ops/csrc/spd.cu``): its envelope
(``ops/kernels.spd_solve_envelope``, the factors' tiles: systems and
shared memory per block, the first n refused at both dtypes), its plain
version as ``spd_factor_solve`` of ``spd_factor`` bit for bit (the kernel
is held to those two kernels' bits on the card, ``tests/test_torch_gpu.py``),
its dependence on M's lower triangle only, and the plain version against the JAX package's ``_spd_solve_batched_impl``
(the Pallas kernel in interpret mode) at n = 1, 32, 33 and 64, float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tuning_tpu.ops.pallas_kernels import _spd_solve_batched_impl
from mpc_tuning_tpu_torch.ops import kernels as K

torch.set_num_threads(1)  # small batches: threads only contend with workers

# W systems per block times n rows at stride n | 1: 8 x 4 bytes at float32
# and 4 x 8 bytes at float64, as the factors' tiles
SMEM = {1: 32, 17: 9248, 32: 33792, 33: 34848, 46: 69184, 64: 133120}
EDGES = [1, 32, 33, 64]


@pytest.mark.parametrize("dtype,per_block", [(torch.float32, 8),
                                             (torch.float64, 4)])
@pytest.mark.parametrize("n", sorted(SMEM))
def test_spd_solve_envelope_arithmetic(n, dtype, per_block):
    assert K.spd_solve_envelope(n, dtype) == (per_block, SMEM[n])
    assert K.spd_solve_envelope(n, dtype) == K.factor_envelope(n, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spd_solve_envelope_first_refused_n(dtype):
    """n = 64 (two rows a lane) is the largest n spd_solve takes, as the
    factor; n = 65 is refused with spd_solve named, as are n < 1 and
    dtypes without a kernel."""
    assert K.spd_solve_envelope(64, dtype)[1] == 133120
    for n in (65, 0):
        with pytest.raises(ValueError, match="spd_solve: n = "):
            K.spd_solve_envelope(n, dtype)
    with pytest.raises(ValueError, match="float32 or float64"):
        K.spd_solve_envelope(5, torch.float16)


def _systems(n, B, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n))
    return (A @ A.transpose(0, 2, 1) + n * np.eye(n),
            rng.standard_normal((B, n)))


@pytest.mark.parametrize("B", [1, 37])
@pytest.mark.parametrize("n", EDGES)
def test_spd_solve_plain_is_factor_then_solve(n, B):
    """The plain version's x is the bits of the factor's and the solve's
    plain versions, one after the other, a failed factor's x all NaN in
    both: the identity the kernel keeps on the card."""
    M, rhs = (torch.as_tensor(a) for a in _systems(n, B, 7 * n + B))
    M[B // 2, n - 1, n - 1] = -1.0
    x = K.spd_solve(M, rhs)
    xs = K.spd_factor_solve(K.spd_factor(M), rhs)
    assert torch.isnan(x[B // 2]).all()
    assert torch.equal(x.view(torch.int64), xs.view(torch.int64))


@pytest.mark.parametrize("n", [1, 33])
def test_spd_solve_plain_reads_the_lower_triangle_only(n):
    """The kernel's x depends on M's lower triangle only (the factor reads
    no other part); the plain version likewise gives the same bits with
    anything above the diagonal."""
    M, rhs = (torch.as_tensor(a) for a in _systems(n, 5, n))
    junk = M + torch.triu(torch.full((n, n), 7.5, dtype=M.dtype), 1)
    assert torch.equal(K.spd_solve(M, rhs), K.spd_solve(junk, rhs))


@pytest.mark.parametrize("B", [1, 37])
@pytest.mark.parametrize("n", EDGES)
def test_spd_solve_plain_matches_pallas_at_the_edges(n, B):
    M, rhs = _systems(n, B, 100 * n + B)
    xj = np.asarray(_spd_solve_batched_impl(jnp.asarray(M), jnp.asarray(rhs)))
    xt = K.spd_solve(torch.as_tensor(M), torch.as_tensor(rhs))
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=1e-12)
