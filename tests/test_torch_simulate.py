"""The port's state-space rollout ``models/simulate.dlsim_torch`` against the
JAX package's ``dlsim_jax`` and the NumPy ``dlsim`` at float64 on the CPU
(Shell3x3 at Ts = 4, as tests/test_lti.py holds the JAX one)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tuning_tpu.models import plants as plants_jax
from mpc_tuning_tpu.models import simulate as sim_jax
from mpc_tuning_tpu_torch.models import simulate as sim_torch


@pytest.mark.parametrize("T,with_x0", [(50, False), (50, True), (1, True)])
def test_dlsim_torch_matches_jax(T, with_x0):
    ss = plants_jax.shell3x3().G.c2d(4.0).to_ss()
    rng = np.random.default_rng(T)
    U = rng.standard_normal((T, 3))
    x0 = rng.standard_normal(ss.nx) if with_x0 else None
    A, B, C, D = (np.asarray(m) for m in (ss.A, ss.B, ss.C, ss.D))
    Yj, xj = sim_jax.dlsim_jax(*(jnp.asarray(m) for m in (A, B, C, D, U)),
                               None if x0 is None else jnp.asarray(x0))
    Yt, xt = sim_torch.dlsim_torch(
        *(torch.tensor(m) for m in (A, B, C, D, U)),
        None if x0 is None else torch.tensor(x0))
    assert Yt.dtype == torch.float64 and Yt.shape == (T, 3)
    np.testing.assert_allclose(Yt.numpy(), np.asarray(Yj), rtol=0, atol=1e-9)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-9)
    if x0 is None:
        np.testing.assert_allclose(Yt.numpy(), sim_torch.dlsim(ss, U),
                                   rtol=0, atol=1e-9)
