"""The port's Van de Vusse NMPC demo (the reference's fixed tuning)
against the JAX package's at float64 on the CPU, nit 30: Y and U at 1e-9
(the port's plain NMPC loop costs ~4 s a step on the CPU, so this file
runs alone beside tests/test_torch_demos.py)."""

import numpy as np
import torch

from mpc_tuning_tpu.cases import demos as demos_jax
from mpc_tuning_tpu_torch.cases import demos as demos_torch

torch.set_num_threads(1)  # B = 1: threads only contend with other workers


def test_vandevusse_demo_matches_jax():
    case, t, (y, u) = demos_torch.vandevusse_demo(nit=30, device="cpu")
    _, t_j, (y_j, u_j) = demos_jax.vandevusse_demo(nit=30)
    assert t["N"] == t_j["N"] and np.array_equal(t["Nu"], t_j["Nu"])
    assert y.shape == (30, 2) and u.shape == (30, 2)
    np.testing.assert_allclose(y, np.asarray(y_j), rtol=0, atol=1e-9)
    np.testing.assert_allclose(u, np.asarray(u_j), rtol=0, atol=1e-9)
