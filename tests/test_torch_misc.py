"""The port's ops/misc helpers against the JAX package's on seeded inputs:
equal results, exactly."""

import numpy as np
import pytest

from mpc_tuning_tpu.ops import misc as misc_jax
from mpc_tuning_tpu_torch.ops import misc as misc_torch


def _horizons():
    rng = np.random.default_rng(0)
    cases = [(rng.integers(0, 40, size=rng.integers(1, 4)),
              rng.integers(0, 16, size=rng.integers(1, 4))) for _ in range(40)]
    return cases + [(5, 4), (4, 4), ([7, 0], [2]), (9, [0, 3])]


def test_precon():
    for N, Nu in _horizons():
        assert misc_torch.precon(N, Nu) == misc_jax.precon(N, Nu), (N, Nu)


@pytest.mark.parametrize("name", ["nml", "dnml"])
def test_min_max_normalisation(name):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(7, 5))
    lo, hi = rng.uniform(-3, 0, size=5), rng.uniform(1, 4, size=5)
    for args in ((x, lo, hi), (x[0], -2.0, 3.0), (list(x[1]), lo, hi)):
        a = getattr(misc_torch, name)(*args)
        b = getattr(misc_jax, name)(*args)
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", ["col2row", "row2col"])
def test_orientation(name):
    rng = np.random.default_rng(2)
    for shape in ((6,), (6, 1), (1, 6), (3, 5), (5, 3), (4, 4)):
        x = rng.normal(size=shape)
        a = getattr(misc_torch, name)(x)
        b = getattr(misc_jax, name)(x)
        assert a.shape == b.shape and np.array_equal(a, b), shape
