"""The port's cross-evaluation of the Van de Vusse NMPC problem against the
JAX package's at float64 on the CPU (the linear problems:
tests/test_torch_cross_eval.py): both tuner objectives at the reference's
and the repo's tuned points, the steps cut to 12 (the Cb setpoint step at
step 9; the port's plain NMPC loop costs seconds a step on the CPU)."""

import pytest
import torch

from test_torch_cross_eval import eval_point_both

torch.set_num_threads(1)  # B <= 2: threads only contend with other workers


@pytest.mark.parametrize("point", ["ref", "repo"])
def test_eval_point_matches_jax(point):
    eval_point_both("VanDeVusse_NMPC", point)
