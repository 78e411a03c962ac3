"""mpc_tuning_tpu_torch — the PyTorch/CUDA port of the JAX package
``mpc_tuning_tpu``.

Hybrid MPC auto-tuning (GAM <-> VNS) for linear plants and for nonlinear
plants under NMPC, with the candidate
batch as an explicit tensor axis and the hot loops in hand-written CUDA
kernels for Hopper (ops/csrc/, built at first use).  Host setup stays
float64 NumPy/SciPy, as in the JAX package.

Layer map (mirrors the JAX package):
  models/   plant & model representation (LTI; ODE models, integrators)
  ops/      controller math (conditioning, observer, QP, kernels)
  sim/      closed-loop and open-loop evaluators (MPC, NMPC)
  tuning/   hybrid GAM <-> VNS auto-tuning
  cases/    benchmark case studies (Wood-Berry, Shell3x3, Shell7x5,
            Van de Vusse)
  utils/    checkpointing
  convert   state carried over from the JAX package
"""

__version__ = "0.1.0"
