"""Controller math: conditioning, observer, the condensed MPC QP, the
batched QP solvers and the hand-written CUDA kernels."""
