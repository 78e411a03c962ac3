"""Candidate sharding for tuning sweeps.

The reference is strictly single-process ('UseParallel', false —
MPCTuning.m:89); the port's parallel axis, as the JAX package's, is the
CANDIDATE batch: every tuning candidate (N, Nu, delta, lambda — and each
per-output selector lane) is an independent closed-loop simulation,
sharded over devices (``sweep.py``) and over processes of a
``torch.distributed`` group (``multihost.py``), each shard on the same
hand-written kernels as an unsharded batch.
"""

from mpc_tuning_tpu_torch.parallel.sweep import (  # noqa: F401
    candidate_mesh,
    shard_candidates,
    sharded_argmin_sweep,
)
