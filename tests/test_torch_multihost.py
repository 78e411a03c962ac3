"""The port's multi-process candidate sharding (``parallel/multihost.py``)
on the CPU: two gloo processes, two CPU shards each, against a local
address, in both self-test modes at the JAX package's toy sizes — the
sharded sweep and its argmin reduction (``_selftest_worker``: the result
equals the grid evaluated whole), and one tuner alternation sharded
against unsharded (``_alternation_worker``: identical decisions, F
within 1e-12 at float64).  Each run has a timeout of its own."""

import numpy as np
import pytest
import torch

from mpc_tuning_tpu_torch.parallel import sweep
from mpc_tuning_tpu_torch.parallel.multihost import (
    _free_port, host_mesh, initialize, multihost_candidate_argmin,
    run_two_process_cpu_selftest)


def test_two_process_sweep():
    line = run_two_process_cpu_selftest(nprocs=2, mode="sweep", timeout=240)
    assert line.startswith("MULTIHOST_OK procs=2 devices=4 backend=gloo")
    assert "equals_whole=1" in line


def test_two_process_alternation():
    line = run_two_process_cpu_selftest(nprocs=2, mode="alternation",
                                        timeout=400)
    assert line.startswith("MULTIHOST_TUNE_OK procs=2 devices=4")
    assert "decisions_identical=1" in line


def test_initialize_names_its_backend():
    """The caller names the backend; an unknown one raises before any
    process group forms."""
    with pytest.raises(ValueError, match="backend"):
        initialize("127.0.0.1:1", 1, 0, "mpi")


def test_one_process_group_reduces_through_the_group(monkeypatch):
    """A mesh of a process group reduces through the group at one process
    too: ``multihost_candidate_argmin`` runs the all-reduce MIN / MAX pair
    (``sweep._reduce_min_index``) and the gather, as a larger group's
    ranks do."""
    import torch.distributed as dist

    calls = []
    reduce = sweep._reduce_min_index
    monkeypatch.setattr(sweep, "_reduce_min_index",
                        lambda *a: calls.append(a[1:]) or reduce(*a))
    initialize(f"127.0.0.1:{_free_port()}", 1, 0, "gloo")
    try:
        mesh = host_mesh([torch.device("cpu")] * 2)
        F = np.array([3.0, 1.5, 2.0, 1.5, 4.0])
        vmin, gidx = multihost_candidate_argmin(
            mesh, lambda f: f.double(), [F], len(F))
        whole = sweep.replicate_to_host(mesh, [torch.as_tensor(F)])
    finally:
        dist.destroy_process_group()
    assert mesh.distributed and mesh.size == 2
    assert (vmin, gidx) == (1.5, 1) and calls == [(1.5, 1)]
    assert np.array_equal(whole, F)
