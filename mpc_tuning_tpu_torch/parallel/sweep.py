"""Sharded candidate sweeps over an ordered list of devices (the port of the
JAX package's ``parallel/sweep.py``).

The data-parallel axis is the tuning candidate: every candidate (and every
per-output selector lane) is an independent closed-loop simulation.  A
``CandidateMesh`` is the ordered list of devices its shards run on; a
device may repeat (two shards on one card, or eight on the CPU).  A batch
is padded to a multiple of the mesh size by repeating its last candidate,
split into equal contiguous shards along axis 0, each shard evaluated on
its device by the same code (and the same kernels) as an unsharded batch,
and the outputs gathered back in order.  Shards on one card run one after
another on that card's current stream; shards on different cards are all
launched before any result is read back.

Across processes (``parallel/multihost.py``) the mesh also names its
``torch.distributed`` group: each process evaluates only its own shards,
and the gather is an all-gather of equal-sized padded tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpc_tuning_tpu_torch.ops.kernels import require_device

__all__ = ["CandidateMesh", "candidate_mesh", "shard_candidates",
           "replicate_to_host", "sharded_argmin_sweep",
           "global_argmin_shard_map", "pad_to_multiple", "map_shards"]


@dataclasses.dataclass(frozen=True)
class CandidateMesh:
    """The shards of a candidate axis: ``devices`` are this process's
    shards in order; across ``process_count`` processes (a
    ``torch.distributed`` group, ``group`` None for the default one) the
    global shard ``process_index * len(devices) + j`` is this process's
    j-th.  ``distributed`` marks a mesh of a process group
    (``multihost.host_mesh``): its gathers and reductions run through the
    group, at one process too."""

    devices: tuple
    process_count: int = 1
    process_index: int = 0
    group: object = None
    distributed: bool = False

    @property
    def size(self) -> int:
        """Number of shards over all processes."""
        return len(self.devices) * self.process_count

    @property
    def first_shard(self) -> int:
        return self.process_index * len(self.devices)

    def describe(self) -> str:
        kinds = sorted({d.type for d in self.devices})
        procs = (f" x {self.process_count} processes"
                 if self.process_count > 1 else "")
        return f"{len(self.devices)} x {'/'.join(kinds)}{procs}"


def _device(d) -> torch.device:
    dev = require_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def candidate_mesh(devices=None) -> CandidateMesh:
    """A one-process mesh over ``devices`` (torch devices or their names;
    a device may repeat), by default every visible card.  Raises when the
    default is asked for on a host without a card."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("candidate_mesh(): no CUDA card is visible; "
                               "name the devices, e.g. [torch.device('cpu')]"
                               " * 4")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = tuple(_device(d) for d in devices)
    if not devs:
        raise ValueError("candidate_mesh: no devices")
    return CandidateMesh(devs)


def pad_to_multiple(arr, k: int, axis: int = 0):
    """Pad ``axis`` to a multiple of k by repeating the last element;
    returns (padded, original length)."""
    arr = np.asarray(arr)
    n = arr.shape[axis]
    pad = (-n) % k
    if pad == 0:
        return arr, n
    last = np.take(arr, [-1], axis=axis)
    reps = [1] * arr.ndim
    reps[axis] = pad
    return np.concatenate([arr, np.tile(last, reps)], axis=axis), n


def _local_slices(mesh: CandidateMesh, *arrays):
    """Pad every array's axis 0 to a multiple of the mesh size; returns
    (B, [(device, [slice of each array]) for this process's shards])."""
    padded, B = [], None
    for a in arrays:
        p, n = pad_to_multiple(a, mesh.size)
        if B is not None and n != B:
            raise ValueError(f"batched arrays of {B} and {n} candidates")
        padded.append(p)
        B = n
    per = padded[0].shape[0] // mesh.size
    out = []
    for j, dev in enumerate(mesh.devices):
        lo = (mesh.first_shard + j) * per
        out.append((dev, [p[lo:lo + per] for p in padded]))
    return B, out


def shard_candidates(mesh: CandidateMesh, *arrays):
    """Each array (already padded to a multiple of the mesh size) split
    into this process's equal contiguous shards along axis 0, each a
    tensor on its device; returns one list of shards per array."""
    for a in arrays:
        if np.shape(a)[0] % mesh.size:
            raise ValueError(f"axis 0 of {np.shape(a)} is not a multiple of "
                             f"the mesh size {mesh.size}: pad_to_multiple")
    _, shards = _local_slices(mesh, *arrays)
    return tuple([torch.as_tensor(np.ascontiguousarray(s[i]), device=dev)
                  for dev, s in shards] for i in range(len(arrays)))


def _all_gather(mesh: CandidateMesh, local: torch.Tensor) -> torch.Tensor:
    """This process's concatenated shards -> every process's, in shard
    order (equal-sized tensors: the batch is padded)."""
    if not mesh.distributed:
        return local
    import torch.distributed as dist

    if dist.get_backend(mesh.group) == "nccl":
        local = local.to(torch.device("cuda", torch.cuda.current_device()))
    parts = [torch.empty_like(local) for _ in range(mesh.process_count)]
    dist.all_gather(parts, local.contiguous(), group=mesh.group)
    return torch.cat(parts).cpu()


def replicate_to_host(mesh: CandidateMesh, shards) -> np.ndarray:
    """The shards of one array (this process's, in order) concatenated on
    the host and gathered from every process: the whole padded array as
    NumPy, the same on every process."""
    local = torch.cat([torch.as_tensor(s).cpu() for s in shards])
    return _all_gather(mesh, local).numpy()


def map_shards(mesh: CandidateMesh, fn, *arrays):
    """Evaluate ``fn(device, *shard_arrays) -> tuple of tensors`` (each
    with the shard's candidates first) on every shard of the padded
    batch, launching every shard before reading any back; returns each
    output gathered over all shards as a CPU tensor cut to the batch's
    candidates."""
    B, shards = _local_slices(mesh, *arrays)
    outs = [fn(dev, *s) for dev, s in shards]
    return tuple(
        torch.from_numpy(replicate_to_host(mesh, [o[i] for o in outs])[:B])
        for i in range(len(outs[0])))


def sharded_argmin_sweep(mesh: CandidateMesh, eval_fn, F_args, B_true: int):
    """Evaluate F = eval_fn(*shard_args) (one (B_shard,) tensor a shard)
    on the shards ``shard_candidates`` made, mask padded lanes to +inf and
    reduce to the argmin (ties to the lowest global index).  Returns
    (F[:B_true], argmin, min)."""
    Fs = [eval_fn(*args) for args in zip(*F_args)]
    F = replicate_to_host(mesh, Fs).astype(np.float64)
    F[B_true:] = np.inf
    best = int(np.argmin(F))  # the lowest index of the minimum
    return F[:B_true], best, float(F[best])


def global_argmin_shard_map(mesh: CandidateMesh, F_local_fn, args,
                            B_true: int):
    """The incumbent by a reduction over shards: each shard evaluates its
    local objectives ``F_local_fn(*shard_args)`` and keeps its own minimum
    and argmin; the global minimum is the smallest of the shards' minima,
    its index the lowest global index holding it (padded lanes at +inf).
    ``args`` are global arrays, padded here.  Returns (min, argmin)."""
    padded = [pad_to_multiple(a, mesh.size)[0] for a in args]
    shards = shard_candidates(mesh, *padded)
    per = padded[0].shape[0] // mesh.size
    best = (np.inf, -1)
    for j, local in enumerate(zip(*shards)):
        F = torch.as_tensor(F_local_fn(*local)).double().cpu().numpy().copy()
        gi = (mesh.first_shard + j) * per + np.arange(F.shape[0])
        F[gi >= B_true] = np.inf
        li = int(np.argmin(F))
        best = min(best, (float(F[li]), int(gi[li])))
    if mesh.distributed:
        return _reduce_min_index(mesh, *best)
    return best


def _reduce_min_index(mesh: CandidateMesh, val: float, idx: int):
    """All-reduce MIN of the value, then MAX of the negated global index
    of the processes holding it: (min, its lowest index) on every
    process."""
    import torch.distributed as dist

    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(mesh.group) == "nccl" else torch.device("cpu"))
    v = torch.tensor([val], dtype=torch.float64, device=dev)
    dist.all_reduce(v, op=dist.ReduceOp.MIN, group=mesh.group)
    vmin = float(v.item())
    w = torch.tensor([-idx if val == vmin else -(1 << 62)],
                     dtype=torch.int64, device=dev)
    dist.all_reduce(w, op=dist.ReduceOp.MAX, group=mesh.group)
    return vmin, int(-w.item())
