"""Profiling / observability helpers (the port of the JAX package's
``utils/profiling.py``).

The reference's only instrumentation is wall-clock tic/toc around tuning
calls (WoodBerry.m:155-157) and disp progress lines (SURVEY.md section 5).
Here: solve-rate counters with honest device synchronization (CUDA work
is asynchronous: a host clock read without a sync measures the launch, not
the work), and optional torch.profiler traces.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch

__all__ = ["Stopwatch", "rate_of", "trace"]


def _tensors(out):
    """The tensors of a (nested) tuple / list / dict result, in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return [t for x in out for t in _tensors(x)]
    return []


def _sync(out):
    """Wait for the work behind ``out``'s CUDA tensors."""
    if any(t.is_cuda for t in _tensors(out)):
        torch.cuda.synchronize()


@dataclasses.dataclass
class Stopwatch:
    """tic/toc on the host clock; ``toc(sync_on=x)`` first waits for the
    card's work behind x's CUDA tensors (``torch.cuda.synchronize``)."""

    t0: float = 0.0

    def tic(self):
        self.t0 = time.perf_counter()
        return self

    def toc(self, sync_on=None) -> float:
        if sync_on is not None:
            _sync(sync_on)
        return time.perf_counter() - self.t0


def rate_of(fn, *args, reps: int = 3, items: int = 1, warmup: bool = True):
    """(items / second, seconds per call) of ``fn(*args)``, after one
    warm-up call unless ``warmup`` is False.  A function that returns CUDA
    tensors is timed by CUDA events around its ``reps`` calls (the card's
    time, host work between launches included); one that returns none
    (CPU tensors, NumPy: it has waited for its results) by the host
    clock."""
    if not warmup:  # the host clock around the calls, synced
        sw = Stopwatch().tic()
        for _ in range(reps):
            out = fn(*args)
        dt = sw.toc(sync_on=out) / reps
        return items / dt, dt
    out = fn(*args)
    if any(t.is_cuda for t in _tensors(out)):
        torch.cuda.synchronize()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn(*args)
        stop.record()
        torch.cuda.synchronize()
        dt = start.elapsed_time(stop) / 1e3 / reps
    else:
        sw = Stopwatch().tic()
        for _ in range(reps):
            fn(*args)
        dt = sw.toc() / reps
    return items / dt, dt


@contextlib.contextmanager
def trace(logdir: str = "mpc_tuning_torch_trace"):
    """torch.profiler context over the host and, where a card is present,
    the card; on exit writes a Chrome trace (``<logdir>/trace.json``, view
    in chrome://tracing or Perfetto).  Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
