"""The port's profiling helpers on the CPU: the stopwatch, the rate of a
function (host clock for CPU results) and the torch.profiler trace."""

import json
import os
import time

import torch

from mpc_tuning_tpu_torch.utils.profiling import Stopwatch, rate_of, trace


def test_stopwatch_measures_the_host_clock():
    sw = Stopwatch().tic()
    time.sleep(0.02)
    x = torch.ones(4)
    dt = sw.toc(sync_on=(x, {"y": [x]}))
    assert 0.02 <= dt < 5.0
    assert sw.toc() >= dt


def test_rate_of_counts_items_per_second():
    calls = []

    def fn(a, b):
        calls.append(1)
        time.sleep(0.01)
        return a @ b, {"n": len(calls)}

    a = torch.randn(8, 8, dtype=torch.float64)
    rate, dt = rate_of(fn, a, a, reps=4, items=10)
    assert len(calls) == 5  # one warm-up call, then the timed ones
    assert 0.01 <= dt < 5.0
    assert abs(rate * dt - 10) < 1e-9


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert prof is not None
    with open(os.path.join(logdir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_rate_of_without_warm_up():
    calls = []

    def fn():
        calls.append(1)
        time.sleep(0.01)
        return torch.zeros(2)

    rate, dt = rate_of(fn, reps=2, items=3, warmup=False)
    assert len(calls) == 2
    assert 0.01 <= dt < 5.0 and abs(rate * dt - 3) < 1e-9
