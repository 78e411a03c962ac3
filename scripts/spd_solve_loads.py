"""spd_solve's tile load (``ops/csrc/spd.cu`` spd_solve_kernel): the whole
matrix (``load_rows``, the shipped design) against M's lower triangle only
(``load_lower``, as spd_factor_solve loads L), on one card, in one
process.

    PYTHONPATH=. python scripts/spd_solve_loads.py [--turns 4]

Builds a second kernel library from a copy of ``ops/csrc`` whose
spd_solve_kernel calls load_lower in place of load_rows, checks that both
give x bit for bit on the same systems, then times ``mpc_spd_solve`` of
each at f32 B=1024 n=17 and f64 B=1024 n=31 in turns (whole, lower,
lower, whole, ...): CUDA-event ms per call (20 calls after a warm-up,
``chip_smoke.timed``) and device ms per call (``chip_smoke.device_ms``).
Prints the card, one line per turn and the medians.  Needs one card and
nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import statistics
import subprocess
import tempfile
from pathlib import Path

import torch

import chip_smoke as cs
from mpc_tuning_tpu_torch.ops import _build

WHOLE = "  load_rows(M + (size_t)b0 * nn, tiles, nb * nn, n, ld);"
LOWER = "  load_lower(M + (size_t)b0 * nn, tiles, nb * nn, n, ld);"
SHAPES = ((torch.float32, 17), (torch.float64, 31))


def lower_load_library():
    """The kernel library with spd_solve_kernel loading the lower triangle
    only."""
    _build._BUILD.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=_build._BUILD))
    for p in _build._CSRC.iterdir():
        if p.is_file():
            shutil.copy(p, tmp / p.name)
    spd = tmp / "spd.cu"
    text = spd.read_text()
    if text.count(WHOLE) != 1:
        raise SystemExit("spd.cu: spd_solve_kernel's load_rows call not "
                         "found once")
    spd.write_text(text.replace(WHOLE, LOWER))
    so = tmp / "libmpc_kernels_lower_load.so"
    _build._compile(sorted(tmp.glob("*.cu")), so)
    return _build._bind(ctypes.CDLL(str(so)))


def solver(lib, M, rhs):
    stream = torch.cuda.current_stream().cuda_stream
    f64 = int(M.dtype == torch.float64)
    B, n = rhs.shape

    def call():
        x = torch.empty_like(rhs)
        _build.check(lib.mpc_spd_solve(f64, M.data_ptr(), rhs.data_ptr(),
                                       x.data_ptr(), B, n, stream),
                     "spd_solve")
        return x
    return call


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--turns", type=int, default=4)
    turns = ap.parse_args().turns
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = {"whole": _build.library(), "lower": lower_load_library()}
    for dtype, n in SHAPES:
        M, rhs = cs.spd_batch(1024, n, dtype, seed=0)
        calls = {k: solver(lib, M, rhs) for k, lib in libs.items()}
        x = {k: fn() for k, fn in calls.items()}
        same = torch.equal(x["whole"].view(torch.int8),
                           x["lower"].view(torch.int8))
        tag = f"{str(dtype).removeprefix('torch.')} B=1024 n={n}"
        print(f"{tag}: x bit for bit whole vs lower: {same}", flush=True)
        if not same:
            raise SystemExit(f"{tag}: the two loads disagree")
        res = {k: {"ms": [], "device_ms": []} for k in calls}
        order = ("whole", "lower")
        for t in range(turns):
            for k in order if t % 2 == 0 else order[::-1]:
                ms = cs.timed(calls[k], 20)[0]
                dev = cs.device_ms(calls[k])
                res[k]["ms"].append(ms)
                res[k]["device_ms"].append(dev)
                print(f"{tag} turn {t} {k}: event {ms:.5f} ms, device "
                      f"{cs.fmt_ms(dev)} ms", flush=True)
        for k, r in res.items():
            devs = [d for d in r["device_ms"] if d is not None]
            print(f"{tag} {k}: median event {statistics.median(r['ms']):.5f}"
                  f" ms, median device "
                  f"{statistics.median(devs) if devs else float('nan'):.5f}"
                  f" ms over {turns} turns", flush=True)


if __name__ == "__main__":
    main()
