"""The rollout kernel ``ops/csrc/nmpc.cu`` beside the thread-per-column
design it replaced (``ops/csrc/reference/nmpc_rollout_thread_per_column.cu``):
registers and agreement.  Their times are ``chip_smoke.py`` phase 4's
(``timings`` in its kernels line).

    PYTHONPATH=. python scripts/nmpc_rollout_old_vs_new.py

Prints the card, each design's registers and spills (``-Xptxas -v``), then
for each stepper (RK4, TR-BDF2) at float64, caps (31, 15) and (16, 2),
B = 64, the largest relative difference of each design's Y and J from the
plain version, of the plant step and of the held playback, and the
largest relative difference of the new design from the old with J and
without, with whether Y and J are the same bits.  Needs one card and nvcc.
"""

from __future__ import annotations

import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from mpc_tuning_tpu_torch.cases import vandevusse
from mpc_tuning_tpu_torch.models import ode
from mpc_tuning_tpu_torch.ops import _build
from mpc_tuning_tpu_torch.ops import kernels as K

SHAPES = ((31, 15), (16, 2))
B = 64


def ptxas_lines(text):
    """'Used N registers' lines, each after its kernel's 'Compiling entry'
    line."""
    out, name = [], None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif ("Used" in line or "spill" in line) and name:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def registers(src, out_dir):
    cmd = [_build._nvcc(), *_build._NVCC_FLAGS, "-Xptxas", "-v", "-c",
           "-o", str(Path(out_dir) / (src.stem + ".o")), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    return ptxas_lines(res.stderr)


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for name, src in (("new", _build._CSRC / "nmpc.cu"),
                          ("old", _build._CSRC / "reference"
                           / "nmpc_rollout_thread_per_column.cu")):
            print(f"{name}: " + " | ".join(registers(src, tmp)), flush=True)
    designs = {"new": K.nmpc_rollout,
               "old": K.nmpc_rollout_thread_per_column}

    for integrator in ("rk4", "tr_bdf2"):
        spec = vandevusse.make_case(integrator=integrator).spec
        for caps in SHAPES:
            cspec, x, up, du, cm, Nu = cs.vdv_rollout_args(
                spec, caps, B, torch.float64, 0)
            p = caps[0]
            Yp, Jp = ode.nmpc_rollout_plain(cspec, x, up, du, cm, p,
                                            jac=True)
            none = torch.zeros((B, 0), dtype=x.dtype, device=x.device)
            Sp = ode.nmpc_rollout_plain(cspec, x, up, none, none, 1,
                                        outputs=range(3))[0]
            hold = torch.tensor(np.maximum(Nu - 1, 0), dtype=torch.int32,
                                device=x.device)
            Hp = ode.nmpc_rollout_plain(cspec, x, up, du, cm, 59,
                                        hold=hold)[0]
            out = {}
            for name, fn in designs.items():
                Yk, Jk = fn(cspec, x, up, du, cm, p, jac=True)
                Yn = fn(cspec, x, up, du, cm, p)[0]
                Sk = fn(cspec, x, up, none, none, 1, outputs=range(3))[0]
                Hk = fn(cspec, x, up, du, cm, 59, hold=hold)[0]
                torch.cuda.synchronize()
                out[name] = (Yk, Jk, Yn)
                print(f"{integrator} {caps} {name} vs plain: Y "
                      f"{cs.rel(Yk, Yp):.3e} J {cs.rel(Jk, Jp):.3e} plant "
                      f"step {cs.rel(Sk, Sp):.3e} playback "
                      f"{cs.rel(Hk, Hp):.3e}", flush=True)
            (Yk, Jk, Yn), (Yo, Jo, Yno) = out["new"], out["old"]
            print(f"{integrator} {caps} new vs old: Y {cs.rel(Yk, Yo):.3e} "
                  f"(same bits {torch.equal(Yk, Yo)}) J {cs.rel(Jk, Jo):.3e} "
                  f"(same bits {torch.equal(Jk, Jo)}); without J "
                  f"{cs.rel(Yn, Yno):.3e} (same bits {torch.equal(Yn, Yno)})",
                  flush=True)


if __name__ == "__main__":
    main()
