"""Which arithmetic of the band kernel moves it off the plain version: the
kernel and variants of its source, each a patched copy built beside the
port's library, held like ``chip_smoke.py`` phase 2b (B = 256, nit 200,
the plain version following the kernel's U, ``tools/band_spread``'s
statistics and the live witness along each variant's own U) at the
buckets ``--caps``, on one card.

    mkdir -p .chip_archive/blocked
    git archive a8b2c30 mpc_tuning_tpu_torch/ops/csrc \\
        | tar -x -C .chip_archive/blocked
    PYTHONPATH=.:scripts python scripts/band_accuracy_variants.py \\
        --src .chip_archive/blocked/mpc_tuning_tpu_torch/ops/csrc \\
        [--caps 32,4 127,15] [--variants kernel factor] [--out FILE]

The patches apply to the thread-block-cluster kernel as first written,
with the 8-row blocked substitutions (the commit "Redesign the band
whole-sim kernel as a thread-block cluster per candidate"), and the
script drives that kernel's launcher (ops/kernels.launch_band,
_build.bind_band): run it from a checkout of that commit with this
tree's tools/band_spread.py and ops/band_cert.py.

Variants, each adding to the one before: ``solve`` the substitutions of
warp_qp.cuh (a division a step, one row a step) in place of the 8-row
blocks; ``factor`` warp_factor's sqrt and divisions in place of rsqrt;
``ratio`` each row's ratio divided out and taken by nmin, as the plain
version does, in place of the cross-multiplied minimum; ``mu_aff`` the
affine mu summed row by row after the step is known (one more cluster
reduction) in place of gap + a S1 + a^2 S2.  Prints per variant and
bucket the lane quantiles against the live limits and the lanes over
them.  Needs one card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import shutil
import subprocess

import torch

from mpc_tuning_tpu_torch.cases import shell7x5
from mpc_tuning_tpu_torch.ops import _build
from mpc_tuning_tpu_torch.ops import kernels as K
from mpc_tuning_tpu_torch.tools.band_spread import (band_gate, band_inputs,
                                                    band_lane_errors,
                                                    band_witness)
from mpc_tuning_tpu_torch.tuning.api import build_problem

OUT = pathlib.Path(_build.__file__).resolve().parent.parent / "_build" / \
    "variants"

SOLVE = ((r"warp_solve_blocked<T, R>\(c\.L, c\.dinv, c\.ldn, n, x, ln\);",
          "warp_chol_solve<T, R>(c.L, c.ldn, n, x, ln);", 2),)
FACTOR = ((r"warp_factor<T, R, true>\(c\.L, n, c\.ldn, ln, c\.ri\);",
           "warp_factor<T, R>(c.L, n, c.ldn, ln);", 1),
          (r"(        __syncwarp\(\);\n        diag_block_inverses)",
           r"        for (int i = ln; i < n; i += 32) c.ri[i] = T(1) / "
           r"c.L[i * c.ldn + i];\n\1", 1))
RATIO = ((r"    if \(a \* den < num \* b\) \{\n      num = a;\n      den = b;\n"
          r"    \}\n", "    num = nmin(num, a / b);\n", 1),)
MU_AFF = ((r"    const T mu_aff = \(gap \+ a_aff \* S1 \+ a_aff \* a_aff \* S2\) "
           r"/ c\.nact;\n",
           "    T ma = T(0);\n"
           "    for (int k = threadIdx.x; k < c.kb; k += kBandThreads)\n"
           "      for (int h = 0; h < 2; ++h)\n"
           "        ma += (c.at(RS_LAM + h, k) + a_aff * c.at(RS_DL + h, k)) *\n"
           "              (c.at(RS_S + h, k) + a_aff * c.at(RS_DS + h, k));\n"
           "    T ma_all, unused2;\n"
           "    cluster_step<T, true>(c, T(0), ma, T(0), ma_all, unused2);\n"
           "    const T mu_aff = ma_all / c.nact;\n", 1),)
VARIANTS = (("kernel", ()), ("solve", SOLVE), ("factor", SOLVE + FACTOR),
            ("ratio", SOLVE + FACTOR + RATIO),
            ("mu_aff", SOLVE + FACTOR + RATIO + MU_AFF))


def build(name, patches, src):
    out = OUT / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(src, out)
    cu = out / "closed_sim_band.cu"
    src = cu.read_text()
    for pat, rep, count in patches:
        src, k = re.subn(pat, rep, src)
        if k != count:
            raise RuntimeError(f"{name}: {pat!r} {k} matches, expected {count}")
    cu.write_text(src)
    so = out / "libvariant.so"
    cmd = [_build._nvcc(), *_build._NVCC_FLAGS, "-shared", "-o", str(so),
           str(cu)]
    return so, subprocess.Popen(cmd)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, type=pathlib.Path,
                    help="ops/csrc of the blocked-solve kernel")
    ap.add_argument("--caps", nargs="+", default=["32,4", "127,15"])
    ap.add_argument("--variants", nargs="+",
                    default=[name for name, _ in VARIANTS])
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args()
    caps_list = [tuple(int(v) for v in c.split(",")) for c in args.caps]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    builds = [(name, *build(name, p, args.src)) for name, p in VARIANTS
              if name in args.variants]
    libs = {}
    for name, so, proc in builds:
        if proc.wait():
            raise RuntimeError(f"{name}: nvcc failed")
        libs[name] = _build.bind_band(ctypes.CDLL(str(so)))
    problem, _ = build_problem(shell7x5.make_case(), device="cuda")
    rows = []
    for caps in caps_list:
        (t, lc, Hp, r_l, dims), _, _ = band_inputs(
            problem, caps, 256, 200, torch.float64, caps[0])
        args_k = (t, lc, Hp, r_l, 200, 20, 12, dims)
        for name, lib in libs.items():
            out = K.launch_band(lib, *args_k)
            plain = K.closed_sim_band_plain(*args_k, u_follow=out[1])
            witness = band_witness(args_k[:-1], dict(dims=dims), out[1],
                                   plain)
            ok, txt, over = band_gate(band_lane_errors(out, plain), witness,
                                      caps)
            rows.append(dict(variant=name, caps=caps, ok=ok, over=over,
                             text=txt))
            print(json.dumps(rows[-1]), flush=True)
    if args.out:
        args.out.write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
