"""Where one launch of the band whole-sim kernel spends its cycles, phase
by phase, on one card: a copy of ops/csrc/closed_sim_band.cu (this tree's
or an earlier one, ``--src``) with clock64() marks patched in, built
beside the port's library.  The shipped source has no switch for this.

    PYTHONPATH=.:scripts python scripts/band_phase_clock.py [--src DIR] \\
        [--nit 40] [--min-cluster C] [--out FILE]

Block 0's thread 0 reads clock64() at each mark (the phases end at a
barrier, so its clock is the block's) and adds the cycles since the last
mark, and the block barriers (__syncthreads; cluster barriers apart)
passed since it, to the phase that just ended.  Shapes: SHAPES (Shell7x5,
float64, lp / s2 iterations 20 / 12, band_spread's seeded candidates).
Printed per shape: CUDA-event ms per launch of the instrumented copy and
of the port's kernel, PDIP iterations, and per phase its cycles per PDIP
iteration (the step-level phases per iteration too), its share and its
barriers per iteration; the marks' own cost is the 'mark' row.  Then a
micro-benchmark of a barrier: cycles per __syncthreads() and per cluster
barrier at cluster sizes 1, 2 and 4 (256 threads a block).  Needs one
card and nvcc.
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

import chip_smoke as cs
from mpc_tuning_tpu_torch.cases import shell7x5
from mpc_tuning_tpu_torch.ops import _build
from mpc_tuning_tpu_torch.ops import kernels as K
from mpc_tuning_tpu_torch.tools.band_spread import band_inputs
from mpc_tuning_tpu_torch.tuning.api import build_problem

SHAPES = (((127, 2), 1), ((127, 15), 8), ((48, 4), 256))
CSRC = pathlib.Path(K.__file__).resolve().parent / "csrc"
OUT = pathlib.Path(_build.__file__).resolve().parent.parent / "_build" / \
    "phase_clock"

HEADER = r"""
__device__ unsigned long long pc_cyc[24];
__device__ unsigned long long pc_bar[24];
__device__ unsigned long long pc_cbar[24];
__device__ unsigned long long pc_iter, pc_bars, pc_cbars, pc_b0, pc_c0;
__device__ long long pc_t0;
#define PC_ON (blockIdx.x == 0 && threadIdx.x == 0)
#define PC_START() do { if (PC_ON) { pc_t0 = clock64(); pc_b0 = pc_bars; \
    pc_c0 = pc_cbars; } } while (0)
#define MARK(k) do { if (PC_ON) { const long long _t = clock64(); \
    pc_cyc[k] += _t - pc_t0; pc_t0 = _t; pc_bar[k] += pc_bars - pc_b0; \
    pc_b0 = pc_bars; pc_cbar[k] += pc_cbars - pc_c0; pc_c0 = pc_cbars; } \
    } while (0)
#define PC_SYNC() do { __syncthreads(); if (PC_ON) ++pc_bars; } while (0)
#define PC_ITER() do { if (PC_ON) ++pc_iter; } while (0)
"""

FOOTER = r"""
extern "C" int pc_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, pc_cyc, sizeof(pc_cyc));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(out + 24, pc_bar, sizeof(pc_bar));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(out + 48, pc_cbar, sizeof(pc_cbar));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(out + 72, pc_iter, sizeof(pc_iter));
  return (int)e;
}
extern "C" int pc_reset() {
  unsigned long long z[24] = {0};
  cudaMemcpyToSymbol(pc_cyc, z, sizeof(z));
  cudaMemcpyToSymbol(pc_bar, z, sizeof(z));
  cudaMemcpyToSymbol(pc_cbar, z, sizeof(z));
  return (int)cudaMemcpyToSymbol(pc_iter, z, sizeof(unsigned long long));
}
"""

# phase names by mark index
OLD_PHASES = {0: "step level (estimator, free response, seeding, freeze)",
              13: "pdip warm start", 1: "residuals (G z, G'lam, merit)",
              2: "best iterate", 3: "normal matrix", 4: "factor",
              5: "G't and rhs", 6: "substitutions", 7: "G dz",
              8: "row updates", 9: "step length", 10: "mu_aff",
              12: "pdip tail (last residuals, best restore)",
              14: "loop top", 15: "mark"}

# the same for the block-cluster design (this tree's source)
NEW_PHASES = {0: OLD_PHASES[0], 13: "pdip warm start",
              1: "row phases (r_p, w, t, ds, dl, updates)",
              3: "cross-row product (normal matrix, G'lam, G't)",
              16: "cross-row product (corrector G't)",
              17: "cluster barriers after the products",
              18: "combine over the cluster (normal matrix, G'y)",
              4: "warp 0 section's end (the other warps' wait)",
              6: "corrector warp 0 section's end",
              9: "step-length reductions (with their cluster barriers)",
              12: OLD_PHASES[12], 14: "loop top", 15: "mark",
              19: "warp 0: r_d and merit", 20: "warp 0: factor",
              21: "warp 0: predictor solve", 22: "warp 0: corrector combine",
              23: "warp 0: corrector solve"}


def _after(anchor, mark, count=1):
    return (f"({re.escape(anchor)})", r"\1" + mark, count)


def _before(anchor, mark, count=1):
    return (f"({re.escape(anchor)})", mark + r"\1", count)


NEW_PATCHES = (
    (r"__syncthreads\(\);", "PC_SYNC();", None),
    (r"cg::this_cluster\(\)\.sync\(\);",
     "{ cg::this_cluster().sync(); if (PC_ON) ++pc_cbars; }", 1),
    _after("  Band<T> c(a);\n", "  PC_START();\n"),
    _after("__device__ void pdip(Band<T>& c, bool diag_h, const T* colm, "
           "int iters) {\n", "  MARK(0);\n"),
    _before("  T bm = inf_value<T>();  // warp 0's\n", "  MARK(13);\n"),
    _after("  for (int it = 0; it <= iters; ++it) {\n",
           "    if (it < iters) PC_ITER();\n    MARK(14); MARK(15);\n"),
    _before("      const int idx[5] = {SC_WSS,", "      MARK(1);\n"),
    _after("      cross_rows(c, last ? t_e : 0, t_end);\n", "      MARK(3);\n"),
    _after("    c.sync_cluster();\n    const int t0 = last ? t_e : 0;\n",
           "    MARK(17);\n"),
    _after("    PC_SYNC();\n    const T gap = c.xsc[7];\n", "    MARK(18);\n"),
    _before("    if (last) break;\n", "    MARK(4);\n"),
    _before("    T S1, S2;\n", "    MARK(1);\n"),
    _after("    T mn = cluster_step<T, true>(c, mr.value(), s1, s2, S1, S2);\n",
           "    MARK(9);\n"),
    _before("      const int idx[1] = {SC_ST};\n", "      MARK(1);\n"),
    _after("      cross_rows(c, t_e, t_end);\n    }\n    c.sync_cluster();\n",
           "    MARK(17);\n"),
    _after("      cross_rows(c, t_e, t_end);\n", "      MARK(16);\n"),
    _after("    PC_SYNC();\n    MinRatio<T> mr2;\n", "    MARK(6);\n"),
    _before("    T unused;\n", "    MARK(1);\n"),
    _after("    mn = cluster_step<T, false>(c, mr2.value(), T(0), T(0), "
           "unused, unused);\n", "    MARK(9);\n"),
    _before("  }\n  // the best iterate, if the last", "    MARK(1);\n"),
    _after("      const bool take = m < bm;  // NaN never wins\n",
           "      MARK(19);\n"),
    _after("        warp_factor<T, R, true>(c.L, n, c.ldn, ln);\n",
           "        MARK(20);\n"),
    _after("        warp_chol_solve<T, R>(c.L, c.ldn, n, x, ln);\n",
           "        MARK(21);\n"),
    _before("\n      warp_chol_solve<T, R>(c.L, c.ldn, n, x, ln);\n",
            " MARK(22);"),
    _after("\n      warp_chol_solve<T, R>(c.L, c.ldn, n, x, ln);\n",
           "      MARK(23);\n"),
    (r"(  PC_SYNC\(\);\n)(\}\n\n// The block's K-rows)", r"\1  MARK(12);\n\2",
     1),
)

# (pattern, replacement, expected count) on the old source
OLD_PATCHES = (
    (r"__syncthreads\(\);", "PC_SYNC();", None),
    (r"(  Band<T> c\(a\);\n)", r"\1  PC_START();\n", 1),
    (r"(__device__ void pdip\(Band<T>& c, bool diag_h, const T\* colm, "
     r"int iters\) \{\n)", r"\1  MARK(0);\n", 1),
    (r"(  T bm = inf_value<T>\(\);\n  for \(int it = 0; it < iters; \+\+it\) "
     r"\{\n)", r"  MARK(13);\n\1    PC_ITER(); MARK(14); MARK(15);\n", 1),
    (r"(    const T mnew = residuals\(c, diag_h, colm, gap, true\);\n)",
     r"\1    MARK(1);\n", 1),
    (r"(    normal_matrix\(c, diag_h, colm\);\n)",
     r"    MARK(2);\n\1    MARK(3);\n", 1),
    (r"(    factor\(c\);\n    PC_SYNC\(\);\n)", r"\1    MARK(4);\n", 1),
    (r"(    c.rhs\[i\] = -c.rd\[i\] \+ c.rhs\[i\];\n  PC_SYNC\(\);\n)",
     r"\1  MARK(5);\n", 1),
    (r"(  solve\(c\);\n  PC_SYNC\(\);\n)", r"\1  MARK(6);\n", 1),
    (r"(  gmat\(c, c.dz, colm, c.ds\);\n  PC_SYNC\(\);\n)",
     r"\1  MARK(7);\n", 1),
    (r"(\n    const T a_aff = step_length\(c\);\n)",
     r"\n    MARK(8);\1    MARK(9);\n", 1),
    (r"(    mu_aff = block_reduce\(mu_aff, c.red, SumOp\(\)\) / c.nact;\n)",
     r"\1    MARK(10);\n", 1),
    (r"(    PC_SYNC\(\);\n    newton_dir\(c, colm\);\n)",
     r"    PC_SYNC();\n    MARK(8);\n    newton_dir(c, colm);\n", 1),
    (r"(\n    const T step = step_length\(c\);\n)",
     r"\n    MARK(8);\1    MARK(9);\n", 1),
    (r"(      c.s\[r\] = c.s\[r\] \+ step \* c.ds\[r\];\n    \}\n    "
     r"PC_SYNC\(\);\n)", r"\1    MARK(8);\n", 1),
    (r"(      c.lam\[r\] = c.blam\[r\];\n    \}\n  \}\n  PC_SYNC\(\);\n)",
     r"\1  MARK(12);\n", 1),
)


def patch(src: str, patches) -> str:
    """The source with the patches applied, then the marks' definitions
    after its first #include and their read-out at its end."""
    for pat, rep, count in patches:
        src, k = re.subn(pat, rep, src)
        if count is not None and k != count:
            raise RuntimeError(f"patch {pat!r}: {k} matches, expected {count}")
    head, inc, rest = src.partition("#include")
    line, nl, rest = rest.partition("\n")
    return head + inc + line + nl + HEADER + rest + FOOTER


def build(src_dir: pathlib.Path, tag: str, min_cluster: int = 1):
    """The instrumented copy of ``src_dir``'s band kernel as a library;
    ``min_cluster`` > 1 makes this tree's launcher take clusters of at
    least that many blocks (a what-if: the shipped rule takes the
    smallest that fits)."""
    out = OUT / tag
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(src_dir, out)
    cu = out / "closed_sim_band.cu"
    text = cu.read_text()
    old = "struct BandLayout" in text
    patches = OLD_PATCHES if old else NEW_PATCHES
    if min_cluster > 1:
        patches += ((r"for \(int C = 1; C <= kBandMaxCluster",
                     f"for (int C = {min_cluster}; C <= kBandMaxCluster", 1),)
    cu.write_text(patch(text, patches))
    so = out / "libphase.so"
    subprocess.run([_build._nvcc(), *_build._NVCC_FLAGS, "-shared", "-o",
                    str(so), str(cu)], check=True)
    if old:
        from band_old_vs_new import old_band, old_band_lib

        lib = old_band_lib(so)
        call = lambda *a: old_band(lib, *a)
    else:
        lib = _build.bind_band(ctypes.CDLL(str(so)))
        call = lambda *a: K.launch_band(lib, *a)
    lib.pc_read.argtypes = [ctypes.c_void_p]
    return lib, call, OLD_PHASES if old else NEW_PHASES


def read(lib):
    buf = (ctypes.c_ulonglong * 73)()
    torch.cuda.synchronize()
    if lib.pc_read(ctypes.addressof(buf)):
        raise RuntimeError("pc_read failed")
    v = list(buf)
    return v[:24], v[24:48], v[48:72], v[72]


def shape_row(lib, call, phases, problem, caps, B, nit):
    inp, _, _ = band_inputs(problem, caps, B, nit, torch.float64, 7)
    t, lc, Hp, r_l, dims = inp
    args = (t, lc, Hp, r_l, nit, 20, 12, dims)
    call(*args)
    lib.pc_reset()
    ms = cs.timed(lambda: call(*args), 1, warm=False)[0]
    cyc, bar, cbar, iters = read(lib)
    ms_port = cs.timed(lambda: K.closed_sim_band(*args), 1)[0]
    total = sum(cyc[k] for k in phases)
    per = {phases[k]: dict(cycles_per_iter=cyc[k] / iters,
                           share=cyc[k] / total,
                           barriers_per_iter=bar[k] / iters,
                           cluster_barriers_per_iter=cbar[k] / iters)
           for k in sorted(phases, key=lambda k: -cyc[k])}
    loop_bars = sum(bar[k] for k in phases if k not in (0, 12, 13)) / iters
    loop_cbars = sum(cbar[k] for k in phases if k not in (0, 12, 13)) / iters
    return dict(caps=caps, B=B, nit=nit, n=dims["n"], ms=ms, port_ms=ms_port,
                pdip_iters=iters, cycles=total,
                cycles_per_iter=total / iters,
                barriers_per_pdip_iter=loop_bars,
                cluster_barriers_per_pdip_iter=loop_cbars, phases=per)


BARRIER_BENCH = r"""
#include <cooperative_groups.h>
namespace cg = cooperative_groups;
__global__ void bar_block(long long* out, int reps) {
  long long t0 = clock64();
  for (int i = 0; i < reps; ++i) __syncthreads();
  if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = clock64() - t0;
}
__global__ void bar_cluster(long long* out, int reps) {
  cg::cluster_group cl = cg::this_cluster();
  long long t0 = clock64();
  for (int i = 0; i < reps; ++i) cl.sync();
  if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = clock64() - t0;
}
extern "C" int bar_run(int cluster, int size, long long* out, int reps) {
  if (!cluster) {
    bar_block<<<1, 256>>>(out, reps);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(size);
    cfg.blockDim = dim3(256);
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = size;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    cudaLaunchKernelEx(&cfg, bar_cluster, out, reps);
  }
  cudaError_t e = cudaDeviceSynchronize();
  return e == cudaSuccess ? (int)cudaGetLastError() : (int)e;
}
"""


def barrier_bench(reps=10000):
    out = OUT / "barrier"
    out.mkdir(parents=True, exist_ok=True)
    (out / "bar.cu").write_text(BARRIER_BENCH)
    subprocess.run([_build._nvcc(), *_build._NVCC_FLAGS, "-shared", "-o",
                    str(out / "libbar.so"), str(out / "bar.cu")], check=True)
    lib = ctypes.CDLL(str(out / "libbar.so"))
    lib.bar_run.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                            ctypes.c_int]
    res = torch.zeros(1, dtype=torch.int64, device="cuda")
    rows = {}
    for name, cl, size in (("__syncthreads", 0, 1), ("cluster 1", 1, 1),
                           ("cluster 2", 1, 2), ("cluster 4", 1, 4)):
        if lib.bar_run(cl, size, res.data_ptr(), reps):
            raise RuntimeError(f"barrier bench {name} failed")
        rows[name] = float(res.item()) / reps
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", type=pathlib.Path, default=CSRC)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--nit", type=int, default=40)
    ap.add_argument("--min-cluster", type=int, default=1)
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    _build.library()
    lib, call, phases = build(args.src, args.tag, args.min_cluster)
    problem, _ = build_problem(shell7x5.make_case(), device="cuda")
    rows = []
    for caps, B in SHAPES:
        rows.append(shape_row(lib, call, phases, problem, caps, B, args.nit))
        print(json.dumps(rows[-1]), flush=True)
    bars = barrier_bench()
    print("barrier cycles: " + json.dumps(bars), flush=True)
    if args.out:
        args.out.write_text(json.dumps(dict(card=card, src=str(args.src),
                                            shapes=rows, barriers=bars),
                                       indent=1))


if __name__ == "__main__":
    main()
