"""Build and load the port's CUDA kernels.

The sources under ``ops/csrc/`` are compiled with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` per ``.cu`` file, all started together, then
linked into one shared library with a plain C interface, loaded with
``ctypes``.  The library is built at first use into
``mpc_tuning_tpu_torch/_build/``, keyed on a hash of the sources, so a
fresh checkout builds it once and later processes reuse it.  A failed
build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

__all__ = ["library", "reference_library", "build_seconds", "bind_band"]

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_BUILD = pathlib.Path(__file__).resolve().parent.parent / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC")

_lib = None
_ref = None
build_seconds = None  # wall seconds of the last build in this process


def _sources(d=_CSRC):
    return sorted(list(d.glob("*.cu")) + list(d.glob("*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def _bind(lib):
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.mpc_spd_factor.argtypes = [i, i, vp, vp, i, i, vp]
    lib.mpc_spd_factor.restype = i
    lib.mpc_spd_factor_solve.argtypes = [i, i, vp, vp, vp, i, i, vp]
    lib.mpc_spd_factor_solve.restype = i
    lib.mpc_spd_solve.argtypes = [i, vp, vp, vp, i, i, vp]
    lib.mpc_spd_solve.restype = i
    lib.mpc_nmpc_rollout.argtypes = [i, ctypes.POINTER(vp), d,
                                     ctypes.c_double, vp]
    lib.mpc_nmpc_rollout.restype = i
    lib.mpc_error_string.argtypes = [i]
    lib.mpc_error_string.restype = ctypes.c_char_p
    lib.mpc_closed_sim_ptr_count.restype = i
    lib.mpc_closed_sim_dim_count.restype = i
    lib.mpc_closed_sim.argtypes = [i, i, ctypes.POINTER(vp), d,
                                   ctypes.POINTER(ctypes.c_double), vp]
    lib.mpc_closed_sim.restype = i
    bind_band(lib)
    lib.mpc_pdip_fused_ptr_count.restype = i
    lib.mpc_admm_fused_ptr_count.restype = i
    lib.mpc_qp_fused_dim_count.restype = i
    lib.mpc_lane_sum.argtypes = [i, vp, vp, i, i, ctypes.c_longlong,
                                 ctypes.c_longlong, vp]
    lib.mpc_lane_sum.restype = i
    for fn in (lib.mpc_pdip_fused, lib.mpc_admm_fused):
        fn.argtypes = [i, ctypes.POINTER(vp), d,
                       ctypes.POINTER(ctypes.c_double), vp]
        fn.restype = i
    return lib


def bind_band(lib):
    """Declare the band kernel's C functions on ``lib`` (the port's library
    or another build of ops/csrc/closed_sim_band.cu); returns lib."""
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.mpc_closed_sim_band_ptr_count.restype = i
    lib.mpc_closed_sim_band_dim_count.restype = i
    lib.mpc_closed_sim_band_max_n.restype = i
    lib.mpc_closed_sim_band_plan.argtypes = [d, ctypes.POINTER(
        ctypes.c_longlong)]
    lib.mpc_closed_sim_band_plan.restype = i
    lib.mpc_closed_sim_band.argtypes = [ctypes.POINTER(vp), d,
                                        ctypes.POINTER(ctypes.c_double), vp]
    lib.mpc_closed_sim_band.restype = i
    return lib


def _compile(srcs, so):
    """nvcc each source to an object in parallel, then link; raises with
    nvcc's output on failure."""
    tmp = so.with_suffix(f".{os.getpid()}.d")
    tmp.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    for src in srcs:
        obj = tmp / (src.stem + ".o")
        cmd = [_nvcc(), *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)))
        objs.append(str(obj))
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    lib_tmp = tmp / so.name
    cmd = [_nvcc(), "-shared", "-o", str(lib_tmp), *objs]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}): "
                           f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    os.replace(lib_tmp, so)
    shutil.rmtree(tmp, ignore_errors=True)


def _built(name, srcs, hashed):
    """The shared library ``name`` of the .cu files in ``srcs``, keyed on a
    hash of ``hashed`` (the sources and the headers they include) and the
    flags; built first if needed.  Returns (path, seconds of the build or
    None)."""
    import time

    h = hashlib.sha256()
    for p in hashed:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    so = _BUILD / f"lib{name}_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so, None
    _BUILD.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    _compile([p for p in srcs if p.suffix == ".cu"], so)
    return so, time.perf_counter() - t0


def library():
    """The loaded kernel library, built first if needed."""
    global _lib, build_seconds
    if _lib is None:
        srcs = _sources()
        so, secs = _built("mpc_kernels", srcs, srcs)
        build_seconds = secs if secs is not None else build_seconds
        _lib = _bind(ctypes.CDLL(str(so)))
    return _lib


def reference_library():
    """The library of ``csrc/reference/`` (earlier designs of a kernel,
    kept as the reference of its replacement; no path of the port calls
    them), built first if needed."""
    global _ref
    if _ref is None:
        srcs = _sources(_CSRC / "reference")
        so, _ = _built("mpc_reference", srcs, srcs + _sources())
        _ref = ctypes.CDLL(str(so))
        vp, i = ctypes.c_void_p, ctypes.c_int
        for fn in (_ref.mpc_admm_fused_one_thread,
                   _ref.mpc_pdip_fused_one_thread):
            fn.argtypes = [i, ctypes.POINTER(vp), ctypes.POINTER(i),
                           ctypes.POINTER(ctypes.c_double), vp]
            fn.restype = i
        _ref.mpc_pdip_fused_one_thread_work_rows.argtypes = [i, i]
        _ref.mpc_pdip_fused_one_thread_work_rows.restype = ctypes.c_longlong
        for fn in (_ref.mpc_spd_factor_solve_one_thread,
                   _ref.mpc_solve_lanes_one_thread):
            fn.argtypes = [i, vp, vp, vp, i, i, vp]
            fn.restype = i
        _ref.mpc_spd_solve_one_thread.argtypes = [i, vp, vp, vp, vp, i, i, vp]
        _ref.mpc_spd_solve_one_thread.restype = i
        _ref.mpc_nmpc_rollout_thread_per_column.argtypes = [
            i, ctypes.POINTER(vp), ctypes.POINTER(i), ctypes.c_double, vp]
        _ref.mpc_nmpc_rollout_thread_per_column.restype = i
    return _ref


def check(code: int, what: str):
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = library().mpc_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
