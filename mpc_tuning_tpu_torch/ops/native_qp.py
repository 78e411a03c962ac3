"""ctypes binding of the native C++ dual active-set QP oracle (the port of
the JAX package's ``ops/native_qp.py``).

A host oracle, not a kernel: the exact solver the fixed-iteration solvers
are held against.  ``ops/qp_active_set.cpp`` is built at first use with
``g++ -O2 -fPIC -shared`` into ``mpc_tuning_tpu_torch/_build/``, keyed on
a hash of the source and the flags; the build goes to a name of its own
and is moved into place with ``os.replace``, so processes that build at
once (pytest-xdist workers) never load a half-written library.  Takes
NumPy arrays or CPU tensors, returns NumPy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile

import numpy as np

__all__ = ["qp_solve_exact", "native_available"]

_SRC = pathlib.Path(__file__).resolve().parent / "qp_active_set.cpp"
_BUILD = pathlib.Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O2", "-fPIC", "-shared")
_lib = None


def _so_path() -> pathlib.Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD / f"libqpactiveset_{h.hexdigest()[:16]}.so"


def _build(so: pathlib.Path) -> bool:
    _BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=so.stem + ".", suffix=".so",
                               dir=_BUILD)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", tmp], check=True,
                       capture_output=True)
        os.replace(tmp, so)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    so = _so_path()
    if not so.exists() and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    arr = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.qp_solve_gi.restype = ctypes.c_int
    lib.qp_solve_gi.argtypes = [ctypes.c_int, ctypes.c_int, arr, arr, arr,
                                arr, arr, arr, ctypes.c_int]
    _lib = lib
    return lib


def native_available() -> bool:
    """True when ``g++`` built (or had built) the oracle."""
    return _load() is not None


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):  # a CPU tensor
        a = a.detach().numpy()
    return np.ascontiguousarray(a, dtype=np.float64)


def qp_solve_exact(H, f, G, h, max_iter: int = 200, anti_cycle: bool = True):
    """Exact dual active-set solve of min 1/2 x'Hx + f'x s.t. G x <= h.
    Returns (x, lam, status): 0 solved, 1 out of iterations, 2 H not SPD.

    anti_cycle: degenerate QPs (more than n tied/active rows, e.g. the
    Shell7x5 soft-band QP) can cycle the active-set method.  The standard
    remedy is applied at this layer: perturb h by a tiny random amount
    (``default_rng(0)``) to break ties almost surely, solve the perturbed
    problem, then POLISH on the original data — exact KKT solve on the
    identified active set, verified against primal feasibility and dual
    nonnegativity."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native QP library unavailable (g++ missing?)")
    H, f, G, h = _host(H), _host(f), _host(G), _host(h)
    n, m = len(f), len(h)
    x = np.zeros(n)
    lam = np.zeros(m)
    status = lib.qp_solve_gi(n, m, H, f, G, h, x, lam, max_iter)
    if status != 1 or not anti_cycle:
        return x, lam, int(status)

    rng = np.random.default_rng(0)
    scale = 1e-7 * (1.0 + np.abs(h))
    for _ in range(4):
        hp = np.ascontiguousarray(h + scale * rng.uniform(0.5, 1.5, size=m))
        xp = np.zeros(n)
        lp = np.zeros(m)
        sp = lib.qp_solve_gi(n, m, H, f, G, hp, xp, lp, max(max_iter, 5000))
        if sp != 0:
            scale = scale * 10.0
            continue
        act = np.where(lp > 1e-10)[0]
        Ga = G[act]
        KKT = np.block([[H, Ga.T], [Ga, np.zeros((len(act), len(act)))]])
        rhs = np.concatenate([-f, h[act]])
        sol = np.linalg.lstsq(KKT, rhs, rcond=None)[0]
        xs, mu = sol[:n], sol[n:]
        tol = 1e-7 * (1.0 + np.abs(h))
        if np.all(G @ xs - h <= tol) and np.all(mu >= -1e-7):
            lam = np.zeros(m)
            lam[act] = np.maximum(mu, 0.0)
            return xs, lam, 0
        scale = scale * 10.0
    return x, lam, int(status)
