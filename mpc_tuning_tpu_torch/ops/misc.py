"""Small API-parity helpers mirroring reference utilities (the port of the
JAX package's ``ops/misc.py``; pure NumPy)."""

from __future__ import annotations

import numpy as np

__all__ = ["precon", "nml", "dnml", "col2row", "row2col"]


def precon(N, Nu) -> bool:
    """Horizon validity predicate (PreCon.m:23-27): min(N) > max(Nu) and all
    nonzero."""
    N = np.atleast_1d(np.asarray(N))
    Nu = np.atleast_1d(np.asarray(Nu))
    return bool(N.min() > Nu.max() and np.all(N != 0) and np.all(Nu != 0))


def nml(x, xmin, xmax):
    """Min-max normalization (nml.m:47)."""
    x = np.asarray(x, dtype=np.float64)
    return (x - xmin) / (np.asarray(xmax) - np.asarray(xmin))


def dnml(xn, xmin, xmax):
    """Inverse min-max normalization (dnml.m:36)."""
    xn = np.asarray(xn, dtype=np.float64)
    return xn * (np.asarray(xmax) - np.asarray(xmin)) + xmin


def col2row(x):
    """Transpose if more rows than columns (col2row.m:3-8)."""
    x = np.atleast_2d(np.asarray(x))
    return x.T if x.shape[0] > x.shape[1] else x


def row2col(x):
    """Transpose if more columns than rows (row2col.m)."""
    x = np.atleast_2d(np.asarray(x))
    return x.T if x.shape[1] > x.shape[0] else x
