"""Polynomial algebra helpers (host-side, float64 NumPy).

Setup-time only: none of this runs inside jit.  Provides the polynomial
machinery the reference gets from MATLAB built-ins (``conv``, ``roots``,
``poly``) and the CARIMA row-common-denominator normalization performed by
the reference's ``BA_MIMO`` (see DTC-GPC/BA_MIMO.m:17-72).

Polynomials are 1-D float64 arrays of coefficients in descending powers of
z (equivalently ascending powers of z^-1), index 0 = constant term of the
z^-1 series: ``A = [1, a1, a2, ...]`` represents ``1 + a1 z^-1 + ...``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["polyconv", "polyfromroots", "polytrim", "row_common_den"]


def polyconv(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Polynomial product (MATLAB ``conv``)."""
    return np.convolve(np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64))


def polyfromroots(roots: np.ndarray) -> np.ndarray:
    """Monic polynomial with the given roots (MATLAB ``poly``), real part kept."""
    p = np.atleast_1d(np.poly(np.asarray(roots)))
    return np.real(p).astype(np.float64)


def polytrim(p: np.ndarray, tol: float = 0.0) -> np.ndarray:
    """Strip trailing (highest z^-1 order) coefficients with |c| <= tol."""
    p = np.asarray(p, dtype=np.float64)
    nz = np.nonzero(np.abs(p) > tol)[0]
    if len(nz) == 0:
        return np.zeros(1)
    return p[: nz[-1] + 1]


def row_common_den(
    num_row: list[np.ndarray],
    den_row: list[np.ndarray],
    dedup: bool = True,
    round_decimals: int = 4,
) -> tuple[np.ndarray, list[np.ndarray]]:
    """Common denominator of one output row of a MIMO discrete TF.

    Returns ``(A, Bs)`` where ``A`` is the row's common denominator and
    ``Bs[j]`` is ``num_row[j]`` multiplied by the cofactor poles of the
    other channels.  With ``dedup`` (the MIMO behavior of the reference's
    BA_MIMO.m:36-41), poles repeated across channels of the same row are
    collapsed via rounded-root deduplication so the CARIMA A polynomial
    stays minimal.
    """
    m = len(den_row)
    acc = np.asarray(den_row[0], dtype=np.float64)
    for j in range(1, m):
        acc = polyconv(acc, den_row[j])
    if dedup and m > 1:
        r = np.round(np.roots(acc), round_decimals)
        # np.unique on complex sorts lexicographically; keep one copy of each
        uniq = np.unique(r)
        A = polyfromroots(uniq)
    else:
        A = acc

    rA = np.round(np.roots(A), round_decimals)
    Bs = []
    for j in range(m):
        b = np.asarray(num_row[j], dtype=np.float64)
        # strip the leading zero that descomp adds for causality
        if b.shape[0] > 1 and b[0] == 0.0:
            b = b[1:]
        rden = np.round(np.roots(np.asarray(den_row[j], dtype=np.float64)), round_decimals)
        # cofactor roots: roots of A not cancelled by this channel's own poles
        remaining = list(rA)
        for rr in rden:
            for k, cand in enumerate(remaining):
                if cand == rr:
                    remaining.pop(k)
                    break
        cof = polyfromroots(np.asarray(remaining)) if remaining else np.ones(1)
        Bs.append(polyconv(b, cof))
    return A, Bs
