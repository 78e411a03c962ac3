"""Robustness filter Fr(z) design + recursive predictor filters (the
port's copy of the JAX package's ``ops/filters.py``: host NumPy, no JAX).

Re-derivation of DTC-GPC/filtro_siso.m:16-98 and
mimofilter.m:14-64.  The filter for output i solves the polynomial identity

    Dr(z^-1) - Nr(z^-1) z^-d  =  px(z^-1) * Qx(z^-1)

with Dr = (1 - alfa z^-1)^nk and px = poly([1, unwanted_poles]), i.e. the
error-feedback term (1 - Fr z^-d) of the filtered Smith predictor cancels
the slow/unstable model poles AND has a zero at z=1 (unit DC gain of Fr,
offset-free prediction).  This is the same Sylvester system filtro_siso.m
assembles row by row, written as explicit coefficient matching.

The reference then replays the whole input history through `lsim` every
timestep (OptimalPredictor2.m:26-40, O(k) per step); here each filter is a
discrete state-space advanced recursively (O(1) per step) inside the
control loop's step (``sim/gpc_loop.py``) — same outputs, linear total
cost.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mpc_tuning_tpu_torch.models.lti import DiscreteTF
from mpc_tuning_tpu_torch.models.poly import polyconv, polytrim

__all__ = ["design_robust_filter", "mimo_filter", "tf2ss_z", "FilterBank"]


def design_robust_filter(
    unwanted_poles: np.ndarray, alfa: float, d: int
) -> tuple[np.ndarray, np.ndarray]:
    """Return (Nr, Dr) z^-1 polynomials of the robustness filter.

    unwanted_poles: model poles with |p| >= raio to be cancelled from the
    predictor (filtro_siso.m:26-36).  d: minimum model delay in samples.
    """
    p_ind = np.asarray(unwanted_poles, dtype=np.float64)
    nm = len(p_ind)
    if nm == 0:
        return np.array([1.0]), np.array([1.0])

    # poles to cancel from (1 - Fr z^-d): z=1 plus the unwanted model poles
    px = np.real(np.poly(np.concatenate([[1.0], p_ind])))  # degree nm+1

    extra = 2 if d == 0 else 0  # filtro_siso.m:32-37 order bump when no delay
    nk = nm + extra
    Dr = np.array([1.0])
    for _ in range(nk):
        Dr = polyconv(Dr, np.array([1.0, -alfa]))

    n_nr = nk + 1  # Nr coefficients
    n_q = d + extra  # Qx coefficients
    rows = nk + d + 1  # coefficient equations, z^0 .. z^-(nk+d)
    A = np.zeros((rows, n_nr + n_q))
    b = np.zeros(rows)
    b[: nk + 1] = Dr
    # -(Nr z^-d) contributes at rows d..d+nk  -> move to LHS as +Nr
    for i in range(n_nr):
        if d + i < rows:
            A[d + i, i] = 1.0
    # px * Qx contributes px[t-i] at row t for q_i
    for i in range(n_q):
        for t in range(len(px)):
            if i + t < rows:
                A[i + t, n_nr + i] = px[t]

    if A.shape[0] == A.shape[1]:
        x = np.linalg.solve(A, b)
    else:
        x, *_ = np.linalg.lstsq(A, b, rcond=None)
    Nr = polytrim(x[:n_nr], 1e-12)
    return Nr, Dr


def tf2ss_z(b: np.ndarray, a: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """Discrete SISO b(z^-1)/a(z^-1) -> (A, B, C, D) controllable canonical.

    Supports biproper filters (b[0] != 0) via polynomial division.
    """
    b = np.asarray(b, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    b = b / a[0]
    a = a / a[0]
    n = len(a) - 1
    if n == 0:
        return np.zeros((0, 0)), np.zeros((0, 1)), np.zeros((1, 0)), float(b[0])
    D = b[0]
    # strictly proper remainder: b_sp = b - D*a (padded)
    bp = np.zeros(n + 1)
    bp[: len(b)] = b
    b_sp = bp - D * a  # b_sp[0] == 0
    A = np.zeros((n, n))
    A[0, :] = -a[1:]
    if n > 1:
        A[1:, :-1] = np.eye(n - 1)
    B = np.zeros((n, 1))
    B[0, 0] = 1.0
    C = b_sp[1:].reshape(1, -1)
    return A, B, C, float(D)


@dataclasses.dataclass
class FilterBank:
    """Diagonal bank of SISO filters as one block state-space."""

    A: np.ndarray
    B: np.ndarray
    C: np.ndarray
    D: np.ndarray

    @staticmethod
    def from_filters(filts: list[tuple[np.ndarray, np.ndarray]]) -> "FilterBank":
        parts = [tf2ss_z(b, a) for b, a in filts]
        nx = sum(p[0].shape[0] for p in parts)
        m = len(parts)
        A = np.zeros((nx, nx))
        B = np.zeros((nx, m))
        C = np.zeros((m, nx))
        D = np.zeros((m, m))
        off = 0
        for i, (Ai, Bi, Ci, Di) in enumerate(parts):
            n = Ai.shape[0]
            A[off : off + n, off : off + n] = Ai
            B[off : off + n, i] = Bi[:, 0]
            C[i, off : off + n] = Ci[0, :]
            D[i, i] = Di
            off += n
        return FilterBank(A, B, C, D)


def predictor_diagnostics(
    filters: list[tuple[np.ndarray, np.ndarray]],
    fr_bank: "FilterBank",
    fast_ss,
    model_ss,
) -> dict:
    """Build-time validation of the filtered-Smith predictor
    S(z) = G_fast(z) - Fr(z) Pd(z)  (mimofilter.m:48-64).

    Returns {dc, dc_ok, rho, stable}:
      * dc: per-output Fr DC gain; dc_ok mirrors the reference's
        round(dcgain(Fr)*10000) == I check (mimofilter.m:52-56);
      * rho: spectral radius of the combined (non-minimal) realization of S
        — the eigenvalue union of G_fast, Pd and Fr, exactly what MATLAB's
        pole(ss(G)-ss(Fr)*ss(Pd)) reports; stable = rho < 1
        (mimofilter.m:59-64).  An unstable predictor silently corrupts
        every DTC run, hence the loud warning at build.
    """
    dc = np.array([np.sum(b) / np.sum(a) for b, a in filters])
    dc_ok = bool(np.all(np.round(dc * 10000) == 10000))
    eig_parts = []
    for A in (fast_ss.A, model_ss.A, fr_bank.A):
        A = np.asarray(A)
        if A.size:
            eig_parts.append(np.linalg.eigvals(A))
    rho = float(max((np.abs(e).max() for e in eig_parts), default=0.0))
    return {"dc": dc, "dc_ok": dc_ok, "rho": rho, "stable": rho < 1.0}


def mimo_filter(
    model: DiscreteTF, alfa: float, raio: float, kn: int = 2
) -> tuple[list[tuple[np.ndarray, np.ndarray]], np.ndarray]:
    """Per-output diagonal Fr(z) (mimofilter.m:33-47).

    For each output: take the product of that row's nonzero channels
    (delay-free), collect its poles with magnitude >= raio, and design the
    robustness filter with the row's minimum delay.  Returns the list of
    (Nr, Dr) filters and the dmin vector.  `kn` is accepted for parity with
    the reference signature (its multiplicity knob is not implemented there
    either, mimofilter.m:10).
    """
    ny, nu = model.shape
    d = model.iodelay
    dmin = d.min(axis=1).astype(np.int64)
    filters = []
    for i in range(ny):
        poles = []
        any_gain = False
        for j in range(nu):
            c = model.channels[i][j]
            if np.sum(np.abs(c.b)) == 0.0:
                continue
            any_gain = True
            poles.extend(list(np.roots(c.a)))
        poles = np.array(poles) if poles else np.zeros(0)
        p_ind = np.real(poles[np.abs(poles) >= raio]) if len(poles) else np.zeros(0)
        if not any_gain or len(p_ind) == 0:
            filters.append((np.array([1.0]), np.array([1.0])))
        else:
            Nr, Dr = design_robust_filter(p_ind, alfa, int(dmin[i]))
            filters.append((Nr, Dr))
    return filters, dmin
