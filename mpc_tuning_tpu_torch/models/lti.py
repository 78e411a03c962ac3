"""L1 LTI core: transfer-function matrices with io-delays, exact ZOH
discretization (fractional delays included), and aggregated discrete
state-space realizations.

Replaces the MATLAB Control Toolbox machinery the reference leans on:
``tf`` matrices with ``iodelay`` (e.g. MPC-Tuning/WoodBerry.m:44-53),
``c2d(Ps,Ts,'zoh')`` (WoodBerry.m:62), ``dcgain``, ``step``, ``tfdata`` and
the tf->{B,A,d} decomposition of DTC-GPC/descompMPC.m:33-43.

All of this is setup-time host code in float64 NumPy; the resulting
``DiscreteSS`` matrices are handed to JAX `lax.scan` rollouts (models/simulate.py).

Fractional delays (e.g. the 8.1/3.4-sample disturbance delays at
DTC-GPC/DTC_GPC_WW.m:31-32 and the 27/4=6.75-sample Shell
delays) are discretized exactly: with theta = (l + f)*Ts, 0 <= f < 1,

    x(k+1) = Phi x(k) + G1 u(k-l-1) + G0 u(k-l)
    G0 = Gamma((1-f)Ts),   G1 = expm(A(1-f)Ts) @ Gamma(f*Ts),
    Gamma(tau) = int_0^tau expm(A v) dv B      (Astrom & Wittenmark ZOH)

which matches what MATLAB's ``c2d(...,'zoh')`` does internally.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
from scipy.linalg import expm

from mpc_tuning_tpu_torch.models.poly import polytrim

__all__ = [
    "tf",
    "tfm",
    "TransferFunction",
    "ChannelD",
    "DiscreteTF",
    "DiscreteSS",
    "c2d_channel",
]


# ---------------------------------------------------------------------------
# Continuous transfer-function matrices
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _ChannelC:
    """One SISO continuous channel: num/den in descending powers of s + delay."""

    num: np.ndarray
    den: np.ndarray
    delay: float = 0.0

    def dcgain(self) -> float:
        if self.den[-1] == 0.0:
            return np.inf * np.sign(self.num[-1]) if self.num[-1] != 0 else np.nan
        return float(self.num[-1] / self.den[-1])


def tf(num, den, delay: float = 0.0) -> "_ChannelC":
    """SISO continuous transfer function (MATLAB ``tf(num, den)``)."""
    num = np.atleast_1d(np.asarray(num, dtype=np.float64))
    den = np.atleast_1d(np.asarray(den, dtype=np.float64))
    num = num / den[0]
    den = den / den[0]
    return _ChannelC(num=num, den=den, delay=float(delay))


class TransferFunction:
    """MIMO continuous transfer-function matrix with per-channel io-delays."""

    def __init__(self, channels: Sequence[Sequence[_ChannelC]]):
        self.channels = [list(row) for row in channels]
        self.ny = len(self.channels)
        self.nu = len(self.channels[0]) if self.ny else 0

    @property
    def shape(self) -> tuple[int, int]:
        return (self.ny, self.nu)

    @property
    def iodelay(self) -> np.ndarray:
        return np.array([[c.delay for c in row] for row in self.channels])

    def set_iodelay(self, d) -> "TransferFunction":
        d = np.broadcast_to(np.asarray(d, dtype=np.float64), (self.ny, self.nu))
        out = [
            [dataclasses.replace(c, delay=float(d[i, j])) for j, c in enumerate(row)]
            for i, row in enumerate(self.channels)
        ]
        return TransferFunction(out)

    def dcgain(self) -> np.ndarray:
        return np.array([[c.dcgain() for c in row] for row in self.channels])

    def scaled(self, L: np.ndarray | None, R: np.ndarray | None) -> "TransferFunction":
        """Diagonal conditioning L*P*R (MPCTuning.m:173 / DTC_GPC_WW.m:36-38)."""
        ld = np.ones(self.ny) if L is None else np.diag(np.asarray(L))
        rd = np.ones(self.nu) if R is None else np.diag(np.asarray(R))
        out = [
            [
                dataclasses.replace(c, num=c.num * ld[i] * rd[j])
                for j, c in enumerate(row)
            ]
            for i, row in enumerate(self.channels)
        ]
        return TransferFunction(out)

    def hcat(self, other: "TransferFunction") -> "TransferFunction":
        """Horizontal concatenation ``[G D]`` (WoodBerry.m:59 ``Ps=[Gs Ds]``)."""
        assert self.ny == other.ny
        return TransferFunction(
            [self.channels[i] + other.channels[i] for i in range(self.ny)]
        )

    def c2d(self, Ts: float) -> "DiscreteTF":
        chans = [
            [c2d_channel(c.num, c.den, c.delay, Ts) for c in row]
            for row in self.channels
        ]
        return DiscreteTF(chans, Ts)


def tfm(rows: Sequence[Sequence[_ChannelC | float | int]]) -> TransferFunction:
    """Build a TF matrix; scalars become static gains (0 -> zero channel)."""
    out = []
    for row in rows:
        r = []
        for c in row:
            if isinstance(c, _ChannelC):
                r.append(c)
            else:
                r.append(tf([float(c)], [1.0]))
        out.append(r)
    return TransferFunction(out)


# ---------------------------------------------------------------------------
# ZOH discretization
# ---------------------------------------------------------------------------


def _realize_siso(num: np.ndarray, den: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Controllable-canonical strictly-proper realization of num/den."""
    den = np.asarray(den, dtype=np.float64)
    num = np.asarray(num, dtype=np.float64) / den[0]
    den = den / den[0]
    n = len(den) - 1
    if n == 0:
        # static gain: no states
        return np.zeros((0, 0)), np.zeros((0, 1)), np.zeros((1, 0))
    if len(num) > n:
        raise ValueError("only strictly proper continuous channels supported")
    A = np.zeros((n, n))
    A[0, :] = -den[1:]
    if n > 1:
        A[1:, :-1] = np.eye(n - 1)
    B = np.zeros((n, 1))
    B[0, 0] = 1.0
    # top-companion form: u->x_k is s^(n-k)/den(s), so C = num padded to
    # descending powers [c1..cn] with y = c1 s^(n-1) + ... + cn over den
    numf = np.concatenate([np.zeros(n - len(num)), num])
    C = numf.reshape(1, -1)
    return A, B, C


def _gamma(A: np.ndarray, B: np.ndarray, tau: float) -> np.ndarray:
    """Gamma(tau) = int_0^tau expm(A v) dv @ B via augmented matrix exponential."""
    n = A.shape[0]
    if n == 0:
        return np.zeros((0, 1))
    M = np.zeros((n + 1, n + 1))
    M[:n, :n] = A * tau
    M[:n, n:] = B * tau
    E = expm(M)
    return E[:n, n:]


@dataclasses.dataclass
class ChannelD:
    """One discretized SISO channel.

    State-space: ``x(k+1) = Ad x(k) + B1 u(k-l-1) + B0 u(k-l)``, ``y = C x``.
    Polynomials: ``a`` (z^-1, monic), ``b`` (z^-1 series with b[0]=0, i.e. at
    least one sample of intrinsic delay), integer delay ``d = l`` such that
    ``y(k) = sum -a_m y(k-m) + sum b_i u(k-d-i)`` — the (B, A, d) cell format
    of DTC-GPC/descompMPC.m.
    """

    Ad: np.ndarray
    B0: np.ndarray
    B1: np.ndarray
    C: np.ndarray
    l: int
    frac: float
    a: np.ndarray
    b: np.ndarray
    Ts: float

    @property
    def d(self) -> int:
        return self.l

    @property
    def nx(self) -> int:
        return self.Ad.shape[0]

    def dcgain(self) -> float:
        a_sum = np.sum(self.a)
        if a_sum == 0.0:
            return np.inf
        return float(np.sum(self.b) / a_sum)

    def step(self, nsamp: int) -> np.ndarray:
        """Discrete step response y(0..nsamp) — MATLAB ``step`` on the
        discretized channel, as used by MatG.m:51."""
        y = np.zeros(nsamp + 1)
        nb = len(self.b)
        # u(k)=1 for k>=0; y via difference equation including delay d
        for k in range(nsamp + 1):
            acc = 0.0
            for m in range(1, len(self.a)):
                if k - m >= 0:
                    acc -= self.a[m] * y[k - m]
            for i in range(nb):
                if k - self.l - i >= 0:
                    acc += self.b[i]
            y[k] = acc
        return y


def c2d_channel(num, den, theta: float, Ts: float) -> ChannelD:
    """Exact ZOH discretization of one continuous channel with delay theta."""
    num = np.atleast_1d(np.asarray(num, dtype=np.float64))
    den = np.atleast_1d(np.asarray(den, dtype=np.float64))
    A, B, C = _realize_siso(num, den)
    n = A.shape[0]

    ratio = theta / Ts
    l = int(np.floor(ratio + 1e-9))
    f = ratio - l
    if f < 1e-9:
        f = 0.0

    if n == 0:
        gain = num[-1] / den[-1] if den[-1] != 0 else 0.0
        # static gain with possible fractional delay: split across two samples
        b = np.array([0.0, gain * (1 - f), gain * f]) if f > 0 else np.array([0.0, gain])
        # represent as pure feedthrough via polynomials (no states)
        return ChannelD(
            Ad=np.zeros((0, 0)), B0=np.zeros((0, 1)), B1=np.zeros((0, 1)),
            C=np.zeros((1, 0)), l=l, frac=f, a=np.array([1.0]), b=polytrim(b), Ts=Ts,
        )

    Phi = expm(A * Ts)
    if f == 0.0:
        G0 = _gamma(A, B, Ts)
        G1 = np.zeros((n, 1))
    else:
        G0 = _gamma(A, B, (1.0 - f) * Ts)
        G1 = expm(A * (1.0 - f) * Ts) @ _gamma(A, B, f * Ts)

    # z-domain polynomials: a(z) = charpoly(Phi);
    # C adj(zI-Phi) Bi = charpoly(Phi - Bi C) - charpoly(Phi)
    a_z = np.real(np.poly(Phi))
    num0 = np.real(np.poly(Phi - G0 @ C)) - a_z
    num0[np.abs(num0) < 1e-14] = 0.0
    b = num0.copy()  # z^-1 series: [~0, c1, ..., cn]
    if f > 0.0:
        num1 = np.real(np.poly(Phi - G1 @ C)) - a_z
        num1[np.abs(num1) < 1e-14] = 0.0
        b = np.concatenate([b, [0.0]])
        b[1:] += num1  # shifted one extra sample
    b[0] = 0.0
    return ChannelD(Ad=Phi, B0=G0, B1=G1, C=C, l=l, frac=f, a=a_z, b=polytrim(b), Ts=Ts)


# ---------------------------------------------------------------------------
# Discrete TF matrix + aggregated state-space
# ---------------------------------------------------------------------------


class DiscreteTF:
    """MIMO discrete TF matrix (per-channel ChannelD) at sample time Ts."""

    def __init__(self, channels: Sequence[Sequence[ChannelD]], Ts: float):
        self.channels = [list(row) for row in channels]
        self.Ts = float(Ts)
        self.ny = len(self.channels)
        self.nu = len(self.channels[0]) if self.ny else 0

    @property
    def shape(self) -> tuple[int, int]:
        return (self.ny, self.nu)

    @property
    def iodelay(self) -> np.ndarray:
        return np.array([[c.l for c in row] for row in self.channels])

    def dcgain(self) -> np.ndarray:
        return np.array([[c.dcgain() for c in row] for row in self.channels])

    def descomp(self) -> tuple[list, list, np.ndarray]:
        """(B, A, d) cells — DTC-GPC/descompMPC.m:33-43.

        b already carries the leading zero (one intrinsic sample), so delays
        are not shifted further; zero-gain channels get the row max delay.
        """
        d = self.iodelay.astype(np.int64)
        B = [[c.b.copy() for c in row] for row in self.channels]
        A = [[c.a.copy() for c in row] for row in self.channels]
        for i in range(self.ny):
            for j in range(self.nu):
                if self.channels[i][j].dcgain() == 0.0:
                    d[i, j] = int(np.max(d[i, :]))
        return B, A, d

    def submatrix(self, rows, cols) -> "DiscreteTF":
        return DiscreteTF(
            [[self.channels[i][j] for j in cols] for i in rows], self.Ts
        )

    def fast_model(self) -> "DiscreteTF":
        """Delay-free-minimum model: per-row minimum delay removed
        (DTC_GPC_WW.m:51-54 ``Gnz.iodelay = dreal - diag(dmin)*ones``)."""
        d = self.iodelay
        dmin = d.min(axis=1)
        out = []
        for i, row in enumerate(self.channels):
            out.append([dataclasses.replace(c, l=int(c.l - dmin[i])) for c in row])
        return DiscreteTF(out, self.Ts)

    def to_ss(self) -> "DiscreteSS":
        return DiscreteSS.from_dtf(self)


class DiscreteSS:
    """Aggregated MIMO discrete state-space with explicit input delay-line
    states (shared per input), suitable both for `lax.scan` simulation and as
    the MPC prediction model.  x(k+1) = A x + B u;  y = C x + D u."""

    def __init__(self, A, B, C, D, Ts: float):
        self.A = np.asarray(A, dtype=np.float64)
        self.B = np.asarray(B, dtype=np.float64)
        self.C = np.asarray(C, dtype=np.float64)
        self.D = np.asarray(D, dtype=np.float64)
        self.Ts = float(Ts)

    @property
    def nx(self) -> int:
        return self.A.shape[0]

    @property
    def nu(self) -> int:
        return self.B.shape[1]

    @property
    def ny(self) -> int:
        return self.C.shape[0]

    @staticmethod
    def from_dtf(dtf: DiscreteTF) -> "DiscreteSS":
        ny, nu = dtf.shape
        # delay-chain length needed per input
        chain_len = np.zeros(nu, dtype=np.int64)
        for j in range(nu):
            need = 0
            for i in range(ny):
                c = dtf.channels[i][j]
                need = max(need, c.l + (1 if c.frac > 0 else 0))
            chain_len[j] = need

        n_chan = sum(
            dtf.channels[i][j].nx for i in range(ny) for j in range(nu)
        )
        n_chain = int(chain_len.sum())
        nx = n_chan + n_chain
        A = np.zeros((nx, nx))
        B = np.zeros((nx, nu))
        C = np.zeros((ny, nx))
        D = np.zeros((ny, nu))

        chain_start = np.zeros(nu, dtype=np.int64)
        off = n_chan
        for j in range(nu):
            chain_start[j] = off
            L = int(chain_len[j])
            if L > 0:
                B[off, j] = 1.0  # z_1(k+1) = u_j(k)
                for m in range(1, L):
                    A[off + m, off + m - 1] = 1.0  # z_{m+1}(k+1) = z_m(k)
            off += L

        def u_delayed_col(j: int, m: int):
            """column index of state equal to u_j(k-m); m=0 means direct u."""
            if m == 0:
                return None
            return int(chain_start[j] + m - 1)

        off = 0
        for i in range(ny):
            for j in range(nu):
                c = dtf.channels[i][j]
                n = c.nx
                if n == 0:
                    # static gain channel handled through D / chains via b poly
                    # (b = [0, g(1-f), g f]) -> feed through delayed inputs
                    for idx, coef in enumerate(c.b):
                        if coef == 0.0:
                            continue
                        m = c.l + idx
                        col = u_delayed_col(j, m)
                        if col is None:
                            D[i, j] += coef
                        else:
                            C[i, col] += coef
                    continue
                sl = slice(off, off + n)
                A[sl, sl] = c.Ad
                # u(k-l) term
                col = u_delayed_col(j, c.l)
                if col is None:
                    B[sl, j] += c.B0[:, 0]
                else:
                    A[sl, col] += c.B0[:, 0]
                if c.frac > 0:
                    col1 = u_delayed_col(j, c.l + 1)
                    A[sl, col1] += c.B1[:, 0]
                C[i, sl] = c.C[0, :]
                off += n

        return DiscreteSS(A, B, C, D, dtf.Ts)
