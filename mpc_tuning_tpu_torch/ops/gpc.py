"""CARIMA / GPC prediction machinery (setup-time, float64 NumPy; the
port's copy of the JAX package's ``ops/gpc.py``, which imports no JAX).

Re-derivation of the reference's L2 math:
 * Diophantine recursion  1 = E_j * (A Delta) + z^-j F_j
   (DTC-GPC/diophantine.m:15-79)
 * per-output MIMO wrapper (DTC-GPC/diophantineMIMO.m:14-21)
 * CARIMA row-common-denominator normalization
   (DTC-GPC/BA_MIMO.m:17-72)
 * forced-response (dynamic) matrix G from step responses
   (DTC-GPC/MatG.m:40-74)
 * past-control (free response) matrix (DTC-GPC/deltaUFree.m:12-63)
 * unconstrained GPC gain K = (H'QH+W)^-1 H'Q
   (DTC-GPC/DTC_GPC_WW.m:97-105)

The outputs are dense float64 matrices consumed by the closed-loop step
of sim/gpc_loop.py.  Everything here is pure setup: it runs once per
plant, not per candidate or per timestep.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mpc_tuning_tpu_torch.models.lti import DiscreteTF
from mpc_tuning_tpu_torch.models.poly import polyconv, polytrim, row_common_den

__all__ = [
    "diophantine",
    "diophantine_mimo",
    "ba_mimo",
    "mat_g",
    "delta_u_free",
    "free_response_block",
    "unconstrained_gain",
    "block_weights",
    "GPCMatrices",
    "build_gpc",
]


def diophantine(A: np.ndarray, N: int, d: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Solve 1 = E_j (A*Delta) + z^-j F_j for j = d+1 .. d+N.

    Returns (E, F): E is (N, d+N) lower-triangular rows of E_j coefficients,
    F is (N, na+1) rows of F_j coefficients (multiplying [y(k), y(k-1), ...]).
    """
    A = np.asarray(A, dtype=np.float64)
    AD = polyconv(A, np.array([1.0, -1.0]))
    na1 = len(AD) - 1  # number of F coefficients
    N1, N2 = d + 1, d + N

    f = np.zeros((N2 + 1, na1))
    f[0, 0] = 1.0
    for j in range(N2):
        f[j + 1, :-1] = f[j, 1:] - f[j, 0] * AD[1:na1]
        f[j + 1, -1] = -f[j, 0] * AD[na1]
    F = f[N1 : N2 + 1, :]

    e = np.array([f[i, 0] for i in range(N2)])  # e_1..e_{N2}, e_1 = 1
    E = np.zeros((N2, N2))
    for i in range(N2):
        E[i, : i + 1] = e[: i + 1]
    return E[N1 - 1 : N2, :], F


def diophantine_mimo(
    A_diag: list[np.ndarray], N: np.ndarray, dmin: np.ndarray
) -> tuple[list, list, list]:
    """Per-output Diophantine solve over the diagonal CARIMA A polynomials.

    Returns (E_last, En_all, F): E_last[i] = last row of E; En_all[i] = all
    rows; F[i] = F coefficient rows (diophantineMIMO.m:16-21).
    """
    E_last, En_all, F_all = [], [], []
    for i, Ai in enumerate(A_diag):
        En, F = diophantine(Ai, int(N[i]), int(dmin[i]))
        E_last.append(En[-1, :])
        En_all.append(En)
        F_all.append(F)
    return E_last, En_all, F_all


def ba_mimo(B_cells, A_cells, round_decimals: int = 4) -> tuple[list, list, np.ndarray, np.ndarray]:
    """CARIMA normalization: per-row common denominator with rounded-root
    dedup; numerators multiplied by cofactor poles (BA_MIMO.m:17-72).

    Returns (B, A_diag, na, nb) where A_diag[i] is the row-common A
    polynomial and B[i][j] the renumerated numerators.  ``round_decimals``
    mirrors the reference's ``round(roots, 4)`` dedup — the default 4
    perturbs coefficients at ~1e-5 exactly as MATLAB does.
    """
    ny = len(A_cells)
    nu = len(A_cells[0])
    B_out, A_diag = [], []
    for i in range(ny):
        A, Bs = row_common_den(
            [B_cells[i][j] for j in range(nu)],
            [A_cells[i][j] for j in range(nu)],
            dedup=(ny != 1),
            round_decimals=round_decimals,
        )
        A_diag.append(A)
        B_out.append(Bs)
    na = np.array([len(a) - 1 for a in A_diag])
    nb = np.array([[len(B_out[i][j]) - 1 for j in range(nu)] for i in range(ny)])
    return B_out, A_diag, na, nb


def mat_g(dtf: DiscreteTF, N: np.ndarray, Nu: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Forced-response matrix from step responses with per-pair delay offsets
    (MatG.m:40-74).  Block (i,j) is (N[i], Nu[j]); blocks concatenate to
    (sum N) x (sum Nu)."""
    ny, nu = dtf.shape
    d = np.asarray(d)
    dmin = d.min(axis=1).astype(np.int64) if nu > 1 else d.astype(np.int64).reshape(-1)
    blocks = []
    for i in range(ny):
        row = []
        g_len = int(N[i] + dmin[i])
        for j in range(nu):
            g = dtf.channels[i][j].step(g_len + 1)
            G = np.zeros((int(N[i]), int(Nu[j])))
            for k in range(1, int(Nu[j]) + 1):
                seg = g[dmin[i] + 1 : dmin[i] + int(N[i]) - k + 2]
                G[k - 1 :, k - 1] = seg
            row.append(G)
        blocks.append(row)
    return np.block(blocks)


def delta_u_free(B, En_all, N: np.ndarray, dp: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Past-control-increment (free response) matrix Hp and register widths.

    Row j of block (m,n) holds the past coefficients of E_j(z^-1) B_mn(z^-1)
    z^-d, ordered newest lag first: column c multiplies du_n(k-1-c)
    (deltaUFree.m:25-58 + cell2mat2 assembly DTC_GPC_WW.m:92-94).

    Returns (Hp, duM) with Hp of shape (sum N, sum duM) and
    duM[n] = max_m (dp[m,n] + len(B[m][n]) - 1), the per-input register
    length (DTC_GPC_WW.m:93).
    """
    ny = len(B)
    nu = len(B[0])
    dp = np.asarray(dp, dtype=np.int64)
    cp = np.zeros((ny, nu), dtype=np.int64)
    for m in range(ny):
        for n in range(nu):
            cp[m, n] = max(int(dp[m, n]) + len(B[m][n]) - 1, 1)
    duM = cp.max(axis=0)

    blocks = []
    for m in range(ny):
        row = []
        for n in range(nu):
            Nm = int(N[m])
            Bmn = polytrim(np.asarray(B[m][n], dtype=np.float64), 1e-14)
            uG1 = np.zeros((Nm, int(cp[m, n])))
            for i in range(Nm):
                Ei = polytrim(En_all[m][i, :], 0.0)
                aux = polytrim(polyconv(Ei, Bmn), 1e-14)
                c = int(cp[m, n])
                if len(aux) < c:
                    uG1[i, :] = np.concatenate([np.zeros(c - len(aux)), aux])
                else:
                    uG1[i, :] = aux[len(aux) - c :]
            # pad to the register width duM[n]: cell2mat2 places each cell at
            # the left of its column block and zero-fills the rest
            if cp[m, n] < duM[n]:
                uG1 = np.hstack([uG1, np.zeros((Nm, int(duM[n] - cp[m, n])))])
            row.append(uG1)
        blocks.append(row)
    return np.block(blocks), duM


def free_response_block(F_all, N: np.ndarray) -> np.ndarray:
    """Block-diagonal S matrix of F polynomial rows (DTC_GPC_WW.m:82-86).
    S @ Yd gives the free response from past outputs, where Yd stacks
    [y_i(k), y_i(k-1), ..., y_i(k-na_i)] per output."""
    mats = [np.asarray(F_all[i][: int(N[i]), :]) for i in range(len(F_all))]
    sizes_r = [m.shape[0] for m in mats]
    sizes_c = [m.shape[1] for m in mats]
    S = np.zeros((sum(sizes_r), sum(sizes_c)))
    r = c = 0
    for m in mats:
        S[r : r + m.shape[0], c : c + m.shape[1]] = m
        r += m.shape[0]
        c += m.shape[1]
    return S


def block_weights(w: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """blkdiag(w_i * I_{sizes_i}) (DTC_GPC_WW.m:66-76)."""
    total = int(np.sum(sizes))
    W = np.zeros((total, total))
    off = 0
    for wi, s in zip(np.asarray(w, dtype=np.float64), np.asarray(sizes, dtype=np.int64)):
        W[off : off + s, off : off + s] = wi * np.eye(int(s))
        off += int(s)
    return W


def unconstrained_gain(
    H: np.ndarray, Q: np.ndarray, W: np.ndarray, Nu: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """K = (H'QH + W)^-1 H'Q symmetrized; Km keeps the first row of each
    input's control-horizon block (DTC_GPC_WW.m:97-105)."""
    S1 = H.T @ Q @ H + W
    S1 = 0.5 * (S1 + S1.T)
    K = np.linalg.solve(S1, H.T @ Q)
    nu = len(Nu)
    Km = np.zeros((nu, K.shape[1]))
    off = 0
    for i in range(nu):
        Km[i, :] = K[off, :]
        off += int(Nu[i])
    return K, Km


@dataclasses.dataclass
class GPCMatrices:
    """Everything the online DTC-GPC loop needs (all float64, static shapes)."""

    H: np.ndarray  # forced response (sum N, sum Nu)
    Hp: np.ndarray  # past-control free response (sum N, sum duM)
    S: np.ndarray  # past-output free response (sum N, sum (na+1))
    K: np.ndarray  # full unconstrained gain
    Km: np.ndarray  # first-move gain (nu, sum N)
    duM: np.ndarray  # per-input past-control register widths
    na: np.ndarray  # per-output CARIMA A orders
    N: np.ndarray
    Nu: np.ndarray
    A_diag: list
    B: list


def build_gpc(
    model: DiscreteTF,
    N: np.ndarray,
    Nu: np.ndarray,
    delta: np.ndarray,
    lam: np.ndarray,
    use_dtc: bool = True,
    round_decimals: int = 4,
) -> GPCMatrices:
    """Offline assembly of the DTC-GPC controller for a discrete model.

    Mirrors the offline section of DTC_GPC_WW.m:41-105: decompose, CARIMA
    normalize, Diophantine (with dmin=0 on the fast model when use_dtc),
    forced response on the full-delay model, past controls on the fast-model
    delays.
    """
    N = np.asarray(N, dtype=np.int64)
    Nu = np.asarray(Nu, dtype=np.int64)
    Bp, Ap, dp = model.descomp()
    dmin = dp.min(axis=1)
    dnz = dp - dmin[:, None]

    B, A_diag, na, nb = ba_mimo(Bp, Ap, round_decimals=round_decimals)
    dio_d = np.zeros_like(N) if use_dtc else dmin
    _, En_all, F_all = diophantine_mimo(A_diag, N, dio_d)

    S = free_response_block(F_all, N)
    H = mat_g(model, N, Nu, dp)
    Hp, duM = delta_u_free(B, En_all, N, dnz if use_dtc else dp)

    Q = block_weights(delta, N)
    W = block_weights(lam, Nu)
    K, Km = unconstrained_gain(H, Q, W, Nu)
    return GPCMatrices(H=H, Hp=Hp, S=S, K=K, Km=Km, duM=duM, na=na, N=N, Nu=Nu,
                       A_diag=A_diag, B=B)
