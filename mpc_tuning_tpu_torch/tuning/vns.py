"""Variable Neighborhood Search over bit-encoded horizons.

Faithful re-design of MPC-Tuning/MPC_Tuning/VNS2.m:
 * decision bits: Xv1 (shared prediction horizon N, nbp bits, MSB first =
   the Fc weights of MPCTuning.m:270-278) and Xv2 (per-input control
   horizons Nu, nbc bits each);
 * neighborhoods of order k = all k-bit flips of one vector (N bits, or one
   input's Nu bits), k = 1..3;
 * validity gate: min(N) > max(Nu), N > dmin, Nu >= 2, nonzero
   (PreCon.m:23-27 + VNS2.m:135);
 * first-improving acceptance in the reference's LSB-first scan order, with
   restart to order 1 on improvement (VNS2.m:198-215).

The difference from the reference is purely *where the work runs*: instead
of one closed-loop simulation at a time, every candidate of the current
neighborhood (x output-selector lane) is evaluated in ONE batched device
call, and the scan order is applied to the result vector.
"""

from __future__ import annotations

import dataclasses
from itertools import combinations

import numpy as np

from mpc_tuning_tpu_torch.tuning.objectives import TuningProblem, vns_objective_batch

__all__ = ["vns_search", "VNSResult", "bits_to_int", "int_to_bits"]


def bits_to_int(bits: np.ndarray) -> int:
    """MSB-first bit vector -> integer (the Fc dot product,
    MPCTuning.m:270-278)."""
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


def int_to_bits(v: int, nb: int) -> np.ndarray:
    return np.array([(v >> (nb - 1 - i)) & 1 for i in range(nb)], dtype=np.int64)


@dataclasses.dataclass
class VNSResult:
    N: int
    Nu: np.ndarray  # (nu,) per-input control horizons
    Xv1: np.ndarray
    Xv2: np.ndarray
    Fv: float
    evals: int


def _neighborhood(Xv1, Xv2, order: int):
    """Candidates in reference scan order: N-bits first then each input's
    Nu-bits, LSB-first within each vector."""
    nbp = len(Xv1)
    nu, nbc = Xv2.shape
    cands = []
    for combo in combinations(range(nbp - 1, -1, -1), order):
        x1 = Xv1.copy()
        x1[list(combo)] ^= 1
        cands.append((x1, Xv2.copy()))
    for i in range(nu):
        for combo in combinations(range(nbc - 1, -1, -1), order):
            x2 = Xv2.copy()
            x2[i, list(combo)] ^= 1
            cands.append((Xv1.copy(), x2))
    return cands


def vns_search(
    problem: TuningProblem,
    Xv1: np.ndarray,
    Xv2: np.ndarray,
    delta: np.ndarray,
    lam: np.ndarray,
    Fv: float,
    max_order: int = 3,
    accept: str = "first",  # "first" = reference scan order, "best" = greedy
    verbose: bool = True,
) -> VNSResult:
    Xv1 = np.asarray(Xv1, dtype=np.int64).copy()
    Xv2 = np.asarray(Xv2, dtype=np.int64).copy()
    dmin_max = int(np.max(problem.dmin))
    evals = 0

    order = 1
    while order <= max_order:
        # evaluate the WHOLE fixed-size neighborhood (invalid candidates get
        # F=inf afterwards) so every order-k call shares one compiled batch
        # shape — variable-size filtering would recompile every round
        cands = _neighborhood(Xv1, Xv2, order)
        Ns = np.zeros(len(cands), dtype=np.int64)
        Nus = np.zeros(len(cands), dtype=np.int64)
        valid = np.zeros(len(cands), dtype=bool)
        decoded = []
        for ci, (x1, x2) in enumerate(cands):
            N = bits_to_int(x1)
            Nu = np.array([bits_to_int(row) for row in x2])
            Ns[ci] = N
            Nus[ci] = int(Nu.max())
            decoded.append((x1, x2, N, Nu))
            valid[ci] = (
                N > int(Nu.max())
                and N != 0
                and np.all(Nu != 0)
                and N > dmin_max
                and np.all(Nu > 1)
            )
        if not valid.any():
            order += 1
            continue

        F = vns_objective_batch(problem, Ns, Nus, delta, lam)
        # invalid horizons AND diverged sims (NaN/inf) are both rejected
        # (reference: PreCon gate + try/catch, VNS2.m:135,151-163)
        F = np.where(valid & np.isfinite(F), F, np.inf)
        evals += int(valid.sum())

        improving = np.where(F < Fv)[0]
        if len(improving) == 0:
            order += 1
            continue
        pick = improving[0] if accept == "first" else improving[np.argmin(F[improving])]
        Xv1, Xv2, N_new, Nu_new = decoded[pick]
        Fv = float(F[pick])
        if verbose:
            print(f"Fvns={Fv:.6g}; N=[{N_new}]; Nu=[{int(Nu_new.max())}]")
        order = 1  # restart (VNS2.m:198-215)

    N = bits_to_int(Xv1)
    Nu = np.array([bits_to_int(row) for row in Xv2])
    return VNSResult(N=N, Nu=Nu, Xv1=Xv1, Xv2=Xv2, Fv=Fv, evals=evals)
