"""Shared case-study helpers."""

from __future__ import annotations

import numpy as np

from mpc_tuning_tpu_torch.models import lti
from mpc_tuning_tpu_torch.models.simulate import dlsim

__all__ = ["ref_trajectory", "diag_pref"]


def diag_pref(taus, delays, Ts: float) -> lti.TransferFunction:
    """Diagonal first-order reference model Pref (e.g. WoodBerry.m:69-75)."""
    n = len(taus)
    rows = []
    for i in range(n):
        row = []
        for j in range(n):
            if i == j:
                row.append(lti.tf([1.0], [taus[i], 1.0], delays[i]))
            else:
                row.append(lti.tf([0.0], [1.0]))
        rows.append(row)
    return lti.TransferFunction(rows)


def ref_trajectory(pref: lti.TransferFunction, Xsp: np.ndarray, Ts: float) -> np.ndarray:
    """Yref = lsim(Pref, Xsp, t, 'zoh') (WoodBerry.m:98)."""
    ss = pref.c2d(Ts).to_ss()
    return dlsim(ss, Xsp)
