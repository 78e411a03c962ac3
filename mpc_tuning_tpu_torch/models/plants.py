"""Benchmark plant definitions (L1 data).

Gains / time constants / delays transcribed from the reference case studies:
 * Wood-Berry 2x2 + disturbance:  MPC-Tuning/WoodBerry.m:44-53
 * Shell 3x3 heavy-oil fractionator: MPC-Tuning/Shell3x3.m:43-58
 * Shell 7x5 non-square (7 outputs, 3 MV + 2 MD): MPC-Tuning/Shell7x5.m:46-86
 * Van de Vusse CSTR parameters: MPC-Tuning/vandevusse_model.m:39-77
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mpc_tuning_tpu_torch.models.lti import TransferFunction, tf, tfm

__all__ = [
    "wood_berry",
    "wood_berry_disturbance",
    "shell3x3",
    "shell7x5",
    "Plant",
]


@dataclasses.dataclass
class Plant:
    """A named continuous plant: G (my x n_mv) and optional D (my x n_md)."""

    name: str
    G: TransferFunction
    D: TransferFunction | None
    Ts: float
    n_mv: int
    n_md: int

    @property
    def full(self) -> TransferFunction:
        """[G D] horizontal concat (WoodBerry.m:59)."""
        return self.G if self.D is None else self.G.hcat(self.D)


def _fo(K, tau, delay=0.0, dk=0.0, dl=0.0):
    """First-order K/(tau s + 1) with gain/delay perturbation flags."""
    return tf([K * (1.0 + dk)], [tau, 1.0], delay + dl)


def wood_berry(deltak: float = 0.0, deltaL: float = 0.0) -> Plant:
    """Wood-Berry 2x2 distillation column (WoodBerry.m:44-53).

    deltak/deltaL reproduce the model-error ('nominal=false') fault-injection
    flags of WoodBerry.m:33-42 (deltak=0.2, deltaL=1 in the error case).
    """
    G = tfm(
        [
            [_fo(12.8, 16.7, 1.0, deltak, deltaL), _fo(-18.9, 21.0, 2.0, deltak, deltaL)],
            [_fo(6.6, 10.9, 2.0, deltak, deltaL), _fo(-19.4, 14.4, 1.0, deltak, deltaL)],
        ]
    )
    D = wood_berry_disturbance()
    return Plant("wood_berry", G, D, Ts=1.0, n_mv=2, n_md=1)


def wood_berry_disturbance() -> TransferFunction:
    """Feed disturbance column Ds (WoodBerry.m:52-53) — fractional delays."""
    return tfm([[_fo(3.8, 14.9, 8.1)], [_fo(4.9, 13.2, 3.4)]])


def shell3x3(e1: float = 0.0, e2: float = 0.0, e3: float = 0.0) -> Plant:
    """Shell heavy-oil fractionator 3x3 (Shell3x3.m:43-58).

    e1..e3 reproduce the model-error case of Shell3x3.m:34-39
    (0.2, 0.2, 0.3 in the error case).
    """
    G = tfm(
        [
            [_fo(4.05 + 2.11 * e1, 50, 27), _fo(1.77 + 0.39 * e2, 60, 28), _fo(5.88 + 0.59 * e3, 50, 27)],
            [_fo(5.39 + 3.29 * e1, 50, 18), _fo(5.72 + 0.57 * e2, 60, 14), _fo(6.90 + 0.89 * e3, 40, 15)],
            [_fo(4.38 + 3.11 * e1, 33, 20), _fo(4.42 + 0.73 * e2, 44, 22), _fo(7.20 + 1.33 * e3, 19, 0)],
        ]
    )
    return Plant("shell3x3", G, None, Ts=4.0, n_mv=3, n_md=0)


def shell7x5(
    e1: float = 0.0, e2: float = 0.0, e3: float = 0.0, e4: float = 0.0, e5: float = 0.0
) -> Plant:
    """Shell 7x5 non-square: 7 outputs, 3 MVs + 2 MDs (Shell7x5.m:46-86).

    e1..e5 reproduce the model-error case of Shell7x5.m:37-42.
    """
    G = tfm(
        [
            [_fo(4.05 + 2.11 * e1, 50, 27), _fo(1.77 + 0.39 * e2, 60, 28), _fo(5.88 + 0.59 * e3, 50, 27)],
            [_fo(5.39 + 3.29 * e1, 50, 18), _fo(5.72 + 0.57 * e2, 60, 14), _fo(6.90 + 0.89 * e3, 40, 15)],
            [_fo(3.66 + 2.29 * e1, 9, 2), _fo(1.65 + 0.35 * e2, 30, 20), _fo(5.53 + 0.67 * e3, 40, 2)],
            [_fo(5.92 + 2.34 * e1, 12, 11), _fo(2.54 + 0.24 * e2, 27, 12), _fo(8.10 + 0.32 * e3, 20, 2)],
            [_fo(4.13 + 1.71 * e1, 8, 5), _fo(2.38 + 0.93 * e2, 19, 7), _fo(6.23 + 0.30 * e3, 10, 2)],
            [_fo(4.06 + 2.39 * e1, 13, 8), _fo(4.18 + 0.35 * e2, 33, 4), _fo(6.53 + 0.72 * e3, 9, 1)],
            [_fo(4.38 + 3.11 * e1, 33, 20), _fo(4.42 + 0.73 * e2, 44, 22), _fo(7.20 + 1.33 * e3, 19, 0)],
        ]
    )
    D = tfm(
        [
            [_fo(1.20 + 0.12 * e4, 45, 27), _fo(1.44 + 0.16 * e5, 40, 27)],
            [_fo(1.52 + 0.13 * e4, 25, 15), _fo(1.83 + 0.13 * e5, 20, 15)],
            [_fo(1.16 + 0.08 * e4, 11, 0), _fo(1.27 + 0.08 * e5, 6, 0)],
            [_fo(1.73 + 0.02 * e4, 5, 0), _fo(1.79 + 0.04 * e5, 19, 0)],
            [_fo(1.31 + 0.03 * e4, 2, 0), _fo(1.26 + 0.02 * e5, 22, 0)],
            [_fo(1.19 + 0.08 * e4, 19, 0), _fo(1.17 + 0.01 * e5, 24, 0)],
            [_fo(1.14 + 0.18 * e4, 24, 0), _fo(1.26 + 0.10 * e5, 32, 0)],
        ]
    )
    return Plant("shell7x5", G, D, Ts=4.0, n_mv=3, n_md=2)
