"""MIMO DTC-GPC closed loop (the port of the JAX package's
``sim/gpc_loop.py``).

The online loop of DTC-GPC/DTC_GPC_WW.m:127-164 with the optimal
predictor of OptimalPredictor2.m:26-40:

  measure -> conditioned output -> optimal predictor (fast model + filtered
  model error) -> free response (past controls + past predictor outputs) ->
  unconstrained first-move gain -> integrate control -> advance plant.

Two implementations:
 * ``DTCGPC.simulate_ref``   — literal host replica (NumPy, O(nit^2) like the
   reference's full-history lsim replay) used as a cross-check oracle;
 * ``DTCGPC.simulate_scan`` / ``simulate_scan_batch`` — the O(nit)
   recursion (``scan_loop``): a Python loop over the steps of batch-major
   tensor ops on the device, one lane per (setpoint, disturbance)
   scenario, the constants as tensors.

The JAX package's step is a ``lax.scan`` of ~20 small mat-vecs.  Here each
mat-vec runs as a chain of elementwise multiply-adds over its inputs in
ascending order (``_LinearMaps``, the maps that share an input stacked
into one chain), so a lane's bits follow neither its slot nor the batch's
size: a matrix product would hand the sums to the BLAS, whose order can
follow the batch's shape.  Nothing here is a Pallas kernel in the JAX
package, so no kernel is ported; on the card the loop is bound by its
~90 launches a step, not by the card.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from mpc_tuning_tpu_torch.models.lti import DiscreteSS, TransferFunction
from mpc_tuning_tpu_torch.models.simulate import dlsim
from mpc_tuning_tpu_torch.ops.filters import (FilterBank, mimo_filter,
                                              predictor_diagnostics)
from mpc_tuning_tpu_torch.ops.gpc import GPCMatrices, build_gpc
from mpc_tuning_tpu_torch.ops.kernels import require_device
from mpc_tuning_tpu_torch.ops.mpc_qp import pin_precision

__all__ = ["DTCGPC", "scan_loop", "SCAN_KEYS"]

# the keys of DTCGPC.scan_constants (the JAX package's, in its order)
SCAN_KEYS = ("A_pl", "B_pl", "C_pl", "D_pl", "A_m", "B_m", "C_m", "A_g",
             "B_g", "C_g", "A_f", "B_f", "C_f", "D_f", "Hp", "S", "Km",
             "Shift", "Inj", "Eref", "L", "R")


def _block_shift_inject(duM: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Matrices implementing the past-control register update
    up <- Shift@up + Inj@dU  (DTC_GPC_WW.m:151-155: newest increment at the
    head of each input's block)."""
    total = int(np.sum(duM))
    nu = len(duM)
    Shift = np.zeros((total, total))
    Inj = np.zeros((total, nu))
    off = 0
    for j, w in enumerate(np.asarray(duM, dtype=np.int64)):
        w = int(w)
        for m in range(1, w):
            Shift[off + m, off + m - 1] = 1.0
        Inj[off, j] = 1.0
        off += w
    return Shift, Inj


def _ref_selector(N: np.ndarray) -> np.ndarray:
    """(sum N, ny) matrix repeating the current reference over each output's
    prediction window (DTC_GPC_WW.m:142-145)."""
    ny = len(N)
    E = np.zeros((int(np.sum(N)), ny))
    off = 0
    for i, n in enumerate(np.asarray(N, dtype=np.int64)):
        E[off : off + int(n), i] = 1.0
        off += int(n)
    return E


def _pad_S(S: np.ndarray, na: np.ndarray, width: int) -> np.ndarray:
    """Pad the per-output F-blocks of S to a uniform (na_max+1) column width
    so Yd can be a dense (ny, width) rolling buffer."""
    ny = len(na)
    rows = S.shape[0]
    out = np.zeros((rows, ny * width))
    c_in = 0
    for i in range(ny):
        w = int(na[i]) + 1
        out[:, i * width : i * width + w] = S[:, c_in : c_in + w]
        c_in += w
    return out


@dataclasses.dataclass
class DTCGPC:
    """Offline-assembled DTC-GPC controller + closed-loop simulators."""

    plant_ss: DiscreteSS  # real plant [P D] (unconditioned)
    model_ss: DiscreteSS  # conditioned nominal model Pnz (driven by ue)
    fast_ss: DiscreteSS  # conditioned fast model Gnz (delays - dmin)
    fr: FilterBank
    mats: GPCMatrices
    L: np.ndarray
    R: np.ndarray
    n_mv: int
    n_md: int
    Shift: np.ndarray
    Inj: np.ndarray
    Eref: np.ndarray
    S_pad: np.ndarray
    yd_width: int

    @staticmethod
    def build(
        plant: TransferFunction,
        model: TransferFunction,
        Ts: float,
        p: np.ndarray,
        m: np.ndarray,
        delta: np.ndarray,
        lam: np.ndarray,
        L: np.ndarray,
        R: np.ndarray,
        n_md: int = 0,
        disturbance: TransferFunction | None = None,
        alfa: float = 0.7,
        raio: float = 0.8,
    ) -> "DTCGPC":
        """Offline section of DTC_GPC_WW.m:34-108 for a general MIMO plant."""
        ny, nu = model.shape
        Pne = model.scaled(L, R)  # conditioned nominal model
        Pnz = Pne.c2d(Ts)
        Gnz = Pnz.fast_model()

        full = plant if disturbance is None else plant.hcat(disturbance)
        plant_ss = full.c2d(Ts).to_ss()

        mats = build_gpc(Pnz, p, m, delta, lam, use_dtc=True)
        filters, _ = mimo_filter(Pnz, alfa, raio)
        fr = FilterBank.from_filters(filters)

        # predictor validation at build time (mimofilter.m:48-64): Fr DC
        # gain = I and S = G_fast - Fr*Pd stable; warn like the reference's
        # validation prints — an unstable predictor corrupts every DTC run
        diag = predictor_diagnostics(filters, fr, Gnz.to_ss(), Pnz.to_ss())
        if not diag["dc_ok"]:
            warnings.warn(
                f"Fr(z) static gain wrong (dcgain={diag['dc']}) — predictor "
                "will not be offset-free", stacklevel=2)
        if not diag["stable"]:
            warnings.warn(
                f"predictor S(z) unstable (spectral radius {diag['rho']:.4f}"
                " >= 1)", stacklevel=2)

        Shift, Inj = _block_shift_inject(mats.duM)
        Eref = _ref_selector(mats.N)
        yd_width = int(np.max(mats.na)) + 1
        S_pad = _pad_S(mats.S, mats.na, yd_width)

        return DTCGPC(
            plant_ss=plant_ss,
            model_ss=Pnz.to_ss(),
            fast_ss=Gnz.to_ss(),
            fr=fr,
            mats=mats,
            L=np.asarray(L, dtype=np.float64),
            R=np.asarray(R, dtype=np.float64),
            n_mv=nu,
            n_md=n_md,
            Shift=Shift,
            Inj=Inj,
            Eref=Eref,
            S_pad=S_pad,
            yd_width=yd_width,
        )

    # ------------------------------------------------------------------
    # host oracle (literal structure of the reference loop)
    # ------------------------------------------------------------------
    def simulate_ref(self, r: np.ndarray, q: np.ndarray, nit: int, k0: int = 3):
        """O(nit^2) replica: full-history replay each step like
        DTC_GPC_WW.m:128-164 (loop starts at k=4, i.e. index 3)."""
        ny, nu = self.L.shape[0], self.n_mv
        u = np.zeros((nit, nu))
        ue = np.zeros((nit, nu))
        y = np.zeros((nit, ny))
        up = np.zeros(int(np.sum(self.mats.duM)))
        na_w = self.yd_width

        fr_ss = DiscreteSS(self.fr.A, self.fr.B, self.fr.C, self.fr.D, self.plant_ss.Ts)
        for k in range(k0, nit):
            # plant replay: dlsim computes Y[t] before applying U[t], so a
            # (k+1)-row history (whose last input row is still zero/unused)
            # yields the time-k measurement
            U_hist = np.hstack([u[: k + 1, :], q[: k + 1, :]])
            y_hist = dlsim(self.plant_ss, U_hist)
            y[k] = y_hist[k]
            ye_hist = (self.L @ y_hist.T).T

            # optimal predictor by replay (OptimalPredictor2.m:26-40)
            ypz = dlsim(self.model_ss, ue[: k + 1, :])
            ygz = dlsim(self.fast_ss, ue[: k + 1, :])
            eM = ye_hist - ypz
            yfr = dlsim(fr_ss, eM)
            yp_hist = ygz + yfr  # rows 0..k

            # free response from past predictor outputs
            Yd = np.zeros(ny * na_w)
            for i in range(ny):
                for mlag in range(na_w):
                    idx = k - mlag
                    Yd[i * na_w + mlag] = yp_hist[idx, i] if idx >= 0 else 0.0
            re = self.L @ r[k]
            yf = self.mats.Hp @ up + self.S_pad @ Yd
            dU = self.mats.Km @ (self.Eref @ re - yf)

            up = self.Shift @ up + self.Inj @ dU
            ue[k] = ue[k - 1] + dU
            u[k] = self.R @ ue[k]
        return y, u

    # ------------------------------------------------------------------
    # the O(nit) recursion on the device
    # ------------------------------------------------------------------
    def scan_constants(self, dtype=torch.float64, device="cuda") -> dict:
        """The step's constants (SCAN_KEYS) as tensors on ``device``."""
        require_device(device)
        c = {
            "A_pl": self.plant_ss.A, "B_pl": self.plant_ss.B,
            "C_pl": self.plant_ss.C, "D_pl": self.plant_ss.D,
            "A_m": self.model_ss.A, "B_m": self.model_ss.B, "C_m": self.model_ss.C,
            "A_g": self.fast_ss.A, "B_g": self.fast_ss.B, "C_g": self.fast_ss.C,
            "A_f": self.fr.A, "B_f": self.fr.B, "C_f": self.fr.C, "D_f": self.fr.D,
            "Hp": self.mats.Hp, "S": self.S_pad, "Km": self.mats.Km,
            "Shift": self.Shift, "Inj": self.Inj, "Eref": self.Eref,
            "L": self.L, "R": self.R,
        }
        return {k: torch.as_tensor(np.asarray(v, dtype=np.float64),
                                   dtype=dtype, device=device)
                for k, v in c.items()}

    def simulate_scan(self, r: np.ndarray, q: np.ndarray, nit: int,
                      dtype=torch.float64, device="cuda"):
        """O(nit) recursive loop of one scenario (a B = 1
        ``simulate_scan_batch``); same trajectory as ``simulate_ref``.
        Returns NumPy (y (nit, ny), u (nit, nu))."""
        Y, U = self.simulate_scan_batch(np.asarray(r)[None],
                                        np.asarray(q)[None], nit, dtype,
                                        device)
        return Y[0].cpu().numpy(), U[0].cpu().numpy()

    def simulate_scan_batch(self, r_b: np.ndarray, q_b: np.ndarray, nit: int,
                            dtype=torch.float64, device="cuda"):
        """Batched loop: one lane per (setpoint, disturbance) scenario — the
        scenario-sweep / benchmark path.  r_b (B, nit, ny), q_b (B, nit,
        nq).  Returns tensors on ``device`` (Y (B, nit, ny), U (B, nit,
        nu))."""
        c = self.scan_constants(dtype, device)
        as_t = lambda a: torch.as_tensor(
            np.array(np.asarray(a)[:, :nit], dtype=np.float64), dtype=dtype,
            device=device)
        return scan_loop(c, as_t(r_b), as_t(q_b), self.yd_width)


class _LinearMaps:
    """The maps that read one input vector, stacked row-wise: ``apply(x)``
    for x (B, K) returns x @ M.T for each map M (m_i, K), every output a
    chain of elementwise multiply-adds over k = 0 .. K - 1 in ascending
    order (``torch.addcmul``), so a lane's bits follow neither its slot nor
    the batch's size.  One launch per k, whatever the number of maps (an
    input of no entries, K = 0, gives zeros)."""

    def __init__(self, *mats):
        M = torch.cat(mats, dim=0)
        self.splits = [m.shape[0] for m in mats]
        self.cols = [M[:, k].contiguous() for k in range(M.shape[1])]
        self.zero = M.new_zeros(M.shape[0])

    def apply(self, x):
        if not self.cols:
            return torch.split(self.zero.expand(x.shape[0], -1),
                               self.splits, dim=1)
        acc = x[:, :1] * self.cols[0]
        for k in range(1, len(self.cols)):
            acc = torch.addcmul(acc, x[:, k:k + 1], self.cols[k])
        return torch.split(acc, self.splits, dim=1)


def scan_loop(c: dict, r: torch.Tensor, q: torch.Tensor, yd_width: int):
    """The DTC-GPC closed loop (the JAX package's ``_scan_core``, every lane
    at once): c the step's constants (SCAN_KEYS, as tensors), r (B, nit,
    ny) setpoints and q (B, nit, nq) measured disturbances in raw units.
    Each step: measure the plant (strictly proper: D ignored), the
    conditioned output, the optimal predictor (fast model plus filtered
    model error), the predictor-output history shifted by one column, the
    free response, the first move, then the input integration and the
    plant, model, fast-model and filter updates.  Returns (Y (B, nit, ny),
    U (B, nit, nu))."""
    pin_precision()
    B, nit, ny = r.shape
    nu = c["R"].shape[0]
    kw = dict(dtype=r.dtype, device=r.device)
    # the maps by their input (the order within each is the JAX step's)
    on_xpl = _LinearMaps(c["C_pl"], c["A_pl"])
    on_y = _LinearMaps(c["L"])
    on_xm = _LinearMaps(c["C_m"], c["A_m"])
    on_xg = _LinearMaps(c["C_g"], c["A_g"])
    on_xf = _LinearMaps(c["C_f"], c["A_f"])
    on_eM = _LinearMaps(c["D_f"], c["B_f"])
    on_up = _LinearMaps(c["Hp"], c["Shift"])
    on_Yd = _LinearMaps(c["S"])
    on_r = _LinearMaps(c["L"])
    on_re = _LinearMaps(c["Eref"])
    on_err = _LinearMaps(c["Km"])
    on_dU = _LinearMaps(c["Inj"])
    on_ue = _LinearMaps(c["R"], c["B_m"], c["B_g"])
    on_uq = _LinearMaps(c["B_pl"])

    zeros = lambda *s: torch.zeros((B,) + s, **kw)
    x_pl, x_m = zeros(c["A_pl"].shape[0]), zeros(c["A_m"].shape[0])
    x_g, x_f = zeros(c["A_g"].shape[0]), zeros(c["A_f"].shape[0])
    up, ue = zeros(c["Hp"].shape[1]), zeros(nu)
    ydb = zeros(ny, yd_width)  # predictor outputs, newest in column 0
    Y = torch.empty((B, nit, ny), **kw)
    U = torch.empty((B, nit, nu), **kw)
    for k in range(nit):
        y, Ax_pl = on_xpl.apply(x_pl)
        (ye,) = on_y.apply(y)
        ym, Ax_m = on_xm.apply(x_m)
        eM = ye - ym
        yg, Ax_g = on_xg.apply(x_g)
        yfx, Ax_f = on_xf.apply(x_f)
        yfe, Bf_eM = on_eM.apply(eM)
        yp = yg + (yfx + yfe)

        ydb = torch.cat([yp[:, :, None], ydb[:, :, :-1]], dim=2)
        Hp_up, Sh_up = on_up.apply(up)
        (S_Yd,) = on_Yd.apply(ydb.reshape(B, -1))
        yf = Hp_up + S_Yd
        (re,) = on_r.apply(r[:, k])
        (ref,) = on_re.apply(re)
        (dU,) = on_err.apply(ref - yf)

        (Inj_dU,) = on_dU.apply(dU)
        up = Sh_up + Inj_dU
        ue = ue + dU
        u, Bm_ue, Bg_ue = on_ue.apply(ue)

        (B_uq,) = on_uq.apply(torch.cat([u, q[:, k]], dim=1))
        x_pl = Ax_pl + B_uq
        x_m = Ax_m + Bm_ue
        x_g = Ax_g + Bg_ue
        x_f = Ax_f + Bf_eM
        Y[:, k] = y
        U[:, k] = u
    return Y, U
