"""Tuning objectives evaluated as batched closed-loop simulations.

GAM objective (GAM_fun.m:79-117): per-output SSE of the closed loop against
the desired reference trajectory Yref, with the candidate weights.

VNS objective (VNS2.m:148-195): per candidate (N, Nu),
  j21 — closed loop vs single-shot open-loop playback mismatch,
  j22 — closed loop vs Yref,
  Jnu — squared ratio of the first open-loop control move to subsequent
        increments (horizon-parsimony penalty, NaN/Inf -> 0),
  F = sum(j21 + j22) + N + sum(Jnu),
with the square-system per-output setpoint-selector protocol
(unit steps at inK=10 on one output at a time, VNS2.m:58-65,148-165; for a
nonlinear problem the case setpoints of one output at a time,
VNS2.m:68-73,155) and the single-sim protocol with the case setpoints for
non-square systems.

Every candidate (and every selector) is one lane of a batched closed-loop
simulation — the whole neighborhood/population evaluates in one device
call, or, under a candidate mesh (``TuningProblem.mesh``), in one call a
shard (``parallel/sweep.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpc_tuning_tpu_torch.ops.kernels import require_device
from mpc_tuning_tpu_torch.parallel.sweep import CandidateMesh, map_shards
from mpc_tuning_tpu_torch.sim.mpc_loop import (ADMM_ENGINES, ENGINES, MPCLoop,
                                               horizon_caps,
                                               require_band_dtype)
from mpc_tuning_tpu_torch.sim.nmpc_loop import NMPCLoop

__all__ = ["TuningProblem", "gam_sse_batch", "vns_objective_batch",
           "resolve_qp_method"]


def resolve_qp_method(method: str, stage: str = "gam", f64: bool = False,
                      band: bool = False) -> str:
    """'auto' -> the closed-loop engine for this tuning stage; an explicit
    engine name (one of ENGINES) passes through, and MPCLoop raises if it
    does not run the case.

    The policy follows the JAX package's accelerator policy and is the
    same on every device; only the executor differs (plain torch for CPU
    tensors, the CUDA kernels for CUDA tensors):
      * band (y-constrained) cases: 'band_sim' at every stage (the JAX
        '+lp20+split12'; ADMM stalls on the ECR band QP and the joint PDIP
        stalls ~5e-2 off the optimum on band steps), at float64 only: a
        float32 band case raises (its loops leave the hard input bounds);
      * float32, tracking case: GAM -> 'pdip_sim' (ADMM rank-flips the GAM
        objective on extreme CMA weight vectors), VNS -> 'admm_sim' (warm
        40-iteration ADMM preserves the VNS argmin on the WB grid);
      * float64 (the decision-grade path): both stages -> 'pdip_sim'.
    The per-step engines ('pdip_ws_fused', 'pdip_ws_lanes', 'admm_fused':
    the JAX package's engines under a candidate mesh, and its float64
    decision-grade 'pdip_ws_lanes'; the batch-major 'pdip', 'pdip_ws',
    'pdip_dense' and 'admm') run only when named."""
    if method != "auto":
        if method not in ENGINES:
            raise ValueError(f"unknown engine {method!r}; use 'auto' or one "
                             f"of {ENGINES}")
        return method
    if band:
        require_band_dtype(torch.float64 if f64 else torch.float32)
        return "band_sim"
    if stage == "vns" and not f64:
        return "admm_sim"
    return "pdip_sim"


@dataclasses.dataclass
class TuningProblem:
    """Everything the tuner needs about one case (conditioned units).
    ``loop`` is an MPCLoop (linear cases) or an NMPCLoop (nonlinear cases:
    one engine, the qp_method fields unused).  ``mesh`` (a
    ``parallel.sweep.CandidateMesh``): when set, every batch is padded to
    a multiple of its size, each shard evaluated on its device by the
    engine the batch would run unsharded, at the batch's capacity bucket,
    and the outputs gathered; ``device`` is then unused by evaluations."""

    loop: MPCLoop | NMPCLoop
    r: np.ndarray  # (nit, ny) case setpoints (conditioned)
    v: np.ndarray  # (nit, nd) measured disturbance (conditioned)
    Yref: np.ndarray  # (nit, ny) desired response (conditioned)
    nit: int
    w: np.ndarray  # (my,) pareto weights
    band_mask: np.ndarray  # (my,) True where user OV weight == 0 (band control)
    dmin: np.ndarray  # (my,) per-output minimum delay (samples)
    nbp: int
    nbc: int
    inK: int = 10
    goal: float = 0.001
    dtype: torch.dtype = torch.float64
    device: str = "cuda"
    qp_iters: int = 30
    # 'auto' = the stage policy of resolve_qp_method; an explicit engine
    # name overrides it (GAM stage and open leg / VNS closed leg)
    qp_method: str = "auto"
    vns_qp_method: str = "auto"
    admm_iters: int = 40  # warm ADMM iterations when an ADMM engine runs
    mesh: CandidateMesh | None = None

    def __post_init__(self):
        require_device(self.device)
        if not self._nmpc and self.loop.ctl.spec.has_y_constraints:
            require_band_dtype(self.dtype)

    @property
    def _nmpc(self) -> bool:
        return isinstance(self.loop, NMPCLoop)

    @property
    def linear(self) -> bool:
        """False for an NMPCLoop: the nonlinear VNS selector protocol."""
        return not self._nmpc

    @property
    def my(self) -> int:
        return self.loop.spec.ny if self._nmpc else self.loop.ctl.spec.model.ny

    @property
    def nu(self) -> int:
        return self.loop.spec.nu if self._nmpc else self.loop.ctl.spec.n_mv

    @property
    def square(self) -> bool:
        return self.my == self.nu

    def _caps(self, N_b, Nu_b):
        s = self.loop.spec if self._nmpc else self.loop.ctl.spec
        return horizon_caps(s.p_max, s.m_max, N_b, Nu_b)

    def _run(self, evaluate, *batched):
        """``evaluate(device, *batched) -> (Y, U)`` on the whole batch on
        ``device``, or on each shard of ``mesh``; returns NumPy (Y, U),
        C-contiguous either way (NumPy's sums round by the layout).  The
        callers fix the capacity bucket from the whole batch on the host
        before sharding: every shard runs at it."""
        if self.mesh is None:
            Y, U = evaluate(self.device, *batched)
        else:
            Y, U = map_shards(self.mesh, evaluate, *batched)
        return Y.cpu().contiguous().numpy(), U.cpu().contiguous().numpy()

    def engine(self, stage="gam"):
        """The closed-loop engine of ``stage`` (``resolve_qp_method``);
        a mesh does not change it."""
        raw = self.vns_qp_method if stage == "vns" else self.qp_method
        return resolve_qp_method(raw, stage=stage,
                                 f64=self.dtype == torch.float64,
                                 band=self.loop.ctl.spec.has_y_constraints)

    def closed_batch(self, r_b, N_b, Nu_b, delta_b, lam_b, stage="gam"):
        """Batched closed loops; returns NumPy (Y, U) in ``dtype``."""
        caps = self._caps(N_b, Nu_b)
        batched = (np.asarray(r_b, dtype=np.float64), N_b, Nu_b, delta_b,
                   lam_b)
        if self._nmpc:
            return self._run(
                lambda dev, r, N, Nu, d, l: self.loop.closed_batch(
                    r, self.v, N, Nu, d, l, self.nit, self.dtype, caps=caps,
                    device=dev), *batched)
        engine = self.engine(stage)
        iters = self.admm_iters if engine in ADMM_ENGINES else self.qp_iters
        return self._run(
            lambda dev, r, N, Nu, d, l: self.loop.closed_batch(
                r, self.v, N, Nu, d, l, self.nit, self.dtype, iters,
                engine=engine, device=dev, caps=caps), *batched)

    def open_batch(self, rfin_b, N_b, Nu_b, delta_b, lam_b):
        """Batched open-loop playbacks; returns NumPy (Y, U) in ``dtype``.
        Band cases take the closed loop's eps-split (a cold slack LP, then
        the slack-frozen stage 2 at ``qp_iters``), as the JAX package's
        qp_split / qp_lp flags do: MPCLoop.open_batch reads it off the
        case, so the open leg never runs the stalling joint solve."""
        caps = self._caps(N_b, Nu_b)
        extra = () if self._nmpc else (self.qp_iters,)
        return self._run(
            lambda dev, r, N, Nu, d, l: self.loop.open_batch(
                r, self.v, N, Nu, d, l, self.nit, self.dtype, *extra,
                device=dev, caps=caps),
            np.asarray(rfin_b, dtype=np.float64), N_b, Nu_b, delta_b,
            lam_b)


def _apply_band(delta: np.ndarray, band_mask: np.ndarray) -> np.ndarray:
    """Zero user OV weight => band control: delta forced to 0
    (GAM_fun.m:58-72, MPC_TFob.m:83-93)."""
    return np.where(band_mask, 0.0, delta)


def gam_sse_batch(problem: TuningProblem, N: int, Nu: int, X: np.ndarray) -> np.ndarray:
    """Evaluate the GAM objective for a batch of weight vectors.

    X: (B, my+nu) decision vectors [delta, lambda] (abs is applied, as in
    GAM_fun.m:55-76).  Returns (B, my) per-output SSE vs Yref.
    """
    B = X.shape[0]
    my, nu = problem.my, problem.nu
    delta = _apply_band(np.abs(X[:, :my]), problem.band_mask[None, :])
    lam = np.abs(X[:, my:])
    r_b = np.broadcast_to(problem.r[: problem.nit], (B, problem.nit, my))
    N_b = np.full(B, N, dtype=np.int64)
    Nu_b = np.full(B, Nu, dtype=np.int64)
    Y, _ = problem.closed_batch(r_b, N_b, Nu_b, delta, lam)
    err = np.asarray(Y) - problem.Yref[None, : problem.nit, :]
    return np.sum(err * err, axis=1)  # (B, my)


def vns_objective_batch(
    problem: TuningProblem,
    N_b: np.ndarray,  # (B,) shared prediction horizon per candidate
    Nu_b: np.ndarray,  # (B,) max control horizon per candidate
    delta: np.ndarray,  # (my,) current weights
    lam: np.ndarray,  # (nu,)
    return_parts: bool = False,
) -> np.ndarray:
    """VNS cost F for each candidate (VNS2.m:171-195).  Returns (B,), or
    (F, {"j21", "j22", "Jnu"}) when ``return_parts`` (each (B,)) — used by
    the parity cross-evaluation and the band-objective audit."""
    B = len(N_b)
    my, nu, nit, inK = problem.my, problem.nu, problem.nit, problem.inK
    # weights may be shared (my,)/(nu,) — the VNS neighborhood case — or
    # per-candidate (B, my)/(B, nu): the weight-search decision path
    # scores a LAMBDA grid in one batched device call instead of B
    # latency-bound B=1 calls
    delta = np.abs(np.asarray(delta, dtype=np.float64))
    lam = np.abs(np.asarray(lam, dtype=np.float64))
    if delta.ndim == 1:
        delta = np.broadcast_to(delta, (B, my))
    if lam.ndim == 1:
        lam = np.broadcast_to(lam, (B, nu))
    delta = _apply_band(delta, problem.band_mask[None, :])

    if problem.square:
        # lane (cand, output i) simulates with a setpoint on output i only:
        # a unit step at inK (linear, VNS2.m:58-65) or the case setpoint
        # (nonlinear: Xsp .* sel, VNS2.m:68-73,155)
        steps = np.zeros((my, nit, my))
        for i in range(my):
            if problem.linear:
                steps[i, inK - 1 :, i] = 1.0
            else:
                steps[i, :, i] = problem.r[:nit, i]
        rfin = steps[:, -1, :]  # (my, my): final setpoint per selector lane
        rfin_b = np.broadcast_to(rfin[None], (B, my, my)).reshape(B * my, my)
        r_b = np.broadcast_to(steps[None], (B, my, nit, my)).reshape(B * my, nit, my)
        N_l = np.repeat(N_b, my)
        Nu_l = np.repeat(Nu_b, my)
        d_l = np.repeat(delta, my, axis=0)
        l_l = np.repeat(lam, my, axis=0)
        Yc, Uc = problem.closed_batch(r_b, N_l, Nu_l, d_l, l_l, stage="vns")
        Yo, Uo = problem.open_batch(rfin_b, N_l, Nu_l, d_l, l_l)
        Yc = np.asarray(Yc).reshape(B, my, nit, my)
        Yo = np.asarray(Yo).reshape(B, my, nit, my)
        Uo = np.asarray(Uo).reshape(B, my, nit, nu)
        # take row i from lane i (VNS2.m:156-160)
        idx = np.arange(my)
        Xy = Yc[:, idx, :, idx].transpose(1, 0, 2)  # (B, my, nit)
        Xyma = Yo[:, idx, :, idx].transpose(1, 0, 2)
        Xuma = Uo[:, idx, :, idx].transpose(1, 0, 2)  # (B, ny, nit), square
    else:
        r_b = np.broadcast_to(problem.r[:nit], (B, nit, my))
        rfin_b = np.broadcast_to(problem.r[nit - 1], (B, my))
        d_b = delta
        l_b = lam
        Yc, Uc = problem.closed_batch(r_b, N_b, Nu_b, d_b, l_b, stage="vns")
        Yo, Uo = problem.open_batch(rfin_b, N_b, Nu_b, d_b, l_b)
        Xy = np.asarray(Yc).transpose(0, 2, 1)  # (B, my, nit)
        Xyma = np.asarray(Yo).transpose(0, 2, 1)
        Xuma = np.asarray(Uo).transpose(0, 2, 1)  # (B, nu, nit)

    k0 = inK - 1  # MATLAB inK 1-indexed
    e2 = Xy[:, :, k0:] - Xyma[:, :, k0:]
    eref = Xy[:, :, k0:] - problem.Yref[:nit].T[None, :, k0:]
    j21 = np.sum(e2 * e2, axis=(1, 2))
    j22 = np.sum(eref * eref, axis=(1, 2))

    # Jnu: "was there a SIGNIFICANT change relative to the previous control
    # increment" (VNS2.m:181-191).  The reference guards only exact 0/NaN
    # increments (MATLAB f64 zero-pads Uopt past the control horizon, so
    # held moves divide 0 exactly); any fixed-precision engine instead
    # produces denormal-tiny increments whose squared ratios explode by
    # 1e20+ and whose value flips between f32 and f64.  A relative
    # threshold — increments below 1e-6 of the first move are "no change",
    # contributing 0 exactly like the reference's Inf/NaN guard — makes the
    # objective precision-stable while preserving its meaning.
    dff = np.abs(np.diff(Xuma, axis=2))
    u1 = np.abs(Xuma[:, :, :1])
    sig = dff > 1e-6 * (u1 + 1e-12)
    with np.errstate(divide="ignore", invalid="ignore"):
        Xnu = np.where(sig, u1 / dff, 0.0)
    Xnu[~np.isfinite(Xnu)] = 0.0
    Jnu = np.sum(Xnu * Xnu, axis=(1, 2))

    F = j21 + j22 + N_b.astype(np.float64) + Jnu
    if return_parts:
        return F, {"j21": j21, "j22": j22, "Jnu": Jnu}
    return F
