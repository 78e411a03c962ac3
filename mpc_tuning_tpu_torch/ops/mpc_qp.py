"""Condensed linear MPC QP: the port of the JAX package's ``ops/mpc_qp.py``.

Implements the documented MATLAB MPC Toolbox formulation that the reference
drives through ``sim``/``mpcmove`` (MPC-Tuning/MPC_Tuning/closedloop_toolbox.m:36-50):
  cost      J = sum_i |Q^(1/2) (r - y(k+i|k))|^2            i = 1..p
              + sum_t |R^(1/2) du(k+t)|^2                   t = 0..m-1
              + rho_eps * eps^2
  s.t.      dumin <= du <= dumax                 (hard)
            umin  <= u(k+t) <= umax              (hard)
            ymin - eps*Vmin <= y <= ymax + eps*Vmax   (soft, ECR)
            eps >= 0

The host half (``MPCSpec``, ``MPCController``, ``build_controller``) is the
float64 NumPy code of the JAX package, unchanged.  The device half is torch
with the candidate batch as an explicit leading axis: everything is built
at the maximum horizons (p_max, m_max) and a candidate (N, Nu, delta,
lambda) enters only through masks and diagonal weights.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpc_tuning_tpu_torch.models.lti import DiscreteSS
from mpc_tuning_tpu_torch.ops.observer import AugmentedModel, augment_with_output_disturbance

__all__ = ["MPCSpec", "MPCController", "build_controller", "controller_arrays",
           "assemble_candidate", "qp_step_data", "pin_precision"]


@dataclasses.dataclass
class MPCSpec:
    """Case-static MPC definition, in (conditioned) model units.

    Mirrors the mpc-object configuration of the reference drivers
    (WoodBerry.m:118-148, Shell7x5.m:100-189): bounds, ECR softening,
    ScaleFactors, max horizons.
    """

    model: DiscreteSS  # conditioned prediction model, inputs [MV, MD]
    n_mv: int
    n_md: int
    p_max: int
    m_max: int
    umin: np.ndarray
    umax: np.ndarray
    dumin: np.ndarray
    dumax: np.ndarray
    ymin: np.ndarray  # +-inf where unconstrained
    ymax: np.ndarray
    v_ymin: np.ndarray | None = None  # MinECR per output (default 1)
    v_ymax: np.ndarray | None = None
    rho_eps: float = 1e5
    sf_u: np.ndarray | None = None  # MV ScaleFactors
    sf_y: np.ndarray | None = None  # OV ScaleFactors
    sf_v: np.ndarray | None = None  # MD ScaleFactors

    def __post_init__(self):
        ny = self.model.ny
        nu = self.n_mv
        nd = self.n_md
        if self.v_ymin is None:
            self.v_ymin = np.ones(ny)
        if self.v_ymax is None:
            self.v_ymax = np.ones(ny)
        if self.sf_u is None:
            self.sf_u = np.ones(nu)
        if self.sf_y is None:
            self.sf_y = np.ones(ny)
        if self.sf_v is None:
            self.sf_v = np.ones(nd)

    @property
    def has_y_constraints(self) -> bool:
        return bool(np.any(np.isfinite(self.ymin)) or np.any(np.isfinite(self.ymax)))


@dataclasses.dataclass
class MPCController:
    """Host-precomputed controller data (numpy float64).  The torch loops
    convert to device arrays once per case."""

    spec: MPCSpec
    aug: AugmentedModel
    # scaled-unit augmented model
    A: np.ndarray
    Bu: np.ndarray
    Bv: np.ndarray
    C: np.ndarray
    Dv: np.ndarray
    M: np.ndarray
    # prediction tensors at max horizons (scaled units)
    Sx: np.ndarray  # (p_max, ny, nxa)
    Sstep: np.ndarray  # (p_max+1, ny, nu): sum_{j<q} C A^j Bu
    Sv: np.ndarray  # (p_max, ny, nd)
    Theta: np.ndarray  # (p_max*ny, m_max*nu) Toeplitz of Sstep
    Tcum: np.ndarray  # (m_max*nu, m_max*nu) cumulative-sum map du -> u-u_prev
    # scaled bounds
    umin_s: np.ndarray
    umax_s: np.ndarray
    dumin_s: np.ndarray
    dumax_s: np.ndarray
    ymin_s: np.ndarray
    ymax_s: np.ndarray


def build_controller(spec: MPCSpec, q_plant: float = 0.0) -> MPCController:
    ss = spec.model
    nu, nd, ny = spec.n_mv, spec.n_md, ss.ny
    Bu_r, Bv_r = ss.B[:, :nu], ss.B[:, nu:]
    Dv_r = ss.D[:, nu:]
    if np.any(np.abs(ss.D[:, :nu]) > 0):
        raise ValueError("direct MV feedthrough unsupported (plants are strictly proper)")

    # ScaleFactor units: u = sf_u*u_s, y = sf_y*y_s, v = sf_v*v_s
    Bu = Bu_r * spec.sf_u[None, :]
    Bv = Bv_r * spec.sf_v[None, :] if nd else Bv_r
    C = ss.C / spec.sf_y[:, None]
    Dv = (Dv_r * spec.sf_v[None, :]) / spec.sf_y[:, None] if nd else Dv_r

    aug = augment_with_output_disturbance(ss.A, Bu, Bv, C, Dv, q_plant=q_plant)

    p_max, m_max = spec.p_max, spec.m_max
    nxa = aug.nx
    Sx = np.zeros((p_max, ny, nxa))
    Sstep = np.zeros((p_max + 1, ny, nu))
    Sv = np.zeros((p_max, ny, nd))
    Ai = np.eye(nxa)
    acc_u = np.zeros((ny, nu))
    acc_v = np.zeros((ny, nd))
    for i in range(1, p_max + 1):
        acc_u = acc_u + aug.C @ Ai @ aug.Bu
        acc_v = acc_v + aug.C @ Ai @ aug.Bv
        Ai = aug.A @ Ai  # A^i
        Sx[i - 1] = aug.C @ Ai
        Sstep[i] = acc_u
        Sv[i - 1] = acc_v + aug.Dv

    Theta = np.zeros((p_max, ny, m_max, nu))
    for i in range(1, p_max + 1):
        for t in range(min(i, m_max)):
            Theta[i - 1, :, t, :] = Sstep[i - t]
    Theta = Theta.reshape(p_max * ny, m_max * nu)

    # cumulative map: (u(k+t) - u(k-1))_j = sum_{tau<=t} du_j(tau)
    Tc = np.kron(np.tril(np.ones((m_max, m_max))), np.eye(nu))

    return MPCController(
        spec=spec, aug=aug,
        A=aug.A, Bu=aug.Bu, Bv=aug.Bv, C=aug.C, Dv=aug.Dv, M=aug.M,
        Sx=Sx, Sstep=Sstep, Sv=Sv, Theta=Theta, Tcum=Tc,
        umin_s=spec.umin / spec.sf_u, umax_s=spec.umax / spec.sf_u,
        dumin_s=spec.dumin / spec.sf_u, dumax_s=spec.dumax / spec.sf_u,
        ymin_s=spec.ymin / spec.sf_y, ymax_s=spec.ymax / spec.sf_y,
    )


def pin_precision():
    """Full-precision float32 matmuls on the card (no TF32).  Candidate
    tables (H = Theta'Q Theta, the ADMM GtG and Minv, T2) built at reduced
    matmul precision carried ~1e-2 du error in the reference
    (the JAX package's sim/mpc_loop.py:775-790); TF32 is the same trap."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def controller_arrays(ctl: MPCController, dtype, device) -> dict:
    """Device-ready constant dict (the JAX ``controller_arrays`` keys)."""
    spec = ctl.spec

    def fin(x, alt=0.0):
        m = np.isfinite(x) & (np.abs(x) < 1e20)
        return np.where(m, x, alt), m.astype(np.float64)

    umin_f, en_u_lo = fin(ctl.umin_s)
    umax_f, en_u_hi = fin(ctl.umax_s)
    dumin_f, en_du_lo = fin(ctl.dumin_s)
    dumax_f, en_du_hi = fin(ctl.dumax_s)
    ymin_f, en_y_lo = fin(ctl.ymin_s)
    ymax_f, en_y_hi = fin(ctl.ymax_s)
    out = {
        "A": ctl.A, "Bu": ctl.Bu, "Bv": ctl.Bv, "C": ctl.C, "Dv": ctl.Dv,
        "M": ctl.M, "Sx": ctl.Sx, "Sstep": ctl.Sstep, "Sv": ctl.Sv,
        "Theta": ctl.Theta, "Tcum": ctl.Tcum,
        "umin": umin_f, "umax": umax_f,
        "dumin": dumin_f, "dumax": dumax_f,
        "ymin": ymin_f, "ymax": ymax_f,
        # finite-bound row enables: +-inf bounds become disabled QP rows
        "en_u_lo": en_u_lo, "en_u_hi": en_u_hi,
        "en_du_lo": en_du_lo, "en_du_hi": en_du_hi,
        "en_y_lo": en_y_lo, "en_y_hi": en_y_hi,
        "vymin": spec.v_ymin, "vymax": spec.v_ymax,
        "sf_u": spec.sf_u, "sf_y": spec.sf_y,
        "sf_v": spec.sf_v if spec.n_md else np.zeros(0),
    }

    # shared constraint matrix G0 (candidates enter through row/variable
    # 0/1 masks) and its row outer products T2[k] = vec(G0[k] G0[k]^T)
    p_max, m_max, nu = spec.p_max, spec.m_max, spec.n_mv
    n = m_max * nu + 1
    I_du = np.eye(m_max * nu)
    Tc = ctl.Tcum
    zero_col = np.zeros((m_max * nu, 1))
    ones_m = np.ones(m_max)
    blocks = [
        np.hstack([I_du, zero_col]) * np.kron(ones_m, en_du_hi)[:, None],
        np.hstack([-I_du, zero_col]) * np.kron(ones_m, en_du_lo)[:, None],
        np.hstack([Tc, zero_col]) * np.kron(ones_m, en_u_hi)[:, None],
        np.hstack([-Tc, zero_col]) * np.kron(ones_m, en_u_lo)[:, None],
    ]
    if spec.has_y_constraints:
        vmax_col = np.tile(spec.v_ymax, p_max).reshape(-1, 1)
        vmin_col = np.tile(spec.v_ymin, p_max).reshape(-1, 1)
        blocks.append(np.hstack([ctl.Theta, -vmax_col]) * np.tile(en_y_hi, p_max)[:, None])
        blocks.append(np.hstack([-ctl.Theta, -vmin_col]) * np.tile(en_y_lo, p_max)[:, None])
    eps_row = np.zeros((1, n))
    eps_row[0, -1] = -1.0
    blocks.append(eps_row)
    G0 = np.vstack(blocks)
    out["G0"] = G0
    out["T2"] = np.einsum("ki,kj->kij", G0, G0).reshape(G0.shape[0], n * n)

    return {k: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
            for k, v in out.items()}


def assemble_candidate(c: dict, N, Nu, delta, lam, p_max: int, m_max: int,
                       ny: int, nu: int, rho_eps: float, with_y: bool = False):
    """Per-candidate QP data for a batch.

    N, Nu: (B,) integer tensors (shared horizon maxima per candidate, as the
    reference applies max(N)/max(Nu), closedloop_toolbox.m:39-43); delta
    (B, ny), lam (B, nu).  Returns a dict of (B, ...) tensors: H (n, n),
    G (mc, n), QTheta (p_max*ny, m_max*nu), the masks, the stage-0 slack
    LP of the band solve (H_lp, f_lp) and, for tracking cases, the ADMM
    precompute.  ``with_y`` adds the soft output-band rows (band cases;
    they never run ADMM, so the precompute is skipped for them).
    """
    from mpc_tuning_tpu_torch.ops.qp import admm_precompute

    Theta0 = c["Theta"]
    dtype, dev = Theta0.dtype, Theta0.device
    B = N.shape[0]
    i_idx = torch.arange(1, p_max + 1, device=dev)
    t_idx = torch.arange(m_max, device=dev)
    row_mask = (i_idx[None, :] <= N[:, None]).to(dtype)     # (B, p_max)
    col_mask = (t_idx[None, :] < Nu[:, None]).to(dtype)     # (B, m_max)

    q_flat = (delta[:, None, :] ** 2 * row_mask[:, :, None]).reshape(B, -1)
    r_flat = (lam[:, None, :] ** 2 * col_mask[:, :, None]).reshape(B, -1)
    cmask_flat = col_mask.repeat_interleave(nu, dim=1)       # (B, m*nu)

    Theta = Theta0[None] * cmask_flat[:, None, :]
    QTheta = Theta * q_flat[:, :, None]
    Hdu = 2.0 * (Theta.transpose(1, 2) @ QTheta
                 + torch.diag_embed(r_flat + (1.0 - cmask_flat)))

    n = m_max * nu + 1
    H = torch.zeros((B, n, n), dtype=dtype, device=dev)
    H[:, :-1, :-1] = Hdu
    H[:, -1, -1] = 2.0 * rho_eps

    # constraint matrix; rows for +-inf bounds are disabled via en_* masks
    en_du_hi = cmask_flat * c["en_du_hi"].repeat(m_max)
    en_du_lo = cmask_flat * c["en_du_lo"].repeat(m_max)
    en_u_hi = cmask_flat * c["en_u_hi"].repeat(m_max)
    en_u_lo = cmask_flat * c["en_u_lo"].repeat(m_max)
    I_du = torch.eye(m_max * nu, dtype=dtype, device=dev).expand(B, -1, -1)
    Tcum = c["Tcum"][None] * cmask_flat[:, None, :]
    zero_col = torch.zeros((B, m_max * nu, 1), dtype=dtype, device=dev)
    blocks = [
        torch.cat([I_du, zero_col], 2) * en_du_hi[:, :, None],    # du <= dumax
        torch.cat([-I_du, zero_col], 2) * en_du_lo[:, :, None],   # -du <= -dumin
        torch.cat([Tcum, zero_col], 2) * en_u_hi[:, :, None],     # u <= umax
        torch.cat([-Tcum, zero_col], 2) * en_u_lo[:, :, None],    # -u <= -umin
    ]
    one = torch.ones((B, 1), dtype=dtype, device=dev)
    rparts = [cmask_flat] * 4
    if with_y:
        # soft bands  y <= ymax + eps*Vmax,  -y <= -ymin + eps*Vmin
        rm_rep = row_mask.repeat_interleave(ny, dim=1)           # (B, p*ny)
        en_y_hi = (rm_rep * c["en_y_hi"].repeat(p_max))[:, :, None]
        en_y_lo = (rm_rep * c["en_y_lo"].repeat(p_max))[:, :, None]
        vmax_col = c["vymax"].repeat(p_max)[None, :, None].expand(B, -1, 1)
        vmin_col = c["vymin"].repeat(p_max)[None, :, None].expand(B, -1, 1)
        blocks.append(torch.cat([Theta, -vmax_col], 2) * en_y_hi)
        blocks.append(torch.cat([-Theta, -vmin_col], 2) * en_y_lo)
        rparts += [rm_rep] * 2
    eps_row = torch.zeros((B, 1, n), dtype=dtype, device=dev)
    eps_row[:, 0, -1] = -1.0
    blocks.append(eps_row)                                       # -eps <= 0
    G = torch.cat(blocks, dim=1)

    # masks of the shared-G0 structured solver: G == diag(rmask) G0
    # diag(cmask_z) exactly
    rmask = torch.cat(rparts + [one], dim=1)
    cmask_z = torch.cat([cmask_flat, one], dim=1)

    # Stage-0 slack LP of the band solve: minimize eps + (sigma/2)||du||^2
    # over the same constraint set (the JAX package's assemble_candidate
    # notes).  sigma sits at the precision's noise floor: it biases the
    # LP's du by ~sigma, and 1e-6 clears the band oracle's 1e-6 gate at f64.
    sigma_lp = 1e-6 if dtype == torch.float64 else 1e-4
    sig = torch.full((B, 1), sigma_lp, dtype=dtype, device=dev)
    lp_diag = torch.cat([2.0 * (sigma_lp * cmask_flat + (1.0 - cmask_flat)),
                         2.0 * sig], dim=1)
    f_lp = torch.zeros((B, n), dtype=dtype, device=dev)
    f_lp[:, -1] = 1.0

    out = {
        "H_lp": torch.diag_embed(lp_diag), "f_lp": f_lp,
        "H": H, "G": G, "Theta": Theta, "QTheta": QTheta,
        "row_mask": row_mask, "col_mask": col_mask,
        "cmask_flat": cmask_flat, "rmask": rmask, "cmask_z": cmask_z,
        "en_du_hi": en_du_hi, "en_du_lo": en_du_lo,
        "en_u_hi": en_u_hi, "en_u_lo": en_u_lo,
    }
    if not with_y:
        out["admm"] = admm_precompute(H, G, cmask=cmask_z)
    return out


def qp_step_data(c: dict, cand: dict, x_hat, u_prev, r_s, v_s,
                 p_max: int, m_max: int, ny: int, nu: int,
                 with_y: bool = False):
    """Per-timestep QP linear term f (B, n) and rhs h (B, mc) for a batch:
    x_hat (B, nxa), u_prev (B, nu), r_s (B, ny), v_s (nd,) shared.

    free response: y(k+i|k) with du=0 = Sx[i] x_hat + Sstep[i] u_prev + Sv[i] v.
    """
    dtype = x_hat.dtype
    B = x_hat.shape[0]
    free = (torch.einsum("pij,bj->bpi", c["Sx"], x_hat)
            + torch.einsum("pij,bj->bpi", c["Sstep"][1:], u_prev))
    if v_s.shape[0]:
        free = free + torch.einsum("pij,j->pi", c["Sv"], v_s)[None]
    e = (r_s[:, None, :] - free).reshape(B, -1)
    f_du = -2.0 * torch.einsum("bkj,bk->bj", cand["QTheta"], e)
    zero = torch.zeros((B, 1), dtype=dtype, device=x_hat.device)
    f = torch.cat([f_du, zero], dim=1)

    h = [
        c["dumax"].repeat(m_max) * cand["en_du_hi"] + (1.0 - cand["en_du_hi"]),
        -c["dumin"].repeat(m_max) * cand["en_du_lo"] + (1.0 - cand["en_du_lo"]),
        (c["umax"][None] - u_prev).repeat(1, m_max) * cand["en_u_hi"]
        + (1.0 - cand["en_u_hi"]),
        (u_prev - c["umin"][None]).repeat(1, m_max) * cand["en_u_lo"]
        + (1.0 - cand["en_u_lo"]),
    ]
    if with_y:
        rm_rep = cand["row_mask"].repeat_interleave(ny, dim=1)
        rm_hi = rm_rep * c["en_y_hi"].repeat(p_max)
        rm_lo = rm_rep * c["en_y_lo"].repeat(p_max)
        free_flat = free.reshape(B, -1)
        h.append((c["ymax"].repeat(p_max) - free_flat) * rm_hi + (1.0 - rm_hi))
        h.append((free_flat - c["ymin"].repeat(p_max)) * rm_lo + (1.0 - rm_lo))
    return f, torch.cat(h + [zero], dim=1), free
