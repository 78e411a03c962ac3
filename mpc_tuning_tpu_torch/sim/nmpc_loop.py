"""Direct single-shooting NMPC: the port of the JAX package's
``sim/nmpc_loop.py`` (the reference's ``nlmpc`` / ``nlmpcmove`` path,
MPC-Tuning/MPC_Tuning/closedloop_toolbox_nmpc.m:67-94).

Per control step the decision variables are the control increments over
the control horizon (held after); the prediction is a fixed-substep rollout
of the explicit model; the NLP is solved by a fixed number of Gauss-Newton
SQP iterations whose QP subproblem (hard MV bounds, soft OV bounds with a
slack) is the dense PDIP ``ops/qp.solve_qp``.  Everything is sized at
(p_max, m_max), candidate horizons enter through masks, and candidates are
the leading batch axis.

What runs where: the rollout, its sensitivities (the JAX package's
``jax.jacfwd``), the plant step and the open leg's playback are
``ops/kernels.nmpc_rollout`` (one CUDA launch each on the card; the plain
version on the CPU); the SQP subproblem's factor and solves are
``ops/kernels.spd_factor`` / ``spd_factor_solve``; the rest is eager
PyTorch.  On the card the rollout kernel covers the Van de Vusse rhs with
either integrator, RK4 or the stiff TR-BDF2 (``models/ode.nmpc_envelope``);
another rhs runs with ``device="cpu"``.

State feedback is direct (closedloop_toolbox_nmpc.m:69): no observer.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpc_tuning_tpu_torch.models.ode import rollout_inputs
from mpc_tuning_tpu_torch.ops.kernels import nmpc_rollout, require_device
from mpc_tuning_tpu_torch.ops.mpc_qp import pin_precision
from mpc_tuning_tpu_torch.ops.qp import lane_baddbmm, lane_mm, solve_qp
from mpc_tuning_tpu_torch.sim.mpc_loop import (card_lanes, horizon_caps,
                                               pad_lanes)

__all__ = ["NMPCSpec", "NMPCLoop", "nmpc_closed_core", "nmpc_open_core"]


@dataclasses.dataclass
class NMPCSpec:
    rhs: object  # rhs(x, u) -> dx/dt, batched over leading axes
    nx: int
    ny: int
    nu: int
    xc: tuple  # indices of the controlled states (0-based)
    Ts: float
    p_max: int
    m_max: int
    umin: np.ndarray
    umax: np.ndarray
    ymin: np.ndarray
    ymax: np.ndarray
    sf_u: np.ndarray
    sf_y: np.ndarray
    x0: np.ndarray
    u0: np.ndarray
    rho_eps: float = 1e5
    substeps: int = 10
    sqp_iters: int = 4
    qp_iters: int = 25
    # prediction and plant integrator: 'rk4' or 'tr_bdf2'
    integrator: str = "rk4"


@dataclasses.dataclass
class NMPCLoop:
    spec: NMPCSpec
    _cap_cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                         compare=False)

    def capped(self, p_cap: int, m_cap: int) -> "NMPCLoop":
        """Capacity-restricted view: the rollout length and move count
        shrink to the batch's bucket (the JAX package's ``capped``, the
        same bucket cache)."""
        s = self.spec
        if (p_cap, m_cap) == (s.p_max, s.m_max):
            return self
        assert p_cap <= s.p_max and m_cap <= s.m_max, (p_cap, m_cap)
        key = (p_cap, m_cap)
        hit = self._cap_cache.get(key)
        if hit is None:
            hit = NMPCLoop(spec=dataclasses.replace(s, p_max=p_cap,
                                                    m_max=m_cap))
            self._cap_cache[key] = hit
        return hit

    def _consts(self, dtype, device):
        s = self.spec
        fin = lambda x: np.where(np.isfinite(x) & (np.abs(x) < 1e20), x, 0.0)
        en = lambda x: (np.isfinite(x) & (np.abs(x) < 1e20)).astype(np.float64)
        Tcum = np.kron(np.tril(np.ones((s.m_max, s.m_max))), np.eye(s.nu))
        arrays = dict(umin=s.umin, umax=s.umax, ymin=fin(s.ymin),
                      ymax=fin(s.ymax), en_y_lo=en(s.ymin), en_y_hi=en(s.ymax),
                      sf_u=s.sf_u, sf_y=s.sf_y, x0=s.x0, u0=s.u0, Tcum=Tcum)
        return {k: torch.as_tensor(np.asarray(v, dtype=np.float64),
                                   dtype=dtype, device=device)
                for k, v in arrays.items()}

    @staticmethod
    def _check_no_md(v):
        """The NMPC engine has no measured-disturbance channel (nor has the
        reference's nonlinear path); reject one instead of dropping it."""
        if v is not None and np.asarray(v).ndim >= 2 and np.asarray(v).shape[-1] != 0:
            raise ValueError(
                "NMPCLoop does not support measured disturbances (v must "
                "have 0 columns); thread them through the model rhs instead"
            )

    def _batch(self, v, N_b, Nu_b, caps, dtype, device, *vals):
        """Capped loop, its constants and the batch as device tensors."""
        self._check_no_md(v)
        require_device(device)
        pin_precision()
        if caps is None:
            caps = horizon_caps(self.spec.p_max, self.spec.m_max, N_b, Nu_b)
        loop = self.capped(*caps)
        as_long = lambda x: torch.as_tensor(np.array(x), dtype=torch.long,
                                            device=device)
        as_f = lambda x: torch.as_tensor(np.array(x, dtype=np.float64),
                                         dtype=dtype, device=device)
        return (loop.spec, loop._consts(dtype, device), as_long(N_b),
                as_long(Nu_b), [as_f(x) for x in vals])

    # ------------------------------------------------------------- API
    def closed_batch(self, r_b, v, N_b, Nu_b, delta_b, lam_b, nit,
                     dtype=torch.float64, caps=None, device="cuda"):
        """Closed loops of a candidate batch at the batch's capacity bucket:
        r_b (B, nit, ny), N_b / Nu_b (B,), delta_b (B, ny), lam_b (B, nu).
        Returns (Y (B, nit, ny), U (B, nit, nu)) tensors on ``device``; the
        batch runs padded (``sim/mpc_loop.pad_lanes``: two lanes at least,
        on the card a multiple of ``ops/qp.CARD_LANES``).  A candidate mesh
        shards the batch one level up (``TuningProblem.mesh``)."""
        def loops(r_b, N_b, Nu_b, delta_b, lam_b):
            spec, c, N, Nu, (r, d, l) = self._batch(
                v, N_b, Nu_b, caps, dtype, device, np.asarray(r_b)[:, :nit],
                delta_b, lam_b)
            return nmpc_closed_core(spec, c, r, N, Nu, d, l)

        return pad_lanes(loops, card_lanes(device), r_b, N_b, Nu_b, delta_b,
                         lam_b)

    def open_batch(self, rfin_b, v, N_b, Nu_b, delta_b, lam_b, nit,
                   dtype=torch.float64, caps=None, device="cuda"):
        """One solve at (x0, u0) with the final setpoints rfin_b (B, ny),
        its moves (held) played through the model.  Returns (Y (B, nit,
        ny), U (B, nit, nu)) tensors on ``device``; the batch runs padded
        as ``closed_batch``'s."""
        def loops(rfin_b, N_b, Nu_b, delta_b, lam_b):
            spec, c, N, Nu, (r, d, l) = self._batch(
                v, N_b, Nu_b, caps, dtype, device, rfin_b, delta_b, lam_b)
            return nmpc_open_core(spec, c, r, N, Nu, d, l, nit)

        return pad_lanes(loops, card_lanes(device), rfin_b, N_b, Nu_b,
                         delta_b, lam_b)

    def simulate(self, r, v, nit, N, Nu, delta, lam, dtype=torch.float64,
                 device="cuda"):
        """Closed loop of one candidate at the full (p_max, m_max), as the
        JAX package's ``simulate`` runs it.  Returns NumPy (y (nit, ny),
        u (nit, nu))."""
        s = self.spec
        Y, U = self.closed_batch(
            np.asarray(r)[None], v, [N], [Nu], np.asarray(delta)[None],
            np.asarray(lam)[None], nit, dtype, caps=(s.p_max, s.m_max),
            device=device)
        return Y[0].cpu().numpy(), U[0].cpu().numpy()


# ---------------------------------------------------------------- the loop


def _nmpc_control(spec, c, x, u_prev, rk, N, Nu, delta, lam):
    """One nlmpcmove-equivalent solve per candidate: x (B, nx), u_prev
    (B, nu), rk (B, ny).  Returns the move sequence du (B, m nu) and the
    move mask (B, m)."""
    s = spec
    p, m, ny, nu = s.p_max, s.m_max, s.ny, s.nu
    B = x.shape[0]
    kw = dict(dtype=x.dtype, device=x.device)
    row_mask = (torch.arange(1, p + 1, device=x.device)[None, :]
                <= N[:, None]).to(x.dtype)                      # (B, p)
    col_mask = (torch.arange(m, device=x.device)[None, :]
                < Nu[:, None]).to(x.dtype)                      # (B, m)
    cm = col_mask.repeat_interleave(nu, dim=1)                  # (B, m nu)
    dq = delta / c["sf_y"]
    q = (dq * dq)[:, None, :] * row_mask[:, :, None]
    q = q.reshape(B, p * ny)
    dl = lam / c["sf_u"]
    r_w = (dl * dl).repeat(1, m) * cm
    r_diag = torch.diag_embed(r_w + (1.0 - cm))
    en_hi = row_mask.repeat_interleave(ny, dim=1) * c["en_y_hi"].repeat(p)
    en_lo = row_mask.repeat_interleave(ny, dim=1) * c["en_y_lo"].repeat(p)
    rk_t = rk.repeat(1, p)
    u_tile = u_prev.repeat(1, m)
    nz = m * nu + 1

    zcol = torch.zeros((B, m * nu, 1), **kw)
    Tc = c["Tcum"] * cm[:, :, None]
    G_u = torch.cat([torch.cat([Tc, zcol], 2), torch.cat([-Tc, zcol], 2)], 1)
    neg1 = torch.full((B, p * ny, 1), -1.0, **kw)
    last = torch.zeros((B, 1, nz), **kw)
    last[:, 0, -1] = -1.0
    h_u = torch.cat([c["umax"].repeat(m), -c["umin"].repeat(m)])
    zero1 = torch.zeros((B, 1), **kw)
    H = torch.zeros((B, nz, nz), **kw)
    H[:, -1, -1] = 2.0 * float(s.rho_eps)

    du = torch.zeros((B, m * nu), **kw)
    for _ in range(s.sqp_iters):
        Yf, J = nmpc_rollout(spec, x, u_prev, du, cm, p, jac=True)
        e = Yf - rk_t
        JQ = J * q[:, :, None]
        # batched products in chunks of CARD_LANES on the card, the shared
        # Tcum product lane-major (ops/qp.lane_baddbmm, lane_mm)
        H[:, :-1, :-1] = 2.0 * (lane_baddbmm(None, J.transpose(1, 2), JQ)
                                + r_diag)
        JQe = lane_baddbmm(None, JQ.transpose(1, 2), e[:, :, None])
        f = torch.cat([2.0 * (JQe[:, :, 0] + r_w * du), zero1], 1)
        u_seq = lane_mm(c["Tcum"], (du * cm).T).T + u_tile
        G = torch.cat([G_u, torch.cat([J, neg1], 2) * en_hi[:, :, None],
                       torch.cat([-J, neg1], 2) * en_lo[:, :, None], last], 1)
        h = torch.cat([
            (h_u[:m * nu] - u_seq) * cm + (1 - cm),
            (u_seq + h_u[m * nu:]) * cm + (1 - cm),
            (c["ymax"].repeat(p) - Yf) * en_hi + (1 - en_hi),
            (Yf - c["ymin"].repeat(p)) * en_lo + (1 - en_lo),
            zero1], 1)
        z = solve_qp(H, f, G, h, iters=s.qp_iters)[0]
        du = du + z[:, :-1] * cm
    return du, col_mask


def nmpc_closed_core(spec, c, r, N, Nu, delta, lam, u_follow=None,
                     solve_steps=None):
    """closedloop_toolbox_nmpc.m:60-75 for a candidate batch: u(k) from the
    state x(k-1), then one plant interval; Y[:, 0] = x0[xc].  r (B, nit,
    ny).  ``u_follow`` (B, nit, nu): when given, the loop still computes
    and returns its own U[k], but steps the plant on u_follow[k] (and
    carries it as the previous input), so a run can be compared step by
    step with one that produced u_follow.  ``solve_steps`` (with
    ``u_follow`` only): the steps k at which it computes U[k]; elsewhere
    it solves nothing and returns u_follow[k] (a control step depends only
    on the state, the previous input and r[k], so the steps it solves are
    those of the full run).  Returns (Y, U)."""
    if solve_steps is not None and u_follow is None:
        raise ValueError("solve_steps needs u_follow")
    B, nit, ny = r.shape
    nx, nu, m = spec.nx, spec.nu, spec.m_max
    kw = dict(dtype=r.dtype, device=r.device)
    xc = list(spec.xc)
    x = c["x0"].expand(B, nx).contiguous()
    u_prev = c["u0"].expand(B, nu).contiguous()
    Y, U = torch.empty((B, nit, ny), **kw), torch.empty((B, nit, nu), **kw)
    Y[:, 0], U[:, 0] = x[:, xc], u_prev
    none = torch.zeros((B, 0), **kw)
    for k in range(1, nit):
        if solve_steps is None or k in solve_steps:
            du, col_mask = _nmpc_control(spec, c, x, u_prev, r[:, k], N, Nu,
                                         delta, lam)
            U[:, k] = u_prev + du.reshape(B, m, nu)[:, 0] * col_mask[:, :1]
        else:
            U[:, k] = u_follow[:, k]
        u = (U if u_follow is None else u_follow)[:, k].contiguous()
        x = nmpc_rollout(spec, x, u, none, none, 1, outputs=range(nx))[0]
        Y[:, k] = x[:, xc]
        u_prev = u
    return Y, U


def nmpc_open_core(spec, c, r_final, N, Nu, delta, lam, nit):
    """closedloop_toolbox_nmpc.m:77-94 for a candidate batch: one solve at
    (x0, u0) with the final setpoint r_final (B, ny), the moves held after
    the last active one and played through the model.  Returns (Y (B, nit,
    ny), U (B, nit, nu))."""
    B = r_final.shape[0]
    nx, nu = spec.nx, spec.nu
    x0 = c["x0"].expand(B, nx).contiguous()
    u0 = c["u0"].expand(B, nu).contiguous()
    du, col_mask = _nmpc_control(spec, c, x0, u0, r_final, N, Nu, delta, lam)
    hold = torch.clamp(Nu - 1, min=0).to(torch.int32)
    uopt = rollout_inputs(u0, du, col_mask, hold, nit - 1)
    Y = nmpc_rollout(spec, x0, u0, du, col_mask, nit - 1, hold=hold)[0]
    Y = torch.cat([x0[:, None, list(spec.xc)], Y.reshape(B, nit - 1, -1)], 1)
    return Y, torch.cat([u0[:, None], uopt], 1)
