"""Explicit single-shooting NMPC demo engine (the port of the JAX package's
``sim/explicit_nmpc.py``).

Re-design of Explicit NMPC/{NMPC_Controller.m, ClosedLoopNMPC.m, main.m}:
the hand-rolled fmincon NMPC with

 * per-input control horizons Nu_j (decision = du blocks stacked per input,
   NMPC_Controller.m:15-28),
 * additive output-disturbance (model-error offset) correction: the
   predicted trajectory is shifted by the gap between the measured
   controlled states and a one-step model propagation under u(k-1)
   (NMPC_Controller.m:108-127),
 * hard du bounds derived from absolute MV bounds (li = lb - u(k-1)),
 * closed loop with plant integration + measurement noise on the states
   (ClosedLoopNMPC.m:77-87).

Solved by a fixed number of Gauss-Newton SQP iterations, each one dense
PDIP (``ops/qp.solve_qp``: on the card around the ``spd_factor`` /
``spd_factor_solve`` kernels).  The prediction and its Jacobian (the JAX
package takes ``jax.jacfwd`` of it), the one-step offset model and the
plant step run on the card as the rollout kernel
``ops/kernels.nmpc_rollout`` (one launch each, the move mask per column),
inside its envelope ``models/ode.nmpc_envelope``: the Van de Vusse rhs
with RK4 or TR-BDF2; another rhs or integrator raises there and runs with
``device="cpu"``.  On the CPU the prediction is
``models/ode.rollout_tangent``'s eager rollout with forward
sensitivities (for the Van de Vusse rhs with RK4 in about a third of the
operations of the general ``models/ode.integrate_tangent``), the plant
step and the offset model the kernel's plain version.  The measurement
noise is an input, (nit, nx) or one (nit, nx) array per lane of a batch
(the JAX package draws it with ``jax.random`` inside the loop);
``draw_noise`` draws it from a seeded ``torch.Generator``.  The rest runs
as eager torch ops, every lane of a batch at once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpc_tuning_tpu_torch.models.ode import nmpc_envelope, rollout_tangent
from mpc_tuning_tpu_torch.ops.kernels import nmpc_rollout, require_device
from mpc_tuning_tpu_torch.ops.mpc_qp import pin_precision
from mpc_tuning_tpu_torch.ops.qp import solve_qp

__all__ = ["ExplicitNMPC"]


@dataclasses.dataclass
class ExplicitNMPC:
    rhs: object
    nx: int
    ny: int
    nu: int
    xc: tuple
    Ts: float
    N: int  # prediction horizon (fixed, e.g. 5 — main.m:57)
    Nu: tuple  # per-input control horizons, e.g. (2, 2)
    Q: np.ndarray  # tracking weights (main.m:60: [1.0214 0.9999])
    W: np.ndarray  # du weights (main.m:61: [1e-4 1e-4])
    ub: np.ndarray
    lb: np.ndarray
    substeps: int = 10
    sqp_iters: int = 5
    qp_iters: int = 25
    noise: float = 0.01  # ClosedLoopNMPC.m:77
    # 'rk4' or 'tr_bdf2' (the reference predicts with stiff ode23t,
    # NMPC_Controller.m:99, and integrates the plant with ode45,
    # ClosedLoopNMPC.m:84)
    integrator: str = "rk4"

    def draw_noise(self, nit: int, seed: int = 0):
        """Measurement noise ``noise * randn`` (nit, nx) from a CPU
        torch.Generator seeded with ``seed``.  NumPy."""
        g = torch.Generator().manual_seed(seed)
        return (self.noise * torch.randn((nit, self.nx), generator=g,
                                         dtype=torch.float64)).numpy()

    def simulate(self, x0, u0, r, nit, inK: int = 10, noise=None,
                 dtype=torch.float64, device="cuda"):
        """Closed loop (ClosedLoopNMPC.m:80-109) of one lane, or of one lane
        per noise array: ``noise`` None (noise-free), (nit, nx) or (B, nit,
        nx), added to the plant's state at every step (the measurement, from
        which the plant also integrates on, as in the JAX package).
        Returns NumPy (y (nit, ny), u (nit, nu)), or (B, nit, ny), (B, nit,
        nu) for a batch of noise arrays.  On the card the model must lie
        inside the rollout kernel's envelope (``models/ode.nmpc_envelope``);
        else it raises."""
        require_device(device)
        if torch.device(device).type != "cpu":
            nmpc_envelope(self)
        pin_precision()
        kw = dict(dtype=dtype, device=device)
        as_t = lambda a: torch.as_tensor(np.array(a, dtype=np.float64), **kw)
        batched = noise is not None and np.ndim(noise) == 3
        if noise is None:
            B, n_t = 1, None
        else:
            n_t = as_t(noise)[..., :nit, :]
            n_t = n_t if batched else n_t[None]
            B = n_t.shape[0]
        x = as_t(x0).expand(B, self.nx).clone()
        u = as_t(u0).expand(B, self.nu).clone()
        r_t = as_t(r)[:nit]
        consts = self._constants(**kw)
        consts["cmask"] = consts["cm"].expand(B, -1).contiguous()
        Y = torch.empty((B, nit, self.ny), **kw)
        U = torch.empty((B, nit, self.nu), **kw)
        xc = list(self.xc)
        for k in range(nit):
            # plant one Ts + state measurement noise (ClosedLoopNMPC.m:84-87)
            x = self._step(x, u)
            if n_t is not None:
                x = x + n_t[:, k]
            if k >= inK - 1:  # the loop starts at inK
                u = u + self._control(x, u, r_t[k], consts)
            Y[:, k] = x[:, xc]
            U[:, k] = u
        Y, U = Y.cpu().numpy(), U.cpu().numpy()
        return (Y, U) if batched else (Y[0], U[0])

    def _constants(self, dtype, device):
        """The SQP's fixed tensors: the per-input move mask, the weights
        tiled over the horizons, the cumulative-sum map and the bound rows'
        matrix."""
        m, nu = max(self.Nu), self.nu
        kw = dict(dtype=dtype, device=device)
        mask = np.zeros((m, nu))
        for j, nuj in enumerate(self.Nu):
            mask[:nuj, j] = 1.0
        cm = torch.as_tensor(mask.reshape(-1), **kw)
        Tcum = torch.kron(torch.tril(torch.ones((m, m), **kw)),
                          torch.eye(nu, **kw))
        W = torch.as_tensor(np.asarray(self.W, dtype=np.float64), **kw)
        Q = torch.as_tensor(np.asarray(self.Q, dtype=np.float64), **kw)
        # column t nu + i moves input i by cm[t nu + i] at steps >= t
        steps = torch.arange(self.N, device=device)
        on = (torch.arange(m, device=device)[None, :]
              <= torch.clamp(steps, max=m - 1)[:, None]).to(dtype)
        dU = (torch.eye(nu, **kw)[None, :, None, :] * on[:, None, :, None]
              ).reshape(self.N, nu, m * nu) * cm
        return dict(
            m=m, cm=cm, Tcum=Tcum, dU=dU,
            q=Q.repeat(self.N), w=W.repeat(m) * cm,
            G=torch.cat([Tcum * cm[:, None], -Tcum * cm[:, None]]),
            ub=torch.as_tensor(np.asarray(self.ub, dtype=np.float64),
                               **kw).repeat(m),
            lb=torch.as_tensor(np.asarray(self.lb, dtype=np.float64),
                               **kw).repeat(m))

    def _step(self, x, u):
        """x (B, nx) one sample interval on at the input u (B, nu): the
        rollout's plant step (m = 0, p = 1; on the CPU ``integrate``)."""
        none = x.new_zeros((x.shape[0], 0))
        return nmpc_rollout(self, x, u, none, none, 1,
                            outputs=range(self.nx))[0]

    def _predict(self, x, u_prev, du, c):
        """The corrected-free predictions Y (B, N ny) of the moves du (B, m
        nu) from x, and their Jacobian J (B, N ny, m nu): the rollout of
        NMPC_Controller.m with its forward sensitivities, on the card one
        launch of the rollout kernel."""
        if x.device.type != "cpu":
            return nmpc_rollout(self, x, u_prev, du, c["cmask"], self.N,
                                jac=True)
        B = x.shape[0]
        m, nu = c["m"], self.nu
        u_seq = u_prev[:, None, :] + torch.cumsum(
            (du * c["cm"]).reshape(B, m, nu), dim=1)
        dX = x.new_zeros((B, self.nx, m * nu))
        xc = list(self.xc)
        ys, js = [], []
        for k in range(self.N):
            u, dU = u_seq[:, min(k, m - 1)], c["dU"][k].expand(B, nu, m * nu)
            x, dX = rollout_tangent(self.rhs, x, u, dX, dU, self.Ts,
                                    self.substeps, self.integrator)
            ys.append(x[:, xc])
            js.append(dX[:, xc])
        return (torch.stack(ys, 1).reshape(B, -1),
                torch.stack(js, 1).reshape(B, -1, m * nu))

    def _control(self, x_meas, u_prev, rk, c):
        """One NMPC_Controller.m solve per lane: the first move per input
        (B, nu)."""
        B = x_meas.shape[0]
        m, nu, cm = c["m"], self.nu, c["cm"]
        xc = list(self.xc)
        # offset correction: measured controlled states minus one-step model
        # propagation under u(k-1) (NMPC_Controller.m:108-127)
        x_one = self._step(x_meas, u_prev)
        offset = x_meas[:, xc] - x_one[:, xc]
        r_flat = rk.repeat(self.N)
        eye_pad = torch.diag(c["w"] + (1.0 - cm))
        u_tile = u_prev.repeat(1, m)
        du = x_meas.new_zeros((B, m * nu))
        for _ in range(self.sqp_iters):
            Yf, J = self._predict(x_meas, u_prev, du, c)
            e = Yf + offset.repeat(1, self.N) - r_flat
            JQ = J * c["q"][:, None]
            H = 2.0 * (J.transpose(1, 2) @ JQ + eye_pad)
            f = 2.0 * ((JQ.transpose(1, 2) @ e[:, :, None])[:, :, 0]
                       + c["w"] * du)
            # bounds on absolute u over the active moves
            u_seq = (du * cm) @ c["Tcum"].T + u_tile
            h = torch.cat([(c["ub"] - u_seq) * cm + (1 - cm),
                           (u_seq - c["lb"]) * cm + (1 - cm)], dim=1)
            z, _, _ = solve_qp(H, f, c["G"].expand(B, -1, -1).contiguous(), h,
                               iters=self.qp_iters)
            du = du + z * cm
        return (du * cm).reshape(B, m, nu)[:, 0]
