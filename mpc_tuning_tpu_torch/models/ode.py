"""Nonlinear ODE models and fixed-step integrators (the port of the JAX
package's ``models/ode.py``).

Van de Vusse non-isothermal CSTR, parameters transcribed from
MPC-Tuning/vandevusse_model.m:39-77 (identical physics in
nmpc_vandevusse_state.m and Explicit NMPC/plant_model.m).  The reference
integrates with adaptive ode45/ode15s/ode23t; here, as in the JAX package,
a fixed-substep RK4 (at Ts = 0.05 h the fastest VdV eigenvalue is ~60/h,
so dt = Ts/10 is deep inside RK4's stability region) or the implicit
L-stable TR-BDF2 for stiff plants.

Every function takes states and inputs with any leading batch axes: x
(..., nx), u (..., nu).  The functions compose with ``torch.func``
(``jacfwd`` / ``jvp`` / ``vmap``).  ``integrate_tangent`` carries forward
sensitivities through a sample interval with the rhs partials: written
out for Van de Vusse, by ``torch.func.jacfwd`` of the rhs for any other
model (``rhs_partials``).  ``nmpc_rollout_plain`` is the NMPC prediction
rollout over p sample intervals with its move sensitivities, the plain
version of the rollout kernel, whose envelope ``nmpc_envelope`` states.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["vandevusse_rhs", "vandevusse_partials", "rhs_partials",
           "rk4_step", "tr_bdf2_step", "integrate", "integrate_rk4",
           "integrate_tangent",
           "vandevusse_rk4_tangent", "rollout_tangent",
           "newton_steady_state", "batched_jacobian", "column_mask",
           "rollout_inputs", "nmpc_rollout_plain", "nmpc_envelope",
           "NMPC_INTEGRATORS",
           "VDV_X0", "VDV_U0",
           "VDV_PARAMS"]

VDV_X0 = np.array([5.1, 1.1163, 130.0])  # [Ca, Cb, T] steady guess
VDV_U0 = np.array([20.0, 130.0])  # [fov (1/h), Tk (C)] (VanDeVusse_NMPC.m:70)

# vandevusse_model.m:39-77; ops/csrc/nmpc.cu carries the same constants
VDV_PARAMS = dict(k10=1.287e12, k20=1.287e12, k30=9.043e9, E1=-9758.3,
                  E2=-9758.3, E3=-8560.0, dAB=-4.20, dBC=11.00, dAD=41.85,
                  rho=0.9342, cp=3.01, Kw=4032.0, Ar=0.215, V=10.0, T0=130.0,
                  Ca0=5.10)


def vandevusse_rhs(x, u):
    """dx/dt for the Van de Vusse CSTR; x (..., 3) = [Ca, Cb, T], u (..., 2)
    = [fov, Tk]."""
    p = VDV_PARAMS
    fov, Tk = u[..., 0], u[..., 1]
    ca, cb, T = x[..., 0], x[..., 1], x[..., 2]
    k1 = p["k10"] * torch.exp(p["E1"] / (T + 273.15))
    k2 = p["k20"] * torch.exp(p["E2"] / (T + 273.15))
    k3 = p["k30"] * torch.exp(p["E3"] / (T + 273.15))
    rho, cp = p["rho"], p["cp"]
    dca = fov * (p["Ca0"] - ca) - k1 * ca - k3 * ca * ca
    dcb = -fov * cb + k1 * ca - k2 * cb
    dT = (
        (1.0 / (rho * cp)) * (k1 * ca * p["dAB"] + k2 * cb * p["dBC"]
                              + k3 * (ca * ca) * p["dAD"])
        + fov * (p["T0"] - T)
        + (p["Kw"] * p["Ar"] / (rho * cp * p["V"])) * (Tk - T)
    )
    return torch.stack([dca, dcb, dT], dim=-1)


def vandevusse_partials(x, u):
    """The partial derivatives of ``vandevusse_rhs``, written out: fx
    (..., 3, 3) = d rhs / dx and fu (..., 3, 2) = d rhs / du."""
    p = VDV_PARAMS
    fov, Tk = u[..., 0], u[..., 1]
    ca, cb, T = x[..., 0], x[..., 1], x[..., 2]
    Tt = T + 273.15
    k1 = p["k10"] * torch.exp(p["E1"] / Tt)
    k2 = p["k20"] * torch.exp(p["E2"] / Tt)
    k3 = p["k30"] * torch.exp(p["E3"] / Tt)
    g1, g2, g3 = (k * (-E / (Tt * Tt))
                  for k, E in ((k1, p["E1"]), (k2, p["E2"]), (k3, p["E3"])))
    c1 = 1.0 / (p["rho"] * p["cp"])
    c2 = p["Kw"] * p["Ar"] / (p["rho"] * p["cp"] * p["V"])
    zero = torch.zeros_like(ca)
    fx = torch.stack([
        torch.stack([-fov - k1 - 2.0 * k3 * ca, zero,
                     -g1 * ca - g3 * ca * ca], dim=-1),
        torch.stack([k1, -fov - k2, g1 * ca - g2 * cb], dim=-1),
        torch.stack([c1 * (k1 * p["dAB"] + 2.0 * k3 * ca * p["dAD"]),
                     c1 * k2 * p["dBC"],
                     c1 * (g1 * ca * p["dAB"] + g2 * cb * p["dBC"]
                           + g3 * (ca * ca) * p["dAD"]) - fov - c2], dim=-1),
    ], dim=-2)
    fu = torch.stack([
        torch.stack([p["Ca0"] - ca, zero], dim=-1),
        torch.stack([-cb, zero], dim=-1),
        torch.stack([p["T0"] - T, torch.full_like(T, c2)], dim=-1),
    ], dim=-2)
    return fx, fu


def rk4_step(rhs, x, u, dt):
    k1 = rhs(x, u)
    k2 = rhs(x + 0.5 * dt * k1, u)
    k3 = rhs(x + 0.5 * dt * k2, u)
    k4 = rhs(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


_TRBDF2_GAMMA = 2.0 - 2.0 ** 0.5  # the standard L-stable choice


def batched_jacobian(fn, x):
    """d fn(x) / dx per leading index: x (..., n) -> (..., n_out, n), for a
    ``fn`` whose leading entries are independent (one forward-mode product
    per input coordinate, all leading entries at once)."""
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    # the tangents by broadcasting, not by writing into zeros: an in-place
    # write is wrong under torch.func.vmap (the plain NMPC Jacobian)
    cols = [torch.func.jvp(fn, (x,), (torch.zeros_like(x) + e,))[1]
            for e in eye]
    return torch.stack(cols, dim=-1)


def _newton_solve(res, jac, x_guess, iters):
    """Fixed-iteration Newton on res(x) = 0, jac(x) its exact Jacobian."""
    x = x_guess
    for _ in range(iters):
        x = x - torch.linalg.solve(jac(x), res(x))
    return x


def _tr_bdf2_stages(rhs, x, u, dt, newton_iters):
    """The two implicit stages of one TR-BDF2 step: (xg, xn).  Each stage's
    Newton Jacobian is I - a fx with fx from ``rhs_partials`` (written out
    for Van de Vusse), the derivative of its residual."""
    g = _TRBDF2_GAMMA
    f0 = rhs(x, u)
    partials = rhs_partials(rhs)
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    a = 0.5 * g * dt

    def res_tr(xg):
        return xg - x - 0.5 * g * dt * (f0 + rhs(xg, u))

    xg = _newton_solve(res_tr, lambda v: eye - a * partials(v, u)[0],
                       x + g * dt * f0, newton_iters)

    c1 = 1.0 / (g * (2.0 - g))
    c2 = (1.0 - g) ** 2 / (g * (2.0 - g))
    c3 = (1.0 - g) / (2.0 - g)

    def res_bdf(xn):
        return xn - c1 * xg + c2 * x - c3 * dt * rhs(xn, u)

    return xg, _newton_solve(res_bdf,
                             lambda v: eye - c3 * dt * partials(v, u)[0],
                             xg, newton_iters)


def tr_bdf2_step(rhs, x, u, dt, newton_iters: int = 6):
    """One TR-BDF2 step (the stiff integrator standing in for the
    reference's ode23t / ode15s, Explicit NMPC/NMPC_Controller.m:99,115):
    a trapezoidal stage to t + g dt, then a BDF2 stage to t + dt, g = 2 -
    sqrt(2), each implicit stage solved by a fixed number of full-Newton
    iterations."""
    return _tr_bdf2_stages(rhs, x, u, dt, newton_iters)[1]


def integrate(rhs, x0, u, Ts, substeps: int = 10, method: str = "rk4",
              newton_iters: int = 6):
    """Integrate one sample interval with ZOH input u: 'rk4' (explicit) or
    'tr_bdf2' (implicit, L-stable)."""
    dt = Ts / substeps
    if method == "rk4":
        stepper = lambda x: rk4_step(rhs, x, u, dt)
    elif method == "tr_bdf2":
        stepper = lambda x: tr_bdf2_step(rhs, x, u, dt, newton_iters)
    else:
        raise ValueError(f"unknown integrator method {method!r}")
    x = x0
    for _ in range(substeps):
        x = stepper(x)
    return x


def integrate_rk4(rhs, x0, u, Ts, substeps: int = 10):
    """Fixed-substep RK4 over one sample interval (``integrate`` with
    'rk4')."""
    return integrate(rhs, x0, u, Ts, substeps, "rk4")


def rhs_partials(rhs):
    """partials(x, u) -> (fx (..., nx, nx), fu (..., nx, nu)) of ``rhs``:
    written out for Van de Vusse, else ``torch.func.jacfwd`` of the rhs
    vmapped over the leading entries."""
    if rhs is vandevusse_rhs:
        return vandevusse_partials
    jac = torch.func.vmap(torch.func.jacfwd(rhs, argnums=(0, 1)))

    def partials(x, u):
        lead = x.shape[:-1]
        fx, fu = jac(x.reshape(-1, x.shape[-1]), u.reshape(-1, u.shape[-1]))
        return (fx.reshape(*lead, *fx.shape[1:]),
                fu.reshape(*lead, *fu.shape[1:]))

    return partials


def integrate_tangent(rhs, x0, u, dX, dU, Ts, substeps: int = 10,
                      method: str = "rk4", newton_iters: int = 6):
    """``integrate`` with forward sensitivities: dX (..., nx, k) and dU
    (..., nu, k) are k tangent directions of x0 and u.  Returns (x, dX)
    at the end of the interval, x computed as ``integrate`` computes it.
    RK4 carries the tangents through every stage; TR-BDF2 differentiates
    each converged implicit stage (the derivative of its fixed Newton
    iterations once they have converged)."""
    partials = rhs_partials(rhs)
    dt = Ts / substeps
    eye = torch.eye(x0.shape[-1], dtype=x0.dtype, device=x0.device)

    def rk4(x, dX):
        def stage(xs, dXs):
            fx, fu = partials(xs, u)
            return rhs(xs, u), fx @ dXs + fu @ dU

        k1, d1 = stage(x, dX)
        k2, d2 = stage(x + 0.5 * dt * k1, dX + 0.5 * dt * d1)
        k3, d3 = stage(x + 0.5 * dt * k2, dX + 0.5 * dt * d2)
        k4, d4 = stage(x + dt * k3, dX + dt * d3)
        return (x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4),
                dX + (dt / 6.0) * (d1 + 2 * d2 + 2 * d3 + d4))

    def tr_bdf2(x, dX):
        g = _TRBDF2_GAMMA
        c1 = 1.0 / (g * (2.0 - g))
        c2 = (1.0 - g) ** 2 / (g * (2.0 - g))
        c3 = (1.0 - g) / (2.0 - g)
        xg, xn = _tr_bdf2_stages(rhs, x, u, dt, newton_iters)
        (fx0, fu0), (fxg, fug), (fxn, fun) = (partials(v, u)
                                              for v in (x, xg, xn))
        a = 0.5 * g * dt
        dXg = torch.linalg.solve(eye - a * fxg,
                                 dX + a * (fx0 @ dX + fu0 @ dU + fug @ dU))
        dXn = torch.linalg.solve(eye - c3 * dt * fxn,
                                 c1 * dXg - c2 * dX + c3 * dt * (fun @ dU))
        return xn, dXn

    if method == "rk4":
        step = rk4
    elif method == "tr_bdf2":
        step = tr_bdf2
    else:
        raise ValueError(f"unknown integrator method {method!r}")
    x = x0
    for _ in range(substeps):
        x, dX = step(x, dX)
    return x, dX


def vandevusse_rk4_tangent(x0, u, dX, dU, Ts, substeps: int = 10):
    """``integrate_tangent`` for the Van de Vusse rhs with RK4 (x0 (B, 3),
    u (B, 2), dX (B, 3, k), dU (B, 2, k)) in about a third of its
    operations: each stage forms the rhs and its directional derivative
    around one set of Arrhenius terms (the rates k_i and dk_i/dT), the
    three reaction terms mixed into the rhs by one 3 x 3 product.  For
    callers that run the rollout as one eager op at a time (the explicit
    NMPC); it rounds otherwise than ``integrate`` and ``integrate_tangent``
    (in the last digits).  Returns (x, dX)."""
    p = VDV_PARAMS
    kw = dict(dtype=x0.dtype, device=x0.device)
    c1 = 1.0 / (p["rho"] * p["cp"])
    c2 = p["Kw"] * p["Ar"] / (p["rho"] * p["cp"] * p["V"])
    K0 = torch.tensor([p["k10"], p["k20"], p["k30"]], **kw)
    E = torch.tensor([p["E1"], p["E2"], p["E3"]], **kw)
    # the reaction terms [k1 ca, k2 cb, k3 ca^2] into [dca, dcb, dT]
    Mr = torch.tensor([[-1.0, 1.0, c1 * p["dAB"]],
                       [0.0, -1.0, c1 * p["dBC"]],
                       [-1.0, 0.0, c1 * p["dAD"]]], **kw)
    MrT = Mr.T.contiguous()
    c0 = torch.tensor([p["Ca0"], 0.0, p["T0"]], **kw)
    cvec = torch.tensor([0.0, 0.0, c2], **kw)
    fov, Tk = u[:, :1], u[:, 1:2]
    dfov, dTk = dU[:, :1], dU[:, 1:2]
    dt = Ts / substeps

    def stage(x, dx):
        ca, cb, T = x[:, :1], x[:, 1:2], x[:, 2:]
        inv = torch.reciprocal(T + 273.15)
        kk = K0 * torch.exp(E * inv)
        g = kk * -E * (inv * inv)  # dk_i / dT
        s = torch.cat([ca, cb, ca * ca], 1)
        cx = c0 - x
        f = fov * cx + (kk * s) @ Mr + (Tk - T) * cvec
        dT = dx[:, 2:]
        ds = torch.cat([dx[:, :2], (2.0 * ca)[:, :, None] * dx[:, :1]], 1)
        drr = (g * s)[:, :, None] * dT + kk[:, :, None] * ds
        df = (cx[:, :, None] * dfov - fov[:, :, None] * dx + MrT @ drr
              + cvec[:, None] * (dTk - dT))
        return f, df

    x = x0
    for _ in range(substeps):
        k1, d1 = stage(x, dX)
        k2, d2 = stage(x + 0.5 * dt * k1, dX + 0.5 * dt * d1)
        k3, d3 = stage(x + 0.5 * dt * k2, dX + 0.5 * dt * d2)
        k4, d4 = stage(x + dt * k3, dX + dt * d3)
        x = x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        dX = dX + (dt / 6.0) * (d1 + 2 * d2 + 2 * d3 + d4)
    return x, dX


def rollout_tangent(rhs, x0, u, dX, dU, Ts, substeps: int = 10,
                    method: str = "rk4"):
    """``integrate_tangent`` in the fewest eager ops this module has for
    ``rhs`` and ``method``: ``vandevusse_rk4_tangent`` for the Van de
    Vusse rhs with RK4 (it rounds otherwise in the last digits), else
    ``integrate_tangent`` itself.  For callers that run a rollout one
    eager op at a time (the explicit NMPC); the NMPC's plain rollout keeps
    ``integrate_tangent``'s rounding."""
    if rhs is vandevusse_rhs and method == "rk4":
        return vandevusse_rk4_tangent(x0, u, dX, dU, Ts, substeps)
    return integrate_tangent(rhs, x0, u, dX, dU, Ts, substeps, method)


def newton_steady_state(rhs, x0, u, iters: int = 50):
    """fsolve equivalent (VanDeVusse_NMPC.m:72-79): Newton on rhs(x, u) = 0
    at float64 on the host.  Returns a NumPy array."""
    x = torch.as_tensor(np.asarray(x0, dtype=np.float64))
    u = torch.as_tensor(np.asarray(u, dtype=np.float64))
    for _ in range(iters):
        f = rhs(x, u)
        J = batched_jacobian(lambda xx: rhs(xx, u), x)
        x = x + torch.linalg.solve(J, -f)
    return x.numpy()


NMPC_INTEGRATORS = ("rk4", "tr_bdf2")  # the rollout kernel's steppers


def nmpc_envelope(model):
    """The envelope of the rollout kernel (``ops/kernels.nmpc_rollout``,
    ops/csrc/nmpc.cu), checked before a launch: the Van de Vusse rhs
    integrated by RK4 or TR-BDF2.  Raises ValueError outside it (another
    rhs runs on the CPU through ``nmpc_rollout_plain``)."""
    if model.rhs is not vandevusse_rhs:
        raise ValueError(f"nmpc_rollout kernel: no kernel for rhs "
                         f"{getattr(model.rhs, '__name__', model.rhs)!r} "
                         "(the kernel integrates the Van de Vusse CSTR); "
                         "run this model with device='cpu'")
    if model.integrator not in NMPC_INTEGRATORS:
        raise ValueError(f"nmpc_rollout kernel: unknown integrator "
                         f"{model.integrator!r} (the kernel steps "
                         f"{' or '.join(NMPC_INTEGRATORS)})")


def column_mask(cmask, m, nu):
    """The move mask per column, (B, m nu): column t nu + i moves input i
    by cmask[:, t nu + i] from step t on.  A per-step mask (B, m) is spread
    over the inputs (each column takes its step's entry); a per-column one
    is returned as it is."""
    if cmask.shape[1] == m * nu:
        return cmask
    if cmask.shape[1] == m:
        return cmask.repeat_interleave(nu, dim=1)
    raise ValueError(f"move mask: (B, {m}) per step or (B, {m * nu}) per "
                     f"column, got {tuple(cmask.shape)}")


def rollout_inputs(u_prev, du, cmask, hold, p):
    """The input of each of p prediction steps, (B, p, nu), as the NMPC
    rollout applies them: u_prev plus the masked moves du (B, m nu) summed
    up to min(step, m - 1, hold) (``hold`` (B,) int, or None), ``cmask``
    per step (B, m) or per column (B, m nu) (``column_mask``)."""
    B, nu = u_prev.shape
    m = du.shape[1] // nu
    if m == 0:
        return u_prev[:, None, :].expand(B, p, nu)
    cm = column_mask(cmask, m, nu)
    u_seq = u_prev[:, None, :] + torch.cumsum(
        du.reshape(B, m, nu) * cm.reshape(B, m, nu), dim=1)
    idx = torch.clamp(torch.arange(p, device=du.device), max=m - 1)
    idx = idx[None, :].expand(B, p)
    if hold is not None:
        idx = torch.minimum(idx, hold.long()[:, None])
    return torch.gather(u_seq, 1, idx[:, :, None].expand(B, p, nu))


def nmpc_rollout_plain(model, x, u_prev, du, cmask, p, hold=None, jac=False,
                       outputs=None):
    """The NMPC prediction rollout, the plain version of
    ``ops/kernels.nmpc_rollout`` (its section note has the arguments):
    ``integrate`` per interval and, with ``jac``, forward sensitivities
    along the m nu move directions (``integrate_tangent``: the chain rule
    through every integrator stage, for any rhs and either integrator).
    Returns (Y (B, p ny), J (B, p ny, m nu) or None)."""
    out = list(model.xc if outputs is None else outputs)
    B, nu = u_prev.shape
    m = du.shape[1] // nu
    if jac and (m == 0 or hold is not None):
        raise ValueError("nmpc_rollout: jac needs moves (m > 0) and no hold")
    cm = column_mask(cmask, m, nu)
    U = rollout_inputs(u_prev, du, cm, hold, p)
    ncol = m * nu if jac else 0
    kw = dict(dtype=x.dtype, device=x.device)
    dX = torch.zeros((B, x.shape[1], ncol), **kw)
    sel = torch.eye(nu, **kw).repeat(1, m)  # (nu, m nu): column t nu + i
    t = torch.arange(m, device=x.device).repeat_interleave(nu)
    ys, js = [], []
    for k in range(p):
        if not jac:
            x = integrate(model.rhs, x, U[:, k], model.Ts, model.substeps,
                          model.integrator)
        else:
            # column t nu + i moves input i by cm[t nu + i] from step t on
            on = cm * (t <= min(k, m - 1)).to(x.dtype)
            dU = sel[None] * on[:, None, :]
            x, dX = integrate_tangent(model.rhs, x, U[:, k], dX, dU,
                                      model.Ts, model.substeps,
                                      model.integrator)
            js.append(dX[:, out])
        ys.append(x[:, out])
    Y = torch.stack(ys, 1).reshape(B, -1)
    return Y, (torch.stack(js, 1).reshape(B, -1, ncol) if jac else None)
