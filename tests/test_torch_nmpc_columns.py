"""The rollout with its move mask per column
(``models/ode.nmpc_rollout_plain``, the plain version of the
``ops/kernels.nmpc_rollout`` kernel) and the explicit NMPC's prediction
on it, on the CPU at float64:

  * against the JAX package's explicit-NMPC prediction ``y_of`` and its
    ``jax.jacfwd`` (built as ``mpc_tuning_tpu/sim/explicit_nmpc.py``
    builds it, without the offset) at per-input control horizons, with
    either integrator, within 1e-10 relative;
  * a per-step mask, spread over the inputs, gives the per-step rollout's
    bits;
  * the explicit NMPC's prediction through ``ops/kernels.nmpc_rollout``
    against its CPU path (``models/ode.rollout_tangent``) within 1e-12;
  * the kernel's envelope refuses the explicit NMPC's other models.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tuning_tpu.models import ode as ode_jax
from mpc_tuning_tpu_torch.cases import vandevusse_explicit as vex
from mpc_tuning_tpu_torch.models import ode
from mpc_tuning_tpu_torch.ops import kernels as K

torch.set_num_threads(1)  # B <= 8: threads only contend with other workers

B, N, SUBSTEPS = 5, 5, 6  # the explicit NMPC demo's horizon and substeps


def _controller(Nu, integrator):
    return dataclasses.replace(vex.make_controller(substeps=SUBSTEPS),
                               Nu=Nu, integrator=integrator)


def _inputs(m, seed):
    """Seeded Van de Vusse states, previous inputs and moves (B, m nu)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform([1.5, 0.8, 125.0], [2.5, 1.2, 137.0], (B, 3))
    up = rng.uniform([10.0, 110.0], [30.0, 135.0], (B, 2))
    du = rng.uniform(-4.0, 4.0, (B, m * 2))
    return x, up, du


def _col_mask(Nu, m, nu=2):
    """The explicit NMPC's mask, (m nu,): column t nu + i on for t < Nu[i]
    (the JAX package's _col_mask_per_input, flattened)."""
    mask = np.zeros((m, nu))
    for j, nuj in enumerate(Nu):
        mask[:nuj, j] = 1.0
    return mask.reshape(-1)


def _jax_prediction(x, up, du, Nu, integrator, xc=(1, 2)):
    """Y (B, N ny) and J (B, N ny, m nu) of the JAX package's explicit
    NMPC: its y_of (mpc_tuning_tpu/sim/explicit_nmpc.py:97-117) without
    the offset, and jax.jacfwd of it."""
    m, nu = max(Nu), 2
    cmask = jnp.asarray(_col_mask(Nu, m).reshape(m, nu))
    xc_arr = jnp.array(xc)

    def y_of(du_flat, x_meas, u_prev):
        d = du_flat.reshape(m, nu) * cmask
        u_seq = u_prev[None, :] + jnp.cumsum(d, axis=0)

        def body(xk, i):
            u = u_seq[jnp.minimum(i, m - 1)]
            xn = ode_jax.integrate(ode_jax.vandevusse_rhs, xk, u, vex.TS,
                                   SUBSTEPS, integrator)
            return xn, xn[xc_arr]

        _, Y = jax.lax.scan(body, x_meas, jnp.arange(N))
        return Y.reshape(-1)

    fy = jax.jit(jax.vmap(y_of))
    fj = jax.jit(jax.vmap(jax.jacfwd(y_of)))
    a = tuple(jnp.asarray(v) for v in (du, x, up))
    return np.asarray(fy(*a)), np.asarray(fj(*a))


@pytest.mark.parametrize("integrator", ["rk4", "tr_bdf2"])
@pytest.mark.parametrize("Nu", [(2, 2), (2, 1), (3, 1)])
def test_column_mask_rollout_matches_jax_explicit_prediction(Nu, integrator):
    m = max(Nu)
    x, up, du = _inputs(m, seed=sum(Nu))
    Yj, Jj = _jax_prediction(x, up, du, Nu, integrator)
    ctl = _controller(Nu, integrator)
    cm = np.broadcast_to(_col_mask(Nu, m), (B, m * 2))
    Yt, Jt = ode.nmpc_rollout_plain(
        ctl, torch.tensor(x), torch.tensor(up), torch.tensor(du),
        torch.tensor(cm.copy()), N, jac=True)
    assert np.isfinite(Jj).all() and np.abs(Jj).max() > 0
    assert np.abs(Yt.numpy() - Yj).max() <= 1e-10 * np.abs(Yj).max()
    assert np.abs(Jt.numpy() - Jj).max() <= 1e-10 * np.abs(Jj).max()
    # a masked-off column moves nothing
    off = np.flatnonzero(_col_mask(Nu, m) == 0)
    assert (Jt[:, :, off] == 0).all()


def _per_step_rollout(model, x, u_prev, du, cmask, p):
    """The rollout with the mask per step (B, m), as the plain version
    computed it before it took a mask per column: the reference of the
    spread mask's bits."""
    B_, nu = u_prev.shape
    m = cmask.shape[1]
    u_seq = u_prev[:, None, :] + torch.cumsum(
        du.reshape(B_, m, nu) * cmask[:, :, None], dim=1)
    ncol = m * nu
    dX = torch.zeros((B_, x.shape[1], ncol), dtype=x.dtype)
    eye = torch.eye(nu, dtype=x.dtype)
    t = torch.arange(m)
    ys, js = [], []
    for k in range(p):
        on = cmask * (t <= min(k, m - 1)).to(x.dtype)
        dU = (eye[None, :, None, :] * on[:, None, :, None]).reshape(
            B_, nu, ncol)
        x, dX = ode.integrate_tangent(model.rhs, x, u_seq[:, min(k, m - 1)],
                                      dX, dU, model.Ts, model.substeps,
                                      model.integrator)
        ys.append(x[:, list(model.xc)])
        js.append(dX[:, list(model.xc)])
    return (torch.stack(ys, 1).reshape(B_, -1),
            torch.stack(js, 1).reshape(B_, -1, ncol))


@pytest.mark.parametrize("integrator", ["rk4", "tr_bdf2"])
def test_step_mask_spread_over_the_inputs_keeps_the_per_step_bits(
        integrator):
    """The tune's mask (one Nu a candidate), per step or spread per
    column: the per-step rollout's Y and J bit for bit, and the same
    inputs."""
    m = 3
    x, up, du = (torch.tensor(a) for a in _inputs(m, seed=7))
    step = torch.tensor((np.arange(m)[None] < np.array(
        [[1], [2], [3], [2], [1]])).astype(float))
    cols = step.repeat_interleave(2, dim=1)
    ctl = _controller((m, m), integrator)
    want = _per_step_rollout(ctl, x, up, du, step, N)
    for mask in (step, cols):
        got = ode.nmpc_rollout_plain(ctl, x, up, du, mask, N, jac=True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    hold = torch.tensor([0, 1, 2, 1, 0], dtype=torch.int32)
    assert torch.equal(ode.rollout_inputs(up, du, step, hold, 7),
                       ode.rollout_inputs(up, du, cols, hold, 7))


@pytest.mark.parametrize("integrator", ["rk4", "tr_bdf2"])
def test_explicit_prediction_through_the_kernel_wrapper(integrator):
    """The explicit NMPC's prediction on the CPU (``rollout_tangent``)
    against the rollout kernel's wrapper on the same moves (on the CPU its
    plain version), as the card's path calls it: within 1e-12."""
    Nu = (2, 1)
    ctl = _controller(Nu, integrator)
    x, up, du = (torch.tensor(a) for a in _inputs(max(Nu), seed=3))
    c = ctl._constants(dtype=torch.float64, device="cpu")
    cmask = c["cm"].expand(B, -1).contiguous()
    Yc, Jc = ctl._predict(x, up, du, c)
    Yk, Jk = K.nmpc_rollout(ctl, x, up, du, cmask, ctl.N, jac=True)
    for a, b in ((Yk, Yc), (Jk, Jc)):
        assert a.shape == b.shape
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-12
    # the plant step: the wrapper's m = 0 call is ``integrate``'s bits
    none = torch.zeros((B, 0), dtype=torch.float64)
    torch.testing.assert_close(
        ctl._step(x, up), ode.integrate(ctl.rhs, x, up, ctl.Ts,
                                        ctl.substeps, integrator),
        rtol=0, atol=0)
    assert torch.equal(ctl._step(x, up), K.nmpc_rollout(
        ctl, x, up, none, none, 1, outputs=range(3))[0])


@pytest.mark.parametrize("change,match", [
    (dict(rhs=lambda x, u: -x), "device='cpu'"),
    (dict(integrator="euler"), "unknown integrator")])
def test_envelope_refuses_the_explicit_nmpcs_other_models(change, match):
    """The rollout kernel's envelope, checked before the card's loop
    starts: another rhs (the tune's message, pointing to the CPU) and an
    unknown integrator raise; the demo's own model passes."""
    ctl = vex.make_controller(substeps=SUBSTEPS)
    ode.nmpc_envelope(ctl)
    with pytest.raises(ValueError, match=match):
        ode.nmpc_envelope(dataclasses.replace(ctl, **change))
