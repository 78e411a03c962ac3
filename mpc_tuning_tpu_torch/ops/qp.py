"""Batched QP solvers: the port of the main-path half of
the JAX package's ``ops/qp.py``.

    min_z  1/2 z'Hz + f'z   s.t.  G z <= h

* ``solve_qp`` — the dense Mehrotra PDIP, batched over candidates, each
  with its own dense G: the NMPC SQP subproblem's solver.  Its normal
  matrix is a batched product (torch.bmm); its factor and two solves per
  iteration go through ``spd_factor`` / ``spd_factor_solve``.
* ``solve_qp_masked`` — infeasible-start Mehrotra predictor-corrector
  primal-dual interior point with a FIXED iteration count and
  best-iterate-by-merit return, for the masked-constraint MPC QP
  G = diag(rmask) G0 diag(cmask_z).  Its public face takes the batch as
  the leading axis; the algorithm itself is ``pdip_lanes`` (batch last),
  which the per-step engine 'pdip_ws_lanes' and the plain PDIP versions
  also run at every step.  The reduced-system Cholesky factor and solves
  go through hand-written kernels (ops/kernels.py): ``spd_factor`` /
  ``spd_factor_solve`` here, ``factor_lanes`` / ``solve_lanes`` in
  'pdip_ws_lanes'.
* ``seed_slack`` / ``split_stage2`` — the band cases' eps-split around
  two ``pdip_lanes`` solves: the stage-0 slack LP's warm start and the
  slack-frozen stage 2.
* ``admm_precompute`` — per-candidate equilibration and the inverse
  Minv = (Hs + sigma I + rho Gs'Gs)^{-1} that the whole-sim ADMM kernel
  reuses at every step.
* ``solve_qp_admm`` — the batch-major warm equilibrated ADMM over
  ``admm_precompute``'s output (the per-step engine 'admm'): batched
  matrix products only, no factor.
* ``qp_kkt_residuals`` — stationarity, primal and complementarity
  residuals of a (batch of) QP solution(s), a diagnostic.

Same algorithm and constants as the JAX package (fraction to the boundary
0.995, sigma = (mu_aff/mu)^3, ridge 1e-9 / 1e-6 and dual cap 1e13 / 1e7 at
f64 / f32, warm-start floor 1e-4).
"""

from __future__ import annotations

import torch

from mpc_tuning_tpu_torch.ops import kernels
from mpc_tuning_tpu_torch.ops.kernels import (factor_lanes, solve_lanes,
                                              spd_factor, spd_factor_solve)

__all__ = ["solve_qp", "solve_qp_masked", "pdip_lanes", "admm_precompute",
           "solve_qp_admm", "qp_kkt_residuals", "WS_EPS", "pdip_constants",
           "seed_slack", "split_margins", "split_stage2", "CARD_LANES",
           "lane_mm", "lane_baddbmm"]

# warm-start re-centering: slacks/duals are floored at WS_EPS so a stale
# active set cannot start the Newton iteration nearly singular
WS_EPS = 1e-4


def pdip_constants(dtype):
    """(ridge, w_cap) of the PDIP normal matrix at this precision."""
    if dtype == torch.float64:
        return 1e-9, 1e13
    return 1e-6, 1e7


def lane_sum(x, batch_major=False):
    """x (rows, B) summed over its rows, (1, B), each lane's bits the same
    wherever the batch puts it and whatever the batch's size.
    ``batch_major``: x is the transpose of a batch-major (B, rows) tensor,
    each lane's rows contiguous (``solve_qp_masked``'s inputs, the open
    legs).

    torch's own sum over the rows rounds a lane by its place: on the card
    where each lane's rows lie contiguous (its vector loads start at the
    lane's first aligned row, so the rounding follows the lane's address:
    identical candidates of one Shell3x3 VNS batch read F 299.69048 /
    299.69050 / 299.69052, ``scripts/slot_trace.py``), on the card where
    the lanes lie contiguous (a column's rows are split over threads by the
    batch's width), and on the CPU where the lanes lie contiguous (full
    groups of lanes run vectorised, the rest scalar).  So:
      * card, batch-major: a pairwise tree of elementwise adds (row i +
        row i + h, an odd last row added to row 0 first), which rounds
        each lane alone and whatever the batch's size;
      * lane-major: ``ops/kernels.lane_sum``, on the card a kernel that
        sums each lane's rows in one fixed order, on the CPU its plain
        version (torch's scalar path in groups of 8 lanes).  The plain
        versions of the PDIP kernels sum by ``lane_sum_plain`` instead
        (``pdip_lanes``' ``total``; on the card elementwise adds in the
        warp-per-lane kernels' order), so they launch no kernel;
      * CPU, batch-major: torch's sum lane by lane."""
    if not batch_major:
        return kernels.lane_sum(x)
    if x.device.type == "cpu":
        return x.sum(0, keepdim=True)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        y = x[:h] + x[h:2 * h]
        if x.shape[0] % 2:
            y[:1] += x[2 * h:]
        x = y
    return x


# On the card cuBLAS picks a product's algorithm, and so its rounding, by
# the product's width (the lanes, or the batch count of a batched product).
# The eager loops of a sharded path (the open legs, the NMPC loop) run their
# batch padded to a multiple of CARD_LANES lanes (sim/mpc_loop.pad_lanes)
# and their products in chunks of CARD_LANES lanes, so a lane reads the same
# bits whatever shard holds it and wherever the shard puts it.
CARD_LANES = 64


def _chunks(n):
    return [slice(i, i + CARD_LANES) for i in range(0, n, CARD_LANES)]


def lane_mm(A, X):
    """A @ X for a lane-major X (k, B): X made contiguous (on a transposed
    batch-major X the CPU's product rounds a lane by the batch's width, up
    to 3) and, on the card, in chunks of CARD_LANES columns."""
    X = X.contiguous()
    if X.device.type == "cpu" or X.shape[1] <= CARD_LANES:
        return A @ X
    return torch.cat([A @ X[:, s] for s in _chunks(X.shape[1])], dim=1)


def lane_baddbmm(x, A, C):
    """x + A @ C batched over the leading (candidate) axis, or A @ C for x
    None; on the card in chunks of CARD_LANES candidates."""
    if A.device.type == "cpu" or A.shape[0] <= CARD_LANES:
        return torch.bmm(A, C) if x is None else torch.baddbmm(x, A, C)
    return torch.cat([lane_baddbmm(None if x is None else x[s], A[s], C[s])
                      for s in _chunks(A.shape[0])])


def _row_sum(x, ones):
    """(B, m, 1) summed over its m rows: on the card as the batched product
    ``ones`` (B, 1, m) @ x, since torch's sum over a lane's rows rounds it
    by its address (``scripts/slot_trace.py --case vandevusse``)."""
    if x.device.type == "cpu":
        return x.sum(1, keepdim=True)
    return lane_baddbmm(None, ones, x)


def _row_norm(x):
    """The 2-norm of each (m, 1) of a (B, m, 1) batch; on the card the
    square root of the batched product x'x, as ``_row_sum``."""
    if x.device.type == "cpu":
        return torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return torch.sqrt(lane_baddbmm(None, x.transpose(1, 2), x))


def _max_step(v, dv):
    """Fraction-to-the-boundary step per lane (rows on axis 0); NaN
    propagates (as jnp.min does)."""
    ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, float("inf")))
    one = torch.ones((), dtype=v.dtype, device=v.device)
    return torch.minimum(one, 0.995 * ratio.amin(dim=0, keepdim=True))


def solve_qp(H, f, G, h, iters: int = 30, init=None):
    """Dense PDIP for a batch of QPs (the JAX package's ``solve_qp`` under
    ``vmap``): H (B, n, n), f (B, n), G (B, m, n), h (B, m).  ``init`` =
    (z0, lam0, s0) warm-starts (s0 recomputed from h, duals and slacks
    floored at WS_EPS); None is the cold start.  A fixed number of
    iterations; returns the best iterate by KKT merit, (z, lam, s).  Rows
    are disabled by a zero row of G and h = 1.

    Eager PyTorch with every vector a (B, k, 1) column and every
    matrix-vector product adding its vector term in the same batched call
    (``torch.baddbmm``): ~80 ops per iteration.  On the card the products
    run in chunks of CARD_LANES candidates and the sums over a candidate's
    rows as batched products too (``_row_sum``): a lane's bits follow
    neither its slot nor, in a batch padded to CARD_LANES lanes, the
    batch's width.  Sums run in another order than the JAX package's
    (rounding only)."""
    B, n = f.shape
    m = h.shape[1]
    kw = dict(dtype=f.dtype, device=f.device)
    Gt = G.transpose(1, 2)
    f, h = f[:, :, None], h[:, :, None]
    ones = torch.ones((B, 1, m), **kw)

    def residuals(z, lam, s):
        r_d = lane_baddbmm(lane_baddbmm(f, H, z), Gt, lam)
        r_p = lane_baddbmm(s - h, G, z)
        ls = lam * s
        gap = _row_sum(ls, ones)
        merit = _row_norm(r_d) + _row_norm(r_p) + gap
        return r_d, r_p, ls, gap, merit

    def solve(L, rhs):
        return spd_factor_solve(L, rhs.view(B, n)).view(B, n, 1)

    if init is None:
        z = torch.zeros_like(f)
        s = torch.clamp_min(h - lane_baddbmm(None, G, z), 1.0)
        lam = torch.ones_like(h)
    else:
        z = init[0][:, :, None]
        s = torch.clamp_min(h - lane_baddbmm(None, G, z), WS_EPS)
        lam = torch.clamp_min(init[1][:, :, None], WS_EPS)

    ridge, w_cap = pdip_constants(f.dtype)
    w_cap = torch.full((), w_cap, **kw)
    H_ridge = H + ridge * torch.eye(n, **kw)

    def max_step(s, ds, lam, dlam):
        """min(1, 0.995 x the largest step keeping s and lam positive) per
        row: the two fraction-to-the-boundary steps' minimum, taken in one
        reduction (NaN propagates, as jnp.min does)."""
        v, dv = torch.cat([s, lam], 1), torch.cat([ds, dlam], 1)
        ratio = torch.where(dv < 0, -v / dv, float("inf"))
        return (0.995 * ratio.amin(dim=1, keepdim=True)).clamp(max=1.0)

    zb, lamb, sb = z, lam, s
    mb = torch.full((B, 1, 1), float("inf"), **kw)
    for _ in range(iters):
        r_d, r_p, ls, gap, mnew = residuals(z, lam, s)
        mu = gap / m

        # best iterate by the merit of the INCOMING iterate; NaN never wins
        take = mnew < mb
        zb = torch.where(take, z, zb)
        lamb = torch.where(take, lam, lamb)
        sb = torch.where(take, s, sb)
        mb = torch.where(take, mnew, mb)

        w = torch.minimum(lam / s, w_cap)
        L = spd_factor(lane_baddbmm(H_ridge, Gt, G * w))
        neg_rd = -r_d

        dz_aff = solve(L, lane_baddbmm(neg_rd, Gt, lam - w * r_p))
        ds_aff = -lane_baddbmm(r_p, G, dz_aff)
        dlam_aff = -(ls + lam * ds_aff) / s
        a_aff = max_step(s, ds_aff, lam, dlam_aff)
        mu_aff = _row_sum((lam + a_aff * dlam_aff) * (s + a_aff * ds_aff),
                          ones) / m
        sig_r = mu_aff / (mu + 1e-30)
        sigma = sig_r * sig_r * sig_r

        r_cent = ls - sigma * mu + dlam_aff * ds_aff
        dz = solve(L, lane_baddbmm(neg_rd, Gt, r_cent / s - w * r_p))
        ds = -lane_baddbmm(r_p, G, dz)
        dlam = -(r_cent + lam * ds) / s
        a = max_step(s, ds, lam, dlam)
        z, lam, s = z + a * dz, lam + a * dlam, s + a * ds

    take = residuals(z, lam, s)[4] < mb
    return tuple(torch.where(take, a, b)[:, :, 0]
                 for a, b in ((z, zb), (lam, lamb), (s, sb)))


def solve_qp_masked(H, f, G0, T2, rmask, cmask_z, h, iters: int = 30,
                    init=None):
    """PDIP for a batch of masked MPC QPs.

    H (B, n, n), f (B, n), rmask (B, mc), cmask_z (B, n), h (B, mc); the
    constraint matrix G0 (mc, n) and its row outer products T2 (mc, n*n)
    are shared.  ``init`` = (z0, lam0, s0) warm-starts (s0 is recomputed
    from h); None is the cold start.  Returns (z, lam, s), each (B, .).
    The batch-first face of ``pdip_lanes``, with the batch-major SPD
    kernels.
    """
    warm = None if init is None else (init[0].T, init[1].T)
    out = pdip_lanes(H.permute(1, 2, 0), f.T, G0, T2.T, rmask.T, cmask_z.T,
                     h.T, iters, warm, factor=_spd_factor_t,
                     solve=_spd_solve_t, batch_major=True)
    return tuple(x.T for x in out)


def _spd_factor_t(M):
    """Lane-major (n, n, B) -> the batch-major factor (B, n, n)."""
    return spd_factor(M.permute(2, 0, 1).contiguous())


def _spd_solve_t(L, rhs):
    """Batch-major factor (B, n, n), lane-major rhs (n, B) -> x (n, B)."""
    return spd_factor_solve(L, rhs.T.contiguous()).T


def pdip_lanes(Hp, f, G0, T2T, rmask, cmask, h, iters: int, warm=None,
               factor=factor_lanes, solve=solve_lanes, batch_major=False,
               total=None):
    """Masked Mehrotra PDIP, lane-major: the batch B is the last axis.

    Hp (n, n, B), f (n, B), rmask (mc, B), cmask (n, B), h (mc, B), shared
    G0 (mc, n) and T2T (n*n, mc).  ``warm`` = (z0, lam0) warm-starts the
    solve (s from h, duals and slacks floored at WS_EPS); None is the cold
    start.  ``factor(M (n, n, B)) -> L`` and ``solve(L, rhs (n, B)) -> x
    (n, B)``: the lane-major kernels by default (the 'pdip_ws_lanes'
    engine), their plain versions in the plain versions of the other PDIP
    kernels.  ``batch_major``: the inputs are transposed batch-major
    tensors (``lane_sum``).  ``total(x (rows, B)) -> (1, B)``: the row
    sums, ``lane_sum`` by default (on the card the lane_sum kernel where
    the inputs are lane-major), ``ops/kernels.lane_sum_plain`` in the plain
    versions.  Returns the best iterate by merit, (z, lam, s).

    Masked rows are exact no-ops: their duals are pinned to zero and mu
    normalises by the active row count.  Every reduction runs over axis 0,
    the sums by ``total``: a lane's bits do not depend on its column.
    The zero rows and columns of a capacity bucket are exact no-ops in the
    products; the sums group a lane's rows by their index, so two buckets
    agree to rounding.
    """
    n, B = f.shape
    kw = dict(dtype=f.dtype, device=f.device)
    lsum = (lambda x: lane_sum(x, batch_major)) if total is None else total
    # the open legs' products as lane_mm takes them (they run sharded); the
    # step loops' (the per-step engine, the plain versions) as they come
    mm = lane_mm if batch_major else torch.matmul

    def Gmat(z):
        return rmask * mm(G0, cmask * z)

    def GTmat(y):
        return cmask * mm(G0.T, rmask * y)

    def residuals(z, lam, s):
        r_d = torch.einsum("ijb,jb->ib", Hp, z) + f + GTmat(lam)
        r_p = Gmat(z) + s - h
        gap = lsum(lam * s)
        merit = (torch.sqrt(lsum(r_d * r_d)) + torch.sqrt(lsum(r_p * r_p))
                 + gap)
        return r_d, r_p, gap, merit

    nact = torch.clamp_min(rmask.sum(0, keepdim=True), 1.0)
    eps_c = torch.full((), WS_EPS, **kw)  # a fill: no host-device copy
    if warm is None:
        z = torch.zeros_like(f)
        s = torch.maximum(h - Gmat(z), torch.ones_like(h))
        lam = torch.ones_like(h) * rmask
    else:
        z = warm[0]
        s = torch.maximum(h - Gmat(z), eps_c)
        lam = torch.maximum(warm[1], eps_c) * rmask

    ridge, w_cap = pdip_constants(f.dtype)
    w_cap = torch.full((), w_cap, **kw)
    ridge_eye = ridge * torch.eye(n, **kw)[:, :, None]
    cc = cmask[:, None, :] * cmask[None, :, :]

    zb, lamb, sb = z, lam, s
    mb = torch.full((1, B), float("inf"), **kw)
    for _ in range(iters):
        r_d, r_p, gap, mnew = residuals(z, lam, s)
        mu = gap / nact

        # best iterate by the merit of the INCOMING iterate; NaN never wins
        take = mnew < mb
        zb = torch.where(take, z, zb)
        lamb = torch.where(take, lam, lamb)
        sb = torch.where(take, s, sb)
        mb = torch.where(take, mnew, mb)

        w = torch.minimum(lam / s, w_cap) * rmask
        M = Hp + mm(T2T, w).reshape(n, n, B) * cc + ridge_eye
        L = factor(M)

        dz_aff = solve(L, -r_d + GTmat(lam - w * r_p))
        ds_aff = -(r_p + Gmat(dz_aff))
        dlam_aff = -(lam * s + lam * ds_aff) / s * rmask
        a_aff = torch.minimum(_max_step(s, ds_aff), _max_step(lam, dlam_aff))
        mu_aff = lsum((lam + a_aff * dlam_aff) * (s + a_aff * ds_aff)) / nact
        sig_r = mu_aff / (mu + 1e-30)
        sigma = sig_r * sig_r * sig_r

        r_cent = (lam * s - sigma * mu + dlam_aff * ds_aff) * rmask
        dz = solve(L, -r_d + GTmat(r_cent / s - w * r_p))
        ds = -(r_p + Gmat(dz))
        dlam = -(r_cent + lam * ds) / s * rmask
        a = torch.minimum(_max_step(s, ds), _max_step(lam, dlam))
        z, lam, s = z + a * dz, lam + a * dlam, s + a * ds

    take = residuals(z, lam, s)[3] < mb
    return (torch.where(take, z, zb), torch.where(take, lam, lamb),
            torch.where(take, s, sb))


# The band solve's slack seeding and stage-2 set-up (the JAX package's
# sim/mpc_loop _seed_slack and _eps_split_stage2), lane-major: constraint
# rows or variables on axis 0, the candidate batch on axis 1.


def _slack_violation(z, G0, rmask, cmask, h):
    """(1, B): each lane's largest soft-row violation G z - h per unit of
    its ECR slack coefficient (NaN propagates, as jnp.max does)."""
    viol = torch.clamp_min(rmask * lane_mm(G0, cmask * z) - h, 0.0)
    V = torch.clamp_min(-G0[:, -1:], 0.0)
    ratio = torch.where(V > 1e-12, viol / torch.clamp_min(V, 1e-12), 0.0)
    return ratio.amax(0, keepdim=True)


def seed_slack(z, lam, G0, rmask, cmask, h):
    """Warm start of the stage-0 slack LP: raise the carried slack to this
    step's own violation level and cold-restart the duals of lanes whose
    slack scale jumped (a disturbance entry moves the optimal slack
    discontinuously; a warm interior point spends ~30 iterations escaping
    the stale scale)."""
    extra = _slack_violation(z, G0, rmask, cmask, h)
    eps_w = torch.clamp_min(z[-1:], 0.0)
    z = torch.cat([z[:-1], eps_w + extra + 1e-6])
    jumped = extra > 1e-3 * (1.0 + eps_w)
    return z, torch.where(jumped, torch.ones_like(lam), lam)


def split_margins(dtype):
    """(relative, absolute) feasibility margin of the frozen slack."""
    return (1e-9, 1e-11) if dtype == torch.float64 else (1e-6, 1e-8)


def split_stage2(z1, G0, rmask, cmask, h):
    """Stage 2 of the eps-split band solve: (h2, cmask2, z start, ehat).  The
    slack is frozen at ehat = stage-0 slack + its residual soft-row
    violation + a margin at the precision's noise floor, folded into the
    rhs through G0's slack column, and masked out as a variable; so the
    stage-0 point is feasible for stage 2 by construction.  The margin
    feeds the frozen band rows' rhs directly, so it is the stage-2 du
    error floor (1e-9 relative clears the band oracle's gate at f64).
    No dual-based slack refinement: the JAX package records it as a dead
    end (non-unique duals on the degenerate band steps)."""
    extra = _slack_violation(z1, G0, rmask, cmask, h)
    m_rel, m_abs = split_margins(z1.dtype)
    ehat = (torch.clamp_min(z1[-1:], 0.0) + extra) * (1.0 + m_rel) + m_abs
    h2 = h - G0[:, -1:] * rmask * ehat
    cmask2 = torch.cat([cmask[:-1], torch.zeros_like(cmask[-1:])])
    z2 = torch.cat([z1[:-1], torch.zeros_like(z1[-1:])])
    return h2, cmask2, z2, ehat


def _frobenius(M):
    """||M_b||_F of a (B, n, n) batch, each candidate's bits the same
    wherever the batch puts it: on the card torch's norm reads a matrix
    with vector loads from its first aligned element, so its rounding
    follows the matrix's address where n n is no multiple of the vector
    (Shell3x3's (16, 4) and (32, 8) buckets, ``scripts/slot_trace.py``);
    there the squares are summed by ``lane_sum``'s tree.  The CPU's norm
    reads each matrix alone."""
    if M.device.type == "cpu":
        return torch.linalg.matrix_norm(M)
    return torch.sqrt(lane_sum((M * M).reshape(M.shape[0], -1).T, True))[0]


def admm_precompute(H, G, sigma: float = 1e-6, cmask=None):
    """Per-candidate constants of the equilibrated ADMM (batched).

    Variable scaling Dinv = 1/sqrt(diag H), row scaling e = 1/||row|| of
    G Dinv, rho = 0.1 ||Hs (masked)||_F / ||Gs'Gs||_F clipped to
    [1e-3, 1e2], and Minv = (Hs + sigma I + rho Gs'Gs)^{-1}, computed once
    per candidate outside any kernel.  H (B, n, n), G (B, mc, n), cmask
    (B, n).  Returns {Minv, rho, Dinv, e, Hs, Gs}.
    """
    n = H.shape[-1]
    dh = torch.sqrt(torch.clamp_min(torch.diagonal(H, dim1=-2, dim2=-1), 1e-8))
    Dinv = 1.0 / dh
    Hs = H * Dinv[:, :, None] * Dinv[:, None, :]
    Gs0 = G * Dinv[:, None, :]
    rn = torch.linalg.vector_norm(Gs0, dim=-1)
    e = 1.0 / torch.clamp_min(rn, 1e-8)
    e = torch.where(rn < 1e-12, torch.ones_like(e), e)  # disabled rows keep 1
    Gs = Gs0 * e[:, :, None]
    GtG = lane_baddbmm(None, Gs.transpose(1, 2), Gs)
    Hn = Hs if cmask is None else Hs * cmask[:, :, None] * cmask[:, None, :]
    rho = 0.1 * (_frobenius(Hn) / (_frobenius(GtG) + 1e-12))
    rho = torch.clamp(rho, 1e-3, 1e2)
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    M = Hs + sigma * eye + rho[:, None, None] * GtG
    Minv = torch.linalg.inv(M)
    return {"Minv": Minv, "rho": rho, "Dinv": Dinv, "e": e, "Hs": Hs, "Gs": Gs}


def solve_qp_admm(pre, f, h, state, iters: int, sigma: float = 1e-6,
                  over_relax: float = 1.6):
    """Fixed-iteration equilibrated ADMM for a batch of QPs min 1/2 z'Hz +
    f'z, Gz <= h (the JAX package's ``solve_qp_admm`` under ``vmap``).

    ``pre`` is ``admm_precompute``'s dict (each entry batched), f (B, n),
    h (B, mc); ``state`` = (x (B, n), zc (B, mc), y (B, mc)) is the warm
    start in SCALED coordinates, carried across closed-loop steps
    (successive MPC QPs differ only in f and h).  Returns (z (B, n)
    unscaled, new state).  Each product is a batched matrix-vector product
    (``lane_baddbmm``: on the card in chunks of CARD_LANES candidates)
    against the candidate's own Minv and Gs."""
    Minv, Dinv, e, Gs = pre["Minv"], pre["Dinv"], pre["e"], pre["Gs"]
    rho = pre["rho"][:, None]
    Gst = Gs.transpose(1, 2)
    fs = f * Dinv
    hs = h * e
    x, zc, y = state
    mv = lambda A, v: lane_baddbmm(None, A, v[:, :, None])[:, :, 0]
    for _ in range(iters):
        x = mv(Minv, sigma * x - fs + mv(Gst, rho * zc - y))
        Gx_r = over_relax * mv(Gs, x) + (1.0 - over_relax) * zc
        zc = torch.minimum(Gx_r + y / rho, hs)
        y = y + rho * (Gx_r - zc)
    return x * Dinv, (x, zc, y)


def qp_kkt_residuals(H, f, G, h, z, lam, s):
    """Diagnostics: (stationarity, primal, complementarity) residual norms
    of QP solutions, H (..., n, n), f / z (..., n), G (..., m, n), h / lam
    / s (..., m), each over any leading batch axes."""
    mv = lambda A, v: (A @ v[..., None])[..., 0]
    r_d = mv(H, z) + f + mv(G.transpose(-1, -2), lam)
    r_p = torch.clamp_min(mv(G, z) - h, 0.0)
    comp = (lam * s).abs()
    return (torch.linalg.vector_norm(r_d, dim=-1),
            torch.linalg.vector_norm(r_p, dim=-1), comp.amax(dim=-1))
