"""Linear MPC closed-loop and single-shot open-loop evaluators (the port of
the JAX package's ``sim/mpc_loop.py``).

* closed loop = per step [Kalman update -> condensed QP -> first move ->
  plant step] (the reference's toolbox ``sim(mpcobj, nit, r, v)``,
  MPC-Tuning/MPC_Tuning/closedloop_toolbox.m:50), run for a whole candidate
  batch by one of three whole-sim engines, the whole loop in one launch:
    'admm_sim' — warm equilibrated ADMM per step (ops/kernels.closed_sim_admm);
    'pdip_sim' — warm masked Mehrotra PDIP per step
                 (ops/kernels.closed_sim_pdip);
    'band_sim' — the band (y-constrained) cases' eps-split solve per step:
                 slack seeding, a BAND_LP_ITERS stage-0 slack LP, then a
                 BAND_S2_ITERS slack-frozen stage-2 PDIP (the JAX package's
                 '+lp20+split12'; ops/kernels.closed_sim_band);
  or by one of seven per-step engines (the JAX package's scan engines), a
  Python loop over steps (ops/kernels.step_loop) with one QP solve per
  step:
    'pdip_ws_fused' — the warm PDIP, all iterations in one launch
                      (ops/kernels.pdip_fused);
    'pdip_ws_lanes' — the warm PDIP as torch ops around the lane-major
                      factor and solve kernels (ops/qp.pdip_lanes with
                      ops/kernels.factor_lanes / solve_lanes);
    'admm_fused'    — the warm ADMM, all iterations in one launch
                      (ops/kernels.admm_fused);
  and, batch-major (the candidate first, as the JAX package's engines run
  under ``vmap``; BATCH_MAJOR_ENGINES):
    'pdip'          — a cold masked PDIP every step (ops/qp.solve_qp_masked:
                      torch ops around the batch-major factor and solve
                      kernels, ops/kernels.spd_factor / spd_factor_solve);
    'pdip_ws'       — the same PDIP warm-started from the previous step's
                      best iterate (z, lam);
    'pdip_dense'    — a cold dense PDIP on each candidate's own G
                      (ops/qp.solve_qp, the same two kernels);
    'admm'          — the warm equilibrated ADMM (ops/qp.solve_qp_admm,
                      batched matrix products against each candidate's
                      precomputed inverse), its state carried across steps.
  Tracking cases run every engine but 'band_sim', band cases only
  'band_sim' and only at float64; any other pairing raises.
* open loop = solve the QP once from rest with the final setpoint and play
  the optimal sequence through the model (closedloop_toolbox.m:83-100); band
  cases solve it as the cold slack LP plus a stage 2 of ``qp_iters``.

All signals are in CONDITIONED units.  Candidates form the leading batch
axis; each batch runs at the smallest capacity bucket covering its
horizons (exact: the cut rows and columns are masked no-ops).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpc_tuning_tpu_torch.models.lti import DiscreteSS
from mpc_tuning_tpu_torch.ops.kernels import (admm_fused, admm_step,
                                              closed_sim_admm, closed_sim_band,
                                              closed_sim_pdip, g_shared,
                                              pdip_fused, pdip_step,
                                              require_device, step_loop,
                                              u_rows)
from mpc_tuning_tpu_torch.ops.mpc_qp import (
    MPCController,
    assemble_candidate,
    controller_arrays,
    pin_precision,
    qp_step_data,
)
from mpc_tuning_tpu_torch.ops.qp import (CARD_LANES, lane_mm, pdip_lanes,
                                         solve_qp, solve_qp_admm,
                                         solve_qp_masked, split_stage2)

__all__ = ["MPCLoop", "horizon_caps", "ENGINES", "STEP_ENGINES",
           "BATCH_MAJOR_ENGINES", "ADMM_ENGINES", "sim_inputs", "run_engine",
           "step_engine", "BAND_LP_ITERS", "BAND_S2_ITERS",
           "require_band_dtype", "pad_lanes", "card_lanes"]

BATCH_MAJOR_ENGINES = ("pdip", "pdip_ws", "pdip_dense", "admm")
STEP_ENGINES = ("pdip_ws_fused", "pdip_ws_lanes",
                "admm_fused") + BATCH_MAJOR_ENGINES
ENGINES = ("admm_sim", "pdip_sim", "band_sim") + STEP_ENGINES
# the engines whose iteration count is ADMM's (TuningProblem.admm_iters)
ADMM_ENGINES = ("admm_sim", "admm_fused", "admm")
# warm ADMM constants of the ADMM engines (the JAX package's)
ADMM_SIGMA, ADMM_OVER_RELAX = 1e-6, 1.6

# iteration counts of the band engine's two stages (JAX '+lp20+split12')
BAND_LP_ITERS = 20
BAND_S2_ITERS = 12

# Capacity buckets: a candidate batch whose horizons all fit (p_cap, m_cap)
# is simulated with the controller tensors SLICED to that capacity — the
# rows/columns beyond max(N)/max(Nu) are fully-masked exact zeros, so the
# result is unchanged while the per-step QP cost scales with the bucket.
_P_BUCKETS = (8, 16, 32, 48, 64, 96)
_M_BUCKETS = (2, 4, 8)


def require_band_dtype(dtype):
    """Band (y-constrained) cases run at float64 only, where the JAX
    package takes its band decisions: float32 band loops leave the hard
    input bounds on some candidates.  Raises for any other dtype."""
    if dtype != torch.float64:
        raise ValueError(f"band (y-constrained) cases run at float64 only, "
                         f"got {dtype}: float32 band loops leave the hard "
                         "input bounds")


def pad_lanes(run, lanes, *batched):
    """``run(*batched)`` -> a tuple of (B, ...) tensors, run on the batch
    padded by repeating its last candidate to two lanes at least and to a
    multiple of ``lanes``; returns each output's first B.  A lane's bits
    must not depend on the batch's width (a candidate mesh cuts a batch
    into shards of any width): the BLAS's matrix-vector path, which a
    product of width 1 takes on the CPU and on the card, rounds otherwise
    than its matrix-matrix one, and on the card cuBLAS picks its algorithm
    by the width, so the eager loops run there at a multiple of
    ``ops/qp.CARD_LANES`` lanes (``card_lanes``)."""
    B = len(batched[0])
    total = max(2, -(-B // lanes) * lanes)
    if total == B:
        return run(*batched)
    out = run(*[np.concatenate([x, np.repeat(x[-1:], total - B, axis=0)])
                for x in map(np.asarray, batched)])
    return tuple(o[:B] for o in out)


def card_lanes(device) -> int:
    """The lane multiple of an eager loop's batch on ``device``
    (``pad_lanes``): CARD_LANES on the card, 1 on the CPU."""
    return CARD_LANES if torch.device(device).type == "cuda" else 1


def horizon_caps(p_max, m_max, N_b, Nu_b):
    """Smallest (p_cap, m_cap) bucket covering the batch, or the maxima."""
    n_need = int(np.max(np.asarray(N_b)))
    m_need = int(np.max(np.asarray(Nu_b)))
    p_cap = next((b for b in _P_BUCKETS if n_need <= b < p_max), p_max)
    m_cap = next((b for b in _M_BUCKETS if m_need <= b < m_max), m_max)
    return p_cap, m_cap


@dataclasses.dataclass
class MPCLoop:
    """Bound pair of (controller, true plant) ready to simulate."""

    ctl: MPCController
    plant_ss: DiscreteSS  # conditioned true plant, inputs [MV, MD]
    _cap_cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                         compare=False)

    @property
    def dims(self):
        s = self.ctl.spec
        return dict(
            p_max=s.p_max, m_max=s.m_max, ny=s.model.ny, nu=s.n_mv,
            nd=s.n_md, with_y=s.has_y_constraints, rho=float(s.rho_eps),
        )

    def capped(self, p_cap: int, m_cap: int) -> "MPCLoop":
        """Capacity-restricted view: controller prediction tensors sliced
        to (p_cap, m_cap).  EXACT for every candidate with N <= p_cap and
        Nu <= m_cap (the discarded rows/cols were fully-masked zeros)."""
        s = self.ctl.spec
        if (p_cap, m_cap) == (s.p_max, s.m_max):
            return self
        assert p_cap <= s.p_max and m_cap <= s.m_max, (p_cap, m_cap)
        key = (p_cap, m_cap)
        hit = self._cap_cache.get(key)
        if hit is None:
            ctl = self.ctl
            ny, nu = s.model.ny, s.n_mv
            spec2 = dataclasses.replace(s, p_max=p_cap, m_max=m_cap)
            Theta4 = ctl.Theta.reshape(s.p_max, ny, s.m_max, nu)
            ctl2 = MPCController(
                spec=spec2, aug=ctl.aug,
                A=ctl.A, Bu=ctl.Bu, Bv=ctl.Bv, C=ctl.C, Dv=ctl.Dv, M=ctl.M,
                Sx=ctl.Sx[:p_cap], Sstep=ctl.Sstep[: p_cap + 1],
                Sv=ctl.Sv[:p_cap],
                Theta=Theta4[:p_cap, :, :m_cap].reshape(p_cap * ny,
                                                        m_cap * nu),
                Tcum=np.kron(np.tril(np.ones((m_cap, m_cap))), np.eye(nu)),
                umin_s=ctl.umin_s, umax_s=ctl.umax_s,
                dumin_s=ctl.dumin_s, dumax_s=ctl.dumax_s,
                ymin_s=ctl.ymin_s, ymax_s=ctl.ymax_s,
            )
            hit = MPCLoop(ctl=ctl2, plant_ss=self.plant_ss)
            self._cap_cache[key] = hit
        return hit

    def arrays(self, dtype=torch.float64, device="cuda"):
        require_device(device)
        c = controller_arrays(self.ctl, dtype, device)
        mss = self.ctl.spec.model  # conditioned internal model (playback)
        for key, arr in (("A_pl", self.plant_ss.A), ("B_pl", self.plant_ss.B),
                         ("C_pl", self.plant_ss.C), ("A_pl_model", mss.A),
                         ("B_pl_model", mss.B), ("C_pl_model", mss.C)):
            c[key] = torch.as_tensor(np.asarray(arr), dtype=dtype,
                                     device=device)
        return c

    def _batch(self, N_b, Nu_b, caps, dtype, device, *vals):
        """Capped loop, its arrays and the batch as device tensors."""
        pin_precision()
        s = self.ctl.spec
        if s.has_y_constraints:
            require_band_dtype(dtype)
        if caps is None:
            caps = horizon_caps(s.p_max, s.m_max, N_b, Nu_b)
        loop = self.capped(*caps)
        c = loop.arrays(dtype, device)
        as_long = lambda x: torch.as_tensor(np.array(x), dtype=torch.long,
                                            device=device)
        as_f = lambda x: torch.as_tensor(np.array(x, dtype=np.float64),
                                         dtype=dtype, device=device)
        return loop, c, as_long(N_b), as_long(Nu_b), [as_f(x) for x in vals]

    # ------------------------------------------------- batched tuning API
    def sim_inputs(self, r_b, v, N_b, Nu_b, delta_b, lam_b, nit, dtype,
                   engine: str = "pdip_sim", device="cuda", caps=None):
        """Inputs of ``engine`` for a candidate batch: (tables, lane_consts,
        Minv_t or Hp_t, r_l, dims)."""
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; use one of {ENGINES}")
        band = self.ctl.spec.has_y_constraints
        if band != (engine == "band_sim"):
            raise ValueError(
                f"engine {engine!r} does not run "
                f"{'y-constrained (band)' if band else 'tracking'} cases: "
                "band cases run 'band_sim' only (the joint PDIP stalls on "
                "band steps), tracking cases every other engine")
        loop, c, N_t, Nu_t, (r_t, v_t, d_t, l_t) = self._batch(
            N_b, Nu_b, caps, dtype, device, np.asarray(r_b)[:, :nit],
            np.asarray(v)[:nit], delta_b, lam_b)
        d = loop.dims
        return sim_inputs(engine, c, r_t, v_t, N_t, Nu_t, d_t, l_t,
                          d["p_max"], d["m_max"], d["ny"], d["nu"], d["rho"])

    def closed_batch(self, r_b, v, N_b, Nu_b, delta_b, lam_b, nit, dtype,
                     qp_iters, engine: str = "pdip_sim", device="cuda",
                     caps=None):
        """Closed loops of a candidate batch: r_b (B, nit, ny), v (nit, nd),
        N_b / Nu_b (B,), delta_b (B, ny), lam_b (B, nu).  ``qp_iters`` is
        the engine's iteration count (ADMM or PDIP; 'band_sim' runs its
        fixed BAND_LP_ITERS + BAND_S2_ITERS).  Returns (Y (B, nit, ny),
        U (B, nit, nu)) tensors on ``device``; a lone candidate runs as
        two lanes (``pad_lanes``); the batch-major engines, which run as
        eager torch ops, on the card a multiple of CARD_LANES lanes, as the
        open legs."""
        lanes = card_lanes(device) if engine in BATCH_MAJOR_ENGINES else 1
        return pad_lanes(
            lambda *b: run_engine(engine, *self.sim_inputs(
                b[0], v, *b[1:], nit, dtype, engine, device, caps), qp_iters),
            lanes, r_b, N_b, Nu_b, delta_b, lam_b)

    def open_batch(self, rfin_b, v, N_b, Nu_b, delta_b, lam_b, nit, dtype,
                   qp_iters, device="cuda", caps=None):
        """Open-loop playback of a candidate batch: rfin_b (B, ny) final
        setpoints.  Returns (Y (B, nit, ny), U (B, nit, nu)) tensors; the
        batch runs padded (``pad_lanes``: two lanes at least, on the card a
        multiple of CARD_LANES)."""
        v = np.asarray(v)

        def run(rfin_b, N_b, Nu_b, delta_b, lam_b):
            loop, c, N_t, Nu_t, (r_t, vf_t, v_t, d_t, l_t) = self._batch(
                N_b, Nu_b, caps, dtype, device, rfin_b, v[nit - 1], v[:nit],
                delta_b, lam_b)
            d = loop.dims
            return open_loop_batch(c, r_t, vf_t, v_t, N_t, Nu_t, d_t, l_t,
                                   d["p_max"], d["m_max"], d["ny"], d["nu"],
                                   d["rho"], qp_iters, d["with_y"])

        return pad_lanes(run, card_lanes(device), rfin_b, N_b, Nu_b,
                         delta_b, lam_b)

    # -------------------------------------------------------------- API
    def simulate(self, r, v, nit, N, Nu, delta, lam, dtype=torch.float64,
                 qp_iters: int = 30, engine: str = "pdip_sim", device="cuda"):
        """Closed loop of one candidate (a B = 1 ``closed_batch``).
        Returns (y, u) conditioned NumPy arrays (nit, ny), (nit, nu)."""
        Y, U = self.closed_batch(
            np.asarray(r)[None], v, [N], [Nu], np.asarray(delta)[None],
            np.asarray(lam)[None], nit, dtype, qp_iters, engine, device)
        return Y[0].cpu().numpy(), U[0].cpu().numpy()

    def open_loop(self, r_final, v, nit, N, Nu, delta, lam,
                  dtype=torch.float64, qp_iters: int = 30, device="cuda"):
        """Single-shot optimal sequence from rest played through the model
        (a B = 1 ``open_batch``).  Returns (ys, uopt) NumPy arrays."""
        Y, U = self.open_batch(
            np.asarray(r_final)[None], v, [N], [Nu], np.asarray(delta)[None],
            np.asarray(lam)[None], nit, dtype, qp_iters, device)
        return Y[0].cpu().numpy(), U[0].cpu().numpy()


# ------------------------------------------------------------ evaluators


def open_loop_batch(c, r_final, v_final, v_traj, N, Nu, delta, lam,
                    p_max, m_max, ny, nu, rho, qp_iters, with_y):
    """From rest (all case setpoints are zero at k=0): one cold masked PDIP
    per candidate (band cases: a cold BAND_LP_ITERS slack LP, then the
    slack-frozen stage 2 of ``qp_iters``), the optimal du sequence held
    after the control horizon and played through the conditioned model."""
    dtype, dev = r_final.dtype, r_final.device
    B = r_final.shape[0]
    cand = assemble_candidate(c, N, Nu, delta, lam, p_max, m_max, ny, nu,
                              rho, with_y)
    nxa = c["A"].shape[0]
    nit = v_traj.shape[0]
    nd = v_traj.shape[1]
    x_hat = torch.zeros((B, nxa), dtype=dtype, device=dev)
    u_prev = torch.zeros((B, nu), dtype=dtype, device=dev)
    r_s = r_final / c["sf_y"]
    v_s = v_final / c["sf_v"] if nd else v_final
    f, h, _ = qp_step_data(c, cand, x_hat, u_prev, r_s, v_s, p_max, m_max,
                           ny, nu, with_y)
    G0, T2, rmask, cmask = c["G0"], c["T2"], cand["rmask"], cand["cmask_z"]
    if with_y:
        z1, lam1, _ = solve_qp_masked(cand["H_lp"], cand["f_lp"], G0, T2,
                                      rmask, cmask, h, iters=BAND_LP_ITERS)
        h2, cmask2, z2, _ = split_stage2(z1.T, G0, rmask.T, cmask.T, h.T)
        z, _, _ = solve_qp_masked(cand["H"], f, G0, T2, rmask, cmask2.T,
                                  h2.T, iters=qp_iters,
                                  init=(z2.T, lam1, None))
    else:
        z, _, _ = solve_qp_masked(cand["H"], f, G0, T2, rmask, cmask, h,
                                  iters=qp_iters)
    du_seq = (z[:, :-1] * cand["cmask_flat"]).reshape(B, m_max, nu)
    u_seq = torch.cumsum(du_seq, dim=1) * c["sf_u"]
    idx = torch.clamp(torch.arange(nit, device=dev), 0, m_max - 1)
    uopt = u_seq[:, idx]                                   # (B, nit, nu)

    # the playback lane-major, the model's matrices on the left: a product
    # with the batch as the BLAS's rows rounds a lane by the batch's width
    A_m, B_m, C_m = c["A_pl_model"], c["B_pl_model"], c["C_pl_model"]
    x = torch.zeros((A_m.shape[0], B), dtype=dtype, device=dev)
    ys = torch.empty((nit, ny, B), dtype=dtype, device=dev)
    u_l = uopt.permute(1, 2, 0).contiguous()               # (nit, nu, B)
    for k in range(nit):
        ys[k] = C_m @ x
        uv = torch.cat([u_l[k], v_traj[k][:, None].expand(nd, B)], dim=0)
        x = A_m @ x + B_m @ uv
    return ys.permute(2, 0, 1), uopt


def sim_inputs(engine, c, r_b, v, N_b, Nu_b, delta_b, lam_b, p_max, m_max,
               ny, nu, rho):
    """Shared tables, lane constants, per-lane matrices and scaled
    setpoints of ``engine`` (the table-building half of the JAX wrappers
    _closed_sim_fused_body, closed_loop_batch_sim_pdip and
    closed_loop_batch_sim_band, without the TPU tile padding); the ADMM
    engines share one set, the PDIP engines another.  The batch-major
    engines (BATCH_MAJOR_ENGINES) also take the candidates' own QP data,
    ``assemble_candidate``'s batch-major dict, as lane_consts["cand"].
    Returns (tables, lane_consts, Minv_t or Hp_t (n, n, B), r_l (nit, ny,
    B), dims)."""
    dtype, dev = r_b.dtype, r_b.device
    B, nit = r_b.shape[:2]
    n = m_max * nu + 1
    pny = p_max * ny
    kw = dict(dtype=dtype, device=dev)
    band = engine == "band_sim"
    cand = assemble_candidate(c, N_b, Nu_b, delta_b, lam_b, p_max, m_max, ny,
                              nu, rho, band)

    def lanes(x):  # (B, rows) -> lane-major (rows, B)
        return x.T.contiguous()

    q_b = (delta_b.abs()[:, None, :] ** 2
           * cand["row_mask"][:, :, None]).reshape(B, pny)
    h1 = cand["en_du_hi"] * c["dumax"].repeat(m_max) + (1.0 - cand["en_du_hi"])
    h2 = -cand["en_du_lo"] * c["dumin"].repeat(m_max) + (1.0 - cand["en_du_lo"])
    h3 = cand["en_u_hi"] * c["umax"].repeat(m_max) + (1.0 - cand["en_u_hi"])
    h4 = -cand["en_u_lo"] * c["umin"].repeat(m_max) + (1.0 - cand["en_u_lo"])
    zeros_mu = torch.zeros_like(h1)
    hbu = torch.cat([h1, h2, h3, h4], dim=1)
    su = torch.cat([zeros_mu, zeros_mu, -cand["en_u_hi"], cand["en_u_lo"]],
                   dim=1)
    lc = {
        "q": lanes(q_b),
        "sfy": c["sf_y"][:, None].expand(ny, B).contiguous(),
        "sfu": c["sf_u"][:, None].expand(nu, B).contiguous(),
    }
    if band:
        # band rows' rhs: hb - rm * free (y_hi) and hb + rm * free (y_lo),
        # the enable masks and ymax / ymin tiles folded into hb
        rm_rep = cand["row_mask"].repeat_interleave(ny, dim=1)
        rmyh = rm_rep * c["en_y_hi"].repeat(p_max)
        rmyl = rm_rep * c["en_y_lo"].repeat(p_max)
        cmask2 = cand["cmask_z"].clone()
        cmask2[:, -1] = 0.0
        lc.update(
            hbu=lanes(hbu), su=lanes(su),
            hbyh=lanes(rmyh * c["ymax"].repeat(p_max) + (1.0 - rmyh)),
            rmyh=lanes(rmyh),
            hbyl=lanes(-rmyl * c["ymin"].repeat(p_max) + (1.0 - rmyl)),
            rmyl=lanes(rmyl),
            cmask2=lanes(cmask2),
            lpd=lanes(torch.diagonal(cand["H_lp"], dim1=1, dim2=2)))
    else:
        zero1 = torch.zeros((B, 1), **kw)
        lc.update(hbase=lanes(torch.cat([hbu, zero1], dim=1)),
                  su=lanes(torch.cat([su, zero1], dim=1)))

    # shared tables; per-step v-dependent columns packed into Vt (nv, nit)
    nd = v.shape[1]
    nxa, nxp = c["A"].shape[0], c["A_pl"].shape[0]
    SvF = c["Sv"].reshape(pny, -1)
    if nd:
        v_s = v / c["sf_v"]
        Vt = torch.cat([c["Dv"] @ v_s.T, c["Bv"] @ v_s.T,
                        c["B_pl"][:, nu:] @ v.T, SvF @ v_s.T], dim=0)
    else:
        Vt = torch.zeros((ny + nxa + nxp + pny, nit), **kw)
    ThT = torch.zeros((n, pny), **kw)
    ThT[:m_max * nu] = c["Theta"].T
    tables = {
        "Cpl": c["C_pl"], "Apl": c["A_pl"],
        "Bplu": c["B_pl"][:, :nu].contiguous(),
        "C": c["C"], "Mk": c["M"], "A": c["A"], "Bu": c["Bu"],
        "SxF": c["Sx"].reshape(pny, -1).contiguous(),
        "SstF": c["Sstep"][1:].reshape(pny, nu).contiguous(),
        "ThT": ThT, "G0": c["G0"], "Vt": Vt.contiguous(),
    }
    r_l = (r_b / c["sf_y"][None, None, :]).permute(1, 2, 0).contiguous()
    dims = dict(ny=ny, nu=nu, n=n, mc=c["G0"].shape[0], m_max=m_max)

    if engine in BATCH_MAJOR_ENGINES:
        lc["cand"] = cand
    if engine in ADMM_ENGINES:
        pre = cand["admm"]
        Dinv_m = pre["Dinv"] * cand["cmask_z"]  # masked-variable fs/du scale
        lc.update(arow=lanes(pre["e"] * cand["rmask"]), acol=lanes(Dinv_m),
                  Dinv=lanes(Dinv_m), e=lanes(pre["e"]),
                  par=torch.stack([pre["rho"], 1.0 / pre["rho"]]).contiguous())
        Hm = pre["Minv"].permute(1, 2, 0).contiguous()
    else:
        lc.update(rmask=lanes(cand["rmask"]), cmask=lanes(cand["cmask_z"]))
        tables["T2T"] = c["T2"].T.contiguous()
        Hm = cand["H"].permute(1, 2, 0).contiguous()
    return tables, lc, Hm, r_l, dims


def run_engine(engine, tables, lane_consts, Hm, r_l, dims, qp_iters):
    """Run ``engine`` on its inputs (``sim_inputs``):
      'admm_sim' / 'admm_fused' — `qp_iters` warm equilibrated ADMM
                   iterations per step (sigma ADMM_SIGMA, over-relaxation
                   ADMM_OVER_RELAX) against Minv_t;
      'pdip_sim' / 'pdip_ws_fused' / 'pdip_ws_lanes' / 'pdip_ws' — a
                   warm-started masked PDIP of `qp_iters` iterations per
                   step against Hp_t; the best iterate (z, lam) is the next
                   step's warm pair;
      'pdip' / 'pdip_dense' — a cold PDIP of `qp_iters` iterations per
                   step (masked, or on each candidate's dense G);
      'admm'     — `qp_iters` warm ADMM iterations per step (batch-major,
                   ``batch_major_step``);
      'band_sim' — the eps-split band solve per step (BAND_LP_ITERS,
                   BAND_S2_ITERS; `qp_iters` unused); the stage-0 LP's
                   (z, lam) is the next step's warm pair.
    Returns (Y (B, nit, ny), U (B, nit, nu))."""
    nit = r_l.shape[0]
    if engine in STEP_ENGINES:
        Y, U = step_engine(engine, tables, lane_consts, Hm, r_l, dims,
                           qp_iters)
    elif engine == "admm_sim":
        Y, U = closed_sim_admm(tables, lane_consts, Hm, r_l, nit=nit,
                               iters=qp_iters, sigma=ADMM_SIGMA,
                               over_relax=ADMM_OVER_RELAX, dims=dims)
    elif engine == "band_sim":
        Y, U, _ = closed_sim_band(tables, lane_consts, Hm, r_l, nit=nit,
                                  lp_iters=BAND_LP_ITERS,
                                  s2_iters=BAND_S2_ITERS, dims=dims)
    else:
        Y, U = closed_sim_pdip(tables, lane_consts, Hm, r_l, nit=nit,
                               iters=qp_iters, dims=dims)
    return Y.permute(2, 0, 1), U.permute(2, 0, 1)


def _pdip_ws_lanes(Hp, f, h, rmask, cmask, warm, G, iters):
    """The 'pdip_ws_lanes' per-step solve: ops/qp.pdip_lanes with the
    lane-major factor and solve kernels."""
    return pdip_lanes(Hp, f, G["G0"], G["T2T"], rmask, cmask, h, iters, warm)


def batch_major_step(engine, tables, lane_consts, dims, iters):
    """The per-step solve of the batch-major engines (BATCH_MAJOR_ENGINES)
    for ``step_loop``: the step's f and h as the lane-major engines form
    them, transposed to the candidate-first layout, then the engine's QP
    on the candidates' own data (lane_consts["cand"]):
      'pdip'       — ``solve_qp_masked``, cold;
      'pdip_ws'    — ``solve_qp_masked`` warm-started from the previous
                     step's best (z, lam), from (0, 1);
      'pdip_dense' — ``solve_qp`` on the dense G, cold;
      'admm'       — ``solve_qp_admm`` carrying its scaled (x, zc, y), from
                     zeros.
    Returns (solve, warm)."""
    t, lc = tables, lane_consts
    cand = lc["cand"]
    nu, mc, m_max = dims["nu"], dims["mc"], dims["m_max"]
    H, rmask, cmask = cand["H"], cand["rmask"], cand["cmask_z"]
    G0 = t["G0"]
    T2 = t["T2T"].T if "T2T" in t else None  # the PDIP engines' tables
    B, n = cmask.shape
    kw = dict(dtype=H.dtype, device=H.device)

    def solve(k, err, free, u_prev, warm):
        f = ((-2.0 * lane_mm(t["ThT"], err)).T * cmask).contiguous()
        h = (lc["hbase"] + lc["su"] * u_rows(u_prev, m_max, mc)).T
        h = h.contiguous()
        if engine == "admm":
            z, warm = solve_qp_admm(cand["admm"], f, h, warm, iters,
                                    ADMM_SIGMA, ADMM_OVER_RELAX)
        elif engine == "pdip_dense":
            z = solve_qp(H, f, cand["G"], h, iters)[0]
        else:
            init = None if engine == "pdip" else (warm[0], warm[1], None)
            z, lam, _ = solve_qp_masked(H, f, G0, T2, rmask, cmask, h,
                                        iters, init)
            warm = (z, lam)
        return z[:, :nu].T, warm

    if engine == "admm":
        return solve, (torch.zeros((B, n), **kw), torch.zeros((B, mc), **kw),
                       torch.zeros((B, mc), **kw))
    return solve, (torch.zeros((B, n), **kw), torch.ones((B, mc), **kw))


def step_engine(engine, tables, lane_consts, Hm, r_l, dims, iters):
    """The per-step engine ``engine`` (one of STEP_ENGINES): the closed
    loop of ``ops/kernels.step_loop`` with one QP solve per step through
    the engine's kernels.  The shared constraint matrix's CSR is built
    once here, not per step.  Returns (Y (nit, ny, B), U (nit, nu, B))."""
    if engine in BATCH_MAJOR_ENGINES:
        # products in chunks of CARD_LANES lanes on the card (lane_mm), as
        # their batched products (ops/qp.solve_qp, solve_qp_admm)
        solve, warm = batch_major_step(engine, tables, lane_consts, dims,
                                       iters)
        return step_loop(tables, lane_consts, r_l, dims, solve, warm,
                         mm=lane_mm)
    G = g_shared(tables["G0"], tables.get("T2T"))
    if engine == "admm_fused":
        solve, warm = admm_step(tables, lane_consts, Hm, dims, G, iters,
                                ADMM_SIGMA, ADMM_OVER_RELAX, admm_fused)
    else:
        qp = pdip_fused if engine == "pdip_ws_fused" else _pdip_ws_lanes
        solve, warm = pdip_step(tables, lane_consts, Hm, dims, G, iters, qp)
    return step_loop(tables, lane_consts, r_l, dims, solve, warm)
