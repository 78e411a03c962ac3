"""The port's CUDA kernels against their plain PyTorch versions on the card
(small Wood-Berry, Shell7x5, Shell3x3 and Van de Vusse shapes).  Skipped
on hosts without a CUDA device; on a GPU host run
``python -m pytest --noconftest tests/test_torch_gpu.py``."""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from mpc_tuning_tpu_torch.cases import shell3x3, shell7x5, vandevusse, woodberry
from mpc_tuning_tpu_torch.models import plants
from mpc_tuning_tpu_torch.models.ode import nmpc_rollout_plain
from mpc_tuning_tpu_torch.ops import kernels as K
from mpc_tuning_tpu_torch.sim import mpc_loop
from mpc_tuning_tpu_torch.tools.band_spread import (band_gate, band_inputs,
                                                    band_lane_errors,
                                                    band_witness)
from mpc_tuning_tpu_torch.tuning.api import build_problem

pytestmark = pytest.mark.gpu

F64 = torch.float64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _inputs(engine, B=40, nit=60, caps=(64, 8), case=woodberry, dtype=F64):
    problem, _ = build_problem(case.make_case(nit=nit), device="cuda")
    rng = np.random.default_rng(0)
    N = rng.integers(caps[1] + 1, caps[0] + 1, size=B)
    Nu = rng.integers(2, caps[1] + 1, size=B)
    r_b = np.broadcast_to(problem.r, (B, nit, problem.my))
    return problem.loop.sim_inputs(
        r_b, problem.v, N, Nu, rng.uniform(0.2, 2.0, (B, problem.my)),
        rng.uniform(0.05, 0.5, (B, problem.nu)), nit, dtype, engine, "cuda",
        caps=caps)


def _spd_batch(cuda, B, n, dtype=F64):
    """B SPD matrices (B, n, n) and right-hand sides (B, n), seeded by n."""
    g = torch.Generator(device=cuda).manual_seed(n)
    A = torch.randn((B, n, n), generator=g, device=cuda, dtype=dtype)
    M = A @ A.transpose(1, 2) + n * torch.eye(n, device=cuda, dtype=dtype)
    return M, torch.randn((B, n), generator=g, device=cuda, dtype=dtype)


# the factor kernels' sizes: n = 1, the tunes' buckets up to Shell's 46 (two
# rows a lane) and the envelope's edge, 64; B = 1, 3 and 37 leave a block's
# matrices part-filled
FACTOR_N = [1, 5, 17, 31, 46, 64]
FACTOR_B = [1, 3, 37, 300]


@pytest.mark.parametrize("B", FACTOR_B)
@pytest.mark.parametrize("n", FACTOR_N)
def test_spd_kernels_match_plain(cuda, n, B):
    M, rhs = _spd_batch(cuda, B, n)
    before = K.launch_counts()
    L = K.spd_factor(M)
    x = K.spd_factor_solve(L, rhs)
    after = K.launch_counts()
    assert after["spd_factor"] == before["spd_factor"] + 1
    assert after["spd_factor_solve"] == before["spd_factor_solve"] + 1
    torch.testing.assert_close(L, K.spd_factor_plain(M), rtol=0, atol=1e-10)
    torch.testing.assert_close(x, K.spd_factor_solve_plain(L, rhs), rtol=0,
                               atol=1e-10)


# The whole-sim kernels, one warp per lane (W = 4 lanes a block at float32,
# 2 at float64): B = 1, 2 and 18 are the tunes' batches, 37 leaves the last
# block part-filled; Wood-Berry's (64, 8) and (127, 15) buckets and, for the
# PDIP, Shell3x3's widest (n = 46: two rows a lane, over 48 KB of shared
# memory).  Held step by step (the plain version follows the kernel's U) at
# chip_smoke.py's gates: float64 1e-9; float32 1e-3, float32 PDIP U at the
# median lane 1e-3 and on every lane 0.1 (PDIP answers scatter at float32),
# a lane over it held by correct runs one rounding away
# (tools/pdip_spread.pdip_u_hold).
SIM_B = [1, 2, 18, 37]
SIM_CASES = {"wb64x8": (woodberry, (64, 8)),
             "wb127x15": (woodberry, (127, 15)),
             "s3127x15": (shell3x3, (127, 15))}
F32_SIM_GATE, F32_PDIP_U_CAP = 1e-3, 0.1


def _sim_check(name, args, dims, dtype):
    """Launch whole-sim kernel ``name`` once and hold it step by step."""
    kernel = getattr(K, name)
    before = kernel.launches
    Y, U = kernel(*args, dims=dims)
    assert kernel.launches == before + 1
    assert torch.isfinite(Y).all() and torch.isfinite(U).all()
    Yp, Up = getattr(K, name + "_plain")(*args, dims=dims, u_follow=U)
    dy = (Y - Yp).abs().amax((0, 1))
    du = (U - Up).abs().amax((0, 1))
    if dtype == F64:
        assert max(float(dy.max()), float(du.max())) <= 1e-9
    elif name == "closed_sim_admm":
        assert max(float(dy.max()), float(du.max())) <= F32_SIM_GATE
    else:
        from mpc_tuning_tpu_torch.tools.pdip_spread import pdip_u_hold

        if not (float(dy.max()) <= F32_SIM_GATE
                and float(du.median()) <= F32_SIM_GATE
                and float(du.max()) <= F32_PDIP_U_CAP):
            # lanes over the cap: by correct runs one rounding away
            ok, text = pdip_u_hold(getattr(K, name + "_plain"), args,
                                   dict(dims=dims), Y, U, F32_SIM_GATE,
                                   F32_PDIP_U_CAP)
            assert ok, text


@pytest.mark.parametrize("dtype", [F64, torch.float32])
@pytest.mark.parametrize("cell", ["wb64x8", "wb127x15"])
@pytest.mark.parametrize("B", SIM_B)
def test_closed_sim_admm_matches_plain(cuda, B, cell, dtype):
    case, caps = SIM_CASES[cell]
    t, lc, Minv, r_l, dims = _inputs("admm_sim", B=B, caps=caps, case=case,
                                     dtype=dtype)
    _sim_check("closed_sim_admm",
               (t, lc, Minv, r_l, r_l.shape[0], 40, 1e-6, 1.6), dims, dtype)


@pytest.mark.parametrize("dtype", [F64, torch.float32])
@pytest.mark.parametrize("cell", ["wb64x8", "wb127x15", "s3127x15"])
@pytest.mark.parametrize("B", SIM_B)
def test_closed_sim_pdip_matches_plain(cuda, B, cell, dtype):
    case, caps = SIM_CASES[cell]
    t, lc, Hp, r_l, dims = _inputs("pdip_sim", B=B, caps=caps, case=case,
                                   dtype=dtype)
    _sim_check("closed_sim_pdip", (t, lc, Hp, r_l, r_l.shape[0], 15), dims,
               dtype)


def _pad_rows(engine, inputs, extra):
    """The inputs with `extra` all-zero constraint rows appended to G0:
    0 <= 1, inactive at every step, so the loop is unchanged."""
    t, lc, Hm, r_l, dims = inputs
    B = r_l.shape[2]
    t = dict(t, G0=torch.cat([t["G0"], t["G0"].new_zeros(
        (extra, t["G0"].shape[1]))]))
    pad = {"hbase": 1.0, "su": 0.0, "rmask": 1.0, "arow": 1.0, "e": 1.0}
    lc = dict(lc, **{k: torch.cat([lc[k], lc[k].new_full((extra, B), v)])
                     for k, v in pad.items() if k in lc})
    if engine == "pdip_sim":
        n = t["G0"].shape[1]
        t["T2T"] = torch.einsum("ki,kj->ijk", t["G0"], t["G0"]).reshape(
            n * n, -1).contiguous()
    return t, lc, Hm, r_l, dict(dims, mc=dims["mc"] + extra)


@pytest.mark.parametrize("engine", ["admm_sim", "pdip_sim"])
def test_sim_envelope_matches_the_launcher(cuda, engine):
    """At the largest mc sim_envelope admits (Wood-Berry (127, 15), G0
    padded with zero rows, float64: ~227 KB a block) the kernel runs and
    follows its plain version; one row more, the wrapper raises without
    launching and the C launcher itself refuses."""
    from mpc_tuning_tpu_torch.ops import _build

    pdip = engine == "pdip_sim"
    name = "closed_sim_" + engine[:4]
    inputs = _inputs(engine, B=3, nit=4, caps=(127, 15))
    t, _, _, _, dims = inputs
    shape = lambda mc: (dims["n"], mc, t["SxF"].shape[0], dims["ny"],
                        dims["nu"], t["A"].shape[0], t["Apl"].shape[0])
    edge = dims["mc"]
    while True:
        try:
            K.sim_envelope(pdip, F64, *shape(edge + 1))
        except ValueError:
            break
        edge += 1
    assert K.sim_envelope(pdip, F64, *shape(edge))[1] > 226 * 1024
    iters = (15,) if pdip else (40, 1e-6, 1.6)
    t, lc, Hm, r_l, d = _pad_rows(engine, inputs, edge - dims["mc"])
    _sim_check(name, (t, lc, Hm, r_l, 4, *iters), d, F64)

    t, lc, Hm, r_l, d = _pad_rows(engine, inputs, edge + 1 - dims["mc"])
    before = K.launch_counts()
    with pytest.raises(ValueError, match="whole-sim"):
        getattr(K, name)(t, lc, Hm, r_l, 4, *iters, dims=d)
    assert K.launch_counts() == before
    lib = _build.library()
    vals = dict(B=3, nit=4, iters=iters[0], ny=d["ny"], nu=d["nu"],
                nxa=t["A"].shape[0], nxp=t["Apl"].shape[0],
                pny=t["SxF"].shape[0], n=d["n"], mc=d["mc"],
                m_max=d["m_max"])
    dims_c = (ctypes.c_int * len(K._SIM_DIMS))(*[vals[k] for k in K._SIM_DIMS])
    ptrs = (ctypes.c_void_p * len(K._SIM_PTRS))()
    scal = (ctypes.c_double * 3)(0.0, 0.0, 0.0)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    assert lib.mpc_closed_sim(int(pdip), 1, ptrs, dims_c, scal, stream) != 0


def _band_inputs(cuda, caps, B=4, nit=30):
    problem, _ = build_problem(shell7x5.make_case(nit=nit), device=cuda)
    (t, lc, Hp, r_l, dims), _, _ = band_inputs(problem, caps, B, nit, F64,
                                               caps[0], device=cuda)
    return t, lc, Hp, r_l, nit, 20, 12, dims


@pytest.mark.parametrize("caps", [(32, 4), (127, 15)])
def test_closed_sim_band_matches_plain(cuda, caps):
    """Step by step (the plain version follows the kernel's U), at the
    gate of chip_smoke.py's band rows: twice the witness measured along
    the kernel's U (tools/band_spread.band_witness), the lanes over it (if
    any) decided step by step by the certificate relative to correct runs
    of the plain solve chain (ops/band_cert.hold_relative).
    (127, 15) runs a cluster of four blocks a candidate, (32, 4) one."""
    from mpc_tuning_tpu_torch.ops.band_cert import hold_relative
    from mpc_tuning_tpu_torch.tools.band_spread import band_candidates

    args = _band_inputs(cuda, caps)
    before = K.closed_sim_band.launches
    out_k = K.closed_sim_band(*args)
    assert K.closed_sim_band.launches == before + 1
    assert all(torch.isfinite(x).all() for x in out_k)
    out_p = K.closed_sim_band_plain(*args, u_follow=out_k[1])
    witness = band_witness(args[:-1], dict(dims=args[-1]), out_k[1], out_p)
    ok, txt, over = band_gate(band_lane_errors(out_k, out_p), witness, caps)
    assert over is not None, txt
    problem, _ = build_problem(shell7x5.make_case(nit=args[4]), device=cuda)
    N, Nu, lam = band_candidates(caps, out_k[0].shape[2], caps[0])
    U, E = out_k[1].cpu().numpy(), out_k[2].cpu().numpy()
    for b in over:
        out = hold_relative(problem, N[b], Nu[b], np.zeros(7), lam[b],
                            U[:, :, b], E[:, b], caps=(int(N[b]), int(Nu[b])),
                            device=cuda)
        print(f"{caps} lane {b}: {out['chains']} chains; slack step "
              f"{out['eps_step']} {out['eps_run']:.3e} (limit "
              f"{out['eps_limit']:.3e}); du step {out['du_step']} "
              f"{out['du_run']:.3e} (limit {out['du_limit']:.3e})")
        assert out["ok"], (txt, b, out)


def _lanes(x, b):
    """The first b lanes of lane-major tensors (the batch on the last
    axis) in x, a dict of them or one."""
    if isinstance(x, dict):
        return {k: _lanes(v, b) for k, v in x.items()}
    return x[..., :b].contiguous()


@pytest.mark.parametrize("caps", [(127, 2), (48, 4), (127, 15)])
def test_closed_sim_band_bits_do_not_depend_on_b(cuda, caps):
    """A lane's (Y, U, E) are the same bits at B = 1, 8 and 37 and in two
    runs: each candidate's cluster reduces in a fixed order (2, 1 and 4
    blocks a cluster at these buckets)."""
    t, lc, Hp, r_l, nit, lp, s2, dims = _band_inputs(cuda, caps, B=37, nit=40)
    run = lambda b: K.closed_sim_band(t, _lanes(lc, b), _lanes(Hp, b),
                                      _lanes(r_l, b), nit, lp, s2, dims)
    ref = run(37)
    assert all(torch.isfinite(x).all() for x in ref)
    for b in (37, 8, 1):
        for x, y in zip(run(b), ref):
            assert torch.equal(x, y[..., :b]), b


def test_closed_sim_band_certified_at_the_tuned_point(cuda):
    """chip_smoke.py's per-step certificate at the reference's tuned point
    (B = 1, nit 80): every step's slack at the LP minimum (1e-6 relative),
    the first move at the certified one where du is well posed (1e-3)."""
    from mpc_tuning_tpu_torch.ops.band_cert import certify_pool, hold

    ref = shell7x5.REF_TUNED
    nit = 80
    problem, _ = build_problem(shell7x5.make_case(nit=nit), L=np.diag(ref.L),
                               R=np.diag(ref.R), device=cuda)
    N, Nu = ref.N, int(ref.Nu.max())
    t, lc, Hp, r_l, dims = problem.loop.sim_inputs(
        problem.r[None], problem.v, [N], [Nu], np.zeros((1, 7)),
        ref.lam[None], nit, F64, "band_sim", cuda)
    _, U, E = K.closed_sim_band(t, lc, Hp, r_l, nit, 20, 12, dims)
    with certify_pool(4) as pool:
        out = hold(problem, N, Nu, np.zeros(7), ref.lam,
                   U[:, :, 0].cpu().numpy(), E[:, 0].cpu().numpy(),
                   caps=(N, Nu), pool=pool)
    assert out["steps"] == nit and out["eps_pos"] > 20, out
    assert out["ok"], out


def _pad_pairs(inputs, extra):
    """Band inputs with `extra` band pairs more, all masked: zero rows of
    G0 after the y_hi and the y_lo blocks, zero rows of the free-response
    tables, rhs 1 and mask 0.  The loop is unchanged."""
    t, lc, Hp, r_l, nit, lp, s2, dims = inputs
    B = r_l.shape[2]
    pny = t["SxF"].shape[0]
    nmv = 4 * dims["m_max"] * dims["nu"]
    zrows = lambda x, k: torch.cat([x, x.new_zeros((k,) + x.shape[1:])])

    def ins(x, fill):  # rows after the y_hi block and after the y_lo block
        new = x.new_full((extra,) + x.shape[1:], fill)
        return torch.cat([x[:nmv + pny], new, x[nmv + pny:nmv + 2 * pny],
                          new, x[nmv + 2 * pny:]])

    t = dict(t, G0=ins(t["G0"], 0.0), SxF=zrows(t["SxF"], extra),
             SstF=zrows(t["SstF"], extra), Vt=zrows(t["Vt"], extra),
             ThT=torch.cat([t["ThT"], t["ThT"].new_zeros((t["ThT"].shape[0],
                                                          extra))], 1))
    lc = dict(lc, rmask=ins(lc["rmask"], 0.0), q=zrows(lc["q"], extra),
              **{k: torch.cat([lc[k], lc[k].new_full((extra, B), v)])
                 for k, v in (("hbyh", 1.0), ("hbyl", 1.0), ("rmyh", 0.0),
                              ("rmyl", 0.0))})
    return t, lc, Hp, r_l, nit, lp, s2, dict(dims, mc=dims["mc"] + 2 * extra)


def test_band_envelope_matches_the_launcher(cuda):
    """The C side's plan (mpc_closed_sim_band_plan) is band_plan's at
    every Shell7x5 bucket shape and at the edge; at the edge (the widest
    bucket with 138 masked band pairs more: four blocks of ~227 KB) the
    kernel runs and gives the unpadded run's bits; one pair more, the
    wrapper raises without launching and the C launcher refuses."""
    from mpc_tuning_tpu_torch.ops import _build

    lib = _build.library()
    inputs = _band_inputs(cuda, (127, 15), B=2, nit=6)
    t, lc, Hp, r_l, nit, lp, s2, dims = inputs
    nxa, nxp = t["A"].shape[0], t["Apl"].shape[0]

    def c_plan(n, mc, pny, ny, nu):
        vals = dict(B=2, nit=nit, lp_iters=lp, s2_iters=s2, ny=ny, nu=nu,
                    nxa=nxa, nxp=nxp, pny=pny, n=n, mc=mc,
                    nmv=mc - 2 * pny - 1)
        d = (ctypes.c_int * len(K._BAND_DIMS))(*[vals[k]
                                                 for k in K._BAND_DIMS])
        b = ctypes.c_longlong()
        return lib.mpc_closed_sim_band_plan(d, ctypes.byref(b)), b.value, d

    for p_cap in (7, 15, 31, 48, 63, 127):
        for m_cap in (1, 2, 4, 7, 15):
            n, pny = 3 * m_cap + 1, 7 * p_cap
            mc = 12 * m_cap + 2 * pny + 1
            assert c_plan(n, mc, pny, 7, 3)[:2] == K.band_plan(
                n, mc, pny, 7, 3, nxa, nxp), (p_cap, m_cap)
    ref = K.closed_sim_band(*inputs)
    pny = t["SxF"].shape[0]
    for extra, fits in ((138, True), (139, False)):
        padded = _pad_pairs(inputs, extra)
        d = padded[-1]
        C, b = K.band_plan(d["n"], d["mc"], pny + extra, 7, 3, nxa, nxp)
        assert c_plan(d["n"], d["mc"], pny + extra, 7, 3)[:2] == (C, b)
        if fits:
            assert C == 4 and b > 226 * 1024
            for x, y in zip(K.closed_sim_band(*padded), ref):
                assert torch.equal(x, y)
        else:
            assert C == 0
            before = K.launch_counts()
            with pytest.raises(ValueError, match="shared memory"):
                K.closed_sim_band(*padded)
            assert K.launch_counts() == before
            dims_c = c_plan(d["n"], d["mc"], pny + extra, 7, 3)[2]
            ptrs = (ctypes.c_void_p * len(K._BAND_PTRS))()
            scal = (ctypes.c_double * 5)()
            stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
            assert lib.mpc_closed_sim_band(ptrs, dims_c, scal, stream) != 0


def test_closed_sim_band_refuses_float32(cuda):
    t, lc, Hp, r_l, *rest = _band_inputs(cuda, (32, 4))
    f32 = lambda d: {k: v.float() for k, v in d.items()}
    with pytest.raises(ValueError, match="float64 only"):
        K.closed_sim_band(f32(t), f32(lc), Hp.float(), r_l.float(), *rest)


def test_wrong_dtype_or_layout_raises(cuda):
    t, lc, Hp, r_l, dims = _inputs("pdip_sim", B=8)
    with pytest.raises(ValueError):
        K.closed_sim_pdip(t, lc, Hp.transpose(0, 1), r_l, r_l.shape[0], 5,
                          dims)
    with pytest.raises(ValueError):
        K.spd_factor(torch.eye(4, device=cuda, dtype=torch.float16)[None])


# ------------------------------------------------ the per-step engines' kernels

# single QP solves on identical inputs: max over lanes of |dz| and of
# |dlam| / max(1, |lam|) (ADMM: x and its duals y), at the max column of
# chip_smoke.py's QP_LIMITS; the first move at 1e-9 at float64
QP_MAX = {("pdip_fused", F64): (1.9e-9, 3.8e-4),
          ("admm_fused", F64): (6.0e-13, 4.2e-14),
          ("pdip_fused", torch.float32): (5.9e-2, 2.1),
          ("admm_fused", torch.float32): (3.4e-4, 8.7e-6)}


@pytest.mark.parametrize("dtype", [F64, torch.float32])
@pytest.mark.parametrize("B", FACTOR_B)
@pytest.mark.parametrize("n", FACTOR_N)
def test_lanes_kernels_match_plain(cuda, n, B, dtype):
    M, rhs = _spd_batch(cuda, B, n, dtype)
    M, rhs = M.permute(1, 2, 0).contiguous(), rhs.T.contiguous()
    before = K.launch_counts()
    L = K.factor_lanes(M)
    x = K.solve_lanes(L, rhs)
    after = K.launch_counts()
    assert after["factor_lanes"] == before["factor_lanes"] + 1
    assert after["solve_lanes"] == before["solve_lanes"] + 1
    Lp = K.factor_lanes_plain(M)
    xp = K.solve_lanes_plain(L, rhs)
    tol = 1e-10 if dtype == F64 else 1e-4
    assert float((L - Lp).abs().max()) <= tol * float(Lp.abs().max())
    assert float((x - xp).abs().max()) <= tol * float(xp.abs().max())


def _factor(layout, M):
    """The factor kernel of ``layout`` on a batch-major M (B, n, n), and
    its plain version, both returned batch-major."""
    if layout == "batch":
        return K.spd_factor(M), K.spd_factor_plain(M)
    Mt = M.permute(1, 2, 0).contiguous()
    return (K.factor_lanes(Mt).permute(2, 0, 1),
            K.factor_lanes_plain(Mt).permute(2, 0, 1))


@pytest.mark.parametrize("dtype", [F64, torch.float32])
@pytest.mark.parametrize("layout", ["batch", "lanes"])
@pytest.mark.parametrize("n", [17, 46])
def test_factor_block_invariance(cuda, n, layout, dtype):
    """The factor of a slice of a batch equals, bit for bit, the same
    matrices of the whole batch's factor, wherever the slice puts them in
    a block (a slice starting at matrix 5 also misaligns the batch-major
    16-byte loads)."""
    M, _ = _spd_batch(cuda, 37, n, dtype)
    L = _factor(layout, M)[0]
    for lo, hi in ((0, 37), (5, 18), (36, 37), (1, 4)):
        assert torch.equal(_factor(layout, M[lo:hi].contiguous())[0],
                           L[lo:hi]), (lo, hi)


@pytest.mark.parametrize("dtype", [F64, torch.float32])
@pytest.mark.parametrize("layout", ["batch", "lanes"])
@pytest.mark.parametrize("n", [5, 46])
def test_factor_failed_pivot_is_all_nan(cuda, n, layout, dtype):
    """An indefinite matrix inside a batch (last pivot at matrix 7, first
    at matrix 20) gives an all-NaN factor in its slot only, as the plain
    version's."""
    M, _ = _spd_batch(cuda, 37, n, dtype)
    M[7, n - 1, n - 1] = -1.0
    M[20, 0, 0] = -1.0
    L, Lp = _factor(layout, M)
    bad = torch.zeros(37, dtype=torch.bool, device=cuda)
    bad[[7, 20]] = True
    assert torch.isnan(L[bad]).all() and torch.isnan(Lp[bad]).all()
    assert torch.isfinite(L[~bad]).all()
    tol = 1e-10 if dtype == F64 else 1e-4
    assert float((L[~bad] - Lp[~bad]).abs().max()) <= tol * float(
        Lp[~bad].abs().max())


def test_factor_envelope_matches_the_launcher(cuda):
    """The C launcher takes n = 64, the envelope's edge (two rows a lane,
    over 48 KB of shared memory), and refuses n = 65 with an error and no
    launch, as factor_envelope does; both factor wrappers raise at 65
    without launching."""
    from mpc_tuning_tpu_torch.ops import _build

    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    for dtype in (torch.float32, torch.float64):
        for lanes in (0, 1):
            M = _spd_batch(cuda, 3, 64, dtype)[0]
            if lanes:
                M = M.permute(1, 2, 0).contiguous()
            L = torch.full_like(M, 7.0)
            assert lib.mpc_spd_factor(int(dtype == F64), lanes, M.data_ptr(),
                                      L.data_ptr(), 3, 64, stream) == 0
            Lp = (K.factor_lanes_plain if lanes else K.spd_factor_plain)(M)
            tol = 1e-10 if dtype == F64 else 1e-4
            assert float((L - Lp).abs().max()) <= tol * float(
                Lp.abs().max())
            M = torch.eye(65, device=cuda, dtype=dtype).expand(3, 65, 65)
            L = torch.full_like(M, 7.0)
            assert lib.mpc_spd_factor(int(dtype == F64), lanes,
                                      M.contiguous().data_ptr(), L.data_ptr(),
                                      3, 65, stream) != 0
            torch.cuda.synchronize()
            assert bool((L == 7.0).all())
        K.factor_envelope(64, dtype)
        with pytest.raises(ValueError, match="SPD factor kernels"):
            K.factor_envelope(65, dtype)
        before = K.launch_counts()
        M = torch.eye(65, device=cuda, dtype=dtype).expand(3, 65, 65)
        with pytest.raises(ValueError, match="SPD factor kernels"):
            K.spd_factor(M.contiguous())
        with pytest.raises(ValueError, match="SPD factor kernels"):
            K.factor_lanes(M.permute(1, 2, 0).contiguous())
        assert K.launch_counts() == before


# spd_factor_solve, one warp per system: n = 1, the tunes' sizes, 32 / 33
# (one row a lane full, then the first with two) and the edge, 64
SOLVE_N = [1, 5, 17, 31, 32, 33, 46, 64]


def _solve_tol(dtype, ref):
    """The tolerance of chip_smoke.py's SPD gates: 1e-10 absolute at
    float64, 1e-4 relative to max |x| at float32."""
    return 1e-10 if dtype == F64 else 1e-4 * float(ref.abs().max())


@pytest.mark.parametrize("dtype", [F64, torch.float32])
@pytest.mark.parametrize("B", [37, 1024])
@pytest.mark.parametrize("n", SOLVE_N)
def test_factor_solve_matches_plain_and_one_thread(cuda, n, B, dtype):
    """The warp kernel against the plain version and against the
    one-thread design it replaced (its forward pass has that design's
    order, its back pass not, so the two differ in the last digits)."""
    M, rhs = _spd_batch(cuda, B, n, dtype)
    L = K.spd_factor_plain(M)
    before = K.spd_factor_solve.launches
    x = K.spd_factor_solve(L, rhs)
    assert K.spd_factor_solve.launches == before + 1
    xp = K.spd_factor_solve_plain(L, rhs)
    xo = K.spd_factor_solve_one_thread(L, rhs)
    assert K.spd_factor_solve.launches == before + 1
    assert torch.isfinite(x).all()
    assert float((x - xp).abs().max()) <= _solve_tol(dtype, xp)
    assert float((x - xo).abs().max()) <= _solve_tol(dtype, xo)


@pytest.mark.parametrize("dtype", [F64, torch.float32])
@pytest.mark.parametrize("n", [17, 46])
def test_factor_solve_block_invariance(cuda, n, dtype):
    """A system's x is the same bits wherever a batch puts it in a block
    (W = 4 or 8 systems a block) and whatever the batch's size."""
    M, rhs = _spd_batch(cuda, 37, n, dtype)
    L = K.spd_factor_plain(M)
    x = K.spd_factor_solve(L, rhs)
    for lo, hi in ((0, 37), (5, 18), (36, 37), (1, 4)):
        assert torch.equal(K.spd_factor_solve(L[lo:hi].contiguous(),
                                              rhs[lo:hi].contiguous()),
                           x[lo:hi]), (lo, hi)


def test_factor_solve_refuses_above_the_envelope(cuda):
    """The C launcher takes n = 64 and refuses n = 65 with an error and no
    launch; the wrapper raises at 65 without launching."""
    from mpc_tuning_tpu_torch.ops import _build

    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    for dtype in (torch.float32, F64):
        M, rhs = _spd_batch(cuda, 3, 64, dtype)
        L = K.spd_factor_plain(M)
        x = torch.full_like(rhs, 7.0)
        assert lib.mpc_spd_factor_solve(int(dtype == F64), 0, L.data_ptr(),
                                        rhs.data_ptr(), x.data_ptr(), 3, 64,
                                        stream) == 0
        xp = K.spd_factor_solve_plain(L, rhs)
        assert float((x - xp).abs().max()) <= _solve_tol(dtype, xp)
        L = torch.eye(65, device=cuda, dtype=dtype).expand(3, 65, 65)
        L = L.contiguous()
        rhs = torch.ones((3, 65), device=cuda, dtype=dtype)
        x = torch.full_like(rhs, 7.0)
        assert lib.mpc_spd_factor_solve(int(dtype == F64), 0, L.data_ptr(),
                                        rhs.data_ptr(), x.data_ptr(), 3, 65,
                                        stream) != 0
        torch.cuda.synchronize()
        assert bool((x == 7.0).all())
        before = K.launch_counts()
        with pytest.raises(ValueError, match="spd_factor_solve: n = 65"):
            K.spd_factor_solve(L, rhs)
        assert K.launch_counts() == before


def _step_qp(engine, dtype, take=25, caps=(32, 4), B=64):
    """The single-solve kernel's arguments at step `take` of a Shell3x3
    loop through ``engine`` (a real step's QPs and warm start)."""
    t, lc, Hm, r_l, dims = _inputs(engine, B=B, nit=take + 1, caps=caps,
                                   case=shell3x3, dtype=dtype)
    G = K.g_shared(t["G0"], t.get("T2T"))
    kernel = K.admm_fused if engine == "admm_fused" else K.pdip_fused
    seen = {}

    def qp(*args):
        seen["args"] = args
        return kernel(*args)

    if engine == "admm_fused":
        step = K.admm_step(t, lc, Hm, dims, G, 40, mpc_loop.ADMM_SIGMA,
                           mpc_loop.ADMM_OVER_RELAX, qp)
    else:
        step = K.pdip_step(t, lc, Hm, dims, G, 15, qp)
    K.step_loop(t, lc, r_l, dims, *step)
    return seen["args"]


@pytest.mark.parametrize("dtype", [F64, torch.float32])
@pytest.mark.parametrize("engine,name,dual", [
    ("pdip_ws_fused", "pdip_fused", 1), ("admm_fused", "admm_fused", 2)])
def test_single_solve_kernels_match_plain(cuda, engine, name, dual, dtype):
    args = _step_qp(engine, dtype)
    before = getattr(K, name).launches
    out_k = getattr(K, name)(*args)
    assert getattr(K, name).launches == before + 1
    out_p = getattr(K, name + "_plain")(*args)
    nu = 3
    scale = 1.0 if name == "pdip_fused" else args[4][:nu]  # ADMM: x scaled
    du = float(((out_k[0][:nu] - out_p[0][:nu]) * scale).abs().max())
    dz = float((out_k[0] - out_p[0]).abs().max())
    dl = float(((out_k[dual] - out_p[dual]).abs()
                / out_p[dual].abs().clamp_min(1.0)).max())
    lim = QP_MAX[(name, dtype)]
    assert dz <= lim[0] and dl <= lim[1], (dz, dl)
    assert dtype != F64 or du <= 1e-9, du


@pytest.mark.parametrize("dtype", [F64, torch.float32])
@pytest.mark.parametrize("caps,B", [((32, 4), 37), ((127, 15), 64)])
def test_admm_fused_bits_equal_the_one_thread_design(cuda, caps, B, dtype):
    """The warp-per-lane admm_fused and the one-thread design it replaced
    (ops/csrc/reference/admm_fused_one_thread.cu) give the same bits in
    every element of the new state, on a real Shell3x3 step's QPs."""
    args = _step_qp("admm_fused", dtype, caps=caps, B=B)
    out = K.admm_fused(*args)
    ref = K.admm_fused_one_thread(*args)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_admm_fused_envelope_matches_the_launcher(cuda):
    """At Shell3x3's n = 46 the largest admitted mc (3045: the step's 181
    rows and 2864 zero rows more) runs, and gives the unpadded solve's bits
    on the first 181 rows; one row more, the wrapper raises without
    launching and the C launcher refuses."""
    from mpc_tuning_tpu_torch.ops import _build

    Minv, fs, hs, arow, acol, par, state, G, *rest = _step_qp(
        "admm_fused", F64, caps=(127, 15), B=4)
    mc, n = G["G0"].shape
    ref = K.admm_fused(Minv, fs, hs, arow, acol, par, state, G, *rest)

    def padded(extra):
        B = fs.shape[1]
        rows = lambda x, v: torch.cat([x, x.new_full((extra, B), v)])
        G0 = torch.cat([G["G0"], G["G0"].new_zeros((extra, n))])
        return (Minv, fs, rows(hs, 1.0), rows(arow, 1.0), acol, par,
                (state[0], rows(state[1], 0.0), rows(state[2], 0.0)),
                K.g_shared(G0), *rest)

    edge = 3045
    assert K.admm_fused_envelope(F64, n, edge)[1] <= K.FACTOR_SMEM_MAX
    out = K.admm_fused(*padded(edge - mc))
    assert torch.equal(out[0], ref[0])
    for a, b in zip(out[1:], ref[1:]):
        assert torch.equal(a[:mc], b)
    before = K.launch_counts()
    with pytest.raises(ValueError, match="admm_fused"):
        K.admm_fused(*padded(edge + 1 - mc))
    assert K.launch_counts() == before
    lib = _build.library()
    ptrs = (ctypes.c_void_p * len(K._ADMM_PTRS))()
    dims = (ctypes.c_int * 4)(4, n, edge + 1, 40)
    scal = (ctypes.c_double * 2)(1e-6, 1.6)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    assert lib.mpc_admm_fused(1, ptrs, dims, scal, stream) != 0


@pytest.mark.parametrize("caps,B", [((32, 4), 64), ((127, 15), 37)])
def test_pdip_ws_fused_follows_pdip_sim(cuda, caps, B):
    """The per-step engine and the whole-sim kernel run the same warp PDIP
    (at (127, 15) n = 46, two rows a lane): stepping on the whole-sim
    kernel's U, the per-step engine's own U and Y agree with it step by
    step at float64."""
    t, lc, Hp, r_l, dims = _inputs("pdip_ws_fused", B=B, nit=80, caps=caps,
                                   case=shell3x3)
    Y, U = K.closed_sim_pdip(t, lc, Hp, r_l, r_l.shape[0], 15, dims)
    G = K.g_shared(t["G0"], t["T2T"])
    solve, warm = K.pdip_step(t, lc, Hp, dims, G, 15, K.pdip_fused)
    before = K.pdip_fused.launches
    Ys, Us = K.step_loop(t, lc, r_l, dims, solve, warm, u_follow=U)
    assert K.pdip_fused.launches == before + r_l.shape[0]
    torch.testing.assert_close(Ys, Y, rtol=0, atol=1e-9)
    torch.testing.assert_close(Us, U, rtol=0, atol=1e-9)


def _qp_lanes(args, lo, hi):
    """A single solve's arguments (lane-major, the batch last) of lanes
    lo ... hi - 1 alone."""
    cut = lambda x: x[..., lo:hi].contiguous()
    return tuple(cut(a) if isinstance(a, torch.Tensor)
                 else tuple(map(cut, a)) if isinstance(a, tuple) else a
                 for a in args)


def _pdip_errors(out, ref):
    """max |dz|, max |dlam| / max(1, |lam|), max |ds| / max(1, |s|), max
    |d first move| of two single PDIP solves."""
    rel = lambda a, b: float(((a - b).abs() / b.abs().clamp_min(1.0)).max())
    return (float((out[0] - ref[0]).abs().max()), rel(out[1], ref[1]),
            rel(out[2], ref[2]), float((out[0][:3] - ref[0][:3]).abs().max()))


@pytest.mark.parametrize("dtype", [F64, torch.float32])
@pytest.mark.parametrize("caps,B", [((32, 4), 37), ((32, 4), 64),
                                    ((127, 15), 37), ((127, 15), 64)])
def test_pdip_fused_matches_plain_and_one_thread(cuda, caps, B, dtype):
    """The warp-per-lane pdip_fused against its plain version and against
    the one-thread design it replaced, on a real Shell3x3 step's QPs: z
    and the duals at QP_MAX, the best iterate's slacks as the duals, the
    first move at 1e-9 at float64 (the one-thread design rounds its
    reductions and back substitution otherwise)."""
    args = _step_qp("pdip_ws_fused", dtype, caps=caps, B=B)
    before = K.pdip_fused.launches
    out = K.pdip_fused(*args)
    assert K.pdip_fused.launches == before + 1
    assert all(torch.isfinite(x).all() for x in out)
    lim = QP_MAX[("pdip_fused", dtype)]
    for ref in (K.pdip_fused_plain(*args), K.pdip_fused_one_thread(*args)):
        dz, dl, ds, du = _pdip_errors(out, ref)
        assert dz <= lim[0] and dl <= lim[1] and ds <= lim[1], (dz, dl, ds)
        assert dtype != F64 or du <= 1e-9, du
    assert K.pdip_fused.launches == before + 1


@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_pdip_fused_does_not_depend_on_the_slot(cuda, dtype):
    """A lane's (z, lam, s) are the same bits wherever a batch puts it in
    a block (4 or 2 lanes a block) and whatever the batch's size."""
    args = _step_qp("pdip_ws_fused", dtype, caps=(127, 15), B=37)
    whole = K.pdip_fused(*args)
    for lo, hi in ((0, 37), (5, 18), (36, 37)):
        for a, b in zip(K.pdip_fused(*_qp_lanes(args, lo, hi)), whole):
            assert torch.equal(a, b[:, lo:hi]), (lo, hi)


@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_pdip_ws_lanes_does_not_depend_on_the_slot(cuda, dtype):
    """The 'pdip_ws_lanes' solve (torch ops around factor_lanes and
    solve_lanes, its sums by ops/qp.lane_sum) gives one lane's QP the same
    bits in every slot: lane 5 of a real step's batch copied to 37
    slots."""
    args = _step_qp("pdip_ws_fused", dtype, caps=(127, 15), B=37)
    wide = lambda x: x.expand(*x.shape[:-1], 37).contiguous()
    rep = tuple(wide(a) if isinstance(a, torch.Tensor)
                else tuple(map(wide, a)) if isinstance(a, tuple) else a
                for a in _qp_lanes(args, 5, 6))
    for x in mpc_loop._pdip_ws_lanes(*rep):
        assert torch.equal(x, x[:, :1].expand_as(x))


@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_pdip_ws_lanes_does_not_depend_on_the_width(cuda, dtype):
    """The 'pdip_ws_lanes' solve gives a lane the same bits in batches of
    2, 13 and 37 lanes of a real step's QPs (its row sums by the lane_sum
    kernel, which sums each lane's rows in one fixed order)."""
    args = _step_qp("pdip_ws_fused", dtype, caps=(127, 15), B=37)
    whole = mpc_loop._pdip_ws_lanes(*args)
    for lo, hi in ((5, 7), (5, 18), (0, 37)):
        for a, b in zip(mpc_loop._pdip_ws_lanes(*_qp_lanes(args, lo, hi)),
                        whole):
            assert torch.equal(a, b[:, lo:hi]), (lo, hi)


@pytest.mark.parametrize("dtype", [F64, torch.float32])
@pytest.mark.parametrize("layout", ["lanes", "rows", "strided"])
@pytest.mark.parametrize("rows,B", [(181, 1024), (181, 37), (1959, 256),
                                    (1, 5), (0, 3)])
def test_lane_sum_kernel_matches_plain(cuda, rows, B, layout, dtype):
    """The lane_sum kernel against its plain version (the same sums on the
    CPU, in another order): within rows ulps of the sum of |x| on every
    lane, in each layout (lanes contiguous, each lane's rows contiguous,
    every other lane of a wider tensor), one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(rows + B)
    x = torch.randn((rows, 2 * B if layout == "strided" else B),
                    generator=g, device=cuda, dtype=dtype)
    if layout == "rows":
        x = x.T.contiguous().T
    elif layout == "strided":
        x = x[:, ::2]
    before = K.lane_sum.launches
    s = K.lane_sum(x)
    assert K.lane_sum.launches == before + 1
    assert s.shape == (1, B) and s.dtype == dtype and s.device == x.device
    ref = K.lane_sum_plain(x.cpu())
    tol = max(rows, 1) * torch.finfo(dtype).eps * x.abs().sum(0).cpu()
    assert bool(((s.cpu() - ref).abs() <= tol).all())


@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_lane_sum_on_the_card(cuda, dtype):
    """ops/qp.lane_sum on the card: lanes holding one column read one sum
    in both layouts; a lane's bits follow neither the batch's width (1, 2,
    13, 37, 64, 1024 lanes) nor its slot (a permuted batch) nor the
    layout of the lane-major tensor (a strided view of it), in both
    layouts."""
    from mpc_tuning_tpu_torch.ops.qp import lane_sum

    g = torch.Generator(device=cuda).manual_seed(5)
    v = torch.randn((181, 1), generator=g, device=cuda, dtype=dtype)
    for batch_major in (False, True):
        x = v.expand(181, 57)
        x = x.T.contiguous().T if batch_major else x.contiguous()
        s = lane_sum(x, batch_major)
        assert torch.equal(s, s[:, :1].expand_as(s)), batch_major
    x = torch.randn((181, 1024), generator=g, device=cuda, dtype=dtype)
    perm = torch.randperm(1024, generator=torch.Generator().manual_seed(6))
    for batch_major in (False, True):
        lay = (lambda t: t.T.contiguous().T) if batch_major else (
            lambda t: t.contiguous())
        whole = lane_sum(lay(x), batch_major)
        for lo, hi in ((5, 6), (5, 7), (5, 18), (0, 37), (0, 64), (0, 1024),
                       (987, 1024)):
            assert torch.equal(lane_sum(lay(x[:, lo:hi]), batch_major),
                               whole[:, lo:hi]), (batch_major, lo, hi)
        assert torch.equal(lane_sum(lay(x[:, perm]), batch_major),
                           whole[:, perm]), batch_major
    wide = torch.randn((181, 2048), generator=g, device=cuda, dtype=dtype)
    assert torch.equal(lane_sum(wide[:, ::2]),
                       lane_sum(wide[:, ::2].contiguous()))


@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_lane_sum_plain_on_the_card(cuda, dtype):
    """The plain version's row sum on the card (elementwise adds in the
    warp-per-lane kernels' order) launches no kernel and gives the CPU's
    elementwise adds' bits, whatever the batch's width, a lane's slot or
    the layout."""
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((181, 1024), generator=g, device=cuda, dtype=dtype)
    before = K.launch_counts()
    s = K.lane_sum_plain(x)
    assert K.launch_counts() == before
    assert torch.equal(s.cpu(), K.warp_order_sum(x.cpu()))
    perm = torch.randperm(1024, generator=torch.Generator().manual_seed(8))
    for lo, hi in ((5, 6), (5, 18), (0, 37), (987, 1024)):
        assert torch.equal(K.lane_sum_plain(x[:, lo:hi]), s[:, lo:hi])
    assert torch.equal(K.lane_sum_plain(x[:, perm]), s[:, perm])
    assert torch.equal(K.lane_sum_plain(x.T.contiguous().T), s)


@pytest.mark.parametrize("name", ["pdip_fused", "closed_sim_pdip",
                                  "closed_sim_band"])
def test_plain_versions_launch_no_kernel(cuda, name):
    """The plain versions of the PDIP kernels run on the card in plain
    torch: their row sums are lane_sum_plain's, not the lane_sum
    kernel's, so no wrapper counts a launch."""
    if name == "closed_sim_band":
        *args, dims = _band_inputs(cuda, (32, 4), nit=4)
        kw = dict(dims=dims)
    elif name == "closed_sim_pdip":
        t, lc, Hp, r_l, dims = _inputs("pdip_sim", B=3, nit=4)
        args, kw = (t, lc, Hp, r_l, 4, 15), dict(dims=dims)
    else:
        args, kw = _step_qp("pdip_ws_fused", F64, take=3, B=3), {}
    before = K.launch_counts()
    out = getattr(K, name + "_plain")(*args, **kw)
    assert K.launch_counts() == before
    assert all(bool(torch.isfinite(x).all()) for x in out)


def test_pdip_fused_envelope_matches_the_launcher(cuda):
    """At Shell3x3's n = 46 the largest admitted mc (902: the step's 181
    rows and 721 zero rows more) runs, and gives the unpadded solve's bits
    on the first 181 rows (zero rows add exact zeros to every sum); one
    row more, or n = 65, the wrapper raises without launching and the C
    launcher refuses."""
    from mpc_tuning_tpu_torch.ops import _build

    Hp, f, h, rmask, cmask, warm, G, iters = _step_qp(
        "pdip_ws_fused", F64, caps=(127, 15), B=4)
    mc, n = G["G0"].shape
    ref = K.pdip_fused(Hp, f, h, rmask, cmask, warm, G, iters)

    def padded(extra):
        B = f.shape[1]
        rows = lambda x, v: torch.cat([x, x.new_full((extra, B), v)])
        G0 = torch.cat([G["G0"], G["G0"].new_zeros((extra, n))])
        T2T = torch.cat([G["T2T"], G["T2T"].new_zeros((n * n, extra))], 1)
        return (Hp, f, rows(h, 1.0), rows(rmask, 0.0), cmask,
                (warm[0], rows(warm[1], 1.0)), K.g_shared(G0, T2T), iters)

    edge = 902
    assert K.pdip_fused_envelope(F64, n, edge)[1] <= K.FACTOR_SMEM_MAX
    out = K.pdip_fused(*padded(edge - mc))
    assert torch.equal(out[0], ref[0])
    for a, b in zip(out[1:], ref[1:]):
        assert torch.equal(a[:mc], b)
    before = K.launch_counts()
    with pytest.raises(ValueError, match="pdip_fused kernel"):
        K.pdip_fused(*padded(edge + 1 - mc))
    assert K.launch_counts() == before
    lib = _build.library()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    scal = (ctypes.c_double * 3)(1e-4, 1e-9, 1e13)
    for dims in ((4, n, edge + 1, 15), (4, 65, mc, 15)):
        ptrs = (ctypes.c_void_p * len(K._PDIP_PTRS))()
        assert lib.mpc_pdip_fused(1, ptrs, (ctypes.c_int * 4)(*dims), scal,
                                  stream) != 0


# solve_lanes, one warp per system: the bits of spd_factor_solve on the same
# systems in the batch-major layout
@pytest.mark.parametrize("dtype", [F64, torch.float32])
@pytest.mark.parametrize("B", [37, 1024])
@pytest.mark.parametrize("n", SOLVE_N)
def test_solve_lanes_bits_equal_spd_factor_solve(cuda, n, B, dtype):
    M, rhs = _spd_batch(cuda, B, n, dtype)
    L = K.spd_factor_plain(M)
    before = K.solve_lanes.launches
    x = K.solve_lanes(L.permute(1, 2, 0).contiguous(), rhs.T.contiguous())
    assert K.solve_lanes.launches == before + 1
    assert torch.equal(x.T, K.spd_factor_solve(L, rhs))
    xo = K.solve_lanes_one_thread(L.permute(1, 2, 0).contiguous(),
                                  rhs.T.contiguous())
    assert K.solve_lanes.launches == before + 1
    assert float((x - xo).abs().max()) <= _solve_tol(dtype, xo)


@pytest.mark.parametrize("dtype", [F64, torch.float32])
@pytest.mark.parametrize("n", [17, 46])
def test_solve_lanes_block_invariance(cuda, n, dtype):
    """A system's x is the same bits wherever a batch puts it in a block
    and whatever the batch's size."""
    M, rhs = _spd_batch(cuda, 37, n, dtype)
    L = K.spd_factor_plain(M).permute(1, 2, 0).contiguous()
    rhs = rhs.T.contiguous()
    x = K.solve_lanes(L, rhs)
    for lo, hi in ((0, 37), (5, 18), (36, 37), (1, 4)):
        assert torch.equal(K.solve_lanes(L[..., lo:hi].contiguous(),
                                         rhs[:, lo:hi].contiguous()),
                           x[:, lo:hi]), (lo, hi)


def test_solve_lanes_refuses_above_the_envelope(cuda):
    """The C launcher takes n = 64 lane-major and refuses n = 65 with an
    error and no launch; the wrapper raises at 65 without launching."""
    from mpc_tuning_tpu_torch.ops import _build

    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    for dtype in (torch.float32, F64):
        M, rhs = _spd_batch(cuda, 3, 64, dtype)
        L = K.spd_factor_plain(M).permute(1, 2, 0).contiguous()
        rhs = rhs.T.contiguous()
        x = torch.full_like(rhs, 7.0)
        assert lib.mpc_spd_factor_solve(int(dtype == F64), 1, L.data_ptr(),
                                        rhs.data_ptr(), x.data_ptr(), 3, 64,
                                        stream) == 0
        assert torch.equal(x, K.solve_lanes(L, rhs))
        L = torch.eye(65, device=cuda, dtype=dtype)[:, :, None].expand(
            65, 65, 3).contiguous()
        rhs = torch.ones((65, 3), device=cuda, dtype=dtype)
        x = torch.full_like(rhs, 7.0)
        assert lib.mpc_spd_factor_solve(int(dtype == F64), 1, L.data_ptr(),
                                        rhs.data_ptr(), x.data_ptr(), 3, 65,
                                        stream) != 0
        torch.cuda.synchronize()
        assert bool((x == 7.0).all())
        before = K.launch_counts()
        with pytest.raises(ValueError, match="solve_lanes: n = 65"):
            K.solve_lanes(L, rhs)
        assert K.launch_counts() == before


# ------------------------------------------------- a lane's F and its slot

# (N, max Nu) per candidate of float32 Shell3x3 VNS batches: one candidate
# in every slot of a neighbourhood-sized batch (19 candidates, 57 lanes, at
# the widest bucket), and mixes at the (32, 8) and (16, 4) buckets (n = 25,
# 13) with one candidate at five slots
SLOT_BATCHES = {"same (8, 7)": [(8, 7)] * 19,
                "bucket (32, 8)": [(20, 6), (32, 8), (9, 3), (20, 6), (20, 6),
                                   (17, 5), (12, 8), (20, 6), (31, 2),
                                   (20, 6)],
                "bucket (16, 4)": [(12, 3), (16, 4), (12, 3), (12, 3), (9, 2),
                                   (14, 4), (12, 3), (5, 3), (12, 3)]}


@pytest.mark.parametrize("batch", sorted(SLOT_BATCHES))
def test_vns_objective_of_repeated_candidates(cuda, batch):
    """Phase 3c's float32 Shell3x3 VNS objective ('admm_fused', 40
    iterations) on the card: every slot of one candidate reads the same
    closed-loop and open-loop bits and the same F."""
    from mpc_tuning_tpu_torch.tuning.objectives import vns_objective_batch

    problem, _ = build_problem(shell3x3.make_case(nit=120),
                               dtype=torch.float32, qp_iters=15,
                               device="cuda")
    problem.vns_qp_method = "admm_fused"
    problem.admm_iters = 40
    legs = {}
    for name in ("closed_batch", "open_batch"):
        fn = getattr(problem, name)

        def keep(*a, _fn=fn, _name=name, **kw):
            legs[_name] = _fn(*a, **kw)
            return legs[_name]
        setattr(problem, name, keep)
    pairs = SLOT_BATCHES[batch]
    N_b, Nu_b = (np.array(x) for x in zip(*pairs))
    F = vns_objective_batch(problem, N_b, Nu_b, [2.36, 0.43, 0.81],
                            [0.066, 0.25, 0.086])
    assert np.isfinite(F).all()
    slots = [i for i, p in enumerate(pairs) if p == pairs[0]]
    my = problem.my
    for Y, U in legs.values():
        for x in (Y, U):
            x = np.asarray(x).reshape(len(pairs), my, *np.shape(x)[1:])
            for i in slots[1:]:
                assert np.array_equal(x[i].view(np.int32),
                                      x[slots[0]].view(np.int32)), i
    assert len(set(F[slots].tolist())) == 1, F[slots]


# ------------------------------------------------- spd_solve and the NMPC path


@pytest.mark.parametrize("n", [5, 17, 31])
def test_spd_solve_matches_plain(cuda, n):
    g = torch.Generator(device=cuda).manual_seed(n)
    A = torch.randn((300, n, n), generator=g, device=cuda, dtype=F64)
    M = A @ A.transpose(1, 2) + n * torch.eye(n, device=cuda, dtype=F64)
    M[7, n - 1, n - 1] = -1.0  # a failed factor: all NaN, as the plain one
    rhs = torch.randn((300, n), generator=g, device=cuda, dtype=F64)
    before = K.spd_solve.launches
    x = K.spd_solve(M, rhs)
    assert K.spd_solve.launches == before + 1
    xp = K.spd_solve_plain(M, rhs)
    assert torch.isnan(x[7]).all() and torch.isnan(xp[7]).all()
    ok = torch.arange(300, device=cuda) != 7
    torch.testing.assert_close(x[ok], xp[ok], rtol=0, atol=1e-10)


@pytest.mark.parametrize("dtype", [F64, torch.float32])
@pytest.mark.parametrize("B", FACTOR_B)
@pytest.mark.parametrize("n", FACTOR_N + [32, 33])
def test_spd_solve_is_factor_then_solve_bit_for_bit(cuda, n, B, dtype):
    """One launch, one warp per system: x is the bits of spd_factor then
    spd_factor_solve on the same systems, a failed factor's x all NaN in
    both; beside it the one-thread design it replaced, within the SPD
    gate."""
    M, rhs = _spd_batch(cuda, B, n, dtype)
    M[B // 2, n - 1, n - 1] = -1.0
    before = K.spd_solve.launches
    x = K.spd_solve(M, rhs)
    assert K.spd_solve.launches == before + 1
    xs = K.spd_factor_solve(K.spd_factor(M), rhs)
    assert torch.isnan(x[B // 2]).all()
    assert torch.equal(x.view(torch.int8), xs.view(torch.int8))
    xo = K.spd_solve_one_thread(M, rhs)
    ok = torch.arange(B, device=cuda) != B // 2
    assert torch.isnan(xo[B // 2]).all()
    if B > 1:
        assert float((x[ok] - xo[ok]).abs().max()) <= _solve_tol(dtype,
                                                                xo[ok])


@pytest.mark.parametrize("dtype", [F64, torch.float32])
@pytest.mark.parametrize("n", [5, 33, 64])
def test_spd_solve_reads_the_lower_triangle_only(cuda, n, dtype):
    """x depends on M's lower triangle only (the factor reads no other
    part): NaN above the diagonal leaves x's bits as they are."""
    M, rhs = _spd_batch(cuda, 37, n, dtype)
    junk = M + torch.triu(torch.full((n, n), float("nan"), device=cuda,
                                     dtype=dtype), 1)
    x = K.spd_solve(M, rhs)
    assert torch.equal(x.view(torch.int8), K.spd_solve(junk, rhs).view(
        torch.int8))


def test_spd_solve_refuses_above_the_envelope(cuda):
    """The C launcher takes n = 64 and refuses n = 65 with an error and no
    launch; the wrapper raises at 65 without launching."""
    from mpc_tuning_tpu_torch.ops import _build

    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    for dtype in (torch.float32, F64):
        M, rhs = _spd_batch(cuda, 3, 64, dtype)
        x = torch.full_like(rhs, 7.0)
        assert lib.mpc_spd_solve(int(dtype == F64), M.data_ptr(),
                                 rhs.data_ptr(), x.data_ptr(), 3, 64,
                                 stream) == 0
        assert float((x - K.spd_solve_plain(M, rhs)).abs().max()) <= \
            _solve_tol(dtype, x)
        M = torch.eye(65, device=cuda, dtype=dtype).expand(3, 65, 65)
        M = M.contiguous()
        rhs = torch.ones((3, 65), device=cuda, dtype=dtype)
        x = torch.full_like(rhs, 7.0)
        assert lib.mpc_spd_solve(int(dtype == F64), M.data_ptr(),
                                 rhs.data_ptr(), x.data_ptr(), 3, 65,
                                 stream) != 0
        torch.cuda.synchronize()
        assert bool((x == 7.0).all())
        before = K.launch_counts()
        with pytest.raises(ValueError, match="spd_solve: n = 65"):
            K.spd_solve(M, rhs)
        assert K.launch_counts() == before


# --------------------------------------- the batch-major scan engines


def _scan_batch(B=37, nit=40, seed=3):
    """A Shell3x3 problem on the card and B seeded candidates at its (32, 4)
    bucket, as closed_batch's arguments (a batch index picks lanes)."""
    problem, _ = build_problem(shell3x3.make_case(nit=nit), device="cuda")
    rng = np.random.default_rng(seed)
    cand = (rng.integers(5, 33, size=B), rng.integers(1, 5, size=B),
            rng.uniform(0.2, 2.0, (B, 3)), rng.uniform(0.01, 0.5, (B, 3)))
    r_b = np.broadcast_to(problem.r[:nit], (B, nit, 3))

    def run(engine, idx):
        iters = 40 if engine == "admm" else 15
        return problem.loop.closed_batch(
            r_b[idx], problem.v, *(x[idx] for x in cand), nit, F64, iters,
            engine=engine, device="cuda", caps=(32, 4))

    return run


@pytest.mark.parametrize("engine", mpc_loop.BATCH_MAJOR_ENGINES)
def test_scan_engine_lanes_do_not_depend_on_the_slot(cuda, engine):
    """'pdip', 'pdip_ws', 'pdip_dense' and 'admm' on the card (float64,
    nit 40, B = 37): a lane's Y and U are the same bits wherever a
    permutation of the batch puts it; the PDIP engines launch spd_factor
    once and spd_factor_solve twice per iteration, 'admm' no kernel."""
    run = _scan_batch()
    K.reset_launches()
    Y, U = run(engine, np.arange(37))
    counts = K.launch_counts()
    pdip = engine != "admm"
    assert counts.pop("spd_factor") == (40 * 15 if pdip else 0)
    assert counts.pop("spd_factor_solve") == (2 * 40 * 15 if pdip else 0)
    assert set(counts.values()) == {0}
    assert Y.device.type == "cuda" and torch.isfinite(U).all()
    perm = np.random.default_rng(4).permutation(37)
    Yp, Up = run(engine, perm)
    assert torch.equal(Yp, Y[perm]) and torch.equal(Up, U[perm])


@pytest.mark.parametrize("engine", mpc_loop.BATCH_MAJOR_ENGINES)
def test_scan_engine_batch_size_moves_a_lane_by_rounding(cuda, engine):
    """The same lanes in batches of 1, 2 and 13 read the same bits as in
    the batch of 37: on the card the batch-major engines run padded to a
    multiple of ops/qp.CARD_LANES lanes, their products in chunks of
    CARD_LANES (torch's products round a lane by the batch's width: a
    width-1 product takes cuBLAS's matrix-vector path, and the batched
    products follow the batch count)."""
    run = _scan_batch()
    idx = np.arange(37)
    Y, U = run(engine, idx)
    for lo, hi in ((5, 6), (5, 7), (5, 18)):
        Ys, Us = run(engine, idx[lo:hi])
        assert torch.equal(Ys, Y[lo:hi]) and torch.equal(Us, U[lo:hi]), \
            (lo, hi)


# ------------------------------------------------------------ DTC-GPC


@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_dtc_lanes_do_not_depend_on_the_batch(cuda, dtype):
    """The Wood-Berry DTC-GPC loop on the card (nit 120): one scenario in
    every lane of batches of 1, 8 and 37 reads the same bits in every
    lane, and lane 0 follows the replay oracle (1e-8 at float64)."""
    from mpc_tuning_tpu_torch.ops import condmin as cm
    from mpc_tuning_tpu_torch.sim.gpc_loop import DTCGPC

    plant = plants.wood_berry()
    L, R, _ = cm.condmin(plant.G.dcgain())
    ctl = DTCGPC.build(plant=plant.G, model=plant.G, Ts=1.0,
                       p=np.array([3, 3]), m=np.array([3, 3]),
                       delta=np.ones(2), lam=np.ones(2), L=L, R=R, n_md=1,
                       disturbance=plant.D)
    nit = 120
    r = np.zeros((nit, 2))
    r[10:, 0], r[60:, 1] = 0.8, 0.5
    q = np.zeros((nit, 1))
    q[100:, 0] = -0.25
    out = {B: ctl.simulate_scan_batch(np.broadcast_to(r, (B, nit, 2)),
                                      np.broadcast_to(q, (B, nit, 1)), nit,
                                      dtype=dtype, device=cuda)
           for B in (1, 8, 37)}
    for B, (Y, U) in out.items():
        assert Y.device.type == "cuda"
        for x, x1 in ((Y, out[1][0]), (U, out[1][1])):
            assert torch.equal(x, x1.expand_as(x)), B
    if dtype == F64:
        y_ref, u_ref = ctl.simulate_ref(r, q, nit)
        np.testing.assert_allclose(out[1][0][0].cpu().numpy(), y_ref,
                                   atol=1e-8)
        np.testing.assert_allclose(out[1][1][0].cpu().numpy(), u_ref,
                                   atol=1e-8)


def _vdv_rollout_args(caps, B=64, seed=0, integrator="rk4"):
    """Seeded Van de Vusse states, previous inputs and moves around the
    operating point, on the card."""
    spec = vandevusse.make_case(integrator=integrator).spec
    spec = dataclasses.replace(spec, p_max=caps[0], m_max=caps[1])
    rng = np.random.default_rng(seed)
    x = spec.x0 + rng.uniform([-0.5, -0.2, -5.0], [0.5, 0.2, 5.0], (B, 3))
    up = spec.u0 + rng.uniform(-5.0, 5.0, (B, 2))
    du = rng.uniform(-2.0, 2.0, (B, caps[1] * 2))
    Nu = rng.integers(1, caps[1] + 1, size=B)
    cm = (np.arange(caps[1])[None] < Nu[:, None]).astype(float)
    t = lambda a: torch.tensor(a, dtype=F64, device="cuda")
    return spec, t(x), t(up), t(du), t(cm), Nu


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("integrator", ["rk4", "tr_bdf2"])
@pytest.mark.parametrize("caps", [(31, 15), (16, 2)])
def test_nmpc_rollout_matches_plain(cuda, caps, integrator):
    """Yf and J, the plant step (m = 0) and the held playback against the
    plain version at float64 (1e-10 relative), with either integrator;
    each call one launch."""
    spec, x, up, du, cm, Nu = _vdv_rollout_args(caps, integrator=integrator)
    before = K.nmpc_rollout.launches
    Yk, Jk = K.nmpc_rollout(spec, x, up, du, cm, caps[0], jac=True)
    assert K.nmpc_rollout.launches == before + 1
    Yp, Jp = nmpc_rollout_plain(spec, x, up, du, cm, caps[0], jac=True)
    assert _rel(Yk, Yp) <= 1e-10 and _rel(Jk, Jp) <= 1e-10
    none = torch.zeros((x.shape[0], 0), dtype=F64, device=cuda)
    args = (spec, x, up, none, none, 1)
    assert _rel(K.nmpc_rollout(*args, outputs=range(3))[0],
                nmpc_rollout_plain(*args, outputs=range(3))[0]) <= 1e-10
    hold = torch.tensor(np.maximum(Nu - 1, 0), dtype=torch.int32,
                        device=cuda)
    args = (spec, x, up, du, cm, 59)
    assert _rel(K.nmpc_rollout(*args, hold=hold)[0],
                nmpc_rollout_plain(*args, hold=hold)[0]) <= 1e-10
    assert K.nmpc_rollout.launches == before + 3


def test_nmpc_rollout_refuses_models_without_a_kernel(cuda):
    """Another rhs and an unknown integrator raise before any launch."""
    spec, x, up, du, cm, _ = _vdv_rollout_args((16, 2), B=4)
    before = K.nmpc_rollout.launches
    for bad, match in ((dataclasses.replace(spec, rhs=lambda a, b: -a),
                        "device='cpu'"),
                       (dataclasses.replace(spec, integrator="euler"),
                        "unknown integrator")):
        with pytest.raises(ValueError, match=match):
            K.nmpc_rollout(bad, x, up, du, cm, 16, jac=True)
    assert K.nmpc_rollout.launches == before


def _column_args(caps, B, seed, integrator, substeps=None):
    """``_vdv_rollout_args`` with a mask per column: each candidate's own
    control horizon per input (the explicit NMPC's per-input Nu)."""
    spec, x, up, du, _, _ = _vdv_rollout_args(caps, B, seed, integrator)
    if substeps is not None:
        spec = dataclasses.replace(spec, substeps=substeps)
    rng = np.random.default_rng(seed + 1)
    Nu = rng.integers(1, caps[1] + 1, size=(B, 2))
    cm = (np.arange(caps[1])[None, :, None] < Nu[:, None, :]).astype(float)
    return spec, x, up, du, torch.tensor(cm.reshape(B, -1), dtype=F64,
                                         device="cuda")


@pytest.mark.parametrize("integrator", ["rk4", "tr_bdf2"])
@pytest.mark.parametrize("B", [1, 7, 64, 256])
def test_nmpc_rollout_column_mask_matches_plain(cuda, B, integrator):
    """The producer-and-consumers kernel with a mask per column (per-input
    control horizons) against the plain version at float64 (1e-10
    relative): at the explicit NMPC's shape (p 5, m 2, 6 substeps) and at
    (16, 4); a block a candidate, so B = 1, 7, 64 and 256 are one to
    256 blocks."""
    for caps, substeps in (((5, 2), 6), ((16, 4), None)):
        spec, x, up, du, cm = _column_args(caps, B, B, integrator, substeps)
        Yk, Jk = K.nmpc_rollout(spec, x, up, du, cm, caps[0], jac=True)
        Yp, Jp = nmpc_rollout_plain(spec, x, up, du, cm, caps[0], jac=True)
        assert _rel(Yk, Yp) <= 1e-10 and _rel(Jk, Jp) <= 1e-10, caps
        off = cm[:, None, :].expand_as(Jk) == 0
        assert (Jk[off] == 0).all()


@pytest.mark.parametrize("integrator", ["rk4", "tr_bdf2"])
def test_nmpc_rollout_lane_bits_follow_neither_batch_nor_slot(cuda,
                                                              integrator):
    """A candidate's Y and J are the same bits alone, in a batch of 64 and
    at another slot of it (the batch reversed)."""
    spec, x, up, du, cm = _column_args((16, 4), 64, 3, integrator)
    Y, J = K.nmpc_rollout(spec, x, up, du, cm, 16, jac=True)
    flip = lambda t: t.flip(0).contiguous()
    Yr, Jr = K.nmpc_rollout(spec, *map(flip, (x, up, du, cm)), 16, jac=True)
    assert torch.equal(Yr.flip(0), Y) and torch.equal(Jr.flip(0), J)
    for b in (0, 17, 63):
        one = lambda t: t[b:b + 1].contiguous()
        Y1, J1 = K.nmpc_rollout(spec, *map(one, (x, up, du, cm)), 16,
                                jac=True)
        assert torch.equal(Y1[0], Y[b]) and torch.equal(J1[0], J[b])


@pytest.mark.parametrize("integrator", ["rk4", "tr_bdf2"])
def test_nmpc_rollout_against_the_thread_per_column_design(cuda,
                                                           integrator):
    """The kernel against the design it replaced
    (ops/csrc/reference/nmpc_rollout_thread_per_column.cu) on the same
    inputs at float64, Y and J within 1e-13 relative, with J and without
    (the primal alone).  The two designs step Newton with different solves
    (the adjugate, the pivoted LU) and RK4's tangent stages fuse otherwise,
    so bit equality, seen on the inputs measured, is not promised."""
    for caps in ((31, 15), (5, 2)):
        spec, x, up, du, cm = _column_args(caps, 64, 11, integrator)
        Yk, Jk = K.nmpc_rollout(spec, x, up, du, cm, caps[0], jac=True)
        Yo, Jo = K.nmpc_rollout_thread_per_column(spec, x, up, du, cm,
                                                  caps[0], jac=True)
        assert _rel(Yk, Yo) <= 1e-13 and _rel(Jk, Jo) <= 1e-13, caps
        assert _rel(K.nmpc_rollout(spec, x, up, du, cm, caps[0])[0],
                    K.nmpc_rollout_thread_per_column(spec, x, up, du, cm,
                                                     caps[0])[0]) <= 1e-13


def _explicit_run(ctl, nit, device):
    from mpc_tuning_tpu_torch.cases import vandevusse_explicit as vex
    from mpc_tuning_tpu_torch.models.ode import (VDV_U0, VDV_X0,
                                                 newton_steady_state,
                                                 vandevusse_rhs)

    x0 = newton_steady_state(vandevusse_rhs, VDV_X0, VDV_U0)
    r = vex.make_reference(x0, nit)
    noise = np.stack([np.zeros((nit, 3)), ctl.draw_noise(nit, seed=1)])
    return ctl.simulate(x0, np.asarray(VDV_U0), r, nit, inK=vex.INK,
                        noise=noise, device=device)


@pytest.mark.parametrize("integrator", ["rk4", "tr_bdf2"])
def test_explicit_nmpc_card_never_runs_the_eager_rollout(cuda, monkeypatch,
                                                         integrator):
    """The explicit NMPC on the card goes through the rollout kernel
    alone: with the eager rollouts (``rollout_tangent``,
    ``integrate_tangent``, ``integrate``) and the plain rollout made to
    raise it still runs, one launch a plant step, an offset model and an
    SQP iteration; it holds the CPU's loop within 1e-9."""
    import dataclasses as dc

    from mpc_tuning_tpu_torch.cases import vandevusse_explicit as vex
    from mpc_tuning_tpu_torch.models import ode
    from mpc_tuning_tpu_torch.sim import explicit_nmpc

    ctl = dc.replace(vex.make_controller(substeps=6, sqp_iters=4,
                                         qp_iters=20), integrator=integrator)
    nit = 12
    Yc, Uc = _explicit_run(ctl, nit, "cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("an eager rollout ran on the card")

    for mod, name in ((explicit_nmpc, "rollout_tangent"),
                      (ode, "integrate_tangent"), (ode, "integrate"),
                      (K, "nmpc_rollout_plain")):
        monkeypatch.setattr(mod, name, refuse)
    before = K.nmpc_rollout.launches
    Y, U = _explicit_run(ctl, nit, cuda)
    solves = nit - vex.INK + 1
    assert K.nmpc_rollout.launches - before == nit + solves * (
        1 + ctl.sqp_iters)
    assert np.abs(Y - Yc).max() <= 1e-9 and np.abs(U - Uc).max() <= 1e-9


def test_explicit_nmpc_card_refuses_models_outside_the_envelope(cuda):
    """Another rhs or integrator raises on the card before any launch,
    with the tune's message for another rhs."""
    import dataclasses as dc

    from mpc_tuning_tpu_torch.cases import vandevusse_explicit as vex

    ctl = vex.make_controller(substeps=6, sqp_iters=2, qp_iters=5)
    before = K.nmpc_rollout.launches
    for change, match in ((dict(rhs=lambda x, u: -x), "device='cpu'"),
                          (dict(integrator="euler"), "unknown integrator")):
        with pytest.raises(ValueError, match=match):
            _explicit_run(dc.replace(ctl, **change), 6, cuda)
    assert K.nmpc_rollout.launches == before


def _vdv_closed(cuda, integrator):
    """A Van de Vusse problem on the card and B = 8 seeded candidates at
    nit 10, as closed_batch's arguments."""
    case = vandevusse.make_case(nit=10, integrator=integrator)
    problem = vandevusse.build_problem(case, device=cuda)
    rng = np.random.default_rng(1)
    B = 8
    args = (np.broadcast_to(case.r[:10], (B, 10, 2)), problem.v,
            rng.integers(3, 9, B), rng.integers(2, 3, B),
            rng.uniform(0.05, 1.0, (B, 2)), rng.uniform(0.05, 0.5, (B, 2)), 10)
    return problem, args


@pytest.mark.parametrize("integrator", ["rk4", "tr_bdf2"])
def test_nmpc_closed_batch_follows_plain(cuda, integrator):
    """An NMPC closed loop on the card (kernels #1, #2 and the rollout)
    against the plain loop on the CPU stepping on the card's U, at
    float64, with either integrator."""
    from mpc_tuning_tpu_torch.sim.nmpc_loop import nmpc_closed_core

    problem, args = _vdv_closed(cuda, integrator)
    before = K.launch_counts()
    Y, U = problem.loop.closed_batch(*args, caps=(8, 2), device=cuda)
    after = K.launch_counts()
    for k in ("spd_factor", "spd_factor_solve", "nmpc_rollout"):
        assert after[k] > before[k], k
    spec, c, N, Nu, (r, d, l) = problem.loop._batch(
        problem.v, args[2], args[3], (8, 2), F64, "cpu", args[0],
        args[4], args[5])
    Yp, Up = nmpc_closed_core(spec, c, r, N, Nu, d, l, u_follow=U.cpu())
    # in the controller's scaled units (U up to 150 in raw units)
    torch.testing.assert_close(Y.cpu() / c["sf_y"], Yp / c["sf_y"], rtol=0,
                               atol=1e-9)
    torch.testing.assert_close(U.cpu() / c["sf_u"], Up / c["sf_u"], rtol=0,
                               atol=1e-9)


def test_nmpc_card_never_runs_the_plain_rollout(cuda, monkeypatch):
    """A stiff closed batch on the card goes through the rollout kernel
    alone: with the plain rollout made to raise it still runs, one launch
    per rollout (SQP iterations and plant steps)."""
    def refuse(*args, **kwargs):
        raise AssertionError("the plain rollout ran on a CUDA tensor")

    monkeypatch.setattr(K, "nmpc_rollout_plain", refuse)
    problem, args = _vdv_closed(cuda, "tr_bdf2")
    before = K.nmpc_rollout.launches
    Y, U = problem.loop.closed_batch(*args, caps=(8, 2), device=cuda)
    spec = problem.loop.spec
    assert K.nmpc_rollout.launches - before == 9 * (spec.sqp_iters + 1)
    assert torch.isfinite(Y).all() and torch.isfinite(U).all()


# ------------------------------------------------- candidate sharding


def _on(x, dev):
    """x's tensors (nested in dicts, tuples and lists) copied to dev."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: _on(v, dev) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_on(v, dev) for v in x)
    return x


def _two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")


def _kernel_call(name):
    """(fn, args) launching kernel ``name`` at a small shape, on cuda:0."""
    if name in ("spd_factor", "spd_factor_solve", "spd_solve",
                "factor_lanes", "solve_lanes"):
        M, rhs = _spd_batch("cuda", 37, 17)
        L = K.spd_factor_plain(M)
        return {"spd_factor": (K.spd_factor, (M,)),
                "spd_factor_solve": (K.spd_factor_solve, (L, rhs)),
                "spd_solve": (K.spd_solve, (M, rhs)),
                "factor_lanes": (K.factor_lanes,
                                 (M.permute(1, 2, 0).contiguous(),)),
                "solve_lanes": (K.solve_lanes,
                                (L.permute(1, 2, 0).contiguous(),
                                 rhs.T.contiguous()))}[name]
    if name in ("pdip_fused", "admm_fused"):
        engine = "pdip_ws_fused" if name == "pdip_fused" else "admm_fused"
        return getattr(K, name), _step_qp(engine, F64, take=5, B=8)
    if name == "closed_sim_band":
        return K.closed_sim_band, _band_inputs("cuda", (32, 4), B=2, nit=8)
    if name == "lane_sum":
        g = torch.Generator(device="cuda").manual_seed(3)
        return K.lane_sum, (torch.randn((181, 37), generator=g,
                                        device="cuda", dtype=F64),)
    if name == "nmpc_rollout":
        spec, x, up, du, cm, _ = _vdv_rollout_args((16, 2), B=8)
        return (lambda *a: K.nmpc_rollout(spec, *a, 16, jac=True),
                (x, up, du, cm))
    engine = "admm_sim" if name == "closed_sim_admm" else "pdip_sim"
    t, lc, Hm, r_l, dims = _inputs(engine, B=8, nit=12, caps=(32, 4))
    if engine == "admm_sim":
        fn = lambda *a: K.closed_sim_admm(*a, 12, 5, mpc_loop.ADMM_SIGMA,
                                          mpc_loop.ADMM_OVER_RELAX, dims)
    else:
        fn = lambda *a: K.closed_sim_pdip(*a, 12, 5, dims)
    return fn, (t, lc, Hm, r_l)


@pytest.mark.parametrize("name", [f.__name__ for f in K._WRAPPERS])
def test_launch_on_the_second_card(name):
    """A launch on tensors of cuda:1 while cuda:0 is current runs on
    cuda:1 (the wrapper makes the tensors' card current) and returns the
    bits of the same launch on cuda:0."""
    _two_cards()
    fn, args = _kernel_call(name)
    ref = fn(*args)
    before = getattr(K, name).launches
    with torch.cuda.device(0):
        out = fn(*_on(args, "cuda:1"))
    assert getattr(K, name).launches == before + 1
    torch.cuda.synchronize(1)
    tensors = lambda o: [t for t in (o if isinstance(o, tuple) else (o,))
                         if t is not None]
    for a, b in zip(tensors(out), tensors(ref)):
        assert a.device == torch.device("cuda", 1)
        assert torch.equal(a.cpu(), b.cpu())


def _shard_problem(case):
    """A small problem of ``case`` on the card at the dtype its tune takes:
    Wood-Berry float32 ('pdip_sim' / 'admm_sim'), Shell7x5 float64
    ('band_sim'), Van de Vusse float64 (the NMPC loop)."""
    if case == "vandevusse":
        c = vandevusse.make_case(nit=10)
        return vandevusse.build_problem(c, F64, "cuda")
    if case == "shell7x5":
        return build_problem(shell7x5.make_case(nit=30), dtype=F64,
                             qp_iters=60, device="cuda")[0]
    return build_problem(woodberry.make_case(nit=60), dtype=torch.float32,
                         qp_iters=15, device="cuda")[0]


@pytest.mark.parametrize("cards", [1, 2])
@pytest.mark.parametrize("case", ["woodberry", "shell7x5", "vandevusse"])
def test_sharded_objectives_match_whole_on_the_card(cuda, case, cards):
    """A GAM batch and a VNS neighbourhood scored over two shards (both on
    cuda:0, or on cuda:0 and cuda:1) read the whole batch's bits: both
    legs, F and the SSE; the shards launch the engine the whole batch
    does."""
    from mpc_tuning_tpu_torch.parallel.sweep import candidate_mesh
    from mpc_tuning_tpu_torch.tuning.objectives import (gam_sse_batch,
                                                        vns_objective_batch)

    if cards == 2:
        _two_cards()
    problem = _shard_problem(case)
    mesh = candidate_mesh(["cuda:0", "cuda:0" if cards == 1 else "cuda:1"])
    rng = np.random.default_rng(3)
    X = rng.uniform(0.05, 2.0, size=(5, problem.my + problem.nu))
    # up to the widest bucket: Shell7x5's (127, 15) open leg has 1959 rows
    # (a product of width 1959 that cuBLAS splits by the lanes' count)
    spec = problem.loop.spec if case == "vandevusse" else \
        problem.loop.ctl.spec
    N_b = np.minimum([8, spec.p_max, 7, 30, 10, 6, spec.p_max], spec.p_max)
    Nu_b = np.minimum([2, 3, 2, spec.m_max, 2, 2, 5], spec.m_max)
    delta, lam = rng.uniform(0.2, 2.0, problem.my), rng.uniform(
        0.05, 0.5, problem.nu)
    legs = {}

    def score():
        for k in ("closed_batch", "open_batch"):
            fn = getattr(type(problem), k)

            def keep(*a, _fn=fn, _k=k, **kw):
                out = _fn(problem, *a, **kw)
                legs.setdefault(_k, []).append(out)
                return out
            setattr(problem, k, keep)
        try:
            K.reset_launches()
            out = (gam_sse_batch(problem, 8, 2, X),
                   vns_objective_batch(problem, N_b, Nu_b, delta, lam))
            return out, K.launch_counts()
        finally:
            for k in ("closed_batch", "open_batch"):
                delattr(problem, k)

    (S0, F0), n0 = score()
    whole = {k: list(v) for k, v in legs.items()}
    legs.clear()
    problem.mesh = mesh
    (S1, F1), n1 = score()
    problem.mesh = None
    assert np.array_equal(S1, S0) and np.array_equal(F1, F0)
    for k, calls in whole.items():
        for (Y0, U0), (Y1, U1) in zip(calls, legs[k]):
            assert np.array_equal(Y1, Y0) and np.array_equal(U1, U0), k
    used = {k for k, v in n0.items() if v}
    assert used == {k for k, v in n1.items() if v}, (n0, n1)
    assert all(n1[k] >= n0[k] for k in used), (n0, n1)
    back = slice(None, None, -1)  # the same candidates in the other slots
    F2 = vns_objective_batch(problem, N_b[back], Nu_b[back], delta, lam)
    assert np.array_equal(F2[back], F0)


# ------------------------------------------------------------ the bench


@pytest.mark.parametrize("row", ["dtc", "wb", "gam", "band", "vdv", "qp"])
def test_bench_row_holds_on_the_card(cuda, row):
    """Each row of mpc_tuning_tpu_torch.bench at B = 64 on the card (the
    band and Van de Vusse rows cut to nit 50 and 20, one timed run):
    its first 8 lanes pass their hold against the plain version, its
    numbers are finite and its kernels were launched."""
    from mpc_tuning_tpu_torch import bench

    f32 = torch.float32
    if row in ("wb", "gam", "qp"):
        problem, _ = build_problem(woodberry.make_case(), dtype=f32,
                                   qp_iters=40, device="cuda")
    if row == "dtc":
        out = bench.dtc_row(64, reps=1)
    elif row == "wb":
        out, _ = bench.wb_row(problem, 64, "admm_sim", 40, reps=1)
    elif row == "gam":
        out, _ = bench.wb_row(problem, 64, "pdip_sim", 15, N_fix=20,
                              Nu_fix=4, reps=1)
    elif row == "band":
        out = bench.band_row(64, nit=50, reps=1)
    elif row == "vdv":
        out = bench.vdv_row(64, nit=20, reps=1)
    else:
        out = bench.qp_p50_row(problem, dict(problem.loop.capped(64, 8).dims))
        assert out["launches"] == {"spd_factor": 15, "spd_factor_solve": 30}
    bench.run_holds([out])
    assert np.isfinite(out["value"]) and out["value"] > 0
    assert ("z vs plain" if row == "qp" else "lanes 0-7") in out["held"]
    kernels = {"wb": "closed_sim_admm", "gam": "closed_sim_pdip",
               "band": "closed_sim_band", "vdv": "nmpc_rollout"}
    if row in kernels:
        assert out["launches"][kernels[row]] > 0
