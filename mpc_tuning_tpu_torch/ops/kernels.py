"""The port's hand-written Hopper kernels, each beside its plain PyTorch
version (the counterpart of ``mpc_tuning_tpu/ops/pallas_kernels.py``).

Every kernel's public function here is a wrapper:
  * for tensors on the CPU it runs the plain version (the CPU tests use it);
  * for CUDA tensors it checks dtype, shape and contiguity, launches the
    CUDA kernel (ops/csrc/, built by ops/_build.py) on the current stream
    of the tensors' card, with that card made current, or raises.  There
    is no fallback.
Each wrapper counts its kernel launches in ``<wrapper>.launches``; only a
launch adds to it.

Layouts follow the JAX package: ``spd_factor`` / ``spd_factor_solve`` /
``spd_solve`` take the public batch-major (B, n, n) / (B, n) layout, and
``nmpc_rollout`` the NMPC loop's candidate-first tensors; ``factor_lanes`` /
``solve_lanes``, the single-solve kernels ``pdip_fused`` / ``admm_fused``
and the whole-sim kernels take lane-major inputs, the candidate batch B on
the last axis (``sim/mpc_loop.py`` builds them; the band wrapper hands its
cluster-per-lane kernel the per-lane inputs batch-major).  Unlike the TPU
kernels, nothing is padded to (8, 128) tiles.

The closed loop of the per-step engines and of the whole-sim plain
versions is one Python loop over steps, ``step_loop``, around a per-step
QP solve (``pdip_step`` / ``admm_step``).
"""

from __future__ import annotations

import ctypes

import torch

from mpc_tuning_tpu_torch.models.ode import (NMPC_INTEGRATORS, column_mask,
                                             nmpc_envelope,
                                             nmpc_rollout_plain)
from mpc_tuning_tpu_torch.ops import _build

__all__ = ["spd_factor", "spd_factor_solve", "spd_solve", "factor_lanes",
           "factor_envelope", "factor_solve_envelope", "spd_solve_envelope",
           "pdip_fused_envelope",
           "admm_fused_envelope",
           "solve_lanes", "pdip_fused", "admm_fused", "closed_sim_admm",
           "closed_sim_pdip", "closed_sim_band", "nmpc_rollout",
           "nmpc_rollout_thread_per_column",
           "spd_factor_plain", "spd_factor_solve_plain", "spd_solve_plain",
           "factor_lanes_plain", "solve_lanes_plain", "pdip_fused_plain",
           "admm_fused_plain", "closed_sim_admm_plain",
           "closed_sim_pdip_plain", "closed_sim_band_plain",
           "g_shared", "step_loop", "lane_sum", "lane_sum_plain",
           "warp_order_sum",
           "pdip_step", "admm_step", "band_envelope", "band_plan",
           "reset_launches",
           "launch_counts", "require_device", "sim_envelope"]

_SIM_TABLES = ("Cpl", "Apl", "Bplu", "C", "Mk", "A", "Bu", "SxF", "SstF",
               "ThT", "Vt")
# argument order of the C launcher (ops/csrc/closed_sim.cu, enum P_*)
_SIM_PTRS = _SIM_TABLES + (
    "g_ptr", "g_col", "g_val", "gt_ptr", "gt_row", "gt_val",
    "e_ptr", "e_row", "e_coef",
    "r", "q", "hbase", "su", "rowm", "colm", "Dinv", "e", "par", "sfy", "sfu",
    "Hm", "Y", "U")
_SIM_DIMS = ("B", "nit", "iters", "ny", "nu", "nxa", "nxp", "pny", "n", "mc",
             "m_max")


def require_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device on a host without one
    raises (the port's entry points default to the card and never carry on
    on the CPU unless it is asked for)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions")
    return dev


def _on_cpu(*ts) -> bool:
    """True when every tensor lies on the CPU, False when all are on one
    CUDA device; anything else raises."""
    kinds = {t.device for t in ts}
    if all(d.type == "cpu" for d in kinds):
        return True
    if len(kinds) != 1 or next(iter(kinds)).type != "cuda":
        raise ValueError(f"tensors on mixed or unsupported devices: {kinds}")
    return False


def _require(t, shape, dtype, name):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _float_dtype(t):
    if t.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"kernels take float32 or float64, got {t.dtype}")
    return t.dtype


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _device_of(t):
    """The launch's device made current: the CUDA side sets its
    shared-memory attributes on, and launches on, the current device, so a
    launch on tensors of another card than the current one runs under
    theirs."""
    return torch.cuda.device(t.device)


# ------------------------------------------------------------ spd_factor
#
# Replaces _factor_batched_impl / _factor_kernel
# (mpc_tuning_tpu/ops/pallas_kernels.py, spd_factor).  Bound by launch
# latency and each matrix's serial chain; one warp per matrix, the matrix in
# a shared-memory tile, several matrices per block (ops/csrc/spd.cu).

# The envelope of spd_factor and factor_lanes (ops/csrc/spd.cu,
# FactorShape / factor_fits): W matrices per block, 8 at float32 and 4 at
# float64; a tile of n rows at an odd row stride n | 1 per matrix; at most
# FACTOR_SMEM_MAX bytes of shared memory a block (the H100's 227 KB) and
# FACTOR_MAX_ROWS rows per lane.
FACTOR_SMEM_MAX = 232448
FACTOR_MAX_ROWS = 2


def factor_envelope(n, dtype, kernel="SPD factor kernels"):
    """(matrices per block, shared-memory bytes per block) of the factor
    kernels at n and dtype; raises ValueError, naming ``kernel``, outside
    the envelope (both dtypes take n <= 64)."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"kernels take float32 or float64, got {dtype}")
    f64 = dtype == torch.float64
    per_block = 4 if f64 else 8
    smem = per_block * n * (n | 1) * (8 if f64 else 4)
    if not (1 <= n <= 32 * FACTOR_MAX_ROWS and smem <= FACTOR_SMEM_MAX):
        raise ValueError(
            f"{kernel}: n = {n} at {dtype} needs {smem} bytes of "
            f"shared memory a block, at most {FACTOR_SMEM_MAX}, and n <= 64")
    return per_block, smem


def spd_factor_plain(M):
    """Lower Cholesky factor of a (B, n, n) SPD batch; a failed factor is
    all NaN (as jnp.linalg.cholesky returns)."""
    L, info = torch.linalg.cholesky_ex(M)
    L = torch.where((info != 0)[:, None, None],
                    torch.full_like(L, float("nan")), L)
    return L.contiguous()  # the kernel's layout, so it can take this L


def spd_factor(M):
    """(B, n, n) SPD -> lower factor L (B, n, n), upper triangle zero; a
    failed factor (a pivot not > 0) is all NaN, as the plain version's.
    Raises above ``factor_envelope``."""
    if _on_cpu(M):
        return spd_factor_plain(M)
    dtype = _float_dtype(M)
    B, n = M.shape[0], M.shape[-1]
    _require(M, (B, n, n), dtype, "M")
    factor_envelope(n, dtype)
    L = torch.empty_like(M)
    with _device_of(M):
        _build.check(_build.library().mpc_spd_factor(
            int(dtype == torch.float64), 0, M.data_ptr(), L.data_ptr(), B, n,
            _stream(M)), "spd_factor")
    spd_factor.launches += 1
    return L


spd_factor.launches = 0


# ------------------------------------------------------ spd_factor_solve
#
# Replaces _solve_batched_impl / _solve_kernel (spd_factor_solve): forward
# then back substitution, 2 n^2 dependent multiply-adds per system.  Bound
# by launch latency and each system's serial chain; one warp per system on
# the factor's lower triangle in a shared-memory tile, the factors' layout
# and envelope, ~2 n dependent steps (ops/csrc/spd.cu).


def factor_solve_envelope(n, dtype, kernel="spd_factor_solve"):
    """(systems per block, shared-memory bytes per block) of the solves
    ``spd_factor_solve`` and ``solve_lanes``: their tiles are the factors'
    (``factor_envelope``), and every solve follows a factor; raises
    ValueError, naming ``kernel``, outside (both dtypes take n <= 64)."""
    return factor_envelope(n, dtype, kernel)


def spd_factor_solve_plain(L, rhs):
    """x with L L' x = rhs; L (B, n, n) lower, rhs (B, n)."""
    y = torch.linalg.solve_triangular(L, rhs[:, :, None], upper=False)
    x = torch.linalg.solve_triangular(L.transpose(1, 2), y, upper=True)
    return x[:, :, 0]


def _solve_args(L, rhs):
    dtype = _float_dtype(L)
    B, n = L.shape[0], L.shape[-1]
    _require(L, (B, n, n), dtype, "L")
    _require(rhs, (B, n), dtype, "rhs")
    return dtype, B, n


def spd_factor_solve(L, rhs):
    """(B, n, n) lower factor, (B, n) rhs -> x (B, n) with L L' x = rhs.
    Reads L's lower triangle only.  Raises above
    ``factor_solve_envelope``."""
    if _on_cpu(L, rhs):
        return spd_factor_solve_plain(L, rhs)
    dtype, B, n = _solve_args(L, rhs)
    factor_solve_envelope(n, dtype)
    x = torch.empty_like(rhs)
    with _device_of(L):
        _build.check(_build.library().mpc_spd_factor_solve(
            int(dtype == torch.float64), 0, L.data_ptr(), rhs.data_ptr(),
            x.data_ptr(), B, n, _stream(L)), "spd_factor_solve")
    spd_factor_solve.launches += 1
    return x


spd_factor_solve.launches = 0


def spd_factor_solve_one_thread(L, rhs):
    """``spd_factor_solve`` by the one-thread-per-system design it replaced
    (ops/csrc/reference/spd_factor_solve_one_thread.cu, built on demand
    into its own library), its reference: CUDA tensors only, not counted,
    on no path of the port."""
    dtype, B, n = _solve_args(L, rhs)
    x = torch.empty_like(rhs)
    with _device_of(L):
        lib = _build.reference_library()
        _build.check(lib.mpc_spd_factor_solve_one_thread(
            int(dtype == torch.float64), L.data_ptr(), rhs.data_ptr(),
            x.data_ptr(), B, n, _stream(L)), "spd_factor_solve_one_thread")
    return x


# ------------------------------------------------------------- spd_solve
#
# Replaces _spd_solve_batched_impl / _cholsolve_kernel (spd_solve): the
# factor and both substitutions in one launch, one warp per system on the
# matrix in a shared-memory tile (spd_factor's tile, then
# spd_factor_solve's substitutions on it; no device-memory scratch), the
# factors' envelope (ops/csrc/spd.cu).  A public entry point with no
# caller on a tune path, as in the JAX package.


def spd_solve_plain(M, rhs):
    """x (B, n) with M x = rhs for a (B, n, n) SPD batch: the factor of
    ``spd_factor_plain`` (all NaN where it fails) and two triangular
    solves."""
    return spd_factor_solve_plain(spd_factor_plain(M), rhs)


def spd_solve_envelope(n, dtype):
    """(systems per block, shared-memory bytes per block) of ``spd_solve``:
    it factors and solves in the factors' tiles (``factor_envelope``);
    raises ValueError, naming spd_solve, outside (both dtypes take n <=
    64)."""
    return factor_envelope(n, dtype, "spd_solve")


def _spd_solve_args(M, rhs):
    dtype = _float_dtype(M)
    B, n = M.shape[0], M.shape[-1]
    _require(M, (B, n, n), dtype, "M")
    _require(rhs, (B, n), dtype, "rhs")
    return dtype, B, n


def spd_solve(M, rhs):
    """(B, n, n) SPD, (B, n) rhs -> x (B, n) with M x = rhs, from M's lower
    triangle; a system whose factor fails (a pivot not > 0) is all NaN.
    x is the bits of ``spd_factor_solve(spd_factor(M), rhs)``.  Raises
    above ``spd_solve_envelope``."""
    if _on_cpu(M, rhs):
        return spd_solve_plain(M, rhs)
    dtype, B, n = _spd_solve_args(M, rhs)
    spd_solve_envelope(n, dtype)
    x = torch.empty_like(rhs)
    with _device_of(M):
        _build.check(_build.library().mpc_spd_solve(
            int(dtype == torch.float64), M.data_ptr(), rhs.data_ptr(),
            x.data_ptr(), B, n, _stream(M)), "spd_solve")
    spd_solve.launches += 1
    return x


spd_solve.launches = 0


def spd_solve_one_thread(M, rhs):
    """``spd_solve`` by the one-thread-per-system design it replaced
    (ops/csrc/reference/spd_solve_one_thread.cu, the factor in lane-major
    device scratch; built on demand into its own library), its reference:
    CUDA tensors only, not counted, on no path of the port."""
    dtype, B, n = _spd_solve_args(M, rhs)
    x = torch.empty_like(rhs)
    work = torch.empty((n * n * B,), dtype=dtype, device=M.device)
    with _device_of(M):
        _build.check(_build.reference_library().mpc_spd_solve_one_thread(
            int(dtype == torch.float64), M.data_ptr(), rhs.data_ptr(),
            x.data_ptr(), work.data_ptr(), B, n, _stream(M)),
            "spd_solve_one_thread")
    return x


# -------------------------------------------------- factor_lanes / solve_lanes
#
# Replace factor_lanes / solve_lanes (mpc_tuning_tpu/ops/pallas_kernels.py,
# _factor_kernel / _solve_kernel on lane-major blocks), the factor and solve
# of the per-step engine 'pdip_ws_lanes' (ops/qp.pdip_lanes).  The designs
# of spd_factor / spd_factor_solve (one warp per matrix or system, the
# factor in a shared-memory tile; the same bits) in the lane-major layout
# (n, n, B) / (n, B): the tiles load in 32-byte runs and the PDIP loop
# around them needs no transposes (ops/csrc/spd.cu).


def factor_lanes_plain(M):
    """Lower Cholesky factor of a lane-major (n, n, B) SPD batch; a failed
    factor is all NaN."""
    return spd_factor_plain(M.permute(2, 0, 1)).permute(1, 2, 0)


def factor_lanes(M):
    """(n, n, B) SPD -> lower factor L (n, n, B), upper triangle zero; a
    failed factor is all NaN.  Raises above ``factor_envelope``."""
    if _on_cpu(M):
        return factor_lanes_plain(M)
    dtype = _float_dtype(M)
    n, B = M.shape[0], M.shape[-1]
    M = M.contiguous()  # the PDIP's M and rhs may come as strided views
    _require(M, (n, n, B), dtype, "M")
    factor_envelope(n, dtype)
    L = torch.empty_like(M)
    with _device_of(M):
        _build.check(_build.library().mpc_spd_factor(
            int(dtype == torch.float64), 1, M.data_ptr(), L.data_ptr(), B, n,
            _stream(M)), "factor_lanes")
    factor_lanes.launches += 1
    return L


factor_lanes.launches = 0


def solve_lanes_plain(L, rhs):
    """x (n, B) with L L' x = rhs; L (n, n, B) lower, rhs (n, B).  The
    factor goes batch-major and contiguous (as factor_lanes_plain's view
    of it already is): torch's triangular solve rounds a strided batch
    otherwise than a lone system, so a lane would read by the batch's
    size."""
    return spd_factor_solve_plain(L.permute(2, 0, 1).contiguous(), rhs.T).T


def _solve_lanes_args(L, rhs):
    dtype = _float_dtype(L)
    n, B = L.shape[0], L.shape[-1]
    L, rhs = L.contiguous(), rhs.contiguous()
    _require(L, (n, n, B), dtype, "L")
    _require(rhs, (n, B), dtype, "rhs")
    return L, rhs, dtype, n, B


def solve_lanes(L, rhs):
    """(n, n, B) lower factor, (n, B) rhs -> x (n, B) with L L' x = rhs;
    a system's x is the bits ``spd_factor_solve`` gives on it.  Reads L's
    lower triangle only.  Raises above ``factor_solve_envelope``."""
    if _on_cpu(L, rhs):
        return solve_lanes_plain(L, rhs)
    L, rhs, dtype, n, B = _solve_lanes_args(L, rhs)
    factor_solve_envelope(n, dtype, "solve_lanes")
    x = torch.empty_like(rhs)
    with _device_of(L):
        _build.check(_build.library().mpc_spd_factor_solve(
            int(dtype == torch.float64), 1, L.data_ptr(), rhs.data_ptr(),
            x.data_ptr(), B, n, _stream(L)), "solve_lanes")
    solve_lanes.launches += 1
    return x


solve_lanes.launches = 0


def solve_lanes_one_thread(L, rhs):
    """``solve_lanes`` by the one-thread-per-system design it replaced
    (ops/csrc/reference/solve_lanes_one_thread.cu, built on demand into
    its own library), its reference: CUDA tensors only, not counted, on no
    path of the port."""
    L, rhs, dtype, n, B = _solve_lanes_args(L, rhs)
    x = torch.empty_like(rhs)
    with _device_of(L):
        lib = _build.reference_library()
        _build.check(lib.mpc_solve_lanes_one_thread(
            int(dtype == torch.float64), L.data_ptr(), rhs.data_ptr(),
            x.data_ptr(), B, n, _stream(L)), "solve_lanes_one_thread")
    return x


# ------------------------------------------------- single-solve QP kernels
#
# One closed-loop step's QP for every candidate lane in one launch, lane-major:
#   pdip_fused — replaces pdip_fused_lanes / _pdip_fused_kernel: `iters`
#                warm-started masked Mehrotra iterations (engine
#                'pdip_ws_fused');
#   admm_fused — replaces admm_fused_lanes / _admm_fused_kernel: `iters`
#                warm equilibrated ADMM iterations (engine 'admm_fused').
# Both run one warp per lane, the design of the whole-sim kernels
# (ops/csrc/warp_qp.cuh), within ``pdip_fused_envelope`` /
# ``admm_fused_envelope`` (see ops/csrc/qp_fused.cu for what bounds them).
# The shared constraint matrix comes as ``g_shared(G0, T2T)``, built once
# per evaluation.

_QP_CSR = ("g_ptr", "g_col", "g_val", "gt_ptr", "gt_row", "gt_val")
# the PDIP normal matrix's term list (``_entry_terms``)
_QP_TERMS = ("e_ptr", "e_row", "e_coef")
# argument order of the C launchers (ops/csrc/qp_fused.cu, enums PF_* / AF_*)
_PDIP_ARGS = ("Hp", "f", "h", "rmask", "cmask", "z0", "lam0", "z", "lam", "s")
_PDIP_PTRS = _QP_CSR + _QP_TERMS + _PDIP_ARGS
_ADMM_PTRS = _QP_CSR + ("Minv", "fs", "hs", "arow", "acol", "par", "x0",
                        "zc0", "y0", "x", "zc", "y")
# ... and of the one-thread references (ops/csrc/reference/
# pdip_fused_one_thread.cu, admm_fused_one_thread.cu), with their
# lane-major scratch
_PDIP_ONE_THREAD_PTRS = _QP_CSR + _PDIP_ARGS + ("work",)
_ADMM_ONE_THREAD_PTRS = _ADMM_PTRS + ("work",)


def g_shared(G0, T2T=None):
    """The shared constraint matrix as the single-solve QPs take it: G0
    (mc, n), the kernels' CSR of G0 by rows and by columns and, where a
    PDIP runs (T2T, its row outer products (n*n, mc), given: the plain
    PDIP's normal matrix), the warp PDIP's list of the normal matrix's
    terms (``_entry_terms``).  The CSR and the term list sync with the
    host: build this once per evaluation, not per step."""
    csr = _csr(G0) + _csr(G0.T.contiguous())
    G = dict(zip(_QP_CSR, csr), G0=G0, T2T=T2T)
    if T2T is not None:
        G.update(zip(_QP_TERMS, _entry_terms(G0)))
    return G


# ------------------------------------------------------------- lane_sum
#
# Replaces no TPU kernel: it repairs a fault of the port.  The eager PDIP's
# sums over the rows of a lane-major (rows, B) tensor (ops/qp.lane_sum)
# were torch's column sum on the card, which splits a column's rows over
# threads by the batch's width, so a lane's bits followed B.  The kernel
# sums each lane's rows in one fixed order, the order of the warp-per-lane
# QP kernels' reductions (32 strided partials, then warp_sum's butterfly),
# in double, rounded once (ops/csrc/qp_fused.cu); bound by the bytes read.

# lanes a CPU sum of ``lane_sum_plain`` takes at a time: torch's CPU sum
# over the rows of a lane-major (rows, B) tensor runs full groups of 32
# (float32) or 16 (float64) lanes vectorised and the rest scalar, which
# round differently; a group of 8 lanes runs scalar, as a batch of up to 8
# lanes always did
_CPU_LANES = 8
# the partials of warp_order_sum: a warp's lanes
_WARP = 32


def warp_order_sum(x):
    """x (rows, B) summed over its rows, (1, B), by elementwise adds in the
    order and at the precision of the warp-per-lane kernels' reductions
    (warp_qp.cuh warp_sum: row r into partial r % 32 in index order, from
    zero, then the xor butterfly as its lane 0 sees it).  Every add is one
    element's, so a lane's bits follow neither its slot nor B, on any
    device."""
    rows, B = x.shape
    acc = x.new_zeros((_WARP, B))
    for r0 in range(0, rows, _WARP):
        chunk = x[r0:r0 + _WARP]
        acc[:chunk.shape[0]] += chunk
    width = _WARP
    while width > 1:
        width //= 2
        acc = acc[:width] + acc[width:2 * width]
    return acc


def lane_sum_plain(x):
    """Plain version of ``lane_sum``: x (rows, B) summed over its rows,
    (1, B), a lane's bits following neither its slot nor B.  On the CPU
    torch's sum over groups of _CPU_LANES lanes (padded with zeros to whole
    groups), all on its scalar path; on the card ``warp_order_sum`` (a
    torch reduction there splits a column by the batch's width).  The plain
    versions of the PDIP kernels take it (``ops/qp.pdip_lanes``'s
    ``total``), so they launch no kernel."""
    if x.device.type != "cpu":
        return warp_order_sum(x)
    rows, B = x.shape
    pad = -B % _CPU_LANES
    if pad:
        x = torch.cat([x, x.new_zeros((rows, pad))], dim=1)
    groups = x.reshape(rows, x.shape[1] // _CPU_LANES, _CPU_LANES)
    groups = groups.transpose(0, 1).contiguous()
    return groups.sum(1).reshape(1, -1)[:, :B]


def lane_sum(x):
    """x (rows, B), any strides, -> (1, B), each lane's rows summed in one
    fixed order: a lane's bits follow neither its slot nor B."""
    if _on_cpu(x):
        return lane_sum_plain(x)
    dtype = _float_dtype(x)
    rows, B = x.shape
    out = torch.empty((1, B), dtype=dtype, device=x.device)
    if B == 0:
        return out
    with _device_of(x):
        _build.check(_build.library().mpc_lane_sum(
            int(dtype == torch.float64), x.data_ptr(), out.data_ptr(), rows,
            B, x.stride(0), x.stride(1), _stream(x)), "lane_sum")
    lane_sum.launches += 1
    return out


lane_sum.launches = 0


def _launch_qp(fn, ptr_count, names, bufs, dims, scal, dtype, what):
    if ptr_count is not None and (
            ptr_count() != len(names)
            or _build.library().mpc_qp_fused_dim_count() != len(dims)):
        raise RuntimeError(f"{what} argument layout mismatch")
    ptrs = (ctypes.c_void_p * len(names))(
        *[bufs[k].data_ptr() if bufs[k].numel() else None for k in names])
    with _device_of(bufs[names[-1]]):
        _build.check(fn(int(dtype == torch.float64), ptrs,
                        (ctypes.c_int * len(dims))(*dims),
                        (ctypes.c_double * len(scal))(*scal),
                        _stream(bufs[names[-1]])), what)


def _require_g(G, dtype, mc, n, device, keys=_QP_CSR):
    _require(G["G0"], (mc, n), dtype, "G0")
    for k in keys:
        if k not in G:
            raise ValueError(f"G lacks {k}: build it with g_shared(G0, T2T)")
        if G[k].device != device:
            raise ValueError(f"{k}: on {G[k].device}, expected {device}")


def pdip_fused_plain(Hp, f, h, rmask, cmask, warm, G, iters):
    """Plain version of ``pdip_fused``: ``ops/qp.pdip_lanes`` with the
    plain factor, solve and row sum and G's dense T2T."""
    from mpc_tuning_tpu_torch.ops.qp import pdip_lanes

    return pdip_lanes(Hp, f, G["G0"], G["T2T"], rmask, cmask, h, iters, warm,
                      factor=factor_lanes_plain, solve=solve_lanes_plain,
                      total=lane_sum_plain)


def pdip_fused_envelope(dtype, n, mc):
    """(lanes per block, shared-memory bytes per block) of the
    single-solve PDIP kernel (ops/csrc/qp_fused.cu, QpShape / PdipLayout):
    one warp per lane, 4 lanes a block at float32 and 2 at float64; each
    lane's H and normal-matrix tiles (row stride n | 1), six n-vectors and
    eleven mc-vectors in shared memory, at most FACTOR_SMEM_MAX bytes a
    block, and n <= 64 (the factor's two rows a lane).  Raises ValueError
    outside the envelope."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"kernels take float32 or float64, got {dtype}")
    f64 = dtype == torch.float64
    per_block = 2 if f64 else 4
    smem = (per_block * (2 * n * (n | 1) + 6 * n + 11 * mc)
            * (8 if f64 else 4))
    if not (1 <= n <= 32 * FACTOR_MAX_ROWS and mc >= 1
            and smem <= FACTOR_SMEM_MAX):
        raise ValueError(
            f"pdip_fused kernel: n = {n}, mc = {mc} at {dtype} needs {smem} "
            f"bytes of shared memory a block, at most {FACTOR_SMEM_MAX}, and "
            f"n <= {32 * FACTOR_MAX_ROWS}")
    return per_block, smem


def _pdip_bufs(Hp, f, h, rmask, cmask, warm, G, keys):
    """Checked launch buffers of a PDIP single solve (G's ``keys``):
    inputs and the best iterate (z, lam, s)."""
    dtype = _float_dtype(f)
    n, B = f.shape
    mc = h.shape[0]
    _require(Hp, (n, n, B), dtype, "Hp")
    for k, x, rows in (("f", f, n), ("h", h, mc), ("rmask", rmask, mc),
                       ("cmask", cmask, n), ("z0", warm[0], n),
                       ("lam0", warm[1], mc)):
        _require(x, (rows, B), dtype, k)
    _require_g(G, dtype, mc, n, f.device, keys)
    kw = dict(dtype=dtype, device=f.device)
    z, lam, s = (torch.empty((rows, B), **kw) for rows in (n, mc, mc))
    return dict({k: G[k] for k in keys}, Hp=Hp, f=f, h=h, rmask=rmask,
                cmask=cmask, z0=warm[0], lam0=warm[1], z=z, lam=lam, s=s)


def pdip_fused(Hp, f, h, rmask, cmask, warm, G, iters):
    """One masked PDIP solve per lane, all `iters` Mehrotra iterations in
    one launch: Hp (n, n, B), f (n, B), h / rmask (mc, B), cmask (n, B),
    warm = (z0 (n, B), lam0 (mc, B)) (the slacks are recomputed from h,
    duals and slacks floored at WS_EPS), G = ``g_shared(G0, T2T)``.
    Returns the best iterate by merit, (z, lam, s).  Raises outside
    ``pdip_fused_envelope``."""
    if _on_cpu(Hp, f):
        return pdip_fused_plain(Hp, f, h, rmask, cmask, warm, G, iters)
    from mpc_tuning_tpu_torch.ops.qp import WS_EPS, pdip_constants

    bufs = _pdip_bufs(Hp, f, h, rmask, cmask, warm, G, _QP_CSR + _QP_TERMS)
    n, B = f.shape
    mc = h.shape[0]
    pdip_fused_envelope(f.dtype, n, mc)
    lib = _build.library()
    ridge, w_cap = pdip_constants(f.dtype)
    _launch_qp(lib.mpc_pdip_fused, lib.mpc_pdip_fused_ptr_count, _PDIP_PTRS,
               bufs, (B, n, mc, iters), (WS_EPS, ridge, w_cap), f.dtype,
               "pdip_fused")
    pdip_fused.launches += 1
    return bufs["z"], bufs["lam"], bufs["s"]


pdip_fused.launches = 0


def pdip_fused_one_thread(Hp, f, h, rmask, cmask, warm, G, iters):
    """``pdip_fused`` by the one-thread-per-lane design it replaced
    (ops/csrc/reference/pdip_fused_one_thread.cu, built on demand into its
    own library), its reference: CUDA tensors only, not counted, on no
    path of the port."""
    from mpc_tuning_tpu_torch.ops.qp import WS_EPS, pdip_constants

    bufs = _pdip_bufs(Hp, f, h, rmask, cmask, warm, G, _QP_CSR)
    n, B = f.shape
    mc = h.shape[0]
    lib = _build.reference_library()
    bufs["work"] = torch.empty(
        (lib.mpc_pdip_fused_one_thread_work_rows(n, mc) * B,),
        dtype=f.dtype, device=f.device)
    ridge, w_cap = pdip_constants(f.dtype)
    _launch_qp(lib.mpc_pdip_fused_one_thread, None, _PDIP_ONE_THREAD_PTRS,
               bufs, (B, n, mc, iters), (WS_EPS, ridge, w_cap), f.dtype,
               "pdip_fused_one_thread")
    return bufs["z"], bufs["lam"], bufs["s"]


def admm_fused_plain(Minv_t, fs, hs, arow, acol, par, state, G, iters,
                     sigma, over_relax):
    """Plain version of ``admm_fused``: the iterations as batched torch
    code against G's dense G0."""
    G0 = G["G0"]
    rho, rho_inv = par[0:1], par[1:2]
    x, zc, yd = state
    for _ in range(iters):
        rhs = sigma * x - fs + acol * (G0.T @ (arow * (rho * zc - yd)))
        x = torch.einsum("ijb,jb->ib", Minv_t, rhs)
        gx_r = over_relax * (arow * (G0 @ (acol * x))) + (1.0 - over_relax) * zc
        z_new = torch.minimum(gx_r + yd * rho_inv, hs)
        yd = yd + rho * (gx_r - z_new)
        zc = z_new
    return x, zc, yd


def admm_fused_envelope(dtype, n, mc):
    """(lanes per block, shared-memory bytes per block) of the
    single-solve ADMM kernel (ops/csrc/qp_fused.cu, QpShape / AdmmLayout):
    one warp per lane, 4 lanes a block at float32 and 2 at float64; each
    lane's Minv tile (row stride n | 1), four n-vectors and four
    mc-vectors in shared memory, at most FACTOR_SMEM_MAX bytes a block.
    Raises ValueError outside the envelope."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"kernels take float32 or float64, got {dtype}")
    f64 = dtype == torch.float64
    per_block = 2 if f64 else 4
    smem = per_block * (n * (n | 1) + 4 * n + 4 * mc) * (8 if f64 else 4)
    if not (n >= 1 and mc >= 1 and smem <= FACTOR_SMEM_MAX):
        raise ValueError(
            f"admm_fused kernel: n = {n}, mc = {mc} at {dtype} needs {smem} "
            f"bytes of shared memory a block, at most {FACTOR_SMEM_MAX}")
    return per_block, smem


def _admm_bufs(Minv_t, fs, hs, arow, acol, par, state, G):
    """Checked launch buffers of an ADMM single solve: inputs and the new
    state (x, zc, y)."""
    dtype = _float_dtype(fs)
    n, B = fs.shape
    mc = hs.shape[0]
    _require(Minv_t, (n, n, B), dtype, "Minv")
    for k, x, rows in (("fs", fs, n), ("hs", hs, mc), ("arow", arow, mc),
                       ("acol", acol, n), ("par", par, 2), ("x0", state[0], n),
                       ("zc0", state[1], mc), ("y0", state[2], mc)):
        _require(x, (rows, B), dtype, k)
    _require_g(G, dtype, mc, n, fs.device)
    kw = dict(dtype=dtype, device=fs.device)
    x, zc, y = (torch.empty((rows, B), **kw) for rows in (n, mc, mc))
    return dict(G, Minv=Minv_t, fs=fs, hs=hs, arow=arow, acol=acol, par=par,
                x0=state[0], zc0=state[1], y0=state[2], x=x, zc=zc, y=y)


def admm_fused(Minv_t, fs, hs, arow, acol, par, state, G, iters, sigma,
               over_relax):
    """`iters` warm equilibrated ADMM iterations per lane in one launch,
    in scaled coordinates: Minv_t (n, n, B) = (Hs + sigma I + rho Gs'Gs)^-1
    with Gs = diag(arow) G0 diag(acol), fs (n, B), hs (mc, B), arow
    (mc, B), acol (n, B), par (2, B) = (rho, 1 / rho), state = (x (n, B),
    zc (mc, B), y (mc, B)), G = ``g_shared(G0)``.  Returns the new state.
    Raises outside ``admm_fused_envelope``."""
    if _on_cpu(Minv_t, fs):
        return admm_fused_plain(Minv_t, fs, hs, arow, acol, par, state, G,
                                iters, sigma, over_relax)
    bufs = _admm_bufs(Minv_t, fs, hs, arow, acol, par, state, G)
    n, B = fs.shape
    mc = hs.shape[0]
    admm_fused_envelope(fs.dtype, n, mc)
    lib = _build.library()
    _launch_qp(lib.mpc_admm_fused, lib.mpc_admm_fused_ptr_count, _ADMM_PTRS,
               bufs, (B, n, mc, iters), (sigma, over_relax), fs.dtype,
               "admm_fused")
    admm_fused.launches += 1
    return bufs["x"], bufs["zc"], bufs["y"]


admm_fused.launches = 0


def admm_fused_one_thread(Minv_t, fs, hs, arow, acol, par, state, G, iters,
                          sigma, over_relax):
    """``admm_fused`` by the one-thread-per-lane design it replaced
    (ops/csrc/reference/admm_fused_one_thread.cu, built on demand into its
    own library), the bit-for-bit reference of the warp kernel: CUDA
    tensors only, not counted, on no path of the port."""
    bufs = _admm_bufs(Minv_t, fs, hs, arow, acol, par, state, G)
    n, B = fs.shape
    bufs["work"] = torch.empty((n * B,), dtype=fs.dtype, device=fs.device)
    lib = _build.reference_library()
    _launch_qp(lib.mpc_admm_fused_one_thread, None, _ADMM_ONE_THREAD_PTRS,
               bufs, (B, n, hs.shape[0], iters), (sigma, over_relax),
               fs.dtype, "admm_fused_one_thread")
    return bufs["x"], bufs["zc"], bufs["y"]


# ------------------------------------------------------------ closed loops
#
# Shared inputs of the closed loops (lane-major, B = candidates):
#   tables:  Cpl (ny, nxp), Apl (nxp, nxp), Bplu (nxp, nu), C (ny, nxa),
#            Mk (nxa, ny), A (nxa, nxa), Bu (nxa, nu), SxF (pny, nxa),
#            SstF (pny, nu), ThT (n, pny), G0 (mc, n), Vt (nv, nit) with
#            rows [Dv v_s | Bv v_s | Bpl_v v | Sv v_s], and T2T (n*n, mc)
#            for the plain PDIP;
#   lane_consts: q (pny, B), hbase / su (mc, B), sfy (ny, B), sfu (nu, B),
#            plus arow / acol / Dinv / e / par (ADMM) or rmask / cmask
#            (PDIP);
#   r_l (nit, ny, B): setpoints pre-scaled by 1 / sf_y.
# Both return Y (nit, ny, B) raw plant outputs (before the step's update)
# and U (nit, nu, B) applied inputs.
#
# ``step_loop`` takes ``u_follow`` (nit, nu, B): when given, the loop
# still computes and returns its own U[k] from its own QP solve, but steps
# the model and the plant with u_follow[k].  Fed a kernel's U, the plain
# version then meets every step in the state the kernel met it in, so the
# two are compared step by step; rounding cannot build up along two
# separate trajectories (an interior point run to its floor turns a
# last-digit difference into a different iterate, and a closed loop
# carries that through all later steps).


def _vcols(Vt, k, ny, nxa, nxp):
    col = Vt[:, k:k + 1]
    return (col[:ny], col[ny:ny + nxa], col[ny + nxa:ny + nxa + nxp],
            col[ny + nxa + nxp:])


def _sim_pre(t, lc, r_l, k, x_pl, xhp, u_prev, ny, mm=torch.matmul):
    """Plant output, Kalman update, free response and weighted tracking
    error for step k; ``mm`` takes the shared-matrix products."""
    nxa, nxp = t["A"].shape[0], t["Apl"].shape[0]
    dv, _, _, sv = _vcols(t["Vt"], k, ny, nxa, nxp)
    y = mm(t["Cpl"], x_pl)
    innov = y / lc["sfy"] - mm(t["C"], xhp) - dv
    x_hat = xhp + mm(t["Mk"], innov)
    free = mm(t["SxF"], x_hat) + mm(t["SstF"], u_prev) + sv
    p = t["SxF"].shape[0] // ny
    err = lc["q"] * (r_l[k].repeat(p, 1) - free)
    return y, x_hat, free, err


def _sim_post(t, lc, k, x_hat, x_pl, u_s, ny, u_follow, mm=torch.matmul):
    """U[k] = u_s * sf_u, then the model and plant step on it (or on
    u_follow[k]); returns (U[k], the u_s stepped on, xhp, x_pl)."""
    nxa, nxp = t["A"].shape[0], t["Apl"].shape[0]
    _, bv, bpl, _ = _vcols(t["Vt"], k, ny, nxa, nxp)
    u_out = u_s * lc["sfu"]
    u_pl = u_out
    if u_follow is not None:
        u_pl = u_follow[k]
        u_s = u_pl / lc["sfu"]
    xhp = mm(t["A"], x_hat) + mm(t["Bu"], u_s) + bv
    x_pl = mm(t["Apl"], x_pl) + mm(t["Bplu"], u_pl) + bpl
    return u_out, u_s, xhp, x_pl


def u_rows(u_prev, m_max, mc):
    """u_prev tiled over the 4 m_max nu move/input rows, zero below."""
    nu, B = u_prev.shape
    pad = torch.zeros((mc - 4 * m_max * nu, B), dtype=u_prev.dtype,
                      device=u_prev.device)
    return torch.cat([u_prev.repeat(4 * m_max, 1), pad], dim=0)


def step_loop(tables, lane_consts, r_l, dims, solve, warm, u_follow=None,
              mm=torch.matmul):
    """The closed loop as a Python loop over the steps of r_l: plant
    output, Kalman update, free response and tracking error, then
    ``solve(k, err, free, u_prev, warm) -> (du, warm)`` (the step's QP,
    warm-started from the previous step's state), then the input update
    and the model and plant step (on ``u_follow[k]`` when given).
    ``mm(A, X)`` takes the products of the shared matrices with the
    lane-major states.  Returns (Y (nit, ny, B), U (nit, nu, B))."""
    t, lc = tables, lane_consts
    nit, ny, B = r_l.shape
    nu = dims["nu"]
    kw = dict(dtype=r_l.dtype, device=r_l.device)
    Y, U = torch.empty((nit, ny, B), **kw), torch.empty((nit, nu, B), **kw)
    x_pl = torch.zeros((t["Apl"].shape[0], B), **kw)
    xhp = torch.zeros((t["A"].shape[0], B), **kw)
    u_prev = torch.zeros((nu, B), **kw)
    for k in range(nit):
        y, x_hat, free, err = _sim_pre(t, lc, r_l, k, x_pl, xhp, u_prev, ny,
                                       mm)
        Y[k] = y
        du, warm = solve(k, err, free, u_prev, warm)
        U[k], u_prev, xhp, x_pl = _sim_post(t, lc, k, x_hat, x_pl,
                                            u_prev + du, ny, u_follow, mm)
    return Y, U


def pdip_step(tables, lane_consts, Hp_t, dims, G, iters, qp):
    """The per-step solve of the warm PDIP engines for ``step_loop``: the
    step's f and h from the lane constants, then ``qp(Hp_t, f, h, rmask,
    cmask, (z0, lam0), G, iters) -> (z, lam, s)`` (``pdip_fused``, its
    plain version, or the factor/solve engine); the best (z, lam) is the
    next step's warm pair, from (0, 1).  Returns (solve, warm)."""
    t, lc = tables, lane_consts
    nu, n, mc, m_max = (dims[k] for k in ("nu", "n", "mc", "m_max"))
    rmask, cmask = lc["rmask"], lc["cmask"]

    def solve(k, err, free, u_prev, warm):
        f = cmask * (-2.0 * (t["ThT"] @ err))
        h = lc["hbase"] + lc["su"] * u_rows(u_prev, m_max, mc)
        z, lam, _ = qp(Hp_t, f, h, rmask, cmask, warm, G, iters)
        return z[:nu], (z, lam)

    B = Hp_t.shape[2]
    kw = dict(dtype=Hp_t.dtype, device=Hp_t.device)
    return solve, (torch.zeros((n, B), **kw), torch.ones((mc, B), **kw))


def admm_step(tables, lane_consts, Minv_t, dims, G, iters, sigma, over_relax,
              qp):
    """The per-step solve of the warm ADMM engines for ``step_loop``: the
    step's scaled fs and hs, then ``qp(Minv_t, fs, hs, arow, acol, par,
    (x, zc, y), G, iters, sigma, over_relax)`` (``admm_fused`` or its plain
    version); the state carries over in scaled coordinates, from zeros.
    Returns (solve, warm)."""
    t, lc = tables, lane_consts
    nu, n, mc, m_max = (dims[k] for k in ("nu", "n", "mc", "m_max"))
    Dinv, ev = lc["Dinv"], lc["e"]

    def solve(k, err, free, u_prev, warm):
        fs = -2.0 * (t["ThT"] @ err) * Dinv
        hs = (lc["hbase"] + lc["su"] * u_rows(u_prev, m_max, mc)) * ev
        warm = qp(Minv_t, fs, hs, lc["arow"], lc["acol"], lc["par"], warm, G,
                  iters, sigma, over_relax)
        return (warm[0] * Dinv)[:nu], warm

    B = Minv_t.shape[2]
    kw = dict(dtype=Minv_t.dtype, device=Minv_t.device)
    return solve, (torch.zeros((n, B), **kw), torch.zeros((mc, B), **kw),
                   torch.zeros((mc, B), **kw))


def closed_sim_admm_plain(tables, lane_consts, Minv_t, r_l, nit, iters,
                          sigma, over_relax, dims, u_follow=None):
    """Plain version of ``closed_sim_admm``: ``step_loop`` with the plain
    ADMM solve per step."""
    G = g_shared(tables["G0"])
    solve, warm = admm_step(tables, lane_consts, Minv_t, dims, G, iters,
                            sigma, over_relax, admm_fused_plain)
    return step_loop(tables, lane_consts, r_l, dims, solve, warm, u_follow)


def closed_sim_pdip_plain(tables, lane_consts, Hp_t, r_l, nit, iters, dims,
                          u_follow=None):
    """Plain version of ``closed_sim_pdip``: ``step_loop`` with the plain
    PDIP solve per step (``ops/qp.pdip_lanes``, warm-started from the
    previous step's best iterate (z, lam))."""
    G = g_shared(tables["G0"], tables["T2T"])
    solve, warm = pdip_step(tables, lane_consts, Hp_t, dims, G, iters,
                            pdip_fused_plain)
    return step_loop(tables, lane_consts, r_l, dims, solve, warm, u_follow)


def _csr(G):
    """Row-wise CSR of a dense matrix: (ptr int32, col int32, val)."""
    nz = G != 0
    ptr = torch.zeros(G.shape[0] + 1, dtype=torch.int32, device=G.device)
    ptr[1:] = torch.cumsum(nz.sum(dim=1), 0)
    rows, cols = nz.nonzero(as_tuple=True)
    return ptr, cols.to(torch.int32).contiguous(), G[rows, cols].contiguous()


def _entry_terms(G):
    """Per lower-triangle entry (a, b) of G'WG, row-major (entry a (a + 1)
    / 2 + b), the list of G's rows r with G[r, a] G[r, b] != 0, ascending,
    and those terms, as CSR over the entries: (e_ptr, e_row, e_coef)."""
    n = G.shape[1]
    rows = torch.nonzero(G.abs().sum(1)).flatten()
    P = G[rows][:, :, None] * G[rows][:, None, :]          # (rows, n, n)
    a_idx, b_idx = torch.tril_indices(n, n, device=G.device)
    terms = P[:, a_idx, b_idx].T                           # (entries, rows)
    nz = terms != 0
    e_ptr = torch.zeros(terms.shape[0] + 1, dtype=torch.int32,
                        device=G.device)
    e_ptr[1:] = torch.cumsum(nz.sum(1), 0)
    e_i, r_i = nz.nonzero(as_tuple=True)
    return (e_ptr, rows[r_i].to(torch.int32).contiguous(),
            terms[e_i, r_i].contiguous())


def sim_envelope(pdip: bool, dtype, n, mc, pny, ny, nu, nxa, nxp):
    """(lanes per block, shared-memory bytes per block) of the whole-sim
    kernels (ops/csrc/closed_sim.cu, SimShape / SimLayout): one warp per
    lane, 4 lanes a block at float32 and 2 at float64; each lane's loop
    state, staged constants, QP vectors and n x n tiles (row stride n | 1)
    in shared memory, at most FACTOR_SMEM_MAX bytes a block, and n <=
    64 (the PDIP factor's two rows a lane; both engines).  Raises
    ValueError outside the envelope."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"kernels take float32 or float64, got {dtype}")
    f64 = dtype == torch.float64
    per_block = 2 if f64 else 4
    nn = n * (n | 1)
    el = (2 * nxp + 2 * nxa + 3 * nu + 2 * ny + 2 * pny + 3 * mc + n + nn
          + (5 * n + 9 * mc + nn if pdip else 4 * n + 4 * mc))
    smem = per_block * el * (8 if f64 else 4)
    if not (1 <= n <= 32 * FACTOR_MAX_ROWS and smem <= FACTOR_SMEM_MAX):
        raise ValueError(
            f"whole-sim {'PDIP' if pdip else 'ADMM'} kernel: n = {n}, mc = "
            f"{mc}, pny = {pny} at {dtype} needs {smem} bytes of shared "
            f"memory a block, at most {FACTOR_SMEM_MAX}, and n <= "
            f"{32 * FACTOR_MAX_ROWS}")
    return per_block, smem


def _launch_sim(pdip: bool, tables, lc, Hm, r_l, nit, iters, dims, scal,
                row_key, col_key):
    ny, nu, n, mc, m_max = (dims[k] for k in ("ny", "nu", "n", "mc", "m_max"))
    dtype = _float_dtype(r_l)
    B = r_l.shape[2]
    nxa, nxp = tables["A"].shape[0], tables["Apl"].shape[0]
    pny = tables["SxF"].shape[0]
    nv = ny + nxa + nxp + pny
    shapes = {
        "Cpl": (ny, nxp), "Apl": (nxp, nxp), "Bplu": (nxp, nu), "C": (ny, nxa),
        "Mk": (nxa, ny), "A": (nxa, nxa), "Bu": (nxa, nu), "SxF": (pny, nxa),
        "SstF": (pny, nu), "ThT": (n, pny), "Vt": (nv, nit), "G0": (mc, n),
    }
    for k, shp in shapes.items():
        _require(tables[k], shp, dtype, k)
    lane_rows = {"q": pny, "hbase": mc, "su": mc, "sfy": ny, "sfu": nu,
                 row_key: mc, col_key: n}
    if not pdip:
        lane_rows.update(Dinv=n, e=mc, par=2)
    for k, rows in lane_rows.items():
        _require(lc[k], (rows, B), dtype, k)
    _require(Hm, (n, n, B), dtype, "Minv/Hp")
    _require(r_l, (nit, ny, B), dtype, "r_l")
    sim_envelope(pdip, dtype, n, mc, pny, ny, nu, nxa, nxp)

    lib = _build.library()
    G = g_shared(tables["G0"], tables["T2T"] if pdip else None)
    dim_vals = dict(B=B, nit=nit, iters=iters, ny=ny, nu=nu, nxa=nxa, nxp=nxp,
                    pny=pny, n=n, mc=mc, m_max=m_max)
    dims_c = (ctypes.c_int * len(_SIM_DIMS))(*[dim_vals[k] for k in _SIM_DIMS])
    if lib.mpc_closed_sim_ptr_count() != len(_SIM_PTRS) or \
            lib.mpc_closed_sim_dim_count() != len(_SIM_DIMS):
        raise RuntimeError("closed_sim argument layout mismatch")
    kw = dict(dtype=dtype, device=r_l.device)
    Y = torch.empty((nit, ny, B), **kw)
    U = torch.empty((nit, nu, B), **kw)
    keys = _QP_CSR + (_QP_TERMS if pdip else ())
    bufs = dict(tables, **{k: G[k] for k in keys}, r=r_l, q=lc["q"],
                hbase=lc["hbase"], su=lc["su"], rowm=lc[row_key],
                colm=lc[col_key], sfy=lc["sfy"], sfu=lc["sfu"], Hm=Hm, Y=Y,
                U=U)
    if not pdip:
        bufs.update(Dinv=lc["Dinv"], e=lc["e"], par=lc["par"])
    for k, v in bufs.items():
        if isinstance(v, torch.Tensor) and v.device != r_l.device:
            raise ValueError(f"{k}: on {v.device}, expected {r_l.device}")
    ptrs = (ctypes.c_void_p * len(_SIM_PTRS))(
        *[bufs[k].data_ptr() if k in bufs and bufs[k].numel() else None
          for k in _SIM_PTRS])
    scal_c = (ctypes.c_double * 3)(*scal)
    with _device_of(r_l):
        _build.check(lib.mpc_closed_sim(int(pdip), int(dtype == torch.float64),
                                        ptrs, dims_c, scal_c, _stream(r_l)),
                     "closed_sim_pdip" if pdip else "closed_sim_admm")
    return Y, U


# Replaces closed_sim_admm_lanes / _closed_sim_admm_kernel
# (mpc_tuning_tpu/ops/pallas_kernels.py); see ops/csrc/closed_sim.cu for
# what bounds it and the design: one warp per candidate lane, its state in
# shared memory, within ``sim_envelope``.


def closed_sim_admm(tables, lane_consts, Minv_t, r_l, nit, iters, sigma,
                    over_relax, dims):
    """Whole closed loop with `iters` warm equilibrated ADMM iterations per
    step against the per-lane Minv_t (n, n, B); returns (Y, U).  Raises
    outside ``sim_envelope``."""
    if _on_cpu(r_l, Minv_t):
        return closed_sim_admm_plain(tables, lane_consts, Minv_t, r_l, nit,
                                     iters, sigma, over_relax, dims)
    out = _launch_sim(False, tables, lane_consts, Minv_t, r_l, nit, iters,
                      dims, (sigma, over_relax, 0.0), "arow", "acol")
    closed_sim_admm.launches += 1
    return out


closed_sim_admm.launches = 0


# Replaces closed_sim_pdip_lanes / _closed_sim_pdip_kernel
# (mpc_tuning_tpu/ops/pallas_kernels.py), the same design as
# closed_sim_admm.  Solves with the factor by substitution in place of the
# TPU kernel's explicit L^{-1}; the two differ only in rounding.


def closed_sim_pdip(tables, lane_consts, Hp_t, r_l, nit, iters, dims):
    """Whole closed loop with a warm masked Mehrotra PDIP of `iters`
    iterations per step against the per-lane Hessians Hp_t (n, n, B);
    returns (Y, U).  Raises outside ``sim_envelope``."""
    if _on_cpu(r_l, Hp_t):
        return closed_sim_pdip_plain(tables, lane_consts, Hp_t, r_l, nit,
                                     iters, dims)
    from mpc_tuning_tpu_torch.ops.qp import WS_EPS, pdip_constants

    ridge, w_cap = pdip_constants(r_l.dtype)
    out = _launch_sim(True, tables, lane_consts, Hp_t, r_l, nit, iters, dims,
                      (WS_EPS, ridge, w_cap), "rmask", "cmask")
    closed_sim_pdip.launches += 1
    return out


closed_sim_pdip.launches = 0

# ------------------------------------------------------- whole band loop
#
# Replaces closed_sim_band_lanes / _closed_sim_band_kernel
# (mpc_tuning_tpu/ops/pallas_kernels.py); see ops/csrc/closed_sim_band.cu
# for what bounds it and the design.  Inputs as for closed_sim_pdip, with
# the band lane constants in place of hbase / su: hbu, su (4 m nu, B) for
# the move and input rows, hbyh, rmyh, hbyl, rmyl (p ny, B) for the band
# rows (h = hbyh - rmyh * free, hbyl + rmyl * free), cmask2 (n, B) = cmask
# with the slack masked, lpd (n, B) = diag(H_lp).


def closed_sim_band_plain(tables, lane_consts, Hp_t, r_l, nit, lp_iters,
                          s2_iters, dims, u_follow=None):
    """Plain version of ``closed_sim_band``: ``step_loop`` with, per step,
    the slack seeding, the stage-0 slack LP and the slack-frozen stage 2,
    each a ``ops/qp.pdip_lanes`` solve with the plain factor, solve and
    row sum; the LP's best (z, lam) is the next step's warm pair.  Returns
    (Y, U, E)."""
    from mpc_tuning_tpu_torch.ops.qp import pdip_lanes, seed_slack, split_stage2

    t, lc = tables, lane_consts
    nu, n, mc, m_max = (dims[k] for k in ("nu", "n", "mc", "m_max"))
    B = r_l.shape[2]
    kw = dict(dtype=r_l.dtype, device=r_l.device)
    G0, T2T, rmask, cmask = t["G0"], t["T2T"], lc["rmask"], lc["cmask"]
    H_lp = torch.diag_embed(lc["lpd"].T).permute(1, 2, 0)
    f_lp = torch.zeros((n, B), **kw)
    f_lp[-1] = 1.0
    plain = dict(factor=factor_lanes_plain, solve=solve_lanes_plain,
                 total=lane_sum_plain)
    zero1 = torch.zeros((1, B), **kw)
    E = torch.empty((r_l.shape[0], B), **kw)

    def solve(k, err, free, u_prev, warm):
        f = cmask * (-2.0 * (t["ThT"] @ err))
        h = torch.cat([lc["hbu"] + lc["su"] * u_prev.repeat(4 * m_max, 1),
                       lc["hbyh"] - lc["rmyh"] * free,
                       lc["hbyl"] + lc["rmyl"] * free, zero1])
        z0, lam0 = seed_slack(*warm, G0, rmask, cmask, h)
        warm = pdip_lanes(H_lp, f_lp, G0, T2T, rmask, cmask, h, lp_iters,
                          (z0, lam0), **plain)[:2]
        h2, _, z2, ehat = split_stage2(warm[0], G0, rmask, cmask, h)
        E[k] = ehat[0]
        z = pdip_lanes(Hp_t, f, G0, T2T, rmask, lc["cmask2"], h2, s2_iters,
                       (z2, warm[1]), **plain)[0]
        return z[:nu], warm

    warm = (torch.zeros((n, B), **kw), torch.ones((mc, B), **kw))
    Y, U = step_loop(t, lc, r_l, dims, solve, warm, u_follow)
    return Y, U, E


_BAND_TABLES = ("Cpl", "Apl", "Bplu", "C", "Mk", "A", "Bu", "SxF", "SstF",
                "ThT", "Vt", "G0")
# the tables the kernel reads transposed (a thread per row of the product)
_BAND_TRANSPOSED = ("Cpl", "Apl", "C", "Mk", "A", "SxF")
_BAND_LANES = ("q", "hbu", "su", "hbyh", "rmyh", "hbyl", "rmyl", "rmask",
               "cmask", "cmask2", "lpd", "sfy", "sfu")
# argument order of the C launcher (ops/csrc/closed_sim_band.cu, enum BP_*)
_BAND_PTRS = _BAND_TABLES + _BAND_LANES + ("Hp", "r", "Y", "U", "E")
_BAND_DIMS = ("B", "nit", "lp_iters", "s2_iters", "ny", "nu", "nxa", "nxp",
              "pny", "n", "mc", "nmv")
BAND_MAX_N = 64  # = kBandMaxN of ops/csrc/closed_sim_band.cu
BAND_MAX_CLUSTER = 4  # = kBandMaxCluster
BAND_THREADS = 256  # = kBandThreads


def _band_bytes(C, n, mc, pny, ny, nu, nxa, nxp):
    """Shared memory of one block of a C-block cluster (band_plan_for):
    the factor tile, packed Hessian, 13 n-vectors, the estimator's
    vectors, reduction scratch, then per K-row (mc - pny of them, split
    over C) a tile row of n - 1 | 1 coefficients, 23 state values and an
    int, and the reduction buffer (also the step's free response and the
    K-row list)."""
    kcap = mc - pny
    kb = -(-kcap // C)
    nt = (n + 2) // 4
    tiles = nt * (nt + 1) // 2 + nt
    part = max(16 * max(tiles, BAND_THREADS), 2 * pny, kcap)
    el = (n * (n | 1) + n * (n + 1) // 2 + 13 * n
          + 2 * nxp + 2 * nxa + ny
          + 2 * nu + 8 * (BAND_THREADS // 32) + 8 + 8 + 4
          + kb * ((n - 1) | 1) + 4 + 23 * kb + (kb + 1) // 2 + part)
    return 8 * el


def band_plan(n, mc, pny, ny, nu, nxa, nxp):
    """(blocks a cluster, shared-memory bytes a block) of the band kernel
    (ops/csrc/closed_sim_band.cu, band_plan): the smallest cluster of 1, 2
    or 4 blocks per candidate whose block holds its slice of the K-rows in
    FACTOR_SMEM_MAX bytes; (0, the 4-block bytes) when none does."""
    for C in (1, 2, BAND_MAX_CLUSTER):
        b = _band_bytes(C, n, mc, pny, ny, nu, nxa, nxp)
        if b <= FACTOR_SMEM_MAX:
            return C, b
    return 0, _band_bytes(BAND_MAX_CLUSTER, n, mc, pny, ny, nu, nxa, nxp)


def band_envelope(G0, dims, pny, nxa=None, nxp=None):
    """The band kernel's envelope, checked before a launch: G0 laid out as
    [4 m nu move/input rows | p ny y_hi | p ny y_lo | slack], the y_lo rows
    the negated y_hi rows outside the slack column (true when every output
    has both bands or neither), n <= BAND_MAX_N variables and, given the
    estimator's sizes nxa and nxp, a cluster whose blocks fit
    (``band_plan``).  Raises ValueError outside it; returns the first band
    row."""
    n, mc, nu, m_max = dims["n"], dims["mc"], dims["nu"], dims["m_max"]
    nmv = 4 * m_max * nu
    if n > BAND_MAX_N:
        raise ValueError(f"band kernel: n = {n} variables, at most "
                         f"{BAND_MAX_N} (the factor's two rows a lane)")
    if mc != nmv + 2 * pny + 1 or tuple(G0.shape) != (mc, n):
        raise ValueError(f"band kernel: G0 {tuple(G0.shape)} is not laid out "
                         f"as {nmv} move/input rows, 2 x {pny} band rows and "
                         "a slack row")
    hi, lo = G0[nmv:nmv + pny, :-1], G0[nmv + pny:nmv + 2 * pny, :-1]
    if not torch.equal(lo, -hi):
        raise ValueError("band kernel: the y_lo rows of G0 are not the "
                         "negated y_hi rows (one-sided output bands)")
    if nxa is not None:
        C, b = band_plan(n, mc, pny, dims["ny"], nu, nxa, nxp)
        if not C:
            raise ValueError(
                f"band kernel: n = {n}, {mc - pny} K-rows need {b} bytes of "
                f"shared memory a block in a cluster of {BAND_MAX_CLUSTER}, "
                f"at most {FACTOR_SMEM_MAX}")
    return nmv


def launch_band(lib, tables, lane_consts, Hp_t, r_l, nit, lp_iters, s2_iters,
                dims):
    """One launch of the band kernel of ``lib`` (the port's library or a
    build of the same source); checks the inputs, returns (Y, U, E)."""
    from mpc_tuning_tpu_torch.ops.qp import (WS_EPS, pdip_constants,
                                             split_margins)

    t, lc = tables, lane_consts
    ny, nu, n, mc, m_max = (dims[k] for k in ("ny", "nu", "n", "mc", "m_max"))
    dtype = torch.float64
    B = r_l.shape[2]
    nxa, nxp = t["A"].shape[0], t["Apl"].shape[0]
    pny = t["SxF"].shape[0]
    nmv = band_envelope(t["G0"], dims, pny, nxa, nxp)
    shapes = {
        "Cpl": (ny, nxp), "Apl": (nxp, nxp), "Bplu": (nxp, nu), "C": (ny, nxa),
        "Mk": (nxa, ny), "A": (nxa, nxa), "Bu": (nxa, nu), "SxF": (pny, nxa),
        "SstF": (pny, nu), "ThT": (n, pny), "Vt": (ny + nxa + nxp + pny, nit),
        "G0": (mc, n)}
    for k, shp in shapes.items():
        _require(t[k], shp, dtype, k)
    rows = dict(q=pny, hbu=nmv, su=nmv, hbyh=pny, rmyh=pny, hbyl=pny,
                rmyl=pny, rmask=mc, cmask=n, cmask2=n, lpd=n, sfy=ny, sfu=nu)
    for k, nr in rows.items():
        _require(lc[k], (nr, B), dtype, k)
    _require(Hp_t, (n, n, B), dtype, "Hp")
    _require(r_l, (nit, ny, B), dtype, "r_l")
    rm = lc["rmask"]
    if not (bool(((rm == 0) | (rm == 1)).all())
            and torch.equal(rm[nmv:nmv + pny], rm[nmv + pny:nmv + 2 * pny])):
        raise ValueError("band kernel: rmask is not 0/1 with equal masks on "
                         "each y_hi / y_lo pair")
    if (lib.mpc_closed_sim_band_ptr_count() != len(_BAND_PTRS)
            or lib.mpc_closed_sim_band_dim_count() != len(_BAND_DIMS)
            or lib.mpc_closed_sim_band_max_n() != BAND_MAX_N):
        raise RuntimeError("closed_sim_band argument layout mismatch")
    dim_vals = dict(B=B, nit=nit, lp_iters=lp_iters, s2_iters=s2_iters, ny=ny,
                    nu=nu, nxa=nxa, nxp=nxp, pny=pny, n=n, mc=mc, nmv=nmv)
    dims_c = (ctypes.c_int * len(_BAND_DIMS))(*[dim_vals[k] for k in _BAND_DIMS])
    kw = dict(dtype=dtype, device=r_l.device)
    Y = torch.empty((nit, ny, B), **kw)
    U = torch.empty((nit, nu, B), **kw)
    E = torch.empty((nit, B), **kw)
    bufs = dict({k: t[k].T.contiguous() if k in _BAND_TRANSPOSED else t[k]
                 for k in _BAND_TABLES},
                Hp=Hp_t.permute(2, 0, 1).contiguous(), r=r_l, Y=Y, U=U, E=E)
    bufs.update({k: lc[k].T.contiguous() for k in _BAND_LANES})
    for k, v in bufs.items():
        if v.device != r_l.device:
            raise ValueError(f"{k}: on {v.device}, expected {r_l.device}")
    ptrs = (ctypes.c_void_p * len(_BAND_PTRS))(
        *[bufs[k].data_ptr() if bufs[k].numel() else None for k in _BAND_PTRS])
    ridge, w_cap = pdip_constants(dtype)
    m_rel, m_abs = split_margins(dtype)
    scal_c = (ctypes.c_double * 5)(WS_EPS, ridge, w_cap, m_rel, m_abs)
    with _device_of(r_l):
        _build.check(lib.mpc_closed_sim_band(ptrs, dims_c, scal_c,
                                             _stream(r_l)), "closed_sim_band")
    return Y, U, E


def closed_sim_band(tables, lane_consts, Hp_t, r_l, nit, lp_iters, s2_iters,
                    dims):
    """Whole band closed loop: per step the slack seeding, an `lp_iters`
    stage-0 slack LP and an `s2_iters` slack-frozen stage-2 PDIP against
    the per-lane Hessians Hp_t (n, n, B).  Returns (Y, U, E), E (nit, B)
    each step's frozen ECR slack ehat.  Float64 only: float32 band loops
    leave the hard input bounds (PERF.md), so float32 inputs raise; raises
    outside ``band_envelope``."""
    if r_l.dtype != torch.float64:
        raise ValueError(f"closed_sim_band runs at float64 only, got "
                         f"{r_l.dtype}: float32 band loops leave the hard "
                         "input bounds")
    if _on_cpu(r_l, Hp_t):
        return closed_sim_band_plain(tables, lane_consts, Hp_t, r_l, nit,
                                     lp_iters, s2_iters, dims)
    out = launch_band(_build.library(), tables, lane_consts, Hp_t, r_l, nit,
                      lp_iters, s2_iters, dims)
    closed_sim_band.launches += 1
    return out


closed_sim_band.launches = 0

# ------------------------------------------------------------ nmpc_rollout
#
# Not a TPU kernel: it replaces what XLA fuses on the TPU, the NMPC
# prediction rollout and its sensitivities (the JAX package's
# sim/nmpc_loop._rollout_y under jax.jacfwd, and the explicit NMPC's y_of,
# sim/explicit_nmpc.py).  ``model`` is an NMPCSpec or an ExplicitNMPC
# (anything with rhs, integrator, substeps, Ts and xc).  For B candidates
# at state x (B, nx) with previous input u_prev (B, nu), moves du (B, m nu)
# and the move mask cmask, per column (B, m nu) or per step (B, m) (spread
# over the inputs, ``models/ode.column_mask``), the input at prediction
# step k is u_prev plus, per input i, the sum over t <= min(k, m - 1, hold)
# of cmask[t nu + i] du[t nu + i] (held after the control horizon; ``hold``
# (B,) int32, or None for m - 1), and the rollout integrates p sample
# intervals.  Returns Y (B, p ny), the states ``outputs`` (default
# model.xc) after each interval, and with ``jac`` J (B, p ny, m nu) = dY /
# d du, the exact derivative of the discrete map.  The same call is the
# closed loop's plant step (m = 0, p = 1, every state as an output) and
# the open leg's playback (p = nit - 1, ``hold`` the last active move).
# The CUDA kernel (ops/csrc/nmpc.cu) runs with jac one block a candidate:
# a producer warp steps the primal and hands each substep's stage states
# and partials through a shared-memory ring to the consumer warps, one
# tangent column a lane; without jac one warp a candidate.  It steps the
# model's integrator, RK4 or TR-BDF2 (a template parameter, chosen by the
# dims slot after the outputs).  The plain version and the kernel's
# envelope (the models and integrators it covers) live beside the models:
# ``models/ode.nmpc_rollout_plain`` / ``nmpc_envelope``.  The design it
# replaced, one thread per (candidate, column), stays as
# ops/csrc/reference/nmpc_rollout_thread_per_column.cu
# (``nmpc_rollout_thread_per_column``).

# the columns one block carries: 31 consumer warps beside the producer
NMPC_MAX_COLUMNS = 31 * 32


def _rollout_launch(entry, model, x, u_prev, du, cmask, p, hold, jac,
                    outputs):
    """Check the rollout's arguments and launch ``entry`` (a C function
    with mpc_nmpc_rollout's arguments) on them: (Y, J or None)."""
    nmpc_envelope(model)
    dtype = _float_dtype(x)
    B, nx = x.shape
    nu = u_prev.shape[1]
    m = du.shape[1] // nu
    out = list(model.xc if outputs is None else outputs)
    if (nx, nu) != (3, 2) or not 1 <= len(out) <= 3 \
            or not all(0 <= o < nx for o in out):
        raise ValueError(f"nmpc_rollout kernel: x (B, 3), u (B, 2) and 1-3 "
                         f"state outputs, got nx={nx} nu={nu} outputs={out}")
    if jac and (m == 0 or hold is not None):
        raise ValueError("nmpc_rollout: jac needs moves (m > 0) and no hold")
    if jac and m * nu > NMPC_MAX_COLUMNS:
        raise ValueError(f"nmpc_rollout kernel: {m * nu} tangent columns, "
                         f"at most {NMPC_MAX_COLUMNS}")
    cmask = column_mask(cmask, m, nu)
    _require(x, (B, nx), dtype, "x")
    _require(u_prev, (B, nu), dtype, "u_prev")
    _require(du, (B, m * nu), dtype, "du")
    _require(cmask, (B, m * nu), dtype, "cmask")
    if hold is not None:
        _require(hold, (B,), torch.int32, "hold")
        if hold.device != x.device:
            raise ValueError(f"hold: on {hold.device}, expected {x.device}")
    ny = len(out)
    kw = dict(dtype=dtype, device=x.device)
    Y = torch.empty((B, p * ny), **kw)
    J = torch.empty((B, p * ny, m * nu), **kw) if jac else None
    ptrs = (ctypes.c_void_p * 7)(*[
        t.data_ptr() if t is not None and t.numel() else None
        for t in (x, u_prev, du, cmask, hold, Y, J)])
    dims = (ctypes.c_int * 10)(B, p, m, model.substeps, int(jac), ny,
                               *(out + [0] * (3 - ny)),
                               NMPC_INTEGRATORS.index(model.integrator))
    with _device_of(x):
        _build.check(entry(int(dtype == torch.float64), ptrs, dims,
                           ctypes.c_double(model.Ts), _stream(x)),
                     "nmpc_rollout")
    return Y, J


def nmpc_rollout(model, x, u_prev, du, cmask, p, hold=None, jac=False,
                 outputs=None):
    """See the section note: (Y (B, p ny), J (B, p ny, m nu) or None)."""
    if _on_cpu(x, u_prev, du, cmask):
        return nmpc_rollout_plain(model, x, u_prev, du, cmask, p, hold, jac,
                                  outputs)
    out = _rollout_launch(_build.library().mpc_nmpc_rollout, model, x,
                          u_prev, du, cmask, p, hold, jac, outputs)
    nmpc_rollout.launches += 1
    return out


nmpc_rollout.launches = 0


def nmpc_rollout_thread_per_column(model, x, u_prev, du, cmask, p, hold=None,
                                   jac=False, outputs=None):
    """``nmpc_rollout`` by the one-thread-per-(candidate, column) design it
    replaced (ops/csrc/reference/nmpc_rollout_thread_per_column.cu, built
    on demand into its own library), its reference: CUDA tensors only, not
    counted, on no path of the port."""
    return _rollout_launch(
        _build.reference_library().mpc_nmpc_rollout_thread_per_column, model,
        x, u_prev, du, cmask, p, hold, jac, outputs)


_WRAPPERS = (spd_factor, spd_factor_solve, spd_solve, factor_lanes,
             solve_lanes, pdip_fused, admm_fused, closed_sim_admm,
             closed_sim_pdip, closed_sim_band, nmpc_rollout, lane_sum)


def reset_launches():
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}
