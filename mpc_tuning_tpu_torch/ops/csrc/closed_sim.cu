// Whole closed-loop simulation kernels: the counterparts of the Pallas
// kernels _closed_sim_admm_kernel and _closed_sim_pdip_kernel
// (mpc_tuning_tpu/ops/pallas_kernels.py, closed_sim_admm_lanes and
// closed_sim_pdip_lanes).  One warp runs one candidate lane through all nit
// steps: plant output -> Kalman update -> free response -> QP data -> warm
// QP solve -> input update -> model and plant step, streaming Y and U.
//
// What bounds them on an H100: each lane is a long serial chain of small
// dependent loops (nit x iters x a few hundred to a few thousand
// multiply-adds), and the tunes launch them at B = 2 to ~141 lanes, so
// time is set by the latency of that chain, not by device memory bytes or
// FLOP/s.  The design shortens the chain:
//  * one warp per lane, W = SimShape<T>::kW lanes a block (4 at float, 2 at
//    double, so that the W values of one lane-major element are 16
//    contiguous bytes), grid ceil(B / W); a warp past B exits at once (no
//    block-wide barrier follows);
//  * the lane's loop state, its QP vectors and its n x n matrices (Minv or
//    Hp, and the PDIP's normal matrix) live in its warp's share of shared
//    memory (SimLayout); its per-lane constants, lane-major (rows, B) in
//    device memory (a stride-B access each), are staged there once per
//    launch through cp.async;
//  * each step's and each QP iteration's work is spread over rows and
//    columns (warp_qp.cuh), so a phase is one dot product deep; the PDIP
//    factors with the warp-per-matrix Cholesky of the SPD factor kernels
//    (warp_factor.cuh) and solves row-parallel with the right-hand side in
//    registers;
//  * the shared tables stay in device memory, read through L1/L2.
// Each dot keeps the one-thread kernels' order of operations, so the ADMM
// kernel computes what the one-thread kernel computed; the PDIP's
// reductions and back substitution round differently.  Padding to the
// TPU's (8, 128) tiles is dropped throughout: padded rows were exact no-ops
// there.  Envelope (ops/kernels.sim_envelope holds the same arithmetic):
// n <= 64 (two rows a lane in the factor) and W SimLayout::total elements
// of shared memory a block, at most kFactorSmemMax.

#include "warp_qp.cuh"

namespace mpc {

template <typename T>
struct SimShape {
  static constexpr int kW = sizeof(T) == 8 ? 2 : 4;
};

template <typename T>
struct SimArgs {
  // shared tables, row-major
  const T* __restrict__ Cpl;   // (ny, nxp)
  const T* __restrict__ Apl;   // (nxp, nxp)
  const T* __restrict__ Bplu;  // (nxp, nu)
  const T* __restrict__ C;     // (ny, nxa)
  const T* __restrict__ Mk;    // (nxa, ny)
  const T* __restrict__ A;     // (nxa, nxa)
  const T* __restrict__ Bu;    // (nxa, nu)
  const T* __restrict__ SxF;   // (pny, nxa)
  const T* __restrict__ SstF;  // (pny, nu)
  const T* __restrict__ ThT;   // (n, pny)
  const T* __restrict__ Vt;    // (ny + nxa + nxp + pny, nit)
  GSparse<T> g;                // G0 (mc, n); its entry terms PDIP only
  // per-lane, lane-major (rows, B)
  const T* __restrict__ r;      // (nit, ny, B) setpoints / sf_y
  const T* __restrict__ q;      // (pny, B)
  const T* __restrict__ hbase;  // (mc, B)
  const T* __restrict__ su;     // (mc, B)
  const T* __restrict__ rowm;   // (mc, B) rmask (PDIP) | e * rmask (ADMM)
  const T* __restrict__ colm;   // (n, B) cmask (PDIP) | Dinv * cmask (ADMM)
  const T* __restrict__ Dinv;   // (n, B) ADMM only
  const T* __restrict__ e;      // (mc, B) ADMM only
  const T* __restrict__ par;    // (2, B) ADMM only: rho, 1 / rho
  const T* __restrict__ sfy;    // (ny, B)
  const T* __restrict__ sfu;    // (nu, B)
  const T* __restrict__ Hm;     // (n, n, B) Hp (PDIP) | Minv (ADMM)
  T* __restrict__ Y;            // (nit, ny, B)
  T* __restrict__ U;            // (nit, nu, B)
  int B, nit, iters, ny, nu, nxa, nxp, pny, n, mc, m_max;
  T c0, c1, c2;  // ADMM: sigma, over_relax | PDIP: eps_c, ridge, w_cap
};

// Offsets (in elements of T) of one lane's vectors in its warp's share of
// shared memory, `total` elements in all: the loop state, the staged
// per-lane constants, then the engine's QP vectors and tiles (n x n at row
// stride factor_ld(n)).
struct SimLayout {
  size_t xpl, xpl2, xhp, xhat, up, ys, uo, err;
  size_t rowm, colm, hbase, su, q, sfy, sfu, Hm;
  size_t Dinv, e, x, rhs, fs, zc, y, hs;                   // ADMM
  size_t z, bz, rd, dz, f, lam, s, blam, rp, w, t, ds, dl, h, L;  // PDIP
  size_t total;
  __host__ __device__ SimLayout(bool pdip, int ny, int nu, int nxa, int nxp,
                                int pny, int n, int mc) {
    const size_t nn = (size_t)n * factor_ld(n);
    size_t o = 0;
    xpl = o; o += nxp;
    xpl2 = o; o += nxp;
    xhp = o; o += nxa;
    xhat = o; o += nxa;
    up = o; o += nu;
    ys = o; o += ny;
    uo = o; o += nu;
    err = o; o += pny;
    rowm = o; o += mc;
    colm = o; o += n;
    hbase = o; o += mc;
    su = o; o += mc;
    q = o; o += pny;
    sfy = o; o += ny;
    sfu = o; o += nu;
    Hm = o; o += nn;
    Dinv = e = x = rhs = fs = zc = y = hs = o;
    z = bz = rd = dz = f = lam = s = blam = rp = w = t = ds = dl = h = L = o;
    if (pdip) {
      z = o; o += n;
      bz = o; o += n;
      rd = o; o += n;
      dz = o; o += n;
      f = o; o += n;
      lam = o; o += mc;
      s = o; o += mc;
      blam = o; o += mc;
      rp = o; o += mc;
      w = o; o += mc;
      t = o; o += mc;
      ds = o; o += mc;
      dl = o; o += mc;
      h = o; o += mc;
      L = o; o += nn;
    } else {
      Dinv = o; o += n;
      e = o; o += mc;
      x = o; o += n;
      rhs = o; o += n;
      fs = o; o += n;
      zc = o; o += mc;
      y = o; o += mc;
      hs = o; o += mc;
    }
    total = o;
  }
};

// The lane's loop state and staged constants in shared memory.
template <typename T>
struct Loop {
  T *xpl, *xpl2, *xhp, *xhat, *up, *ys, *uo, *err;
  T *rowm, *colm, *hbase, *su, *q, *sfy, *sfu, *Hm;
};

template <typename T>
__device__ void stage_rows(T* dst, const T* src, int rows, int B, int b,
                           int ln) {
  for (int i = ln; i < rows; i += 32)
    cp_async(dst + i, src + (size_t)i * B + b);
}

// Lane b's shared-memory view: the loop state zeroed, the constants staged
// (Hm into a tile at row stride factor_ld(n)).  The caller waits for the
// copies (cp_async_wait, __syncwarp).
template <typename T>
__device__ Loop<T> loop_state(const SimArgs<T>& a, const SimLayout& lay,
                              T* sm, int b, int ln) {
  Loop<T> v;
  v.xpl = sm + lay.xpl; v.xpl2 = sm + lay.xpl2; v.xhp = sm + lay.xhp;
  v.xhat = sm + lay.xhat; v.up = sm + lay.up; v.ys = sm + lay.ys;
  v.uo = sm + lay.uo; v.err = sm + lay.err; v.rowm = sm + lay.rowm;
  v.colm = sm + lay.colm; v.hbase = sm + lay.hbase; v.su = sm + lay.su;
  v.q = sm + lay.q; v.sfy = sm + lay.sfy; v.sfu = sm + lay.sfu;
  v.Hm = sm + lay.Hm;
  const int B = a.B, n = a.n, ld = factor_ld(n);
  stage_rows(v.rowm, a.rowm, a.mc, B, b, ln);
  stage_rows(v.colm, a.colm, n, B, b, ln);
  stage_rows(v.hbase, a.hbase, a.mc, B, b, ln);
  stage_rows(v.su, a.su, a.mc, B, b, ln);
  stage_rows(v.q, a.q, a.pny, B, b, ln);
  stage_rows(v.sfy, a.sfy, a.ny, B, b, ln);
  stage_rows(v.sfu, a.sfu, a.nu, B, b, ln);
  for (int el = ln; el < n * n; el += 32) {
    const int i = el / n;
    cp_async(v.Hm + i * ld + (el - i * n), a.Hm + (size_t)el * B + b);
  }
  for (int i = ln; i < a.nxp; i += 32) v.xpl[i] = T(0);
  for (int i = ln; i < a.nxa; i += 32) v.xhp[i] = T(0);
  for (int i = ln; i < a.nu; i += 32) v.up[i] = T(0);
  return v;
}

// Plant output (streamed to Y[k]), Kalman update into xhat, free response
// and the weighted tracking error err = q * (r_k - free); one lane a row.
template <typename T>
__device__ void pre_step(const SimArgs<T>& a, int k, int b, int ln,
                         const Loop<T>& v) {
  const int B = a.B, nit = a.nit;
  for (int i = ln; i < a.ny; i += 32) {
    T y = T(0);
    for (int j = 0; j < a.nxp; ++j) y += a.Cpl[i * a.nxp + j] * v.xpl[j];
    a.Y[((size_t)k * a.ny + i) * B + b] = y;
    const T ys = y / v.sfy[i];
    T c = T(0);  // innovation, in place of y_s
    for (int j = 0; j < a.nxa; ++j) c += a.C[i * a.nxa + j] * v.xhp[j];
    v.ys[i] = ys - c - a.Vt[(size_t)i * nit + k];
  }
  __syncwarp();
  for (int i = ln; i < a.nxa; i += 32) {
    T m = T(0);
    for (int j = 0; j < a.ny; ++j) m += a.Mk[i * a.ny + j] * v.ys[j];
    v.xhat[i] = v.xhp[i] + m;
  }
  __syncwarp();
  const size_t sv_row = (size_t)a.ny + a.nxa + a.nxp;
  for (int p = ln; p < a.pny; p += 32) {
    T f1 = T(0);
#pragma unroll 8
    for (int j = 0; j < a.nxa; ++j) f1 += a.SxF[p * a.nxa + j] * v.xhat[j];
    T f2 = T(0);
    for (int j = 0; j < a.nu; ++j) f2 += a.SstF[p * a.nu + j] * v.up[j];
    const T fr = f1 + f2 + a.Vt[(sv_row + p) * nit + k];
    const T rk = a.r[((size_t)k * a.ny + p % a.ny) * B + b];
    v.err[p] = v.q[p] * (rk - fr);
  }
  __syncwarp();
}

// f_i = -2 (Theta' Q e)_i, before masking or scaling.
template <typename T>
__device__ __forceinline__ T lin_term(const SimArgs<T>& a, int i,
                                      const Loop<T>& v) {
  T acc = T(0);
#pragma unroll 8
  for (int p = 0; p < a.pny; ++p) acc += a.ThT[i * a.pny + p] * v.err[p];
  return T(-2) * acc;
}

// Constraint rhs h_r = hbase_r + su_r * u_prev (u rows only).
template <typename T>
__device__ __forceinline__ T rhs_row(const SimArgs<T>& a, int r,
                                     const Loop<T>& v) {
  const int nmv = 4 * a.m_max * a.nu;
  const T ut = r < nmv ? v.up[r % a.nu] : T(0);
  return v.hbase[r] + v.su[r] * ut;
}

// up holds u_s on entry (lane j wrote up[j]): stream U[k], step the model
// and the plant (into xpl2, then swap).
template <typename T>
__device__ void post_step(const SimArgs<T>& a, int k, int b, int ln,
                          Loop<T>& v) {
  const int nit = a.nit;
  for (int j = ln; j < a.nu; j += 32) {
    const T uo = v.up[j] * v.sfu[j];
    v.uo[j] = uo;
    a.U[((size_t)k * a.nu + j) * a.B + b] = uo;
  }
  __syncwarp();
  for (int i = ln; i < a.nxa; i += 32) {
    T x1 = T(0);
#pragma unroll 8
    for (int j = 0; j < a.nxa; ++j) x1 += a.A[i * a.nxa + j] * v.xhat[j];
    T x2 = T(0);
    for (int j = 0; j < a.nu; ++j) x2 += a.Bu[i * a.nu + j] * v.up[j];
    v.xhp[i] = x1 + x2 + a.Vt[((size_t)a.ny + i) * nit + k];
  }
  const size_t bpl_row = (size_t)a.ny + a.nxa;
  for (int i = ln; i < a.nxp; i += 32) {
    T x1 = T(0);
#pragma unroll 8
    for (int j = 0; j < a.nxp; ++j) x1 += a.Apl[i * a.nxp + j] * v.xpl[j];
    T x2 = T(0);
    for (int j = 0; j < a.nu; ++j) x2 += a.Bplu[i * a.nu + j] * v.uo[j];
    v.xpl2[i] = x1 + x2 + a.Vt[(bpl_row + i) * nit + k];
  }
  __syncwarp();
  T* next = v.xpl2;
  v.xpl2 = v.xpl;
  v.xpl = next;
}

// ----------------------------------------------------------------- ADMM

template <typename T>
__global__ void __launch_bounds__(32 * SimShape<T>::kW)
    closed_sim_admm_kernel(const __grid_constant__ SimArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wi = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const int b = blockIdx.x * SimShape<T>::kW + wi;
  if (b >= a.B) return;
  const int B = a.B, n = a.n, mc = a.mc;
  const SimLayout lay(false, a.ny, a.nu, a.nxa, a.nxp, a.pny, n, mc);
  T* sm = reinterpret_cast<T*>(smem_raw) + (size_t)wi * lay.total;
  Loop<T> st = loop_state(a, lay, sm, b, ln);
  T* Dinv = sm + lay.Dinv;
  T* ev = sm + lay.e;
  stage_rows(Dinv, a.Dinv, n, B, b, ln);
  stage_rows(ev, a.e, mc, B, b, ln);
  WarpAdmm<T> v;
  T* fs = sm + lay.fs;
  T* hs = sm + lay.hs;
  v.fs = fs;
  v.hs = hs;
  v.arow = st.rowm;
  v.acol = st.colm;
  v.Minv = st.Hm;
  v.x = sm + lay.x;
  v.zc = sm + lay.zc;
  v.y = sm + lay.y;
  v.rhs = sm + lay.rhs;
  v.rho = a.par[b];
  v.rho_inv = a.par[(size_t)B + b];
  v.ld = factor_ld(n);
  for (int i = ln; i < n; i += 32) v.x[i] = T(0);
  for (int r = ln; r < mc; r += 32) { v.zc[r] = T(0); v.y[r] = T(0); }
  cp_async_wait();
  __syncwarp();

  for (int k = 0; k < a.nit; ++k) {
    pre_step(a, k, b, ln, st);
    for (int i = ln; i < n; i += 32) fs[i] = lin_term(a, i, st) * Dinv[i];
    for (int r = ln; r < mc; r += 32) hs[r] = rhs_row(a, r, st) * ev[r];
    warp_admm(a.g, v, n, mc, a.iters, a.c0, a.c1, ln);
    for (int j = ln; j < a.nu; j += 32)
      st.up[j] = st.up[j] + v.x[j] * Dinv[j];
    post_step(a, k, b, ln, st);
  }
}

// ----------------------------------------------------------------- PDIP

template <typename T, int R>
__global__ void __launch_bounds__(32 * SimShape<T>::kW)
    closed_sim_pdip_kernel(const __grid_constant__ SimArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wi = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const int b = blockIdx.x * SimShape<T>::kW + wi;
  if (b >= a.B) return;
  const int n = a.n, mc = a.mc;
  const SimLayout lay(true, a.ny, a.nu, a.nxa, a.nxp, a.pny, n, mc);
  T* sm = reinterpret_cast<T*>(smem_raw) + (size_t)wi * lay.total;
  Loop<T> st = loop_state(a, lay, sm, b, ln);
  WarpPdip<T> v;
  T* f = sm + lay.f;
  T* h = sm + lay.h;
  v.f = f;
  v.h = h;
  v.rmask = st.rowm;
  v.cmask = st.colm;
  v.H = st.Hm;
  v.z = sm + lay.z;
  v.lam = sm + lay.lam;
  v.s = sm + lay.s;
  v.bz = sm + lay.bz;
  v.rd = sm + lay.rd;
  v.dz = sm + lay.dz;
  v.blam = sm + lay.blam;
  v.rp = sm + lay.rp;
  v.w = sm + lay.w;
  v.t = sm + lay.t;
  v.ds = sm + lay.ds;
  v.dl = sm + lay.dl;
  v.L = sm + lay.L;
  v.ld = factor_ld(n);
  // warm pair (z, lam) carried across steps: z = 0, lam = 1 initially
  for (int i = ln; i < n; i += 32) v.z[i] = T(0);
  for (int r = ln; r < mc; r += 32) v.lam[r] = T(1);
  cp_async_wait();
  __syncwarp();
  T nact = T(0);
  for (int r = ln; r < mc; r += 32) nact += st.rowm[r];
  v.nact = nmax(warp_sum(nact), T(1));

  for (int k = 0; k < a.nit; ++k) {
    pre_step(a, k, b, ln, st);
    for (int i = ln; i < n; i += 32) f[i] = st.colm[i] * lin_term(a, i, st);
    for (int r = ln; r < mc; r += 32) h[r] = rhs_row(a, r, st);
    warp_pdip<T, R>(a.g, v, n, mc, a.iters, a.c0, a.c1, a.c2, ln);
    for (int j = ln; j < a.nu; j += 32) st.up[j] = st.up[j] + v.z[j];
    post_step(a, k, b, ln, st);
  }
}

// ----------------------------------------------------------------- launch

enum {
  P_CPL, P_APL, P_BPLU, P_C, P_MK, P_A, P_BU, P_SXF, P_SSTF, P_THT, P_VT,
  P_GPTR, P_GCOL, P_GVAL, P_GTPTR, P_GTROW, P_GTVAL, P_EPTR, P_EROW, P_ECOEF,
  P_R, P_Q, P_HBASE, P_SU, P_ROWM, P_COLM, P_DINV, P_E, P_PAR, P_SFY, P_SFU,
  P_HM, P_Y, P_U, P_COUNT
};

enum { D_B, D_NIT, D_ITERS, D_NY, D_NU, D_NXA, D_NXP, D_PNY, D_N, D_MC,
       D_MMAX, D_COUNT };

template <typename T>
SimArgs<T> make_args(void* const* p, const int* d, const double* c) {
  SimArgs<T> a;
  a.Cpl = static_cast<const T*>(p[P_CPL]);
  a.Apl = static_cast<const T*>(p[P_APL]);
  a.Bplu = static_cast<const T*>(p[P_BPLU]);
  a.C = static_cast<const T*>(p[P_C]);
  a.Mk = static_cast<const T*>(p[P_MK]);
  a.A = static_cast<const T*>(p[P_A]);
  a.Bu = static_cast<const T*>(p[P_BU]);
  a.SxF = static_cast<const T*>(p[P_SXF]);
  a.SstF = static_cast<const T*>(p[P_SSTF]);
  a.ThT = static_cast<const T*>(p[P_THT]);
  a.Vt = static_cast<const T*>(p[P_VT]);
  a.g = GSparse<T>{static_cast<const int*>(p[P_GPTR]),
                   static_cast<const int*>(p[P_GCOL]),
                   static_cast<const T*>(p[P_GVAL]),
                   static_cast<const int*>(p[P_GTPTR]),
                   static_cast<const int*>(p[P_GTROW]),
                   static_cast<const T*>(p[P_GTVAL]),
                   static_cast<const int*>(p[P_EPTR]),
                   static_cast<const int*>(p[P_EROW]),
                   static_cast<const T*>(p[P_ECOEF])};
  a.r = static_cast<const T*>(p[P_R]);
  a.q = static_cast<const T*>(p[P_Q]);
  a.hbase = static_cast<const T*>(p[P_HBASE]);
  a.su = static_cast<const T*>(p[P_SU]);
  a.rowm = static_cast<const T*>(p[P_ROWM]);
  a.colm = static_cast<const T*>(p[P_COLM]);
  a.Dinv = static_cast<const T*>(p[P_DINV]);
  a.e = static_cast<const T*>(p[P_E]);
  a.par = static_cast<const T*>(p[P_PAR]);
  a.sfy = static_cast<const T*>(p[P_SFY]);
  a.sfu = static_cast<const T*>(p[P_SFU]);
  a.Hm = static_cast<const T*>(p[P_HM]);
  a.Y = static_cast<T*>(p[P_Y]);
  a.U = static_cast<T*>(p[P_U]);
  a.B = d[D_B];
  a.nit = d[D_NIT];
  a.iters = d[D_ITERS];
  a.ny = d[D_NY];
  a.nu = d[D_NU];
  a.nxa = d[D_NXA];
  a.nxp = d[D_NXP];
  a.pny = d[D_PNY];
  a.n = d[D_N];
  a.mc = d[D_MC];
  a.m_max = d[D_MMAX];
  a.c0 = static_cast<T>(c[0]);
  a.c1 = static_cast<T>(c[1]);
  a.c2 = static_cast<T>(c[2]);
  return a;
}

namespace {
// The dynamic shared memory each kernel (engine, dtype, rows a lane) is
// allowed on each device so far: above 48 KB a block's has to be allowed,
// once a kernel and device, for the most any launch has needed.  Internal
// linkage, so two libraries loaded in one process keep their own.
constexpr int kMaxDevices = 64;
int g_sim_smem[2][2][kFactorMaxRows][kMaxDevices];
}  // namespace

// The kernel's entry of g_sim_smem on the current device when `smem` bytes
// have yet to be allowed there, else nullptr (in `slot`).
cudaError_t smem_slot(int (&per_device)[kMaxDevices], int smem, int*& slot) {
  slot = nullptr;
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > per_device[dev]) slot = &per_device[dev];
  return cudaSuccess;
}

template <typename T, int R>
int launch_pdip(const SimArgs<T>& a, int blocks, int smem, cudaStream_t st) {
  int* slot;
  cudaError_t e = smem_slot(g_sim_smem[1][sizeof(T) == 8][R - 1], smem, slot);
  if (e == cudaSuccess && slot)
    e = cudaFuncSetAttribute(closed_sim_pdip_kernel<T, R>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return (int)e;
  if (slot) *slot = smem;
  closed_sim_pdip_kernel<T, R>
      <<<blocks, 32 * SimShape<T>::kW, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_admm(const SimArgs<T>& a, int blocks, int smem, cudaStream_t st) {
  int* slot;
  cudaError_t e = smem_slot(g_sim_smem[0][sizeof(T) == 8][0], smem, slot);
  if (e == cudaSuccess && slot)
    e = cudaFuncSetAttribute(closed_sim_admm_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return (int)e;
  if (slot) *slot = smem;
  closed_sim_admm_kernel<T><<<blocks, 32 * SimShape<T>::kW, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sim(bool pdip, void* const* p, const int* d, const double* c,
               cudaStream_t st) {
  constexpr int W = SimShape<T>::kW;
  const SimArgs<T> a = make_args<T>(p, d, c);
  const SimLayout lay(pdip, a.ny, a.nu, a.nxa, a.nxp, a.pny, a.n, a.mc);
  const long long smem = (long long)W * lay.total * sizeof(T);
  if (a.n < 1 || a.n > 32 * kFactorMaxRows || smem > kFactorSmemMax)
    return (int)cudaErrorInvalidValue;
  const int blocks = (a.B + W - 1) / W;
  if (!pdip) return launch_admm<T>(a, blocks, (int)smem, st);
  return a.n <= 32 ? launch_pdip<T, 1>(a, blocks, (int)smem, st)
                   : launch_pdip<T, 2>(a, blocks, (int)smem, st);
}

}  // namespace mpc

extern "C" {

int mpc_closed_sim_ptr_count() { return mpc::P_COUNT; }

int mpc_closed_sim_dim_count() { return mpc::D_COUNT; }

// Refuses (cudaErrorInvalidValue, nothing launched) outside the envelope.
int mpc_closed_sim(int pdip, int is_f64, void* const* ptrs, const int* dims,
                   const double* scal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? mpc::launch_sim<double>(pdip != 0, ptrs, dims, scal, st)
                : mpc::launch_sim<float>(pdip != 0, ptrs, dims, scal, st);
}

}  // extern "C"
