// Whole closed-loop simulation kernels: the counterparts of the Pallas
// kernels _closed_sim_admm_kernel and _closed_sim_pdip_kernel
// (mpc_tuning_tpu/ops/pallas_kernels.py, closed_sim_admm_lanes and
// closed_sim_pdip_lanes).  One thread runs one candidate lane through all
// nit steps: plant output -> Kalman update -> free response -> QP data ->
// warm QP solve -> input update -> model and plant step, streaming Y and U.
//
// What bounds them on an H100: each lane is a long serial chain of small
// dependent loops (nit x iters x a few thousand multiply-adds), so time is
// set by instruction latency per thread and by how many lanes are in
// flight, not by device memory bandwidth or FLOP/s.  The design therefore
//  * keeps every per-lane vector in a lane-major scratch buffer
//    (row * B + lane), so each load of a warp is one coalesced line that
//    stays in L1/L2;
//  * reads the shared tables through uniform (broadcast) loads;
//  * solves each step's QP with the per-lane device code of lane_qp.cuh,
//    which the single-solve kernels (qp_fused.cu) share: CSR visits of the
//    shared constraint matrix G0's nonzeros in place of the TPU's T2T;
//  * runs 32 threads per block so that a batch spreads over many SMs.
// Padding to the TPU's (8, 128) tiles is dropped throughout: padded rows
// were exact no-ops there.

#include "lane_qp.cuh"

namespace mpc {

constexpr int kSimThreads = 32;

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
  Csr<T> g;                    // G0 (mc, n) by rows and by columns
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
  T* __restrict__ work;         // (Offsets::rows, B)
  int B, nit, iters, ny, nu, nxa, nxp, pny, n, mc, m_max;
  T c0, c1, c2;  // ADMM: sigma, over_relax | PDIP: eps_c, ridge, w_cap
};

// Row offsets of the per-lane scratch vectors.
struct Offsets {
  size_t xpl, xpl2, xhp, xhat, uprev, ys, uo, err, f, h, rhs, dz;
  size_t z, lam, s;                                 // ADMM: x, zc, y
  size_t bz, rd, blam, rp, w, t, ds, dl, dsa, dla, L;  // PDIP only
  size_t rows;
  __host__ __device__ Offsets(int ny, int nu, int nxa, int nxp, int pny,
                              int n, int mc, bool pdip) {
    size_t o = 0;
    xpl = o; o += nxp;
    xpl2 = o; o += nxp;
    xhp = o; o += nxa;
    xhat = o; o += nxa;
    uprev = o; o += nu;
    ys = o; o += ny;
    uo = o; o += nu;
    err = o; o += pny;
    f = o; o += n;
    h = o; o += mc;
    rhs = o; o += n;
    dz = o; o += n;
    z = o; o += n;
    lam = o; o += mc;
    s = o; o += mc;
    bz = rd = blam = rp = w = t = ds = dl = dsa = dla = L = o;
    if (pdip) {
      bz = o; o += n;
      rd = o; o += n;
      blam = o; o += mc;
      rp = o; o += mc;
      w = o; o += mc;
      t = o; o += mc;
      ds = o; o += mc;
      dl = o; o += mc;
      dsa = o; o += mc;
      dla = o; o += mc;
      L = o; o += (size_t)n * n;
    }
    rows = o;
  }
};

template <typename T>
struct LoopState {
  Lane<T> xpl, xpl2, xhp, xhat, uprev, ys, uo, err;
};

template <typename T>
__device__ LoopState<T> loop_state(const SimArgs<T>& a, const Offsets& o,
                                   int lane) {
  LoopState<T> st;
  st.xpl = lane_at(a.work, o.xpl, a.B, lane);
  st.xpl2 = lane_at(a.work, o.xpl2, a.B, lane);
  st.xhp = lane_at(a.work, o.xhp, a.B, lane);
  st.xhat = lane_at(a.work, o.xhat, a.B, lane);
  st.uprev = lane_at(a.work, o.uprev, a.B, lane);
  st.ys = lane_at(a.work, o.ys, a.B, lane);
  st.uo = lane_at(a.work, o.uo, a.B, lane);
  st.err = lane_at(a.work, o.err, a.B, lane);
  for (int i = 0; i < a.nxp; ++i) st.xpl[i] = T(0);
  for (int i = 0; i < a.nxa; ++i) st.xhp[i] = T(0);
  for (int i = 0; i < a.nu; ++i) st.uprev[i] = T(0);
  return st;
}

// Plant output (streamed to Y[k]), Kalman update into xhat, free response
// and the weighted tracking error err = q * (r_k - free).
template <typename T>
__device__ void pre_step(const SimArgs<T>& a, int k, int lane,
                         const LoopState<T>& st) {
  const int B = a.B;
  const CLane<T> sfy = clane_at(a.sfy, B, lane);
  const CLane<T> q = clane_at(a.q, B, lane);
  for (int i = 0; i < a.ny; ++i) {
    T y = T(0);
    for (int j = 0; j < a.nxp; ++j) y += a.Cpl[i * a.nxp + j] * st.xpl[j];
    a.Y[((size_t)k * a.ny + i) * B + lane] = y;
    st.ys[i] = y / sfy[i];
  }
  for (int i = 0; i < a.ny; ++i) {  // innovation, in place of y_s
    T c = T(0);
    for (int j = 0; j < a.nxa; ++j) c += a.C[i * a.nxa + j] * st.xhp[j];
    st.ys[i] = st.ys[i] - c - a.Vt[(size_t)i * a.nit + k];
  }
  for (int i = 0; i < a.nxa; ++i) {
    T m = T(0);
    for (int j = 0; j < a.ny; ++j) m += a.Mk[i * a.ny + j] * st.ys[j];
    st.xhat[i] = st.xhp[i] + m;
  }
  const size_t sv_row = (size_t)a.ny + a.nxa + a.nxp;
  for (int p = 0; p < a.pny; ++p) {
    T f1 = T(0);
    for (int j = 0; j < a.nxa; ++j) f1 += a.SxF[p * a.nxa + j] * st.xhat[j];
    T f2 = T(0);
    for (int j = 0; j < a.nu; ++j) f2 += a.SstF[p * a.nu + j] * st.uprev[j];
    const T fr = f1 + f2 + a.Vt[(sv_row + p) * a.nit + k];
    const T rk = a.r[((size_t)k * a.ny + p % a.ny) * B + lane];
    st.err[p] = q[p] * (rk - fr);
  }
}

// f_i = -2 (Theta' Q e)_i, before masking or scaling.
template <typename T>
__device__ __forceinline__ T lin_term(const SimArgs<T>& a, int i,
                                      const LoopState<T>& st) {
  T acc = T(0);
  for (int p = 0; p < a.pny; ++p) acc += a.ThT[i * a.pny + p] * st.err[p];
  return T(-2) * acc;
}

// Constraint rhs h_r = hbase_r + su_r * u_prev (u rows only).
template <typename T>
__device__ __forceinline__ T rhs_row(const SimArgs<T>& a, int r, int lane,
                                     const LoopState<T>& st) {
  const int nmv = 4 * a.m_max * a.nu;
  const T ut = r < nmv ? st.uprev[r % a.nu] : T(0);
  const size_t idx = (size_t)r * a.B + lane;
  return a.hbase[idx] + a.su[idx] * ut;
}

// uprev holds u_s on entry: stream U[k], step the model and the plant.
template <typename T>
__device__ void post_step(const SimArgs<T>& a, int k, int lane,
                          const LoopState<T>& st) {
  const int B = a.B;
  const CLane<T> sfu = clane_at(a.sfu, B, lane);
  for (int j = 0; j < a.nu; ++j) {
    const T uo = st.uprev[j] * sfu[j];
    st.uo[j] = uo;
    a.U[((size_t)k * a.nu + j) * B + lane] = uo;
  }
  for (int i = 0; i < a.nxa; ++i) {
    T x1 = T(0);
    for (int j = 0; j < a.nxa; ++j) x1 += a.A[i * a.nxa + j] * st.xhat[j];
    T x2 = T(0);
    for (int j = 0; j < a.nu; ++j) x2 += a.Bu[i * a.nu + j] * st.uprev[j];
    st.xhp[i] = x1 + x2 + a.Vt[((size_t)a.ny + i) * a.nit + k];
  }
  const size_t bpl_row = (size_t)a.ny + a.nxa;
  for (int i = 0; i < a.nxp; ++i) {
    T x1 = T(0);
    for (int j = 0; j < a.nxp; ++j) x1 += a.Apl[i * a.nxp + j] * st.xpl[j];
    T x2 = T(0);
    for (int j = 0; j < a.nu; ++j) x2 += a.Bplu[i * a.nu + j] * st.uo[j];
    st.xpl2[i] = x1 + x2 + a.Vt[(bpl_row + i) * a.nit + k];
  }
  for (int i = 0; i < a.nxp; ++i) st.xpl[i] = st.xpl2[i];
}

// ----------------------------------------------------------------- ADMM

template <typename T>
__global__ void __launch_bounds__(kSimThreads)
closed_sim_admm_kernel(const SimArgs<T> a) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.B) return;
  const int B = a.B, n = a.n, mc = a.mc;
  const Offsets o(a.ny, a.nu, a.nxa, a.nxp, a.pny, n, mc, false);
  const LoopState<T> st = loop_state(a, o, lane);
  AdmmLane<T> v;
  v.fs = lane_at(a.work, o.f, B, lane);
  v.hs = lane_at(a.work, o.h, B, lane);
  v.rhs = lane_at(a.work, o.rhs, B, lane);
  v.x = lane_at(a.work, o.z, B, lane);
  v.zc = lane_at(a.work, o.lam, B, lane);
  v.y = lane_at(a.work, o.s, B, lane);
  v.arow = clane_at(a.rowm, B, lane);
  v.acol = clane_at(a.colm, B, lane);
  v.Minv = clane_at(a.Hm, B, lane);
  v.rho = a.par[lane];
  v.rho_inv = a.par[(size_t)B + lane];
  const CLane<T> Dinv = clane_at(a.Dinv, B, lane);
  const CLane<T> ev = clane_at(a.e, B, lane);
  for (int i = 0; i < n; ++i) v.x[i] = T(0);
  for (int r = 0; r < mc; ++r) { v.zc[r] = T(0); v.y[r] = T(0); }

  for (int k = 0; k < a.nit; ++k) {
    pre_step(a, k, lane, st);
    for (int i = 0; i < n; ++i) v.fs[i] = lin_term(a, i, st) * Dinv[i];
    for (int r = 0; r < mc; ++r) v.hs[r] = rhs_row(a, r, lane, st) * ev[r];
    admm_iterations(a.g, v, n, mc, a.iters, a.c0, a.c1);
    for (int j = 0; j < a.nu; ++j) st.uprev[j] = st.uprev[j] + v.x[j] * Dinv[j];
    post_step(a, k, lane, st);
  }
}

// ----------------------------------------------------------------- PDIP

template <typename T>
__global__ void __launch_bounds__(kSimThreads)
closed_sim_pdip_kernel(const SimArgs<T> a) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.B) return;
  const int B = a.B, n = a.n, mc = a.mc;
  const Offsets o(a.ny, a.nu, a.nxa, a.nxp, a.pny, n, mc, true);
  const LoopState<T> st = loop_state(a, o, lane);
  PdipLane<T> v;
  v.f = lane_at(a.work, o.f, B, lane);
  v.h = lane_at(a.work, o.h, B, lane);
  v.rhs = lane_at(a.work, o.rhs, B, lane);
  v.dz = lane_at(a.work, o.dz, B, lane);
  v.z = lane_at(a.work, o.z, B, lane);
  v.lam = lane_at(a.work, o.lam, B, lane);
  v.s = lane_at(a.work, o.s, B, lane);
  v.bz = lane_at(a.work, o.bz, B, lane);
  v.rd = lane_at(a.work, o.rd, B, lane);
  v.blam = lane_at(a.work, o.blam, B, lane);
  v.bs = Lane<T>{nullptr, B};  // s is recomputed at every step
  v.rp = lane_at(a.work, o.rp, B, lane);
  v.w = lane_at(a.work, o.w, B, lane);
  v.t = lane_at(a.work, o.t, B, lane);
  v.ds = lane_at(a.work, o.ds, B, lane);
  v.dl = lane_at(a.work, o.dl, B, lane);
  v.dsa = lane_at(a.work, o.dsa, B, lane);
  v.dla = lane_at(a.work, o.dla, B, lane);
  v.L = lane_at(a.work, o.L, B, lane);
  v.rmask = clane_at(a.rowm, B, lane);
  v.cmask = clane_at(a.colm, B, lane);
  v.H = clane_at(a.Hm, B, lane);

  // warm pair (z, lam) carried across steps: z = 0, lam = 1 initially
  for (int i = 0; i < n; ++i) v.z[i] = T(0);
  for (int r = 0; r < mc; ++r) v.lam[r] = T(1);

  for (int k = 0; k < a.nit; ++k) {
    pre_step(a, k, lane, st);
    for (int i = 0; i < n; ++i) v.f[i] = v.cmask[i] * lin_term(a, i, st);
    for (int r = 0; r < mc; ++r) v.h[r] = rhs_row(a, r, lane, st);
    pdip_solve(a.g, v, n, mc, a.iters, a.c0, a.c1, a.c2);
    for (int j = 0; j < a.nu; ++j) st.uprev[j] = st.uprev[j] + v.z[j];
    post_step(a, k, lane, st);
  }
}

// ----------------------------------------------------------------- launch

enum {
  P_CPL, P_APL, P_BPLU, P_C, P_MK, P_A, P_BU, P_SXF, P_SSTF, P_THT, P_VT,
  P_GPTR, P_GCOL, P_GVAL, P_GTPTR, P_GTROW, P_GTVAL,
  P_R, P_Q, P_HBASE, P_SU, P_ROWM, P_COLM, P_DINV, P_E, P_PAR, P_SFY, P_SFU,
  P_HM, P_Y, P_U, P_WORK, P_COUNT
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
  a.g = Csr<T>{static_cast<const int*>(p[P_GPTR]),
               static_cast<const int*>(p[P_GCOL]),
               static_cast<const T*>(p[P_GVAL]),
               static_cast<const int*>(p[P_GTPTR]),
               static_cast<const int*>(p[P_GTROW]),
               static_cast<const T*>(p[P_GTVAL])};
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
  a.work = static_cast<T*>(p[P_WORK]);
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

template <typename T>
int launch_sim(bool pdip, void* const* p, const int* d, const double* c,
               cudaStream_t st) {
  const SimArgs<T> a = make_args<T>(p, d, c);
  const int blocks = (a.B + kSimThreads - 1) / kSimThreads;
  if (pdip)
    closed_sim_pdip_kernel<T><<<blocks, kSimThreads, 0, st>>>(a);
  else
    closed_sim_admm_kernel<T><<<blocks, kSimThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace mpc

extern "C" {

int mpc_closed_sim_ptr_count() { return mpc::P_COUNT; }

int mpc_closed_sim_dim_count() { return mpc::D_COUNT; }

// Rows of the lane-major scratch buffer the wrapper allocates (rows * B).
long long mpc_closed_sim_work_rows(int pdip, const int* d) {
  const mpc::Offsets o(d[mpc::D_NY], d[mpc::D_NU], d[mpc::D_NXA],
                       d[mpc::D_NXP], d[mpc::D_PNY], d[mpc::D_N],
                       d[mpc::D_MC], pdip != 0);
  return (long long)o.rows;
}

int mpc_closed_sim(int pdip, int is_f64, void* const* ptrs, const int* dims,
                   const double* scal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? mpc::launch_sim<double>(pdip != 0, ptrs, dims, scal, st)
                : mpc::launch_sim<float>(pdip != 0, ptrs, dims, scal, st);
}

}  // extern "C"
