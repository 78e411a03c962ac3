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
//  * visits only the structural nonzeros of the shared constraint matrix
//    G0 (CSR by rows and by columns, built by the wrapper): G products and
//    the normal matrix G'WG cost O(nnz) and O(sum of squared row nnz)
//    instead of the dense O(mc n) and O(mc n^2) of the TPU's T2T table;
//  * runs 32 threads per block so that a batch spreads over many SMs.
// Padding to the TPU's (8, 128) tiles is dropped throughout: padded rows
// were exact no-ops there.

#include "common.cuh"

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
  const int* __restrict__ g_ptr;   // G0 by rows: (mc + 1)
  const int* __restrict__ g_col;
  const T* __restrict__ g_val;
  const int* __restrict__ gt_ptr;  // G0 by columns: (n + 1)
  const int* __restrict__ gt_row;
  const T* __restrict__ gt_val;
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

// (G x)_r = rowm_r * sum_j G0[r, j] colm_j x_j over the nonzeros of row r.
template <typename T, typename V>
__device__ __forceinline__ T g_row(const SimArgs<T>& a, int r,
                                   const CLane<T>& rowm, const CLane<T>& colm,
                                   const V& x) {
  T acc = T(0);
  for (int p = a.g_ptr[r]; p < a.g_ptr[r + 1]; ++p) {
    const int j = a.g_col[p];
    acc += a.g_val[p] * (colm[j] * x[j]);
  }
  return rowm[r] * acc;
}

// (G' y)_i = colm_i * sum_r G0[r, i] y_r over the nonzeros of column i
// (y already multiplied by rowm).
template <typename T, typename V>
__device__ __forceinline__ T gt_col(const SimArgs<T>& a, int i,
                                    const CLane<T>& colm, const V& y) {
  T acc = T(0);
  for (int p = a.gt_ptr[i]; p < a.gt_ptr[i + 1]; ++p)
    acc += a.gt_val[p] * y[a.gt_row[p]];
  return colm[i] * acc;
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
  const Lane<T> fs = lane_at(a.work, o.f, B, lane);
  const Lane<T> hs = lane_at(a.work, o.h, B, lane);
  const Lane<T> rhs = lane_at(a.work, o.rhs, B, lane);
  const Lane<T> x = lane_at(a.work, o.z, B, lane);
  const Lane<T> zc = lane_at(a.work, o.lam, B, lane);
  const Lane<T> y = lane_at(a.work, o.s, B, lane);
  const CLane<T> arow = clane_at(a.rowm, B, lane);
  const CLane<T> acol = clane_at(a.colm, B, lane);
  const CLane<T> Dinv = clane_at(a.Dinv, B, lane);
  const CLane<T> ev = clane_at(a.e, B, lane);
  const CLane<T> Minv = clane_at(a.Hm, B, lane);
  const T rho = a.par[lane];
  const T rho_inv = a.par[(size_t)B + lane];
  const T sigma = a.c0, alpha = a.c1;
  for (int i = 0; i < n; ++i) x[i] = T(0);
  for (int r = 0; r < mc; ++r) { zc[r] = T(0); y[r] = T(0); }

  for (int k = 0; k < a.nit; ++k) {
    pre_step(a, k, lane, st);
    for (int i = 0; i < n; ++i) fs[i] = lin_term(a, i, st) * Dinv[i];
    for (int r = 0; r < mc; ++r) hs[r] = rhs_row(a, r, lane, st) * ev[r];

    for (int it = 0; it < a.iters; ++it) {
      // rhs = sigma x - fs + Gs'(rho zc - y)
      for (int i = 0; i < n; ++i) {
        T acc = T(0);
        for (int p = a.gt_ptr[i]; p < a.gt_ptr[i + 1]; ++p) {
          const int rr = a.gt_row[p];
          acc += a.gt_val[p] * (arow[rr] * (rho * zc[rr] - y[rr]));
        }
        rhs[i] = sigma * x[i] - fs[i] + acol[i] * acc;
      }
      for (int i = 0; i < n; ++i) {  // x = Minv rhs
        T acc = T(0);
        for (int j = 0; j < n; ++j) acc += Minv[i * n + j] * rhs[j];
        x[i] = acc;
      }
      for (int r = 0; r < mc; ++r) {
        const T gx = g_row(a, r, arow, acol, x);
        const T gxr = alpha * gx + (T(1) - alpha) * zc[r];
        const T zn = nmin(gxr + y[r] * rho_inv, hs[r]);
        y[r] = y[r] + rho * (gxr - zn);
        zc[r] = zn;
      }
    }
    for (int j = 0; j < a.nu; ++j) st.uprev[j] = st.uprev[j] + x[j] * Dinv[j];
    post_step(a, k, lane, st);
  }
}

// ----------------------------------------------------------------- PDIP

template <typename T>
struct PdipLane {
  Lane<T> f, h, rhs, dz, z, lam, s, bz, rd, blam, rp, w, t, ds, dl, dsa, dla,
      L;
  CLane<T> rmask, cmask, H;
};

// Residuals r_d = H z + f + G' lam, r_p = G z + s - h; returns the merit
// ||r_d|| + ||r_p|| + lam's and the gap lam's.
template <typename T>
__device__ T pdip_residuals(const SimArgs<T>& a, const PdipLane<T>& v,
                            T& gap) {
  const int n = a.n, mc = a.mc;
  for (int r = 0; r < mc; ++r) v.t[r] = v.rmask[r] * v.lam[r];
  T nd = T(0);
  for (int i = 0; i < n; ++i) {
    T hz = T(0);
    for (int j = 0; j < n; ++j) hz += v.H[i * n + j] * v.z[j];
    const T rd = hz + v.f[i] + gt_col(a, i, v.cmask, v.t);
    v.rd[i] = rd;
    nd += rd * rd;
  }
  T np = T(0), g = T(0);
  for (int r = 0; r < mc; ++r) {
    const T rp = g_row(a, r, v.rmask, v.cmask, v.z) + v.s[r] - v.h[r];
    v.rp[r] = rp;
    np += rp * rp;
    g += v.lam[r] * v.s[r];
  }
  gap = g;
  return sqrt(nd) + sqrt(np) + g;
}

template <typename T>
__device__ __forceinline__ T max_step(const Lane<T>& x, const Lane<T>& dx,
                                      int m) {
  const T inf = inf_value<T>();
  T mn = inf;
  for (int r = 0; r < m; ++r) {
    const T ratio = dx[r] < T(0) ? -x[r] / dx[r] : inf;
    mn = nmin(mn, ratio);
  }
  return nmin(T(1), T(0.995) * mn);
}

// L L' x = rhs by forward and back substitution (x may not alias rhs).
template <typename T>
__device__ void chol_solve(const Lane<T>& L, const Lane<T>& rhs,
                           const Lane<T>& x, int n) {
  for (int i = 0; i < n; ++i) {
    T v = rhs[i];
    for (int k = 0; k < i; ++k) v -= L[i * n + k] * x[k];
    x[i] = v / L[i * n + i];
  }
  for (int i = n - 1; i >= 0; --i) {
    T v = x[i];
    for (int k = i + 1; k < n; ++k) v -= L[k * n + i] * x[k];
    x[i] = v / L[i * n + i];
  }
}

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
  const T eps_c = a.c0, ridge = a.c1, w_cap = a.c2;

  T nact = T(0);
  for (int r = 0; r < mc; ++r) nact += v.rmask[r];
  nact = nmax(nact, T(1));
  // warm pair (z, lam) carried across steps: z = 0, lam = 1 initially
  for (int i = 0; i < n; ++i) v.z[i] = T(0);
  for (int r = 0; r < mc; ++r) v.lam[r] = T(1);

  for (int k = 0; k < a.nit; ++k) {
    pre_step(a, k, lane, st);
    for (int i = 0; i < n; ++i) v.f[i] = v.cmask[i] * lin_term(a, i, st);
    for (int r = 0; r < mc; ++r) v.h[r] = rhs_row(a, r, lane, st);

    // warm start: re-centre the carried pair; s from this step's h
    for (int r = 0; r < mc; ++r) v.lam[r] = nmax(v.lam[r], eps_c) * v.rmask[r];
    for (int r = 0; r < mc; ++r)
      v.s[r] = nmax(v.h[r] - g_row(a, r, v.rmask, v.cmask, v.z), eps_c);
    for (int i = 0; i < n; ++i) v.bz[i] = v.z[i];
    for (int r = 0; r < mc; ++r) v.blam[r] = v.lam[r];
    T bm = inf_value<T>();

    for (int it = 0; it < a.iters; ++it) {
      T gap;
      const T mnew = pdip_residuals(a, v, gap);
      const T mu = gap / nact;
      if (mnew < bm) {  // NaN never wins
        for (int i = 0; i < n; ++i) v.bz[i] = v.z[i];
        for (int r = 0; r < mc; ++r) v.blam[r] = v.lam[r];
        bm = mnew;
      }
      for (int r = 0; r < mc; ++r)
        v.w[r] = nmin(v.lam[r] / v.s[r], w_cap) * v.rmask[r];

      // normal matrix H + (G0' W G0) o cc + ridge I, lower triangle
      for (int i = 0; i < n; ++i)
        for (int j = 0; j <= i; ++j) v.L[i * n + j] = T(0);
      for (int r = 0; r < mc; ++r) {
        const T wr = v.w[r];
        for (int p = a.g_ptr[r]; p < a.g_ptr[r + 1]; ++p) {
          const int ca = a.g_col[p];
          const T ga = a.g_val[p] * v.cmask[ca];
          for (int qq = a.g_ptr[r]; qq <= p; ++qq) {
            const int cb = a.g_col[qq];
            v.L[ca * n + cb] += wr * (ga * (a.g_val[qq] * v.cmask[cb]));
          }
        }
      }
      for (int i = 0; i < n; ++i) {
        for (int j = 0; j < i; ++j)
          v.L[i * n + j] = v.H[i * n + j] + v.L[i * n + j];
        v.L[i * n + i] = v.H[i * n + i] + v.L[i * n + i] + ridge;
      }
      // Cholesky in place (lower)
      for (int j = 0; j < n; ++j) {
        T d = v.L[j * n + j];
        for (int kk = 0; kk < j; ++kk) d -= v.L[j * n + kk] * v.L[j * n + kk];
        const T ljj = sqrt(d);
        v.L[j * n + j] = ljj;
        for (int i = j + 1; i < n; ++i) {
          T x = v.L[i * n + j];
          for (int kk = 0; kk < j; ++kk) x -= v.L[i * n + kk] * v.L[j * n + kk];
          v.L[i * n + j] = x / ljj;
        }
      }

      // predictor
      for (int r = 0; r < mc; ++r)
        v.t[r] = v.rmask[r] * (v.lam[r] - v.w[r] * v.rp[r]);
      for (int i = 0; i < n; ++i)
        v.rhs[i] = -v.rd[i] + gt_col(a, i, v.cmask, v.t);
      chol_solve(v.L, v.rhs, v.dz, n);
      for (int r = 0; r < mc; ++r) {
        v.dsa[r] = -(v.rp[r] + g_row(a, r, v.rmask, v.cmask, v.dz));
        v.dla[r] = -(v.lam[r] * v.s[r] + v.lam[r] * v.dsa[r]) / v.s[r] *
                   v.rmask[r];
      }
      const T a_aff = nmin(max_step(v.s, v.dsa, mc), max_step(v.lam, v.dla, mc));
      T mu_aff = T(0);
      for (int r = 0; r < mc; ++r)
        mu_aff += (v.lam[r] + a_aff * v.dla[r]) * (v.s[r] + a_aff * v.dsa[r]);
      mu_aff = mu_aff / nact;
      const T sig_r = mu_aff / (mu + T(1e-30));
      const T sigma = sig_r * sig_r * sig_r;

      // corrector; r_cent overwrites dla
      for (int r = 0; r < mc; ++r) {
        const T rc = (v.lam[r] * v.s[r] - sigma * mu + v.dla[r] * v.dsa[r]) *
                     v.rmask[r];
        v.dla[r] = rc;
        v.t[r] = v.rmask[r] * (rc / v.s[r] - v.w[r] * v.rp[r]);
      }
      for (int i = 0; i < n; ++i)
        v.rhs[i] = -v.rd[i] + gt_col(a, i, v.cmask, v.t);
      chol_solve(v.L, v.rhs, v.dz, n);
      for (int r = 0; r < mc; ++r) {
        v.ds[r] = -(v.rp[r] + g_row(a, r, v.rmask, v.cmask, v.dz));
        v.dl[r] = -(v.dla[r] + v.lam[r] * v.ds[r]) / v.s[r] * v.rmask[r];
      }
      const T step = nmin(max_step(v.s, v.ds, mc), max_step(v.lam, v.dl, mc));
      for (int i = 0; i < n; ++i) v.z[i] = v.z[i] + step * v.dz[i];
      for (int r = 0; r < mc; ++r) {
        v.lam[r] = v.lam[r] + step * v.dl[r];
        v.s[r] = v.s[r] + step * v.ds[r];
      }
    }
    T gap;
    const T mlast = pdip_residuals(a, v, gap);
    if (!(mlast < bm)) {  // keep the best iterate as the warm pair
      for (int i = 0; i < n; ++i) v.z[i] = v.bz[i];
      for (int r = 0; r < mc; ++r) v.lam[r] = v.blam[r];
    }
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
  a.g_ptr = static_cast<const int*>(p[P_GPTR]);
  a.g_col = static_cast<const int*>(p[P_GCOL]);
  a.g_val = static_cast<const T*>(p[P_GVAL]);
  a.gt_ptr = static_cast<const int*>(p[P_GTPTR]);
  a.gt_row = static_cast<const int*>(p[P_GTROW]);
  a.gt_val = static_cast<const T*>(p[P_GTVAL]);
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
