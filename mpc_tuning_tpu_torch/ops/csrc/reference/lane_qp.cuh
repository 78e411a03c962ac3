// Per-lane QP device code of the one-thread-per-lane designs that the
// warp-per-lane single-solve kernels (qp_fused.cu: pdip_fused, admm_fused)
// replaced, kept for their references (pdip_fused_one_thread.cu,
// admm_fused_one_thread.cu beside this file): one thread solves one
// candidate lane's masked MPC QP
//
//     min 1/2 z'Hz + f'z   s.t.  G z <= h,   G = diag(rmask) G0 diag(cmask)
//
// by a warm-started Mehrotra PDIP (pdip_solve) or warm equilibrated ADMM
// iterations (admm_iterations).  Per-lane vectors are lane-major (common.cuh);
// the shared G0 is visited through its structural nonzeros only (CSR by rows
// and by columns, built by the wrapper): G products and the normal matrix
// G'WG cost O(nnz) and O(sum of squared row nnz) instead of the dense
// O(mc n) and O(mc n^2) of the TPU kernels' T2T table.
#pragma once

#include "../common.cuh"

namespace mpc {

// The shared constraint matrix G0 (mc, n) as CSR by rows (ptr, col, val)
// and by columns (tptr, trow, tval).
template <typename T>
struct Csr {
  const int* __restrict__ ptr;
  const int* __restrict__ col;
  const T* __restrict__ val;
  const int* __restrict__ tptr;
  const int* __restrict__ trow;
  const T* __restrict__ tval;
};

// (G x)_r = rowm_r * sum_j G0[r, j] colm_j x_j over the nonzeros of row r.
template <typename T, typename V>
__device__ __forceinline__ T g_row(const Csr<T>& g, int r,
                                   const CLane<T>& rowm, const CLane<T>& colm,
                                   const V& x) {
  T acc = T(0);
  for (int p = g.ptr[r]; p < g.ptr[r + 1]; ++p) {
    const int j = g.col[p];
    acc += g.val[p] * (colm[j] * x[j]);
  }
  return rowm[r] * acc;
}

// (G' y)_i = colm_i * sum_r G0[r, i] y_r over the nonzeros of column i
// (y already multiplied by rowm).
template <typename T, typename V>
__device__ __forceinline__ T gt_col(const Csr<T>& g, int i,
                                    const CLane<T>& colm, const V& y) {
  T acc = T(0);
  for (int p = g.tptr[i]; p < g.tptr[i + 1]; ++p)
    acc += g.tval[p] * y[g.trow[p]];
  return colm[i] * acc;
}

// ----------------------------------------------------------------- ADMM
//
// Equilibrated ADMM against the lane's Minv = (Hs + sigma I + rho Gs'Gs)^-1
// with Gs = diag(arow) G0 diag(acol), in scaled coordinates.  fs and hs are
// only read (Lane, not CLane: the whole-sim kernel writes them between
// steps through the same pointers).

template <typename T>
struct AdmmLane {
  Lane<T> fs, hs;             // (n), (mc) scaled linear term and rhs
  CLane<T> arow, acol, Minv;  // (mc), (n), (n, n)
  Lane<T> x, zc, y, rhs;      // state (n), (mc), (mc); scratch (n)
  T rho, rho_inv;
};

template <typename T>
__device__ void admm_iterations(const Csr<T>& g, const AdmmLane<T>& v, int n,
                                int mc, int iters, T sigma, T alpha) {
  for (int it = 0; it < iters; ++it) {
    // rhs = sigma x - fs + Gs'(rho zc - y)
    for (int i = 0; i < n; ++i) {
      T acc = T(0);
      for (int p = g.tptr[i]; p < g.tptr[i + 1]; ++p) {
        const int rr = g.trow[p];
        acc += g.tval[p] * (v.arow[rr] * (v.rho * v.zc[rr] - v.y[rr]));
      }
      v.rhs[i] = sigma * v.x[i] - v.fs[i] + v.acol[i] * acc;
    }
    for (int i = 0; i < n; ++i) {  // x = Minv rhs
      T acc = T(0);
      for (int j = 0; j < n; ++j) acc += v.Minv[i * n + j] * v.rhs[j];
      v.x[i] = acc;
    }
    for (int r = 0; r < mc; ++r) {
      const T gx = g_row(g, r, v.arow, v.acol, v.x);
      const T gxr = alpha * gx + (T(1) - alpha) * v.zc[r];
      const T zn = nmin(gxr + v.y[r] * v.rho_inv, v.hs[r]);
      v.y[r] = v.y[r] + v.rho * (gxr - zn);
      v.zc[r] = zn;
    }
  }
}

// ----------------------------------------------------------------- PDIP

template <typename T>
struct PdipLane {
  Lane<T> f, h;  // (n), (mc): only read (see AdmmLane)
  CLane<T> rmask, cmask, H;
  // z, lam, s: the warm pair on entry (s is recomputed), the best iterate
  // on exit; bs.p == nullptr: the best slack is not kept (s then holds the
  // last iterate, which the whole-sim kernel never reads)
  Lane<T> z, lam, s;
  Lane<T> rhs, dz, bz, rd, blam, bs, rp, w, t, ds, dl, dsa, dla, L;
};

// Residuals r_d = H z + f + G' lam, r_p = G z + s - h; returns the merit
// ||r_d|| + ||r_p|| + lam's and the gap lam's.
template <typename T>
__device__ T pdip_residuals(const Csr<T>& g, const PdipLane<T>& v, int n,
                            int mc, T& gap) {
  for (int r = 0; r < mc; ++r) v.t[r] = v.rmask[r] * v.lam[r];
  T nd = T(0);
  for (int i = 0; i < n; ++i) {
    T hz = T(0);
    for (int j = 0; j < n; ++j) hz += v.H[i * n + j] * v.z[j];
    const T rd = hz + v.f[i] + gt_col(g, i, v.cmask, v.t);
    v.rd[i] = rd;
    nd += rd * rd;
  }
  T np = T(0), gs = T(0);
  for (int r = 0; r < mc; ++r) {
    const T rp = g_row(g, r, v.rmask, v.cmask, v.z) + v.s[r] - v.h[r];
    v.rp[r] = rp;
    np += rp * rp;
    gs += v.lam[r] * v.s[r];
  }
  gap = gs;
  return sqrt(nd) + sqrt(np) + gs;
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

// `iters` warm-started masked Mehrotra iterations from (z, lam); leaves the
// best iterate by merit in (z, lam) (and s when bs is kept).  Masked rows
// are exact no-ops: their duals stay zero and mu normalises by the active
// row count.
template <typename T>
__device__ void pdip_solve(const Csr<T>& g, const PdipLane<T>& v, int n,
                           int mc, int iters, T eps_c, T ridge, T w_cap) {
  const bool keep_s = v.bs.p != nullptr;
  T nact = T(0);
  for (int r = 0; r < mc; ++r) nact += v.rmask[r];
  nact = nmax(nact, T(1));

  // warm start: re-centre the carried pair; s from this step's h
  for (int r = 0; r < mc; ++r) v.lam[r] = nmax(v.lam[r], eps_c) * v.rmask[r];
  for (int r = 0; r < mc; ++r)
    v.s[r] = nmax(v.h[r] - g_row(g, r, v.rmask, v.cmask, v.z), eps_c);
  for (int i = 0; i < n; ++i) v.bz[i] = v.z[i];
  for (int r = 0; r < mc; ++r) v.blam[r] = v.lam[r];
  if (keep_s)
    for (int r = 0; r < mc; ++r) v.bs[r] = v.s[r];
  T bm = inf_value<T>();

  for (int it = 0; it < iters; ++it) {
    T gap;
    const T mnew = pdip_residuals(g, v, n, mc, gap);
    const T mu = gap / nact;
    if (mnew < bm) {  // NaN never wins
      for (int i = 0; i < n; ++i) v.bz[i] = v.z[i];
      for (int r = 0; r < mc; ++r) v.blam[r] = v.lam[r];
      if (keep_s)
        for (int r = 0; r < mc; ++r) v.bs[r] = v.s[r];
      bm = mnew;
    }
    for (int r = 0; r < mc; ++r)
      v.w[r] = nmin(v.lam[r] / v.s[r], w_cap) * v.rmask[r];

    // normal matrix H + (G0' W G0) o cc + ridge I, lower triangle
    for (int i = 0; i < n; ++i)
      for (int j = 0; j <= i; ++j) v.L[i * n + j] = T(0);
    for (int r = 0; r < mc; ++r) {
      const T wr = v.w[r];
      for (int p = g.ptr[r]; p < g.ptr[r + 1]; ++p) {
        const int ca = g.col[p];
        const T ga = g.val[p] * v.cmask[ca];
        for (int qq = g.ptr[r]; qq <= p; ++qq) {
          const int cb = g.col[qq];
          v.L[ca * n + cb] += wr * (ga * (g.val[qq] * v.cmask[cb]));
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
      v.rhs[i] = -v.rd[i] + gt_col(g, i, v.cmask, v.t);
    chol_solve(v.L, v.rhs, v.dz, n);
    for (int r = 0; r < mc; ++r) {
      v.dsa[r] = -(v.rp[r] + g_row(g, r, v.rmask, v.cmask, v.dz));
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
      v.rhs[i] = -v.rd[i] + gt_col(g, i, v.cmask, v.t);
    chol_solve(v.L, v.rhs, v.dz, n);
    for (int r = 0; r < mc; ++r) {
      v.ds[r] = -(v.rp[r] + g_row(g, r, v.rmask, v.cmask, v.dz));
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
  const T mlast = pdip_residuals(g, v, n, mc, gap);
  if (!(mlast < bm)) {  // the best iterate
    for (int i = 0; i < n; ++i) v.z[i] = v.bz[i];
    for (int r = 0; r < mc; ++r) v.lam[r] = v.blam[r];
    if (keep_s)
      for (int r = 0; r < mc; ++r) v.s[r] = v.bs[r];
  }
}

}  // namespace mpc
