// Per-lane QP device code of the whole-sim kernels (closed_sim.cu) and of
// the single-solve kernels (qp_fused.cu: admm_fused, pdip_fused), one warp
// per candidate lane: the lane's masked MPC QP
//
//     min 1/2 z'Hz + f'z   s.t.  G z <= h,   G = diag(rmask) G0 diag(cmask)
//
// by warm equilibrated ADMM iterations (warp_admm) or a warm-started masked
// Mehrotra PDIP (warp_pdip).  The lane's vectors and its n x n matrices
// (tiles at the odd row stride factor_ld(n)) live in its warp's share of
// shared memory; the shared G0 is read from device memory through its
// structural nonzeros: CSR by rows and by columns and, for the PDIP's
// normal matrix, the list of G0[r,a] G0[r,b] terms of each lower entry
// (a, b), all built by the wrapper.
//
// Work is spread over rows and columns, not over the terms of one dot:
// lane l owns the rows r = l, l + 32, ... of every mc-vector and the
// columns i = l, l + 32, ... of every n-vector, and forms each of its
// dots alone, in the order of the one-thread code (reference/lane_qp.cuh).
// A vector
// a lane writes is read by another lane only after a __syncwarp().  The
// ADMM iteration is therefore the one-thread iteration's arithmetic; the
// PDIP's scalar reductions (merit norms, gap, mu_aff, active rows) run a
// fixed shuffle tree, the same on every lane, and its back substitution
// goes right-looking, so the PDIP rounds differently.
#pragma once

#include "warp_factor.cuh"

namespace mpc {

constexpr unsigned kWarpMask = 0xffffffffu;

// Butterfly sum: every lane ends with the same bits (each pairing is one
// commutative addition).
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kWarpMask, v, o);
  return v;
}

// The warp's nmin (a NaN wins, as jnp.min), lane 0's on every lane.
template <typename T>
__device__ __forceinline__ T warp_nmin(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = nmin(v, __shfl_xor_sync(kWarpMask, v, o));
  return __shfl_sync(kWarpMask, v, 0);
}

// The shared constraint matrix G0 (mc, n): CSR by rows (ptr, col, val), by
// columns (tptr, trow, tval) and, PDIP only, per lower entry e = a (a + 1)
// / 2 + b of the normal matrix its rows r (ascending) and G0[r,a] G0[r,b]
// (eptr, erow, ecoef).
template <typename T>
struct GSparse {
  const int* __restrict__ ptr;
  const int* __restrict__ col;
  const T* __restrict__ val;
  const int* __restrict__ tptr;
  const int* __restrict__ trow;
  const T* __restrict__ tval;
  const int* __restrict__ eptr;
  const int* __restrict__ erow;
  const T* __restrict__ ecoef;
};

// (G x)_r = rowm_r * sum_j G0[r, j] colm_j x_j over the nonzeros of row r.
template <typename T>
__device__ __forceinline__ T g_row(const GSparse<T>& g, int r, const T* rowm,
                                   const T* colm, const T* x) {
  T acc = T(0);
#pragma unroll 4
  for (int p = g.ptr[r]; p < g.ptr[r + 1]; ++p) {
    const int j = g.col[p];
    acc += g.val[p] * (colm[j] * x[j]);
  }
  return rowm[r] * acc;
}

// (G' y)_i = colm_i * sum_r G0[r, i] y_r (y already multiplied by rowm).
template <typename T>
__device__ __forceinline__ T gt_col(const GSparse<T>& g, int i,
                                    const T* colm, const T* y) {
  T acc = T(0);
#pragma unroll 4
  for (int p = g.tptr[i]; p < g.tptr[i + 1]; ++p)
    acc += g.tval[p] * y[g.trow[p]];
  return colm[i] * acc;
}

// ----------------------------------------------------------------- ADMM
//
// Equilibrated ADMM against the lane's Minv = (Hs + sigma I + rho Gs'Gs)^-1
// with Gs = diag(arow) G0 diag(acol), in scaled coordinates.

template <typename T>
struct WarpAdmm {
  const T *fs, *hs;           // (n), (mc) scaled linear term and rhs
  const T *arow, *acol;       // (mc), (n)
  const T* Minv;              // n x n tile, row stride ld
  T *x, *zc, *y, *rhs;        // state (n), (mc), (mc); scratch (n)
  T rho, rho_inv;
  int ld;
};

template <typename T>
__device__ void warp_admm(const GSparse<T>& g, const WarpAdmm<T>& v, int n,
                          int mc, int iters, T sigma, T alpha, int ln) {
  for (int it = 0; it < iters; ++it) {
    // rhs = sigma x - fs + Gs'(rho zc - y), one lane per column
    for (int i = ln; i < n; i += 32) {
      T acc = T(0);
#pragma unroll 4
      for (int p = g.tptr[i]; p < g.tptr[i + 1]; ++p) {
        const int rr = g.trow[p];
        acc += g.tval[p] * (v.arow[rr] * (v.rho * v.zc[rr] - v.y[rr]));
      }
      v.rhs[i] = sigma * v.x[i] - v.fs[i] + v.acol[i] * acc;
    }
    __syncwarp();
    for (int i = ln; i < n; i += 32) {  // x = Minv rhs, one lane per row
      const T* m = v.Minv + i * v.ld;
      T acc = T(0);
#pragma unroll 8
      for (int j = 0; j < n; ++j) acc += m[j] * v.rhs[j];
      v.x[i] = acc;
    }
    __syncwarp();
    for (int r = ln; r < mc; r += 32) {
      const T gx = g_row(g, r, v.arow, v.acol, v.x);
      const T gxr = alpha * gx + (T(1) - alpha) * v.zc[r];
      const T zn = nmin(gxr + v.y[r] * v.rho_inv, v.hs[r]);
      v.y[r] = v.y[r] + v.rho * (gxr - zn);
      v.zc[r] = zn;
    }
    __syncwarp();
  }
}

// ----------------------------------------------------------------- PDIP

template <typename T>
struct WarpPdip {
  const T *f, *h;              // (n), (mc)
  const T *rmask, *cmask, *H;  // (mc), (n), n x n tile (row stride ld)
  // z, lam, s: the warm pair on entry (s is recomputed from h), the best
  // iterate (z, lam) on exit; s holds the best iterate's with KeepS (bs
  // its scratch, mc), else the last iterate's (bs unused)
  T *z, *lam, *s, *bs;
  T *bz, *rd, *dz;                      // (n)
  T *blam, *rp, *w, *t, *ds, *dl;       // (mc)
  T* L;                                 // n x n tile, row stride ld
  T nact;                               // active rows, at least 1
  int ld;
};

// Residuals r_d = H z + f + G' lam, r_p = G z + s - h; returns the merit
// ||r_d|| + ||r_p|| + lam's and sets gap = lam's.
template <typename T>
__device__ T warp_residuals(const GSparse<T>& g, const WarpPdip<T>& v, int n,
                            int mc, int ln, T& gap) {
  for (int r = ln; r < mc; r += 32) v.t[r] = v.rmask[r] * v.lam[r];
  __syncwarp();
  T nd = T(0);
  for (int i = ln; i < n; i += 32) {
    const T* hrow = v.H + i * v.ld;
    T hz = T(0);
#pragma unroll 8
    for (int j = 0; j < n; ++j) hz += hrow[j] * v.z[j];
    const T rd = hz + v.f[i] + gt_col(g, i, v.cmask, v.t);
    v.rd[i] = rd;
    nd += rd * rd;
  }
  T np = T(0), gs = T(0);
  for (int r = ln; r < mc; r += 32) {
    const T rp = g_row(g, r, v.rmask, v.cmask, v.z) + v.s[r] - v.h[r];
    v.rp[r] = rp;
    np += rp * rp;
    gs += v.lam[r] * v.s[r];
  }
  nd = warp_sum(nd);
  np = warp_sum(np);
  gap = warp_sum(gs);
  return sqrt(nd) + sqrt(np) + gap;
}

// min(1, 0.995 * the smallest fraction-to-the-boundary ratio of (s, ds) and
// (lam, dl)), on every lane; a NaN propagates.
template <typename T>
__device__ T warp_step(const WarpPdip<T>& v, int mc, int ln) {
  const T inf = inf_value<T>();
  T mn = inf;
  for (int r = ln; r < mc; r += 32) {
    const T rs = v.ds[r] < T(0) ? -v.s[r] / v.ds[r] : inf;
    const T rl = v.dl[r] < T(0) ? -v.lam[r] / v.dl[r] : inf;
    mn = nmin(mn, nmin(rs, rl));
  }
  return nmin(T(1), T(0.995) * warp_nmin(mn));
}

// L (lower triangle) = H + (G0' W G0) o (cmask cmask') + ridge I, one lane
// per entry: entry (a, b) sums its rows' w_r G0[r,a] G0[r,b] in ascending
// r.  Lane l takes entries e = l, l + 32, ... (row-major lower order).
template <typename T>
__device__ void warp_normal(const GSparse<T>& g, const WarpPdip<T>& v, int n,
                            T ridge, int ln) {
  int a = 0, b = ln;
  while (b > a) b -= ++a;
  for (int e = ln; e < n * (n + 1) / 2; e += 32) {
    T acc = T(0);
#pragma unroll 4
    for (int q = g.eptr[e]; q < g.eptr[e + 1]; ++q)
      acc += v.w[g.erow[q]] * g.ecoef[q];
    T m = v.H[a * v.ld + b] + acc * (v.cmask[a] * v.cmask[b]);
    if (a == b) m += ridge;
    v.L[a * v.ld + b] = m;
    b += 32;
    while (b > a) b -= ++a;
  }
}

// dz = (L L')^-1 (-r_d + G' t), then ds = -(r_p + G dz).
template <typename T, int R>
__device__ void warp_newton(const GSparse<T>& g, const WarpPdip<T>& v, int n,
                            int mc, int ln) {
  T x[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = ln + 32 * r;
    x[r] = i < n ? -v.rd[i] + gt_col(g, i, v.cmask, v.t) : T(0);
  }
  warp_chol_solve(v.L, v.ld, n, x, ln);
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (ln + 32 * r < n) v.dz[ln + 32 * r] = x[r];
  __syncwarp();
  for (int r = ln; r < mc; r += 32)
    v.ds[r] = -(v.rp[r] + g_row(g, r, v.rmask, v.cmask, v.dz));
}

// `iters` warm-started masked Mehrotra iterations from (z, lam); leaves the
// best iterate by merit in (z, lam), and in s with KeepS (the single-solve
// kernel returns it; the whole-sim kernel reads only z and lam).  Masked
// rows are exact no-ops: their duals stay zero and mu normalises by the
// active row count.  R: rows a lane owns in the factor and the solves (n
// <= 32 R).
template <typename T, int R, bool KeepS = false>
__device__ void warp_pdip(const GSparse<T>& g, const WarpPdip<T>& v, int n,
                          int mc, int iters, T eps_c, T ridge, T w_cap,
                          int ln) {
  // warm start: re-centre the carried pair; s from this step's h
  for (int r = ln; r < mc; r += 32) {
    const T l = nmax(v.lam[r], eps_c) * v.rmask[r];
    v.lam[r] = l;
    v.blam[r] = l;
    v.s[r] = nmax(v.h[r] - g_row(g, r, v.rmask, v.cmask, v.z), eps_c);
    if constexpr (KeepS) v.bs[r] = v.s[r];
  }
  for (int i = ln; i < n; i += 32) v.bz[i] = v.z[i];
  T bm = inf_value<T>();

  for (int it = 0; it < iters; ++it) {
    T gap;
    const T mnew = warp_residuals(g, v, n, mc, ln, gap);
    const T mu = gap / v.nact;
    if (mnew < bm) {  // warp-uniform; NaN never wins
      for (int i = ln; i < n; i += 32) v.bz[i] = v.z[i];
      for (int r = ln; r < mc; r += 32) v.blam[r] = v.lam[r];
      if constexpr (KeepS)
        for (int r = ln; r < mc; r += 32) v.bs[r] = v.s[r];
      bm = mnew;
    }
    for (int r = ln; r < mc; r += 32)
      v.w[r] = nmin(v.lam[r] / v.s[r], w_cap) * v.rmask[r];
    __syncwarp();
    for (int r = ln; r < mc; r += 32)  // the predictor's t
      v.t[r] = v.rmask[r] * (v.lam[r] - v.w[r] * v.rp[r]);
    warp_normal(g, v, n, ridge, ln);
    __syncwarp();
    warp_factor<T, R>(v.L, n, v.ld, ln);
    __syncwarp();

    // predictor
    warp_newton<T, R>(g, v, n, mc, ln);
    for (int r = ln; r < mc; r += 32)
      v.dl[r] = -(v.lam[r] * v.s[r] + v.lam[r] * v.ds[r]) / v.s[r] *
                v.rmask[r];
    const T a_aff = warp_step(v, mc, ln);
    T mu_aff = T(0);
    for (int r = ln; r < mc; r += 32)
      mu_aff += (v.lam[r] + a_aff * v.dl[r]) * (v.s[r] + a_aff * v.ds[r]);
    mu_aff = warp_sum(mu_aff) / v.nact;
    const T sig_r = mu_aff / (mu + T(1e-30));
    const T sigma = sig_r * sig_r * sig_r;

    // corrector; r_cent overwrites dl
    for (int r = ln; r < mc; r += 32) {
      const T rc = (v.lam[r] * v.s[r] - sigma * mu + v.dl[r] * v.ds[r]) *
                   v.rmask[r];
      v.dl[r] = rc;
      v.t[r] = v.rmask[r] * (rc / v.s[r] - v.w[r] * v.rp[r]);
    }
    __syncwarp();
    warp_newton<T, R>(g, v, n, mc, ln);
    for (int r = ln; r < mc; r += 32)
      v.dl[r] = -(v.dl[r] + v.lam[r] * v.ds[r]) / v.s[r] * v.rmask[r];
    const T step = warp_step(v, mc, ln);
    for (int i = ln; i < n; i += 32) v.z[i] = v.z[i] + step * v.dz[i];
    for (int r = ln; r < mc; r += 32) {
      v.lam[r] = v.lam[r] + step * v.dl[r];
      v.s[r] = v.s[r] + step * v.ds[r];
    }
  }
  T gap;
  const T mlast = warp_residuals(g, v, n, mc, ln, gap);
  if (!(mlast < bm)) {  // the best iterate
    for (int i = ln; i < n; i += 32) v.z[i] = v.bz[i];
    for (int r = ln; r < mc; r += 32) v.lam[r] = v.blam[r];
    if constexpr (KeepS)
      for (int r = ln; r < mc; r += 32) v.s[r] = v.bs[r];
  }
  __syncwarp();
}

}  // namespace mpc
