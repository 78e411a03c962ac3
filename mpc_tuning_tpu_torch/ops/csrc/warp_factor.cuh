// The warp-per-matrix Cholesky factor in shared memory, its substitutions
// and their helpers, shared by the SPD kernels (spd.cu: spd_factor,
// factor_lanes, spd_factor_solve), the whole-sim PDIP kernel (closed_sim.cu,
// through warp_qp.cuh) and the band kernel (closed_sim_band.cu).
#pragma once

#include "common.cuh"

namespace mpc {

// Rows a lane owns in warp_factor (lane l: rows l + 32 r, r < R <=
// kFactorMaxRows, so n <= 64), the columns finished per pass over the dots,
// and the shared memory a block may hold on the H100 (227 KB).
constexpr int kFactorMaxRows = 2;
constexpr int kFactorCols = 4;
constexpr long long kFactorSmemMax = 232448;

// Row stride of an n x n tile in shared memory: odd, so the 32 lanes
// reading one column hit 32 banks (at double in 8-byte words, half a warp
// at a time).
__host__ __device__ __forceinline__ int factor_ld(int n) { return n | 1; }

// One element from device memory into shared memory without a register
// (cp.async, 4 or 8 bytes), so that all of a thread's copies are in flight
// at once; cp_async_wait() waits for this thread's.
template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* g) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if (sizeof(T) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(s), "l"(g));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(g));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The value a[j >> 5] of row j on the lane that owns it, on every lane: one
// shuffle per row slot (indexing a by j would put it in local memory).
template <typename T, int R>
__device__ __forceinline__ T from_row(const T (&a)[R], int j) {
  T v = __shfl_sync(0xffffffffu, a[0], j & 31);
#pragma unroll
  for (int r = 1; r < R; ++r) {
    const T u = __shfl_sync(0xffffffffu, a[r], j & 31);
    if ((j >> 5) == r) v = u;
  }
  return v;
}

// Column j from its finished dots a[r] (rows lane + 32 r): the pivot d of
// row j, ljj = sqrt(d) on every lane, q[r] = a[r] / ljj; returns ljj.
// Rsq: ri = rsqrt(d), ljj = d ri and q[r] = a[r] ri (one long-latency
// operation on the column's chain in place of a sqrt and a division;
// other rounding).
template <typename T, int R, bool Rsq = false>
__device__ __forceinline__ T finish_column(const T (&a)[R], T (&q)[R], int j,
                                           bool& ok) {
  const T d = from_row(a, j);
  ok = ok && d > T(0);
  if (Rsq) {
    const T ri = rsqrt(d);
#pragma unroll
    for (int r = 0; r < R; ++r) q[r] = a[r] * ri;
    return d * ri;
  }
  const T ljj = sqrt(d);
#pragma unroll
  for (int r = 0; r < R; ++r) q[r] = a[r] / ljj;
  return ljj;
}

// The factor of one n x n matrix in the tile t (row stride ld), in place,
// by one warp.  Lane l owns rows l + 32 r, r < R; a lane past row n - 1
// reads row n - 1 and stores nothing, so no load or multiply-add is
// branched.  Left-looking, C = kFactorCols columns a pass: every row forms
// the dots of columns j ... j + C - 1 over k < j at once (one load of L[i][k]
// serves C columns), then the C columns are finished in order, each one's
// entries entering the later columns' dots as their terms k = j, j + 1, ...
// So every entry sees A[i][j] - sum_k L[i][k] L[j][k] in ascending k, then
// the sqrt or the division.  Ends with the upper triangle zero, or, if a
// pivot was not > 0, the whole tile NaN (as the plain version).  Rsq
// (finish_column): the pivots through rsqrt.
template <typename T, int R, bool Rsq = false>
__device__ void warp_factor(T* t, int n, int ld, int lane) {
  constexpr int C = kFactorCols;
  int off[R];
#pragma unroll
  for (int r = 0; r < R; ++r) off[r] = min(lane + 32 * r, n - 1) * ld;
  bool ok = true;
  int j = 0;
  for (; j + C <= n; j += C) {
    T a[C][R], q[C][R], diag[C];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int r = 0; r < R; ++r) a[c][r] = t[off[r] + j + c];
    const T* Lj = t + j * ld;
#pragma unroll 8
    for (int k = 0; k < j; ++k) {
      T lc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) lc[c] = Lj[c * ld + k];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const T lik = t[off[r] + k];
#pragma unroll
        for (int c = 0; c < C; ++c) a[c][r] -= lik * lc[c];
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      diag[c] = finish_column<T, R, Rsq>(a[c], q[c], j + c, ok);
#pragma unroll
      for (int c2 = c + 1; c2 < C; ++c2) {
        const T l = from_row(q[c], j + c2);
#pragma unroll
        for (int r = 0; r < R; ++r) a[c2][r] -= q[c][r] * l;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + 32 * r;
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (i > j + c && i < n) t[off[r] + j + c] = q[c][r];
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (lane == ((j + c) & 31)) t[(j + c) * ld + j + c] = diag[c];
    __syncwarp();
  }
  for (; j < n; ++j) {  // the last n % C columns, one at a time
    T a[R], q[R];
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = t[off[r] + j];
    const T* Lj = t + j * ld;
#pragma unroll 8
    for (int k = 0; k < j; ++k) {
      const T ljk = Lj[k];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] -= t[off[r] + k] * ljk;
    }
    const T ljj = finish_column<T, R, Rsq>(a, q, j, ok);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + 32 * r;
      if (i > j && i < n) t[off[r] + j] = q[r];
    }
    if (lane == (j & 31)) t[j * ld + j] = ljj;
    __syncwarp();
  }
  const T nan = nan_value<T>();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
    if (i < n) {
      if (!ok)
        for (int c = 0; c < n; ++c) t[i * ld + c] = nan;
      else
        for (int c = i + 1; c < n; ++c) t[i * ld + c] = T(0);
    }
  }
}

// x = (L L')^-1 x for the factor in the tile L; x[r] holds row ln + 32 r on
// its lane (zero past row n - 1).  Right-looking: the forward pass
// subtracts row i's terms L[i][k] y_k in ascending k, as the one-thread
// substitution does; the back pass in descending k.
template <typename T, int R>
__device__ void warp_chol_solve(const T* L, int ld, int n, T (&x)[R],
                                int ln) {
  for (int j = 0; j < n; ++j) {
    const T xj = from_row(x, j) / L[j * ld + j];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = ln + 32 * r;
      if (i == j)
        x[r] = xj;
      else if (i > j && i < n)
        x[r] -= L[i * ld + j] * xj;
    }
  }
  for (int j = n - 1; j >= 0; --j) {
    const T xj = from_row(x, j) / L[j * ld + j];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = ln + 32 * r;
      if (i == j)
        x[r] = xj;
      else if (i < j)
        x[r] -= L[j * ld + i] * xj;
    }
  }
}

}  // namespace mpc
