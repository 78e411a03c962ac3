// Whole band-control closed loop: the counterpart of the Pallas kernel
// _closed_sim_band_kernel (mpc_tuning_tpu/ops/pallas_kernels.py,
// closed_sim_band_lanes).  Every step of a band (y-constrained) case runs
// the Kalman update, the free response, the QP rhs with its free-response
// dependent band rows, slack seeding, the stage-0 slack LP (diagonal
// H_lp, f = e_slack), the slack-frozen stage-2 PDIP against Hp, and the
// model and plant steps; the stage-0 (z, lam) is the next step's warm pair.
//
// What bounds it on an H100: per PDIP iteration the soft band rows dominate
// (mc = 4 m nu + 1 + 2 p ny, up to 1,959 rows on Shell7x5): the normal
// matrix G' W G costs ~n^2/2 multiply-adds per band row and G z, G' y ~n
// per row, in a serial chain of nit x (lp + s2) iterations per candidate.
// The tunes launch 1 to ~20 candidates at a time, so the chain's latency,
// not the card's rates, sets the time.  The design spreads a candidate
// over a thread-block cluster and cuts the barriers per iteration:
//  * a cluster of C = 1, 2 or 4 blocks per candidate (grid B C; C the
//    smallest that fits, band_plan): the candidate's active constraint
//    rows, as "K-rows" (a band +-pair, whose rows share Theta up to sign,
//    or one other row), are split into C contiguous slices; each block
//    keeps its slice's G0 coefficients (the tile) and row state in shared
//    memory for the whole launch, so nothing streams from device memory
//    inside the PDIP;
//  * a thread owns its K-rows for the whole launch: a row's own updates
//    (s, lam, ds, dl, r_p, the best iterate, the warm pair) need no
//    barrier; only G'y, the normal matrix and the scalar sums cross rows;
//  * those cross-row sums are one register-blocked product per iteration
//    (4 x 4 outputs a thread from 8 shared loads per row, in place of two
//    loads per multiply-add): Theta' [W Theta | w s | y | t] over the
//    block's K-rows gives the normal matrix, G'lam and the predictor's G't
//    at once; the corrector's G't is a second, narrower one; the slack
//    column's scalar sums ride along as warp reductions;
//  * the reductions run in a fixed order (lanes by a shuffle tree, warps,
//    then the blocks in rank order through distributed shared memory), so
//    every block ends with the same bits and factors and solves
//    redundantly on one warp (warp_factor.cuh with rsqrt pivots, then its
//    row-parallel substitutions, warp_chol_solve: one row a step, all
//    later rows updated at once), and the result does not depend on B or
//    the run;
//  * a PDIP iteration passes at most 10 block barriers and 4 cluster
//    barriers (block barriers too when C = 1); the block-per-candidate
//    design passed 27-29 (PERF.md).
// Envelope (band_plan; ops/kernels.band_envelope): n <= kBandMaxN and the
// slice of C = 4 blocks within kBandSmem bytes of shared memory; G0's
// y_lo rows the negated y_hi rows outside the slack column; 0/1 masks.

#include <cooperative_groups.h>

#include "warp_qp.cuh"

namespace mpc {

namespace cg = cooperative_groups;

constexpr int kBandThreads = 256;
constexpr int kBandWarps = kBandThreads / 32;
constexpr int kBandMaxN = 64;
constexpr int kBandMaxCluster = 4;
constexpr long long kBandSmem = 232448;
// per K-row arrays of shared memory: the row state (two rows each) and
// the reduction's inputs (W Theta's weight, then w s, y, t and a pad)
enum {
  RS_H, RS_LAM = 2, RS_S = 4, RS_BLAM = 6, RS_LAMW = 8, RS_RP = 10,
  RS_DS = 12, RS_DL = 14, RS_SCV = 16, RS_WSUM = 18, RS_EXT = 19,
  RS_COUNT = 23
};
// scalar sums of a reduction (the slack entries and the merit's parts)
enum { SC_WSS, SC_SL, SC_ST, SC_RPSQ, SC_GAP, SC_COUNT };

struct BandShape {
  int n, mc, pny, ny, nu, nxa, nxp, nmv;
};

// Shared-memory layout of one block (offsets in elements of 8 bytes) for a
// cluster of C blocks; C = 0 when even kBandMaxCluster blocks do not fit.
struct BandPlan {
  int C, kcap, kb, ld, ldn, part;
  size_t L, H, vec, est, red, xsc, slot, flag, tile, rows, grow, buf,
      total;
};

__host__ __device__ inline BandPlan band_plan_for(const BandShape& s, int C) {
  BandPlan p;
  p.C = C;
  p.kcap = s.mc - s.pny;  // non-band rows and one K-row per band pair
  p.kb = (p.kcap + C - 1) / C;
  p.ld = (s.n - 1) | 1;
  p.ldn = s.n | 1;
  const int nt = (s.n + 2) / 4, tiles = nt * (nt + 1) / 2 + nt;
  int part = 16 * (tiles > kBandThreads ? tiles : kBandThreads);
  part = part > 2 * s.pny ? part : 2 * s.pny;  // the step's free response
  p.part = part > p.kcap ? part : p.kcap;      // the K-row list (ints)
  size_t o = 0;
  p.L = o; o += (size_t)s.n * p.ldn;
  p.H = o; o += (size_t)s.n * (s.n + 1) / 2;
  p.vec = o; o += (size_t)13 * s.n;
  p.est = o; o += (size_t)2 * s.nxp + 2 * s.nxa + s.ny + 2 * s.nu;
  p.red = o; o += (size_t)kBandWarps * 8;
  p.xsc = o; o += 8;
  p.slot = o; o += 8;
  p.flag = o; o += 4;
  p.tile = o; o += (size_t)p.kb * p.ld + 4;
  p.rows = o; o += (size_t)RS_COUNT * p.kb;
  p.grow = o; o += ((size_t)p.kb + 1) / 2;
  p.buf = o; o += (size_t)p.part;
  p.total = o;
  return p;
}

__host__ __device__ inline BandPlan band_plan(const BandShape& s) {
  for (int C = 1; C <= kBandMaxCluster; C *= 2) {
    const BandPlan p = band_plan_for(s, C);
    if ((long long)p.total * 8 <= kBandSmem) return p;
  }
  BandPlan p = band_plan_for(s, kBandMaxCluster);
  p.C = 0;
  return p;
}

template <typename T>
struct BandArgs {
  // shared tables, row-major; Cpl, Apl, C, Mk, A and SxF transposed
  const T *Cpl, *Apl, *Bplu, *C, *Mk, *A, *Bu, *SxF, *SstF, *ThT, *Vt, *G0;
  // per lane, batch-major (B, rows)
  const T *q, *hbu, *su, *hbyh, *rmyh, *hbyl, *rmyl, *rmask, *cmask,
      *cmask2, *lpd, *sfy, *sfu, *Hp;
  const T* r;  // (nit, ny, B)
  T* Y;        // (nit, ny, B)
  T* U;        // (nit, nu, B)
  T* E;        // (nit, B): each step's frozen slack ehat
  BandShape s;
  int B, nit, lp_iters, s2_iters, cluster;  // cluster: blocks a candidate
  T eps_c, ridge, w_cap, m_rel, m_abs;
};

// One block's view of its candidate: shared-memory arrays, the active
// sizes and this block's K-rows.
template <typename T>
struct Band {
  const BandArgs<T>& a;
  int n, ld, ldn, ncol, nt, ntri, kb, kbc, C, slot;
  T nact;
  T *L, *H, *z, *bz, *dz, *zc, *rd, *fq, *fl, *zw, *lpd, *cm, *cm2, *gl, *gt,
      *xpl, *xpl2, *xhp, *xhat, *ys, *up, *uo, *red, *xsc, *slots, *tile,
      *rs, *buf;
  int *flag, *grow;
  const T* f;  // the QP's linear term: fq (stage 2) or fl (the LP)

  __device__ Band(const BandArgs<T>& args) : a(args) {}

  // row-state array v (RS_*) of K-row k; the lo row of a pair at v + 1
  __device__ __forceinline__ T& at(int v, int k) const {
    return rs[(size_t)v * kbc + k];
  }
  // the block barrier, and the cluster barrier (the block's when C = 1)
  __device__ __forceinline__ void sync_cluster() const {
    if (C > 1)
      cg::this_cluster().sync();
    else
      __syncthreads();
  }
  // the sum over the cluster's blocks, in rank order, of the value at p in
  // each block's shared memory
  // (the C loads are issued together, then combined in rank order)
  __device__ __forceinline__ void xload(T* p, T (&v)[kBandMaxCluster]) const {
    cg::cluster_group cl = cg::this_cluster();
#pragma unroll
    for (int r = 0; r < kBandMaxCluster; ++r)
      if (r < C) v[r] = *cl.map_shared_rank(p, r);
  }
  __device__ __forceinline__ T xsum(T* p) const {
    if (C == 1) return *p;
    T v[kBandMaxCluster];
    xload(p, v);
    T s = T(0);
#pragma unroll
    for (int r = 0; r < kBandMaxCluster; ++r)
      if (r < C) s += v[r];
    return s;
  }
  __device__ __forceinline__ T xmin(T* p) const {
    T v[kBandMaxCluster];
    xload(p, v);
    T s = v[0];
#pragma unroll
    for (int r = 1; r < kBandMaxCluster; ++r)
      if (r < C) s = nmin(s, v[r]);
    return s;
  }
  __device__ __forceinline__ T xmax(T* p) const {
    T v[kBandMaxCluster];
    xload(p, v);
    T s = v[0];
#pragma unroll
    for (int r = 1; r < kBandMaxCluster; ++r)
      if (r < C) s = nmax(s, v[r]);
    return s;
  }
};

// Hessian entry (i, j) from its packed lower triangle.
template <typename T>
__device__ __forceinline__ T hess(const T* H, int i, int j) {
  return i >= j ? H[i * (i + 1) / 2 + j] : H[j * (j + 1) / 2 + i];
}

// G0 row of K-row k (its hi row for a pair) times x (x = colm * the
// variables, from xc): the du part over the tile, without the slack term.
template <typename T>
__device__ __forceinline__ T row_dot(const Band<T>& c, int k, const T* xc) {
  const T* t = c.tile + (size_t)k * c.ld;
  T d = T(0);
#pragma unroll 4
  for (int i = 0; i < c.ncol; ++i) d += t[i] * xc[i];
  return d;
}

// G x on K-row k: the hi row rm_h (d + scv_h xs), the lo row rm_l (-d +
// scv_l xs); rm_h = 1 and rm_l = 1 for a pair, 0 for a single row.
template <typename T>
__device__ __forceinline__ void row_g(const Band<T>& c, int k, const T* xc,
                                      T& gh, T& gl) {
  const T d = row_dot(c, k, xc), xs = xc[c.n - 1];
  const T rml = c.grow[k] >= 0 ? T(1) : T(0);
  gh = d + c.at(RS_SCV, k) * xs;
  gl = rml * (-d + c.at(RS_SCV + 1, k) * xs);
}

// Warp sums of NS values, lane 0 stores them at red[warp * 8 + idx[j]].
template <typename T, int NS>
__device__ __forceinline__ void warp_scalars(const Band<T>& c, T (&v)[NS],
                                             const int (&idx)[NS]) {
#pragma unroll
  for (int j = 0; j < NS; ++j) v[j] = warp_sum(v[j]);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int j = 0; j < NS; ++j) c.red[(threadIdx.x >> 5) * 8 + idx[j]] = v[j];
  }
}

// After a block barrier: xsc[idx] = the warps' sums in warp order.
template <typename T, int NS>
__device__ __forceinline__ void block_scalars(const Band<T>& c,
                                              const int (&idx)[NS]) {
  if (threadIdx.x < NS) {
    const int j = idx[threadIdx.x];
    T v = c.red[j];
    for (int w = 1; w < kBandWarps; ++w) v += c.red[w * 8 + j];
    c.xsc[j] = v;
  }
}

// The sum over the warp's 32 lanes of each of the 16 values v, in a fixed
// tree (a transpose reduction: 16 shuffles in place of 16 x 5): the sum of
// v[q] lands on the lanes 2 q' + {0, 1} with q' the lane's bits 4..1
// read as q (returned in q).
template <typename T>
__device__ __forceinline__ T warp_sum16(const T (&v)[16], int ln, int& q) {
  T a[8], b[4], d[2];
  const bool s16 = ln & 16, s8 = ln & 8, s4 = ln & 4, s2 = ln & 2;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    a[i] = (s16 ? v[i + 8] : v[i]) +
           __shfl_xor_sync(kWarpMask, s16 ? v[i] : v[i + 8], 16);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    b[i] = (s8 ? a[i + 4] : a[i]) +
           __shfl_xor_sync(kWarpMask, s8 ? a[i] : a[i + 4], 8);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    d[i] = (s4 ? b[i + 2] : b[i]) +
           __shfl_xor_sync(kWarpMask, s4 ? b[i] : b[i + 2], 4);
  T e = (s2 ? d[1] : d[0]) + __shfl_xor_sync(kWarpMask, s2 ? d[0] : d[1], 2);
  e += __shfl_xor_sync(kWarpMask, e, 1);
  q = (s16 ? 8 : 0) + (s8 ? 4 : 0) + (s4 ? 2 : 0) + (s2 ? 1 : 0);
  return e;
}

// acc[i][j] += the 4 x 4 tile tl's terms of K-rows k0, k0 + dk, ... < k1:
// W tiles (tl < ntri) sum_k wsum_k a_k[4 ta + i] a_k[4 tb + j]; E tiles
// (after the ntri W tiles) sum_k a_k[4 ta + i] ext_k[j] (ext = w s, y_lam,
// t, 0).
template <typename T>
__device__ __forceinline__ void tile_terms(const Band<T>& c, int tl, int k0,
                                           int k1, int dk, T (&acc)[4][4]) {
  if (tl < c.ntri) {
    int ta = 0;
    while ((ta + 1) * (ta + 2) / 2 <= tl) ++ta;
    const int tb = tl - ta * (ta + 1) / 2;
    const T* pa = c.tile + 4 * ta;
    const T* pb = c.tile + 4 * tb;
    const T* ws = &c.at(RS_WSUM, 0);
#pragma unroll 2
    for (int k = k0; k < k1; k += dk) {
      const size_t o = (size_t)k * c.ld;
      const T w = ws[k];
      T x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = pa[o + i];
        y[i] = pb[o + i] * w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += x[i] * y[j];
    }
  } else {
    const T* pa = c.tile + 4 * (tl - c.ntri);
    const T* pe = &c.at(RS_EXT, 0);
#pragma unroll 2
    for (int k = k0; k < k1; k += dk) {
      const size_t o = (size_t)k * c.ld;
      T x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = pa[o + i];
        y[i] = pe[(size_t)i * c.kbc + k];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += x[i] * y[j];
    }
  }
}

// The register-blocked cross-row product over this block's K-rows, tiles
// [t0, t1) (tile_terms).  A tile's lanes take every 32nd K-row (so the 32
// lanes read 32 tile rows, at the odd stride apart: no bank conflict) and
// their sums meet by warp_sum16; with at most kBandWarps tiles, wpt warps
// share a tile (every 32 wpt-th K-row) and their sums meet in order, else
// the warps take the tiles in turn.  Warp g of a tile stores its 16 sums
// of tile t at buf[g 16 T + 16 (t - t0) + 4 i + j]; then buf[16 (t - t0) +
// 4 i + j] holds the block's sum.  Ends before a barrier.
template <typename T>
__device__ void cross_rows(const Band<T>& c, int t0, int t1) {
  const int nT = t1 - t0, nout = 16 * nT;
  const int ln = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpt = nT <= kBandWarps ? kBandWarps / nT : 1, L = 32 * wpt;
  for (int job = warp; job < nT * wpt; job += kBandWarps) {
    const int tl = t0 + job / wpt, g = job % wpt;
    T acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = T(0);
    tile_terms(c, tl, 32 * g + ln, c.kb, L, acc);
    T v[16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) v[4 * i + j] = acc[i][j];
    int q;
    const T sum = warp_sum16(v, ln, q);
    if ((ln & 1) == 0) c.buf[(size_t)g * nout + 16 * (tl - t0) + q] = sum;
  }
  if (wpt > 1) {
    __syncthreads();
    for (int o = threadIdx.x; o < nout; o += kBandThreads) {
      T v = c.buf[o];
      for (int g = 1; g < wpt; ++g) v += c.buf[(size_t)g * nout + o];
      c.buf[o] = v;
    }
  }
}

// Reduction buffers' entry of E tile column j for variable i (tiles
// counted from t0).
template <typename T>
__device__ __forceinline__ T* ext_out(const Band<T>& c, int t0, int i, int j) {
  return c.buf + 16 * (c.ntri + i / 4 - t0) + 4 * (i % 4) + j;
}

// One warp's rows of M x for a row-major table M (rows, cols); lane 0 hands
// (row, value) to put.
template <typename T, typename Put>
__device__ void warp_rows(const T* M, int rows, int cols, const T* x,
                          Put put) {
  const int ln = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < rows; i += kBandWarps) {
    T acc = T(0);
    for (int j = ln; j < cols; j += 32) acc += M[(size_t)i * cols + j] * x[j];
    acc = warp_sum(acc);
    if (ln == 0) put(i, acc);
  }
}

// M x for a table M (rows, cols) given transposed, MT (cols, rows): a
// thread a row (neighbouring threads on neighbouring addresses), each dot
// in ascending column order; put(row, value).
template <typename T, typename Put>
__device__ void thread_rows(const T* MT, int rows, int cols, const T* x,
                            Put put) {
  for (int i = threadIdx.x; i < rows; i += kBandThreads) {
    T acc = T(0);
#pragma unroll 4
    for (int j = 0; j < cols; ++j) acc += MT[(size_t)j * rows + i] * x[j];
    put(i, acc);
  }
}

// The cluster's largest soft-row violation of z per unit of slack
// coefficient (the slack seeding's and the slack freeze's core); ends
// after a cluster barrier.
template <typename T>
__device__ T slack_violation(Band<T>& c, const T* cmz) {
  for (int i = threadIdx.x; i < c.n; i += kBandThreads) c.zc[i] = cmz[i] * c.z[i];
  __syncthreads();
  T mx = T(0);
  for (int k = threadIdx.x; k < c.kb; k += kBandThreads) {
    T gh, gl;
    row_g(c, k, c.zc, gh, gl);
    const T vh = nmax(gh - c.at(RS_H, k), T(0));
    const T vl = nmax(gl - c.at(RS_H + 1, k), T(0));
    const T Vh = nmax(-c.at(RS_SCV, k), T(0));
    const T Vl = nmax(-c.at(RS_SCV + 1, k), T(0));
    mx = nmax(mx, Vh > T(1e-12) ? vh / nmax(Vh, T(1e-12)) : T(0));
    mx = nmax(mx, Vl > T(1e-12) ? vl / nmax(Vl, T(1e-12)) : T(0));
  }
  for (int o = 16; o > 0; o >>= 1)
    mx = nmax(mx, __shfl_xor_sync(kWarpMask, mx, o));
  if ((threadIdx.x & 31) == 0) c.red[(threadIdx.x >> 5) * 8] = mx;
  __syncthreads();
  T* s = c.slots + 4 * c.slot;
  c.slot ^= 1;
  if (threadIdx.x == 0) {
    T v = c.red[0];
    for (int w = 1; w < kBandWarps; ++w) v = nmax(v, c.red[w * 8]);
    s[0] = v;
  }
  c.sync_cluster();
  return c.C == 1 ? s[0] : c.xmax(s);
}

// The least fraction-to-the-boundary ratio num / den (den > 0) over a
// thread's rows, compared by cross-multiplication: one division at the end
// in place of one per row.  A NaN numerator makes it NaN, as nmin over the
// quotients would.
template <typename T>
struct MinRatio {
  T num, den;
  bool nan;
  __device__ MinRatio() : num(inf_value<T>()), den(T(1)), nan(false) {}
  // the candidate a / b of a row whose step -b < 0 would cross a = 0
  __device__ __forceinline__ void add(T a, T b) {
    nan = nan || a != a;
    if (a * den < num * b) {
      num = a;
      den = b;
    }
  }
  __device__ __forceinline__ T value() const {
    return nan ? nan_value<T>() : num / den;
  }
};

// min over the cluster of a per-thread fraction-to-the-boundary ratio and,
// with S (aff), the sums S1, S2; ends after a cluster barrier.
template <typename T, bool Aff>
__device__ T cluster_step(Band<T>& c, T mn, T s1, T s2, T& S1, T& S2) {
  for (int o = 16; o > 0; o >>= 1) {
    mn = nmin(mn, __shfl_xor_sync(kWarpMask, mn, o));
    if (Aff) {
      s1 += __shfl_xor_sync(kWarpMask, s1, o);
      s2 += __shfl_xor_sync(kWarpMask, s2, o);
    }
  }
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    c.red[w * 8] = mn;
    c.red[w * 8 + 1] = s1;
    c.red[w * 8 + 2] = s2;
  }
  __syncthreads();
  T* s = c.slots + 4 * c.slot;
  c.slot ^= 1;
  if (threadIdx.x < (Aff ? 3 : 1)) {
    const int j = threadIdx.x;
    T v = c.red[j];
    for (int ww = 1; ww < kBandWarps; ++ww)
      v = j == 0 ? nmin(v, c.red[ww * 8]) : v + c.red[ww * 8 + j];
    s[j] = v;
  }
  c.sync_cluster();
  if (c.C == 1) {
    S1 = s[1];
    S2 = s[2];
    return s[0];
  }
  // every block's three values in flight together, then combined in rank
  // order
  cg::cluster_group cl = cg::this_cluster();
  T v[3][kBandMaxCluster];
#pragma unroll
  for (int r = 0; r < kBandMaxCluster; ++r)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (r < c.C && (Aff || j == 0)) v[j][r] = *cl.map_shared_rank(s + j, r);
  T m = v[0][0];
  S1 = S2 = T(0);
#pragma unroll
  for (int r = 0; r < kBandMaxCluster; ++r) {
    if (r >= c.C) continue;
    if (r > 0) m = nmin(m, v[0][r]);
    if (Aff) {
      S1 += v[1][r];
      S2 += v[2][r];
    }
  }
  return m;
}

// Warm-started masked Mehrotra PDIP (the plain pdip_lanes): z and the
// K-rows' lam hold the start on entry and the best iterate by merit on
// exit; s is recomputed from this h.  diag_h: the quadratic term is
// diag(lpd), else H.  colm: the variable mask (cmask or cmask2).
template <typename T, int R>
__device__ void pdip(Band<T>& c, bool diag_h, const T* colm, int iters) {
  const BandArgs<T>& a = c.a;
  const int n = c.n, ln = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ncol = c.ncol;
  const T w_cap = a.w_cap, eps_c = a.eps_c;
  for (int i = threadIdx.x; i < n; i += kBandThreads) {
    c.zc[i] = colm[i] * c.z[i];
    c.bz[i] = c.z[i];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < c.kb; k += kBandThreads) {
    T gh, gl;
    row_g(c, k, c.zc, gh, gl);
    const T rml = c.grow[k] >= 0 ? T(1) : T(0);
    const T lh = nmax(c.at(RS_LAM, k), eps_c);
    const T ll = nmax(c.at(RS_LAM + 1, k), eps_c) * rml;
    c.at(RS_LAM, k) = lh;
    c.at(RS_LAM + 1, k) = ll;
    c.at(RS_BLAM, k) = lh;
    c.at(RS_BLAM + 1, k) = ll;
    c.at(RS_S, k) = nmax(c.at(RS_H, k) - gh, eps_c);
    c.at(RS_S + 1, k) = nmax(c.at(RS_H + 1, k) - gl, eps_c);
  }
  const int t_e = c.ntri, t_end = c.ntri + c.nt;
  T bm = inf_value<T>();  // warp 0's
  for (int it = 0; it <= iters; ++it) {
    const bool last = it == iters;  // the final merit only
    __syncthreads();
    // rows: r_p = G z + s - h, w, the predictor's t, the reduction's
    // inputs and the scalar sums
    {
      T v[5] = {T(0), T(0), T(0), T(0), T(0)};
#pragma unroll 2
      for (int k = threadIdx.x; k < c.kb; k += kBandThreads) {
        T gh, gl;
        row_g(c, k, c.zc, gh, gl);
        const T rml = c.grow[k] >= 0 ? T(1) : T(0);
        const T lh = c.at(RS_LAM, k), ll = c.at(RS_LAM + 1, k);
        const T sh = c.at(RS_S, k), sl = c.at(RS_S + 1, k);
        const T ch = c.at(RS_SCV, k), cl = c.at(RS_SCV + 1, k);
        const T ph = gh + sh - c.at(RS_H, k);
        const T pl = gl + sl - c.at(RS_H + 1, k);
        c.at(RS_RP, k) = ph;
        c.at(RS_RP + 1, k) = pl;
        const T yl = ll * rml;
        v[SC_RPSQ] += ph * ph + pl * pl;
        v[SC_GAP] += lh * sh + ll * sl;
        v[SC_SL] += ch * lh + cl * yl;
        c.at(RS_EXT + 1, k) = lh - yl;
        if (!last) {
          const T wh = nmin(lh / sh, w_cap), wl = nmin(ll / sl, w_cap) * rml;
          const T th = lh - wh * ph, tl = rml * (ll - wl * pl);
          c.at(RS_WSUM, k) = wh + wl;
          c.at(RS_EXT, k) = wh * ch - wl * cl;
          c.at(RS_EXT + 2, k) = th - tl;
          c.at(RS_EXT + 3, k) = T(0);
          v[SC_WSS] += wh * ch * ch + wl * cl * cl;
          v[SC_ST] += ch * th + cl * tl;
        }
      }
      const int idx[5] = {SC_WSS, SC_SL, SC_ST, SC_RPSQ, SC_GAP};
      warp_scalars(c, v, idx);
      __syncthreads();
      block_scalars(c, idx);
      cross_rows(c, last ? t_e : 0, t_end);
    }
    c.sync_cluster();
    const int t0 = last ? t_e : 0;
    // the normal matrix M = Hbase + (G'WG) o (colm colm') + ridge I
    if (!last) {
      for (int e = threadIdx.x; e < n * (n + 1) / 2; e += kBandThreads) {
        int ia = 0;
        while ((ia + 1) * (ia + 2) / 2 <= e) ++ia;
        const int ib = e - ia * (ia + 1) / 2;
        T v = T(0);
        if (ia < ncol) {
          v = c.xsum(c.buf + 16 * ((ia / 4) * (ia / 4 + 1) / 2 + ib / 4) +
                     4 * (ia % 4) + ib % 4);
        } else if (ia == n - 1) {
          if (ib < ncol)
            v = c.xsum(ext_out(c, 0, ib, 0));
          else if (ib == n - 1)
            v = c.xsum(c.xsc + SC_WSS);
        }
        const T hv = diag_h ? (ia == ib ? c.lpd[ia] : T(0)) : hess(c.H, ia, ib);
        T m = hv + v * (colm[ia] * colm[ib]);
        if (ia == ib) m += a.ridge;
        c.L[ia * c.ldn + ib] = m;
      }
    }
    for (int i = threadIdx.x; i < n; i += kBandThreads) {
      const bool du = i < ncol, sl = i == n - 1;
      c.gl[i] = du ? c.xsum(ext_out(c, t0, i, 1))
                   : sl ? c.xsum(c.xsc + SC_SL) : T(0);
      if (!last)
        c.gt[i] = du ? c.xsum(ext_out(c, t0, i, 2))
                     : sl ? c.xsum(c.xsc + SC_ST) : T(0);
    }
    if (threadIdx.x == 0) {  // slots 6, 7: never read by another block
      c.xsc[6] = c.xsum(c.xsc + SC_RPSQ);
      c.xsc[7] = c.xsum(c.xsc + SC_GAP);
    }
    __syncthreads();
    const T gap = c.xsc[7];
    const T mu = gap / c.nact;
    // warp 0: r_d, the merit and the best iterate; the factor and the
    // predictor's direction
    if (warp == 0) {
      T x[R], nd = T(0);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = ln + 32 * r;
        x[r] = T(0);
        if (i < n) {
          T hz;
          if (diag_h) {
            hz = c.lpd[i] * c.z[i];
          } else {
            hz = T(0);
            for (int j = 0; j < n; ++j) hz += hess(c.H, i, j) * c.z[j];
          }
          const T rd = hz + c.f[i] + colm[i] * c.gl[i];
          c.rd[i] = rd;
          nd += rd * rd;
          if (!last) x[r] = -rd + colm[i] * c.gt[i];
        }
      }
      nd = warp_sum(nd);
      const T m = sqrt(nd) + sqrt(c.xsc[6]) + gap;
      const bool take = m < bm;  // NaN never wins
      if (last) {
        if (ln == 0) c.flag[0] = take ? 0 : 1;  // restore the best
        if (!take)
          for (int i = ln; i < n; i += 32) c.z[i] = c.bz[i];
      } else {
        if (take) {
          bm = m;
          for (int i = ln; i < n; i += 32) c.bz[i] = c.z[i];
        }
        if (ln == 0) c.flag[0] = take ? 1 : 0;
        __syncwarp();
        warp_factor<T, R, true>(c.L, n, c.ldn, ln);
        __syncwarp();
        warp_chol_solve<T, R>(c.L, c.ldn, n, x, ln);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = ln + 32 * r;
          if (i < n) {
            c.dz[i] = x[r];
            c.zc[i] = colm[i] * x[r];
          }
        }
      }
    }
    __syncthreads();
    if (last) break;

    // predictor: ds, dl, the step's ratios and the mu_aff sums
    MinRatio<T> mr;
    T s1 = T(0), s2 = T(0);
    const bool take = c.flag[0] != 0;
#pragma unroll 2
    for (int k = threadIdx.x; k < c.kb; k += kBandThreads) {
      if (take) {
        c.at(RS_BLAM, k) = c.at(RS_LAM, k);
        c.at(RS_BLAM + 1, k) = c.at(RS_LAM + 1, k);
      }
      T gh, gl;
      row_g(c, k, c.zc, gh, gl);
      const T rml = c.grow[k] >= 0 ? T(1) : T(0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const T rm = h ? rml : T(1);
        const T lam = c.at(RS_LAM + h, k), s = c.at(RS_S + h, k);
        const T ds = -(c.at(RS_RP + h, k) + (h ? gl : gh));
        const T dl = -(lam * s + lam * ds) / s * rm;
        c.at(RS_DS + h, k) = ds;
        c.at(RS_DL + h, k) = dl;
        if (ds < T(0)) mr.add(s, -ds);
        if (dl < T(0)) mr.add(lam, -dl);
        s1 += lam * ds + s * dl;
        s2 += dl * ds;
      }
    }
    T S1, S2;
    T mn = cluster_step<T, true>(c, mr.value(), s1, s2, S1, S2);
    const T a_aff = nmin(T(1), T(0.995) * mn);
    const T mu_aff = (gap + a_aff * S1 + a_aff * a_aff * S2) / c.nact;
    const T sig_r = mu_aff / (mu + T(1e-30));
    const T sigma = sig_r * sig_r * sig_r;

    // corrector: r_cent (over dl) and t
    {
      T v[1] = {T(0)};
#pragma unroll 2
      for (int k = threadIdx.x; k < c.kb; k += kBandThreads) {
        const T rml = c.grow[k] >= 0 ? T(1) : T(0);
        T t2[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const T rm = h ? rml : T(1);
          const T lam = c.at(RS_LAM + h, k), s = c.at(RS_S + h, k);
          const T rc = (lam * s - sigma * mu + c.at(RS_DL + h, k) *
                        c.at(RS_DS + h, k)) * rm;
          c.at(RS_DL + h, k) = rc;
          const T w = nmin(lam / s, w_cap) * rm;
          t2[h] = rm * (rc / s - w * c.at(RS_RP + h, k));
        }
        c.at(RS_EXT + 2, k) = t2[0] - t2[1];
        v[0] += c.at(RS_SCV, k) * t2[0] + c.at(RS_SCV + 1, k) * t2[1];
      }
      const int idx[1] = {SC_ST};
      warp_scalars(c, v, idx);
      __syncthreads();
      block_scalars(c, idx);
      cross_rows(c, t_e, t_end);
    }
    c.sync_cluster();
    if (warp == 0) {
      T x[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = ln + 32 * r;
        x[r] = T(0);
        if (i < n) {
          const T g = i < ncol ? c.xsum(ext_out(c, t_e, i, 2))
                      : i == n - 1 ? c.xsum(c.xsc + SC_ST) : T(0);
          x[r] = -c.rd[i] + colm[i] * g;
        }
      }
      warp_chol_solve<T, R>(c.L, c.ldn, n, x, ln);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = ln + 32 * r;
        if (i < n) {
          c.dz[i] = x[r];
          c.zc[i] = colm[i] * x[r];
        }
      }
    }
    __syncthreads();
    MinRatio<T> mr2;
#pragma unroll 2
    for (int k = threadIdx.x; k < c.kb; k += kBandThreads) {
      T gh, gl;
      row_g(c, k, c.zc, gh, gl);
      const T rml = c.grow[k] >= 0 ? T(1) : T(0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const T rm = h ? rml : T(1);
        const T lam = c.at(RS_LAM + h, k), s = c.at(RS_S + h, k);
        const T ds = -(c.at(RS_RP + h, k) + (h ? gl : gh));
        const T dl = -(c.at(RS_DL + h, k) + lam * ds) / s * rm;
        c.at(RS_DS + h, k) = ds;
        c.at(RS_DL + h, k) = dl;
        if (ds < T(0)) mr2.add(s, -ds);
        if (dl < T(0)) mr2.add(lam, -dl);
      }
    }
    T unused;
    mn = cluster_step<T, false>(c, mr2.value(), T(0), T(0), unused, unused);
    const T step = nmin(T(1), T(0.995) * mn);
    for (int k = threadIdx.x; k < c.kb; k += kBandThreads) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        c.at(RS_LAM + h, k) = c.at(RS_LAM + h, k) + step * c.at(RS_DL + h, k);
        c.at(RS_S + h, k) = c.at(RS_S + h, k) + step * c.at(RS_DS + h, k);
      }
    }
    for (int i = threadIdx.x; i < n; i += kBandThreads) {
      c.z[i] = c.z[i] + step * c.dz[i];
      c.zc[i] = colm[i] * c.z[i];
    }
  }
  // the best iterate, if the last was not better (flag from warp 0)
  if (c.flag[0]) {
    for (int k = threadIdx.x; k < c.kb; k += kBandThreads) {
      c.at(RS_LAM, k) = c.at(RS_BLAM, k);
      c.at(RS_LAM + 1, k) = c.at(RS_BLAM + 1, k);
    }
  }
  __syncthreads();
}

// The block's K-rows: the candidate's active rows (rmask != 0) in the
// order [non-band rows | slack rows | band pairs], cut into C contiguous
// slices; this block's slice lands in grow (its hi row; -1 - row for a
// row without a lo partner).  The list is built in buf (as ints).
template <typename T>
__device__ void k_rows(Band<T>& c, const T* rm, int rank) {
  const BandShape& s = c.a.s;
  int* list = reinterpret_cast<int*>(c.buf);
  int* wcnt = c.flag;  // kBandWarps ints fit in the 4 T of flag
  const int ln = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nsingle = s.mc - 2 * s.pny;
  int count = 0;
  for (int base = 0; base < nsingle + s.pny; base += kBandThreads) {
    const int j = base + threadIdx.x;
    int r = -1;
    if (j < nsingle)
      r = j < s.nmv ? j : j + 2 * s.pny;  // the tail rows after the bands
    else if (j < nsingle + s.pny)
      r = s.nmv + (j - nsingle);  // a pair's hi row
    const bool f = r >= 0 && rm[r] != T(0);
    const unsigned m = __ballot_sync(kWarpMask, f);
    if (ln == 0) wcnt[w] = __popc(m);
    __syncthreads();
    int off = count, tot = count;
    for (int ww = 0; ww < kBandWarps; ++ww) {
      if (ww < w) off += wcnt[ww];
      tot += wcnt[ww];
    }
    if (f) {
      const bool pair = j >= nsingle;
      list[off + __popc(m & ((1u << ln) - 1u))] = pair ? r : -1 - r;
    }
    __syncthreads();
    count = tot;
  }
  const int k0 = (int)((long long)count * rank / c.C);
  const int k1 = (int)((long long)count * (rank + 1) / c.C);
  c.kb = k1 - k0;
  for (int k = threadIdx.x; k < c.kb; k += kBandThreads)
    c.grow[k] = list[k0 + k];
  __syncthreads();
}

template <typename T, int R>
__global__ void __launch_bounds__(kBandThreads, 1)
closed_sim_band_kernel(const __grid_constant__ BandArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const BandShape& s = a.s;
  const BandPlan p = band_plan_for(s, a.cluster);
  Band<T> c(a);
  const int rank = a.cluster > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int lane = blockIdx.x / a.cluster, B = a.B, n = s.n;
  c.n = n;
  c.ld = p.ld;
  c.ldn = p.ldn;
  c.kbc = p.kb;
  c.C = a.cluster;
  c.slot = 0;
  c.L = sm + p.L;
  c.H = sm + p.H;
  T* v = sm + p.vec;
  T** vecs[13] = {&c.z, &c.bz, &c.dz, &c.zc, &c.rd, &c.fq, &c.fl, &c.zw,
                  &c.lpd, &c.cm, &c.cm2, &c.gl, &c.gt};
  for (int i = 0; i < 13; ++i) *vecs[i] = v + (size_t)i * n;
  c.xpl = sm + p.est;
  c.xpl2 = c.xpl + s.nxp;
  c.xhp = c.xpl2 + s.nxp;
  c.xhat = c.xhp + s.nxa;
  c.ys = c.xhat + s.nxa;
  c.up = c.ys + s.ny;
  c.uo = c.up + s.nu;
  c.red = sm + p.red;
  c.xsc = sm + p.xsc;
  c.slots = sm + p.slot;
  c.flag = reinterpret_cast<int*>(sm + p.flag);
  c.tile = sm + p.tile;
  c.rs = sm + p.rows;
  c.grow = reinterpret_cast<int*>(sm + p.grow);
  c.buf = sm + p.buf;

  // lane constants, the active sizes and this block's K-rows
  const T* rm = a.rmask + (size_t)lane * s.mc;
  const T* Hg = a.Hp + (size_t)lane * n * n;
  for (int e = threadIdx.x; e < n * (n + 1) / 2; e += kBandThreads) {
    int i = 0;
    while ((i + 1) * (i + 2) / 2 <= e) ++i;
    c.H[e] = Hg[i * n + (e - i * (i + 1) / 2)];
  }
  for (int i = threadIdx.x; i < n; i += kBandThreads) {
    c.lpd[i] = a.lpd[(size_t)lane * n + i];
    c.cm[i] = a.cmask[(size_t)lane * n + i];
    c.cm2[i] = a.cmask2[(size_t)lane * n + i];
    c.zw[i] = T(0);
    c.fl[i] = i == n - 1 ? T(1) : T(0);
  }
  T nact = T(0);
  for (int r = threadIdx.x; r < s.mc; r += kBandThreads) nact += rm[r];
  nact = warp_sum(nact);
  if ((threadIdx.x & 31) == 0) c.red[(threadIdx.x >> 5) * 8] = nact;
  for (int i = threadIdx.x; i < s.nxp; i += kBandThreads) c.xpl[i] = T(0);
  for (int i = threadIdx.x; i < s.nxa; i += kBandThreads) c.xhp[i] = T(0);
  for (int i = threadIdx.x; i < s.nu; i += kBandThreads) c.up[i] = T(0);
  __syncthreads();
  nact = c.red[0];
  for (int w = 1; w < kBandWarps; ++w) nact += c.red[w * 8];
  c.nact = nmax(nact, T(1));
  int ncol = 0;
  for (int i = 0; i < n - 1; ++i)
    if (c.cm[i] != T(0)) ncol = i + 1;
  c.ncol = ncol;
  c.nt = (ncol + 3) / 4;
  c.ntri = c.nt * (c.nt + 1) / 2;
  __syncthreads();  // red is read before k_rows reuses flag and buf
  k_rows(c, rm, rank);
  // the slice's G0 coefficients and slack column; the warm pair
  for (int idx = threadIdx.x; idx < c.kb * p.ld + 4; idx += kBandThreads) {
    const int k = idx / p.ld, i = idx - k * p.ld;
    T val = T(0);
    if (k < c.kb && i < ncol) {
      const int g = c.grow[k];
      val = a.G0[(size_t)(g >= 0 ? g : -1 - g) * n + i];
    }
    c.tile[idx] = val;
  }
  for (int k = threadIdx.x; k < c.kb; k += kBandThreads) {
    const int g = c.grow[k], r = g >= 0 ? g : -1 - g;
    c.at(RS_SCV, k) = a.G0[(size_t)r * n + n - 1];
    c.at(RS_SCV + 1, k) = g >= 0 ? a.G0[(size_t)(r + s.pny) * n + n - 1] : T(0);
    c.at(RS_LAMW, k) = T(1);
    c.at(RS_LAMW + 1, k) = g >= 0 ? T(1) : T(0);
    c.at(RS_EXT + 3, k) = T(0);
  }
  __syncthreads();

  const T* sfy = a.sfy + (size_t)lane * s.ny;
  const T* sfu = a.sfu + (size_t)lane * s.nu;
  const T* q = a.q + (size_t)lane * s.pny;
  const T* hbu = a.hbu + (size_t)lane * s.nmv;
  const T* su = a.su + (size_t)lane * s.nmv;
  const T* hbyh = a.hbyh + (size_t)lane * s.pny;
  const T* rmyh = a.rmyh + (size_t)lane * s.pny;
  const T* hbyl = a.hbyl + (size_t)lane * s.pny;
  const T* rmyl = a.rmyl + (size_t)lane * s.pny;
  const size_t bv_row = s.ny, bpl_row = (size_t)s.ny + s.nxa,
               sv_row = (size_t)s.ny + s.nxa + s.nxp;
  T* fr = c.buf;           // the free response of every band row
  T* trk = c.buf + s.pny;  // the tracking error
  const bool out = rank == 0;

  for (int k = 0; k < a.nit; ++k) {
    const T* Vk = a.Vt + k;  // column k: Vk[row * nit]
    const int nit = a.nit;
    // plant output, Kalman update
    thread_rows(a.Cpl, s.ny, s.nxp, c.xpl, [&](int i, T y) {
      if (out) a.Y[((size_t)k * s.ny + i) * B + lane] = y;
      c.ys[i] = y / sfy[i];
    });
    __syncthreads();
    thread_rows(a.C, s.ny, s.nxa, c.xhp, [&](int i, T cx) {
      c.ys[i] = c.ys[i] - cx - Vk[(size_t)i * nit];
    });
    __syncthreads();
    thread_rows(a.Mk, s.nxa, s.ny, c.ys,
              [&](int i, T m) { c.xhat[i] = c.xhp[i] + m; });
    __syncthreads();
    // free response -> tracking error and the band rows' rhs
    thread_rows(a.SxF, s.pny, s.nxa, c.xhat, [&](int pp, T f1) {
      T f2 = T(0);
      for (int j = 0; j < s.nu; ++j) f2 += a.SstF[pp * s.nu + j] * c.up[j];
      const T f = f1 + f2 + Vk[(sv_row + pp) * nit];
      const T rk = a.r[((size_t)k * s.ny + pp % s.ny) * B + lane];
      fr[pp] = f;
      trk[pp] = q[pp] * (rk - f);
    });
    __syncthreads();
    warp_rows(a.ThT, n, s.pny, trk,
              [&](int i, T vv) { c.fq[i] = c.cm[i] * (T(-2) * vv); });
    for (int kk = threadIdx.x; kk < c.kb; kk += kBandThreads) {
      const int g = c.grow[kk];
      T hh = T(0), hl = T(1);
      if (g >= 0) {
        const int pp = g - s.nmv;
        hh = hbyh[pp] - rmyh[pp] * fr[pp];
        hl = hbyl[pp] + rmyl[pp] * fr[pp];
      } else if (-1 - g < s.nmv) {
        const int r = -1 - g;
        hh = hbu[r] + su[r] * c.up[r % s.nu];
      }
      c.at(RS_H, kk) = hh;
      c.at(RS_H + 1, kk) = hl;
    }
    for (int i = threadIdx.x; i < n; i += kBandThreads) c.z[i] = c.zw[i];
    __syncthreads();

    // slack seeding from the carried pair (z, lam) = (zw, lamw)
    {
      const T extra = slack_violation(c, c.cm);
      const T eps_w = nmax(c.zw[n - 1], T(0));
      const bool jumped = extra > T(1e-3) * (T(1) + eps_w);
      if (threadIdx.x == 0) c.z[n - 1] = eps_w + extra + T(1e-6);
      for (int kk = threadIdx.x; kk < c.kb; kk += kBandThreads) {
        c.at(RS_LAM, kk) = jumped ? T(1) : c.at(RS_LAMW, kk);
        c.at(RS_LAM + 1, kk) = jumped ? T(1) : c.at(RS_LAMW + 1, kk);
      }
      __syncthreads();
    }
    // stage 0: the slack LP, f = e_slack against diag(lpd)
    c.f = c.fl;
    pdip<T, R>(c, true, c.cm, a.lp_iters);
    // carry (z1, lam1); stage 2 freezes the slack
    for (int i = threadIdx.x; i < n; i += kBandThreads) c.zw[i] = c.z[i];
    for (int kk = threadIdx.x; kk < c.kb; kk += kBandThreads) {
      c.at(RS_LAMW, kk) = c.at(RS_LAM, kk);
      c.at(RS_LAMW + 1, kk) = c.at(RS_LAM + 1, kk);
    }
    {
      const T extra = slack_violation(c, c.cm);
      const T ehat =
          (nmax(c.z[n - 1], T(0)) + extra) * (T(1) + a.m_rel) + a.m_abs;
      if (out && threadIdx.x == 0) a.E[(size_t)k * B + lane] = ehat;
      for (int kk = threadIdx.x; kk < c.kb; kk += kBandThreads) {
        const T rml = c.grow[kk] >= 0 ? T(1) : T(0);
        c.at(RS_H, kk) = c.at(RS_H, kk) - c.at(RS_SCV, kk) * ehat;
        c.at(RS_H + 1, kk) =
            c.at(RS_H + 1, kk) - c.at(RS_SCV + 1, kk) * rml * ehat;
      }
      __syncthreads();
      if (threadIdx.x == 0) c.z[n - 1] = T(0);
      __syncthreads();
    }
    c.f = c.fq;
    pdip<T, R>(c, false, c.cm2, a.s2_iters);

    // input, model and plant steps
    for (int j = threadIdx.x; j < s.nu; j += kBandThreads) {
      const T us = c.up[j] + c.z[j];
      c.up[j] = us;
      c.uo[j] = us * sfu[j];
      if (out) a.U[((size_t)k * s.nu + j) * B + lane] = c.uo[j];
    }
    __syncthreads();
    thread_rows(a.A, s.nxa, s.nxa, c.xhat, [&](int i, T x1) {
      T x2 = T(0);
      for (int j = 0; j < s.nu; ++j) x2 += a.Bu[i * s.nu + j] * c.up[j];
      c.xhp[i] = x1 + x2 + Vk[(bv_row + i) * nit];
    });
    thread_rows(a.Apl, s.nxp, s.nxp, c.xpl, [&](int i, T x1) {
      T x2 = T(0);
      for (int j = 0; j < s.nu; ++j) x2 += a.Bplu[i * s.nu + j] * c.uo[j];
      c.xpl2[i] = x1 + x2 + Vk[(bpl_row + i) * nit];
    });
    __syncthreads();
    for (int i = threadIdx.x; i < s.nxp; i += kBandThreads) c.xpl[i] = c.xpl2[i];
    // the next step writes buf, which the cluster's blocks read up to the
    // last merit; and no block leaves while another may read its memory
    c.sync_cluster();
  }
}

// ----------------------------------------------------------------- launch

enum {
  BP_CPL, BP_APL, BP_BPLU, BP_C, BP_MK, BP_A, BP_BU, BP_SXF, BP_SSTF, BP_THT,
  BP_VT, BP_G0, BP_Q, BP_HBU, BP_SU, BP_HBYH, BP_RMYH, BP_HBYL, BP_RMYL,
  BP_RMASK, BP_CMASK, BP_CMASK2, BP_LPD, BP_SFY, BP_SFU, BP_HP, BP_R, BP_Y,
  BP_U, BP_E, BP_COUNT
};

enum { BD_B, BD_NIT, BD_LP, BD_S2, BD_NY, BD_NU, BD_NXA, BD_NXP, BD_PNY,
       BD_N, BD_MC, BD_NMV, BD_COUNT };

inline BandShape band_shape(const int* d) {
  return BandShape{d[BD_N], d[BD_MC], d[BD_PNY], d[BD_NY], d[BD_NU],
                   d[BD_NXA], d[BD_NXP], d[BD_NMV]};
}

// The launcher's envelope: n in [2, kBandMaxN], the rows laid out as
// [nmv move/input rows | pny y_hi | pny y_lo | slack rows], and a plan.
inline bool band_inside(const BandShape& s, const BandPlan& p) {
  return s.n >= 2 && s.n <= kBandMaxN && s.nmv >= 0 && s.pny >= 1 &&
         s.mc > s.nmv + 2 * s.pny && p.C > 0;
}

template <typename T>
BandArgs<T> make_band_args(void* const* p, const int* d, const double* c) {
  BandArgs<T> a;
  const T** tabs[] = {&a.Cpl, &a.Apl, &a.Bplu, &a.C, &a.Mk, &a.A, &a.Bu,
                      &a.SxF, &a.SstF, &a.ThT, &a.Vt, &a.G0};
  for (int i = 0; i < 12; ++i) *tabs[i] = static_cast<const T*>(p[BP_CPL + i]);
  const T** lcs[] = {&a.q, &a.hbu, &a.su, &a.hbyh, &a.rmyh, &a.hbyl, &a.rmyl,
                     &a.rmask, &a.cmask, &a.cmask2, &a.lpd, &a.sfy, &a.sfu,
                     &a.Hp, &a.r};
  for (int i = 0; i < 15; ++i) *lcs[i] = static_cast<const T*>(p[BP_Q + i]);
  a.Y = static_cast<T*>(p[BP_Y]);
  a.U = static_cast<T*>(p[BP_U]);
  a.E = static_cast<T*>(p[BP_E]);
  a.s = band_shape(d);
  a.B = d[BD_B];
  a.nit = d[BD_NIT];
  a.lp_iters = d[BD_LP];
  a.s2_iters = d[BD_S2];
  a.eps_c = static_cast<T>(c[0]);
  a.ridge = static_cast<T>(c[1]);
  a.w_cap = static_cast<T>(c[2]);
  a.m_rel = static_cast<T>(c[3]);
  a.m_abs = static_cast<T>(c[4]);
  return a;
}

template <typename T, int R>
int launch_band(BandArgs<T> a, const BandPlan& p, cudaStream_t st) {
  const size_t bytes = p.total * sizeof(T);
  auto kern = closed_sim_band_kernel<T, R>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  a.cluster = p.C;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.B * p.C));
  cfg.blockDim = dim3(kBandThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = (unsigned)p.C;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace mpc

extern "C" {

int mpc_closed_sim_band_ptr_count() { return mpc::BP_COUNT; }

int mpc_closed_sim_band_dim_count() { return mpc::BD_COUNT; }

int mpc_closed_sim_band_max_n() { return mpc::kBandMaxN; }

// Blocks a cluster of the launch of this shape (0 outside the envelope),
// and in bytes its shared memory a block.
int mpc_closed_sim_band_plan(const int* dims, long long* bytes) {
  const mpc::BandShape s = mpc::band_shape(dims);
  const mpc::BandPlan p = mpc::band_plan(s);
  *bytes = (long long)p.total * 8;
  return mpc::band_inside(s, p) ? p.C : 0;
}

// Band cases run at float64 only (float32 band loops leave the hard input
// bounds; see ops/kernels.closed_sim_band), so only double is instantiated.
int mpc_closed_sim_band(void* const* ptrs, const int* dims, const double* scal,
                        void* stream) {
  const mpc::BandShape s = mpc::band_shape(dims);
  const mpc::BandPlan p = mpc::band_plan(s);
  if (!mpc::band_inside(s, p) || dims[mpc::BD_B] < 1)
    return (int)cudaErrorInvalidValue;
  const mpc::BandArgs<double> a = mpc::make_band_args<double>(ptrs, dims, scal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return s.n <= 32 ? mpc::launch_band<double, 1>(a, p, st)
                   : mpc::launch_band<double, 2>(a, p, st);
}

}  // extern "C"
