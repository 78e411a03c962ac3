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
// matrix G' W G costs ~n^2/2 multiply-adds per band row, the G and G'
// products ~n per row, all in a serial chain of nit x (lp + s2) iterations.
// A thread per candidate (closed_sim.cu) would run that chain on one
// thread, so the design spreads each candidate over a thread block:
//  * one block of kBandThreads threads per candidate lane (grid = B);
//  * row work (G z, G' y, residuals, step-length minima, merit norms) is
//    spread over the threads, with deterministic block reductions that
//    keep jnp.min / jnp.max NaN semantics (nmin / nmax, common.cuh);
//  * the band rows come in +-pairs that share Theta up to sign, so the
//    kernel works on pairs: one dot product gives both rows of G z, and
//    G' W G takes Theta' diag(w_hi + w_lo) Theta (the same sum, regrouped)
//    plus the slack column; only the candidate's active rows and columns
//    (rmask, cmask) are visited, exact since the rest add exact zeros;
//  * the normal matrix is spread over the active entries of its lower
//    triangle (registers per thread) and, when they are few, over groups
//    of band rows too; G0's few other rows (move, input and slack bounds)
//    enter through a precomputed list of their G0[r,a] G0[r,b] terms per
//    entry;
//  * the normal matrix, its factor and Hp stay in shared memory; one warp
//    factors it and runs the substitutions;
//  * the per-lane mc-vectors (with the lane's rmask and G0's slack column)
//    live in shared memory where they fit, else in a global scratch buffer
//    (per block, contiguous); the active Theta block takes the rest of
//    shared memory: held there for the whole launch when it fits, else
//    streamed through it in chunks of band rows at each normal matrix.
// Measured on the H100 (PERF.md): latency-bound by the serial chain of
// block-wide phases, far above the operation bound.
// Envelope: n <= kBandMaxN variables (checked by the wrapper).

#include "common.cuh"

namespace mpc {

constexpr int kBandThreads = 256;
constexpr int kBandWarps = kBandThreads / 32;
constexpr int kBandMaxN = 64;
constexpr int kBandEntries =
    (kBandMaxN * (kBandMaxN + 1) / 2 + kBandThreads - 1) / kBandThreads;
constexpr int kBandChunk = 32;     // least band rows of the Theta tile
constexpr int kBandMaxRows = 1024;  // most band rows of the Theta tile
constexpr int kBandVecs = 12;       // per-lane mc-vectors
constexpr size_t kSmemLimit = 232448;

template <typename T>
struct BandArgs {
  // shared tables, row-major
  const T *Cpl, *Apl, *Bplu, *C, *Mk, *A, *Bu, *SxF, *SstF, *ThT, *Vt;
  const int *s_ptr, *s_col;  // G0 without its band rows, by rows (CSR)
  const T* s_val;
  const int *st_ptr, *st_row;  // the same, by columns
  const T* st_val;
  const int *e_ptr, *e_row;  // their G0[r,a] G0[r,b] terms per lower entry
  const T* e_coef;
  const T* GbT;   // (n - 1, pny): G0's y_hi rows without the slack column
  const T* scol;  // (mc): G0's slack column
  // per lane, batch-major (B, rows)
  const T *q, *hbu, *su, *hbyh, *rmyh, *hbyl, *rmyl, *rmask, *cmask,
      *cmask2, *lpd, *sfy, *sfu, *Hp;
  const T* r;  // (nit, ny, B)
  T* Y;        // (nit, ny, B)
  T* U;        // (nit, nu, B)
  T* E;        // (nit, B): each step's frozen slack ehat
  T* work;     // (B, kBandVecs * mc) when the vectors leave shared memory
  int B, nit, lp_iters, s2_iters, ny, nu, nxa, nxp, pny, n, mc, nmv;
  T eps_c, ridge, w_cap, m_rel, m_abs;
};

// Offsets (in elements of T) into the block's dynamic shared memory.
struct BandLayout {
  size_t z, bz, dz, rd, rhs, f, fl, zw, lpd, cm, cm2, L, H, part, xpl, xpl2,
      xhp, xhat, ys, up, uo, red, vec, tile, wb, trows, total;
  bool vec_smem;
  __host__ __device__ BandLayout(int n, int nxa, int nxp, int ny, int nu,
                                 int mc, size_t tsize) {
    size_t o = 0;
    z = o; o += n;
    bz = o; o += n;
    dz = o; o += n;
    rd = o; o += n;
    rhs = o; o += n;
    f = o; o += n;
    fl = o; o += n;
    zw = o; o += n;
    lpd = o; o += n;
    cm = o; o += n;
    cm2 = o; o += n;
    L = o; o += (size_t)n * n;
    H = o; o += (size_t)n * n;
    part = o;
    o += (size_t)(n * (n + 1) / 2 > kBandThreads ? n * (n + 1) / 2 : kBandThreads);
    xpl = o; o += nxp;
    xpl2 = o; o += nxp;
    xhp = o; o += nxa;
    xhat = o; o += nxa;
    ys = o; o += ny;
    up = o; o += nu;
    uo = o; o += nu;
    red = o; o += 3 * kBandWarps;
    // the mc-vectors first, if they fit beside the least tile; then the
    // Theta tile takes what is left, up to kBandMaxRows band rows
    const size_t cap = kSmemLimit / tsize, row_el = (size_t)n + 3;
    const size_t vec_el = (size_t)kBandVecs * mc;
    vec_smem = o + vec_el + kBandChunk * row_el <= cap;
    vec = o;
    if (vec_smem) o += vec_el;
    size_t rows = (cap - o) / row_el;
    rows = rows < (size_t)kBandMaxRows ? rows : (size_t)kBandMaxRows;
    trows = rows - rows % kBandChunk;
    tile = o; o += trows * n;
    wb = o; o += 3 * trows;
    total = o;
  }
};

struct SumOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};
struct MinOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return nmin(a, b); }
};
struct MaxOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return nmax(a, b); }
};

// Butterfly reduction: every lane ends with the same value (the pairings
// are commutative, so sums agree to the bit across lanes).
template <typename T, typename Op>
__device__ __forceinline__ T warp_reduce(T v, Op op) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reduction in a fixed order; every thread gets the result.
template <typename T, typename Op>
__device__ T block_reduce(T v, T* red, Op op) {
  v = warp_reduce(v, op);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T r = red[0];
  for (int i = 1; i < kBandWarps; ++i) r = op(r, red[i]);
  __syncthreads();
  return r;
}

template <typename T>
__device__ void block_sum3(T& a, T& b, T& c, T* red) {
  a = warp_reduce(a, SumOp());
  b = warp_reduce(b, SumOp());
  c = warp_reduce(c, SumOp());
  if ((threadIdx.x & 31) == 0) {
    const int w = threadIdx.x >> 5;
    red[w] = a;
    red[kBandWarps + w] = b;
    red[2 * kBandWarps + w] = c;
  }
  __syncthreads();
  a = red[0];
  b = red[kBandWarps];
  c = red[2 * kBandWarps];
  for (int i = 1; i < kBandWarps; ++i) {
    a += red[i];
    b += red[kBandWarps + i];
    c += red[2 * kBandWarps + i];
  }
  __syncthreads();
}

// One block's view: arguments, shared vectors, the active band-pair count
// prow and active du-column count ncol.
template <typename T>
struct Band {
  const BandArgs<T>& a;
  int n, nmv, pny, prow, ncol, ntail, nrows, trows;
  bool resident;  // the whole active Theta block lives in the tile
  T *z, *bz, *dz, *rd, *rhs, *f, *fq, *fl, *zw, *lpd, *cm, *cm2, *L, *H,
      *part, *tile, *wsum, *ws, *wss, *red;
  T *h, *lam, *s, *blam, *rp, *w, *ds, *dl, *t, *lamw, *rm, *scv;  // mc
  T nact;

  __device__ Band(const BandArgs<T>& args) : a(args) {}

  // G0[y_hi row p, column i], from the tile when it holds every band row
  __device__ __forceinline__ T gb(int i, int p) const {
    return resident ? tile[p * n + i] : a.GbT[(size_t)i * pny + p];
  }

  // active row j -> row index: move/input rows, active y_hi, active y_lo,
  // then the slack row(s)
  __device__ __forceinline__ int row(int j) const {
    if (j < nmv + prow) return j;
    if (j < nmv + 2 * prow) return j - prow + pny;
    return j - 2 * prow + 2 * pny;
  }
};

// out = rmask * (G0 (colmask * x)) on the active rows.
template <typename T>
__device__ void gmat(const Band<T>& c, const T* x, const T* colm, T* out) {
  const BandArgs<T>& a = c.a;
  const T xs = colm[c.n - 1] * x[c.n - 1];
  for (int j = threadIdx.x; j < c.nmv + c.prow + c.ntail; j += kBandThreads) {
    if (j >= c.nmv && j < c.nmv + c.prow) {
      const int p = j - c.nmv;
      T d = T(0);
#pragma unroll 8
      for (int i = 0; i < c.ncol; ++i) d += c.gb(i, p) * (colm[i] * x[i]);
      const int rh = c.nmv + p, rl = rh + c.pny;
      out[rh] = c.rm[rh] * (d + c.scv[rh] * xs);
      out[rl] = c.rm[rl] * (-d + c.scv[rl] * xs);
    } else {
      const int r = j < c.nmv ? j : j - c.prow + 2 * c.pny;
      T acc = T(0);
      for (int k = a.s_ptr[r]; k < a.s_ptr[r + 1]; ++k) {
        const int i = a.s_col[k];
        acc += a.s_val[k] * (colm[i] * x[i]);
      }
      out[r] = c.rm[r] * acc;
    }
  }
}

// out = colmask * (G0' y) for y already multiplied by rmask; one warp per
// column.
template <typename T>
__device__ void gtmat(const Band<T>& c, const T* y, const T* colm, T* out) {
  const BandArgs<T>& a = c.a;
  const int ln = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < c.n; i += kBandWarps) {
    const bool slack = i == c.n - 1;
    T acc = T(0);
    if (slack || i < c.ncol) {
      if (slack) {
        for (int p = ln; p < c.prow; p += 32) {
          const int rh = c.nmv + p, rl = rh + c.pny;
          acc += c.scv[rh] * y[rh] + c.scv[rl] * y[rl];
        }
      } else {
#pragma unroll 8
        for (int p = ln; p < c.prow; p += 32)
          acc += c.gb(i, p) * (y[c.nmv + p] - y[c.nmv + c.pny + p]);
      }
      for (int k = a.st_ptr[i] + ln; k < a.st_ptr[i + 1]; k += 32)
        acc += a.st_val[k] * y[a.st_row[k]];
      acc = warp_reduce(acc, SumOp());
    }
    if (ln == 0) out[i] = colm[i] * acc;
  }
}

// Row and column of lower-triangle entry e (row-major order).
__device__ __forceinline__ void tri_entry(int e, int& ia, int& ib) {
  int r = (int)((sqrt(8.0 * e + 1.0) - 1.0) * 0.5);
  while ((r + 1) * (r + 2) / 2 <= e) ++r;
  while (r * (r + 1) / 2 > e) --r;
  ia = r;
  ib = e - r * (r + 1) / 2;
}

// Stage band rows [p0, p0 + np) of the active Theta columns in the tile.
template <typename T>
__device__ void load_tile(Band<T>& c, int p0, int np) {
  for (int idx = threadIdx.x; idx < np * c.ncol; idx += kBandThreads) {
    const int i = idx / np, pp = idx - i * np;
    c.tile[pp * c.n + i] = c.a.GbT[(size_t)i * c.pny + p0 + pp];
  }
}

// L (lower triangle) = Hbase + (G0' W G0) o (colm colm') + ridge I.  The
// band part runs over the ta active entries (du-du and the slack row) and
// the active band rows; with few entries the threads split the rows into
// groups, and the groups' partial sums meet in `part`.
template <typename T>
__device__ void normal_matrix(Band<T>& c, bool diag_h, const T* colm) {
  const BandArgs<T>& a = c.a;
  const int n = c.n, nc = c.ncol;
  const int tdd = nc * (nc + 1) / 2, ta = tdd + nc + 1;
  const int G = max(1, kBandThreads / ta);
  const int g = G > 1 ? threadIdx.x / ta : 0;
  T acc[kBandEntries];
  int ea[kBandEntries], eb[kBandEntries], ee[kBandEntries];
  int ne = 0;
#pragma unroll
  for (int k = 0; k < kBandEntries; ++k) {
    acc[k] = T(0);
    ea[k] = eb[k] = ee[k] = 0;
    const int e = G > 1 ? (k == 0 && g < G ? threadIdx.x - g * ta : ta)
                        : threadIdx.x + k * kBandThreads;
    if (e < ta) {
      if (e < tdd) {
        tri_entry(e, ea[k], eb[k]);
      } else {
        ea[k] = n - 1;
        eb[k] = e - tdd == nc ? n - 1 : e - tdd;
      }
      ee[k] = e;
      ne = k + 1;
    }
  }
  for (int p0 = 0; p0 < c.prow; p0 += c.trows) {
    const int np = min(c.trows, c.prow - p0);
    if (!c.resident) load_tile(c, p0, np);
    for (int pp = threadIdx.x; pp < np; pp += kBandThreads) {
      const int rh = c.nmv + p0 + pp, rl = rh + c.pny;
      const T wh = c.w[rh], wl = c.w[rl], sh = c.scv[rh], sl = c.scv[rl];
      c.wsum[pp] = wh + wl;
      c.ws[pp] = wh * sh - wl * sl;
      c.wss[pp] = wh * sh * sh + wl * sl * sl;
    }
    __syncthreads();
    for (int pp = g; pp < np; pp += G) {
      const T* tr = c.tile + pp * n;
      const T w1 = c.wsum[pp], w2 = c.ws[pp], w3 = c.wss[pp];
#pragma unroll
      for (int k = 0; k < kBandEntries; ++k) {
        if (k < ne) {
          const int ia = ea[k], ib = eb[k];
          acc[k] += ia < nc ? tr[ia] * tr[ib] * w1
                            : (ib < nc ? tr[ib] * w2 : w3);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kBandEntries; ++k)
    if (k < ne) c.part[g * ta + ee[k]] = acc[k];
  __syncthreads();
  for (int e = threadIdx.x; e < n * (n + 1) / 2; e += kBandThreads) {
    int ia, ib;
    tri_entry(e, ia, ib);
    const int ae = ia < nc ? ia * (ia + 1) / 2 + ib
                 : ia != n - 1 ? -1
                 : ib < nc ? tdd + ib
                 : ib == n - 1 ? tdd + nc : -1;
    T v = T(0);
    if (ae >= 0)
      for (int gg = 0; gg < G; ++gg) v += c.part[gg * ta + ae];
    for (int qq = a.e_ptr[e]; qq < a.e_ptr[e + 1]; ++qq)
      v += c.w[a.e_row[qq]] * a.e_coef[qq];
    const T hv = diag_h ? (ia == ib ? c.lpd[ia] : T(0)) : c.H[ia * n + ib];
    T m = hv + v * (colm[ia] * colm[ib]);
    if (ia == ib) m += a.ridge;
    c.L[ia * n + ib] = m;
  }
  __syncthreads();
}

// In-place lower Cholesky of L by warp 0; a non-positive pivot gives NaN
// (torch.linalg.cholesky_ex reports it and the plain factor returns NaN).
template <typename T>
__device__ void factor(Band<T>& c) {
  if (threadIdx.x >= 32) return;
  const int ln = threadIdx.x, n = c.n;
  T* L = c.L;
  for (int j = 0; j < n; ++j) {
    T part = T(0);
    for (int k = ln; k < j; k += 32) part += L[j * n + k] * L[j * n + k];
    const T d = L[j * n + j] - warp_reduce(part, SumOp());
    const T ljj = d > T(0) ? sqrt(d) : inf_value<T>() - inf_value<T>();
    for (int i = j + 1 + ln; i < n; i += 32) {
      T v = L[i * n + j];
      for (int k = 0; k < j; ++k) v -= L[i * n + k] * L[j * n + k];
      L[i * n + j] = v / ljj;
    }
    __syncwarp();
    if (ln == 0) L[j * n + j] = ljj;
    __syncwarp();
  }
}

// dz = (L L')^{-1} rhs by warp 0 (column-oriented substitutions).
template <typename T>
__device__ void solve(Band<T>& c) {
  if (threadIdx.x >= 32) return;
  const int ln = threadIdx.x, n = c.n;
  const T* L = c.L;
  T* x = c.dz;
  for (int i = ln; i < n; i += 32) x[i] = c.rhs[i];
  __syncwarp();
  for (int j = 0; j < n; ++j) {
    const T xj = x[j] / L[j * n + j];
    __syncwarp();
    for (int i = j + 1 + ln; i < n; i += 32) x[i] -= L[i * n + j] * xj;
    if (ln == 0) x[j] = xj;
    __syncwarp();
  }
  for (int j = n - 1; j >= 0; --j) {
    const T xj = x[j] / L[j * n + j];
    __syncwarp();
    for (int i = ln; i < j; i += 32) x[i] -= L[j * n + i] * xj;
    if (ln == 0) x[j] = xj;
    __syncwarp();
  }
}

// r_d = H z + f + G' lam, r_p = G z + s - h; returns the merit
// ||r_d|| + ||r_p|| + lam's and sets gap = lam's.  With `newton` also the
// weights w = min(lam / s, w_cap) rmask and the predictor's
// t = rmask (lam - w r_p).
template <typename T>
__device__ T residuals(Band<T>& c, bool diag_h, const T* colm, T& gap,
                       bool newton) {
  for (int j = threadIdx.x; j < c.nrows; j += kBandThreads) {
    const int r = c.row(j);
    c.t[r] = c.rm[r] * c.lam[r];
  }
  __syncthreads();
  gmat(c, c.z, colm, c.rp);
  gtmat(c, c.t, colm, c.rhs);
  __syncthreads();
  T nd = T(0), np = T(0), g = T(0);
  for (int i = threadIdx.x; i < c.n; i += kBandThreads) {
    T hz;
    if (diag_h) {
      hz = c.lpd[i] * c.z[i];
    } else {
      hz = T(0);
      for (int j = 0; j < c.n; ++j) hz += c.H[i * c.n + j] * c.z[j];
    }
    const T rd = hz + c.f[i] + c.rhs[i];
    c.rd[i] = rd;
    nd += rd * rd;
  }
  for (int j = threadIdx.x; j < c.nrows; j += kBandThreads) {
    const int r = c.row(j);
    const T rp = c.rp[r] + c.s[r] - c.h[r];
    c.rp[r] = rp;
    np += rp * rp;
    g += c.lam[r] * c.s[r];
    if (newton) {
      const T wr = nmin(c.lam[r] / c.s[r], c.a.w_cap) * c.rm[r];
      c.w[r] = wr;
      c.t[r] = c.rm[r] * (c.lam[r] - wr * rp);
    }
  }
  block_sum3(nd, np, g, c.red);
  gap = g;
  return sqrt(nd) + sqrt(np) + g;
}

// min(1, 0.995 * the smallest fraction-to-the-boundary ratio of (s, ds) and
// (lam, dl)); NaN propagates.
template <typename T>
__device__ T step_length(Band<T>& c) {
  const T inf = inf_value<T>();
  T mn = inf;
  for (int j = threadIdx.x; j < c.nrows; j += kBandThreads) {
    const int r = c.row(j);
    const T rs = c.ds[r] < T(0) ? -c.s[r] / c.ds[r] : inf;
    const T rl = c.dl[r] < T(0) ? -c.lam[r] / c.dl[r] : inf;
    mn = nmin(mn, nmin(rs, rl));
  }
  mn = block_reduce(mn, c.red, MinOp());
  return nmin(T(1), T(0.995) * mn);
}

// rhs = -r_d + G' t, then dz by the factor; then ds = -(r_p + G dz).
template <typename T>
__device__ void newton_dir(Band<T>& c, const T* colm) {
  gtmat(c, c.t, colm, c.rhs);
  __syncthreads();
  for (int i = threadIdx.x; i < c.n; i += kBandThreads)
    c.rhs[i] = -c.rd[i] + c.rhs[i];
  __syncthreads();
  solve(c);
  __syncthreads();
  gmat(c, c.dz, colm, c.ds);
  __syncthreads();
}

// Warm-started masked Mehrotra PDIP (the _pdip_fused_kernel body): z and
// lam hold the start on entry and the best iterate by merit on exit; s is
// recomputed from this h.  diag_h: the quadratic term is diag(lpd), else H.
template <typename T>
__device__ void pdip(Band<T>& c, bool diag_h, const T* colm, int iters) {
  const BandArgs<T>& a = c.a;
  gmat(c, c.z, colm, c.ds);
  __syncthreads();
  for (int j = threadIdx.x; j < c.nrows; j += kBandThreads) {
    const int r = c.row(j);
    const T l = nmax(c.lam[r], a.eps_c) * c.rm[r];
    c.lam[r] = l;
    c.blam[r] = l;
    c.s[r] = nmax(c.h[r] - c.ds[r], a.eps_c);
  }
  for (int i = threadIdx.x; i < c.n; i += kBandThreads) c.bz[i] = c.z[i];
  __syncthreads();
  T bm = inf_value<T>();
  for (int it = 0; it < iters; ++it) {
    T gap;
    const T mnew = residuals(c, diag_h, colm, gap, true);
    const T mu = gap / c.nact;
    if (mnew < bm) {  // block-uniform; NaN never wins
      for (int i = threadIdx.x; i < c.n; i += kBandThreads) c.bz[i] = c.z[i];
      for (int j = threadIdx.x; j < c.nrows; j += kBandThreads) {
        const int r = c.row(j);
        c.blam[r] = c.lam[r];
      }
      bm = mnew;
    }
    normal_matrix(c, diag_h, colm);
    factor(c);
    __syncthreads();

    // predictor
    newton_dir(c, colm);
    for (int j = threadIdx.x; j < c.nrows; j += kBandThreads) {
      const int r = c.row(j);
      const T dsa = -(c.rp[r] + c.ds[r]);
      c.ds[r] = dsa;
      c.dl[r] = -(c.lam[r] * c.s[r] + c.lam[r] * dsa) / c.s[r] * c.rm[r];
    }
    __syncthreads();
    const T a_aff = step_length(c);
    T mu_aff = T(0);
    for (int j = threadIdx.x; j < c.nrows; j += kBandThreads) {
      const int r = c.row(j);
      mu_aff += (c.lam[r] + a_aff * c.dl[r]) * (c.s[r] + a_aff * c.ds[r]);
    }
    mu_aff = block_reduce(mu_aff, c.red, SumOp()) / c.nact;
    const T sig_r = mu_aff / (mu + T(1e-30));
    const T sigma = sig_r * sig_r * sig_r;

    // corrector; r_cent overwrites dl
    for (int j = threadIdx.x; j < c.nrows; j += kBandThreads) {
      const int r = c.row(j);
      const T rc = (c.lam[r] * c.s[r] - sigma * mu + c.dl[r] * c.ds[r]) * c.rm[r];
      c.dl[r] = rc;
      c.t[r] = c.rm[r] * (rc / c.s[r] - c.w[r] * c.rp[r]);
    }
    __syncthreads();
    newton_dir(c, colm);
    for (int j = threadIdx.x; j < c.nrows; j += kBandThreads) {
      const int r = c.row(j);
      const T dsr = -(c.rp[r] + c.ds[r]);
      c.ds[r] = dsr;
      c.dl[r] = -(c.dl[r] + c.lam[r] * dsr) / c.s[r] * c.rm[r];
    }
    __syncthreads();
    const T step = step_length(c);
    for (int i = threadIdx.x; i < c.n; i += kBandThreads)
      c.z[i] = c.z[i] + step * c.dz[i];
    for (int j = threadIdx.x; j < c.nrows; j += kBandThreads) {
      const int r = c.row(j);
      c.lam[r] = c.lam[r] + step * c.dl[r];
      c.s[r] = c.s[r] + step * c.ds[r];
    }
    __syncthreads();
  }
  T gap;
  const T mlast = residuals(c, diag_h, colm, gap, false);
  if (!(mlast < bm)) {  // keep the best iterate
    for (int i = threadIdx.x; i < c.n; i += kBandThreads) c.z[i] = c.bz[i];
    for (int j = threadIdx.x; j < c.nrows; j += kBandThreads) {
      const int r = c.row(j);
      c.lam[r] = c.blam[r];
    }
  }
  __syncthreads();
}

// Largest soft-row violation of z per unit of slack coefficient (the
// shared core of the slack seeding and the stage-2 slack freeze).
template <typename T>
__device__ T slack_violation(Band<T>& c) {
  gmat(c, c.z, c.cm, c.ds);
  __syncthreads();
  T mx = T(0);
  for (int j = threadIdx.x; j < c.nrows; j += kBandThreads) {
    const int r = c.row(j);
    const T viol = nmax(c.ds[r] - c.h[r], T(0));
    const T V = nmax(-c.scv[r], T(0));
    mx = nmax(mx, V > T(1e-12) ? viol / nmax(V, T(1e-12)) : T(0));
  }
  return block_reduce(mx, c.red, MaxOp());
}

// y = M x for a row-major (rows, cols) table, one warp per row; lane 0
// hands (row, value) to put.
template <typename T, typename Put>
__device__ void warp_rows(const T* M, int rows, int cols, const T* x,
                          Put put) {
  const int ln = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < rows; i += kBandWarps) {
    T acc = T(0);
    for (int j = ln; j < cols; j += 32) acc += M[(size_t)i * cols + j] * x[j];
    acc = warp_reduce(acc, SumOp());
    if (ln == 0) put(i, acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kBandThreads)
closed_sim_band_kernel(const __grid_constant__ BandArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int lane = blockIdx.x, B = a.B, n = a.n, mc = a.mc;
  const BandLayout lay(n, a.nxa, a.nxp, a.ny, a.nu, mc, sizeof(T));
  Band<T> c(a);
  c.n = n;
  c.nmv = a.nmv;
  c.pny = a.pny;
  c.ntail = mc - a.nmv - 2 * a.pny;
  c.z = sm + lay.z; c.bz = sm + lay.bz; c.dz = sm + lay.dz;
  c.rd = sm + lay.rd; c.rhs = sm + lay.rhs;
  c.fq = sm + lay.f; c.fl = sm + lay.fl;  // the QP's f, the LP's e_slack
  c.zw = sm + lay.zw; c.lpd = sm + lay.lpd; c.cm = sm + lay.cm;
  c.cm2 = sm + lay.cm2; c.L = sm + lay.L; c.H = sm + lay.H;
  c.part = sm + lay.part;
  c.trows = (int)lay.trows;
  c.tile = sm + lay.tile; c.wsum = sm + lay.wb;
  c.ws = c.wsum + c.trows; c.wss = c.ws + c.trows;
  c.red = sm + lay.red;
  T* vb = lay.vec_smem ? sm + lay.vec
                       : a.work + (size_t)lane * kBandVecs * mc;
  T** vecs[kBandVecs] = {&c.h, &c.lam, &c.s, &c.blam, &c.rp, &c.w, &c.ds,
                         &c.dl, &c.t, &c.lamw, &c.rm, &c.scv};
  for (int v = 0; v < kBandVecs; ++v) *vecs[v] = vb + (size_t)v * mc;
  T* xpl = sm + lay.xpl; T* xpl2 = sm + lay.xpl2;
  T* xhp = sm + lay.xhp; T* xhat = sm + lay.xhat;
  T* ys = sm + lay.ys; T* up = sm + lay.up; T* uo = sm + lay.uo;

  // lane constants, active sizes and this thread's normal-matrix entries
  const T* Hg = a.Hp + (size_t)lane * n * n;
  for (int i = threadIdx.x; i < n * n; i += kBandThreads) c.H[i] = Hg[i];
  for (int i = threadIdx.x; i < n; i += kBandThreads) {
    c.lpd[i] = a.lpd[(size_t)lane * n + i];
    c.cm[i] = a.cmask[(size_t)lane * n + i];
    c.cm2[i] = a.cmask2[(size_t)lane * n + i];
    c.zw[i] = T(0);
    c.fl[i] = i == n - 1 ? T(1) : T(0);
  }
  T nact = T(0);
  int prow = 0, ncol = 0;
  for (int r = threadIdx.x; r < mc; r += kBandThreads) {
    c.rm[r] = a.rmask[(size_t)lane * mc + r];
    c.scv[r] = a.scol[r];
    nact += c.rm[r];
    c.lamw[r] = T(1);
    const int p = r - a.nmv;
    if (p >= 0 && p < 2 * a.pny && c.rm[r] != T(0))
      prow = max(prow, (p < a.pny ? p : p - a.pny) + 1);
  }
  for (int i = threadIdx.x; i < n - 1; i += kBandThreads)
    if (a.cmask[(size_t)lane * n + i] != T(0)) ncol = i + 1;
  c.nact = nmax(block_reduce(nact, c.red, SumOp()), T(1));
  c.prow = (int)block_reduce(T(prow), c.red, MaxOp());
  c.ncol = (int)block_reduce(T(ncol), c.red, MaxOp());
  c.nrows = c.nmv + 2 * c.prow + c.ntail;
  c.resident = c.prow <= c.trows;
  if (c.resident) load_tile(c, 0, c.prow);
  for (int i = threadIdx.x; i < a.nxp; i += kBandThreads) xpl[i] = T(0);
  for (int i = threadIdx.x; i < a.nxa; i += kBandThreads) xhp[i] = T(0);
  for (int i = threadIdx.x; i < a.nu; i += kBandThreads) up[i] = T(0);
  __syncthreads();

  const T* sfy = a.sfy + (size_t)lane * a.ny;
  const T* sfu = a.sfu + (size_t)lane * a.nu;
  const T* q = a.q + (size_t)lane * a.pny;
  const T* hbu = a.hbu + (size_t)lane * a.nmv;
  const T* su = a.su + (size_t)lane * a.nmv;
  const T* hbyh = a.hbyh + (size_t)lane * a.pny;
  const T* rmyh = a.rmyh + (size_t)lane * a.pny;
  const T* hbyl = a.hbyl + (size_t)lane * a.pny;
  const T* rmyl = a.rmyl + (size_t)lane * a.pny;
  const size_t bv_row = a.ny, bpl_row = (size_t)a.ny + a.nxa,
               sv_row = (size_t)a.ny + a.nxa + a.nxp;

  for (int k = 0; k < a.nit; ++k) {
    const T* Vk = a.Vt + k;  // column k: Vk[row * nit]
    const int nit = a.nit;
    // plant output, Kalman update
    warp_rows(a.Cpl, a.ny, a.nxp, xpl, [&](int i, T y) {
      a.Y[((size_t)k * a.ny + i) * B + lane] = y;
      ys[i] = y / sfy[i];
    });
    __syncthreads();
    warp_rows(a.C, a.ny, a.nxa, xhp, [&](int i, T cx) {
      ys[i] = ys[i] - cx - Vk[(size_t)i * nit];
    });
    __syncthreads();
    warp_rows(a.Mk, a.nxa, a.ny, ys, [&](int i, T m) { xhat[i] = xhp[i] + m; });
    __syncthreads();
    // free response -> tracking error (in t) and the band rows of h
    warp_rows(a.SxF, a.pny, a.nxa, xhat, [&](int p, T f1) {
      T f2 = T(0);
      for (int j = 0; j < a.nu; ++j) f2 += a.SstF[p * a.nu + j] * up[j];
      const T fr = f1 + f2 + Vk[(sv_row + p) * nit];
      const T rk = a.r[((size_t)k * a.ny + p % a.ny) * B + lane];
      c.t[p] = q[p] * (rk - fr);
      c.h[a.nmv + p] = hbyh[p] - rmyh[p] * fr;
      c.h[a.nmv + a.pny + p] = hbyl[p] + rmyl[p] * fr;
    });
    for (int r = threadIdx.x; r < a.nmv; r += kBandThreads)
      c.h[r] = hbu[r] + su[r] * up[r % a.nu];
    for (int r = a.nmv + 2 * a.pny + threadIdx.x; r < mc; r += kBandThreads)
      c.h[r] = T(0);
    __syncthreads();
    warp_rows(a.ThT, n, a.pny, c.t, [&](int i, T v) {
      c.fq[i] = c.cm[i] * (T(-2) * v);
    });
    __syncthreads();

    // slack seeding from the carried pair (z, lam) = (zw, lamw)
    for (int i = threadIdx.x; i < n; i += kBandThreads) c.z[i] = c.zw[i];
    __syncthreads();
    {
      const T extra = slack_violation(c);
      const T eps_w = nmax(c.zw[n - 1], T(0));
      const bool jumped = extra > T(1e-3) * (T(1) + eps_w);
      if (threadIdx.x == 0) c.z[n - 1] = eps_w + extra + T(1e-6);
      for (int j = threadIdx.x; j < c.nrows; j += kBandThreads) {
        const int r = c.row(j);
        c.lam[r] = jumped ? T(1) : c.lamw[r];
      }
      __syncthreads();
    }
    // stage 0: the slack LP, f = e_slack against diag(lpd)
    c.f = c.fl;
    pdip(c, true, c.cm, a.lp_iters);
    // carry (z1, lam1); stage 2 freezes the slack
    for (int i = threadIdx.x; i < n; i += kBandThreads) c.zw[i] = c.z[i];
    for (int j = threadIdx.x; j < c.nrows; j += kBandThreads) {
      const int r = c.row(j);
      c.lamw[r] = c.lam[r];
    }
    __syncthreads();
    {
      const T extra = slack_violation(c);
      const T ehat = (nmax(c.z[n - 1], T(0)) + extra) * (T(1) + a.m_rel) + a.m_abs;
      if (threadIdx.x == 0) a.E[(size_t)k * B + lane] = ehat;
      for (int j = threadIdx.x; j < c.nrows; j += kBandThreads) {
        const int r = c.row(j);
        c.h[r] = c.h[r] - c.scv[r] * c.rm[r] * ehat;
      }
      __syncthreads();
      if (threadIdx.x == 0) c.z[n - 1] = T(0);
      __syncthreads();
    }
    c.f = c.fq;
    pdip(c, false, c.cm2, a.s2_iters);

    // input, model and plant steps
    for (int j = threadIdx.x; j < a.nu; j += kBandThreads) {
      const T us = up[j] + c.z[j];
      up[j] = us;
      uo[j] = us * sfu[j];
      a.U[((size_t)k * a.nu + j) * B + lane] = uo[j];
    }
    __syncthreads();
    warp_rows(a.A, a.nxa, a.nxa, xhat, [&](int i, T x1) {
      T x2 = T(0);
      for (int j = 0; j < a.nu; ++j) x2 += a.Bu[i * a.nu + j] * up[j];
      xhp[i] = x1 + x2 + Vk[(bv_row + i) * nit];
    });
    warp_rows(a.Apl, a.nxp, a.nxp, xpl, [&](int i, T x1) {
      T x2 = T(0);
      for (int j = 0; j < a.nu; ++j) x2 += a.Bplu[i * a.nu + j] * uo[j];
      xpl2[i] = x1 + x2 + Vk[(bpl_row + i) * nit];
    });
    __syncthreads();
    for (int i = threadIdx.x; i < a.nxp; i += kBandThreads) xpl[i] = xpl2[i];
    __syncthreads();
  }
}


// ----------------------------------------------------------------- launch

enum {
  BP_CPL, BP_APL, BP_BPLU, BP_C, BP_MK, BP_A, BP_BU, BP_SXF, BP_SSTF, BP_THT,
  BP_VT, BP_SPTR, BP_SCOL, BP_SVAL, BP_STPTR, BP_STROW, BP_STVAL, BP_EPTR,
  BP_EROW, BP_ECOEF, BP_GBT, BP_SCOLV, BP_Q, BP_HBU, BP_SU, BP_HBYH, BP_RMYH,
  BP_HBYL, BP_RMYL, BP_RMASK, BP_CMASK, BP_CMASK2, BP_LPD, BP_SFY, BP_SFU,
  BP_HP, BP_R, BP_Y, BP_U, BP_E, BP_WORK, BP_COUNT
};

enum { BD_B, BD_NIT, BD_LP, BD_S2, BD_NY, BD_NU, BD_NXA, BD_NXP, BD_PNY,
       BD_N, BD_MC, BD_NMV, BD_COUNT };

template <typename T>
BandArgs<T> make_band_args(void* const* p, const int* d, const double* c) {
  BandArgs<T> a;
  const T** tabs[] = {&a.Cpl, &a.Apl, &a.Bplu, &a.C, &a.Mk, &a.A, &a.Bu,
                      &a.SxF, &a.SstF, &a.ThT, &a.Vt};
  for (int i = 0; i < 11; ++i) *tabs[i] = static_cast<const T*>(p[BP_CPL + i]);
  a.s_ptr = static_cast<const int*>(p[BP_SPTR]);
  a.s_col = static_cast<const int*>(p[BP_SCOL]);
  a.s_val = static_cast<const T*>(p[BP_SVAL]);
  a.st_ptr = static_cast<const int*>(p[BP_STPTR]);
  a.st_row = static_cast<const int*>(p[BP_STROW]);
  a.st_val = static_cast<const T*>(p[BP_STVAL]);
  a.e_ptr = static_cast<const int*>(p[BP_EPTR]);
  a.e_row = static_cast<const int*>(p[BP_EROW]);
  a.e_coef = static_cast<const T*>(p[BP_ECOEF]);
  a.GbT = static_cast<const T*>(p[BP_GBT]);
  a.scol = static_cast<const T*>(p[BP_SCOLV]);
  const T** lcs[] = {&a.q, &a.hbu, &a.su, &a.hbyh, &a.rmyh, &a.hbyl, &a.rmyl,
                     &a.rmask, &a.cmask, &a.cmask2, &a.lpd, &a.sfy, &a.sfu,
                     &a.Hp, &a.r};
  for (int i = 0; i < 15; ++i) *lcs[i] = static_cast<const T*>(p[BP_Q + i]);
  a.Y = static_cast<T*>(p[BP_Y]);
  a.U = static_cast<T*>(p[BP_U]);
  a.E = static_cast<T*>(p[BP_E]);
  a.work = static_cast<T*>(p[BP_WORK]);
  a.B = d[BD_B];
  a.nit = d[BD_NIT];
  a.lp_iters = d[BD_LP];
  a.s2_iters = d[BD_S2];
  a.ny = d[BD_NY];
  a.nu = d[BD_NU];
  a.nxa = d[BD_NXA];
  a.nxp = d[BD_NXP];
  a.pny = d[BD_PNY];
  a.n = d[BD_N];
  a.mc = d[BD_MC];
  a.nmv = d[BD_NMV];
  a.eps_c = static_cast<T>(c[0]);
  a.ridge = static_cast<T>(c[1]);
  a.w_cap = static_cast<T>(c[2]);
  a.m_rel = static_cast<T>(c[3]);
  a.m_abs = static_cast<T>(c[4]);
  return a;
}

template <typename T>
BandLayout band_layout(const int* d) {
  return BandLayout(d[BD_N], d[BD_NXA], d[BD_NXP], d[BD_NY], d[BD_NU],
                    d[BD_MC], sizeof(T));
}

template <typename T>
int launch_band(void* const* p, const int* d, const double* c,
                cudaStream_t st) {
  const BandArgs<T> a = make_band_args<T>(p, d, c);
  if (a.n > kBandMaxN || a.n < 2) return (int)cudaErrorInvalidValue;
  const size_t bytes = band_layout<T>(d).total * sizeof(T);
  if (bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      closed_sim_band_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  closed_sim_band_kernel<T><<<a.B, kBandThreads, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace mpc

extern "C" {

int mpc_closed_sim_band_ptr_count() { return mpc::BP_COUNT; }

int mpc_closed_sim_band_dim_count() { return mpc::BD_COUNT; }

int mpc_closed_sim_band_max_n() { return mpc::kBandMaxN; }

// Band cases run at float64 only (float32 band loops leave the hard input
// bounds; see ops/kernels.closed_sim_band), so only double is instantiated.

// Elements of the global scratch buffer per lane: 0 when the per-lane
// mc-vectors fit in shared memory.
long long mpc_closed_sim_band_work_per_lane(const int* d) {
  const mpc::BandLayout lay = mpc::band_layout<double>(d);
  return lay.vec_smem ? 0LL : (long long)mpc::kBandVecs * d[mpc::BD_MC];
}

int mpc_closed_sim_band(void* const* ptrs, const int* dims, const double* scal,
                        void* stream) {
  return mpc::launch_band<double>(ptrs, dims, scal,
                                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"
