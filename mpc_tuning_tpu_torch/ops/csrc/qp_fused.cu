// Single-solve QP kernels of the per-step engines: the counterparts of the
// Pallas kernels _pdip_fused_kernel (pdip_fused_lanes) and
// _admm_fused_kernel (admm_fused_lanes) in
// mpc_tuning_tpu/ops/pallas_kernels.py.  One launch solves one closed-loop
// step's QP for every candidate lane: all `iters` warm-started masked
// Mehrotra iterations (pdip_fused) or all `iters` warm equilibrated ADMM
// iterations (admm_fused).
//
// What bounds them on an H100: each lane is a serial chain of small
// dependent loops (iters x a few thousand multiply-adds), so time is set
// by instruction latency and by how many lanes are in flight, not by the
// bytes moved (each input read once, each output written once) or by
// FLOP/s.
//
// Both run one warp per lane, the design of the whole-sim kernels
// (closed_sim.cu): W = QpShape<T>::kW lanes a block (4 at float, 2 at
// double), each lane's n x n tiles (row stride factor_ld(n)), its vectors
// and its staged constants in its warp's share of shared memory
// (PdipLayout, AdmmLayout), copied there once per launch with cp.async, so
// no iteration touches device memory but through G0's shared tables.
// Each iteration's work is spread over rows and columns (warp_qp.cuh), one
// dot deep:
//  * pdip_fused runs warp_pdip: the normal matrix per lower entry from the
//    wrapper's list of G0[r,a] G0[r,b] terms, the warp-per-matrix factor
//    (warp_factor.cuh), row-parallel substitutions with the right-hand
//    side in registers, shuffle-tree reductions; it keeps the best
//    iterate's slacks beside (z, lam), as the TPU kernel returns them.
//    Its reductions and back substitution round differently from the
//    one-thread design it replaced (reference/pdip_fused_one_thread.cu);
//  * admm_fused runs warp_admm, which forms every dot in the one-thread
//    order: the result is the one-thread kernel's
//    (reference/admm_fused_one_thread.cu), bit for bit.
// The TPU kernels' (8, 128) tile padding is dropped.  Envelopes
// (ops/kernels.pdip_fused_envelope and admm_fused_envelope hold the same
// arithmetic): W Layout::total elements of shared memory a block, at most
// kFactorSmemMax, and for the PDIP n <= 32 kFactorMaxRows (the factor's
// two rows a lane); the launchers refuse outside them.

#include "warp_qp.cuh"

namespace mpc {

template <typename T>
struct QpShape {
  static constexpr int kW = sizeof(T) == 8 ? 2 : 4;
};

template <typename T>
struct AdmmFusedArgs {
  GSparse<T> g;   // G0's CSR by rows and columns (no entry terms)
  const T* Minv;  // (n, n, B)
  const T* fs;    // (n, B)
  const T* hs;    // (mc, B)
  const T* arow;  // (mc, B)
  const T* acol;  // (n, B)
  const T* par;   // (2, B): rho, 1 / rho
  const T* x0;    // (n, B) warm state, scaled coordinates
  const T* zc0;   // (mc, B)
  const T* y0;    // (mc, B)
  T* x;           // (n, B)
  T* zc;          // (mc, B)
  T* y;           // (mc, B)
  int B, n, mc, iters;
  T sigma, alpha;
};

// Offsets (in elements of T) of one lane's data in its warp's share of
// shared memory: the Minv tile, the n-vectors, then the mc-vectors.
struct AdmmLayout {
  size_t Minv, fs, acol, x, rhs, hs, arow, zc, y, total;
  __host__ __device__ AdmmLayout(int n, int mc) {
    size_t o = 0;
    Minv = o; o += (size_t)n * factor_ld(n);
    fs = o; o += n;
    acol = o; o += n;
    x = o; o += n;
    rhs = o; o += n;
    hs = o; o += mc;
    arow = o; o += mc;
    zc = o; o += mc;
    y = o; o += mc;
    total = o;
  }
};

template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int rows, int B,
                                      int b, int ln) {
  for (int i = ln; i < rows; i += 32)
    cp_async(dst + i, src + (size_t)i * B + b);
}

template <typename T>
__global__ void __launch_bounds__(32 * QpShape<T>::kW)
    admm_fused_kernel(const __grid_constant__ AdmmFusedArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wi = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const int b = blockIdx.x * QpShape<T>::kW + wi;
  if (b >= a.B) return;
  const int B = a.B, n = a.n, mc = a.mc, ld = factor_ld(n);
  const AdmmLayout lay(n, mc);
  T* sm = reinterpret_cast<T*>(smem_raw) + (size_t)wi * lay.total;
  WarpAdmm<T> v;
  T* Minv = sm + lay.Minv;
  T* fs = sm + lay.fs;
  T* acol = sm + lay.acol;
  T* hs = sm + lay.hs;
  T* arow = sm + lay.arow;
  v.fs = fs;
  v.hs = hs;
  v.arow = arow;
  v.acol = acol;
  v.Minv = Minv;
  v.x = sm + lay.x;
  v.zc = sm + lay.zc;
  v.y = sm + lay.y;
  v.rhs = sm + lay.rhs;
  v.rho = a.par[b];
  v.rho_inv = a.par[(size_t)B + b];
  v.ld = ld;
  for (int el = ln; el < n * n; el += 32) {
    const int i = el / n;
    cp_async(Minv + i * ld + (el - i * n), a.Minv + (size_t)el * B + b);
  }
  stage(fs, a.fs, n, B, b, ln);
  stage(acol, a.acol, n, B, b, ln);
  stage(hs, a.hs, mc, B, b, ln);
  stage(arow, a.arow, mc, B, b, ln);
  stage(v.x, a.x0, n, B, b, ln);
  stage(v.zc, a.zc0, mc, B, b, ln);
  stage(v.y, a.y0, mc, B, b, ln);
  cp_async_wait();
  __syncwarp();
  warp_admm(a.g, v, n, mc, a.iters, a.sigma, a.alpha, ln);
  for (int i = ln; i < n; i += 32) a.x[(size_t)i * B + b] = v.x[i];
  for (int r = ln; r < mc; r += 32) {
    a.zc[(size_t)r * B + b] = v.zc[r];
    a.y[(size_t)r * B + b] = v.y[r];
  }
}

template <typename T>
struct PdipFusedArgs {
  GSparse<T> g;    // G0's CSR by rows and columns and its entry terms
  const T* Hp;     // (n, n, B)
  const T* f;      // (n, B)
  const T* h;      // (mc, B)
  const T* rmask;  // (mc, B)
  const T* cmask;  // (n, B)
  const T* z0;     // (n, B) warm pair
  const T* lam0;   // (mc, B)
  T* z;            // (n, B) best iterate
  T* lam;          // (mc, B)
  T* s;            // (mc, B)
  int B, n, mc, iters;
  T eps_c, ridge, w_cap;
};

// Offsets (in elements of T) of one lane's data in its warp's share of
// shared memory: the H and normal-matrix tiles, the n-vectors, then the
// mc-vectors (bs: the best iterate's slacks).
struct PdipLayout {
  size_t H, L, f, cmask, z, bz, rd, dz;
  size_t h, rmask, lam, s, blam, bs, rp, w, t, ds, dl, total;
  __host__ __device__ PdipLayout(int n, int mc) {
    const size_t nn = (size_t)n * factor_ld(n);
    size_t o = 0;
    H = o; o += nn;
    L = o; o += nn;
    f = o; o += n;
    cmask = o; o += n;
    z = o; o += n;
    bz = o; o += n;
    rd = o; o += n;
    dz = o; o += n;
    h = o; o += mc;
    rmask = o; o += mc;
    lam = o; o += mc;
    s = o; o += mc;
    blam = o; o += mc;
    bs = o; o += mc;
    rp = o; o += mc;
    w = o; o += mc;
    t = o; o += mc;
    ds = o; o += mc;
    dl = o; o += mc;
    total = o;
  }
};

// R: rows a lane owns in the factor and the solves (n <= 32 R).
template <typename T, int R>
__global__ void __launch_bounds__(32 * QpShape<T>::kW)
    pdip_fused_kernel(const __grid_constant__ PdipFusedArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wi = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const int b = blockIdx.x * QpShape<T>::kW + wi;
  if (b >= a.B) return;
  const int B = a.B, n = a.n, mc = a.mc, ld = factor_ld(n);
  const PdipLayout lay(n, mc);
  T* sm = reinterpret_cast<T*>(smem_raw) + (size_t)wi * lay.total;
  T* H = sm + lay.H;
  T* f = sm + lay.f;
  T* cmask = sm + lay.cmask;
  T* h = sm + lay.h;
  T* rmask = sm + lay.rmask;
  WarpPdip<T> v;
  v.f = f;
  v.h = h;
  v.rmask = rmask;
  v.cmask = cmask;
  v.H = H;
  v.z = sm + lay.z;
  v.lam = sm + lay.lam;
  v.s = sm + lay.s;
  v.bs = sm + lay.bs;
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
  v.ld = ld;
  for (int el = ln; el < n * n; el += 32) {
    const int i = el / n;
    cp_async(H + i * ld + (el - i * n), a.Hp + (size_t)el * B + b);
  }
  stage(f, a.f, n, B, b, ln);
  stage(cmask, a.cmask, n, B, b, ln);
  stage(h, a.h, mc, B, b, ln);
  stage(rmask, a.rmask, mc, B, b, ln);
  stage(v.z, a.z0, n, B, b, ln);
  stage(v.lam, a.lam0, mc, B, b, ln);
  cp_async_wait();
  __syncwarp();
  T nact = T(0);
  for (int r = ln; r < mc; r += 32) nact += rmask[r];
  v.nact = nmax(warp_sum(nact), T(1));
  warp_pdip<T, R, true>(a.g, v, n, mc, a.iters, a.eps_c, a.ridge, a.w_cap,
                        ln);
  for (int i = ln; i < n; i += 32) a.z[(size_t)i * B + b] = v.z[i];
  for (int r = ln; r < mc; r += 32) {
    a.lam[(size_t)r * B + b] = v.lam[r];
    a.s[(size_t)r * B + b] = v.s[r];
  }
}

// ----------------------------------------------------------------- launch

// argument order of the C launchers (ops/kernels.py _QP_CSR, _QP_TERMS,
// _PDIP_PTRS, _ADMM_PTRS)
enum { C_GPTR, C_GCOL, C_GVAL, C_GTPTR, C_GTROW, C_GTVAL, C_COUNT };
enum { PF_EPTR = C_COUNT, PF_EROW, PF_ECOEF, PF_HP, PF_F, PF_H, PF_RMASK,
       PF_CMASK, PF_Z0, PF_LAM0, PF_Z, PF_LAM, PF_S, PF_COUNT };
enum { AF_MINV = C_COUNT, AF_FS, AF_HS, AF_AROW, AF_ACOL, AF_PAR, AF_X0,
       AF_ZC0, AF_Y0, AF_X, AF_ZC, AF_Y, AF_COUNT };
// dims: B, n, mc, iters
enum { QD_B, QD_N, QD_MC, QD_ITERS, QD_COUNT };

template <typename T>
GSparse<T> gsparse_of(void* const* p, bool terms) {
  return GSparse<T>{
      static_cast<const int*>(p[C_GPTR]), static_cast<const int*>(p[C_GCOL]),
      static_cast<const T*>(p[C_GVAL]), static_cast<const int*>(p[C_GTPTR]),
      static_cast<const int*>(p[C_GTROW]), static_cast<const T*>(p[C_GTVAL]),
      terms ? static_cast<const int*>(p[PF_EPTR]) : nullptr,
      terms ? static_cast<const int*>(p[PF_EROW]) : nullptr,
      terms ? static_cast<const T*>(p[PF_ECOEF]) : nullptr};
}

namespace {
// The dynamic shared memory each kernel (admm_fused; pdip_fused at one and
// two rows a lane) is allowed on each device so far, by dtype: above 48 KB
// a launch's has to be allowed, once a kernel and device, for the most any
// launch has needed.  Internal linkage, so two libraries loaded in one
// process keep their own.
constexpr int kMaxDevices = 64;
enum { kQpAdmm, kQpPdip1, kQpPdip2, kQpKernels };
int g_qp_smem[kQpKernels][2][kMaxDevices];
}  // namespace

// Allow `kernel` (g_qp_smem's `which`, dtype T) `smem` bytes of dynamic
// shared memory on the current device; a CUDA error code or 0.
template <typename T, typename Kernel>
int allow_qp_smem(Kernel kernel, int which, int smem) {
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev >= kMaxDevices) e = cudaErrorInvalidDevice;
  if (e != cudaSuccess) return (int)e;
  int& allowed = g_qp_smem[which][sizeof(T) == 8][dev];
  if (smem > allowed) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  return 0;
}

template <typename T, int R>
int launch_pdip_rows(const PdipFusedArgs<T>& a, int smem, cudaStream_t st) {
  constexpr int W = QpShape<T>::kW;
  const int e = allow_qp_smem<T>(pdip_fused_kernel<T, R>,
                                 R == 1 ? kQpPdip1 : kQpPdip2, smem);
  if (e) return e;
  pdip_fused_kernel<T, R><<<(a.B + W - 1) / W, 32 * W, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pdip_fused(void* const* p, const int* d, const double* c,
                      cudaStream_t st) {
  constexpr int W = QpShape<T>::kW;
  PdipFusedArgs<T> a;
  a.g = gsparse_of<T>(p, true);
  a.Hp = static_cast<const T*>(p[PF_HP]);
  a.f = static_cast<const T*>(p[PF_F]);
  a.h = static_cast<const T*>(p[PF_H]);
  a.rmask = static_cast<const T*>(p[PF_RMASK]);
  a.cmask = static_cast<const T*>(p[PF_CMASK]);
  a.z0 = static_cast<const T*>(p[PF_Z0]);
  a.lam0 = static_cast<const T*>(p[PF_LAM0]);
  a.z = static_cast<T*>(p[PF_Z]);
  a.lam = static_cast<T*>(p[PF_LAM]);
  a.s = static_cast<T*>(p[PF_S]);
  a.B = d[QD_B];
  a.n = d[QD_N];
  a.mc = d[QD_MC];
  a.iters = d[QD_ITERS];
  a.eps_c = static_cast<T>(c[0]);
  a.ridge = static_cast<T>(c[1]);
  a.w_cap = static_cast<T>(c[2]);
  const long long smem =
      (long long)W * PdipLayout(a.n, a.mc).total * sizeof(T);
  if (a.n < 1 || a.n > 32 * kFactorMaxRows || a.mc < 1 ||
      smem > kFactorSmemMax)
    return (int)cudaErrorInvalidValue;
  return a.n <= 32 ? launch_pdip_rows<T, 1>(a, (int)smem, st)
                   : launch_pdip_rows<T, 2>(a, (int)smem, st);
}

template <typename T>
int launch_admm_fused(void* const* p, const int* d, const double* c,
                      cudaStream_t st) {
  constexpr int W = QpShape<T>::kW;
  AdmmFusedArgs<T> a;
  a.g = gsparse_of<T>(p, false);
  a.Minv = static_cast<const T*>(p[AF_MINV]);
  a.fs = static_cast<const T*>(p[AF_FS]);
  a.hs = static_cast<const T*>(p[AF_HS]);
  a.arow = static_cast<const T*>(p[AF_AROW]);
  a.acol = static_cast<const T*>(p[AF_ACOL]);
  a.par = static_cast<const T*>(p[AF_PAR]);
  a.x0 = static_cast<const T*>(p[AF_X0]);
  a.zc0 = static_cast<const T*>(p[AF_ZC0]);
  a.y0 = static_cast<const T*>(p[AF_Y0]);
  a.x = static_cast<T*>(p[AF_X]);
  a.zc = static_cast<T*>(p[AF_ZC]);
  a.y = static_cast<T*>(p[AF_Y]);
  a.B = d[QD_B];
  a.n = d[QD_N];
  a.mc = d[QD_MC];
  a.iters = d[QD_ITERS];
  a.sigma = static_cast<T>(c[0]);
  a.alpha = static_cast<T>(c[1]);
  const long long smem =
      (long long)W * AdmmLayout(a.n, a.mc).total * sizeof(T);
  if (a.n < 1 || a.mc < 1 || smem > kFactorSmemMax)
    return (int)cudaErrorInvalidValue;
  const int e = allow_qp_smem<T>(admm_fused_kernel<T>, kQpAdmm, (int)smem);
  if (e) return e;
  const int blocks = (a.B + W - 1) / W;
  admm_fused_kernel<T><<<blocks, 32 * W, (int)smem, st>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- lane_sum
//
// x (rows, B), any strides, summed over its rows into out (1, B): the
// lane-major sums of the eager PDIP (ops/qp.pdip_lanes through
// ops/qp.lane_sum), in the per-step engine 'pdip_ws_lanes' and in the
// plain versions' solves.  It replaces no TPU kernel: it repairs a fault of
// the port, where torch's column sum split a column's rows over threads by
// the batch's width, so a lane's bits followed B.
//
// Each lane's rows are summed in one fixed order, the order of the
// warp-per-lane QP kernels' reductions (warp_qp.cuh warp_sum): row r into
// partial r % kLaneSumWays in index order, then the partials added by the
// xor butterfly of a warp's shuffles, all in double and rounded once to T
// (a float32 sum is then its exact sum rounded, but where the double
// partials round, whatever the order).  So a lane's bits follow neither
// its slot nor B.  A block takes kLaneSumLanes lanes; thread (x, y) runs
// partial y of lane x, so the threads of a warp read neighbouring lanes of
// one row (one coalesced load a row when the lanes are contiguous, stride
// 1); the partials are added in shared memory.  Bound by bytes (rows B
// elements read once).
constexpr int kLaneSumWays = 32;
constexpr int kLaneSumLanes = 32;

template <typename T>
__global__ void lane_sum_kernel(const T* __restrict__ x, T* __restrict__ out,
                                int rows, int B, long long s_row,
                                long long s_lane) {
  __shared__ double part[kLaneSumWays][kLaneSumLanes];
  const int b = blockIdx.x * kLaneSumLanes + threadIdx.x;
  const int y = threadIdx.y;
  double acc = 0.0;
  if (b < B) {
    const T* p = x + (long long)b * s_lane;
    int r = y;
    // four loads in flight, added in index order
    for (; r + 3 * kLaneSumWays < rows; r += 4 * kLaneSumWays) {
      const T a0 = p[(long long)r * s_row];
      const T a1 = p[(long long)(r + kLaneSumWays) * s_row];
      const T a2 = p[(long long)(r + 2 * kLaneSumWays) * s_row];
      const T a3 = p[(long long)(r + 3 * kLaneSumWays) * s_row];
      acc += (double)a0;
      acc += (double)a1;
      acc += (double)a2;
      acc += (double)a3;
    }
    for (; r < rows; r += kLaneSumWays)
      acc += (double)p[(long long)r * s_row];
  }
  part[y][threadIdx.x] = acc;
  __syncthreads();
  // warp_sum's butterfly as its lane 0 sees it (v += shfl_xor(v, o)), a
  // level at a time in shared memory
#pragma unroll
  for (int o = kLaneSumWays / 2; o > 0; o >>= 1) {
    if (y < o) part[y][threadIdx.x] = part[y][threadIdx.x] +
                                      part[y + o][threadIdx.x];
    __syncthreads();
  }
  if (y == 0 && b < B) out[b] = static_cast<T>(part[0][threadIdx.x]);
}

template <typename T>
int launch_lane_sum(const void* x, void* out, int rows, int B,
                    long long s_row, long long s_lane, cudaStream_t st) {
  if (rows < 0 || B < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (B + kLaneSumLanes - 1) / kLaneSumLanes;
  lane_sum_kernel<T><<<blocks, dim3(kLaneSumLanes, kLaneSumWays), 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), rows, B, s_row,
      s_lane);
  return (int)cudaGetLastError();
}

}  // namespace mpc

extern "C" {

int mpc_pdip_fused_ptr_count() { return mpc::PF_COUNT; }

int mpc_admm_fused_ptr_count() { return mpc::AF_COUNT; }

int mpc_qp_fused_dim_count() { return mpc::QD_COUNT; }

// Both refuse (cudaErrorInvalidValue, nothing launched) outside their
// envelopes.
int mpc_pdip_fused(int is_f64, void* const* ptrs, const int* dims,
                   const double* scal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? mpc::launch_pdip_fused<double>(ptrs, dims, scal, st)
                : mpc::launch_pdip_fused<float>(ptrs, dims, scal, st);
}

int mpc_admm_fused(int is_f64, void* const* ptrs, const int* dims,
                   const double* scal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? mpc::launch_admm_fused<double>(ptrs, dims, scal, st)
                : mpc::launch_admm_fused<float>(ptrs, dims, scal, st);
}

// x (rows, B) with element strides s_row, s_lane -> out (1, B), each
// lane's rows summed in one fixed order; refuses B < 1 or rows < 0.
int mpc_lane_sum(int is_f64, const void* x, void* out, int rows, int B,
                 long long s_row, long long s_lane, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64
             ? mpc::launch_lane_sum<double>(x, out, rows, B, s_row, s_lane, st)
             : mpc::launch_lane_sum<float>(x, out, rows, B, s_row, s_lane, st);
}

}  // extern "C"
