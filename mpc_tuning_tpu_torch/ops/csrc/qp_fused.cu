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
// pdip_fused runs one thread per lane with the per-lane device code of
// lane_qp.cuh, its vectors and normal matrix in a lane-major scratch
// buffer (row * B + lane: a warp's loads are one coalesced line), G0 read
// through its CSR; the solves substitute with the factor in place of the
// TPU kernel's explicit L^{-1} (the two differ only in rounding).
//
// admm_fused runs one warp per lane, the design of the whole-sim ADMM
// kernel (closed_sim.cu): W = QpShape<T>::kW lanes a block (4 at float, 2
// at double), each lane's Minv tile (row stride factor_ld(n)), its
// vectors and its staged constants in its warp's share of shared memory
// (AdmmLayout), copied there once per launch with cp.async, and the
// iterations of warp_qp.cuh's warp_admm, which spreads each one over rows
// and columns (one dot deep) and forms every dot in the one-thread order:
// the result is the one-thread kernel's (ops/csrc/reference/
// admm_fused_one_thread.cu), bit for bit.  The TPU kernels' (8, 128) tile
// padding is dropped.  Envelope (ops/kernels.admm_fused_envelope holds the
// same arithmetic): W AdmmLayout::total elements of shared memory a block,
// at most kFactorSmemMax; the launcher refuses outside it.

#include "lane_qp.cuh"
#include "warp_qp.cuh"

namespace mpc {

constexpr int kQpThreads = 32;

template <typename T>
struct PdipFusedArgs {
  Csr<T> g;
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
  T* work;         // (PdipRows::rows, B)
  int B, n, mc, iters;
  T eps_c, ridge, w_cap;
};

// Row offsets of the PDIP kernel's per-lane scratch vectors.
struct PdipRows {
  size_t rhs, dz, bz, rd, blam, bs, rp, w, t, ds, dl, dsa, dla, L, rows;
  __host__ __device__ PdipRows(int n, int mc) {
    size_t o = 0;
    rhs = o; o += n;
    dz = o; o += n;
    bz = o; o += n;
    rd = o; o += n;
    blam = o; o += mc;
    bs = o; o += mc;
    rp = o; o += mc;
    w = o; o += mc;
    t = o; o += mc;
    ds = o; o += mc;
    dl = o; o += mc;
    dsa = o; o += mc;
    dla = o; o += mc;
    L = o; o += (size_t)n * n;
    rows = o;
  }
};

template <typename T>
__global__ void __launch_bounds__(kQpThreads)
pdip_fused_kernel(const PdipFusedArgs<T> a) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.B) return;
  const int B = a.B;
  const PdipRows o(a.n, a.mc);
  PdipLane<T> v;
  // f and h are inputs, only read (PdipLane takes them as Lane)
  v.f = Lane<T>{const_cast<T*>(a.f) + lane, B};
  v.h = Lane<T>{const_cast<T*>(a.h) + lane, B};
  v.rmask = clane_at(a.rmask, B, lane);
  v.cmask = clane_at(a.cmask, B, lane);
  v.H = clane_at(a.Hp, B, lane);
  v.z = lane_at(a.z, 0, B, lane);
  v.lam = lane_at(a.lam, 0, B, lane);
  v.s = lane_at(a.s, 0, B, lane);
  v.rhs = lane_at(a.work, o.rhs, B, lane);
  v.dz = lane_at(a.work, o.dz, B, lane);
  v.bz = lane_at(a.work, o.bz, B, lane);
  v.rd = lane_at(a.work, o.rd, B, lane);
  v.blam = lane_at(a.work, o.blam, B, lane);
  v.bs = lane_at(a.work, o.bs, B, lane);
  v.rp = lane_at(a.work, o.rp, B, lane);
  v.w = lane_at(a.work, o.w, B, lane);
  v.t = lane_at(a.work, o.t, B, lane);
  v.ds = lane_at(a.work, o.ds, B, lane);
  v.dl = lane_at(a.work, o.dl, B, lane);
  v.dsa = lane_at(a.work, o.dsa, B, lane);
  v.dla = lane_at(a.work, o.dla, B, lane);
  v.L = lane_at(a.work, o.L, B, lane);
  const CLane<T> z0 = clane_at(a.z0, B, lane);
  const CLane<T> lam0 = clane_at(a.lam0, B, lane);
  for (int i = 0; i < a.n; ++i) v.z[i] = z0[i];
  for (int r = 0; r < a.mc; ++r) v.lam[r] = lam0[r];
  pdip_solve(a.g, v, a.n, a.mc, a.iters, a.eps_c, a.ridge, a.w_cap);
}

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

// ----------------------------------------------------------------- launch

// argument order of the C launchers (ops/kernels.py _QP_CSR, _PDIP_PTRS,
// _ADMM_PTRS)
enum { C_GPTR, C_GCOL, C_GVAL, C_GTPTR, C_GTROW, C_GTVAL, C_COUNT };
enum { PF_HP = C_COUNT, PF_F, PF_H, PF_RMASK, PF_CMASK, PF_Z0, PF_LAM0, PF_Z,
       PF_LAM, PF_S, PF_WORK, PF_COUNT };
enum { AF_MINV = C_COUNT, AF_FS, AF_HS, AF_AROW, AF_ACOL, AF_PAR, AF_X0,
       AF_ZC0, AF_Y0, AF_X, AF_ZC, AF_Y, AF_COUNT };
// dims: B, n, mc, iters
enum { QD_B, QD_N, QD_MC, QD_ITERS, QD_COUNT };

template <typename T>
Csr<T> csr_of(void* const* p) {
  return Csr<T>{static_cast<const int*>(p[C_GPTR]),
                static_cast<const int*>(p[C_GCOL]),
                static_cast<const T*>(p[C_GVAL]),
                static_cast<const int*>(p[C_GTPTR]),
                static_cast<const int*>(p[C_GTROW]),
                static_cast<const T*>(p[C_GTVAL])};
}

template <typename T>
int launch_pdip_fused(void* const* p, const int* d, const double* c,
                      cudaStream_t st) {
  PdipFusedArgs<T> a;
  a.g = csr_of<T>(p);
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
  a.work = static_cast<T*>(p[PF_WORK]);
  a.B = d[QD_B];
  a.n = d[QD_N];
  a.mc = d[QD_MC];
  a.iters = d[QD_ITERS];
  a.eps_c = static_cast<T>(c[0]);
  a.ridge = static_cast<T>(c[1]);
  a.w_cap = static_cast<T>(c[2]);
  const int blocks = (a.B + kQpThreads - 1) / kQpThreads;
  pdip_fused_kernel<T><<<blocks, kQpThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

namespace {
// The dynamic shared memory admm_fused (by dtype) is allowed on each device
// so far: above 48 KB a launch's has to be allowed, once a kernel and
// device, for the most any launch has needed.  Internal linkage, so two
// libraries loaded in one process keep their own.
constexpr int kMaxDevices = 64;
int g_admm_smem[2][kMaxDevices];
}  // namespace

template <typename T>
int launch_admm_fused(void* const* p, const int* d, const double* c,
                      cudaStream_t st) {
  constexpr int W = QpShape<T>::kW;
  AdmmFusedArgs<T> a;
  a.g = GSparse<T>{static_cast<const int*>(p[C_GPTR]),
                   static_cast<const int*>(p[C_GCOL]),
                   static_cast<const T*>(p[C_GVAL]),
                   static_cast<const int*>(p[C_GTPTR]),
                   static_cast<const int*>(p[C_GTROW]),
                   static_cast<const T*>(p[C_GTVAL]),
                   nullptr, nullptr, nullptr};
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
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess && dev >= kMaxDevices) e = cudaErrorInvalidDevice;
    if (e != cudaSuccess) return (int)e;
    int& allowed = g_admm_smem[sizeof(T) == 8][dev];
    if (smem > allowed) {
      e = cudaFuncSetAttribute(admm_fused_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
      allowed = (int)smem;
    }
  }
  const int blocks = (a.B + W - 1) / W;
  admm_fused_kernel<T><<<blocks, 32 * W, (int)smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace mpc

extern "C" {

int mpc_pdip_fused_ptr_count() { return mpc::PF_COUNT; }

int mpc_admm_fused_ptr_count() { return mpc::AF_COUNT; }

int mpc_qp_fused_dim_count() { return mpc::QD_COUNT; }

// Rows of the PDIP kernel's lane-major scratch buffer (rows * B).
long long mpc_pdip_fused_work_rows(int n, int mc) {
  return (long long)mpc::PdipRows(n, mc).rows;
}

int mpc_pdip_fused(int is_f64, void* const* ptrs, const int* dims,
                   const double* scal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? mpc::launch_pdip_fused<double>(ptrs, dims, scal, st)
                : mpc::launch_pdip_fused<float>(ptrs, dims, scal, st);
}

// Refuses (cudaErrorInvalidValue, nothing launched) outside the envelope.
int mpc_admm_fused(int is_f64, void* const* ptrs, const int* dims,
                   const double* scal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? mpc::launch_admm_fused<double>(ptrs, dims, scal, st)
                : mpc::launch_admm_fused<float>(ptrs, dims, scal, st);
}

}  // extern "C"
