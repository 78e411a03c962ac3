// Single-solve QP kernels of the per-step engines: the counterparts of the
// Pallas kernels _pdip_fused_kernel (pdip_fused_lanes) and
// _admm_fused_kernel (admm_fused_lanes) in
// mpc_tuning_tpu/ops/pallas_kernels.py.  One launch solves one closed-loop
// step's QP for every candidate lane: all `iters` warm-started masked
// Mehrotra iterations (pdip_fused) or all `iters` warm equilibrated ADMM
// iterations (admm_fused), with the per-lane device code of lane_qp.cuh
// that the whole-sim kernels (closed_sim.cu) run at every step.
//
// What bounds them on an H100: one thread per lane runs a serial chain of
// small dependent loops (iters x a few thousand multiply-adds), so time is
// set by instruction latency and by how many lanes are in flight, not by
// the bytes moved (each input read once, each output written once) or by
// FLOP/s.  The design keeps the lane's vectors and its normal matrix in a
// lane-major scratch buffer (row * B + lane: a warp's loads are one
// coalesced line) and reads G0 through its CSR, as closed_sim.cu does; the
// TPU kernels' (8, 128) tile padding is dropped, and the solves substitute
// with the factor in place of the TPU kernel's explicit L^{-1} (the two
// differ only in rounding).

#include "lane_qp.cuh"

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
struct AdmmFusedArgs {
  Csr<T> g;
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
  T* work;        // (n, B): the rhs
  int B, n, mc, iters;
  T sigma, alpha;
};

template <typename T>
__global__ void __launch_bounds__(kQpThreads)
admm_fused_kernel(const AdmmFusedArgs<T> a) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.B) return;
  const int B = a.B;
  AdmmLane<T> v;
  v.fs = Lane<T>{const_cast<T*>(a.fs) + lane, B};  // inputs, only read
  v.hs = Lane<T>{const_cast<T*>(a.hs) + lane, B};
  v.arow = clane_at(a.arow, B, lane);
  v.acol = clane_at(a.acol, B, lane);
  v.Minv = clane_at(a.Minv, B, lane);
  v.x = lane_at(a.x, 0, B, lane);
  v.zc = lane_at(a.zc, 0, B, lane);
  v.y = lane_at(a.y, 0, B, lane);
  v.rhs = lane_at(a.work, 0, B, lane);
  v.rho = a.par[lane];
  v.rho_inv = a.par[(size_t)B + lane];
  const CLane<T> x0 = clane_at(a.x0, B, lane);
  const CLane<T> zc0 = clane_at(a.zc0, B, lane);
  const CLane<T> y0 = clane_at(a.y0, B, lane);
  for (int i = 0; i < a.n; ++i) v.x[i] = x0[i];
  for (int r = 0; r < a.mc; ++r) {
    v.zc[r] = zc0[r];
    v.y[r] = y0[r];
  }
  admm_iterations(a.g, v, a.n, a.mc, a.iters, a.sigma, a.alpha);
}

// ----------------------------------------------------------------- launch

// argument order of the C launchers (ops/kernels.py _QP_CSR, _PDIP_PTRS,
// _ADMM_PTRS)
enum { C_GPTR, C_GCOL, C_GVAL, C_GTPTR, C_GTROW, C_GTVAL, C_COUNT };
enum { PF_HP = C_COUNT, PF_F, PF_H, PF_RMASK, PF_CMASK, PF_Z0, PF_LAM0, PF_Z,
       PF_LAM, PF_S, PF_WORK, PF_COUNT };
enum { AF_MINV = C_COUNT, AF_FS, AF_HS, AF_AROW, AF_ACOL, AF_PAR, AF_X0,
       AF_ZC0, AF_Y0, AF_X, AF_ZC, AF_Y, AF_WORK, AF_COUNT };
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

template <typename T>
int launch_admm_fused(void* const* p, const int* d, const double* c,
                      cudaStream_t st) {
  AdmmFusedArgs<T> a;
  a.g = csr_of<T>(p);
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
  a.work = static_cast<T*>(p[AF_WORK]);
  a.B = d[QD_B];
  a.n = d[QD_N];
  a.mc = d[QD_MC];
  a.iters = d[QD_ITERS];
  a.sigma = static_cast<T>(c[0]);
  a.alpha = static_cast<T>(c[1]);
  const int blocks = (a.B + kQpThreads - 1) / kQpThreads;
  admm_fused_kernel<T><<<blocks, kQpThreads, 0, st>>>(a);
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

int mpc_admm_fused(int is_f64, void* const* ptrs, const int* dims,
                   const double* scal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? mpc::launch_admm_fused<double>(ptrs, dims, scal, st)
                : mpc::launch_admm_fused<float>(ptrs, dims, scal, st);
}

}  // extern "C"
