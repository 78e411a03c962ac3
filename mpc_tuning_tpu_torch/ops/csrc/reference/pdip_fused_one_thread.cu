// The one-thread-per-lane design of the single-solve PDIP kernel
// (pdip_fused, ops/csrc/qp_fused.cu) that the warp-per-lane kernel
// replaced, kept as its reference: the same `iters` warm-started masked
// Mehrotra iterations (lane_qp.cuh pdip_solve) with the lane's vectors,
// normal matrix and factor in a lane-major device-memory scratch (row * B
// + lane), G0 read through its CSR.  The warp kernel's reductions (a
// shuffle tree) and back substitution (right-looking) round differently,
// so the two agree to rounding, not bit for bit.  Built on demand into its
// own library (ops/_build.reference_library); no path of the port calls
// it.

#include "lane_qp.cuh"

namespace mpc {

constexpr int kPdipRefThreads = 32;

template <typename T>
struct PdipRefArgs {
  Csr<T> g;
  const T *Hp, *f, *h, *rmask, *cmask, *z0, *lam0;  // (n, n, B) ... (mc, B)
  T *z, *lam, *s;                                   // best iterate
  T* work;  // (PdipRows::rows, B)
  int B, n, mc, iters;
  T eps_c, ridge, w_cap;
};

// Row offsets of the per-lane scratch vectors.
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
__global__ void __launch_bounds__(kPdipRefThreads)
pdip_one_thread_kernel(const PdipRefArgs<T> a) {
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

// pointer order: G0's CSR by rows and columns (6), then Hp, f, h, rmask,
// cmask, z0, lam0, z, lam, s, work; dims B, n, mc, iters; scalars eps_c,
// ridge, w_cap
template <typename T>
int launch_pdip_one_thread(void* const* p, const int* d, const double* c,
                           cudaStream_t st) {
  PdipRefArgs<T> a;
  a.g = Csr<T>{static_cast<const int*>(p[0]), static_cast<const int*>(p[1]),
               static_cast<const T*>(p[2]), static_cast<const int*>(p[3]),
               static_cast<const int*>(p[4]), static_cast<const T*>(p[5])};
  const T* const* in = reinterpret_cast<const T* const*>(p + 6);
  a.Hp = in[0];
  a.f = in[1];
  a.h = in[2];
  a.rmask = in[3];
  a.cmask = in[4];
  a.z0 = in[5];
  a.lam0 = in[6];
  T* const* out = reinterpret_cast<T* const*>(p + 13);
  a.z = out[0];
  a.lam = out[1];
  a.s = out[2];
  a.work = out[3];
  a.B = d[0];
  a.n = d[1];
  a.mc = d[2];
  a.iters = d[3];
  a.eps_c = static_cast<T>(c[0]);
  a.ridge = static_cast<T>(c[1]);
  a.w_cap = static_cast<T>(c[2]);
  const int blocks = (a.B + kPdipRefThreads - 1) / kPdipRefThreads;
  pdip_one_thread_kernel<T><<<blocks, kPdipRefThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace mpc

extern "C" {

// Rows of the lane-major scratch buffer (rows * B).
long long mpc_pdip_fused_one_thread_work_rows(int n, int mc) {
  return (long long)mpc::PdipRows(n, mc).rows;
}

int mpc_pdip_fused_one_thread(int is_f64, void* const* ptrs, const int* dims,
                              const double* scal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? mpc::launch_pdip_one_thread<double>(ptrs, dims, scal, st)
                : mpc::launch_pdip_one_thread<float>(ptrs, dims, scal, st);
}

}  // extern "C"
