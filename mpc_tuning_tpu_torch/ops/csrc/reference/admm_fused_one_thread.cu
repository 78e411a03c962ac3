// The one-thread-per-lane design of the single-solve ADMM kernel
// (admm_fused, ops/csrc/qp_fused.cu) that the warp-per-lane kernel
// replaced, kept as its bit-for-bit reference: the same `iters` warm
// equilibrated ADMM iterations (lane_qp.cuh admm_iterations) with the
// lane's vectors in a lane-major device-memory scratch.  Built on demand
// into its own library (ops/_build.reference_library); no path of the port
// calls it.

#include "lane_qp.cuh"

namespace mpc {

constexpr int kRefThreads = 32;

template <typename T>
struct AdmmRefArgs {
  Csr<T> g;
  const T *Minv, *fs, *hs, *arow, *acol, *par, *x0, *zc0, *y0;
  T *x, *zc, *y;
  T* work;  // (n, B): the rhs
  int B, n, mc, iters;
  T sigma, alpha;
};

template <typename T>
__global__ void __launch_bounds__(kRefThreads)
admm_one_thread_kernel(const AdmmRefArgs<T> a) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.B) return;
  const int B = a.B;
  AdmmLane<T> v;
  v.fs = Lane<T>{const_cast<T*>(a.fs) + lane, B};
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

// pointer order: G0's CSR by rows and columns (6), then Minv, fs, hs,
// arow, acol, par, x0, zc0, y0, x, zc, y, work; dims B, n, mc, iters;
// scalars sigma, over_relax
template <typename T>
int launch_one_thread(void* const* p, const int* d, const double* c,
                      cudaStream_t st) {
  AdmmRefArgs<T> a;
  a.g = Csr<T>{static_cast<const int*>(p[0]), static_cast<const int*>(p[1]),
               static_cast<const T*>(p[2]), static_cast<const int*>(p[3]),
               static_cast<const int*>(p[4]), static_cast<const T*>(p[5])};
  const T* const* in = reinterpret_cast<const T* const*>(p + 6);
  a.Minv = in[0];
  a.fs = in[1];
  a.hs = in[2];
  a.arow = in[3];
  a.acol = in[4];
  a.par = in[5];
  a.x0 = in[6];
  a.zc0 = in[7];
  a.y0 = in[8];
  T* const* out = reinterpret_cast<T* const*>(p + 15);
  a.x = out[0];
  a.zc = out[1];
  a.y = out[2];
  a.work = out[3];
  a.B = d[0];
  a.n = d[1];
  a.mc = d[2];
  a.iters = d[3];
  a.sigma = static_cast<T>(c[0]);
  a.alpha = static_cast<T>(c[1]);
  const int blocks = (a.B + kRefThreads - 1) / kRefThreads;
  admm_one_thread_kernel<T><<<blocks, kRefThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace mpc

extern "C" int mpc_admm_fused_one_thread(int is_f64, void* const* ptrs,
                                         const int* dims, const double* scal,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? mpc::launch_one_thread<double>(ptrs, dims, scal, st)
                : mpc::launch_one_thread<float>(ptrs, dims, scal, st);
}
