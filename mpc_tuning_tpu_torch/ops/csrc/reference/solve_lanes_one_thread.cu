// The one-thread-per-system design of the lane-major solve (solve_lanes,
// ops/csrc/spd.cu) that the warp-per-system kernel replaced, kept as its
// reference: forward then back substitution on lane-major (n, n, B) /
// (n, B), element (i, j, b) at (i n + j) B + b, each system's factor and
// solution read from device memory by its own thread (a warp's loads
// coalesce, n^2 dependent ones a system).  The warp kernel's forward pass
// has this one's order; its back pass subtracts in descending k, this one
// in ascending k.  Built on demand into its own library
// (ops/_build.reference_library); no path of the port calls it.

#include "../common.cuh"

namespace mpc {

constexpr int kSolveLanesRefThreads = 128;

template <typename T>
__global__ void solve_lanes_one_thread_kernel(const T* __restrict__ L,
                                              const T* __restrict__ rhs,
                                              T* __restrict__ x, int B,
                                              int n) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const CLane<T> Lb = clane_at(L, B, b);
  const CLane<T> r = clane_at(rhs, B, b);
  const Lane<T> xb = lane_at(x, 0, B, b);
  for (int i = 0; i < n; ++i) {
    T v = r[i];
    for (int k = 0; k < i; ++k) v -= Lb[i * n + k] * xb[k];
    xb[i] = v / Lb[i * n + i];
  }
  for (int i = n - 1; i >= 0; --i) {
    T v = xb[i];
    for (int k = i + 1; k < n; ++k) v -= Lb[k * n + i] * xb[k];
    xb[i] = v / Lb[i * n + i];
  }
}

template <typename T>
int launch_solve_lanes_one_thread(const void* L, const void* rhs, void* x,
                                  int B, int n, cudaStream_t st) {
  const int blocks = (B + kSolveLanesRefThreads - 1) / kSolveLanesRefThreads;
  solve_lanes_one_thread_kernel<T>
      <<<blocks, kSolveLanesRefThreads, 0, st>>>(
          static_cast<const T*>(L), static_cast<const T*>(rhs),
          static_cast<T*>(x), B, n);
  return (int)cudaGetLastError();
}

}  // namespace mpc

extern "C" int mpc_solve_lanes_one_thread(int is_f64, const void* L,
                                          const void* rhs, void* x, int B,
                                          int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64
             ? mpc::launch_solve_lanes_one_thread<double>(L, rhs, x, B, n, st)
             : mpc::launch_solve_lanes_one_thread<float>(L, rhs, x, B, n, st);
}
