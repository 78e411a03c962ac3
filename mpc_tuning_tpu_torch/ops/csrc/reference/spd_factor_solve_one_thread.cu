// The one-thread-per-system design of the batch-major solve
// (spd_factor_solve, ops/csrc/spd.cu) that the warp-per-system kernel
// replaced, kept as its reference: forward then back substitution on
// (B, n, n) / (B, n), each system's factor and solution read from device
// memory by its own thread.  The warp kernel's forward pass has this
// one's order; its back pass subtracts in descending k, this one in
// ascending k.  Built on demand into its own library
// (ops/_build.reference_library); no path of the port calls it.

#include "../common.cuh"

namespace mpc {

constexpr int kSolveRefThreads = 128;

template <typename T>
__global__ void spd_factor_solve_one_thread_kernel(const T* __restrict__ L,
                                                   const T* __restrict__ rhs,
                                                   T* __restrict__ x, int B,
                                                   int n) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const T* Lb = L + (size_t)b * n * n;
  const T* r = rhs + (size_t)b * n;
  T* xb = x + (size_t)b * n;
  // forward: L y = rhs (y kept in x)
  for (int i = 0; i < n; ++i) {
    T v = r[i];
    for (int k = 0; k < i; ++k) v -= Lb[i * n + k] * xb[k];
    xb[i] = v / Lb[i * n + i];
  }
  // back: L^T x = y, in place
  for (int i = n - 1; i >= 0; --i) {
    T v = xb[i];
    for (int k = i + 1; k < n; ++k) v -= Lb[k * n + i] * xb[k];
    xb[i] = v / Lb[i * n + i];
  }
}

template <typename T>
int launch_solve_one_thread(const void* L, const void* rhs, void* x, int B,
                            int n, cudaStream_t st) {
  const int blocks = (B + kSolveRefThreads - 1) / kSolveRefThreads;
  spd_factor_solve_one_thread_kernel<T><<<blocks, kSolveRefThreads, 0, st>>>(
      static_cast<const T*>(L), static_cast<const T*>(rhs),
      static_cast<T*>(x), B, n);
  return (int)cudaGetLastError();
}

}  // namespace mpc

extern "C" int mpc_spd_factor_solve_one_thread(int is_f64, const void* L,
                                               const void* rhs, void* x,
                                               int B, int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? mpc::launch_solve_one_thread<double>(L, rhs, x, B, n, st)
                : mpc::launch_solve_one_thread<float>(L, rhs, x, B, n, st);
}
