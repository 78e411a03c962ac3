// The one-thread-per-system design of spd_solve (ops/csrc/spd.cu) that the
// warp-per-system kernel replaced, kept as its reference: the factor and
// both substitutions of one (B, n, n) / (B, n) system by its own thread,
// the factor kept in lane-major device scratch (work[(i n + j) B + b]) so
// that a warp's scratch accesses coalesce.  The warp kernel's factor has
// this one's order (ascending k, then the sqrt or the division) and its
// forward pass too; its back pass subtracts in descending k, this one in
// ascending k.  Built on demand into its own library
// (ops/_build.reference_library); no path of the port calls it.

#include "../common.cuh"

namespace mpc {

constexpr int kSpdSolveRefThreads = 128;

// A pivot that is not > 0 makes the whole solution NaN.
template <typename T>
__global__ void spd_solve_one_thread_kernel(const T* __restrict__ M,
                                            const T* __restrict__ rhs,
                                            T* __restrict__ x,
                                            T* __restrict__ work, int B,
                                            int n) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const T* A = M + (size_t)b * n * n;
  const Lane<T> L = lane_at(work, 0, B, b);
  bool ok = true;
  for (int j = 0; j < n; ++j) {
    T d = A[j * n + j];
    for (int k = 0; k < j; ++k) d -= L[j * n + k] * L[j * n + k];
    ok = ok && d > T(0);
    const T ljj = sqrt(d);
    L[j * n + j] = ljj;
    for (int i = j + 1; i < n; ++i) {
      T v = A[i * n + j];
      for (int k = 0; k < j; ++k) v -= L[i * n + k] * L[j * n + k];
      L[i * n + j] = v / ljj;
    }
  }
  const T* r = rhs + (size_t)b * n;
  T* xb = x + (size_t)b * n;
  if (!ok) {
    for (int i = 0; i < n; ++i) xb[i] = T(0) / T(0);
    return;
  }
  for (int i = 0; i < n; ++i) {
    T v = r[i];
    for (int k = 0; k < i; ++k) v -= L[i * n + k] * xb[k];
    xb[i] = v / L[i * n + i];
  }
  for (int i = n - 1; i >= 0; --i) {
    T v = xb[i];
    for (int k = i + 1; k < n; ++k) v -= L[k * n + i] * xb[k];
    xb[i] = v / L[i * n + i];
  }
}

template <typename T>
int launch_spd_solve_one_thread(const void* M, const void* rhs, void* x,
                                void* work, int B, int n, cudaStream_t st) {
  const int blocks = (B + kSpdSolveRefThreads - 1) / kSpdSolveRefThreads;
  spd_solve_one_thread_kernel<T><<<blocks, kSpdSolveRefThreads, 0, st>>>(
      static_cast<const T*>(M), static_cast<const T*>(rhs),
      static_cast<T*>(x), static_cast<T*>(work), B, n);
  return (int)cudaGetLastError();
}

}  // namespace mpc

// work: n * n * B scratch of the factor, lane-major.
extern "C" int mpc_spd_solve_one_thread(int is_f64, const void* M,
                                        const void* rhs, void* x, void* work,
                                        int B, int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? mpc::launch_spd_solve_one_thread<double>(M, rhs, x, work, B,
                                                           n, st)
                : mpc::launch_spd_solve_one_thread<float>(M, rhs, x, work, B,
                                                          n, st);
}
