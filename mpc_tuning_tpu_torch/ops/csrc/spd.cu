// Batched small SPD Cholesky factor and solve: the counterparts of the
// Pallas kernels _factor_kernel / _solve_kernel / _cholsolve_kernel
// (mpc_tuning_tpu/ops/pallas_kernels.py), in two layouts:
//  * batch-major (B, n, n) / (B, n): spd_factor and spd_factor_solve
//    (_factor_batched_impl / _solve_batched_impl), reached from the open
//    leg's masked PDIP (ops/qp.solve_qp_masked) and the NMPC dense PDIP
//    (ops/qp.solve_qp), and spd_solve (_spd_solve_batched_impl): factor
//    and both substitutions in one launch, the factor kept in lane-major
//    device scratch (work[(i n + j) B + b]) so a warp's scratch accesses
//    coalesce;
//  * lane-major (n, n, B) / (n, B), element (i, j, b) at (i n + j) B + b:
//    factor_lanes and solve_lanes, reached from the per-step engine
//    'pdip_ws_lanes' (ops/qp.pdip_lanes).  Neighbouring threads read
//    neighbouring addresses, so a warp's loads coalesce, and the PDIP loop
//    around them needs no transposes.
//
// One thread per matrix.  The work is n^3/6 dependent multiply-adds per
// matrix at n <= 46 (a few thousand to ~16,000), so the kernels are bound
// by the latency of that serial chain, not by bytes or FLOP/s; a batch of
// B matrices keeps B threads busy.  The upper triangle of L is written as
// zeros, as the Pallas factor and torch.linalg.cholesky leave it.

#include "common.cuh"

namespace mpc {

template <typename T>
__global__ void spd_factor_kernel(const T* __restrict__ M, T* __restrict__ L,
                                  int B, int n) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const T* A = M + (size_t)b * n * n;
  T* Lb = L + (size_t)b * n * n;
  for (int j = 0; j < n; ++j) {
    T d = A[j * n + j];
    for (int k = 0; k < j; ++k) d -= Lb[j * n + k] * Lb[j * n + k];
    const T ljj = sqrt(d);
    Lb[j * n + j] = ljj;
    for (int i = j + 1; i < n; ++i) {
      T v = A[i * n + j];
      for (int k = 0; k < j; ++k) v -= Lb[i * n + k] * Lb[j * n + k];
      Lb[i * n + j] = v / ljj;
    }
    for (int i = 0; i < j; ++i) Lb[i * n + j] = T(0);
  }
}

template <typename T>
__global__ void spd_factor_solve_kernel(const T* __restrict__ L,
                                        const T* __restrict__ rhs,
                                        T* __restrict__ x, int B, int n) {
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

// Factor and solve in one launch.  A pivot that is not > 0 (the factor
// fails, as cholesky_ex reports it) makes the whole solution NaN, as the
// plain version's NaN factor does.
template <typename T>
__global__ void spd_solve_kernel(const T* __restrict__ M,
                                 const T* __restrict__ rhs,
                                 T* __restrict__ x, T* __restrict__ work,
                                 int B, int n) {
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

// Lane-major: the same arithmetic, indices through Lane / CLane.
template <typename T>
__global__ void factor_lanes_kernel(const T* __restrict__ M,
                                    T* __restrict__ L, int B, int n) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const CLane<T> A = clane_at(M, B, b);
  const Lane<T> Lb = lane_at(L, 0, B, b);
  for (int j = 0; j < n; ++j) {
    T d = A[j * n + j];
    for (int k = 0; k < j; ++k) d -= Lb[j * n + k] * Lb[j * n + k];
    const T ljj = sqrt(d);
    Lb[j * n + j] = ljj;
    for (int i = j + 1; i < n; ++i) {
      T v = A[i * n + j];
      for (int k = 0; k < j; ++k) v -= Lb[i * n + k] * Lb[j * n + k];
      Lb[i * n + j] = v / ljj;
    }
    for (int i = 0; i < j; ++i) Lb[i * n + j] = T(0);
  }
}

template <typename T>
__global__ void solve_lanes_kernel(const T* __restrict__ L,
                                   const T* __restrict__ rhs,
                                   T* __restrict__ x, int B, int n) {
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

constexpr int kSpdThreads = 128;

template <typename T>
int launch_factor(bool lanes, const void* M, void* L, int B, int n,
                  cudaStream_t st) {
  const int blocks = (B + kSpdThreads - 1) / kSpdThreads;
  if (lanes)
    factor_lanes_kernel<T><<<blocks, kSpdThreads, 0, st>>>(
        static_cast<const T*>(M), static_cast<T*>(L), B, n);
  else
    spd_factor_kernel<T><<<blocks, kSpdThreads, 0, st>>>(
        static_cast<const T*>(M), static_cast<T*>(L), B, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_solve(bool lanes, const void* L, const void* rhs, void* x, int B,
                 int n, cudaStream_t st) {
  const int blocks = (B + kSpdThreads - 1) / kSpdThreads;
  if (lanes)
    solve_lanes_kernel<T><<<blocks, kSpdThreads, 0, st>>>(
        static_cast<const T*>(L), static_cast<const T*>(rhs),
        static_cast<T*>(x), B, n);
  else
    spd_factor_solve_kernel<T><<<blocks, kSpdThreads, 0, st>>>(
        static_cast<const T*>(L), static_cast<const T*>(rhs),
        static_cast<T*>(x), B, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_spd_solve(const void* M, const void* rhs, void* x, void* work,
                     int B, int n, cudaStream_t st) {
  const int blocks = (B + kSpdThreads - 1) / kSpdThreads;
  spd_solve_kernel<T><<<blocks, kSpdThreads, 0, st>>>(
      static_cast<const T*>(M), static_cast<const T*>(rhs),
      static_cast<T*>(x), static_cast<T*>(work), B, n);
  return (int)cudaGetLastError();
}

}  // namespace mpc

extern "C" {

// lanes = 0: batch-major (B, n, n); lanes = 1: lane-major (n, n, B).
int mpc_spd_factor(int is_f64, int lanes, const void* M, void* L, int B,
                   int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? mpc::launch_factor<double>(lanes != 0, M, L, B, n, st)
                : mpc::launch_factor<float>(lanes != 0, M, L, B, n, st);
}

int mpc_spd_factor_solve(int is_f64, int lanes, const void* L,
                         const void* rhs, void* x, int B, int n,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? mpc::launch_solve<double>(lanes != 0, L, rhs, x, B, n, st)
                : mpc::launch_solve<float>(lanes != 0, L, rhs, x, B, n, st);
}

// work: n * n * B scratch of the factor, lane-major.
int mpc_spd_solve(int is_f64, const void* M, const void* rhs, void* x,
                  void* work, int B, int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? mpc::launch_spd_solve<double>(M, rhs, x, work, B, n, st)
                : mpc::launch_spd_solve<float>(M, rhs, x, work, B, n, st);
}

const char* mpc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
