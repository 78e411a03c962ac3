// Batched small SPD Cholesky factor and solve: the counterparts of the
// Pallas kernels _factor_kernel / _solve_kernel / _cholsolve_kernel
// (mpc_tuning_tpu/ops/pallas_kernels.py), in two layouts:
//  * batch-major (B, n, n) / (B, n): spd_factor and spd_factor_solve
//    (_factor_batched_impl / _solve_batched_impl), reached from the open
//    leg's masked PDIP (ops/qp.solve_qp_masked) and the NMPC dense PDIP
//    (ops/qp.solve_qp), and spd_solve (_spd_solve_batched_impl): factor
//    and both substitutions in one launch;
//  * lane-major (n, n, B) / (n, B), element (i, j, b) at (i n + j) B + b:
//    factor_lanes and solve_lanes, reached from the per-step engine
//    'pdip_ws_lanes' (ops/qp.pdip_lanes).  Neighbouring threads read
//    neighbouring addresses, so a warp's loads coalesce, and the PDIP loop
//    around them needs no transposes.
//
// The TPU factor (_factor_kernel, pallas_kernels.py:163) ran a right-looking
// Cholesky on a (8, 128)-tiled block of matrices in VMEM, one grid step per
// block, in order, on one core.  Here the two factors (spd_factor,
// factor_lanes) run one warp per matrix, W = 8 (float) or 4 (double)
// matrices a block, each factored in place in a padded tile in shared
// memory.  At the tunes' sizes (n <= 46, B = 8 to ~1024) a factor moves a
// few KB to a few MB and does B n^3 / 3 operations, so neither bytes nor
// FLOP/s bound it: launch latency and each matrix's serial chain of columns
// do, and bytes only at large B.  The design cuts the chain: left-looking,
// lane l holds rows l and l + 32, so a column's dots run on all rows at
// once (about n^2 / 2 dependent steps, not n^3 / 6); four columns share one
// pass over the dots; pivots travel by shuffle.  Each entry still sees the
// operations of the one-thread factor (spd_solve's) in their order
// (ascending k, then the sqrt or the division), so the two agree to the
// bit.  The block's loads go through cp.async, all in flight at once, and
// its stores are coalesced (16 bytes a thread batch-major, 32-byte runs
// lane-major).
//
// The batch-major solve (spd_factor_solve; the TPU's _solve_kernel,
// pallas_kernels.py:182, launched by _solve_batched_impl at :242) is bound
// the same way:
// 2 n^2 multiply-adds a system, a few KB to ~1 MB moved, launched on the
// tunes' small batches (B = 8 to ~1024).  It runs the factors' layout: one
// warp per system, W a block, the factor's lower triangle staged into a
// tile in shared memory by coalesced cp.async loads, the right-hand side
// in registers (lane l holds rows l and l + 32), and the substitutions of
// warp_factor.cuh (warp_chol_solve): one row a step, its value by shuffle
// to every lane and all later (forward) or earlier (back) rows updated at
// once, so ~2 n dependent steps in place of 2 n^2.  The forward pass keeps
// the one-thread solve's order (ascending k, then the division); the back
// pass subtracts in descending k, so it rounds differently from the
// one-thread design (kept as reference/spd_factor_solve_one_thread.cu).
// The lane-major solve (solve_lanes; the TPU's _solve_kernel on lane-major
// blocks, launched by solve_lanes at pallas_kernels.py:302) runs the same
// design on the lane-major layout: its tiles are loaded as factor_lanes
// loads them, and a system's x is the bits spd_factor_solve gives on it
// (its one-thread design is kept as reference/solve_lanes_one_thread.cu).
// spd_solve (the TPU's _cholsolve_kernel, launched by
// _spd_solve_batched_impl at pallas_kernels.py:120) is the two in one
// launch: one warp per system, W a block, the matrix loaded into its tile
// as spd_factor loads it, factored in place by warp_factor, then solved on
// the same tile by warp_chol_solve, with no device-memory scratch; its x is
// the bits spd_factor_solve gives on spd_factor's L (its one-thread design,
// which kept the factor in lane-major device scratch, is kept as
// reference/spd_solve_one_thread.cu).

#include "warp_factor.cuh"

namespace mpc {

// ------------------------------------------------ factors and the solve
//
// Envelope of the two factors, of the two solves, which read a factor in
// the same tiles, and of spd_solve, which factors and solves in them
// (ops/kernels.factor_envelope and factor_solve_envelope hold the same
// arithmetic): W =
// FactorShape<T>::kW matrices per block (8 at float, 4 at double, so that
// the W values of one element in the lane-major layout fill a 32-byte
// sector), each a tile of n rows at a row stride ld = n | 1 (odd, so the 32
// lanes reading one column of a tile hit 32 banks; at double in 8-byte
// words, half a warp at a time); W n ld sizeof(T) bytes of dynamic shared
// memory, at most kFactorSmemMax (the H100's 227 KB a block), and n <= 32
// kFactorMaxRows rows a lane.  Both dtypes take n <= 64 (133,120 bytes).

template <typename T>
struct FactorShape {
  static constexpr int kW = sizeof(T) == 8 ? 4 : 8;
};

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};

template <typename T>
long long factor_smem_bytes(int n) {
  return (long long)FactorShape<T>::kW * n * factor_ld(n) * sizeof(T);
}

template <typename T>
bool factor_fits(int n) {
  return n >= 1 && n <= 32 * kFactorMaxRows &&
         factor_smem_bytes<T>(n) <= kFactorSmemMax;
}

// Batch-major (B, n, n): block x takes matrices x W ... x W + W - 1, which
// lie contiguous in M and L, `count` elements in rows of n; element e, row
// e / n, sits at e + (e / n) (ld - n) in the block's tiles.  The block
// copies them with consecutive threads on consecutive elements: loads
// element by element through cp.async (the padded tile rows allow no
// 16-byte shared-memory stores), stores 16 bytes a thread where L allows.
template <typename T>
__device__ void load_rows(const T* __restrict__ g, T* __restrict__ tiles,
                          int count, int n, int ld) {
  for (int e = threadIdx.x; e < count; e += blockDim.x)
    cp_async(tiles + e + (e / n) * (ld - n), g + e);
  cp_async_wait();
}

// The lower triangles only, laid out as load_rows lays them out: what
// warp_chol_solve reads.
template <typename T>
__device__ void load_lower(const T* __restrict__ g, T* __restrict__ tiles,
                           int count, int n, int ld) {
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int row = e / n;  // the block's row: system row / n, row % n
    if (e - row * n <= row % n) cp_async(tiles + e + row * (ld - n), g + e);
  }
  cp_async_wait();
}

template <typename T>
__device__ void store_rows(const T* __restrict__ tiles, T* __restrict__ g,
                           int count, int n, int ld) {
  using V = typename Vec16<T>::type;
  constexpr int kV = 16 / sizeof(T);
  int e0 = 0;
  if ((reinterpret_cast<size_t>(g) & 15) == 0) {
    const int nv = count / kV;
    for (int v = threadIdx.x; v < nv; v += blockDim.x) {
      V x;
      T* xs = reinterpret_cast<T*>(&x);
#pragma unroll
      for (int u = 0; u < kV; ++u) {
        const int e = v * kV + u;
        xs[u] = tiles[e + (e / n) * (ld - n)];
      }
      reinterpret_cast<V*>(g)[v] = x;
    }
    e0 = nv * kV;
  }
  for (int e = e0 + threadIdx.x; e < count; e += blockDim.x)
    g[e] = tiles[e + (e / n) * (ld - n)];
}

// A warp past the batch's end skips the factor as a whole and only meets
// the block's barriers.
template <typename T, int R>
__global__ void __launch_bounds__(32 * FactorShape<T>::kW)
    spd_factor_kernel(const T* __restrict__ M, T* __restrict__ L, int B,
                      int n) {
  constexpr int W = FactorShape<T>::kW;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);
  const int ld = factor_ld(n), nn = n * n;
  const int b0 = blockIdx.x * W;
  const int nb = min(W, B - b0);
  const size_t off = (size_t)b0 * nn;
  load_rows(M + off, tiles, nb * nn, n, ld);
  __syncthreads();
  const int w = threadIdx.x >> 5;
  if (w < nb) warp_factor<T, R>(tiles + w * n * ld, n, ld, threadIdx.x & 31);
  __syncthreads();
  store_rows(tiles, L + off, nb * nn, n, ld);
}

// Batch-major solve, the factors' envelope (factor_fits): block x takes
// systems x W ... x W + W - 1; their factors' lower triangles (the solve
// reads no other part) go into the tiles as load_rows lays them out, the
// right-hand sides into registers, one warp a system.
template <typename T, int R>
__global__ void __launch_bounds__(32 * FactorShape<T>::kW)
    spd_factor_solve_kernel(const T* __restrict__ L,
                            const T* __restrict__ rhs, T* __restrict__ x,
                            int B, int n) {
  constexpr int W = FactorShape<T>::kW;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);
  const int ld = factor_ld(n), nn = n * n;
  const int b0 = blockIdx.x * W;
  const int nb = min(W, B - b0);
  load_lower(L + (size_t)b0 * nn, tiles, nb * nn, n, ld);
  __syncthreads();
  const int w = threadIdx.x >> 5, ln = threadIdx.x & 31;
  if (w >= nb) return;
  const size_t off = (size_t)(b0 + w) * n;
  T v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = ln + 32 * r;
    v[r] = i < n ? rhs[off + i] : T(0);
  }
  warp_chol_solve<T, R>(tiles + w * n * ld, ld, n, v, ln);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = ln + 32 * r;
    if (i < n) x[off + i] = v[r];
  }
}

// Factor and solve in one launch, the factors' envelope (factor_fits):
// block x takes systems x W ... x W + W - 1, their matrices loaded whole
// as spd_factor_kernel loads them (the factor reads the lower triangle
// only, but loading it alone, as spd_factor_solve_kernel loads L, took
// 9-12 % more device time on an H100 at B = 1024, n = 17 and 31:
// scripts/spd_solve_loads.py), each factored in place by its warp and
// solved on the same tile, the right-hand side in registers.  A pivot that
// is not > 0 leaves the tile NaN (warp_factor), so that system's x is all
// NaN, as the plain version's.
template <typename T, int R>
__global__ void __launch_bounds__(32 * FactorShape<T>::kW)
    spd_solve_kernel(const T* __restrict__ M, const T* __restrict__ rhs,
                     T* __restrict__ x, int B, int n) {
  constexpr int W = FactorShape<T>::kW;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);
  const int ld = factor_ld(n), nn = n * n;
  const int b0 = blockIdx.x * W;
  const int nb = min(W, B - b0);
  load_rows(M + (size_t)b0 * nn, tiles, nb * nn, n, ld);
  __syncthreads();
  const int w = threadIdx.x >> 5, ln = threadIdx.x & 31;
  if (w >= nb) return;
  T* tile = tiles + w * n * ld;
  warp_factor<T, R>(tile, n, ld, ln);
  __syncwarp();
  const size_t off = (size_t)(b0 + w) * n;
  T v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = ln + 32 * r;
    v[r] = i < n ? rhs[off + i] : T(0);
  }
  warp_chol_solve<T, R>(tile, ld, n, v, ln);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = ln + 32 * r;
    if (i < n) x[off + i] = v[r];
  }
}

// Lane-major (n, n, B), element (i, j, b) at (i n + j) B + b: block x
// takes lanes b0 = x W ... b0 + W - 1.  Thread t copies elements e = t / W,
// e + 32, ... of lane b0 + t % W, so the W values of one element are one
// contiguous run of 32 bytes.  Only the lower triangle is loaded (the
// factor reads no other); the store writes every element.
template <typename T, int R>
__global__ void __launch_bounds__(32 * FactorShape<T>::kW)
    factor_lanes_kernel(const T* __restrict__ M, T* __restrict__ L, int B,
                        int n) {
  constexpr int W = FactorShape<T>::kW;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);
  const int ld = factor_ld(n), nn = n * n;
  const int b0 = blockIdx.x * W;
  const int mine = threadIdx.x % W, b = b0 + mine;
  T* tile = tiles + mine * n * ld;
  if (b < B)
    for (int e = threadIdx.x / W; e < nn; e += 32) {
      const int i = e / n, j = e - i * n;
      if (j <= i) cp_async(tile + i * ld + j, M + (size_t)e * B + b);
    }
  cp_async_wait();
  __syncthreads();
  const int w = threadIdx.x >> 5;
  if (b0 + w < B)
    warp_factor<T, R>(tiles + w * n * ld, n, ld, threadIdx.x & 31);
  __syncthreads();
  if (b < B)
    for (int e = threadIdx.x / W; e < nn; e += 32) {
      const int i = e / n;
      L[(size_t)e * B + b] = tile[i * ld + e - i * n];
    }
}

// Lane-major solve, the factors' envelope (factor_fits): block x takes
// systems b0 = x W ... b0 + W - 1; their factors' lower triangles go into
// the tiles by factor_lanes_kernel's lane-major copy (the W values of one
// element, one run of 32 bytes), the right-hand sides into registers, one
// warp a system, and the substitutions of spd_factor_solve_kernel: a
// system's x is the bits the batch-major solve gives on it.
template <typename T, int R>
__global__ void __launch_bounds__(32 * FactorShape<T>::kW)
    solve_lanes_kernel(const T* __restrict__ L, const T* __restrict__ rhs,
                       T* __restrict__ x, int B, int n) {
  constexpr int W = FactorShape<T>::kW;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);
  const int ld = factor_ld(n), nn = n * n;
  const int b0 = blockIdx.x * W;
  const int mine = threadIdx.x % W;
  T* tile = tiles + mine * n * ld;
  if (b0 + mine < B)
    for (int e = threadIdx.x / W; e < nn; e += 32) {
      const int i = e / n, j = e - i * n;
      if (j <= i) cp_async(tile + i * ld + j, L + (size_t)e * B + b0 + mine);
    }
  cp_async_wait();
  __syncthreads();
  const int w = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const int b = b0 + w;
  if (b >= B) return;
  T v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = ln + 32 * r;
    v[r] = i < n ? rhs[(size_t)i * B + b] : T(0);
  }
  warp_chol_solve<T, R>(tiles + w * n * ld, ld, n, v, ln);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = ln + 32 * r;
    if (i < n) x[(size_t)i * B + b] = v[r];
  }
}

namespace {
// The dynamic shared memory each tile kernel (spd_factor, factor_lanes,
// spd_factor_solve, solve_lanes, spd_solve; dtype; rows a lane) is
// allowed on each device so far:
// above 48 KB a block's has to be allowed, once a kernel and device, for
// the most any launch has needed.  Internal linkage, so two libraries
// loaded in one process keep their own (a template's static would be one
// symbol in the whole process).
constexpr int kMaxDevices = 64;
enum { kTileFactor, kTileFactorLanes, kTileSolve, kTileSolveLanes,
       kTileSpdSolve, kTileKernels };
int g_tile_smem[kTileKernels][2][kFactorMaxRows][kMaxDevices];
}  // namespace

// Allow `kernel` (tile kernel `which`, dtype T, R rows a lane) `smem` bytes
// of dynamic shared memory on the current device; a CUDA error code or 0.
template <typename T, int R, typename Kernel>
int allow_tile_smem(Kernel kernel, int which, int smem) {
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int& allowed = g_tile_smem[which][sizeof(T) == 8][R - 1][dev];
  if (smem > allowed) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  return 0;
}

template <typename T, int R>
int launch_factor_rows(bool lanes, const T* M, T* L, int B, int n,
                       cudaStream_t st) {
  constexpr int W = FactorShape<T>::kW;
  void (*kernel)(const T*, T*, int, int) =
      lanes ? factor_lanes_kernel<T, R> : spd_factor_kernel<T, R>;
  const int smem = (int)factor_smem_bytes<T>(n);
  const int e = allow_tile_smem<T, R>(
      kernel, lanes ? kTileFactorLanes : kTileFactor, smem);
  if (e) return e;
  kernel<<<(B + W - 1) / W, 32 * W, smem, st>>>(M, L, B, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_factor(bool lanes, const void* M, void* L, int B, int n,
                  cudaStream_t st) {
  if (!factor_fits<T>(n)) return (int)cudaErrorInvalidValue;
  const T* m = static_cast<const T*>(M);
  T* l = static_cast<T*>(L);
  return n <= 32 ? launch_factor_rows<T, 1>(lanes, m, l, B, n, st)
                 : launch_factor_rows<T, 2>(lanes, m, l, B, n, st);
}

template <typename T, int R>
int launch_solve_rows(bool lanes, const T* L, const T* rhs, T* x, int B,
                      int n, cudaStream_t st) {
  constexpr int W = FactorShape<T>::kW;
  void (*kernel)(const T*, const T*, T*, int, int) =
      lanes ? solve_lanes_kernel<T, R> : spd_factor_solve_kernel<T, R>;
  const int smem = (int)factor_smem_bytes<T>(n);
  const int e = allow_tile_smem<T, R>(
      kernel, lanes ? kTileSolveLanes : kTileSolve, smem);
  if (e) return e;
  kernel<<<(B + W - 1) / W, 32 * W, smem, st>>>(L, rhs, x, B, n);
  return (int)cudaGetLastError();
}

// lanes: the lane-major solve_lanes, else the batch-major
// spd_factor_solve; both inside the factors' envelope.
template <typename T>
int launch_solve(bool lanes, const void* L, const void* rhs, void* x, int B,
                 int n, cudaStream_t st) {
  if (!factor_fits<T>(n)) return (int)cudaErrorInvalidValue;
  const T* l = static_cast<const T*>(L);
  const T* r = static_cast<const T*>(rhs);
  T* xo = static_cast<T*>(x);
  return n <= 32 ? launch_solve_rows<T, 1>(lanes, l, r, xo, B, n, st)
                 : launch_solve_rows<T, 2>(lanes, l, r, xo, B, n, st);
}

template <typename T, int R>
int launch_spd_solve_rows(const T* M, const T* rhs, T* x, int B, int n,
                          cudaStream_t st) {
  constexpr int W = FactorShape<T>::kW;
  const int smem = (int)factor_smem_bytes<T>(n);
  const int e = allow_tile_smem<T, R>(spd_solve_kernel<T, R>, kTileSpdSolve,
                                      smem);
  if (e) return e;
  spd_solve_kernel<T, R><<<(B + W - 1) / W, 32 * W, smem, st>>>(M, rhs, x, B,
                                                                n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_spd_solve(const void* M, const void* rhs, void* x, int B, int n,
                     cudaStream_t st) {
  if (!factor_fits<T>(n)) return (int)cudaErrorInvalidValue;
  const T* m = static_cast<const T*>(M);
  const T* r = static_cast<const T*>(rhs);
  T* xo = static_cast<T*>(x);
  return n <= 32 ? launch_spd_solve_rows<T, 1>(m, r, xo, B, n, st)
                 : launch_spd_solve_rows<T, 2>(m, r, xo, B, n, st);
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

// Factor and solve in one launch, inside the factors' envelope.
int mpc_spd_solve(int is_f64, const void* M, const void* rhs, void* x, int B,
                  int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? mpc::launch_spd_solve<double>(M, rhs, x, B, n, st)
                : mpc::launch_spd_solve<float>(M, rhs, x, B, n, st);
}

const char* mpc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
