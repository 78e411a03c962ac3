// Shared helpers of the port's hand-written Hopper kernels.
//
// The kernels run one candidate per thread (the SPD factors of spd.cu: one
// warp per matrix, the tile in shared memory; the whole-sim tracking
// kernels of closed_sim.cu: one warp per candidate, its state in shared
// memory).  Per-candidate data is
// lane-major: element i of a per-candidate vector lives at p[i * B + lane],
// so the threads of a warp touch neighbouring addresses.  Lane<T> wraps a
// pointer already offset by the lane.
//
// NaN semantics follow jnp.minimum / jnp.maximum / jnp.min: a NaN operand
// wins.  CUDA's fmin/fmax return the non-NaN operand instead, so the
// kernels use nmin / nmax everywhere the reference takes a min or a max.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace mpc {

template <typename T>
struct Lane {
  T* p;
  int B;
  __device__ __forceinline__ T& operator[](int i) const {
    return p[(size_t)i * B];
  }
};

template <typename T>
struct CLane {
  const T* __restrict__ p;
  int B;
  __device__ __forceinline__ T operator[](int i) const {
    return p[(size_t)i * B];
  }
};

template <typename T>
__device__ __forceinline__ Lane<T> lane_at(T* base, size_t row, int B,
                                           int lane) {
  return Lane<T>{base + row * (size_t)B + lane, B};
}

template <typename T>
__device__ __forceinline__ CLane<T> clane_at(const T* base, int B, int lane) {
  return CLane<T>{base + lane, B};
}

// (a != a) is the NaN test; the kernels are built without fast-math.
template <typename T>
__device__ __forceinline__ T nmin(T a, T b) {
  return (a < b || a != a) ? a : b;
}

template <typename T>
__device__ __forceinline__ T nmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}

template <typename T>
__device__ __forceinline__ T inf_value();

template <>
__device__ __forceinline__ float inf_value<float>() {
  return __int_as_float(0x7f800000);
}

template <>
__device__ __forceinline__ double inf_value<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

// the quiet NaN that torch's float('nan') fills with
template <typename T>
__device__ __forceinline__ T nan_value();

template <>
__device__ __forceinline__ float nan_value<float>() {
  return __int_as_float(0x7fc00000);
}

template <>
__device__ __forceinline__ double nan_value<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

}  // namespace mpc
