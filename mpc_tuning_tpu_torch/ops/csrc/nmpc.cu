// The NMPC prediction rollout and its sensitivities (ops/kernels.py
// nmpc_rollout).  Not the counterpart of a Pallas kernel: on the TPU, XLA
// fuses the JAX package's rollout (mpc_tuning_tpu/sim/nmpc_loop.py
// _rollout_y) and its jax.jacfwd into the compiled NMPC step; eager
// PyTorch would spend ~1e5 launches on one rollout.
//
// For candidate b the input at prediction step k is
//   u(k) = u_prev + sum_{t <= min(k, m - 1, hold[b])} cmask[t] du[t]
// (held after the control horizon), the state advances one sample interval
// of `substeps` RK4 steps of the Van de Vusse CSTR (models/ode.py
// vandevusse_rhs, the same constants), and Y[b, k, o] is state out[o]
// after step k.  With jac, J[b, k ny + o, j] = dY[b, k, o] / d du[j], the
// exact derivative of the discrete map: the tangent of du[j] is carried
// through every RK4 stage with the rhs partials written out.
//
// One thread per (candidate, tangent column): each thread recomputes the
// 3-state primal beside its own tangent, so no thread waits on another.
// The work is p * substeps * 4 rhs evaluations (three exp each) per
// thread, a serial chain of a few thousand dependent operations: the
// kernel is bound by that chain's latency, not by bytes or FLOP/s.

#include "common.cuh"

namespace mpc {

// models/ode.py VDV_PARAMS (MPC-Tuning/vandevusse_model.m:39-77)
constexpr double kK10 = 1.287e12, kK20 = 1.287e12, kK30 = 9.043e9;
constexpr double kE1 = -9758.3, kE2 = -9758.3, kE3 = -8560.0;
constexpr double kDAB = -4.20, kDBC = 11.00, kDAD = 41.85;
constexpr double kRho = 0.9342, kCp = 3.01, kKw = 4032.0, kAr = 0.215;
constexpr double kV = 10.0, kT0 = 130.0, kCa0 = 5.10;

// dx/dt (and, with TAN, its directional derivative along (dx, du)), in
// the operation order of vandevusse_rhs.
template <typename T, bool TAN>
__device__ __forceinline__ void vdv_rhs(const T* x, const T* u, const T* dx,
                                        const T* du, T* f, T* df) {
  const T fov = u[0], Tk = u[1];
  const T ca = x[0], cb = x[1], Tt = x[2];
  const T tk = Tt + T(273.15);
  const T k1 = T(kK10) * exp(T(kE1) / tk);
  const T k2 = T(kK20) * exp(T(kE2) / tk);
  const T k3 = T(kK30) * exp(T(kE3) / tk);
  const T c1 = T(1.0 / (kRho * kCp));
  const T c2 = T(kKw * kAr / (kRho * kCp * kV));
  f[0] = fov * (T(kCa0) - ca) - k1 * ca - k3 * ca * ca;
  f[1] = -fov * cb + k1 * ca - k2 * cb;
  f[2] = c1 * (k1 * ca * T(kDAB) + k2 * cb * T(kDBC) + k3 * (ca * ca) * T(kDAD))
         + fov * (T(kT0) - Tt) + c2 * (Tk - Tt);
  if (TAN) {
    const T itk2 = T(1) / (tk * tk);
    const T g1 = k1 * (T(-kE1) * itk2) * dx[2];  // d k1
    const T g2 = k2 * (T(-kE2) * itk2) * dx[2];
    const T g3 = k3 * (T(-kE3) * itk2) * dx[2];
    const T r1 = g1 * ca + k1 * dx[0];           // d (k1 ca)
    const T r2 = g2 * cb + k2 * dx[1];           // d (k2 cb)
    const T r3 = g3 * ca * ca + T(2) * k3 * ca * dx[0];  // d (k3 ca^2)
    df[0] = du[0] * (T(kCa0) - ca) - fov * dx[0] - r1 - r3;
    df[1] = -du[0] * cb - fov * dx[1] + r1 - r2;
    df[2] = c1 * (r1 * T(kDAB) + r2 * T(kDBC) + r3 * T(kDAD))
            + du[0] * (T(kT0) - Tt) - fov * dx[2] + c2 * (du[1] - dx[2]);
  }
}

// One RK4 step of length dt (rk4_step's operation order), tangent along.
template <typename T, bool TAN>
__device__ __forceinline__ void rk4(T* x, T* dx, const T* u, const T* du,
                                    T h2, T h, T h6) {
  T k[4][3], d[4][3], xs[3], dxs[3];
  vdv_rhs<T, TAN>(x, u, dx, du, k[0], d[0]);
  for (int s = 1; s < 4; ++s) {
    const T c = s < 3 ? h2 : h;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      xs[i] = x[i] + c * k[s - 1][i];
      if (TAN) dxs[i] = dx[i] + c * d[s - 1][i];
    }
    vdv_rhs<T, TAN>(xs, u, dxs, du, k[s], d[s]);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    x[i] = x[i] + h6 * (k[0][i] + T(2) * k[1][i] + T(2) * k[2][i] + k[3][i]);
    if (TAN)
      dx[i] = dx[i] + h6 * (d[0][i] + T(2) * d[1][i] + T(2) * d[2][i]
                            + d[3][i]);
  }
}

template <typename T, bool TAN>
__global__ void nmpc_rollout_kernel(const T* __restrict__ x0,
                                    const T* __restrict__ u_prev,
                                    const T* __restrict__ dmove,
                                    const T* __restrict__ cmask,
                                    const int* __restrict__ hold,
                                    T* __restrict__ Y, T* __restrict__ J,
                                    int B, int p, int m, int substeps,
                                    int ny, int o0, int o1, int o2,
                                    double Ts) {
  constexpr int nu = 2;
  const int ncol = TAN ? m * nu : 1;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)B * ncol) return;
  const int b = (int)(tid / ncol), j = (int)(tid % ncol);
  const int tcol = j / nu, icol = j % nu;
  const int out[3] = {o0, o1, o2};
  T x[3], dx[3] = {T(0), T(0), T(0)}, acc[2] = {T(0), T(0)};
  for (int i = 0; i < 3; ++i) x[i] = x0[(size_t)b * 3 + i];
  const T up0 = u_prev[(size_t)b * nu], up1 = u_prev[(size_t)b * nu + 1];
  const int last = hold ? min(m - 1, hold[b]) : m - 1;
  const T* dm = dmove + (size_t)b * m * nu;
  const T* cm = cmask + (size_t)b * m;
  const T cm_col = TAN ? cm[tcol] : T(0);
  const double dt = Ts / substeps;
  const T h2 = T(0.5 * dt), h = T(dt), h6 = T(dt / 6.0);
  const int pny = p * ny;
  int t_in = -1;  // moves summed into acc so far: t <= t_in
  for (int k = 0; k < p; ++k) {
    const int lim = min(k, last);
    while (t_in < lim) {
      ++t_in;
      acc[0] += dm[t_in * nu] * cm[t_in];
      acc[1] += dm[t_in * nu + 1] * cm[t_in];
    }
    const T u[2] = {up0 + acc[0], up1 + acc[1]};
    T du[2] = {T(0), T(0)};
    if (TAN && tcol <= lim) du[icol] = cm_col;
    for (int s = 0; s < substeps; ++s) rk4<T, TAN>(x, dx, u, du, h2, h, h6);
    for (int o = 0; o < ny; ++o) {
      const size_t row = (size_t)b * pny + (size_t)k * ny + o;
      if (j == 0) Y[row] = x[out[o]];
      if (TAN) J[row * ncol + j] = dx[out[o]];
    }
  }
}

enum { R_X, R_UPREV, R_DU, R_CMASK, R_HOLD, R_Y, R_J, R_COUNT };
enum { D_B, D_P, D_M, D_SUBSTEPS, D_JAC, D_NY, D_O0, D_O1, D_O2 };

template <typename T>
int launch_rollout(void* const* ptr, const int* d, double Ts,
                   cudaStream_t st) {
  const bool jac = d[D_JAC] != 0;
  const long long threads =
      (long long)d[D_B] * (jac ? d[D_M] * 2 : 1);
  if (threads == 0) return 0;
  constexpr int kThreads = 128;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  auto c = [&](int k) { return static_cast<const T*>(ptr[k]); };
  const int* hold = static_cast<const int*>(ptr[R_HOLD]);
  T* Y = static_cast<T*>(ptr[R_Y]);
  T* J = static_cast<T*>(ptr[R_J]);
  if (jac)
    nmpc_rollout_kernel<T, true><<<blocks, kThreads, 0, st>>>(
        c(R_X), c(R_UPREV), c(R_DU), c(R_CMASK), hold, Y, J, d[D_B], d[D_P],
        d[D_M], d[D_SUBSTEPS], d[D_NY], d[D_O0], d[D_O1], d[D_O2], Ts);
  else
    nmpc_rollout_kernel<T, false><<<blocks, kThreads, 0, st>>>(
        c(R_X), c(R_UPREV), c(R_DU), c(R_CMASK), hold, Y, J, d[D_B], d[D_P],
        d[D_M], d[D_SUBSTEPS], d[D_NY], d[D_O0], d[D_O1], d[D_O2], Ts);
  return (int)cudaGetLastError();
}

}  // namespace mpc

extern "C" {

// ptr: x (B, 3), u_prev (B, 2), du (B, m 2), cmask (B, m), hold (B,) int32
// or null, Y (B, p ny), J (B, p ny, m 2) or null; dims: B, p, m, substeps,
// jac, ny, out[0..2].
int mpc_nmpc_rollout(int is_f64, void* const* ptr, const int* dims,
                     double Ts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? mpc::launch_rollout<double>(ptr, dims, Ts, st)
                : mpc::launch_rollout<float>(ptr, dims, Ts, st);
}

}  // extern "C"
