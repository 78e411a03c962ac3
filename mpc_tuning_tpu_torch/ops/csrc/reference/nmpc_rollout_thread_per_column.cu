// The thread-per-column design of nmpc_rollout (ops/csrc/nmpc.cu) that the
// producer-and-consumers kernel replaced, kept as its reference, with the
// move mask taken per column (B, m nu) as the new kernel takes it
// (cmask[t nu + i] in place of cmask[t]: a per-step mask spread over the
// inputs gives its old bits).  Built on demand into its own library
// (ops/_build.reference_library); no path of the port calls it.
//
// For candidate b the input at prediction step k is
//   u(k) = u_prev + sum_{t <= min(k, m - 1, hold[b])} cmask[t nu + i] du[t nu + i]
// per input i (held after the control horizon), the state advances one
// sample interval of `substeps` steps of the Van de Vusse CSTR (models/
// ode.py vandevusse_rhs, the same constants), and Y[b, k, o] is state
// out[o] after step k.  Two steppers, a template parameter:
//  - RK4 (models/ode.py rk4_step);
//  - TR-BDF2 (models/ode.py tr_bdf2_step): a trapezoidal stage to
//    t + g dt from x + g dt f(x), then a BDF2 stage from it, each by
//    kNewton full-Newton iterations whose 3 x 3 Jacobian I - a fx is
//    formed from the written-out partials (vandevusse_partials) and
//    solved in registers by LU with partial pivoting.
// With jac, J[b, k ny + o, j] = dY[b, k, o] / d du[j]: RK4 carries the
// tangent of du[j] through every stage with the rhs partials written out
// (the exact derivative of the discrete map); TR-BDF2 differentiates each
// converged stage (integrate_tangent: the partials at x, xg and xn, then
// two 3 x 3 solves on the thread's column), not the Newton iterations.
//
// One thread per (candidate, tangent column): each thread recomputes the
// 3-state primal beside its own tangent, so no thread waits on another.
// The kernel is bound by each thread's serial chain of dependent
// operations, not by bytes or FLOP/s: p * substeps * 4 rhs evaluations
// (three exp each) with RK4, p * substeps * (1 + 2 * kNewton + 3) rhs and
// partials evaluations (three exp each, the Arrhenius terms formed once
// per evaluation) and 2 * kNewton + 2 3 x 3 solves with TR-BDF2, about
// four times RK4's chain at kNewton = 6.

#include "../common.cuh"

namespace mpc {

// models/ode.py VDV_PARAMS (MPC-Tuning/vandevusse_model.m:39-77)
constexpr double kK10 = 1.287e12, kK20 = 1.287e12, kK30 = 9.043e9;
constexpr double kE1 = -9758.3, kE2 = -9758.3, kE3 = -8560.0;
constexpr double kDAB = -4.20, kDBC = 11.00, kDAD = 41.85;
constexpr double kRho = 0.9342, kCp = 3.01, kKw = 4032.0, kAr = 0.215;
constexpr double kV = 10.0, kT0 = 130.0, kCa0 = 5.10;

// The Arrhenius rates k1, k2, k3 at temperature T + 273.15 = tk.
template <typename T>
__device__ __forceinline__ void vdv_rates(T tk, T& k1, T& k2, T& k3) {
  k1 = T(kK10) * exp(T(kE1) / tk);
  k2 = T(kK20) * exp(T(kE2) / tk);
  k3 = T(kK30) * exp(T(kE3) / tk);
}

// dx/dt at the rates k1, k2, k3, in the operation order of vandevusse_rhs.
template <typename T>
__device__ __forceinline__ void vdv_f(const T* x, const T* u, T k1, T k2,
                                      T k3, T* f) {
  const T fov = u[0], Tk = u[1];
  const T ca = x[0], cb = x[1], Tt = x[2];
  const T c1 = T(1.0 / (kRho * kCp));
  const T c2 = T(kKw * kAr / (kRho * kCp * kV));
  f[0] = fov * (T(kCa0) - ca) - k1 * ca - k3 * ca * ca;
  f[1] = -fov * cb + k1 * ca - k2 * cb;
  f[2] = c1 * (k1 * ca * T(kDAB) + k2 * cb * T(kDBC) + k3 * (ca * ca) * T(kDAD))
         + fov * (T(kT0) - Tt) + c2 * (Tk - Tt);
}

// dx/dt (and, with TAN, its directional derivative along (dx, du)), in
// the operation order of vandevusse_rhs.
template <typename T, bool TAN>
__device__ __forceinline__ void vdv_rhs(const T* x, const T* u, const T* dx,
                                        const T* du, T* f, T* df) {
  const T fov = u[0];
  const T ca = x[0], cb = x[1], Tt = x[2];
  const T tk = Tt + T(273.15);
  T k1, k2, k3;
  vdv_rates(tk, k1, k2, k3);
  vdv_f(x, u, k1, k2, k3, f);
  if (TAN) {
    const T c1 = T(1.0 / (kRho * kCp));
    const T c2 = T(kKw * kAr / (kRho * kCp * kV));
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

// dx/dt and its state partials fx = d rhs / dx (vandevusse_partials'
// formulas) around one set of Arrhenius terms.
template <typename T>
__device__ __forceinline__ void vdv_rhs_fx(const T* x, const T* u, T* f,
                                           T (&fx)[3][3]) {
  const T fov = u[0];
  const T ca = x[0], cb = x[1];
  const T tk = x[2] + T(273.15);
  T k1, k2, k3;
  vdv_rates(tk, k1, k2, k3);
  vdv_f(x, u, k1, k2, k3, f);
  const T c1 = T(1.0 / (kRho * kCp));
  const T c2 = T(kKw * kAr / (kRho * kCp * kV));
  const T itk2 = T(1) / (tk * tk);
  const T g1 = k1 * (T(-kE1) * itk2);  // d k_i / dT
  const T g2 = k2 * (T(-kE2) * itk2);
  const T g3 = k3 * (T(-kE3) * itk2);
  fx[0][0] = -fov - k1 - T(2) * k3 * ca;
  fx[0][1] = T(0);
  fx[0][2] = -g1 * ca - g3 * ca * ca;
  fx[1][0] = k1;
  fx[1][1] = -fov - k2;
  fx[1][2] = g1 * ca - g2 * cb;
  fx[2][0] = c1 * (k1 * T(kDAB) + T(2) * k3 * ca * T(kDAD));
  fx[2][1] = c1 * k2 * T(kDBC);
  fx[2][2] = c1 * (g1 * ca * T(kDAB) + g2 * cb * T(kDBC)
                   + g3 * (ca * ca) * T(kDAD)) - fov - c2;
}

// fu du, the input partials (vandevusse_partials' fu) along du.
template <typename T>
__device__ __forceinline__ void vdv_fu_du(const T* x, const T* du, T* out) {
  const T c2 = T(kKw * kAr / (kRho * kCp * kV));
  out[0] = (T(kCa0) - x[0]) * du[0];
  out[1] = -x[1] * du[0];
  out[2] = (T(kT0) - x[2]) * du[0] + c2 * du[1];
}

template <typename T>
__device__ __forceinline__ void swap_if(bool c, T& a, T& b) {
  const T t = a;
  a = c ? b : a;
  b = c ? t : b;
}

// b <- (I - a F)^-1 b for a 3 x 3 F, by LU with partial pivoting (the
// largest |pivot| of each column, first on a tie, as LAPACK's getrf picks
// it), in registers.
template <typename T>
__device__ __forceinline__ void solve_i_minus(T a, const T (&F)[3][3],
                                              T (&b)[3]) {
  T A[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) A[i][j] = (i == j ? T(1) : T(0)) - a * F[i][j];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int i = k + 1; i < 3; ++i) {
      const bool s = fabs(A[i][k]) > fabs(A[k][k]);
#pragma unroll
      for (int j = k; j < 3; ++j) swap_if(s, A[k][j], A[i][j]);
      swap_if(s, b[k], b[i]);
    }
#pragma unroll
    for (int i = k + 1; i < 3; ++i) {
      const T l = A[i][k] / A[k][k];
#pragma unroll
      for (int j = k + 1; j < 3; ++j) A[i][j] -= l * A[k][j];
      b[i] -= l * b[k];
    }
  }
  b[2] = b[2] / A[2][2];
  b[1] = (b[1] - A[1][2] * b[2]) / A[1][1];
  b[0] = (b[0] - A[0][1] * b[1] - A[0][2] * b[2]) / A[0][0];
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

constexpr int kNewton = 6;  // models/ode.py tr_bdf2_step's newton_iters
enum { S_RK4, S_TRBDF2 };  // the steppers; models/ode.py NMPC_INTEGRATORS

// TR-BDF2's step coefficients at step length dt (models/ode.py
// _tr_bdf2_stages): g = 2 - sqrt(2).
struct TrCoef {
  double gdt, a, c1, c2, c3dt;
  __device__ explicit TrCoef(double dt) {
    const double g = 2.0 - sqrt(2.0);
    gdt = g * dt;
    a = 0.5 * g * dt;
    c1 = 1.0 / (g * (2.0 - g));
    c2 = (1.0 - g) * (1.0 - g) / (g * (2.0 - g));
    c3dt = (1.0 - g) / (2.0 - g) * dt;
  }
};

// One TR-BDF2 step of length dt (tr_bdf2_step's residuals and initial
// guesses, each implicit stage by kNewton Newton iterations); with TAN the
// tangent of the converged stages (integrate_tangent's TR-BDF2 branch):
//   dxg = (I - a fx(xg))^-1 (dx + a (fx(x) dx + fu(x) du + fu(xg) du))
//   dxn = (I - c3 dt fx(xn))^-1 (c1 dxg - c2 dx + c3 dt fu(xn) du).
template <typename T, bool TAN>
__device__ __forceinline__ void trbdf2(T* x, T* dx, const T* u, const T* du,
                                       const TrCoef& c) {
  const T gdt = T(c.gdt), a = T(c.a), c1 = T(c.c1), c2 = T(c.c2),
          c3dt = T(c.c3dt);
  T f0[3], fx0[3][3], fx[3][3], r[3], F[3], xg[3], xn[3];
  if (TAN)
    vdv_rhs_fx(x, u, f0, fx0);
  else
    vdv_rhs<T, false>(x, u, nullptr, nullptr, f0, nullptr);
#pragma unroll
  for (int i = 0; i < 3; ++i) xg[i] = x[i] + gdt * f0[i];
  for (int it = 0; it < kNewton; ++it) {
    vdv_rhs_fx(xg, u, r, fx);
#pragma unroll
    for (int i = 0; i < 3; ++i) F[i] = xg[i] - x[i] - a * (f0[i] + r[i]);
    solve_i_minus(a, fx, F);
#pragma unroll
    for (int i = 0; i < 3; ++i) xg[i] = xg[i] - F[i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) xn[i] = xg[i];
  for (int it = 0; it < kNewton; ++it) {
    vdv_rhs_fx(xn, u, r, fx);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      F[i] = xn[i] - c1 * xg[i] + c2 * x[i] - c3dt * r[i];
    solve_i_minus(c3dt, fx, F);
#pragma unroll
    for (int i = 0; i < 3; ++i) xn[i] = xn[i] - F[i];
  }
  if (TAN) {
    T g[3], n[3], fu0[3], fug[3], fun[3];
    vdv_fu_du(x, du, fu0);
    vdv_fu_du(xg, du, fug);
    vdv_fu_du(xn, du, fun);
    vdv_rhs_fx(xg, u, r, fx);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      g[i] = dx[i] + a * (fx0[i][0] * dx[0] + fx0[i][1] * dx[1]
                          + fx0[i][2] * dx[2] + fu0[i] + fug[i]);
    solve_i_minus(a, fx, g);
    vdv_rhs_fx(xn, u, r, fx);
#pragma unroll
    for (int i = 0; i < 3; ++i) n[i] = c1 * g[i] - c2 * dx[i] + c3dt * fun[i];
    solve_i_minus(c3dt, fx, n);
#pragma unroll
    for (int i = 0; i < 3; ++i) dx[i] = n[i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) x[i] = xn[i];
}

template <typename T, bool TAN, int STEP>
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
  const T* cm = cmask + (size_t)b * m * nu;
  const T cm_col = TAN ? cm[j] : T(0);
  const double dt = Ts / substeps;
  const T h2 = T(0.5 * dt), h = T(dt), h6 = T(dt / 6.0);
  const TrCoef tr(dt);
  const int pny = p * ny;
  int t_in = -1;  // moves summed into acc so far: t <= t_in
  for (int k = 0; k < p; ++k) {
    const int lim = min(k, last);
    while (t_in < lim) {
      ++t_in;
      acc[0] += dm[t_in * nu] * cm[t_in * nu];
      acc[1] += dm[t_in * nu + 1] * cm[t_in * nu + 1];
    }
    const T u[2] = {up0 + acc[0], up1 + acc[1]};
    T du[2] = {T(0), T(0)};
    if (TAN && tcol <= lim) du[icol] = cm_col;
    for (int s = 0; s < substeps; ++s) {
      if (STEP == S_RK4)
        rk4<T, TAN>(x, dx, u, du, h2, h, h6);
      else
        trbdf2<T, TAN>(x, dx, u, du, tr);
    }
    for (int o = 0; o < ny; ++o) {
      const size_t row = (size_t)b * pny + (size_t)k * ny + o;
      if (j == 0) Y[row] = x[out[o]];
      if (TAN) J[row * ncol + j] = dx[out[o]];
    }
  }
}

enum { R_X, R_UPREV, R_DU, R_CMASK, R_HOLD, R_Y, R_J, R_COUNT };
enum { D_B, D_P, D_M, D_SUBSTEPS, D_JAC, D_NY, D_O0, D_O1, D_O2, D_STEP,
       D_COUNT };

template <typename T, bool TAN, int STEP>
void launch_one(void* const* ptr, const int* d, double Ts, unsigned blocks,
                unsigned threads, cudaStream_t st) {
  auto c = [&](int k) { return static_cast<const T*>(ptr[k]); };
  nmpc_rollout_kernel<T, TAN, STEP><<<blocks, threads, 0, st>>>(
      c(R_X), c(R_UPREV), c(R_DU), c(R_CMASK),
      static_cast<const int*>(ptr[R_HOLD]), static_cast<T*>(ptr[R_Y]),
      static_cast<T*>(ptr[R_J]), d[D_B], d[D_P], d[D_M], d[D_SUBSTEPS],
      d[D_NY], d[D_O0], d[D_O1], d[D_O2], Ts);
}

template <typename T>
int launch_rollout(void* const* ptr, const int* d, double Ts,
                   cudaStream_t st) {
  const bool jac = d[D_JAC] != 0;
  const int step = d[D_STEP];
  if (step != S_RK4 && step != S_TRBDF2) return (int)cudaErrorInvalidValue;
  const long long threads =
      (long long)d[D_B] * (jac ? d[D_M] * 2 : 1);
  if (threads == 0) return 0;
  constexpr int kThreads = 128;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  if (step == S_RK4) {
    if (jac)
      launch_one<T, true, S_RK4>(ptr, d, Ts, blocks, kThreads, st);
    else
      launch_one<T, false, S_RK4>(ptr, d, Ts, blocks, kThreads, st);
  } else {
    if (jac)
      launch_one<T, true, S_TRBDF2>(ptr, d, Ts, blocks, kThreads, st);
    else
      launch_one<T, false, S_TRBDF2>(ptr, d, Ts, blocks, kThreads, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace mpc

extern "C" {

// The reference's entry point, mpc_nmpc_rollout's arguments.
// ptr: x (B, 3), u_prev (B, 2), du (B, m 2), cmask (B, m 2), hold (B,) int32
// or null, Y (B, p ny), J (B, p ny, m 2) or null; dims: B, p, m, substeps,
// jac, ny, out[0..2], the stepper (0 RK4, 1 TR-BDF2; another value returns
// cudaErrorInvalidValue without a launch).
int mpc_nmpc_rollout_thread_per_column(int is_f64, void* const* ptr,
                                       const int* dims, double Ts,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? mpc::launch_rollout<double>(ptr, dims, Ts, st)
                : mpc::launch_rollout<float>(ptr, dims, Ts, st);
}

}  // extern "C"
