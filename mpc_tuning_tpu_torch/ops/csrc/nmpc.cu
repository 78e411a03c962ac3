// The NMPC prediction rollout and its sensitivities (ops/kernels.py
// nmpc_rollout).  Not the counterpart of a Pallas kernel: on the TPU, XLA
// fuses the JAX package's rollout (mpc_tuning_tpu/sim/nmpc_loop.py:191
// _rollout_y, and the explicit NMPC's y_of, mpc_tuning_tpu/sim/
// explicit_nmpc.py:97-117) and its jax.jacfwd into the compiled NMPC step,
// for either integrator; eager PyTorch would spend ~1e5 launches on one
// rollout.
//
// For candidate b the input at prediction step k is
//   u(k) = u_prev + sum_{t <= min(k, m - 1, hold[b])} cmask[t nu + i] du[t nu + i]
// per input i (the move mask per column; held after the control horizon),
// the state advances one sample interval of `substeps` steps of the Van de
// Vusse CSTR (models/ode.py vandevusse_rhs, the same constants), and
// Y[b, k, o] is state out[o] after step k.  Two steppers, a template
// parameter:
//  - RK4 (models/ode.py rk4_step);
//  - TR-BDF2 (models/ode.py tr_bdf2_step): a trapezoidal stage to
//    t + g dt from x + g dt f(x), then a BDF2 stage from it, each by
//    kNewton full-Newton iterations whose 3 x 3 Jacobian I - a fx is
//    formed from the written-out partials (vandevusse_partials).
// With jac, J[b, k ny + o, j] = dY[b, k, o] / d du[j]: RK4 carries the
// tangent of du[j] through every stage with the rhs partials written out
// (the exact derivative of the discrete map); TR-BDF2 differentiates each
// converged stage (integrate_tangent: the partials at x, xg and xn, then
// two 3 x 3 solves on the column), not the Newton iterations.
//
// What bounds it: each candidate's primal is a serial chain of dependent
// f64 operations, p * substeps * 4 rhs evaluations (a division and exps
// each) with RK4, p * substeps * (1 + 2 kNewton) rhs-and-partials
// evaluations and 2 kNewton 3 x 3 solves at most with TR-BDF2; the bytes
// and the operations are a hundredth of the launch or less (PERF.md).  So
// the design shortens that chain and keeps everything else off it:
//  - one block per candidate: warp 0, the producer, runs the primal (all
//    its lanes alike, lane 0 stores); warps 1.., the consumers, carry one
//    tangent column a lane.  The producer writes what the tangent needs
//    for every substep into a ring of kRing slots in shared memory (RK4:
//    the four stage states and their rates; TR-BDF2: x, xg, xn and fx at
//    each), handed over by named barriers (bar.arrive / bar.sync, a FULL
//    and an EMPTY barrier a slot).  The consumers apply it a substep or
//    more behind: no rhs, no exp, and TR-BDF2's two substitutions on their
//    own chain, beside the producer's next substep.
//  - TR-BDF2's tangent takes fx at the converged xg from the first BDF2
//    Newton iteration (which starts at xg) and fx at xn from the next
//    substep's first evaluation (recomputed with the old input where a
//    sample interval ends): no evaluation beyond the primal's own, where
//    the thread-per-column design made two more a substep.
//  - k20 = k10 and E2 = E1, so k2 is k1 bit for bit: two exps, not three.
//  - the producer's Newton step solves by the adjugate (adj_solve): one
//    reciprocal on the chain where the thread-per-column design divided at
//    each use, and each stage's Newton loop stops at its fixed point
//    (newton_update): ~3 of the 6 iterations a stage.
//  - the consumers' arithmetic is that design's (vdv_rhs's tangent, the
//    pivoted divisions of solve_i_minus).  TR-BDF2's outputs have been
//    that design's bits on every input measured, but that is not promised:
//    the two Newton solves round otherwise, so a stage may stop a few ulps
//    apart.  RK4's J rounds otherwise in the last digits (the compiler
//    fuses its tangent stages' products otherwise).
//    ops/csrc/reference/nmpc_rollout_thread_per_column.cu keeps it.
// Without jac the kernel runs the producer's code alone, a warp a
// candidate (the plant step, the open leg's playback): each candidate's
// Newton loops stop at their own fixed points, where candidates sharing a
// warp would wait for the slowest lane.

#include "common.cuh"

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
  if constexpr (kK20 == kK10 && kE2 == kE1)
    k2 = k1;  // the same operations on the same operands
  else
    k2 = T(kK20) * exp(T(kE2) / tk);
  k3 = T(kK30) * exp(T(kE3) / tk);
}

// dx/dt at the rates k1, k2, k3, in the operation order of vandevusse_rhs.
template <typename T>
__device__ __forceinline__ void vdv_f(const T* x, T fov, T Tk, T k1, T k2,
                                      T k3, T* f) {
  const T ca = x[0], cb = x[1], Tt = x[2];
  const T c1 = T(1.0 / (kRho * kCp));
  const T c2 = T(kKw * kAr / (kRho * kCp * kV));
  f[0] = fov * (T(kCa0) - ca) - k1 * ca - k3 * ca * ca;
  f[1] = -fov * cb + k1 * ca - k2 * cb;
  f[2] = c1 * (k1 * ca * T(kDAB) + k2 * cb * T(kDBC) + k3 * (ca * ca) * T(kDAD))
         + fov * (T(kT0) - Tt) + c2 * (Tk - Tt);
}

// dx/dt and its rates (vandevusse_rhs).
template <typename T>
__device__ __forceinline__ void vdv_rhs(const T* x, const T* u, T* f, T& k1,
                                        T& k2, T& k3) {
  vdv_rates(x[2] + T(273.15), k1, k2, k3);
  vdv_f(x, u[0], u[1], k1, k2, k3, f);
}

// The directional derivative of the rhs along (dx, du) at the state x with
// feed fov and rates k1, k2, k3 (the thread-per-column design's inline
// tangent, in its operation order).
template <typename T>
__device__ __forceinline__ void vdv_drhs(const T* x, T fov, T k1, T k2, T k3,
                                         const T* dx, const T* du, T* df) {
  const T ca = x[0], cb = x[1], Tt = x[2];
  const T tk = Tt + T(273.15);
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

// fx = d rhs / dx (vandevusse_partials' formulas) at the state x with feed
// fov and rates k1, k2, k3.
template <typename T>
__device__ __forceinline__ void vdv_fx(const T* x, T fov, T k1, T k2, T k3,
                                       T (&fx)[3][3]) {
  const T ca = x[0], cb = x[1];
  const T tk = x[2] + T(273.15);
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

// dx/dt and fx around one set of Arrhenius terms.
template <typename T>
__device__ __forceinline__ void vdv_rhs_fx(const T* x, const T* u, T* f,
                                           T (&fx)[3][3]) {
  T k1, k2, k3;
  vdv_rhs(x, u, f, k1, k2, k3);
  vdv_fx(x, u[0], k1, k2, k3, fx);
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

// A <- I - a F.
template <typename T>
__device__ __forceinline__ void i_minus(T a, const T (&F)[3][3],
                                        T (&A)[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) A[i][j] = (i == j ? T(1) : T(0)) - a * F[i][j];
}

// b <- (I - a F)^-1 b for a 3 x 3 F, by LU with partial pivoting (the
// largest |pivot| of each column, first on a tie, as LAPACK's getrf picks
// it) and a division at each use, in registers: the thread-per-column
// design's solve, the tangent's.
template <typename T>
__device__ __forceinline__ void solve_i_minus(T a, const T (&F)[3][3],
                                              T (&b)[3]) {
  T A[3][3];
  i_minus(a, F, A);
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

// b <- (I - a F)^-1 b by the adjugate: the cofactors and the determinant
// in a few dependent products, then one reciprocal (the producer's Newton
// step; the iterate converges to the stage's root whichever solve steps
// it, the rounding of the last step only).
template <typename T>
__device__ __forceinline__ void adj_solve(T a, const T (&F)[3][3],
                                          T (&b)[3]) {
  T A[3][3];
  i_minus(a, F, A);
  const T c00 = A[1][1] * A[2][2] - A[1][2] * A[2][1];
  const T c01 = A[1][2] * A[2][0] - A[1][0] * A[2][2];
  const T c02 = A[1][0] * A[2][1] - A[1][1] * A[2][0];
  const T c10 = A[0][2] * A[2][1] - A[0][1] * A[2][2];
  const T c11 = A[0][0] * A[2][2] - A[0][2] * A[2][0];
  const T c12 = A[0][1] * A[2][0] - A[0][0] * A[2][1];
  const T c20 = A[0][1] * A[1][2] - A[0][2] * A[1][1];
  const T c21 = A[0][2] * A[1][0] - A[0][0] * A[1][2];
  const T c22 = A[0][0] * A[1][1] - A[0][1] * A[1][0];
  const T rd = T(1) / (A[0][0] * c00 + A[0][1] * c01 + A[0][2] * c02);
  const T x0 = (c00 * b[0] + c10 * b[1] + c20 * b[2]) * rd;
  const T x1 = (c01 * b[0] + c11 * b[1] + c21 * b[2]) * rd;
  const T x2 = (c02 * b[0] + c12 * b[1] + c22 * b[2]) * rd;
  b[0] = x0;
  b[1] = x1;
  b[2] = x2;
}

__device__ __forceinline__ bool same_bits(double a, double b) {
  return __double_as_longlong(a) == __double_as_longlong(b);
}
__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_int(a) == __float_as_int(b);
}

// x <- x - F; true when no bit of x moved: a fixed point of the Newton
// iteration, a fixed map of the iterate, so every later iteration would
// repeat this one and stopping gives the full kNewton iterations' bits.
template <typename T>
__device__ __forceinline__ bool newton_update(T (&x)[3], const T (&F)[3]) {
  bool same = true;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T v = x[i] - F[i];
    same = same && same_bits(v, x[i]);
    x[i] = v;
  }
  return same;
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

// ------------------------------------------------------------- the ring
//
// One slot a substep.  RK4: the feed, then for each of the four stages its
// state and rates (x, k1, k2, k3).  TR-BDF2: x, xg, xn, then fx at each.
constexpr int kRing = 4;  // slots; named barriers 1..2 kRing
constexpr int kRk4Stage = 6, kRk4Slot = 1 + 4 * kRk4Stage;
constexpr int kTrX = 0, kTrXg = 3, kTrXn = 6, kTrFx0 = 9, kTrFxg = 18,
              kTrFxn = 27, kTrSlot = 36;

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ int full_bar(int s) { return 1 + s; }
__device__ __forceinline__ int empty_bar(int s) { return 1 + kRing + s; }

// The producer's side of the ring: Ring<T, false> (no jac) stores nothing.
template <typename T, bool PUSH>
struct Ring {
  T* base;     // kRing slots of `size` values
  int size;    // values a slot
  int nthr;    // the block's threads, the barriers' count
  bool store;  // this lane stores (lane 0)

  __device__ __forceinline__ T* slot(int q) const {
    return base + (q % kRing) * size;
  }
  // wait until the consumers have read slot q's previous round
  __device__ __forceinline__ void acquire(int q) const {
    if (PUSH && q >= kRing) {
      __syncwarp();
      bar_sync(empty_bar(q % kRing), nthr);
    }
  }
  __device__ __forceinline__ void put(int q, int i, T v) const {
    if (PUSH && store) slot(q)[i] = v;
  }
  __device__ __forceinline__ void put3(int q, int i, const T* v) const {
#pragma unroll
    for (int k = 0; k < 3; ++k) put(q, i + k, v[k]);
  }
  __device__ __forceinline__ void put9(int q, int i,
                                       const T (&v)[3][3]) const {
#pragma unroll
    for (int r = 0; r < 3; ++r) put3(q, i + 3 * r, v[r]);
  }
  __device__ __forceinline__ void release(int q) const {
    if (PUSH) {
      __syncwarp();
      bar_arrive(full_bar(q % kRing), nthr);
    }
  }
};

// One RK4 step of length dt (rk4_step's operation order); publishes the
// stage states and rates as slot q.
template <typename T, bool PUSH>
__device__ __forceinline__ void rk4_primal(T* x, const T* u, T h2, T h, T h6,
                                           const Ring<T, PUSH>& ring, int q) {
  T k[4][3], xs[3];
  ring.acquire(q);
  ring.put(q, 0, u[0]);
#pragma unroll
  for (int i = 0; i < 3; ++i) xs[i] = x[i];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (s > 0) {
      const T c = s < 3 ? h2 : h;
#pragma unroll
      for (int i = 0; i < 3; ++i) xs[i] = x[i] + c * k[s - 1][i];
    }
    T k1, k2, k3;
    vdv_rhs(xs, u, k[s], k1, k2, k3);
    const int o = 1 + s * kRk4Stage;
    ring.put3(q, o, xs);
    ring.put(q, o + 3, k1);
    ring.put(q, o + 4, k2);
    ring.put(q, o + 5, k3);
  }
  ring.release(q);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    x[i] = x[i] + h6 * (k[0][i] + T(2) * k[1][i] + T(2) * k[2][i] + k[3][i]);
}

// The tangent of one RK4 step from slot r: dx carried through the four
// stages (the thread-per-column design's arithmetic).
template <typename T>
__device__ __forceinline__ void rk4_tangent(const T* r, T* dx, const T* du,
                                            T h2, T h, T h6) {
  const T fov = r[0];
  T d[4][3], dxs[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) dxs[i] = dx[i];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (s > 0) {
      const T c = s < 3 ? h2 : h;
#pragma unroll
      for (int i = 0; i < 3; ++i) dxs[i] = dx[i] + c * d[s - 1][i];
    }
    const T* st = r + 1 + s * kRk4Stage;
    vdv_drhs(st, fov, st[3], st[4], st[5], dxs, du, d[s]);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    dx[i] = dx[i] + h6 * (d[0][i] + T(2) * d[1][i] + T(2) * d[2][i]
                          + d[3][i]);
}

// One TR-BDF2 step of length dt (tr_bdf2_step's residuals and initial
// guesses, each implicit stage by kNewton Newton iterations, stopped at a
// fixed point of the iterate: newton_update).  With PUSH it
// fills slot q with x, xg, fx(x) and fx(xg) (the first BDF2 iteration's,
// which starts at xg); the caller completes it with xn and fx(xn).
template <typename T, bool PUSH>
__device__ __forceinline__ void trbdf2_primal(T* x, const T* f0, const T* u,
                                              const TrCoef& c,
                                              const Ring<T, PUSH>& ring,
                                              int q) {
  const T gdt = T(c.gdt), a = T(c.a), c1 = T(c.c1), c2 = T(c.c2),
          c3dt = T(c.c3dt);
  T fx[3][3], r[3], F[3], xg[3], xn[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) xg[i] = x[i] + gdt * f0[i];
  for (int it = 0; it < kNewton; ++it) {
    vdv_rhs_fx(xg, u, r, fx);
#pragma unroll
    for (int i = 0; i < 3; ++i) F[i] = xg[i] - x[i] - a * (f0[i] + r[i]);
    adj_solve(a, fx, F);
    if (newton_update(xg, F)) break;
  }
  ring.put3(q, kTrXg, xg);
#pragma unroll
  for (int i = 0; i < 3; ++i) xn[i] = xg[i];
  for (int it = 0; it < kNewton; ++it) {
    vdv_rhs_fx(xn, u, r, fx);
    if (it == 0) ring.put9(q, kTrFxg, fx);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      F[i] = xn[i] - c1 * xg[i] + c2 * x[i] - c3dt * r[i];
    adj_solve(c3dt, fx, F);
    if (newton_update(xn, F)) break;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) x[i] = xn[i];
}

// The tangent of one TR-BDF2 step from slot r (integrate_tangent's
// TR-BDF2 branch, the thread-per-column design's arithmetic):
//   dxg = (I - a fx(xg))^-1 (dx + a (fx(x) dx + fu(x) du + fu(xg) du))
//   dxn = (I - c3 dt fx(xn))^-1 (c1 dxg - c2 dx + c3 dt fu(xn) du).
template <typename T>
__device__ __forceinline__ void trbdf2_tangent(const T* r, T* dx,
                                               const T* du, const TrCoef& c) {
  const T a = T(c.a), c1 = T(c.c1), c2 = T(c.c2), c3dt = T(c.c3dt);
  T fx0[3][3], fx[3][3], g[3], n[3], fu0[3], fug[3], fun[3];
  vdv_fu_du(r + kTrX, du, fu0);
  vdv_fu_du(r + kTrXg, du, fug);
  vdv_fu_du(r + kTrXn, du, fun);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      fx0[i][j] = r[kTrFx0 + 3 * i + j];
      fx[i][j] = r[kTrFxg + 3 * i + j];
    }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    g[i] = dx[i] + a * (fx0[i][0] * dx[0] + fx0[i][1] * dx[1]
                        + fx0[i][2] * dx[2] + fu0[i] + fug[i]);
  solve_i_minus(a, fx, g);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) fx[i][j] = r[kTrFxn + 3 * i + j];
#pragma unroll
  for (int i = 0; i < 3; ++i) n[i] = c1 * g[i] - c2 * dx[i] + c3dt * fun[i];
  solve_i_minus(c3dt, fx, n);
#pragma unroll
  for (int i = 0; i < 3; ++i) dx[i] = n[i];
}

struct Dims {
  int B, p, m, substeps, ny, out[3];
  double Ts;
};

// The primal of candidate b: Y, and with PUSH every substep's slot of the
// ring.
template <typename T, int STEP, bool PUSH>
__device__ void primal(const T* __restrict__ x0, const T* __restrict__ u_prev,
                       const T* __restrict__ dmove,
                       const T* __restrict__ cmask,
                       const int* __restrict__ hold, T* __restrict__ Y,
                       const Dims& d, int b, bool write,
                       const Ring<T, PUSH>& ring) {
  constexpr int nu = 2;
  const int m = d.m, ny = d.ny, pny = d.p * d.ny;
  T x[3], acc[2] = {T(0), T(0)};
  for (int i = 0; i < 3; ++i) x[i] = x0[(size_t)b * 3 + i];
  const T up0 = u_prev[(size_t)b * nu], up1 = u_prev[(size_t)b * nu + 1];
  const int last = hold ? min(m - 1, hold[b]) : m - 1;
  const T* dm = dmove + (size_t)b * m * nu;
  const T* cm = cmask + (size_t)b * m * nu;
  const double dt = d.Ts / d.substeps;
  const T h2 = T(0.5 * dt), h = T(dt), h6 = T(dt / 6.0);
  const TrCoef tr(dt);
  T u_old[2] = {up0, up1};  // the previous substep's input (TR-BDF2)
  int t_in = -1;  // moves summed into acc so far: t <= t_in
  int q = 0;      // substeps so far
  for (int k = 0; k < d.p; ++k) {
    const int lim = min(k, last);
    while (t_in < lim) {
      ++t_in;
      acc[0] += dm[t_in * nu] * cm[t_in * nu];
      acc[1] += dm[t_in * nu + 1] * cm[t_in * nu + 1];
    }
    const T u[2] = {up0 + acc[0], up1 + acc[1]};
    for (int s = 0; s < d.substeps; ++s, ++q) {
      if (STEP == S_RK4) {
        rk4_primal<T, PUSH>(x, u, h2, h, h6, ring, q);
        continue;
      }
      T f0[3];
      if (PUSH) {
        // fx at x is this substep's fx(x) and, at the previous input, the
        // previous substep's fx(xn): complete and release its slot
        T fx0[3][3], fxn[3][3], fn[3];
        vdv_rhs_fx(x, u, f0, fx0);
        if (q > 0) {
          if (s == 0)
            vdv_rhs_fx(x, u_old, fn, fxn);
          else
#pragma unroll
            for (int i = 0; i < 3; ++i)
#pragma unroll
              for (int j = 0; j < 3; ++j) fxn[i][j] = fx0[i][j];
          ring.put3(q - 1, kTrXn, x);
          ring.put9(q - 1, kTrFxn, fxn);
          ring.release(q - 1);
        }
        ring.acquire(q);
        ring.put3(q, kTrX, x);
        ring.put9(q, kTrFx0, fx0);
      } else {
        T k1, k2, k3;
        vdv_rhs(x, u, f0, k1, k2, k3);
      }
      trbdf2_primal<T, PUSH>(x, f0, u, tr, ring, q);
      u_old[0] = u[0];
      u_old[1] = u[1];
    }
    if (write)
      for (int o = 0; o < ny; ++o)
        Y[(size_t)b * pny + (size_t)k * ny + o] = x[d.out[o]];
  }
  if (PUSH && STEP == S_TRBDF2 && q > 0) {  // the last substep's fx(xn)
    T fn[3], fxn[3][3];
    vdv_rhs_fx(x, u_old, fn, fxn);
    ring.put3(q - 1, kTrXn, x);
    ring.put9(q - 1, kTrFxn, fxn);
    ring.release(q - 1);
  }
}

// Without jac: one warp a candidate, the primal alone.
template <typename T, int STEP>
__global__ void nmpc_primal_kernel(const T* __restrict__ x0,
                                   const T* __restrict__ u_prev,
                                   const T* __restrict__ dmove,
                                   const T* __restrict__ cmask,
                                   const int* __restrict__ hold,
                                   T* __restrict__ Y, Dims d) {
  const Ring<T, false> none{nullptr, 0, 0, false};
  primal<T, STEP, false>(x0, u_prev, dmove, cmask, hold, Y, d, blockIdx.x,
                         threadIdx.x == 0, none);
}

// With jac: one block a candidate, warp 0 the producer, the other warps one
// tangent column a lane.
template <typename T, int STEP>
__global__ void nmpc_rollout_kernel(const T* __restrict__ x0,
                                    const T* __restrict__ u_prev,
                                    const T* __restrict__ dmove,
                                    const T* __restrict__ cmask,
                                    T* __restrict__ Y, T* __restrict__ J,
                                    Dims d) {
  constexpr int nu = 2;
  constexpr int size = STEP == S_RK4 ? kRk4Slot : kTrSlot;
  __shared__ T ring_mem[kRing * size];
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int total = d.p * d.substeps;
  const Ring<T, true> ring{ring_mem, size, (int)blockDim.x, lane == 0};
  if (warp == 0) {
    primal<T, STEP, true>(x0, u_prev, dmove, cmask, nullptr, Y, d, b,
                          lane == 0, ring);
    return;
  }
  const int m = d.m, ny = d.ny, pny = d.p * d.ny, ncol = m * nu;
  const int j = (warp - 1) * 32 + lane;
  const bool active = j < ncol;
  const int tcol = j / nu, icol = j % nu;
  const T cm_col = active ? cmask[(size_t)b * ncol + j] : T(0);
  const double dt = d.Ts / d.substeps;
  const T h2 = T(0.5 * dt), h = T(dt), h6 = T(dt / 6.0);
  const TrCoef tr(dt);
  T dx[3] = {T(0), T(0), T(0)};
  T r[size];
  int q = 0;
  for (int k = 0; k < d.p; ++k) {
    T du[2] = {T(0), T(0)};
    if (tcol <= min(k, m - 1)) du[icol] = cm_col;
    for (int s = 0; s < d.substeps; ++s, ++q) {
      const int sl = q % kRing;
      __syncwarp();
      bar_sync(full_bar(sl), ring.nthr);
      const T* src = ring_mem + sl * size;
#pragma unroll
      for (int i = 0; i < size; ++i) r[i] = src[i];
      // the producer waits for this round's release before it reuses the
      // slot, which it does for all but the last kRing substeps
      if (q + kRing < total) bar_arrive(empty_bar(sl), ring.nthr);
      if (active) {
        if (STEP == S_RK4)
          rk4_tangent(r, dx, du, h2, h, h6);
        else
          trbdf2_tangent(r, dx, du, tr);
      }
    }
    if (active)
      for (int o = 0; o < ny; ++o) {
        const size_t row = (size_t)b * pny + (size_t)k * ny + o;
        J[row * ncol + j] = dx[d.out[o]];
      }
  }
}

enum { R_X, R_UPREV, R_DU, R_CMASK, R_HOLD, R_Y, R_J, R_COUNT };
enum { D_B, D_P, D_M, D_SUBSTEPS, D_JAC, D_NY, D_O0, D_O1, D_O2, D_STEP,
       D_COUNT };
constexpr int kMaxColumnWarps = 31;  // 1024 threads a block

template <typename T, int STEP>
int launch_step(void* const* ptr, const Dims& d, bool jac, cudaStream_t st) {
  auto c = [&](int k) { return static_cast<const T*>(ptr[k]); };
  if (!jac) {
    nmpc_primal_kernel<T, STEP><<<d.B, 32, 0, st>>>(
        c(R_X), c(R_UPREV), c(R_DU), c(R_CMASK),
        static_cast<const int*>(ptr[R_HOLD]), static_cast<T*>(ptr[R_Y]), d);
    return (int)cudaGetLastError();
  }
  const int warps = (d.m * 2 + 31) / 32;
  if (warps < 1 || warps > kMaxColumnWarps) return (int)cudaErrorInvalidValue;
  nmpc_rollout_kernel<T, STEP><<<d.B, 32 * (1 + warps), 0, st>>>(
      c(R_X), c(R_UPREV), c(R_DU), c(R_CMASK), static_cast<T*>(ptr[R_Y]),
      static_cast<T*>(ptr[R_J]), d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rollout(void* const* ptr, const int* dims, double Ts,
                   cudaStream_t st) {
  const bool jac = dims[D_JAC] != 0;
  const int step = dims[D_STEP];
  if (step != S_RK4 && step != S_TRBDF2) return (int)cudaErrorInvalidValue;
  if (jac && ptr[R_HOLD] != nullptr) return (int)cudaErrorInvalidValue;
  const Dims d{dims[D_B], dims[D_P], dims[D_M], dims[D_SUBSTEPS], dims[D_NY],
               {dims[D_O0], dims[D_O1], dims[D_O2]}, Ts};
  if (d.B == 0) return 0;
  return step == S_RK4 ? launch_step<T, S_RK4>(ptr, d, jac, st)
                       : launch_step<T, S_TRBDF2>(ptr, d, jac, st);
}

}  // namespace mpc

extern "C" {

// ptr: x (B, 3), u_prev (B, 2), du (B, m 2), cmask (B, m 2) (per column),
// hold (B,) int32 or null, Y (B, p ny), J (B, p ny, m 2) or null; dims: B,
// p, m, substeps, jac, ny, out[0..2], the stepper (0 RK4, 1 TR-BDF2).
// Returns cudaErrorInvalidValue without a launch for another stepper, for
// jac with a hold, or for jac with m 2 outside 1..992 columns.
int mpc_nmpc_rollout(int is_f64, void* const* ptr, const int* dims,
                     double Ts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? mpc::launch_rollout<double>(ptr, dims, Ts, st)
                : mpc::launch_rollout<float>(ptr, dims, Ts, st);
}

}  // extern "C"
