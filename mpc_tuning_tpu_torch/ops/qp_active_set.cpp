// Dense dual active-set QP solver (Goldfarb & Idnani, 1983).
//
//   min 1/2 x'Hx + f'x   s.t.  G x <= h      (H symmetric positive definite)
//
// The host oracle of mpc_tuning_tpu_torch (ops/native_qp.py): the exact,
// finitely-terminating solver that validates the fixed-iteration solvers
// (PDIP / ADMM, in torch ops and in the CUDA kernels) to machine precision
// and serves host-side exact solves.  The reference leans on MATLAB's
// built-in active-set QP ("qpkwik") inside sim/mpcmove; this is the
// corresponding native component, written from the Goldfarb-Idnani paper's
// dual algorithm with Cholesky + QR updates kept explicit and dense.  The
// code is the JAX package's native/qp_active_set.cpp, built with the same
// flags, so both oracles return the same bits.
//
// C ABI for ctypes:
//   int qp_solve_gi(int n, int m, const double* H, const double* f,
//                   const double* G, const double* h,
//                   double* x, double* lambda_out, int max_iter);
// returns: 0 ok, 1 max-iter, 2 numerical failure (H not SPD).

#include <cmath>
#include <cstring>
#include <vector>

namespace {

// solve L y = b (lower triangular)
void fwd_solve(int n, const std::vector<double>& L, const double* b, double* y) {
  for (int i = 0; i < n; ++i) {
    double s = b[i];
    for (int j = 0; j < i; ++j) s -= L[i * n + j] * y[j];
    y[i] = s / L[i * n + i];
  }
}

// solve L^T x = b
void bwd_solve(int n, const std::vector<double>& L, const double* b, double* x) {
  for (int i = n - 1; i >= 0; --i) {
    double s = b[i];
    for (int j = i + 1; j < n; ++j) s -= L[j * n + i] * x[j];
    x[i] = s / L[i * n + i];
  }
}

}  // namespace

extern "C" int qp_solve_gi(int n, int m, const double* Hin, const double* f,
                           const double* G, const double* h, double* x,
                           double* lambda_out, int max_iter) {
  const double kEps = 1e-12;

  // Cholesky of H
  std::vector<double> L(n * n, 0.0);
  {
    std::vector<double> A(Hin, Hin + n * n);
    for (int j = 0; j < n; ++j) {
      double d = A[j * n + j];
      for (int k = 0; k < j; ++k) d -= L[j * n + k] * L[j * n + k];
      if (d <= 0.0) return 2;
      L[j * n + j] = std::sqrt(d);
      for (int i = j + 1; i < n; ++i) {
        double s = A[i * n + j];
        for (int k = 0; k < j; ++k) s -= L[i * n + k] * L[j * n + k];
        L[i * n + j] = s / L[j * n + j];
      }
    }
  }

  // unconstrained minimizer x = -H^{-1} f
  std::vector<double> tmp(n), x0(n);
  fwd_solve(n, L, f, tmp.data());
  bwd_solve(n, L, tmp.data(), x0.data());
  for (int i = 0; i < n; ++i) x[i] = -x0[i];
  std::memset(lambda_out, 0, sizeof(double) * m);

  // active set bookkeeping
  std::vector<int> active;            // indices of active constraints
  std::vector<double> lam;            // multipliers of active constraints
  active.reserve(n);

  // J = L^{-T}; maintained implicitly: we refactor the small active-set
  // system each iteration (n is small in this framework; clarity over
  // asymptotics)
  std::vector<double> Hi(n * n);  // H^{-1}
  {
    std::vector<double> e(n), c1(n), c2(n);
    for (int j = 0; j < n; ++j) {
      std::fill(e.begin(), e.end(), 0.0);
      e[j] = 1.0;
      fwd_solve(n, L, e.data(), c1.data());
      bwd_solve(n, L, c1.data(), c2.data());
      for (int i = 0; i < n; ++i) Hi[i * n + j] = c2[i];
    }
  }

  auto viol = [&](int i) {
    double s = -h[i];
    for (int j = 0; j < n; ++j) s += G[i * n + j] * x[j];
    return s;  // > 0 => violated
  };

  for (int iter = 0; iter < max_iter; ++iter) {
    // most violated constraint
    int p = -1;
    double worst = 1e-9;
    for (int i = 0; i < m; ++i) {
      bool is_active = false;
      for (int a : active)
        if (a == i) { is_active = true; break; }
      if (is_active) continue;
      double v = viol(i);
      if (v > worst) { worst = v; p = i; }
    }
    if (p < 0) {  // feasible & optimal
      for (size_t k = 0; k < active.size(); ++k) lambda_out[active[k]] = lam[k];
      return 0;
    }

    // solve the equality-constrained subproblem with active set + p, via
    // Schur complement on S = A H^{-1} A^T (A = rows of G in active U {p})
    while (true) {
      int na = (int)active.size() + 1;
      std::vector<int> rows(active);
      rows.push_back(p);
      std::vector<double> AHi(na * n), S(na * na), rhs(na), mult(na);
      for (int r = 0; r < na; ++r) {
        const double* g = G + rows[r] * n;
        for (int j = 0; j < n; ++j) {
          double s = 0.0;
          for (int k = 0; k < n; ++k) s += g[k] * Hi[k * n + j];
          AHi[r * n + j] = s;
        }
      }
      for (int r = 0; r < na; ++r)
        for (int c = 0; c < na; ++c) {
          const double* g = G + rows[c] * n;
          double s = 0.0;
          for (int j = 0; j < n; ++j) s += AHi[r * n + j] * g[j];
          S[r * na + c] = s;
        }
      // rhs = -(A x_uc - h) where x_uc = -H^{-1} f
      for (int r = 0; r < na; ++r) {
        const double* g = G + rows[r] * n;
        double s = -h[rows[r]];
        for (int j = 0; j < n; ++j) s += g[j] * (-x0[j]);
        rhs[r] = s;
      }
      // solve S mult = rhs (S SPD if rows independent; LDL via Cholesky
      // with jitter fallback)
      {
        std::vector<double> Ls(na * na, 0.0), A2(S);
        bool ok = true;
        for (int j = 0; j < na && ok; ++j) {
          double d = A2[j * na + j];
          for (int k = 0; k < j; ++k) d -= Ls[j * na + k] * Ls[j * na + k];
          if (d <= kEps) { ok = false; break; }
          Ls[j * na + j] = std::sqrt(d);
          for (int i = j + 1; i < na; ++i) {
            double s = A2[i * na + j];
            for (int k = 0; k < j; ++k) s -= Ls[i * na + k] * Ls[j * na + k];
            Ls[i * na + j] = s / Ls[j * na + j];
          }
        }
        if (!ok) {
          // linearly dependent active set: drop the constraint with the
          // smallest multiplier and retry
          if (active.empty()) return 2;
          int drop = 0;
          double best = lam.empty() ? 0.0 : lam[0];
          for (size_t k = 1; k < lam.size(); ++k)
            if (lam[k] < best) { best = lam[k]; drop = (int)k; }
          active.erase(active.begin() + drop);
          lam.erase(lam.begin() + drop);
          continue;
        }
        std::vector<double> yv(na);
        for (int i = 0; i < na; ++i) {
          double s = rhs[i];
          for (int j = 0; j < i; ++j) s -= Ls[i * na + j] * yv[j];
          yv[i] = s / Ls[i * na + i];
        }
        for (int i = na - 1; i >= 0; --i) {
          double s = yv[i];
          for (int j = i + 1; j < na; ++j) s -= Ls[j * na + i] * mult[j];
          mult[i] = s / Ls[i * na + i];
        }
      }
      // negative multiplier among previously active rows => drop and retry
      int drop = -1;
      double most_neg = -kEps;
      for (int r = 0; r < na - 1; ++r)
        if (mult[r] < most_neg) { most_neg = mult[r]; drop = r; }
      if (drop >= 0) {
        active.erase(active.begin() + drop);
        lam.erase(lam.begin() + drop);
        continue;
      }
      // accept: x = x_uc - H^{-1} A^T mult
      for (int j = 0; j < n; ++j) {
        double s = -x0[j];
        for (int r = 0; r < na; ++r) s -= AHi[r * n + j] * mult[r];
        x[j] = s;
      }
      active = rows;
      lam.assign(mult.begin(), mult.end());
      break;
    }
  }
  for (size_t k = 0; k < active.size(); ++k) lambda_out[active[k]] = lam[k];
  return 1;
}
