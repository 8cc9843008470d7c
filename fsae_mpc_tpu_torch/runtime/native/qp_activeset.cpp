// Dense active-set QP solver (Goldfarb-Idnani dual method).
//
// Native-runtime counterpart of the reference's qpOASES C++ MEX backend
// (reference: optimizers/matlab/qpOASES/qpOASES.m:20-37 -- online active-set
// strategy for  min 1/2 x'Hx + g'x  s.t.  lb<=x<=ub, lbA<=Ax<=ubA).
// This implementation is written from the published Goldfarb-Idnani dual
// algorithm: start at the unconstrained minimum (dual feasible), repeatedly
// add the most violated constraint, taking dual steps that may drop active
// constraints.  Factorisations are recomputed per step (O(n^3)); the solver
// is the framework's trusted f64 CPU oracle for golden-testing the on-device
// interior-point method, not a hot-path component.
//
// C ABI only (consumed through ctypes; pybind11 is unavailable in the image).

#include <cmath>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

// Solve S y = b for symmetric positive definite S via Cholesky. Returns
// false if the factorisation breaks down.
bool chol_solve(std::vector<double> S, int n, std::vector<double>& y) {
  // in-place lower Cholesky
  for (int j = 0; j < n; ++j) {
    double d = S[j * n + j];
    for (int k = 0; k < j; ++k) d -= S[j * n + k] * S[j * n + k];
    if (d <= 0.0) return false;
    d = std::sqrt(d);
    S[j * n + j] = d;
    for (int i = j + 1; i < n; ++i) {
      double v = S[i * n + j];
      for (int k = 0; k < j; ++k) v -= S[i * n + k] * S[j * n + k];
      S[i * n + j] = v / d;
    }
  }
  // forward substitution L z = b
  for (int i = 0; i < n; ++i) {
    double v = y[i];
    for (int k = 0; k < i; ++k) v -= S[i * n + k] * y[k];
    y[i] = v / S[i * n + i];
  }
  // backward substitution L' y = z
  for (int i = n - 1; i >= 0; --i) {
    double v = y[i];
    for (int k = i + 1; k < n; ++k) v -= S[k * n + i] * y[k];
    y[i] = v / S[i * n + i];
  }
  return true;
}

struct Constraint {
  // normal vector is implicit: bound i -> e_i ; row j -> A[j,:]
  int kind;   // 0 = variable bound, 1 = general row
  int index;  // variable or row index
  int sign;   // +1: lower (a'x >= b), -1: upper (-a'x >= -b)
  double bound;
};

}  // namespace

extern "C" {

// Returns 0 on success, 1 on iteration limit, 2 on numerical failure,
// 3 on infeasible.
int qp_solve_activeset(int n, int m, const double* H, const double* g,
                       const double* A, const double* lb, const double* ub,
                       const double* lbA, const double* ubA, int max_iter,
                       double* x_out, double* obj_out, int* n_active_out) {
  std::vector<double> Hreg(H, H + n * n);
  // tiny regularisation keeps H invertible when slack variables carry no
  // curvature (the reference's soft-constraint columns)
  double hmax = 1.0;
  for (int i = 0; i < n * n; ++i) hmax = std::max(hmax, std::fabs(H[i]));
  for (int i = 0; i < n; ++i) Hreg[i * n + i] += 1e-11 * hmax;

  // Hinv via n solves
  std::vector<double> Hinv(n * n);
  {
    std::vector<double> col(n);
    for (int j = 0; j < n; ++j) {
      std::fill(col.begin(), col.end(), 0.0);
      col[j] = 1.0;
      if (!chol_solve(Hreg, n, col)) return 2;
      for (int i = 0; i < n; ++i) Hinv[i * n + j] = col[i];
    }
  }

  // unconstrained minimum x = -Hinv g
  std::vector<double> x(n, 0.0);
  for (int i = 0; i < n; ++i) {
    double v = 0.0;
    for (int j = 0; j < n; ++j) v -= Hinv[i * n + j] * g[j];
    x[i] = v;
  }

  auto normal_dot = [&](const Constraint& c, const double* v) {
    if (c.kind == 0) return static_cast<double>(c.sign) * v[c.index];
    double s = 0.0;
    for (int j = 0; j < n; ++j) s += A[c.index * n + j] * v[j];
    return static_cast<double>(c.sign) * s;
  };
  auto normal_into = [&](const Constraint& c, std::vector<double>& out) {
    std::fill(out.begin(), out.end(), 0.0);
    if (c.kind == 0) {
      out[c.index] = static_cast<double>(c.sign);
    } else {
      for (int j = 0; j < n; ++j)
        out[j] = static_cast<double>(c.sign) * A[c.index * n + j];
    }
  };

  std::vector<Constraint> active;
  std::vector<double> lambda;  // duals of active constraints (>= 0)

  const double tol = 1e-9 * (1.0 + hmax);

  std::vector<double> np_(n), z(n), r, tmp(n);

  for (int iter = 0; iter < max_iter; ++iter) {
    // ---- find most violated constraint -------------------------------
    Constraint best{};
    double worst = tol;
    for (int i = 0; i < n; ++i) {
      if (lb[i] > -kInf && lb[i] - x[i] > worst) {
        worst = lb[i] - x[i];
        best = {0, i, +1, lb[i]};
      }
      if (ub[i] < kInf && x[i] - ub[i] > worst) {
        worst = x[i] - ub[i];
        best = {0, i, -1, -ub[i]};
      }
    }
    for (int j = 0; j < m; ++j) {
      double ax = 0.0;
      for (int k = 0; k < n; ++k) ax += A[j * n + k] * x[k];
      if (lbA[j] > -kInf && lbA[j] - ax > worst) {
        worst = lbA[j] - ax;
        best = {1, j, +1, lbA[j]};
      }
      if (ubA[j] < kInf && ax - ubA[j] > worst) {
        worst = ax - ubA[j];
        best = {1, j, -1, -ubA[j]};
      }
    }
    if (worst <= tol) {
      // optimal
      double obj = 0.0;
      for (int i = 0; i < n; ++i) {
        obj += g[i] * x[i];
        for (int j = 0; j < n; ++j) obj += 0.5 * x[i] * H[i * n + j] * x[j];
      }
      if (obj_out) *obj_out = obj;
      if (n_active_out) *n_active_out = static_cast<int>(active.size());
      std::memcpy(x_out, x.data(), n * sizeof(double));
      return 0;
    }

    normal_into(best, np_);
    double viol = worst;  // s(x) = b - a'x > 0

    // resolve violated constraint `best` against the current active set
    for (int inner = 0; inner < 4 * (n + m); ++inner) {
      int q = static_cast<int>(active.size());

      // d = Hinv * np
      std::vector<double> d(n, 0.0);
      for (int i = 0; i < n; ++i) {
        double v = 0.0;
        for (int j = 0; j < n; ++j) v += Hinv[i * n + j] * np_[j];
        d[i] = v;
      }

      std::vector<double> rdir;  // dual direction for active constraints
      if (q > 0) {
        // M = N' Hinv N (q x q), rhs = N' d
        std::vector<double> Nmat(q * n);
        for (int a = 0; a < q; ++a) {
          normal_into(active[a], tmp);
          for (int j = 0; j < n; ++j) Nmat[a * n + j] = tmp[j];
        }
        std::vector<double> M(q * q, 0.0), rhs(q, 0.0);
        std::vector<double> HinvN(n);
        for (int a = 0; a < q; ++a) {
          // HinvN_a = Hinv * N_a
          for (int i = 0; i < n; ++i) {
            double v = 0.0;
            for (int j = 0; j < n; ++j) v += Hinv[i * n + j] * Nmat[a * n + j];
            HinvN[i] = v;
          }
          for (int b = 0; b < q; ++b) {
            double v = 0.0;
            for (int j = 0; j < n; ++j) v += Nmat[b * n + j] * HinvN[j];
            M[b * q + a] = v;
          }
          double v = 0.0;
          for (int j = 0; j < n; ++j) v += Nmat[a * n + j] * d[j];
          rhs[a] = v;
        }
        // regularise M slightly (degenerate active sets)
        for (int a = 0; a < q; ++a) M[a * q + a] += 1e-12;
        rdir = rhs;
        if (!chol_solve(M, q, rdir)) return 2;
        // z = d - Hinv N rdir
        for (int i = 0; i < n; ++i) {
          double corr = 0.0;
          for (int a = 0; a < q; ++a) {
            // Hinv N_a  recompute (column i)
            double v = 0.0;
            for (int j = 0; j < n; ++j) v += Hinv[i * n + j] * Nmat[a * n + j];
            corr += v * rdir[a];
          }
          z[i] = d[i] - corr;
        }
      } else {
        z = d;
      }

      double ztnp = 0.0;
      for (int j = 0; j < n; ++j) ztnp += z[j] * np_[j];

      // dual blocking step
      double t1 = kInf;
      int blocking = -1;
      for (int a = 0; a < q; ++a) {
        if (!rdir.empty() && rdir[a] > 1e-12) {
          double tt = lambda[a] / rdir[a];
          if (tt < t1) {
            t1 = tt;
            blocking = a;
          }
        }
      }
      // primal full step
      double t2 = (ztnp > 1e-12) ? viol / ztnp : kInf;

      double t = std::min(t1, t2);
      if (t == kInf) return 3;  // infeasible

      // update duals
      for (int a = 0; a < q; ++a) lambda[a] -= t * (rdir.empty() ? 0.0 : rdir[a]);

      if (t2 == kInf || t < t2) {
        // dual step only: drop blocking constraint, stay on `best`
        viol -= t * ztnp;
        for (int i = 0; i < n; ++i) x[i] += t * z[i];
        active.erase(active.begin() + blocking);
        lambda.erase(lambda.begin() + blocking);
        continue;
      }
      // full step: add `best` to the active set
      for (int i = 0; i < n; ++i) x[i] += t * z[i];
      active.push_back(best);
      lambda.push_back(t);
      // drop any active constraint whose dual hit zero exactly at a tie
      break;
    }
  }
  std::memcpy(x_out, x.data(), n * sizeof(double));
  return 1;
}

}  // extern "C"
