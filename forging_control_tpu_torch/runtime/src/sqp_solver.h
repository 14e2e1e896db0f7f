// Native condensed GN-SQP MPC solver — single-stream real-time path.
//
// The C++ twin of forging_control_tpu/solver/sqp.py: same condensed
// single-shooting formulation (decision = N scaled inputs), Gauss-Newton
// on the tracking/du residuals, augmented-Lagrangian pressure bounds,
// damped-candidate globalization, shift warm start.  Purpose: the
// deployment-side MPC at the 1 ms control period — the budget the
// reference's IPOPT misses by 3-15x at the median (BASELINE.md) — using
// forward-mode dual-number Jacobians through the RK4 rollout.
//
// Fixed-capacity buffers (N <= MAX_N), zero allocation per solve.
#pragma once

#include <algorithm>
#include <cmath>
#include <cstring>
#include <initializer_list>

#include "press_model.h"

namespace forging {

constexpr int kMaxN = 25;
constexpr double kUScale = 0.01;   // template_mpc.py:37
constexpr double kPScale = 1e7;    // template_mpc.py:34-35

// Forward-mode dual numbers with a single tangent: one rollout per
// decision variable gives the exact Jacobian column (same derivative the
// JAX side gets from jacfwd).
struct Dual {
  double v, d;
  Dual(double v_ = 0, double d_ = 0) : v(v_), d(d_) {}
};
inline Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.d + b.d}; }
inline Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.d - b.d}; }
inline Dual operator*(Dual a, Dual b) { return {a.v * b.v, a.d * b.v + a.v * b.d}; }
inline Dual operator/(Dual a, Dual b) {
  double inv = 1.0 / b.v;
  return {a.v * inv, (a.d - a.v * b.d * inv) * inv};
}
inline Dual operator+(Dual a, double b) { return {a.v + b, a.d}; }
inline Dual operator+(double a, Dual b) { return {a + b.v, b.d}; }
inline Dual operator-(Dual a, double b) { return {a.v - b, a.d}; }
inline Dual operator-(double a, Dual b) { return {a - b.v, -b.d}; }
inline Dual operator*(Dual a, double b) { return {a.v * b, a.d * b}; }
inline Dual operator*(double a, Dual b) { return {a * b.v, a * b.d}; }
inline Dual operator/(Dual a, double b) { return {a.v / b, a.d / b}; }
inline Dual operator/(double a, Dual b) {
  double inv = 1.0 / b.v;
  return {a * inv, -a * b.d * inv * inv};
}
inline Dual operator-(Dual a) { return {-a.v, -a.d}; }
inline Dual sqrt(Dual a) {
  double s = std::sqrt(a.v);
  return {s, s > 0 ? a.d / (2.0 * s) : 0.0};
}
inline Dual exp(Dual a) {
  double e = std::exp(a.v);
  return {e, e * a.d};
}
inline Dual log(Dual a) { return {std::log(a.v), a.d / a.v}; }
inline Dual pow(Dual a, double p) {
  double f = std::pow(a.v, p);
  return {f, a.v > 0 ? p * f / a.v * a.d : 0.0};
}
inline Dual fabs_s(Dual a) { return a.v >= 0 ? a : -a; }
inline double fabs_s(double a) { return std::fabs(a); }
// Exact-match double forwarders so unqualified calls in templated code do
// not implicitly convert double -> Dual.
inline double sqrt(double a) { return std::sqrt(a); }
inline double exp(double a) { return std::exp(a); }
inline double log(double a) { return std::log(a); }
inline double pow(double a, double b) { return std::pow(a, b); }
inline double sign_of(double x) { return x >= 0 ? 1.0 : -1.0; }
inline double value_of(double x) { return x; }
inline double value_of(Dual x) { return x.v; }

// Multi-tangent forward-mode duals: ONE rollout carries all NT Jacobian
// columns.  Transcendentals (sqrt/exp/log/pow) are evaluated once on the
// value and chain-ruled onto the tangent array; the per-tangent loops are
// trivially SIMD-vectorized by -O3 -march=native.  This replaces the N
// single-tangent rollouts per GN iteration (N x fewer transcendental
// evaluations — the dominant cost of the N=25 solve).
template <int NT>
struct DualN {
  double v;
  double d[NT];
  DualN() : v(0) { for (int i = 0; i < NT; ++i) d[i] = 0; }
  explicit DualN(double v_) : v(v_) { for (int i = 0; i < NT; ++i) d[i] = 0; }
};
template <int NT>
inline DualN<NT> operator+(const DualN<NT>& a, const DualN<NT>& b) {
  DualN<NT> r; r.v = a.v + b.v;
  for (int i = 0; i < NT; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
template <int NT>
inline DualN<NT> operator-(const DualN<NT>& a, const DualN<NT>& b) {
  DualN<NT> r; r.v = a.v - b.v;
  for (int i = 0; i < NT; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
template <int NT>
inline DualN<NT> operator*(const DualN<NT>& a, const DualN<NT>& b) {
  DualN<NT> r; r.v = a.v * b.v;
  for (int i = 0; i < NT; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}
template <int NT>
inline DualN<NT> operator/(const DualN<NT>& a, const DualN<NT>& b) {
  DualN<NT> r; const double inv = 1.0 / b.v; r.v = a.v * inv;
  for (int i = 0; i < NT; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) * inv;
  return r;
}
template <int NT>
inline DualN<NT> operator+(const DualN<NT>& a, double b) {
  DualN<NT> r = a; r.v += b; return r;
}
template <int NT>
inline DualN<NT> operator+(double a, const DualN<NT>& b) { return b + a; }
template <int NT>
inline DualN<NT> operator-(const DualN<NT>& a, double b) {
  DualN<NT> r = a; r.v -= b; return r;
}
template <int NT>
inline DualN<NT> operator-(double a, const DualN<NT>& b) {
  DualN<NT> r; r.v = a - b.v;
  for (int i = 0; i < NT; ++i) r.d[i] = -b.d[i];
  return r;
}
template <int NT>
inline DualN<NT> operator*(const DualN<NT>& a, double b) {
  DualN<NT> r; r.v = a.v * b;
  for (int i = 0; i < NT; ++i) r.d[i] = a.d[i] * b;
  return r;
}
template <int NT>
inline DualN<NT> operator*(double a, const DualN<NT>& b) { return b * a; }
template <int NT>
inline DualN<NT> operator/(const DualN<NT>& a, double b) {
  return a * (1.0 / b);
}
template <int NT>
inline DualN<NT> operator/(double a, const DualN<NT>& b) {
  DualN<NT> r; const double inv = 1.0 / b.v; r.v = a * inv;
  const double c = -r.v * inv;
  for (int i = 0; i < NT; ++i) r.d[i] = c * b.d[i];
  return r;
}
template <int NT>
inline DualN<NT> operator-(const DualN<NT>& a) {
  DualN<NT> r; r.v = -a.v;
  for (int i = 0; i < NT; ++i) r.d[i] = -a.d[i];
  return r;
}
template <int NT>
inline DualN<NT> sqrt(const DualN<NT>& a) {
  DualN<NT> r; const double s = std::sqrt(a.v); r.v = s;
  const double c = s > 0 ? 0.5 / s : 0.0;
  for (int i = 0; i < NT; ++i) r.d[i] = c * a.d[i];
  return r;
}
template <int NT>
inline DualN<NT> exp(const DualN<NT>& a) {
  DualN<NT> r; const double e = std::exp(a.v); r.v = e;
  for (int i = 0; i < NT; ++i) r.d[i] = e * a.d[i];
  return r;
}
template <int NT>
inline DualN<NT> log(const DualN<NT>& a) {
  DualN<NT> r; r.v = std::log(a.v); const double inv = 1.0 / a.v;
  for (int i = 0; i < NT; ++i) r.d[i] = inv * a.d[i];
  return r;
}
template <int NT>
inline DualN<NT> pow(const DualN<NT>& a, double p) {
  DualN<NT> r; const double f = std::pow(a.v, p); r.v = f;
  const double c = a.v > 0 ? p * f / a.v : 0.0;
  for (int i = 0; i < NT; ++i) r.d[i] = c * a.d[i];
  return r;
}
template <int NT>
inline DualN<NT> fabs_s(const DualN<NT>& a) { return a.v >= 0 ? a : -a; }
template <int NT>
inline double value_of(const DualN<NT>& x) { return x.v; }

// Smooth-variant RHS templated on scalar type (mirrors press_model.h rhs
// with Variant::kSmooth; templated so Dual tangents flow through).
template <typename S>
inline void rhs_smooth(const PressParams& p, const S x[5], S u, S out[5]) {
  const S y = x[0], y_dot = x[1], z = x[4];
  // smooth_relu pressure floor
  const S p1 = 0.5 * (x[2] + sqrt(x[2] * x[2] + 1e-6));
  const S p2 = 0.5 * (x[3] + sqrt(x[3] * x[3] + 1e-6));

  // forging force (gated; clipped branch like the JAX side)
  S Fd(0.0);
  const double yv = value_of(y), ydv = value_of(y_dot);
  if (yv > 0.0 && ydv >= 0.0) {
    const S h1 = p.H0 - y;
    const S w1 = p.W0 * pow(p.H0 / h1, p.A_spread());
    const S b1 = p.B0 * (1.0 + 0.67 * (p.H0 / h1 * p.W0 / w1 - 1.0));
    const S Kd = p.K * (1.0 + p.MU * b1 / (2.0 * y) + y / (4.0 * b1));
    const S Ad = w1 * b1;
    const S e = log(p.H0 / (p.H0 - y));
    const S e_dot = y_dot / (p.H0 - y);
    if (value_of(e) > 0.0 && value_of(e_dot) > 0.0) {
      Fd = Kd * Ad * p.M0 * std::exp(p.M1 * p.T) * pow(e, p.M2) *
           pow(e_dot, p.M3) * exp(p.M4 / e);
    }
  }

  const S Ft = std::fabs(ydv) <= 0.5 ? S(p.FT / 0.5) * y_dot : S(p.FT);

  const double coeffd = M_PI * p.D * p.CD;
  auto orif = [&](S dp) -> S {
    const double s = sign_of(value_of(dp));
    return sqrt(2.0 / p.RHO * (fabs_s(dp) + 1e-2)) * s;
  };
  S qvPB, qvAT;
  if (value_of(z) >= 0.0) {
    qvPB = coeffd * z * orif(p.PS - p1);
    qvAT = coeffd * z * orif(p2 - p.PT);
  } else {
    qvPB = coeffd * z * orif(p1 - p.PT);
    qvAT = coeffd * z * orif(p.PS - p2);
  }

  const S V1 = p.V1_0 / 2.0 + p.A1() * y;
  const S V2 = p.V2_0 / 2.0 - p.A2() * y;

  out[0] = y_dot;
  out[1] = (3.0 * M_PI * p.D1 * p.D1 * p1 / 4.0 -
            M_PI * p.D2 * p.D2 * p2 / 2.0 - p.B * y_dot - Ft - Fd) /
               p.M +
           p.G;
  out[2] = p.KB / V1 * (qvPB / 3.0 - p.A1() * y_dot - p.KL_1 * p1);
  out[3] = p.KB / V2 * (-qvAT / 2.0 + p.A2() * y_dot - p.KL_2 * p2);
  out[4] = (u - z) / p.T1;
}

template <typename S>
inline void rk4_step_t(const PressParams& p, S x[5], S u, double dt,
                       int substeps) {
  const double h = dt / substeps;
  S k1[5], k2[5], k3[5], k4[5], tmp[5];
  for (int s = 0; s < substeps; ++s) {
    rhs_smooth(p, x, u, k1);
    for (int i = 0; i < 5; ++i) tmp[i] = x[i] + 0.5 * h * k1[i];
    rhs_smooth(p, tmp, u, k2);
    for (int i = 0; i < 5; ++i) tmp[i] = x[i] + 0.5 * h * k2[i];
    rhs_smooth(p, tmp, u, k3);
    for (int i = 0; i < 5; ++i) tmp[i] = x[i] + h * k3[i];
    rhs_smooth(p, tmp, u, k4);
    for (int i = 0; i < 5; ++i)
      x[i] = x[i] + (h / 6.0) * (k1[i] + 2.0 * k2[i] + 2.0 * k3[i] + k4[i]);
  }
}

struct SqpConfig {
  int horizon = 10;
  double dt = 1e-3;
  int substeps = 4;
  double rterm = 0.02;
  double p_min = 0.0;
  double p_max = -1.0;  // <0 => no upper bound
  int gn_iters = 5;
  int al_iters = 2;
  double mu0 = 1e2;
  double mu_factor = 10.0;
  double lm_reg = 1e-8;
  double tol_grad = 1e-7;
};

struct SqpDiag {
  int iters = 0;
  double obj = 0, inf_pr = 0, inf_du = 0;
};

class SqpSolver {
 public:
  explicit SqpSolver(const SqpConfig& cfg) : cfg_(cfg) {
    n_con_ = (cfg.p_max > 0 ? 4 : 2) * cfg.horizon;
    std::memset(v_, 0, sizeof(v_));
    std::memset(lam_, 0, sizeof(lam_));
  }

  void reset() {
    std::memset(v_, 0, sizeof(v_));
    std::memset(lam_, 0, sizeof(lam_));
  }

  // Shift warm start (previous solution advanced one period).
  void shift() {
    for (int i = 0; i + 1 < cfg_.horizon; ++i) v_[i] = v_[i + 1];
  }

  // One MPC solve from measured state x0; returns u0 (physical units).
  double solve(const double x0[5], double ref, double u_prev, SqpDiag* diag);

  const double* solution() const { return v_; }

 private:
  // residuals: track (N) + du (N) + AL-active constraints (n_con_)
  int n_res() const { return 2 * cfg_.horizon + n_con_; }

  template <typename S>
  void residuals(const double x0[5], double ref, double u_prev_s,
                 const S* v, double mu, S* r) const;

  // Residuals + Jacobian in ONE multi-tangent rollout (NT >= horizon).
  template <int NT>
  void jac_pass(const double x0[5], double ref, double u_prev_s, double mu,
                double* r, double J[][kMaxN]) const {
    const int N = cfg_.horizon, M = n_res();
    DualN<NT> vd[kMaxN];
    DualN<NT> rd[6 * kMaxN];
    for (int k = 0; k < N; ++k) {
      vd[k] = DualN<NT>(v_[k]);
      vd[k].d[k] = 1.0;
    }
    residuals(x0, ref, u_prev_s, vd, mu, rd);
    for (int i = 0; i < M; ++i) {
      r[i] = rd[i].v;
      for (int j = 0; j < N; ++j) J[i][j] = rd[i].d[j];
    }
  }

  SqpConfig cfg_;
  int n_con_;
  double v_[kMaxN];
  double lam_[4 * kMaxN];
};

template <typename S>
void SqpSolver::residuals(const double x0[5], double ref, double u_prev_s,
                          const S* v, double mu, S* r) const {
  const PressParams P{};
  const int N = cfg_.horizon;
  S x[5];
  for (int i = 0; i < 5; ++i) x[i] = S(x0[i]);
  const double sr = std::sqrt(cfg_.rterm);
  const double smu = std::sqrt(mu / 2.0);
  S prev = S(u_prev_s);
  int ci = 2 * N;
  for (int k = 0; k < N; ++k) {
    S uk = v[k] * kUScale;
    rk4_step_t(P, x, uk, cfg_.dt, cfg_.substeps);
    r[k] = x[1] - ref;                 // tracking residual (stages 1..N)
    r[N + k] = sr * (v[k] - prev);     // scaled du residual
    prev = v[k];
    // AL residuals sqrt(mu/2)*max(0, lam/mu - c)
    const S c1 = (x[2] - cfg_.p_min) / kPScale;
    const S c2 = (x[3] - cfg_.p_min) / kPScale;
    auto al = [&](S c, double lam) -> S {
      S t = lam / mu - c;
      return value_of(t) > 0.0 ? smu * t : S(0.0);
    };
    r[ci] = al(c1, lam_[ci - 2 * N]);
    r[ci + 1] = al(c2, lam_[ci + 1 - 2 * N]);
    ci += 2;
    if (cfg_.p_max > 0) {
      const S c3 = (cfg_.p_max - x[2] * 1.0) / kPScale;
      const S c4 = (cfg_.p_max - x[3] * 1.0) / kPScale;
      r[ci] = al(c3, lam_[ci - 2 * N]);
      r[ci + 1] = al(c4, lam_[ci + 1 - 2 * N]);
      ci += 2;
    }
  }
}

inline double SqpSolver::solve(const double x0[5], double ref, double u_prev,
                               SqpDiag* diag) {
  const int N = cfg_.horizon;
  const int M = n_res();
  const double u_prev_s = u_prev / kUScale;
  double mu = cfg_.mu0;

  double r[2 * kMaxN + 4 * kMaxN];
  double J[2 * kMaxN + 4 * kMaxN][kMaxN];  // M x N
  double H[kMaxN][kMaxN], g[kMaxN], L[kMaxN][kMaxN], yv[kMaxN], dv[kMaxN];

  int iters = 0;
  double inf_du = 0;

  for (int ar = 0; ar < cfg_.al_iters; ++ar) {
    for (int it = 0; it < cfg_.gn_iters; ++it) {
      // residuals + Jacobian via ONE multi-tangent rollout, dispatched to
      // the smallest compiled tangent width covering the horizon.
      if (N <= 5)       jac_pass<5>(x0, ref, u_prev_s, mu, r, J);
      else if (N <= 10) jac_pass<10>(x0, ref, u_prev_s, mu, r, J);
      else if (N <= 15) jac_pass<15>(x0, ref, u_prev_s, mu, r, J);
      else if (N <= 20) jac_pass<20>(x0, ref, u_prev_s, mu, r, J);
      else              jac_pass<kMaxN>(x0, ref, u_prev_s, mu, r, J);

      double cost0 = 0;
      for (int i = 0; i < M; ++i) cost0 += 0.5 * r[i] * r[i];

      // g = J^T r; H = J^T J + reg I
      double gnorm = 0;
      for (int a = 0; a < N; ++a) {
        double s = 0;
        for (int i = 0; i < M; ++i) s += J[i][a] * r[i];
        g[a] = s;
        gnorm = std::max(gnorm, std::fabs(s));
        for (int b = 0; b <= a; ++b) {
          double h = 0;
          for (int i = 0; i < M; ++i) h += J[i][a] * J[i][b];
          H[a][b] = H[b][a] = h;
        }
        H[a][a] += cfg_.lm_reg;
      }
      inf_du = gnorm;
      if (gnorm < cfg_.tol_grad) break;
      ++iters;

      // Cholesky solve H dv = -g
      for (int jj = 0; jj < N; ++jj) {
        double s = H[jj][jj];
        for (int k = 0; k < jj; ++k) s -= L[jj][k] * L[jj][k];
        L[jj][jj] = std::sqrt(std::max(s, 1e-300));
        for (int i2 = jj + 1; i2 < N; ++i2) {
          double t = H[i2][jj];
          for (int k = 0; k < jj; ++k) t -= L[i2][k] * L[jj][k];
          L[i2][jj] = t / L[jj][jj];
        }
      }
      for (int i2 = 0; i2 < N; ++i2) {
        double s = -g[i2];
        for (int k = 0; k < i2; ++k) s -= L[i2][k] * yv[k];
        yv[i2] = s / L[i2][i2];
      }
      for (int i2 = N - 1; i2 >= 0; --i2) {
        double s = yv[i2];
        for (int k = i2 + 1; k < N; ++k) s -= L[k][i2] * dv[k];
        dv[i2] = s / L[i2][i2];
      }

      // step ladder (1.0, 0.25)
      double best_cost = cost0;
      double best_v[kMaxN];
      bool improved = false;
      for (double alpha : {1.0, 0.25}) {
        double vt[kMaxN];
        for (int k = 0; k < N; ++k) vt[k] = v_[k] + alpha * dv[k];
        double rt[2 * kMaxN + 4 * kMaxN];
        residuals(x0, ref, u_prev_s, vt, mu, rt);
        double c = 0;
        for (int i = 0; i < M; ++i) c += 0.5 * rt[i] * rt[i];
        if (c < best_cost) {
          best_cost = c;
          std::memcpy(best_v, vt, sizeof(double) * N);
          improved = true;
        }
      }
      if (improved) std::memcpy(v_, best_v, sizeof(double) * N);
    }

    // multiplier update: lam <- max(0, lam - mu c)
    const PressParams P{};
    double x[5];
    std::memcpy(x, x0, sizeof(x));
    int ci = 0;
    double inf_pr = 0;
    for (int k = 0; k < N; ++k) {
      rk4_step_t(P, x, v_[k] * kUScale, cfg_.dt, cfg_.substeps);
      const double c1 = (x[2] - cfg_.p_min) / kPScale;
      const double c2 = (x[3] - cfg_.p_min) / kPScale;
      lam_[ci] = std::max(0.0, lam_[ci] - mu * c1);
      lam_[ci + 1] = std::max(0.0, lam_[ci + 1] - mu * c2);
      inf_pr = std::max({inf_pr, -c1, -c2});
      ci += 2;
      if (cfg_.p_max > 0) {
        const double c3 = (cfg_.p_max - x[2]) / kPScale;
        const double c4 = (cfg_.p_max - x[3]) / kPScale;
        lam_[ci] = std::max(0.0, lam_[ci] - mu * c3);
        lam_[ci + 1] = std::max(0.0, lam_[ci + 1] - mu * c4);
        inf_pr = std::max({inf_pr, -c3, -c4});
        ci += 2;
      }
    }
    if (diag) diag->inf_pr = inf_pr;
    mu *= cfg_.mu_factor;
  }

  if (diag) {
    diag->iters = iters;
    diag->inf_du = inf_du;
    double obj = 0;
    // true objective
    const PressParams P{};
    double x[5];
    std::memcpy(x, x0, sizeof(x));
    double prev = u_prev_s;
    for (int k = 0; k < N; ++k) {
      rk4_step_t(P, x, v_[k] * kUScale, cfg_.dt, cfg_.substeps);
      obj += (x[1] - ref) * (x[1] - ref);
      obj += cfg_.rterm * (v_[k] - prev) * (v_[k] - prev);
      prev = v_[k];
    }
    diag->obj = obj;
  }
  return v_[0] * kUScale;
}

}  // namespace forging
