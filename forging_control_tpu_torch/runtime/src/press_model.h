// Hydraulic-press plant model — native C++ runtime.
//
// Deployment-side counterpart of forging_control_tpu/physics/press.py
// (same equations; see that file and the reference citations therein:
// Generate Data/template_model.py:20-133).  The TPU side trains policies
// and generates datasets at scale; this runtime executes the plant and a
// trained policy on a CPU at the 1 ms control period with zero per-step
// allocation, replacing the roles the reference delegated to CasADi/
// CVODES native libraries (SURVEY.md section 2.9).
#pragma once

#include <cmath>

namespace forging {

enum class Variant { kRaw = 0, kSmooth = 1, kClamp = 2 };

struct PressParams {
  // Mechanical
  double M = 90000.0, B = 25000.0, FT = 200000.0;
  double D1 = 0.6, D2 = 0.5, G = 9.81;
  // Hydraulic
  double KB = 22e9, V1_0 = 0.3, V2_0 = 0.1;
  double KL_1 = 8e-13, KL_2 = 14e-14;
  double CD = 0.63, RHO = 858.0, D = 0.006;
  double PS = 32e6, PT = 101325.0, T1 = 0.005;
  // Forging geometry
  double MU = 0.3, K = 1.115, W0 = 0.2, H0 = 0.5, B0 = 0.1;
  double T = 900.0;
  // C45 steel constants
  double M0 = 1200e6, M1 = -0.0025, M2 = -0.0587, M3 = 0.1165, M4 = -0.0065;

  double A1() const { return M_PI * D1 * D1 / 4.0; }
  double A2() const { return M_PI * D2 * D2 / 4.0; }
  double A_spread() const {
    double r = B0 / W0;
    return 0.14 + 0.36 * r - 0.054 * r * r;
  }
};

inline double smooth_relu(double x, double eps = 1e-6) {
  return 0.5 * (x + std::sqrt(x * x + eps));
}

inline double forging_force(const PressParams& p, double y, double y_dot) {
  if (!(y > 0.0 && y_dot >= 0.0)) return 0.0;
  const double h1 = p.H0 - y;
  const double w1 = p.W0 * std::pow(p.H0 / h1, p.A_spread());
  const double b1 = p.B0 * (1.0 + 0.67 * (p.H0 / h1 * p.W0 / w1 - 1.0));
  const double Kd = p.K * (1.0 + p.MU * b1 / (2.0 * y) + y / (4.0 * b1));
  const double Ad = w1 * b1;
  const double e = std::log(p.H0 / (p.H0 - y));
  const double e_dot = y_dot / (p.H0 - y);
  if (e <= 0.0) return 0.0;
  return Kd * Ad * p.M0 * std::exp(p.M1 * p.T) * std::pow(e, p.M2) *
         std::pow(e_dot, p.M3) * std::exp(p.M4 / e);
}

inline double orifice(const PressParams& p, double dp) {
  const double s = dp >= 0.0 ? 1.0 : -1.0;
  return std::sqrt(2.0 / p.RHO * std::fabs(dp)) * s;
}

// dx/dt = f(x, u); x = [y, y_dot, p1, p2, z].
inline void rhs(const PressParams& p, Variant variant, const double x[5],
                double u, double out[5]) {
  const double y = x[0], y_dot = x[1], z = x[4];
  double p1 = x[2], p2 = x[3];
  switch (variant) {
    case Variant::kSmooth:
      p1 = smooth_relu(p1);
      p2 = smooth_relu(p2);
      break;
    case Variant::kClamp:
      p1 = p1 > 0.0 ? p1 : 0.0;
      p2 = p2 > 0.0 ? p2 : 0.0;
      break;
    case Variant::kRaw:
      break;
  }

  const double Fd = forging_force(p, y, y_dot);
  const double Ft =
      std::fabs(y_dot) <= 0.5 ? p.FT * y_dot / 0.5 : p.FT;

  const double coeff = M_PI * p.D * p.CD * z;
  double qvPB, qvAT;
  if (z >= 0.0) {
    qvPB = coeff * orifice(p, p.PS - p1);
    qvAT = coeff * orifice(p, p2 - p.PT);
  } else {
    qvPB = coeff * orifice(p, p1 - p.PT);
    qvAT = coeff * orifice(p, p.PS - p2);
  }

  const double V1 = p.V1_0 / 2.0 + p.A1() * y;
  const double V2 = p.V2_0 / 2.0 - p.A2() * y;

  out[0] = y_dot;
  out[1] = (3.0 * M_PI * p.D1 * p.D1 * p1 / 4.0 -
            M_PI * p.D2 * p.D2 * p2 / 2.0 - p.B * y_dot - Ft - Fd) /
               p.M +
           p.G;
  out[2] = p.KB / V1 * (qvPB / 3.0 - p.A1() * y_dot - p.KL_1 * p1);
  out[3] = p.KB / V2 * (-qvAT / 2.0 + p.A2() * y_dot - p.KL_2 * p2);
  out[4] = (-z + u) / p.T1;
}

// RK4 over one control period with `substeps` stages; additive
// disturbance w (process noise) as in do-mpc's make_step(u, w0).
inline void rk4_step(const PressParams& p, Variant variant, double x[5],
                     double u, double dt, int substeps,
                     const double* w = nullptr) {
  const double h = dt / substeps;
  double k1[5], k2[5], k3[5], k4[5], tmp[5];
  for (int s = 0; s < substeps; ++s) {
    rhs(p, variant, x, u, k1);
    if (w) for (int i = 0; i < 5; ++i) k1[i] += w[i];
    for (int i = 0; i < 5; ++i) tmp[i] = x[i] + 0.5 * h * k1[i];
    rhs(p, variant, tmp, u, k2);
    if (w) for (int i = 0; i < 5; ++i) k2[i] += w[i];
    for (int i = 0; i < 5; ++i) tmp[i] = x[i] + 0.5 * h * k2[i];
    rhs(p, variant, tmp, u, k3);
    if (w) for (int i = 0; i < 5; ++i) k3[i] += w[i];
    for (int i = 0; i < 5; ++i) tmp[i] = x[i] + h * k3[i];
    rhs(p, variant, tmp, u, k4);
    if (w) for (int i = 0; i < 5; ++i) k4[i] += w[i];
    for (int i = 0; i < 5; ++i)
      x[i] += (h / 6.0) * (k1[i] + 2.0 * k2[i] + 2.0 * k3[i] + k4[i]);
  }
}

inline void measure(const PressParams&, Variant variant, const double x[5],
                    double out[5]) {
  for (int i = 0; i < 5; ++i) out[i] = x[i];
  if (variant == Variant::kSmooth) {
    out[2] = smooth_relu(x[2]);
    out[3] = smooth_relu(x[3]);
  }
}

}  // namespace forging
