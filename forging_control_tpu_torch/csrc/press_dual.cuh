// Device physics of the press for the port's hand-written kernels, written
// once for the card (nvcc, __host__ __device__) and for the CPU (g++, plain
// C++), templated on the scalar type T (float, double) and on the number of
// forward tangents K (0: values only; 7: a stage's linearisation in the
// AL-iLQR solve; 6: its terminal one).
//
// It follows forging_control_tpu_torch/physics/press.py (rhs, forging_force,
// _orifice, valve_flows, friction, effective_pressures, measure) and
// integrate/rk4.py (rk4_step) operation for operation, in the order that
// Python evaluates each expression, with the tangent rules of
// forging_control_tpu_torch/dual.py, which are JAX's:
//   maximum / minimum give each side one half of the tangent at a tie;
//   clip is minimum(maximum(a, lo), hi); abs passes +1 at 0; sign has a
//   zero tangent; where selects the tangent; c / a is PyTorch's
//   reciprocal(a) * c, and a ** -2 is 1 / (a * a).
// A tensor divided by a Python number rounds as PyTorch rounds it on each
// side (divc).  Every constant that press.py computes in Python (derived areas, exp(M1*T),
// sqrt(s * eps_q), ...) arrives precomputed in double in PressParams, so
// that the kernels round it to T exactly as PyTorch rounds a Python number
// to the tensor's type.  Nothing is baked in: a PressParams with other
// values computes the same thing as press.py with those values.
#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define FCT_HD __host__ __device__ inline
#define FCT_HDF __host__ __device__ __forceinline__
#else
#define FCT_HD inline
#define FCT_HDF inline
#endif

namespace fct {

// press.PressParams, with the constants press.py derives from it in Python
// (ops/plant.py press_params builds it; field order is the ctypes layout).
struct PressParams {
  double M, B, FT, G, KB, KL_1, KL_2, PS, PT, T1;
  double MU, K, W0, H0, B0, M0, M2, M3, M4;
  double eps_y, eps_q, A1, A2, A_spread;
  double y_hi;        // H0 * (1.0 - 1e-9)
  double exp_m1t;     // math.exp(M1 * T)
  double c_p1;        // 3.0 * math.pi * D1 ** 2
  double c_p2;        // math.pi * D2 ** 2
  double coeff;       // math.pi * D * CD
  double s_orf;       // 2.0 / RHO
  double lin_den;     // math.sqrt(s_orf * eps_q)
  double v1h, v2h;    // V1_0 / 2.0, V2_0 / 2.0
  double smooth_eps;  // press._SMOOTH_EPS
  double A_m1, M2_m1, M3_m1;   // A_spread - 1.0, M2 - 1.0, M3 - 1.0
};

enum Variant { RAW = 0, SMOOTH = 1, CLAMP = 2 };

FCT_HDF float m_sqrt(float x) { return sqrtf(x); }
FCT_HDF double m_sqrt(double x) { return sqrt(x); }
FCT_HDF float m_exp(float x) { return expf(x); }
FCT_HDF double m_exp(double x) { return exp(x); }
FCT_HDF float m_log(float x) { return logf(x); }
FCT_HDF double m_log(double x) { return log(x); }
FCT_HDF float m_pow(float x, float c) { return powf(x, c); }
FCT_HDF double m_pow(double x, double c) { return pow(x, c); }
FCT_HDF float m_abs(float x) { return fabsf(x); }
FCT_HDF double m_abs(double x) { return fabs(x); }

template <class T> FCT_HDF bool is_nan(T x) { return x != x; }

// a / c for a number c, as PyTorch divides a tensor by a Python number:
// its CUDA kernels multiply by the reciprocal of c (computed in T), its CPU
// kernels divide.  The card's build follows the former, the host build the
// latter, so that each rounds as the plain version does beside it.
template <class T> FCT_HDF T divc(T a, T c) {
#if defined(__CUDA_ARCH__)
  return a * (T(1) / c);
#else
  return a / c;
#endif
}

// torch.maximum / torch.minimum (and clamp_min / clamp_max against a
// number): NaN propagates.
template <class T> FCT_HDF T t_max(T a, T b) {
  return is_nan(a) ? a : (is_nan(b) ? b : (a > b ? a : b));
}
template <class T> FCT_HDF T t_min(T a, T b) {
  return is_nan(a) ? a : (is_nan(b) ? b : (a < b ? a : b));
}
// torch.sign: -1, 0 or 1 (0 at NaN).
template <class T> FCT_HDF T t_sign(T a) {
  return T((T(0) < a) - (a < T(0)));
}

// A value with K tangents (dual.Dual with D = K directions).
template <class T, int K>
struct Dual {
  T v;
  T d[K > 0 ? K : 1];
};

template <class T, int K> FCT_HDF Dual<T, K> cst(T c) {
  Dual<T, K> r;
  r.v = c;
  for (int i = 0; i < K; ++i) r.d[i] = T(0);
  return r;
}

// Dual op Dual.
template <class T, int K>
FCT_HDF Dual<T, K> operator+(const Dual<T, K>& a, const Dual<T, K>& b) {
  Dual<T, K> r;
  r.v = a.v + b.v;
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
template <class T, int K>
FCT_HDF Dual<T, K> operator-(const Dual<T, K>& a, const Dual<T, K>& b) {
  Dual<T, K> r;
  r.v = a.v - b.v;
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
template <class T, int K>
FCT_HDF Dual<T, K> operator*(const Dual<T, K>& a, const Dual<T, K>& b) {
  Dual<T, K> r;
  r.v = a.v * b.v;
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}
template <class T, int K>
FCT_HDF Dual<T, K> operator/(const Dual<T, K>& a, const Dual<T, K>& b) {
  Dual<T, K> r;
  r.v = a.v / b.v;
  if (K > 0) {
    const T inv2 = T(1) / (b.v * b.v);
    for (int i = 0; i < K; ++i)
      r.d[i] = a.d[i] / b.v + (-b.d[i] * a.v) * inv2;
  }
  return r;
}
template <class T, int K> FCT_HDF Dual<T, K> operator-(const Dual<T, K>& a) {
  Dual<T, K> r;
  r.v = -a.v;
  for (int i = 0; i < K; ++i) r.d[i] = -a.d[i];
  return r;
}

// Dual op number (a tensor without tangents, or a Python number already
// rounded to T).
template <class T, int K>
FCT_HDF Dual<T, K> operator+(const Dual<T, K>& a, T c) {
  Dual<T, K> r = a;
  r.v = a.v + c;
  return r;
}
template <class T, int K>
FCT_HDF Dual<T, K> operator+(T c, const Dual<T, K>& a) {
  Dual<T, K> r = a;
  r.v = a.v + c;
  return r;
}
template <class T, int K>
FCT_HDF Dual<T, K> operator-(const Dual<T, K>& a, T c) {
  Dual<T, K> r = a;
  r.v = a.v - c;
  return r;
}
template <class T, int K>
FCT_HDF Dual<T, K> operator-(T c, const Dual<T, K>& a) {
  Dual<T, K> r;
  r.v = c - a.v;
  for (int i = 0; i < K; ++i) r.d[i] = -a.d[i];
  return r;
}
template <class T, int K>
FCT_HDF Dual<T, K> operator*(const Dual<T, K>& a, T c) {
  Dual<T, K> r;
  r.v = a.v * c;
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] * c;
  return r;
}
template <class T, int K>
FCT_HDF Dual<T, K> operator*(T c, const Dual<T, K>& a) {
  return a * c;
}
template <class T, int K>
FCT_HDF Dual<T, K> operator/(const Dual<T, K>& a, T c) {
  Dual<T, K> r;
  r.v = divc(a.v, c);
  for (int i = 0; i < K; ++i) r.d[i] = divc(a.d[i], c);
  return r;
}
// c / a: PyTorch's Tensor.__rtruediv__ is reciprocal(a) * c; the tangent
// (-a.t * c) * a ** -2, with a ** -2 = 1 / (a * a).
template <class T, int K>
FCT_HDF Dual<T, K> operator/(T c, const Dual<T, K>& a) {
  Dual<T, K> r;
  r.v = (T(1) / a.v) * c;
  if (K > 0) {
    const T inv2 = T(1) / (a.v * a.v);
    for (int i = 0; i < K; ++i) r.d[i] = (-a.d[i] * c) * inv2;
  }
  return r;
}

// a ** c (c not one of PyTorch's special exponents): tangent
// a.t * (c * a ** (c - 1)), with c - 1 computed in Python (cm1).
template <class T, int K>
FCT_HDF Dual<T, K> dpow(const Dual<T, K>& a, T c, T cm1) {
  Dual<T, K> r;
  r.v = m_pow(a.v, c);
  if (K > 0) {
    const T s = m_pow(a.v, cm1) * c;
    for (int i = 0; i < K; ++i) r.d[i] = a.d[i] * s;
  }
  return r;
}
template <class T, int K> FCT_HDF Dual<T, K> dsqrt(const Dual<T, K>& a) {
  Dual<T, K> r;
  r.v = m_sqrt(a.v);
  if (K > 0) {
    const T s = (T(1) / r.v) * T(0.5);
    for (int i = 0; i < K; ++i) r.d[i] = a.d[i] * s;
  }
  return r;
}
template <class T, int K> FCT_HDF Dual<T, K> dexp(const Dual<T, K>& a) {
  Dual<T, K> r;
  r.v = m_exp(a.v);
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] * r.v;
  return r;
}
template <class T, int K> FCT_HDF Dual<T, K> dlog(const Dual<T, K>& a) {
  Dual<T, K> r;
  r.v = m_log(a.v);
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] / a.v;
  return r;
}
// jnp.abs: +1 at 0.
template <class T, int K> FCT_HDF Dual<T, K> dabs(const Dual<T, K>& a) {
  Dual<T, K> r;
  r.v = m_abs(a.v);
  const bool pos = a.v >= T(0);
  for (int i = 0; i < K; ++i) r.d[i] = pos ? a.d[i] : -a.d[i];
  return r;
}
// jnp.maximum / jnp.minimum against a number: the tangent weighted 1 where
// a is the extremum, 1/2 at a tie (JAX's _balanced_eq).
template <class T, int K>
FCT_HDF Dual<T, K> dmax(const Dual<T, K>& a, T c) {
  Dual<T, K> r;
  r.v = t_max(a.v, c);
  const T w = (a.v == r.v ? T(1) : T(0)) / (c == r.v ? T(2) : T(1));
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] * w;
  return r;
}
template <class T, int K>
FCT_HDF Dual<T, K> dmin(const Dual<T, K>& a, T c) {
  Dual<T, K> r;
  r.v = t_min(a.v, c);
  const T w = (a.v == r.v ? T(1) : T(0)) / (c == r.v ? T(2) : T(1));
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] * w;
  return r;
}
template <class T, int K>
FCT_HDF Dual<T, K> dclip(const Dual<T, K>& a, T lo, T hi) {
  return dmin(dmax(a, lo), hi);
}
template <class T, int K>
FCT_HDF Dual<T, K> dwhere(bool c, const Dual<T, K>& a, const Dual<T, K>& b) {
  return c ? a : b;
}

// press._smooth_relu: 0.5 * (x + sqrt(x * x + eps)).
template <class T, int K>
FCT_HD Dual<T, K> smooth_relu(const Dual<T, K>& x, const PressParams& P) {
  return T(0.5) * (x + dsqrt(x * x + T(P.smooth_eps)));
}

template <class T, int K>
FCT_HD Dual<T, K> effective_pressure(const Dual<T, K>& p, int variant,
                                     const PressParams& P) {
  if (variant == SMOOTH) return smooth_relu(p, P);
  if (variant == CLAMP) return dmax(p, T(0));
  return p;
}

// press.forging_force: gated to 0 unless y > 0 and y_dot >= 0, the gated
// branch evaluated at clipped arguments.
template <class T, int K>
FCT_HD Dual<T, K> forging_force(const Dual<T, K>& y, const Dual<T, K>& y_dot,
                                const PressParams& P) {
  typedef Dual<T, K> D;
  const bool gate = (y.v > T(0)) && (y_dot.v >= T(0));
  if (!gate) return cst<T, K>(T(0));
  const T H0 = T(P.H0), W0 = T(P.W0), B0 = T(P.B0);
  const D y_s = dclip(y, T(P.eps_y), T(P.y_hi));
  const D yd_s = dmax(y_dot, T(0));
  const D h1 = H0 - y_s;
  const D w1 = W0 * dpow(H0 / h1, T(P.A_spread), T(P.A_m1));
  const D b1 = B0 * (T(1) + T(0.67) * ((H0 / h1) * W0 / w1 - T(1)));
  const D Kd = T(P.K) * ((T(1) + (T(P.MU) * b1) / (T(2) * y_s))
                         + y_s / (T(4) * b1));
  const D Ad = w1 * b1;
  const D e = dmax(dlog(H0 / (H0 - y_s)), T(1e-12));
  const D e_dot = yd_s / (H0 - y_s);
  const D e_dot_s = dmax(e_dot, T(1e-30));
  return Kd * Ad * T(P.M0) * T(P.exp_m1t) * dpow(e, T(P.M2), T(P.M2_m1))
         * dpow(e_dot_s, T(P.M3), T(P.M3_m1)) * dexp(T(P.M4) / e);
}

// press._orifice: sqrt(2/RHO*|dp|)*sign(dp), linear below eps_q.
template <class T, int K>
FCT_HD Dual<T, K> orifice(const Dual<T, K>& dp, const PressParams& P) {
  typedef Dual<T, K> D;
  const D m = dabs(dp);
  const T s = T(P.s_orf);
  D mag;
  if (m.v <= T(P.eps_q)) {
    mag = (s * m) / T(P.lin_den);
  } else {
    mag = dsqrt(s * m);
  }
  return mag * t_sign(dp.v);
}

template <class T, int K>
FCT_HD void valve_flows(const Dual<T, K>& p1, const Dual<T, K>& p2,
                        const Dual<T, K>& z, const PressParams& P,
                        Dual<T, K>& qvPB, Dual<T, K>& qvAT) {
  const Dual<T, K> cz = T(P.coeff) * z;
  if (z.v >= T(0)) {
    qvPB = cz * orifice(T(P.PS) - p1, P);
    qvAT = cz * orifice(p2 - T(P.PT), P);
  } else {
    qvPB = cz * orifice(p1 - T(P.PT), P);
    qvAT = cz * orifice(T(P.PS) - p2, P);
  }
}

template <class T, int K>
FCT_HD Dual<T, K> friction(const Dual<T, K>& y_dot, const PressParams& P) {
  if (m_abs(y_dot.v) <= T(0.5)) return (T(P.FT) * y_dot) / T(0.5);
  return cst<T, K>(T(P.FT));
}

// press.rhs: dx/dt for x = [y, y_dot, p1, p2, z] and input u.
template <class T, int K>
FCT_HD void rhs(const Dual<T, K> x[5], const Dual<T, K>& u, int variant,
                const PressParams& P, Dual<T, K> dx[5]) {
  typedef Dual<T, K> D;
  const D& y = x[0];
  const D& y_dot = x[1];
  const D& z = x[4];
  const D p1e = effective_pressure(x[2], variant, P);
  const D p2e = effective_pressure(x[3], variant, P);
  const D Fd = forging_force(y, y_dot, P);
  const D Ft = friction(y_dot, P);
  D qvPB, qvAT;
  valve_flows(p1e, p2e, z, P, qvPB, qvAT);
  const D V1 = T(P.v1h) + T(P.A1) * y;
  const D V2 = T(P.v2h) - T(P.A2) * y;
  dx[0] = y_dot;
  dx[1] = (((((T(P.c_p1) * p1e) / T(4) - (T(P.c_p2) * p2e) / T(2))
             - T(P.B) * y_dot) - Ft) - Fd) / T(P.M) + T(P.G);
  dx[2] = (T(P.KB) / V1)
          * ((qvPB / T(3) - T(P.A1) * y_dot) - T(P.KL_1) * p1e);
  dx[3] = (T(P.KB) / V2)
          * ((-qvAT / T(2) + T(P.A2) * y_dot) - T(P.KL_2) * p2e);
  dx[4] = (-z + u) / T(P.T1);
}

// press.measure: the smooth variant measures the floored pressures.
template <class T, int K>
FCT_HD void measure(const Dual<T, K> x[5], int variant, const PressParams& P,
                    Dual<T, K> out[5]) {
  for (int i = 0; i < 5; ++i) out[i] = x[i];
  if (variant == SMOOTH) {
    out[2] = smooth_relu(x[2], P);
    out[3] = smooth_relu(x[3], P);
  }
}

// rk4.rk4_step over one control period dt in `substeps` steps; w (5 values
// or null) is the additive disturbance, added to every evaluation of rhs.
template <class T, int K>
FCT_HD void rk4_step(Dual<T, K> x[5], const Dual<T, K>& u, const T* w,
                     double dt, int substeps, int variant,
                     const PressParams& P) {
  typedef Dual<T, K> D;
  const double h = dt / substeps;
  const T hh = T(0.5 * h), hf = T(h), h6 = T(h / 6.0);
  // x + h6 * (((k1 + 2 k2) + 2 k3) + k4), summed into acc as each k comes,
  // in that order: one k live at a time, not four.
  D k[5], acc[5], xt[5];
  for (int s = 0; s < substeps; ++s) {
    rhs(x, u, variant, P, k);
    if (w) for (int i = 0; i < 5; ++i) k[i] = k[i] + w[i];
    for (int i = 0; i < 5; ++i) {
      acc[i] = k[i];
      xt[i] = x[i] + hh * k[i];
    }
    rhs(xt, u, variant, P, k);
    if (w) for (int i = 0; i < 5; ++i) k[i] = k[i] + w[i];
    for (int i = 0; i < 5; ++i) {
      acc[i] = acc[i] + T(2) * k[i];
      xt[i] = x[i] + hh * k[i];
    }
    rhs(xt, u, variant, P, k);
    if (w) for (int i = 0; i < 5; ++i) k[i] = k[i] + w[i];
    for (int i = 0; i < 5; ++i) {
      acc[i] = acc[i] + T(2) * k[i];
      xt[i] = x[i] + hf * k[i];
    }
    rhs(xt, u, variant, P, k);
    if (w) for (int i = 0; i < 5; ++i) k[i] = k[i] + w[i];
    for (int i = 0; i < 5; ++i) x[i] = x[i] + h6 * (acc[i] + k[i]);
  }
}

}  // namespace fct
