// The operations that the bodies of kernels K4 and K5 (bodies.cuh) need for
// given inputs, counted on the CPU: the bodies run on a scalar type,
// Counted<F>, that does the arithmetic of F and counts it.  For the
// operations bound of each kernel (chip_smoke.py), through csrc/
// host_bodies.cpp; no path of the port uses it.
//
// What counts.  A value is a structural zero (ZERO), a constant of
// magnitude one (UNIT), another constant (CONST) or a value that depends on
// the inputs (VAR).  Literals and configuration numbers are constants by
// value; every input is VAR, even where its value happens to be 0.  An
// add, subtract, multiply, divide, square root, exp, log, pow, abs,
// minimum or maximum counts one operation, unless its result needs no
// arithmetic:
//   x + 0, 0 + x, x - 0 and 0 - x (a negation), 0 * x, x * 0, 0 / x,
//   x * (+-1), x / (+-1), a negation, and any operation on constants only
//   (the compiler folds it);
// so the tangents that are structurally zero (those of a constant, the
// seeds' zeros, the masked residual rows of stage 0) and the first add into
// a zeroed accumulator cost nothing.  A comparison, a select and
// nan_to_num cost nothing.  Branches are C++ branches: a branch not taken
// (the forging force's gate, the orifice's other side, the friction's
// other regime) costs nothing.  A transcendental counts one, as an add
// does, so the count is a lower bound of the work at the card's float32
// rate.  Every value is computed in F in the same order as the plain host
// build, so the outputs are bit for bit those of fct_ilqr_f64 and the
// others.
//
// Counts go to op_counts[op_phase], per thread; FCT_PHASE(p) in a body
// marks where phase p begins.
#pragma once

#include <float.h>
#include <math.h>

#include <type_traits>

#define FCT_PHASE(p) (::fct::op_phase = (p))

namespace fct {

constexpr int kOpPhases = 8;
inline thread_local unsigned long long op_counts[kOpPhases];
inline thread_local int op_phase = 0;

enum OpKind : unsigned char { ZERO, UNIT, CONST, VAR };

template <class F>
struct Counted {
  F x;
  OpKind k;

  Counted() : x(0), k(ZERO) {}
  template <class A,
            class = std::enable_if_t<std::is_arithmetic<A>::value>>
  Counted(A a) : x(static_cast<F>(a)), k(kind_of(static_cast<F>(a))) {}

  static OpKind kind_of(F v) {
    return v == F(0) ? ZERO : (v == F(1) || v == F(-1)) ? UNIT : CONST;
  }
  static Counted var(F v) {
    Counted c;
    c.x = v;
    c.k = VAR;
    return c;
  }
  // The result of an operation whose value is v: counted, and VAR, where
  // an operand is VAR; otherwise a folded constant.
  static Counted op(F v, bool var) {
    Counted c;
    c.x = v;
    if (var) {
      c.k = VAR;
      ++op_counts[op_phase];
    } else {
      c.k = kind_of(v);
    }
    return c;
  }
  static Counted free(F v, OpKind k) {
    Counted c;
    c.x = v;
    c.k = k;
    return c;
  }
  bool var() const { return k == VAR; }
};

template <class F>
inline Counted<F> operator+(const Counted<F>& a, const Counted<F>& b) {
  const F v = a.x + b.x;
  if (a.k == ZERO) return Counted<F>::free(v, b.k);
  if (b.k == ZERO) return Counted<F>::free(v, a.k);
  return Counted<F>::op(v, a.var() || b.var());
}
template <class F>
inline Counted<F> operator-(const Counted<F>& a) {
  const F v = -a.x;
  return a.var() ? Counted<F>::free(v, VAR)
                 : Counted<F>::free(v, Counted<F>::kind_of(v));
}
template <class F>
inline Counted<F> operator-(const Counted<F>& a, const Counted<F>& b) {
  const F v = a.x - b.x;
  if (b.k == ZERO) return Counted<F>::free(v, a.k);
  if (a.k == ZERO) return Counted<F>::free(v, b.var() ? VAR : b.k);
  return Counted<F>::op(v, a.var() || b.var());
}
template <class F>
inline Counted<F> operator*(const Counted<F>& a, const Counted<F>& b) {
  const F v = a.x * b.x;
  if (a.k == ZERO || b.k == ZERO) return Counted<F>::free(v, ZERO);
  if (a.k == UNIT) return Counted<F>::free(v, b.k);
  if (b.k == UNIT) return Counted<F>::free(v, a.k);
  return Counted<F>::op(v, a.var() || b.var());
}
template <class F>
inline Counted<F> operator/(const Counted<F>& a, const Counted<F>& b) {
  const F v = a.x / b.x;
  if (a.k == ZERO) return Counted<F>::free(v, ZERO);
  if (b.k == UNIT) return Counted<F>::free(v, a.k);
  return Counted<F>::op(v, a.var() || b.var());
}

template <class F>
inline bool operator<(const Counted<F>& a, const Counted<F>& b) {
  return a.x < b.x;
}
template <class F>
inline bool operator>(const Counted<F>& a, const Counted<F>& b) {
  return a.x > b.x;
}
template <class F>
inline bool operator<=(const Counted<F>& a, const Counted<F>& b) {
  return a.x <= b.x;
}
template <class F>
inline bool operator>=(const Counted<F>& a, const Counted<F>& b) {
  return a.x >= b.x;
}
template <class F>
inline bool operator==(const Counted<F>& a, const Counted<F>& b) {
  return a.x == b.x;
}
template <class F>
inline bool operator!=(const Counted<F>& a, const Counted<F>& b) {
  return a.x != b.x;
}

inline float c_sqrt(float x) { return sqrtf(x); }
inline double c_sqrt(double x) { return sqrt(x); }
inline float c_exp(float x) { return expf(x); }
inline double c_exp(double x) { return exp(x); }
inline float c_log(float x) { return logf(x); }
inline double c_log(double x) { return log(x); }
inline float c_pow(float x, float c) { return powf(x, c); }
inline double c_pow(double x, double c) { return pow(x, c); }
inline float c_abs(float x) { return fabsf(x); }
inline double c_abs(double x) { return fabs(x); }

template <class F> inline Counted<F> m_sqrt(const Counted<F>& a) {
  return Counted<F>::op(c_sqrt(a.x), a.var());
}
template <class F> inline Counted<F> m_exp(const Counted<F>& a) {
  return Counted<F>::op(c_exp(a.x), a.var());
}
template <class F> inline Counted<F> m_log(const Counted<F>& a) {
  return Counted<F>::op(c_log(a.x), a.var());
}
template <class F>
inline Counted<F> m_pow(const Counted<F>& a, const Counted<F>& c) {
  return Counted<F>::op(c_pow(a.x, c.x), a.var() || c.var());
}
template <class F> inline Counted<F> m_abs(const Counted<F>& a) {
  return Counted<F>::op(c_abs(a.x), a.var());
}
// torch.maximum / torch.minimum: NaN propagates.
template <class F>
inline Counted<F> t_max(const Counted<F>& a, const Counted<F>& b) {
  const Counted<F>& r =
      a.x != a.x ? a : (b.x != b.x ? b : (a.x > b.x ? a : b));
  return Counted<F>::op(r.x, a.var() || b.var());
}
template <class F>
inline Counted<F> t_min(const Counted<F>& a, const Counted<F>& b) {
  const Counted<F>& r =
      a.x != a.x ? a : (b.x != b.x ? b : (a.x < b.x ? a : b));
  return Counted<F>::op(r.x, a.var() || b.var());
}
template <class F> inline Counted<F> max_finite(const Counted<F>&) {
  return Counted<F>(std::is_same<F, float>::value ? double(FLT_MAX)
                                                  : DBL_MAX);
}

}  // namespace fct
