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
// Each value also carries its depth: the length of the longest chain of
// counted operations that leads to it from the inputs, one more than its
// deepest operand (a transcendental counts one, as in the count; what costs
// no operation passes its operand's depth on; inputs and constants are at
// 0).  A select (pick) waits for both sides, so its result has the depth of
// the deeper one; a C++ branch passes on only the side it takes.  The
// depth is what a schedule that overlaps every independent operation would
// still take one after another.
//
// Counts go to op_counts[op_phase] and the deepest result of each phase to
// op_depths[op_phase], per thread; FCT_PHASE(p) in a body marks where
// phase p begins.
#pragma once

#include <float.h>
#include <math.h>

#include <algorithm>
#include <type_traits>

#define FCT_PHASE(p) (::fct::op_phase = (p))

namespace fct {

constexpr int kOpPhases = 8;
inline thread_local unsigned long long op_counts[kOpPhases];
inline thread_local unsigned long long op_depths[kOpPhases];
inline thread_local int op_phase = 0;

enum OpKind : unsigned char { ZERO, UNIT, CONST, VAR };

template <class F>
struct Counted {
  F x;
  OpKind k;
  unsigned d;   // the depth

  Counted() : x(0), k(ZERO), d(0) {}
  template <class A,
            class = std::enable_if_t<std::is_arithmetic<A>::value>>
  Counted(A a) : x(static_cast<F>(a)), k(kind_of(static_cast<F>(a))), d(0) {}

  static OpKind kind_of(F v) {
    return v == F(0) ? ZERO : (v == F(1) || v == F(-1)) ? UNIT : CONST;
  }
  static Counted var(F v) {
    Counted c;
    c.x = v;
    c.k = VAR;
    return c;
  }
  // The result of an operation on a and b whose value is v: counted, VAR,
  // and one deeper than its deeper operand, where an operand is VAR;
  // otherwise a folded constant.
  static Counted op(F v, const Counted& a, const Counted& b) {
    Counted c;
    c.x = v;
    if (a.var() || b.var()) {
      c.k = VAR;
      c.d = 1 + std::max(a.d, b.d);
      ++op_counts[op_phase];
      op_depths[op_phase] = std::max<unsigned long long>(
          op_depths[op_phase], c.d);
    } else {
      c.k = kind_of(v);
    }
    return c;
  }
  static Counted op(F v, const Counted& a) { return op(v, a, a); }
  // A result that needs no arithmetic: of kind k, at the depth of the
  // operand `from` it passes on.
  static Counted free(F v, OpKind k, const Counted& from) {
    Counted c;
    c.x = v;
    c.k = k;
    c.d = k == VAR ? from.d : 0;
    return c;
  }
  bool var() const { return k == VAR; }
};

template <class F>
inline Counted<F> operator+(const Counted<F>& a, const Counted<F>& b) {
  const F v = a.x + b.x;
  if (a.k == ZERO) return Counted<F>::free(v, b.k, b);
  if (b.k == ZERO) return Counted<F>::free(v, a.k, a);
  return Counted<F>::op(v, a, b);
}
template <class F>
inline Counted<F> operator-(const Counted<F>& a) {
  const F v = -a.x;
  return a.var() ? Counted<F>::free(v, VAR, a)
                 : Counted<F>::free(v, Counted<F>::kind_of(v), a);
}
template <class F>
inline Counted<F> operator-(const Counted<F>& a, const Counted<F>& b) {
  const F v = a.x - b.x;
  if (b.k == ZERO) return Counted<F>::free(v, a.k, a);
  if (a.k == ZERO) return Counted<F>::free(v, b.var() ? VAR : b.k, b);
  return Counted<F>::op(v, a, b);
}
template <class F>
inline Counted<F> operator*(const Counted<F>& a, const Counted<F>& b) {
  const F v = a.x * b.x;
  if (a.k == ZERO || b.k == ZERO) return Counted<F>::free(v, ZERO, a);
  if (a.k == UNIT) return Counted<F>::free(v, b.k, b);
  if (b.k == UNIT) return Counted<F>::free(v, a.k, a);
  return Counted<F>::op(v, a, b);
}
template <class F>
inline Counted<F> operator/(const Counted<F>& a, const Counted<F>& b) {
  const F v = a.x / b.x;
  if (a.k == ZERO) return Counted<F>::free(v, ZERO, a);
  if (b.k == UNIT) return Counted<F>::free(v, a.k, a);
  return Counted<F>::op(v, a, b);
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
  return Counted<F>::op(c_sqrt(a.x), a);
}
template <class F> inline Counted<F> m_exp(const Counted<F>& a) {
  return Counted<F>::op(c_exp(a.x), a);
}
template <class F> inline Counted<F> m_log(const Counted<F>& a) {
  return Counted<F>::op(c_log(a.x), a);
}
template <class F>
inline Counted<F> m_pow(const Counted<F>& a, const Counted<F>& c) {
  return Counted<F>::op(c_pow(a.x, c.x), a, c);
}
template <class F> inline Counted<F> m_abs(const Counted<F>& a) {
  return Counted<F>::op(c_abs(a.x), a);
}
// torch.maximum / torch.minimum: NaN propagates.
template <class F>
inline Counted<F> t_max(const Counted<F>& a, const Counted<F>& b) {
  const Counted<F>& r =
      a.x != a.x ? a : (b.x != b.x ? b : (a.x > b.x ? a : b));
  return Counted<F>::op(r.x, a, b);
}
template <class F>
inline Counted<F> t_min(const Counted<F>& a, const Counted<F>& b) {
  const Counted<F>& r =
      a.x != a.x ? a : (b.x != b.x ? b : (a.x < b.x ? a : b));
  return Counted<F>::op(r.x, a, b);
}
// A select that waits for both sides (bodies.cuh pick): costs nothing, and
// is a value that depends on the inputs, as deep as the deeper side, where
// either side is one (the card computes both and keeps one).
template <class F>
inline Counted<F> pick(bool c, const Counted<F>& a, const Counted<F>& b) {
  Counted<F> r = c ? a : b;
  if (a.var() || b.var()) {
    r.k = VAR;
    r.d = std::max(a.d, b.d);
  }
  return r;
}
template <class F> inline Counted<F> max_finite(const Counted<F>&) {
  return Counted<F>(std::is_same<F, float>::value ? double(FLT_MAX)
                                                  : DBL_MAX);
}

}  // namespace fct
