// The bodies of kernels K4 and K5 (bodies.cuh) on the CPU: the same C
// interface as csrc/plant.cu and csrc/ilqr.cu, without the stream, each
// scenario in turn (K4's team of four as arrays of its lanes' values, each
// step run in lane order; K5's team of G lanes one lane after another
// between its barriers, over a local buffer in place of shared memory), for
// the tests; and the same bodies on op_count.h's counting scalar
// (fct_plant_ops_*, fct_ilqr_ops_*), which give the operations that the
// kernels need for given inputs (chip_smoke.py's bounds).  Built with g++
// -O2 -ffp-contract=off (ops/build.py build_host) so that every multiply
// and add rounds on its own, as PyTorch's CPU kernels do; no path of the
// port calls it.
#include <algorithm>
#include <thread>
#include <vector>

#include "op_count.h"
#include "bodies.cuh"

namespace {

// K4's team of four on the CPU (bodies.cuh plant_team): one thread holds
// every lane's values, in lane order, and reads lane j's for a shuffle.
struct PlantSerial {
  static constexpr int kLanes = 4;
  int role(int k) const { return k; }
  template <class T>
  T get(const T (&v)[kLanes], int j) const {
    return v[j];
  }
};

// Whether the card's kernel takes this configuration (plant.cu launch).
inline bool plant_takes(const fct::PlantCfg* c, int B, int G) {
  return B >= 0 && c->substeps >= 1 && c->variant >= fct::RAW
         && c->variant <= fct::CLAMP && (G == 1 || G == 4);
}

template <class T, int V>
void plant_teams(const fct::PlantConsts<T>& C, const fct::PlantCfg* c,
                 const T* xt, const T* xm, const T* u, const T* w,
                 const T* v, T* xn, T* xmn, T* Fd, int lo, int hi) {
  for (int b = lo; b < hi; ++b)
    fct::plant_team<T, V>(C, *c, xt + 5 * b, xm + 5 * b, u[b],
                          w ? w + 5 * b : nullptr, v ? v + 5 * b : nullptr,
                          xn + 5 * b, xmn + 5 * b, Fd + b, true,
                          PlantSerial());
}

// Scenarios lo..hi-1 through K4's body for G (1: plant_body, one thread,
// from P; 4: plant_team, from consts, K4's constants (bodies.cuh
// PlantConsts) in F).
template <class T, class F>
void plant_scenarios(const fct::PressParams* P, const fct::PlantCfg* c,
                     const F* consts, const T* xt, const T* xm, const T* u,
                     const T* w, const T* v, T* xn, T* xmn, T* Fd, int G,
                     int lo, int hi) {
  if (G == 1) {
    for (int b = lo; b < hi; ++b)
      fct::plant_body<T>(*P, *c, xt + 5 * b, xm + 5 * b, u[b],
                         w ? w + 5 * b : nullptr, v ? v + 5 * b : nullptr,
                         xn + 5 * b, xmn + 5 * b, Fd + b);
    return;
  }
  const fct::PlantConsts<T> C = fct::plant_consts<T>(consts);
  switch (c->variant) {
    case fct::RAW:
      plant_teams<T, fct::RAW>(C, c, xt, xm, u, w, v, xn, xmn, Fd, lo, hi);
      break;
    case fct::SMOOTH:
      plant_teams<T, fct::SMOOTH>(C, c, xt, xm, u, w, v, xn, xmn, Fd, lo,
                                  hi);
      break;
    default:
      plant_teams<T, fct::CLAMP>(C, c, xt, xm, u, w, v, xn, xmn, Fd, lo, hi);
  }
}

template <class T>
int plant(const fct::PressParams* P, const fct::PlantCfg* c,
          const T* consts, const T* xt, const T* xm, const T* u, const T* w,
          const T* v, T* xn, T* xmn, T* Fd, int B, int G) {
  if (!plant_takes(c, B, G)) return 1;
  plant_scenarios<T>(P, c, consts, xt, xm, u, w, v, xn, xmn, Fd, G, 0, B);
  return 0;
}

// K5's team on the CPU: each(f) runs every lane in lane order, so a lane
// finds what the lanes before it wrote in the same phase, as no lane on the
// card may rely on; the tests cannot show a missing barrier (chip_smoke.py
// 3d runs the kernel under compute-sanitizer where the tool supports the
// card).
template <int G>
struct TeamSerial {
  template <class F> void each(F&& f) const {
    for (int lane = 0; lane < G; ++lane) f(lane);
  }
};

// Whether the card's kernel takes this configuration (ilqr.cu launch,
// less the teams a block holds, which the host has no use for).
template <class T>
bool ilqr_takes(const fct::IlqrCfg* c, int B, int G) {
  return B >= 0 && c->N >= 1
         && (long long)fct::ilqr_team_fields(c->N) * sizeof(T) <= 227 * 1024
         && (c->nc == 2 || c->nc == 4) && c->substeps >= 1
         && (G == 4 || G == 8 || G == 16 || G == 32);
}

// Scenarios lo..hi-1 by the team of G lanes, K tangents a unit; skip:
// ilqr_team's skip_repeats.
template <class T, int K>
void ilqr_scenarios(const fct::PressParams* P, const fct::IlqrCfg* c,
                    const fct::IlqrIO<T>& io, int G, int lo, int hi,
                    bool skip) {
  std::vector<T> sm(fct::ilqr_team_fields(c->N));
  for (int b = lo; b < hi; ++b) {
    std::fill(sm.begin(), sm.end(), T());
    T* s = sm.data();
    switch (G) {
      case 4:
        fct::ilqr_team<T, 4, K>(*P, *c, io, b, s, TeamSerial<4>(), skip);
        break;
      case 8:
        fct::ilqr_team<T, 8, K>(*P, *c, io, b, s, TeamSerial<8>(), skip);
        break;
      case 16:
        fct::ilqr_team<T, 16, K>(*P, *c, io, b, s, TeamSerial<16>(), skip);
        break;
      default:
        fct::ilqr_team<T, 32, K>(*P, *c, io, b, s, TeamSerial<32>(), skip);
    }
  }
}

template <class T>
int ilqr(const fct::PressParams* P, const fct::IlqrCfg* c, void* const* p,
         int B, int G, int teams) {
  if (!ilqr_takes<T>(c, B, G) || teams < 1) return 1;
  ilqr_scenarios<T, fct::kIlqrTangents>(P, c, fct::ilqr_io<T>(p), G, 0, B,
                                        true);
  return 0;
}

// fn(lo, hi) over [0, B) in `threads` contiguous chunks, one thread each;
// the per-thread operation counts summed into ops[kOpPhases] and, unless
// depth is null, the deepest result of each phase into depth[kOpPhases].
template <class Fn>
void counted_chunks(int B, int threads, unsigned long long* ops, Fn fn,
                    unsigned long long* depth = nullptr) {
  if (threads < 1) threads = 1;
  std::vector<std::thread> pool;
  std::vector<unsigned long long> sums(threads * fct::kOpPhases, 0),
      deepest(threads * fct::kOpPhases, 0);
  for (int t = 0; t < threads; ++t) {
    const int lo = (long long)B * t / threads;
    const int hi = (long long)B * (t + 1) / threads;
    pool.emplace_back([=, &sums, &deepest] {
      for (int p = 0; p < fct::kOpPhases; ++p)
        fct::op_counts[p] = fct::op_depths[p] = 0;
      fn(lo, hi);
      for (int p = 0; p < fct::kOpPhases; ++p) {
        sums[t * fct::kOpPhases + p] = fct::op_counts[p];
        deepest[t * fct::kOpPhases + p] = fct::op_depths[p];
      }
    });
  }
  for (auto& th : pool) th.join();
  for (int p = 0; p < fct::kOpPhases; ++p) {
    ops[p] = 0;
    if (depth) depth[p] = 0;
    for (int t = 0; t < threads; ++t) {
      ops[p] += sums[t * fct::kOpPhases + p];
      if (depth)
        depth[p] = std::max(depth[p], deepest[t * fct::kOpPhases + p]);
    }
  }
}

template <class F>
std::vector<fct::Counted<F>> counted_in(const F* a, long long n) {
  std::vector<fct::Counted<F>> out(a ? n : 0);
  for (long long i = 0; i < (long long)out.size(); ++i)
    out[i] = fct::Counted<F>::var(a[i]);
  return out;
}

template <class F>
void counted_out(const std::vector<fct::Counted<F>>& a, F* out) {
  if (!out) return;
  for (size_t i = 0; i < a.size(); ++i) out[i] = a[i].x;
}

// K4's body for G (1: plant_body, whose count is the function's; 4:
// plant_team, which computes both sides of every select and every lane's
// part) on counted
// scalars: the outputs as plant<F> gives them, the operations by phase (0:
// Fd, 1: RK4, 2: clip and measurement) and the deepest chain reached in
// each phase, over the scenarios.  A phase's depth runs from the inputs, so
// the RK4's is that of the state it ends with.
template <class F>
int plant_ops(const fct::PressParams* P, const fct::PlantCfg* c,
              const F* consts, const F* xt, const F* xm, const F* u,
              const F* w, const F* v, F* xn, F* xmn, F* Fd, int B, int G,
              int threads, unsigned long long* ops,
              unsigned long long* depth) {
  typedef fct::Counted<F> C;
  if (!plant_takes(c, B, G)) return 1;
  const auto cxt = counted_in(xt, 5LL * B), cxm = counted_in(xm, 5LL * B),
             cu = counted_in(u, B), cw = counted_in(w, 5LL * B),
             cv = counted_in(v, 5LL * B);
  std::vector<C> cxn(5LL * B), cxmn(5LL * B), cFd(B);
  counted_chunks(
      B, threads, ops,
      [&](int lo, int hi) {
        plant_scenarios<C>(P, c, consts, cxt.data(), cxm.data(), cu.data(),
                           w ? cw.data() : nullptr, v ? cv.data() : nullptr,
                           cxn.data(), cxmn.data(), cFd.data(), G, lo, hi);
      },
      depth);
  counted_out(cxn, xn);
  counted_out(cxmn, xmn);
  counted_out(cFd, Fd);
  return 0;
}

// K5's body on counted scalars: the outputs as ilqr<F> gives them, and
// the operations by phase (bodies.cuh ilqr_team: 0 the initial rollout,
// 1 the stages' RK4 with tangents, 2 the residuals and Gauss-Newton
// blocks, 3 the backward sweep, 4 the forward sweep, 5 the accept rule,
// the AL update and the diagnostics).  ops: the function's operations,
// each stage linearised in one unit of 7 tangents (K = 7: no value
// evaluated twice) and every iteration run; exec_ops, unless null: those
// the kernel runs (K = kIlqrTangents: each unit evaluates its stage's
// values anew; an iteration that repeats the last one skipped).  The
// partition over the team's lanes adds none.
template <class F>
int ilqr_ops(const fct::PressParams* P, const fct::IlqrCfg* c,
             void* const* p, int B, int G, int teams, int threads,
             unsigned long long* ops, unsigned long long* exec_ops) {
  typedef fct::Counted<F> C;
  if (!ilqr_takes<F>(c, B, G) || teams < 1) return 1;
  const long long N = c->N, nc = c->nc;
  const long long rows = (long long)c->al_iters * c->gn_iters * 6;
  const fct::IlqrIO<F> io = fct::ilqr_io<F>(p);
  const auto x0 = counted_in(io.x0, 5 * B), ref = counted_in(io.ref, B),
             up = counted_in(io.u_prev, B), v_in = counted_in(io.v_in, N * B),
             lam_in = counted_in(io.lam_in, N * nc * B);
  std::vector<C> u0(B), v(N * B), lam(N * nc * B), obj(B), inf_pr(B),
      inf_du(B), reg(B), d_norm(B), mu(B), alpha(B),
      trace(c->record_trace ? rows * B : 0),
      zc((long long)fct::ilqr_zc_fields(c->N) * B);
  fct::IlqrIO<C> cio;
  cio.x0 = x0.data();
  cio.ref = ref.data();
  cio.u_prev = up.data();
  cio.v_in = v_in.data();
  cio.lam_in = lam_in.data();
  cio.u0 = u0.data();
  cio.v = v.data();
  cio.lam = lam.data();
  cio.iters = io.iters;
  cio.obj = obj.data();
  cio.inf_pr = inf_pr.data();
  cio.inf_du = inf_du.data();
  cio.reg = reg.data();
  cio.d_norm = d_norm.data();
  cio.mu = mu.data();
  cio.alpha = alpha.data();
  cio.trace = trace.data();
  cio.zc = zc.data();
  if (exec_ops)
    counted_chunks(B, threads, exec_ops, [&](int lo, int hi) {
      ilqr_scenarios<C, fct::kIlqrTangents>(P, c, cio, G, lo, hi, true);
    });
  counted_chunks(B, threads, ops, [&](int lo, int hi) {
    ilqr_scenarios<C, 7>(P, c, cio, G, lo, hi, false);
  });
  counted_out(u0, io.u0);
  counted_out(v, io.v);
  counted_out(lam, io.lam);
  counted_out(obj, io.obj);
  counted_out(inf_pr, io.inf_pr);
  counted_out(inf_du, io.inf_du);
  counted_out(reg, io.reg);
  counted_out(d_norm, io.d_norm);
  counted_out(mu, io.mu);
  counted_out(alpha, io.alpha);
  counted_out(trace, io.trace);
  return 0;
}

}  // namespace

extern "C" int fct_op_phases() { return fct::kOpPhases; }

extern "C" int fct_plant_ops_f32(const fct::PressParams* P,
                                 const fct::PlantCfg* c, const float* consts,
                                 const float* xt,
                                 const float* xm, const float* u,
                                 const float* w, const float* v, float* xn,
                                 float* xmn, float* Fd, int B, int G,
                                 int threads, unsigned long long* ops,
                                 unsigned long long* depth) {
  return plant_ops<float>(P, c, consts, xt, xm, u, w, v, xn, xmn, Fd, B, G,
                          threads, ops, depth);
}

extern "C" int fct_plant_ops_f64(const fct::PressParams* P,
                                 const fct::PlantCfg* c, const double* consts,
                                 const double* xt,
                                 const double* xm, const double* u,
                                 const double* w, const double* v, double* xn,
                                 double* xmn, double* Fd, int B, int G,
                                 int threads, unsigned long long* ops,
                                 unsigned long long* depth) {
  return plant_ops<double>(P, c, consts, xt, xm, u, w, v, xn, xmn, Fd, B,
                           G, threads, ops, depth);
}

extern "C" int fct_ilqr_ops_f32(const fct::PressParams* P,
                                const fct::IlqrCfg* c, void* const* ptrs,
                                int B, int G, int teams, int threads,
                                unsigned long long* ops,
                                unsigned long long* exec_ops) {
  return ilqr_ops<float>(P, c, ptrs, B, G, teams, threads, ops, exec_ops);
}

extern "C" int fct_ilqr_ops_f64(const fct::PressParams* P,
                                const fct::IlqrCfg* c, void* const* ptrs,
                                int B, int G, int teams, int threads,
                                unsigned long long* ops,
                                unsigned long long* exec_ops) {
  return ilqr_ops<double>(P, c, ptrs, B, G, teams, threads, ops, exec_ops);
}

extern "C" int fct_ilqr_team_fields(int N) {
  return fct::ilqr_team_fields(N);
}

extern "C" int fct_ilqr_zc_fields(int N) { return fct::ilqr_zc_fields(N); }

extern "C" int fct_plant_f32(const fct::PressParams* P,
                             const fct::PlantCfg* c, const float* consts,
                             const float* xt,
                             const float* xm, const float* u, const float* w,
                             const float* v, float* xn, float* xmn, float* Fd,
                             int B, int G) {
  return plant<float>(P, c, consts, xt, xm, u, w, v, xn, xmn, Fd, B, G);
}

extern "C" int fct_plant_f64(const fct::PressParams* P,
                             const fct::PlantCfg* c, const double* consts,
                             const double* xt,
                             const double* xm, const double* u,
                             const double* w, const double* v, double* xn,
                             double* xmn, double* Fd, int B, int G) {
  return plant<double>(P, c, consts, xt, xm, u, w, v, xn, xmn, Fd, B, G);
}

extern "C" int fct_ilqr_f32(const fct::PressParams* P, const fct::IlqrCfg* c,
                            void* const* ptrs, int B, int G, int teams) {
  return ilqr<float>(P, c, ptrs, B, G, teams);
}

extern "C" int fct_ilqr_f64(const fct::PressParams* P, const fct::IlqrCfg* c,
                            void* const* ptrs, int B, int G, int teams) {
  return ilqr<double>(P, c, ptrs, B, G, teams);
}
