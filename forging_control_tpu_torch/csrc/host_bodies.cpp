// The bodies of kernels K4 and K5 (bodies.cuh) and of the SQP's build and
// search (sqp_bodies.cuh) on the CPU: the same C interface as csrc/plant.cu,
// csrc/ilqr.cu, csrc/sqp_build.cu and csrc/sqp_search.cu, without the
// stream (and the teams a block holds), each scenario in turn (K4's team of
// four as arrays of its lanes' values, each step run in lane order; the
// other teams' lanes one after another between their barriers, over a local
// buffer in place of shared memory), for the tests; and the same bodies on
// op_count.h's counting scalar (fct_plant_ops_*, fct_ilqr_ops_*,
// fct_sqp_build_ops_*, fct_sqp_search_ops_*), which give the operations
// that the kernels need for given inputs (chip_smoke.py's bounds).  Built with g++
// -O2 -ffp-contract=off (ops/build.py build_host) so that every multiply
// and add rounds on its own, as PyTorch's CPU kernels do; no path of the
// port calls it.
#include <algorithm>
#include <thread>
#include <vector>

#include "op_count.h"
#include "bodies.cuh"
#include "sqp_bodies.cuh"

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
  // The quads of four lanes in turn, each as K4's team on the CPU.
  template <class F> void quads(F&& f) const {
    for (int q = 0; q < G / 4; ++q) f(q, PlantSerial());
  }
};

// Whether the card's kernel takes this configuration (ilqr.cu launch,
// less the teams a block holds, which the host has no use for).
template <class T>
bool ilqr_takes(const fct::IlqrCfg* c, int B, int G) {
  return B >= 0 && c->N >= 1
         && (long long)fct::ilqr_team_fields(c->N) * sizeof(T)
                <= fct::kIlqrSharedBytes
         && (c->nc == 2 || c->nc == 4) && c->substeps >= 1
         && (G == 8 || G == 16 || G == 32);
}

// Scenarios lo..hi-1 by the team of G lanes, K tangents a unit, K4's
// constants from consts (in F); skip and sweeps: ilqr_team's skip_repeats
// and sweeps.
template <class T, int K, class F>
void ilqr_scenarios(const fct::PressParams* P, const fct::IlqrCfg* c,
                    const F* consts, const fct::IlqrIO<T>& io, int G, int lo,
                    int hi, bool skip, unsigned* sweeps = nullptr) {
  const fct::PlantConsts<T> C = fct::plant_consts<T>(consts);
  std::vector<T> sm(fct::ilqr_team_fields(c->N));
  for (int b = lo; b < hi; ++b) {
    std::fill(sm.begin(), sm.end(), T());
    T* s = sm.data();
    switch (G) {
      case 8:
        fct::ilqr_team<T, 8, K>(*P, C, *c, io, b, s, TeamSerial<8>(), skip,
                                sweeps);
        break;
      case 16:
        fct::ilqr_team<T, 16, K>(*P, C, *c, io, b, s, TeamSerial<16>(),
                                 skip, sweeps);
        break;
      default:
        fct::ilqr_team<T, 32, K>(*P, C, *c, io, b, s, TeamSerial<32>(),
                                 skip, sweeps);
    }
  }
}

// K5's sweeps per AL round on the CPU, as csrc/ilqr.cu g_sweeps counts
// them on the card: a launch's sums added once at its end.
unsigned long long g_sweeps[fct::kSweepRounds] = {};

template <class T>
int ilqr(const fct::PressParams* P, const fct::IlqrCfg* c, const T* consts,
         void* const* p, int B, int G, int teams) {
  if (!ilqr_takes<T>(c, B, G) || teams < 1) return 1;
  unsigned sweeps[fct::kSweepRounds] = {};
  ilqr_scenarios<T, fct::kIlqrTangents>(P, c, consts, fct::ilqr_io<T>(p), G,
                                        0, B, true, sweeps);
  for (int r = 0; r < fct::kSweepRounds; ++r) g_sweeps[r] += sweeps[r];
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
// evaluated twice), every iteration run and each rollout's stage on one
// lane (aug_step, the team of kFunctionTeam lanes, whatever G is); exec_ops,
// unless null: those the kernel runs with G lanes (K = kIlqrTangents: each
// unit evaluates its stage's values anew; an iteration that repeats the
// last one skipped; at G >= 16 the rollouts' rhs_four, both sides of each
// select and every lane of every quad).  The partition of the one-lane
// rollouts over the team's lanes adds none.
constexpr int kFunctionTeam = 8;

template <class F>
int ilqr_ops(const fct::PressParams* P, const fct::IlqrCfg* c,
             const F* consts, void* const* p, int B, int G, int teams,
             int threads, unsigned long long* ops,
             unsigned long long* exec_ops) {
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
      ilqr_scenarios<C, fct::kIlqrTangents>(P, c, consts, cio, G, lo, hi,
                                            true);
    });
  counted_chunks(B, threads, ops, [&](int lo, int hi) {
    ilqr_scenarios<C, 7>(P, c, consts, cio, kFunctionTeam, lo, hi, false);
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

// A team of G lanes, G known at run time (the SQP's build and search), on
// the CPU: each(f) runs every lane in lane order.
struct TeamSerialN {
  int G;
  template <class F> void each(F&& f) const {
    for (int lane = 0; lane < G; ++lane) f(lane);
  }
};

// Whether the card's kernels take this configuration (sqp_build.cu and
// sqp_search.cu launch, less the teams a block holds).
inline bool sqp_takes(const fct::SqpCfg* c, int B, int G, bool build) {
  return B >= 0 && c->N >= 1 && c->N <= 32 && (c->nc == 2 || c->nc == 4)
         && c->substeps >= 1 && c->n_lad >= 0
         && c->n_lad + 2 <= fct::kSqpMaxCand && G <= 32
         && G >= (build ? c->N : 1);
}

// The build of scenarios lo..hi-1 by teams of G lanes, K input directions
// a lane (the kernel's K = 1; the operation count's function takes one lane
// with every direction).
template <class T, int K>
void sqp_build_scenarios(const fct::PressParams* P, const fct::SqpCfg* c,
                         const fct::SqpIO<T>& io, int G, int al, int row,
                         int lo, int hi) {
  std::vector<T> sm(fct::sqp_build_fields(c->N, c->nc));
  for (int b = lo; b < hi; ++b) {
    std::fill(sm.begin(), sm.end(), T());
    fct::sqp_build_team<T, K>(*P, *c, al, row, io, b, sm.data(),
                              TeamSerialN{G}, G);
  }
}

template <class T>
void sqp_search_scenarios(const fct::PressParams* P, const fct::SqpCfg* c,
                          const fct::SqpIO<T>& io, int G, int al, int row,
                          int flags, int lo, int hi) {
  std::vector<T> sm(fct::sqp_search_fields(c->n_lad + 2));
  for (int b = lo; b < hi; ++b) {
    std::fill(sm.begin(), sm.end(), T());
    fct::sqp_search_team<T>(*P, *c, al, row, flags, io, b, sm.data(),
                            TeamSerialN{G}, G);
  }
}

// Values of each of the launch's 22 arrays (fct::SqpIO order) at B
// scenarios; iters (12) is an int array.
inline std::vector<long long> sqp_sizes(const fct::SqpCfg* c, int B) {
  const long long N = c->N, ncon = (long long)c->nc * N;
  const long long n_cand = c->n_lad + 2;
  std::vector<long long> n = {5, 1, 1, N, ncon, N, ncon, 3 * N * N, 3 * N,
                              3 * N, 4 + ncon, n_cand * ncon, 1, 1, 1, 1,
                              (long long)c->trace_rows * 6, 1, 1, 1, 1, 1};
  for (auto& x : n) x *= B;
  return n;
}

// An SqpIO of counted scalars over copies of the launch's arrays, every
// value an input (VAR); arrays that share a pointer share a copy.
template <class F>
struct CountedSqp {
  std::vector<std::vector<fct::Counted<F>>> bufs;
  std::vector<int> slot;
  fct::SqpIO<fct::Counted<F>> io;
  void* const* p;

  CountedSqp(const fct::SqpCfg* c, void* const* ptrs, int B) : p(ptrs) {
    const auto n = sqp_sizes(c, B);
    slot.assign(fct::kSqpPointers, -1);
    void* cp[fct::kSqpPointers];
    for (int i = 0; i < fct::kSqpPointers; ++i) {
      cp[i] = nullptr;
      if (!p[i]) continue;
      if (i == 12) {
        cp[i] = p[i];
        continue;
      }
      for (int j = 0; j < i; ++j)
        if (p[j] == p[i] && slot[j] >= 0) slot[i] = slot[j];
      if (slot[i] < 0) {
        slot[i] = (int)bufs.size();
        bufs.push_back(counted_in(static_cast<const F*>(p[i]), n[i]));
      }
      cp[i] = bufs[slot[i]].data();
    }
    io = fct::sqp_io<fct::Counted<F>>(cp);
  }
  // The values back into the launch's arrays.
  void out() const {
    for (int i = 0; i < fct::kSqpPointers; ++i)
      if (slot[i] >= 0) counted_out(bufs[slot[i]], static_cast<F*>(p[i]));
  }
};

// The build's body on counted scalars: the outputs as fct_sqp_build_<F>
// gives them and the operations by phase (sqp_bodies.cuh: 0 the rollout,
// 1 the residual rows and their sums, 2 g, H and the damped systems, 3 the
// cost, |g|_inf, the objective and the trace).  ops: what the kernel runs,
// a direction a lane, every lane its own values; fn_ops, unless null:
// the function's, one lane with every direction (K = kSqpCountTangents:
// the values and what the tangent rules derive from them once, as
// dual.linearize's single dual of N directions); val_ops, unless null: one
// lane's values alone (sqp_build_lane at K = 0, without lane 0's sums),
// what each further lane computes again.
constexpr int kSqpCountTangents = 32;

template <class F>
int sqp_build_ops(const fct::PressParams* P, const fct::SqpCfg* c,
                  void* const* p, int B, int G, int al, int row,
                  int threads, unsigned long long* ops,
                  unsigned long long* fn_ops, unsigned long long* val_ops) {
  typedef fct::Counted<F> C;
  if (!sqp_takes(c, B, G, true)) return 1;
  CountedSqp<F> cs(c, p, B);
  counted_chunks(B, threads, ops, [&](int lo, int hi) {
    sqp_build_scenarios<C, 1>(P, c, cs.io, G, al, row, lo, hi);
  });
  if (fn_ops) {
    CountedSqp<F> again(c, p, B);
    counted_chunks(B, threads, fn_ops, [&](int lo, int hi) {
      sqp_build_scenarios<C, kSqpCountTangents>(P, c, again.io, 1, al, row,
                                                lo, hi);
    });
  }
  if (val_ops) {
    const int N = c->N;
    CountedSqp<F> again(c, p, B);
    counted_chunks(B, threads, val_ops, [&](int lo, int hi) {
      const C mu = fct::sqp_mu<C>(*c, al);
      const C sq = fct::m_sqrt(mu / C(2));
      C dummy;
      for (int b = lo; b < hi; ++b)
        fct::sqp_build_lane<C, 0>(
            *P, *c, mu, sq, again.io.x0 + 5LL * b, again.io.ref[b],
            again.io.u_prev[b], again.io.v_in + (long long)b * N,
            again.io.lam_in + (long long)b * N * c->nc, 1, &dummy, 0,
            &dummy, &dummy, static_cast<fct::SqpSums<C>*>(nullptr));
    });
  }
  cs.out();
  return 0;
}

// The search's body on counted scalars: the outputs as fct_sqp_search_<F>
// gives them and the operations by phase (0 the candidates' steps, 1 their
// rollouts, 2 their residuals and costs, 3 the accept rule, the AL update
// and the diagnostics): what the kernel runs, which is the function's (each
// candidate on one lane).
template <class F>
int sqp_search_ops(const fct::PressParams* P, const fct::SqpCfg* c,
                   void* const* p, int B, int G, int al, int row, int flags,
                   int threads, unsigned long long* ops) {
  typedef fct::Counted<F> C;
  if (!sqp_takes(c, B, G, false)) return 1;
  CountedSqp<F> cs(c, p, B);
  counted_chunks(B, threads, ops, [&](int lo, int hi) {
    sqp_search_scenarios<C>(P, c, cs.io, G, al, row, flags, lo, hi);
  });
  cs.out();
  return 0;
}

}  // namespace

extern "C" int fct_sqp_build_f32(const fct::PressParams* P,
                                 const fct::SqpCfg* c, void* const* ptrs,
                                 int B, int G, int teams, int al, int row) {
  if (!sqp_takes(c, B, G, true) || teams < 1) return 1;
  sqp_build_scenarios<float, 1>(P, c, fct::sqp_io<float>(ptrs), G, al, row,
                                0, B);
  return 0;
}

extern "C" int fct_sqp_build_f64(const fct::PressParams* P,
                                 const fct::SqpCfg* c, void* const* ptrs,
                                 int B, int G, int teams, int al, int row) {
  if (!sqp_takes(c, B, G, true) || teams < 1) return 1;
  sqp_build_scenarios<double, 1>(P, c, fct::sqp_io<double>(ptrs), G, al,
                                 row, 0, B);
  return 0;
}

extern "C" int fct_sqp_search_f32(const fct::PressParams* P,
                                  const fct::SqpCfg* c, void* const* ptrs,
                                  int B, int G, int teams, int al, int row,
                                  int flags) {
  if (!sqp_takes(c, B, G, false) || teams < 1) return 1;
  sqp_search_scenarios<float>(P, c, fct::sqp_io<float>(ptrs), G, al, row,
                              flags, 0, B);
  return 0;
}

extern "C" int fct_sqp_search_f64(const fct::PressParams* P,
                                  const fct::SqpCfg* c, void* const* ptrs,
                                  int B, int G, int teams, int al, int row,
                                  int flags) {
  if (!sqp_takes(c, B, G, false) || teams < 1) return 1;
  sqp_search_scenarios<double>(P, c, fct::sqp_io<double>(ptrs), G, al, row,
                               flags, 0, B);
  return 0;
}

extern "C" int fct_sqp_build_ops_f32(const fct::PressParams* P,
                                     const fct::SqpCfg* c, void* const* ptrs,
                                     int B, int G, int teams, int al, int row,
                                     int threads,
                                     unsigned long long* ops,
                                     unsigned long long* fn_ops,
                                     unsigned long long* val_ops) {
  (void)teams;
  return sqp_build_ops<float>(P, c, ptrs, B, G, al, row, threads, ops,
                              fn_ops, val_ops);
}

extern "C" int fct_sqp_build_ops_f64(const fct::PressParams* P,
                                     const fct::SqpCfg* c, void* const* ptrs,
                                     int B, int G, int teams, int al, int row,
                                     int threads,
                                     unsigned long long* ops,
                                     unsigned long long* fn_ops,
                                     unsigned long long* val_ops) {
  (void)teams;
  return sqp_build_ops<double>(P, c, ptrs, B, G, al, row, threads, ops,
                               fn_ops, val_ops);
}

extern "C" int fct_sqp_search_ops_f32(const fct::PressParams* P,
                                      const fct::SqpCfg* c,
                                      void* const* ptrs, int B, int G,
                                      int teams, int al, int row, int flags,
                                      int threads, unsigned long long* ops) {
  (void)teams;
  return sqp_search_ops<float>(P, c, ptrs, B, G, al, row, flags, threads,
                               ops);
}

extern "C" int fct_sqp_search_ops_f64(const fct::PressParams* P,
                                      const fct::SqpCfg* c,
                                      void* const* ptrs, int B, int G,
                                      int teams, int al, int row, int flags,
                                      int threads, unsigned long long* ops) {
  (void)teams;
  return sqp_search_ops<double>(P, c, ptrs, B, G, al, row, flags, threads,
                                ops);
}

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
                                const fct::IlqrCfg* c, const float* consts,
                                void* const* ptrs, int B, int G, int teams,
                                int threads, unsigned long long* ops,
                                unsigned long long* exec_ops) {
  return ilqr_ops<float>(P, c, consts, ptrs, B, G, teams, threads, ops,
                         exec_ops);
}

extern "C" int fct_ilqr_ops_f64(const fct::PressParams* P,
                                const fct::IlqrCfg* c, const double* consts,
                                void* const* ptrs, int B, int G, int teams,
                                int threads, unsigned long long* ops,
                                unsigned long long* exec_ops) {
  return ilqr_ops<double>(P, c, consts, ptrs, B, G, teams, threads, ops,
                          exec_ops);
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
                            const float* consts, void* const* ptrs, int B,
                            int G, int teams) {
  return ilqr<float>(P, c, consts, ptrs, B, G, teams);
}

extern "C" int fct_ilqr_f64(const fct::PressParams* P, const fct::IlqrCfg* c,
                            const double* consts, void* const* ptrs, int B,
                            int G, int teams) {
  return ilqr<double>(P, c, consts, ptrs, B, G, teams);
}

// csrc/ilqr.cu's fct_ilqr_sweeps for the host build's launches.
extern "C" int fct_ilqr_sweeps(unsigned long long* out, int reset) {
  std::copy(g_sweeps, g_sweeps + fct::kSweepRounds, out);
  if (reset) std::fill(g_sweeps, g_sweeps + fct::kSweepRounds, 0ULL);
  return 0;
}
