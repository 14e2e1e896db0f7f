// Per-scenario bodies of the condensed GN-SQP's two kernels (csrc/
// sqp_build.cu, csrc/sqp_search.cu): one Gauss-Newton iteration of
// solver/sqp.py solve_batch is the build, kernel B1 on the damped systems
// the build writes, then the line search.  On the device physics of
// press_dual.cuh; csrc/host_bodies.cpp runs the same bodies on the CPU for
// the tests (g++).
//
// The build (sqp_build_team), at the incoming iterate v: the horizon rolled
// out with the N input directions as forward tangents, K a lane (the
// kernel's K = 1: lane i carries direction i as a one-tangent dual and
// recomputes the values, so the serial chain needs no other lane's help;
// the operation count's function is one lane with every direction); the
// stacked residuals
//   r = [y_dot - ref (N), sqrt(rterm) du (N),
//        sqrt(mu / 2) max(lam / mu - c, 0) (nc N, type-major)];
// column i of their Jacobian J into the team's shared memory; then
// g = J^T r (an entry a lane), H = J^T J (an entry of the upper triangle a
// lane, in turn), the three damped systems (H + reg_m I, g) written
// straight into B1's (B, 3, N, N) and (B, 3, N) inputs; cost0 = 0.5 |r|^2,
// the largest |g_i| and the incoming iterate's objective, infeasibility and
// constraint values into the scenario's work row for the search.
//
// The search (sqp_search_team), from B1's solutions x (the steps are -x):
// the n_lad + 2 candidates (the ladder along the first damping's step, then
// the other two at 1), each rolled out on its own lane, its cost summed as
// the build sums cost0; the first-minimum argmin (a NaN counts as the
// minimum, as torch.argmin takes it), the accept rule cost < cost0 and not
// converged, the new iterate and the diagnostics.  On an AL round's last
// iteration it updates the multipliers from the accepted iterate's
// constraint values (the winning candidate's, or the build's where nothing
// was taken) and, after the last round, writes the objective, the
// infeasibility, mu and u0: no rollout is left to tensor code.
//
// Sums.  Every sum runs in one fixed order: g_i and H_ij over the residual
// rows in row order; a cost over each block of rows in stage order
// (tracking, increments, then each constraint type), the blocks added in
// that order, cost = 0.5 (((track + du) + con_0) + con_1 ...); the build and
// the search use the same order, so a candidate equal to the iterate costs
// exactly cost0.  PyTorch's reductions sum in their own orders, so the
// kernels agree with the plain solve to rounding.
//
// Team: the lanes of a team talk only through the team's slice of shared
// memory and, within the search, through the scenario's rows in device
// memory, between the team's barriers (TeamLanes on the card, a serial loop
// over the lanes on the CPU).  A team has G lanes, any G from ceil(N / K)
// (build) or 1 (search) to 32, inside one warp.
#pragma once

#include "bodies.cuh"

namespace fct {

// Line-search candidates a configuration may have: n_lad + 2.
constexpr int kSqpMaxCand = 64;

struct SqpCfg {
  double dt;
  int substeps;
  int variant;
  int N, nc, n_lad, trace_rows;  // nc: constraint types a stage (2 or 4)
  double sqrt_rterm, rterm;      // math.sqrt(rterm), rterm
  double p_scale, p_lo, p_hi;    // _P_SCALE, p_min / _P_SCALE, p_max / ...
  double mu0, mu_factor, tol_grad, lm_reg, u_scale;
  double regs[3];                // sqp._damping: lm_reg, + 1e-2, + 1.0
  double alphas[kSqpMaxCand];    // the ladder, then 1.0, 1.0
};

// What one launch does besides its body: the AL round (its mu), the trace
// row (-1: none) and the flags below.
enum SqpFlags {
  kSqpFirst = 1,      // the solve's first search: the counters start at 0
  kSqpStep = 2,       // a Gauss-Newton iteration (else the AL update alone)
  kSqpRoundEnd = 4,   // the round's last: the multipliers' update
  kSqpLast = 8,       // the solve's last: obj, inf_pr, mu, reg and u0
};

// The pointers of a launch, in the order of the C interface's array.
// v_out and lam_out may be v_in and lam_in.
template <class T>
struct SqpIO {
  const T *x0, *ref, *u_prev, *v_in, *lam_in;
  T *v_out, *lam_out;
  T *H, *g;         // B1's systems, (B, 3, N, N) and (B, 3, N)
  const T* x;       // B1's solutions, (B, 3, N)
  T* work;          // (B, 4 + nc N): cost0, |g|_inf, obj, inf_pr, c(v)
  T* cs;            // (B, n_lad + 2, nc N): the candidates' c
  int* iters;
  T *d_norm, *alpha, *inf_du, *trace, *u0, *obj, *inf_pr, *mu, *reg;
};
constexpr int kSqpPointers = 22;

template <class T>
inline SqpIO<T> sqp_io(void* const* p) {
  SqpIO<T> io;
  io.x0 = static_cast<const T*>(p[0]);
  io.ref = static_cast<const T*>(p[1]);
  io.u_prev = static_cast<const T*>(p[2]);
  io.v_in = static_cast<const T*>(p[3]);
  io.lam_in = static_cast<const T*>(p[4]);
  io.v_out = static_cast<T*>(p[5]);
  io.lam_out = static_cast<T*>(p[6]);
  io.H = static_cast<T*>(p[7]);
  io.g = static_cast<T*>(p[8]);
  io.x = static_cast<const T*>(p[9]);
  io.work = static_cast<T*>(p[10]);
  io.cs = static_cast<T*>(p[11]);
  io.iters = static_cast<int*>(p[12]);
  io.d_norm = static_cast<T*>(p[13]);
  io.alpha = static_cast<T*>(p[14]);
  io.inf_du = static_cast<T*>(p[15]);
  io.trace = static_cast<T*>(p[16]);
  io.u0 = static_cast<T*>(p[17]);
  io.obj = static_cast<T*>(p[18]);
  io.inf_pr = static_cast<T*>(p[19]);
  io.mu = static_cast<T*>(p[20]);
  io.reg = static_cast<T*>(p[21]);
  return io;
}

// Values of one scenario's work row.
FCT_HDF int sqp_work_fields(int N, int nc) { return 4 + nc * N; }

// The build's slice of shared memory: the N columns of J (each NR values,
// at an odd stride, so that the lanes' stores of one row fall on different
// banks), the residuals R and g.  An odd size, as K5's.
struct SqpBuildLayout {
  int N, nc;
  FCT_HDF int NR() const { return 2 * N + nc * N; }
  FCT_HDF int stride() const { return NR() | 1; }
  FCT_HDF int J() const { return 0; }
  FCT_HDF int R() const { return N * stride(); }
  FCT_HDF int GV() const { return R() + NR(); }
  FCT_HDF int size() const { return (GV() + N) | 1; }
};
FCT_HDF int sqp_build_fields(int N, int nc) {
  return SqpBuildLayout{N, nc}.size();
}

// The search's slice: each candidate's cost, step norm, objective and
// infeasibility, then the accepted candidate and the accept flag.
struct SqpSearchLayout {
  int n_cand;
  FCT_HDF int COST() const { return 0; }
  FCT_HDF int DNS() const { return n_cand; }
  FCT_HDF int OBJ() const { return 2 * n_cand; }
  FCT_HDF int INF() const { return 3 * n_cand; }
  FCT_HDF int FL() const { return 4 * n_cand; }
  FCT_HDF int size() const { return (FL() + 2) | 1; }
};
FCT_HDF int sqp_search_fields(int n_cand) {
  return SqpSearchLayout{n_cand}.size();
}

// mu of AL round al: mu0 times mu_factor al times, as solve_batch
// multiplies its 0-d tensor.
template <class T> FCT_HD T sqp_mu(const SqpCfg& c, int al) {
  T mu = T(c.mu0);
  for (int i = 0; i < al; ++i) mu = mu * T(c.mu_factor);
  return mu;
}

// sqp._constraints at one arrival state: [p1 - lo, p2 - lo(, hi - p1,
// hi - p2)] in scaled pressure units.
template <class T, int K>
FCT_HD void sqp_constraints(const Dual<T, K>* x, const SqpCfg& c,
                            Dual<T, K>* out) {
  const T ps = T(c.p_scale), lo = T(c.p_lo);
  out[0] = x[2] / ps - lo;
  out[1] = x[3] / ps - lo;
  if (c.nc == 4) {
    const T hi = T(c.p_hi);
    out[2] = hi - x[2] / ps;
    out[3] = hi - x[3] / ps;
  }
}

// The sums over one trajectory's residual rows, in the order written at
// the top: the squared tracking, increment and AL rows by block, the raw
// increments' squares (the objective's) and the largest -c.
template <class T>
struct SqpSums {
  T track, du, dv, con[4], amax;

  FCT_HD void add_stage(int k, T tr, T rdu, T du_raw) {
    track = k == 0 ? tr * tr : track + tr * tr;
    du = k == 0 ? rdu * rdu : du + rdu * rdu;
    dv = k == 0 ? du_raw * du_raw : dv + du_raw * du_raw;
  }
  FCT_HD void add_con(int k, int j, T r, T cval) {
    con[j] = k == 0 ? r * r : con[j] + r * r;
    amax = (k == 0 && j == 0) ? -cval : t_max(amax, -cval);
  }
  // 0.5 * sum(r * r): solve_batch's cost0 and a candidate's cost.
  FCT_HD T cost(int nc) const {
    T s = track + du;
    for (int j = 0; j < 4; ++j)
      if (j < nc) s = s + con[j];
    return T(0.5) * s;
  }
  // The trace's objective, sum(r_obj * r_obj) over the first 2N rows.
  FCT_HD T trace_obj() const { return track + du; }
  // The diagnostics' objective and primal infeasibility.
  FCT_HD T obj(const SqpCfg& c) const { return track + T(c.rterm) * dv; }
  FCT_HD T inf_pr() const { return t_max(amax, T(0)); }
};

// The (i, j) entry, i <= j, of the e-th of the upper triangle's
// N (N + 1) / 2 entries in row order.
FCT_HDF void sqp_upper(int e, int N, int& i, int& j) {
  i = 0;
  while (e >= N - i) {
    e -= N - i;
    ++i;
  }
  j = i + e;
}

// The build's phase (a) on one lane: the rollout from x0 with K tangents
// (the input directions lane K .. lane K + K - 1 below N; K = 0: values
// only, which the operation count runs to find the values' share), the
// stages' residual rows and the directions' columns of J (J's column i at
// J + i stride).  Lane 0 also writes the residuals to R, the constraint
// values to the work row and the sums to *sums.
template <class T, int K>
FCT_HD void sqp_build_lane(const PressParams& P, const SqpCfg& c, T mu,
                           T sq, const T* x0, T ref, T u_prev, const T* v,
                           const T* lam, int lane, T* J, int stride, T* R,
                           T* work, SqpSums<T>* sums) {
  typedef Dual<T, K> D;
  const int N = c.N, nc = c.nc, d0 = lane * K;
  const T srt = T(c.sqrt_rterm);
  D x[5];
  for (int i = 0; i < 5; ++i) x[i] = cst<T, K>(x0[i]);
  FCT_PHASE(1);
  T prev = divc(u_prev, T(c.u_scale));
  SqpSums<T> s;
  for (int k = 0; k < N; ++k) {
    FCT_PHASE(0);
    D u = cst<T, K>(v[k]);
    for (int t = 0; t < K; ++t) u.d[t] = T(d0 + t == k ? 1 : 0);
    rk4_step(x, u * T(c.u_scale), static_cast<const T*>(nullptr), c.dt,
             c.substeps, c.variant, P);
    FCT_PHASE(1);
    const D tr = x[1] - ref;
    const T du = v[k] - prev;
    const T rdu = du * srt;
    prev = v[k];
    D cs[4];
    sqp_constraints(x, c, cs);
    D rc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nc) rc[j] = dmax((lam[j * N + k] / mu) - cs[j], T(0)) * sq;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const int i = d0 + t;
      if (i >= N) break;
      T* Jc = J + i * stride;
      // d du_k / d v_i: +1 at k, -1 at k - 1, times sqrt(rterm).
      Jc[k] = tr.d[t];
      Jc[N + k] = i == k ? srt : (i == k - 1 ? -srt : T(0));
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < nc) Jc[2 * N + j * N + k] = rc[j].d[t];
    }
    if (lane != 0) continue;
    s.add_stage(k, tr.v, rdu, du);
    R[k] = tr.v;
    R[N + k] = rdu;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nc) {
        s.add_con(k, j, rc[j].v, cs[j].v);
        R[2 * N + j * N + k] = rc[j].v;
        work[4 + j * N + k] = cs[j].v;
      }
  }
  if (lane == 0) *sums = s;
}

// The build of scenario b by a team of G lanes, K input directions a lane
// (G >= ceil(N / K)), on its slice sm of sqp_build_fields(N, nc) values
// (see the top of this file).  Every lane calls it with its own team.lane.
template <class T, int K, class Team>
FCT_HD void sqp_build_team(const PressParams& P, const SqpCfg& c, int al,
                           int row, const SqpIO<T>& io, int b, T* sm,
                           const Team& team, int G) {
  const int N = c.N, nc = c.nc, NR = 2 * N + nc * N;
  const SqpBuildLayout L{N, nc};
  const long long bN = (long long)b * N;
  const T ref = io.ref[b];
  const T mu = sqp_mu<T>(c, al);
  const T sq = m_sqrt(mu / T(2));
  const T* v = io.v_in + bN;
  const T* lam = io.lam_in + bN * nc;
  T* work = io.work + (long long)b * sqp_work_fields(N, nc);
  T* trace = (c.trace_rows > 0 && row >= 0)
      ? io.trace + ((long long)b * c.trace_rows + row) * 6 : (T*)0;
  // (a) The rollout with the lane's directions, their columns of J, the
  // residuals.
  team.each([&](int lane) {
    if (lane * K >= N) return;
    SqpSums<T> s;
    sqp_build_lane<T, K>(P, c, mu, sq, io.x0 + 5LL * b, ref, io.u_prev[b],
                         v, lam, lane, sm + L.J(), L.stride(), sm + L.R(),
                         work, &s);
    if (lane != 0) return;
    FCT_PHASE(3);
    work[0] = s.cost(nc);
    work[2] = s.obj(c);
    work[3] = s.inf_pr();
    if (trace) {   // at the incoming iterate (sqp.TRACE_COLS)
      trace[0] = s.trace_obj();
      trace[1] = work[3];
      trace[5] = mu;
    }
  });
  // (b) g = J^T r on lane i; H = J^T J by entries of the upper triangle;
  // the damped systems.
  team.each([&](int lane) {
    FCT_PHASE(2);
    const T* R = sm + L.R();
    for (int i = lane; i < N; i += G) {
      const T* Ji = sm + L.J() + i * L.stride();
      T gi = T(0);
      for (int r = 0; r < NR; ++r) gi = gi + Ji[r] * R[r];
      sm[L.GV() + i] = gi;
      for (int m = 0; m < 3; ++m) io.g[(3 * (long long)b + m) * N + i] = gi;
    }
    for (int e = lane; e < N * (N + 1) / 2; e += G) {
      int i, j;
      sqp_upper(e, N, i, j);
      const T* Ji = sm + L.J() + i * L.stride();
      const T* Jj = sm + L.J() + j * L.stride();
      T h = T(0);
      for (int r = 0; r < NR; ++r) h = h + Ji[r] * Jj[r];
      for (int m = 0; m < 3; ++m) {
        T* Hm = io.H + (3 * (long long)b + m) * N * N;
        if (i == j) {
          Hm[i * N + i] = h + T(c.regs[m]);
        } else {
          Hm[i * N + j] = h;
          Hm[j * N + i] = h;
        }
      }
    }
  });
  // (c) The largest |g_i| (NaN propagates, as torch.amax).
  team.each([&](int lane) {
    if (lane != 0) return;
    FCT_PHASE(3);
    const T* gv = sm + L.GV();
    T gn = m_abs(gv[0]);
    for (int i = 1; i < N; ++i) gn = t_max(gn, m_abs(gv[i]));
    work[1] = gn;
    if (trace) trace[2] = gn;
  });
}

// The search's phase (a) for candidate a: its step from B1's solutions xs
// (B, 3, N rows of one scenario), the rollout, the cost summed as the build
// sums cost0, the step's norm and, for the solve's last search, the
// objective and the infeasibility; with cs (non-null) its constraint
// values.
template <class T>
FCT_HD void sqp_candidate(const PressParams& P, const SqpCfg& c, T mu, T sq,
                          const T* x0, T ref, T u_prev, const T* v,
                          const T* lam, const T* xs, int a, T* cs,
                          T* sm, const SqpSearchLayout& L) {
  typedef Dual<T, 0> D;
  const int N = c.N, nc = c.nc;
  const T alpha = T(c.alphas[a]);
  const T* dir = xs + (a < c.n_lad ? 0 : a - c.n_lad + 1) * N;
  D x[5];
  for (int i = 0; i < 5; ++i) x[i] = cst<T, 0>(x0[i]);
  FCT_PHASE(2);
  T prev = divc(u_prev, T(c.u_scale));
  SqpSums<T> s;
  T dn = T(0);
  for (int k = 0; k < N; ++k) {
    FCT_PHASE(0);
    const T step = alpha * -dir[k];
    const T vk = v[k] + step;
    dn = dn + step * step;
    FCT_PHASE(1);
    rk4_step(x, cst<T, 0>(vk * T(c.u_scale)), static_cast<const T*>(nullptr),
             c.dt, c.substeps, c.variant, P);
    FCT_PHASE(2);
    const T tr = x[1].v - ref;
    const T du = vk - prev;
    prev = vk;
    s.add_stage(k, tr, du * T(c.sqrt_rterm), du);
    D con[4];
    sqp_constraints(x, c, con);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nc) {
        const D r = dmax((lam[j * N + k] / mu) - con[j], T(0)) * sq;
        s.add_con(k, j, r.v, con[j].v);
        if (cs) cs[j * N + k] = con[j].v;
      }
  }
  FCT_PHASE(2);
  sm[L.COST() + a] = s.cost(nc);
  sm[L.DNS() + a] = m_sqrt(dn);
  sm[L.OBJ() + a] = s.obj(c);
  sm[L.INF() + a] = s.inf_pr();
}

// The search of scenario b by a team of G lanes on its slice sm of
// sqp_search_fields(n_lad + 2) values, after the build of the same
// iteration and B1 (flags: SqpFlags; without kSqpStep, no candidate: the
// iterate stays and only the AL update and the last writes run).
template <class T, class Team>
FCT_HD void sqp_search_team(const PressParams& P, const SqpCfg& c, int al,
                            int row, int flags, const SqpIO<T>& io, int b,
                            T* sm, const Team& team, int G) {
  const int N = c.N, nc = c.nc, ncon = nc * N, n_cand = c.n_lad + 2;
  const SqpSearchLayout L{n_cand};
  const long long bN = (long long)b * N;
  const bool step = flags & kSqpStep, first = flags & kSqpFirst;
  const bool round_end = flags & kSqpRoundEnd, last = flags & kSqpLast;
  const T ref = io.ref[b];
  const T mu = sqp_mu<T>(c, al);
  const T* v = io.v_in + bN;
  const T* lam = io.lam_in + bN * nc;
  const T* xs = io.x + 3 * bN;
  const T* work = io.work + (long long)b * sqp_work_fields(N, nc);
  T* cs = io.cs + (long long)b * n_cand * ncon;
  // (a) The candidates, one a lane.
  if (step)
    team.each([&](int lane) {
      const T sq = m_sqrt(mu / T(2));
      for (int a = lane; a < n_cand; a += G)
        sqp_candidate(P, c, mu, sq, io.x0 + 5LL * b, ref, io.u_prev[b], v,
                      lam, xs, a, round_end ? cs + a * ncon : (T*)0, sm, L);
    });
  // (b) The argmin, the accept rule and the diagnostics, on lane 0.
  team.each([&](int lane) {
    if (lane != 0) return;
    FCT_PHASE(3);
    int best = 0;
    bool take = false;
    if (step) {
      const T* costs = sm + L.COST();
      const T gn = work[1];
      const bool converged = gn < T(c.tol_grad);
      for (int a = 1; a < n_cand; ++a)
        if (!is_nan(costs[best])
            && (is_nan(costs[a]) || costs[a] < costs[best]))
          best = a;
      take = (costs[best] < work[0]) && !converged;
      const T d_n = take ? sm[L.DNS() + best] : T(0);
      const T a_n = take ? T(c.alphas[best]) : (first ? T(0) : io.alpha[b]);
      io.d_norm[b] = d_n;
      io.alpha[b] = a_n;
      io.iters[b] = (first ? 0 : io.iters[b]) + (converged ? 0 : 1);
      io.inf_du[b] = gn;
      if (c.trace_rows > 0 && row >= 0) {
        T* tr = io.trace + ((long long)b * c.trace_rows + row) * 6;
        tr[3] = d_n;
        tr[4] = a_n;
      }
    } else if (first) {
      io.d_norm[b] = T(0);
      io.alpha[b] = T(0);
      io.iters[b] = 0;
      io.inf_du[b] = T(0);
    }
    sm[L.FL()] = T(best);
    sm[L.FL() + 1] = T(take ? 1 : 0);
  });
  // (c) The new iterate, the AL update and the solve's last writes.
  team.each([&](int lane) {
    FCT_PHASE(3);
    int best = 0;
    for (int a = 1; a < n_cand; ++a)
      if (sm[L.FL()] == T(a)) best = a;
    const bool take = sm[L.FL() + 1] != T(0);
    const T alpha = T(c.alphas[best]);
    const T* dir = xs + (best < c.n_lad ? 0 : best - c.n_lad + 1) * N;
    for (int k = lane; k < N; k += G) {
      const T vk = take ? v[k] + alpha * -dir[k] : v[k];
      io.v_out[bN + k] = vk;
      if (last && k == 0) io.u0[b] = vk * T(c.u_scale);
    }
    if (round_end)
      for (int e = lane; e < ncon; e += G) {
        const T ce = take ? cs[best * ncon + e] : work[4 + e];
        io.lam_out[bN * nc + e] = t_max(lam[e] - mu * ce, T(0));
      }
    if (!last || lane != 0) return;
    io.obj[b] = take ? sm[L.OBJ() + best] : work[2];
    io.inf_pr[b] = take ? sm[L.INF() + best] : work[3];
    io.mu[b] = round_end ? mu * T(c.mu_factor) : mu;
    io.reg[b] = T(c.lm_reg);
  });
}

}  // namespace fct
