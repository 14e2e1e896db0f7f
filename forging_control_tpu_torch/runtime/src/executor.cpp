// Realtime closed-loop executor — C ABI for ctypes.
//
// Replaces the reference's per-step Python -> torch -> CasADi/CVODES hops
// (NeuralNetwork.loop, Supervised Learning/Functions.py:673-885) with a
// single native loop: NN policy step + RK4 plant step at the 1 ms control
// period, with per-step latency capture.  This is the deployment artifact:
// TPU generates data and trains; this executor runs the trained policy
// against the plant (or, on a press, against the real IO layer) inside the
// real-time budget the reference's IPOPT MPC missed (BASELINE.md).
//
// Build: g++ -O3 -march=native -shared -fPIC executor.cpp -o libforging_rt.so

#include <chrono>
#include <cstdint>
#include <cstring>
#include <new>

#include "fnn.h"
#include "press_model.h"
#include "sqp_solver.h"
#include "trajstore.h"

#ifdef _OPENMP
#include <omp.h>
#endif

using forging::FnnPolicy;
using forging::PressParams;
using forging::Variant;

namespace {

struct Executor {
  PressParams params;
  Variant variant = Variant::kSmooth;
  FnnPolicy policy;
  double dt = 1e-3;
  int substeps = 4;
  double x[5] = {0, 0, 0, 0, 0};        // true plant state
  double x_meas[5] = {0, 0, 0, 0, 0};   // measured (floored) state
  double u_prev = 0.0;
};

}  // namespace

extern "C" {

void* fc_create(int variant, double dt, int substeps) {
  auto* e = new (std::nothrow) Executor();
  if (!e) return nullptr;
  e->variant = static_cast<Variant>(variant);
  e->dt = dt;
  e->substeps = substeps;
  return e;
}

void fc_destroy(void* h) { delete static_cast<Executor*>(h); }

void fc_reset(void* h, const double x0[5]) {
  auto* e = static_cast<Executor*>(h);
  std::memcpy(e->x, x0, sizeof(e->x));
  forging::measure(e->params, e->variant, e->x, e->x_meas);
  e->u_prev = 0.0;
}

// Load FNN policy weights (row-major [in][hidden] etc.) + scalers.
int fc_load_policy(void* h, int input_dim, int hidden_dim, int width_dim,
                   const double* w_in, const double* b_in,
                   const double* w_int, const double* b_int,
                   const double* w_out, const double* in_shift,
                   const double* in_scale, double out_shift,
                   double out_scale, double lb, double ub) {
  auto* e = static_cast<Executor*>(h);
  if (input_dim != 3) return -1;
  FnnPolicy& p = e->policy;
  p.input_dim = input_dim;
  p.hidden_dim = hidden_dim;
  p.width_dim = width_dim;
  p.w_in.assign(w_in, w_in + input_dim * hidden_dim);
  p.b_in.assign(b_in, b_in + hidden_dim);
  p.w_int.assign(w_int, w_int + hidden_dim * hidden_dim);
  p.b_int.assign(b_int, b_int + hidden_dim);
  p.w_out.assign(w_out, w_out + hidden_dim);
  std::memcpy(p.in_shift, in_shift, 3 * sizeof(double));
  std::memcpy(p.in_scale, in_scale, 3 * sizeof(double));
  p.out_shift = out_shift;
  p.out_scale = out_scale;
  p.lb = lb;
  p.ub = ub;
  p.init_scratch();
  return 0;
}

// One RK4 plant step with external command u (and optional process noise
// w[5]); writes the new measurement into x_meas_out.
void fc_plant_step(void* h, double u, const double* w, double* x_meas_out) {
  auto* e = static_cast<Executor*>(h);
  forging::rk4_step(e->params, e->variant, e->x, u, e->dt, e->substeps, w);
  forging::measure(e->params, e->variant, e->x, e->x_meas);
  e->u_prev = u;
  if (x_meas_out) std::memcpy(x_meas_out, e->x_meas, sizeof(e->x_meas));
}

// One full closed-loop step: policy(x_meas, ref) -> u; plant(u).
// Returns u; latency_ns (policy-only, the reference's timed section)
// written when non-null.
double fc_step(void* h, double ref, const double* w, double* x_meas_out,
               int64_t* latency_ns) {
  auto* e = static_cast<Executor*>(h);
  const auto t0 = std::chrono::steady_clock::now();
  const double u =
      e->policy.step(e->x_meas[1], e->x_meas[4], ref);
  const auto t1 = std::chrono::steady_clock::now();
  if (latency_ns)
    *latency_ns =
        std::chrono::duration_cast<std::chrono::nanoseconds>(t1 - t0).count();
  fc_plant_step(h, u, w, x_meas_out);
  return u;
}

// Run a whole episode natively: refs[T] in, trajectories out.
// xs_out: (T, 5) measurements; us_out: (T,); lat_out: (T,) ns.
void fc_run_episode(void* h, const double x0[5], const double* refs, int T,
                    double* xs_out, double* us_out, int64_t* lat_out) {
  fc_reset(h, x0);
  for (int t = 0; t < T; ++t) {
    int64_t lat = 0;
    const double u = fc_step(h, refs[t], nullptr, xs_out + 5 * t, &lat);
    us_out[t] = u;
    if (lat_out) lat_out[t] = lat;
  }
}

// ---------------------------------------------------------------------------
// Native MPC (condensed GN-SQP, sqp_solver.h): the single-stream real-time
// path that meets the 1 ms budget IPOPT missed.
// ---------------------------------------------------------------------------

void* fc_mpc_create(int horizon, double dt, int substeps, int gn_iters,
                    int al_iters, double p_max) {
  if (horizon < 1 || horizon > forging::kMaxN) return nullptr;
  forging::SqpConfig cfg;
  cfg.horizon = horizon;
  cfg.dt = dt;
  cfg.substeps = substeps;
  cfg.gn_iters = gn_iters;
  cfg.al_iters = al_iters;
  cfg.p_max = p_max;
  return new (std::nothrow) forging::SqpSolver(cfg);
}

// Full-config constructor: additionally exposes the pressure lower bound
// and AL penalty schedule (ipopt_compat preset: p_min=-5e6, mu0=1,
// mu_factor=1 — see solver/sqp.py MPCConfig.ipopt_compat).
void* fc_mpc_create_ex(int horizon, double dt, int substeps, int gn_iters,
                       int al_iters, double p_max, double p_min, double mu0,
                       double mu_factor) {
  if (horizon < 1 || horizon > forging::kMaxN) return nullptr;
  forging::SqpConfig cfg;
  cfg.horizon = horizon;
  cfg.dt = dt;
  cfg.substeps = substeps;
  cfg.gn_iters = gn_iters;
  cfg.al_iters = al_iters;
  cfg.p_max = p_max;
  cfg.p_min = p_min;
  cfg.mu0 = mu0;
  cfg.mu_factor = mu_factor;
  return new (std::nothrow) forging::SqpSolver(cfg);
}

void fc_mpc_destroy(void* h) { delete static_cast<forging::SqpSolver*>(h); }

void fc_mpc_reset(void* h) { static_cast<forging::SqpSolver*>(h)->reset(); }

// One warm-started MPC solve; returns u0.  stats_out (optional, len 4):
// [iters, obj, inf_pr, inf_du].
double fc_mpc_step(void* h, const double x0[5], double ref, double u_prev,
                   double* stats_out) {
  auto* s = static_cast<forging::SqpSolver*>(h);
  s->shift();
  forging::SqpDiag d;
  const double u = s->solve(x0, ref, u_prev, &d);
  if (stats_out) {
    stats_out[0] = d.iters;
    stats_out[1] = d.obj;
    stats_out[2] = d.inf_pr;
    stats_out[3] = d.inf_du;
  }
  return u;
}

// Full native MPC closed loop: solver + RK4 plant (smooth variant) for T
// steps.  xs_out (T,5) measurements, us_out (T,), lat_ns (T,) solve-only
// latency.
void fc_mpc_run_episode(void* solver_h, const double x0[5],
                        const double* refs, int T, double* xs_out,
                        double* us_out, int64_t* lat_ns) {
  auto* s = static_cast<forging::SqpSolver*>(solver_h);
  forging::PressParams P;
  s->reset();
  double x[5], xm[5];
  std::memcpy(x, x0, sizeof(x));
  forging::measure(P, forging::Variant::kSmooth, x, xm);
  double u_prev = 0.0;
  for (int t = 0; t < T; ++t) {
    const auto t0 = std::chrono::steady_clock::now();
    s->shift();
    const double u = s->solve(xm, refs[t], u_prev, nullptr);
    const auto t1 = std::chrono::steady_clock::now();
    if (lat_ns)
      lat_ns[t] = std::chrono::duration_cast<std::chrono::nanoseconds>(
                      t1 - t0).count();
    forging::rk4_step(P, forging::Variant::kSmooth, x, u, 1e-3, 4);
    forging::measure(P, forging::Variant::kSmooth, x, xm);
    u_prev = u;
    us_out[t] = u;
    if (xs_out) std::memcpy(xs_out + 5 * t, xm, sizeof(xm));
  }
}

// Batched native MPC dataset generation: one solver per thread (OpenMP),
// optional direct streaming into a trajectory store file.  refs is
// (n_traj, T); us_out (n_traj, T); xs_out (n_traj, T, 5) or null;
// store_path may be null.  Returns trajectories completed.
int fc_mpc_run_batch(int horizon, int gn_iters, int al_iters,
                     const double x0[5], const double* refs, int n_traj,
                     int T, double* xs_out, double* us_out,
                     const char* store_path) {
  if (horizon < 1 || horizon > forging::kMaxN) return 0;
  forging::SqpConfig scfg;
  scfg.horizon = horizon;
  scfg.gn_iters = gn_iters;
  scfg.al_iters = al_iters;

  std::vector<double> all(store_path ? static_cast<size_t>(n_traj) * T * 8 : 0);

  int done = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic) reduction(+ : done)
#endif
  for (int i = 0; i < n_traj; ++i) {
    forging::SqpSolver solver(scfg);
    forging::PressParams P;
    double x[5], xm[5];
    std::memcpy(x, x0, sizeof(x));
    forging::measure(P, forging::Variant::kSmooth, x, xm);
    double u_prev = 0.0;
    for (int t = 0; t < T; ++t) {
      const double ref = refs[static_cast<size_t>(i) * T + t];
      solver.shift();
      const double u = solver.solve(xm, ref, u_prev, nullptr);
      forging::rk4_step(P, forging::Variant::kSmooth, x, u, 1e-3, 4);
      forging::measure(P, forging::Variant::kSmooth, x, xm);
      u_prev = u;
      us_out[static_cast<size_t>(i) * T + t] = u;
      if (xs_out)
        std::memcpy(xs_out + (static_cast<size_t>(i) * T + t) * 5, xm,
                    sizeof(xm));
      if (store_path) {
        double* row = all.data() + (static_cast<size_t>(i) * T + t) * 8;
        row[0] = xm[0]; row[1] = xm[1]; row[2] = xm[2]; row[3] = xm[3];
        row[4] = xm[4]; row[5] = ref; row[6] = u;
        row[7] = forging::forging_force(P, xm[0], xm[1]);
      }
    }
    done += 1;
  }

  if (store_path) {
    forging::TrajStoreWriter w(store_path, n_traj, T,
                               {"y", "y_dot", "p1", "p2", "z", "ref", "u",
                                "F_d"});
    if (!w.ok()) return -1;
    for (int i = 0; i < n_traj; ++i)
      if (!w.append(all.data() + static_cast<size_t>(i) * T * 8)) return -1;
  }
  return done;
}

// Pure physics check hooks (for parity tests against the JAX side).
void fc_rhs(int variant, const double x[5], double u, double out[5]) {
  PressParams p;
  forging::rhs(p, static_cast<Variant>(variant), x, u, out);
}

void fc_rk4(int variant, double x[5], double u, double dt, int substeps) {
  PressParams p;
  forging::rk4_step(p, static_cast<Variant>(variant), x, u, dt, substeps);
}

}  // extern "C"
