// The condensed GN-SQP's line search: one launch a Gauss-Newton iteration
// of solver/sqp.py solve_batch, after the build (csrc/sqp_build.cu) and
// kernel B1, a team of G lanes a scenario (sqp_bodies.cuh sqp_search_team).
//
// Replaces the tensor code after the damped solve: the n_lad + 2 step
// candidates' rollouts and costs (sqp._residuals over a candidate axis),
// torch.argmin, the accept rule and the diagnostics' torch.where updates,
// the per-iteration trace, and, on an AL round's last iteration, the
// rollout of the accepted iterate for the multipliers' update and, after
// the last round, for the objective and the infeasibility: together some
// 60,000 dispatched kernels a Gauss-Newton iteration at N = 10.
//
// Bound on an H100: latency.  Each candidate is one chain of 16 N
// evaluations of rhs in values; candidate a runs on lane a (K5 puts its
// four on four lanes), so a scenario's search takes one chain's time, and
// the teams pack into warps (32 / G a block of one warp; ops/sqp.py picks
// G from the ladder's length).  The accepted iterate's states are not
// rolled out again: each candidate keeps its constraint values on an AL
// round's last iteration (the scenario's rows of the cs scratch in device
// memory), and where nothing was taken the build's values of the same
// iterate serve.
//
// Built with --fmad=false (ops/build.py), as the build.
//
// The C entry points launch on the given stream, allocate nothing, do not
// synchronise, and return cudaGetLastError(), or cudaErrorInvalidValue for
// what they cannot run: N outside 1..32, n_lad + 2 above kSqpMaxCand, nc
// other than 2 and 4, substeps < 1, G outside 1..32, or teams that do not
// fit one warp.

#include <cuda_runtime.h>

#include "sqp_bodies.cuh"

namespace {

constexpr int kWarp = 32;

template <class T>
__global__ void __launch_bounds__(kWarp)
sqp_search_kernel(const __grid_constant__ fct::PressParams P,
                  const __grid_constant__ fct::SqpCfg c,
                  const __grid_constant__ fct::SqpIO<T> io, int B, int G,
                  int teams, int al, int row, int flags) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int team = threadIdx.x / G;
  const int b = blockIdx.x * teams + team;
  if (b >= B) return;   // the whole team
  T* sm = reinterpret_cast<T*>(smem)
          + (long long)team * fct::sqp_search_fields(c.n_lad + 2);
  const unsigned mask =
      G == kWarp ? 0xffffffffu : ((1u << G) - 1u) << (team * G);
  fct::sqp_search_team<T>(P, c, al, row, flags, io, b, sm,
                          fct::TeamLanes{(int)threadIdx.x % G, mask}, G);
}

template <class T>
int launch(const fct::PressParams* P, const fct::SqpCfg* c, void* const* p,
           int B, int G, int teams, int al, int row, int flags,
           void* stream) {
  const long long bytes =
      (long long)teams * fct::sqp_search_fields(c->n_lad + 2) * sizeof(T);
  if (B < 0 || c->N < 1 || c->N > kWarp || c->n_lad < 0
      || c->n_lad + 2 > fct::kSqpMaxCand || (c->nc != 2 && c->nc != 4)
      || c->substeps < 1 || G < 1 || teams < 1 || teams * G > kWarp)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  sqp_search_kernel<T><<<(B + teams - 1) / teams, teams * G, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      *P, *c, fct::sqp_io<T>(p), B, G, teams, al, row, flags);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fct_sqp_search_f32(const fct::PressParams* P,
                                  const fct::SqpCfg* c, void* const* ptrs,
                                  int B, int G, int teams, int al, int row,
                                  int flags, void* stream) {
  return launch<float>(P, c, ptrs, B, G, teams, al, row, flags, stream);
}

extern "C" int fct_sqp_search_f64(const fct::PressParams* P,
                                  const fct::SqpCfg* c, void* const* ptrs,
                                  int B, int G, int teams, int al, int row,
                                  int flags, void* stream) {
  return launch<double>(P, c, ptrs, B, G, teams, al, row, flags, stream);
}
