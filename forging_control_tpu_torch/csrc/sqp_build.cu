// The condensed GN-SQP's Gauss-Newton build: one launch a Gauss-Newton
// iteration of solver/sqp.py solve_batch, a team of G >= N lanes a scenario,
// an input direction a lane (sqp_bodies.cuh sqp_build_team at K = 1).
//
// Replaces, with kernel B1 (csrc/smallchol.cu) and the line search (csrc/
// sqp_search.cu), the tensor code of one Gauss-Newton iteration: the
// residuals' linearisation by forward mode over the N input directions
// (dual.linearize through the rollout: 10 stages x 16 evaluations of
// press.rhs with N tangents at N = 10), g = J^T r and H = J^T J
// (torch.einsum) and the three damped systems (sqp._damped), some 100,000
// dispatched kernels at N = 10.  The JAX package compiles the same
// iteration into its XLA program (forging_control_tpu/solver/sqp.py
// `res_and_jac`, `solve_batch`).
//
// Bound on an H100: latency.  A scenario's build is N chains of 16 N
// evaluations of rhs with one tangent each, in dependent dual-number
// arithmetic (IEEE division, square root, pow, log and exp, unfused).  Lane
// i carries direction i and recomputes the values, so no lane waits for
// another inside the chain; one thread a scenario would leave one warp on
// an SM and the whole chain exposed.  Two or four directions a lane compute
// the values fewer times but run fewer chains side by side: at N = 10,
// B = 4,096 they took as long or longer (PERF.md), so the kernel is built
// for one.  Teams pack into warps (32 / G teams a block of one warp); the
// wrapper (ops/sqp.py) takes G = N, the fastest (PERF.md).  The Jacobian's
// columns meet in the team's shared memory (N (2N + nc N) values at an odd
// stride) for g's and H's entries, which the lanes share out.
//
// Built with --fmad=false (ops/build.py), as K4 and K5: every multiply and
// add rounds on its own, as the plain version's do.
//
// The C entry points launch on the given stream, allocate nothing, do not
// synchronise, and return cudaGetLastError(), or cudaErrorInvalidValue for
// what they cannot run: N outside 1..32, G outside N..32, nc other than 2
// and 4, substeps < 1, teams that do not fit one warp, or a team's slice
// beyond the default 48 KB of shared memory.

#include <cuda_runtime.h>

#include "sqp_bodies.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kSharedBytes = 48 * 1024;

template <class T>
__global__ void __launch_bounds__(kWarp)
sqp_build_kernel(const __grid_constant__ fct::PressParams P,
                 const __grid_constant__ fct::SqpCfg c,
                 const __grid_constant__ fct::SqpIO<T> io, int B, int G,
                 int teams, int al, int row) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int team = threadIdx.x / G;
  const int b = blockIdx.x * teams + team;
  if (b >= B) return;   // the whole team
  T* sm = reinterpret_cast<T*>(smem)
          + (long long)team * fct::sqp_build_fields(c.N, c.nc);
  const unsigned mask =
      G == kWarp ? 0xffffffffu : ((1u << G) - 1u) << (team * G);
  fct::sqp_build_team<T, 1>(P, c, al, row, io, b, sm,
                            fct::TeamLanes{(int)threadIdx.x % G, mask}, G);
}

template <class T>
int launch(const fct::PressParams* P, const fct::SqpCfg* c, void* const* p,
           int B, int G, int teams, int al, int row, void* stream) {
  const long long bytes =
      (long long)teams * fct::sqp_build_fields(c->N, c->nc) * sizeof(T);
  if (B < 0 || c->N < 1 || c->N > kWarp || G < c->N || G > kWarp
      || (c->nc != 2 && c->nc != 4) || c->substeps < 1 || teams < 1
      || teams * G > kWarp || bytes > kSharedBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  sqp_build_kernel<T><<<(B + teams - 1) / teams, teams * G, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      *P, *c, fct::sqp_io<T>(p), B, G, teams, al, row);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fct_sqp_build_f32(const fct::PressParams* P,
                                 const fct::SqpCfg* c, void* const* ptrs,
                                 int B, int G, int teams, int al, int row,
                                 void* stream) {
  return launch<float>(P, c, ptrs, B, G, teams, al, row, stream);
}

extern "C" int fct_sqp_build_f64(const fct::PressParams* P,
                                 const fct::SqpCfg* c, void* const* ptrs,
                                 int B, int G, int teams, int al, int row,
                                 void* stream) {
  return launch<double>(P, c, ptrs, B, G, teams, al, row, stream);
}
