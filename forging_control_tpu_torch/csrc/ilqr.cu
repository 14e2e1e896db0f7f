// Kernel K5: the whole AL-iLQR solve of solver/riccati.py solve_batch, a
// team of G lanes per scenario.
//
// Replaces the JAX package's compiled solve, forging_control_tpu/solver/
// riccati.py:148-359 `solve_batch`, whose lax.scans (the stage
// linearisation :190, the backward Riccati sweep :248, the forward sweep
// :271, the Gauss-Newton and AL rounds :312 and :326) XLA compiles into one
// program.  The port's plain version (solver/riccati.py, Python loops of
// tensor ops) is some 200,000 kernels a solve at N = 10; this is one launch:
// the initial rollout, al_iters x gn_iters iterations (every stage
// linearised with 7 forward tangents and the terminal one with 6, the
// stage-0 mask, the Gauss-Newton blocks, the backward sweep over 6x6 blocks
// with lm_reg, qmax and the convergence mask, the 4-alpha forward sweep with
// in-line costs, the first-minimum argmin and the accept rule), the AL
// update of the multipliers and the penalty, the final objective and
// diagnostics and, if asked, the per-iteration trace (bodies.cuh
// ilqr_team).
//
// Bound on an H100: latency.  A scenario needs about 1.0 M operations at
// N = 10 (fast_5x1; 0.8 M on the return stroke, where the forging force's
// gate is shut; ops/opcount.py), in dependent chains of dual-number
// arithmetic: the card's float32 rate would take 0.064 ms at B = 4,096.
// One thread per scenario left one warp on an SM and each chain exposed.
// So a team of G lanes (G = 8, 16, 32, a template parameter; every team
// inside one warp) works on a scenario in phases (bodies.cuh): the stages'
// linearisation units (a stage x a group of K = 4 tangents) and
// Gauss-Newton blocks spread over the lanes, the backward sweep's 6x6
// products one entry a lane, the four line-search candidates on four
// lanes, the sums in stage order on one lane.  Between phases the team
// waits at __syncwarp with its own lanes' mask (teams follow their own
// scenario: a team skips the iterations that would repeat, bit for bit, an
// iteration that took no step, at N = 25 about half of them).  What
// remains is the chain of one stage's physics
// (IEEE division, square root, pow, log and exp, unfused): the forward
// sweep rolls N stages one after another on each candidate's lane, and
// the linearisation takes ceil(N x 2 / G) units a lane (PERF.md).  At
// G = 8, 4 teams fill a warp, and at 255 registers the 8 warps an SM
// holds keep B = 4,096 scenarios at N = 10 in one wave.  Where the card
// has room (ops/ilqr.py team_size: the largest G whose one wave holds the
// batch), a scenario takes 16 or 32 lanes, and there the two rollouts run
// on quads of four lanes, each evaluation of rhs split over its quad one
// op kind a step as in K4 (bodies.cuh rhs_four, from K4's constants), so
// a stage's chain is K4's shorter one; that code is compiled only at
// G >= 16, and the same bits come out at every G.  A
// scenario's blocks (108 N + 185 values) live in the
// block's dynamic shared memory, one slice a team, so a phase reads what
// another lane wrote at shared-memory latency; only the line search's
// candidate states (24 N values, written once and read once an iteration)
// go to a scratch in device memory, besides the inputs and outputs.  A
// block is one warp at most: the wrapper (ops/ilqr.py) picks the teams a
// block holds from N, the dtype and the 227 KB that a block may use; so the
// horizon is bounded only by one scenario's blocks in 227 KB (N <= 536 in
// float32, 267 in float64).
//
// Built with --fmad=false (ops/build.py): the plain version rounds every
// multiply and add on its own, and so does this kernel, so that its
// physics rounds as the plain version's does (K4, built the same way from
// the same physics, equals the plain plant bit for bit).  The reductions
// (the Gauss-Newton blocks, the costs) sum in another order than
// PyTorch's, so the solve agrees with the plain one to rounding, about
// 1e-15 in float64 at N = 5 and 10; the team changes no bit of it.
//
// The C entry points take, besides the press parameters, K4's constants in
// T (bodies.cuh PlantConsts, ops/plant.py plant_consts at the solver's dt
// and substeps), which the rollouts read at G >= 16.  Those that launch do
// so on the given stream, allocate nothing, do not synchronise, and return
// cudaGetLastError(), or
// cudaErrorInvalidValue for what they cannot run: N < 1, one scenario's
// blocks beyond 227 KB, nc other than 2 and 4, substeps < 1, a team size
// not built (float32: 8, 16, 32; float64: 8), or teams that do not fit
// one warp or the block's shared memory.

#include <cuda_runtime.h>

#include "bodies.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kSharedBytes = fct::kIlqrSharedBytes;
// The team size of float64 (ops/ilqr.py TEAM), which is built for it
// alone, and of float32 where the card holds the batch in one wave at no
// larger G; float32 is built for the sizes team_size picks (8, 16, 32).
constexpr int kTeam = 8;

// The Gauss-Newton iterations the kernel computed, summed over scenarios,
// per AL round (bodies.cuh ilqr_team's sweeps; fct_ilqr_sweeps reads and
// resets them).  A block sums its teams' counts in shared memory, and its
// first thread adds the sums here once, at the block's end.
__device__ unsigned long long g_sweeps[fct::kSweepRounds] = {};

// Blocks of at most one warp, each holding `teams` teams of G lanes.
template <class T, int G>
__global__ void __launch_bounds__(kWarp)
ilqr_kernel(const __grid_constant__ fct::PressParams P,
            const __grid_constant__ fct::IlqrCfg c,
            const __grid_constant__ fct::IlqrIO<T> io, int B, int teams,
            const __grid_constant__ fct::PlantConsts<T> C) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned sweeps[fct::kSweepRounds];
  for (int r = threadIdx.x; r < fct::kSweepRounds; r += blockDim.x)
    sweeps[r] = 0;
  __syncthreads();
  const int team = threadIdx.x / G;
  const int b = blockIdx.x * teams + team;
  if (b < B) {   // the whole team
    T* sm = reinterpret_cast<T*>(smem)
            + (long long)team * fct::ilqr_team_fields(c.N);
    const int lane = threadIdx.x % G;
    const unsigned mask =
        G == kWarp ? 0xffffffffu
                   : ((1u << G) - 1u) << ((threadIdx.x % kWarp) / G * G);
    fct::ilqr_team<T, G, fct::kIlqrTangents>(
        P, C, c, io, b, sm, fct::TeamLanes{lane, mask}, true, sweeps);
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int r = 0; r < fct::kSweepRounds; ++r)
      if (sweeps[r]) atomicAdd(&g_sweeps[r], (unsigned long long)sweeps[r]);
}

template <class T, int G>
int launch_team(const fct::PressParams* P, const fct::IlqrCfg* c,
                const T* consts, void* const* p, int B, int teams,
                cudaStream_t stream) {
  const long long bytes =
      (long long)teams * fct::ilqr_team_fields(c->N) * sizeof(T);
  if (teams < 1 || teams * G > kWarp || bytes > kSharedBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {   // beyond the default: opt in (per device)
    const cudaError_t e = cudaFuncSetAttribute(
        ilqr_kernel<T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSharedBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const fct::IlqrIO<T> io = fct::ilqr_io<T>(p);
  ilqr_kernel<T, G><<<(B + teams - 1) / teams, teams * G, bytes, stream>>>(
      *P, *c, io, B, teams, fct::plant_consts<T>(consts));
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch(const fct::PressParams* P, const fct::IlqrCfg* c, const T* k,
           void* const* p, int B, int G, int teams, void* stream) {
  if (B < 0 || c->N < 1
      || (long long)fct::ilqr_team_fields(c->N) * sizeof(T) > kSharedBytes
      || (c->nc != 2 && c->nc != 4) || c->substeps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(T) == 8) {   // float64: the default team only
    if (G == kTeam) return launch_team<T, kTeam>(P, c, k, p, B, teams, s);
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    switch (G) {
      case 8: return launch_team<T, 8>(P, c, k, p, B, teams, s);
      case 16: return launch_team<T, 16>(P, c, k, p, B, teams, s);
      case 32: return launch_team<T, 32>(P, c, k, p, B, teams, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
}

}  // namespace

// K: the forward tangents of one stage-linearisation unit.
extern "C" int fct_ilqr_tangents() { return fct::kIlqrTangents; }

extern "C" int fct_ilqr_f32(const fct::PressParams* P, const fct::IlqrCfg* c,
                            const float* consts, void* const* ptrs, int B,
                            int G, int teams, void* stream) {
  return launch<float>(P, c, consts, ptrs, B, G, teams, stream);
}

extern "C" int fct_ilqr_f64(const fct::PressParams* P, const fct::IlqrCfg* c,
                            const double* consts, void* const* ptrs, int B,
                            int G, int teams, void* stream) {
  return launch<double>(P, c, consts, ptrs, B, G, teams, stream);
}

// The sweeps counted since the library was loaded or last reset, per AL
// round, into out[0..kSweepRounds); with reset, the count starts again from
// 0.  Synchronises the device.
extern "C" int fct_ilqr_sweeps(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_sweeps, sizeof(g_sweeps));
  if (e == cudaSuccess && reset) {
    const decltype(g_sweeps) zero{};
    e = cudaMemcpyToSymbol(g_sweeps, &zero, sizeof(zero));
  }
  return static_cast<int>(e);
}
