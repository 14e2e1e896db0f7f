// Kernel K5: the whole AL-iLQR solve of solver/riccati.py solve_batch, one
// thread per scenario.
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
// ilqr_body).
//
// Bound on an H100: latency.  At N = 10 (fast_5x1) a scenario needs about
// 1.0 M operations (0.8 M on the return stroke, where the forging force's
// gate is shut; ops/opcount.py) in dependent chains of dual-number
// arithmetic: 0.064 ms of the card's float32 rate at B = 4,096, where it
// takes milliseconds (PERF.md); at B = 4,096 one
// thread per scenario is 128 warps, about one per SM, so nothing hides the
// latency of a dependent instruction.  Blocks of 32 threads spread those
// warps over the SMs.  A scenario's blocks (the trajectory, the linearised
// dynamics, the Gauss-Newton blocks, the gains and the line search's
// candidates: 133 N + 30 values) live in a scratch buffer that the wrapper
// allocates, laid out field-major so that the threads of a warp touch
// neighbouring words.  Spreading the tangents over lanes, shared memory for
// the blocks and more warps per SM are the next design's work.
//
// Built with --fmad=false (ops/build.py): the plain version rounds every
// multiply and add on its own, and so does this kernel, so that its
// physics rounds as the plain version's does (K4, built the same way from
// the same physics, equals the plain plant bit for bit).  The reductions
// (the Gauss-Newton blocks, the costs) sum in another order than
// PyTorch's, so the solve agrees with the plain one to rounding, about
// 1e-15 in float64 at N = 5 and 10.
//
// The C entry points that launch do so on the given stream, allocate
// nothing, do not synchronise, and return cudaGetLastError()
// (cudaErrorInvalidValue for N outside 1..25 or nc other than 2 and 4).

#include <cuda_runtime.h>

#include "bodies.cuh"

namespace {

constexpr int kThreads = 32;

// The kernel's own count of its runs on this card: the first thread of the
// first block adds one at every launch, so that a replayed CUDA graph shows
// whether the kernel's node ran (fct_ilqr_runs reads and resets it).
__device__ unsigned long long g_runs = 0;

template <class T>
__global__ void __launch_bounds__(kThreads)
ilqr_kernel(fct::PressParams P, fct::IlqrCfg c, fct::IlqrIO<T> io, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b == 0) atomicAdd(&g_runs, 1ULL);
  if (b >= B) return;
  fct::ilqr_body<T>(P, c, io, b, B);
}

template <class T>
int launch(const fct::PressParams* P, const fct::IlqrCfg* c, void* const* p,
           int B, void* stream) {
  if (B < 0 || c->N < 1 || c->N > 25 || (c->nc != 2 && c->nc != 4) ||
      c->substeps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const fct::IlqrIO<T> io = fct::ilqr_io<T>(p);
  ilqr_kernel<T><<<(B + kThreads - 1) / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(*P, *c, io, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fct_ilqr_scratch_fields(int N) {
  return fct::ilqr_scratch_fields(N);
}

extern "C" int fct_ilqr_f32(const fct::PressParams* P, const fct::IlqrCfg* c,
                            void* const* ptrs, int B, void* stream) {
  return launch<float>(P, c, ptrs, B, stream);
}

extern "C" int fct_ilqr_f64(const fct::PressParams* P, const fct::IlqrCfg* c,
                            void* const* ptrs, int B, void* stream) {
  return launch<double>(P, c, ptrs, B, stream);
}

// The runs counted since the library was loaded or last reset, into *out;
// with reset, the count starts again from 0.  Synchronises the device.
extern "C" int fct_ilqr_runs(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_runs, sizeof(*out));
  if (e == cudaSuccess && reset) {
    const unsigned long long zero = 0;
    e = cudaMemcpyToSymbol(g_runs, &zero, sizeof(zero));
  }
  return static_cast<int>(e);
}
