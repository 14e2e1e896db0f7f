// Kernel K4: one control period of the closed loop's plant, one thread per
// scenario.
//
// Replaces the plant side of the JAX package's closed-loop scan body
// (forging_control_tpu/loop/closed_loop.py:254-279, `body` of
// `_run_batch_fused`, which XLA fuses into the compiled period): the forging
// force at the pre-step measured state, four RK4 substeps of press.rhs with
// the additive process noise, the optional state clip (nan_to_num, then
// clip) and the measurement plus its noise.  The port's plain version is
// ops/plant.py plant_step_torch, some 2,700 elementwise kernels a period;
// this is one launch.
//
// Bound on an H100: latency.  A scenario's period is 16 evaluations of rhs
// (about 1,900 operations that need arithmetic, with the transcendentals
// counted once: ops/opcount.py); at B = 4,096 that is 8 M operations,
// 0.12 us at the float32 rate, and one
// thread per scenario is 128 warps, about one per SM.  Blocks of 32
// threads spread those warps over the SMs instead of packing them onto a few.
//
// Built with --fmad=false (ops/build.py): the plain version rounds every
// multiply and add on its own, and the float32 closed loops that the smoke
// run pins to the JAX package's numbers go through this kernel.
//
// The C entry points that launch do so on the given stream, allocate
// nothing, do not synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>

#include "bodies.cuh"

namespace {

constexpr int kThreads = 32;

// The kernel's own count of its runs on this card: the first thread of the
// first block adds one at every launch, so that a replayed CUDA graph shows
// whether the kernel's node ran (fct_plant_runs reads and resets it).
__device__ unsigned long long g_runs = 0;

template <class T>
__global__ void __launch_bounds__(kThreads)
plant_kernel(fct::PressParams P, fct::PlantCfg c, const T* __restrict__ xt,
             const T* __restrict__ xm, const T* __restrict__ u,
             const T* __restrict__ w, const T* __restrict__ v,
             T* __restrict__ xn, T* __restrict__ xmn, T* __restrict__ Fd,
             int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b == 0) atomicAdd(&g_runs, 1ULL);
  if (b >= B) return;
  fct::plant_body<T>(P, c, xt + 5 * b, xm + 5 * b, u[b],
                     w ? w + 5 * b : nullptr, v ? v + 5 * b : nullptr,
                     xn + 5 * b, xmn + 5 * b, Fd + b);
}

template <class T>
int launch(const fct::PressParams* P, const fct::PlantCfg* c, const T* xt,
           const T* xm, const T* u, const T* w, const T* v, T* xn, T* xmn,
           T* Fd, int B, void* stream) {
  if (B < 0 || c->substeps < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  plant_kernel<T><<<(B + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      *P, *c, xt, xm, u, w, v, xn, xmn, Fd, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fct_plant_f32(const fct::PressParams* P,
                             const fct::PlantCfg* c, const float* xt,
                             const float* xm, const float* u, const float* w,
                             const float* v, float* xn, float* xmn, float* Fd,
                             int B, void* stream) {
  return launch<float>(P, c, xt, xm, u, w, v, xn, xmn, Fd, B, stream);
}

extern "C" int fct_plant_f64(const fct::PressParams* P,
                             const fct::PlantCfg* c, const double* xt,
                             const double* xm, const double* u,
                             const double* w, const double* v, double* xn,
                             double* xmn, double* Fd, int B, void* stream) {
  return launch<double>(P, c, xt, xm, u, w, v, xn, xmn, Fd, B, stream);
}

// The runs counted since the library was loaded or last reset, into *out;
// with reset, the count starts again from 0.  Synchronises the device.
extern "C" int fct_plant_runs(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_runs, sizeof(*out));
  if (e == cudaSuccess && reset) {
    const unsigned long long zero = 0;
    e = cudaMemcpyToSymbol(g_runs, &zero, sizeof(zero));
  }
  return static_cast<int>(e);
}
