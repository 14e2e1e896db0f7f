// Kernel K4: one control period of the closed loop's plant, a team of four
// lanes of one warp a scenario (G = 4), or one thread a scenario through
// the reference body (G = 1).
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
// one after another (about 1,900 operations that need arithmetic, with the
// transcendentals counted once: ops/opcount.py); at B = 4,096 that is 8 M
// operations, 0.12 us at the float32 rate, and even teams of four are 512
// warps, about one per warp scheduler.  So the time is one scenario's
// dependent chain, and in it the operations whose library code ends in a
// branch to a slow path (IEEE division and reciprocal, square root, powf),
// which no schedule overlaps with one another: plant_body runs a stage's
// seven divisions, three powers and four square roots one after another.
// The team body (bodies.cuh plant_team) makes every branch of the physics a
// select, takes the square root without its branch, and gives each of its
// four lanes its own operands of one such operation at a time, four at
// once.  G = 1 runs plant_body, the one-thread body that the operation
// count reads; it stays for the timings and as the reference.  Blocks of 32
// threads spread the warps over the SMs instead of packing them onto a few.
//
// Built with --fmad=false (ops/build.py): the plain version rounds every
// multiply and add on its own, and the float32 closed loops that the smoke
// run pins to the JAX package's numbers go through this kernel.  Both
// bodies compute plant_body's expressions in its order, so each equals the
// plain plant bit for bit on the card.
//
// The C entry points that launch do so on the given stream, allocate
// nothing, do not synchronise, and return cudaGetLastError(), or
// cudaErrorInvalidValue for substeps < 1, a variant other than 0, 1, 2 or
// a team size other than 1 and 4.

#include <cuda_runtime.h>

#include "bodies.cuh"

namespace {

constexpr int kThreads = 32;
constexpr int kTeam = 4;   // lanes a scenario of the team body

template <class T>
__global__ void __launch_bounds__(kThreads)
plant_kernel(fct::PressParams P, fct::PlantCfg c, const T* __restrict__ xt,
             const T* __restrict__ xm, const T* __restrict__ u,
             const T* __restrict__ w, const T* __restrict__ v,
             T* __restrict__ xn, T* __restrict__ xmn, T* __restrict__ Fd,
             int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  fct::plant_body<T>(P, c, xt + 5 * b, xm + 5 * b, u[b],
                     w ? w + 5 * b : nullptr, v ? v + 5 * b : nullptr,
                     xn + 5 * b, xmn + 5 * b, Fd + b);
}

// Teams of four lanes (a block's 32 threads hold 8, so a team never spans
// two warps); variant V.  Every lane of every warp runs the body: the teams
// past the last scenario run scenario B - 1 again and store nothing, so that
// each shuffle can name the whole warp, before which the compiler then puts
// no check for a warp that has come apart (which cost a fifth of the
// kernel's time).
template <class T, int V>
__global__ void __launch_bounds__(kThreads)
plant_team_kernel(const __grid_constant__ fct::PlantConsts<T> C,
                  const __grid_constant__ fct::PlantCfg c,
                  const T* __restrict__ xt, const T* __restrict__ xm,
                  const T* __restrict__ u, const T* __restrict__ w,
                  const T* __restrict__ v, T* __restrict__ xn,
                  T* __restrict__ xmn, T* __restrict__ Fd, int B) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const bool store = t / kTeam < B;
  const int b = store ? t / kTeam : B - 1;
  fct::plant_team<T, V>(C, c, xt + 5 * b, xm + 5 * b, u[b],
                        w ? w + 5 * b : nullptr, v ? v + 5 * b : nullptr,
                        xn + 5 * b, xmn + 5 * b, Fd + b, store,
                        fct::PlantLanes{int(threadIdx.x % kTeam),
                                        0xffffffffu});
}

// The body's float32 square root (bodies.cuh sqrt_rn) of n values, for the
// card's check of it against sqrtf.
__global__ void __launch_bounds__(256)
sqrt_kernel(const float* __restrict__ x, float* __restrict__ out,
            long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = fct::sqrt_rn(x[i]);
}

template <class T>
int launch(const fct::PressParams* P, const fct::PlantCfg* c,
           const T* consts, const T* xt, const T* xm, const T* u, const T* w,
           const T* v, T* xn, T* xmn, T* Fd, int B, int G, void* stream) {
  if (B < 0 || c->substeps < 1 || c->variant < fct::RAW
      || c->variant > fct::CLAMP || (G != 1 && G != kTeam))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (B * G + kThreads - 1) / kThreads;
  if (G == 1) {
    plant_kernel<T><<<blocks, kThreads, 0, s>>>(*P, *c, xt, xm, u, w, v, xn,
                                                 xmn, Fd, B);
    return static_cast<int>(cudaGetLastError());
  }
  const fct::PlantConsts<T> C = fct::plant_consts<T>(consts);
  switch (c->variant) {
    case fct::RAW:
      plant_team_kernel<T, fct::RAW><<<blocks, kThreads, 0, s>>>(
          C, *c, xt, xm, u, w, v, xn, xmn, Fd, B);
      break;
    case fct::SMOOTH:
      plant_team_kernel<T, fct::SMOOTH><<<blocks, kThreads, 0, s>>>(
          C, *c, xt, xm, u, w, v, xn, xmn, Fd, B);
      break;
    default:
      plant_team_kernel<T, fct::CLAMP><<<blocks, kThreads, 0, s>>>(
          C, *c, xt, xm, u, w, v, xn, xmn, Fd, B);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// G = 1: one thread a scenario through plant_body, which reads P; G = 4:
// the team body, which reads consts, K4's kPlantConsts constants in T
// (bodies.cuh PlantConsts).
extern "C" int fct_plant_f32(const fct::PressParams* P,
                             const fct::PlantCfg* c, const float* consts,
                             const float* xt, const float* xm, const float* u,
                             const float* w, const float* v, float* xn,
                             float* xmn, float* Fd, int B, int G,
                             void* stream) {
  return launch<float>(P, c, consts, xt, xm, u, w, v, xn, xmn, Fd, B, G,
                       stream);
}

extern "C" int fct_plant_f64(const fct::PressParams* P,
                             const fct::PlantCfg* c, const double* consts,
                             const double* xt, const double* xm,
                             const double* u, const double* w,
                             const double* v, double* xn, double* xmn,
                             double* Fd, int B, int G, void* stream) {
  return launch<double>(P, c, consts, xt, xm, u, w, v, xn, xmn, Fd, B, G,
                        stream);
}

extern "C" int fct_plant_sqrt_f32(const float* x, float* out, long long n,
                                  void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  sqrt_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, n);
  return static_cast<int>(cudaGetLastError());
}
