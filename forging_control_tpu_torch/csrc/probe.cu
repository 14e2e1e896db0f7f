// Toolchain probe: y = x * 2 + 1 over a float32 array.
//
// Replaces the Mosaic probe `kernel` of `main` in scripts/pallas_probe.py
// (:27-33), an (8, 128) float32 elementwise `pallas_call` whose only job is
// to show that the kernel toolchain compiles and launches. Here it shows
// that nvcc builds for sm_90a, that the library loads through ctypes and
// that a launch on PyTorch's current stream runs. x * 2 is exact, so the
// result equals the plain version's bit for bit.
//
// Bound: bytes (8 KB in, 8 KB out); at that size the launch is the cost.
// The C interface launches on the given stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void probe_kernel(const float* __restrict__ x,
                             float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] * 2.0f + 1.0f;
}

}  // namespace

extern "C" int fct_probe_f32(const float* x, float* y, int n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  probe_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(x, y, n);
  return static_cast<int>(cudaGetLastError());
}
