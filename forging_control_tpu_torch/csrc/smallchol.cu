// Batched small-SPD Cholesky solve H x = g, staged through shared memory.
//
// Replaces the Pallas TPU kernel `_chol_kernel` driven by
// `chol_solve_pallas` (forging_control_tpu/ops/smallchol.py:77-160). The TPU
// kernel transposes the batch into 128-lane tiles of an (N*N, B) layout and
// pads the batch with identity systems. Here the batch stays row-major
// (B, N, N) and the ragged last block is masked instead of padded.
//
// Bound on an H100: memory. On the main path (B*3 = 12288 systems, N = 10,
// float32) one call reads H and g and writes x, 12288*120*4 B = 5.9 MB,
// 1.76 us at 3.35 TB/s, against 7.3 MFLOP (0.1 us at the 67 TFLOP/s float32
// rate). A thread that reads its own 400-byte matrix from device memory
// makes each warp-wide load touch 32 cache lines, 128 such threads per block
// give the main path 96 blocks on 132 SMs, and a per-thread L array spills
// to local memory at N >= 17 (float64) and N >= 21 (float32). So:
//
// * a block of S = 32 threads owns 32 consecutive systems (384 blocks on
//   the main path; 16 where 32 would need more than 100 KB) and copies its
//   contiguous (S, N, N) slab of H and (S, N) slab of g into shared memory
//   as they lie, with 16-byte cp.async copies (element copies where a
//   pointer is not 16-byte aligned), every copy in flight at once;
// * each thread factors its system in place in shared memory and solves in
//   place over g: no per-thread array. Where a system's words fit in about
//   160 registers (N <= 16 in float32, N <= 11 in float64) the compiler
//   keeps them there; above that every access is a volatile shared load or
//   store, so nothing spills to local memory at any N <= 25;
// * x goes back from shared memory with 16-byte stores (x must be 16-byte
//   aligned; the wrapper allocates it).
//
// The per-system stride is N*N words, as in H: odd, so conflict-free, for
// odd N. A packed lower triangle at an odd stride (conflict-free for every
// N) needs a 4-byte copy per element with a scatter address, and that
// staging made the whole kernel slower than the first version (PERF.md);
// at even N <= 16 each element is read from shared memory once, so
// the conflicts cost little.
//
// Arithmetic: the left-looking recurrence of the plain version
// (`chol_solve_torch`), in its summation order: Cholesky factor L, forward
// substitution L y = g, back substitution L^T x = y. N is a template
// parameter (1..25) so every loop unrolls and every shared-memory offset is
// a compile-time constant. One launch per solve; no host synchronisation or
// allocation inside it, so it can be captured in a CUDA graph.
//
// The C interface takes raw device pointers and the CUDA stream, launches on
// that stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for N outside 1..25, or x
// not 16-byte aligned).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxN = 25;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float dev_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dev_sqrt(double v) { return sqrt(v); }

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

// One element from global to shared memory, asynchronously.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(addr),
               "l"(src), "n"(sizeof(T)));
}

template <typename T>
__device__ __forceinline__ void cp_async16(T* dst, const T* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(addr),
               "l"(src));
}

// A system's words in shared memory. Where its lower triangle and
// right-hand side fit in about 160 registers, plain accesses let the
// compiler keep them there; beyond that they are volatile, so each use is
// a load from shared memory and nothing spills to local memory.
template <typename T, int N>
struct Smem {
  static constexpr bool kVolatile =
      (N * (N + 1) / 2 + N) * static_cast<int>(sizeof(T) / 4) > 160;
  T* p;
  __device__ __forceinline__ T ld(int k) const {
    if constexpr (kVolatile) return *reinterpret_cast<volatile T*>(p + k);
    else return p[k];
  }
  __device__ __forceinline__ void st(int k, T v) const {
    if constexpr (kVolatile) *reinterpret_cast<volatile T*>(p + k) = v;
    else p[k] = v;
  }
};

// Systems per block: 32, or 16 where 32 would take more than 100 KB of
// shared memory (float64 at N >= 20), so that two blocks share an SM.
template <typename T, int N>
__host__ __device__ constexpr int systems() {
  return sizeof(T) * 32 * (N * N + N) <= 100 * 1024 ? 32 : 16;
}

template <typename T, int N>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(T) * systems<T, N>() * (N * N + N);
}

// n contiguous elements from global into shared memory: 16-byte copies
// where src is 16-byte aligned (dst always is), element copies otherwise
// and for the tail.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      int n) {
  constexpr int kPer = 16 / sizeof(T);
  int e0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nv = n / kPer;
    for (int q = threadIdx.x; q < nv; q += blockDim.x) {
      cp_async16(dst + q * kPer, src + q * kPer);
    }
    e0 = nv * kPer;
  }
  for (int e = e0 + threadIdx.x; e < n; e += blockDim.x) {
    cp_async(dst + e, src + e);
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(systems<T, N>())
chol_solve_kernel(const T* __restrict__ H, const T* __restrict__ g,
                  T* __restrict__ x, int B) {
  constexpr int S = systems<T, N>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* hs = reinterpret_cast<T*>(smem_raw);   // [S][N][N], as in H
  T* gs = hs + S * N * N;                   // [S][N], as in g, then x

  const long long b0 = static_cast<long long>(blockIdx.x) * S;
  const int rows = static_cast<int>(min(static_cast<long long>(S), B - b0));

  // Stage the block's slabs of H and g, every copy in flight at once.
  stage(hs, H + b0 * (N * N), rows * N * N);
  stage(gs, g + b0 * N, rows * N);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  if (static_cast<int>(threadIdx.x) < rows) {
    // H's lower triangle in, L's out (row-major, in place); g in, y, then x.
    const Smem<T, N> L{hs + threadIdx.x * (N * N)};
    const Smem<T, N> y{gs + threadIdx.x * N};
#pragma unroll
    for (int j = 0; j < N; ++j) {
      T d = L.ld(j * N + j);
#pragma unroll
      for (int k = 0; k < j; ++k) {
        const T ljk = L.ld(j * N + k);
        d = d - ljk * ljk;
      }
      d = dev_sqrt(d);
      L.st(j * N + j, d);
      const T inv_d = T(1) / d;
#pragma unroll
      for (int i = j + 1; i < N; ++i) {
        T t = L.ld(i * N + j);
#pragma unroll
        for (int k = 0; k < j; ++k) t = t - L.ld(i * N + k) * L.ld(j * N + k);
        L.st(i * N + j, t * inv_d);
      }
    }
    // Forward substitution L y = g, then back substitution L^T x = y.
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T t = y.ld(i);
#pragma unroll
      for (int k = 0; k < i; ++k) t = t - L.ld(i * N + k) * y.ld(k);
      y.st(i, t / L.ld(i * N + i));
    }
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
      T t = y.ld(i);
#pragma unroll
      for (int k = i + 1; k < N; ++k) t = t - L.ld(k * N + i) * y.ld(k);
      y.st(i, t / L.ld(i * N + i));
    }
  }
  __syncthreads();

  // x out: the block's (rows, N) slab is gs as it lies. x is 16-byte
  // aligned, so is each block's slab (S * N * sizeof(T) bytes apart).
  T* xb = x + b0 * N;
  using V = typename Vec16<T>::type;
  constexpr int kPer = 16 / sizeof(T);
  const int n = rows * N, nv = n / kPer;
  for (int q = threadIdx.x; q < nv; q += blockDim.x) {
    reinterpret_cast<V*>(xb)[q] = reinterpret_cast<const V*>(gs)[q];
  }
  for (int e = nv * kPer + threadIdx.x; e < n; e += blockDim.x) xb[e] = gs[e];
}

template <typename T, int N>
int launch_n(const T* H, const T* g, T* x, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, N>();
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        chol_solve_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  constexpr int S = systems<T, N>();
  chol_solve_kernel<T, N><<<(B + S - 1) / S, S, smem, stream>>>(H, g, x, B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* H, const T* g, T* x, int B, int N, void* stream_ptr) {
  if (N < 1 || N > kMaxN || B < 0 ||
      (reinterpret_cast<uintptr_t>(x) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (N) {
#define FCT_CASE(n) \
    case n: return launch_n<T, n>(H, g, x, B, stream);
    FCT_CASE(1) FCT_CASE(2) FCT_CASE(3) FCT_CASE(4) FCT_CASE(5)
    FCT_CASE(6) FCT_CASE(7) FCT_CASE(8) FCT_CASE(9) FCT_CASE(10)
    FCT_CASE(11) FCT_CASE(12) FCT_CASE(13) FCT_CASE(14) FCT_CASE(15)
    FCT_CASE(16) FCT_CASE(17) FCT_CASE(18) FCT_CASE(19) FCT_CASE(20)
    FCT_CASE(21) FCT_CASE(22) FCT_CASE(23) FCT_CASE(24) FCT_CASE(25)
#undef FCT_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int fct_chol_solve_f32(const float* H, const float* g, float* x,
                                  int B, int N, void* stream) {
  return launch<float>(H, g, x, B, N, stream);
}

extern "C" int fct_chol_solve_f64(const double* H, const double* g, double* x,
                                  int B, int N, void* stream) {
  return launch<double>(H, g, x, B, N, stream);
}
