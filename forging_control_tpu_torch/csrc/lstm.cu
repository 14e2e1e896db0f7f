// Stacked-LSTM surrogate forward over a whole window, batch-tiled.
//
// Replaces the Pallas TPU kernel `_kernel` driven by `apply_pallas`
// (forging_control_tpu/ops/lstm_pallas.py:29-102): per timestep and layer
// gates = inp @ w_ih + h @ w_hh in torch gate order (i, f, g, o), bias-free
// cells, zero initial (h, c), and the readout h_last @ w_out (+ b_out) of
// the last timestep. The TPU kernel pads the batch to `block_b` tiles, holds
// every weight in VMEM and unrolls T. None of that carries over: here
//
// * one block owns kRows batch rows; the ragged last block is masked, so
//   the wrapper pads nothing;
// * thread `col` owns gate column col for all kRows rows (a strided loop
//   when 4H exceeds the block), and keeps the kRows partial sums of
//   inp @ w_ih and h @ w_hh in registers, so each weight it reads serves
//   kRows rows;
// * each row's h and c for every layer, the gate pre-activations and the
//   input row live in shared memory (16 KB in float32 at I = 5, H = 50,
//   L = 3);
// * the weights (0.2 MB at full width) are read as they lie, row-major
//   (I_l, 4H) and (H, 4H), through the read-only path; neighbouring threads
//   read neighbouring columns, and the working set sits in L1 and L2;
// * a __syncthreads() separates the gate products from the nonlinearity and
//   state update of each (timestep, layer).
//
// T, I, H, L, O and B are runtime values (H <= 256, L <= 16). Arithmetic is
// that of the plain version (`lstm_forward_torch`): the two products are
// summed separately and then added, sigmoid is 1 / (1 + exp(-v)), with
// precise expf/tanhf (no fast math).
//
// Bound on an H100: operations. At the main path's shape (B = 24000
// windows, T = 10, I = 5, H = 50, L = 3, O = 4) one call does 2.45e10
// floating-point operations of the gate products, 0.37 ms at the 67 TFLOP/s
// float32 rate outside the tensor cores, against 5.4 MB of inputs and
// outputs (under 2 us at 3.35 TB/s). This first version issues one shared
// load per multiply-add and uses no tensor cores; wgmma tiles of the gate
// products are later work.
//
// The C interface takes raw device pointers (host arrays of L pointers for
// the per-layer weights) and the CUDA stream, launches on that stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError()
// (or cudaErrorInvalidValue for shapes outside the supported range).

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;            // batch rows per block
constexpr int kMaxLayers = 16;
constexpr int kMaxHidden = 256;     // 4H gate columns <= 1024 threads
constexpr size_t kMaxSmem = 232448; // a block's shared-memory limit
constexpr size_t kDefaultSmem = 48 * 1024;

template <typename T>
struct Weights {
  const T* w_ih[kMaxLayers];  // layer l: (I_l, 4H), I_0 = I, I_l = H
  const T* w_hh[kMaxLayers];  // layer l: (H, 4H)
};

__device__ __forceinline__ float dev_exp(float v) { return expf(v); }
__device__ __forceinline__ double dev_exp(double v) { return exp(v); }
__device__ __forceinline__ float dev_tanh(float v) { return tanhf(v); }
__device__ __forceinline__ double dev_tanh(double v) { return tanh(v); }

template <typename T>
__device__ __forceinline__ T sigmoid(T v) {
  return T(1) / (T(1) + dev_exp(-v));
}

template <typename T>
size_t smem_bytes(int I, int H, int L) {
  // h and c per layer, the 4H gate pre-activations, the input row.
  return sizeof(T) * (static_cast<size_t>(2) * L * kRows * H +
                      static_cast<size_t>(kRows) * 4 * H +
                      static_cast<size_t>(kRows) * I);
}

template <typename T>
__global__ void lstm_forward_kernel(const T* __restrict__ x, Weights<T> w,
                                    const T* __restrict__ w_out,
                                    const T* __restrict__ b_out,
                                    T* __restrict__ out, int B, int Tn,
                                    int I, int H, int L, int O) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = 4 * H;
  T* hs = reinterpret_cast<T*>(smem_raw);   // [L][kRows][H]
  T* cs = hs + L * kRows * H;               // [L][kRows][H]
  T* gates = cs + L * kRows * H;            // [kRows][G]
  T* xin = gates + kRows * G;               // [kRows][I]

  const long long b0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows),
                                        B - b0));
  const int tid = threadIdx.x;

  for (int p = tid; p < 2 * L * kRows * H; p += blockDim.x) hs[p] = T(0);

  for (int t = 0; t < Tn; ++t) {
    for (int p = tid; p < kRows * I; p += blockDim.x) {
      const int r = p / I, k = p % I;
      xin[p] = r < rows ? x[((b0 + r) * Tn + t) * I + k] : T(0);
    }
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      const T* inp = l == 0 ? xin : hs + (l - 1) * kRows * H;
      const int K = l == 0 ? I : H;
      T* h = hs + l * kRows * H;
      T* c = cs + l * kRows * H;

      // Gate products: column col of inp @ w_ih and of h @ w_hh.
      for (int col = tid; col < G; col += blockDim.x) {
        T a[kRows], s[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) a[r] = s[r] = T(0);
        const T* wi = w.w_ih[l] + col;
        for (int k = 0; k < K; ++k) {
          const T wk = __ldg(wi + static_cast<size_t>(k) * G);
#pragma unroll
          for (int r = 0; r < kRows; ++r) a[r] += inp[r * K + k] * wk;
        }
        const T* wh = w.w_hh[l] + col;
        for (int k = 0; k < H; ++k) {
          const T wk = __ldg(wh + static_cast<size_t>(k) * G);
#pragma unroll
          for (int r = 0; r < kRows; ++r) s[r] += h[r * H + k] * wk;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) gates[r * G + col] = a[r] + s[r];
      }
      __syncthreads();

      // Nonlinearity and state update of (row, unit) pairs.
      for (int p = tid; p < kRows * H; p += blockDim.x) {
        const int r = p / H, j = p % H;
        const T* g = gates + r * G;
        const T ig = sigmoid(g[j]);
        const T fg = sigmoid(g[H + j]);
        const T gg = dev_tanh(g[2 * H + j]);
        const T og = sigmoid(g[3 * H + j]);
        const T cn = fg * c[p] + ig * gg;
        c[p] = cn;
        h[p] = og * dev_tanh(cn);
      }
      __syncthreads();
    }
  }

  // Readout of the last layer's h at the last timestep.
  const T* hl = hs + (L - 1) * kRows * H;
  for (int p = tid; p < rows * O; p += blockDim.x) {
    const int r = p / O, o = p % O;
    T acc = T(0);
    for (int k = 0; k < H; ++k) acc += hl[r * H + k] * __ldg(w_out + k * O + o);
    if (b_out != nullptr) acc += __ldg(b_out + o);
    out[(b0 + r) * O + o] = acc;
  }
}

template <typename T>
int launch(const T* x, const void* const* w_ih, const void* const* w_hh,
           const T* w_out, const T* b_out, T* out, int B, int Tn, int I,
           int H, int L, int O, void* stream_ptr) {
  if (B < 0 || Tn < 1 || I < 1 || H < 1 || H > kMaxHidden || L < 1 ||
      L > kMaxLayers || O < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes<T>(I, H, L);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  Weights<T> w{};
  for (int l = 0; l < L; ++l) {
    w.w_ih[l] = static_cast<const T*>(w_ih[l]);
    w.w_hh[l] = static_cast<const T*>(w_hh[l]);
  }
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_forward_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = (4 * H + 31) / 32 * 32;   // <= 1024 as H <= 256
  const int blocks = (B + kRows - 1) / kRows;
  lstm_forward_kernel<T><<<blocks, threads, smem,
                           static_cast<cudaStream_t>(stream_ptr)>>>(
      x, w, w_out, b_out, out, B, Tn, I, H, L, O);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fct_lstm_forward_f32(const float* x, const void* const* w_ih,
                                    const void* const* w_hh,
                                    const float* w_out, const float* b_out,
                                    float* out, int B, int T, int I, int H,
                                    int L, int O, void* stream) {
  return launch<float>(x, w_ih, w_hh, w_out, b_out, out, B, T, I, H, L, O,
                       stream);
}

extern "C" int fct_lstm_forward_f64(const double* x, const void* const* w_ih,
                                    const void* const* w_hh,
                                    const double* w_out, const double* b_out,
                                    double* out, int B, int T, int I, int H,
                                    int L, int O, void* stream) {
  return launch<double>(x, w_ih, w_hh, w_out, b_out, out, B, T, I, H, L, O,
                        stream);
}
