// Stacked-LSTM surrogate forward over a whole window, batch-tiled.
//
// Replaces the Pallas TPU kernel `_kernel` driven by `apply_pallas`
// (forging_control_tpu/ops/lstm_pallas.py:29-102): per timestep and layer
// gates = inp @ w_ih + h @ w_hh in torch gate order (i, f, g, o), bias-free
// cells, zero initial (h, c), and the readout h_last @ w_out (+ b_out) of
// the last timestep. The TPU kernel pads the batch to `block_b` tiles, holds
// every weight in VMEM and unrolls T. None of that carries over. Two
// variants, chosen by shape and dtype alone (`ops/lstm.py` `variant`, which
// mirrors the shared-memory arithmetic below):
//
// "mma" — float32 with H <= 64 whose block fits in shared memory (the main
// path: B = 24000 windows, T = 10, I = 5, H = 50, L = 3, O = 4).
//
//   Bound on an H100: operations. One call does 2.449e10 FLOP of gate
//   products: 0.366 ms at the 67 TFLOP/s float32 rate outside the tensor
//   cores, 0.148 ms as three TF32 passes at 495 TFLOP/s (this design's
//   bound), against 5.4 MB of inputs and outputs (under 2 us at 3.35 TB/s).
//   The general variant below executes one shared load per multiply-add
//   (the rate of load instructions caps it near a fifth of the SIMT rate),
//   uses no tensor cores, fetches the weights from L1/L2 for every 8 rows
//   and (t, l) step, and round-trips the gates through shared memory.
//   Here:
//
//   * gate products on the tensor cores, mma.sync.m16n8k8 TF32 in three
//     passes (3xTF32): each operand a = a_hi + a_lo with a_hi = tf32(a),
//     a_lo = tf32(a - a_hi), and a_lo b_hi + a_hi b_lo + a_hi b_hi summed in
//     float32. One TF32 pass misses the float32 bound of the JAX package
//     (rtol 2e-5 / atol 2e-6 against `lstm_forward_torch`); three stay
//     inside it (tests/test_torch_lstm.py emulates both). The tensor cores
//     round every mma's sum toward zero, so the three passes of each k-step
//     go into a fresh accumulator that is then added to the gate's float32
//     sum with round to nearest: chained into one accumulator, the bias of
//     24 such roundings a gate met the bound in one forward but compounded
//     in a 290-step free-running rollout to ten times it (the test emulates
//     both);
//   * a block owns kMmaRows = 32 batch rows (two m16 tiles), so each weight
//     fragment read from shared memory serves 32 rows; when the whole batch
//     fits in one wave of 16-row blocks (B <= 16 x the SM count: the shadow
//     pass at B = 300, a free-running step at B = 1) a block owns 16, which
//     halves each (t, l) step of the chain of 30 that bounds such a call.
//     The ragged last block is masked, so the wrapper pads nothing;
//   * layer-major order: layer l runs over all T before layer l + 1, so only
//     one layer's weights are in shared memory at a time (all three, 204 KB,
//     do not fit beside the state in 227 KB). They are copied in with
//     cp.async once per layer and block, into fragment order (each lane's
//     two B values adjacent, one 8-byte conflict-free load per n8 tile),
//     with K padded to a multiple of 8 (I = 5 -> 8, H = 50 -> 56) and the
//     padded rows and columns zero. No double buffering: the state and one
//     layer's weights take 188 KB of the 227 KB;
//   * the sequence of h of the layer below stays in shared memory ([T][32]
//     rows, an odd-in-words-of-8 stride of 60 floats, so A-fragment loads
//     are conflict-free); layer l's h(t) overwrites it one step later, once
//     every warp has read slot t;
//   * warp w owns hidden units 8w..8w+7 across all four gates (n8 tiles j,
//     H8+j, 2H8+j, 3H8+j), so i, f, g and o of one (row, unit) land in one
//     thread's accumulators: the cell update runs in registers, c never
//     leaves them, only h goes to shared memory (double-buffered by t), and
//     each (t, l) step has one barrier;
//   * the loops over the padded K are unrolled (UT = H8 / 8 is a template
//     parameter, 1..8).
//
// "simt" — every other shape and float64: the first version of this kernel,
// kept as the general variant. One block owns kRows = 8 rows; thread `col`
// owns gate column col for all 8 rows and keeps their partial sums in
// registers; h, c, the gates and the input row live in shared memory; the
// weights are read as they lie through the read-only path; a barrier
// separates the products from the nonlinearity of each (t, l).
//
// Arithmetic: the plain version's recurrence (`lstm_forward_torch`):
// sigmoid is 1 / (1 + exp(-v)), with the precise expf, tanhf and division in
// both variants, so the products are the only source of difference. The
// simt variant sums the two products apart and then adds, as the plain
// version does; the mma variant adds both, k-step by k-step, into one
// float32 sum. T, I,
// H, L, O and B are runtime values (H <= 256, L <= 16).
//
// The C interface takes raw device pointers (host arrays of L pointers for
// the per-layer weights) and the CUDA stream, launches on that stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError()
// (or cudaErrorInvalidValue for shapes outside the template range, or the
// error of a shared-memory request above the card's limit). Which variant
// takes a shape is decided by the caller alone (`variant`). No host
// synchronisation or allocation happens inside a launch, so either variant
// can be captured in a CUDA graph.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxLayers = 16;
constexpr int kMaxHidden = 256;     // simt: 4H gate columns <= 1024 threads
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

// ---------------------------------------------------------------- mma ----

constexpr int kMmaRows = 32;        // batch rows per block: two m16 tiles
constexpr int kMaxUnitTiles = 8;    // H8 = 8 * UT <= 64
constexpr int kMaxDevices = 64;

struct MmaShape {
  int ki, h8, sa, w_floats;
};

__host__ __device__ inline MmaShape mma_shape(int I, int H) {
  MmaShape s;
  s.ki = (I + 7) / 8 * 8;                         // padded input width
  s.h8 = (H + 7) / 8 * 8;                         // padded hidden width
  const int kmax = s.ki > s.h8 ? s.ki : s.h8;
  s.sa = kmax + 4;                                // row stride, 4 mod 8
  s.w_floats = (kmax + s.h8) / 8 * (4 * s.h8 / 8) * 64;  // one layer
  return s;
}

inline size_t mma_smem_bytes(int Tn, int I, int H, int rows) {
  const MmaShape s = mma_shape(I, H);
  return sizeof(float) * (static_cast<size_t>(s.w_floats) +
                          static_cast<size_t>(Tn + 2) * rows * s.sa);
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(addr),
               "l"(src));
}

// acc[m][q] += A[rows of m-tile m][K] @ B-fragments of gate q, warp w, over
// NK k-steps of 8. A is row-major in shared memory with stride sa; wf holds
// the layer's fragments [kstep][4 * UT n8 tiles][32 lanes][2].
template <int UT, int NK, int MT>
__device__ __forceinline__ void gate_product(float (&acc)[MT][4][4],
                                             const float* __restrict__ A,
                                             int sa,
                                             const float* __restrict__ wf,
                                             int ks0, int w, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int ks = 0; ks < NK; ++ks) {
    uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float* a = A + (m * 16 + g) * sa + ks * 8 + t4;
      split_tf32(a[0], ahi[m][0], alo[m][0]);
      split_tf32(a[8 * sa], ahi[m][1], alo[m][1]);
      split_tf32(a[4], ahi[m][2], alo[m][2]);
      split_tf32(a[8 * sa + 4], ahi[m][3], alo[m][3]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 b = *reinterpret_cast<const float2*>(
          wf + (((ks0 + ks) * 4 * UT + q * UT + w) * 32 + lane) * 2);
      uint32_t bhi0, blo0, bhi1, blo1;
      split_tf32(b.x, bhi0, blo0);
      split_tf32(b.y, bhi1, blo1);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        // A fresh accumulator per k-step: the tensor cores round each sum
        // toward zero, so chaining all of a gate's mma into acc biases it
        // by up to one float32 ulp per mma (24 a gate at H = 50); here only
        // within one k-step, and acc adds it with round to nearest.
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(d, alo[m], bhi0, bhi1);
        mma_tf32(d, ahi[m], blo0, blo1);
        mma_tf32(d, ahi[m], bhi0, bhi1);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][q][e] += d[e];
      }
    }
  }
}

// The layer-0 input product: nk (= ki / 8) k-steps, usually one.
template <int UT, int MT>
__device__ __forceinline__ void input_product(float (&acc)[MT][4][4],
                                              const float* A, int sa,
                                              const float* wf, int nk, int w,
                                              int lane) {
  for (int ks = 0; ks < nk; ++ks) {
    gate_product<UT, 1, MT>(acc, A + ks * 8, sa, wf, ks, w, lane);
  }
}

// Copies a (K, 4H) row-major weight into fragment order at k-step ks0:
// element (k, q*H + u) goes to n8 tile q*UT + u/8, lane (u%8)*4 + k%4,
// slot (k%8)/4. Neighbouring threads read neighbouring columns.
template <int UT>
__device__ __forceinline__ void stage_weight(float* wf,
                                             const float* __restrict__ src,
                                             int K, int H, int ks0) {
  const int G = 4 * H;
  for (int col = threadIdx.x; col < G; col += blockDim.x) {
    const int q = col / H, u = col % H;
    float* dst = wf + ((ks0 * 4 * UT + q * UT + u / 8) * 32 + (u % 8) * 4) * 2;
    for (int k = 0; k < K; ++k) {
      const int kk = k % 8;
      cp_async4(dst + ((k / 8) * 4 * UT * 32 + (kk & 3)) * 2 + (kk >> 2),
                src + static_cast<size_t>(k) * G + col);
    }
  }
}

// UT warps of 8 hidden units; MT m16 tiles of batch rows per block (2 in
// general, 1 when the whole batch fits in one wave of blocks: half the
// work per (t, l) step for the same latency-bound chain of steps).
template <int UT, int MT>
__global__ void __launch_bounds__(32 * UT, 1)
lstm_forward_mma_kernel(const float* __restrict__ x, Weights<float> w,
                        const float* __restrict__ w_out,
                        const float* __restrict__ b_out,
                        float* __restrict__ out, int B, int Tn, int I, int H,
                        int L, int O) {
  constexpr int H8 = 8 * UT;
  constexpr int kRowsB = 16 * MT;
  extern __shared__ __align__(16) float smem[];
  const MmaShape shp = mma_shape(I, H);
  const int sa = shp.sa, ki = shp.ki;
  float* wf = smem;                               // one layer's fragments
  float* seq = wf + shp.w_floats;                 // [Tn][kRowsB][sa]
  float* hbuf = seq + Tn * kRowsB * sa;         // [2][kRowsB][sa]

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long long b0 = static_cast<long long>(blockIdx.x) * kRowsB;
  const int rows = static_cast<int>(min(static_cast<long long>(kRowsB),
                                        B - b0));

  // The windows into seq[t][r][0..ki), zero-padded in k and in rows.
  for (int p = tid; p < kRowsB * Tn * ki; p += nthreads) {
    const int r = p / (Tn * ki), t = (p / ki) % Tn, c = p % ki;
    seq[(t * kRowsB + r) * sa + c] =
        r < rows && c < I ? x[((b0 + r) * Tn + t) * I + c] : 0.f;
  }

  for (int l = 0; l < L; ++l) {
    const int kin = l == 0 ? ki : H8;
    const int nk_in = kin / 8;
    const int layer_floats = (kin + H8) / 8 * 4 * UT * 64;
    // Stage layer l's weights (every earlier reader of wf has passed the
    // last barrier of layer l - 1).
    float4* wf4 = reinterpret_cast<float4*>(wf);
    for (int p = tid; p < layer_floats / 4; p += nthreads) {
      wf4[p] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    stage_weight<UT>(wf, w.w_ih[l], l == 0 ? I : H, H, 0);
    stage_weight<UT>(wf, w.w_hh[l], H, H, nk_in);
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();

    const bool last = l == L - 1;
    float c[MT][4], h[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int e = 0; e < 4; ++e) c[m][e] = h[m][e] = 0.f;
    }
    for (int t = 0; t < Tn; ++t) {
      if (!last && t > 0) {
        // h(t - 1) into slot t - 1: every warp has read it (last barrier).
        float* s = seq + (t - 1) * kRowsB * sa;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int col = warp * 8 + 2 * t4;
          *reinterpret_cast<float2*>(s + (m * 16 + g) * sa + col) =
              make_float2(h[m][0], h[m][1]);
          *reinterpret_cast<float2*>(s + (m * 16 + g + 8) * sa + col) =
              make_float2(h[m][2], h[m][3]);
        }
      }
      float acc[MT][4][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][q][e] = 0.f;
        }
      }
      const float* inp = seq + t * kRowsB * sa;
      if (l == 0) {
        input_product<UT, MT>(acc, inp, sa, wf, nk_in, warp, lane);
      } else {
        gate_product<UT, UT, MT>(acc, inp, sa, wf, 0, warp, lane);
      }
      if (t > 0) {
        gate_product<UT, UT, MT>(acc, hbuf + ((t - 1) & 1) * kRowsB * sa, sa,
                             wf, nk_in, warp, lane);
      }
      // Cell update in registers; h out to hbuf[t & 1].
      float* hb = hbuf + (t & 1) * kRowsB * sa;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ig = sigmoid(acc[m][0][e]);
          const float fg = sigmoid(acc[m][1][e]);
          const float gg = dev_tanh(acc[m][2][e]);
          const float og = sigmoid(acc[m][3][e]);
          c[m][e] = fg * c[m][e] + ig * gg;
          h[m][e] = og * dev_tanh(c[m][e]);
        }
        const int col = warp * 8 + 2 * t4;
        *reinterpret_cast<float2*>(hb + (m * 16 + g) * sa + col) =
            make_float2(h[m][0], h[m][1]);
        *reinterpret_cast<float2*>(hb + (m * 16 + g + 8) * sa + col) =
            make_float2(h[m][2], h[m][3]);
      }
      __syncthreads();
    }
    if (!last) {
      float* s = seq + (Tn - 1) * kRowsB * sa;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int col = warp * 8 + 2 * t4;
        *reinterpret_cast<float2*>(s + (m * 16 + g) * sa + col) =
            make_float2(h[m][0], h[m][1]);
        *reinterpret_cast<float2*>(s + (m * 16 + g + 8) * sa + col) =
            make_float2(h[m][2], h[m][3]);
      }
      __syncthreads();
    }
  }

  // Readout of the last layer's h at the last timestep.
  const float* hl = hbuf + ((Tn - 1) & 1) * kRowsB * sa;
  for (int p = tid; p < rows * O; p += nthreads) {
    const int r = p / O, o = p % O;
    float acc = 0.f;
    for (int k = 0; k < H; ++k) acc += hl[r * sa + k] * __ldg(w_out + k * O + o);
    if (b_out != nullptr) acc += __ldg(b_out + o);
    out[(b0 + r) * O + o] = acc;
  }
}

template <int UT, int MT>
int launch_mma_ut(const float* x, const Weights<float>& w, const float* w_out,
                  const float* b_out, float* out, int B, int Tn, int I, int H,
                  int L, int O, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(Tn, I, H, 16 * MT);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_forward_mma_kernel<UT, MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (B + 16 * MT - 1) / (16 * MT);
  lstm_forward_mma_kernel<UT, MT><<<blocks, 32 * UT, smem, stream>>>(
      x, w, w_out, b_out, out, B, Tn, I, H, L, O);
  return static_cast<int>(cudaGetLastError());
}

// The current device's SM count, read once per device.
cudaError_t sm_count(int& sms) {
  static int cached[kMaxDevices] = {};
  int device = 0;
  const cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device >= kMaxDevices) {
    return cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device);
  }
  if (cached[device] == 0) {
    int n = 0;
    const cudaError_t ea =
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (ea != cudaSuccess) return ea;
    cached[device] = n;
  }
  sms = cached[device];
  return cudaSuccess;
}

template <int UT>
int launch_mma_rows(const float* x, const Weights<float>& w,
                    const float* w_out, const float* b_out, float* out, int B,
                    int Tn, int I, int H, int L, int O, cudaStream_t stream) {
  // 16 rows per block when that still makes one wave (one block per SM).
  int sms = 0;
  const cudaError_t e = sm_count(sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  if ((B + 15) / 16 <= sms) {
    return launch_mma_ut<UT, 1>(x, w, w_out, b_out, out, B, Tn, I, H, L, O,
                                stream);
  }
  return launch_mma_ut<UT, kMmaRows / 16>(x, w, w_out, b_out, out, B, Tn, I,
                                          H, L, O, stream);
}

int launch_mma(const float* x, const void* const* w_ih,
               const void* const* w_hh, const float* w_out,
               const float* b_out, float* out, int B, int Tn, int I, int H,
               int L, int O, void* stream_ptr) {
  const int ut = (H + 7) / 8;
  if (B < 0 || Tn < 1 || I < 1 || H < 1 || ut > kMaxUnitTiles || L < 1 ||
      L > kMaxLayers || O < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaSuccess);
  Weights<float> w{};
  for (int l = 0; l < L; ++l) {
    w.w_ih[l] = static_cast<const float*>(w_ih[l]);
    w.w_hh[l] = static_cast<const float*>(w_hh[l]);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (ut) {
#define FCT_CASE(n)                                                       \
    case n:                                                               \
      return launch_mma_rows<n>(x, w, w_out, b_out, out, B, Tn, I, H, L,  \
                                O, stream);
    FCT_CASE(1) FCT_CASE(2) FCT_CASE(3) FCT_CASE(4)
    FCT_CASE(5) FCT_CASE(6) FCT_CASE(7) FCT_CASE(8)
#undef FCT_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// --------------------------------------------------------------- simt ----

constexpr int kRows = 8;            // batch rows per block

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

extern "C" int fct_lstm_forward_mma_f32(const float* x,
                                        const void* const* w_ih,
                                        const void* const* w_hh,
                                        const float* w_out,
                                        const float* b_out, float* out, int B,
                                        int T, int I, int H, int L, int O,
                                        void* stream) {
  return launch_mma(x, w_ih, w_hh, w_out, b_out, out, B, T, I, H, L, O,
                    stream);
}

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
