// EWC over the flat f32 parameter vector: the penalty, its gradient and the
// Fisher pass's squared-gradient accumulation.
//
// Replaces the TPU kernels of cl_tpu/pallas/ewc_fused.py:
//   ::_penalty_kernel (launched at ewc_fused.py:72)  total = sum_i F_i (theta_i - a_i)^2
//   ::_grad_kernel    (ewc_fused.py:95)              dtheta_i = (2 g F_i) (theta_i - a_i)
//   ::_sq_acc_kernel  (ewc_fused.py:163)             acc_i = acc_i + g_i^2, in place
// theta, anchor a, Fisher F, acc and g are f32 vectors of n elements; g of
// the gradient kernel is the penalty's 0-d cotangent, read from device
// memory (never fetched to the host).
//
// What bounds them on the H100: bytes. At n = 7.76 M (UNet-32, depth 4) the
// penalty reads 3 x 31 MB (~28 us at 3.35 TB/s), the gradient moves 4 x 31 MB
// (~37 us), the accumulation 3 x 31 MB (~28 us); each does a few operations
// per element.
//
// Design: grid-stride passes with 16-byte loads (four floats a thread a
// step) where every pointer is 16-byte aligned, and a scalar tail for the
// n % 4 last elements (the caller passes vec = 0 for a misaligned pointer,
// such as a row of a [T, n] state at odd n: any n, no padding). The TPU
// kernel walked a chunked grid in order and carried one scalar across it;
// here the blocks run in parallel, so the penalty writes one partial sum per
// block and a second kernel adds the partials in a fixed order. The grid is
// a function of n alone, so the sum runs in the same order on every call
// and card: a relaunch repeats every bit, with no float atomics. The
// gradient and the accumulation round as the plain PyTorch versions do
// (each product rounded, no contraction into an FMA), so they agree with
// them bit for bit.
//
// The accumulation (#19) runs once per Fisher batch at the data rate: its
// first version (a grid of at most 2048 blocks, 1.94 waves of resident
// blocks at n = 7.76 M, one float4 of acc and of g in flight a thread,
// cached loads of data used once) read 0.039-0.077 ms against the 0.028
// of its bound and addcmul_'s 0.035 (NVIDIA H100 80GB HBM3, 700.00 W,
// PERF.md). It now runs one wave: the resident blocks of the card
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, read once per
// device), each thread kSqAccUnroll float4s of acc and of g in flight
// before its first store, with streaming hints (__ldcs / __stcs: every
// byte is read once and written once). The grid changes no bit: each
// element is its own sum.

#include "common.cuh"

namespace cltorch {
namespace {

constexpr int kEwcThreads = 256;
constexpr int kEwcMaxBlocks = 2048;  // elementwise passes

__device__ __forceinline__ float4 ld4(const float* p, int64_t i) {
  return reinterpret_cast<const float4*>(p)[i];
}

__device__ __forceinline__ float pen_term(float t, float a, float f) {
  const float d = __fsub_rn(t, a);
  return __fmul_rn(__fmul_rn(f, d), d);
}

__global__ void __launch_bounds__(kEwcThreads)
ewc_penalty_kernel(const float* __restrict__ theta, const float* __restrict__ anchor,
                   const float* __restrict__ fisher, int64_t n, int vec,
                   float* __restrict__ partials) {
  __shared__ float scratch[kEwcThreads / 32];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n4 = vec ? n / 4 : 0;
  float acc = 0.f;
  for (int64_t i = t0; i < n4; i += stride) {
    const float4 t = ld4(theta, i), a = ld4(anchor, i), f = ld4(fisher, i);
    acc += pen_term(t.x, a.x, f.x) + pen_term(t.y, a.y, f.y) +
           (pen_term(t.z, a.z, f.z) + pen_term(t.w, a.w, f.w));
  }
  for (int64_t i = 4 * n4 + t0; i < n; i += stride) acc += pen_term(theta[i], anchor[i], fisher[i]);
  acc = block_sum(acc, scratch);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__device__ __forceinline__ float grad_term(float g2, float t, float a, float f) {
  return __fmul_rn(__fmul_rn(g2, f), __fsub_rn(t, a));
}

__global__ void __launch_bounds__(kEwcThreads)
ewc_grad_kernel(const float* __restrict__ theta, const float* __restrict__ anchor,
                const float* __restrict__ fisher, const float* __restrict__ g,
                float* __restrict__ out, int64_t n, int vec) {
  const float g2 = __fmul_rn(2.f, g[0]);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n4 = vec ? n / 4 : 0;
  for (int64_t i = t0; i < n4; i += stride) {
    const float4 t = ld4(theta, i), a = ld4(anchor, i), f = ld4(fisher, i);
    reinterpret_cast<float4*>(out)[i] =
        make_float4(grad_term(g2, t.x, a.x, f.x), grad_term(g2, t.y, a.y, f.y),
                    grad_term(g2, t.z, a.z, f.z), grad_term(g2, t.w, a.w, f.w));
  }
  for (int64_t i = 4 * n4 + t0; i < n; i += stride)
    out[i] = grad_term(g2, theta[i], anchor[i], fisher[i]);
}

__device__ __forceinline__ float sq_term(float acc, float g) {
  return __fadd_rn(acc, __fmul_rn(g, g));
}

constexpr int kSqAccUnroll = 4;  // float4s of acc and of g a thread has in flight

__device__ __forceinline__ float4 sq_term4(const float4& a, const float4& v) {
  return make_float4(sq_term(a.x, v.x), sq_term(a.y, v.y), sq_term(a.z, v.z), sq_term(a.w, v.w));
}

__global__ void __launch_bounds__(kEwcThreads)
ewc_sq_acc_kernel(float* __restrict__ acc, const float* __restrict__ g, int64_t n, int vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n4 = vec ? n / 4 : 0;
  float4* a4 = reinterpret_cast<float4*>(acc);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  for (int64_t i = t0; i < n4; i += kSqAccUnroll * stride) {
    float4 a[kSqAccUnroll], v[kSqAccUnroll];
#pragma unroll
    for (int u = 0; u < kSqAccUnroll; ++u) {
      const int64_t j = i + u * stride;
      if (j < n4) {
        a[u] = __ldcs(a4 + j);
        v[u] = __ldcs(g4 + j);
      }
    }
#pragma unroll
    for (int u = 0; u < kSqAccUnroll; ++u) {
      const int64_t j = i + u * stride;
      if (j < n4) __stcs(a4 + j, sq_term4(a[u], v[u]));
    }
  }
  for (int64_t i = 4 * n4 + t0; i < n; i += stride) acc[i] = sq_term(acc[i], g[i]);
}

// The accumulation's grid: the card's resident blocks of it, read once per
// device (the grid changes no bit, so it may follow the card).
int sq_acc_grid() {
  constexpr int kDevices = 16;
  static int grid[kDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kDevices && grid[dev] > 0) return grid[dev];
  int per_sm = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ewc_sq_acc_kernel, kEwcThreads, 0);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks = per_sm * sms > 0 ? per_sm * sms : kEwcMaxBlocks;
  if (dev < kDevices) grid[dev] = blocks;
  return blocks;
}

// Blocks of a pass over n elements: one thread per float4 (or float), at
// most max_blocks. A function of n alone.
inline int ewc_blocks(int64_t n, int vec, int max_blocks) {
  const int64_t items = vec ? (n + 3) / 4 : n;
  const int64_t b = (items + kEwcThreads - 1) / kEwcThreads;
  return (int)(b < 1 ? 1 : (b < max_blocks ? b : max_blocks));
}

}  // namespace
}  // namespace cltorch

// Plain C interface, loaded with ctypes. Each returns cudaGetLastError()
// (0 = launched). Types, lengths and alignment are checked by the Python
// wrapper (cl_tpu_torch/kernels/ewc_fused.py); `partials` holds max_blocks
// floats, `out` of the penalty one float.
extern "C" {

int cltorch_ewc_penalty(const void* theta, const void* anchor, const void* fisher, int64_t n,
                        int vec, void* partials, void* out, int max_blocks, void* stream) {
  using namespace cltorch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblk = ewc_blocks(n, vec, max_blocks);
  ewc_penalty_kernel<<<nblk, kEwcThreads, 0, st>>>(
      static_cast<const float*>(theta), static_cast<const float*>(anchor),
      static_cast<const float*>(fisher), n, vec, static_cast<float*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<<<1, kReduceThreads, 0, st>>>(static_cast<const float*>(partials), nblk, 1,
                                                   1, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

int cltorch_ewc_grad(const void* theta, const void* anchor, const void* fisher, const void* g,
                     void* out, int64_t n, int vec, void* stream) {
  using namespace cltorch;
  ewc_grad_kernel<<<ewc_blocks(n, vec, kEwcMaxBlocks), kEwcThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(theta), static_cast<const float*>(anchor),
      static_cast<const float*>(fisher), static_cast<const float*>(g), static_cast<float*>(out),
      n, vec);
  return (int)cudaGetLastError();
}

int cltorch_ewc_sq_acc(void* acc, const void* g, int64_t n, int vec, void* stream) {
  using namespace cltorch;
  ewc_sq_acc_kernel<<<ewc_blocks(n, vec, sq_acc_grid()), kEwcThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(acc), static_cast<const float*>(g), n, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
