// 2x2 / stride-2 max pool over NHWC, forward and backward.
//
// Replaces the TPU kernels cl_tpu/pallas/pool_pack.py::_fwd_kernel
// (launched at pool_pack.py:238 by `maxpool2x2_packed`, and by the forward
// of `maxpool2x2_packed_tee`, which returns its input beside the pool) and
// ::_bwd_kernel (:279, both VJPs; the tee adds the skip cotangent). The
// TPU kernels pool a lane-packed [B, H, G, p*C] view into the consumer's
// packed view and route the backward through lane-permutation matmuls; on
// the GPU the tensors are NHWC as they lie, so the pool is
// y[b, i, j, c] = max over u, v in {0, 1} of x[b, 2i+u, 2j+v, c].
//
// The max compares exactly: on finite data the result equals
// F.max_pool2d bit for bit, and the backward moves dy without arithmetic
// (with the tee: one f32 add, rounded once).
//
// What bounds it on the H100: bytes (the forward reads x once, writes a
// quarter of it: 512^2 x 32 bf16 x batch 8 is 168 MB, ~50 us at
// 3.35 TB/s; the tee backward reads x, dy and ds and writes dx, 302 MB).
//
// Design: one thread per output vector of 16 bytes (8 bf16 or 4 f32
// channels); the four window loads of a warp are contiguous runs of the
// channel dimension.

#include "common.cuh"

namespace cltorch {
namespace {

constexpr int kPoolThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kPoolThreads)
maxpool_kernel(const T* __restrict__ x, T* __restrict__ y, int B, int H, int W, int C) {
  constexpr int V = Vec16<T>::N;
  const int cv = C / V, Ho = H / 2, Wo = W / 2;
  const int64_t n = (int64_t)B * Ho * Wo * cv;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % cv);
    int64_t pix = i / cv;
    const int j = (int)(pix % Wo);
    pix /= Wo;
    const int ii = (int)(pix % Ho);
    const int b = (int)(pix / Ho);
    const int64_t row0 = ((int64_t)b * H + 2 * ii) * W + 2 * j;  // pixel (2i, 2j)
    alignas(16) T q0[V], q1[V], q2[V], q3[V], out[V];
    load16<T>(q0, x, row0 * cv + c);
    load16<T>(q1, x, (row0 + 1) * cv + c);
    load16<T>(q2, x, (row0 + W) * cv + c);
    load16<T>(q3, x, (row0 + W + 1) * cv + c);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      T m = q0[k];
      if (to_f32(q1[k]) > to_f32(m)) m = q1[k];
      if (to_f32(q2[k]) > to_f32(m)) m = q2[k];
      if (to_f32(q3[k]) > to_f32(m)) m = q3[k];
      out[k] = m;
    }
    store16<T>(y, i, out);
  }
}

// Backward, one thread per output vector as above: dy goes to the first
// maximum of its window (top row if max(row 0) >= max(row 1); in the row,
// the first column if it is >= the second: pool_pack.py:181-192), zero
// elsewhere. With `ds` (the tee's skip cotangent) each of the four values
// is the routed one (already of type T, so already rounded) plus ds, added
// in f32 and rounded once (pool_pack.py:98-104).
template <typename T>
__global__ void __launch_bounds__(kPoolThreads)
maxpool_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ ds,
                   T* __restrict__ dx, int B, int H, int W, int C) {
  constexpr int V = Vec16<T>::N;
  const int cv = C / V, Ho = H / 2, Wo = W / 2;
  const int64_t n = (int64_t)B * Ho * Wo * cv;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % cv);
    int64_t pix = i / cv;
    const int j = (int)(pix % Wo);
    pix /= Wo;
    const int ii = (int)(pix % Ho);
    const int b = (int)(pix / Ho);
    const int64_t row0 = ((int64_t)b * H + 2 * ii) * W + 2 * j;  // pixel (2i, 2j)
    const int64_t at[4] = {row0 * cv + c, (row0 + 1) * cv + c, (row0 + W) * cv + c,
                           (row0 + W + 1) * cv + c};
    alignas(16) T q[4][V], g[V], out[4][V];
#pragma unroll
    for (int w = 0; w < 4; ++w) load16<T>(q[w], x, at[w]);
    load16<T>(g, dy, i);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float v0 = to_f32(q[0][k]), v1 = to_f32(q[1][k]);
      const float v2 = to_f32(q[2][k]), v3 = to_f32(q[3][k]);
      const bool top = fmaxf(v0, v1) >= fmaxf(v2, v3);
      const int win = top ? (v0 >= v1 ? 0 : 1) : (v2 >= v3 ? 2 : 3);
#pragma unroll
      for (int w = 0; w < 4; ++w) out[w][k] = w == win ? g[k] : from_f32<T>(0.f);
    }
    if (ds != nullptr) {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        alignas(16) T d[V];
        load16<T>(d, ds, at[w]);
#pragma unroll
        for (int k = 0; k < V; ++k)
          out[w][k] = from_f32<T>(__fadd_rn(to_f32(out[w][k]), to_f32(d[k])));
      }
    }
#pragma unroll
    for (int w = 0; w < 4; ++w) store16<T>(dx, at[w], out[w]);
  }
}

inline int pool_blocks(int64_t n) {
  int64_t blocks = (n + kPoolThreads - 1) / kPoolThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  return blocks < 1 ? 1 : (int)blocks;
}

template <typename T>
int maxpool_launch(const void* x, void* y, int B, int H, int W, int C, cudaStream_t st) {
  const int64_t n = (int64_t)B * (H / 2) * (W / 2) * (C / Vec16<T>::N);
  maxpool_kernel<T><<<pool_blocks(n), kPoolThreads, 0, st>>>(static_cast<const T*>(x),
                                                             static_cast<T*>(y), B, H, W, C);
  return (int)cudaGetLastError();
}

template <typename T>
int maxpool_bwd_launch(const void* x, const void* dy, const void* ds, void* dx, int B, int H,
                       int W, int C, cudaStream_t st) {
  const int64_t n = (int64_t)B * (H / 2) * (W / 2) * (C / Vec16<T>::N);
  maxpool_bwd_kernel<T><<<pool_blocks(n), kPoolThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const T*>(ds),
      static_cast<T*>(dx), B, H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cltorch

// Plain C interface, loaded with ctypes; returns cudaGetLastError(). The
// wrapper (cl_tpu_torch/kernels/pool_pack.py) checks: contiguous NHWC,
// 16-byte aligned, H and W even, C * itemsize a multiple of 16; dy of the
// pool's shape, ds (nullptr for the plain pool) of x's.
extern "C" {

int cltorch_maxpool_fwd(const void* x, void* y, int B, int H, int W, int C, int is_bf16,
                        void* stream) {
  using namespace cltorch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? maxpool_launch<__nv_bfloat16>(x, y, B, H, W, C, st)
                 : maxpool_launch<float>(x, y, B, H, W, C, st);
}

int cltorch_maxpool_bwd(const void* x, const void* dy, const void* ds, void* dx, int B, int H,
                        int W, int C, int is_bf16, void* stream) {
  using namespace cltorch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? maxpool_bwd_launch<__nv_bfloat16>(x, dy, ds, dx, B, H, W, C, st)
                 : maxpool_bwd_launch<float>(x, dy, ds, dx, B, H, W, C, st);
}

}  // extern "C"
