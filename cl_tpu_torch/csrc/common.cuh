// Shared device helpers for the cl_tpu_torch kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cltorch {
namespace {  // internal linkage: each .cu file carries its own copy

constexpr float kNegInf = -1e9f;  // valid-class mask value (losses.NEG_INF)
constexpr int kReduceThreads = 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch and XLA cast
}

// Round an f32 value through T and back (identity for float).
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sum of one value per thread over the block, in a fixed order: warp
// shuffles, then warp 0 over the warp sums. Result valid in thread 0.
// `scratch` holds blockDim.x / 32 floats.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  v = 0.f;
  if (warp == 0) {
    v = lane < nwarps ? scratch[lane] : 0.f;
    v = warp_sum(v);
  }
  return v;
}

// out[j] = sum_i part[i * stride + j] for j < n, i < rows, each output
// summed by one block in a fixed order (strided per-thread sums, then
// block_sum): deterministic, no atomics. Launch with grid n, block
// kReduceThreads.
__global__ void reduce_rows_kernel(const float* __restrict__ part, int rows,
                                   int stride, int n, float* __restrict__ out) {
  __shared__ float scratch[kReduceThreads / 32];
  const int j = blockIdx.x;
  float acc = 0.f;
  for (int i = threadIdx.x; i < rows; i += blockDim.x) acc += part[(int64_t)i * stride + j];
  acc = block_sum(acc, scratch);
  if (threadIdx.x == 0) out[j] = acc;
}

}  // namespace
}  // namespace cltorch
