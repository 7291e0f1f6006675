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

// 16-byte vector access: N elements of T at once (8 bf16 or 4 f32).
template <typename T> struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
};
template <typename T>
__device__ __forceinline__ void load16(T (&dst)[Vec16<T>::N], const T* base, int64_t i) {
  *reinterpret_cast<uint4*>(dst) = reinterpret_cast<const uint4*>(base)[i];
}
template <typename T>
__device__ __forceinline__ void store16(T* base, int64_t i, const T (&src)[Vec16<T>::N]) {
  reinterpret_cast<uint4*>(base)[i] = *reinterpret_cast<const uint4*>(src);
}

// d += a * b on the tensor cores: one m16n8k16 product of bf16 fragments
// (A row-major 16 x 16, B column-major 16 x 8) with f32 accumulation. Lane
// (g = lane / 4, t = lane % 4) holds a = {A[g][2t..], A[g+8][2t..],
// A[g][2t+8..], A[g+8][2t+8..]}, b = {B[2t..][g], B[2t+8..][g]} (pairs of
// consecutive k, the lower k in the low half) and d = {D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory, transposed: lanes 8i..8i+7
// give the addresses of rows 0..7 of matrix i (16 bytes each, 16-byte
// aligned), and lane (g, t) receives r[i] = {M_i[2t][g], M_i[2t+1][g]}.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The same without the transpose: lane (g, t) receives r[i] = {M_i[g][2t],
// M_i[g][2t+1]}.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Asynchronous copies global -> shared (Ampere's cp.async, on Hopper too):
// `bytes` (4, 8 or 16) when `pred`, else that many zeros (src-size 0: the
// source is not read, but must be a valid address). Completion is by
// group: commit after issuing a stage's copies, then wait until at most N
// groups are in flight, then a block barrier before reading.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = pred ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(gmem),
                 "n"(BYTES), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// sum over s < rows of p[s * stride], in order of s, from 0: UNROLL loads
// in flight before their adds (the same sum, bit for bit, at any UNROLL).
template <int UNROLL>
__device__ __forceinline__ float sum_rows(const float* __restrict__ p, int rows,
                                          int64_t stride) {
  float acc = 0.f;
  int s = 0;
  for (; s + UNROLL <= rows; s += UNROLL) {
    float v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = p[(int64_t)(s + u) * stride];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc += v[u];
  }
  for (; s < rows; ++s) acc += p[(int64_t)s * stride];
  return acc;
}

// out[j] = sum over s < splits of part[s * n + j], in order of s: the
// fixed-order sum of per-block partials (no atomics). UNROLL keeps that
// many of a thread's loads in flight (the ring bodies' many splits).
template <int UNROLL = 1>
__global__ void sum_splits_kernel(const float* __restrict__ part, int splits, int64_t n,
                                  float* __restrict__ out) {
  const int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (j >= n) return;
  out[j] = sum_rows<UNROLL>(part + j, splits, n);
}

}  // namespace
}  // namespace cltorch
