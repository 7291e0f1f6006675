// Device helpers shared by the fused head + CE kernels (head_ce.cu) and
// their BN·ReLU-prologue and KD variants (head_ce_bn.cu): one pixel per
// thread, its features staged as a row of a shared-memory tile, its C
// logits in registers.
#pragma once

#include "common.cuh"

namespace cltorch {
namespace {

constexpr int kTile = 128;     // pixels per tile = threads per block

// W (rounded to the feature type T, as head_ce.py:62 does), b and valid
// into shared memory.
template <typename T>
__device__ __forceinline__ void load_head(const float* __restrict__ w, const float* __restrict__ b,
                                          const float* __restrict__ valid, int Cin, int C,
                                          float* ws, float* bs, float* vs) {
  for (int i = threadIdx.x; i < C * Cin; i += blockDim.x) ws[i] = round_to<T>(w[i]);
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    bs[i] = b[i];
    vs[i] = valid[i];
  }
}

// Four consecutive staged features as f32 (an 8- or 16-byte aligned load).
template <typename T> __device__ __forceinline__ void load4(const unsigned char* p, float (&f)[4]);
template <> __device__ __forceinline__ void load4<float>(const unsigned char* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
template <>
__device__ __forceinline__ void load4<__nv_bfloat16>(const unsigned char* p, float (&f)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] = to_f32(h[j]);
}

// z[c] = b[c] + sum_k ws[c][k] x[k] for this thread's staged row; with
// MASK, invalid classes are set to -1e9. Returns the max over classes.
template <typename T, int CMAX, bool MASK = true>
__device__ __forceinline__ float row_logits(const unsigned char* row, const float* ws,
                                            const float* bs, const float* vs, int Cin, int C,
                                            int chunks, float (&z)[CMAX]) {
  constexpr int kVec = 16 / sizeof(T);
#pragma unroll
  for (int c = 0; c < CMAX; ++c) z[c] = c < C ? bs[c] : 0.f;
  for (int q = 0; q < chunks; ++q) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + q * 16);
    const T* xv = reinterpret_cast<const T*>(&raw);
    float xf[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) xf[j] = to_f32(xv[j]);
    const int k0 = q * kVec;
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      if (c < C) {
        // 16-byte loads of W (Cin % 4 == 0, ws 16-byte aligned): one
        // shared-memory load per 4 FMAs
        const float4* wr = reinterpret_cast<const float4*>(ws + c * Cin + k0);
        float acc = z[c];
#pragma unroll
        for (int j4 = 0; j4 < kVec / 4; ++j4) {
          const float4 wv = wr[j4];
          acc = fmaf(wv.x, xf[4 * j4], acc);
          acc = fmaf(wv.y, xf[4 * j4 + 1], acc);
          acc = fmaf(wv.z, xf[4 * j4 + 2], acc);
          acc = fmaf(wv.w, xf[4 * j4 + 3], acc);
        }
        z[c] = acc;
      }
    }
  }
  float m = kNegInf;
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    if (c < C) {
      if (MASK) z[c] = vs[c] > 0.f ? z[c] : kNegInf;
      m = fmaxf(m, z[c]);
    }
  }
  return m;
}

// Blocks for P pixels: one per tile, at most max_blocks (the rows of the
// partials buffer the caller gave).
inline int head_blocks(int P, int max_blocks) {
  const int tiles = (P + kTile - 1) / kTile;
  const int n = tiles < max_blocks ? tiles : max_blocks;
  return n > 1 ? n : 1;
}

}  // namespace
}  // namespace cltorch
