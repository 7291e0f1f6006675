// What the packed conv's kernels stage: the forward's t (x through the
// BN-ReLU prologue) and the backward's e (the output cotangent with the
// stats cotangents folded in). Shared by conv3x3_bn.cu (forward, dx) and
// conv3x3_bn_bwd.cu (dW), so the three round at the same points.
//
//   t = round(relu(x * a[c] + b[c]))       prologue on (else t = x)
//   e = round(dy + ds1[c] + 2 * y * ds2[c]) ds1 given (else e = dy)
//
// Both in f32, products and sums each rounded (__fmul_rn / __fadd_rn keep
// nvcc from contracting them into an FMA), as the plain PyTorch versions
// and the TPU kernels (conv3x3_v3.py:686-690, :1050-1061) compute them.
// Out-of-image pixels are staged as zero, in t-space and in e-space: a
// padded tap is 0, never relu(b) or ds1 (conv3x3_v3.py:693-716, :1069-1070).
#pragma once

#include "common.cuh"

namespace cltorch {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kTH = 16, kTW = 16;  // pixel tile (rows, cols)
constexpr int kWinH = kTH + 2, kWinW = kTW + 2;

__device__ __forceinline__ float prologue_f32(float x, float a, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(x, a), b), 0.f);
}

__device__ __forceinline__ float e_f32(float dy, float y, float s1, float s2) {
  return __fadd_rn(__fadd_rn(dy, s1), __fmul_rn(__fmul_rn(2.f, y), s2));
}

// Eight channels [c, c + 8) of one pixel (or weight row) of x into `dst`,
// zero past C or outside; with the prologue, t on the real ones.
__device__ __forceinline__ void stage8_t(bf16* dst, const bf16* src, int c, int C, bool inside,
                                         int prologue, const float* pa, const float* pb) {
  alignas(16) bf16 v[8];
  if (inside && (C & 7) == 0 && c < C) {
    load16<bf16>(v, src, 0);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = (inside && c + k < C) ? src[k] : __float2bfloat16(0.f);
  }
  if (prologue && inside) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (c + k < C)
        v[k] = __float2bfloat16(prologue_f32(__bfloat162float(v[k]), pa[c + k], pb[c + k]));
  }
  store16<bf16>(dst, 0, v);
}

// Eight channels of e at one pixel from dy and y (e = dy when s1 is null),
// zero past C or outside.
__device__ __forceinline__ void stage8_e(bf16* dst, const bf16* dy, const bf16* y, int c, int C,
                                         bool inside, const float* s1, const float* s2) {
  alignas(16) bf16 v[8];
  if (!inside || c >= C) {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = __float2bfloat16(0.f);
  } else if ((C & 7) == 0) {
    load16<bf16>(v, dy, 0);
    if (s1 != nullptr) {
      alignas(16) bf16 yv[8];
      load16<bf16>(yv, y, 0);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[k] = __float2bfloat16(
            e_f32(__bfloat162float(v[k]), __bfloat162float(yv[k]), s1[c + k], s2[c + k]));
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float e = 0.f;
      if (c + k < C) {
        e = __bfloat162float(dy[k]);
        if (s1 != nullptr)
          e = __bfloat162float(__float2bfloat16(
              e_f32(e, __bfloat162float(y[k]), s1[c + k], s2[c + k])));
      }
      v[k] = __float2bfloat16(e);
    }
  }
  store16<bf16>(dst, 0, v);
}

// One staged value (f32 kernels): t of x[i] at channel c, or e of
// (dy[i], y[i]) at channel c.
template <typename T>
__device__ __forceinline__ float t_at(const T* x, int64_t i, int c, int prologue, const float* pa,
                                      const float* pb) {
  const float v = to_f32(x[i]);
  return prologue ? round_to<T>(prologue_f32(v, pa[c], pb[c])) : v;
}

template <typename T>
__device__ __forceinline__ float e_at(const T* dy, const T* y, int64_t i, int c, const float* s1,
                                      const float* s2) {
  const float d = to_f32(dy[i]);
  return s1 == nullptr ? d : round_to<T>(e_f32(d, to_f32(y[i]), s1[c], s2[c]));
}

}  // namespace
}  // namespace cltorch
