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

// ---------------------------------------------------------------------------
// int8 saved activations (model.conv_act_store=int8)
// ---------------------------------------------------------------------------
//
// A saved tensor v [B, H, W, C] is stored as q int8 [B, H, W, C] and an f32
// scale [B, H, p, C] per image row, column mod p and channel (the TPU
// kernel's per-(image-row, lane) scale of its packed view, lane j*C + c
// holding the columns w = j mod p): deq(v) = q * scale, in f32, NOT rounded
// to the compute type where the backward reads it (conv3x3_v3.py:1532-1540,
// :1577-1579, :1686-1696). The scale's row of pixel `pix` (b*H*W + h*W + w):
__device__ __forceinline__ int64_t q_scale_row(int64_t pix, int W, int p) {
  return (pix / W) * p + (pix % W) % p;
}

__device__ __forceinline__ float deq_f32(int8_t q, float scale) {
  return __fmul_rn(static_cast<float>(q), scale);
}

// e with y dequantized: e = round(dy + ds1 + 2 * deq(y) * ds2), or dy
// without stats cotangents. `i` is the element, `c` its channel of C.
template <typename T>
__device__ __forceinline__ float e_at_q(const T* dy, const int8_t* yq, const float* ysc,
                                        int64_t i, int c, int C, int W, int p, const float* s1,
                                        const float* s2) {
  const float d = to_f32(dy[i]);
  if (s1 == nullptr) return d;
  const float yv = deq_f32(yq[i], ysc[q_scale_row(i / C, W, p) * C + c]);
  return round_to<T>(e_f32(d, yv, s1[c], s2[c]));
}

// Eight int8 values and their eight scales (16-byte aligned: c and C
// multiples of 8) as f32 deq values.
__device__ __forceinline__ void deq8(float (&d)[8], const int8_t* q, const float* sc) {
  const uint2 qv = *reinterpret_cast<const uint2*>(q);
  const int8_t* q8 = reinterpret_cast<const int8_t*>(&qv);
  const float4 sa = reinterpret_cast<const float4*>(sc)[0];
  const float4 sb = reinterpret_cast<const float4*>(sc)[1];
  const float s8[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
#pragma unroll
  for (int k = 0; k < 8; ++k) d[k] = deq_f32(q8[k], s8[k]);
}

// Eight channels of e at one pixel from dy and the int8 y (`sc` the
// scales of that pixel's row and column mod p, at channel c), zero past C
// or outside.
__device__ __forceinline__ void stage8_eq(bf16* dst, const bf16* dy, const int8_t* yq,
                                          const float* sc, int c, int C, bool inside,
                                          const float* s1, const float* s2) {
  alignas(16) bf16 v[8];
  if (inside && (C & 7) == 0 && c < C) {  // vector loads
    load16<bf16>(v, dy, 0);
    if (s1 != nullptr) {
      float yv[8];
      deq8(yv, yq, sc);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[k] = __float2bfloat16(e_f32(__bfloat162float(v[k]), yv[k], s1[c + k], s2[c + k]));
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float e = 0.f;
      if (inside && c + k < C) {
        e = __bfloat162float(dy[k]);
        if (s1 != nullptr)
          e = __bfloat162float(
              __float2bfloat16(e_f32(e, deq_f32(yq[k], sc[k]), s1[c + k], s2[c + k])));
      }
      v[k] = __float2bfloat16(e);
    }
  }
  store16<bf16>(dst, 0, v);
}

// Eight channels of t from the int8 x: t = round(relu(deq(x) * a + b))
// with the prologue, else round(deq(x)), the prologue on the f32 deq(x)
// (conv3x3_v3.py:1690-1696); zero past C or outside.
__device__ __forceinline__ void stage8_tq(bf16* dst, const int8_t* xq, const float* sc, int c,
                                          int C, bool inside, int prologue, const float* pa,
                                          const float* pb) {
  alignas(16) bf16 v[8];
  float t[8];
  if (inside && (C & 7) == 0 && c < C) {  // vector loads
    deq8(t, xq, sc);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) t[k] = inside && c + k < C ? deq_f32(xq[k], sc[k]) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (prologue && inside && c + k < C) t[k] = prologue_f32(t[k], pa[c + k], pb[c + k]);
    v[k] = __float2bfloat16(t[k]);
  }
  store16<bf16>(dst, 0, v);
}

// One t of the int8 x (f32 kernels): element i, channel c of C.
template <typename T>
__device__ __forceinline__ float t_at_q(const int8_t* xq, const float* xsc, int64_t i, int c,
                                        int C, int W, int p, int prologue, const float* pa,
                                        const float* pb) {
  const float v = deq_f32(xq[i], xsc[q_scale_row(i / C, W, p) * C + c]);
  return round_to<T>(prologue ? prologue_f32(v, pa[c], pb[c]) : v);
}

}  // namespace
}  // namespace cltorch
