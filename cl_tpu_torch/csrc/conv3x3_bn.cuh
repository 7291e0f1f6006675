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
// Under CL_TPU_E_BF16=1 the bf16 kernels run both chains in bf16
// (`_ew_dtype`, conv3x3_v3.py:670-683): a, b, ds1 and ds2 are rounded to
// bf16 first, then every product and sum is rounded to bf16 before the
// next (prologue_bf16 / e_bf16; the dx epilogue keeps the f32 a and b). A
// launch takes the choice as a run-time flag (`ew_bf16`), turned into a
// compile-time one once per staging loop (with_ew), so each loop is
// compiled for both chains and neither tests the flag per element. Each op
// is taken in f32 and rounded once: a sum or product of two bf16 values
// computed in f32 (24 bits >= 2 * 8 + 2) and rounded to bf16 is the
// correctly rounded bf16 result, so the kernels, the plain versions and
// the TPU kernels agree bit for bit.
// No native bf16 FMA (fma.rn.bf16, __hfma2): one rounding of x * a + b is
// a different number.
// Out-of-image pixels are staged as zero, in t-space and in e-space: a
// padded tap is 0, never relu(b) or ds1 (conv3x3_v3.py:693-716, :1069-1070).
#pragma once

#include <type_traits>

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

// v rounded to bf16 (nearest even), as an f32.
__device__ __forceinline__ float bf16_rn(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The bf16 chains (CL_TPU_E_BF16): x, dy and y are bf16 values; the f32
// vectors are rounded here, so a kernel that also reads them in f32 (the dx
// epilogue) passes them as they are.
__device__ __forceinline__ float prologue_bf16(float x, float a, float b) {
  return fmaxf(bf16_rn(__fadd_rn(bf16_rn(__fmul_rn(x, bf16_rn(a))), bf16_rn(b))), 0.f);
}

__device__ __forceinline__ float e_bf16(float dy, float y, float s1, float s2) {
  const float d = bf16_rn(__fadd_rn(dy, bf16_rn(s1)));
  const float q = bf16_rn(__fmul_rn(bf16_rn(__fmul_rn(2.f, y)), bf16_rn(s2)));
  return bf16_rn(__fadd_rn(d, q));
}

// The chain a bf16 kernel stages: the bf16 one under EW, else the f32 one.
template <bool EW>
__device__ __forceinline__ float prologue_ew(float x, float a, float b) {
  if constexpr (EW) return prologue_bf16(x, a, b);
  else return prologue_f32(x, a, b);
}

template <bool EW>
__device__ __forceinline__ float e_ew(float dy, float y, float s1, float s2) {
  if constexpr (EW) return e_bf16(dy, y, s1, s2);
  else return e_f32(dy, y, s1, s2);
}

// f(std::true_type{}) under the bf16 chains (`ew` non-zero, uniform over
// the launch), else f(std::false_type{}): the body takes its chain as
// decltype(tag)::value.
template <typename F>
__device__ __forceinline__ void with_ew(int ew, F&& f) {
  if (ew) f(std::true_type{});
  else f(std::false_type{});
}

// The dx epilogue of the BN-ReLU prologue at one output from the f32
// accumulator dt: u = x * a + b (each rounded, no FMA), du = [u > 0] * dt,
// da += du * x, db += du; returns du * a (to be rounded to the dtype).
__device__ __forceinline__ float prologue_bwd_one(float xv, float a, float b, float dt,
                                                  float& da, float& db) {
  const float du = __fadd_rn(__fmul_rn(xv, a), b) > 0.f ? dt : 0.f;
  da = fmaf(du, xv, da);
  db += du;
  return __fmul_rn(du, a);
}

// Eight channels [c, c + 8) of one pixel (or weight row) of x into `dst`,
// zero past C or outside; with the prologue, t on the real ones (the bf16
// chain under EW).
template <bool EW = false>
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
        v[k] = __float2bfloat16(prologue_ew<EW>(__bfloat162float(v[k]), pa[c + k], pb[c + k]));
  }
  store16<bf16>(dst, 0, v);
}

// Eight channels of e at one pixel from dy and y (e = dy when s1 is null),
// zero past C or outside; the bf16 chain under EW.
template <bool EW = false>
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
            e_ew<EW>(__bfloat162float(v[k]), __bfloat162float(yv[k]), s1[c + k], s2[c + k]));
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float e = 0.f;
      if (c + k < C) {
        e = __bfloat162float(dy[k]);
        if (s1 != nullptr)
          e = __bfloat162float(__float2bfloat16(
              e_ew<EW>(e, __bfloat162float(y[k]), s1[c + k], s2[c + k])));
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

// ---------------------------------------------------------------------------
// The conv bodies' operands, their dx epilogue and the bf16 tap loop, shared
// by conv3x3_bn.cu and conv3x3_bn_bwd_fused.cu (#37)
// ---------------------------------------------------------------------------

// What a body computes: the forward with the BN-ReLU prologue and the stats
// epilogue, the dx with the prologue's backward, or the plain conv; the dx
// from the int8 saved y (kDxQ), and also from the int8 saved x (kDxQX:
// the XQ mode, the epilogue's x dequantized).
constexpr int kFwd = 0, kDx = 1, kPlain = 2, kDxQ = 3, kDxQX = 4;

template <int MODE>
__host__ __device__ constexpr bool is_dx() {
  return MODE == kDx || MODE == kDxQ || MODE == kDxQX;
}

// The f32 dx's blocked sum: each run of kDxBlock channels' 9 x kDxBlock
// products goes into a fresh accumulator, added to the running total once a
// run (the FMA body's dx and #37 in the same order: so they keep their
// bits). A dx at 512 channels then adds 64 block sums of 72 products
// instead of 4,608 products in one serial order, whose error from float64
// was 4.4 u·Σ|term| (cuDNN's 1.0).
constexpr int kDxBlock = 8;

// Operands of one launch. `Cin` / `Cout` are the channels the kernel reads
// and writes: for dx, the forward's Cout and Cin.
template <typename T> struct ConvArgs {
  const T* in;         // forward: x; dx: dy
  const T* y;          // dx: the forward's output (for e)
  const float* s1;     // dx: the stats cotangents, or null (e = dy)
  const float* s2;
  const T* w;          // bf16: [3, 3, Cout, Cin]; f32: [Cin, 3, 3, Cout]
  const float* pa;     // prologue scale/shift: the forward's input
  const float* pb;     //   channels (forward staging, dx epilogue)
  const T* x;          // dx epilogue: the forward's input
  T* out;              // y or dx
  float* partials;     // per-block rows [2, Cout] of the sums
  int H, W, Cin, Cout;
  int prologue;
  const int8_t* yq;    // kDxQ, kDxQX: the forward's y as int8 [B, H, W, Cin]
  const float* ysc;    //   and its scales [B, H, pack, Cin]
  const int8_t* xq;    // kDxQX: the forward's x as int8 [B, H, W, Cout]
  const float* xsc;    //   and its scales [B, H, pack, Cout]
  int pack;            // the columns' grouping of the scales (mod pack)
  int batch;           // images (#37 walks them in-kernel)
  int ew_bf16;         // bf16 kernels: stage t and e with the bf16 chains
};

// The row of the scales of output pixel (b*H + gy, gx) in the XQ mode
// (kDxQX), once per pixel; 0 in the other modes.
template <int MODE, typename T>
__device__ __forceinline__ int64_t x_scale_row(const ConvArgs<T>& p, int row, int gx) {
  if constexpr (MODE == kDxQX) return (int64_t)row * p.pack + gx % p.pack;
  return 0;
}

// The epilogue at one output (pixel offset `pix`, channel o; `srow` its
// x_scale_row) from the f32 accumulator: returns the stored value and adds
// to the two sums.
template <int MODE, typename T>
__device__ __forceinline__ T epilogue_one(const ConvArgs<T>& p, int64_t pix, int o, float acc,
                                          float& s1, float& s2, int64_t srow) {
  if constexpr (MODE == kFwd) {
    const T yv = from_f32<T>(acc);
    const float yr = to_f32(yv);
    s1 += yr;
    s2 = fmaf(yr, yr, s2);
    return yv;
  } else {
    if (!p.prologue) return from_f32<T>(acc);
    float xv;
    if constexpr (MODE == kDxQX)  // deq(x) in f32, not rounded (:1577-1579)
      xv = deq_f32(p.xq[pix * p.Cout + o], p.xsc[srow * p.Cout + o]);
    else
      xv = to_f32(p.x[pix * p.Cout + o]);
    return from_f32<T>(prologue_bwd_one(xv, p.pa[o], p.pb[o], acc, s1, s2));
  }
}

template <int MODE, typename T>
__device__ __forceinline__ bool has_sums(const ConvArgs<T>& p) {
  return MODE == kFwd || (is_dx<MODE>() && p.prologue);
}

constexpr int kMmaThreads = 256;
constexpr int kRowS = 24;  // bf16 per staged row: 16 channels + 8 padding

// bf16: the nine taps of one 16-channel chunk of the window (in_s, rows of
// kRowS) against its weights (w_s, [tap][co][16 + 8]) into the warp's two
// output rows, in the order tap, n, m.
template <int COT>
__device__ __forceinline__ void mma_chunk(float (&acc)[2][COT / 8][4], const bf16* in_s,
                                          const bf16* w_s, int warp, int g, int t) {
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
    uint32_t a[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int wy = warp * 2 + m + ky;  // window row of this output row
      const uint32_t* r0 = reinterpret_cast<const uint32_t*>(&in_s[(wy * kWinW + g + kx) * kRowS]);
      const uint32_t* r1 =
          reinterpret_cast<const uint32_t*>(&in_s[(wy * kWinW + g + 8 + kx) * kRowS]);
      a[m][0] = r0[t];
      a[m][1] = r1[t];
      a[m][2] = r0[t + 4];
      a[m][3] = r1[t + 4];
    }
#pragma unroll
    for (int n = 0; n < COT / 8; ++n) {
      const uint32_t* wr =
          reinterpret_cast<const uint32_t*>(&w_s[((tap * COT) + n * 8 + g) * kRowS]);
      const uint32_t b0 = wr[t], b1 = wr[t + 4];
#pragma unroll
      for (int m = 0; m < 2; ++m) mma_bf16(acc[m][n], a[m], b0, b1);
    }
  }
}

// bf16 epilogue of the 16 x 16 tile at (gy0, gx0) of image b: store, and
// sum into the partial row `blk` (a fixed order: shuffles within a warp,
// then the warps in order through `red`). Thread (g, t) of warps 0-7
// holds pixels g and g + 8 of rows warp*2 + m, channels n*8 + 2t and + 1;
// a block with more warps calls it from all of them (for the barrier),
// the others storing nothing.
template <int MODE, int COT>
__device__ __forceinline__ void mma_epilogue(const ConvArgs<bf16>& p,
                                             const float (&acc)[2][COT / 8][4], int b, int gy0,
                                             int gx0, int co0, int blk, float (*red)[2][COT],
                                             int warp, int g, int t) {
  constexpr int NT = COT / 8;
  const int H = p.H, W = p.W, Cout = p.Cout;
  const int64_t img = (int64_t)b * H * W;
  const bool rows = warp < kMmaThreads / 32;
  float s1[NT][2], s2[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n) s1[n][0] = s1[n][1] = s2[n][0] = s2[n][1] = 0.f;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int gy = gy0 + warp * 2 + m;
    if (!rows) break;
#pragma unroll
    for (int hp = 0; hp < 2; ++hp) {
      const int gx = gx0 + g + hp * 8;
      if (gy >= H || gx >= W) continue;
      const int64_t pix = img + (int64_t)gy * W + gx;
      const int64_t srow = x_scale_row<MODE>(p, b * H + gy, gx);
      bf16* dst = p.out + pix * Cout;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int o = co0 + n * 8 + 2 * t;
        const bf16 r0 = o < Cout ? epilogue_one<MODE>(p, pix, o, acc[m][n][hp * 2], s1[n][0],
                                                      s2[n][0], srow)
                                 : __float2bfloat16(0.f);
        const bf16 r1 = o + 1 < Cout ? epilogue_one<MODE>(p, pix, o + 1, acc[m][n][hp * 2 + 1],
                                                          s1[n][1], s2[n][1], srow)
                                     : __float2bfloat16(0.f);
        if (o + 1 < Cout && (Cout & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst + o) = __halves2bfloat162(r0, r1);
        } else {
          if (o < Cout) dst[o] = r0;
          if (o + 1 < Cout) dst[o + 1] = r1;
        }
      }
    }
  }
  if (!has_sums<MODE>(p)) return;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s1[n][j] += __shfl_xor_sync(0xffffffffu, s1[n][j], off);
        s2[n][j] += __shfl_xor_sync(0xffffffffu, s2[n][j], off);
      }
  if (g == 0 && rows) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        red[warp][0][n * 8 + 2 * t + j] = s1[n][j];
        red[warp][1][n * 8 + 2 * t + j] = s2[n][j];
      }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * COT; i += blockDim.x) {
    const int which = i / COT, co = i % COT;
    float v = 0.f;
#pragma unroll
    for (int wp = 0; wp < kMmaThreads / 32; ++wp) v += red[wp][which][co];
    if (co0 + co < Cout) p.partials[(int64_t)blk * 2 * Cout + which * Cout + co0 + co] = v;
  }
}

}  // namespace
}  // namespace cltorch
