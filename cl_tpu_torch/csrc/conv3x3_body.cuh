// The 3x3 SAME conv's first body over NHWC, f32 FMA, instanced by a MODE of
// conv3x3_bn.cuh: in conv3x3_bn.cu (the packed conv's forward and dx) and
// conv3x3_dx_q.cu (the dx from int8).
//
// What it replaces in f32 (cl_tpu/pallas/conv3x3_v3.py): the packed conv's
// forward ::_fwd_bn_kernel (#32, launched at :833) and dx ::_dx_slim_kernel
// / ::_dx_bn_kernel (#34, #35, :1233, :1259) and the dx from int8
// ::_dx_q_kernel (#38, :1657). Their bf16 instances run the ring body
// (conv3x3_ring_body.cuh): #32/#34/#35, and #38 since its move onto
// the ring's kDxQ / kDxQX MODEs, which ended the first bf16 body
// (conv3x3_mma_body: 16-channel chunks staged synchronously through
// registers, the weights re-staged by every block, 32-bit fragment loads;
// 4-6x its bounds). The plain conv (#30, #40) ran here until it moved onto
// its own bodies (conv3x3_plain_body.cuh).
//
// What bounds it on the H100 (batch 8): the FMA units (38.7 GFLOP a conv of
// 512^2 x 32 -> 32, 256^2 x 64 -> 64 or 128^2 x 128 -> 128: 577 us at 67
// TFLOP/s).
//
// Why the dx's order is fixed in bf16: the ring body's dx (#34/#35, and
// 34p/35p and #37, which launch it, and #38) accumulates each output in
// 16-channel chunks ascending, taps 0-8, one m16n8k16 each, on bf16
// operands, and sums its partial rows in one fixed order
// (conv3x3_ring_body.cuh), so all of them repeat their bits.
//
// f32: FMA, since TF32 would round the products. A block of 128 threads (4
// warps) computes a 16 x 16 pixel tile for 32 output channels, with window
// and weights staged as f32; each warp owns 8 output channels (its weight
// reads are broadcasts), each lane 8 consecutive pixels of one row with 8 x
// 8 accumulators: per input channel and kernel row it reads 10 inputs and 3
// x 8 weights (as float4) for 192 FMAs. The dx sums each 8 input channels'
// products in a fresh accumulator before adding them to the running sum
// (fma_chunk), so a dx over 512 channels is not one serial sum of 4,608
// products.
//
// The epilogues that sum (the forward's stats, the dx's da and db) sum a
// block's threads by shuffles and write one partial row, which a second
// launch sums over the blocks in a fixed order. No float atomics: a run
// repeats its sums bit for bit.

#pragma once

#include "conv3x3_bn.cuh"

namespace cltorch {
namespace {

// The operands of one launch from the C interface's untyped pointers.
template <typename T>
ConvArgs<T> conv_args(const void* in, const void* y, const void* s1, const void* s2,
                      const void* w, const void* a, const void* b, const void* x, void* out,
                      void* partials, int H, int W, int Cin, int Cout, int prologue) {
  return ConvArgs<T>{static_cast<const T*>(in),    static_cast<const T*>(y),
                     static_cast<const float*>(s1), static_cast<const float*>(s2),
                     static_cast<const T*>(w),     static_cast<const float*>(a),
                     static_cast<const float*>(b), static_cast<const T*>(x),
                     static_cast<T*>(out),         static_cast<float*>(partials),
                     H,                            W,
                     Cin,                          Cout,
                     prologue};
}

constexpr int kCoT = 32, kCiT = 16;  // output channels / input chunk
constexpr int kConvThreads = 128;
// The f32 dx instances (#34/#35's, which 34p/35p run too, and #38's) at
// four blocks an SM: the blocked sum's fresh accumulator (fma_chunk) would
// take them to 165-168 registers and three blocks an SM, slower on the
// H100 than 128 registers with 20-28 bytes a thread spilled.
constexpr int kFmaDxMinBlocks = 4;

// The staged input at one in-image pixel: t (forward: the prologue, if on)
// or e (dx).
template <int MODE, typename T>
__device__ __forceinline__ float staged_at(const ConvArgs<T>& p, int64_t i, int c) {
  if constexpr (MODE == kDx) return e_at(p.in, p.y, i, c, p.s1, p.s2);
  if constexpr (MODE == kDxQ || MODE == kDxQX)
    return e_at_q(p.in, p.yq, p.ysc, i, c, p.Cin, p.W, p.pack, p.s1, p.s2);
  return t_at(p.in, i, c, p.prologue, p.pa, p.pb);
}

// f32: input channels [ci0, ci1) of the staged window (in_s) and their
// weights (w_s) into the 8 pixels x NC output channels acc (the thread's
// channels cg + c0 ..), in the order ci, ky, kx.
template <int NC>
__device__ __forceinline__ void fma_channels(float (&acc)[8][NC], float (*in_s)[kWinH][kWinW],
                                             float (*w_s)[9][kCoT], int ci0, int ci1, int ty,
                                             int seg, int cg) {
#pragma unroll 2
  for (int ci = ci0; ci < ci1; ++ci) {
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      float v[10];
      const float* row = &in_s[ci][ty + ky][seg * 8];
#pragma unroll
      for (int j = 0; j < 10; ++j) v[j] = row[j];
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        float wv[NC];
#pragma unroll
        for (int c4 = 0; c4 < NC; c4 += 4) {
          const float4 w4 = *reinterpret_cast<const float4*>(&w_s[ci][ky * 3 + kx][cg + c4]);
          wv[c4] = w4.x;
          wv[c4 + 1] = w4.y;
          wv[c4 + 2] = w4.z;
          wv[c4 + 3] = w4.w;
        }
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[q][c] = fmaf(v[q + kx], wv[c], acc[q][c]);
      }
    }
  }
}

// f32: one 16-channel chunk into the thread's 8 pixels x 8 output channels.
// The forward and the plain conv add every product to acc in one serial
// order; the dx (BLOCKED) sums each kDxBlock channels in a fresh
// accumulator and adds that to acc (conv3x3_bn.cuh::kDxBlock), four output
// channels at a time: the fresh accumulator then holds 32 values, not 64,
// so the body keeps its registers (and its blocks an SM) at the cost of
// reading each window row twice. Each output's sums run in the same order
// either way.
template <bool BLOCKED>
__device__ __forceinline__ void fma_chunk(float (&acc)[8][8], float (*in_s)[kWinH][kWinW],
                                          float (*w_s)[9][kCoT], int ty, int seg, int cg) {
  if constexpr (!BLOCKED) {
    fma_channels<8>(acc, in_s, w_s, 0, kCiT, ty, seg, cg);
  } else {
#pragma unroll 1
    for (int ci0 = 0; ci0 < kCiT; ci0 += kDxBlock) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float part[8][4];
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int c = 0; c < 4; ++c) part[q][c] = 0.f;
        fma_channels<4>(part, in_s, w_s, ci0, ci0 + kDxBlock, ty, seg, cg + 4 * h);
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[q][4 * h + c] += part[q][c];
      }
    }
  }
}

// f32 epilogue of the 16 x 16 tile at (gy0, gx0) of image b: store, and sum
// into the partial row `blk`.
template <int MODE, typename T>
__device__ __forceinline__ void fma_epilogue(const ConvArgs<T>& p, const float (&acc)[8][8],
                                             int b, int gy0, int gx0, int co0, int blk, int ty,
                                             int seg, int cg, int lane) {
  const int H = p.H, W = p.W, Cout = p.Cout;
  const int64_t img = (int64_t)b * H * W;
  float s1[8], s2[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) s1[c] = s2[c] = 0.f;
  const int gy = gy0 + ty;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int gx = gx0 + seg * 8 + q;
    if (gy < H && gx < W) {
      const int64_t pix = img + (int64_t)gy * W + gx;
      const int64_t srow = x_scale_row<MODE>(p, b * H + gy, gx);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int o = co0 + cg + c;
        if (o < Cout)
          p.out[pix * Cout + o] = epilogue_one<MODE>(p, pix, o, acc[q][c], s1[c], s2[c], srow);
      }
    }
  }
  if (!has_sums<MODE>(p)) return;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float t1 = warp_sum(s1[c]);
    const float t2 = warp_sum(s2[c]);
    const int o = co0 + cg + c;
    if (lane == 0 && o < Cout) {
      p.partials[(int64_t)blk * 2 * Cout + o] = t1;
      p.partials[(int64_t)blk * 2 * Cout + Cout + o] = t2;
    }
  }
}

template <int MODE, typename T>
__device__ __forceinline__ void conv3x3_fma_body(const ConvArgs<T>& p) {
  __shared__ __align__(16) float in_s[kCiT][kWinH][kWinW];
  __shared__ __align__(16) float w_s[kCiT][9][kCoT];

  const int H = p.H, W = p.W, Cin = p.Cin, Cout = p.Cout;
  const int tiles_x = (W + kTW - 1) / kTW;
  const int gy0 = (blockIdx.x / tiles_x) * kTH, gx0 = (blockIdx.x % tiles_x) * kTW;
  const int co0 = blockIdx.y * kCoT;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = lane >> 1, seg = lane & 1;  // output row, 8-pixel segment
  const int cg = warp * 8;                   // first output channel of the warp
  const int64_t img = (int64_t)b * H * W;    // first pixel of the image

  float acc[8][8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[q][c] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += kCiT) {
    __syncthreads();
    for (int e = threadIdx.x; e < kCiT * kWinH * kWinW; e += kConvThreads) {
      const int ci = e % kCiT, pix = e / kCiT;
      const int wx = pix % kWinW, wy = pix / kWinW;
      const int gy = gy0 - 1 + wy, gx = gx0 - 1 + wx, c = ci0 + ci;
      float v = 0.f;  // SAME padding: zero in t-space and in e-space
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cin) {
        const int64_t i = (img + (int64_t)gy * W + gx) * Cin + c;
        v = staged_at<MODE>(p, i, c);
      }
      in_s[ci][wy][wx] = v;
    }
    for (int e = threadIdx.x; e < kCiT * 9 * kCoT; e += kConvThreads) {
      const int co = e % kCoT, rest = e / kCoT;
      const int k = rest % 9, ci = rest / 9;
      const int c = ci0 + ci, o = co0 + co;
      w_s[ci][k][co] = (c < Cin && o < Cout) ? to_f32(p.w[((int64_t)c * 9 + k) * Cout + o]) : 0.f;
    }
    __syncthreads();
    fma_chunk<is_dx<MODE>()>(acc, in_s, w_s, ty, seg, cg);
  }
  fma_epilogue<MODE>(p, acc, b, gy0, gx0, co0, b * gridDim.x + blockIdx.x, ty, seg, cg, lane);
}

}  // namespace
}  // namespace cltorch
