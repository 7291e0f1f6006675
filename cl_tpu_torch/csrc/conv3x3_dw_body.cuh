// The 3x3 SAME conv's weight-gradient bodies over NHWC, each instanced by a
// KIND: the packed conv's fused dW (#36), the plain dW (t = x, e = dy), the
// two-pass dW (#33) and the dW from int8 (#39). Shared by conv3x3_bn_bwd.cu
// and conv3x3_g2.cu (the gen-2 dW #41, a kDwPlain instance).
//
// Design: the contraction runs over pixels, so the pixels are split over
// gridDim.z blocks (each takes every gridDim.z-th 16 x 16 tile, 16 x 8 for
// f32) for a 32 x 32 (input x output channel) tile of all nine taps; each
// block writes its own partial dW and a second launch sums the partials in
// a fixed order. No float atomics: a run repeats its sums bit for bit.
// * bf16: mma.sync m16n8k16 with f32 accumulation. A block of 288 threads
//   is nine warps, one per tap. Per pixel tile it stages the 18 x 18 window
//   of t and the 16 x 16 tile of e as [pixel][channel] with an 80-byte
//   row (32 channels + 8 of padding); per output row each warp forms
//   A = t^T (its tap's shift is an offset into the window) and B = e, the
//   row's 16 pixels the k of one m16n8k16 product. ldmatrix.trans loads
//   the fragments of both straight from that layout (four 8 x 8 quarters
//   an instruction; the 80-byte row keeps its eight row reads on distinct
//   banks).
// * f32: FMA (TF32 would round). A block of 256 threads: lane = input
//   channel, warp = 4 output channels, each thread 9 taps x 4 channels of
//   accumulators; per pixel one float4 of e (a broadcast) and nine t.

#pragma once

#include "conv3x3_bn.cuh"

namespace cltorch {
namespace {

constexpr int kDwC = 32;  // input and output channels of a block's tile

// What a body computes: the fused dW (prologue if on, e formed from dy, y
// and the stats cotangents), the plain dW (t = x, e = dy), the two-pass
// dW (prologue if on, e = dy as given), or the dW from int8 saved
// activations (kDwQ: e from dy and deq(y); t from x, or from deq(xq) when
// the int8 x is given).
constexpr int kDwFused = 0, kDwPlain = 1, kDwBn = 2, kDwQ = 3;

// kDwQ's int8 operands (conv3x3_bn.cuh): y as int8 [B, H, W, Cout] with
// scales [B, H, pack, Cout]; x as int8 [B, H, W, Cin] with scales
// [B, H, pack, Cin], or null (t from x itself).
struct QArgs {
  const int8_t* yq;
  const float* ysc;
  const int8_t* xq;
  const float* xsc;
  int pack;
};

template <int KIND>
__device__ __forceinline__ int dw_prologue(int prologue) {
  return KIND == kDwPlain ? 0 : prologue;
}

template <int KIND>
__device__ __forceinline__ const float* dw_stats(const float* s) {
  return KIND == kDwFused || KIND == kDwQ ? s : nullptr;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kDwThreads = 9 * 32;
constexpr int kDwRow = 40;  // bf16 per staged pixel: 32 channels + 8 padding

template <int KIND>
__device__ __forceinline__ void dw_mma_body(const bf16* __restrict__ x,
                                            const float* __restrict__ pa,
                                            const float* __restrict__ pb,
                                            const bf16* __restrict__ dy,
                                            const bf16* __restrict__ y,
                                            const float* __restrict__ s1_in,
                                            const float* __restrict__ s2_in,
                                            float* __restrict__ partials, int B, int H, int W,
                                            int Cin, int Cout, int prologue_in, const QArgs qa) {
  const int prologue = dw_prologue<KIND>(prologue_in);
  const float* s1 = dw_stats<KIND>(s1_in);
  const float* s2 = dw_stats<KIND>(s2_in);
  __shared__ __align__(16) bf16 t_s[kWinH * kWinW * kDwRow];
  __shared__ __align__(16) bf16 e_s[kTH * kTW * kDwRow];
  const int ci0 = blockIdx.x * kDwC, co0 = blockIdx.y * kDwC;
  const int tap = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ky = tap / 3, kx = tap % 3;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix rows: lane -> (pixel j, channel half) of quarter i = lane / 8
  const int lj = lane & 7, lq = lane >> 3;
  const int tiles_x = (W + kTW - 1) / kTW, tiles_y = (H + kTH - 1) / kTH;
  const int n_tiles = B * tiles_x * tiles_y;

  float acc[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][n][j] = 0.f;

  for (int tile = blockIdx.z; tile < n_tiles; tile += gridDim.z) {
    const int b = tile / (tiles_x * tiles_y), rem = tile % (tiles_x * tiles_y);
    const int gy0 = (rem / tiles_x) * kTH, gx0 = (rem % tiles_x) * kTW;
    const int64_t img = (int64_t)b * H * W;
    __syncthreads();
    for (int e = threadIdx.x; e < kWinH * kWinW * 4; e += kDwThreads) {
      const int pix = e >> 2, q = e & 3;
      const int gy = gy0 - 1 + pix / kWinW, gx = gx0 - 1 + pix % kWinW;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const int c = ci0 + q * 8;
      const int64_t i = (img + (int64_t)gy * W + gx) * Cin + c;
      if (KIND == kDwQ && qa.xq != nullptr)
        stage8_tq(&t_s[pix * kDwRow + q * 8], qa.xq + i,
                  qa.xsc + ((int64_t)(b * H + gy) * qa.pack + gx % qa.pack) * Cin + c, c, Cin,
                  inside, prologue, pa, pb);
      else
        stage8_t(&t_s[pix * kDwRow + q * 8], x + i, c, Cin, inside, prologue, pa, pb);
    }
    for (int e = threadIdx.x; e < kTH * kTW * 4; e += kDwThreads) {
      const int pix = e >> 2, q = e & 3;
      const int gy = gy0 + pix / kTW, gx = gx0 + pix % kTW;
      const int c = co0 + q * 8;
      const int64_t i = (img + (int64_t)gy * W + gx) * Cout + c;
      if constexpr (KIND == kDwQ)
        stage8_eq(&e_s[pix * kDwRow + q * 8], dy + i, qa.yq + i,
                  qa.ysc + ((int64_t)(b * H + gy) * qa.pack + gx % qa.pack) * Cout + c, c, Cout,
                  gy < H && gx < W, s1, s2);
      else
        stage8_e(&e_s[pix * kDwRow + q * 8], dy + i, s1 ? y + i : nullptr, c, Cout,
                 gy < H && gx < W, s1, s2);
    }
    __syncthreads();

    for (int r = 0; r < kTH; ++r) {
      // A[ci][k] = t at window (r + ky, k + kx), B[k][co] = e at (r, k):
      // both stored k-major, so their fragments are transposed quarters.
      // A's quarters (k, ci) = (0-7, 0-7), (0-7, 8-15), (8-15, 0-7),
      // (8-15, 8-15) are a0..a3; B's (k, co) = (0-7, n), (8-15, n) are b0, b1.
      uint32_t a[2][4], b[2][4];
      const int t_pix = (r + ky) * kWinW + kx + (lq >> 1) * 8 + lj;
#pragma unroll
      for (int m = 0; m < 2; ++m)
        ldmatrix_x4_trans(a[m], &t_s[t_pix * kDwRow + m * 16 + (lq & 1) * 8]);
      const int e_pix = r * kTW + (lq & 1) * 8 + lj;
#pragma unroll
      for (int h = 0; h < 2; ++h)  // n-tiles 2h and 2h + 1
        ldmatrix_x4_trans(b[h], &e_s[e_pix * kDwRow + (2 * h + (lq >> 1)) * 8]);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int m = 0; m < 2; ++m)
          mma_bf16(acc[m][n], a[m], b[n >> 1][(n & 1) * 2], b[n >> 1][(n & 1) * 2 + 1]);
    }
  }

  // D[ci][co]: acc[m][n] = {D[m*16+g][n*8+2t], D[..][+1], D[m*16+g+8][n*8+2t], D[..][+1]};
  // partials[z] is laid out as the weight, [Cout, Cin, 3, 3].
  float* part = partials + (int64_t)blockIdx.z * Cout * Cin * 9;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ci = ci0 + m * 16 + g + (j >> 1) * 8, co = co0 + n * 8 + 2 * t + (j & 1);
        if (ci < Cin && co < Cout) part[((int64_t)co * Cin + ci) * 9 + tap] = acc[m][n][j];
      }
}

// ---------------------------------------------------------------------------
// f32: FMA
// ---------------------------------------------------------------------------

constexpr int kDwfThreads = 256;
constexpr int kDwfTH = 8;  // pixel tile rows (x 16 columns)

template <int KIND>
__device__ __forceinline__ void dw_fma_body(const float* __restrict__ x,
                                            const float* __restrict__ pa,
                                            const float* __restrict__ pb,
                                            const float* __restrict__ dy,
                                            const float* __restrict__ y,
                                            const float* __restrict__ s1_in,
                                            const float* __restrict__ s2_in,
                                            float* __restrict__ partials, int B, int H, int W,
                                            int Cin, int Cout, int prologue_in, const QArgs qa) {
  const int prologue = dw_prologue<KIND>(prologue_in);
  const float* s1 = dw_stats<KIND>(s1_in);
  const float* s2 = dw_stats<KIND>(s2_in);
  __shared__ float t_s[(kDwfTH + 2) * kWinW][kDwC];
  __shared__ __align__(16) float e_s[kDwfTH * kTW][kDwC];
  const int ci0 = blockIdx.x * kDwC, co0 = blockIdx.y * kDwC;
  const int ci = threadIdx.x & 31, cq = (threadIdx.x >> 5) * 4;  // input channel, 4 outputs
  const int tiles_x = (W + kTW - 1) / kTW, tiles_y = (H + kDwfTH - 1) / kDwfTH;
  const int n_tiles = B * tiles_x * tiles_y;

  float acc[9][4];
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;

  for (int tile = blockIdx.z; tile < n_tiles; tile += gridDim.z) {
    const int b = tile / (tiles_x * tiles_y), rem = tile % (tiles_x * tiles_y);
    const int gy0 = (rem / tiles_x) * kDwfTH, gx0 = (rem % tiles_x) * kTW;
    const int64_t img = (int64_t)b * H * W;
    __syncthreads();
    for (int e = threadIdx.x; e < (kDwfTH + 2) * kWinW * kDwC; e += kDwfThreads) {
      const int c = e % kDwC, pix = e / kDwC;
      const int gy = gy0 - 1 + pix / kWinW, gx = gx0 - 1 + pix % kWinW;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && ci0 + c < Cin) {
        const int64_t i = (img + (int64_t)gy * W + gx) * Cin + ci0 + c;
        v = KIND == kDwQ && qa.xq != nullptr
                ? t_at_q<float>(qa.xq, qa.xsc, i, ci0 + c, Cin, W, qa.pack, prologue, pa, pb)
                : t_at(x, i, ci0 + c, prologue, pa, pb);
      }
      t_s[pix][c] = v;
    }
    for (int e = threadIdx.x; e < kDwfTH * kTW * kDwC; e += kDwfThreads) {
      const int c = e % kDwC, pix = e / kDwC;
      const int gy = gy0 + pix / kTW, gx = gx0 + pix % kTW;
      float v = 0.f;
      if (gy < H && gx < W && co0 + c < Cout) {
        const int64_t i = (img + (int64_t)gy * W + gx) * Cout + co0 + c;
        v = KIND == kDwQ ? e_at_q(dy, qa.yq, qa.ysc, i, co0 + c, Cout, W, qa.pack, s1, s2)
                         : e_at(dy, y, i, co0 + c, s1, s2);
      }
      e_s[pix][c] = v;
    }
    __syncthreads();

    for (int r = 0; r < kDwfTH; ++r) {
#pragma unroll 4
      for (int col = 0; col < kTW; ++col) {
        const float4 ev = *reinterpret_cast<const float4*>(&e_s[r * kTW + col][cq]);
        const float e4[4] = {ev.x, ev.y, ev.z, ev.w};
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          const float tv = t_s[(r + k / 3) * kWinW + col + k % 3][ci];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[k][j] = fmaf(tv, e4[j], acc[k][j]);
        }
      }
    }
  }

  float* part = partials + (int64_t)blockIdx.z * Cout * Cin * 9;
  if (ci0 + ci < Cin) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + cq + j;
      if (co < Cout) {
#pragma unroll
        for (int k = 0; k < 9; ++k) part[((int64_t)co * Cin + ci0 + ci) * 9 + k] = acc[k][j];
      }
    }
  }
}

}  // namespace
}  // namespace cltorch
