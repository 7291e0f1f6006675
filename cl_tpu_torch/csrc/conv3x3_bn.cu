// 3x3 SAME conv over NHWC with a BN-ReLU prologue and a batch-stats
// epilogue, forward.
//
// Replaces the TPU kernel cl_tpu/pallas/conv3x3_v3.py::_fwd_bn_kernel
// (launched at conv3x3_v3.py:833 by `conv_bn_fused`, body :710-747):
//
//   t = round(relu(x * a[ci] + b[ci]))   when the prologue is on, else x
//   y = round(conv3x3_SAME(t, w))        f32 accumulation (:384-391)
//   s1[co] = sum of y, s2[co] = sum of y^2, taken from the ROUNDED y
//
// The rounding points are the TPU kernel's: t is rounded to the compute
// type before the conv (:686-690), y once after it, and the stats come from
// the stored y (:727-731). The SAME padding is zero in t-space: the halo is
// zeroed after the prologue (:693-716), so a border pixel never sees
// relu(b). The TPU kernel's lane packing and its stem's channel padding
// (3 -> 128/p, cl_tpu/models/unet.py:476-485) are layout devices: zeros
// add nothing, and here the input channels are walked in chunks of 16 with
// the tail zero-filled.
//
// What bounds it on the H100: at the packed body's shapes, bytes on the
// tensor cores (512^2 x 32 -> 32 at batch 8: 38.7 GFLOP, 39 us at
// 989 TFLOP/s, against 268 MB of input and output, 80 us at 3.35 TB/s),
// operations on the FMA units (580 us at the f32 peak of 67 TFLOP/s).
//
// Two kernels:
//
// * bf16: an implicit GEMM on the tensor cores, mma.sync m16n8k16 with f32
//   accumulation (bf16 products are exact, so only the f32 sum order
//   differs from the TPU's). A block of 256 threads (8 warps) computes a
//   16 x 16 pixel tile for 32 or 64 output channels. Per 16-channel input
//   chunk it stages the 18 x 18 window (prologue applied, out-of-image
//   pixels zero) as [pixel][channel] and the weights as [tap][co][channel],
//   both bf16 with a 24-element row (16 channels + 8 of padding), so every
//   32-bit fragment load of a warp hits 32 distinct banks. Each warp owns
//   two output rows (two m16 tiles, one image row each) and all the
//   block's channels; per tap it loads two A fragments straight from the
//   window (the tap's shift is an offset) and one B fragment per n8 tile.
// * f32: FMA, since TF32 would round the products. A block of 128 threads
//   (4 warps) computes the same 16 x 16 tile for 32 output channels, with
//   window and weights staged as f32; each warp owns 8 output channels
//   (its weight reads are broadcasts), each lane 8 consecutive pixels of
//   one row with 8 x 8 accumulators: per input channel and kernel row it
//   reads 10 inputs and 3 x 8 weights (as float4) for 192 FMAs.
//
// Both epilogues round y, store it, and sum y and y^2 of their pixels; a
// block sums its threads by shuffles and shared memory in a fixed order and
// writes one partial row, which a second launch sums over the blocks in a
// fixed order. No float atomics: a run repeats its sums bit for bit.

#include "common.cuh"

namespace cltorch {
namespace {

constexpr int kTH = 16, kTW = 16;          // output tile (rows, cols)
constexpr int kCoT = 32, kCiT = 16;        // output channels / input chunk
constexpr int kWinH = kTH + 2, kWinW = kTW + 2;
constexpr int kConvThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kConvThreads)
conv3x3_bn_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ pa, const float* __restrict__ pb,
                  T* __restrict__ y, float* __restrict__ partials, int H, int W, int Cin,
                  int Cout, int prologue) {
  __shared__ __align__(16) float in_s[kCiT][kWinH][kWinW];
  __shared__ __align__(16) float w_s[kCiT][9][kCoT];

  const int tiles_x = (W + kTW - 1) / kTW;
  const int gy0 = (blockIdx.x / tiles_x) * kTH, gx0 = (blockIdx.x % tiles_x) * kTW;
  const int co0 = blockIdx.y * kCoT;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = lane >> 1, seg = lane & 1;  // output row, 8-pixel segment
  const int cg = warp * 8;                   // first output channel of the warp
  const T* xb = x + (int64_t)b * H * W * Cin;

  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[p][c] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += kCiT) {
    __syncthreads();
    for (int e = threadIdx.x; e < kCiT * kWinH * kWinW; e += kConvThreads) {
      const int ci = e % kCiT, pix = e / kCiT;
      const int wx = pix % kWinW, wy = pix / kWinW;
      const int gy = gy0 - 1 + wy, gx = gx0 - 1 + wx, c = ci0 + ci;
      float v = 0.f;  // SAME padding, zero in t-space
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cin) {
        v = to_f32(xb[((int64_t)gy * W + gx) * Cin + c]);
        if (prologue) v = round_to<T>(fmaxf(__fadd_rn(__fmul_rn(v, pa[c]), pb[c]), 0.f));
      }
      in_s[ci][wy][wx] = v;
    }
    for (int e = threadIdx.x; e < kCiT * 9 * kCoT; e += kConvThreads) {
      const int co = e % kCoT, rest = e / kCoT;
      const int k = rest % 9, ci = rest / 9;
      const int c = ci0 + ci, o = co0 + co;
      w_s[ci][k][co] = (c < Cin && o < Cout) ? to_f32(w[((int64_t)c * 9 + k) * Cout + o]) : 0.f;
    }
    __syncthreads();

#pragma unroll 2
    for (int ci = 0; ci < kCiT; ++ci) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        float v[10];
        const float* row = &in_s[ci][ty + ky][seg * 8];
#pragma unroll
        for (int j = 0; j < 10; ++j) v[j] = row[j];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4 w0 = *reinterpret_cast<const float4*>(&w_s[ci][ky * 3 + kx][cg]);
          const float4 w1 = *reinterpret_cast<const float4*>(&w_s[ci][ky * 3 + kx][cg + 4]);
          const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int p = 0; p < 8; ++p)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[p][c] = fmaf(v[p + kx], wv[c], acc[p][c]);
        }
      }
    }
  }

  // Epilogue: round, store, and sum the stored values.
  float s1[8], s2[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) s1[c] = s2[c] = 0.f;
  const int gy = gy0 + ty;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int gx = gx0 + seg * 8 + p;
    if (gy < H && gx < W) {
      T* dst = y + (((int64_t)b * H + gy) * W + gx) * Cout + co0 + cg;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (co0 + cg + c < Cout) {
          const T yv = from_f32<T>(acc[p][c]);
          dst[c] = yv;
          const float yr = to_f32(yv);
          s1[c] += yr;
          s2[c] = fmaf(yr, yr, s2[c]);
        }
      }
    }
  }
  const int blk = b * gridDim.x + blockIdx.x;  // partial row of this tile
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float t1 = warp_sum(s1[c]);
    const float t2 = warp_sum(s2[c]);
    const int o = co0 + cg + c;
    if (lane == 0 && o < Cout) {
      partials[(int64_t)blk * 2 * Cout + o] = t1;
      partials[(int64_t)blk * 2 * Cout + Cout + o] = t2;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 256;
constexpr int kRowS = 24;  // bf16 per staged row: 16 channels + 8 padding

// Eight channels [c, c + 8) of one pixel (or weight row) into `dst`, zero
// past Cin; with the prologue, t = round(relu(x * a + b)) on the real ones.
__device__ __forceinline__ void stage8(bf16* dst, const bf16* src, int c, int Cin, bool inside,
                                       int prologue, const float* pa, const float* pb) {
  alignas(16) bf16 v[8];
  if (inside && (Cin & 7) == 0 && c < Cin) {
    load16<bf16>(v, src, 0);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = (inside && c + k < Cin) ? src[k] : __float2bfloat16(0.f);
  }
  if (prologue && inside) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (c + k < Cin)
        v[k] = __float2bfloat16(
            fmaxf(__fadd_rn(__fmul_rn(__bfloat162float(v[k]), pa[c + k]), pb[c + k]), 0.f));
  }
  store16<bf16>(dst, 0, v);
}

template <int COT>
__global__ void __launch_bounds__(kMmaThreads)
conv3x3_bn_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      const float* __restrict__ pa, const float* __restrict__ pb,
                      bf16* __restrict__ y, float* __restrict__ partials, int H, int W, int Cin,
                      int Cout, int prologue) {
  constexpr int NT = COT / 8;  // n8 tiles per warp
  __shared__ __align__(16) bf16 in_s[kWinH * kWinW * kRowS];
  __shared__ __align__(16) bf16 w_s[9 * COT * kRowS];
  __shared__ float red[kMmaThreads / 32][2][COT];

  const int tiles_x = (W + kTW - 1) / kTW;
  const int gy0 = (blockIdx.x / tiles_x) * kTH, gx0 = (blockIdx.x % tiles_x) * kTW;
  const int co0 = blockIdx.y * COT;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, thread in group
  const bf16* xb = x + (int64_t)b * H * W * Cin;

  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][n][j] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += 16) {
    __syncthreads();
    for (int e = threadIdx.x; e < kWinH * kWinW * 2; e += kMmaThreads) {
      const int pix = e >> 1, half = e & 1;
      const int gy = gy0 - 1 + pix / kWinW, gx = gx0 - 1 + pix % kWinW;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const int c = ci0 + half * 8;
      stage8(&in_s[pix * kRowS + half * 8], xb + ((int64_t)gy * W + gx) * Cin + c, c, Cin,
             inside, prologue, pa, pb);
    }
    for (int e = threadIdx.x; e < 9 * COT * 2; e += kMmaThreads) {
      const int half = e & 1, row = e >> 1;  // row = tap * COT + co
      const int co = row % COT, tap = row / COT;
      const int c = ci0 + half * 8;
      stage8(&w_s[row * kRowS + half * 8], w + ((int64_t)tap * Cout + co0 + co) * Cin + c, c,
             Cin, co0 + co < Cout, 0, pa, pb);
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int wy = warp * 2 + m + ky;  // window row of this output row
        const uint32_t* r0 =
            reinterpret_cast<const uint32_t*>(&in_s[(wy * kWinW + g + kx) * kRowS]);
        const uint32_t* r1 =
            reinterpret_cast<const uint32_t*>(&in_s[(wy * kWinW + g + 8 + kx) * kRowS]);
        a[m][0] = r0[t];
        a[m][1] = r1[t];
        a[m][2] = r0[t + 4];
        a[m][3] = r1[t + 4];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint32_t* wr =
            reinterpret_cast<const uint32_t*>(&w_s[((tap * COT) + n * 8 + g) * kRowS]);
        const uint32_t b0 = wr[t], b1 = wr[t + 4];
#pragma unroll
        for (int m = 0; m < 2; ++m) mma_bf16(acc[m][n], a[m], b0, b1);
      }
    }
  }

  // Epilogue: round, store, and sum the stored values. Thread (g, t) holds
  // pixels g and g + 8 of rows warp*2 + m, channels n*8 + 2t and + 1.
  float s1[NT][2], s2[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n) s1[n][0] = s1[n][1] = s2[n][0] = s2[n][1] = 0.f;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int gy = gy0 + warp * 2 + m;
#pragma unroll
    for (int hp = 0; hp < 2; ++hp) {
      const int gx = gx0 + g + hp * 8;
      if (gy >= H || gx >= W) continue;
      bf16* dst = y + (((int64_t)b * H + gy) * W + gx) * Cout;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int o = co0 + n * 8 + 2 * t;
        const bf16 r0 = __float2bfloat16(acc[m][n][hp * 2]);
        const bf16 r1 = __float2bfloat16(acc[m][n][hp * 2 + 1]);
        if (o + 1 < Cout && (Cout & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst + o) = __halves2bfloat162(r0, r1);
        } else {
          if (o < Cout) dst[o] = r0;
          if (o + 1 < Cout) dst[o + 1] = r1;
        }
        const float f0 = o < Cout ? __bfloat162float(r0) : 0.f;
        const float f1 = o + 1 < Cout ? __bfloat162float(r1) : 0.f;
        s1[n][0] += f0;
        s1[n][1] += f1;
        s2[n][0] = fmaf(f0, f0, s2[n][0]);
        s2[n][1] = fmaf(f1, f1, s2[n][1]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s1[n][j] += __shfl_xor_sync(0xffffffffu, s1[n][j], off);
        s2[n][j] += __shfl_xor_sync(0xffffffffu, s2[n][j], off);
      }
  if (g == 0) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        red[warp][0][n * 8 + 2 * t + j] = s1[n][j];
        red[warp][1][n * 8 + 2 * t + j] = s2[n][j];
      }
  }
  __syncthreads();
  const int blk = b * gridDim.x + blockIdx.x;  // partial row of this tile
  for (int i = threadIdx.x; i < 2 * COT; i += kMmaThreads) {
    const int which = i / COT, co = i % COT;
    float v = 0.f;
#pragma unroll
    for (int wp = 0; wp < kMmaThreads / 32; ++wp) v += red[wp][which][co];
    if (co0 + co < Cout) partials[(int64_t)blk * 2 * Cout + which * Cout + co0 + co] = v;
  }
}

template <int COT>
void conv3x3_bn_mma_grid(const void* x, const void* w, const void* a, const void* b, void* y,
                         void* partials, int tiles, int B, int H, int W, int Cin, int Cout,
                         int prologue, cudaStream_t st) {
  dim3 grid(tiles, (Cout + COT - 1) / COT, B);
  conv3x3_bn_mma_kernel<COT><<<grid, kMmaThreads, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<bf16*>(y), static_cast<float*>(partials), H, W,
      Cin, Cout, prologue);
}

int conv3x3_bn_mma_launch(const void* x, const void* w, const void* a, const void* b, void* y,
                          void* partials, void* out, int B, int H, int W, int Cin, int Cout,
                          int prologue, cudaStream_t st) {
  const int tiles = ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
  if (Cout % 64 == 0)
    conv3x3_bn_mma_grid<64>(x, w, a, b, y, partials, tiles, B, H, W, Cin, Cout, prologue, st);
  else
    conv3x3_bn_mma_grid<32>(x, w, a, b, y, partials, tiles, B, H, W, Cin, Cout, prologue, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<<<2 * Cout, kReduceThreads, 0, st>>>(
      static_cast<const float*>(partials), tiles * B, 2 * Cout, 2 * Cout, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: FMA
// ---------------------------------------------------------------------------

template <typename T>
int conv3x3_bn_launch(const void* x, const void* w, const void* a, const void* b, void* y,
                      void* partials, void* out, int B, int H, int W, int Cin, int Cout,
                      int prologue, cudaStream_t st) {
  const int tiles = ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
  dim3 grid(tiles, (Cout + kCoT - 1) / kCoT, B);
  conv3x3_bn_kernel<T><<<grid, kConvThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<T*>(y), static_cast<float*>(partials), H, W, Cin,
      Cout, prologue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<<<2 * Cout, kReduceThreads, 0, st>>>(
      static_cast<const float*>(partials), tiles * B, 2 * Cout, 2 * Cout, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cltorch

// Plain C interface, loaded with ctypes; returns cudaGetLastError(). The
// wrapper (cl_tpu_torch/kernels/conv3x3.py) checks the operands: x
// contiguous NHWC [B, H, W, Cin], 16-byte aligned; w contiguous of x's
// type, [3, 3, Cout, Cin] for bf16 and [Cin, 3, 3, Cout] for f32; a, b f32
// [Cin] (read only when `prologue`); y [B, H, W, Cout];
// `partials` holds (number of 16 x 16 tiles) * B * 2 * Cout floats; `out`
// is [2, Cout] (sum, sum of squares).
extern "C" {

int cltorch_conv3x3_bn_fwd(const void* x, const void* w, const void* a, const void* b, void* y,
                           void* partials, void* out, int B, int H, int W, int Cin, int Cout,
                           int prologue, int is_bf16, void* stream) {
  using namespace cltorch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? conv3x3_bn_mma_launch(x, w, a, b, y, partials, out, B, H, W, Cin, Cout,
                                         prologue, st)
                 : conv3x3_bn_launch<float>(x, w, a, b, y, partials, out, B, H, W, Cin, Cout,
                                            prologue, st);
}

}  // extern "C"
