// 3x3 SAME conv over NHWC with a BN-ReLU prologue and a batch-stats
// epilogue: the forward and the input gradient (dx).
//
// Replaces the TPU kernels of cl_tpu/pallas/conv3x3_v3.py:
// ::_fwd_bn_kernel (launched at conv3x3_v3.py:833 by `conv_bn_fused`,
// body :710-747) and, from its VJP's fused branch (`_cbf_bwd`, :951-961),
// ::_dx_slim_kernel (:1233) and ::_dx_bn_kernel (:1259, `_dx_bn_impl`).
//
// Forward:
//   t = round(relu(x * a[ci] + b[ci]))   when the prologue is on, else x
//   y = round(conv3x3_SAME(t, w))        f32 accumulation (:384-391)
//   s1[co] = sum of y, s2[co] = sum of y^2, taken from the ROUNDED y
// dx (the conv of e with the flipped, transposed weight, e formed while
// staging, conv3x3_v3.py:1064-1110):
//   e  = round(dy + ds1[co] + 2 * y * ds2[co])  (e = dy without stats
//        cotangents), zero outside the image
//   dt = conv3x3_SAME(e, w_flip^T)       f32 accumulator, not rounded
//   prologue on: u = x * a + b, du = [u > 0] * dt, dx = round(du * a),
//                da = sum of du * x, db = sum of du   (:1082-1088)
//   prologue off: dx = round(dt)
//
// The rounding points are the TPU kernels': t is rounded to the compute
// type before the conv (:686-690), y once after it, and the stats come from
// the stored y (:727-731); e is rounded before the dx conv (:1050-1061),
// and the dx epilogue reads the f32 accumulator. The SAME padding is zero
// in t-space and in e-space (conv3x3_bn.cuh). The TPU kernel's lane packing
// and its stem's channel padding (3 -> 128/p, cl_tpu/models/unet.py:476-485)
// are layout devices: zeros add nothing, and here the input channels are
// walked in chunks of 16 with the tail zero-filled.
//
// What bounds it on the H100: at the packed body's shapes, bytes on the
// tensor cores (512^2 x 32 -> 32 at batch 8: 38.7 GFLOP, 39 us at
// 989 TFLOP/s, against 268 MB of input and output, 80 us at 3.35 TB/s;
// the dx reads dy, y and x and writes dx, 537 MB, 160 us), operations on
// the FMA units (580 us at the f32 peak of 67 TFLOP/s).
//
// Also the plain gen-3 conv, cl_tpu/pallas/conv3x3_v3.py::_fwd_kernel
// (launched at conv3x3_v3.py:522 by `_fwd_packed`): y = round(conv3x3_SAME(x,
// w)), no prologue and no statistics, as the forward of `conv3x3` /
// `conv3x3_packed` under model.conv_impl=v3|auto, as their dx (the same conv
// on dy with the flipped, transposed weight, :619-620, :641-642) and as the
// two-pass backward's dt (:965). Its kernels are the instances
// `conv3x3_v3_kernel` / `conv3x3_v3_mma_kernel` of the bodies below with
// MODE = kPlain: x staged as it is, the accumulator rounded and stored,
// no sums. At baseline_2's 256^2 x 64 -> 64, batch 8, f32 (FMA): 38.7
// GFLOP, 577 us at 67 TFLOP/s, against 268 MB, 80 us.
//
// And the int8 saved activations of model.conv_act_store=int8
// (`conv_bn_fused_q`, conv3x3_v3.py:1800-1870):
// * 32q, the quantizing epilogue of ::_fwd_bn_q_kernel (:757, launched by
//   the same pallas_call as the forward, :833, with emit_q; `_quant_rows`
//   :142-151), here a second kernel, conv3x3_q_quant_kernel, after the
//   forward, which keeps its bits: q and a scale per image row, column mod
//   p and channel (conv3x3_bn.cuh). Bound by bytes: y read, q and the
//   scales written (512^2 x 32 bf16 at batch 8: 201 MB, 60 us).
// * #38, ::_dx_q_kernel (launched at :1657 by `_dx_q_impl`): the dx
//   instances conv3x3_q_dx_kernel / conv3x3_q_dx_mma_kernel of the bodies
//   below with MODE = kDxQ (e from dy and deq(y): the stats term reads
//   deq(y) in f32, not rounded, :1532-1540) or kDxQX (also the epilogue's
//   x as deq(xq) in f32, not rounded, :1577-1579). The int8 y and x halve
//   the dx's reads of them against the compute type's bf16.
//
// Two bodies, each templated on what it computes (forward, dx, plain or a
// dx from int8);
// the staging of the window and the epilogue differ, the tile, the tap
// loop and the fixed-order sums are shared:
//
// * bf16: an implicit GEMM on the tensor cores, mma.sync m16n8k16 with f32
//   accumulation (bf16 products are exact, so only the f32 sum order
//   differs from the TPU's). A block of 256 threads (8 warps) computes a
//   16 x 16 pixel tile for 32 or 64 output channels. Per 16-channel input
//   chunk it stages the 18 x 18 window (t or e, out-of-image pixels zero)
//   as [pixel][channel] and the weights as [tap][co][channel], both bf16
//   with a 24-element row (16 channels + 8 of padding), so every 32-bit
//   fragment load of a warp hits 32 distinct banks. Each warp owns two
//   output rows (two m16 tiles, one image row each) and all the block's
//   channels; per tap it loads two A fragments straight from the window
//   (the tap's shift is an offset) and one B fragment per n8 tile.
// * f32: FMA, since TF32 would round the products. A block of 128 threads
//   (4 warps) computes the same 16 x 16 tile for 32 output channels, with
//   window and weights staged as f32; each warp owns 8 output channels
//   (its weight reads are broadcasts), each lane 8 consecutive pixels of
//   one row with 8 x 8 accumulators: per input channel and kernel row it
//   reads 10 inputs and 3 x 8 weights (as float4) for 192 FMAs.
//
// The epilogues that sum (the forward's stats, the dx's da and db) sum a
// block's threads by shuffles and shared memory in a fixed order and write
// one partial row, which a second launch sums over the blocks in a fixed
// order. No float atomics: a run repeats its sums bit for bit.

#include "conv3x3_bn.cuh"

namespace cltorch {
namespace {

constexpr int kCoT = 32, kCiT = 16;  // output channels / input chunk
constexpr int kConvThreads = 128;

// What a body computes: the forward with the BN-ReLU prologue and the stats
// epilogue, the dx with the prologue's backward, or the plain conv; the dx
// from the int8 saved y (kDxQ), and also from the int8 saved x (kDxQX:
// the XQ mode, the epilogue's x dequantized).
constexpr int kFwd = 0, kDx = 1, kPlain = 2, kDxQ = 3, kDxQX = 4;

template <int MODE>
__host__ __device__ constexpr bool is_dx() {
  return MODE == kDx || MODE == kDxQ || MODE == kDxQX;
}

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
  if constexpr (MODE == kPlain) {
    return from_f32<T>(acc);
  } else if constexpr (MODE == kFwd) {
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
    const float du = __fadd_rn(__fmul_rn(xv, p.pa[o]), p.pb[o]) > 0.f ? acc : 0.f;
    s1 = fmaf(du, xv, s1);
    s2 += du;
    return from_f32<T>(__fmul_rn(du, p.pa[o]));
  }
}

template <int MODE, typename T>
__device__ __forceinline__ bool has_sums(const ConvArgs<T>& p) {
  return MODE == kFwd || (is_dx<MODE>() && p.prologue);
}

// The staged input at one in-image pixel: t (forward: the prologue, if on;
// plain: x itself) or e (dx).
template <int MODE, typename T>
__device__ __forceinline__ float staged_at(const ConvArgs<T>& p, int64_t i, int c) {
  if constexpr (MODE == kDx) return e_at(p.in, p.y, i, c, p.s1, p.s2);
  if constexpr (MODE == kDxQ || MODE == kDxQX)
    return e_at_q(p.in, p.yq, p.ysc, i, c, p.Cin, p.W, p.pack, p.s1, p.s2);
  return t_at(p.in, i, c, MODE == kFwd ? p.prologue : 0, p.pa, p.pb);
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
          for (int q = 0; q < 8; ++q)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[q][c] = fmaf(v[q + kx], wv[c], acc[q][c]);
        }
      }
    }
  }

  // Epilogue: store, and sum.
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
  const int blk = b * gridDim.x + blockIdx.x;  // partial row of this tile
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

template <bool DX, typename T>
__global__ void __launch_bounds__(kConvThreads) conv3x3_bn_kernel(ConvArgs<T> p) {
  conv3x3_fma_body<DX ? kDx : kFwd>(p);
}

template <typename T>
__global__ void __launch_bounds__(kConvThreads) conv3x3_v3_kernel(ConvArgs<T> p) {
  conv3x3_fma_body<kPlain>(p);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 256;
constexpr int kRowS = 24;  // bf16 per staged row: 16 channels + 8 padding

template <int MODE, int COT>
__device__ __forceinline__ void conv3x3_mma_body(const ConvArgs<bf16>& p) {
  constexpr int NT = COT / 8;  // n8 tiles per warp
  __shared__ __align__(16) bf16 in_s[kWinH * kWinW * kRowS];
  __shared__ __align__(16) bf16 w_s[9 * COT * kRowS];
  __shared__ float red[kMmaThreads / 32][2][COT];

  const int H = p.H, W = p.W, Cin = p.Cin, Cout = p.Cout;
  const int tiles_x = (W + kTW - 1) / kTW;
  const int gy0 = (blockIdx.x / tiles_x) * kTH, gx0 = (blockIdx.x % tiles_x) * kTW;
  const int co0 = blockIdx.y * COT;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, thread in group
  const int64_t img = (int64_t)b * H * W;

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
      const int64_t i = (img + (int64_t)gy * W + gx) * Cin + c;
      if constexpr (MODE == kDx)
        stage8_e(&in_s[pix * kRowS + half * 8], p.in + i, p.s1 ? p.y + i : nullptr, c, Cin,
                 inside, p.s1, p.s2);
      else if constexpr (MODE == kDxQ || MODE == kDxQX)
        stage8_eq(&in_s[pix * kRowS + half * 8], p.in + i, p.yq + i,
                  p.ysc + ((int64_t)(b * H + gy) * p.pack + gx % p.pack) * Cin + c, c, Cin,
                  inside, p.s1, p.s2);
      else
        stage8_t(&in_s[pix * kRowS + half * 8], p.in + i, c, Cin, inside,
                 MODE == kFwd ? p.prologue : 0, p.pa, p.pb);
    }
    for (int e = threadIdx.x; e < 9 * COT * 2; e += kMmaThreads) {
      const int half = e & 1, row = e >> 1;  // row = tap * COT + co
      const int co = row % COT, tap = row / COT;
      const int c = ci0 + half * 8;
      stage8_t(&w_s[row * kRowS + half * 8], p.w + ((int64_t)tap * Cout + co0 + co) * Cin + c, c,
               Cin, co0 + co < Cout, 0, nullptr, nullptr);
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

  // Epilogue: store, and sum. Thread (g, t) holds pixels g and g + 8 of
  // rows warp*2 + m, channels n*8 + 2t and + 1.
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
    if (co0 + co < Cout) p.partials[(int64_t)blk * 2 * Cout + which * Cout + co0 + co] = v;
  }
}

template <bool DX, int COT>
__global__ void __launch_bounds__(kMmaThreads) conv3x3_bn_mma_kernel(ConvArgs<bf16> p) {
  conv3x3_mma_body<DX ? kDx : kFwd, COT>(p);
}

template <int COT>
__global__ void __launch_bounds__(kMmaThreads) conv3x3_v3_mma_kernel(ConvArgs<bf16> p) {
  conv3x3_mma_body<kPlain, COT>(p);
}

// #38: the dx from the int8 saved y (MODE kDxQ) and x (kDxQX).
template <int MODE, typename T>
__global__ void __launch_bounds__(kConvThreads) conv3x3_q_dx_kernel(ConvArgs<T> p) {
  conv3x3_fma_body<MODE>(p);
}

template <int MODE, int COT>
__global__ void __launch_bounds__(kMmaThreads) conv3x3_q_dx_mma_kernel(ConvArgs<bf16> p) {
  conv3x3_mma_body<MODE, COT>(p);
}

// Launches the kernel of the type and mode and, when it sums, the
// reduction of its partial rows into out [2, Cout].
template <int MODE>
int conv3x3_launch(ConvArgs<bf16> pb16, ConvArgs<float> pf32, int is_bf16, int B, void* out,
                   cudaStream_t st) {
  constexpr bool DX = is_dx<MODE>();
  const int H = pf32.H, W = pf32.W, Cout = pf32.Cout;
  const int tiles = ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
  const dim3 grid32(tiles, (Cout + 31) / 32, B);
  const dim3 grid64(tiles, Cout / 64, B);
  if constexpr (MODE == kPlain) {
    if (!is_bf16)
      conv3x3_v3_kernel<float><<<grid32, kConvThreads, 0, st>>>(pf32);
    else if (Cout % 64 == 0)
      conv3x3_v3_mma_kernel<64><<<grid64, kMmaThreads, 0, st>>>(pb16);
    else
      conv3x3_v3_mma_kernel<32><<<grid32, kMmaThreads, 0, st>>>(pb16);
    return (int)cudaGetLastError();
  }
  if constexpr (MODE == kDxQ || MODE == kDxQX) {
    if (!is_bf16)
      conv3x3_q_dx_kernel<MODE, float><<<grid32, kConvThreads, 0, st>>>(pf32);
    else if (Cout % 64 == 0)
      conv3x3_q_dx_mma_kernel<MODE, 64><<<grid64, kMmaThreads, 0, st>>>(pb16);
    else
      conv3x3_q_dx_mma_kernel<MODE, 32><<<grid32, kMmaThreads, 0, st>>>(pb16);
  } else {
    if (!is_bf16)
      conv3x3_bn_kernel<DX, float><<<grid32, kConvThreads, 0, st>>>(pf32);
    else if (Cout % 64 == 0)
      conv3x3_bn_mma_kernel<DX, 64><<<grid64, kMmaThreads, 0, st>>>(pb16);
    else
      conv3x3_bn_mma_kernel<DX, 32><<<grid32, kMmaThreads, 0, st>>>(pb16);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || (DX && !pf32.prologue)) return (int)err;
  reduce_rows_kernel<<<2 * Cout, kReduceThreads, 0, st>>>(pf32.partials, tiles * B, 2 * Cout,
                                                          2 * Cout, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// 32q: the quantizing epilogue of the forward, as a second kernel. One
// block per image row (b, h); a thread per lane l = j * C + c (column mod
// p, channel) walks its W / p columns (lane l of column group g is element
// g * p * C + l of the row: a warp's reads are consecutive), takes the max
// of |y|, then writes q = clip(rint(y * (127 / m)), +-127) and the scale
// m * float32(1 / 127) (`_quant_rows`, conv3x3_v3.py:142-151). Each value
// comes from one exact max and one rounding per operation, so the result
// does not depend on the order: no sums, nothing to repeat.
constexpr int kQuantThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
    conv3x3_q_quant_kernel(const T* __restrict__ y, int8_t* __restrict__ q,
                           float* __restrict__ scale, int W, int C, int p) {
  const int64_t row = blockIdx.x;  // b * H + h
  const int L = p * C, G = W / p;
  const T* yr = y + row * W * C;
  int8_t* qr = q + row * W * C;
  const float inv_qmax = static_cast<float>(1.0 / 127.0);  // as the JAX package rounds it
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    float m = 0.f;
    for (int g = 0; g < G; ++g) m = fmaxf(m, fabsf(to_f32(yr[(int64_t)g * L + l])));
    const float inv = m > 0.f ? __fdiv_rn(127.f, m) : 0.f;
    for (int g = 0; g < G; ++g) {
      const float v = rintf(__fmul_rn(to_f32(yr[(int64_t)g * L + l]), inv));  // half to even
      qr[(int64_t)g * L + l] = static_cast<int8_t>(fminf(fmaxf(v, -127.f), 127.f));
    }
    scale[row * L + l] = __fmul_rn(m, inv_qmax);
  }
}

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

}  // namespace
}  // namespace cltorch

// Plain C interface, loaded with ctypes; each returns cudaGetLastError().
// The wrapper (cl_tpu_torch/kernels/conv3x3.py) checks the operands: NHWC
// tensors contiguous and 16-byte aligned, of one type; w of that type,
// [3, 3, Cout, Cin] for bf16 and [Cin, 3, 3, Cout] for f32 in the
// kernel's own Cin / Cout (for dx: the flipped, transposed weight); a, b
// f32 [Cin] for the forward, [Cout] for dx (read only with `prologue`);
// s1, s2 f32 [Cin] or null; `partials` holds (number of 16 x 16 tiles) *
// B * 2 * Cout floats; `out` is [2, Cout]: the forward's (sum, sum of
// squares), dx's (da, db).
extern "C" {

int cltorch_conv3x3_bn_fwd(const void* x, const void* w, const void* a, const void* b, void* y,
                           void* partials, void* out, int B, int H, int W, int Cin, int Cout,
                           int prologue, int is_bf16, void* stream) {
  using namespace cltorch;
  return conv3x3_launch<kFwd>(
      conv_args<bf16>(x, nullptr, nullptr, nullptr, w, a, b, nullptr, y, partials, H, W, Cin,
                      Cout, prologue),
      conv_args<float>(x, nullptr, nullptr, nullptr, w, a, b, nullptr, y, partials, H, W, Cin,
                       Cout, prologue),
      is_bf16, B, out, static_cast<cudaStream_t>(stream));
}

// dx of the conv: dy, y [B, H, W, Cin] (the forward's output side), x and
// dx [B, H, W, Cout] (its input side).
int cltorch_conv3x3_bn_dx(const void* dy, const void* y, const void* s1, const void* s2,
                          const void* w, const void* x, const void* a, const void* b, void* dx,
                          void* partials, void* out, int B, int H, int W, int Cin, int Cout,
                          int prologue, int is_bf16, void* stream) {
  using namespace cltorch;
  return conv3x3_launch<kDx>(
      conv_args<bf16>(dy, y, s1, s2, w, a, b, x, dx, partials, H, W, Cin, Cout, prologue),
      conv_args<float>(dy, y, s1, s2, w, a, b, x, dx, partials, H, W, Cin, Cout, prologue),
      is_bf16, B, out, static_cast<cudaStream_t>(stream));
}

// 32q: y [B, H, W, C] -> q int8 [B, H, W, C] and scale f32 [B, H, p, C];
// W a multiple of p.
int cltorch_conv3x3_bn_quant(const void* y, void* q, void* scale, int B, int H, int W, int C,
                             int p, int is_bf16, void* stream) {
  using namespace cltorch;
  const int threads = p * C < kQuantThreads ? (p * C + 31) / 32 * 32 : kQuantThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    conv3x3_q_quant_kernel<bf16><<<B * H, threads, 0, st>>>(
        static_cast<const bf16*>(y), static_cast<int8_t*>(q), static_cast<float*>(scale), W, C,
        p);
  else
    conv3x3_q_quant_kernel<float><<<B * H, threads, 0, st>>>(
        static_cast<const float*>(y), static_cast<int8_t*>(q), static_cast<float*>(scale), W,
        C, p);
  return (int)cudaGetLastError();
}

// #38: dx of the conv from the int8 saved y (yq, ysc [B, H, pack, Cin]) and,
// when xq is given, the int8 saved x (xq, xsc [B, H, pack, Cout]) in place
// of x; the other operands as for cltorch_conv3x3_bn_dx.
int cltorch_conv3x3_bn_dx_q(const void* dy, const void* yq, const void* ysc, const void* s1,
                            const void* s2, const void* w, const void* x, const void* xq,
                            const void* xsc, const void* a, const void* b, void* dx,
                            void* partials, void* out, int B, int H, int W, int Cin, int Cout,
                            int prologue, int pack, int is_bf16, void* stream) {
  using namespace cltorch;
  auto pb16 = conv_args<bf16>(dy, nullptr, s1, s2, w, a, b, x, dx, partials, H, W, Cin, Cout,
                              prologue);
  auto pf32 = conv_args<float>(dy, nullptr, s1, s2, w, a, b, x, dx, partials, H, W, Cin, Cout,
                               prologue);
  pb16.yq = pf32.yq = static_cast<const int8_t*>(yq);
  pb16.xq = pf32.xq = static_cast<const int8_t*>(xq);
  pb16.ysc = pf32.ysc = static_cast<const float*>(ysc);
  pb16.xsc = pf32.xsc = static_cast<const float*>(xsc);
  pb16.pack = pf32.pack = pack;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return xq != nullptr ? conv3x3_launch<kDxQX>(pb16, pf32, is_bf16, B, out, st)
                       : conv3x3_launch<kDxQ>(pb16, pf32, is_bf16, B, out, st);
}

// The plain gen-3 conv: x [B, H, W, Cin] -> y [B, H, W, Cout], w as for
// the forward above.
int cltorch_conv3x3_fwd(const void* x, const void* w, void* y, int B, int H, int W, int Cin,
                        int Cout, int is_bf16, void* stream) {
  using namespace cltorch;
  return conv3x3_launch<kPlain>(
      conv_args<bf16>(x, nullptr, nullptr, nullptr, w, nullptr, nullptr, nullptr, y, nullptr, H,
                      W, Cin, Cout, 0),
      conv_args<float>(x, nullptr, nullptr, nullptr, w, nullptr, nullptr, nullptr, y, nullptr,
                       H, W, Cin, Cout, 0),
      is_bf16, B, nullptr, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
