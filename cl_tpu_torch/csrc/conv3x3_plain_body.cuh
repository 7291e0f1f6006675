// The plain 3x3 SAME conv, y = round(conv3x3_SAME(x, w)) over NHWC with
// one f32 sum an output rounded once to x's type, no prologue and no
// statistics: the gen-3 conv (#30, cl_tpu/pallas/conv3x3_v3.py::_fwd_kernel,
// launched at conv3x3_v3.py:522) and the gen-2 conv (#40,
// cl_tpu/pallas/conv3x3.py::_fwd_kernel, launched at conv3x3.py:279), each
// also as its VJP's dx (the conv of dy with the flipped, transposed
// weight) and #30 as the two-pass backward's dt. conv3x3_bn.cu instances
// these bodies under gen-3 names, conv3x3_g2.cu under gen-2 names (their
// profile families); both entries launch through the runs below, with the
// schedule the wrapper picks (kernels/conv3x3.py::conv_plain_tile,
// conv_plain_blocks, plain_fma_tile).
//
// What bounds it on the H100 (batch 8, 256^2 x 64 -> 64): in bf16 the
// bytes (134 MB read and written, 0.0401 ms at 3.35 TB/s; the products,
// 38.7 GFLOP, 0.039 ms at 989 TFLOP/s); in f32 the FMA units (0.577 ms at
// 67 TFLOP/s). The first bodies (conv3x3_body.cuh) ran at 5.3x (bf16,
// 0.2117 ms) and 2.6x (f32, 1.4978 ms) of those bounds: each 16-channel
// chunk staged synchronously, two barriers a chunk, nothing in flight while
// it multiplied; every block re-staging its weights; 32-bit (bf16) or
// scalar, bank-conflicting (f32) fragment loads.
//
// * bf16: the ring body's kPlain MODE (conv3x3_ring_body.cuh): persistent
//   blocks over one wave, a ring of three stages of 18 x 18 windows, each
//   one TMA box (plain loads where Cin is not a multiple of 8), the weights
//   resident for the block's walk where they fit (else carried with each
//   stage), the window used as it lands; the products on wgmma with A from
//   registers (the ring's ldmatrix.x4 fragments at the tap's shift, one
//   image row a warp, into three register buffers so that two taps' products
//   run while the next tap's A loads) and B the tap's [COT][16] weight slice
//   by descriptor; no wait between stages unless the weights travel with
//   them. The schedule (COT 32, 64 or 128; 16 or 32 input channels a stage;
//   resident weights; blocks) is the one the card ran fastest
//   (kernels/conv3x3.py::conv_plain_tile). On the H100 (700 W, batch 8,
//   card sleep, kernel_ab; PERF.md §6) it runs 256^2 x 64 -> 64 in 0.1298 ms
//   against the first body's 0.2086, F.conv2d's 0.0985 and the bound 0.0401,
//   and beats the packed conv's mma.sync ring forward without its prologue
//   at every listed shape (0.1736 there): held by shared-memory traffic (a
//   tap's A, 8 KB a 16 x 16 tile, and B read once a 64-row product, 8 KB at
//   COT 64, against 0.5 MFLOP), not by the copies (three or more stages ran
//   no faster). Registers (ptxas, 256 threads): COT 128 196-198, no spills;
//   COT 64 128 (two blocks an SM) with 12-24 bytes a thread spilled; COT 32
//   102, none. ptxas injects one warpgroup wait into each instance (its
//   note C7517: registers a product defines, used after it) and
//   serializes none.
//   A second design was measured and deleted: wgmma with both operands in
//   shared memory, the weights as A (64 output channels) and as B the N
//   contiguous pixels of one of three shifted window copies (no ldmatrix,
//   N = 128 or 256). It ran 10-25% faster where COT is 128 (256^2 x 64 ->
//   128 0.1858 against 0.2259) but 2.1x slower at 512^2 x 32 -> 32 (0.3245
//   against 0.1571, slower than the ring forward's 0.1888): its copies are
//   three TMA boxes of 32-byte rows a stage, and a 64-row product wastes
//   half its rows below 64 output channels.
// * f32: plain_fma_body below, a register-blocked FMA body: 128 threads, a
//   16 x 16 pixel tile for COT = 64 (or 32) output channels, each thread one
//   pixel row of 16 x COT / 8 channels. Per input channel and kernel row it
//   reads the window row as five float4s (rows 80 bytes apart: the 8 rows
//   a quarter-warp reads fall on distinct banks) and, per tap, COT / 8
//   weights as float4 broadcasts: 16 x COT / 8 x 3 FMAs for 5 + 3 COT / 32
//   16-byte loads (384 for 11 at COT 64, 192 for 8 at 32). A three-stage
//   cp.async ring of 8 input channels (window and weights) a stage, so the
//   copies of stage k + 2 run while stage k multiplies; one barrier a
//   stage. The sum runs in the first body's order (ci ascending, ky, kx,
//   one fmaf each), rounded once: no TF32. Its COT is 64 where the blocks
//   fill a wave, else 32 (plain_fma_tile). Registers (ptxas): 251 at COT 64
//   (two blocks an SM), 167 at 32 (three), no spills. On the H100 (700 W,
//   kernel_ab; PERF.md §6) 256^2 x 64 -> 64 takes 0.9636 ms against the first
//   body's 1.4597, cuDNN's f32 1.1351 and the bound 0.5769 (0.60 of the
//   FMA peak); every listed shape is faster than cuDNN's f32.

#pragma once

#include "conv3x3_ring_body.cuh"

namespace cltorch {
namespace {

// ---------------------------------------------------------------------------
// bf16: the ring body's plain MODE
// ---------------------------------------------------------------------------

// Blocks an SM the instance's registers are fitted to (__launch_bounds__):
// two up to 64 output channels, one at 128 (128 accumulators a thread).
template <int COT>
struct PlainRing {
  static constexpr int kMinBlocks = COT == 128 ? 1 : 2;
};

// One launch of a plain ring instance over `blocks` x (Cout / COT) blocks.
// `launch(grid, threads, smem, ra, maps)` launches the caller's kernel (of
// its own name); maps[0] is the window's, maps[1] the weight's.
template <int COT, int CK, typename Launch>
int plain_ring_run(const void* kernel, Launch&& launch, const void* x, const void* w, int B, int H,
                   int W, int Cin, int Cout, int resident, int blocks) {
  const RingArgs ra{B, resident, (Cin & 7) == 0, 0};
  const int smem = conv_plain_smem<COT, CK>(resident != 0, Cin);
  if ((!resident && !ra.tma) || smem > kSmemMax || blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = smem_allowed(kernel, kSmemMax);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tms[2] = {};
  if (ra.tma && ((err = tm_nhwc(&tms[0], x, B, H, W, Cin, CK, kWinW, kWinH)) != cudaSuccess ||
                 (err = tm_weights(&tms[1], w, Cin, Cout, CK, COT)) != cudaSuccess))
    return (int)err;
  launch(dim3(blocks, (Cout + COT - 1) / COT), kRingConvThreads, smem, ra, tms);
  return (int)cudaGetLastError();
}

// What the card gives a plain ring instance at `smem` bytes (out[4] as
// kernel_info), its shared memory allowed at the most first, as its runs do.
inline int plain_ring_info(const void* kernel, int smem, int* out) {
  const cudaError_t err = smem_allowed(kernel, kSmemMax);
  return err != cudaSuccess ? (int)err : kernel_info(kernel, kRingConvThreads, smem, out);
}

// ---------------------------------------------------------------------------
// f32: the register-blocked FMA body
// ---------------------------------------------------------------------------

constexpr int kPfThreads = 128;  // 16 pixel rows x 8 channel groups
constexpr int kPfCi = 8;         // input channels a stage
constexpr int kPfStages = 3;     // the products of one, the copies of two
constexpr int kPfRow = 20;       // floats a window row: 18, and 2 to 16-byte rows
constexpr int kPfPlane = kWinH * kPfRow + 4;  // floats a channel's window: its copies' banks

// Sizes of a COT instance in floats: a stage is the window's kPfCi planes
// and their weights [kPfCi][9][COT].
template <int COT>
struct PlainFmaTile {
  static_assert(COT == 32 || COT == 64, "32 or 64 output channels");
  static constexpr int kC = COT / 8;  // output channels a thread
  static constexpr int kWin = kPfCi * kPfPlane;
  static constexpr int kStage = kWin + kPfCi * 9 * COT;
  static constexpr int kSmem = kPfStages * kStage * 4;  // bytes
  // registers (16 x kC accumulators) for two blocks an SM at 64, three at 32
  static constexpr int kMinBlocks = COT == 64 ? 2 : 3;
};

// x [B, H, W, Cin], w [Cin, 3, 3, Cout] (f32) -> y [B, H, W, Cout]; a block
// per 16 x 16 pixel tile (blockIdx.x), COT output channels (y) and image (z).
template <int COT>
__device__ __forceinline__ void plain_fma_body(const float* __restrict__ x,
                                               const float* __restrict__ w,
                                               float* __restrict__ y, int H, int W, int Cin,
                                               int Cout) {
  using Tile = PlainFmaTile<COT>;
  constexpr int C = Tile::kC;
  extern __shared__ __align__(16) float plain_fma_smem[];
  const int tiles_x = (W + kTW - 1) / kTW;
  const int gy0 = (blockIdx.x / tiles_x) * kTH, gx0 = (blockIdx.x % tiles_x) * kTW;
  const int co0 = blockIdx.y * COT, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // a quarter-warp: 8 rows of one channel group (distinct banks, one weight)
  const int ty = lane & 15, cg = (warp * 2 + (lane >> 4)) * C;
  const int64_t img = (int64_t)b * H * W;
  const int n_stages = (Cin + kPfCi - 1) / kPfCi;
  const bool w16 = (Cout & 3) == 0;  // weight rows by 16-byte copies

  // The copies of stage k (zeros outside the image and past Cin or Cout),
  // and their group, committed even where empty so the waits count stages.
  auto issue = [&](int k) {
    if (k < n_stages) {
      float* win = plain_fma_smem + (k % kPfStages) * Tile::kStage;
      float* ws = win + Tile::kWin;
      const int ci0 = k * kPfCi;
      for (int e = threadIdx.x; e < kPfCi * kWinH * kWinW; e += kPfThreads) {
        const int ci = e % kPfCi, pix = e / kPfCi;
        const int wy = pix / kWinW, wx = pix % kWinW;
        const int gy = gy0 - 1 + wy, gx = gx0 - 1 + wx, c = ci0 + ci;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cin;
        cp_async<4>(&win[ci * kPfPlane + wy * kPfRow + wx],
                    in ? x + (img + (int64_t)gy * W + gx) * Cin + c : x, in);
      }
      if (w16) {
        for (int e = threadIdx.x; e < kPfCi * 9 * COT / 4; e += kPfThreads) {
          const int q = e % (COT / 4), row = e / (COT / 4);  // row = ci * 9 + tap
          const int c = ci0 + row / 9, o = co0 + 4 * q;
          const bool in = c < Cin && o < Cout;
          cp_async<16>(&ws[row * COT + 4 * q],
                       in ? w + ((int64_t)c * 9 + row % 9) * Cout + o : w, in);
        }
      } else {
        for (int e = threadIdx.x; e < kPfCi * 9 * COT; e += kPfThreads) {
          const int q = e % COT, row = e / COT;
          const int c = ci0 + row / 9, o = co0 + q;
          const bool in = c < Cin && o < Cout;
          cp_async<4>(&ws[row * COT + q], in ? w + ((int64_t)c * 9 + row % 9) * Cout + o : w,
                      in);
        }
      }
    }
    cp_async_commit();
  };

  float acc[16][C];
#pragma unroll
  for (int q = 0; q < 16; ++q)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[q][c] = 0.f;

#pragma unroll
  for (int k = 0; k < kPfStages - 1; ++k) issue(k);
  for (int k = 0; k < n_stages; ++k) {
    cp_async_wait<kPfStages - 2>();  // stage k has landed (this thread's copies)
    // every thread's copies of stage k, and every warp past the products of
    // stage k - 1, whose slot takes stage k + 2
    __syncthreads();
    issue(k + kPfStages - 1);
    const float* win = plain_fma_smem + (k % kPfStages) * Tile::kStage;
    const float* ws = win + Tile::kWin;
#pragma unroll 2
    for (int ci = 0; ci < kPfCi; ++ci) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        float v[kPfRow];
        const float4* row =
            reinterpret_cast<const float4*>(&win[ci * kPfPlane + (ty + ky) * kPfRow]);
#pragma unroll
        for (int i = 0; i < kPfRow / 4; ++i) {
          const float4 t = row[i];
          v[4 * i] = t.x;
          v[4 * i + 1] = t.y;
          v[4 * i + 2] = t.z;
          v[4 * i + 3] = t.w;
        }
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          float wv[C];
          const float4* wr =
              reinterpret_cast<const float4*>(&ws[(ci * 9 + ky * 3 + kx) * COT + cg]);
#pragma unroll
          for (int i = 0; i < C / 4; ++i) {
            const float4 t = wr[i];
            wv[4 * i] = t.x;
            wv[4 * i + 1] = t.y;
            wv[4 * i + 2] = t.z;
            wv[4 * i + 3] = t.w;
          }
#pragma unroll
          for (int q = 0; q < 16; ++q)
#pragma unroll
            for (int c = 0; c < C; ++c) acc[q][c] = fmaf(v[q + kx], wv[c], acc[q][c]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int gy = gy0 + ty;
  if (gy >= H) return;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int gx = gx0 + q;
    if (gx >= W) break;
    float* dst = y + (img + (int64_t)gy * W + gx) * Cout;
#pragma unroll
    for (int i = 0; i < C / 4; ++i) {
      const int o = co0 + cg + 4 * i;
      if (w16 && o + 3 < Cout) {
        *reinterpret_cast<float4*>(dst + o) =
            make_float4(acc[q][4 * i], acc[q][4 * i + 1], acc[q][4 * i + 2], acc[q][4 * i + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (o + j < Cout) dst[o + j] = acc[q][4 * i + j];
      }
    }
  }
}

// One launch of a register-blocked instance: `launch(grid, threads, smem)`.
template <int COT, typename Launch>
int plain_fma_run(const void* kernel, Launch&& launch, int B, int H, int W, int Cout) {
  using Tile = PlainFmaTile<COT>;
  const cudaError_t err = smem_allowed(kernel, Tile::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
  launch(dim3(tiles, (Cout + COT - 1) / COT, B), kPfThreads, Tile::kSmem);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cltorch

// The instances: bf16 (COT, CK) as kernels/conv3x3.py::conv_plain_tile
// picks them, f32 COT as plain_fma_tile does; any other is refused
// (cudaErrorInvalidValue). RING(COT, CK) and FMA(COT) return the
// instance's result.
#define CLTORCH_PLAIN_DISPATCH(RING, FMA)                        \
  if (is_bf16) {                                                  \
    if (cot == 32 && ck == 16) return RING(32, 16);               \
    if (cot == 32 && ck == 32) return RING(32, 32);               \
    if (cot == 64 && ck == 16) return RING(64, 16);               \
    if (cot == 64 && ck == 32) return RING(64, 32);               \
    if (cot == 128 && ck == 16) return RING(128, 16);             \
    if (cot == 128 && ck == 32) return RING(128, 32);             \
    return (int)cudaErrorInvalidValue;                            \
  }                                                               \
  if (cot == 32) return FMA(32);                                  \
  if (cot == 64) return FMA(64);                                  \
  return (int)cudaErrorInvalidValue;

// The kernels of one route, named NAME_ring_kernel<COT, CK> (bf16) and
// NAME_fma_kernel<COT> (f32), for its profile family.
#define CLTORCH_PLAIN_KERNELS(NAME)                                                                \
  template <int COT, int CK>                                                                       \
  __global__ void __launch_bounds__(kRingConvThreads, PlainRing<COT>::kMinBlocks)                  \
      NAME##_ring_kernel(ConvArgs<bf16> p, RingArgs ra, const __grid_constant__ CUtensorMap tm_in, \
                         const __grid_constant__ CUtensorMap tm_w) {                               \
    conv_ring_body<kPlain, COT, CK, false>(p, ra, &tm_in, &tm_in, &tm_w, &tm_in);                  \
  }                                                                                                \
  template <int COT>                                                                               \
  __global__ void __launch_bounds__(kPfThreads, PlainFmaTile<COT>::kMinBlocks)                     \
      NAME##_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,                  \
                        float* __restrict__ y, int H, int W, int Cin, int Cout) {                  \
    plain_fma_body<COT>(x, w, y, H, W, Cin, Cout);                                                 \
  }

// One instance's run inside a plain entry point (x, w, y, B, H, W, Cin,
// Cout, resident, blocks, the stream st and the bf16 operands pb in scope).
#define CLTORCH_PLAIN_RING_RUN(NAME, COT, CK)                                                      \
  plain_ring_run<COT, CK>(                                                                         \
      kernel_ptr(NAME##_ring_kernel<COT, CK>),                                                     \
      [&](dim3 grid, int threads, int smem, const RingArgs& ra, const CUtensorMap* tm) {           \
        NAME##_ring_kernel<COT, CK><<<grid, threads, smem, st>>>(pb, ra, tm[0], tm[1]);            \
      },                                                                                           \
      x, w, B, H, W, Cin, Cout, resident, blocks)
#define CLTORCH_PLAIN_FMA_RUN(NAME, COT)                                                           \
  plain_fma_run<COT>(                                                                              \
      kernel_ptr(NAME##_fma_kernel<COT>),                                                          \
      [&](dim3 grid, int threads, int smem) {                                                      \
        NAME##_fma_kernel<COT><<<grid, threads, smem, st>>>(static_cast<const float*>(x),          \
                                                            static_cast<const float*>(w),          \
                                                            static_cast<float*>(y), H, W, Cin,     \
                                                            Cout);                                 \
      },                                                                                           \
      B, H, W, Cout)
