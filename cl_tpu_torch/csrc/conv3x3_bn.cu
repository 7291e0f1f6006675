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
// What bounds it on the H100 (bf16, batch 8; the bound the larger of the
// bytes each input read once and each output written once at 3.35 TB/s
// and the products at 989 TFLOP/s, chip_smoke.packed_bytes_ops /
// bwd_bytes_ops): bytes at the 512^2 and 256^2 levels (512^2 x 32 -> 32:
// the forward 0.080 ms, #34 0.120, #35 0.160), the tensor cores at 128^2
// (128 -> 128: 38.7 GFLOP, 0.039 ms); in f32 the FMA units (580 us at the
// f32 peak of 67 TFLOP/s at 512^2 x 32 -> 32).
//
// Where each runs: in bf16 the forward and dx (#32, #34/#35) launch the
// ring body (conv3x3_ring.cu, conv3x3_ring_body.cuh, whose note gives the
// per-shape bounds, what held the first body at 4-6x them and what the
// ring does about it, and why the dx's accumulation order is fixed),
// which the wrapper calls directly. Here remain their
// f32 instances of the FMA body, and the first bf16 body
// (conv3x3_body.cuh::conv3x3_mma_body) for the plain conv and the dx from
// int8 below, with mma_chunk / mma_epilogue for 34p/35p: the order the
// ring keeps, so its dx gives their bits.
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
// And, under CL_TPU_DX_PIPE=1, 34p / 35p: ::_dx_pipe_slim_kernel and
// ::_dx_pipe_bn_kernel (conv3x3_v3.py:1187, :1179; body `_dx_pipe_body`,
// :1112), which `_dx_bn_impl` launches at the #34/#35 sites (:1233, :1259)
// in their place: the same dx through a cross-tile software pipeline,
// bit-identical to #34/#35 (tests/tpu/test_dx_pipe.py). Here
// conv3x3_bn_dx_pipe_mma_kernel / conv3x3_bn_dx_pipe_kernel: a block walks
// many pixel tiles and stages the next (tile, chunk)'s raw dy, y and
// weights by cp.async while the current one's products run (section
// "34p / 35p" below); the chunks, taps and epilogue are the bodies' own,
// so its bits are #34/#35's. Bound as #34/#35: bytes on the tensor cores.
//
// The first two bodies (FMA for f32, mma.sync for bf16), each templated on
// what it computes, are in conv3x3_body.cuh, shared with the gen-2 conv.

#include <algorithm>

#include "conv3x3_body.cuh"

namespace cltorch {
namespace {

// The f32 dx instances (here, #38's and 34p's) at four blocks an SM: the
// blocked sum's fresh accumulator (conv3x3_body.cuh::fma_chunk) would take
// them to 165-168 registers and three blocks an SM, slower on the H100
// than 128 registers with 20-28 bytes a thread spilled.
constexpr int kFmaDxMinBlocks = 4;

template <bool DX, typename T>
__global__ void __launch_bounds__(kConvThreads, DX && sizeof(T) == 4 ? kFmaDxMinBlocks : 1)
    conv3x3_bn_kernel(ConvArgs<T> p) {
  conv3x3_fma_body<DX ? kDx : kFwd>(p);
}

template <typename T>
__global__ void __launch_bounds__(kConvThreads) conv3x3_v3_kernel(ConvArgs<T> p) {
  conv3x3_fma_body<kPlain>(p);
}

template <int COT>
__global__ void __launch_bounds__(kMmaThreads) conv3x3_v3_mma_kernel(ConvArgs<bf16> p) {
  conv3x3_mma_body<kPlain, COT>(p);
}

// #38: the dx from the int8 saved y (MODE kDxQ) and x (kDxQX).
template <int MODE, typename T>
__global__ void __launch_bounds__(kConvThreads, sizeof(T) == 4 ? kFmaDxMinBlocks : 1)
    conv3x3_q_dx_kernel(ConvArgs<T> p) {
  conv3x3_fma_body<MODE>(p);
}

template <int MODE, int COT>
__global__ void __launch_bounds__(kMmaThreads) conv3x3_q_dx_mma_kernel(ConvArgs<bf16> p) {
  conv3x3_mma_body<MODE, COT>(p);
}

// Launches the kernel of the type and mode and, when it sums, the
// reduction of its partial rows into out [2, Cout]. The forward and dx take
// f32 only here: in bf16 they run the ring body (conv3x3_ring.cu).
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
  } else {  // f32; bf16 runs the ring body (conv3x3_ring.cu)
    if (is_bf16) return (int)cudaErrorInvalidValue;
    conv3x3_bn_kernel<DX, float><<<grid32, kConvThreads, 0, st>>>(pf32);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || (DX && !pf32.prologue)) return (int)err;
  reduce_rows_kernel<<<2 * Cout, kReduceThreads, 0, st>>>(pf32.partials, tiles * B, 2 * Cout,
                                                          2 * Cout, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 34p / 35p: the dx pipelined across pixel tiles (CL_TPU_DX_PIPE)
// ---------------------------------------------------------------------------
//
// A block walks the pixel tiles blockIdx.x, + gridDim.x, ... of all B
// images for one tile of output channels, and within each tile its
// 16-channel chunks of dy: one flat sequence of stages (tile, chunk). The
// raw dy and y windows and the weights of stage s + 1 are in flight by
// cp.async into the second of two buffers while stage s's products run;
// e is then formed in place from the raw dy (its stats term from the raw
// y) and the products read it. Within a tile the chunks, the taps, the
// epilogue and its partial row are #34/#35's (mma_chunk / fma_chunk and
// their epilogues), so every output is bit-equal to theirs. Out-of-image
// pixels and channels past Cin arrive as zeros (cp.async's zero fill) and
// stay zero: e-space padding. Where a row of dy is not 16-byte aligned
// (bf16 with Cin % 8 != 0) the stage is loaded by plain loads instead.

constexpr int kPipeBlocks = 2 * 132;  // blocks of a launch, over the channel tiles

// bf16: issue stage (b, gy0, gx0, chunk ci0) into the buffers dy_s, y_s
// (windows, rows of kRowS) and w_s ([tap][co][kRowS]).
template <int COT>
__device__ __forceinline__ void pipe_issue_mma(const ConvArgs<bf16>& p, bf16* dy_s, bf16* y_s,
                                               bf16* w_s, int b, int gy0, int gx0, int ci0,
                                               int co0) {
  const int H = p.H, W = p.W, Cin = p.Cin, Cout = p.Cout;
  const int64_t img = (int64_t)b * H * W;
  const bool vec = (Cin & 7) == 0;
  for (int e = threadIdx.x; e < kWinH * kWinW * 2; e += kMmaThreads) {
    const int pix = e >> 1, half = e & 1;
    const int gy = gy0 - 1 + pix / kWinW, gx = gx0 - 1 + pix % kWinW;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const int c = ci0 + half * 8;
    const int64_t i = inside ? (img + (int64_t)gy * W + gx) * Cin + c : 0;
    bf16* d = &dy_s[pix * kRowS + half * 8];
    bf16* yd = &y_s[pix * kRowS + half * 8];
    if (vec) {
      const bool ok = inside && c < Cin;
      cp_async<16>(d, p.in + (ok ? i : 0), ok);
      if (p.s1 != nullptr) cp_async<16>(yd, p.y + (ok ? i : 0), ok);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const bool ok = inside && c + k < Cin;
        d[k] = ok ? p.in[i + k] : __float2bfloat16(0.f);
        if (p.s1 != nullptr) yd[k] = ok ? p.y[i + k] : __float2bfloat16(0.f);
      }
    }
  }
  for (int e = threadIdx.x; e < 9 * COT * 2; e += kMmaThreads) {
    const int half = e & 1, row = e >> 1;  // row = tap * COT + co
    const int co = row % COT, tap = row / COT;
    const int c = ci0 + half * 8;
    const bool in_co = co0 + co < Cout;
    const int64_t i = in_co ? ((int64_t)tap * Cout + co0 + co) * Cin + c : 0;
    bf16* d = &w_s[row * kRowS + half * 8];
    if (vec) {
      const bool ok = in_co && c < Cin;
      cp_async<16>(d, p.w + (ok ? i : 0), ok);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        d[k] = in_co && c + k < Cin ? p.w[i + k] : __float2bfloat16(0.f);
    }
  }
}

// bf16: e = round(dy + ds1 + 2 * y * ds2) in place over the staged raw dy,
// at in-image pixels and channels below Cin (stage8_e's arithmetic, the
// bf16 chain under p.ew_bf16); e = dy without stats cotangents.
__device__ __forceinline__ void pipe_form_e_mma(const ConvArgs<bf16>& p, bf16* dy_s,
                                                const bf16* y_s, int gy0, int gx0, int ci0) {
  if (p.s1 == nullptr) return;
  with_ew(p.ew_bf16, [&](auto ew) {
    for (int e = threadIdx.x; e < kWinH * kWinW * 16; e += kMmaThreads) {
      const int pix = e >> 4, k = e & 15;
      const int gy = gy0 - 1 + pix / kWinW, gx = gx0 - 1 + pix % kWinW;
      const int c = ci0 + k;
      if (gy < 0 || gy >= p.H || gx < 0 || gx >= p.W || c >= p.Cin) continue;
      bf16& v = dy_s[pix * kRowS + k];
      v = __float2bfloat16(e_ew<decltype(ew)::value>(
          __bfloat162float(v), __bfloat162float(y_s[pix * kRowS + k]), p.s1[c], p.s2[c]));
    }
  });
}

template <int COT>
constexpr size_t pipe_smem_mma() {
  return (4 * (size_t)kWinH * kWinW * kRowS + 2 * 9 * COT * kRowS) * sizeof(bf16) +
         (kMmaThreads / 32) * 2 * COT * sizeof(float);
}

template <int COT>
__global__ void __launch_bounds__(kMmaThreads) conv3x3_bn_dx_pipe_mma_kernel(ConvArgs<bf16> p) {
  constexpr int NT = COT / 8, kWin = kWinH * kWinW * kRowS, kWts = 9 * COT * kRowS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* dy_s = reinterpret_cast<bf16*>(smem);  // [2][kWin]: raw dy, then e
  bf16* y_s = dy_s + 2 * kWin;                 // [2][kWin]
  bf16* w_s = y_s + 2 * kWin;                  // [2][kWts]
  float(*red)[2][COT] = reinterpret_cast<float(*)[2][COT]>(w_s + 2 * kWts);
  const int tiles_x = (p.W + kTW - 1) / kTW, tiles = tiles_x * ((p.H + kTH - 1) / kTH);
  const int n_tiles = p.batch * tiles, nch = (p.Cin + 15) / 16;
  const int co0 = blockIdx.y * COT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int my_tiles = (int)blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int n_stages = my_tiles * nch;
  auto coords = [&](int s, int& b, int& rem, int& gy0, int& gx0) {
    const int tile = blockIdx.x + (s / nch) * gridDim.x;
    b = tile / tiles;
    rem = tile % tiles;
    gy0 = (rem / tiles_x) * kTH;
    gx0 = (rem % tiles_x) * kTW;
  };
  int b, rem, gy0, gx0;
  if (n_stages > 0) {
    coords(0, b, rem, gy0, gx0);
    pipe_issue_mma<COT>(p, dy_s, y_s, w_s, b, gy0, gx0, 0, co0);
  }
  cp_async_commit();
  float acc[2][NT][4];
  for (int s = 0; s < n_stages; ++s) {
    const int buf = s & 1, chunk = s % nch;
    __syncthreads();  // stage s - 1's products are done with the other buffer
    if (s + 1 < n_stages) {
      coords(s + 1, b, rem, gy0, gx0);
      pipe_issue_mma<COT>(p, dy_s + (buf ^ 1) * kWin, y_s + (buf ^ 1) * kWin,
                          w_s + (buf ^ 1) * kWts, b, gy0, gx0, ((s + 1) % nch) * 16, co0);
    }
    cp_async_commit();
    cp_async_wait<1>();  // stage s has landed
    coords(s, b, rem, gy0, gx0);
    __syncthreads();
    pipe_form_e_mma(p, dy_s + buf * kWin, y_s + buf * kWin, gy0, gx0, chunk * 16);
    __syncthreads();
    if (chunk == 0) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][n][j] = 0.f;
    }
    mma_chunk<COT>(acc, dy_s + buf * kWin, w_s + buf * kWts, warp, g, t);
    if (chunk == nch - 1)
      mma_epilogue<kDx, COT>(p, acc, b, gy0, gx0, co0, b * tiles + rem, red, warp, g, t);
  }
  cp_async_wait<0>();
}

// f32: the same walk; the windows staged channel-major ([16][18][18], as
// conv3x3_fma_body stages them) by 4-byte copies, the weights [16][9][32].
__device__ __forceinline__ void pipe_issue_fma(const ConvArgs<float>& p, float* dy_s, float* y_s,
                                               float* w_s, int b, int gy0, int gx0, int ci0,
                                               int co0) {
  const int H = p.H, W = p.W, Cin = p.Cin, Cout = p.Cout;
  const int64_t img = (int64_t)b * H * W;
  for (int e = threadIdx.x; e < kCiT * kWinH * kWinW; e += kConvThreads) {
    const int ci = e % kCiT, pix = e / kCiT;
    const int gy = gy0 - 1 + pix / kWinW, gx = gx0 - 1 + pix % kWinW, c = ci0 + ci;
    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cin;
    const int64_t i = ok ? (img + (int64_t)gy * W + gx) * Cin + c : 0;
    cp_async<4>(&dy_s[ci * kWinH * kWinW + pix], p.in + i, ok);
    if (p.s1 != nullptr) cp_async<4>(&y_s[ci * kWinH * kWinW + pix], p.y + i, ok);
  }
  for (int e = threadIdx.x; e < kCiT * 9 * kCoT; e += kConvThreads) {
    const int co = e % kCoT, rest = e / kCoT;
    const int k = rest % 9, ci = rest / 9;
    const int c = ci0 + ci, o = co0 + co;
    const bool ok = c < Cin && o < Cout;
    cp_async<4>(&w_s[e], p.w + (ok ? ((int64_t)c * 9 + k) * Cout + o : 0), ok);
  }
}

__device__ __forceinline__ void pipe_form_e_fma(const ConvArgs<float>& p, float* dy_s,
                                                const float* y_s, int gy0, int gx0, int ci0) {
  if (p.s1 == nullptr) return;
  for (int e = threadIdx.x; e < kCiT * kWinH * kWinW; e += kConvThreads) {
    const int ci = e / (kWinH * kWinW), pix = e % (kWinH * kWinW);
    const int gy = gy0 - 1 + pix / kWinW, gx = gx0 - 1 + pix % kWinW, c = ci0 + ci;
    if (gy < 0 || gy >= p.H || gx < 0 || gx >= p.W || c >= p.Cin) continue;
    dy_s[e] = e_f32(dy_s[e], y_s[e], p.s1[c], p.s2[c]);
  }
}

constexpr size_t kPipeSmemFma =
    (4 * (size_t)kCiT * kWinH * kWinW + 2 * (size_t)kCiT * 9 * kCoT) * sizeof(float);

__global__ void __launch_bounds__(kConvThreads, kFmaDxMinBlocks)
    conv3x3_bn_dx_pipe_kernel(ConvArgs<float> p) {
  constexpr int kWin = kCiT * kWinH * kWinW, kWts = kCiT * 9 * kCoT;
  extern __shared__ __align__(16) unsigned char smem[];
  float* dy_s = reinterpret_cast<float*>(smem);  // [2][kWin]: raw dy, then e
  float* y_s = dy_s + 2 * kWin;                  // [2][kWin]
  float* w_s = y_s + 2 * kWin;                   // [2][kWts]
  const int tiles_x = (p.W + kTW - 1) / kTW, tiles = tiles_x * ((p.H + kTH - 1) / kTH);
  const int n_tiles = p.batch * tiles, nch = (p.Cin + kCiT - 1) / kCiT;
  const int co0 = blockIdx.y * kCoT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = lane >> 1, seg = lane & 1, cg = warp * 8;
  const int my_tiles = (int)blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int n_stages = my_tiles * nch;
  auto coords = [&](int s, int& b, int& rem, int& gy0, int& gx0) {
    const int tile = blockIdx.x + (s / nch) * gridDim.x;
    b = tile / tiles;
    rem = tile % tiles;
    gy0 = (rem / tiles_x) * kTH;
    gx0 = (rem % tiles_x) * kTW;
  };
  int b, rem, gy0, gx0;
  if (n_stages > 0) {
    coords(0, b, rem, gy0, gx0);
    pipe_issue_fma(p, dy_s, y_s, w_s, b, gy0, gx0, 0, co0);
  }
  cp_async_commit();
  float acc[8][8];
  for (int s = 0; s < n_stages; ++s) {
    const int buf = s & 1, chunk = s % nch;
    __syncthreads();
    if (s + 1 < n_stages) {
      coords(s + 1, b, rem, gy0, gx0);
      pipe_issue_fma(p, dy_s + (buf ^ 1) * kWin, y_s + (buf ^ 1) * kWin, w_s + (buf ^ 1) * kWts,
                     b, gy0, gx0, ((s + 1) % nch) * kCiT, co0);
    }
    cp_async_commit();
    cp_async_wait<1>();
    coords(s, b, rem, gy0, gx0);
    __syncthreads();
    pipe_form_e_fma(p, dy_s + buf * kWin, y_s + buf * kWin, gy0, gx0, chunk * kCiT);
    __syncthreads();
    if (chunk == 0) {
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[q][c] = 0.f;
    }
    fma_chunk<true>(acc, reinterpret_cast<float(*)[kWinH][kWinW]>(dy_s + buf * kWin),
              reinterpret_cast<float(*)[9][kCoT]>(w_s + buf * kWts), ty, seg, cg);
    if (chunk == nch - 1)
      fma_epilogue<kDx>(p, acc, b, gy0, gx0, co0, b * tiles + rem, ty, seg, cg, lane);
  }
  cp_async_wait<0>();
}

// Launches the pipelined dx of the type and, with the prologue, the
// reduction of its per-tile partial rows (#34/#35's rows) into out.
int conv3x3_dx_pipe_launch(ConvArgs<bf16> pb16, ConvArgs<float> pf32, int is_bf16, void* out,
                           cudaStream_t st) {
  const int H = pf32.H, W = pf32.W, Cout = pf32.Cout, B = pf32.batch;
  const int tiles = ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
  const int cot = !is_bf16 || Cout % 64 != 0 ? 32 : 64;
  const int ctiles = (Cout + cot - 1) / cot;
  const dim3 grid(std::min(tiles * B, std::max(1, kPipeBlocks / ctiles)), ctiles);
  cudaError_t err;
  if (!is_bf16) {
    err = cudaFuncSetAttribute(conv3x3_bn_dx_pipe_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kPipeSmemFma);
    if (err != cudaSuccess) return (int)err;
    conv3x3_bn_dx_pipe_kernel<<<grid, kConvThreads, kPipeSmemFma, st>>>(pf32);
  } else if (cot == 64) {
    err = cudaFuncSetAttribute(conv3x3_bn_dx_pipe_mma_kernel<64>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)pipe_smem_mma<64>());
    if (err != cudaSuccess) return (int)err;
    conv3x3_bn_dx_pipe_mma_kernel<64><<<grid, kMmaThreads, pipe_smem_mma<64>(), st>>>(pb16);
  } else {
    err = cudaFuncSetAttribute(conv3x3_bn_dx_pipe_mma_kernel<32>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)pipe_smem_mma<32>());
    if (err != cudaSuccess) return (int)err;
    conv3x3_bn_dx_pipe_mma_kernel<32><<<grid, kMmaThreads, pipe_smem_mma<32>(), st>>>(pb16);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || !pf32.prologue) return (int)err;
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
// squares), dx's (da, db). The forward and dx take f32 only: in bf16 the
// wrapper calls conv3x3_ring.cu's cltorch_conv3x3_bn_ring.
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

// 34p / 35p: the dx pipelined across pixel tiles; the operands and outputs
// of cltorch_conv3x3_bn_dx, and every bit of its results (in bf16, of the
// ring's dx: `ew_bf16` forms e with the bf16 chain, as it does there).
int cltorch_conv3x3_bn_dx_pipe(const void* dy, const void* y, const void* s1, const void* s2,
                               const void* w, const void* x, const void* a, const void* b,
                               void* dx, void* partials, void* out, int B, int H, int W, int Cin,
                               int Cout, int prologue, int is_bf16, int ew_bf16, void* stream) {
  using namespace cltorch;
  auto pb16 = conv_args<bf16>(dy, y, s1, s2, w, a, b, x, dx, partials, H, W, Cin, Cout, prologue);
  auto pf32 = conv_args<float>(dy, y, s1, s2, w, a, b, x, dx, partials, H, W, Cin, Cout,
                               prologue);
  pb16.batch = pf32.batch = B;
  pb16.ew_bf16 = ew_bf16;
  return conv3x3_dx_pipe_launch(pb16, pf32, is_bf16, out, static_cast<cudaStream_t>(stream));
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
