// Weight gradient of the 3x3 SAME conv with the BN-ReLU prologue, and of
// the plain gen-3 conv.
//
// Replaces the TPU kernel cl_tpu/pallas/conv3x3_v3.py::_dw_bn2_kernel
// (launched at conv3x3_v3.py:1332 by `_dw_bn2_impl`, from the fused branch
// of `conv_bn_fused`'s VJP, :951-961):
//
//   t = round(relu(x * a + b)) (prologue) or x, recomputed while staging
//   e = round(dy + ds1 + 2 * y * ds2) (or dy), formed while staging
//   dW[co, ci, ky, kx] = sum over pixels p of e[p, co] * t[p + (ky-1, kx-1), ci]
//
// in f32 (the wrapper rounds it to the compute type once, as the JAX
// package's `dw.astype(w.dtype)` does, :957). t and e are staged exactly as
// the forward and dx kernels stage them (conv3x3_bn.cuh): zero outside the
// image, the same rounding points.
//
// Two more instances of the same bodies (KIND below), each computing only
// its own function:
// * cl_tpu/pallas/conv3x3_v3.py::_dw_kernel (launched at :564 by
//   `_dw_packed`), the dW of `conv3x3` / `conv3x3_packed` under
//   model.conv_impl=v3|auto: t = x, e = dy, no y or stats reads (kDwPlain;
//   the VJP rounds dW once to the compute type, :621, :643);
// * ::_dw_bn_kernel (launched at :870 by `_dw_bn_impl`), the two-pass
//   backward's dW (:966): t recomputed through the prologue when it is on,
//   e the MATERIALIZED dy_eff read as it is (kDwBn);
// * ::_dw2_q_kernel (#39, launched at :1779 by `_dw2_q_impl`), the dW of
//   `conv_bn_fused_q` under model.conv_act_store=int8 (kDwQ): e =
//   round(dy + ds1 + 2 * deq(y) * ds2) from the int8 y (deq in f32, not
//   rounded, :1713-1715), t from x as kDwFused stages it or, in the XQ
//   mode, t = round(relu(deq(xq) * a + b)) from the int8 x, computed in
//   f32 and rounded once (:1690-1696). Bound by bytes as kDwFused, with y
//   (and x in the XQ mode) read as one byte an element.
// At baseline_2's 256^2 x 64 -> 64 (batch 8, f32, FMA) #31 does 38.7 GFLOP,
// 577 us at 67 TFLOP/s, against 268 MB read, 80 us.
//
// What bounds it on the H100: at the packed body's shapes, bytes on the
// tensor cores (512^2 x 32 -> 32 at batch 8: x, dy and y read once, 403 MB,
// 120 us at 3.35 TB/s, against 38.7 GFLOP, 39 us at 989 TFLOP/s);
// operations on the FMA units.
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

// The kernels: one instance of each body per KIND, named for the profile
// families (conv3x3_dw*: the packed body's; conv3x3_v3_dw*: the gen-3
// conv's).
#define CLTORCH_DW_PARAMS(T)                                                              \
  const T *__restrict__ x, const float *__restrict__ pa, const float *__restrict__ pb,   \
      const T *__restrict__ dy, const T *__restrict__ y, const float *__restrict__ s1,    \
      const float *__restrict__ s2, float *__restrict__ partials, int B, int H, int W,    \
      int Cin, int Cout, int prologue, const QArgs qa
#define CLTORCH_DW_ARGS x, pa, pb, dy, y, s1, s2, partials, B, H, W, Cin, Cout, prologue, qa

__global__ void __launch_bounds__(kDwThreads) conv3x3_dw_mma_kernel(CLTORCH_DW_PARAMS(bf16)) {
  dw_mma_body<kDwFused>(CLTORCH_DW_ARGS);
}
__global__ void __launch_bounds__(kDwThreads)
    conv3x3_v3_dw_mma_kernel(CLTORCH_DW_PARAMS(bf16)) {
  dw_mma_body<kDwPlain>(CLTORCH_DW_ARGS);
}
__global__ void __launch_bounds__(kDwThreads)
    conv3x3_v3_dw_bn_mma_kernel(CLTORCH_DW_PARAMS(bf16)) {
  dw_mma_body<kDwBn>(CLTORCH_DW_ARGS);
}
__global__ void __launch_bounds__(kDwThreads) conv3x3_q_dw_mma_kernel(CLTORCH_DW_PARAMS(bf16)) {
  dw_mma_body<kDwQ>(CLTORCH_DW_ARGS);
}
__global__ void __launch_bounds__(kDwfThreads) conv3x3_dw_fma_kernel(CLTORCH_DW_PARAMS(float)) {
  dw_fma_body<kDwFused>(CLTORCH_DW_ARGS);
}
__global__ void __launch_bounds__(kDwfThreads)
    conv3x3_v3_dw_fma_kernel(CLTORCH_DW_PARAMS(float)) {
  dw_fma_body<kDwPlain>(CLTORCH_DW_ARGS);
}
__global__ void __launch_bounds__(kDwfThreads)
    conv3x3_v3_dw_bn_fma_kernel(CLTORCH_DW_PARAMS(float)) {
  dw_fma_body<kDwBn>(CLTORCH_DW_ARGS);
}
__global__ void __launch_bounds__(kDwfThreads) conv3x3_q_dw_fma_kernel(CLTORCH_DW_PARAMS(float)) {
  dw_fma_body<kDwQ>(CLTORCH_DW_ARGS);
}

}  // namespace
}  // namespace cltorch

// Plain C interface, loaded with ctypes; returns cudaGetLastError(). The
// wrapper (cl_tpu_torch/kernels/conv3x3.py) checks the operands: x
// [B, H, W, Cin], dy and y [B, H, W, Cout], contiguous, 16-byte aligned, of
// one type; a, b f32 [Cin] (read only with `prologue`); s1, s2 f32 [Cout]
// or null (e = dy); `partials` holds splits * Cout * Cin * 9 floats; dw is
// f32 [Cout, Cin, 3, 3].
namespace cltorch {
namespace {

// Launches the dW kernel of the type and KIND, then the fixed-order sum of
// its partials.
template <int KIND>
int dw_launch(const void* x, const void* a, const void* b, const void* dy, const void* y,
              const void* s1, const void* s2, void* partials, void* dw, int B, int H, int W,
              int Cin, int Cout, int prologue, int splits, int is_bf16, cudaStream_t st,
              QArgs qa = QArgs{}) {
  const dim3 grid((Cin + kDwC - 1) / kDwC, (Cout + kDwC - 1) / kDwC, splits);
  const float *fa = static_cast<const float*>(a), *fb = static_cast<const float*>(b);
  const float *f1 = static_cast<const float*>(s1), *f2 = static_cast<const float*>(s2);
  float* part = static_cast<float*>(partials);
  if (is_bf16) {
    const bf16 *xb = static_cast<const bf16*>(x), *dyb = static_cast<const bf16*>(dy),
               *yb = static_cast<const bf16*>(y);
    auto kernel = KIND == kDwFused   ? conv3x3_dw_mma_kernel
                  : KIND == kDwPlain ? conv3x3_v3_dw_mma_kernel
                  : KIND == kDwBn    ? conv3x3_v3_dw_bn_mma_kernel
                                     : conv3x3_q_dw_mma_kernel;
    kernel<<<grid, kDwThreads, 0, st>>>(xb, fa, fb, dyb, yb, f1, f2, part, B, H, W, Cin, Cout,
                                        prologue, qa);
  } else {
    const float *xf = static_cast<const float*>(x), *dyf = static_cast<const float*>(dy),
                *yf = static_cast<const float*>(y);
    auto kernel = KIND == kDwFused   ? conv3x3_dw_fma_kernel
                  : KIND == kDwPlain ? conv3x3_v3_dw_fma_kernel
                  : KIND == kDwBn    ? conv3x3_v3_dw_bn_fma_kernel
                                     : conv3x3_q_dw_fma_kernel;
    kernel<<<grid, kDwfThreads, 0, st>>>(xf, fa, fb, dyf, yf, f1, f2, part, B, H, W, Cin, Cout,
                                         prologue, qa);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)Cout * Cin * 9;
  sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, splits, n,
                                                                  static_cast<float*>(dw));
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cltorch

extern "C" {

int cltorch_conv3x3_bn_dw(const void* x, const void* a, const void* b, const void* dy,
                          const void* y, const void* s1, const void* s2, void* partials,
                          void* dw, int B, int H, int W, int Cin, int Cout, int prologue,
                          int splits, int is_bf16, void* stream) {
  return cltorch::dw_launch<cltorch::kDwFused>(x, a, b, dy, y, s1, s2, partials, dw, B, H, W,
                                               Cin, Cout, prologue, splits, is_bf16,
                                               static_cast<cudaStream_t>(stream));
}

// The plain gen-3 conv's dW: x [B, H, W, Cin], dy [B, H, W, Cout].
int cltorch_conv3x3_dw(const void* x, const void* dy, void* partials, void* dw, int B, int H,
                       int W, int Cin, int Cout, int splits, int is_bf16, void* stream) {
  return cltorch::dw_launch<cltorch::kDwPlain>(x, nullptr, nullptr, dy, nullptr, nullptr,
                                               nullptr, partials, dw, B, H, W, Cin, Cout, 0,
                                               splits, is_bf16,
                                               static_cast<cudaStream_t>(stream));
}

// #39: the dW from int8 saved activations: y as yq [B, H, W, Cout] with
// scales ysc [B, H, pack, Cout]; x [B, H, W, Cin] or, when xq is given,
// xq [B, H, W, Cin] with scales xsc [B, H, pack, Cin] (x then unread).
int cltorch_conv3x3_bn_dw_q(const void* x, const void* xq, const void* xsc, const void* a,
                            const void* b, const void* dy, const void* yq, const void* ysc,
                            const void* s1, const void* s2, void* partials, void* dw, int B,
                            int H, int W, int Cin, int Cout, int prologue, int pack, int splits,
                            int is_bf16, void* stream) {
  const cltorch::QArgs qa{static_cast<const int8_t*>(yq), static_cast<const float*>(ysc),
                          static_cast<const int8_t*>(xq), static_cast<const float*>(xsc), pack};
  return cltorch::dw_launch<cltorch::kDwQ>(x, a, b, dy, nullptr, s1, s2, partials, dw, B, H, W,
                                           Cin, Cout, prologue, splits, is_bf16,
                                           static_cast<cudaStream_t>(stream), qa);
}

// The two-pass backward's dW: x [B, H, W, Cin] through the prologue (a, b
// f32 [Cin], read only with `prologue`), e [B, H, W, Cout] materialized.
int cltorch_conv3x3_dw_bn(const void* x, const void* a, const void* b, const void* e,
                          void* partials, void* dw, int B, int H, int W, int Cin, int Cout,
                          int prologue, int splits, int is_bf16, void* stream) {
  return cltorch::dw_launch<cltorch::kDwBn>(x, a, b, e, nullptr, nullptr, nullptr, partials, dw,
                                            B, H, W, Cin, Cout, prologue, splits, is_bf16,
                                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
