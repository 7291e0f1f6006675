// k=2 / stride-2 transposed conv + bias over NHWC: forward, dx, dW and db.
//
// Replaces the TPU kernels of cl_tpu/pallas/upconv_pack.py: ::_fwd_kernel
// (launched at upconv_pack.py:150 by `upconv2x2_packed`), ::_dx_kernel
// (:183) and ::_dw_kernel (:201, dW and db), the last two from its VJP
// `_vjp_bwd`. With no kernel overlap every output pixel is one tap:
//
//   out[b, 2h+a, 2w+c, o] = round( sum_ci x[b,h,w,ci] * K[ci, o, a, c] + bias[o] )
//
// with K in torch's ConvTranspose2d layout [Cin, Cout, 2, 2] (the JAX
// package's flipped flax kernel, cl_tpu/models/unet.py:583-585), the
// product accumulated in f32, the f32 bias added, and one rounding to x's
// type (upconv_pack.py:88-94). Written as matrices, with the pixel rows
// m = (b, h, w), the columns n = (a*2 + c)*Cout + o, Kg[ci, n] = K rounded
// to x's type ([Cin, 4*Cout]) and DY[m, n] = dy[b, 2h+a, 2w+c, o]:
//
//   forward  Y  = X Kg + bias        (scattered to the (a, c) phases)
//   dx       DX = round(DY Kg^T)     [M, 4*Cout] x [4*Cout, Cin]
//   dW       DW = X^T DY             [Cin, M] x [M, 4*Cout], f32
//   db       db[o] = sum over m and the 4 phases of DY[m, (a,c), o], f32
//
// The wrapper rounds dW to x's type once (the JAX package rounds each p_in
// block and sums them in bf16, upconv_pack.py:219; a few bf16 ulps apart)
// and keeps db in f32 (the TPU kernel sums each tile in bf16, :132).
//
// What bounds it on the H100: bytes, at the packed body's shapes (e.g.
// 256^2 x 64 -> 512^2 x 32 at batch 8: 67 MB in, 134 MB out, ~60 us at
// 3.35 TB/s, against 8.6 GFLOP, ~9 us at the bf16 tensor cores' 989
// TFLOP/s; on the f32 FMA units the operations bound it, ~130 us). dx and
// dW each read dy (134 MB there) and x or write dx.
//
// Design: one GEMM main loop per route, fed by staging functors that know
// each operand's layout (row-major, the dy gather, or a transposed view),
// and one epilogue per function. The bf16 route stages a transposed view
// (dW's X^T and DY^T) k-major: a thread reads eight consecutive channels
// of one pixel in one 16-byte load and writes them down a column of the
// shared tile.
// * bf16: mma.sync m16n8k16 with f32 accumulation. A block of 256 threads
//   (8 warps, 4 along the rows x 2 along the columns) computes a
//   128-row x 64-column tile from 32-deep slices of A [row][k] and of
//   B^T [column][k] staged in shared memory with a 40-element row, so the
//   32-bit fragment loads of a warp hit 32 distinct banks.
// * f32: FMA (TF32 would round). A block of 256 threads computes a
//   64-row x 64-column tile from 16-deep slices of A (transposed) and B
//   staged as f32; each thread keeps a 4 x 4 register tile.
// * dW splits the pixels (its k) over gridDim.z blocks, each taking every
//   gridDim.z-th slice; each writes its own partial [Cin, 4*Cout] (and, in
//   the blocks of the first row tile, its column sums of DY for db), and a
//   second launch sums the partials in a fixed order. No float atomics.

#include "common.cuh"

namespace cltorch {
namespace {

using bf16 = __nv_bfloat16;
constexpr int kUpThreads = 256;
constexpr int kMBM = 128, kMBN = 64, kMBK = 32, kMRow = 40;  // bf16 tiles

// Pixel row m = (b, h, w) of the input grid -> offset of output pixel
// (2h, 2w); phase q = a*2 + c is output pixel (2h+a, 2w+c), `phase(q, W)`
// further. An epilogue decomposes m once per row, not once per column.
__device__ __forceinline__ int64_t out_base(int64_t m, int H, int W) {
  const int w_ = (int)(m % W);
  const int64_t bh = m / W;
  const int h = (int)(bh % H);
  const int64_t b = bh / H;
  return (b * 2 * H + 2 * h) * (int64_t)(2 * W) + 2 * w_;
}

__device__ __forceinline__ int64_t phase(int q, int W) {
  return (q >> 1) * (int64_t)(2 * W) + (q & 1);
}

// ---------------------------------------------------------------------------
// Operand views: element (r, k) of a matrix (f32 route), and the bf16
// route's slice s[r * kMRow + kk] = (row0 + r, k0 + kk) for r < nrows,
// kk < kMBK, staged by the block (zero past the matrix)
// ---------------------------------------------------------------------------

// Row-major staging from a view's 8-along-k loads.
template <class View>
__device__ __forceinline__ void stage_rows(const View& v, bf16* s, int64_t row0, int64_t k0,
                                           int nrows) {
  for (int e = threadIdx.x; e < nrows * (kMBK / 8); e += kUpThreads) {
    const int r = e / (kMBK / 8), q = (e % (kMBK / 8)) * 8;
    v.stage8(&s[r * kMRow + q], row0 + r, k0 + q);
  }
}

// k-major staging: `load8(v, r, k)` fills the 8 rows [r, r + 8) of column k.
template <class Load8>
__device__ __forceinline__ void stage_cols(bf16* s, int64_t row0, int64_t k0, int nrows,
                                           const Load8& load8) {
  for (int e = threadIdx.x; e < kMBK * (nrows / 8); e += kUpThreads) {
    const int kk = e / (nrows / 8), r = (e % (nrows / 8)) * 8;
    alignas(16) bf16 v[8];
    load8(v, row0 + r, k0 + kk);
#pragma unroll
    for (int j = 0; j < 8; ++j) s[(r + j) * kMRow + kk] = v[j];
  }
}

// Row-major [rows, K].
template <typename T> struct RowMajor {
  const T* p;
  int64_t rows;
  int64_t K;
  __device__ float at(int64_t r, int64_t k) const {
    return (r < rows && k < K) ? to_f32(p[r * K + k]) : 0.f;
  }
  __device__ void stage8(bf16* dst, int64_t r, int64_t k) const {
    alignas(16) bf16 v[8];
    if (r < rows && (K & 7) == 0 && k < K) {
      load16<bf16>(v, reinterpret_cast<const bf16*>(p) + r * K + k, 0);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = __float2bfloat16(at(r, k + j));
    }
    store16<bf16>(dst, 0, v);
  }
  __device__ void stage_tile(bf16* s, int64_t row0, int64_t k0, int nrows) const {
    stage_rows(*this, s, row0, k0, nrows);
  }
};

// Column-major [rows, K]: element (r, k) at p[k * rows + r] (x^T for dW).
template <typename T> struct ColMajor {
  const T* p;
  int64_t rows;
  int64_t K;
  __device__ float at(int64_t r, int64_t k) const {
    return (r < rows && k < K) ? to_f32(p[k * rows + r]) : 0.f;
  }
  __device__ void stage_tile(bf16* s, int64_t row0, int64_t k0, int nrows) const {
    stage_cols(s, row0, k0, nrows, [&](bf16 (&v)[8], int64_t r, int64_t k) {
      if (k < K && r + 8 <= rows && (rows & 7) == 0) {
        load16<bf16>(v, reinterpret_cast<const bf16*>(p) + k * rows + r, 0);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = __float2bfloat16(at(r + j, k));
      }
    });
  }
};

// DY [M, 4*Cout] gathered from dy [B, 2H, 2W, Cout]; `transposed` views it
// as [4*Cout, M] (the B operand of dW).
template <typename T> struct DyGather {
  const T* dy;
  int64_t M;
  int H, W, Cout;
  bool transposed;
  __device__ float at(int64_t r, int64_t k) const {
    const int64_t m = transposed ? k : r;
    const int64_t n = transposed ? r : k;
    if (m >= M || n >= 4 * Cout) return 0.f;
    const int q = (int)(n / Cout), o = (int)(n - (int64_t)q * Cout);
    return to_f32(dy[(out_base(m, H, W) + phase(q, W)) * Cout + o]);
  }
  // Eight columns [n, n + 8) of DY at pixel m (one phase when Cout % 8 == 0).
  __device__ void load8(bf16 (&v)[8], int64_t m, int64_t n) const {
    if (m < M && (Cout & 7) == 0 && n < 4 * Cout) {
      const int q = (int)(n / Cout), o = (int)(n - (int64_t)q * Cout);
      load16<bf16>(v, reinterpret_cast<const bf16*>(dy) + (out_base(m, H, W) + phase(q, W)) * Cout
                          + o, 0);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = __float2bfloat16(transposed ? at(n + j, m) : at(m, n + j));
    }
  }
  __device__ void stage8(bf16* dst, int64_t r, int64_t k) const {
    alignas(16) bf16 v[8];
    load8(v, r, k);
    store16<bf16>(dst, 0, v);
  }
  __device__ void stage_tile(bf16* s, int64_t row0, int64_t k0, int nrows) const {
    if (!transposed)
      stage_rows(*this, s, row0, k0, nrows);
    else
      stage_cols(s, row0, k0, nrows,
                 [&](bf16 (&v)[8], int64_t n, int64_t m) { load8(v, m, n); });
  }
};

struct NoHook {
  template <typename S> __device__ void operator()(const S*) const {}
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// acc += A[m0 : m0+128, k] B[k, n0 : n0+64] over k = k_begin, k_begin +
// k_step, ... (32-deep slices) below K; `a` views A, `b` views B^T. `hook`
// sees each staged B^T slice (ws) after the block has synchronised.
template <class SA, class SB, class Hook>
__device__ void mma_mainloop(float (&acc)[2][4][4], bf16* xs, bf16* ws, int64_t m0, int64_t n0,
                             int64_t k_begin, int64_t k_step, int64_t K, const SA& a,
                             const SB& b, const Hook& hook) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;  // warp tile origin
  const int g = lane >> 2, t = lane & 3;
  for (int64_t k0 = k_begin; k0 < K; k0 += k_step) {
    __syncthreads();
    a.stage_tile(xs, m0, k0, kMBM);
    b.stage_tile(ws, n0, k0, kMBN);
    __syncthreads();
    hook(ws);
#pragma unroll
    for (int kk = 0; kk < kMBK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t* r0 =
            reinterpret_cast<const uint32_t*>(&xs[(wm + i * 16 + g) * kMRow + kk]);
        const uint32_t* r1 =
            reinterpret_cast<const uint32_t*>(&xs[(wm + i * 16 + g + 8) * kMRow + kk]);
        af[i][0] = r0[t];
        af[i][1] = r1[t];
        af[i][2] = r0[t + 4];
        af[i][3] = r1[t + 4];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t* wr =
            reinterpret_cast<const uint32_t*>(&ws[(wn + j * 8 + g) * kMRow + kk]);
        const uint32_t b0 = wr[t], b1 = wr[t + 4];
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_bf16(acc[i][j], af[i], b0, b1);
      }
    }
  }
}

// Thread (g, t) of warp w holds, for i, j, hr, e in {0,1}x{0..3}x{0,1}x{0,1},
// acc[i][j][hr*2+e] = D[m0 + wm + i*16 + g + hr*8][n0 + wn + j*8 + 2t + e].
#define MMA_TILE_INIT                                                \
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;        \
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;             \
  const int g = lane >> 2, t = lane & 3;                             \
  __shared__ __align__(16) bf16 xs[kMBM * kMRow];                    \
  __shared__ __align__(16) bf16 ws[kMBN * kMRow];                    \
  float acc[2][4][4];                                                \
  for (int i = 0; i < 2; ++i)                                        \
    for (int j = 0; j < 4; ++j)                                      \
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

__global__ void __launch_bounds__(kUpThreads)
upconv_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ kgt,
                  const float* __restrict__ bias, bf16* __restrict__ out, int B, int H, int W,
                  int Cin, int Cout) {
  MMA_TILE_INIT
  const int64_t M = (int64_t)B * H * W;
  const int N = 4 * Cout;
  const int64_t m0 = (int64_t)blockIdx.x * kMBM;
  const int n0 = blockIdx.y * kMBN;
  mma_mainloop(acc, xs, ws, m0, n0, 0, kMBK, Cin, RowMajor<bf16>{x, M, Cin},
               RowMajor<bf16>{kgt, N, Cin}, NoHook{});
  // Columns 2t and 2t + 1 of an n8 tile: two consecutive output channels
  // of one phase.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int64_t m = m0 + wm + i * 16 + g + hr * 8;
      if (m >= M) continue;
      const int64_t base = out_base(m, H, W);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + j * 8 + 2 * t;
        if ((Cout & 1) == 0 && n + 1 < N) {  // n even: both in one phase
          const int q = n / Cout, o = n - q * Cout;
          *reinterpret_cast<__nv_bfloat162*>(out + (base + phase(q, W)) * Cout + o) =
              __floats2bfloat162_rn(acc[i][j][hr * 2] + bias[o], acc[i][j][hr * 2 + 1] + bias[o + 1]);
          continue;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (n + e >= N) continue;
          const int q = (n + e) / Cout, o = n + e - q * Cout;
          out[(base + phase(q, W)) * Cout + o] = __float2bfloat16(acc[i][j][hr * 2 + e] + bias[o]);
        }
      }
    }
}

__global__ void __launch_bounds__(kUpThreads)
upconv_dx_mma_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ kg,
                     bf16* __restrict__ dx, int B, int H, int W, int Cin, int Cout) {
  MMA_TILE_INIT
  const int64_t M = (int64_t)B * H * W;
  const int64_t m0 = (int64_t)blockIdx.x * kMBM;
  const int n0 = blockIdx.y * kMBN;
  mma_mainloop(acc, xs, ws, m0, n0, 0, kMBK, 4 * Cout, DyGather<bf16>{dy, M, H, W, Cout, false},
               RowMajor<bf16>{kg, Cin, 4 * Cout}, NoHook{});
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int64_t m = m0 + wm + i * 16 + g + hr * 8;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + j * 8 + 2 * t;
        if ((Cin & 1) == 0 && n + 1 < Cin) {
          *reinterpret_cast<__nv_bfloat162*>(dx + m * Cin + n) =
              __floats2bfloat162_rn(acc[i][j][hr * 2], acc[i][j][hr * 2 + 1]);
          continue;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (n + e < Cin) dx[m * Cin + n + e] = __float2bfloat16(acc[i][j][hr * 2 + e]);
      }
    }
}

// Column sums of the staged DY^T slice ([column][pixel], kMBK pixels) into
// one register per thread of the first kMBN threads; the first row tile's
// blocks only.
struct DbHook {
  float* sum;
  bool on;
  __device__ void operator()(const bf16* ws) const {
    if (!on || threadIdx.x >= kMBN) return;
    float s = 0.f;
#pragma unroll 8
    for (int k = 0; k < kMBK; ++k) s += __bfloat162float(ws[threadIdx.x * kMRow + k]);
    *sum += s;
  }
};

__global__ void __launch_bounds__(kUpThreads)
upconv_dw_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                     float* __restrict__ part_w, float* __restrict__ part_b, int B, int H,
                     int W, int Cin, int Cout) {
  MMA_TILE_INIT
  const int64_t M = (int64_t)B * H * W;
  const int N = 4 * Cout;
  const int64_t m0 = (int64_t)blockIdx.x * kMBM;
  const int n0 = blockIdx.y * kMBN;
  const int s = blockIdx.z, S = gridDim.z;
  float db = 0.f;
  mma_mainloop(acc, xs, ws, m0, n0, (int64_t)s * kMBK, (int64_t)S * kMBK, M,
               ColMajor<bf16>{x, Cin, M}, DyGather<bf16>{dy, M, H, W, Cout, true},
               DbHook{&db, blockIdx.x == 0});
  float* pw = part_w + (int64_t)s * Cin * N;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int64_t m = m0 + wm + i * 16 + g + hr * 8;
      if (m >= Cin) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + j * 8 + 2 * t + e;
          if (n < N) pw[m * N + n] = acc[i][j][hr * 2 + e];
        }
    }
  if (blockIdx.x == 0 && threadIdx.x < kMBN && n0 + threadIdx.x < N)
    part_b[(int64_t)s * N + n0 + threadIdx.x] = db;
}

// ---------------------------------------------------------------------------
// f32: FMA
// ---------------------------------------------------------------------------

constexpr int kUpBM = 64, kUpBN = 64, kUpBK = 16;

// acc += A[m0 + ty*4 + i, k] B[k, n0 + tx*4 + j] over the 16-deep slices
// k_begin, k_begin + k_step, ... below K; `a` views A, `b` views B^T.
template <class VA, class VB, class Hook>
__device__ void fma_mainloop(float (&acc)[4][4], float (*xs)[kUpBM], float (*ws)[kUpBN],
                             int64_t m0, int64_t n0, int64_t k_begin, int64_t k_step, int64_t K,
                             const VA& a, const VB& b, const Hook& hook) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int64_t k0 = k_begin; k0 < K; k0 += k_step) {
    __syncthreads();
    for (int e = threadIdx.x; e < kUpBK * kUpBM; e += kUpThreads) {
      const int kk = e % kUpBK, mm = e / kUpBK;
      xs[kk][mm] = a.at(m0 + mm, k0 + kk);
    }
    for (int e = threadIdx.x; e < kUpBK * kUpBN; e += kUpThreads) {
      const int nn = e % kUpBN, kk = e / kUpBN;
      ws[kk][nn] = b.at(n0 + nn, k0 + kk);
    }
    __syncthreads();
    hook(&ws[0][0]);
#pragma unroll
    for (int kk = 0; kk < kUpBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w}, br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }
}

// Column sums of the staged DY slice (ws[k][column]) for db.
struct FmaDbHook {
  float* sum;
  bool on;
  __device__ void operator()(const float* ws) const {
    if (!on || threadIdx.x >= kUpBN) return;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kUpBK; ++k) s += ws[k * kUpBN + threadIdx.x];
    *sum += s;
  }
};

struct NoHookF {
  __device__ void operator()(const float*) const {}
};

#define FMA_TILE_INIT                                          \
  __shared__ __align__(16) float xs[kUpBK][kUpBM];             \
  __shared__ __align__(16) float ws[kUpBK][kUpBN];             \
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;      \
  float acc[4][4];                                             \
  for (int i = 0; i < 4; ++i)                                  \
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

template <typename T>
__global__ void __launch_bounds__(kUpThreads)
upconv_kernel(const T* __restrict__ x, const T* __restrict__ kg, const float* __restrict__ bias,
              T* __restrict__ out, int B, int H, int W, int Cin, int Cout) {
  FMA_TILE_INIT
  const int64_t M = (int64_t)B * H * W;
  const int N = 4 * Cout;
  const int64_t m0 = (int64_t)blockIdx.x * kUpBM;
  const int n0 = blockIdx.y * kUpBN;
  // B = Kg [Cin, N]: its transpose is column-major [N, Cin]
  fma_mainloop(acc, xs, ws, m0, n0, 0, kUpBK, Cin, RowMajor<T>{x, M, Cin},
               ColMajor<T>{kg, N, Cin}, NoHookF{});
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty * 4 + i;
    if (m >= M) continue;
    const int64_t base = out_base(m, H, W);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      const int q = n / Cout, o = n - q * Cout;
      out[(base + phase(q, W)) * Cout + o] = from_f32<T>(acc[i][j] + bias[o]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kUpThreads)
upconv_dx_kernel(const T* __restrict__ dy, const T* __restrict__ kg, T* __restrict__ dx, int B,
                 int H, int W, int Cin, int Cout) {
  FMA_TILE_INIT
  const int64_t M = (int64_t)B * H * W;
  const int64_t m0 = (int64_t)blockIdx.x * kUpBM;
  const int n0 = blockIdx.y * kUpBN;
  fma_mainloop(acc, xs, ws, m0, n0, 0, kUpBK, 4 * Cout, DyGather<T>{dy, M, H, W, Cout, false},
               RowMajor<T>{kg, Cin, 4 * Cout}, NoHookF{});
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < Cin) dx[m * Cin + n] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kUpThreads)
upconv_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ part_w,
                 float* __restrict__ part_b, int B, int H, int W, int Cin, int Cout) {
  FMA_TILE_INIT
  const int64_t M = (int64_t)B * H * W;
  const int N = 4 * Cout;
  const int64_t m0 = (int64_t)blockIdx.x * kUpBM;
  const int n0 = blockIdx.y * kUpBN;
  const int s = blockIdx.z, S = gridDim.z;
  float db = 0.f;
  fma_mainloop(acc, xs, ws, m0, n0, (int64_t)s * kUpBK, (int64_t)S * kUpBK, M,
               ColMajor<T>{x, Cin, M}, DyGather<T>{dy, M, H, W, Cout, true},
               FmaDbHook{&db, blockIdx.x == 0});
  float* pw = part_w + (int64_t)s * Cin * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty * 4 + i;
    if (m >= Cin) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) pw[m * N + n] = acc[i][j];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < kUpBN && n0 + threadIdx.x < N)
    part_b[(int64_t)s * N + n0 + threadIdx.x] = db;
}

// ---------------------------------------------------------------------------
// Fixed-order sums of the dW / db partials
// ---------------------------------------------------------------------------

// dw[j] = sum over s of part_w[s][j]; db[o] = sum over s, then over the 4
// phases q, of part_b[s][q*Cout + o]. One thread per output, each summing
// in a fixed order.
__global__ void upconv_dw_reduce_kernel(const float* __restrict__ part_w,
                                        const float* __restrict__ part_b, int S, int64_t nw,
                                        int Cout, float* __restrict__ dw, float* __restrict__ db) {
  const int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (j < nw) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += part_w[(int64_t)s * nw + j];
    dw[j] = acc;
  }
  if (j < Cout) {
    float acc = 0.f;
    for (int q = 0; q < 4; ++q) {
      float aq = 0.f;
      for (int s = 0; s < S; ++s) aq += part_b[(int64_t)s * 4 * Cout + q * Cout + j];
      acc += aq;
    }
    db[j] = acc;
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

inline dim3 tiles(int64_t rows, int64_t cols, int bm, int bn, int splits = 1) {
  return dim3((unsigned)((rows + bm - 1) / bm), (unsigned)((cols + bn - 1) / bn), splits);
}

int upconv_fwd_launch(const void* x, const void* kg, const void* bias, void* out, int B, int H,
                      int W, int Cin, int Cout, int is_bf16, cudaStream_t st) {
  const int64_t M = (int64_t)B * H * W;
  if (is_bf16)
    upconv_mma_kernel<<<tiles(M, 4 * Cout, kMBM, kMBN), kUpThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(kg),
        static_cast<const float*>(bias), static_cast<bf16*>(out), B, H, W, Cin, Cout);
  else
    upconv_kernel<float><<<tiles(M, 4 * Cout, kUpBM, kUpBN), kUpThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(kg),
        static_cast<const float*>(bias), static_cast<float*>(out), B, H, W, Cin, Cout);
  return (int)cudaGetLastError();
}

int upconv_dx_launch(const void* dy, const void* kg, void* dx, int B, int H, int W, int Cin,
                     int Cout, int is_bf16, cudaStream_t st) {
  const int64_t M = (int64_t)B * H * W;
  if (is_bf16)
    upconv_dx_mma_kernel<<<tiles(M, Cin, kMBM, kMBN), kUpThreads, 0, st>>>(
        static_cast<const bf16*>(dy), static_cast<const bf16*>(kg), static_cast<bf16*>(dx), B,
        H, W, Cin, Cout);
  else
    upconv_dx_kernel<float><<<tiles(M, Cin, kUpBM, kUpBN), kUpThreads, 0, st>>>(
        static_cast<const float*>(dy), static_cast<const float*>(kg), static_cast<float*>(dx),
        B, H, W, Cin, Cout);
  return (int)cudaGetLastError();
}

int upconv_dw_launch(const void* x, const void* dy, void* part_w, void* part_b, void* dw,
                     void* db, int B, int H, int W, int Cin, int Cout, int splits, int is_bf16,
                     cudaStream_t st) {
  if (is_bf16)
    upconv_dw_mma_kernel<<<tiles(Cin, 4 * Cout, kMBM, kMBN, splits), kUpThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(dy), static_cast<float*>(part_w),
        static_cast<float*>(part_b), B, H, W, Cin, Cout);
  else
    upconv_dw_kernel<float><<<tiles(Cin, 4 * Cout, kUpBM, kUpBN, splits), kUpThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), static_cast<float*>(part_w),
        static_cast<float*>(part_b), B, H, W, Cin, Cout);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t nw = (int64_t)Cin * 4 * Cout;
  upconv_dw_reduce_kernel<<<(unsigned)((nw + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part_w), static_cast<const float*>(part_b), splits, nw, Cout,
      static_cast<float*>(dw), static_cast<float*>(db));
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cltorch

// Plain C interface, loaded with ctypes; each returns cudaGetLastError().
// The wrapper (cl_tpu_torch/kernels/upconv_pack.py) checks the operands:
// contiguous, 16-byte-aligned NHWC x [B, H, W, Cin] and dy
// [B, 2H, 2W, Cout] of one type; the weight of that type, as Kg^T
// [4*Cout, Cin] for the bf16 forward and as Kg [Cin, 4*Cout] otherwise;
// f32 bias [Cout]. dW: `part_w` holds splits * Cin * 4*Cout floats,
// `part_b` splits * 4*Cout; dw [Cin, 4*Cout] and db [Cout] are f32.
extern "C" {

int cltorch_upconv_fwd(const void* x, const void* kg, const void* bias, void* out, int B, int H,
                       int W, int Cin, int Cout, int is_bf16, void* stream) {
  return cltorch::upconv_fwd_launch(x, kg, bias, out, B, H, W, Cin, Cout, is_bf16,
                                    static_cast<cudaStream_t>(stream));
}

int cltorch_upconv_dx(const void* dy, const void* kg, void* dx, int B, int H, int W, int Cin,
                      int Cout, int is_bf16, void* stream) {
  return cltorch::upconv_dx_launch(dy, kg, dx, B, H, W, Cin, Cout, is_bf16,
                                   static_cast<cudaStream_t>(stream));
}

int cltorch_upconv_dw(const void* x, const void* dy, void* part_w, void* part_b, void* dw,
                      void* db, int B, int H, int W, int Cin, int Cout, int splits, int is_bf16,
                      void* stream) {
  return cltorch::upconv_dw_launch(x, dy, part_w, part_b, dw, db, B, H, W, Cin, Cout, splits,
                                   is_bf16, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
