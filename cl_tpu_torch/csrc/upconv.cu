// k=2 / stride-2 transposed conv + bias over NHWC, forward.
//
// Replaces the TPU kernel cl_tpu/pallas/upconv_pack.py::_fwd_kernel
// (launched at upconv_pack.py:150 by `upconv2x2_packed`). With no kernel
// overlap every output pixel is one tap:
//
//   out[b, 2h+a, 2w+c, o] = round( sum_ci x[b,h,w,ci] * K[ci, o, a, c] + bias[o] )
//
// with K in torch's ConvTranspose2d layout [Cin, Cout, 2, 2] (the JAX
// package's flipped flax kernel, cl_tpu/models/unet.py:583-585), the
// product accumulated in f32, the f32 bias added, and one rounding to x's
// type (upconv_pack.py:88-94). The wrapper passes K rounded to x's type as
// the matrix Kg[ci, (a*2 + c)*Cout + o] ([Cin, 4*Cout]) for f32 and as its
// transpose ([4*Cout, Cin]) for bf16.
//
// What bounds it on the H100: bytes, at the packed body's shapes (e.g.
// 256^2 x 64 -> 512^2 x 32 at batch 8: 67 MB in, 134 MB out, ~60 us at
// 3.35 TB/s, against 8.6 GFLOP, ~9 us at the bf16 tensor cores' 989
// TFLOP/s; on the f32 FMA units the operations bound it, ~130 us).
//
// Design: the per-pixel product is one GEMM [B*H*W, Cin] x [Cin, 4*Cout]
// in the kernel's own body. The epilogue scatters each column to its
// (a, c) output phase.
// * bf16: mma.sync m16n8k16 with f32 accumulation. A block of 256 threads
//   (8 warps, 4 along the pixels x 2 along the columns) computes a
//   128-pixel x 64-column tile from 32-deep slices of x [pixel][k] and of
//   Kg^T [column][k] staged in shared memory with a 40-element row, so the
//   32-bit fragment loads of a warp hit 32 distinct banks.
// * f32: FMA (TF32 would round). A block of 256 threads computes a
//   64-pixel x 64-column tile from 16-deep slices of x (transposed) and Kg
//   staged as f32; each thread keeps a 4 x 4 register tile whose four
//   columns are four consecutive output channels of one pixel.

#include "common.cuh"

namespace cltorch {
namespace {

constexpr int kUpBM = 64, kUpBN = 64, kUpBK = 16, kUpThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kUpThreads)
upconv_kernel(const T* __restrict__ x, const T* __restrict__ kg, const float* __restrict__ bias,
              T* __restrict__ out, int B, int H, int W, int Cin, int Cout) {
  __shared__ __align__(16) float xs[kUpBK][kUpBM];
  __shared__ __align__(16) float ws[kUpBK][kUpBN];
  const int64_t M = (int64_t)B * H * W;
  const int N = 4 * Cout;
  const int64_t m0 = (int64_t)blockIdx.x * kUpBM;
  const int n0 = blockIdx.y * kUpBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Cin; k0 += kUpBK) {
    __syncthreads();
    for (int e = threadIdx.x; e < kUpBK * kUpBM; e += kUpThreads) {
      const int kk = e % kUpBK, mm = e / kUpBK;
      const int64_t m = m0 + mm;
      const int k = k0 + kk;
      xs[kk][mm] = (m < M && k < Cin) ? to_f32(x[m * Cin + k]) : 0.f;
    }
    for (int e = threadIdx.x; e < kUpBK * kUpBN; e += kUpThreads) {
      const int nn = e % kUpBN, kk = e / kUpBN;
      const int n = n0 + nn, k = k0 + kk;
      ws[kk][nn] = (n < N && k < Cin) ? to_f32(kg[(int64_t)k * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kUpBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty * 4 + i;
    if (m >= M) continue;
    const int w_ = (int)(m % W);
    const int64_t bh = m / W;
    const int h = (int)(bh % H);
    const int64_t b = bh / H;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      const int q = n / Cout, o = n - q * Cout;
      const int a = q >> 1, c = q & 1;
      const int64_t dst = ((b * 2 * H + 2 * h + a) * (int64_t)(2 * W) + 2 * w_ + c) * Cout + o;
      out[dst] = from_f32<T>(acc[i][j] + bias[o]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kMBM = 128, kMBN = 64, kMBK = 32, kMRow = 40;

// Row r of a [rows, K] bf16 matrix, elements [k, k + 8), zero past the
// matrix, into shared memory.
__device__ __forceinline__ void stage8(bf16* dst, const bf16* src, int64_t r, int64_t rows, int k,
                                       int K) {
  alignas(16) bf16 v[8];
  if (r < rows && (K & 7) == 0 && k < K) {
    load16<bf16>(v, src + r * K + k, 0);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = (r < rows && k + j < K) ? src[r * K + k + j] : __float2bfloat16(0.f);
  }
  store16<bf16>(dst, 0, v);
}

__global__ void __launch_bounds__(kUpThreads)
upconv_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ kgt,
                  const float* __restrict__ bias, bf16* __restrict__ out, int B, int H, int W,
                  int Cin, int Cout) {
  __shared__ __align__(16) bf16 xs[kMBM * kMRow];
  __shared__ __align__(16) bf16 ws[kMBN * kMRow];
  const int64_t M = (int64_t)B * H * W;
  const int N = 4 * Cout;
  const int64_t m0 = (int64_t)blockIdx.x * kMBM;
  const int n0 = blockIdx.y * kMBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;  // warp tile origin
  const int g = lane >> 2, t = lane & 3;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < Cin; k0 += kMBK) {
    __syncthreads();
    for (int e = threadIdx.x; e < kMBM * 4; e += kUpThreads) {
      const int r = e >> 2, q = (e & 3) * 8;
      stage8(&xs[r * kMRow + q], x, m0 + r, M, k0 + q, Cin);
    }
    for (int e = threadIdx.x; e < kMBN * 4; e += kUpThreads) {
      const int r = e >> 2, q = (e & 3) * 8;
      stage8(&ws[r * kMRow + q], kgt, n0 + r, N, k0 + q, Cin);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kMBK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t* r0 =
            reinterpret_cast<const uint32_t*>(&xs[(wm + i * 16 + g) * kMRow + kk]);
        const uint32_t* r1 =
            reinterpret_cast<const uint32_t*>(&xs[(wm + i * 16 + g + 8) * kMRow + kk]);
        a[i][0] = r0[t];
        a[i][1] = r1[t];
        a[i][2] = r0[t + 4];
        a[i][3] = r1[t + 4];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t* wr =
            reinterpret_cast<const uint32_t*>(&ws[(wn + j * 8 + g) * kMRow + kk]);
        const uint32_t b0 = wr[t], b1 = wr[t + 4];
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
      }
    }
  }

  // Thread (g, t) holds rows g and g + 8 of each m16 tile, columns 2t and
  // 2t + 1 of each n8 tile: two consecutive output channels of one phase.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int64_t m = m0 + wm + i * 16 + g + hr * 8;
      if (m >= M) continue;
      const int w_ = (int)(m % W);
      const int64_t bh = m / W;
      const int h = (int)(bh % H);
      const int64_t b = bh / H;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + j * 8 + 2 * t;
        if ((Cout & 1) == 0 && n + 1 < N) {  // n even: both in one phase
          const int q = n / Cout, o = n - q * Cout;
          const int64_t dst =
              ((b * 2 * H + 2 * h + (q >> 1)) * (int64_t)(2 * W) + 2 * w_ + (q & 1)) * Cout + o;
          *reinterpret_cast<__nv_bfloat162*>(out + dst) =
              __floats2bfloat162_rn(acc[i][j][hr * 2] + bias[o], acc[i][j][hr * 2 + 1] + bias[o + 1]);
          continue;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (n + e >= N) continue;
          const int q = (n + e) / Cout, o = n + e - q * Cout;
          const int64_t dst =
              ((b * 2 * H + 2 * h + (q >> 1)) * (int64_t)(2 * W) + 2 * w_ + (q & 1)) * Cout + o;
          out[dst] = __float2bfloat16(acc[i][j][hr * 2 + e] + bias[o]);
        }
      }
    }
}

int upconv_mma_launch(const void* x, const void* kgt, const void* bias, void* out, int B, int H,
                      int W, int Cin, int Cout, cudaStream_t st) {
  const int64_t M = (int64_t)B * H * W;
  dim3 grid((unsigned)((M + kMBM - 1) / kMBM), (unsigned)((4 * Cout + kMBN - 1) / kMBN));
  upconv_mma_kernel<<<grid, kUpThreads, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(kgt), static_cast<const float*>(bias),
      static_cast<bf16*>(out), B, H, W, Cin, Cout);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: FMA
// ---------------------------------------------------------------------------

template <typename T>
int upconv_launch(const void* x, const void* kg, const void* bias, void* out, int B, int H, int W,
                  int Cin, int Cout, cudaStream_t st) {
  const int64_t M = (int64_t)B * H * W;
  dim3 grid((unsigned)((M + kUpBM - 1) / kUpBM), (unsigned)((4 * Cout + kUpBN - 1) / kUpBN));
  upconv_kernel<T><<<grid, kUpThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(kg), static_cast<const float*>(bias),
      static_cast<T*>(out), B, H, W, Cin, Cout);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cltorch

// Plain C interface, loaded with ctypes; returns cudaGetLastError(). The
// wrapper (cl_tpu_torch/kernels/upconv_pack.py) checks: contiguous,
// 16-byte-aligned NHWC x; Kg contiguous of x's type ([4*Cout, Cin] for
// bf16, [Cin, 4*Cout] for f32); f32 bias [Cout].
extern "C" {

int cltorch_upconv_fwd(const void* x, const void* kg, const void* bias, void* out, int B, int H,
                       int W, int Cin, int Cout, int is_bf16, void* stream) {
  using namespace cltorch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? upconv_mma_launch(x, kg, bias, out, B, H, W, Cin, Cout, st)
                 : upconv_launch<float>(x, kg, bias, out, B, H, W, Cin, Cout, st);
}

}  // extern "C"
