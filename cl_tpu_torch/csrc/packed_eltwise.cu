// The packed body's two elementwise passes and their backward.
//
// Replaces the TPU kernels of cl_tpu/pallas/packed_eltwise.py:
// ::_fwd_kernel (launched at packed_eltwise.py:93, `bn_relu_packed`),
// ::_bwd_kernel (:113, its VJP `_brp_bwd`), ::_add_stats_kernel (:202,
// `add_stats_packed`) and ::_dy_eff_kernel (:226, `dy_eff_packed`, the
// VJP of add_stats). The TPU kernels work on a lane-packed [N, p*C] view;
// here the tensors are NHWC [P, C] as they lie (the packed view is a
// reshape of the same memory), so the per-lane vectors are per-channel
// ones and the per-lane sums come out already folded to channels.
//
//   bn_relu:     z = relu(y * s[c] + b[c]) in f32, rounded once to y's type
//   bn_relu bwd: du = [y * s + b > 0] * dz (f32); dy = round(du * s),
//                with per-channel sums of du * y and du (:65-81)
//   add_stats:   z = round(a + b) computed in f32, with per-channel sums of
//                the ROUNDED z and z^2 (packed_eltwise.py:179-184)
//   dy_eff:      e = round(dz + ds1[c] + 2 * z * ds2[c]) in f32 (:191-194)
//
// Products and sums use __fmul_rn / __fadd_rn so nvcc does not contract
// them into an FMA: the plain PyTorch version rounds after each, and the
// kernels' z then equals it bit for bit (the sums differ only in order).
//
// What bounds them on the H100: bytes. Each reads its inputs once and
// writes its output once (512^2 x 32 bf16 x batch 8: 134 MB in, 134 MB out
// for bn_relu, ~80 us at 3.35 TB/s; 268 MB in for either backward); a
// handful of operations per element.
//
// Design: 16-byte vector loads and stores (8 bf16 or 4 f32 a thread). The
// kernels with sums (add_stats, bn_relu bwd) lay a block out as `rows`
// pixel rows of C/V channel vectors,
// so a thread keeps the same channels for the whole grid-stride walk and
// sums them in registers; the block's rows are combined in shared memory
// in a fixed order and each block writes one partial row [2, C], which a
// second launch sums over the blocks in a fixed order. No float atomics:
// a run repeats its sums bit for bit.

#include "common.cuh"

namespace cltorch {
namespace {

constexpr int kEwThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kEwThreads)
bn_relu_kernel(const T* __restrict__ y, const float* __restrict__ s, const float* __restrict__ b,
               T* __restrict__ z, int64_t nvec, int C) {
  constexpr int V = Vec16<T>::N;
  const int cv = C / V;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < nvec;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int c0 = (int)(i % cv) * V;
    alignas(16) T in[V], out[V];
    load16<T>(in, y, i);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float t = __fadd_rn(__fmul_rn(to_f32(in[k]), s[c0 + k]), b[c0 + k]);
      out[k] = from_f32<T>(fmaxf(t, 0.f));
    }
    store16<T>(z, i, out);
  }
}

// Block = rows x cv threads (cv = C / V channel vectors per pixel).
template <typename T>
__global__ void add_stats_kernel(const T* __restrict__ a, const T* __restrict__ b,
                                 T* __restrict__ z, float* __restrict__ partials, int64_t P,
                                 int C) {
  constexpr int V = Vec16<T>::N;
  extern __shared__ float red[];  // [rows][2][C]
  const int cv = C / V;
  const int rows = blockDim.x / cv;
  const int r = threadIdx.x / cv, c0 = (threadIdx.x % cv) * V;
  float s1[V], s2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s1[k] = s2[k] = 0.f;
  if (r < rows) {
    for (int64_t p = blockIdx.x * (int64_t)rows + r; p < P; p += (int64_t)gridDim.x * rows) {
      const int64_t i = p * cv + c0 / V;
      alignas(16) T va[V], vb[V], out[V];
      load16<T>(va, a, i);
      load16<T>(vb, b, i);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        out[k] = from_f32<T>(__fadd_rn(to_f32(va[k]), to_f32(vb[k])));
        const float zr = to_f32(out[k]);
        s1[k] = __fadd_rn(s1[k], zr);
        s2[k] = __fadd_rn(s2[k], __fmul_rn(zr, zr));
      }
      store16<T>(z, i, out);
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red[(r * 2 + 0) * C + c0 + k] = s1[k];
      red[(r * 2 + 1) * C + c0 + k] = s2[k];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 2 * C; j += blockDim.x) {
    float acc = 0.f;
    for (int rr = 0; rr < rows; ++rr) acc += red[rr * 2 * C + j];
    partials[(int64_t)blockIdx.x * 2 * C + j] = acc;
  }
}

// Block = rows x cv threads, as add_stats_kernel; partial sums of du * y
// and du per block.
template <typename T>
__global__ void bn_relu_bwd_kernel(const T* __restrict__ y, const T* __restrict__ dz,
                                   const float* __restrict__ s, const float* __restrict__ b,
                                   T* __restrict__ dy, float* __restrict__ partials, int64_t P,
                                   int C) {
  constexpr int V = Vec16<T>::N;
  extern __shared__ float red[];  // [rows][2][C]
  const int cv = C / V;
  const int rows = blockDim.x / cv;
  const int r = threadIdx.x / cv, c0 = (threadIdx.x % cv) * V;
  float s1[V], s2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s1[k] = s2[k] = 0.f;
  if (r < rows) {
    for (int64_t p = blockIdx.x * (int64_t)rows + r; p < P; p += (int64_t)gridDim.x * rows) {
      const int64_t i = p * cv + c0 / V;
      alignas(16) T vy[V], vd[V], out[V];
      load16<T>(vy, y, i);
      load16<T>(vd, dz, i);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float yf = to_f32(vy[k]);
        const float t = __fadd_rn(__fmul_rn(yf, s[c0 + k]), b[c0 + k]);
        const float du = t > 0.f ? to_f32(vd[k]) : 0.f;
        out[k] = from_f32<T>(__fmul_rn(du, s[c0 + k]));
        s1[k] = __fadd_rn(s1[k], __fmul_rn(du, yf));
        s2[k] = __fadd_rn(s2[k], du);
      }
      store16<T>(dy, i, out);
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red[(r * 2 + 0) * C + c0 + k] = s1[k];
      red[(r * 2 + 1) * C + c0 + k] = s2[k];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 2 * C; j += blockDim.x) {
    float acc = 0.f;
    for (int rr = 0; rr < rows; ++rr) acc += red[rr * 2 * C + j];
    partials[(int64_t)blockIdx.x * 2 * C + j] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kEwThreads)
dy_eff_kernel(const T* __restrict__ dz, const T* __restrict__ z, const float* __restrict__ s1,
              const float* __restrict__ s2, T* __restrict__ e, int64_t nvec, int C) {
  constexpr int V = Vec16<T>::N;
  const int cv = C / V;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < nvec;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int c0 = (int)(i % cv) * V;
    alignas(16) T vd[V], vz[V], out[V];
    load16<T>(vd, dz, i);
    load16<T>(vz, z, i);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float t = __fmul_rn(__fmul_rn(2.f, to_f32(vz[k])), s2[c0 + k]);
      out[k] = from_f32<T>(__fadd_rn(__fadd_rn(to_f32(vd[k]), s1[c0 + k]), t));
    }
    store16<T>(e, i, out);
  }
}

inline int grid_for(int64_t work, int per_block, int max_blocks) {
  const int64_t n = (work + per_block - 1) / per_block;
  return (int)(n < 1 ? 1 : (n < max_blocks ? n : max_blocks));
}

template <typename T>
int bn_relu_launch(const void* y, const void* s, const void* b, void* z, int64_t P, int C,
                   cudaStream_t st) {
  const int64_t nvec = P * C / Vec16<T>::N;
  bn_relu_kernel<T><<<grid_for(nvec, kEwThreads, 132 * 16), kEwThreads, 0, st>>>(
      static_cast<const T*>(y), static_cast<const float*>(s), static_cast<const float*>(b),
      static_cast<T*>(z), nvec, C);
  return (int)cudaGetLastError();
}

template <typename T>
int add_stats_launch(const void* a, const void* b, void* z, void* partials, void* out, int64_t P,
                     int C, int max_blocks, cudaStream_t st) {
  const int cv = C / Vec16<T>::N;
  const int rows = kEwThreads / cv;
  const int nblk = grid_for(P, rows, max_blocks);
  add_stats_kernel<T><<<nblk, rows * cv, (size_t)rows * 2 * C * sizeof(float), st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(z),
      static_cast<float*>(partials), P, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<<<2 * C, kReduceThreads, 0, st>>>(static_cast<const float*>(partials), nblk,
                                                       2 * C, 2 * C, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int bn_relu_bwd_launch(const void* y, const void* dz, const void* s, const void* b, void* dy,
                       void* partials, void* out, int64_t P, int C, int max_blocks,
                       cudaStream_t st) {
  const int cv = C / Vec16<T>::N;
  const int rows = kEwThreads / cv;
  const int nblk = grid_for(P, rows, max_blocks);
  bn_relu_bwd_kernel<T><<<nblk, rows * cv, (size_t)rows * 2 * C * sizeof(float), st>>>(
      static_cast<const T*>(y), static_cast<const T*>(dz), static_cast<const float*>(s),
      static_cast<const float*>(b), static_cast<T*>(dy), static_cast<float*>(partials), P, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<<<2 * C, kReduceThreads, 0, st>>>(static_cast<const float*>(partials), nblk,
                                                       2 * C, 2 * C, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int dy_eff_launch(const void* dz, const void* z, const void* s1, const void* s2, void* e,
                  int64_t P, int C, cudaStream_t st) {
  const int64_t nvec = P * C / Vec16<T>::N;
  dy_eff_kernel<T><<<grid_for(nvec, kEwThreads, 132 * 16), kEwThreads, 0, st>>>(
      static_cast<const T*>(dz), static_cast<const T*>(z), static_cast<const float*>(s1),
      static_cast<const float*>(s2), static_cast<T*>(e), nvec, C);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cltorch

// Plain C interface, loaded with ctypes; each returns cudaGetLastError().
// The Python wrapper (cl_tpu_torch/kernels/packed_eltwise.py) checks the
// operands: contiguous NHWC, 16-byte aligned, C * itemsize a multiple of 16
// and C / (16 / itemsize) <= 256. `partials` holds max_blocks * 2 * C
// floats; `out` is [2, C] (add_stats: sum, sum of squares; bn_relu_bwd:
// dscale, dshift).
extern "C" {

int cltorch_bn_relu_fwd(const void* y, const void* s, const void* b, void* z, int64_t P, int C,
                        int is_bf16, void* stream) {
  using namespace cltorch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? bn_relu_launch<__nv_bfloat16>(y, s, b, z, P, C, st)
                 : bn_relu_launch<float>(y, s, b, z, P, C, st);
}

int cltorch_add_stats_fwd(const void* a, const void* b, void* z, void* partials, void* out,
                          int64_t P, int C, int is_bf16, int max_blocks, void* stream) {
  using namespace cltorch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? add_stats_launch<__nv_bfloat16>(a, b, z, partials, out, P, C, max_blocks, st)
                 : add_stats_launch<float>(a, b, z, partials, out, P, C, max_blocks, st);
}

int cltorch_bn_relu_bwd(const void* y, const void* dz, const void* s, const void* b, void* dy,
                        void* partials, void* out, int64_t P, int C, int is_bf16,
                        int max_blocks, void* stream) {
  using namespace cltorch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? bn_relu_bwd_launch<__nv_bfloat16>(y, dz, s, b, dy, partials, out, P, C,
                                                     max_blocks, st)
                 : bn_relu_bwd_launch<float>(y, dz, s, b, dy, partials, out, P, C, max_blocks,
                                             st);
}

int cltorch_dy_eff(const void* dz, const void* z, const void* s1, const void* s2, void* e,
                   int64_t P, int C, int is_bf16, void* stream) {
  using namespace cltorch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dy_eff_launch<__nv_bfloat16>(dz, z, s1, s2, e, P, C, st)
                 : dy_eff_launch<float>(dz, z, s1, s2, e, P, C, st);
}

}  // extern "C"
