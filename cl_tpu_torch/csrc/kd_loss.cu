// LwF distillation on materialized logits, forward and backward.
//
// Replaces the TPU kernels cl_tpu/pallas/kd_loss.py::_kd_kernel (launched at
// kd_loss.py:154) and ::_kd_grad_kernel (kd_loss.py:183). Same arithmetic,
// in pixel-major layout: the student's logits `nw` and the frozen teacher's
// `old` [P, C] (the same type, f32 or bf16, contiguous), labels [P] int32,
// old_valid [C] f32 1/0, inv_t = 1/T rounded to f32.
//
//   a_c = old_valid_c ? nw_c * inv_t : -1e9    (the multiply first, then
//   b_c = old_valid_c ? old_c * inv_t : -1e9    the mask: kd_loss.py:47-50)
//   ls_a = a - max(a) - log(sum exp(a - max(a))), ls_b likewise
//   forward:  total = sum_p pix_p * sum_c exp(ls_b) (ls_b - ls_a)
//   backward: dnw = scale * pix * (exp(ls_a) - exp(ls_b)), 0 outside
//             old_valid, written in the logits' type (kd_loss.py:176-188);
//             scale = g / T arrives as a device scalar
// with pix = label != ignore. The T^2/n factor is the caller's. All math is
// f32 in registers; bf16 logits are upcast on load.
//
// What bounds it on the H100: bytes. The forward reads both logit tensors
// and the labels once (2 M pixels x 19 bf16 classes: 2 x 76 MiB + 8 MiB,
// ~50 us at 3.35 TB/s); the backward also writes dnw. The math is ~15
// operations per logit pair.
//
// Design: ce_loss.cu's, with two tiles staged instead of one. A block of 256
// threads walks tiles of 256 pixels (grid-stride over a fixed grid); a
// tile's C*256 logits of each tensor are one contiguous run, staged in
// shared memory by coalesced loads and upcast to f32, with a row stride of
// C|1 floats so that each thread's reads of its own rows are free of bank
// conflicts. Each thread owns one pixel. The backward writes its dnw row
// into the staged student tile, which the block stores with coalesced
// writes. The forward's per-block partial sums are added by a second kernel
// in a fixed order: no float atomics, so a run repeats its bits.

#include "common.cuh"

namespace cltorch {
namespace {

constexpr int kKdTile = 256;  // pixels per tile = threads per block

inline __host__ __device__ int kd_stride(int C) { return (C % 2 == 0) ? C + 1 : C; }
inline __host__ __device__ size_t kd_smem(int C) {
  return ((size_t)2 * kKdTile * kd_stride(C) + C + kKdTile / 32) * sizeof(float);
}

template <typename T>
__device__ __forceinline__ void kd_stage(const T* __restrict__ z, int64_t base, int rows, int C,
                                         int S, float* zs) {
  const T* src = z + base * C;
  for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
    const int r = i / C, c = i - r * C;
    zs[r * S + c] = to_f32(src[i]);
  }
}

// One row scaled by 1/T and masked to the old classes, in place; returns
// max and log(sum exp(row - max)), so that ls_c = (row_c - m) - lse.
__device__ __forceinline__ void kd_row(float* row, const float* ovs, int C, float inv_t,
                                       float& m, float& lse) {
  m = kNegInf;
  for (int c = 0; c < C; ++c) {
    row[c] = ovs[c] > 0.f ? row[c] * inv_t : kNegInf;
    m = fmaxf(m, row[c]);
  }
  float s = 0.f;
  for (int c = 0; c < C; ++c) s += expf(row[c] - m);
  lse = logf(s);
}

template <typename T>
__global__ void __launch_bounds__(kKdTile)
kd_fwd_kernel(const T* __restrict__ nw, const T* __restrict__ old, const int* __restrict__ labels,
              const float* __restrict__ ovalid, float inv_t, float* __restrict__ partials, int P,
              int C, int ignore_index) {
  extern __shared__ __align__(16) float sm[];
  const int S = kd_stride(C);
  float* ns = sm;
  float* os = ns + kKdTile * S;
  float* ovs = os + kKdTile * S;
  float* scratch = ovs + C;
  for (int i = threadIdx.x; i < C; i += blockDim.x) ovs[i] = ovalid[i];
  const int ntiles = (P + kKdTile - 1) / kKdTile;
  float acc = 0.f;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t base = (int64_t)tile * kKdTile;
    const int rows = min(kKdTile, (int)(P - base));
    __syncthreads();
    kd_stage<T>(nw, base, rows, C, S, ns);
    kd_stage<T>(old, base, rows, C, S, os);
    __syncthreads();
    const int r = threadIdx.x;
    if (r < rows) {
      float* a = ns + r * S;
      float* b = os + r * S;
      float ma, la, mb, lb;
      kd_row(a, ovs, C, inv_t, ma, la);
      kd_row(b, ovs, C, inv_t, mb, lb);
      float kl = 0.f;
      for (int c = 0; c < C; ++c) {
        const float lsa = (a[c] - ma) - la;
        const float lsb = (b[c] - mb) - lb;
        kl += expf(lsb) * (lsb - lsa);
      }
      const float pix = labels[base + r] != ignore_index ? 1.f : 0.f;
      acc += kl * pix;
    }
  }
  acc = block_sum(acc, scratch);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kKdTile)
kd_bwd_kernel(const T* __restrict__ nw, const T* __restrict__ old, const int* __restrict__ labels,
              const float* __restrict__ ovalid, const float* __restrict__ scale, float inv_t,
              T* __restrict__ dnw, int P, int C, int ignore_index) {
  extern __shared__ __align__(16) float sm[];
  const int S = kd_stride(C);
  float* ns = sm;
  float* os = ns + kKdTile * S;
  float* ovs = os + kKdTile * S;
  for (int i = threadIdx.x; i < C; i += blockDim.x) ovs[i] = ovalid[i];
  const float sc = *scale;
  const int ntiles = (P + kKdTile - 1) / kKdTile;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t base = (int64_t)tile * kKdTile;
    const int rows = min(kKdTile, (int)(P - base));
    __syncthreads();
    kd_stage<T>(nw, base, rows, C, S, ns);
    kd_stage<T>(old, base, rows, C, S, os);
    __syncthreads();
    const int r = threadIdx.x;
    if (r < rows) {
      float* a = ns + r * S;
      float* b = os + r * S;
      float ma, la, mb, lb;
      kd_row(a, ovs, C, inv_t, ma, la);
      kd_row(b, ovs, C, inv_t, mb, lb);
      const float sp = sc * (labels[base + r] != ignore_index ? 1.f : 0.f);
      for (int c = 0; c < C; ++c) {
        const float g = sp * (expf((a[c] - ma) - la) - expf((b[c] - mb) - lb));
        a[c] = ovs[c] > 0.f ? g : 0.f;
      }
    }
    __syncthreads();
    T* dst = dnw + base * C;
    for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
      const int rr = i / C, c = i - rr * C;
      dst[i] = from_f32<T>(ns[rr * S + c]);
    }
  }
}

// Blocks for P pixels: one per tile, at most max_blocks (the length of the
// partials buffer the caller gave).
inline int kd_blocks(int P, int max_blocks) {
  const int tiles = (P + kKdTile - 1) / kKdTile;
  const int n = tiles < max_blocks ? tiles : max_blocks;
  return n > 1 ? n : 1;
}

template <typename T>
int kd_fwd_launch(const void* nw, const void* old, const void* lbl, const void* ovalid,
                  void* partials, void* out, int P, int C, int ignore_index, float inv_t,
                  int max_blocks, cudaStream_t st) {
  const int nblk = kd_blocks(P, max_blocks);
  const size_t smem = kd_smem(C);
  cudaError_t err = cudaFuncSetAttribute(kd_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kd_fwd_kernel<T><<<nblk, kKdTile, smem, st>>>(
      static_cast<const T*>(nw), static_cast<const T*>(old), static_cast<const int*>(lbl),
      static_cast<const float*>(ovalid), inv_t, static_cast<float*>(partials), P, C,
      ignore_index);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<<<1, kReduceThreads, 0, st>>>(static_cast<const float*>(partials), nblk, 1,
                                                   1, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int kd_bwd_launch(const void* nw, const void* old, const void* lbl, const void* ovalid,
                  const void* scale, void* dnw, int P, int C, int ignore_index, float inv_t,
                  int max_blocks, cudaStream_t st) {
  const int nblk = kd_blocks(P, max_blocks);
  const size_t smem = kd_smem(C);
  cudaError_t err = cudaFuncSetAttribute(kd_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kd_bwd_kernel<T><<<nblk, kKdTile, smem, st>>>(
      static_cast<const T*>(nw), static_cast<const T*>(old), static_cast<const int*>(lbl),
      static_cast<const float*>(ovalid), static_cast<const float*>(scale), inv_t,
      static_cast<T*>(dnw), P, C, ignore_index);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cltorch

// Plain C interface, loaded with ctypes. Each returns cudaGetLastError()
// (0 = launched). Shapes and types are checked by the Python wrapper
// (cl_tpu_torch/kernels/kd_loss.py): C <= 32, both logit tensors contiguous
// and of one type. The forward's `partials` holds max_blocks floats; the
// backward's `scale` is g / T on the device.
extern "C" {

int cltorch_kd_fwd(const void* nw, const void* old, const void* lbl, const void* ovalid,
                   void* partials, void* out, int P, int C, int ignore_index, int is_bf16,
                   float inv_t, int max_blocks, void* stream) {
  using namespace cltorch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? kd_fwd_launch<__nv_bfloat16>(nw, old, lbl, ovalid, partials, out, P, C,
                                                ignore_index, inv_t, max_blocks, st)
                 : kd_fwd_launch<float>(nw, old, lbl, ovalid, partials, out, P, C, ignore_index,
                                        inv_t, max_blocks, st);
}

int cltorch_kd_bwd(const void* nw, const void* old, const void* lbl, const void* ovalid,
                   const void* scale, void* dnw, int P, int C, int ignore_index, int is_bf16,
                   float inv_t, int max_blocks, void* stream) {
  using namespace cltorch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? kd_bwd_launch<__nv_bfloat16>(nw, old, lbl, ovalid, scale, dnw, P, C,
                                                ignore_index, inv_t, max_blocks, st)
                 : kd_bwd_launch<float>(nw, old, lbl, ovalid, scale, dnw, P, C, ignore_index,
                                        inv_t, max_blocks, st);
}

}  // extern "C"
