// Masked softmax cross-entropy on materialized logits, forward and backward.
//
// Replaces the TPU kernels cl_tpu/pallas/ce_loss.py::_ce_kernel (launched at
// ce_loss.py:118) and ::_ce_grad_kernel (ce_loss.py:140). Same arithmetic,
// in pixel-major layout: logits z [P, C] (f32 or bf16, contiguous), labels
// [P] int32, valid [C] f32 1/0.
//
//   forward:  total = sum_p pix_p * (logsumexp_c z_pc - z_p,label_p)
//   backward: dz = scale * pix * (softmax(z) - onehot(label)) * valid,
//             written in the logits dtype (ce_loss.py:144)
// with invalid classes at -1e9 and pix = label != ignore. All math is f32
// in registers; bf16 logits are upcast on load.
//
// What bounds it on the H100: bytes. The forward reads z and the labels
// once (2 M pixels x 19 bf16 classes = 76 MiB + 8 MiB: ~26 us at
// 3.35 TB/s); the backward also writes dz of the size of z. The math is a
// few operations per logit.
//
// Design: a block of 256 threads walks tiles of 256 pixels (grid-stride
// over a fixed grid). A tile's C*256 logits are one contiguous run in
// memory, staged in shared memory by coalesced loads and upcast to f32,
// with a row stride of C|1 floats so that each thread's reads of its own
// row are free of bank conflicts. Each thread owns one pixel. The backward
// writes its dz row back into the staged tile and the block stores the
// tile with coalesced writes. The forward's per-block partial sums are
// added by a second kernel in a fixed order: no float atomics, so a run
// repeats its losses bit for bit.

#include "common.cuh"

namespace cltorch {
namespace {

constexpr int kCeTile = 256;  // pixels per tile = threads per block

inline __host__ __device__ int ce_stride(int C) { return (C % 2 == 0) ? C + 1 : C; }
inline __host__ __device__ size_t ce_smem(int C) {
  return ((size_t)kCeTile * ce_stride(C) + 2 * C + kCeTile / 32) * sizeof(float);
}

template <typename T>
__device__ __forceinline__ void ce_stage(const T* __restrict__ z, int64_t base, int rows, int C,
                                         int S, float* zs) {
  const T* src = z + base * C;
  for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
    const int r = i / C, c = i - r * C;
    zs[r * S + c] = to_f32(src[i]);
  }
}

// Masked row (invalid classes at -1e9); returns max and sum of exp(z - max).
__device__ __forceinline__ void ce_row_stats(float* row, const float* vs, int C, float& m,
                                             float& s) {
  m = kNegInf;
  for (int c = 0; c < C; ++c) {
    row[c] = vs[c] > 0.f ? row[c] : kNegInf;
    m = fmaxf(m, row[c]);
  }
  s = 0.f;
  for (int c = 0; c < C; ++c) s += expf(row[c] - m);
}

template <typename T>
__global__ void __launch_bounds__(kCeTile)
ce_fwd_kernel(const T* __restrict__ z, const int* __restrict__ labels,
              const float* __restrict__ valid, float* __restrict__ partials, int P, int C,
              int ignore_index) {
  extern __shared__ __align__(16) float sm[];
  const int S = ce_stride(C);
  float* zs = sm;
  float* vs = zs + kCeTile * S;
  float* scratch = vs + 2 * C;
  for (int i = threadIdx.x; i < C; i += blockDim.x) vs[i] = valid[i];
  const int ntiles = (P + kCeTile - 1) / kCeTile;
  float acc = 0.f;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t base = (int64_t)tile * kCeTile;
    const int rows = min(kCeTile, (int)(P - base));
    __syncthreads();
    ce_stage<T>(z, base, rows, C, S, zs);
    __syncthreads();
    const int r = threadIdx.x;
    if (r < rows) {
      float* row = zs + r * S;
      float m, s;
      ce_row_stats(row, vs, C, m, s);
      const float logz = m + logf(s);
      const int lbl = labels[base + r];
      const float pix = lbl != ignore_index ? 1.f : 0.f;
      const int lbl0 = lbl == ignore_index ? 0 : lbl;
      const float picked = (lbl0 >= 0 && lbl0 < C) ? row[lbl0] : 0.f;
      acc += (logz - picked) * pix;
    }
  }
  acc = block_sum(acc, scratch);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kCeTile)
ce_bwd_kernel(const T* __restrict__ z, const int* __restrict__ labels,
              const float* __restrict__ valid, const float* __restrict__ scale,
              T* __restrict__ dz, int P, int C, int ignore_index) {
  extern __shared__ __align__(16) float sm[];
  const int S = ce_stride(C);
  float* zs = sm;
  float* vs = zs + kCeTile * S;
  for (int i = threadIdx.x; i < C; i += blockDim.x) vs[i] = valid[i];
  const float sc = *scale;
  const int ntiles = (P + kCeTile - 1) / kCeTile;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t base = (int64_t)tile * kCeTile;
    const int rows = min(kCeTile, (int)(P - base));
    __syncthreads();
    ce_stage<T>(z, base, rows, C, S, zs);
    __syncthreads();
    const int r = threadIdx.x;
    if (r < rows) {
      float* row = zs + r * S;
      float m, s;
      ce_row_stats(row, vs, C, m, s);
      const int lbl = labels[base + r];
      const float pix = lbl != ignore_index ? 1.f : 0.f;
      const int lbl0 = lbl == ignore_index ? 0 : lbl;
      const float sp = sc * pix;
      for (int c = 0; c < C; ++c) {
        const float p = expf(row[c] - m) / s;
        const float g = sp * (p - (c == lbl0 ? 1.f : 0.f));
        row[c] = vs[c] > 0.f ? g : 0.f;
      }
    }
    __syncthreads();
    T* dst = dz + base * C;
    for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
      const int rr = i / C, c = i - rr * C;
      dst[i] = from_f32<T>(zs[rr * S + c]);
    }
  }
}

// Blocks for P pixels: one per tile, at most max_blocks (the length of the
// partials buffer the caller gave).
inline int ce_blocks(int P, int max_blocks) {
  const int tiles = (P + kCeTile - 1) / kCeTile;
  const int n = tiles < max_blocks ? tiles : max_blocks;
  return n > 1 ? n : 1;
}

template <typename T>
int ce_fwd_launch(const void* z, const void* lbl, const void* valid, void* partials, void* out,
                  int P, int C, int ignore_index, int max_blocks, cudaStream_t st) {
  const int nblk = ce_blocks(P, max_blocks);
  ce_fwd_kernel<T><<<nblk, kCeTile, ce_smem(C), st>>>(
      static_cast<const T*>(z), static_cast<const int*>(lbl), static_cast<const float*>(valid),
      static_cast<float*>(partials), P, C, ignore_index);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<<<1, kReduceThreads, 0, st>>>(static_cast<const float*>(partials), nblk, 1,
                                                   1, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int ce_bwd_launch(const void* z, const void* lbl, const void* valid, const void* scale, void* dz,
                  int P, int C, int ignore_index, int max_blocks, cudaStream_t st) {
  const int nblk = ce_blocks(P, max_blocks);
  ce_bwd_kernel<T><<<nblk, kCeTile, ce_smem(C), st>>>(
      static_cast<const T*>(z), static_cast<const int*>(lbl), static_cast<const float*>(valid),
      static_cast<const float*>(scale), static_cast<T*>(dz), P, C, ignore_index);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cltorch

// Plain C interface, loaded with ctypes. Each returns cudaGetLastError()
// (0 = launched). Shapes and types are checked by the Python wrapper
// (cl_tpu_torch/kernels/ce_loss.py): C <= 32, contiguous z. The forward's
// `partials` holds max_blocks floats.
extern "C" {

int cltorch_ce_fwd(const void* z, const void* lbl, const void* valid, void* partials, void* out,
                   int P, int C, int ignore_index, int is_bf16, int max_blocks, void* stream) {
  using namespace cltorch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? ce_fwd_launch<__nv_bfloat16>(z, lbl, valid, partials, out, P, C,
                                                ignore_index, max_blocks, st)
                 : ce_fwd_launch<float>(z, lbl, valid, partials, out, P, C, ignore_index,
                                        max_blocks, st);
}

int cltorch_ce_bwd(const void* z, const void* lbl, const void* valid, const void* scale, void* dz,
                   int P, int C, int ignore_index, int is_bf16, int max_blocks, void* stream) {
  using namespace cltorch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? ce_bwd_launch<__nv_bfloat16>(z, lbl, valid, scale, dz, P, C, ignore_index,
                                                max_blocks, st)
                 : ce_bwd_launch<float>(z, lbl, valid, scale, dz, P, C, ignore_index, max_blocks, st);
}

}  // extern "C"
