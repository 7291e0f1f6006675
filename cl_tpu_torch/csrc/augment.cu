// Device-side augmentation of a uint8 batch: the image's bilinear resize,
// horizontal flip and normalization (kernel #15), and the mask's
// nearest-neighbour resize with the same flip (kernel #16).
//
// Replaces the TPU kernels cl_tpu/pallas/augment.py::_img_kernel (call at
// augment.py:94) and _mask_kernel (call at augment.py:110). The image kernel
// ran per (image, channel) two dense products with the half-pixel bilinear
// matrix, Rv . X . Rh^T, the flip folded in as the row-reversed Rh, then
// (y - 255 mean_c) / (255 std_c) rounded once to the compute dtype; it read a
// planarized [B, 3, S, S] copy and wrote planar [B, 3, D, D], a layout that
// existed only for the TPU's VMEM budget. The mask kernel was a one-hot
// selection product, exact in f32.
//
// What bounds them on the H100: bytes. At B = 8, 576 -> 512, #15 reads
// 7,962,624 bytes and writes 12,582,912 (bf16) or 25,165,824 (f32): 6.1 or
// 9.9 us at 3.35 TB/s; #16 reads 2,654,208 and writes 8,388,608: 3.3 us. The
// dense products would do 15.4 GFLOP of multiplications by zero.
//
// Design: each row of the half-pixel bilinear matrix has at most two
// nonzeros, so the dense product equals a two-tap vertical pass followed by a
// two-tap horizontal pass: the zero terms add exactly 0. The taps are the
// nonzeros of the f32 matrix itself (cl_tpu_torch/kernels/augment.py builds
// the tables), so an edge row whose two clamped weights were summed into one
// entry has one tap. Read NHWC uint8, write NHWC in the compute dtype, no
// planar copy. One block per (output row, image): the vertical pass writes
// the row's S x 3 f32 intermediate to shared memory (the same order as the
// TPU kernel: vertical first, f32 in between), then the horizontal pass
// forms the D x 3 outputs, each thread one element at a time so that the
// stores of a warp are contiguous. The flip reads the horizontal taps of
// output column D - 1 - p. The division is IEEE (no fast math), and the
// result is rounded once. The mask kernel is the gather
// out[b, o, p] = mask[b, n[o], n[flip ? D - 1 - p : p]], bit-equal.

#include "common.cuh"

namespace cltorch {
namespace {

constexpr int kAugThreads = 256;

__device__ __forceinline__ float pick3(int c, float a, float b, float d) {
  return c == 0 ? a : (c == 1 ? b : d);
}

template <typename T>
__global__ void __launch_bounds__(kAugThreads)
augment_image_kernel(const uint8_t* __restrict__ img, const uint8_t* __restrict__ flip,
                     const int* __restrict__ lo, const int* __restrict__ hi,
                     const float* __restrict__ wlo, const float* __restrict__ whi,
                     T* __restrict__ out, int S, int D, float m0, float m1, float m2, float s0,
                     float s1, float s2) {
  extern __shared__ float row[];  // the vertical pass of output row o: [S, 3] f32
  const int o = blockIdx.x, b = blockIdx.y;
  const int n_in = S * 3;
  const uint8_t* src = img + (int64_t)b * S * n_in;
  const uint8_t* r0 = src + (int64_t)lo[o] * n_in;
  const uint8_t* r1 = src + (int64_t)hi[o] * n_in;
  const float a0 = wlo[o], a1 = whi[o];
  for (int j = threadIdx.x; j < n_in; j += blockDim.x)
    row[j] = fmaf(a1, (float)r1[j], __fmul_rn(a0, (float)r0[j]));
  __syncthreads();
  const bool fl = flip[b] != 0;
  T* dst = out + ((int64_t)b * D + o) * D * 3;
  for (int j = threadIdx.x; j < D * 3; j += blockDim.x) {
    const int p = j / 3, c = j - 3 * p;
    const int q = fl ? D - 1 - p : p;
    const float y = fmaf(whi[q], row[hi[q] * 3 + c], __fmul_rn(wlo[q], row[lo[q] * 3 + c]));
    dst[j] = from_f32<T>(__fdiv_rn(__fsub_rn(y, pick3(c, m0, m1, m2)), pick3(c, s0, s1, s2)));
  }
}

__global__ void __launch_bounds__(kAugThreads)
augment_mask_kernel(const uint8_t* __restrict__ mask, const uint8_t* __restrict__ flip,
                    const int* __restrict__ nidx, int* __restrict__ out, int S, int D) {
  const int o = blockIdx.x, b = blockIdx.y;
  const uint8_t* src = mask + ((int64_t)b * S + nidx[o]) * S;
  int* dst = out + ((int64_t)b * D + o) * D;
  const bool fl = flip[b] != 0;
  for (int p = threadIdx.x; p < D; p += blockDim.x) dst[p] = src[nidx[fl ? D - 1 - p : p]];
}

}  // namespace
}  // namespace cltorch

// Plain C interface, loaded with ctypes; each returns cudaGetLastError() (0 =
// launched). Checked by cl_tpu_torch/kernels/augment.py: img uint8 [B, S, S, 3]
// and mask uint8 [B, S, S] contiguous, flip bool [B], the tap tables int32 /
// f32 [D] on the device, 1 <= B <= 65535, S <= 4096 (the intermediate row
// fits the default 48 KB of shared memory).
extern "C" {

int cltorch_augment_image(const void* img, const void* flip, const void* lo, const void* hi,
                          const void* wlo, const void* whi, void* out, int B, int S, int D,
                          float m0, float m1, float m2, float s0, float s1, float s2, int out_bf16,
                          void* stream) {
  using namespace cltorch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)D, (unsigned)B);
  const size_t smem = (size_t)S * 3 * sizeof(float);
  const auto* im = static_cast<const uint8_t*>(img);
  const auto* fl = static_cast<const uint8_t*>(flip);
  const auto* l = static_cast<const int*>(lo);
  const auto* h = static_cast<const int*>(hi);
  const auto* wl = static_cast<const float*>(wlo);
  const auto* wh = static_cast<const float*>(whi);
  if (out_bf16)
    augment_image_kernel<__nv_bfloat16><<<grid, kAugThreads, smem, st>>>(
        im, fl, l, h, wl, wh, static_cast<__nv_bfloat16*>(out), S, D, m0, m1, m2, s0, s1, s2);
  else
    augment_image_kernel<float><<<grid, kAugThreads, smem, st>>>(
        im, fl, l, h, wl, wh, static_cast<float*>(out), S, D, m0, m1, m2, s0, s1, s2);
  return (int)cudaGetLastError();
}

int cltorch_augment_mask(const void* mask, const void* flip, const void* nidx, void* out, int B,
                         int S, int D, void* stream) {
  using namespace cltorch;
  augment_mask_kernel<<<dim3((unsigned)D, (unsigned)B), kAugThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<const uint8_t*>(flip),
      static_cast<const int*>(nidx), static_cast<int*>(out), S, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
