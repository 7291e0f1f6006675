// Weight gradient of the 3x3 SAME conv with the BN-ReLU prologue, from the
// saved activations in the compute type (the int8 form's, #39, is
// conv3x3_dw_q.cu).
//
// Replaces the TPU kernel cl_tpu/pallas/conv3x3_v3.py::_dw_bn2_kernel
// (#36, launched at conv3x3_v3.py:1332 by `_dw_bn2_impl`, from the fused
// branch of `conv_bn_fused`'s VJP, :951-961):
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
// What bounds #36 on the H100 (bf16, batch 8, x, dy and y read once; the
// tensor cores at 989 TFLOP/s, 3.35 TB/s):
//
//   shape (H, Cin -> Cout)  convs  bytes   bytes bound  FLOP bound
//   512, 3 -> 32 (stem)       1    281 MB    84 us        4 us
//   512, 32 -> 32             4    403 MB   120 us       39 us
//   256, 32 -> 64             1    168 MB    50 us       20 us
//   256, 64 -> 64             4    201 MB    60 us       39 us
//   128, 64 -> 128            1     84 MB    25 us       20 us
//   128, 128 -> 128           4    101 MB    30 us       39 us
//
// bytes at levels 0-1, the tensor cores at level 2: 1.04 ms over a step.
// bf16 #36 runs the ring body (conv3x3_dw_body.cuh::dw_ring_body): a ring of
// stages fed by TMA (cp.async for the stem and odd widths), t and e formed
// once per element in place, a channel tile fitted to the shape (wgmma on
// the 64 x 64 tile of levels 1-2, mma.sync on the others), one wave of
// resident blocks whose partials are written a weight row at a time; its
// note there says what it does about each cause that held the first body.
// The tile (CI_T, CO_T) and the splits come from the wrapper
// (kernels/conv3x3.py::dw_ring_tile, dw_ring_splits), which mirrors
// RingTile's resources; the TMA maps are made here (conv3x3_tma.cuh, cached
// by pointer and shape). f32 #36
// runs the FMA body.

#include "conv3x3_dw_body.cuh"

namespace cltorch {
namespace {

// The kernels, named for the profile family of the packed body's (conv3x3_dw*).
#define CLTORCH_DW_PARAMS(T)                                                              \
  const T *__restrict__ x, const float *__restrict__ pa, const float *__restrict__ pb,   \
      const T *__restrict__ dy, const T *__restrict__ y, const float *__restrict__ s1,    \
      const float *__restrict__ s2, float *__restrict__ partials, int B, int H, int W,    \
      int Cin, int Cout, int prologue, int ew_bf16

// The ring kernel takes TMA maps of x, dy and y (read with CI_T >= 32 only).
template <int CI_T, int CO_T>
__global__ void __launch_bounds__(RingTile<CI_T, CO_T>::kThreads, RingTile<CI_T, CO_T>::kMinBlocks)
    conv3x3_dw_ring_kernel(CLTORCH_DW_PARAMS(bf16), const __grid_constant__ CUtensorMap tm_x,
                           const __grid_constant__ CUtensorMap tm_dy,
                           const __grid_constant__ CUtensorMap tm_y) {
  dw_ring_body<kDwFused, CI_T, CO_T>(x, pa, pb, dy, y, s1, s2, partials, B, H, W, Cin, Cout,
                                     prologue, &tm_x, &tm_dy, &tm_y, ew_bf16);
}
__global__ void __launch_bounds__(kDwfThreads) conv3x3_dw_fma_kernel(CLTORCH_DW_PARAMS(float)) {
  dw_fma_body<kDwFused>(x, pa, pb, dy, y, s1, s2, partials, B, H, W, Cin, Cout, prologue);
}

// The f32 kernel (the FMA body), then the fixed-order sum of its partials.
int dw_fma_launch(const float* x, const float* a, const float* b, const float* dy,
                  const float* y, const float* s1, const float* s2, void* partials, void* dw,
                  int B, int H, int W, int Cin, int Cout, int prologue, int splits,
                  cudaStream_t st) {
  const dim3 grid((Cin + kDwC - 1) / kDwC, (Cout + kDwC - 1) / kDwC, splits);
  float* part = static_cast<float*>(partials);
  conv3x3_dw_fma_kernel<<<grid, kDwfThreads, 0, st>>>(x, a, b, dy, y, s1, s2, part, B, H, W, Cin,
                                                      Cout, prologue, 0);
  return sum_dw_splits(part, dw, splits, Cin, Cout, st);
}

}  // namespace
}  // namespace cltorch

// Plain C interface, loaded with ctypes; returns cudaGetLastError(). The
// wrapper (cl_tpu_torch/kernels/conv3x3.py) checks the operands: x
// [B, H, W, Cin], dy and y [B, H, W, Cout], contiguous, 16-byte aligned, of
// one type; a, b f32 [Cin] (read only with `prologue`); s1, s2 f32 [Cout]
// or null (e = dy); `partials` holds splits * Cout * Cin * 9 floats; dw is
// f32 [Cout, Cin, 3, 3].
extern "C" {

// #36. bf16 runs the ring body with the (ci_t, co_t) tile; f32 the FMA
// body (ci_t, co_t unread). `ew_bf16` (bf16): t and e with the bf16 chains
// (CL_TPU_E_BF16).
int cltorch_conv3x3_bn_dw(const void* x, const void* a, const void* b, const void* dy,
                          const void* y, const void* s1, const void* s2, void* partials,
                          void* dw, int B, int H, int W, int Cin, int Cout, int prologue,
                          int splits, int ci_t, int co_t, int is_bf16, int ew_bf16,
                          void* stream) {
  using namespace cltorch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return dw_fma_launch(static_cast<const float*>(x), static_cast<const float*>(a),
                         static_cast<const float*>(b), static_cast<const float*>(dy),
                         static_cast<const float*>(y), static_cast<const float*>(s1),
                         static_cast<const float*>(s2), partials, dw, B, H, W, Cin, Cout,
                         prologue, splits, st);
  const bf16 *xb = static_cast<const bf16*>(x), *dyb = static_cast<const bf16*>(dy),
             *yb = static_cast<const bf16*>(y);
  const float *fa = static_cast<const float*>(a), *fb = static_cast<const float*>(b);
  const float *f1 = static_cast<const float*>(s1), *f2 = static_cast<const float*>(s2);
#define CLTORCH_RING_LAUNCH(CI, CO)                                                                \
  dw_ring_run<CI, CO>(                                                                             \
      kernel_ptr(conv3x3_dw_ring_kernel<CI, CO>),                                                  \
      [&](dim3 grid, int threads, int smem, float* out, const CUtensorMap* tm) {                   \
        conv3x3_dw_ring_kernel<CI, CO><<<grid, threads, smem, st>>>(                               \
            xb, fa, fb, dyb, yb, f1, f2, out, B, H, W, Cin, Cout, prologue, ew_bf16,            \
            tm[0], tm[1], tm[2]);                                                                  \
      },                                                                                           \
      x, dy, s1 != nullptr ? y : nullptr, partials, dw, B, H, W, Cin, Cout, splits, st)
  CLTORCH_RING_DISPATCH(CLTORCH_RING_LAUNCH)
#undef CLTORCH_RING_LAUNCH
}

// The ring instance (ci_t, co_t) on this card: out[4] = {resident blocks
// an SM, registers a thread, local (spilled) bytes a thread, dynamic shared
// bytes a block}.
int cltorch_conv3x3_dw_ring_info(int ci_t, int co_t, int* out) {
  using namespace cltorch;
#define CLTORCH_RING_INFO(CI, CO)                                                                  \
  kernel_info(kernel_ptr(conv3x3_dw_ring_kernel<CI, CO>),                                          \
              RingTile<CI, CO>::kThreads, RingTile<CI, CO>::kSmem, out)
  CLTORCH_RING_DISPATCH(CLTORCH_RING_INFO)
#undef CLTORCH_RING_INFO
}

}  // extern "C"
