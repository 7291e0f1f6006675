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
// The bodies (mma.sync for bf16, FMA for f32), each templated on its KIND,
// are in conv3x3_dw_body.cuh, shared with the gen-2 dW.

#include "conv3x3_dw_body.cuh"

namespace cltorch {
namespace {

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
