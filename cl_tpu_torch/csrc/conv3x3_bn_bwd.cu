// Weight gradient of the 3x3 SAME conv with the BN-ReLU prologue, from the
// saved activations in the compute type and from their int8 form.
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
//
// One more instance of the first bodies (KIND below), computing only its
// own function (#33, kDwBn, and #31, kDwPlain, were redesigned onto the ring
// and register-blocked bodies: conv3x3_dw_bn.cu, conv3x3_v3_dw.cu):
// * cl_tpu/pallas/conv3x3_v3.py::_dw2_q_kernel (#39, launched at :1779 by
//   `_dw2_q_impl`), the dW of `conv_bn_fused_q` under
//   model.conv_act_store=int8 (kDwQ): e = round(dy + ds1 + 2 * deq(y) *
//   ds2) from the int8 y (deq in f32, not rounded, :1713-1715), t from x as
//   kDwFused stages it or, in the XQ mode, t = round(relu(deq(xq) * a + b))
//   from the int8 x, computed in f32 and rounded once (:1690-1696). Bound
//   by bytes as kDwFused, with y (and x in the XQ mode) read as one byte an
//   element.

#include "conv3x3_dw_body.cuh"

namespace cltorch {
namespace {

// The kernels: one instance of each body per KIND, named for the profile
// families (conv3x3_dw*: the packed body's; conv3x3_q_*: the int8 conv's).
#define CLTORCH_DW_PARAMS(T)                                                              \
  const T *__restrict__ x, const float *__restrict__ pa, const float *__restrict__ pb,   \
      const T *__restrict__ dy, const T *__restrict__ y, const float *__restrict__ s1,    \
      const float *__restrict__ s2, float *__restrict__ partials, int B, int H, int W,    \
      int Cin, int Cout, int prologue, const QArgs qa, int ew_bf16
#define CLTORCH_DW_ARGS \
  x, pa, pb, dy, y, s1, s2, partials, B, H, W, Cin, Cout, prologue, qa, ew_bf16

// The ring kernel takes TMA maps of x, dy and y (read with CI_T >= 32 only).
template <int CI_T, int CO_T>
__global__ void __launch_bounds__(RingTile<CI_T, CO_T>::kThreads, RingTile<CI_T, CO_T>::kMinBlocks)
    conv3x3_dw_ring_kernel(CLTORCH_DW_PARAMS(bf16), const __grid_constant__ CUtensorMap tm_x,
                           const __grid_constant__ CUtensorMap tm_dy,
                           const __grid_constant__ CUtensorMap tm_y) {
  dw_ring_body<kDwFused, CI_T, CO_T>(x, pa, pb, dy, y, s1, s2, partials, B, H, W, Cin, Cout,
                                     prologue, &tm_x, &tm_dy, &tm_y, ew_bf16);
}
__global__ void __launch_bounds__(kDwThreads) conv3x3_q_dw_mma_kernel(CLTORCH_DW_PARAMS(bf16)) {
  dw_mma_body<kDwQ>(CLTORCH_DW_ARGS);
}
__global__ void __launch_bounds__(kDwfThreads) conv3x3_dw_fma_kernel(CLTORCH_DW_PARAMS(float)) {
  dw_fma_body<kDwFused>(CLTORCH_DW_ARGS);
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

// Launches the first bodies' dW kernel of the type and KIND (bf16 kDwFused
// runs the ring body, below), then the fixed-order sum of its partials.
template <int KIND>
int dw_launch(const void* x, const void* a, const void* b, const void* dy, const void* y,
              const void* s1, const void* s2, void* partials, void* dw, int B, int H, int W,
              int Cin, int Cout, int prologue, int splits, int is_bf16, cudaStream_t st,
              QArgs qa = QArgs{}, int ew_bf16 = 0) {
  const dim3 grid((Cin + kDwC - 1) / kDwC, (Cout + kDwC - 1) / kDwC, splits);
  const float *fa = static_cast<const float*>(a), *fb = static_cast<const float*>(b);
  const float *f1 = static_cast<const float*>(s1), *f2 = static_cast<const float*>(s2);
  float* part = static_cast<float*>(partials);
  if (is_bf16) {
    if constexpr (KIND == kDwFused) {
      return (int)cudaErrorInvalidValue;
    } else {
      const bf16 *xb = static_cast<const bf16*>(x), *dyb = static_cast<const bf16*>(dy),
                 *yb = static_cast<const bf16*>(y);
      conv3x3_q_dw_mma_kernel<<<grid, kDwThreads, 0, st>>>(xb, fa, fb, dyb, yb, f1, f2, part, B,
                                                           H, W, Cin, Cout, prologue, qa,
                                                           ew_bf16);
    }
  } else {
    const float *xf = static_cast<const float*>(x), *dyf = static_cast<const float*>(dy),
                *yf = static_cast<const float*>(y);
    auto kernel = KIND == kDwFused ? conv3x3_dw_fma_kernel : conv3x3_q_dw_fma_kernel;
    kernel<<<grid, kDwfThreads, 0, st>>>(xf, fa, fb, dyf, yf, f1, f2, part, B, H, W, Cin, Cout,
                                         prologue, qa, 0);
  }
  return sum_dw_splits(part, dw, splits, Cin, Cout, st);
}

}  // namespace
}  // namespace cltorch

extern "C" {

// #36. bf16 runs the ring body with the (ci_t, co_t) tile; f32 the FMA
// body (ci_t, co_t unread). `ew_bf16` (bf16): t and e with the bf16 chains
// (CL_TPU_E_BF16); the same for #39 below.
int cltorch_conv3x3_bn_dw(const void* x, const void* a, const void* b, const void* dy,
                          const void* y, const void* s1, const void* s2, void* partials,
                          void* dw, int B, int H, int W, int Cin, int Cout, int prologue,
                          int splits, int ci_t, int co_t, int is_bf16, int ew_bf16,
                          void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return cltorch::dw_launch<cltorch::kDwFused>(x, a, b, dy, y, s1, s2, partials, dw, B, H,
                                                 W, Cin, Cout, prologue, splits, 0, st);
  using namespace cltorch;
  const bf16 *xb = static_cast<const bf16*>(x), *dyb = static_cast<const bf16*>(dy),
             *yb = static_cast<const bf16*>(y);
  const float *fa = static_cast<const float*>(a), *fb = static_cast<const float*>(b);
  const float *f1 = static_cast<const float*>(s1), *f2 = static_cast<const float*>(s2);
#define CLTORCH_RING_LAUNCH(CI, CO)                                                                \
  dw_ring_run<CI, CO>(                                                                             \
      kernel_ptr(conv3x3_dw_ring_kernel<CI, CO>),                                                  \
      [&](dim3 grid, int threads, int smem, float* out, const CUtensorMap* tm) {                   \
        conv3x3_dw_ring_kernel<CI, CO><<<grid, threads, smem, st>>>(                               \
            xb, fa, fb, dyb, yb, f1, f2, out, B, H, W, Cin, Cout, prologue, QArgs{}, ew_bf16,   \
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

// #39: the dW from int8 saved activations: y as yq [B, H, W, Cout] with
// scales ysc [B, H, pack, Cout]; x [B, H, W, Cin] or, when xq is given,
// xq [B, H, W, Cin] with scales xsc [B, H, pack, Cin] (x then unread).
int cltorch_conv3x3_bn_dw_q(const void* x, const void* xq, const void* xsc, const void* a,
                            const void* b, const void* dy, const void* yq, const void* ysc,
                            const void* s1, const void* s2, void* partials, void* dw, int B,
                            int H, int W, int Cin, int Cout, int prologue, int pack, int splits,
                            int is_bf16, int ew_bf16, void* stream) {
  const cltorch::QArgs qa{static_cast<const int8_t*>(yq), static_cast<const float*>(ysc),
                          static_cast<const int8_t*>(xq), static_cast<const float*>(xsc), pack};
  return cltorch::dw_launch<cltorch::kDwQ>(x, a, b, dy, nullptr, s1, s2, partials, dw, B, H, W,
                                           Cin, Cout, prologue, splits, is_bf16,
                                           static_cast<cudaStream_t>(stream), qa, ew_bf16);
}

}  // extern "C"
