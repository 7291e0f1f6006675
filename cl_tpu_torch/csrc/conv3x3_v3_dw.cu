// The plain gen-3 conv's weight gradient (#31), redesigned for the H100.
//
// Replaces the TPU kernel cl_tpu/pallas/conv3x3_v3.py::_dw_kernel
// (launched at conv3x3_v3.py:564 by `_dw_packed`), the dW of `conv3x3` /
// `conv3x3_packed` under model.conv_impl=v3|auto:
//
//   dW[co, ci, ky, kx] = sum over pixels p of dy[p, co] * x[p + (ky-1, kx-1), ci]
//
// in f32, not rounded here (the VJP rounds it once to the compute type,
// :621, :643). t = x and e = dy as given: no prologue, no y, no stats
// (kDwPlain), the function the gen-2 dW (#41, conv3x3_g2.cu) computes, so
// these are #41's bodies under names of the gen-3 conv's profile family
// (conv3x3_v3*), in a translation unit of their own that builds beside the
// others.
//
// What bounds it on the H100 at baseline_2's 256^2 x 64 -> 64, batch 8:
// in f32 38.7 GFLOP, 577 us at the f32 FMA peak of 67 TFLOP/s, against
// 268 MB, 80 us (operations); in bf16 39 us on the tensor cores against
// 134 MB, 40 us (bytes, by a hair).
//
// * bf16 runs the ring body (conv3x3_dw_body.cuh::dw_ring_body): TMA
//   (cp.async for the stem and widths that are not a multiple of 8) into a
//   ring of three stages, x and dy read as they land, wgmma on the 64 x 64
//   tile and mma.sync on the others, one wave of resident blocks whose
//   partials are written a weight row at a time.
// * f32 runs the register-blocked FMA body (dw_reg_body): 48 FMAs for two
//   16-byte shared loads, a 32 x 64 or 32 x 32 channel tile, a three-stage
//   cp.async ring.
// The first bodies they replace (dw_mma_body: synchronous staging, a 32 x 32
// tile re-staged at every chunk, scattered 4-byte partials; dw_fma_body: 3.6
// FMAs a shared load) ran at 6.3x (bf16, 0.2521 ms against 0.0401) and 3.3x
// (f32, 1.8824 ms against 0.5769) the bound at that shape. The tile and the
// splits come from the wrapper (kernels/conv3x3.py::dw_tile_splits:
// dw_ring_tile / dw_ring_splits in bf16, dw_fma_tile / dw_fma_splits in
// f32), which mirror the bodies' resources; one split writes dW itself,
// more are summed in a fixed order (no float atomics: a relaunch repeats
// every bit).

#include "conv3x3_dw_body.cuh"

namespace cltorch {
namespace {

template <int CI_T, int CO_T>
__global__ void __launch_bounds__(RingTile<CI_T, CO_T>::kThreads, RingTile<CI_T, CO_T>::kMinBlocks)
    conv3x3_v3_dw_ring_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                              float* __restrict__ out, int B, int H, int W, int Cin, int Cout,
                              const __grid_constant__ CUtensorMap tm_x,
                              const __grid_constant__ CUtensorMap tm_dy) {
  dw_ring_body<kDwPlain, CI_T, CO_T>(x, nullptr, nullptr, dy, nullptr, nullptr, nullptr, out, B,
                                     H, W, Cin, Cout, 0, &tm_x, &tm_dy, nullptr, 0);
}

template <int CO_T>
__global__ void __launch_bounds__(RegTile<CO_T>::kThreads, RegTile<CO_T>::kMinBlocks)
    conv3x3_v3_dw_reg_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                             float* __restrict__ out, int B, int H, int W, int Cin, int Cout) {
  dw_reg_body<kDwPlain, CO_T>(x, nullptr, nullptr, dy, out, B, H, W, Cin, Cout, 0);
}

}  // namespace
}  // namespace cltorch

// Plain C interface, loaded with ctypes; returns cudaGetLastError(). The
// wrapper (cl_tpu_torch/kernels/conv3x3.py::launch_conv3x3_dw) checks the
// operands: x [B, H, W, Cin] and dy [B, H, W, Cout], contiguous, 16-byte
// aligned, of one type (f32 or bf16); `partials` holds splits * Cout * Cin
// * 9 floats; dw is f32 [Cout, Cin, 3, 3].
extern "C" {

// #31: the ring instance (ci_t, co_t) in bf16, the register-blocked one
// (ci_t = 32, co_t) in f32.
int cltorch_conv3x3_dw(const void* x, const void* dy, void* partials, void* dw, int B, int H,
                       int W, int Cin, int Cout, int splits, int ci_t, int co_t, int is_bf16,
                       void* stream) {
  using namespace cltorch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const bf16 *xb = static_cast<const bf16*>(x), *dyb = static_cast<const bf16*>(dy);
#define CLTORCH_RING_LAUNCH(CI, CO)                                                                \
  dw_ring_run<CI, CO>(                                                                             \
      kernel_ptr(conv3x3_v3_dw_ring_kernel<CI, CO>),                                               \
      [&](dim3 grid, int threads, int smem, float* out, const CUtensorMap* tm) {                   \
        conv3x3_v3_dw_ring_kernel<CI, CO><<<grid, threads, smem, st>>>(xb, dyb, out, B, H, W,      \
                                                                       Cin, Cout, tm[0],           \
                                                                       tm[1]);                     \
      },                                                                                           \
      x, dy, nullptr, partials, dw, B, H, W, Cin, Cout, splits, st)
    CLTORCH_RING_DISPATCH(CLTORCH_RING_LAUNCH)
#undef CLTORCH_RING_LAUNCH
  }
  const float *xf = static_cast<const float*>(x), *dyf = static_cast<const float*>(dy);
#define CLTORCH_REG_LAUNCH(CO)                                                                     \
  dw_reg_run<CO>(                                                                                  \
      kernel_ptr(conv3x3_v3_dw_reg_kernel<CO>),                                                    \
      [&](dim3 grid, int threads, int smem, float* out) {                                          \
        conv3x3_v3_dw_reg_kernel<CO><<<grid, threads, smem, st>>>(xf, dyf, out, B, H, W, Cin,      \
                                                                  Cout);                           \
      },                                                                                           \
      partials, dw, Cin, Cout, splits, st)
  CLTORCH_REG_DISPATCH(CLTORCH_REG_LAUNCH)
#undef CLTORCH_REG_LAUNCH
}

// What the card gives #31's instance (ci_t, co_t) of the type: out[4] =
// {resident blocks an SM, registers a thread, local bytes a thread,
// dynamic shared bytes a block}.
int cltorch_conv3x3_v3_dw_info(int ci_t, int co_t, int is_bf16, int* out) {
  using namespace cltorch;
  if (is_bf16) {
#define CLTORCH_RING_INFO(CI, CO)                                                                  \
  kernel_info(kernel_ptr(conv3x3_v3_dw_ring_kernel<CI, CO>),                                       \
              RingTile<CI, CO>::kThreads, RingTile<CI, CO>::kSmem, out)
    CLTORCH_RING_DISPATCH(CLTORCH_RING_INFO)
#undef CLTORCH_RING_INFO
  }
#define CLTORCH_REG_INFO(CO)                                                                       \
  kernel_info(kernel_ptr(conv3x3_v3_dw_reg_kernel<CO>),                                            \
              RegTile<CO>::kThreads, RegTile<CO>::kSmem, out)
  CLTORCH_REG_DISPATCH(CLTORCH_REG_INFO)
#undef CLTORCH_REG_INFO
}

}  // extern "C"
