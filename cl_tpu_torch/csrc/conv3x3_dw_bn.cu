// The two-pass backward's weight gradient (#33), redesigned for the H100.
//
// Replaces the TPU kernel cl_tpu/pallas/conv3x3_v3.py::_dw_bn_kernel
// (launched at conv3x3_v3.py:870 by `_dw_bn_impl`), the dW of the two-pass
// branch of `conv_bn_fused`'s VJP (:966):
//
//   t = round(relu(x * a + b)) (prologue) or x, recomputed while staging
//   dW[co, ci, ky, kx] = sum over pixels p of e[p, co] * t[p + (ky-1, kx-1), ci]
//
// in f32, not rounded here (the VJP rounds it once to the compute type),
// where e is the MATERIALIZED dy_eff, already rounded to the dtype: it is
// read as it is, never formed again (kDwBn: no y, no stats). Under
// CL_TPU_E_BF16 the bf16 prologue is the bf16 chain (`ew_bf16`).
//
// What bounds it on the H100 at its path's shape, 64^2 x 256 -> 256,
// batch 8 (the two-pass convs of level 2 under model.packed_min_size=0 in
// f32, of level 3 at a 22 MiB conv budget in bf16): 38.7 GFLOP, 577 us at
// the f32 FMA peak of 67 TFLOP/s against 36 MB of bytes (f32: operations);
// in bf16 39 us on the tensor cores against 36 MB, 11 us (operations).
//
// * bf16 runs the ring body (conv3x3_dw_body.cuh::dw_ring_body, kDwBn):
//   TMA (cp.async for narrow and odd widths) into a ring of three stages,
//   t formed once per element in place, the e tile read as it lands, wgmma
//   on the 64 x 64 tile and mma.sync on the others, one wave of resident
//   blocks; the first body it replaces (dw_mma_body) ran at 9.8x its bound
//   here (0.3823 ms against 0.0391).
// * f32 runs the register-blocked FMA body (dw_reg_body, kDwBn): 48 FMAs
//   for two 16-byte shared loads, a 32 x 64 channel tile, a three-stage
//   cp.async ring, the prologue formed once per element with the rounded
//   ops; the first FMA body (dw_fma_body) ran at 4.35x its bound here.
// The tile and the splits come from the wrapper
// (kernels/conv3x3.py::dw_tile_splits: dw_ring_tile / dw_ring_splits in
// bf16, dw_fma_tile / dw_fma_splits in f32), which mirror the bodies'
// resources.

#include "conv3x3_dw_body.cuh"

namespace cltorch {
namespace {

// Named for the gen-3 conv's profile family (conv3x3_v3*).
template <int CI_T, int CO_T>
__global__ void __launch_bounds__(RingTile<CI_T, CO_T>::kThreads, RingTile<CI_T, CO_T>::kMinBlocks)
    conv3x3_v3_dw_bn_ring_kernel(const bf16* __restrict__ x, const float* __restrict__ pa,
                                 const float* __restrict__ pb, const bf16* __restrict__ e,
                                 float* __restrict__ out, int B, int H, int W, int Cin,
                                 int Cout, int prologue, int ew_bf16,
                                 const __grid_constant__ CUtensorMap tm_x,
                                 const __grid_constant__ CUtensorMap tm_e) {
  dw_ring_body<kDwBn, CI_T, CO_T>(x, pa, pb, e, nullptr, nullptr, nullptr, out, B, H, W, Cin,
                                  Cout, prologue, &tm_x, &tm_e, nullptr, ew_bf16);
}

template <int CO_T>
__global__ void __launch_bounds__(RegTile<CO_T>::kThreads, RegTile<CO_T>::kMinBlocks)
    conv3x3_v3_dw_bn_reg_kernel(const float* __restrict__ x, const float* __restrict__ pa,
                                const float* __restrict__ pb, const float* __restrict__ e,
                                float* __restrict__ out, int B, int H, int W, int Cin, int Cout,
                                int prologue) {
  dw_reg_body<kDwBn, CO_T>(x, pa, pb, e, out, B, H, W, Cin, Cout, prologue);
}

}  // namespace
}  // namespace cltorch

// Plain C interface, loaded with ctypes; returns cudaGetLastError(). The
// wrapper (cl_tpu_torch/kernels/conv3x3.py::launch_conv3x3_dw_bn) checks
// the operands: x [B, H, W, Cin] and e [B, H, W, Cout], contiguous,
// 16-byte aligned, of one type; a, b f32 [Cin] (read only with `prologue`);
// `partials` holds splits * Cout * Cin * 9 floats; dw is f32
// [Cout, Cin, 3, 3].
extern "C" {

// #33: the ring instance (ci_t, co_t) in bf16 (`ew_bf16`: the prologue's
// bf16 chain), the register-blocked one (ci_t = 32, co_t) in f32.
int cltorch_conv3x3_dw_bn(const void* x, const void* a, const void* b, const void* e,
                          void* partials, void* dw, int B, int H, int W, int Cin, int Cout,
                          int prologue, int splits, int ci_t, int co_t, int is_bf16,
                          int ew_bf16, void* stream) {
  using namespace cltorch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *fa = static_cast<const float*>(a), *fb = static_cast<const float*>(b);
  if (is_bf16) {
    const bf16 *xb = static_cast<const bf16*>(x), *eb = static_cast<const bf16*>(e);
#define CLTORCH_RING_LAUNCH(CI, CO)                                                                \
  dw_ring_run<CI, CO>(                                                                             \
      kernel_ptr(conv3x3_v3_dw_bn_ring_kernel<CI, CO>),                                            \
      [&](dim3 grid, int threads, int smem, float* out, const CUtensorMap* tm) {                   \
        conv3x3_v3_dw_bn_ring_kernel<CI, CO><<<grid, threads, smem, st>>>(                         \
            xb, fa, fb, eb, out, B, H, W, Cin, Cout, prologue, ew_bf16, tm[0], tm[1]);             \
      },                                                                                           \
      x, e, nullptr, partials, dw, B, H, W, Cin, Cout, splits, st)
    CLTORCH_RING_DISPATCH(CLTORCH_RING_LAUNCH)
#undef CLTORCH_RING_LAUNCH
  }
  const float *xf = static_cast<const float*>(x), *ef = static_cast<const float*>(e);
#define CLTORCH_REG_LAUNCH(CO)                                                                     \
  dw_reg_run<CO>(                                                                                  \
      kernel_ptr(conv3x3_v3_dw_bn_reg_kernel<CO>),                                                 \
      [&](dim3 grid, int threads, int smem, float* out) {                                          \
        conv3x3_v3_dw_bn_reg_kernel<CO><<<grid, threads, smem, st>>>(xf, fa, fb, ef, out, B, H,    \
                                                                     W, Cin, Cout, prologue);      \
      },                                                                                           \
      partials, dw, Cin, Cout, splits, st)
  CLTORCH_REG_DISPATCH(CLTORCH_REG_LAUNCH)
#undef CLTORCH_REG_LAUNCH
}

// What the card gives #33's instance (ci_t, co_t) of the type: out[4] =
// {resident blocks an SM, registers a thread, local bytes a thread,
// dynamic shared bytes a block}.
int cltorch_conv3x3_dw_bn_info(int ci_t, int co_t, int is_bf16, int* out) {
  using namespace cltorch;
  if (is_bf16) {
#define CLTORCH_RING_INFO(CI, CO)                                                                  \
  kernel_info(kernel_ptr(conv3x3_v3_dw_bn_ring_kernel<CI, CO>),                                    \
              RingTile<CI, CO>::kThreads, RingTile<CI, CO>::kSmem, out)
    CLTORCH_RING_DISPATCH(CLTORCH_RING_INFO)
#undef CLTORCH_RING_INFO
  }
#define CLTORCH_REG_INFO(CO)                                                                       \
  kernel_info(kernel_ptr(conv3x3_v3_dw_bn_reg_kernel<CO>),                                         \
              RegTile<CO>::kThreads, RegTile<CO>::kSmem, out)
  CLTORCH_REG_DISPATCH(CLTORCH_REG_INFO)
#undef CLTORCH_REG_INFO
}

}  // extern "C"
