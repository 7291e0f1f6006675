// #39: the packed conv's weight gradient from the int8 saved activations of
// model.conv_act_store=int8.
//
// Replaces the TPU kernel cl_tpu/pallas/conv3x3_v3.py::_dw2_q_kernel
// (launched at conv3x3_v3.py:1779 by `_dw2_q_impl`, body :1676-1717), the
// dW of `conv_bn_fused_q`'s fused branch:
//
//   e = round(dy + ds1 + 2 * deq(y) * ds2) from the int8 y (deq in f32, not
//       rounded, :1713-1715), or dy without stats cotangents
//   t = round(relu(x * a + b)) (prologue) or x, from x as the dtype route's
//       dW (#36) forms it, or in the xq mode t = round(relu(deq(xq) * a +
//       b)) from the int8 x, computed in f32 and rounded once (:1690-1696)
//   dW[co, ci, ky, kx] = sum over pixels p of e[p, co] * t[p + (ky-1, kx-1), ci]
//
// in f32, rounded once to the compute type by the wrapper. What bounds it
// on the H100 (bf16, batch 8, the 15 launches of a headline int8 step,
// chip_smoke.q_bytes_ops): bytes at the 512^2 and 256^2 levels (dy, the
// int8 y and x read once), the tensor cores at 128^2; 0.86 ms a step.
//
// * bf16 runs #36's ring body (conv3x3_dw_body.cuh::dw_ring_body, kDwQ):
//   a ring of three stages (the products of pixel tile k, the transform of
//   k + 1, the copies of k + 2), one wave of resident blocks, the channel
//   tile fitted to the shape (wgmma on 64 x 64, mma.sync with ldmatrix.trans
//   elsewhere), fixed-order partials. What the int8 route adds: each stage
//   copies the int8 y tile and its rows' scales by TMA, and e is formed in
//   place in the dy tile once per element; in the xq mode the int8 x window
//   and its scales land in one of two raw slots and t is formed from them
//   into the stage's x window. The 16-wide tiles (the stem, and widths that
//   are not a multiple of 16) form e and t by plain loads as they copy.
// * f32 runs the register-blocked FMA body (dw_reg_body, kDwQ; #33's, #41's
//   and #31's f32 body): 48 FMAs for two 16-byte shared loads, a three-stage
//   cp.async ring, dy, the int8 y and x and their scales copied by cp.async
//   into the stage and its raw slot, e and t formed in f32 once per element.
//
// Against the first bodies (dw_mma_body, dw_fma_body) at a 5q-a step's 15
// launches (kernel_ab, card sleep, H100 SXM at 700 W; PERF.md §6): bf16
// 5.1865 -> 2.6259 ms (cuDNN's dW 2.4891, #36's ring on the same shapes
// 2.3939), f32 35.4135 -> 14.1997 (cuDNN's f32 18.8506); every shape
// faster. Registers (kernel_ab --ptxas / cudaFuncGetAttributes): the ring
// 96 (152 on the 64 x 64 wgmma tile, 143 at 64 x 32), the register-blocked
// body 126 at CO_T 64 and 96 at 32 (12 bytes spilled there, 16 local,
// under three blocks an SM); nothing else spilled.
//
// The tile and the splits come from the wrapper (kernels/conv3x3.py::
// dw_q_tile_splits), which mirrors the bodies' resources at the launch's
// pack; the launcher recomputes the shared memory and refuses what does
// not fit. One split writes dW itself; more are summed in a fixed order (no
// float atomics: a relaunch repeats every bit).

#include "conv3x3_dw_body.cuh"

namespace cltorch {
namespace {

// Named for the int8 conv's profile family (conv3x3_q_*).
template <int CI_T, int CO_T>
__global__ void __launch_bounds__(RingTile<CI_T, CO_T>::kThreads, RingTile<CI_T, CO_T>::kMinBlocks)
    conv3x3_q_dw_ring_kernel(const bf16* __restrict__ x, const float* __restrict__ pa,
                             const float* __restrict__ pb, const bf16* __restrict__ dy,
                             const float* __restrict__ s1, const float* __restrict__ s2,
                             float* __restrict__ out, int B, int H, int W, int Cin, int Cout,
                             int prologue, int ew_bf16, const QArgs qa,
                             const __grid_constant__ CUtensorMap tm_x,
                             const __grid_constant__ CUtensorMap tm_dy,
                             const __grid_constant__ CUtensorMap tm_y,
                             const __grid_constant__ CUtensorMap tm_ys,
                             const __grid_constant__ CUtensorMap tm_xs) {
  dw_ring_body<kDwQ, CI_T, CO_T>(x, pa, pb, dy, nullptr, s1, s2, out, B, H, W, Cin, Cout,
                                 prologue, &tm_x, &tm_dy, &tm_y, ew_bf16, qa, &tm_ys, &tm_xs);
}

template <int CO_T>
__global__ void __launch_bounds__(RegTile<CO_T>::kThreads, RegTile<CO_T>::kMinBlocks)
    conv3x3_q_dw_reg_kernel(const float* __restrict__ x, const float* __restrict__ pa,
                            const float* __restrict__ pb, const float* __restrict__ dy,
                            const float* __restrict__ s1, const float* __restrict__ s2,
                            float* __restrict__ out, int B, int H, int W, int Cin, int Cout,
                            int prologue, const QArgs qa) {
  dw_reg_body<kDwQ, CO_T>(x, pa, pb, dy, out, B, H, W, Cin, Cout, prologue, s1, s2, qa);
}

// The bf16 ring instance's launch (its maps: x or the int8 x, dy, the int8
// y, the y's and x's scales), then the sum of its partials.
template <int CI_T, int CO_T>
int q_ring_run(const bf16* x, const float* pa, const float* pb, const bf16* dy, const float* s1,
               const float* s2, const QArgs& qa, void* partials, void* dw, int B, int H, int W,
               int Cin, int Cout, int prologue, int splits, int ew_bf16, cudaStream_t st) {
  using Tile = RingTile<CI_T, CO_T>;
  const bool xq = qa.xq != nullptr;
  const int smem = dw_ring_smem<CI_T, CO_T>(true, xq, qa.pack);
  if (smem > kSmemMax || qa.pack < 1 || splits < 1 || (!xq && x == nullptr) ||
      (Tile::kTma && ((Cout & 15) || (xq && (Cin & 15)))))
    return (int)cudaErrorInvalidValue;
  const void* kernel = kernel_ptr(conv3x3_q_dw_ring_kernel<CI_T, CO_T>);
  cudaError_t err = smem_allowed(kernel, kSmemMax);  // the most: the bytes follow pack
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tms[5] = {};
  if constexpr (Tile::kTma) {
    if ((err = xq ? tm_nhwc_i8(&tms[0], qa.xq, B, H, W, Cin, CI_T, kWinW, kRingWinH)
                  : tm_nhwc(&tms[0], x, B, H, W, Cin, CI_T, kWinW, kRingWinH)) != cudaSuccess ||
        (err = tm_nhwc(&tms[1], dy, B, H, W, Cout, CO_T, kTW, kRingTH)) != cudaSuccess ||
        (s1 != nullptr &&
         ((err = tm_nhwc_i8(&tms[2], qa.yq, B, H, W, Cout, CO_T, kTW, kRingTH)) != cudaSuccess ||
          (err = tm_scales(&tms[3], qa.ysc, B, H, qa.pack, Cout, CO_T, kRingTH)) !=
              cudaSuccess)) ||
        (xq && (err = tm_scales(&tms[4], qa.xsc, B, H, qa.pack, Cin, CI_T, kRingWinH)) !=
                   cudaSuccess))
      return (int)err;
  }
  const dim3 grid((Cin + CI_T - 1) / CI_T, (Cout + CO_T - 1) / CO_T, splits);
  conv3x3_q_dw_ring_kernel<CI_T, CO_T><<<grid, Tile::kThreads, smem, st>>>(
      x, pa, pb, dy, s1, s2, dw_out(partials, dw, splits), B, H, W, Cin, Cout, prologue, ew_bf16,
      qa, tms[0], tms[1], tms[2], tms[3], tms[4]);
  return sum_dw_splits<true>(static_cast<float*>(partials), dw, splits, Cin, Cout, st);
}

// The f32 register-blocked instance's launch, then the sum of its partials.
template <int CO_T>
int q_reg_run(const float* x, const float* pa, const float* pb, const float* dy, const float* s1,
              const float* s2, const QArgs& qa, void* partials, void* dw, int B, int H, int W,
              int Cin, int Cout, int prologue, int splits, cudaStream_t st) {
  const int smem = dw_reg_smem<CO_T>(true, qa.xq != nullptr, qa.pack);
  if (smem > kSmemMax || qa.pack < 1 || splits < 1 || (qa.xq == nullptr && x == nullptr))
    return (int)cudaErrorInvalidValue;
  const void* kernel = kernel_ptr(conv3x3_q_dw_reg_kernel<CO_T>);
  const cudaError_t err = smem_allowed(kernel, kSmemMax);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Cin + kRegCiT - 1) / kRegCiT, (Cout + CO_T - 1) / CO_T, splits);
  conv3x3_q_dw_reg_kernel<CO_T><<<grid, RegTile<CO_T>::kThreads, smem, st>>>(
      x, pa, pb, dy, s1, s2, dw_out(partials, dw, splits), B, H, W, Cin, Cout, prologue, qa);
  return sum_dw_splits<true>(static_cast<float*>(partials), dw, splits, Cin, Cout, st);
}

}  // namespace
}  // namespace cltorch

// Plain C interface, loaded with ctypes; returns cudaGetLastError(). The
// wrapper (cl_tpu_torch/kernels/conv3x3.py::launch_conv_dw_q) checks the
// operands.
extern "C" {

// #39: y as yq [B, H, W, Cout] with scales ysc [B, H, pack, Cout]; x
// [B, H, W, Cin] or, when xq is given, xq [B, H, W, Cin] with scales xsc
// [B, H, pack, Cin] (x then unread); dy [B, H, W, Cout] of the compute
// type; a, b f32 [Cin] (read with `prologue`), s1, s2 f32 [Cout] or null
// (e = dy); `partials` holds splits * Cout * Cin * 9 floats, dw is f32
// [Cout, Cin, 3, 3]. The bf16 ring instance (ci_t, co_t) or the f32
// register-blocked one (ci_t = 32, co_t), as kernels/conv3x3.py::
// dw_q_tile_splits picks them; `ew_bf16` (bf16, x given): the prologue's
// bf16 chain (CL_TPU_E_BF16).
int cltorch_conv3x3_bn_dw_q(const void* x, const void* xq, const void* xsc, const void* a,
                            const void* b, const void* dy, const void* yq, const void* ysc,
                            const void* s1, const void* s2, void* partials, void* dw, int B,
                            int H, int W, int Cin, int Cout, int prologue, int pack, int splits,
                            int ci_t, int co_t, int is_bf16, int ew_bf16, void* stream) {
  using namespace cltorch;
  const QArgs qa{static_cast<const int8_t*>(yq), static_cast<const float*>(ysc),
                 static_cast<const int8_t*>(xq), static_cast<const float*>(xsc), pack};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *fa = static_cast<const float*>(a), *fb = static_cast<const float*>(b);
  const float *f1 = static_cast<const float*>(s1), *f2 = static_cast<const float*>(s2);
  if (!is_bf16) {
    const float *xf = static_cast<const float*>(x), *dyf = static_cast<const float*>(dy);
#define CLTORCH_Q_REG_LAUNCH(CO) \
  q_reg_run<CO>(xf, fa, fb, dyf, f1, f2, qa, partials, dw, B, H, W, Cin, Cout, prologue, splits, st)
    CLTORCH_REG_DISPATCH(CLTORCH_Q_REG_LAUNCH)
#undef CLTORCH_Q_REG_LAUNCH
  }
  const bf16 *xb = static_cast<const bf16*>(x), *dyb = static_cast<const bf16*>(dy);
#define CLTORCH_Q_RING_LAUNCH(CI, CO)                                                          \
  q_ring_run<CI, CO>(xb, fa, fb, dyb, f1, f2, qa, partials, dw, B, H, W, Cin, Cout, prologue, \
                     splits, ew_bf16, st)
  CLTORCH_RING_DISPATCH(CLTORCH_Q_RING_LAUNCH)
#undef CLTORCH_Q_RING_LAUNCH
}

// #39's instance (ci_t, co_t) of the type on this card at a launch's
// shared bytes (xq: the xq mode's raw slots; pack: the scales' column
// groups): out[4] = {resident blocks an SM, registers a thread, local
// (spilled) bytes a thread, dynamic shared bytes a block}.
int cltorch_conv3x3_dw_q_info(int ci_t, int co_t, int is_bf16, int xq, int pack, int* out) {
  using namespace cltorch;
  if (is_bf16) {
#define CLTORCH_Q_RING_INFO(CI, CO)                                                            \
  (smem_allowed(kernel_ptr(conv3x3_q_dw_ring_kernel<CI, CO>), kSmemMax) != cudaSuccess         \
       ? (int)cudaErrorInvalidValue                                                            \
       : kernel_info(kernel_ptr(conv3x3_q_dw_ring_kernel<CI, CO>), RingTile<CI, CO>::kThreads, \
                     dw_ring_smem<CI, CO>(true, xq != 0, pack), out))
    CLTORCH_RING_DISPATCH(CLTORCH_Q_RING_INFO)
#undef CLTORCH_Q_RING_INFO
  }
#define CLTORCH_Q_REG_INFO(CO)                                                       \
  (smem_allowed(kernel_ptr(conv3x3_q_dw_reg_kernel<CO>), kSmemMax) != cudaSuccess    \
       ? (int)cudaErrorInvalidValue                                                  \
       : kernel_info(kernel_ptr(conv3x3_q_dw_reg_kernel<CO>), RegTile<CO>::kThreads, \
                     dw_reg_smem<CO>(true, xq != 0, pack), out))
  CLTORCH_REG_DISPATCH(CLTORCH_Q_REG_INFO)
#undef CLTORCH_Q_REG_INFO
}

}  // extern "C"
