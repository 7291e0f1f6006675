// The gen-2 3x3 SAME conv of model.conv_impl=pallas|hybrid over NHWC: its
// forward (also its dx) and its weight gradient.
//
// Replaces the TPU kernels of cl_tpu/pallas/conv3x3.py:
// * #40 ::_fwd_kernel (launched at conv3x3.py:279 by `_conv_fwd_impl`, body
//   :226-242): y = round(conv3x3_SAME(x, w)), one f32 accumulator rounded
//   once to x's type (:242). The forward of `conv3x3` under
//   model.conv_impl=pallas and, in its VJP, the dx: the same conv on dy
//   (cast to x's type) with the weight flipped in space and its channels
//   swapped (:340-344).
// * #41 ::_dw_kernel (launched at :309 by `_conv_dw_impl`, body :245-267):
//   dW[co, ci, ky, kx] = sum over pixels p of dy[p, co] * x[p + (ky-1,
//   kx-1), ci] in f32, not rounded here (the VJP rounds it once to the
//   compute type, :345 under pallas, :408 under hybrid). The only gen-2
//   kernel conv_impl=hybrid runs.
//
// The TPU kernels' lane packing (P output columns per 128-lane group, the
// packed weight W' = pack_weights(w, p), :133-141), their lane-offset piece
// DMAs of the padded flat rows (_pad_input, :170-185) and the dW's fold over
// j (_fold_dw, :144-153, in f32) are layout devices of the TPU: each output
// is still one f32 sum of its 9 * Cin products (dW: of its pixels' products)
// rounded once, in another order. So these are the plain conv's and plain
// dW's arithmetic, and the kernels here are instances of the conv bodies,
// with MODE kPlain (conv3x3_body.cuh, as the gen-3 plain conv #30) and KIND
// kDwPlain (conv3x3_dw_body.cuh), under names of their own (conv3x3_g2_*:
// a profile family of their own):
// * forward: f32 on FMAs (128 threads, a 16 x 16 pixel tile for 32 output
//   channels; TF32 would round the products), bf16 on mma.sync m16n8k16
//   (256 threads, 32 or 64 output channels). The input channels are walked
//   in chunks of 16 staged in shared memory, so the block's footprint does
//   not grow with the channels (39 KB f32, at most 47 KB bf16, at 1024 -> 1024
//   as at 32 -> 32), with zeros past Cin or Cout and outside the image.
// * dW (redesigned for the H100): a block per channel tile of all nine
//   taps, the pixel tiles split over gridDim.z blocks, one wave of resident
//   blocks; each block writes its own partial dW, which sum_splits_kernel
//   sums over the blocks in a fixed order (one split is written to dW
//   itself). No float atomics: a relaunch repeats every bit. bf16 runs the
//   ring body (dw_ring_body, kDwPlain: TMA or cp.async into three stages,
//   x and dy read as they land, wgmma on the 64 x 64 tile, mma.sync on the
//   others; tile and splits from kernels/conv3x3.py::dw_ring_tile /
//   dw_ring_splits); f32 the register-blocked FMA body (dw_reg_body: 48
//   FMAs for two 16-byte shared loads, a 32 x 64 or 32 x 32 channel tile, a
//   three-stage cp.async ring; dw_fma_tile / dw_fma_splits). The first
//   bodies they replace ran at 6.3x (bf16, 256^2 x 64 -> 64: 0.2519 ms
//   against 0.0401) and 3.3x (f32: 1.8824 against 0.5769) their bounds.
//
// What bounds it on the H100: at baseline_2's 256^2 x 64 -> 64 (batch 8,
// f32) 38.7 GFLOP, 577 us at the f32 FMA peak of 67 TFLOP/s, against 268 MB
// of input and output, 80 us at 3.35 TB/s: operations. At the 512^2 x
// 32 -> 32 standard body in bf16: 38.7 GFLOP, 39 us on the tensor cores,
// against 268 MB, 80 us: bytes.

#include "conv3x3_body.cuh"
#include "conv3x3_dw_body.cuh"

namespace cltorch {
namespace {

__global__ void __launch_bounds__(kConvThreads) conv3x3_g2_kernel(ConvArgs<float> p) {
  conv3x3_fma_body<kPlain>(p);
}

template <int COT>
__global__ void __launch_bounds__(kMmaThreads) conv3x3_g2_mma_kernel(ConvArgs<bf16> p) {
  conv3x3_mma_body<kPlain, COT>(p);
}

template <int CI_T, int CO_T>
__global__ void __launch_bounds__(RingTile<CI_T, CO_T>::kThreads, RingTile<CI_T, CO_T>::kMinBlocks)
    conv3x3_g2_dw_ring_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                              float* __restrict__ out, int B, int H, int W, int Cin, int Cout,
                              const __grid_constant__ CUtensorMap tm_x,
                              const __grid_constant__ CUtensorMap tm_dy) {
  dw_ring_body<kDwPlain, CI_T, CO_T>(x, nullptr, nullptr, dy, nullptr, nullptr, nullptr, out, B,
                                     H, W, Cin, Cout, 0, &tm_x, &tm_dy, nullptr, 0);
}

template <int CO_T>
__global__ void __launch_bounds__(RegTile<CO_T>::kThreads, RegTile<CO_T>::kMinBlocks)
    conv3x3_g2_dw_reg_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                             float* __restrict__ out, int B, int H, int W, int Cin, int Cout) {
  dw_reg_body<kDwPlain, CO_T>(x, nullptr, nullptr, dy, out, B, H, W, Cin, Cout, 0);
}

}  // namespace
}  // namespace cltorch

// Plain C interface, loaded with ctypes; each returns cudaGetLastError().
// The wrapper (cl_tpu_torch/kernels/conv3x3_g2.py) checks the operands:
// NHWC tensors contiguous, 16-byte aligned and of one type (f32 or bf16).
extern "C" {

// #40: x [B, H, W, Cin] -> y [B, H, W, Cout]; w [3, 3, Cout, Cin] for bf16
// and [Cin, 3, 3, Cout] for f32 (for the dx: the flipped, channel-swapped
// weight, dy in and dx out).
int cltorch_conv3x3_g2_fwd(const void* x, const void* w, void* y, int B, int H, int W, int Cin,
                           int Cout, int is_bf16, void* stream) {
  using namespace cltorch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
  if (!is_bf16) {
    conv3x3_g2_kernel<<<dim3(tiles, (Cout + kCoT - 1) / kCoT, B), kConvThreads, 0, st>>>(
        conv_args<float>(x, nullptr, nullptr, nullptr, w, nullptr, nullptr, nullptr, y,
                         nullptr, H, W, Cin, Cout, 0));
  } else if (Cout % 64 == 0) {
    conv3x3_g2_mma_kernel<64><<<dim3(tiles, Cout / 64, B), kMmaThreads, 0, st>>>(
        conv_args<bf16>(x, nullptr, nullptr, nullptr, w, nullptr, nullptr, nullptr, y,
                        nullptr, H, W, Cin, Cout, 0));
  } else {
    conv3x3_g2_mma_kernel<32><<<dim3(tiles, (Cout + 31) / 32, B), kMmaThreads, 0, st>>>(
        conv_args<bf16>(x, nullptr, nullptr, nullptr, w, nullptr, nullptr, nullptr, y,
                        nullptr, H, W, Cin, Cout, 0));
  }
  return (int)cudaGetLastError();
}

// #41: x [B, H, W, Cin], dy [B, H, W, Cout] -> dw f32 [Cout, Cin, 3, 3];
// `partials` holds splits * Cout * Cin * 9 floats. bf16: the ring instance
// (ci_t, co_t); f32: the register-blocked one (ci_t = 32, co_t).
int cltorch_conv3x3_g2_dw(const void* x, const void* dy, void* partials, void* dw, int B, int H,
                          int W, int Cin, int Cout, int splits, int ci_t, int co_t, int is_bf16,
                          void* stream) {
  using namespace cltorch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const bf16 *xb = static_cast<const bf16*>(x), *dyb = static_cast<const bf16*>(dy);
#define CLTORCH_RING_LAUNCH(CI, CO)                                                                \
  dw_ring_run<CI, CO>(                                                                             \
      kernel_ptr(conv3x3_g2_dw_ring_kernel<CI, CO>),                                               \
      [&](dim3 grid, int threads, int smem, float* out, const CUtensorMap* tm) {                   \
        conv3x3_g2_dw_ring_kernel<CI, CO><<<grid, threads, smem, st>>>(xb, dyb, out, B, H, W,      \
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
      kernel_ptr(conv3x3_g2_dw_reg_kernel<CO>),                                                    \
      [&](dim3 grid, int threads, int smem, float* out) {                                          \
        conv3x3_g2_dw_reg_kernel<CO><<<grid, threads, smem, st>>>(xf, dyf, out, B, H, W, Cin,      \
                                                                  Cout);                           \
      },                                                                                           \
      partials, dw, Cin, Cout, splits, st)
  CLTORCH_REG_DISPATCH(CLTORCH_REG_LAUNCH)
#undef CLTORCH_REG_LAUNCH
}

// What the card gives #41's instance (ci_t, co_t) of the type: out[4] =
// {resident blocks an SM, registers a thread, local bytes a thread,
// dynamic shared bytes a block}.
int cltorch_conv3x3_g2_dw_info(int ci_t, int co_t, int is_bf16, int* out) {
  using namespace cltorch;
  if (is_bf16) {
#define CLTORCH_RING_INFO(CI, CO)                                                                  \
  kernel_info(kernel_ptr(conv3x3_g2_dw_ring_kernel<CI, CO>),                                       \
              RingTile<CI, CO>::kThreads, RingTile<CI, CO>::kSmem, out)
    CLTORCH_RING_DISPATCH(CLTORCH_RING_INFO)
#undef CLTORCH_RING_INFO
  }
#define CLTORCH_REG_INFO(CO)                                                                       \
  kernel_info(kernel_ptr(conv3x3_g2_dw_reg_kernel<CO>),                                            \
              RegTile<CO>::kThreads, RegTile<CO>::kSmem, out)
  CLTORCH_REG_DISPATCH(CLTORCH_REG_INFO)
#undef CLTORCH_REG_INFO
}

}  // extern "C"
