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
// dW's arithmetic, and the kernels here are instances of the bodies the
// gen-3 plain conv (#30, #31) runs, with MODE kPlain (conv3x3_body.cuh) and
// KIND kDwPlain (conv3x3_dw_body.cuh), under names of their own
// (conv3x3_g2_*: a profile family of their own):
// * forward: f32 on FMAs (128 threads, a 16 x 16 pixel tile for 32 output
//   channels; TF32 would round the products), bf16 on mma.sync m16n8k16
//   (256 threads, 32 or 64 output channels). The input channels are walked
//   in chunks of 16 staged in shared memory, so the block's footprint does
//   not grow with the channels (39 KB f32, at most 47 KB bf16, at 1024 -> 1024
//   as at 32 -> 32), with zeros past Cin or Cout and outside the image.
// * dW: a block per 32 x 32 (input x output channel) tile of all nine taps,
//   the pixel tiles split over gridDim.z blocks (16 x 16 for bf16 on
//   mma.sync, 16 x 8 for f32 on FMAs); each block writes its own partial
//   dW, which sum_splits_kernel sums over the blocks in a fixed order. No
//   float atomics: a relaunch repeats every bit.
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

__global__ void __launch_bounds__(kDwThreads)
    conv3x3_g2_dw_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                             float* __restrict__ partials, int B, int H, int W, int Cin,
                             int Cout) {
  dw_mma_body<kDwPlain>(x, nullptr, nullptr, dy, nullptr, nullptr, nullptr, partials, B, H, W,
                        Cin, Cout, 0, QArgs{});
}

__global__ void __launch_bounds__(kDwfThreads)
    conv3x3_g2_dw_fma_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                             float* __restrict__ partials, int B, int H, int W, int Cin,
                             int Cout) {
  dw_fma_body<kDwPlain>(x, nullptr, nullptr, dy, nullptr, nullptr, nullptr, partials, B, H, W,
                        Cin, Cout, 0, QArgs{});
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
// `partials` holds splits * Cout * Cin * 9 floats.
int cltorch_conv3x3_g2_dw(const void* x, const void* dy, void* partials, void* dw, int B, int H,
                          int W, int Cin, int Cout, int splits, int is_bf16, void* stream) {
  using namespace cltorch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((Cin + kDwC - 1) / kDwC, (Cout + kDwC - 1) / kDwC, splits);
  float* part = static_cast<float*>(partials);
  if (is_bf16)
    conv3x3_g2_dw_mma_kernel<<<grid, kDwThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(dy), part, B, H, W, Cin, Cout);
  else
    conv3x3_g2_dw_fma_kernel<<<grid, kDwfThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), part, B, H, W, Cin, Cout);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)Cout * Cin * 9;
  sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, splits, n,
                                                                  static_cast<float*>(dw));
  return (int)cudaGetLastError();
}

}  // extern "C"
