// 3x3 SAME conv over NHWC with a BN-ReLU prologue and a batch-stats
// epilogue: the forward and the input gradient (dx).
//
// Replaces the TPU kernels of cl_tpu/pallas/conv3x3_v3.py:
// ::_fwd_bn_kernel (launched at conv3x3_v3.py:833 by `conv_bn_fused`,
// body :710-747) and, from its VJP's fused branch (`_cbf_bwd`, :951-961),
// ::_dx_slim_kernel (:1233) and ::_dx_bn_kernel (:1259, `_dx_bn_impl`).
//
// Forward:
//   t = round(relu(x * a[ci] + b[ci]))   when the prologue is on, else x
//   y = round(conv3x3_SAME(t, w))        f32 accumulation (:384-391)
//   s1[co] = sum of y, s2[co] = sum of y^2, taken from the ROUNDED y
// dx (the conv of e with the flipped, transposed weight, e formed while
// staging, conv3x3_v3.py:1064-1110):
//   e  = round(dy + ds1[co] + 2 * y * ds2[co])  (e = dy without stats
//        cotangents), zero outside the image
//   dt = conv3x3_SAME(e, w_flip^T)       f32 accumulator, not rounded
//   prologue on: u = x * a + b, du = [u > 0] * dt, dx = round(du * a),
//                da = sum of du * x, db = sum of du   (:1082-1088)
//   prologue off: dx = round(dt)
//
// The rounding points are the TPU kernels': t is rounded to the compute
// type before the conv (:686-690), y once after it, and the stats come from
// the stored y (:727-731); e is rounded before the dx conv (:1050-1061),
// and the dx epilogue reads the f32 accumulator. The SAME padding is zero
// in t-space and in e-space (conv3x3_bn.cuh). The TPU kernel's lane packing
// and its stem's channel padding (3 -> 128/p, cl_tpu/models/unet.py:476-485)
// are layout devices: zeros add nothing, and here the input channels are
// walked in chunks of 16 with the tail zero-filled.
//
// What bounds it on the H100 (bf16, batch 8; the bound the larger of the
// bytes each input read once and each output written once at 3.35 TB/s
// and the products at 989 TFLOP/s, chip_smoke.packed_bytes_ops /
// bwd_bytes_ops): bytes at the 512^2 and 256^2 levels (512^2 x 32 -> 32:
// the forward 0.080 ms, #34 0.120, #35 0.160), the tensor cores at 128^2
// (128 -> 128: 38.7 GFLOP, 0.039 ms); in f32 the FMA units (580 us at the
// f32 peak of 67 TFLOP/s at 512^2 x 32 -> 32).
//
// Where each runs: in bf16 the forward and dx (#32, #34/#35) launch the
// ring body (conv3x3_ring.cu, conv3x3_ring_body.cuh, whose note gives the
// per-shape bounds, what held the first body at 4-6x them and what the
// ring does about it, and why the dx's accumulation order is fixed),
// which the wrapper calls directly. Here remain their
// f32 instances of the FMA body, and the first bf16 body
// (conv3x3_body.cuh::conv3x3_mma_body) for the plain conv and the dx from
// int8 below, whose mma_chunk / mma_epilogue order the ring's dx keeps.
//
// Also the plain gen-3 conv, cl_tpu/pallas/conv3x3_v3.py::_fwd_kernel
// (launched at conv3x3_v3.py:522 by `_fwd_packed`): y = round(conv3x3_SAME(x,
// w)), no prologue and no statistics, as the forward of `conv3x3` /
// `conv3x3_packed` under model.conv_impl=v3|auto, as their dx (the same conv
// on dy with the flipped, transposed weight, :619-620, :641-642) and as the
// two-pass backward's dt (:965). Its kernels are the instances
// `conv3x3_v3_kernel` / `conv3x3_v3_mma_kernel` of the bodies below with
// MODE = kPlain: x staged as it is, the accumulator rounded and stored,
// no sums. At baseline_2's 256^2 x 64 -> 64, batch 8, f32 (FMA): 38.7
// GFLOP, 577 us at 67 TFLOP/s, against 268 MB, 80 us.
//
// And the int8 saved activations of model.conv_act_store=int8
// (`conv_bn_fused_q`, conv3x3_v3.py:1800-1870):
// * 32q, the quantizing epilogue of ::_fwd_bn_q_kernel (:757, launched by
//   the same pallas_call as the forward, :833, with emit_q; `_quant_rows`
//   :142-151), here a second kernel, conv3x3_q_quant_kernel, after the
//   forward, which keeps its bits: q and a scale per image row, column mod
//   p and channel (conv3x3_bn.cuh). Bound by bytes: y read, q and the
//   scales written (512^2 x 32 bf16 at batch 8: 201 MB, 60 us).
// * #38, ::_dx_q_kernel (launched at :1657 by `_dx_q_impl`): the dx
//   instances conv3x3_q_dx_kernel / conv3x3_q_dx_mma_kernel of the bodies
//   below with MODE = kDxQ (e from dy and deq(y): the stats term reads
//   deq(y) in f32, not rounded, :1532-1540) or kDxQX (also the epilogue's
//   x as deq(xq) in f32, not rounded, :1577-1579). The int8 y and x halve
//   the dx's reads of them against the compute type's bf16.
//
// Under CL_TPU_DX_PIPE=1, 34p / 35p (::_dx_pipe_slim_kernel and
// ::_dx_pipe_bn_kernel, conv3x3_v3.py:1187, :1179; body `_dx_pipe_body`,
// :1112), which `_dx_bn_impl` launches at the #34/#35 sites (:1233, :1259)
// in their place, are the same dx through a cross-tile software pipeline,
// bit-identical to #34/#35 (tests/tpu/test_dx_pipe.py). The wrapper runs
// them on #34/#35's kernels: in bf16 the ring's dx (conv3x3_ring.cu), whose
// persistent blocks already overlap the next tile's copies with the current
// tile's products, with resident weights; in f32 the FMA instances here,
// which the card ran faster than a cp.async-pipelined FMA kernel at every
// headline shape (1.4-1.6x, kernel_ab).
//
// The first two bodies (FMA for f32, mma.sync for bf16), each templated on
// what it computes, are in conv3x3_body.cuh, shared with the gen-2 conv.

#include "conv3x3_body.cuh"

namespace cltorch {
namespace {

// The f32 dx instances (#34/#35's, which 34p/35p run too, and #38's) at
// four blocks an SM: the blocked sum's fresh accumulator
// (conv3x3_body.cuh::fma_chunk) would take them to 165-168 registers and
// three blocks an SM, slower on the H100 than 128 registers with 20-28
// bytes a thread spilled.
constexpr int kFmaDxMinBlocks = 4;

template <bool DX, typename T>
__global__ void __launch_bounds__(kConvThreads, DX && sizeof(T) == 4 ? kFmaDxMinBlocks : 1)
    conv3x3_bn_kernel(ConvArgs<T> p) {
  conv3x3_fma_body<DX ? kDx : kFwd>(p);
}

template <typename T>
__global__ void __launch_bounds__(kConvThreads) conv3x3_v3_kernel(ConvArgs<T> p) {
  conv3x3_fma_body<kPlain>(p);
}

template <int COT>
__global__ void __launch_bounds__(kMmaThreads) conv3x3_v3_mma_kernel(ConvArgs<bf16> p) {
  conv3x3_mma_body<kPlain, COT>(p);
}

// #38: the dx from the int8 saved y (MODE kDxQ) and x (kDxQX).
template <int MODE, typename T>
__global__ void __launch_bounds__(kConvThreads, sizeof(T) == 4 ? kFmaDxMinBlocks : 1)
    conv3x3_q_dx_kernel(ConvArgs<T> p) {
  conv3x3_fma_body<MODE>(p);
}

template <int MODE, int COT>
__global__ void __launch_bounds__(kMmaThreads) conv3x3_q_dx_mma_kernel(ConvArgs<bf16> p) {
  conv3x3_mma_body<MODE, COT>(p);
}

// Launches the kernel of the type and mode and, when it sums, the
// reduction of its partial rows into out [2, Cout]. The forward and dx take
// f32 only here: in bf16 they run the ring body (conv3x3_ring.cu).
template <int MODE>
int conv3x3_launch(ConvArgs<bf16> pb16, ConvArgs<float> pf32, int is_bf16, int B, void* out,
                   cudaStream_t st) {
  constexpr bool DX = is_dx<MODE>();
  const int H = pf32.H, W = pf32.W, Cout = pf32.Cout;
  const int tiles = ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
  const dim3 grid32(tiles, (Cout + 31) / 32, B);
  const dim3 grid64(tiles, Cout / 64, B);
  if constexpr (MODE == kPlain) {
    if (!is_bf16)
      conv3x3_v3_kernel<float><<<grid32, kConvThreads, 0, st>>>(pf32);
    else if (Cout % 64 == 0)
      conv3x3_v3_mma_kernel<64><<<grid64, kMmaThreads, 0, st>>>(pb16);
    else
      conv3x3_v3_mma_kernel<32><<<grid32, kMmaThreads, 0, st>>>(pb16);
    return (int)cudaGetLastError();
  }
  if constexpr (MODE == kDxQ || MODE == kDxQX) {
    if (!is_bf16)
      conv3x3_q_dx_kernel<MODE, float><<<grid32, kConvThreads, 0, st>>>(pf32);
    else if (Cout % 64 == 0)
      conv3x3_q_dx_mma_kernel<MODE, 64><<<grid64, kMmaThreads, 0, st>>>(pb16);
    else
      conv3x3_q_dx_mma_kernel<MODE, 32><<<grid32, kMmaThreads, 0, st>>>(pb16);
  } else {  // f32; bf16 runs the ring body (conv3x3_ring.cu)
    if (is_bf16) return (int)cudaErrorInvalidValue;
    conv3x3_bn_kernel<DX, float><<<grid32, kConvThreads, 0, st>>>(pf32);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || (DX && !pf32.prologue)) return (int)err;
  reduce_rows_kernel<<<2 * Cout, kReduceThreads, 0, st>>>(pf32.partials, tiles * B, 2 * Cout,
                                                          2 * Cout, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// 32q: the quantizing epilogue of the forward, as a second kernel. One
// block per image row (b, h); a thread per lane l = j * C + c (column mod
// p, channel) walks its W / p columns (lane l of column group g is element
// g * p * C + l of the row: a warp's reads are consecutive), takes the max
// of |y|, then writes q = clip(rint(y * (127 / m)), +-127) and the scale
// m * float32(1 / 127) (`_quant_rows`, conv3x3_v3.py:142-151). Each value
// comes from one exact max and one rounding per operation, so the result
// does not depend on the order: no sums, nothing to repeat.
constexpr int kQuantThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
    conv3x3_q_quant_kernel(const T* __restrict__ y, int8_t* __restrict__ q,
                           float* __restrict__ scale, int W, int C, int p) {
  const int64_t row = blockIdx.x;  // b * H + h
  const int L = p * C, G = W / p;
  const T* yr = y + row * W * C;
  int8_t* qr = q + row * W * C;
  const float inv_qmax = static_cast<float>(1.0 / 127.0);  // as the JAX package rounds it
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    float m = 0.f;
    for (int g = 0; g < G; ++g) m = fmaxf(m, fabsf(to_f32(yr[(int64_t)g * L + l])));
    const float inv = m > 0.f ? __fdiv_rn(127.f, m) : 0.f;
    for (int g = 0; g < G; ++g) {
      const float v = rintf(__fmul_rn(to_f32(yr[(int64_t)g * L + l]), inv));  // half to even
      qr[(int64_t)g * L + l] = static_cast<int8_t>(fminf(fmaxf(v, -127.f), 127.f));
    }
    scale[row * L + l] = __fmul_rn(m, inv_qmax);
  }
}

}  // namespace
}  // namespace cltorch

// Plain C interface, loaded with ctypes; each returns cudaGetLastError().
// The wrapper (cl_tpu_torch/kernels/conv3x3.py) checks the operands: NHWC
// tensors contiguous and 16-byte aligned, of one type; w of that type,
// [3, 3, Cout, Cin] for bf16 and [Cin, 3, 3, Cout] for f32 in the
// kernel's own Cin / Cout (for dx: the flipped, transposed weight); a, b
// f32 [Cin] for the forward, [Cout] for dx (read only with `prologue`);
// s1, s2 f32 [Cin] or null; `partials` holds (number of 16 x 16 tiles) *
// B * 2 * Cout floats; `out` is [2, Cout]: the forward's (sum, sum of
// squares), dx's (da, db). The forward and dx take f32 only: in bf16 the
// wrapper calls conv3x3_ring.cu's cltorch_conv3x3_bn_ring.
extern "C" {

int cltorch_conv3x3_bn_fwd(const void* x, const void* w, const void* a, const void* b, void* y,
                           void* partials, void* out, int B, int H, int W, int Cin, int Cout,
                           int prologue, int is_bf16, void* stream) {
  using namespace cltorch;
  return conv3x3_launch<kFwd>(
      conv_args<bf16>(x, nullptr, nullptr, nullptr, w, a, b, nullptr, y, partials, H, W, Cin,
                      Cout, prologue),
      conv_args<float>(x, nullptr, nullptr, nullptr, w, a, b, nullptr, y, partials, H, W, Cin,
                       Cout, prologue),
      is_bf16, B, out, static_cast<cudaStream_t>(stream));
}

// dx of the conv: dy, y [B, H, W, Cin] (the forward's output side), x and
// dx [B, H, W, Cout] (its input side).
int cltorch_conv3x3_bn_dx(const void* dy, const void* y, const void* s1, const void* s2,
                          const void* w, const void* x, const void* a, const void* b, void* dx,
                          void* partials, void* out, int B, int H, int W, int Cin, int Cout,
                          int prologue, int is_bf16, void* stream) {
  using namespace cltorch;
  return conv3x3_launch<kDx>(
      conv_args<bf16>(dy, y, s1, s2, w, a, b, x, dx, partials, H, W, Cin, Cout, prologue),
      conv_args<float>(dy, y, s1, s2, w, a, b, x, dx, partials, H, W, Cin, Cout, prologue),
      is_bf16, B, out, static_cast<cudaStream_t>(stream));
}

// 32q: y [B, H, W, C] -> q int8 [B, H, W, C] and scale f32 [B, H, p, C];
// W a multiple of p.
int cltorch_conv3x3_bn_quant(const void* y, void* q, void* scale, int B, int H, int W, int C,
                             int p, int is_bf16, void* stream) {
  using namespace cltorch;
  const int threads = p * C < kQuantThreads ? (p * C + 31) / 32 * 32 : kQuantThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    conv3x3_q_quant_kernel<bf16><<<B * H, threads, 0, st>>>(
        static_cast<const bf16*>(y), static_cast<int8_t*>(q), static_cast<float*>(scale), W, C,
        p);
  else
    conv3x3_q_quant_kernel<float><<<B * H, threads, 0, st>>>(
        static_cast<const float*>(y), static_cast<int8_t*>(q), static_cast<float*>(scale), W,
        C, p);
  return (int)cudaGetLastError();
}

// #38: dx of the conv from the int8 saved y (yq, ysc [B, H, pack, Cin]) and,
// when xq is given, the int8 saved x (xq, xsc [B, H, pack, Cout]) in place
// of x; the other operands as for cltorch_conv3x3_bn_dx.
int cltorch_conv3x3_bn_dx_q(const void* dy, const void* yq, const void* ysc, const void* s1,
                            const void* s2, const void* w, const void* x, const void* xq,
                            const void* xsc, const void* a, const void* b, void* dx,
                            void* partials, void* out, int B, int H, int W, int Cin, int Cout,
                            int prologue, int pack, int is_bf16, void* stream) {
  using namespace cltorch;
  auto pb16 = conv_args<bf16>(dy, nullptr, s1, s2, w, a, b, x, dx, partials, H, W, Cin, Cout,
                              prologue);
  auto pf32 = conv_args<float>(dy, nullptr, s1, s2, w, a, b, x, dx, partials, H, W, Cin, Cout,
                               prologue);
  pb16.yq = pf32.yq = static_cast<const int8_t*>(yq);
  pb16.xq = pf32.xq = static_cast<const int8_t*>(xq);
  pb16.ysc = pf32.ysc = static_cast<const float*>(ysc);
  pb16.xsc = pf32.xsc = static_cast<const float*>(xsc);
  pb16.pack = pf32.pack = pack;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return xq != nullptr ? conv3x3_launch<kDxQX>(pb16, pf32, is_bf16, B, out, st)
                       : conv3x3_launch<kDxQ>(pb16, pf32, is_bf16, B, out, st);
}

// The plain gen-3 conv: x [B, H, W, Cin] -> y [B, H, W, Cout], w as for
// the forward above.
int cltorch_conv3x3_fwd(const void* x, const void* w, void* y, int B, int H, int W, int Cin,
                        int Cout, int is_bf16, void* stream) {
  using namespace cltorch;
  return conv3x3_launch<kPlain>(
      conv_args<bf16>(x, nullptr, nullptr, nullptr, w, nullptr, nullptr, nullptr, y, nullptr, H,
                      W, Cin, Cout, 0),
      conv_args<float>(x, nullptr, nullptr, nullptr, w, nullptr, nullptr, nullptr, y, nullptr,
                       H, W, Cin, Cout, 0),
      is_bf16, B, nullptr, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
