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
// which the wrapper calls directly. Here remain their f32 instances of the
// FMA body.
//
// Also the plain gen-3 conv, cl_tpu/pallas/conv3x3_v3.py::_fwd_kernel
// (launched at conv3x3_v3.py:522 by `_fwd_packed`): y = round(conv3x3_SAME(x,
// w)), no prologue and no statistics, as the forward of `conv3x3` /
// `conv3x3_packed` under model.conv_impl=v3|auto, as their dx (the same conv
// on dy with the flipped, transposed weight, :619-620, :641-642) and as the
// two-pass backward's dt (:965). Its kernels, conv3x3_v3_plain_ring_kernel
// (bf16: the ring body's kPlain MODE, products on wgmma) and
// conv3x3_v3_plain_fma_kernel (f32: the register-blocked FMA body), are
// conv3x3_plain_body.cuh's, whose note gives the bounds and the design;
// the gen-2 conv (#40, conv3x3_g2.cu) instances the same bodies.
//
// And the int8 saved activations of model.conv_act_store=int8
// (`conv_bn_fused_q`, conv3x3_v3.py:1800-1870):
// * 32q, the quantizing epilogue of ::_fwd_bn_q_kernel (:757, launched by
//   the same pallas_call as the forward, :833, with emit_q; `_quant_rows`
//   :142-151), here a second kernel, conv3x3_q_quant_kernel, after the
//   forward, which keeps its bits: q and a scale per image row, column mod
//   p and channel (conv3x3_bn.cuh). Bound by bytes: y read, q and the
//   scales written (512^2 x 32 bf16 at batch 8: 201 MB, 60 us).
// * #38, ::_dx_q_kernel (launched at :1657 by `_dx_q_impl`), the dx from
//   the int8 y (and x), has a translation unit of its own: conv3x3_dx_q.cu
//   (the ring body's kDxQ / kDxQX in bf16, the FMA body in f32).
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
// The FMA body, templated on what it computes, is in conv3x3_body.cuh.

#include "conv3x3_plain_body.cuh"

namespace cltorch {
namespace {

template <bool DX, typename T>
__global__ void __launch_bounds__(kConvThreads, DX && sizeof(T) == 4 ? kFmaDxMinBlocks : 1)
    conv3x3_bn_kernel(ConvArgs<T> p) {
  conv3x3_fma_body<DX ? kDx : kFwd>(p);
}

// #30: the plain conv's instances (conv3x3_plain_body.cuh)
CLTORCH_PLAIN_KERNELS(conv3x3_v3_plain)

// Launches the f32 kernel of the forward or the dx and, when it sums, the
// reduction of its partial rows into out [2, Cout]. In bf16 they run the
// ring body (conv3x3_ring.cu).
template <int MODE>
int conv3x3_launch(ConvArgs<float> pf32, int is_bf16, int B, void* out, cudaStream_t st) {
  constexpr bool DX = is_dx<MODE>();
  const int H = pf32.H, W = pf32.W, Cout = pf32.Cout;
  const int tiles = ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
  if (is_bf16) return (int)cudaErrorInvalidValue;
  conv3x3_bn_kernel<DX, float><<<dim3(tiles, (Cout + 31) / 32, B), kConvThreads, 0, st>>>(pf32);
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

// #30, the plain gen-3 conv: x [B, H, W, Cin] -> y [B, H, W, Cout], w as
// for the forward above; cot, ck, resident and blocks the wrapper's
// schedule (kernels/conv3x3.py::conv_plain_tile, conv_plain_blocks in
// bf16; plain_fma_tile's cot in f32, the others unread). One launch.
int cltorch_conv3x3_fwd(const void* x, const void* w, void* y, int B, int H, int W, int Cin,
                        int Cout, int is_bf16, int cot, int ck, int resident, int blocks,
                        void* stream) {
  using namespace cltorch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ConvArgs<bf16> pb = conv_args<bf16>(x, nullptr, nullptr, nullptr, w, nullptr, nullptr,
                                            nullptr, y, nullptr, H, W, Cin, Cout, 0);
#define CLTORCH_V3_PLAIN_RING(COT, CK) CLTORCH_PLAIN_RING_RUN(conv3x3_v3_plain, COT, CK)
#define CLTORCH_V3_PLAIN_FMA(COT) CLTORCH_PLAIN_FMA_RUN(conv3x3_v3_plain, COT)
  CLTORCH_PLAIN_DISPATCH(CLTORCH_V3_PLAIN_RING, CLTORCH_V3_PLAIN_FMA)
#undef CLTORCH_V3_PLAIN_RING
#undef CLTORCH_V3_PLAIN_FMA
}

// What the card gives the plain conv's instance (is_bf16, cot, ck; the
// gen-2 conv's are the same bodies) at the dynamic shared bytes of a launch
// with `resident` weights over `cin` input channels (bf16, as its runs
// compute them; f32 its own): out[4] = {resident blocks an SM, registers a
// thread, local bytes a thread, dynamic shared bytes}.
int cltorch_conv3x3_plain_info(int is_bf16, int cot, int ck, int resident, int cin, int* out) {
  using namespace cltorch;
#define CLTORCH_V3_PLAIN_RING_INFO(COT, CK)                                        \
  plain_ring_info(kernel_ptr(conv3x3_v3_plain_ring_kernel<COT, CK>),             \
                  conv_plain_smem<COT, CK>(resident != 0, cin), out)
#define CLTORCH_V3_PLAIN_FMA_INFO(COT)                                              \
  kernel_info(kernel_ptr(conv3x3_v3_plain_fma_kernel<COT>), kPfThreads,           \
              PlainFmaTile<COT>::kSmem, out)
  CLTORCH_PLAIN_DISPATCH(CLTORCH_V3_PLAIN_RING_INFO, CLTORCH_V3_PLAIN_FMA_INFO)
#undef CLTORCH_V3_PLAIN_RING_INFO
#undef CLTORCH_V3_PLAIN_FMA_INFO
}

}  // extern "C"
