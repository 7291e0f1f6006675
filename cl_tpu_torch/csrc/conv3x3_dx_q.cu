// #38: the packed conv's dx from the int8 saved activations of
// model.conv_act_store=int8.
//
// Replaces the TPU kernel cl_tpu/pallas/conv3x3_v3.py::_dx_q_kernel
// (launched at conv3x3_v3.py:1657 by `_dx_q_impl`, body :1543-1586), the
// dx of `conv_bn_fused_q`'s fused branch:
//
//   e  = round(dy + ds1[co] + 2 * deq(y) * ds2[co])  (e = dy without stats
//        cotangents), deq(y) = q * scale in f32, NOT rounded (:1532-1540);
//        a halo row takes its own row's scale; zero outside the image
//   dt = conv3x3_SAME(e, w_flip^T)       f32 accumulator, not rounded
//   prologue on: u = x * a + b, du = [u > 0] * dt, dx = round(du * a),
//                da = sum of du * x, db = sum of du, where x is deq(xq) in
//                f32, not rounded, in the xq mode (:1577-1579)
//   prologue off: dx = round(dt)
//
// The int8 y (and x) halve the reads of them against the compute type's
// bf16; the scales are one f32 per (image row, column mod pack, channel)
// (conv3x3_bn.cuh). What bounds it on the H100 (bf16, batch 8, the 14
// launches of a headline int8 step, chip_smoke.q_bytes_ops): bytes at the
// 512^2 and 256^2 levels, the tensor cores at 128^2; 1.05 ms a step.
//
// * bf16 runs the packed conv's ring body (conv3x3_ring_body.cuh::
//   conv_ring_body, MODEs kDxQ and kDxQX), the body of the dtype route's dx
//   (#34/#35), whose note says what it does about each cause that held the
//   first body (4-6x its bounds). What the int8 route adds: the y window is
//   one TMA box of int8 (CK bytes a pixel) and one of its 18 rows' scales
//   ([18][pack][CK] floats), into a window of its own; e is formed in place
//   in the dy window once per element, in f32 with one rounding; plain
//   loads form e as they land (stage8_eq) where the width is not a multiple
//   of 16 (int8 rows of 16-byte multiples); kDxQX's epilogue reads deq(xq)
//   from a TMA tile of the int8 x and its rows' scales where #35 copies its
//   x tile (levels 0-1), else from global memory, half a tile's n-tiles'
//   loads in flight together (one at a time left the 128^2 xq launch 7%
//   slower than the first body). Products: at 32 output channels the dx's
//   mma.sync order (16-channel chunks ascending, taps 0-8, one m16n8k16
//   each) on the same bf16 e and w as the first body, with its partial rows
//   of da and db in its order; at 64 the kPlain products on wgmma (A from
//   registers), the same k16 steps in the same order, one m64n64k16 a tap.
//   Both keep the first body's bits (kernel_ab --bits at every Q_PATH and
//   Q_ODD shape), and phase 3 holds them at its tolerance.
//   Both forms were timed at every Q_PATH shape in the same turns
//   (kernel_ab, card sleep, H100 SXM at 700 W; PERF.md §6): mma.sync
//   3.4054 ms a 5q-a step, wgmma 3.3652 (the first body 4.2202); wgmma 1-6%
//   faster at 64 output channels and 2-8% slower at 32 (its m64n32
//   products; 24-28 bytes a thread spilled in kDxQX under two blocks an
//   SM), so each width takes its faster form: 3.3178 ms a step against
//   the first body's 4.2414 in the final turns.
//   Registers (kernel_ab --ptxas, no spills unless named): mma.sync at 32
//   output channels kDxQ 96-124, kDxQX 117-127; wgmma at 64 kDxQ 144-182,
//   kDxQX 205; ptxas injects a wgmma wait in each wgmma instance (its note
//   C7517), as it may in kPlain's.
// * f32 runs the FMA body (conv3x3_body.cuh::conv3x3_fma_body), as #34/#35's
//   f32 instances do.
//
// The bf16 schedule (COT, CK, resident weights, x tile, blocks) comes from
// the wrapper (kernels/conv3x3.py::conv_ring_tile, conv_ring_xbuf,
// conv_ring_blocks with the int8 sizes); the launcher recomputes the
// shared memory (conv_ring_smem) and refuses what does not fit.

#include "conv3x3_ring_body.cuh"

namespace cltorch {
namespace {

// f32: the FMA body, as #34/#35's f32 instances (four blocks an SM)
template <int MODE>
__global__ void __launch_bounds__(kConvThreads, kFmaDxMinBlocks)
    conv3x3_q_dx_kernel(ConvArgs<float> p) {
  conv3x3_fma_body<MODE>(p);
}

// bf16: the ring body; tm_y and tm_x are the int8 y's and x's maps
template <int MODE, int COT, int CK, bool EPI>
__global__ void __launch_bounds__(kRingConvThreads, ConvRingTile<COT, CK>::kMinBlocks)
    conv3x3_q_dx_ring_kernel(ConvArgs<bf16> p, RingArgs ra,
                             const __grid_constant__ CUtensorMap tm_in,
                             const __grid_constant__ CUtensorMap tm_y,
                             const __grid_constant__ CUtensorMap tm_w,
                             const __grid_constant__ CUtensorMap tm_x,
                             const __grid_constant__ CUtensorMap tm_ys,
                             const __grid_constant__ CUtensorMap tm_xs) {
  conv_ring_body<MODE, COT, CK, EPI>(p, ra, &tm_in, &tm_y, &tm_w, &tm_x, &tm_ys, &tm_xs);
}

template <int MODE, int COT, int CK, bool EPI>
int q_ring_launch(const ConvArgs<bf16>& p, const RingArgs& ra, int blocks, void* sums,
                  cudaStream_t st) {
  return conv_ring_run<MODE, COT, CK, EPI>(
      kernel_ptr(conv3x3_q_dx_ring_kernel<MODE, COT, CK, EPI>),
      [&](dim3 grid, int smem, const CUtensorMap* tm) {
        conv3x3_q_dx_ring_kernel<MODE, COT, CK, EPI><<<grid, kRingConvThreads, smem, st>>>(
            p, ra, tm[0], tm[1], tm[2], tm[3], tm[4], tm[5]);
      },
      p, ra, blocks, sums, st);
}

}  // namespace
}  // namespace cltorch

// The bf16 instances: (cot, ck) as kernels/conv3x3.py::conv_ring_tile picks
// them for the dx (32 or 64 output channels, 16 or 32 input channels a
// stage), each without the prologue's epilogue (kDxQ), with it (kDxQ), and
// with it in the xq mode (kDxQX; without the prologue x is unread, so the
// xq mode takes kDxQ's instance); any other is refused.
#define CLTORCH_DX_Q_CASE(CALL, COT, CK)                                          \
  if (cot == COT && ck == CK)                                                   \
    return !epi ? CALL(cltorch::kDxQ, COT, CK, false)                          \
                : xq ? CALL(cltorch::kDxQX, COT, CK, true)                     \
                     : CALL(cltorch::kDxQ, COT, CK, true);
#define CLTORCH_DX_Q_DISPATCH(CALL) \
  CLTORCH_DX_Q_CASE(CALL, 32, 16)   \
  CLTORCH_DX_Q_CASE(CALL, 32, 32)   \
  CLTORCH_DX_Q_CASE(CALL, 64, 16)   \
  CLTORCH_DX_Q_CASE(CALL, 64, 32)   \
  return (int)cudaErrorInvalidValue;

extern "C" {

// #38: dx of the conv from the int8 saved y (yq, ysc [B, H, pack, Cin]) and,
// when xq is given, the int8 saved x (xq, xsc [B, H, pack, Cout]) in place
// of x: dy [B, H, W, Cin] of the kernel's own Cin, x and dx [B, H, W, Cout],
// w the dx conv's weight (bf16 [3, 3, Cout, Cin], f32 [Cin, 3, 3, Cout]),
// s1, s2 f32 [Cin] or null, a, b f32 [Cout] (read with `prologue`);
// `partials` holds 16 x 16 tiles x B rows of 2 x Cout floats, `out` [2,
// Cout] = (da, db). cot, ck, resident, xbuf and blocks are the bf16
// schedule (kernels/conv3x3.py::dx_q_schedule), unread in f32.
int cltorch_conv3x3_bn_dx_q(const void* dy, const void* yq, const void* ysc, const void* s1,
                            const void* s2, const void* w, const void* x, const void* xq,
                            const void* xsc, const void* a, const void* b, void* dx,
                            void* partials, void* out, int B, int H, int W, int Cin, int Cout,
                            int prologue, int pack, int is_bf16, int cot, int ck, int resident,
                            int xbuf, int blocks, void* stream) {
  using namespace cltorch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    auto p = conv_args<float>(dy, nullptr, s1, s2, w, a, b, x, dx, partials, H, W, Cin, Cout,
                              prologue);
    p.yq = static_cast<const int8_t*>(yq);
    p.ysc = static_cast<const float*>(ysc);
    p.xq = static_cast<const int8_t*>(xq);
    p.xsc = static_cast<const float*>(xsc);
    p.pack = pack;
    const int tiles = ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
    const dim3 grid(tiles, (Cout + kCoT - 1) / kCoT, B);
    if (xq != nullptr)
      conv3x3_q_dx_kernel<kDxQX><<<grid, kConvThreads, 0, st>>>(p);
    else
      conv3x3_q_dx_kernel<kDxQ><<<grid, kConvThreads, 0, st>>>(p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || !prologue) return (int)err;
    reduce_rows_kernel<<<2 * Cout, kReduceThreads, 0, st>>>(p.partials, tiles * B, 2 * Cout,
                                                            2 * Cout, static_cast<float*>(out));
    return (int)cudaGetLastError();
  }
  auto p = conv_args<bf16>(dy, nullptr, s1, s2, w, a, b, x, dx, partials, H, W, Cin, Cout,
                           prologue);
  p.yq = static_cast<const int8_t*>(yq);
  p.ysc = static_cast<const float*>(ysc);
  p.xq = static_cast<const int8_t*>(xq);
  p.xsc = static_cast<const float*>(xsc);
  p.pack = pack;
  // the windows by TMA where the int8 rows are 16-byte multiples
  const RingArgs ra{B, resident, (Cin & 15) == 0, xbuf};
  const bool epi = prologue != 0;
#define CLTORCH_DX_Q_LAUNCH(MODE, COT, CK, EPI) \
  q_ring_launch<MODE, COT, CK, EPI>(p, ra, blocks, out, st)
  CLTORCH_DX_Q_DISPATCH(CLTORCH_DX_Q_LAUNCH)
#undef CLTORCH_DX_Q_LAUNCH
}

// The bf16 instance (cot, ck, epi: the prologue's epilogue, xq: the xq
// mode) on this card at the shared bytes the launcher gives the schedule
// (stats: the stats cotangents; resident, xbuf as the entry takes them; Cin
// the dy's channels; pack the scales' column groups): out[4] as
// conv_ring_info, out[3] from conv_ring_smem.
int cltorch_conv3x3_dx_q_info(int cot, int ck, int epi, int xq, int stats, int resident,
                              int xbuf, int Cin, int pack, int* out) {
  using namespace cltorch;
#define CLTORCH_DX_Q_INFO(MODE, COT, CK, EPI)                                               \
  conv_ring_info(kernel_ptr(conv3x3_q_dx_ring_kernel<MODE, COT, CK, EPI>),                  \
                 conv_ring_smem<COT, CK>(true, stats != 0, resident != 0, EPI && xbuf != 0, \
                                         Cin, MODE == kDxQX ? kQx : kQy, pack),             \
                 out)
  CLTORCH_DX_Q_DISPATCH(CLTORCH_DX_Q_INFO)
#undef CLTORCH_DX_Q_INFO
}

}  // extern "C"
