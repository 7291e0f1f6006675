// The bf16 packed conv's forward (#32) and dx (#34, #35) on the ring body
// (conv3x3_ring_body.cuh::conv_ring_body, whose note says what bounds them
// on the H100 and what the design does about it).
//
// Replaces, in bf16, the TPU kernels of cl_tpu/pallas/conv3x3_v3.py:
// ::_fwd_bn_kernel (launched at conv3x3_v3.py:833 by `conv_bn_fused`),
// ::_dx_slim_kernel (:1233) and ::_dx_bn_kernel (:1259), which compute what
// conv3x3_bn.cu's header states; the f32 instances stay in conv3x3_bn.cu.
//
// One kernel per (MODE, COT, CK, EPI): kFwd with 32, 64 or 128 output
// channels a block, kDx with 32 or 64, each with (#35) and without (#34) the
// prologue's epilogue; 16 or 32 input channels a stage. The wrapper
// (kernels/conv3x3.py::conv_ring_tile, conv_ring_blocks) picks the instance,
// whether the weights stay resident and the blocks of one wave from the
// shapes alone; the launcher recomputes the shared memory from the same
// formula (conv_ring_smem) and refuses what does not fit. TMA maps of the
// window's tensors and of the weight are encoded once per (pointer, shape)
// and cached (conv3x3_tma.cuh::tm_tiled).

#include "conv3x3_ring_body.cuh"

namespace cltorch {
namespace {

template <int MODE, int COT, int CK, bool EPI>
__global__ void __launch_bounds__(kRingConvThreads, ConvRingTile<COT, CK>::kMinBlocks)
    conv3x3_bn_ring_kernel(ConvArgs<bf16> p, RingArgs ra, const __grid_constant__ CUtensorMap tm_in,
                           const __grid_constant__ CUtensorMap tm_y,
                           const __grid_constant__ CUtensorMap tm_w,
                           const __grid_constant__ CUtensorMap tm_x) {
  conv_ring_body<MODE, COT, CK, EPI>(p, ra, &tm_in, &tm_y, &tm_w, &tm_x);
}

template <int MODE, int COT, int CK, bool EPI>
int ring_launch(const ConvArgs<bf16>& p, const RingArgs& ra, int blocks, void* sums,
                cudaStream_t st) {
  return conv_ring_run<MODE, COT, CK, EPI>(
      kernel_ptr(conv3x3_bn_ring_kernel<MODE, COT, CK, EPI>),
      [&](dim3 grid, int smem, const CUtensorMap* tm) {
        conv3x3_bn_ring_kernel<MODE, COT, CK, EPI>
            <<<grid, kRingConvThreads, smem, st>>>(p, ra, tm[0], tm[1], tm[2], tm[3]);
      },
      p, ra, blocks, sums, st);
}

}  // namespace
}  // namespace cltorch

// The instances: (dx, cot, ck) as kernels/conv3x3.py::conv_ring_tile picks
// them, the dx's with and without the prologue's epilogue (#35, #34); any
// other is refused (cudaErrorInvalidValue).
#define CLTORCH_CONV_RING_DX(CALL, COT, CK)                                         \
  if (dx && cot == COT && ck == CK)                                               \
    return epi ? CALL(cltorch::kDx, COT, CK, true) : CALL(cltorch::kDx, COT, CK, false);
#define CLTORCH_CONV_RING_DISPATCH(CALL)                                             \
  if (!dx && cot == 32 && ck == 16) return CALL(cltorch::kFwd, 32, 16, false);      \
  if (!dx && cot == 32 && ck == 32) return CALL(cltorch::kFwd, 32, 32, false);      \
  if (!dx && cot == 64 && ck == 16) return CALL(cltorch::kFwd, 64, 16, false);      \
  if (!dx && cot == 64 && ck == 32) return CALL(cltorch::kFwd, 64, 32, false);      \
  if (!dx && cot == 128 && ck == 16) return CALL(cltorch::kFwd, 128, 16, false);    \
  if (!dx && cot == 128 && ck == 32) return CALL(cltorch::kFwd, 128, 32, false);    \
  CLTORCH_CONV_RING_DX(CALL, 32, 16)                                                \
  CLTORCH_CONV_RING_DX(CALL, 32, 32)                                                \
  CLTORCH_CONV_RING_DX(CALL, 64, 16)                                                \
  CLTORCH_CONV_RING_DX(CALL, 64, 32)                                                \
  return (int)cudaErrorInvalidValue;

extern "C" {

// The bf16 forward (dx = 0: in = x [B, H, W, Cin], out = y [B, H, W, Cout],
// sums = (Σy, Σy²)) or dx (dx = 1: in = dy and y [B, H, W, Cin] of the
// kernel's own Cin, x and out = dx [B, H, W, Cout], sums = (da, db) with
// the prologue), w the kernel's [3, 3, Cout, Cin]; `partials` holds blocks
// (forward) or 16 x 16 tiles x B (dx) rows of 2 x Cout floats; `xbuf`
// (the dx with the prologue, Cout a multiple of 8) copies each tile's x
// in by TMA; cot, ck, resident, xbuf and blocks are the wrapper's
// schedule (kernels/conv3x3.py::conv_ring_tile, conv_ring_xbuf,
// conv_ring_blocks); `ew_bf16` stages t or e with the bf16 chains
// (CL_TPU_E_BF16; the dx epilogue keeps the f32 a and b).
int cltorch_conv3x3_bn_ring(int dx, const void* in, const void* y, const void* s1,
                            const void* s2, const void* w, const void* a, const void* b,
                            const void* x, void* out, void* partials, void* sums, int B, int H,
                            int W, int Cin, int Cout, int prologue, int cot, int ck, int resident,
                            int xbuf, int blocks, int ew_bf16, void* stream) {
  using namespace cltorch;
  ConvArgs<bf16> p =
      conv_args<bf16>(in, y, s1, s2, w, a, b, x, out, partials, H, W, Cin, Cout, prologue);
  p.ew_bf16 = ew_bf16;
  const RingArgs ra{B, resident, (Cin & 7) == 0, xbuf};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool epi = prologue != 0;
#define CLTORCH_CONV_RING_LAUNCH(MODE, COT, CK, EPI) \
  ring_launch<MODE, COT, CK, EPI>(p, ra, blocks, sums, st)
  CLTORCH_CONV_RING_DISPATCH(CLTORCH_CONV_RING_LAUNCH)
#undef CLTORCH_CONV_RING_LAUNCH
}

// The instance (dx, cot, ck, epi: the dx's prologue) on this card at `smem`
// bytes: out[4] as ring_info.
int cltorch_conv3x3_ring_info(int dx, int cot, int ck, int epi, int smem, int* out) {
  using namespace cltorch;
#define CLTORCH_CONV_RING_INFO(MODE, COT, CK, EPI) \
  conv_ring_info(kernel_ptr(conv3x3_bn_ring_kernel<MODE, COT, CK, EPI>), smem, out)
  CLTORCH_CONV_RING_DISPATCH(CLTORCH_CONV_RING_INFO)
#undef CLTORCH_CONV_RING_INFO
}

}  // extern "C"
