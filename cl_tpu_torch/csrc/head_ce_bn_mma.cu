// The packed head+CE's bf16 forward (#7) and backward (#8) on the tensor
// cores: the instances of head_ce_bn_mma.cuh, which says what they
// replace, what bounds them and what their design does about that. Their
// own translation unit, so that nvcc builds it beside head_ce_bn.cu.

#include "head_ce_bn_mma.cuh"

namespace cltorch {

// The bf16 #8 behind cltorch_head_ce_bn_bwd (head_ce_bn.cu): the instance
// for Cin (a multiple of 8 up to 64, rounded up to 16) and C (up to 16 or
// 32 classes), over `blocks` persistent blocks (kernels/head_ce.py::
// bn_bwd_blocks: the rows of `partials`, C*(Cin+1) + 2*Cin floats each).
int head_ce_bn_bwd_mma(const void* y, const void* s, const void* sh, const void* w,
                       const void* b, const void* lbl, const void* valid, const void* cot,
                       void* dx, void* partials, void* out, int P, int Cin, int C,
                       int ignore_index, int blocks, cudaStream_t st) {
  if (blocks < 1 || Cin < 8 || Cin > 64 || (Cin & 7) || C < 1 || C > 32)
    return (int)cudaErrorInvalidValue;
  const int cin16 = (Cin + 15) / 16 * 16;
#define CLTORCH_HB(CIN16)                                                                      \
  if (cin16 == CIN16)                                                                          \
    return C <= 16 ? hb_launch<CIN16, 16>(y, s, sh, w, b, lbl, valid, cot, dx, partials, out, \
                                          P, Cin, C, ignore_index, blocks, st)                 \
                   : hb_launch<CIN16, 32>(y, s, sh, w, b, lbl, valid, cot, dx, partials, out, \
                                          P, Cin, C, ignore_index, blocks, st);
  CLTORCH_HB(16)
  CLTORCH_HB(32)
  CLTORCH_HB(48)
  CLTORCH_HB(64)
#undef CLTORCH_HB
  return (int)cudaErrorInvalidValue;
}


// The bf16 #7 behind cltorch_head_ce_bn_fwd (head_ce_bn.cu): the instance
// for Cin and C as #8's, over `blocks` persistent blocks (kernels/
// head_ce.py::bn_fwd_blocks: the floats of `partials`), the total into
// out_ce.
int head_ce_bn_fwd_mma(const void* y, const void* s, const void* sh, const void* w,
                       const void* b, const void* lbl, const void* valid, void* partials,
                       void* out_ce, int P, int Cin, int C, int ignore_index, int blocks,
                       cudaStream_t st) {
  if (blocks < 1 || Cin < 8 || Cin > 64 || (Cin & 7) || C < 1 || C > 32)
    return (int)cudaErrorInvalidValue;
  const int cin16 = (Cin + 15) / 16 * 16;
#define CLTORCH_HF(CIN16)                                                                      \
  if (cin16 == CIN16)                                                                          \
    return C <= 16 ? hf_launch<CIN16, 16>(y, s, sh, w, b, lbl, valid, partials, out_ce, P, Cin, \
                                          C, ignore_index, blocks, st)                         \
                   : hf_launch<CIN16, 32>(y, s, sh, w, b, lbl, valid, partials, out_ce, P, Cin, \
                                          C, ignore_index, blocks, st);
  CLTORCH_HF(16)
  CLTORCH_HF(32)
  CLTORCH_HF(48)
  CLTORCH_HF(64)
#undef CLTORCH_HF
  return (int)cudaErrorInvalidValue;
}

}  // namespace cltorch

extern "C" {

// The instance for (Cin, C) on this card, #8's (fwd 0) or #7's (fwd 1):
// out[4] as hb_info.
#define CLTORCH_HB_INFO(FWD)                                                       \
  const int cin16 = (cin + 15) / 16 * 16;                                          \
  const bool c16 = C <= 16;                                                        \
  if (cin16 == 16) return c16 ? hb_info<16, 16, FWD>(out) : hb_info<16, 32, FWD>(out); \
  if (cin16 == 32) return c16 ? hb_info<32, 16, FWD>(out) : hb_info<32, 32, FWD>(out); \
  if (cin16 == 48) return c16 ? hb_info<48, 16, FWD>(out) : hb_info<48, 32, FWD>(out); \
  if (cin16 == 64) return c16 ? hb_info<64, 16, FWD>(out) : hb_info<64, 32, FWD>(out); \
  return (int)cudaErrorInvalidValue;

int cltorch_head_ce_bn_mma_info(int cin, int C, int* out) {
  using namespace cltorch;
  CLTORCH_HB_INFO(false)
}

int cltorch_head_ce_bn_fwd_mma_info(int cin, int C, int* out) {
  using namespace cltorch;
  CLTORCH_HB_INFO(true)
}

#undef CLTORCH_HB_INFO

}  // extern "C"
