// The packed head+CE with the BN·ReLU prologue, alone: replaces
// cl_tpu/pallas/head_ce.py::_pkbn_fwd_kernel (launched at head_ce.py:571)
// and ::_pkbn_bwd_kernel (:601). The teacher's operands are not read.
// Arithmetic, what bounds it and the design: head_ce_bn.cuh, and for the
// bf16 forward and backward head_ce_bn_mma.cuh.

#include "head_ce_bn.cuh"

namespace cltorch {
// bf16 #7 and #8 on the tensor cores (head_ce_bn_mma.cu).
int head_ce_bn_fwd_mma(const void* y, const void* s, const void* sh, const void* w,
                       const void* b, const void* lbl, const void* valid, void* partials,
                       void* out_ce, int P, int Cin, int C, int ignore_index, int blocks,
                       cudaStream_t st);
int head_ce_bn_bwd_mma(const void* y, const void* s, const void* sh, const void* w,
                       const void* b, const void* lbl, const void* valid, const void* cot,
                       void* dx, void* partials, void* out, int P, int Cin, int C,
                       int ignore_index, int blocks, cudaStream_t st);
}  // namespace cltorch

// Plain C interface, loaded with ctypes. Each returns cudaGetLastError()
// (0 = launched). Shapes and types are checked by the Python wrapper
// (cl_tpu_torch/kernels/head_ce.py): C <= 32, Cin <= 64, Cin*itemsize a
// multiple of 16, 16-byte aligned contiguous y. `partials` holds
// max_blocks rows (1 float forward; C*(Cin+1) + 2*Cin floats
// backward); `cot` is {gce} on the device; the backward's `out` is
// [dW | db] as [C, Cin+1], then dscale and dshift [Cin] each. The bf16
// forward and backward run head_ce_bn_mma.cuh's bodies over exactly
// max_blocks persistent blocks (the wrapper's bn_fwd_blocks, bn_bwd_blocks);
// the f32 ones run head_ce_bn.cuh's over at most max_blocks.
extern "C" {

int cltorch_head_ce_bn_fwd(const void* y, const void* s, const void* sh, const void* w,
                           const void* b, const void* yt, const void* ts, const void* tsh,
                           const void* tw, const void* tb, const void* lbl, const void* valid,
                           const void* ovalid, void* partials, void* out_ce, void* out_kd, int P,
                           int Cin, int C, int ignore_index, int is_bf16, float temperature,
                           int max_blocks, void* stream) {
  using namespace cltorch;
  const BnArgs a{y, s, sh, w, b, yt, ts, tsh, tw, tb, lbl, valid, ovalid};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return head_ce_bn_fwd_mma(y, s, sh, w, b, lbl, valid, partials, out_ce, P, Cin, C,
                              ignore_index, max_blocks, st);
  return launch_bn_fwd<float, false>(a, temperature, partials, out_ce, out_kd, P, Cin, C,
                                     ignore_index, max_blocks, st);
}

int cltorch_head_ce_bn_bwd(const void* y, const void* s, const void* sh, const void* w,
                           const void* b, const void* yt, const void* ts, const void* tsh,
                           const void* tw, const void* tb, const void* lbl, const void* valid,
                           const void* ovalid, const void* cot, void* dx, void* partials,
                           void* out, int P, int Cin, int C, int ignore_index, int is_bf16,
                           float temperature, int max_blocks, void* stream) {
  using namespace cltorch;
  const BnArgs a{y, s, sh, w, b, yt, ts, tsh, tw, tb, lbl, valid, ovalid};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return head_ce_bn_bwd_mma(y, s, sh, w, b, lbl, valid, cot, dx, partials, out, P, Cin, C,
                              ignore_index, max_blocks, st);
  return launch_bn_bwd<float, false>(a, temperature, cot, dx, partials, out, P, Cin, C,
                                     ignore_index, max_blocks, st);
}

}  // extern "C"
