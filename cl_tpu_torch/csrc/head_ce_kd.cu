// The fused head+CE with the LwF distillation term of a frozen teacher on
// plain NHWC features (x, w, b; the teacher's xt, tw, tb; ovalid): replaces
// cl_tpu/pallas/head_ce.py::_kd_fwd_kernel (launched at head_ce.py:784) and
// ::_kd_bwd_kernel (:815). It is head_ce_bn.cuh's KD instance with the
// BN·ReLU prologue compiled out (BN = false): the features enter the logit
// products as they are, dx = round(round(g) W), and no dscale or dshift is
// summed. Arithmetic, what bounds it and the design: head_ce_bn.cuh.

#include "head_ce_bn.cuh"

// Plain C interface, loaded with ctypes. Each returns cudaGetLastError()
// (0 = launched). The BN operands (s, sh, ts, tsh) are not read and may be
// null. Shapes and types are checked by the Python wrapper
// (cl_tpu_torch/kernels/head_ce.py): C <= 32, Cin <= 64, Cin*itemsize a
// multiple of 16, 16-byte aligned contiguous x and xt. `partials` holds
// max_blocks rows (2 floats forward (the CE and KD sums); C*(Cin+1) floats
// backward); `cot` is {gce, gkd} on the device; the backward's `out` is
// [dW | db] as [C, Cin+1].
extern "C" {

int cltorch_head_ce_kd_fwd(const void* x, const void* s, const void* sh, const void* w,
                           const void* b, const void* xt, const void* ts, const void* tsh,
                           const void* tw, const void* tb, const void* lbl, const void* valid,
                           const void* ovalid, void* partials, void* out_ce, void* out_kd, int P,
                           int Cin, int C, int ignore_index, int is_bf16, float temperature,
                           int max_blocks, void* stream) {
  using namespace cltorch;
  const BnArgs a{x, s, sh, w, b, xt, ts, tsh, tw, tb, lbl, valid, ovalid};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bn_fwd<__nv_bfloat16, true, false>(a, temperature, partials, out_ce,
                                                             out_kd, P, Cin, C, ignore_index,
                                                             max_blocks, st)
                 : launch_bn_fwd<float, true, false>(a, temperature, partials, out_ce, out_kd, P,
                                                     Cin, C, ignore_index, max_blocks, st);
}

int cltorch_head_ce_kd_bwd(const void* x, const void* s, const void* sh, const void* w,
                           const void* b, const void* xt, const void* ts, const void* tsh,
                           const void* tw, const void* tb, const void* lbl, const void* valid,
                           const void* ovalid, const void* cot, void* dx, void* partials,
                           void* out, int P, int Cin, int C, int ignore_index, int is_bf16,
                           float temperature, int max_blocks, void* stream) {
  using namespace cltorch;
  const BnArgs a{x, s, sh, w, b, xt, ts, tsh, tw, tb, lbl, valid, ovalid};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bn_bwd<__nv_bfloat16, true, false>(a, temperature, cot, dx, partials,
                                                             out, P, Cin, C, ignore_index,
                                                             max_blocks, st)
                 : launch_bn_bwd<float, true, false>(a, temperature, cot, dx, partials, out, P,
                                                     Cin, C, ignore_index, max_blocks, st);
}

}  // extern "C"
