// The packed head+CE without a prologue: replaces
// cl_tpu/pallas/head_ce.py::_pkcm_fwd_kernel (launched at head_ce.py:405,
// body :289) and ::_pkcm_bwd_kernel (:431, body :310), reached through
// `head_cross_entropy_packed` (:1155). It is head_ce_bn.cuh's instance
// with neither the teacher nor the BN·ReLU prologue (KD = false, BN =
// false): logits x round(W)^T + b with f32 sums, masked to valid_classes;
// g = gce * pix * (softmax - onehot), masked; gc = round(g); dx =
// round(gc W), dW = sum gc (x) x, db = sum g. The TPU kernels' lane
// packing and class-major transpose are layout devices: here x is NHWC
// [P, Cin] as it lies (the packed view is a reshape of it). Its own
// translation unit, so that nvcc builds it beside the other instances.
// What bounds it and the design: head_ce_bn.cuh.

#include "head_ce_bn.cuh"

// Plain C interface, loaded with ctypes. Each returns cudaGetLastError()
// (0 = launched). The BN and teacher operands (s, sh, xt, ts, tsh, tw, tb,
// ovalid, out_kd) are not read and may be null. Shapes and types are
// checked by the Python wrapper (cl_tpu_torch/kernels/head_ce.py): C <= 32,
// Cin <= 64, Cin*itemsize a multiple of 16, 16-byte aligned contiguous x.
// `partials` holds max_blocks rows (1 float forward; C*(Cin+1) floats
// backward); `cot` is {gce} on the device; the backward's `out` is
// [dW | db] as [C, Cin+1].
extern "C" {

int cltorch_head_ce_pk_fwd(const void* x, const void* s, const void* sh, const void* w,
                           const void* b, const void* xt, const void* ts, const void* tsh,
                           const void* tw, const void* tb, const void* lbl, const void* valid,
                           const void* ovalid, void* partials, void* out_ce, void* out_kd, int P,
                           int Cin, int C, int ignore_index, int is_bf16, float temperature,
                           int max_blocks, void* stream) {
  using namespace cltorch;
  const BnArgs a{x, s, sh, w, b, xt, ts, tsh, tw, tb, lbl, valid, ovalid};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bn_fwd<__nv_bfloat16, false, false>(a, temperature, partials, out_ce,
                                                              out_kd, P, Cin, C, ignore_index,
                                                              max_blocks, st)
                 : launch_bn_fwd<float, false, false>(a, temperature, partials, out_ce, out_kd,
                                                      P, Cin, C, ignore_index, max_blocks, st);
}

int cltorch_head_ce_pk_bwd(const void* x, const void* s, const void* sh, const void* w,
                           const void* b, const void* xt, const void* ts, const void* tsh,
                           const void* tw, const void* tb, const void* lbl, const void* valid,
                           const void* ovalid, const void* cot, void* dx, void* partials,
                           void* out, int P, int Cin, int C, int ignore_index, int is_bf16,
                           float temperature, int max_blocks, void* stream) {
  using namespace cltorch;
  const BnArgs a{x, s, sh, w, b, xt, ts, tsh, tw, tb, lbl, valid, ovalid};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bn_bwd<__nv_bfloat16, false, false>(a, temperature, cot, dx, partials,
                                                              out, P, Cin, C, ignore_index,
                                                              max_blocks, st)
                 : launch_bn_bwd<float, false, false>(a, temperature, cot, dx, partials, out, P,
                                                      Cin, C, ignore_index, max_blocks, st);
}

}  // extern "C"
