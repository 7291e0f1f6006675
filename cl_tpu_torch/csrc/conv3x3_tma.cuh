// The Tensor Memory Accelerator (TMA) and its mbarriers, shared by the
// conv's ring kernels: the forward and dx (conv3x3_ring.cu,
// conv3x3_ring_body.cuh) and the dW (conv3x3_bn_bwd.cu, conv3x3_dw_body.cuh);
// and by the up-conv's forward (upconv.cu).
//
// Device side: one thread asks for a box of a tensor map to be copied into
// shared memory; the copy counts its bytes against an mbarrier's expected
// transaction, and the threads that read the box wait on the barrier's
// phase. Host side: the maps of bf16 NHWC activations and of the conv's
// weights, encoded by cuTensorMapEncodeTiled as the CUDA runtime looks it up
// (no link against libcuda); and a kernel's dynamic shared memory allowed
// once, and what the card gives it (kernel_info).
#pragma once

#include <cuda.h>  // CUtensorMap

#include <mutex>

#include "common.cuh"

namespace cltorch {
namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A 4-d box of `tm` at (c, w, h, b) into shared `dst`, completing on the
// mbarrier `bar`; coordinates past the tensor (negative too) read zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* tm, int c, int w, int h,
                                            int b, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c), "r"(w), "r"(h), "r"(b), "r"(bar)
      : "memory");
}

// A 2-d box of `tm` at (i, j) into shared `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* tm, int i, int j,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(i), "r"(j), "r"(bar)
      : "memory");
}

// A 3-d box of `tm` at (i, j, k) into shared `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* tm, int i, int j, int k,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(i), "r"(j), "r"(k), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Waits until the mbarrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nwait:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra wait;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Generic-proxy accesses of shared memory (stores, ldmatrix, cp.async)
// ordered before the async proxy's (TMA, wgmma) that follow.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime.
typedef CUresult (*TmEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

TmEncodeTiled tm_encode() {
  static TmEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) == cudaSuccess)
      fn = reinterpret_cast<TmEncodeTiled>(p);
  }
  return fn;
}

// The swizzle whose span is a box row of bc bf16 (16, 32 or 64 channels:
// 32, 64 or 128 bytes): a 16-byte piece q of row r lands at piece
// q ^ (address bits 7 and up of the row), so the eight rows of an
// ldmatrix fall on distinct banks.
CUtensorMapSwizzle tm_swizzle(int bc) {
  return bc == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                  : bc == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
}

// The maps already encoded, by (pointer, rank, dims, box; the strides
// follow from the dims for both callers below, and the swizzle from the
// box): a step launches the same tensors' maps again and again (the
// caching allocator hands the same addresses back), and encoding costs host
// time at every launch. A map holds only the address and the layout, so a
// hit is the same map. The slots are read and written under a lock:
// PyTorch launches a step's backward from its autograd thread and the
// forward from the caller's, and both reach the same translation unit's
// cache.
struct TmKey {
  const void* p;
  int rank;
  cuuint64_t dims[4];
  cuuint32_t box[4];
  bool operator==(const TmKey& o) const {
    if (p != o.p || rank != o.rank) return false;
    for (int i = 0; i < 4; ++i)
      if (dims[i] != o.dims[i] || box[i] != o.box[i]) return false;
    return true;
  }
};
constexpr int kTmCache = 256;

cudaError_t tm_tiled(CUtensorMap* m, const void* p, int rank, const cuuint64_t* dims,
                     const cuuint64_t* strides, const cuuint32_t* box, int bc) {
  static TmKey keys[kTmCache];
  static CUtensorMap maps[kTmCache];
  static std::mutex lock;
  TmKey key{p, rank, {1, 1, 1, 1}, {1, 1, 1, 1}};
  uint64_t h = reinterpret_cast<uint64_t>(p) * 0x9E3779B97F4A7C15ull + rank;
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
    h = (h ^ dims[i]) * 0x100000001B3ull;
    h = (h ^ box[i]) * 0x100000001B3ull;
  }
  const int slot = static_cast<int>((h >> 32) % kTmCache);
  std::lock_guard<std::mutex> guard(lock);
  if (keys[slot] == key) {
    *m = maps[slot];
    return cudaSuccess;
  }
  const TmEncodeTiled fn = tm_encode();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  if (fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(p), dims, strides, box,
         ones, CU_TENSOR_MAP_INTERLEAVE_NONE, tm_swizzle(bc), CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  keys[slot] = key;
  maps[slot] = *m;
  return cudaSuccess;
}

// A TMA map of the bf16 NHWC tensor p [B, H, W, C] whose box is bc channels
// x bw columns x bh rows of one image, zeros outside.
cudaError_t tm_nhwc(CUtensorMap* m, const void* p, int B, int H, int W, int C, int bc, int bw,
                    int bh) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)bc, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  return tm_tiled(m, p, 4, dims, strides, box, bc);
}

// A TMA map of the bf16 conv weight w [9, Cout, Cin] (tap, output channel,
// input channel) whose box is bc input channels x bo output channels x the
// nine taps, zeros past Cout and Cin.
cudaError_t tm_weights(CUtensorMap* m, const void* w, int Cin, int Cout, int bc, int bo) {
  const cuuint64_t dims[3] = {(cuuint64_t)Cin, (cuuint64_t)Cout, 9};
  const cuuint64_t strides[2] = {(cuuint64_t)Cin * 2, (cuuint64_t)Cout * Cin * 2};
  const cuuint32_t box[3] = {(cuuint32_t)bc, (cuuint32_t)bo, 9};
  return tm_tiled(m, w, 3, dims, strides, box, bc);
}

// A TMA map of the bf16 row-major matrix p [rows, cols] whose box is 64
// columns (one 128-byte swizzled row) x box_rows rows, zeros past either
// edge: the up-conv forward's x rows and its transposed weight.
cudaError_t tm_rows(CUtensorMap* m, const void* p, int64_t rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return tm_tiled(m, p, 2, dims, strides, box, 64);
}

// Host side: the kernels' launch attributes, shared by the translation
// units that instance the ring and register-blocked bodies.

// A kernel as the runtime's C functions take it.
template <typename K>
inline const void* kernel_ptr(K* kernel) {
  return reinterpret_cast<const void*>(kernel);
}

// A kernel's dynamic shared memory above 48 KB, allowed once per kernel
// and device (under a lock: the backward launches from autograd's thread).
inline cudaError_t smem_allowed(const void* kernel, int bytes) {
  constexpr int kSlots = 64;
  static const void* kernels[kSlots] = {};
  static int devices[kSlots] = {};
  static int n = 0;
  static std::mutex lock;
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < n; ++i)
    if (kernels[i] == kernel && devices[i] == dev) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && n < kSlots) {
    kernels[n] = kernel;
    devices[n++] = dev;
  }
  return err;
}

// What the card gives a kernel of `threads` threads and `smem` dynamic
// shared bytes: out = {resident blocks an SM, registers a thread, local
// (spilled) bytes a thread, smem}.
inline int kernel_info(const void* kernel, int threads, int smem, int* out) {
  cudaError_t err = smem_allowed(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, threads, smem);
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = smem;
  return (int)err;
}

}  // namespace
}  // namespace cltorch
