// Hopper's warpgroup matrix multiply (wgmma) on operands in shared memory,
// shared by the packed conv's dW ring (conv3x3_dw_body.cuh, both operands
// MN-major) and the up-conv's forward (upconv.cu, both K-major).
#pragma once

#include "conv3x3_tma.cuh"  // smem_u32

namespace cltorch {
namespace {

// A shared-memory matrix descriptor with the 128-byte swizzle (start, LBO,
// SBO, each >> 4; layout type 1).
__device__ __forceinline__ uint64_t wg_desc(const void* smem, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = smem_u32(smem);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator accesses across an async wgmma.
template <int N>
__device__ __forceinline__ void wg_fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define CLTORCH_WG_N64_D                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define CLTORCH_WG_N64_OUT(d)                                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d[64 x 64] += A[64 x 16] B[16 x 64], bf16 in, f32 accumulators, both
// operands MN-major in shared memory (imm-trans-a = imm-trans-b = 1). Lane
// (g, t) of warp w of the warpgroup holds d[4j + v] = D[16w + g + (v / 2) * 8]
// [8j + 2t + v % 2].
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " CLTORCH_WG_N64_D
               ", %32, %33, p, 1, 1, 1, 1;\n}\n"
               : CLTORCH_WG_N64_OUT(d)
               : "l"(a), "l"(b));
}

// The same with both operands K-major (A [64 rows][k], B [64 columns][k]:
// imm-trans 0), and d = A B in place of d += A B where `accumulate` is 0.
__device__ __forceinline__ void wgmma_n64_k(float (&d)[32], uint64_t a, uint64_t b,
                                            int accumulate) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " CLTORCH_WG_N64_D
               ", %32, %33, p, 1, 1, 0, 0;\n}\n"
               : CLTORCH_WG_N64_OUT(d)
               : "l"(a), "l"(b), "r"(accumulate));
}

#undef CLTORCH_WG_N64_D
#undef CLTORCH_WG_N64_OUT

}  // namespace
}  // namespace cltorch
