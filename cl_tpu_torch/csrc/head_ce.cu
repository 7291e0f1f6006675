// Fused 1x1 head + masked softmax cross-entropy, forward and backward.
//
// Replaces the TPU kernels cl_tpu/pallas/head_ce.py::_fwd_kernel (launched
// at head_ce.py:165) and ::_bwd_kernel (head_ce.py:190). Same arithmetic,
// in pixel-major layout: features x [P, Cin] (f32 or bf16, contiguous),
// head weight W [C, Cin] f32 (rounded to the feature dtype here, as
// head_ce.py:62 does), bias b [C] f32, labels [P] int32, valid [C] f32 1/0.
//
//   forward:  total = sum_p pix_p * (logsumexp_c z_pc - z_p,label_p),
//             z = x W^T + b with invalid classes at -1e9, pix = label != ignore
//   backward: g = scale * pix * (softmax(z) - onehot(label)) * valid   (f32)
//             dx = round(g) W       (in the feature dtype)
//             dW = round(g)^T x, db = sum_p g   (f32; db from the unrounded g,
//             head_ce.py:113 and :122), round = cast through the feature dtype
//
// What bounds it on the H100: bytes. Forward reads x and the labels once
// (2 M pixels x 32 bf16 channels = 128 MiB + 8 MiB: ~41 us at 3.35 TB/s);
// the backward also writes dx of the same size. The head product is
// C*Cin = 608 FMAs per pixel, below the byte bound on the f32 pipes.
//
// Design: logits never leave registers. A block of 128 threads walks tiles
// of 128 pixels (grid-stride over a fixed grid); each tile of x is staged
// in shared memory by coalesced 16-byte loads, with a row stride whose
// 16-byte count is odd so that each thread's 16-byte row reads are free of
// bank conflicts. Each thread owns one pixel: its C logits are f32 FMA
// loops against W in shared memory (a broadcast read). Sums across pixels
// (the loss, dW, db) go to one partial per block and then to a second
// kernel that adds the partials in a fixed order: no float atomics, so a
// run repeats its losses bit for bit (the resume-exactness rule).
// The backward keeps g of the tile in shared memory for the dW/db
// accumulation, register-tiled: each thread owns 4 channels of up to 4
// classes (and their db) in registers across tiles, so one staged x load
// and one g load feed 4 FMAs. Each thread writes its row of dx into a
// shared dx tile as soon as it has g (so g holds no registers through the
// dW loop); the tile then goes out by coalesced 16-byte stores.

#include "common.cuh"

namespace cltorch {
namespace {

constexpr int kTile = 128;     // pixels per tile = threads per block

struct HeadLayout {
  int row_bytes;    // Cin * sizeof(T)
  int chunks;       // 16-byte chunks per row
  int xs_stride;    // shared-memory row stride in bytes (odd chunk count)
  int gs_stride;    // g row stride in floats (odd)
  size_t xs_off, ds_off, gs_off, w_off, b_off, v_off, scratch_off, bytes;
};

// Shared memory: the staged x tile; for the backward also the dx tile and
// g of the tile; then W, b, valid and the block-sum scratch.
__host__ __device__ inline HeadLayout head_layout(int Cin, int C, int elem, bool bwd) {
  HeadLayout L;
  L.row_bytes = Cin * elem;
  L.chunks = L.row_bytes / 16;
  const int sc = (L.chunks % 2 == 0) ? L.chunks + 1 : L.chunks;
  L.xs_stride = sc * 16;
  L.gs_stride = (C % 2 == 0) ? C + 1 : C;
  L.xs_off = 0;
  L.ds_off = L.xs_off + (size_t)kTile * L.xs_stride;
  L.gs_off = L.ds_off + (bwd ? (size_t)kTile * L.xs_stride : 0);
  L.w_off = L.gs_off + (bwd ? (size_t)kTile * L.gs_stride * 4 : 0);
  L.b_off = L.w_off + (size_t)C * Cin * 4;
  L.v_off = L.b_off + (size_t)C * 4;
  L.scratch_off = L.v_off + (size_t)C * 4;
  L.bytes = L.scratch_off + (kTile / 32) * 4;
  return L;
}

template <typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ x, int64_t base, int rows,
                                           const HeadLayout& L, unsigned char* xs) {
  const unsigned char* src = reinterpret_cast<const unsigned char*>(x) + base * L.row_bytes;
  for (int i = threadIdx.x; i < kTile * L.chunks; i += blockDim.x) {
    const int r = i / L.chunks, c16 = i - r * L.chunks;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < rows) v = *reinterpret_cast<const uint4*>(src + (int64_t)r * L.row_bytes + c16 * 16);
    *reinterpret_cast<uint4*>(xs + r * L.xs_stride + c16 * 16) = v;
  }
}

template <typename T>
__device__ __forceinline__ void load_head(const float* __restrict__ w, const float* __restrict__ b,
                                          const float* __restrict__ valid, int Cin, int C,
                                          float* ws, float* bs, float* vs) {
  for (int i = threadIdx.x; i < C * Cin; i += blockDim.x) ws[i] = round_to<T>(w[i]);
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    bs[i] = b[i];
    vs[i] = valid[i];
  }
}

// Four consecutive staged features as f32 (an 8- or 16-byte aligned load).
template <typename T> __device__ __forceinline__ void load4(const unsigned char* p, float (&f)[4]);
template <> __device__ __forceinline__ void load4<float>(const unsigned char* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
template <>
__device__ __forceinline__ void load4<__nv_bfloat16>(const unsigned char* p, float (&f)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] = to_f32(h[j]);
}

// z[c] = b[c] + sum_k ws[c][k] x[k] for this thread's staged row, with
// invalid classes set to -1e9. Returns the max over classes.
template <typename T, int CMAX>
__device__ __forceinline__ float row_logits(const unsigned char* row, const float* ws,
                                            const float* bs, const float* vs, int Cin, int C,
                                            int chunks, float (&z)[CMAX]) {
  constexpr int kVec = 16 / sizeof(T);
#pragma unroll
  for (int c = 0; c < CMAX; ++c) z[c] = c < C ? bs[c] : 0.f;
  for (int q = 0; q < chunks; ++q) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + q * 16);
    const T* xv = reinterpret_cast<const T*>(&raw);
    float xf[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) xf[j] = to_f32(xv[j]);
    const int k0 = q * kVec;
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      if (c < C) {
        // 16-byte loads of W (Cin % 4 == 0, ws 16-byte aligned): one
        // shared-memory load per 4 FMAs
        const float4* wr = reinterpret_cast<const float4*>(ws + c * Cin + k0);
        float acc = z[c];
#pragma unroll
        for (int j4 = 0; j4 < kVec / 4; ++j4) {
          const float4 wv = wr[j4];
          acc = fmaf(wv.x, xf[4 * j4], acc);
          acc = fmaf(wv.y, xf[4 * j4 + 1], acc);
          acc = fmaf(wv.z, xf[4 * j4 + 2], acc);
          acc = fmaf(wv.w, xf[4 * j4 + 3], acc);
        }
        z[c] = acc;
      }
    }
  }
  float m = kNegInf;
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    if (c < C) {
      z[c] = vs[c] > 0.f ? z[c] : kNegInf;
      m = fmaxf(m, z[c]);
    }
  }
  return m;
}

template <typename T, int CMAX>
__global__ void __launch_bounds__(kTile)
head_ce_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b, const int* __restrict__ labels,
                   const float* __restrict__ valid, float* __restrict__ partials,
                   int P, int Cin, int C, int ignore_index) {
  extern __shared__ __align__(16) unsigned char smem[];
  const HeadLayout L = head_layout(Cin, C, sizeof(T), false);
  unsigned char* xs = smem + L.xs_off;
  float* ws = reinterpret_cast<float*>(smem + L.w_off);
  float* bs = reinterpret_cast<float*>(smem + L.b_off);
  float* vs = reinterpret_cast<float*>(smem + L.v_off);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch_off);
  load_head<T>(w, b, valid, Cin, C, ws, bs, vs);

  const int ntiles = (P + kTile - 1) / kTile;
  float acc = 0.f;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t base = (int64_t)tile * kTile;
    const int rows = min(kTile, (int)(P - base));
    __syncthreads();  // previous tile's readers are done (and ws is loaded)
    stage_tile<T>(x, base, rows, L, xs);
    __syncthreads();
    if ((int)threadIdx.x < rows) {
      float z[CMAX];
      const float m = row_logits<T, CMAX>(xs + threadIdx.x * L.xs_stride, ws, bs, vs, Cin, C,
                                          L.chunks, z);
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < CMAX; ++c)
        if (c < C) s += expf(z[c] - m);
      const float logz = m + logf(s);
      const int lbl = labels[base + threadIdx.x];
      const float pix = lbl != ignore_index ? 1.f : 0.f;
      const int lbl0 = lbl == ignore_index ? 0 : lbl;
      float picked = 0.f;
#pragma unroll
      for (int c = 0; c < CMAX; ++c)
        if (c < C && c == lbl0) picked = z[c];
      acc += (logz - picked) * pix;
    }
  }
  acc = block_sum(acc, scratch);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

template <typename T, int CMAX>
__global__ void __launch_bounds__(kTile)
head_ce_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b, const int* __restrict__ labels,
                   const float* __restrict__ valid, const float* __restrict__ scale,
                   T* __restrict__ dx, float* __restrict__ partials,
                   int P, int Cin, int C, int ignore_index) {
  constexpr int kVec = 16 / sizeof(T);
  // dW is register-tiled: thread t owns channels [4*kg, 4*kg+4) of the
  // classes cg, cg+CG, ... (kg = t % KG, cg = t / KG), at most kRc of them
  // (CG >= kTile / (64/4) = 8 for Cin <= 64), and db of those classes
  // beside them.
  constexpr int kRc = (CMAX + 7) / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const HeadLayout L = head_layout(Cin, C, sizeof(T), true);
  unsigned char* xs = smem + L.xs_off;
  unsigned char* ds = smem + L.ds_off;
  float* gs = reinterpret_cast<float*>(smem + L.gs_off);
  float* ws = reinterpret_cast<float*>(smem + L.w_off);
  float* bs = reinterpret_cast<float*>(smem + L.b_off);
  float* vs = reinterpret_cast<float*>(smem + L.v_off);
  load_head<T>(w, b, valid, Cin, C, ws, bs, vs);
  const float sc = *scale;
  const int n_ent = C * (Cin + 1);  // [C, Cin] dW entries, then db in column Cin
  const int KG = Cin / 4, CG = kTile / KG;
  const int kg = threadIdx.x % KG, cg = threadIdx.x / KG;
  int n_rc = 0;  // classes this thread owns (0 for the threads past KG*CG)
  if (cg < CG) n_rc = min(kRc, (C - cg + CG - 1) / CG);

  float acc[kRc][4], dbacc[kRc];
#pragma unroll
  for (int i = 0; i < kRc; ++i) {
    dbacc[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  const int ntiles = (P + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t base = (int64_t)tile * kTile;
    const int rows = min(kTile, (int)(P - base));
    __syncthreads();
    stage_tile<T>(x, base, rows, L, xs);
    __syncthreads();
    const int r = threadIdx.x;
    if (r < rows) {
      float g[CMAX];
      const float m = row_logits<T, CMAX>(xs + r * L.xs_stride, ws, bs, vs, Cin, C, L.chunks, g);
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        if (c < C) {
          g[c] = expf(g[c] - m);
          s += g[c];
        }
      }
      const int lbl = labels[base + r];
      const float pix = lbl != ignore_index ? 1.f : 0.f;
      const int lbl0 = lbl == ignore_index ? 0 : lbl;
      const float sp = sc * pix;
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        if (c < C) {
          const float p = g[c] / s;
          const float gc = sp * (p - (c == lbl0 ? 1.f : 0.f));
          g[c] = vs[c] > 0.f ? gc : 0.f;
          gs[r * L.gs_stride + c] = g[c];
        }
      }
      // dx = round(g) W for this row, into the dx tile (g dies here, so
      // it holds no registers through the dW loop)
#pragma unroll
      for (int c = 0; c < CMAX; ++c)
        if (c < C) g[c] = round_to<T>(g[c]);
      unsigned char* row = ds + r * L.xs_stride;
      for (int q = 0; q < L.chunks; ++q) {
        uint4 raw;
        T* out = reinterpret_cast<T*>(&raw);
        const int k0 = q * kVec;
#pragma unroll
        for (int j4 = 0; j4 < kVec / 4; ++j4) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int c = 0; c < CMAX; ++c) {
            if (c < C) {
              const float4 wv = *reinterpret_cast<const float4*>(ws + c * Cin + k0 + 4 * j4);
              d[0] = fmaf(g[c], wv.x, d[0]);
              d[1] = fmaf(g[c], wv.y, d[1]);
              d[2] = fmaf(g[c], wv.z, d[2]);
              d[3] = fmaf(g[c], wv.w, d[3]);
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) out[4 * j4 + j] = from_f32<T>(d[j]);
        }
        *reinterpret_cast<uint4*>(row + q * 16) = raw;
      }
    }
    __syncthreads();
    // dW[c][k] += sum_r round(g[r][c]) x[r][k]; db[c] += sum_r g[r][c]
    if (n_rc > 0) {
      const unsigned char* xcol = xs + kg * 4 * sizeof(T);
#pragma unroll 4
      for (int rr = 0; rr < rows; ++rr) {
        float xf[4];
        load4<T>(xcol + rr * L.xs_stride, xf);
        const float* grow = gs + rr * L.gs_stride + cg;
#pragma unroll
        for (int i = 0; i < kRc; ++i) {
          if (i < n_rc) {
            const float gv = grow[i * CG];
            dbacc[i] += gv;
            const float gq = round_to<T>(gv);
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(gq, xf[j], acc[i][j]);
          }
        }
      }
    }
    unsigned char* dst = reinterpret_cast<unsigned char*>(dx) + base * L.row_bytes;
    for (int i = threadIdx.x; i < rows * L.chunks; i += blockDim.x) {
      const int rr = i / L.chunks, c16 = i - rr * L.chunks;
      *reinterpret_cast<uint4*>(dst + (int64_t)rr * L.row_bytes + c16 * 16) =
          *reinterpret_cast<const uint4*>(ds + rr * L.xs_stride + c16 * 16);
    }
  }
  float* part = partials + (int64_t)blockIdx.x * n_ent;
#pragma unroll
  for (int i = 0; i < kRc; ++i) {
    if (i < n_rc) {
      float* prow = part + (cg + i * CG) * (Cin + 1);
#pragma unroll
      for (int j = 0; j < 4; ++j) prow[kg * 4 + j] = acc[i][j];
      if (kg == 0) prow[Cin] = dbacc[i];
    }
  }
}

// Blocks for P pixels: one per tile, at most max_blocks (the rows of the
// partials buffer the caller gave).
inline int head_blocks(int P, int max_blocks) {
  const int tiles = (P + kTile - 1) / kTile;
  const int n = tiles < max_blocks ? tiles : max_blocks;
  return n > 1 ? n : 1;
}

// The kernel instance for C classes: CMAX is the least of 8, 16, 24, 32
// that holds C (the per-class loops are unrolled to CMAX and predicated).
template <typename T>
decltype(&head_ce_fwd_kernel<T, 8>) fwd_kernel_for(int C) {
  return C <= 8 ? head_ce_fwd_kernel<T, 8> : C <= 16 ? head_ce_fwd_kernel<T, 16>
       : C <= 24 ? head_ce_fwd_kernel<T, 24> : head_ce_fwd_kernel<T, 32>;
}

template <typename T>
decltype(&head_ce_bwd_kernel<T, 8>) bwd_kernel_for(int C) {
  return C <= 8 ? head_ce_bwd_kernel<T, 8> : C <= 16 ? head_ce_bwd_kernel<T, 16>
       : C <= 24 ? head_ce_bwd_kernel<T, 24> : head_ce_bwd_kernel<T, 32>;
}

template <typename T>
int launch_fwd(const void* x, const void* w, const void* b, const void* lbl, const void* valid,
               void* partials, void* out, int P, int Cin, int C, int ignore_index, int max_blocks,
               cudaStream_t st) {
  const HeadLayout L = head_layout(Cin, C, sizeof(T), false);
  const int nblk = head_blocks(P, max_blocks);
  auto kern = fwd_kernel_for<T>(C);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<nblk, kTile, L.bytes, st>>>(static_cast<const T*>(x), static_cast<const float*>(w),
                                     static_cast<const float*>(b), static_cast<const int*>(lbl),
                                     static_cast<const float*>(valid),
                                     static_cast<float*>(partials), P, Cin, C, ignore_index);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<<<1, kReduceThreads, 0, st>>>(static_cast<const float*>(partials), nblk, 1,
                                                   1, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* w, const void* b, const void* lbl, const void* valid,
               const void* scale, void* dx, void* partials, void* dwb, int P, int Cin, int C,
               int ignore_index, int max_blocks, cudaStream_t st) {
  const HeadLayout L = head_layout(Cin, C, sizeof(T), true);
  const int nblk = head_blocks(P, max_blocks);
  auto kern = bwd_kernel_for<T>(C);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<nblk, kTile, L.bytes, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<const int*>(lbl), static_cast<const float*>(valid),
      static_cast<const float*>(scale), static_cast<T*>(dx), static_cast<float*>(partials), P,
      Cin, C, ignore_index);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_ent = C * (Cin + 1);
  reduce_rows_kernel<<<n_ent, kReduceThreads, 0, st>>>(static_cast<const float*>(partials), nblk,
                                                       n_ent, n_ent, static_cast<float*>(dwb));
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cltorch

// Plain C interface, loaded with ctypes. Each returns cudaGetLastError()
// (0 = launched). Shapes and types are checked by the Python wrapper
// (cl_tpu_torch/kernels/head_ce.py): C <= 32, Cin <= 64, Cin*itemsize a
// multiple of 16, 16-byte aligned contiguous x. `partials` holds
// max_blocks rows (of 1 float forward, C*(Cin+1) floats backward).
extern "C" {

int cltorch_head_ce_fwd(const void* x, const void* w, const void* b, const void* lbl,
                        const void* valid, void* partials, void* out, int P, int Cin, int C,
                        int ignore_index, int is_bf16, int max_blocks, void* stream) {
  using namespace cltorch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_fwd<__nv_bfloat16>(x, w, b, lbl, valid, partials, out, P, Cin, C,
                                             ignore_index, max_blocks, st)
                 : launch_fwd<float>(x, w, b, lbl, valid, partials, out, P, Cin, C,
                                     ignore_index, max_blocks, st);
}

int cltorch_head_ce_bwd(const void* x, const void* w, const void* b, const void* lbl,
                        const void* valid, const void* scale, void* dx, void* partials,
                        void* dwb, int P, int Cin, int C, int ignore_index, int is_bf16,
                        int max_blocks, void* stream) {
  using namespace cltorch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bwd<__nv_bfloat16>(x, w, b, lbl, valid, scale, dx, partials, dwb, P,
                                             Cin, C, ignore_index, max_blocks, st)
                 : launch_bwd<float>(x, w, b, lbl, valid, scale, dx, partials, dwb, P, Cin, C,
                                     ignore_index, max_blocks, st);
}

}  // extern "C"
