// k=2 / stride-2 transposed conv + bias over NHWC: forward, dx, dW and db.
//
// Replaces the TPU kernels of cl_tpu/pallas/upconv_pack.py: ::_fwd_kernel
// (#27, launched at upconv_pack.py:150 by `upconv2x2_packed`), ::_dx_kernel
// (#28, :183) and ::_dw_kernel (#29, :201, dW and db), the last two from its
// VJP `_vjp_bwd`. With no kernel overlap every output pixel is one tap:
//
//   out[b, 2h+a, 2w+c, o] = round( sum_ci x[b,h,w,ci] * K[ci, o, a, c] + bias[o] )
//
// with K in torch's ConvTranspose2d layout [Cin, Cout, 2, 2] (the JAX
// package's flipped flax kernel, cl_tpu/models/unet.py:583-585), the
// product accumulated in f32, the f32 bias added, and one rounding to x's
// type (upconv_pack.py:88-94). Written as matrices, with the pixel rows
// m = (b, h, w), the columns n = (a*2 + c)*Cout + o, Kg[ci, n] = K rounded
// to x's type ([Cin, 4*Cout]) and DY[m, n] = dy[b, 2h+a, 2w+c, o]:
//
//   forward  Y  = X Kg + bias        (scattered to the (a, c) phases)
//   dx       DX = round(DY Kg^T)     [M, 4*Cout] x [4*Cout, Cin]
//   dW       DW = X^T DY             [Cin, M] x [M, 4*Cout], f32
//   db       db[o] = sum over m and the 4 phases of DY[m, (a,c), o], f32
//
// The wrapper rounds dW to x's type once (the JAX package rounds each p_in
// block and sums them in bf16, upconv_pack.py:219; a few bf16 ulps apart)
// and keeps db in f32 (the TPU kernel sums each tile in bf16, :132).
//
// What bounds it on the H100: bytes, at the packed body's shapes (batch 8,
// bf16; 3.35 TB/s against 989 TFLOP/s on the tensor cores). dW reads x and
// dy once: 256^2 x 64 -> 512^2 x 32 201 MB, 60 us (against 8.6 GFLOP, 9 us);
// 128^2 x 128 -> 64 101 MB, 30 us; 64^2 x 256 -> 128 50 MB, 15 us. The
// forward and dx move the same bytes; on the f32 FMA units the operations
// bound them (~130 us at 256^2).
//
// bf16 forward (#27): upconv_fwd_wg_kernel, redesigned for the H100
// (replaces cl_tpu/pallas/upconv_pack.py::_fwd_kernel, :83-94, launched at
// :150). At the headline step's three launches (batch 8: 64^2 x 256 -> 128,
// 128^2 x 128 -> 64, 256^2 x 64 -> 32) it moves 352 MB, 0.105 ms at 3.35
// TB/s, against 25.8 GFLOP, 0.026 ms at 989 TFLOP/s: bytes bound it. What it
// does about each cause that held the first version (mma.sync on a
// synchronous 32-deep main loop, 0.50-0.53 ms a step):
// * A short, unpipelined main loop. The block is persistent: one wave of
//   resident blocks (kernels/upconv_pack.py::fwd_blocks) each walks pixel
//   tiles of 128 rows, and every (tile, 64-channel k-chunk) is a stage of
//   one ring of 2-6 stages fed by TMA and completed on an mbarrier, so the
//   copies of the next tiles are in flight while a tile multiplies and
//   while its epilogue stores; one block barrier a stage.
// * Weights re-staged by every row tile. The block's column slice of Kg^T
//   ([BN][Cin] bf16) is formed once from the f32 weight (no host-side
//   transpose: one launch a call) and stays for the walk. The column tile
//   (kernels/upconv_pack.py::fwd_tile) is the widest that leaves room for
//   two resident blocks an SM: 128 columns at levels 0 and 1 (16 and 32
//   KB), 64 at level 2 (eight tiles of 32 KB); the blocks of a pixel tile's
//   column tiles walk it at about the same time, so x is re-read from L2.
//   Two blocks of 8 warps an SM with 2-3 stages ran faster on the H100
//   than one with 5-6 stages and a tile twice as wide: one block's products
//   and copies overlap the other's epilogue.
// * The products. wgmma (m64n64k16, f32 accumulation, two warpgroups of 64
//   rows): both operands, the x rows [pixels][Cin] and Kg^T [4 Cout][Cin],
//   are K-major as they lie in memory, which is wgmma's native layout, so
//   TMA's 128-byte swizzle is the operand layout and no fragment is loaded
//   by the threads.
// * Scattered 4-byte stores. The rounded tile is staged [BM][BN + 8] in
//   shared memory (rows of a warp on distinct banks) and leaves as 16-byte
//   pieces: for a pixel, the columns of phase row a are 2 Cout contiguous
//   values of output row 2h + a, and neighbouring pixels' runs continue
//   each other, so a warp writes whole runs.
//
// bf16 dx (#28): upconv_dx_wg_kernel, redesigned for the H100 on #27's
// design (replaces cl_tpu/pallas/upconv_pack.py::_dx_kernel, :97-108,
// launched at :183). At the headline step's three launches (batch 8: dy
// 128^2 x 128 -> dx 64^2 x 256, 256^2 x 64 -> 128^2 x 128, 512^2 x 32 ->
// 256^2 x 64) it moves 352 MB, 0.105 ms at 3.35 TB/s, against 25.8 GFLOP,
// 0.026 ms at 989 TFLOP/s: bytes bound it. What it does about each cause
// that held the first version (mma.sync on a synchronous main loop, 0.48 ms
// a step):
// * A short, unpipelined main loop. Persistent blocks (one wave,
//   kernels/upconv_pack.py::dx_blocks) walk pixel tiles of 128 rows, and
//   every (tile, 64-wide k-chunk of 4 Cout) is a stage of one ring of 2-6
//   stages completed on an mbarrier; one block barrier a stage.
// * The dy gather through registers, by 64-bit division a piece. For a
//   pixel, the columns of phase row a are 2 Cout contiguous values of dy row
//   2h + a, so with dy viewed as [B H][2][W][2 Cout] a tile's k-chunk is one
//   TMA box (64 values x the tile's pixels of one phase row) where 2 Cout is
//   a multiple of 64 and a tile covers whole rows or lies in one (W a
//   multiple or a divisor of 128): every launch of the headline step. Else
//   (ragged shapes) 16-byte cp.async pieces land in the same swizzled
//   layout, their rows decoded once a piece.
// * The weight's cast and copies on the host. The block's slice of Kg
//   ([BN][4 Cout] bf16, BN a slice of Cin) is formed once from the f32
//   weight [Cin, Cout, 2, 2] (one float4, the four phases of (ci, o), a
//   thread) and stays for the walk: the wrapper issues one launch a call.
//   The column tile (kernels/upconv_pack.py::dx_tile) is the widest that
//   leaves room for two resident blocks an SM: 64 at the headline's levels,
//   level 2's Kg (256 KB) as four slices of 64 KB; the blocks of a pixel
//   tile's column tiles walk it at about the same time, so dy is re-read
//   from L2.
// * 32-bit fragment loads: wgmma (m64n64k16, f32 accumulation, two
//   warpgroups of 64 rows) on both operands as staged, DY rows [pixels][k]
//   and Kg rows [Cin][k], both K-major with TMA's 128-byte swizzle.
// * Scattered 4-byte stores. The rounded tile is staged [BM][BN] in shared
//   memory, 16-byte pieces swizzled by the row (a warp's pairs on distinct
//   banks), and leaves as 16-byte pieces of whole dx rows ([M, Cin] is
//   contiguous).
// The mbarriers live in the 1024 bytes of alignment slack, so that level
// 2's slice, two stages and the output tile fit two blocks an SM exactly.
//
// f32 forward, dx and dW: one FMA main loop, fed by views that know each
// operand's layout (row-major, the dy gather, or a transposed view), and
// one epilogue per function. A block of 256 threads computes a 64-row x
// 64-column tile from 16-deep slices of A (transposed) and B staged as f32;
// each thread keeps a 4 x 4 register tile (TF32 would round). dW splits the
// pixels (its k) over gridDim.z blocks, each taking every gridDim.z-th
// slice and writing its own partial [Cin, 4*Cout] (and, in the blocks of
// the first row tile, its column sums of DY for db).
//
// bf16 dW: the ring kernel (upconv_dw_ring_kernel). The contraction runs
// over the pixels, and both operands are pixel-major in memory, so they are
// staged that way and the transposes are taken by the fragment loads. What
// it does about each cause that held the first version (mma.sync on a
// synchronous main loop over transposed views) at 12x its bound:
// * Transposed scalar staging. x is staged as [k pixels][Cin tile] and the
//   dy gather as [k pixels][4*Cout tile], in their memory order, by 16-byte
//   cp.async (for a pixel m, the columns of phase row a are the 2*Cout
//   contiguous values of dy at (2h + a, 2w..2w+1), so every 16-byte piece is
//   one copy); A = X^T and B = DY fragments come from ldmatrix.trans, with
//   rows padded by 8 bf16 so that an ldmatrix's eight rows fall on distinct
//   banks. No transposed st.shared.
// * No prefetch. The slices go through a ring of three stages, two ahead:
//   the copies of slices i + 1 and i + 2 are in flight while the products of
//   slice i run; one barrier a slice.
// * Zero rows at level 0. The row tile is fitted to Cin: 64 rows for
//   Cin <= 64 (level 0 has no zero rows), else 128; the column tile 128 or
//   256 of 4*Cout. Levels 0 and 1 (64 -> 4x32, 128 -> 4x64) are one tile, so
//   x and dy are each read once; level 2 (256 -> 4x128) is 2 x 2 tiles, each
//   operand read twice (the second time mostly from L2).
// * A serial db. The column sums of the staged DY come from one more
//   m16n8k16 product: the B fragments a warp already holds ARE the A
//   fragment of DY^T (16 columns x 16 pixels), against a ones operand, so a
//   sum costs one MMA per 16 columns and 16 pixels; the warp rows take the
//   k steps in turn, and the block adds their sums in a fixed order. db is
//   f32 (exact products, f32 sums in a fixed order).
// * Occupancy. Warps of 32 rows x BN/4 columns (8 or 16 warps), held by
//   __launch_bounds__ at two blocks an SM for the 64 x 128 tile and one for
//   the larger ones (16 warps an SM either way); the wrapper's picker
//   (kernels/upconv_pack.py::dw_ring_splits) sizes one wave of resident
//   blocks from these resources.
// * The partials. Each block stages its dW tile in shared memory and writes
//   its partial a row of BN floats at a time, and upconv_dw_reduce_kernel
//   sums them in a fixed order (no float atomics): the same sums as before,
//   bit for bit, with 16 loads in flight a thread and db's four phases
//   summed by four lanes, added in order (in place of a serial loop of 4 x
//   splits loads on only Cout threads).

#include "wgmma.cuh"  // wgmma, TMA and mbarriers

namespace cltorch {
namespace {

using bf16 = __nv_bfloat16;
constexpr int kUpThreads = 256;

// Pixel row m = (b, h, w) of the input grid -> offset of output pixel
// (2h, 2w); phase q = a*2 + c is output pixel (2h+a, 2w+c), `phase(q, W)`
// further. An epilogue decomposes m once per row, not once per column.
__device__ __forceinline__ int64_t out_base(int64_t m, int H, int W) {
  const int w_ = (int)(m % W);
  const int64_t bh = m / W;
  const int h = (int)(bh % H);
  const int64_t b = bh / H;
  return (b * 2 * H + 2 * h) * (int64_t)(2 * W) + 2 * w_;
}

__device__ __forceinline__ int64_t phase(int q, int W) {
  return (q >> 1) * (int64_t)(2 * W) + (q & 1);
}

// ---------------------------------------------------------------------------
// Operand views of the f32 route: element (r, k) of a matrix, zero past it
// ---------------------------------------------------------------------------

// Row-major [rows, K].
template <typename T> struct RowMajor {
  const T* p;
  int64_t rows;
  int64_t K;
  __device__ float at(int64_t r, int64_t k) const {
    return (r < rows && k < K) ? to_f32(p[r * K + k]) : 0.f;
  }
};

// Column-major [rows, K]: element (r, k) at p[k * rows + r] (x^T for dW).
template <typename T> struct ColMajor {
  const T* p;
  int64_t rows;
  int64_t K;
  __device__ float at(int64_t r, int64_t k) const {
    return (r < rows && k < K) ? to_f32(p[k * rows + r]) : 0.f;
  }
};

// DY [M, 4*Cout] gathered from dy [B, 2H, 2W, Cout]; `transposed` views it
// as [4*Cout, M] (the B operand of the f32 dW).
template <typename T> struct DyGather {
  const T* dy;
  int64_t M;
  int H, W, Cout;
  bool transposed;
  __device__ float at(int64_t r, int64_t k) const {
    const int64_t m = transposed ? k : r;
    const int64_t n = transposed ? r : k;
    if (m >= M || n >= 4 * Cout) return 0.f;
    const int q = (int)(n / Cout), o = (int)(n - (int64_t)q * Cout);
    return to_f32(dy[(out_base(m, H, W) + phase(q, W)) * Cout + o]);
  }
};

// ---------------------------------------------------------------------------
// bf16 forward: the persistent wgmma kernel
// ---------------------------------------------------------------------------

constexpr int kUfBM = 128;      // pixels a tile: two warpgroups of 64 rows
constexpr int kUfBK = 64;       // input channels a k-chunk: one 128-byte swizzled row
constexpr int kUfThreads = 256;
constexpr int kUfMaxStages = 6;
constexpr int kUfSmemMax = 232448;           // dynamic shared bytes a block can have
constexpr int kUfStage = kUfBM * kUfBK * 2;  // bytes of one x stage

// A block's shared memory for a BN-column tile, `kc` k-chunks and `stages`
// x stages: 1024 bytes of slack that align the swizzled tiles to 1024; the
// block's weights Kg^T [BN][64] a k-chunk; the x ring; the rounded output
// tile [BM][BN + 8] bf16; the bias of its columns; the output offsets of
// the tile's rows and of its 16-byte column pieces; an mbarrier a stage.
template <int BN>
struct UpFwd {
  static constexpr int kMinBlocks = 2;  // resident blocks an SM
  static constexpr int kRowO = BN + 8;
  static constexpr int kWChunk = BN * kUfBK * 2;
  __host__ __device__ static int smem(int kc, int stages) {
    return 1024 + kc * kWChunk + stages * kUfStage + kUfBM * kRowO * 2 + BN * 4 +
           (kUfBM + BN / 8) * 8 + stages * 8;
  }
};

// out[pixel m][column n] = round(sum_k x[m][k] Kg^T[n][k] + bias[n % Cout]),
// scattered to the (a, c) phases: block (bx, by) takes the columns
// [by BN, (by + 1) BN) and walks the pixel tiles bx, bx + gridDim.x, ...;
// each tile's k-chunks are the stages of one ring. `w` is the f32 weight
// [Cin, Cout, 2, 2] as the module holds it: Kg^T is formed from it here.
template <int BN>
__global__ void __launch_bounds__(kUfThreads, UpFwd<BN>::kMinBlocks)
    upconv_fwd_wg_kernel(const __grid_constant__ CUtensorMap tm_x, const float* __restrict__ w,
                         const float* __restrict__ bias, bf16* __restrict__ out, int B, int H,
                         int W, int Cin, int Cout, int stages) {
  using Tile = UpFwd<BN>;
  constexpr int NB = BN / 64;  // wgmma n64 products a k-step
  extern __shared__ __align__(16) unsigned char up_fwd_smem[];
  unsigned char* base = up_fwd_smem + ((1024 - (smem_u32(up_fwd_smem) & 1023)) & 1023);
  const int KC = (Cin + kUfBK - 1) / kUfBK;
  unsigned char* ws = base;                                    // [KC][BN][64]
  unsigned char* xs = ws + KC * Tile::kWChunk;                 // [stages][BM][64]
  bf16* os = reinterpret_cast<bf16*>(xs + stages * kUfStage);  // [BM][kRowO]
  float* bs = reinterpret_cast<float*>(os + kUfBM * Tile::kRowO);
  int64_t* row_off = reinterpret_cast<int64_t*>(bs + BN);      // [BM]
  int64_t* col_off = row_off + kUfBM;                          // [BN / 8]
  uint64_t* bars = reinterpret_cast<uint64_t*>(col_off + BN / 8);  // [stages]

  const int64_t M = (int64_t)B * H * W;
  const int N = 4 * Cout;
  const int n0 = blockIdx.y * BN;
  const int n_tiles = (int)((M + kUfBM - 1) / kUfBM);
  const int my_tiles = (int)blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int n_stages = my_tiles * KC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(smem_u32(&bars[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // stage s: k-chunk s % KC of this block's tile s / KC, into slot s % stages
  auto issue = [&](int s) {
    const int slot = s % stages;
    const int tile = blockIdx.x + (s / KC) * gridDim.x;
    const uint32_t bar = smem_u32(&bars[slot]);
    mbar_expect_tx(bar, kUfStage);
    tma_load_2d(xs + slot * kUfStage, &tm_x, (s % KC) * kUfBK, tile * kUfBM, bar);
  };
  if (threadIdx.x == 0)
    for (int s = 0; s < stages && s < n_stages; ++s) issue(s);
  // While the first stages are copied: the block's Kg^T [n][k] =
  // round(w[k][o][a][c]) for its columns n = (2a + c) Cout + o, zero past N
  // and Cin, 8 channels (16 bytes) a thread at a time, neighbouring threads
  // on neighbouring columns, each piece q of row n where TMA's 128-byte
  // swizzle puts it (q ^ n % 8); then the bias of the columns. No host-side
  // copy of the weight, so the wrapper issues this one launch.
  for (int i = threadIdx.x; i < KC * BN * 8; i += kUfThreads) {
    const int n = i % BN, q = (i / BN) % 8, kc = i / (BN * 8);
    const int ng = n0 + n, k0 = kc * kUfBK + q * 8;
    const int ph = ng / Cout, o = ng - ph * Cout;
    alignas(16) bf16 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = __float2bfloat16(ng < N && k0 + j < Cin
                                  ? w[((int64_t)(k0 + j) * Cout + o) * 4 + ph] : 0.f);
    *reinterpret_cast<uint4*>(ws + kc * Tile::kWChunk + n * 128 + ((q ^ (n & 7)) << 4)) =
        *reinterpret_cast<const uint4*>(v);
  }
  for (int i = threadIdx.x; i < BN; i += kUfThreads)
    bs[i] = n0 + i < N ? bias[(n0 + i) % Cout] : 0.f;
  // where column piece q (columns n0 + 8q..) of a pixel goes, from the
  // pixel's output offset: phase row a = n / (2 Cout), 2 Cout contiguous
  // values there; -1 past N
  for (int q = threadIdx.x; q < BN / 8; q += kUfThreads) {
    const int n = n0 + 8 * q, a = n / (2 * Cout);
    col_off[q] = n < N ? a * (int64_t)(2 * W) * Cout + (n - a * 2 * Cout) : -1;
  }
  fence_proxy_async();  // the weights' stores, to wgmma
  __syncthreads();

  float acc[NB][32];
  for (int s = 0; s < n_stages; ++s) {
    const int slot = s % stages, kc = s % KC;
    mbar_wait(smem_u32(&bars[slot]), (s / stages) & 1);
    // D[m][n] (+)= A B: A the tile's 128 pixels x 64 channels, warpgroup wg
    // its 64 rows; B the weights' 64 channels of BN columns; both K-major,
    // 128-byte rows swizzled by TMA, 8-row groups 1024 bytes apart (SBO); a
    // 16-channel k-step is +32 bytes of the start.
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kUfBK / 16; ++kk) {
      const uint64_t a = wg_desc(xs + slot * kUfStage + wg * 64 * 128 + kk * 32, 16, 1024);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        wgmma_n64_k(acc[nb], a,
                    wg_desc(ws + kc * Tile::kWChunk + nb * 64 * 128 + kk * 32, 16, 1024),
                    kc > 0 || kk > 0);
    }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) wg_fence_regs(acc[nb]);
    __syncthreads();  // both warpgroups are past the slot's products: it takes stage s + stages
    if (threadIdx.x == 0 && s + stages < n_stages) issue(s + stages);
    if (kc != KC - 1) continue;
    // The epilogue: the f32 bias added, one rounding, into the out tile
    // (lane (g, t) of warp wl holds acc[nb][4j + v] = D[16 wl + g + (v / 2)
    // 8][64 nb + 8j + 2t + v % 2] of its warpgroup's rows), and each row's
    // output offset (its pixel (2h, 2w)) decoded once; then 16-byte pieces
    // of it to the phases. For a pixel, the columns of phase row a are 2 Cout
    // contiguous values of out row 2h + a, so each piece (2 Cout a multiple
    // of 8) is one 16-byte store, and neighbouring pieces of a row run on in
    // memory.
    const int64_t m0 = (int64_t)(blockIdx.x + (s / KC) * gridDim.x) * kUfBM;
    if (threadIdx.x < kUfBM) {
      const int64_t m = m0 + threadIdx.x;
      row_off[threadIdx.x] = m < M ? out_base(m, H, W) * Cout : -1;
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wg * 64 + wl * 16 + g + 8 * h, c = nb * 64 + 8 * j + 2 * t;
          *reinterpret_cast<__nv_bfloat162*>(&os[r * Tile::kRowO + c]) = __floats2bfloat162_rn(
              acc[nb][4 * j + 2 * h] + bs[c], acc[nb][4 * j + 2 * h + 1] + bs[c + 1]);
        }
    __syncthreads();
    for (int i = threadIdx.x; i < kUfBM * (BN / 8); i += kUfThreads) {
      const int r = i / (BN / 8), q = i % (BN / 8);
      const int64_t ro = row_off[r], co = col_off[q];
      if (ro >= 0 && co >= 0)
        *reinterpret_cast<uint4*>(out + ro + co) =
            *reinterpret_cast<const uint4*>(&os[r * Tile::kRowO + 8 * q]);
    }
    // the next epilogue writes the out tile after the next stage's barrier
  }
}

// ---------------------------------------------------------------------------
// bf16 dx: the persistent wgmma kernel
// ---------------------------------------------------------------------------

// A block's shared memory for a BN-column tile (a slice of Cin), `kc`
// k-chunks of 4 Cout and `stages` DY stages: 1024 bytes of slack that align
// the swizzled tiles to 1024 (and hold the mbarriers, an mbarrier a stage,
// in the part of it the alignment leaves: 1024 minus the slack taken lie
// after the tiles, the rest before them, so 48 bytes lie on one side); the
// block's Kg slice [BN][64] a k-chunk; the DY ring [BM][64] a stage; the
// rounded dx tile [BM][BN] bf16. Where the whole slice does not fit (4 Cout
// above ~1400 at BN 64), it is streamed: a Kg chunk a ring stage, formed
// beside its DY chunk (smem_streamed).
template <int BN>
struct UpDx {
  static constexpr int kMinBlocks = 2;  // resident blocks an SM
  static constexpr int kWChunk = BN * kUfBK * 2;
  static constexpr int kOut = kUfBM * BN * 2;
  __host__ __device__ static int smem(int kc, int stages) {
    return 1024 + kc * kWChunk + stages * kUfStage + kOut;
  }
  __host__ __device__ static int smem_streamed(int stages) {
    return 1024 + stages * (kWChunk + kUfStage) + kOut;
  }
};

// cp.async.wait_group with a count known at run time (the ring's stages).
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    default: cp_async_wait<5>(); break;
  }
}

// dx[pixel m][ci] = round(sum_n DY[m][n] Kg[ci][n]): block (bx, by) takes
// the input channels [by BN, (by + 1) BN) and walks the pixel tiles bx,
// bx + gridDim.x, ...; each tile's k-chunks (64 columns n of DY) are the
// stages of one ring, by TMA (`use_tma`, the map tm_dy of dy as [B H][2][W]
// [2 Cout] with a box of 64 values x the tile's pixels of one phase row) or
// by 16-byte cp.async pieces. `w` is the f32 weight [Cin, Cout, 2, 2] as
// the module holds it: the Kg slice is formed from it here, whole, or with
// `streamed` a chunk a stage.
template <int BN>
__global__ void __launch_bounds__(kUfThreads, UpDx<BN>::kMinBlocks)
    upconv_dx_wg_kernel(const __grid_constant__ CUtensorMap tm_dy, const bf16* __restrict__ dy,
                        const float* __restrict__ w, bf16* __restrict__ dx, int B, int H, int W,
                        int Cin, int Cout, int stages, int use_tma, int streamed) {
  using Tile = UpDx<BN>;
  constexpr int NB = BN / 64;  // wgmma n64 products a k-step
  extern __shared__ __align__(16) unsigned char up_dx_smem[];
  const int slack = (int)((1024 - (smem_u32(up_dx_smem) & 1023)) & 1023);
  const int K = 4 * Cout, two_c = 2 * Cout;
  const int KC = (K + kUfBK - 1) / kUfBK;
  unsigned char* ws = up_dx_smem + slack;                          // [KC or stages][BN][64]
  unsigned char* ds = ws + (streamed ? stages : KC) * Tile::kWChunk;  // [stages][BM][64]
  unsigned char* os = ds + stages * kUfStage;      // [BM][BN]
  uint64_t* bars = reinterpret_cast<uint64_t*>(slack >= 8 * kUfMaxStages ? up_dx_smem
                                                                          : os + Tile::kOut);

  const int64_t M = (int64_t)B * H * W;
  const int n0 = blockIdx.y * BN;
  const int n_tiles = (int)((M + kUfBM - 1) / kUfBM);
  const int my_tiles = (int)blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int n_stages = my_tiles * KC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;

  if (use_tma && threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(smem_u32(&bars[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // stage s: k-chunk s % KC of this block's tile s / KC, into slot s %
  // stages; the chunk's 64 columns n lie in phase row a = n / (2 Cout) where
  // TMA serves (2 Cout a multiple of 64), at offset n - a 2 Cout of its 2
  // Cout contiguous values. Piece p of row r lands at p ^ (r % 8), as TMA's
  // 128-byte swizzle puts it.
  auto issue = [&](int s) {
    const int slot = s % stages, kc = s % KC;
    const int64_t m0 = (int64_t)(blockIdx.x + (s / KC) * gridDim.x) * kUfBM;
    unsigned char* dst = ds + slot * kUfStage;
    if (use_tma) {
      if (threadIdx.x != 0) return;
      const int a = kc * kUfBK / two_c;
      const uint32_t bar = smem_u32(&bars[slot]);
      mbar_expect_tx(bar, kUfStage);
      tma_load_4d(dst, &tm_dy, kc * kUfBK - a * two_c, (int)(m0 % W), a, (int)(m0 / W), bar);
      return;
    }
    for (int i = threadIdx.x; i < kUfBM * 8; i += kUfThreads) {
      const int r = i >> 3, p = i & 7, n = kc * kUfBK + 8 * p;
      const int64_t m = m0 + r;
      const bool on = m < M && n < K;
      const bf16* src = dy;
      if (on) {
        const int a = n / two_c;
        src = dy + (out_base(m, H, W) + a * (int64_t)(2 * W)) * Cout + (n - a * two_c);
      }
      cp_async<16>(dst + r * 128 + ((p ^ (r & 7)) << 4), src, on);
    }
  };
  // Streamed: k-chunk kc of the Kg slice into `dst` [BN][64], 16-byte
  // pieces swizzled as below, element by element from the f32 weight.
  auto form_chunk = [&](int kc, unsigned char* dst) {
    for (int i = threadIdx.x; i < BN * 8; i += kUfThreads) {
      const int ci = i % BN, q = i / BN, n = kc * kUfBK + 8 * q;
      alignas(16) bf16 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int o = (n + j) % Cout, ph = (n + j) / Cout;
        v[j] = __float2bfloat16(n0 + ci < Cin && n + j < K
                                    ? w[((int64_t)(n0 + ci) * Cout + o) * 4 + ph] : 0.f);
      }
      *reinterpret_cast<uint4*>(dst + ci * 128 + ((q ^ (ci & 7)) << 4)) =
          *reinterpret_cast<const uint4*>(v);
    }
  };
  if (use_tma) {
    for (int s = 0; s < stages && s < n_stages; ++s) issue(s);
  } else {
    for (int s = 0; s < stages; ++s) {  // one group a stage, empty past the walk
      if (s < n_stages) issue(s);
      cp_async_commit();
    }
  }
  if (streamed)
    for (int s = 0; s < stages && s < n_stages; ++s) form_chunk(s % KC, ws + s * Tile::kWChunk);
  // While the first stages are copied: the block's Kg slice [ci][n] =
  // round(w[ci][o][a][c]) at n = (2a + c) Cout + o, each 16-byte piece q of
  // row ci where the swizzle puts it (q ^ ci % 8). The pieces past Cin or K
  // are zero; the others are written by one float4 a thread, the four
  // phases of (ci, o), neighbouring threads on neighbouring o. No host-side
  // copy of the weight, so the wrapper issues this one launch.
  for (int i = threadIdx.x; i < (streamed ? 0 : KC * BN * 8); i += kUfThreads) {
    const int ci = i % BN, q = (i / BN) % 8, kc = i / (BN * 8);
    if (n0 + ci < Cin && kc * kUfBK + 8 * q < K) continue;
    *reinterpret_cast<uint4*>(ws + kc * Tile::kWChunk + ci * 128 + ((q ^ (ci & 7)) << 4)) =
        make_uint4(0, 0, 0, 0);
  }
  const int n_ci = streamed ? 0 : Cin - n0 < BN ? Cin - n0 : BN;
  for (int i = threadIdx.x; i < n_ci * Cout; i += kUfThreads) {
    const int ci = i / Cout, o = i - ci * Cout;
    const float4 v = *reinterpret_cast<const float4*>(w + ((int64_t)(n0 + ci) * Cout + o) * 4);
    const float ph[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = q * Cout + o, c = n % kUfBK;
      *reinterpret_cast<bf16*>(ws + (n / kUfBK) * Tile::kWChunk + ci * 128 +
                               (((c >> 3) ^ (ci & 7)) << 4) + (c & 7) * 2) =
          __float2bfloat16(ph[q]);
    }
  }
  fence_proxy_async();  // the weights' stores, to wgmma
  __syncthreads();

  float acc[NB][32];
  for (int s = 0; s < n_stages; ++s) {
    const int slot = s % stages, kc = s % KC;
    if (use_tma) {
      mbar_wait(smem_u32(&bars[slot]), (s / stages) & 1);
    } else {
      cp_async_wait_upto(stages - 1);  // this thread's pieces of stage s have landed
      fence_proxy_async();             // ... and are visible to wgmma
      __syncthreads();                 // every thread's
    }
    // D[m][ci] (+)= A B: A the tile's 128 pixels x 64 columns of DY,
    // warpgroup wg its 64 rows; B the Kg slice's BN rows x the same 64
    // columns; both K-major, 128-byte rows swizzled, 8-row groups 1024 bytes
    // apart (SBO); a 16-column k-step is +32 bytes of the start.
    const unsigned char* wk = ws + (streamed ? slot : kc) * Tile::kWChunk;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kUfBK / 16; ++kk) {
      const uint64_t a = wg_desc(ds + slot * kUfStage + wg * 64 * 128 + kk * 32, 16, 1024);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        wgmma_n64_k(acc[nb], a, wg_desc(wk + nb * 64 * 128 + kk * 32, 16, 1024),
                    kc > 0 || kk > 0);
    }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) wg_fence_regs(acc[nb]);
    __syncthreads();  // both warpgroups are past the slot's products: it takes stage s + stages
    if (s + stages < n_stages) {
      issue(s + stages);
      if (streamed) {  // read by wgmma after the next stage's barrier
        form_chunk((s + stages) % KC, ws + slot * Tile::kWChunk);
        fence_proxy_async();
      }
    }
    if (!use_tma) cp_async_commit();
    if (kc != KC - 1) continue;
    // The epilogue: one rounding into the dx tile (lane (g, t) of warp wl
    // holds acc[nb][4j + v] = D[16 wl + g + (v / 2) 8][64 nb + 8j + 2t + v %
    // 2] of its warpgroup's rows; piece 8 nb + j of row r at (8 nb + j) ^ r %
    // 8, so a warp's pairs fall on 32 banks), then 16-byte pieces of whole
    // dx rows.
    const int64_t m0 = (int64_t)(blockIdx.x + (s / KC) * gridDim.x) * kUfBM;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wg * 64 + wl * 16 + g + 8 * h, q = nb * 8 + j;
          *reinterpret_cast<__nv_bfloat162*>(os + r * (BN * 2) + ((q ^ (r & 7)) << 4) + 4 * t) =
              __floats2bfloat162_rn(acc[nb][4 * j + 2 * h], acc[nb][4 * j + 2 * h + 1]);
        }
    __syncthreads();
    for (int i = threadIdx.x; i < kUfBM * (BN / 8); i += kUfThreads) {
      const int r = i / (BN / 8), q = i % (BN / 8);
      const int64_t m = m0 + r;
      if (m < M && n0 + 8 * q < Cin)
        *reinterpret_cast<uint4*>(dx + m * Cin + n0 + 8 * q) =
            *reinterpret_cast<const uint4*>(os + r * (BN * 2) + ((q ^ (r & 7)) << 4));
    }
    // the next epilogue writes the dx tile after the next stage's barrier
  }
}

// ---------------------------------------------------------------------------
// bf16 dW: the ring kernel
// ---------------------------------------------------------------------------

constexpr int kRingBK = 64;  // pixels a slice
constexpr int kRingStagesUp = 3;

// A block's shape for a BM (Cin) x BN (4*Cout) tile: warps of 32 rows x
// BN / 4 columns; staged rows of BM (x) and BN (dy) bf16 plus 8 of padding;
// a stage holds one slice of both; then the warp rows' db sums.
template <int BM, int BN>
struct UpRing {
  static constexpr int kWN = BN / 4;
  static constexpr int kRows = BM / 32;
  static constexpr int kThreads = kRows * 4 * 32;
  static constexpr int kMinBlocks = BM == 64 && BN == 128 ? 2 : 1;  // resident blocks an SM
  static constexpr int kRowA = BM + 8, kRowB = BN + 8;
  static constexpr int kStage = kRingBK * (kRowA + kRowB);  // bf16
  static constexpr int kSmem = kRingStagesUp * kStage * 2 + kRows * BN * 4;
  static_assert(BM * BN * 4 <= kRingStagesUp * kStage * 2, "the dW tile fits the ring");
};

// Eight columns [n, n + 8) of DY at pixel m (dy [B, 2H, 2W, Cout]): one
// 16-byte piece when Cout % 4 == 0 (the piece then lies in one phase row a),
// else element by element; zero past M or N.
__device__ __forceinline__ const bf16* dy_piece(const bf16* dy, int64_t m, int n, int H, int W,
                                                int Cout) {
  const int a = n / (2 * Cout), rem = n - a * 2 * Cout;
  return dy + (out_base(m, H, W) + a * (int64_t)(2 * W)) * Cout + rem;
}

template <int BM, int BN>
__global__ void __launch_bounds__(UpRing<BM, BN>::kThreads, UpRing<BM, BN>::kMinBlocks)
    upconv_dw_ring_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                          float* __restrict__ part_w, float* __restrict__ part_b, int B, int H,
                          int W, int Cin, int Cout) {
  using Tile = UpRing<BM, BN>;
  constexpr int RA = Tile::kRowA, RB = Tile::kRowB, WN = Tile::kWN, NT = Tile::kThreads;
  constexpr int QA = BM / 8, QB = BN / 8;
  extern __shared__ __align__(16) unsigned char up_ring_smem[];
  bf16* ring = reinterpret_cast<bf16*>(up_ring_smem);
  float* db_s = reinterpret_cast<float*>(ring + kRingStagesUp * Tile::kStage);  // [rows][BN]

  const int64_t M = (int64_t)B * H * W;
  const int N = 4 * Cout;
  const int ci0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp / 4, wm = wr * 32, wn = (warp % 4) * WN;  // warp tile origin
  const int g = lane >> 2, t = lane & 3;
  const int lj = lane & 7, lq = lane >> 3;
  const bool vec_a = (Cin & 7) == 0, vec_b = (Cout & 3) == 0;
  const bool db_on = blockIdx.x == 0;  // the first row tile sums DY's columns
  const int64_t n_slices = (M + kRingBK - 1) / kRingBK;
  const int my_slices =
      blockIdx.z < n_slices ? (int)((n_slices - 1 - blockIdx.z) / gridDim.z) + 1 : 0;

  // Copies of this block's k-th slice into stage `st`. A thread keeps one
  // 8-wide column of each operand (NT is a multiple of BM / 8 and BN / 8),
  // so its dy column's phase row a and offset are fixed; a slice within one
  // input row (W a multiple of kRingBK, as on the path) is decoded once.
  static_assert(NT % QA == 0 && NT % QB == 0, "a fixed column a thread");
  const int qa = threadIdx.x % QA, qb = threadIdx.x % QB;
  const int ca = ci0 + qa * 8, nb = n0 + qb * 8;
  const int pa_row = nb / (2 * Cout), pa_off = nb - pa_row * 2 * Cout;
  auto issue = [&](int k, int st) {
    const int64_t slice = blockIdx.z + (int64_t)k * gridDim.z;
    if (slice >= n_slices) return;
    const int64_t m0 = slice * kRingBK;
    bf16* as = ring + st * Tile::kStage;
    bf16* bs = as + kRingBK * RA;
    for (int kk = threadIdx.x / QA; kk < kRingBK; kk += NT / QA) {
      const int64_t m = m0 + kk;
      const bool on = m < M && ca < Cin;
      bf16* dst = &as[kk * RA + qa * 8];
      if (vec_a) {
        cp_async<16>(dst, on ? x + m * Cin + ca : x, on);
      } else {
        alignas(16) bf16 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = m < M && ca + j < Cin ? x[m * Cin + ca + j] : __float2bfloat16(0.f);
        store16<bf16>(dst, 0, v);
      }
    }
    const bool one_row = m0 % W + kRingBK <= W;
    const int64_t base0 = out_base(m0, H, W);
    for (int kk = threadIdx.x / QB; kk < kRingBK; kk += NT / QB) {
      const int64_t m = m0 + kk;
      bf16* dst = &bs[kk * RB + qb * 8];
      if (vec_b) {
        const bool on = m < M && nb < N;
        const int64_t ob = one_row ? base0 + 2 * kk : out_base(m, H, W);
        cp_async<16>(dst, on ? dy + (ob + pa_row * (int64_t)(2 * W)) * Cout + pa_off : dy, on);
      } else {
        alignas(16) bf16 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = m < M && nb + j < N ? *dy_piece(dy, m, nb + j, H, W, Cout)
                                     : __float2bfloat16(0.f);
        store16<bf16>(dst, 0, v);
      }
    }
  };

  float acc[2][WN / 8][4], dbacc[WN / 16][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < WN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
  for (int h = 0; h < WN / 16; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) dbacc[h][e] = 0.f;
  const uint32_t ones = 0x3F803F80u;  // two bf16 1.0

#pragma unroll
  for (int k = 0; k < kRingStagesUp - 1; ++k) {
    issue(k, k);
    cp_async_commit();
  }
  for (int k = 0; k < my_slices; ++k) {
    const int st = k % kRingStagesUp;
    cp_async_wait<kRingStagesUp - 2>();  // slice k has landed
    // every warp is past the products of slice k - 1: its stage is free
    __syncthreads();
    issue(k + kRingStagesUp - 1, (k + kRingStagesUp - 1) % kRingStagesUp);
    cp_async_commit();
    const bf16* as = ring + st * Tile::kStage;
    const bf16* bs = as + kRingBK * RA;
#pragma unroll
    for (int kk = 0; kk < kRingBK / 16; ++kk) {
      // A[ci][k] = x at pixel k, B[k][n] = DY at pixel k: both stored
      // k-major, their fragments transposed quarters (as the conv dW's).
      uint32_t bf[WN / 16][4];
#pragma unroll
      for (int h = 0; h < WN / 16; ++h)  // n-tiles 2h and 2h + 1
        ldmatrix_x4_trans(bf[h], &bs[(kk * 16 + (lq & 1) * 8 + lj) * RB + wn +
                                     (2 * h + (lq >> 1)) * 8]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t af[4];
        ldmatrix_x4_trans(af, &as[(kk * 16 + (lq >> 1) * 8 + lj) * RA + wm + i * 16 +
                                  (lq & 1) * 8]);
#pragma unroll
        for (int j = 0; j < WN / 8; ++j)
          mma_bf16(acc[i][j], af, bf[j >> 1][(j & 1) * 2], bf[j >> 1][(j & 1) * 2 + 1]);
      }
      // db: DY^T's fragment for columns 16h..16h+15 is {b0 of n-tile 2h,
      // b0 of 2h + 1, b1 of 2h, b1 of 2h + 1}; times ones, row i of the
      // product is the column sum of column 16h + i
      if (db_on && (k * (kRingBK / 16) + kk) % Tile::kRows == wr) {
#pragma unroll
        for (int h = 0; h < WN / 16; ++h) {
          const uint32_t at[4] = {bf[h][0], bf[h][2], bf[h][1], bf[h][3]};
          mma_bf16(dbacc[h], at, ones, ones);
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (the groups past the end are empty)
  __syncthreads();     // every warp is past its products: the ring takes the dW tile

  // dW: thread (g, t) holds acc[i][j][hr*2+e] = D[wm + i*16 + g + hr*8][wn + j*8 + 2t + e],
  // staged as the block's [BM][BN] tile, then written to partials[z]
  // ([Cin, N]) a row of BN consecutive floats at a time. db: lane (g, 0)
  // holds the sums of columns wn + 16h + g (dbacc[h][0]) and + 8
  // (dbacc[h][2]); the warp rows' sums are added in order.
  float* out_s = reinterpret_cast<float*>(up_ring_smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int j = 0; j < WN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          out_s[(wm + i * 16 + g + hr * 8) * BN + wn + j * 8 + 2 * t + e] = acc[i][j][hr * 2 + e];
  if (db_on && t == 0) {
#pragma unroll
    for (int h = 0; h < WN / 16; ++h) {
      db_s[wr * BN + wn + h * 16 + g] = dbacc[h][0];
      db_s[wr * BN + wn + h * 16 + g + 8] = dbacc[h][2];
    }
  }
  __syncthreads();
  float* pw = part_w + (int64_t)blockIdx.z * Cin * N;
  for (int i = threadIdx.x; i < BM * BN; i += NT) {
    const int r = i / BN, c = i % BN;
    if (ci0 + r < Cin && n0 + c < N) pw[(int64_t)(ci0 + r) * N + n0 + c] = out_s[i];
  }
  if (!db_on) return;
  for (int c = threadIdx.x; c < BN; c += NT) {
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < Tile::kRows; ++r) v += db_s[r * BN + c];
    if (n0 + c < N) part_b[(int64_t)blockIdx.z * N + n0 + c] = v;
  }
}

// ---------------------------------------------------------------------------
// f32: FMA
// ---------------------------------------------------------------------------

constexpr int kUpBM = 64, kUpBN = 64, kUpBK = 16;

// acc += A[m0 + ty*4 + i, k] B[k, n0 + tx*4 + j] over the 16-deep slices
// k_begin, k_begin + k_step, ... below K; `a` views A, `b` views B^T.
template <class VA, class VB, class Hook>
__device__ void fma_mainloop(float (&acc)[4][4], float (*xs)[kUpBM], float (*ws)[kUpBN],
                             int64_t m0, int64_t n0, int64_t k_begin, int64_t k_step, int64_t K,
                             const VA& a, const VB& b, const Hook& hook) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int64_t k0 = k_begin; k0 < K; k0 += k_step) {
    __syncthreads();
    for (int e = threadIdx.x; e < kUpBK * kUpBM; e += kUpThreads) {
      const int kk = e % kUpBK, mm = e / kUpBK;
      xs[kk][mm] = a.at(m0 + mm, k0 + kk);
    }
    for (int e = threadIdx.x; e < kUpBK * kUpBN; e += kUpThreads) {
      const int nn = e % kUpBN, kk = e / kUpBN;
      ws[kk][nn] = b.at(n0 + nn, k0 + kk);
    }
    __syncthreads();
    hook(&ws[0][0]);
#pragma unroll
    for (int kk = 0; kk < kUpBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w}, br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }
}

// Column sums of the staged DY slice (ws[k][column]) for db.
struct FmaDbHook {
  float* sum;
  bool on;
  __device__ void operator()(const float* ws) const {
    if (!on || threadIdx.x >= kUpBN) return;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kUpBK; ++k) s += ws[k * kUpBN + threadIdx.x];
    *sum += s;
  }
};

struct NoHookF {
  __device__ void operator()(const float*) const {}
};

#define FMA_TILE_INIT                                          \
  __shared__ __align__(16) float xs[kUpBK][kUpBM];             \
  __shared__ __align__(16) float ws[kUpBK][kUpBN];             \
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;      \
  float acc[4][4];                                             \
  for (int i = 0; i < 4; ++i)                                  \
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

template <typename T>
__global__ void __launch_bounds__(kUpThreads)
upconv_kernel(const T* __restrict__ x, const T* __restrict__ kg, const float* __restrict__ bias,
              T* __restrict__ out, int B, int H, int W, int Cin, int Cout) {
  FMA_TILE_INIT
  const int64_t M = (int64_t)B * H * W;
  const int N = 4 * Cout;
  const int64_t m0 = (int64_t)blockIdx.x * kUpBM;
  const int n0 = blockIdx.y * kUpBN;
  // B = Kg [Cin, N]: its transpose is column-major [N, Cin]
  fma_mainloop(acc, xs, ws, m0, n0, 0, kUpBK, Cin, RowMajor<T>{x, M, Cin},
               ColMajor<T>{kg, N, Cin}, NoHookF{});
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty * 4 + i;
    if (m >= M) continue;
    const int64_t base = out_base(m, H, W);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      const int q = n / Cout, o = n - q * Cout;
      out[(base + phase(q, W)) * Cout + o] = from_f32<T>(acc[i][j] + bias[o]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kUpThreads)
upconv_dx_kernel(const T* __restrict__ dy, const T* __restrict__ kg, T* __restrict__ dx, int B,
                 int H, int W, int Cin, int Cout) {
  FMA_TILE_INIT
  const int64_t M = (int64_t)B * H * W;
  const int64_t m0 = (int64_t)blockIdx.x * kUpBM;
  const int n0 = blockIdx.y * kUpBN;
  fma_mainloop(acc, xs, ws, m0, n0, 0, kUpBK, 4 * Cout, DyGather<T>{dy, M, H, W, Cout, false},
               RowMajor<T>{kg, Cin, 4 * Cout}, NoHookF{});
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < Cin) dx[m * Cin + n] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kUpThreads)
upconv_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ part_w,
                 float* __restrict__ part_b, int B, int H, int W, int Cin, int Cout) {
  FMA_TILE_INIT
  const int64_t M = (int64_t)B * H * W;
  const int N = 4 * Cout;
  const int64_t m0 = (int64_t)blockIdx.x * kUpBM;
  const int n0 = blockIdx.y * kUpBN;
  const int s = blockIdx.z, S = gridDim.z;
  float db = 0.f;
  fma_mainloop(acc, xs, ws, m0, n0, (int64_t)s * kUpBK, (int64_t)S * kUpBK, M,
               ColMajor<T>{x, Cin, M}, DyGather<T>{dy, M, H, W, Cout, true},
               FmaDbHook{&db, blockIdx.x == 0});
  float* pw = part_w + (int64_t)s * Cin * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty * 4 + i;
    if (m >= Cin) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) pw[m * N + n] = acc[i][j];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < kUpBN && n0 + threadIdx.x < N)
    part_b[(int64_t)s * N + n0 + threadIdx.x] = db;
}

// ---------------------------------------------------------------------------
// Fixed-order sums of the dW / db partials
// ---------------------------------------------------------------------------

// dw[j] = sum over s of part_w[s][j]; db[o] = sum over s, then over the 4
// phases q, of part_b[s][q*Cout + o]. One thread per output, each summing
// in a fixed order.
__global__ void upconv_dw_reduce_kernel(const float* __restrict__ part_w,
                                        const float* __restrict__ part_b, int S, int64_t nw,
                                        int Cout, float* __restrict__ dw, float* __restrict__ db) {
  // Threads [0, nw) sum dw; from nw rounded up to whole warps, thread
  // 4o + q sums phase q of db[o] and the o's q = 0 lane adds its four
  // phases in order. Each sum over s runs in order from 0 (sum_rows, 16
  // loads in flight): the sums above, bit for bit.
  const int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t nw_pad = (nw + 31) / 32 * 32;
  if (j < nw_pad) {
    if (j < nw) dw[j] = sum_rows<16>(part_w + j, S, nw);
    return;
  }
  const int64_t d = j - nw_pad;
  const int o = (int)(d >> 2), q = (int)(d & 3);
  const float aq = o < Cout ? sum_rows<16>(part_b + q * Cout + o, S, 4 * Cout) : 0.f;
  const float a1 = __shfl_down_sync(0xffffffffu, aq, 1);
  const float a2 = __shfl_down_sync(0xffffffffu, aq, 2);
  const float a3 = __shfl_down_sync(0xffffffffu, aq, 3);
  if (q == 0 && o < Cout) db[o] = (((0.f + aq) + a1) + a2) + a3;
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

inline dim3 tiles(int64_t rows, int64_t cols, int bm, int bn, int splits = 1) {
  return dim3((unsigned)((rows + bm - 1) / bm), (unsigned)((cols + bn - 1) / bn), splits);
}

// A wgmma kernel's dynamic shared memory above 48 KB (the forward's, DX
// false; the dx's, DX true), allowed once per instance and device (at the
// most a block can have).
template <int BN, bool DX>
cudaError_t up_wg_smem_allowed() {
  static bool done[16] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 16 && done[dev]) return cudaSuccess;
  cudaError_t err;
  if constexpr (DX)
    err = cudaFuncSetAttribute(upconv_dx_wg_kernel<BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kUfSmemMax);
  else
    err = cudaFuncSetAttribute(upconv_fwd_wg_kernel<BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kUfSmemMax);
  if (err == cudaSuccess && dev < 16) done[dev] = true;
  return err;
}

// bf16 forward on the wgmma kernel with the wrapper's column tile BN, ring
// of `stages` and `blocks` x (N / BN) persistent blocks, from the f32
// weight [Cin, Cout, 2, 2]. Needs Cin % 8 == 0 (16-byte rows for TMA) and
// Cout % 4 == 0 (16-byte output pieces).
template <int BN>
int upconv_fwd_wg_launch(const void* x, const void* w, const void* bias, void* out, int B,
                         int H, int W, int Cin, int Cout, int stages, int blocks,
                         cudaStream_t st) {
  const int64_t M = (int64_t)B * H * W;
  const int smem = UpFwd<BN>::smem((Cin + kUfBK - 1) / kUfBK, stages);
  if ((Cin & 7) || (Cout & 3) || stages < 2 || stages > kUfMaxStages || blocks < 1 ||
      smem > kUfSmemMax)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = up_wg_smem_allowed<BN, false>();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tm_x;
  if ((err = tm_rows(&tm_x, x, M, Cin, kUfBM)) != cudaSuccess) return (int)err;
  const dim3 grid(blocks, (4 * Cout + BN - 1) / BN);
  upconv_fwd_wg_kernel<BN><<<grid, kUfThreads, smem, st>>>(
      tm_x, static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<bf16*>(out), B, H, W, Cin, Cout, stages);
  return (int)cudaGetLastError();
}

// bf16 dx on the wgmma kernel with the wrapper's column tile BN (of Cin),
// ring of `stages` and `blocks` x (Cin / BN) persistent blocks, from the
// f32 weight [Cin, Cout, 2, 2]. Needs Cin % 8 == 0 (16-byte dx pieces) and
// Cout % 4 == 0 (16-byte dy pieces, each in one phase row). DY comes by TMA
// where a box serves: 2 Cout a multiple of 64 (a k-chunk in one phase row)
// and W a multiple or a divisor of 128 (a pixel tile is the pixels of one
// row, or of whole rows: the box is 64 values x min(W, 128) pixels x one
// phase row x 128 / min(W, 128) rows); else by cp.async.
// The Kg slice is resident where it fits at (BN, stages), else streamed.
template <int BN>
int upconv_dx_wg_launch(const void* dy, const void* w, void* dx, int B, int H, int W, int Cin,
                        int Cout, int stages, int blocks, cudaStream_t st) {
  const int resident = UpDx<BN>::smem((4 * Cout + kUfBK - 1) / kUfBK, stages);
  const int streamed = resident > kUfSmemMax;
  const int smem = streamed ? UpDx<BN>::smem_streamed(stages) : resident;
  if ((Cin & 7) || (Cout & 3) || stages < 2 || stages > kUfMaxStages || blocks < 1 ||
      smem > kUfSmemMax)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = up_wg_smem_allowed<BN, true>();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tm_dy = {};
  const int use_tma = (2 * Cout) % kUfBK == 0 && (W % kUfBM == 0 || kUfBM % W == 0);
  if (use_tma) {
    const int bw = W < kUfBM ? W : kUfBM;
    const cuuint64_t dims[4] = {(cuuint64_t)(2 * Cout), (cuuint64_t)W, 2, (cuuint64_t)B * H};
    const cuuint64_t strides[3] = {(cuuint64_t)Cout * 4, (cuuint64_t)W * Cout * 4,
                                   (cuuint64_t)W * Cout * 8};
    const cuuint32_t box[4] = {(cuuint32_t)kUfBK, (cuuint32_t)bw, 1, (cuuint32_t)(kUfBM / bw)};
    if ((err = tm_tiled(&tm_dy, dy, 4, dims, strides, box, kUfBK)) != cudaSuccess)
      return (int)err;
  }
  const dim3 grid(blocks, (Cin + BN - 1) / BN);
  upconv_dx_wg_kernel<BN><<<grid, kUfThreads, smem, st>>>(
      tm_dy, static_cast<const bf16*>(dy), static_cast<const float*>(w), static_cast<bf16*>(dx),
      B, H, W, Cin, Cout, stages, use_tma, streamed);
  return (int)cudaGetLastError();
}

// What the card gives a wgmma instance (the forward's, DX false; the dx's,
// DX true) at `smem` dynamic bytes: {resident blocks an SM, registers a
// thread, local (spilled) bytes a thread, smem}.
template <int BN, bool DX>
int upconv_wg_info(int smem, int* out) {
  cudaError_t err = up_wg_smem_allowed<BN, DX>();
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  if constexpr (DX) {
    err = cudaFuncGetAttributes(&attr, upconv_dx_wg_kernel<BN>);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], upconv_dx_wg_kernel<BN>,
                                                          kUfThreads, smem);
  } else {
    err = cudaFuncGetAttributes(&attr, upconv_fwd_wg_kernel<BN>);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], upconv_fwd_wg_kernel<BN>,
                                                          kUfThreads, smem);
  }
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = smem;
  return (int)err;
}

// The fixed-order sums of `splits` dW / db partials.
int upconv_dw_reduce(const void* part_w, const void* part_b, void* dw, void* db, int Cin,
                     int Cout, int splits, cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t nw = (int64_t)Cin * 4 * Cout;
  const int64_t threads = (nw + 31) / 32 * 32 + 4 * (int64_t)Cout;
  upconv_dw_reduce_kernel<<<(unsigned)((threads + 127) / 128), 128, 0, st>>>(
      static_cast<const float*>(part_w), static_cast<const float*>(part_b), splits, nw, Cout,
      static_cast<float*>(dw), static_cast<float*>(db));
  return (int)cudaGetLastError();
}

// The ring kernel's dynamic shared memory above 48 KB, allowed once per
// instance and device.
template <int BM, int BN>
cudaError_t up_ring_smem_allowed() {
  static bool done[16] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 16 && done[dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      upconv_dw_ring_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      UpRing<BM, BN>::kSmem);
  if (err == cudaSuccess && dev < 16) done[dev] = true;
  return err;
}

// bf16 dW on the ring kernel with the wrapper's BM x BN tile.
template <int BM, int BN>
int upconv_dw_ring_launch(const void* x, const void* dy, void* part_w, void* part_b, void* dw,
                          void* db, int B, int H, int W, int Cin, int Cout, int splits,
                          cudaStream_t st) {
  using Tile = UpRing<BM, BN>;
  const cudaError_t err = up_ring_smem_allowed<BM, BN>();
  if (err != cudaSuccess) return (int)err;
  upconv_dw_ring_kernel<BM, BN><<<tiles(Cin, 4 * Cout, BM, BN, splits), Tile::kThreads,
                                  Tile::kSmem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), static_cast<float*>(part_w),
      static_cast<float*>(part_b), B, H, W, Cin, Cout);
  return upconv_dw_reduce(part_w, part_b, dw, db, Cin, Cout, splits, st);
}

// What the card gives a ring instance: {resident blocks an SM, registers a
// thread, local (spilled) bytes a thread, dynamic shared bytes a block}.
template <int BM, int BN>
int upconv_dw_ring_info(int* out) {
  cudaError_t err = up_ring_smem_allowed<BM, BN>();
  if (err != cudaSuccess) return (int)err;
  using Tile = UpRing<BM, BN>;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, upconv_dw_ring_kernel<BM, BN>);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], upconv_dw_ring_kernel<BM, BN>,
                                                      Tile::kThreads, Tile::kSmem);
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = Tile::kSmem;
  return (int)err;
}

int upconv_dw_fma_launch(const void* x, const void* dy, void* part_w, void* part_b, void* dw,
                         void* db, int B, int H, int W, int Cin, int Cout, int splits,
                         cudaStream_t st) {
  upconv_dw_kernel<float><<<tiles(Cin, 4 * Cout, kUpBM, kUpBN, splits), kUpThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy), static_cast<float*>(part_w),
      static_cast<float*>(part_b), B, H, W, Cin, Cout);
  return upconv_dw_reduce(part_w, part_b, dw, db, Cin, Cout, splits, st);
}

}  // namespace
}  // namespace cltorch

// Plain C interface, loaded with ctypes; each returns cudaGetLastError().
// The wrapper (cl_tpu_torch/kernels/upconv_pack.py) checks the operands:
// contiguous, 16-byte-aligned NHWC x [B, H, W, Cin] and dy
// [B, 2H, 2W, Cout] of one type (the bf16 forward and dx: Cin % 8 == 0 and
// Cout % 4 == 0); the weight as the module holds it (f32 [Cin, Cout, 2, 2])
// for the bf16 forward and dx, else as Kg [Cin, 4*Cout] of x's type;
// f32 bias [Cout]. dW: `part_w` holds splits * Cin * 4*Cout floats,
// `part_b` splits * 4*Cout; dw [Cin, 4*Cout] and db [Cout] are f32.
extern "C" {

// The forward: bf16 on the wgmma kernel with the column tile bn (64 or
// 128), `stages` x stages and `blocks` persistent blocks a column tile, as
// kernels/upconv_pack.py::fwd_tile / fwd_blocks pick them, `kg` the f32
// weight [Cin, Cout, 2, 2]; f32 on FMAs (bn, stages, blocks unread; `kg` is
// Kg [Cin, 4*Cout]).
int cltorch_upconv_fwd(const void* x, const void* kg, const void* bias, void* out, int B, int H,
                       int W, int Cin, int Cout, int bn, int stages, int blocks, int is_bf16,
                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    const int64_t M = (int64_t)B * H * W;
    cltorch::upconv_kernel<float><<<cltorch::tiles(M, 4 * Cout, cltorch::kUpBM, cltorch::kUpBN),
                                    cltorch::kUpThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(kg),
        static_cast<const float*>(bias), static_cast<float*>(out), B, H, W, Cin, Cout);
    return (int)cudaGetLastError();
  }
#define CLTORCH_UP_FWD(BN)                                                                    \
  if (bn == BN)                                                                               \
    return cltorch::upconv_fwd_wg_launch<BN>(x, kg, bias, out, B, H, W, Cin, Cout, stages,  \
                                             blocks, st);
  CLTORCH_UP_FWD(64)
  CLTORCH_UP_FWD(128)
#undef CLTORCH_UP_FWD
  return (int)cudaErrorInvalidValue;
}

// The forward's instance bn at `smem` dynamic bytes on this card: out[4] as
// upconv_wg_info.
int cltorch_upconv_fwd_info(int bn, int smem, int* out) {
  if (bn == 64) return cltorch::upconv_wg_info<64, false>(smem, out);
  if (bn == 128) return cltorch::upconv_wg_info<128, false>(smem, out);
  return (int)cudaErrorInvalidValue;
}

// dx: bf16 on the wgmma kernel with the column tile bn (64 or 128 of Cin),
// `stages` DY stages and `blocks` persistent blocks a column tile, as
// kernels/upconv_pack.py::dx_tile / dx_blocks pick them, `kg` the f32
// weight [Cin, Cout, 2, 2]; f32 on FMAs (bn, stages, blocks unread; `kg` is
// Kg [Cin, 4*Cout]).
int cltorch_upconv_dx(const void* dy, const void* kg, void* dx, int B, int H, int W, int Cin,
                      int Cout, int bn, int stages, int blocks, int is_bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    const int64_t M = (int64_t)B * H * W;
    cltorch::upconv_dx_kernel<float><<<cltorch::tiles(M, Cin, cltorch::kUpBM, cltorch::kUpBN),
                                       cltorch::kUpThreads, 0, st>>>(
        static_cast<const float*>(dy), static_cast<const float*>(kg), static_cast<float*>(dx),
        B, H, W, Cin, Cout);
    return (int)cudaGetLastError();
  }
#define CLTORCH_UP_DX(BN)                                                                     \
  if (bn == BN)                                                                               \
    return cltorch::upconv_dx_wg_launch<BN>(dy, kg, dx, B, H, W, Cin, Cout, stages, blocks, st);
  CLTORCH_UP_DX(64)
  CLTORCH_UP_DX(128)
#undef CLTORCH_UP_DX
  return (int)cudaErrorInvalidValue;
}

// The dx's instance bn at `smem` dynamic bytes on this card: out[4] as
// upconv_wg_info.
int cltorch_upconv_dx_info(int bn, int smem, int* out) {
  if (bn == 64) return cltorch::upconv_wg_info<64, true>(smem, out);
  if (bn == 128) return cltorch::upconv_wg_info<128, true>(smem, out);
  return (int)cudaErrorInvalidValue;
}

// The ring instances: (BM, BN) as kernels/upconv_pack.py::dw_ring_tile
// picks them; any other pair is refused (cudaErrorInvalidValue).
#define CLTORCH_UP_RING_DISPATCH(CALL)                 \
  if (bm == 64 && bn == 128) return CALL(64, 128);     \
  if (bm == 64 && bn == 256) return CALL(64, 256);     \
  if (bm == 128 && bn == 128) return CALL(128, 128);   \
  if (bm == 128 && bn == 256) return CALL(128, 256);   \
  return (int)cudaErrorInvalidValue;

// dW and db: bf16 on the ring kernel with the (bm, bn) tile, f32 on FMAs
// (bm, bn unread).
int cltorch_upconv_dw(const void* x, const void* dy, void* part_w, void* part_b, void* dw,
                      void* db, int B, int H, int W, int Cin, int Cout, int splits, int bm,
                      int bn, int is_bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return cltorch::upconv_dw_fma_launch(x, dy, part_w, part_b, dw, db, B, H, W, Cin, Cout,
                                         splits, st);
#define CLTORCH_UP_RING_LAUNCH(BM, BN)                                                        \
  cltorch::upconv_dw_ring_launch<BM, BN>(x, dy, part_w, part_b, dw, db, B, H, W, Cin, Cout, \
                                         splits, st)
  CLTORCH_UP_RING_DISPATCH(CLTORCH_UP_RING_LAUNCH)
#undef CLTORCH_UP_RING_LAUNCH
}

// The ring instance (bm, bn) on this card: out[4] as upconv_dw_ring_info.
int cltorch_upconv_dw_ring_info(int bm, int bn, int* out) {
#define CLTORCH_UP_RING_INFO(BM, BN) cltorch::upconv_dw_ring_info<BM, BN>(out)
  CLTORCH_UP_RING_DISPATCH(CLTORCH_UP_RING_INFO)
#undef CLTORCH_UP_RING_INFO
}

}  // extern "C"
