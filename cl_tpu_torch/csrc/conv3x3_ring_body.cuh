// The bf16 ring body of the packed conv's forward (#32) and dx (#34, #35),
// and of the plain conv (#30, #40): conv_ring_body<MODE, COT, CK, EPI>,
// instanced for kFwd and kDx (conv3x3_ring.cu) and kPlain (conv3x3_bn.cu,
// conv3x3_g2.cu, through conv3x3_plain_body.cuh). It replaces, for those,
// the first body (conv3x3_body.cuh::conv3x3_mma_body), which still serves
// the dx from int8 (#38). kPlain forms nothing (no prologue, no e), sums
// nothing and keeps no vectors; it runs a ring of three stages and its
// products on wgmma (below).
//
// TPU kernels: cl_tpu/pallas/conv3x3_v3.py::_fwd_bn_kernel (launched at
// conv3x3_v3.py:833), ::_dx_slim_kernel (:1233) and ::_dx_bn_kernel (:1259).
//
// What bounds them on the H100 (bf16, batch 8, a shape (H, Cin -> Cout) of
// the forward conv; the bound is the larger of the bytes each input read
// once and each output written once at 3.35 TB/s and the products at 989
// TFLOP/s; chip_smoke.packed_bytes_ops / bwd_bytes_ops):
//
//   shape              #32 bound    #34 bound    #35 bound
//   512, 3 -> 32       0.044 ms        -            -
//   512, 32 -> 32      0.080        0.120        0.160
//   256, 32 -> 64      0.030        0.050          -
//   256, 64 -> 64      0.040        0.060        0.080
//   128, 64 -> 128     0.020 (ops)  0.025          -
//   128, 128 -> 128    0.039 (ops)  0.039 (ops)  0.040
//
// bytes at levels 0 and 1, the tensor cores at level 2. The first body ran
// at 4-6x these bounds at levels 1-2 and 1.1-1.35x cuDNN at level 0. What
// this body does about each cause that held it:
//
// - Nothing overlapped (each 16-channel chunk staged through registers, two
//   barriers a chunk). A block is persistent: it walks the pixel tiles
//   blockIdx.x, + gridDim.x, ... of all B images for one tile of COT output
//   channels (one wave of resident blocks, kernels/conv3x3.py::
//   conv_ring_blocks), and within each tile its input channels in chunks of
//   CK (32, or 16 where the ring would not fit or the width takes plain
//   loads): one flat sequence of stages (tile, chunk). The raw window of a
//   stage (the 18 x 18 pixels of the tile with its one-pixel halo: x, or
//   the dx's dy) goes through a ring of two stages: while the products of
//   stage k run, stage k + 1 is copied in (with the dx's stats, its y
//   window too, into a window of its own); then stage k + 1 is transformed
//   in place; one barrier a stage. One thread copies a window as one 4-d
//   TMA box (zeros outside the image) into rows of CK bf16 with the 32- or
//   64-byte swizzle, completing on the stage's mbarrier. Widths that are
//   not a multiple of 8 (the stem's 3: a 6-byte pixel is no TMA row) are
//   staged by plain loads a stage ahead, formed as they land (stage8_t /
//   stage8_e). A third stage, with the transform of stage k + 1 spread
//   over the taps of stage k, measured slower on the H100 (its registers),
//   as did transforming a thread's pieces in batches.
// - Weights re-staged by every block (as many bytes as the windows). The
//   block's 9 x COT x Cin weights are loaded once, by TMA, and stay
//   resident for its whole walk where they fit beside the ring (every shape
//   of the headline step: at most 147,456 bytes, at 128^2). Weight bytes a
//   launch: 256 blocks x 18 KB = 4.7 MB at 512^2 x 32 -> 32 and 128 blocks
//   x 147 KB = 18.9 MB at 128^2 x 128 -> 128 (the forward, 64 + 64 output
//   channels; the dx the same), against the first body's 151 MB at both.
//   Where they do not fit (9 x COT x Cin past ~150 KB: Cin > 256 at COT
//   32), each stage carries its weight chunk (TMA), as the first body staged
//   them.
// - 32-bit fragment loads. The A fragments (window) and B fragments
//   (weights) come from ldmatrix.x4, into the registers mma_chunk loaded
//   them into: a tap's A is two ldmatrix.x4, its B one per two n-tiles.
// - Transforms and re-reads. t = round(relu(x a + b)) and e = round(dy +
//   ds1 + 2 y ds2) are formed once per element of a window, in place, with
//   stage8_t's / stage8_e's f32 arithmetic and one rounding (or, under
//   CL_TPU_E_BF16, their bf16 chains: p.ew_bf16); a, b, ds1, ds2
//   are staged in shared memory once per block (zero past the channels).
//   Out-of-image pixels keep TMA's zeros (the transform skips them): zero
//   padding in t-space and in e-space, never relu(b) or ds1. The forward
//   takes Cout = 128 in one channel tile (COT 128, 128 f32 accumulators a
//   thread) where its weights fit resident (128^2 x 64 -> 128), so the
//   window is read and t formed once; at 128 -> 128 (295 KB of weights) it
//   takes two tiles of 64 with resident weights, whose second read of the
//   window (33.5 MB) comes from L2 (COT 128 with the weights travelling
//   with each stage measured no faster). The halo's 1.27x reads stay.
// - #35's epilogue. The dx is instanced with (EPI) and without the
//   prologue's epilogue, so #34 carries none of its registers. #35 reads x
//   as bf16 pairs: where x's rows are 16-byte multiples and the tile fits
//   (levels 0 and 1), from a 16 x 16 x COT tile that TMA copies in while
//   the tile multiplies, else from global memory with all loads in flight
//   first; a and b from shared memory. A tile's sums over the warps are
//   taken after the next barrier, from one of two slots, so the epilogue
//   waits at no barrier of its own.
//
// The tile: 256 threads, 8 warps, a 16 x 16 pixel tile; warp w owns output
// rows 2w and 2w + 1 (two m16 tiles, one image row each) and all COT
// channels, mma.sync m16n8k16 with f32 accumulation, as the first body.
// The forward and the dx stay on mma.sync: the dx keeps mma.sync's
// per-output order (below), and the forward shares the body. mma.sync runs
// at ~3.4 cycles an m16n8k16 an SM here (the forward at 128^2 without its
// prologue), which holds levels 1 and 2 at ~3.6x their bounds. The plain
// conv (kPlain), whose bits nothing else repeats, takes wgmma with A from
// registers: warp w of a warpgroup supplies rows 16w .. 16w + 15 of the
// 64-row A as mma.sync's A fragment, which the ldmatrix.x4 here loads at
// any tap offset, so no 64 contiguous pixels are needed (wgmma with A in
// shared memory would need them, or a layout whose one-pixel tap shift is
// a descriptor offset under the swizzle); B is the tap's weight slice by
// descriptor (wgmma.cuh::wg_desc's 32- and 64-byte swizzles).
//
// Why the dx's order is fixed: the one-pass backward (#37) must give
// #34/#35's bits (chip_smoke.compare_fused), as the pipelined dx (34p/35p,
// this body's dx itself in bf16) does (compare_pipe). So each dx output is accumulated as the first body does:
// its 16-channel chunks ascending, within a chunk the taps 0-8, each one
// mma.sync m16n8k16 on the same bf16 operands (a CK = 32 stage is two such
// chunks in order; a chunk wholly past Cin is skipped, as the first body's
// loop never reaches it), and the epilogue's partial row of da and db is
// one per 16 x 16 tile, summed in mma_epilogue's thread order (a thread's
// pixels in the order row, half; shuffles over xor 4, 8, 16; the warps in
// order). The forward keeps that accumulation too (its y bits are the first
// body's), but sums its statistics per block: each tile's row is added, in
// the block's tile order, to a row kept in shared memory, and the block
// writes one partial row (gridDim.x rows in all), which a second launch
// sums in a fixed order. No float atomics: a run repeats its sums bit for
// bit.
#pragma once

#include "conv3x3_body.cuh"
#include "conv3x3_tma.cuh"
#include "wgmma.cuh"

namespace cltorch {
namespace {

constexpr int kRingConvThreads = 256;  // 8 warps x 2 output rows of a 16 x 16 tile
constexpr int kRingConvStages = 2;     // the products of one, the copies of the next
constexpr int kPlainStages = 3;        // kPlain: the products of one, the copies of two
constexpr int kRingConvWin = kWinH * kWinW;  // window pixels

// The launch's schedule and staging, as the wrapper picks them
// (kernels/conv3x3.py::conv_ring_tile, conv_ring_blocks).
struct RingArgs {
  int batch;
  int resident;  // the block's weights stay in shared memory for its walk
  int tma;       // windows and weights by TMA (Cin a multiple of 8)
  int xbuf;      // #35: the epilogue's x tile by TMA, while the tile multiplies
};

// Sizes of a COT x CK instance, in bytes. A window chunk is the 18 x 18
// pixels' CK channels, rounded up to 1024 bytes (the swizzles repeat within
// 1024 bytes); a weight chunk is [9][COT][CK].
template <int COT, int CK>
struct ConvRingTile {
  static_assert(CK == 16 || CK == 32, "16 or 32 input channels a stage");
  static_assert(COT == 32 || COT == 64 || COT == 128, "32, 64 or 128 output channels");
  static constexpr int kWinB = (kRingConvWin * CK * 2 + 1023) / 1024 * 1024;
  static constexpr int kWchB = 9 * COT * CK * 2;
  static constexpr int kXB = kTH * kTW * COT * 2;  // #35's x tile
  // registers for two blocks an SM at 32 output channels, one else
  static constexpr int kMinBlocks = COT == 32 ? 2 : 1;
};

// Dynamic shared bytes of a launch (mirrored by conv3x3.conv_ring_smem):
// 1024 bytes of alignment slack; the resident weights (nch chunks) or none;
// two stages, each the window (x or dy) and, without resident weights, the
// stage's weight chunk; the dx's y window when e is formed in place (one:
// it is read only by the transform); #35's x tile (16 x 16 x COT) where
// it is copied in; then in f32 the input channels' vectors (a, b or ds1,
// ds2: 2 x nch x CK), the dx epilogue's a and b (2 x COT), the warps' sums
// (two slots of 8 x 2 x COT), the forward's block sums (2 x COT); then five
// mbarriers.
template <int COT, int CK>
__host__ __device__ constexpr int conv_ring_smem(bool dx, bool stats, bool resident, bool xbuf,
                                                 int Cin) {
  using Tile = ConvRingTile<COT, CK>;
  const int nch = (Cin + CK - 1) / CK;
  const bool y_win = stats && (Cin & 7) == 0;  // by TMA; plain loads form e as they land
  const int stage = Tile::kWinB + (resident ? 0 : Tile::kWchB);
  const int floats = 2 * nch * CK + (dx ? 2 * COT : 0) + 32 * COT + (dx ? 0 : 2 * COT);
  return 1024 + (resident ? nch * Tile::kWchB : 0) + kRingConvStages * stage +
         (y_win ? Tile::kWinB : 0) + (xbuf ? Tile::kXB : 0) + 4 * floats + 40;
}

// Dynamic shared bytes of a plain launch (kPlain; mirrored by
// conv3x3.conv_plain_smem): the alignment slack, the resident weights or
// none, kPlainStages stages (each the window and, without resident
// weights, its weight chunk), then their mbarriers and three more; no
// vectors and no sums.
template <int COT, int CK>
__host__ __device__ constexpr int conv_plain_smem(bool resident, int Cin) {
  using Tile = ConvRingTile<COT, CK>;
  const int nch = (Cin + CK - 1) / CK;
  return 1024 + (resident ? nch * Tile::kWchB : 0) +
         kPlainStages * (Tile::kWinB + (resident ? 0 : Tile::kWchB)) + 8 * (kPlainStages + 3);
}

// Byte offset of the 16-byte piece q of row r in rows of CK bf16, swizzled
// as TMA's 32- or 64-byte swizzle writes them (tm_swizzle): the piece is
// XORed with the row's address bits 7 and up.
template <int CK>
__device__ __forceinline__ int ring_at(int r, int q) {
  return r * CK * 2 + ((q ^ ((r * CK * 2 >> 7) & (CK / 8 - 1))) << 4);
}

template <int MODE, int COT, int CK, bool EPI>
__device__ __forceinline__ void conv_ring_body(const ConvArgs<bf16>& p, const RingArgs& ra,
                                               const CUtensorMap* tm_in, const CUtensorMap* tm_y,
                                               const CUtensorMap* tm_w, const CUtensorMap* tm_x) {
  static_assert(MODE == kFwd || MODE == kDx || MODE == kPlain,
                "the ring body is the forward, the dx and the plain conv");
  using Tile = ConvRingTile<COT, CK>;
  constexpr bool DX = MODE == kDx;
  constexpr bool PLAIN = MODE == kPlain;  // no transform, no sums: y stored
  constexpr bool DXP = DX && EPI;  // #35: the dx with the prologue's epilogue
  constexpr int NT = COT / 8, QC = CK / 8, S = PLAIN ? kPlainStages : kRingConvStages;
  constexpr int kWinB = Tile::kWinB, kWchB = Tile::kWchB;
  extern __shared__ __align__(16) unsigned char conv_ring_smem_raw[];
  unsigned char* base =
      conv_ring_smem_raw + ((1024 - (smem_u32(conv_ring_smem_raw) & 1023)) & 1023);
  const int H = p.H, W = p.W, Cin = p.Cin, Cout = p.Cout;
  const int nch = (Cin + CK - 1) / CK;
  const bool stats = DX && p.s1 != nullptr;  // the dx's e formed from dy and y
  const bool form = ra.tma && (DX ? stats : p.prologue != 0);  // a transform in place
  const bool y_win = ra.tma && stats;                           // the y window, by TMA
  const int stage_b = kWinB + (ra.resident ? 0 : kWchB);
  unsigned char* w_res = base;  // [nch][9][COT][CK], resident
  unsigned char* ring = base + (ra.resident ? nch * kWchB : 0);
  unsigned char* y_s = ring + S * stage_b;  // the y window of the stage being formed
  const bool xbuf = DXP && ra.xbuf;
  unsigned char* x_s = y_s + (y_win ? kWinB : 0);  // #35: the tile's x [16 x 16][COT]
  float* va = reinterpret_cast<float*>(x_s + (xbuf ? Tile::kXB : 0));  // a or ds1, over nch * CK
  float* vb = va + (PLAIN ? 0 : nch * CK);                    // b or ds2
  float* xa = vb + (PLAIN ? 0 : nch * CK);                    // dx epilogue: a, b over COT
  float* xb = xa + (DX ? COT : 0);
  // the warps' sums of a tile, in two slots (tile parity): a tile's are
  // summed after the next barrier, while the next tile's are written
  float(*red)[kRingConvThreads / 32][2][COT] =
      reinterpret_cast<float(*)[kRingConvThreads / 32][2][COT]>(xb + (DX ? COT : 0));
  float* tsum = reinterpret_cast<float*>(red + 2);  // forward: [2][COT]
  // the stages', the weights', the y window's and the x tile's mbarriers
  uint64_t* bars = PLAIN ? reinterpret_cast<uint64_t*>(va)
                         : reinterpret_cast<uint64_t*>(tsum + (DX ? 0 : 2 * COT));
  constexpr int kBarW = S, kBarY = S + 1, kBarX = S + 2;

  const int co0 = blockIdx.y * COT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, li = lane >> 3;  // ldmatrix: the row and matrix this lane addresses
  const int tiles_x = (W + kTW - 1) / kTW, tiles = tiles_x * ((H + kTH - 1) / kTH);
  const int n_tiles = ra.batch * tiles;
  const int my_tiles =
      (int)blockIdx.x < n_tiles ? (n_tiles - 1 - (int)blockIdx.x) / gridDim.x + 1 : 0;
  const int n_stages = my_tiles * nch;

  // the per-channel vectors, zero past the channels (t and e stay 0 there)
  for (int c = threadIdx.x; c < (PLAIN ? 0 : nch * CK); c += kRingConvThreads) {
    const bool on = c < Cin && (DX ? stats : p.prologue != 0);
    va[c] = on ? (DX ? p.s1[c] : p.pa[c]) : 0.f;
    vb[c] = on ? (DX ? p.s2[c] : p.pb[c]) : 0.f;
  }
  for (int c = threadIdx.x; c < (PLAIN ? 0 : COT); c += kRingConvThreads) {
    if constexpr (DX) {
      const bool on = DXP && co0 + c < Cout;
      xa[c] = on ? p.pa[co0 + c] : 0.f;
      xb[c] = on ? p.pb[co0 + c] : 0.f;
    } else {
      tsum[c] = tsum[COT + c] = 0.f;
    }
  }
  if ((ra.tma || xbuf) && threadIdx.x == 0) {
    for (int i = 0; i < S + 3; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the resident weights: TMA boxes of CK input channels, or plain loads
  if (ra.resident && n_stages > 0) {
    if (ra.tma) {
      if (threadIdx.x == 0) {
        const uint32_t bar = smem_u32(&bars[kBarW]);
        mbar_expect_tx(bar, nch * kWchB);
        for (int c = 0; c < nch; ++c) tma_load_3d(w_res + c * kWchB, tm_w, c * CK, co0, 0, bar);
      }
    } else {
      for (int i = threadIdx.x; i < nch * 9 * COT * QC; i += kRingConvThreads) {
        const int q = i % QC, row = (i / QC) % (9 * COT), c = i / (QC * 9 * COT);
        const int co = row % COT, tap = row / COT, ci = c * CK + q * 8;
        const bool in_co = co0 + co < Cout;
        stage8_t(reinterpret_cast<bf16*>(w_res + c * kWchB + ring_at<CK>(row, q)),
                 p.w + (in_co ? ((int64_t)tap * Cout + co0 + co) * Cin + ci : 0), ci, Cin, in_co,
                 0, nullptr, nullptr);
      }
    }
  }

  // Stage k's image, tile origin and first input channel.
  auto coords = [&](int k, int& b, int& rem, int& gy0, int& gx0, int& ci0) {
    const int tile = blockIdx.x + (k / nch) * gridDim.x;
    b = tile / tiles;
    rem = tile % tiles;
    gy0 = (rem / tiles_x) * kTH;
    gx0 = (rem % tiles_x) * kTW;
    ci0 = (k % nch) * CK;
  };
  // The copies of stage k into its slot of the ring (and its y window):
  // TMA boxes (one thread), or plain loads formed as they land.
  auto issue = [&](int k) {
    if (k >= n_stages) return;
    int b, rem, gy0, gx0, ci0;
    coords(k, b, rem, gy0, gx0, ci0);
    unsigned char* st = ring + (k % S) * stage_b;
    if (ra.tma) {
      if (threadIdx.x == 0) {
        const uint32_t bar = smem_u32(&bars[k % S]);
        mbar_expect_tx(bar, kRingConvWin * CK * 2 + (ra.resident ? 0 : kWchB));
        tma_load_4d(st, tm_in, ci0, gx0 - 1, gy0 - 1, b, bar);
        if (!ra.resident) tma_load_3d(st + kWinB, tm_w, ci0, co0, 0, bar);
        if (y_win) {
          const uint32_t ybar = smem_u32(&bars[kBarY]);
          mbar_expect_tx(ybar, kRingConvWin * CK * 2);
          tma_load_4d(y_s, tm_y, ci0, gx0 - 1, gy0 - 1, b, ybar);
        }
      }
      return;
    }
    const int64_t img = (int64_t)b * H * W;
    with_ew(p.ew_bf16, [&](auto ew) {
      constexpr bool EW = decltype(ew)::value;
      for (int i = threadIdx.x; i < kRingConvWin * QC; i += kRingConvThreads) {
        const int pix = i / QC, q = i % QC;
        const int gy = gy0 - 1 + pix / kWinW, gx = gx0 - 1 + pix % kWinW, c = ci0 + q * 8;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
        const int64_t off = inside ? (img + (int64_t)gy * W + gx) * Cin + c : 0;
        bf16* dst = reinterpret_cast<bf16*>(st + ring_at<CK>(pix, q));
        if constexpr (DX)
          stage8_e<EW>(dst, p.in + off, stats ? p.y + off : nullptr, c, Cin, inside, p.s1,
                       p.s2);
        else
          stage8_t<EW>(dst, p.in + off, c, Cin, inside, p.prologue, p.pa, p.pb);
      }
    });
  };
  // t or e of stage k, in place, once per element, at in-image pixels,
  // once stage k (and its y window) have landed.
  auto transform = [&](int k) {
    int b, rem, gy0, gx0, ci0;
    coords(k, b, rem, gy0, gx0, ci0);
    unsigned char* st = ring + (k % S) * stage_b;
    mbar_wait(smem_u32(&bars[k % S]), (k / S) & 1);
    if (y_win) mbar_wait(smem_u32(&bars[kBarY]), k & 1);
    with_ew(p.ew_bf16, [&](auto ew) {
      constexpr bool EW = decltype(ew)::value;
      for (int i = threadIdx.x; i < kRingConvWin * QC; i += kRingConvThreads) {
        const int pix = i / QC, q = i % QC;
        const int gy = gy0 - 1 + pix / kWinW, gx = gx0 - 1 + pix % kWinW;
        if (gy < 0 || gy >= H || gx < 0 || gx >= W) continue;  // TMA's zeros stay
        const int at = ring_at<CK>(pix, q), c = ci0 + q * 8;
        alignas(16) bf16 v[8];
        alignas(16) float av[8], bv[8];
        load16<bf16>(v, reinterpret_cast<const bf16*>(st + at), 0);
        load16<float>(reinterpret_cast<float(&)[4]>(av[0]), va + c, 0);
        load16<float>(reinterpret_cast<float(&)[4]>(av[4]), va + c + 4, 0);
        load16<float>(reinterpret_cast<float(&)[4]>(bv[0]), vb + c, 0);
        load16<float>(reinterpret_cast<float(&)[4]>(bv[4]), vb + c + 4, 0);
        if constexpr (DX) {
          alignas(16) bf16 yv[8];
          load16<bf16>(yv, reinterpret_cast<const bf16*>(y_s + at), 0);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            v[j] = __float2bfloat16(
                e_ew<EW>(__bfloat162float(v[j]), __bfloat162float(yv[j]), av[j], bv[j]));
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            v[j] = __float2bfloat16(prologue_ew<EW>(__bfloat162float(v[j]), av[j], bv[j]));
        }
        store16<bf16>(reinterpret_cast<bf16*>(st + at), 0, v);
      }
    });
  };

  float acc[2][NT][4];
  if constexpr (PLAIN) {  // defined before the first product (which overwrites them)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][n][j] = 0.f;
  }
  // The products of stage k: its 16-channel chunks below Cin in order, each
  // the nine taps in order, one mma.sync per (tap, n-tile, m-tile).
  auto products = [&](int k) {
    const unsigned char* st = ring + (k % S) * stage_b;
    const unsigned char* ws = ra.resident ? w_res + (k % nch) * kWchB : st + kWinB;
    const int left = Cin - (k % nch) * CK;
#pragma unroll
    for (int j = 0; j < CK / 16; ++j) {
      if (j * 16 >= left) break;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap % 3;
        // A: matrices (pixels 0-7 | 8-15) x (k 0-7 | 8-15) of output row
        // 2 warp + m at the tap's shift: a[m] = mma_chunk's four registers
        uint32_t a[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int pix = (warp * 2 + m + ky) * kWinW + kx + (li & 1) * 8 + lr;
          ldmatrix_x4(a[m], st + ring_at<CK>(pix, 2 * j + (li >> 1)));
        }
        // B: n-tiles 2 n2 and 2 n2 + 1, each its k 0-7 and 8-15
#pragma unroll
        for (int n2 = 0; n2 < NT / 2; ++n2) {
          uint32_t bq[4];
          const int row = tap * COT + (2 * n2 + (li >> 1)) * 8 + lr;
          ldmatrix_x4(bq, ws + ring_at<CK>(row, 2 * j + (li & 1)));
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma_bf16(acc[m][2 * n2], a[m], bq[0], bq[1]);
            mma_bf16(acc[m][2 * n2 + 1], a[m], bq[2], bq[3]);
          }
        }
      }
    }
  };
  // The products of stage k for the plain conv, on wgmma with A from
  // registers: per 16-channel chunk below Cin and tap, each warpgroup
  // multiplies its two 64-row A tiles (m: row 2 warp + m of each of its
  // four warps, loaded by the ldmatrix.x4 above at the tap's shift) by the
  // tap's [COT][16] weight slice, read by descriptor from its rows of CK
  // bf16 under the 32- or 64-byte swizzle (the chunk's k16 a 32-byte step
  // of the start). A tap's A goes into the next of three register buffers
  // (nine taps a chunk: a tap's buffer is its own across chunks and
  // stages) once the products that read it three taps before are done,
  // while the two taps between run; a tile's first product overwrites the
  // accumulators. Only weights that travel with the stage are waited for
  // before the stage's slot is copied over; the tile's epilogue waits for
  // all of them (wg_wait).
  uint32_t wa[3][2][4];
  auto products_wg = [&](int k) {
    const unsigned char* st = ring + (k % S) * stage_b;
    const unsigned char* ws = ra.resident ? w_res + (k % nch) * kWchB : st + kWinB;
    const int left = Cin - (k % nch) * CK;
    constexpr int kLayout = CK == 16 ? 3 : 2;  // the 32- or 64-byte swizzle
#pragma unroll
    for (int j = 0; j < CK / 16; ++j) {
      if (j * 16 >= left) break;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap % 3, buf = tap % 3;
        wg_wait<2>();  // the products that read wa[buf] are done
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int pix = (warp * 2 + m + ky) * kWinW + kx + (li & 1) * 8 + lr;
          ldmatrix_x4(wa[buf][m], st + ring_at<CK>(pix, 2 * j + (li >> 1)));
        }
        const uint64_t bd = wg_desc(ws + tap * COT * CK * 2 + j * 32, 16, 8 * CK * 2, kLayout);
        const int accumulate = k % nch != 0 || j != 0 || tap != 0;
        wg_fence();
#pragma unroll
        for (int m = 0; m < 2; ++m)
          wgmma_rs<COT>(reinterpret_cast<float(&)[COT / 2]>(acc[m]), wa[buf][m], bd, accumulate);
        wg_commit();
      }
    }
    if (!ra.resident) wg_wait<0>();  // the slot's weights are copied over next
  };
  constexpr bool sums = !PLAIN && (!DX || EPI);
  // The tile of stage k: y (forward) or dx stored, and the sums: the
  // forward's added to the block's row, the dx's (da, db with the prologue)
  // written as the tile's partial row, as mma_epilogue sums them.
  auto epilogue = [&](int k) {
    int b, rem, gy0, gx0, ci0;
    coords(k, b, rem, gy0, gx0, ci0);
    const int64_t img = (int64_t)b * H * W;
    const bool pairs = (Cout & 1) == 0;
    // #35: the thread's x pairs, all loads in flight before the first use
    constexpr int XN = DXP ? NT : 1;
    __nv_bfloat162 xs[2][2][XN];
    if constexpr (DXP) {
      {
        // the copied tile: pixel tp's 16-byte piece n, swizzled as TMA wrote it
        if (xbuf) mbar_wait(smem_u32(&bars[kBarX]), (k / nch) & 1);
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int hp = 0; hp < 2; ++hp)
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              const int gy = gy0 + warp * 2 + m, gx = gx0 + g + hp * 8, o = co0 + n * 8 + 2 * t;
              const bool ok = pairs && gy < H && gx < W && o + 1 < Cout;
              const int tp = (warp * 2 + m) * kTW + g + hp * 8;
              const __nv_bfloat162* src =
                  xbuf ? reinterpret_cast<const __nv_bfloat162*>(
                             x_s + tp * COT * 2 +
                             ((n ^ ((tp * COT * 2 >> 7) & (COT / 8 - 1))) << 4) + 4 * t)
                       : reinterpret_cast<const __nv_bfloat162*>(
                             p.x + (img + (int64_t)gy * W + gx) * Cout + o);
              xs[m][hp][n] = ok ? *src : __floats2bfloat162_rn(0.f, 0.f);
            }
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int oc = n * 8 + 2 * t, o = co0 + oc;
      float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int gy = gy0 + warp * 2 + m;
#pragma unroll
        for (int hp = 0; hp < 2; ++hp) {
          const int gx = gx0 + g + hp * 8;
          if (gy >= H || gx >= W) continue;
          const int64_t pix = img + (int64_t)gy * W + gx;
          const float d0 = acc[m][n][hp * 2], d1 = acc[m][n][hp * 2 + 1];
          bf16 r0 = __float2bfloat16(0.f), r1 = r0;
          if constexpr (PLAIN) {
            r0 = __float2bfloat16(d0);
            r1 = __float2bfloat16(d1);
          } else if constexpr (!DX) {
            r0 = __float2bfloat16(d0);
            r1 = __float2bfloat16(d1);
            const float y0 = __bfloat162float(r0), y1 = __bfloat162float(r1);
            if (o < Cout) {
              s1[0] += y0;
              s2[0] = fmaf(y0, y0, s2[0]);
            }
            if (o + 1 < Cout) {
              s1[1] += y1;
              s2[1] = fmaf(y1, y1, s2[1]);
            }
          } else if constexpr (!EPI) {
            r0 = __float2bfloat16(d0);
            r1 = __float2bfloat16(d1);
          } else {
            const bf16* xp = p.x + pix * Cout + o;
            float x0 = 0.f, x1 = 0.f;
            if (pairs && o + 1 < Cout) {
              x0 = __low2float(xs[m][hp][n < XN ? n : 0]);
              x1 = __high2float(xs[m][hp][n < XN ? n : 0]);
            } else {
              if (o < Cout) x0 = __bfloat162float(xp[0]);
              if (o + 1 < Cout) x1 = __bfloat162float(xp[1]);
            }
            if (o < Cout) r0 = __float2bfloat16(prologue_bwd_one(x0, xa[oc], xb[oc], d0, s1[0], s2[0]));
            if (o + 1 < Cout)
              r1 = __float2bfloat16(prologue_bwd_one(x1, xa[oc + 1], xb[oc + 1], d1, s1[1], s2[1]));
          }
          bf16* dst = p.out + pix * Cout;
          if (pairs && o + 1 < Cout) {
            *reinterpret_cast<__nv_bfloat162*>(dst + o) = __halves2bfloat162(r0, r1);
          } else {
            if (o < Cout) dst[o] = r0;
            if (o + 1 < Cout) dst[o + 1] = r1;
          }
        }
      }
      if (sums) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            s1[j] += __shfl_xor_sync(0xffffffffu, s1[j], off);
            s2[j] += __shfl_xor_sync(0xffffffffu, s2[j], off);
          }
        if (g == 0) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            red[(k / nch) & 1][warp][0][oc + j] = s1[j];
            red[(k / nch) & 1][warp][1][oc + j] = s2[j];
          }
        }
      }
    }
  };
  // After a barrier, the sums of the tile of stage k over the warps, in
  // their order: the dx's partial row of the tile, or added to the
  // forward's row of the block.
  auto sum_tile = [&](int k) {
    int b, rem, gy0, gx0, ci0;
    coords(k, b, rem, gy0, gx0, ci0);
    for (int i = threadIdx.x; i < 2 * COT; i += kRingConvThreads) {
      const int which = i / COT, co = i % COT;
      float v = 0.f;
#pragma unroll
      for (int wp = 0; wp < kRingConvThreads / 32; ++wp) v += red[(k / nch) & 1][wp][which][co];
      if constexpr (DX) {
        if (co0 + co < Cout)
          p.partials[(int64_t)(b * tiles + rem) * 2 * Cout + which * Cout + co0 + co] = v;
      } else {
        tsum[i] += v;
      }
    }
  };

  // The ring: the copies of stage k + S - 1 (and its y window) land while the
  // products of stage k run; then stage k + 1 is transformed in place, and
  // the tile of stage k, if complete, stored.
#pragma unroll
  for (int i = 0; i < S - 1; ++i) issue(i);
  if (ra.tma && ra.resident && n_stages > 0) mbar_wait(smem_u32(&bars[kBarW]), 0);
  if (form && n_stages > 0) transform(0);
  for (int k = 0; k < n_stages; ++k) {
    if (ra.tma) mbar_wait(smem_u32(&bars[k % S]), (k / S) & 1);  // stage k has landed
    // this thread's reads and writes of the ring and the x tile, before TMA's
    // (and the plain conv's resident weights by plain loads, before wgmma's)
    if (ra.tma || xbuf || PLAIN) fence_proxy_async();
    // stage k is formed (and stored, by plain loads), and every warp is past
    // the products of stage k - 1, whose slot takes stage k + S - 1, the
    // transform that read the y window and the epilogue that read x
    __syncthreads();
    issue(k + S - 1);
    if (sums && k >= nch && k % nch == 0) sum_tile(k - 1);  // the last tile's sums
    if (xbuf && k % nch == 0 && threadIdx.x == 0) {  // #35: the tile's x, for its epilogue
      int b, rem, gy0, gx0, ci0;
      coords(k, b, rem, gy0, gx0, ci0);
      const uint32_t xbar = smem_u32(&bars[kBarX]);
      mbar_expect_tx(xbar, Tile::kXB);
      tma_load_4d(x_s, tm_x, co0, gx0, gy0, b, xbar);
    }
    if (!PLAIN && k % nch == 0) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][n][j] = 0.f;
    }
    if constexpr (PLAIN) {
      products_wg(k);
      if (k % nch == nch - 1) {  // the tile's products, before its epilogue reads them
        wg_wait<0>();
#pragma unroll
        for (int m = 0; m < 2; ++m) wg_fence_regs(reinterpret_cast<float(&)[COT / 2]>(acc[m]));
      }
    } else {
      products(k);
    }
    // the next stage's transform first: the tile's x copy has longer to land
    if (form && k + 1 < n_stages) transform(k + 1);
    if (k % nch == nch - 1) epilogue(k);
  }
  __syncthreads();
  if (sums && n_stages > 0) sum_tile(n_stages - 1);
  if constexpr (!DX && !PLAIN) {  // the block's row of the forward's sums
    for (int i = threadIdx.x; i < 2 * COT; i += kRingConvThreads) {
      const int which = i / COT, co = i % COT;
      if (co0 + co < Cout)
        p.partials[(int64_t)blockIdx.x * 2 * Cout + which * Cout + co0 + co] = tsum[i];
    }
  }
}

}  // namespace
}  // namespace cltorch
