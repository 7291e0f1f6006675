// The 3x3 SAME conv's weight-gradient bodies over NHWC, each instanced by a
// KIND: the packed conv's fused dW (#36), the plain dW (t = x, e = dy), the
// two-pass dW (#33) and the dW from int8 (#39). Shared by conv3x3_bn_bwd.cu
// (#36, #39), conv3x3_dw_bn.cu (#33, a kDwBn instance), conv3x3_v3_dw.cu
// (the gen-3 dW #31, a kDwPlain instance) and conv3x3_g2.cu (the gen-2 dW
// #41, a kDwPlain instance), with the host side of their launches (the ring
// and register-blocked instances' dispatch, their shared memory, the sum of
// their partials).
//
// The contraction runs over pixels, so the pixels are split over gridDim.z
// blocks (each takes every gridDim.z-th pixel tile) for one channel tile of
// all nine taps; each block writes its own partial dW and a second launch
// sums the partials in a fixed order (none for one split). No float
// atomics: a run repeats its sums bit for bit.
//
// * bf16, the ring body (dw_ring_body; kDwFused, #36, the headline step's
//   dW; kDwBn, #33, and kDwPlain, #41 and #31, since their redesign).
//   Bound on the H100 by bytes at 512^2 and 256^2 (x, dy and y read
//   once: 403 MB, 120 us at 3.35 TB/s at 512^2 x 32 -> 32, batch 8, against
//   39 us of tensor-core work) and by the tensor cores at 128^2 x 128 -> 128
//   (39 us against 30 us of bytes); 1.04 ms over the step's 15 convs. What it
//   does about the causes that held the first bf16 body (dw_mma_body, a
//   32 x 32 tile of nine warps staged synchronously, deleted once #39 moved
//   here) at 4.6x that bound:
//   - Nothing overlapped. The raw tiles (the x window with its one-pixel
//     halo, dy and y) go through a ring of three stages: while the products
//     of pixel tile k run, tile k + 1 is formed in the next stage and tile
//     k + 2 is copied into the third; one barrier a tile. With 32 input
//     channels or more one thread copies each operand by TMA (a 4-d box of
//     the NHWC tensor, zeros outside the image, completing on the stage's
//     mbarrier), with the 64- or 128-byte swizzle; the stem and odd widths
//     by 16-byte cp.async per pixel (a narrow x, Cin < 8, as whole window
//     rows in 4-byte pieces; widths that are not a multiple of 8 by plain
//     loads). The per-thread cp.async of every tile (about nine a thread)
//     was what held the first ring version at half the memory rate.
//   - t = round(relu(x a + b)) and e = round(dy + ds1 + 2 y ds2) are formed
//     ONCE per element, in place in the stage, with stage8_t's / stage8_e's
//     arithmetic and one rounding, or their bf16 chains under CL_TPU_E_BF16
//     (`ew_bf16`, which every bf16 body takes; kDwQ's e from deq(y), and its
//     t from deq(xq), are f32 chains whose operands are f32: the int8 tiles
//     and their scales land beside the stage, e is formed in place from them
//     and t into the stage's x window); raw x and dy are the operands
//     as they land when the prologue or the stats are off. Zero padding stays in
//     t-space: out-of-image pixels land as zeros and the transform skips
//     them (a narrow x's are written as zeros), so a padded tap is 0, never
//     relu(b); channels past Cin or Cout get a = b = ds1 = ds2 = 0.
//   - Channel re-staging. The tile is CI_T x CO_T = (16, 32 or 64) x (32 or
//     64), fitted to the shape: e is staged once per Cin chunk and t once
//     per Cout chunk, so at 64 channels each is read once and at 128 twice
//     (four times each in the 32 x 32 tiles of the first body).
//   - Tensor cores. The 64 x 64 tile (levels 1 and 2) multiplies on wgmma:
//     three warpgroups, one per kernel row, each three taps' m64n64k16 per
//     pixel row with A = e^T (64 output channels x 16 pixels) and B = the
//     shifted t window (16 pixels x 64 input channels), both MN-major in
//     shared memory with the 128-byte swizzle (a pixel's 64 channels one
//     128-byte row, K groups of 8 rows 1024 bytes apart): a tap's one-pixel
//     shift along K is +128 bytes of the descriptor's start, which the
//     swizzle, applied on address bits, follows. The transform of tile k + 1
//     runs while they do. The other tiles run mma.sync m16n8k16 with
//     ldmatrix.trans fragments, one warp per (tap, 32 output channels), CI_T
//     f32 accumulators a thread; wgmma at 32 output channels (M padded to 64)
//     measured slower than mma.sync there.
//   - The stem. Cin = 3 takes a 16-wide ci tile (mma's m16) instead of 32.
//   - Occupancy and partials. __launch_bounds__ holds two blocks an SM for
//     CO_T = 32 (CI_T <= 32) and one else: 18 warps an SM (12 on wgmma); the wrapper's
//     split picker (kernels/conv3x3.py::dw_ring_splits) derives the splits
//     from these resources, one wave of resident blocks. Each block stages
//     its dW tile in shared memory and writes its partial a weight row
//     (CI_T * 9 consecutive floats) at a time; the scattered 4-byte stores of
//     the first body cost as much as a level's bytes bound.
// * f32: FMA (TF32 would round), the first body (dw_fma_body: kDwFused
//   #36 alone). A block of 256 threads: lane = input
//   channel, warp = 4 output channels, each thread 9 taps x 4 channels of
//   accumulators; per pixel one float4 of e (a broadcast) and nine t: 3.6
//   FMAs a shared load, staged synchronously, x re-read Cout / 32 times.
// * f32, the register-blocked body (dw_reg_body: kDwBn #33, kDwPlain #41
//   and #31, kDwQ #39).
//   Bound by the FMA units (18 px Cin Cout operations at 67 TFLOP/s: 577 us
//   at 256^2 x 64 -> 64, batch 8, against 80 us of bytes). A thread holds
//   the outer product of 4 output x 4 input channels for the three taps of
//   one kernel row (48 accumulators) and walks a pixel row's 18 window
//   columns with the last three t columns in registers: one float4 of t
//   and one of e (both 16-byte shared loads) for 48 FMAs. A 32 x 64 (or
//   32 x 32) channel tile, so x is read Cout / 64 times; a ring of three
//   cp.async-fed stages (copies of tile k + 2 and the prologue of tile k + 1
//   while tile k's products run); fixed-order partials as above. No TF32:
//   the products are the direct f32 sums the TPU kernel and the plain
//   version take. kDwQ forms e (and in the xq mode t) in f32 once per
//   element from its raw int8 slots.

#pragma once

#include "conv3x3_bn.cuh"
#include "conv3x3_tma.cuh"  // TMA, mbarriers
#include "wgmma.cuh"

namespace cltorch {
namespace {

constexpr int kDwC = 32;  // input and output channels of a block's tile

// What a body computes: the fused dW (prologue if on, e formed from dy, y
// and the stats cotangents), the plain dW (t = x, e = dy), the two-pass
// dW (prologue if on, e = dy as given), or the dW from int8 saved
// activations (kDwQ: e from dy and deq(y); t from x, or from deq(xq) when
// the int8 x is given).
constexpr int kDwFused = 0, kDwPlain = 1, kDwBn = 2, kDwQ = 3;

// kDwQ's int8 operands (conv3x3_bn.cuh): y as int8 [B, H, W, Cout] with
// scales [B, H, pack, Cout]; x as int8 [B, H, W, Cin] with scales
// [B, H, pack, Cin], or null (t from x itself).
struct QArgs {
  const int8_t* yq;
  const float* ysc;
  const int8_t* xq;
  const float* xsc;
  int pack;
};

template <int KIND>
__device__ __forceinline__ int dw_prologue(int prologue) {
  return KIND == kDwPlain ? 0 : prologue;
}

template <int KIND>
__device__ __forceinline__ const float* dw_stats(const float* s) {
  return KIND == kDwFused || KIND == kDwQ ? s : nullptr;
}

// ---------------------------------------------------------------------------
// bf16: the ring body
// ---------------------------------------------------------------------------

constexpr int kRingTH = 8;                      // pixel tile rows (x kTW = 16 columns)
constexpr int kRingWinH = kRingTH + 2;          // window rows (with the halo)
constexpr int kRingWin = kRingWinH * kWinW;     // window pixels
constexpr int kRingPix = kRingTH * kTW;         // tile pixels
constexpr int kRingStages = 3;
constexpr int kRawRow = 256;  // bytes a window row of a narrow x (Cin < 8) is copied into

// A block's shape for a CI_T x CO_T channel tile. Staging: with CI_T >= 32
// (kTma) each operand is copied by one TMA load into [pixel][C_T channels],
// C_T * 2 bytes a pixel (64 or 128) with the 16-byte pieces swizzled as the
// 64- or 128-byte swizzle does (piece ^ (address bits 7 and up), from
// 1024-byte aligned buffers), out-of-image pixels zero; else (CI_T = 16, the
// stem and widths that are not a multiple of 8) by cp.async into rows of
// C_T bf16 plus 8 of padding (48, 80 or 144 bytes), and for a narrow x the
// raw window rows. Products: on mma.sync one warp per (tap, 32 output
// channels), ldmatrix.trans on those rows (on either layout the eight rows
// of an ldmatrix fall on distinct banks); on wgmma (kWg: the 64 x 64 tile)
// three warpgroups, one per kernel row ky, each its three taps' 64 (output)
// x 64 (input channel) products, whose one-pixel shift along K is +128
// bytes of the descriptor's start. A stage holds the x window and the dy
// (becoming e) and y tiles.
template <int CI_T, int CO_T>
struct RingTile {
  static_assert(CI_T % 16 == 0 && CO_T % 32 == 0, "m16 input and 32-wide output tiles");
  static constexpr bool kTma = CI_T >= 32;
  static constexpr bool kWg = CI_T == 64 && CO_T == 64;
  static constexpr int kWarps = kWg ? 12 : 9 * (CO_T / 32);
  static constexpr int kThreads = kWarps * 32;
  // resident blocks an SM: two for the 16- and 32-wide tiles of 32 output
  // channels, else one (the shared memory holds one 64 x 32 block anyway)
  static constexpr int kMinBlocks = CO_T == 32 && CI_T <= 32 ? 2 : 1;
  static constexpr int kRowX = kTma ? CI_T : CI_T + 8, kRowE = kTma ? CO_T : CO_T + 8;  // bf16
  static constexpr int kX = kTma ? (kRingWin * CI_T * 2 + 1023) / 1024 * 512 : kRingWin * kRowX;
  static constexpr int kE = kRingPix * kRowE;
  static constexpr int kY = kE;
  static constexpr int kRaw = CI_T == 16 ? kRingWinH * kRawRow / 2 : 0;
  static constexpr int kStage = kX + kE + kY + kRaw;  // bf16
  // the ring, the per-channel vectors, and with TMA the stages' mbarriers
  // and the slack that aligns the ring to 1024 bytes
  static constexpr int kSmem =
      kRingStages * kStage * 2 + (2 * CI_T + 2 * CO_T) * 4 + (kTma ? kRingStages * 8 + 1024 : 0);
  // accumulators a thread: 3 taps x 32 (wgmma m64n64), or CI_T / 16 x 4
  // n-tiles of 4 (mma.sync)
  static constexpr int kAccRows = kWg ? 3 : CI_T / 16 * 4, kAccCols = kWg ? 32 : 4;
  static_assert(CO_T * CI_T * 9 * 4 <= kRingStages * kStage * 2, "the dW tile fits the ring");
  static_assert(!kTma || kStage % 512 == 0, "1024-byte aligned stages");
  // where 8 channels q of a staged pixel start, in bf16: rows of R bf16,
  // swizzled with TMA (R = 32: piece ^ (pix / 2) % 4; R = 64: ^ pix % 8)
  template <int R>
  __device__ static int at(int pix, int q) {
    if constexpr (!kTma) return pix * R + q * 8;
    return pix * R + ((q ^ ((pix * R * 2 >> 7) & (R / 8 - 1))) << 3);
  }
  __device__ static int x_at(int pix, int q) { return at<kRowX>(pix, q); }
  __device__ static int e_at(int pix, int q) { return at<kRowE>(pix, q); }
};

// The dW from int8 (kDwQ) on a TMA tile: a stage holds the x window (or, in
// the xq mode, t formed from the int8 x), the dy tile (becoming e), the
// int8 y tile (dense rows of CO_T bytes) and its rows' scales ([RING_TH]
// [pack][CO_T] floats), 1024-byte rounded; the xq mode's int8 x window
// (dense rows of CI_T bytes, 128-byte rounded) and its rows' scales
// ([RING_TH + 2][pack][CI_T]) land in one of two raw slots after the
// stages (tile j's in slot j % 2: the transform of tile j is done before
// the copies of tile j + 2 start). The 16-wide tiles' stages are the other
// kinds': their kDwQ forms e and t by plain loads as they are copied.
template <int CI_T, int CO_T>
__host__ __device__ constexpr int dw_ring_stage_bytes(bool q, int pack) {
  using Tile = RingTile<CI_T, CO_T>;
  return q && Tile::kTma ? (Tile::kX * 2 + Tile::kE * 2 + kRingPix * CO_T +
                            kRingTH * pack * CO_T * 4 + 1023) / 1024 * 1024
                         : Tile::kStage * 2;
}
template <int CI_T>
__host__ __device__ constexpr int dw_ring_x8_bytes() {
  return (kRingWin * CI_T + 127) / 128 * 128;
}
template <int CI_T, int CO_T>
__host__ __device__ constexpr int dw_ring_raw_bytes(bool xq, int pack) {
  return xq && RingTile<CI_T, CO_T>::kTma ? dw_ring_x8_bytes<CI_T>() + kRingWinH * pack * CI_T * 4
                                          : 0;
}
// A launch's dynamic shared bytes (mirrored by conv3x3.dw_ring_resources):
// the ring's stages, kDwQ's two raw slots, the vectors, the mbarriers and
// the alignment slack; RingTile::kSmem for the other kinds.
template <int CI_T, int CO_T>
__host__ __device__ constexpr int dw_ring_smem(bool q, bool xq, int pack) {
  using Tile = RingTile<CI_T, CO_T>;
  return kRingStages * dw_ring_stage_bytes<CI_T, CO_T>(q, pack) +
         2 * dw_ring_raw_bytes<CI_T, CO_T>(xq, pack) + (2 * CI_T + 2 * CO_T) * 4 +
         (Tile::kTma ? kRingStages * 8 + 1024 : 0);
}

// Eight channels [c, c + 8) of one pixel, copied as they are by plain
// loads (a width that is not a multiple of 8), zero past C or outside.
__device__ __forceinline__ void stage8_raw(bf16* dst, const bf16* src, int c, int C,
                                           bool inside) {
  alignas(16) bf16 v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = inside && c + k < C ? src[k] : __float2bfloat16(0.f);
  store16<bf16>(dst, 0, v);
}

// Four bytes global -> shared, of which the first n (0-4) are read and the
// rest zero-filled.
__device__ __forceinline__ void cp_async4_n(void* smem, const void* gmem, int n) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

// kDwQ reads y as qa's int8 y (tm_y its map, tm_ys its scales') and, in
// the xq mode, x as qa's int8 x (tm_x its map, tm_xs its scales').
template <int KIND, int CI_T, int CO_T>
__device__ __forceinline__ void dw_ring_body(const bf16* __restrict__ x,
                                             const float* __restrict__ pa,
                                             const float* __restrict__ pb,
                                             const bf16* __restrict__ dy,
                                             const bf16* __restrict__ y,
                                             const float* __restrict__ s1_in,
                                             const float* __restrict__ s2_in,
                                             float* __restrict__ partials, int B, int H, int W,
                                             int Cin, int Cout, int prologue_in,
                                             const CUtensorMap* tm_x, const CUtensorMap* tm_dy,
                                             const CUtensorMap* tm_y, int ew_bf16,
                                             const QArgs qa = QArgs{},
                                             const CUtensorMap* tm_ys = nullptr,
                                             const CUtensorMap* tm_xs = nullptr) {
  using Tile = RingTile<CI_T, CO_T>;
  constexpr int QX = CI_T / 8, QE = CO_T / 8;
  constexpr int NT = Tile::kThreads, S = kRingStages;
  constexpr bool Q = KIND == kDwQ;
  constexpr bool QT = Q && Tile::kTma;  // the int8 tiles by TMA, formed in the transform
  const int prologue = dw_prologue<KIND>(prologue_in);
  const float* s1 = dw_stats<KIND>(s1_in);
  const float* s2 = dw_stats<KIND>(s2_in);
  const bool xq = Q && qa.xq != nullptr;  // t from the int8 x
  const int pack = qa.pack;
  // a stage's and a raw slot's bytes, and a stage's bf16
  const int stage_b = dw_ring_stage_bytes<CI_T, CO_T>(Q, pack);
  const int raw_b = dw_ring_raw_bytes<CI_T, CO_T>(xq, pack), stage_e = stage_b / 2;
  extern __shared__ __align__(16) unsigned char dw_ring_smem[];
  // the swizzles repeat every 1024 bytes or less: TMA, ldmatrix and wgmma
  // agree on them from a 1024-byte aligned ring
  bf16* ring = reinterpret_cast<bf16*>(
      dw_ring_smem + (Tile::kTma ? (1024 - (smem_u32(dw_ring_smem) & 1023)) & 1023 : 0));
  unsigned char* xraw = reinterpret_cast<unsigned char*>(ring) + S * stage_b;  // xq: [2][raw_b]
  // the per-channel vectors as (a, b) and (ds1, ds2) pairs, channel q * 8 +
  // j at [j * Q + q]: an item's eight pairs are eight 8-byte loads, and a
  // warp's items (consecutive q) read consecutive pairs, on distinct banks
  float2* ab_s = reinterpret_cast<float2*>(xraw + 2 * raw_b);
  float2* se_s = ab_s + CI_T;
  uint64_t* bars = reinterpret_cast<uint64_t*>(se_s + CO_T);  // a stage's TMA loads

  const int ci0 = blockIdx.x * CI_T, co0 = blockIdx.y * CO_T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tap = warp % 9, co_w = (warp / 9) * 32;  // the warp's tap and 32 output channels
  const int ky = tap / 3, kx = tap % 3;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix rows: lane -> (pixel j, channel half) of quarter i = lane / 8
  const int lj = lane & 7, lq = lane >> 3;
  const int tiles_x = (W + kTW - 1) / kTW, tiles_y = (H + kRingTH - 1) / kRingTH;
  const int n_tiles = B * tiles_x * tiles_y;
  // x on the 16-wide tiles (TMA takes the others): a narrow pixel (Cin < 8,
  // the stem) is copied as whole window rows in 4-byte pieces and scattered
  // into t by the transform; Cin % 8 == 0 in 16-byte pieces per pixel; any
  // other width by plain loads (stage8_raw)
  // (the xq mode's 16-wide tiles form t from the int8 x by plain loads)
  const bool narrow = CI_T == 16 && Cin < 8 && !xq, vec_x = (Cin & 7) == 0,
             vec_e = (Cout & 7) == 0;
  const bool form_e = s1 != nullptr;
  const int64_t x_bytes = (int64_t)B * H * W * Cin * 2;
  // the transform's items: the x window's pixels (narrow) or 8-channel
  // pieces (with the prologue; kDwQ's t from the int8 x, at every pixel of
  // the window), then e's 8-channel pieces (with the stats); the 16-wide
  // tiles of kDwQ form both as they are copied
  const int nx = xq ? (QT ? kRingWin * QX : 0) : narrow ? kRingWin : prologue ? kRingWin * QX : 0;
  const int n_items = nx + (form_e && (QT || !Q) ? kRingPix * QE : 0);

  // the per-channel vectors of this tile, zero past Cin / Cout (so t and e
  // stay 0 there); a narrow t's channels 8-15 are zero in every stage
  for (int c = threadIdx.x; c < CI_T; c += NT) {
    const bool on = prologue && ci0 + c < Cin;
    ab_s[(c & 7) * QX + (c >> 3)] = on ? make_float2(pa[ci0 + c], pb[ci0 + c])
                                       : make_float2(0.f, 0.f);
  }
  for (int c = threadIdx.x; c < CO_T; c += NT) {
    const bool on = form_e && co0 + c < Cout;
    se_s[(c & 7) * QE + (c >> 3)] = on ? make_float2(s1[co0 + c], s2[co0 + c])
                                       : make_float2(0.f, 0.f);
  }
  if constexpr (Tile::kTma) {
    if (threadIdx.x == 0) {
      for (int st = 0; st < S; ++st) mbar_init(smem_u32(&bars[st]), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  if (narrow) {
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int i = threadIdx.x; i < S * kRingWin; i += NT)
      *reinterpret_cast<uint4*>(&ring[(i / kRingWin) * stage_e +
                                      Tile::x_at(i % kRingWin, 1)]) = zero;
  }

  // The k-th tile of this block: its image and origin; false past the end.
  auto origin = [&](int k, int& b, int& gy0, int& gx0) {
    const int tile = blockIdx.z + k * gridDim.z;
    b = tile / (tiles_x * tiles_y);
    const int rem = tile % (tiles_x * tiles_y);
    gy0 = (rem / tiles_x) * kRingTH;
    gx0 = (rem % tiles_x) * kTW;
    return tile < n_tiles;
  };
  // The scales' row of pixel (gy, gx) of image b, at channel c of C.
  auto scale_at = [&](const float* sc, int b, int gy, int gx, int c, int C) {
    return sc + ((int64_t)(b * H + gy) * pack + scale_col(gx, pack)) * C + c;
  };
  // Copies of the raw x window, dy and y of tile k into stage `st` (kDwQ:
  // the int8 y tile and its scales; in the xq mode the int8 x window and
  // its scales into raw slot k % 2).
  auto issue = [&](int k, int st) {
    int b, gy0, gx0;
    if (!origin(k, b, gy0, gx0)) return;
    bf16* xs = ring + st * stage_e;
    bf16* es = xs + Tile::kX;
    bf16* ys = es + Tile::kE;
    if constexpr (Tile::kTma) {  // one thread: the window and the tiles, zeros outside
      if (threadIdx.x == 0) {
        const uint32_t bar = smem_u32(&bars[st]);
        const int y_bytes = Q ? kRingPix * CO_T + kRingTH * pack * CO_T * 4 : kRingPix * CO_T * 2;
        const int x_bytes_tile =
            xq ? kRingWin * CI_T + kRingWinH * pack * CI_T * 4 : kRingWin * CI_T * 2;
        mbar_expect_tx(bar, x_bytes_tile + kRingPix * CO_T * 2 + (form_e ? y_bytes : 0));
        if (xq) {
          unsigned char* r = xraw + (k & 1) * raw_b;
          tma_load_4d(r, tm_x, ci0, gx0 - 1, gy0 - 1, b, bar);
          tma_load_4d(r + dw_ring_x8_bytes<CI_T>(), tm_xs, ci0, 0, gy0 - 1, b, bar);
        } else {
          tma_load_4d(xs, tm_x, ci0, gx0 - 1, gy0 - 1, b, bar);
        }
        tma_load_4d(es, tm_dy, co0, gx0, gy0, b, bar);
        if (form_e) {
          tma_load_4d(ys, tm_y, co0, gx0, gy0, b, bar);
          if constexpr (Q)
            tma_load_4d(reinterpret_cast<unsigned char*>(ys) + kRingPix * CO_T, tm_ys, co0, 0,
                        gy0, b, bar);
        }
      }
      return;
    }
    const int64_t img = (int64_t)b * H * W;
    if (xq) {  // t from the int8 x by plain loads, zero outside
      for (int i = threadIdx.x; i < kRingWin * QX; i += NT) {
        const int pix = i / QX, q = i % QX;
        const int gy = gy0 - 1 + pix / kWinW, gx = gx0 - 1 + pix % kWinW, c = ci0 + q * 8;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
        const int64_t off = inside ? (img + (int64_t)gy * W + gx) * Cin + c : 0;
        stage8_tq(&xs[Tile::x_at(pix, q)], qa.xq + off,
                  inside ? scale_at(qa.xsc, b, gy, gx, c, Cin) : qa.xsc, c, Cin, inside, prologue,
                  pa, pb);
      }
    } else if (narrow) {
      // window row wr: the 18 * Cin * 2 bytes from pixel (gy, gx0 - 1), in
      // the 4-byte pieces that cover them; past either end of x, zeros
      unsigned char* raw = reinterpret_cast<unsigned char*>(ys + Tile::kY);
      const int pieces = (18 * Cin * 2 + 3) / 4 + 1;
      for (int i = threadIdx.x; i < kRingWinH * pieces; i += NT) {
        const int wr = i / pieces, c = i % pieces, gy = gy0 - 1 + wr;
        if (gy < 0 || gy >= H) continue;
        const int64_t lo = (img + (int64_t)gy * W + gx0 - 1) * Cin * 2;
        const int64_t at = (lo & ~(int64_t)3) + 4 * c;
        const int64_t left = at < 0 ? 0 : x_bytes - at;  // bytes of x from `at` on
        const int n = left >= 4 ? 4 : left > 0 ? (int)left : 0;
        cp_async4_n(raw + wr * kRawRow + 4 * c,
                    n > 0 ? reinterpret_cast<const unsigned char*>(x) + at
                          : reinterpret_cast<const unsigned char*>(x),
                    n);
      }
    } else {
      for (int i = threadIdx.x; i < kRingWin * QX; i += NT) {
        const int pix = i / QX, q = i % QX;
        const int gy = gy0 - 1 + pix / kWinW, gx = gx0 - 1 + pix % kWinW, c = ci0 + q * 8;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
        const bf16* src = inside ? x + (img + (int64_t)gy * W + gx) * Cin + c : x;
        if (vec_x)
          cp_async<16>(&xs[Tile::x_at(pix, q)], c < Cin ? src : x, inside && c < Cin);
        else
          stage8_raw(&xs[Tile::x_at(pix, q)], src, c, Cin, inside);
      }
    }
    for (int i = threadIdx.x; i < kRingPix * QE; i += NT) {
      const int pix = i / QE, q = i % QE;
      const int gy = gy0 + pix / kTW, gx = gx0 + pix % kTW, c = co0 + q * 8;
      const bool inside = gy < H && gx < W, on = inside && c < Cout;
      const int64_t off = inside ? (img + (int64_t)gy * W + gx) * Cout + c : 0;
      const int at = Tile::e_at(pix, q);
      if constexpr (Q) {  // e from dy and the int8 y by plain loads, zero outside
        stage8_eq(&es[at], dy + off, qa.yq + off,
                  inside ? scale_at(qa.ysc, b, gy, gx, c, Cout) : qa.ysc, c, Cout, inside, s1, s2);
      } else if (vec_e) {
        cp_async<16>(&es[at], on ? dy + off : dy, on);
        if (form_e) cp_async<16>(&ys[at], on ? y + off : y, on);
      } else {
        stage8_raw(&es[at], dy + off, c, Cout, inside);
        if (form_e) stage8_raw(&ys[at], y + off, c, Cout, inside);
      }
    }
  };
  // Item i of the transform of tile k at (b, gy0, gx0) in stage `st`, in
  // place and once per element: t = round(relu(x a + b)) (or x itself, for
  // a narrow x scattered from its raw rows), e = round(dy + ds1 + 2 y ds2);
  // kDwQ: e from deq(y) in f32, and in the xq mode t = round(relu(deq(xq)
  // a + b)) from the raw slot, both with one rounding.
  // Out-of-image pixels keep the zeros they were copied as (a narrow x's
  // and the xq mode's t are written as zeros): zero padding in t-space and
  // in e-space.
  auto form = [&](auto ew, int i, int k, int st, int b, int gy0, int gx0) {
    constexpr bool EW = decltype(ew)::value;
    bf16* xs = ring + st * stage_e;
    bf16* es = xs + Tile::kX;
    const bf16* ys = es + Tile::kE;
    alignas(16) bf16 v[8];
    if (i < nx) {
      const int pix = narrow ? i : i / QX, q = narrow ? 0 : i % QX;
      const int wr = pix / kWinW, wc = pix % kWinW;
      const int gy = gy0 - 1 + wr, gx = gx0 - 1 + wc;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      if (Q && xq) {
        const unsigned char* r = xraw + (k & 1) * raw_b;
        float d[8] = {};
        if (inside)
          deq8(d, reinterpret_cast<const int8_t*>(r) + pix * CI_T + q * 8,
               reinterpret_cast<const float*>(r + dw_ring_x8_bytes<CI_T>()) +
                   (wr * pack + scale_col(gx, pack)) * CI_T + q * 8);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 ab = ab_s[j * QX + q];
          v[j] = __float2bfloat16(!inside ? 0.f : prologue ? prologue_f32(d[j], ab.x, ab.y) : d[j]);
        }
      } else if (narrow) {
        const int64_t lo = ((int64_t)b * H * W + (int64_t)gy * W + gx0 - 1) * Cin * 2;
        const bf16* src = reinterpret_cast<const bf16*>(
            reinterpret_cast<const unsigned char*>(ys + Tile::kY) + wr * kRawRow +
            (lo & 3) + wc * Cin * 2);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xv = inside && j < Cin ? __bfloat162float(src[j]) : 0.f;
          const float2 ab = ab_s[j * QX];
          v[j] = __float2bfloat16(prologue && inside && j < Cin
                                      ? prologue_ew<EW>(xv, ab.x, ab.y) : xv);
        }
      } else {
        if (!inside) return;
        load16<bf16>(v, &xs[Tile::x_at(pix, q)], 0);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 ab = ab_s[j * QX + q];
          v[j] = __float2bfloat16(prologue_ew<EW>(__bfloat162float(v[j]), ab.x, ab.y));
        }
      }
      store16<bf16>(&xs[Tile::x_at(pix, q)], 0, v);
    } else {
      const int pix = (i - nx) / QE, q = (i - nx) % QE;
      if (gy0 + pix / kTW >= H || gx0 + pix % kTW >= W) return;
      const int at = Tile::e_at(pix, q);
      load16<bf16>(v, &es[at], 0);
      if constexpr (Q) {  // deq(y) in f32, not rounded; the pixel's row of scales
        const unsigned char* y8 = reinterpret_cast<const unsigned char*>(ys);
        float yv[8];
        deq8(yv, reinterpret_cast<const int8_t*>(y8) + pix * CO_T + q * 8,
             reinterpret_cast<const float*>(y8 + kRingPix * CO_T) +
                 ((pix / kTW) * pack + scale_col(gx0 + pix % kTW, pack)) * CO_T + q * 8);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 se = se_s[j * QE + q];
          v[j] = __float2bfloat16(e_f32(__bfloat162float(v[j]), yv[j], se.x, se.y));
        }
      } else {
        alignas(16) bf16 yv[8];
        load16<bf16>(yv, &ys[at], 0);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 se = se_s[j * QE + q];
          v[j] = __float2bfloat16(
              e_ew<EW>(__bfloat162float(v[j]), __bfloat162float(yv[j]), se.x, se.y));
        }
      }
      store16<bf16>(&es[at], 0, v);
    }
  };
  // Every item of tile k's transform, the chain chosen once.
  auto form_all = [&](int k, int st, int b, int gy0, int gx0) {
    with_ew(ew_bf16, [&](auto ew) {
      for (int i = threadIdx.x; i < n_items; i += NT) form(ew, i, k, st, b, gy0, gx0);
    });
  };

  float acc[Tile::kAccRows][Tile::kAccCols];
#pragma unroll
  for (int m = 0; m < Tile::kAccRows; ++m)
#pragma unroll
    for (int j = 0; j < Tile::kAccCols; ++j) acc[m][j] = 0.f;

  // The ring: tile k's products run while tile k + 1 is formed in the next
  // stage and tile k + 2 is copied into the third: one barrier a tile.
  static_assert(S == 3, "a stage each for the products, the transform, the copies");
  const int my_tiles = blockIdx.z < n_tiles ? (n_tiles - 1 - blockIdx.z) / gridDim.z + 1 : 0;
  issue(0, 0);
  cp_async_commit();
  issue(1, 1);
  cp_async_commit();
  // tile 0 has landed
  if constexpr (Tile::kTma) {
    if (my_tiles > 0) mbar_wait(smem_u32(&bars[0]), 0);
  } else {
    cp_async_wait<1>();
  }
  __syncthreads();
  {
    int b, gy0, gx0;
    if (origin(0, b, gy0, gx0))
      form_all(0, 0, b, gy0, gx0);
  }
  for (int k = 0; k < my_tiles; ++k) {
    const int st = k % S, next = (k + 1) % S;
    // tile k + 1 has landed
    if constexpr (Tile::kTma) {
      if (k + 1 < my_tiles) mbar_wait(smem_u32(&bars[next]), ((k + 1) / S) & 1);
      fence_proxy_async();  // this thread's writes (tile k formed), to TMA and wgmma
    } else {
      cp_async_wait<0>();
    }
    // tile k is formed, tile k + 1 copied, and every warp is past the
    // products of tile k - 1, whose stage takes tile k + 2
    __syncthreads();
    issue(k + 2, (k + 2) % S);
    cp_async_commit();
    int b, gy0, gx0;
    const bool more = origin(k + 1, b, gy0, gx0);
    const bf16* ts = ring + st * stage_e;
    const bf16* es = ts + Tile::kX;
    if constexpr (Tile::kWg) {
      // Warpgroup ky's taps (ky, 0..2) on pixel row r: D[co][ci] += A B with
      // A[co][k] = e at (r, k) and B[k][ci] = t at window (r + ky, k + kx),
      // both MN-major with the 128-byte swizzle: a pixel's 64 channels one
      // 128-byte row, the 16 pixels two groups of 8 rows 1024 bytes apart
      // (SBO); the tap's shift is 128 bytes a pixel of B's start. Async: the
      // transform of tile k + 1 runs while they do.
      const int wky = warp / 4;
      wg_fence();
#pragma unroll
      for (int r = 0; r < kRingTH; ++r) {
        const uint64_t a = wg_desc(&es[r * kTW * 64], 16, 1024);
#pragma unroll
        for (int tx = 0; tx < 3; ++tx)
          wgmma_n64(acc[tx], a, wg_desc(&ts[((r + wky) * kWinW + tx) * 64], 16, 1024));
      }
      wg_commit();
      if (more)
        form_all(k + 1, next, b, gy0, gx0);
      wg_wait_all();  // before the barrier: this stage takes tile k + 3
#pragma unroll
      for (int tx = 0; tx < 3; ++tx) wg_fence_regs(acc[tx]);
    } else {
#pragma unroll
      for (int r = 0; r < kRingTH; ++r) {
        // The products of pixel row r: A[ci][k] = t at window (r + ky, k +
        // kx), B[k][co] = e at (r, k), both stored k-major, so their
        // fragments are transposed quarters. A's quarters (k, ci) = (0-7,
        // 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15) are a0..a3; B's (k,
        // co) = (0-7, n), (8-15, n) are b0, b1.
        uint32_t bf[2][4];
        const int e_pix = r * kTW + (lq & 1) * 8 + lj;
#pragma unroll
        for (int h = 0; h < 2; ++h)  // n-tiles 2h and 2h + 1
          ldmatrix_x4_trans(bf[h], &es[Tile::e_at(e_pix, co_w / 8 + 2 * h + (lq >> 1))]);
        const int t_pix = (r + ky) * kWinW + kx + (lq >> 1) * 8 + lj;
#pragma unroll
        for (int m = 0; m < CI_T / 16; ++m) {
          uint32_t af[4];
          ldmatrix_x4_trans(af, &ts[Tile::x_at(t_pix, m * 2 + (lq & 1))]);
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mma_bf16(acc[m * 4 + n], af, bf[n >> 1][(n & 1) * 2], bf[n >> 1][(n & 1) * 2 + 1]);
        }
      }
      // then tile k + 1's transform: a warp past its products starts on it
      // while the others finish theirs
      if (more)
        form_all(k + 1, next, b, gy0, gx0);
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (the groups past the end are empty)
  __syncthreads();     // every warp is past its products: the ring takes the dW tile

  // The dW tile, staged as this block's slice of the weight [CO_T][CI_T][3 x
  // 3], then written to partials[z] (laid out as the weight, [Cout, Cin, 3,
  // 3]) a row of CI_T * 9 consecutive floats at a time. mma.sync: acc[m * 4
  // + n] = {D[m*16+g][n*8+2t], D[..][+1], D[m*16+g+8][n*8+2t], D[..][+1]} of
  // D[ci][co]; wgmma: acc[tx][4j + v] = D[16 w + g + (v / 2) * 8][8j + 2t + v
  // % 2] of D[co][ci], w the warp of the warpgroup, tap (warpgroup, tx).
  float* out_s = reinterpret_cast<float*>(dw_ring_smem);
  if constexpr (Tile::kWg) {
    const int w = warp % 4, tap0 = (warp / 4) * 3;
#pragma unroll
    for (int tx = 0; tx < 3; ++tx)
#pragma unroll
      for (int j = 0; j < CI_T / 8; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int co = 16 * w + g + (v >> 1) * 8, ci = 8 * j + 2 * t + (v & 1);
          out_s[(co * CI_T + ci) * 9 + tap0 + tx] = acc[tx][4 * j + v];
        }
  } else {
#pragma unroll
    for (int m = 0; m < CI_T / 16; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ci = m * 16 + g + (j >> 1) * 8, co = co_w + n * 8 + 2 * t + (j & 1);
          out_s[(co * CI_T + ci) * 9 + tap] = acc[m * 4 + n][j];
        }
  }
  __syncthreads();
  float* part = partials + (int64_t)blockIdx.z * Cout * Cin * 9;
  const int row = min(CI_T, Cin - ci0) * 9;
  for (int i = threadIdx.x; i < CO_T * CI_T * 9; i += NT) {
    const int co = i / (CI_T * 9), c = i % (CI_T * 9);
    if (co0 + co < Cout && c < row)
      part[((int64_t)(co0 + co) * Cin + ci0) * 9 + c] = out_s[i];
  }
}

// ---------------------------------------------------------------------------
// f32: FMA
// ---------------------------------------------------------------------------

constexpr int kDwfThreads = 256;
constexpr int kDwfTH = 8;  // pixel tile rows (x 16 columns)

template <int KIND>
__device__ __forceinline__ void dw_fma_body(const float* __restrict__ x,
                                            const float* __restrict__ pa,
                                            const float* __restrict__ pb,
                                            const float* __restrict__ dy,
                                            const float* __restrict__ y,
                                            const float* __restrict__ s1_in,
                                            const float* __restrict__ s2_in,
                                            float* __restrict__ partials, int B, int H, int W,
                                            int Cin, int Cout, int prologue_in,
                                            int = 0) {  // f32: no bf16 chains
  const int prologue = dw_prologue<KIND>(prologue_in);
  const float* s1 = dw_stats<KIND>(s1_in);
  const float* s2 = dw_stats<KIND>(s2_in);
  __shared__ float t_s[(kDwfTH + 2) * kWinW][kDwC];
  __shared__ __align__(16) float e_s[kDwfTH * kTW][kDwC];
  const int ci0 = blockIdx.x * kDwC, co0 = blockIdx.y * kDwC;
  const int ci = threadIdx.x & 31, cq = (threadIdx.x >> 5) * 4;  // input channel, 4 outputs
  const int tiles_x = (W + kTW - 1) / kTW, tiles_y = (H + kDwfTH - 1) / kDwfTH;
  const int n_tiles = B * tiles_x * tiles_y;

  float acc[9][4];
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;

  for (int tile = blockIdx.z; tile < n_tiles; tile += gridDim.z) {
    const int b = tile / (tiles_x * tiles_y), rem = tile % (tiles_x * tiles_y);
    const int gy0 = (rem / tiles_x) * kDwfTH, gx0 = (rem % tiles_x) * kTW;
    const int64_t img = (int64_t)b * H * W;
    __syncthreads();
    for (int e = threadIdx.x; e < (kDwfTH + 2) * kWinW * kDwC; e += kDwfThreads) {
      const int c = e % kDwC, pix = e / kDwC;
      const int gy = gy0 - 1 + pix / kWinW, gx = gx0 - 1 + pix % kWinW;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && ci0 + c < Cin) {
        const int64_t i = (img + (int64_t)gy * W + gx) * Cin + ci0 + c;
        v = t_at(x, i, ci0 + c, prologue, pa, pb);
      }
      t_s[pix][c] = v;
    }
    for (int e = threadIdx.x; e < kDwfTH * kTW * kDwC; e += kDwfThreads) {
      const int c = e % kDwC, pix = e / kDwC;
      const int gy = gy0 + pix / kTW, gx = gx0 + pix % kTW;
      float v = 0.f;
      if (gy < H && gx < W && co0 + c < Cout) {
        const int64_t i = (img + (int64_t)gy * W + gx) * Cout + co0 + c;
        v = e_at(dy, y, i, co0 + c, s1, s2);
      }
      e_s[pix][c] = v;
    }
    __syncthreads();

    for (int r = 0; r < kDwfTH; ++r) {
#pragma unroll 4
      for (int col = 0; col < kTW; ++col) {
        const float4 ev = *reinterpret_cast<const float4*>(&e_s[r * kTW + col][cq]);
        const float e4[4] = {ev.x, ev.y, ev.z, ev.w};
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          const float tv = t_s[(r + k / 3) * kWinW + col + k % 3][ci];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[k][j] = fmaf(tv, e4[j], acc[k][j]);
        }
      }
    }
  }

  float* part = partials + (int64_t)blockIdx.z * Cout * Cin * 9;
  if (ci0 + ci < Cin) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + cq + j;
      if (co < Cout) {
#pragma unroll
        for (int k = 0; k < 9; ++k) part[((int64_t)co * Cin + ci0 + ci) * 9 + k] = acc[k][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: the register-blocked FMA body (kDwBn #33, kDwPlain #41 and #31)
// ---------------------------------------------------------------------------

constexpr int kRegCiT = 32;         // input channels of a tile
constexpr int kRegStages = 3;       // the ring's stages
constexpr int kRegTHWide = 8;       // pixel tile rows (x kTW columns) of the 64-wide tile
constexpr int kRegTHNarrow = 4;     // ... of the 32-wide tile
constexpr int kRegBlocksWide = 1;   // resident blocks an SM of the 64-wide tile
constexpr int kRegBlocksNarrow = 3;  // ... of the 32-wide tile

// A block's shape for a 32 (input) x CO_T (output) channel tile. Warp w
// takes kernel row ky = w / (CO_T / 16) and 16 output channels; its lane
// (co4, ci4) = (lane / 8, lane % 8) 4 output x 4 input channels, and holds
// their outer product for the three taps (ky, 0..2): 48 accumulators. A
// stage holds the x window (TH + 2 rows of 18 pixels) and the e tile (TH
// rows of 16 pixels) as [pixel][channel] f32, 128 or 256 bytes a pixel.
template <int CO_T>
struct RegTile {
  static_assert(CO_T == 32 || CO_T == 64, "32- or 64-wide output tiles");
  static constexpr int kTH = CO_T == 64 ? kRegTHWide : kRegTHNarrow;
  static constexpr int kMinBlocks = CO_T == 64 ? kRegBlocksWide : kRegBlocksNarrow;
  static constexpr int kWarpsKy = CO_T / 16;
  static constexpr int kThreads = 3 * kWarpsKy * 32;
  static constexpr int kWin = (kTH + 2) * kWinW;  // window pixels
  static constexpr int kPix = kTH * kTW;          // tile pixels
  static constexpr int kX = kWin * kRegCiT, kE = kPix * CO_T;  // floats
  static constexpr int kStage = kX + kE;
  // the ring, then the prologue's a and b
  static constexpr int kSmem = (kRegStages * kStage + 2 * kRegCiT) * 4;
  static_assert(CO_T * kRegCiT * 9 <= kRegStages * kStage, "the dW tile fits the ring");
};

// Four channels [c, c + 4) of one pixel, by plain loads (a width that is
// not a multiple of 4), zero past C or outside.
__device__ __forceinline__ void stage4_raw(float* dst, const float* src, int c, int C,
                                           bool inside) {
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = inside && c + k < C ? src[k] : 0.f;
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// kDwQ's raw slots in f32 (two, tile j's in slot j % 2, as the bf16 ring's):
// the int8 y tile (TH x 16 pixels, dense rows of CO_T bytes) and its rows'
// scales ([TH][pack][CO_T] floats); in the xq mode the int8 x window and its
// rows' scales ([TH + 2][pack][32]). Each piece 128-byte rounded.
template <int CO_T>
struct RegQRaw {
  using Tile = RegTile<CO_T>;
  int y8, ysc, x8, xsc, bytes;  // offsets in a slot, and its bytes
  __host__ __device__ constexpr RegQRaw(bool xq, int pack)
      : y8(0),
        ysc(round(Tile::kPix * CO_T)),
        x8(ysc + round(Tile::kTH * pack * CO_T * 4)),
        xsc(x8 + (xq ? round(Tile::kWin * kRegCiT) : 0)),
        bytes(xsc + (xq ? round((Tile::kTH + 2) * pack * kRegCiT * 4) : 0)) {}
  __host__ __device__ static constexpr int round(int b) { return (b + 127) / 128 * 128; }
};

// A launch's dynamic shared bytes (mirrored by conv3x3.dw_fma_resources):
// the ring, kDwQ's two raw slots, the prologue's a and b and kDwQ's ds1 and
// ds2; RegTile::kSmem for the other kinds.
template <int CO_T>
__host__ __device__ constexpr int dw_reg_smem(bool q, bool xq, int pack) {
  return RegTile<CO_T>::kSmem + (q ? 2 * RegQRaw<CO_T>(xq, pack).bytes + 2 * CO_T * 4 : 0);
}

// Sixteen int8 values [c, c + 16) of one pixel: by cp.async where C is a
// multiple of 16, else by plain loads; zero past C or outside. `base` is a
// valid address for a copy that reads nothing.
__device__ __forceinline__ void stage16_i8(int8_t* dst, const int8_t* src, int c, int C,
                                           bool inside, const int8_t* base) {
  if ((C & 15) == 0) {
    cp_async<16>(dst, inside && c < C ? src : base, inside && c < C);
    return;
  }
  alignas(16) int8_t v[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = inside && c + k < C ? src[k] : 0;
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
}

// Four f32 values [c, c + 4): by cp.async where C is a multiple of 4, else
// by plain loads; zero past C or outside.
__device__ __forceinline__ void stage4_f32(float* dst, const float* src, int c, int C, bool inside,
                                           const float* base) {
  if ((C & 3) == 0)
    cp_async<16>(dst, inside && c < C ? src : base, inside && c < C);
  else
    stage4_raw(dst, src, c, C, inside);
}

// Four int8 values and their four scales as f32 deq values.
__device__ __forceinline__ void deq4(float (&d)[4], const int8_t* q, const float* sc) {
  const char4 qv = *reinterpret_cast<const char4*>(q);
  const float4 s = *reinterpret_cast<const float4*>(sc);
  d[0] = deq_f32(qv.x, s.x);
  d[1] = deq_f32(qv.y, s.y);
  d[2] = deq_f32(qv.z, s.z);
  d[3] = deq_f32(qv.w, s.w);
}

// acc[j][i] += e[j] * t[i]: one tap's 4 x 4 outer product.
__device__ __forceinline__ void fma_outer(float (&acc)[4][4], const float4& e, const float4& t) {
  const float ev[4] = {e.x, e.y, e.z, e.w}, tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = fmaf(ev[j], tv[i], acc[j][i]);
}

// dW of t = prologue(x) (kDwBn, t = x without it) against e = dy as given
// (the materialized dy_eff of the two-pass branch, or the plain dW's dy),
// or (kDwQ) against e = dy + ds1 + 2 deq(y) ds2 formed from dy and the
// int8 y, with t from x or, in the xq mode, from deq(xq), each in f32 once
// per element after its copies land (from the raw slots),
// into `out` [gridDim.z][Cout, Cin, 3, 3]. The ring of kRegStages stages:
// tile k's products run while tile k + 1 is formed in the next stage and
// tile k + 2 is copied into the third, by 16-byte cp.async (4 channels;
// zeros outside the image and past Cin / Cout, plain loads for widths that
// are not a multiple of 4): one barrier a tile. t = relu(x a + b) is formed
// once per element in place, with conv3x3_bn.cuh's rounded ops;
// out-of-image pixels keep their zeros (padding in t-space). The products:
// per pixel row a thread walks the 18 window columns of its kernel row, one
// float4 of t and one of e a column; the taps' one-pixel shift is the last
// three t columns held in registers, so a staged value is read once a
// thread and row: 48 FMAs for two shared loads.
template <int KIND, int CO_T>
__device__ __forceinline__ void dw_reg_body(const float* __restrict__ x,
                                            const float* __restrict__ pa,
                                            const float* __restrict__ pb,
                                            const float* __restrict__ dy,
                                            float* __restrict__ out, int B, int H, int W,
                                            int Cin, int Cout, int prologue_in,
                                            const float* __restrict__ s1 = nullptr,
                                            const float* __restrict__ s2 = nullptr,
                                            const QArgs qa = QArgs{}) {
  static_assert(KIND == kDwPlain || KIND == kDwBn || KIND == kDwQ,
                "e as given (the plain and two-pass dW) or from the int8 y (kDwQ)");
  using Tile = RegTile<CO_T>;
  constexpr int CI_T = kRegCiT, TH = Tile::kTH, S = kRegStages, NT = Tile::kThreads;
  constexpr int QX = CI_T / 4, QE = CO_T / 4;  // 16-byte pieces of a staged pixel
  constexpr bool Q = KIND == kDwQ;
  const int prologue = dw_prologue<KIND>(prologue_in);
  const bool xq = Q && qa.xq != nullptr, form_e = Q && s1 != nullptr;
  const int pack = qa.pack;
  const RegQRaw<CO_T> rq(xq, pack);
  extern __shared__ __align__(16) float dw_reg_smem[];
  float* ring = dw_reg_smem;
  unsigned char* qraw = reinterpret_cast<unsigned char*>(ring + S * Tile::kStage);  // [2][rq]
  float* a_s = reinterpret_cast<float*>(qraw + (Q ? 2 * rq.bytes : 0));
  float* b_s = a_s + CI_T;
  float* s1_s = b_s + CI_T;  // kDwQ: ds1, ds2 over the tile's CO_T channels
  float* s2_s = s1_s + CO_T;

  const int ci0 = blockIdx.x * CI_T, co0 = blockIdx.y * CO_T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ky = warp / Tile::kWarpsKy;
  const int co_l = (warp % Tile::kWarpsKy) * 16 + (lane >> 3) * 4;  // 4 output channels
  const int ci_l = (lane & 7) * 4;                                    // 4 input channels
  const int tiles_x = (W + kTW - 1) / kTW, tiles_y = (H + TH - 1) / TH;
  const int n_tiles = B * tiles_x * tiles_y;
  const bool vec_x = (Cin & 3) == 0, vec_e = (Cout & 3) == 0;

  for (int c = threadIdx.x; c < CI_T; c += NT) {
    const bool on = prologue && ci0 + c < Cin;
    a_s[c] = on ? pa[ci0 + c] : 0.f;
    b_s[c] = on ? pb[ci0 + c] : 0.f;
  }
  for (int c = threadIdx.x; c < (Q ? CO_T : 0); c += NT) {
    const bool on = form_e && co0 + c < Cout;
    s1_s[c] = on ? s1[co0 + c] : 0.f;
    s2_s[c] = on ? s2[co0 + c] : 0.f;
  }

  // The k-th tile of this block: its image and origin; false past the end.
  auto origin = [&](int k, int& b, int& gy0, int& gx0) {
    const int tile = blockIdx.z + k * gridDim.z;
    b = tile / (tiles_x * tiles_y);
    const int rem = tile % (tiles_x * tiles_y);
    gy0 = (rem / tiles_x) * TH;
    gx0 = (rem % tiles_x) * kTW;
    return tile < n_tiles;
  };
  // Copies of the raw x window and the e tile of tile k into stage `st`
  // (kDwQ: dy, the int8 y tile and its scales into raw slot k % 2; in the
  // xq mode the int8 x window and its scales in place of x).
  auto issue = [&](int k, int st) {
    int b, gy0, gx0;
    if (!origin(k, b, gy0, gx0)) return;
    float* xs = ring + st * Tile::kStage;
    float* es = xs + Tile::kX;
    const int64_t img = (int64_t)b * H * W;
    unsigned char* r = qraw + (k & 1) * rq.bytes;
    if (form_e) {
      for (int i = threadIdx.x; i < Tile::kPix * (CO_T / 16); i += NT) {
        const int pix = i / (CO_T / 16), q = i % (CO_T / 16);
        const int gy = gy0 + pix / kTW, gx = gx0 + pix % kTW, c = co0 + q * 16;
        const bool inside = gy < H && gx < W;
        stage16_i8(reinterpret_cast<int8_t*>(r + rq.y8) + pix * CO_T + q * 16,
                   qa.yq + (inside ? (img + (int64_t)gy * W + gx) * Cout + c : 0), c, Cout, inside,
                   qa.yq);
      }
      for (int i = threadIdx.x; i < TH * pack * QE; i += NT) {
        const int row = i / (pack * QE), j = (i / QE) % pack, c = co0 + (i % QE) * 4;
        const bool inside = gy0 + row < H;
        stage4_f32(reinterpret_cast<float*>(r + rq.ysc) + i * 4,
                   qa.ysc + (inside ? ((int64_t)(b * H + gy0 + row) * pack + j) * Cout + c : 0), c,
                   Cout, inside, qa.ysc);
      }
    }
    if (xq) {
      for (int i = threadIdx.x; i < Tile::kWin * (CI_T / 16); i += NT) {
        const int pix = i / (CI_T / 16), q = i % (CI_T / 16);
        const int gy = gy0 - 1 + pix / kWinW, gx = gx0 - 1 + pix % kWinW, c = ci0 + q * 16;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
        stage16_i8(reinterpret_cast<int8_t*>(r + rq.x8) + pix * CI_T + q * 16,
                   qa.xq + (inside ? (img + (int64_t)gy * W + gx) * Cin + c : 0), c, Cin, inside,
                   qa.xq);
      }
      for (int i = threadIdx.x; i < (TH + 2) * pack * QX; i += NT) {
        const int row = i / (pack * QX), j = (i / QX) % pack, c = ci0 + (i % QX) * 4;
        const int gy = gy0 - 1 + row;
        const bool inside = gy >= 0 && gy < H;
        stage4_f32(reinterpret_cast<float*>(r + rq.xsc) + i * 4,
                   qa.xsc + (inside ? ((int64_t)(b * H + gy) * pack + j) * Cin + c : 0), c, Cin,
                   inside, qa.xsc);
      }
    }
    for (int i = threadIdx.x; i < (xq ? 0 : Tile::kWin * QX); i += NT) {
      const int pix = i / QX, q = i % QX;
      const int gy = gy0 - 1 + pix / kWinW, gx = gx0 - 1 + pix % kWinW, c = ci0 + q * 4;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W, on = inside && c < Cin;
      const int64_t off = inside ? (img + (int64_t)gy * W + gx) * Cin + c : 0;
      if (vec_x)
        cp_async<16>(&xs[pix * CI_T + q * 4], on ? x + off : x, on);
      else
        stage4_raw(&xs[pix * CI_T + q * 4], x + off, c, Cin, inside);
    }
    for (int i = threadIdx.x; i < Tile::kPix * QE; i += NT) {
      const int pix = i / QE, q = i % QE;
      const int gy = gy0 + pix / kTW, gx = gx0 + pix % kTW, c = co0 + q * 4;
      const bool inside = gy < H && gx < W, on = inside && c < Cout;
      const int64_t off = inside ? (img + (int64_t)gy * W + gx) * Cout + c : 0;
      if (vec_e)
        cp_async<16>(&es[pix * CO_T + q * 4], on ? dy + off : dy, on);
      else
        stage4_raw(&es[pix * CO_T + q * 4], dy + off, c, Cout, inside);
    }
  };
  // The prologue of tile k at (gy0, gx0) in stage `st`, in place, once per
  // element; out-of-image pixels stay 0, channels past Cin have a = b = 0.
  // kDwQ: e = dy + ds1 + 2 deq(y) ds2 in place of dy, and in the xq mode
  // t = relu(deq(xq) a + b) (or deq(xq)) from the raw slot, zero outside.
  auto form_all = [&](int k, int st, int gy0, int gx0) {
    float* xs = ring + st * Tile::kStage;
    const unsigned char* r = qraw + (k & 1) * rq.bytes;
    if (form_e) {
      float* es = xs + Tile::kX;
      for (int i = threadIdx.x; i < Tile::kPix * QE; i += NT) {
        const int pix = i / QE, q = i % QE, gx = gx0 + pix % kTW;
        if (gy0 + pix / kTW >= H || gx >= W) continue;  // the zeros stay
        float d[4];
        deq4(d, reinterpret_cast<const int8_t*>(r + rq.y8) + pix * CO_T + q * 4,
             reinterpret_cast<const float*>(r + rq.ysc) +
                 ((pix / kTW) * pack + scale_col(gx, pack)) * CO_T + q * 4);
        float4* p = reinterpret_cast<float4*>(&es[pix * CO_T + q * 4]);
        float4 v = *p;
        const int c = q * 4;
        v.x = e_f32(v.x, d[0], s1_s[c], s2_s[c]);
        v.y = e_f32(v.y, d[1], s1_s[c + 1], s2_s[c + 1]);
        v.z = e_f32(v.z, d[2], s1_s[c + 2], s2_s[c + 2]);
        v.w = e_f32(v.w, d[3], s1_s[c + 3], s2_s[c + 3]);
        *p = v;
      }
    }
    if (xq) {
      for (int i = threadIdx.x; i < Tile::kWin * QX; i += NT) {
        const int pix = i / QX, q = i % QX, wr = pix / kWinW;
        const int gy = gy0 - 1 + wr, gx = gx0 - 1 + pix % kWinW;
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
          deq4(d, reinterpret_cast<const int8_t*>(r + rq.x8) + pix * CI_T + q * 4,
               reinterpret_cast<const float*>(r + rq.xsc) +
                   (wr * pack + scale_col(gx, pack)) * CI_T + q * 4);
          const int c = q * 4;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (prologue) d[j] = prologue_f32(d[j], a_s[c + j], b_s[c + j]);
        }
        *reinterpret_cast<float4*>(&xs[pix * CI_T + q * 4]) = make_float4(d[0], d[1], d[2], d[3]);
      }
      return;
    }
    if (!prologue) return;
    for (int i = threadIdx.x; i < Tile::kWin * QX; i += NT) {
      const int pix = i / QX, q = i % QX;
      const int gy = gy0 - 1 + pix / kWinW, gx = gx0 - 1 + pix % kWinW;
      if (gy < 0 || gy >= H || gx < 0 || gx >= W) continue;
      float4* p = reinterpret_cast<float4*>(&xs[pix * CI_T + q * 4]);
      float4 v = *p;
      const int c = q * 4;
      v.x = prologue_f32(v.x, a_s[c], b_s[c]);
      v.y = prologue_f32(v.y, a_s[c + 1], b_s[c + 1]);
      v.z = prologue_f32(v.z, a_s[c + 2], b_s[c + 2]);
      v.w = prologue_f32(v.w, a_s[c + 3], b_s[c + 3]);
      *p = v;
    }
  };

  float acc[3][4][4];  // [kx][output channel][input channel]
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[k][j][i] = 0.f;

  static_assert(S == 3, "a stage each for the products, the prologue, the copies");
  const int my_tiles = blockIdx.z < n_tiles ? (n_tiles - 1 - blockIdx.z) / gridDim.z + 1 : 0;
  issue(0, 0);
  cp_async_commit();
  issue(1, 1);
  cp_async_commit();
  cp_async_wait<1>();  // tile 0 has landed
  __syncthreads();
  {
    int b, gy0, gx0;
    if (origin(0, b, gy0, gx0)) form_all(0, 0, gy0, gx0);
  }
  for (int k = 0; k < my_tiles; ++k) {
    cp_async_wait<0>();  // tile k + 1 has landed
    // tile k is formed, tile k + 1 copied, and every warp is past the
    // products of tile k - 1, whose stage takes tile k + 2
    __syncthreads();
    issue(k + 2, (k + 2) % S);
    cp_async_commit();
    const float* ts = ring + (k % S) * Tile::kStage + ci_l;
    const float* es = ring + (k % S) * Tile::kStage + Tile::kX + co_l;
#pragma unroll 1
    for (int r = 0; r < TH; ++r) {
      const float* trow = ts + (r + ky) * kWinW * CI_T;
      const float* erow = es + r * kTW * CO_T;
      float4 t0 = lds4(trow), t1 = lds4(trow + CI_T);
#pragma unroll
      for (int col = 0; col < kTW; ++col) {
        const float4 t2 = lds4(trow + (col + 2) * CI_T);
        const float4 e = lds4(erow + col * CO_T);
        fma_outer(acc[0], e, t0);
        fma_outer(acc[1], e, t1);
        fma_outer(acc[2], e, t2);
        t0 = t1;
        t1 = t2;
      }
    }
    // then tile k + 1's prologue: a warp past its products starts on it
    int b, gy0, gx0;
    if (origin(k + 1, b, gy0, gx0)) form_all(k + 1, (k + 1) % S, gy0, gx0);
  }
  cp_async_wait<0>();  // no copy outlives the block (the groups past the end are empty)
  __syncthreads();     // every warp is past its products: the ring takes the dW tile

  // The dW tile staged as this block's slice of the weight [CO_T][CI_T][3 x
  // 3], then written to out[z] a row of CI_T * 9 consecutive floats at a time.
  float* out_s = dw_reg_smem;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
        out_s[((co_l + j) * CI_T + ci_l + i) * 9 + ky * 3 + kx] = acc[kx][j][i];
  __syncthreads();
  float* part = out + (int64_t)blockIdx.z * Cout * Cin * 9;
  const int row = min(CI_T, Cin - ci0) * 9;
  for (int i = threadIdx.x; i < CO_T * CI_T * 9; i += NT) {
    const int co = i / (CI_T * 9), c = i % (CI_T * 9);
    if (co0 + co < Cout && c < row) part[((int64_t)(co0 + co) * Cin + ci0) * 9 + c] = out_s[i];
  }
}

// ---------------------------------------------------------------------------
// Host side, shared by the translation units that instance the bodies
// (kernel_ptr, smem_allowed and kernel_info: conv3x3_tma.cuh)
// ---------------------------------------------------------------------------

// The fixed-order sum of `splits` partials [Cout, Cin, 3, 3] into dw: for
// the ring and register-blocked bodies' many splits with 16 loads in
// flight a thread and small blocks (more SMs for few outputs), else as the
// first bodies had it. One split was written to dw itself (dw_out).
template <bool RING = false>
int sum_dw_splits(float* part, void* dw, int splits, int Cin, int Cout, cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || (RING && splits == 1)) return (int)err;
  const int64_t n = (int64_t)Cout * Cin * 9;
  if (RING)
    sum_splits_kernel<16><<<(unsigned)((n + 63) / 64), 64, 0, st>>>(part, splits, n,
                                                                   static_cast<float*>(dw));
  else
    sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, splits, n,
                                                                    static_cast<float*>(dw));
  return (int)cudaGetLastError();
}

// Where the ring and register-blocked bodies write: dw itself for one
// split (nothing to sum), else the partials.
float* dw_out(void* partials, void* dw, int splits) {
  return static_cast<float*>(splits == 1 ? dw : partials);
}

// A ring kernel's launch with the CI_T x CO_T tile, then the sum of its
// partials. `launch(grid, threads, smem, out, maps)` launches the caller's
// kernel (of its own name, for the profile families); for CI_T >= 32 the
// TMA maps of the x window, the dy tile and, where `y` is given, the y tile.
template <int CI_T, int CO_T, typename Launch>
int dw_ring_run(const void* kernel, Launch&& launch, const void* x, const void* dy,
                const void* y, void* partials, void* dw, int B, int H, int W, int Cin, int Cout,
                int splits, cudaStream_t st) {
  using Tile = RingTile<CI_T, CO_T>;
  cudaError_t err = smem_allowed(kernel, Tile::kSmem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tms[3] = {};
  if constexpr (Tile::kTma) {
    if ((err = tm_nhwc(&tms[0], x, B, H, W, Cin, CI_T, kWinW, kRingTH + 2)) != cudaSuccess ||
        (err = tm_nhwc(&tms[1], dy, B, H, W, Cout, CO_T, kTW, kRingTH)) != cudaSuccess ||
        (y != nullptr &&
         (err = tm_nhwc(&tms[2], y, B, H, W, Cout, CO_T, kTW, kRingTH)) != cudaSuccess))
      return (int)err;
  }
  const dim3 grid((Cin + CI_T - 1) / CI_T, (Cout + CO_T - 1) / CO_T, splits);
  launch(grid, Tile::kThreads, Tile::kSmem, dw_out(partials, dw, splits), tms);
  return sum_dw_splits<true>(static_cast<float*>(partials), dw, splits, Cin, Cout, st);
}

// The same for a register-blocked kernel: `launch(grid, threads, smem, out)`.
template <int CO_T, typename Launch>
int dw_reg_run(const void* kernel, Launch&& launch, void* partials, void* dw, int Cin, int Cout,
               int splits, cudaStream_t st) {
  using Tile = RegTile<CO_T>;
  const cudaError_t err = smem_allowed(kernel, Tile::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Cin + kRegCiT - 1) / kRegCiT, (Cout + CO_T - 1) / CO_T, splits);
  launch(grid, Tile::kThreads, Tile::kSmem, dw_out(partials, dw, splits));
  return sum_dw_splits<true>(static_cast<float*>(partials), dw, splits, Cin, Cout, st);
}

}  // namespace
}  // namespace cltorch

// The ring instances: (CI_T, CO_T) as kernels/conv3x3.py::dw_ring_tile
// picks them; any other pair is refused (cudaErrorInvalidValue). CALL(CI,
// CO) returns the instance's result.
#define CLTORCH_RING_DISPATCH(CALL)                       \
  if (ci_t == 16 && co_t == 32) return CALL(16, 32);      \
  if (ci_t == 16 && co_t == 64) return CALL(16, 64);      \
  if (ci_t == 32 && co_t == 32) return CALL(32, 32);      \
  if (ci_t == 32 && co_t == 64) return CALL(32, 64);      \
  if (ci_t == 64 && co_t == 32) return CALL(64, 32);      \
  if (ci_t == 64 && co_t == 64) return CALL(64, 64);      \
  return (int)cudaErrorInvalidValue;

// The register-blocked instances: (32, CO_T) as kernels/conv3x3.py::
// dw_fma_tile picks them; CALL(CO) returns the instance's result.
#define CLTORCH_REG_DISPATCH(CALL)                   \
  if (ci_t == 32 && co_t == 32) return CALL(32);     \
  if (ci_t == 32 && co_t == 64) return CALL(64);     \
  return (int)cudaErrorInvalidValue;
