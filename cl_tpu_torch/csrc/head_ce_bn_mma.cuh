// The packed head+CE's backward (#8) and forward (#7) in bf16 on the
// tensor cores: the BN·ReLU prologue, the 1x1 head's logits, and the
// masked softmax CE's cotangent and every gradient (#8) or its sum (#7),
// in one pass over the raw last-level output y [P, Cin], redesigned for
// the H100.
//
// Replaces cl_tpu/pallas/head_ce.py::_pkbn_bwd_kernel (:505-549, launched
// at :601) for bf16 features. Its arithmetic, with W rounded to bf16:
//   t = y*s + sh in f32 (product and sum each rounded: no FMA), z =
//   round(max(t, 0)); logits zW^T + b with f32 sums, invalid classes -1e9;
//   g = gce*pix*(softmax - onehot), masked by valid; gc = round(g); dz =
//   round(gc W); du = [t > 0] dz on the f32 t; dx = round(du*s); dscale =
//   sum du*y, dshift = sum du, dW = sum gc^T z, db = sum g (unrounded).
// head_ce_bn.cuh keeps the f32 #7 and #8, the KD forms #9-#12 and #5/#6;
// the bodies are templated on the widths only, for those to move onto.
//
// What bounds it on the H100: bytes. At the headline shape (P = 2,097,152
// pixels x 32 channels, 19 classes) it reads y (134 MB) and the labels (8
// MB) and writes dx (134 MB): 0.083 ms at 3.35 TB/s. Its three products
// (the logits, dz and dW) are 3 x 2 x 32 x 32 flops a pixel on the padded
// tile, 13 GFLOP, 0.013 ms at 989 TFLOP/s.
//
// What held the first body (head_ce_bn.cuh, 1.47-1.48 ms) and what this one
// does about each:
// * One pixel a thread, the three products on f32 FMAs. Here a warp takes
//   16 pixels and runs all three on mma.sync m16n8k16 (bf16 in, f32 out):
//   z's A fragments come from the staged y by ldmatrix and the prologue
//   runs on them in registers (z is written back over y for the dW
//   product); the logits come out in accumulator fragments, whose row max
//   and sum over the <= 32 classes take two quad shuffles each; the rounded
//   g is packed from that layout straight into dz's A fragments (no trip
//   through shared memory); dW = gc^T z takes gc^T by ldmatrix.trans from a
//   16-row g tile and z by ldmatrix.trans from the staged rows. W stays
//   resident as bf16 [C][Cin] and feeds the logits (ldmatrix) and dz
//   (ldmatrix.trans). The epilogue (du, dx, dscale, dshift) runs on dz's
//   accumulators with y from the A fragments already in registers.
// * Low occupancy (3 blocks of 4 warps an SM, 61.6 KB of shared memory a
//   block). Blocks of 8 warps hold a 3-stage ring of 128-pixel y tiles, W
//   and 8 g tiles: 45.6 KB at Cin 32, two blocks an SM (16 warps).
// * No overlap of copies and compute. The y tiles and their labels come
//   through the ring by cp.async, two tiles ahead, one block barrier a
//   tile; the grid is one wave of persistent blocks (the wrapper's picker,
//   kernels/head_ce.py::bn_bwd_blocks, sizes it from these resources).
// * The serial dW pass and the dx staging. dW runs on the tensor cores per
//   16 pixels; dx is written in place over the warp's own staged rows and
//   leaves as 16-byte stores of whole rows.
// * Large partials. One partial row a block (about 264 rows, not 1024): the
//   warps' sums are added in warp order in shared memory, and the second
//   launch sums the rows in a fixed order. No float atomics: a relaunch
//   repeats every bit.
//
// The forward (#7; replaces cl_tpu/pallas/head_ce.py::_pkbn_fwd_kernel,
// :482-502, launched at :571, for bf16 features): total = sum_p pix
// (logsumexp - z_label) over the same logits. What bounds it: bytes, y
// (134 MB) and the labels (8 MB) at the headline shape, 0.043 ms. What
// held the first body (head_ce_bn.cuh, 0.215 ms: one pixel a thread, the
// logits on f32 FMAs, synchronous staging) and what this one does:
// * The products: #8's logits on mma.sync against the resident W, the
//   prologue on the ldmatrix'd A fragments (its max on the rounded bf16
//   pair), the logits starting at the bias in the first product.
// * Instructions a pixel, which bound it once the copies overlap (a deeper
//   ring alone barely moved it): no column needs a mask (W's rows of the
//   invalid classes are zero and their bias -1e9, so their logits are the
//   plain version's -1e9 exactly); the column tiles past C are skipped;
//   exp by ex2 of (z - max) log2 e and one log a row; the label's logit by
//   a compare against label - 2t and the same quad shuffles as the sum; s
//   and sh stay in registers up to 32 channels.
// * One barrier and one copy set-up a 256-pixel tile up to 32 channels
//   (two slabs a warp, branch-free so that the compiler interleaves them),
//   through a ring of the stages that fit a third of the SM's shared
//   memory; three blocks an SM, exactly, by asking for that third
//   (kernels/head_ce.py::bn_fwd_blocks sizes one wave from it).
// * One partial a block (the warps' sums in warp order), summed by the
//   fixed-order second launch: a relaunch repeats every bit.

#pragma once

#include "head_ce.cuh"

namespace cltorch {
namespace {

using bf16 = __nv_bfloat16;
constexpr int kHbTile = 128;  // pixels a stage: 8 warps x 16 rows
constexpr int kHbWarps = 8;
constexpr int kHbThreads = kHbWarps * 32;
constexpr int kHbStages = 3;

// The shared memory of the instance for CIN16 (Cin rounded up to 16) and
// CMAX (16 or 32 classes): the ring of y tiles ([128][CIN16 + 8] bf16, so
// the eight rows of an ldmatrix fall on distinct banks) and their labels,
// W [CMAX][CIN16 + 8] bf16, a g tile [16][CMAX + 8] bf16 a warp, then the
// f32 vectors s, sh [CIN16] and b, valid [CMAX]. The block's final sums (dW
// [CMAX][CIN16], db, dscale, dshift) reuse the ring.
template <int CIN16, int CMAX>
struct HbLayout {
  static_assert(CIN16 % 16 == 0 && CIN16 <= 64 && (CMAX == 16 || CMAX == 32), "the instances");
  static constexpr int kRowY = CIN16 + 8, kRowG = CMAX + 8;  // bf16
  static constexpr int kStageY = kHbTile * kRowY;            // bf16
  static constexpr int kY = 0;
  static constexpr int kLbl = kY + kHbStages * kStageY * 2;
  static constexpr int kW = kLbl + kHbStages * kHbTile * 4;
  static constexpr int kG = kW + CMAX * kRowY * 2;
  static constexpr int kVec = kG + kHbWarps * 16 * kRowG * 2;
  static constexpr int kSmem = kVec + (2 * CIN16 + 2 * CMAX) * 4;
  static constexpr int kRed = CMAX * CIN16 + CMAX + 2 * CIN16;  // floats
  static_assert(kRed * 4 <= kLbl, "the block's sums fit the ring");
  // resident blocks an SM (__launch_bounds__): three of the narrowest
  // instance, two up to 32 channels, else one
  static constexpr int kMinBlocks = CIN16 == 16 && CMAX == 16 ? 3 : CIN16 <= 32 ? 2 : 1;
};

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xFFFF0000u));
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float ex2_approx(float x) {  // 2^x, one MUFU op
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Both kernels' set-up, by the block: the ring of `ring_words` 16-byte
// words zeroed where Cin < CIN16 (channels Cin..CIN16 stay zero: no copy
// writes them), W
// rounded to bf16 and zero-padded [CMAX][CIN16 + 8], the vectors s, sh
// [CIN16] and b, valid [CMAX] at vec (zero past Cin and C).
// With ZERO_INVALID, W's rows of the classes that are not valid are zero
// too (the forward's masked logits are then exactly its bias of -1e9).
template <int CIN16, int CMAX, bool ZERO_INVALID = false>
__device__ __forceinline__ void hb_load(uint4* ring, int ring_words, bf16* w_s, float* vec,
                                        const float* __restrict__ s,
                                        const float* __restrict__ sh,
                                        const float* __restrict__ w,
                                        const float* __restrict__ b,
                                        const float* __restrict__ valid, int Cin, int C) {
  constexpr int RY = CIN16 + 8;
  if (Cin < CIN16)  // else no channel past Cin is read (rows past P are zero-filled copies)
    for (int i = threadIdx.x; i < ring_words; i += kHbThreads) ring[i] = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < CMAX * CIN16; i += kHbThreads) {
    const int c = i / CIN16, k = i % CIN16;
    const bool on = c < C && k < Cin && (!ZERO_INVALID || valid[c] > 0.f);
    w_s[c * RY + k] = __float2bfloat16(on ? w[c * Cin + k] : 0.f);
  }
  float *s_s = vec, *sh_s = vec + CIN16, *b_s = vec + 2 * CIN16, *v_s = b_s + CMAX;
  for (int i = threadIdx.x; i < CIN16; i += kHbThreads) {
    s_s[i] = i < Cin ? s[i] : 0.f;
    sh_s[i] = i < Cin ? sh[i] : 0.f;
  }
  for (int i = threadIdx.x; i < CMAX; i += kHbThreads) {
    b_s[i] = i < C ? b[i] : 0.f;
    v_s[i] = i < C ? valid[i] : 0.f;
  }
}

// Copies of the block's k-th tile into stage st (ys its y rows [128][CIN16
// + 8], ls its labels), by the block: y rows, zero past P; labels (zero
// past P, where pix is 0 by the row test).
template <int CIN16, int TILE = kHbTile>
__device__ __forceinline__ void hb_issue(int k, int my_tiles, bf16* ys, int* ls,
                                         const bf16* __restrict__ y,
                                         const int* __restrict__ labels, int P, int Cin) {
  if (k >= my_tiles) return;
  constexpr int RY = CIN16 + 8;
  const int chunks = Cin / 8;  // 16-byte pieces of a pixel's row
  const int64_t base = ((int64_t)blockIdx.x + (int64_t)k * gridDim.x) * TILE;
  for (int i = threadIdx.x; i < TILE * chunks; i += kHbThreads) {
    const int r = i / chunks, q = i - r * chunks;
    const bool on = base + r < P;
    cp_async<16>(ys + r * RY + q * 8, on ? y + (base + r) * Cin + q * 8 : y, on);
  }
  for (int r = threadIdx.x; r < TILE; r += kHbThreads) {
    const bool on = base + r < P;
    cp_async<4>(ls + r, on ? labels + base + r : labels, on);
  }
}

template <int CIN16, int CMAX>
__global__ void __launch_bounds__(kHbThreads, HbLayout<CIN16, CMAX>::kMinBlocks)
    head_ce_bn_bwd_mma_kernel(const bf16* __restrict__ y, const float* __restrict__ s,
                              const float* __restrict__ sh, const float* __restrict__ w,
                              const float* __restrict__ b, const int* __restrict__ labels,
                              const float* __restrict__ valid, const float* __restrict__ cot,
                              bf16* __restrict__ dx, float* __restrict__ partials, int P, int Cin,
                              int C, int ignore_index) {
  using L = HbLayout<CIN16, CMAX>;
  constexpr int KS = CIN16 / 16;  // k-steps of the logits
  constexpr int NC = CIN16 / 8;   // n8 tiles of dz and dW (channels)
  constexpr int NT = CMAX / 8;    // n8 tiles of the logits (classes)
  constexpr int KC = CMAX / 16;   // k-steps of dz; m16 tiles of dW
  constexpr int RY = L::kRowY, RG = L::kRowG;
  extern __shared__ __align__(16) unsigned char hb_smem[];
  bf16* ring = reinterpret_cast<bf16*>(hb_smem + L::kY);
  int* lbl_s = reinterpret_cast<int*>(hb_smem + L::kLbl);
  bf16* w_s = reinterpret_cast<bf16*>(hb_smem + L::kW);
  float* s_s = reinterpret_cast<float*>(hb_smem + L::kVec);
  float *sh_s = s_s + CIN16, *b_s = sh_s + CIN16, *v_s = b_s + CMAX;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: the row of matrix lm this lane addresses
  bf16* g_s = reinterpret_cast<bf16*>(hb_smem + L::kG) + warp * 16 * RG;

  hb_load<CIN16, CMAX>(reinterpret_cast<uint4*>(ring), kHbStages * L::kStageY / 8, w_s, s_s, s,
                       sh, w, b, valid, Cin, C);
  const float gce = cot[0];
  __syncthreads();
  // this thread's logit columns 8j + 2t + e: bias, and bit 2j + e of `in`
  // (c < C) and of `ok` (c < C and valid)
  float bcol[NT][2];
  uint32_t in = 0, ok = 0;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * t + e;
      bcol[j][e] = b_s[c];
      in |= (c < C ? 1u : 0u) << (2 * j + e);
      ok |= (c < C && v_s[c] > 0.f ? 1u : 0u) << (2 * j + e);
    }

  const int n_tiles = (P + kHbTile - 1) / kHbTile;
  const int my_tiles = (int)blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int chunks = Cin / 8;  // 16-byte pieces of a pixel's row
  auto issue = [&](int k, int st) {
    hb_issue<CIN16>(k, my_tiles, ring + st * L::kStageY, lbl_s + st * kHbTile, y, labels, P, Cin);
  };

  // This thread's sums: dW (D[class][channel] fragments), db of its
  // classes 8j + 2t + e, dscale and dshift of its channels 8n + 2t + e.
  float dw[KC][NC][4], db[NT][2], dsc[NC][2], dsh[NC][2];
#pragma unroll
  for (int i = 0; i < KC; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dw[i][n][e] = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) db[j][0] = db[j][1] = 0.f;
#pragma unroll
  for (int n = 0; n < NC; ++n) dsc[n][0] = dsc[n][1] = dsh[n][0] = dsh[n][1] = 0.f;

  issue(0, 0);
  cp_async_commit();
  issue(1, 1);
  cp_async_commit();
  for (int k = 0; k < my_tiles; ++k) {
    const int st = k % kHbStages;
    cp_async_wait<kHbStages - 2>();  // tile k has landed
    // every warp is past tile k - 1: its stage takes tile k + 2
    __syncthreads();
    issue(k + kHbStages - 1, (k + kHbStages - 1) % kHbStages);
    cp_async_commit();
    const int64_t tile0 = ((int64_t)blockIdx.x + (int64_t)k * gridDim.x) * kHbTile;
    for (int sl = warp; sl < kHbTile / 16; sl += kHbWarps) {  // the warp's slabs of 16 rows
      const int64_t row0 = tile0 + sl * 16;
      if (row0 >= P) break;  // past the end
      bf16* ys = ring + st * L::kStageY + sl * 16 * RY;
      const int* ls = lbl_s + st * kHbTile + sl * 16;

      // y as the logits' A fragments: ya[kk] = {rows g, g + 8} x {channels
      // 16kk + 2t, +1} and {16kk + 8 + 2t, +1}; z = round(max(y s + sh, 0))
      // from them, written back over y (each word by the lane that holds it)
      uint32_t ya[KS][4], za[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4(ya[kk], ys + ((lm & 1) * 8 + lr) * RY + kk * 16 + (lm >> 1) * 8);
      __syncwarp();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int ch = kk * 16 + (r >> 1) * 8 + 2 * t;
          const float2 yv = unpack_bf16x2(ya[kk][r]);
          const float2 sv = *reinterpret_cast<const float2*>(&s_s[ch]);
          const float2 hv = *reinterpret_cast<const float2*>(&sh_s[ch]);
          za[kk][r] = pack_bf16x2(fmaxf(__fadd_rn(__fmul_rn(yv.x, sv.x), hv.x), 0.f),
                                  fmaxf(__fadd_rn(__fmul_rn(yv.y, sv.y), hv.y), 0.f));
          *reinterpret_cast<uint32_t*>(&ys[(g + (r & 1) * 8) * RY + ch]) = za[kk][r];
        }

      // logits: z W^T + b; lg[j] = {row g, row g + 8} x classes 8j + 2t, +1
      float lg[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        lg[j][0] = lg[j][2] = bcol[j][0];
        lg[j][1] = lg[j][3] = bcol[j][1];
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {  // class tiles 2jp and 2jp + 1
          uint32_t wb[4];
          ldmatrix_x4(wb, w_s + ((2 * jp + (lm >> 1)) * 8 + lr) * RY + kk * 16 + (lm & 1) * 8);
          mma_bf16(lg[2 * jp], za[kk], wb[0], wb[1]);
          mma_bf16(lg[2 * jp + 1], za[kk], wb[2], wb[3]);
        }

      // the masked softmax over the C classes of each row: the quad's four
      // lanes hold a row's columns. exp by ex2.approx and one reciprocal a
      // row: g is rounded to bf16 before its products (dz, dW), and db's
      // tolerance is the head's
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t bit = 1u << (2 * j + (e & 1));
          lg[j][e] = ok & bit ? lg[j][e] : kNegInf;
          if (in & bit) mx[e >> 1] = fmaxf(mx[e >> 1], lg[j][e]);
        }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          lg[j][e] = in & (1u << (2 * j + (e & 1))) ? __expf(lg[j][e] - mx[e >> 1]) : 0.f;
          sum[e >> 1] += lg[j][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        sum[h] = __frcp_rn(sum[h]);
      }
      // g = gce pix (p - onehot) on the valid classes; db sums it unrounded;
      // gc = round(g), into the g tile and, packed, dz's A fragments
      float sp[2];
      int lbl0[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lbl = ls[g + 8 * h];
        const bool pix = row0 + g + 8 * h < P && lbl != ignore_index;
        sp[h] = gce * (pix ? 1.f : 0.f);
        lbl0[h] = lbl == ignore_index ? 0 : lbl;
      }
      uint32_t gp[NT][2];  // gc of rows g, g + 8 at classes 8j + 2t, +1
      __syncwarp();        // the previous slab's ldmatrix of the g tile is done
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float gv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1), h = e >> 1;
          const float v = sp[h] * (lg[j][e] * sum[h] - (c == lbl0[h] ? 1.f : 0.f));
          gv[e] = ok & (1u << (2 * j + (e & 1))) ? v : 0.f;
        }
        db[j][0] += gv[0];
        db[j][1] += gv[1];
        db[j][0] += gv[2];
        db[j][1] += gv[3];
        gp[j][0] = pack_bf16x2(gv[0], gv[1]);
        gp[j][1] = pack_bf16x2(gv[2], gv[3]);
        *reinterpret_cast<uint32_t*>(&g_s[g * RG + 8 * j + 2 * t]) = gp[j][0];
        *reinterpret_cast<uint32_t*>(&g_s[(g + 8) * RG + 8 * j + 2 * t]) = gp[j][1];
      }
      __syncwarp();  // the g tile and the z rows are written

      // dW += gc^T z: A = gc^T (classes x 16 pixels) by ldmatrix.trans of the
      // g tile, B = z (16 pixels x channels) by ldmatrix.trans of the rows
      uint32_t zb[NC / 2][4];
#pragma unroll
      for (int np = 0; np < NC / 2; ++np)
        ldmatrix_x4_trans(zb[np], ys + ((lm & 1) * 8 + lr) * RY + (2 * np + (lm >> 1)) * 8);
#pragma unroll
      for (int mt = 0; mt < KC; ++mt) {
        uint32_t ga[4];
        ldmatrix_x4_trans(ga, g_s + ((lm >> 1) * 8 + lr) * RG + mt * 16 + (lm & 1) * 8);
#pragma unroll
        for (int np = 0; np < NC / 2; ++np) {
          mma_bf16(dw[mt][2 * np], ga, zb[np][0], zb[np][1]);
          mma_bf16(dw[mt][2 * np + 1], ga, zb[np][2], zb[np][3]);
        }
      }

      // dz = round(gc W) (A fragments from gp, B = W by ldmatrix.trans), then
      // per element du = [t > 0] dz, dx = round(du s), dscale and dshift; y
      // from ya, whose fragment positions are dz's (channel tile n = 2kk + h:
      // rows g, g + 8 are ya[kk][2h], ya[kk][2h + 1]); dx over the rows
#pragma unroll
      for (int np = 0; np < NC / 2; ++np) {
        float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          const uint32_t ga[4] = {gp[2 * kc][0], gp[2 * kc][1], gp[2 * kc + 1][0],
                                  gp[2 * kc + 1][1]};
          uint32_t wb[4];
          ldmatrix_x4_trans(wb, w_s + (kc * 16 + (lm & 1) * 8 + lr) * RY +
                                    (2 * np + (lm >> 1)) * 8);
          mma_bf16(d[0], ga, wb[0], wb[1]);
          mma_bf16(d[1], ga, wb[2], wb[3]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = 2 * np + h, ch = 8 * n + 2 * t;
          const float2 sv = *reinterpret_cast<const float2*>(&s_s[ch]);
          const float2 hv = *reinterpret_cast<const float2*>(&sh_s[ch]);
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const float2 yv = unpack_bf16x2(ya[np][2 * h + rr]);
            const float t0 = __fadd_rn(__fmul_rn(yv.x, sv.x), hv.x);
            const float t1 = __fadd_rn(__fmul_rn(yv.y, sv.y), hv.y);
            const float du0 = t0 > 0.f ? round_to<bf16>(d[h][2 * rr]) : 0.f;
            const float du1 = t1 > 0.f ? round_to<bf16>(d[h][2 * rr + 1]) : 0.f;
            dsc[n][0] = fmaf(du0, yv.x, dsc[n][0]);
            dsc[n][1] = fmaf(du1, yv.y, dsc[n][1]);
            dsh[n][0] += du0;
            dsh[n][1] += du1;
            *reinterpret_cast<uint32_t*>(&ys[(g + 8 * rr) * RY + ch]) =
                pack_bf16x2(__fmul_rn(du0, sv.x), __fmul_rn(du1, sv.y));
          }
        }
      }
      __syncwarp();  // the warp's dx rows are complete
      for (int i = lane; i < 16 * chunks; i += 32) {
        const int r = i / chunks, q = i - r * chunks;
        if (row0 + r < P)
          *reinterpret_cast<uint4*>(dx + (row0 + r) * Cin + q * 8) =
              *reinterpret_cast<const uint4*>(&ys[r * RY + q * 8]);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (the groups past the end are empty)
  __syncthreads();     // every warp is past its tiles: the ring takes the sums

  // db, dscale, dshift over the eight lanes of each t (fixed butterflies:
  // every lane ends with the same bits); then the warps' sums added in
  // warp order: red = [dW [CMAX][CIN16] | db [CMAX] | dscale | dshift]
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) db[j][e] += __shfl_xor_sync(0xffffffffu, db[j][e], o);
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dsc[n][e] += __shfl_xor_sync(0xffffffffu, dsc[n][e], o);
        dsh[n][e] += __shfl_xor_sync(0xffffffffu, dsh[n][e], o);
      }
  }
  float* red = reinterpret_cast<float*>(hb_smem);
  float *red_b = red + CMAX * CIN16, *red_sc = red_b + CMAX, *red_sh = red_sc + CIN16;
  for (int wv = 0; wv < kHbWarps; ++wv) {
    if (warp == wv) {
#pragma unroll
      for (int mt = 0; mt < KC; ++mt)
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float* dst = &red[(mt * 16 + g + 8 * (e >> 1)) * CIN16 + 8 * n + 2 * t + (e & 1)];
            *dst = wv == 0 ? dw[mt][n][e] : *dst + dw[mt][n][e];
          }
      if (g == 0) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float* dst = &red_b[8 * j + 2 * t + e];
            *dst = wv == 0 ? db[j][e] : *dst + db[j][e];
          }
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float* d1 = &red_sc[8 * n + 2 * t + e];
            float* d2 = &red_sh[8 * n + 2 * t + e];
            *d1 = wv == 0 ? dsc[n][e] : *d1 + dsc[n][e];
            *d2 = wv == 0 ? dsh[n][e] : *d2 + dsh[n][e];
          }
      }
    }
    __syncthreads();
  }
  // this block's partial row: [dW | db] as [C, Cin + 1], then dscale, dshift
  const int n_ent = C * (Cin + 1) + 2 * Cin;
  float* part = partials + (int64_t)blockIdx.x * n_ent;
  for (int i = threadIdx.x; i < n_ent; i += kHbThreads) {
    float v;
    if (i < C * (Cin + 1)) {
      const int c = i / (Cin + 1), kk = i - c * (Cin + 1);
      v = kk < Cin ? red[c * CIN16 + kk] : red_b[c];
    } else {
      const int j = i - C * (Cin + 1);
      v = j < Cin ? red_sc[j] : red_sh[j - Cin];
    }
    part[i] = v;
  }
}

// ---------------------------------------------------------------------------
// The forward (#7): the logits and the row softmax of the body above,
// without dz, dW and dx
// ---------------------------------------------------------------------------

// The SM's shared memory as the pickers count it (kernels/__init__.py::
// SMEM_PER_SM, SMEM_RESERVED_PER_BLOCK).
constexpr int kSmemPerSm = 233472, kSmemReservedPerBlock = 1024;

// The forward's shared memory for CIN16 and CMAX: #8's without the g
// tiles (a ring of y tiles and their labels, W, the vectors), then the
// warps' sums. Each block asks for a third of the SM's shared memory
// (kSmem), so that exactly three are resident (kMinBlocks, as
// __launch_bounds__ fits the registers) whatever registers the compiler
// leaves, as the wrapper's picker (kernels/head_ce.py::bn_fwd_blocks)
// assumes. A stage is 256 pixels up to 32 channels (two slabs of 16 rows a
// warp, so the barrier and the copies' set-up count half as often), else
// 128; the ring takes as many stages as fit, at most kHfMaxStages.
constexpr int kHfMaxStages = 6;

template <int CIN16, int CMAX>
struct HfLayout {
  static_assert(CIN16 % 16 == 0 && CIN16 <= 64 && (CMAX == 16 || CMAX == 32), "the instances");
  static constexpr int kTile = CIN16 <= 32 ? 2 * kHbTile : kHbTile;  // pixels a stage
  static constexpr int kRowY = CIN16 + 8;                             // bf16
  static constexpr int kStageY = kTile * kRowY;                       // bf16
  static constexpr int kMinBlocks = 3;
  static constexpr int kSmem = kSmemPerSm / kMinBlocks - kSmemReservedPerBlock;
  static constexpr int kFixed = CMAX * kRowY * 2 + (2 * CIN16 + 2 * CMAX) * 4 + kHbWarps * 4;
  static constexpr int kFit = (kSmem - kFixed) / (kStageY * 2 + kTile * 4);
  static constexpr int kStages = kFit < kHfMaxStages ? kFit : kHfMaxStages;
  static constexpr int kY = 0;
  static constexpr int kLbl = kY + kStages * kStageY * 2;
  static constexpr int kW = kLbl + kStages * kTile * 4;
  static constexpr int kVec = kW + CMAX * kRowY * 2;
  static constexpr int kRed = kVec + (2 * CIN16 + 2 * CMAX) * 4;
  static_assert(kStages >= 3 && kRed + kHbWarps * 4 <= kSmem, "the ring fits the share");
};

// d = a b + c on the tensor cores, as mma_bf16 with the accumulator in
// from other registers (the logits start at the bias without a copy).
__device__ __forceinline__ void mma_bf16_c(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                           uint32_t b1, float c0, float c1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%11,%10,%11};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c0), "f"(c1));
}

// partials[block] = sum over the block's rows of pix (logsumexp(z W^T + b)
// - logit[label]), the logits masked to the valid classes (-1e9), z =
// round(max(y s + sh, 0)); pix is 0 at ignore_index and past P. The
// persistent blocks walk the pixel tiles through a ring as #8's.
template <int CIN16, int CMAX>
__global__ void __launch_bounds__(kHbThreads, HfLayout<CIN16, CMAX>::kMinBlocks)
    head_ce_bn_fwd_mma_kernel(const bf16* __restrict__ y, const float* __restrict__ s,
                              const float* __restrict__ sh, const float* __restrict__ w,
                              const float* __restrict__ b, const int* __restrict__ labels,
                              const float* __restrict__ valid, float* __restrict__ partials,
                              int P, int Cin, int C, int ignore_index) {
  using L = HfLayout<CIN16, CMAX>;
  constexpr int KS = CIN16 / 16;  // k-steps of the logits
  constexpr int NT = CMAX / 8;    // n8 tiles of the logits (classes)
  constexpr int RY = L::kRowY, NS = L::kStages, TILE = L::kTile;
  extern __shared__ __align__(16) unsigned char hf_smem[];
  bf16* ring = reinterpret_cast<bf16*>(hf_smem + L::kY);
  int* lbl_s = reinterpret_cast<int*>(hf_smem + L::kLbl);
  bf16* w_s = reinterpret_cast<bf16*>(hf_smem + L::kW);
  float* s_s = reinterpret_cast<float*>(hf_smem + L::kVec);
  float *sh_s = s_s + CIN16, *b_s = sh_s + CIN16, *v_s = b_s + CMAX;
  float* red = reinterpret_cast<float*>(hf_smem + L::kRed);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: the row of matrix lm this lane addresses
  hb_load<CIN16, CMAX, true>(reinterpret_cast<uint4*>(ring), NS * L::kStageY / 8, w_s, s_s, s,
                             sh, w, b, valid, Cin, C);
  __syncthreads();
  // This thread's logit columns 8j + 2t + e start at the bias, or at -1e9
  // where the class is past C or not valid (its row of W is zero): the
  // products then give the masked logits, -1e9 exactly, and no column needs
  // a test. The columns past C join the max at -1e9 and add 0 to the sum
  // (or, where no class is valid, log CMAX instead of log C to -1e9, below
  // its half ulp). Its channels' s and sh (16kk + 8hh + 2t, +1) stay in
  // registers up to 32 channels.
  float bcol[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * t + e;
      bcol[j][e] = c < C && v_s[c] > 0.f ? b_s[c] : kNegInf;
    }
  const int nt_live = (C + 7) / 8;  // column tiles with a class below C
  constexpr bool kVecRegs = KS <= 2;
  float2 sv[KS][2], hv[KS][2];
  if constexpr (kVecRegs)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int ch = kk * 16 + hh * 8 + 2 * t;
        sv[kk][hh] = *reinterpret_cast<const float2*>(&s_s[ch]);
        hv[kk][hh] = *reinterpret_cast<const float2*>(&sh_s[ch]);
      }

  const int n_tiles = (P + TILE - 1) / TILE;
  const int my_tiles = (int)blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  auto issue = [&](int k, int st) {
    hb_issue<CIN16, TILE>(k, my_tiles, ring + st * L::kStageY, lbl_s + st * TILE, y, labels, P,
                          Cin);
  };

  float ce = 0.f;  // this lane's rows' terms (lanes t = 0)
#pragma unroll
  for (int k = 0; k < NS - 1; ++k) {
    issue(k, k);
    cp_async_commit();
  }
  for (int k = 0; k < my_tiles; ++k) {
    const int st = k % NS;
    cp_async_wait<NS - 2>();  // tile k has landed
    // every warp is past tile k - 1: its stage takes tile k + NS - 1
    __syncthreads();
    issue(k + NS - 1, (k + NS - 1) % NS);
    cp_async_commit();
    const int64_t tile0 = ((int64_t)blockIdx.x + (int64_t)k * gridDim.x) * TILE;
    // the warp's slabs of 16 rows, branch-free (rows past P are zeros with
    // pix 0), so that the compiler interleaves them
#pragma unroll
    for (int i = 0; i < TILE / 16 / kHbWarps; ++i) {
      const int sl = warp + i * kHbWarps;
      const int64_t row0 = tile0 + sl * 16;
      const bf16* ys = ring + st * L::kStageY + sl * 16 * RY;
      const int* ls = lbl_s + st * TILE + sl * 16;

      // z = round(max(y s + sh, 0)) as the logits' A fragments, from y's by
      // ldmatrix: za[kk] = {rows g, g + 8} x {channels 16kk + 2t, +1} and
      // {16kk + 8 + 2t, +1}; the max taken on the rounded pair (rounding
      // is monotonic and keeps 0)
      uint32_t za[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4(za[kk], ys + ((lm & 1) * 8 + lr) * RY + kk * 16 + (lm >> 1) * 8);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int hh = r >> 1, ch = kk * 16 + hh * 8 + 2 * t;
          const float2 yv = unpack_bf16x2(za[kk][r]);
          float2 s2, h2;
          if constexpr (kVecRegs) {
            s2 = sv[kk][hh];
            h2 = hv[kk][hh];
          } else {
            s2 = *reinterpret_cast<const float2*>(&s_s[ch]);
            h2 = *reinterpret_cast<const float2*>(&sh_s[ch]);
          }
          const uint32_t tr = pack_bf16x2(__fadd_rn(__fmul_rn(yv.x, s2.x), h2.x),
                                          __fadd_rn(__fmul_rn(yv.y, s2.y), h2.y));
          asm("max.bf16x2 %0, %1, %2;" : "=r"(za[kk][r]) : "r"(tr), "r"(0u));
        }
      // the logits z W^T + b: lg[j] = {row g, row g + 8} x classes 8j + 2t, +1
      float lg[NT][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {  // class tiles 2jp and 2jp + 1
          uint32_t wb[4];
          ldmatrix_x4(wb, w_s + ((2 * jp + (lm >> 1)) * 8 + lr) * RY + kk * 16 + (lm & 1) * 8);
          if (kk == 0) {
            mma_bf16_c(lg[2 * jp], za[kk], wb[0], wb[1], bcol[2 * jp][0], bcol[2 * jp][1]);
            mma_bf16_c(lg[2 * jp + 1], za[kk], wb[2], wb[3], bcol[2 * jp + 1][0],
                       bcol[2 * jp + 1][1]);
          } else {
            mma_bf16(lg[2 * jp], za[kk], wb[0], wb[1]);
            mma_bf16(lg[2 * jp + 1], za[kk], wb[2], wb[3]);
          }
        }

      // the softmax CE of rows g, g + 8 (e / 2): the quad's four lanes hold
      // a row's columns; the max and the sum by two quad shuffles each, exp
      // by ex2 of (z - max) log2 e, one log a row; the label's logit from
      // the one lane that holds it (column 8j + e of its own at label - 2t),
      // by the same shuffles; the column tiles past C skipped
      int dl[2];
      bool pix[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lbl = ls[g + 8 * h];
        pix[h] = row0 + g + 8 * h < P && lbl != ignore_index;
        dl[h] = (lbl == ignore_index ? 0 : lbl) - 2 * t;
      }
      float mx[2] = {kNegInf, kNegInf}, pk[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j < nt_live)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            mx[e >> 1] = fmaxf(mx[e >> 1], lg[j][e]);
            if (dl[e >> 1] == 8 * j + (e & 1)) pk[e >> 1] = lg[j][e];
          }
      float sum[2] = {0.f, 0.f}, nm[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        pk[h] += __shfl_xor_sync(0xffffffffu, pk[h], 1);
        pk[h] += __shfl_xor_sync(0xffffffffu, pk[h], 2);
        nm[h] = -mx[h] * kLog2e;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j < nt_live)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sum[e >> 1] += ex2_approx(fmaf(lg[j][e], kLog2e, nm[e >> 1]));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        if (t == 0 && pix[h]) ce += (mx[h] + __logf(sum[h])) - pk[h];
      }
    }
  }
  // the lanes' sums over the warp, then the warps' in warp order
  ce = warp_sum(ce);
  if (lane == 0) red[warp] = ce;
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = 0.f;
#pragma unroll
    for (int wv = 0; wv < kHbWarps; ++wv) v += red[wv];
    partials[blockIdx.x] = v;
  }
  cp_async_wait<0>();  // no copy outlives the block (the groups past the end are empty)
}

// An instance's dynamic shared memory above 48 KB (#8's, FWD false; #7's,
// FWD true), allowed once per instance and device.
template <int CIN16, int CMAX, bool FWD>
cudaError_t hb_smem_allowed() {
  static bool done[16] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 16 && done[dev]) return cudaSuccess;
  cudaError_t err;
  if constexpr (FWD)
    err = cudaFuncSetAttribute(head_ce_bn_fwd_mma_kernel<CIN16, CMAX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               HfLayout<CIN16, CMAX>::kSmem);
  else
    err = cudaFuncSetAttribute(head_ce_bn_bwd_mma_kernel<CIN16, CMAX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               HbLayout<CIN16, CMAX>::kSmem);
  if (err == cudaSuccess && dev < 16) done[dev] = true;
  return err;
}

// #8: one launch over `blocks` persistent blocks (one partial row each),
// then the fixed-order sum of the rows into out = [dW | db] [C, Cin + 1],
// dscale, dshift.
template <int CIN16, int CMAX>
int hb_launch(const void* y, const void* s, const void* sh, const void* w, const void* b,
              const void* lbl, const void* valid, const void* cot, void* dx, void* partials,
              void* out, int P, int Cin, int C, int ignore_index, int blocks, cudaStream_t st) {
  cudaError_t err = hb_smem_allowed<CIN16, CMAX, false>();
  if (err != cudaSuccess) return (int)err;
  head_ce_bn_bwd_mma_kernel<CIN16, CMAX>
      <<<blocks, kHbThreads, HbLayout<CIN16, CMAX>::kSmem, st>>>(
          static_cast<const bf16*>(y), static_cast<const float*>(s),
          static_cast<const float*>(sh), static_cast<const float*>(w),
          static_cast<const float*>(b), static_cast<const int*>(lbl),
          static_cast<const float*>(valid), static_cast<const float*>(cot),
          static_cast<bf16*>(dx), static_cast<float*>(partials), P, Cin, C, ignore_index);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_ent = C * (Cin + 1) + 2 * Cin;
  reduce_rows_kernel<<<n_ent, kReduceThreads, 0, st>>>(static_cast<const float*>(partials),
                                                       blocks, n_ent, n_ent,
                                                       static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// #7: one launch over `blocks` persistent blocks (one partial each), then
// the fixed-order sum of the partials into out_ce.
template <int CIN16, int CMAX>
int hf_launch(const void* y, const void* s, const void* sh, const void* w, const void* b,
              const void* lbl, const void* valid, void* partials, void* out_ce, int P, int Cin,
              int C, int ignore_index, int blocks, cudaStream_t st) {
  cudaError_t err = hb_smem_allowed<CIN16, CMAX, true>();
  if (err != cudaSuccess) return (int)err;
  head_ce_bn_fwd_mma_kernel<CIN16, CMAX>
      <<<blocks, kHbThreads, HfLayout<CIN16, CMAX>::kSmem, st>>>(
          static_cast<const bf16*>(y), static_cast<const float*>(s),
          static_cast<const float*>(sh), static_cast<const float*>(w),
          static_cast<const float*>(b), static_cast<const int*>(lbl),
          static_cast<const float*>(valid), static_cast<float*>(partials), P, Cin, C,
          ignore_index);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<<<1, kReduceThreads, 0, st>>>(static_cast<const float*>(partials), blocks,
                                                   1, 1, static_cast<float*>(out_ce));
  return (int)cudaGetLastError();
}

// What the card gives an instance (#8's, FWD false; #7's, FWD true):
// {resident blocks an SM, registers a thread, local (spilled) bytes a
// thread, dynamic shared bytes a block}.
template <int CIN16, int CMAX, bool FWD>
int hb_info(int* out) {
  cudaError_t err = hb_smem_allowed<CIN16, CMAX, FWD>();
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  if constexpr (FWD) {
    out[3] = HfLayout<CIN16, CMAX>::kSmem;
    err = cudaFuncGetAttributes(&attr, head_ce_bn_fwd_mma_kernel<CIN16, CMAX>);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &out[0], head_ce_bn_fwd_mma_kernel<CIN16, CMAX>, kHbThreads, out[3]);
  } else {
    out[3] = HbLayout<CIN16, CMAX>::kSmem;
    err = cudaFuncGetAttributes(&attr, head_ce_bn_bwd_mma_kernel<CIN16, CMAX>);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &out[0], head_ce_bn_bwd_mma_kernel<CIN16, CMAX>, kHbThreads, out[3]);
  }
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  return (int)err;
}

}  // namespace
}  // namespace cltorch
