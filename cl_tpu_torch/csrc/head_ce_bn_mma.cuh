// The packed head+CE's backward (#8) in bf16 on the tensor cores: the
// BN·ReLU prologue, the 1x1 head's logits, the masked softmax CE's
// cotangent and every gradient in one pass over the raw last-level output
// y [P, Cin], redesigned for the H100.
//
// Replaces cl_tpu/pallas/head_ce.py::_pkbn_bwd_kernel (:505-549, launched
// at :601) for bf16 features. Its arithmetic, with W rounded to bf16:
//   t = y*s + sh in f32 (product and sum each rounded: no FMA), z =
//   round(max(t, 0)); logits zW^T + b with f32 sums, invalid classes -1e9;
//   g = gce*pix*(softmax - onehot), masked by valid; gc = round(g); dz =
//   round(gc W); du = [t > 0] dz on the f32 t; dx = round(du*s); dscale =
//   sum du*y, dshift = sum du, dW = sum gc^T z, db = sum g (unrounded).
// head_ce_bn.cuh keeps the f32 #8, the forward #7, the KD forms #9-#12 and
// #5/#6; the body is templated on the widths only, for those to move onto.
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

  // the ring zeroed (channels Cin..CIN16 stay zero: no copy writes them),
  // W rounded to bf16 and zero-padded, the vectors
  for (int i = threadIdx.x; i < kHbStages * L::kStageY / 8; i += kHbThreads)
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < CMAX * CIN16; i += kHbThreads) {
    const int c = i / CIN16, k = i % CIN16;
    w_s[c * RY + k] = __float2bfloat16(c < C && k < Cin ? w[c * Cin + k] : 0.f);
  }
  for (int i = threadIdx.x; i < CIN16; i += kHbThreads) {
    s_s[i] = i < Cin ? s[i] : 0.f;
    sh_s[i] = i < Cin ? sh[i] : 0.f;
  }
  for (int i = threadIdx.x; i < CMAX; i += kHbThreads) {
    b_s[i] = i < C ? b[i] : 0.f;
    v_s[i] = i < C ? valid[i] : 0.f;
  }
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
  // Copies of this block's k-th tile into stage st: y rows, zero past P;
  // labels (zero past P, where pix is 0 by the row test below).
  auto issue = [&](int k, int st) {
    if (k >= my_tiles) return;
    const int64_t base = ((int64_t)blockIdx.x + (int64_t)k * gridDim.x) * kHbTile;
    bf16* ys = ring + st * L::kStageY;
    for (int i = threadIdx.x; i < kHbTile * chunks; i += kHbThreads) {
      const int r = i / chunks, q = i - r * chunks;
      const bool on = base + r < P;
      cp_async<16>(ys + r * RY + q * 8, on ? y + (base + r) * Cin + q * 8 : y, on);
    }
    if (threadIdx.x < kHbTile) {
      const bool on = base + threadIdx.x < P;
      cp_async<4>(lbl_s + st * kHbTile + threadIdx.x, on ? labels + base + threadIdx.x : labels,
                  on);
    }
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

// The instance's dynamic shared memory above 48 KB, allowed once per
// instance and device.
template <int CIN16, int CMAX>
cudaError_t hb_smem_allowed() {
  static bool done[16] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 16 && done[dev]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(head_ce_bn_bwd_mma_kernel<CIN16, CMAX>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           HbLayout<CIN16, CMAX>::kSmem);
  if (err == cudaSuccess && dev < 16) done[dev] = true;
  return err;
}

// One launch over `blocks` persistent blocks (one partial row each), then
// the fixed-order sum of the rows into out = [dW | db] [C, Cin + 1],
// dscale, dshift.
template <int CIN16, int CMAX>
int hb_launch(const void* y, const void* s, const void* sh, const void* w, const void* b,
              const void* lbl, const void* valid, const void* cot, void* dx, void* partials,
              void* out, int P, int Cin, int C, int ignore_index, int blocks, cudaStream_t st) {
  cudaError_t err = hb_smem_allowed<CIN16, CMAX>();
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

// What the card gives the instance: {resident blocks an SM, registers a
// thread, local (spilled) bytes a thread, dynamic shared bytes a block}.
template <int CIN16, int CMAX>
int hb_info(int* out) {
  cudaError_t err = hb_smem_allowed<CIN16, CMAX>();
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, head_ce_bn_bwd_mma_kernel<CIN16, CMAX>);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], head_ce_bn_bwd_mma_kernel<CIN16, CMAX>, kHbThreads, HbLayout<CIN16, CMAX>::kSmem);
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = HbLayout<CIN16, CMAX>::kSmem;
  return (int)err;
}

}  // namespace
}  // namespace cltorch
