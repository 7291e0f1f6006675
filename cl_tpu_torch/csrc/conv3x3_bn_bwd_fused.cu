// The one-pass backward of the 3x3 SAME conv with the BN-ReLU prologue
// (#37, under CL_TPU_FUSE_BWD=1): dx, da, db and dW from one launch.
//
// Replaces the TPU kernel cl_tpu/pallas/conv3x3_v3.py::_bwd_fused_kernel
// (launched at conv3x3_v3.py:1480 by `_bwd_fused_impl`, body :1420, from
// `_cbf_bwd` at :938-950 when `_pick_th_bwdf` finds a tile). Per pixel
// tile, as the TPU kernel:
//
//   e  = round(dy + ds1 + 2 * y * ds2)  (e = dy without stats cotangents),
//        formed once, zero outside the image (e-space padding)
//   dt = conv3x3_SAME(e, w_flip^T)      f32 accumulator, not rounded
//   prologue on: u = x * a + b from the RAW x, du = [u > 0] * dt,
//                dx = round(du * a), da = sum du * x, db = sum du
//   prologue off: dx = round(dt) (da, db zero)
//   t  = round(relu(x * a + b)) (or x), zero outside the image (t-space)
//   dW += t-pieces * e                  f32, rounded once by the wrapper
//
// the arithmetic of the fused branch (#34/#35 and #36), so the outputs are
// theirs: the e and t staging (conv3x3_bn.cuh), the bf16 tap loop and the
// dx epilogue with its per-tile partial rows of da and db (shared with
// conv3x3_bn.cu), the dW's pixel split and per-tile order (#36's). In bf16
// dx, da, db and dW are bit-equal to #34/#35 + #36; in f32 dx and dW are,
// and da, db sum 8 x 16 tiles where #35 sums 16 x 16 ones. Under
// CL_TPU_E_BF16 (ew_bf16, bf16 only) e and t take the bf16 chains
// (conv3x3_bn.cuh), as #34/#35 and #36 do, while the dx epilogue reads the
// same a and b in f32.
//
// What bounds it on the H100: bytes. At 512^2 x 32 -> 32, batch 8, bf16:
// x, dy and y read once and dx written, 537 MB, 160 us at 3.35 TB/s,
// against 77 GFLOP (dx and dW), 78 us at 989 TFLOP/s; f32 on the FMA units.
//
// Design. The grid is #36's: a block owns 32 of the forward's input
// channels (dx's outputs, the dW's rows), 32 of its output channels (one
// dW pass: an f32 accumulator of 32 x 32 x 9) and a split of the pixel
// tiles (every gridDim.z-th). The passes of one input tile and split walk
// the same tiles and share out their dx: the block of pass k forms the dx
// of every n-th of them (n passes), over every output channel. Per tile a
// block stages the 18 x 18 window of t once; then, per 16 (bf16) or 32
// (f32) channels of e, it forms that chunk of the e window once and feeds
// it to both products: the dx (on its dx tiles, over every chunk) and the
// dW (its pass's chunks). The dx epilogue reads the raw x rows; partial
// dW go out per split and partial da/db rows per tile, each summed in a
// fixed order by a second launch. No float atomics: a run repeats its
// bits. The decomposition re-reads: dy and y (the window, halo included)
// once per 32 input channels for the dx and once per pass for the dW
// (2 - 1/n times in all, n = Cout / 32 passes), x once per pass, the
// weights per dx tile. At the headline's 128 -> 128: dy and y read 7
// times (4 input tiles x (2 - 1/4)), x 4 times.
// * bf16: mma.sync m16n8k16, 288 threads, two blocks an SM. Warps 0-7
//   hold the dx of two output rows each for the 32 channels (the conv
//   bodies' tap loop); warp w holds tap w of the dW, A = t^T by
//   ldmatrix.trans from the t window (80-byte rows), B = e from the e
//   window (48-byte rows).
// * f32: FMA, 256 threads, 8 x 16 tiles (#36's). dx: warp w holds input
//   channels 4w..4w+3, lane 4 pixels of one row, in the order co, ky, kx
//   with #35's blocked sum (conv3x3_bn.cuh::kDxBlock); dW: lane = input
//   channel, warp w output channels 4w..4w+3.

#include "conv3x3_bn.cuh"

namespace cltorch {
namespace {

// The operands as the conv bodies' dx view takes them: in = dy, y, s1, s2,
// w = the flipped weight (bf16 [3, 3, Cin, Cout], f32 [Cout, 3, 3, Cin]),
// pa, pb, x, out = dx (null: no dx, da or db), partials = the per-tile rows
// of da and db, Cin = the forward's Cout, Cout = the forward's Cin.
template <typename T>
ConvArgs<T> dx_view(const void* dy, const void* y, const void* s1, const void* s2,
                    const void* wdx, const void* a, const void* b, const void* x, void* dx,
                    void* part_ab, int B, int H, int W, int Cin, int Cout, int prologue) {
  ConvArgs<T> p{};
  p.in = static_cast<const T*>(dy);
  p.y = static_cast<const T*>(y);
  p.s1 = static_cast<const float*>(s1);
  p.s2 = static_cast<const float*>(s2);
  p.w = static_cast<const T*>(wdx);
  p.pa = static_cast<const float*>(a);
  p.pb = static_cast<const float*>(b);
  p.x = static_cast<const T*>(x);
  p.out = static_cast<T*>(dx);
  p.partials = static_cast<float*>(part_ab);
  p.H = H;
  p.W = W;
  p.Cin = Cout;
  p.Cout = Cin;
  p.prologue = prologue;
  p.batch = B;
  return p;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kFbThreads = 9 * 32;  // warps 0-7: the dx rows; warp w: the dW's tap w
constexpr int kFbC = 32;            // the forward's input channels of a block
constexpr int kTRow = 40;           // bf16 per staged t pixel: 32 channels + 8

constexpr size_t kFusedSmemMma =
    ((size_t)kWinH * kWinW * (kTRow + kRowS) + 9 * kFbC * kRowS) * sizeof(bf16) +
    (kMmaThreads / 32) * 2 * kFbC * sizeof(float);

// Two blocks an SM (96 registers a thread, a few spilled): over the
// headline step's 15 convs 11.6 ms against 14.4 with one block of 155
// registers (NVIDIA H100 80GB HBM3, 700.00 W).
__global__ void __launch_bounds__(kFbThreads, 2)
    conv3x3_bn_bwd_fused_mma_kernel(ConvArgs<bf16> p, float* __restrict__ part_dw) {
  constexpr int COG = kFbC, NCH = COG / 16;  // output channels (e chunks) of a dW pass
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* t_s = reinterpret_cast<bf16*>(smem);  // t window [pixel][kTRow]
  bf16* e_s = t_s + kWinH * kWinW * kTRow;     // e window, one chunk [pixel][kRowS]
  bf16* w_s = e_s + kWinH * kWinW * kRowS;     // dx weights, one chunk [tap][ci][kRowS]
  float(*red)[2][kFbC] = reinterpret_cast<float(*)[2][kFbC]>(w_s + 9 * kFbC * kRowS);
  const int H = p.H, W = p.W, Ci = p.Cout, Co = p.Cin;  // the forward's channels
  const int ci0 = blockIdx.x * kFbC, pass = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lj = lane & 7, lq = lane >> 3;  // ldmatrix rows: pixel, quarter
  const int ky = warp / 3, kx = warp % 3;   // this warp's dW tap
  const int tiles_x = (W + kTW - 1) / kTW, tiles = tiles_x * ((H + kTH - 1) / kTH);
  const int n_tiles = p.batch * tiles, n_pass = gridDim.y;

  float accw[2][COG / 8][4], accx[2][kFbC / 8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < COG / 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) accw[m][n][j] = 0.f;

  for (int tile = blockIdx.z, k = 0; tile < n_tiles; tile += gridDim.z, ++k) {
    const int b = tile / tiles, rem = tile % tiles;
    const int gy0 = (rem / tiles_x) * kTH, gx0 = (rem % tiles_x) * kTW;
    const int64_t img = (int64_t)b * H * W;
    // the passes share out the dx of their common tiles: every n_pass-th
    const bool dx_tile = p.out != nullptr && k % n_pass == pass;
    const int g_lo = dx_tile ? 0 : pass, g_hi = dx_tile ? n_pass : pass + 1;
    __syncthreads();
    with_ew(p.ew_bf16, [&](auto ew) {
      for (int e = threadIdx.x; e < kWinH * kWinW * 4; e += kFbThreads) {
        const int pix = e >> 2, q = e & 3;
        const int gy = gy0 - 1 + pix / kWinW, gx = gx0 - 1 + pix % kWinW;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
        const int c = ci0 + q * 8;
        const int64_t i = (img + (int64_t)gy * W + gx) * Ci + c;
        stage8_t<decltype(ew)::value>(&t_s[pix * kTRow + q * 8], p.x + i, c, Ci, inside,
                                      p.prologue, p.pa, p.pb);
      }
    });
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < kFbC / 8; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) accx[m][n][j] = 0.f;
    for (int grp = g_lo; grp < g_hi; ++grp) {
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        const int c0 = grp * COG + ch * 16;
        if (c0 >= Co) break;
        __syncthreads();  // the previous chunk's products are done
        with_ew(p.ew_bf16, [&](auto ew) {
          for (int e = threadIdx.x; e < kWinH * kWinW * 2; e += kFbThreads) {
            const int pix = e >> 1, half = e & 1;
            const int gy = gy0 - 1 + pix / kWinW, gx = gx0 - 1 + pix % kWinW;
            const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
            const int c = c0 + half * 8;
            const int64_t i = (img + (int64_t)gy * W + gx) * Co + c;
            stage8_e<decltype(ew)::value>(&e_s[pix * kRowS + half * 8], p.in + i,
                                          p.s1 ? p.y + i : nullptr, c, Co, inside, p.s1, p.s2);
          }
        });
        if (dx_tile) {
          for (int e = threadIdx.x; e < 9 * kFbC * 2; e += kFbThreads) {
            const int half = e & 1, row = e >> 1;  // row = tap * kFbC + ci
            const int ci = row % kFbC, tap = row / kFbC;
            const int c = c0 + half * 8;
            stage8_t(&w_s[row * kRowS + half * 8], p.w + ((int64_t)tap * Ci + ci0 + ci) * Co + c,
                     c, Co, ci0 + ci < Ci, 0, nullptr, nullptr);
          }
        }
        __syncthreads();
        if (dx_tile && warp < kMmaThreads / 32) mma_chunk<kFbC>(accx, e_s, w_s, warp, g, t);
        if (grp == pass) {
          // D[ci][co] of this warp's tap over the tile's rows: A[ci][k] = t
          // at window (r + ky, k + kx), B[k][co] = e at (r, k) (#36's)
          for (int r = 0; r < kTH; ++r) {
            uint32_t a[2][4], eb[4];
            const int t_pix = (r + ky) * kWinW + kx + (lq >> 1) * 8 + lj;
#pragma unroll
            for (int m = 0; m < 2; ++m)
              ldmatrix_x4_trans(a[m], &t_s[t_pix * kTRow + m * 16 + (lq & 1) * 8]);
            const int e_pix = (r + 1) * kWinW + 1 + (lq & 1) * 8 + lj;
            ldmatrix_x4_trans(eb, &e_s[e_pix * kRowS + (lq >> 1) * 8]);
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
              for (int m = 0; m < 2; ++m)
                mma_bf16(accw[m][ch * 2 + n], a[m], eb[n * 2], eb[n * 2 + 1]);
          }
        }
      }
    }
    if (dx_tile)
      mma_epilogue<kDx, kFbC>(p, accx, b, gy0, gx0, ci0, b * tiles + rem, red, warp, g, t);
  }

  // accw[m][n] = {D[m*16+g][n*8+2t], D[..][+1], D[m*16+g+8][n*8+2t], D[..][+1]}
  // into this split's partial dW, laid out as the weight [Co, Ci, 3, 3]
  float* part = part_dw + (int64_t)blockIdx.z * Co * Ci * 9;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < COG / 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ci = ci0 + m * 16 + g + (j >> 1) * 8;
        const int co = pass * COG + n * 8 + 2 * t + (j & 1);
        if (ci < Ci && co < Co) part[((int64_t)co * Ci + ci) * 9 + warp] = accw[m][n][j];
      }
}

// ---------------------------------------------------------------------------
// f32: FMA
// ---------------------------------------------------------------------------

constexpr int kFfThreads = 256;
constexpr int kFfTH = 8;  // pixel tile rows (x 16 columns)
constexpr int kFfWinH = kFfTH + 2;
constexpr int kFfC = 32;  // input channels of a block; e channels of a chunk and of a dW pass

constexpr size_t kFusedSmemFma =
    ((size_t)2 * kFfWinH * kWinW * kFfC + 9 * kFfC * kFfC) * sizeof(float);

__global__ void __launch_bounds__(kFfThreads)
    conv3x3_bn_bwd_fused_fma_kernel(ConvArgs<float> p, float* __restrict__ part_dw) {
  extern __shared__ __align__(16) unsigned char smem[];
  float(*t_s)[kFfC] = reinterpret_cast<float(*)[kFfC]>(smem);  // [pixel][ci]
  float(*e_s)[kFfWinH][kWinW] =                                 // [co][row][col]
      reinterpret_cast<float(*)[kFfWinH][kWinW]>(&t_s[kFfWinH * kWinW][0]);
  float(*w_s)[9][kFfC] = reinterpret_cast<float(*)[9][kFfC]>(&e_s[kFfC][0][0]);  // [co][tap][ci]
  const int H = p.H, W = p.W, Ci = p.Cout, Co = p.Cin;  // the forward's channels
  const int ci0 = blockIdx.x * kFfC, pass = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = lane >> 2, seg = lane & 3;  // dx: output row, 4-pixel segment
  const int cq = warp * 4;                   // dx: input channels; dW: output channels
  const int tiles_x = (W + kTW - 1) / kTW, tiles = tiles_x * ((H + kFfTH - 1) / kFfTH);
  const int n_tiles = p.batch * tiles, n_pass = gridDim.y;

  float accw[9][4], accx[4][4];
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) accw[k][j] = 0.f;

  for (int tile = blockIdx.z, k = 0; tile < n_tiles; tile += gridDim.z, ++k) {
    const int b = tile / tiles, rem = tile % tiles;
    const int gy0 = (rem / tiles_x) * kFfTH, gx0 = (rem % tiles_x) * kTW;
    const int64_t img = (int64_t)b * H * W;
    const bool dx_tile = p.out != nullptr && k % n_pass == pass;
    const int g_lo = dx_tile ? 0 : pass, g_hi = dx_tile ? n_pass : pass + 1;
    __syncthreads();
    for (int e = threadIdx.x; e < kFfWinH * kWinW * kFfC; e += kFfThreads) {
      const int c = e % kFfC, pix = e / kFfC;
      const int gy = gy0 - 1 + pix / kWinW, gx = gx0 - 1 + pix % kWinW;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && ci0 + c < Ci)
        v = t_at(p.x, (img + (int64_t)gy * W + gx) * Ci + ci0 + c, ci0 + c, p.prologue, p.pa,
                 p.pb);
      t_s[pix][c] = v;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < 4; ++c) accx[q][c] = 0.f;
    for (int grp = g_lo; grp < g_hi; ++grp) {
      const int c0 = grp * kFfC;
      __syncthreads();
      for (int e = threadIdx.x; e < kFfC * kFfWinH * kWinW; e += kFfThreads) {
        const int co = e % kFfC, pix = e / kFfC;
        const int wy = pix / kWinW, wx = pix % kWinW;
        const int gy = gy0 - 1 + wy, gx = gx0 - 1 + wx;
        float v = 0.f;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W && c0 + co < Co)
          v = e_at(p.in, p.y, (img + (int64_t)gy * W + gx) * Co + c0 + co, c0 + co, p.s1, p.s2);
        e_s[co][wy][wx] = v;
      }
      if (dx_tile) {
        for (int e = threadIdx.x; e < kFfC * 9 * kFfC; e += kFfThreads) {
          const int ci = e % kFfC, rest = e / kFfC;
          const int k = rest % 9, co = rest / 9;
          w_s[co][k][ci] = c0 + co < Co && ci0 + ci < Ci
                               ? p.w[((int64_t)(c0 + co) * 9 + k) * Ci + ci0 + ci]
                               : 0.f;
        }
      }
      __syncthreads();
      if (dx_tile) {
        // the blocked sum of the FMA body's dx (kDxBlock), so dx keeps #34/#35's bits
        for (int cb = 0; cb < kFfC; cb += kDxBlock) {
          float part[4][4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int c = 0; c < 4; ++c) part[q][c] = 0.f;
          for (int co = cb; co < cb + kDxBlock; ++co) {
#pragma unroll
            for (int ky = 0; ky < 3; ++ky) {
              float v[6];
#pragma unroll
              for (int j = 0; j < 6; ++j) v[j] = e_s[co][ty + ky][seg * 4 + j];
#pragma unroll
              for (int kx = 0; kx < 3; ++kx) {
                const float4 w4 = *reinterpret_cast<const float4*>(&w_s[co][ky * 3 + kx][cq]);
                const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
                for (int q = 0; q < 4; ++q)
#pragma unroll
                  for (int c = 0; c < 4; ++c) part[q][c] = fmaf(v[q + kx], wv[c], part[q][c]);
              }
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int c = 0; c < 4; ++c) accx[q][c] += part[q][c];
        }
      }
      if (grp == pass) {
        for (int r = 0; r < kFfTH; ++r) {
#pragma unroll 4
          for (int col = 0; col < kTW; ++col) {
            float e4[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) e4[j] = e_s[cq + j][r + 1][col + 1];
#pragma unroll
            for (int k = 0; k < 9; ++k) {
              const float tv = t_s[(r + k / 3) * kWinW + col + k % 3][lane];
#pragma unroll
              for (int j = 0; j < 4; ++j) accw[k][j] = fmaf(tv, e4[j], accw[k][j]);
            }
          }
        }
      }
    }
    if (dx_tile) {  // the epilogue, and this tile's partial rows of da, db
      float s1[4], s2[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) s1[c] = s2[c] = 0.f;
      const int gy = gy0 + ty;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int gx = gx0 + seg * 4 + q;
        if (gy < H && gx < W) {
          const int64_t pix = img + (int64_t)gy * W + gx;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int o = ci0 + cq + c;
            if (o < Ci) p.out[pix * Ci + o] = epilogue_one<kDx>(p, pix, o, accx[q][c], s1[c],
                                                                s2[c], 0);
          }
        }
      }
      if (p.prologue) {
        const int64_t blk = (int64_t)b * tiles + rem;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float t1 = warp_sum(s1[c]), t2 = warp_sum(s2[c]);
          const int o = ci0 + cq + c;
          if (lane == 0 && o < Ci) {
            p.partials[blk * 2 * Ci + o] = t1;
            p.partials[blk * 2 * Ci + Ci + o] = t2;
          }
        }
      }
    }
  }

  float* part = part_dw + (int64_t)blockIdx.z * Co * Ci * 9;
  if (ci0 + lane < Ci) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = pass * kFfC + cq + j;
      if (co < Co) {
#pragma unroll
        for (int k = 0; k < 9; ++k) part[((int64_t)co * Ci + ci0 + lane) * 9 + k] = accw[k][j];
      }
    }
  }
}

// Launches the kernel of the type, then the fixed-order sums: the per-tile
// rows of da and db (with dx and the prologue) and the splits' dW.
int fused_launch(ConvArgs<bf16> pb16, ConvArgs<float> pf32, void* out_ab, float* part_dw,
                 void* dw, int splits, int is_bf16, cudaStream_t st) {
  const int H = pf32.H, W = pf32.W, Ci = pf32.Cout, Co = pf32.Cin, B = pf32.batch;
  int rows;  // pixel tiles: the partial rows of da and db
  cudaError_t err;
  if (!is_bf16) {
    rows = B * ((H + kFfTH - 1) / kFfTH) * ((W + kTW - 1) / kTW);
    const dim3 grid((Ci + kFfC - 1) / kFfC, (Co + kFfC - 1) / kFfC, splits);
    err = cudaFuncSetAttribute(conv3x3_bn_bwd_fused_fma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFusedSmemFma);
    if (err != cudaSuccess) return (int)err;
    conv3x3_bn_bwd_fused_fma_kernel<<<grid, kFfThreads, kFusedSmemFma, st>>>(pf32, part_dw);
  } else {
    rows = B * ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
    const dim3 grid((Ci + kFbC - 1) / kFbC, (Co + kFbC - 1) / kFbC, splits);
    err = cudaFuncSetAttribute(conv3x3_bn_bwd_fused_mma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFusedSmemMma);
    if (err != cudaSuccess) return (int)err;
    conv3x3_bn_bwd_fused_mma_kernel<<<grid, kFbThreads, kFusedSmemMma, st>>>(pb16, part_dw);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (pf32.out != nullptr && pf32.prologue)
    reduce_rows_kernel<<<2 * Ci, kReduceThreads, 0, st>>>(pf32.partials, rows, 2 * Ci, 2 * Ci,
                                                          static_cast<float*>(out_ab));
  const int64_t n = (int64_t)Co * Ci * 9;
  sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part_dw, splits, n,
                                                                  static_cast<float*>(dw));
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cltorch

// Plain C interface, loaded with ctypes; returns cudaGetLastError(). The
// wrapper (cl_tpu_torch/kernels/conv3x3.py::launch_conv_bwd_fused) checks
// the operands: x [B, H, W, Cin], y and dy [B, H, W, Cout], contiguous,
// 16-byte aligned, of one type; a, b f32 [Cin] (read only with
// `prologue`); s1, s2 f32 [Cout] or null (e = dy); wdx the flipped,
// transposed weight in the dx kernel's layout (bf16 [3, 3, Cin, Cout], f32
// [Cout, 3, 3, Cin]), and dx [B, H, W, Cin], both null where no dx is
// wanted (the stem: dx, da and db are then not computed); part_ab one row
// [2, Cin] per pixel tile (16 x 16 bf16, 8 x 16 f32), out_ab [2, Cin]
// (da, db; written with dx and the prologue); part_dw splits * Cout * Cin
// * 9 floats, dw f32 [Cout, Cin, 3, 3], not rounded; `ew_bf16` (bf16):
// the bf16 chains.
extern "C" {

int cltorch_conv3x3_bn_bwd_fused(const void* x, const void* a, const void* b, const void* y,
                                 const void* dy, const void* s1, const void* s2, const void* wdx,
                                 void* dx, void* part_ab, void* out_ab, void* part_dw, void* dw,
                                 int B, int H, int W, int Cin, int Cout, int prologue,
                                 int splits, int is_bf16, int ew_bf16, void* stream) {
  using namespace cltorch;
  ConvArgs<bf16> pb16 =
      dx_view<bf16>(dy, y, s1, s2, wdx, a, b, x, dx, part_ab, B, H, W, Cin, Cout, prologue);
  pb16.ew_bf16 = ew_bf16;
  return fused_launch(
      pb16,
      dx_view<float>(dy, y, s1, s2, wdx, a, b, x, dx, part_ab, B, H, W, Cin, Cout, prologue),
      out_ab, static_cast<float*>(part_dw), dw, splits, is_bf16,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
