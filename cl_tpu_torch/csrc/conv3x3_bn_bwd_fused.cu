// The one-pass backward of the 3x3 SAME conv with the BN-ReLU prologue
// (#37, under CL_TPU_FUSE_BWD=1): dx, da, db and dW of one conv from one
// call of kernels/conv3x3.py::launch_conv_bwd_fused.
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
// bf16: no kernel of its own. The wrapper launches the ring dx
// (conv3x3_ring.cu, #34/#35's kernel; none for the stem) and #36's ring
// (conv3x3_bn_bwd.cu, dw_ring_body), counted as one #37 launch: dx, da, db
// bit-equal to #34/#35 and dW bit-equal to #36 (chip_smoke.compare_fused),
// the bf16 chains under CL_TPU_E_BF16 theirs. Why, on the card (NVIDIA
// H100 80GB HBM3, 700.00 W; kernel_ab, card sleep, in the same turns;
// PERF.md section 6): a one-pass ring kernel of its own (persistent, TMA
// ring of 16 x 16 tiles, e and t formed once in place, 8 mma.sync dx warps
// on resident weights beside 6 mma.sync dW warps on 32 x 64 channel tiles,
// setmaxnreg, no spills) ran the headline step's 15 convs in 7.0083 ms
// against 5.8497 for these two kernels. It won 3 of the 15 launches by
// 0.053 ms in all (512^2, 32 -> 32 with the prologue: 0.6288 against
// 0.6532; 256^2, 32 -> 64: 0.2388 against 0.2427) and lost the other 11
// by 1.21 ms (128^2, 128 -> 128: 0.5127 against 0.3103), so it went.
// What held it: registers. Its dW warps held 96 accumulators of a
// 32 x 64 x 3-tap tile on mma.sync where #36 multiplies 64 x 64 tiles on
// wgmma, and its 32 input channels a block formed e once per 32 dx
// channels where the ring dx takes 64. Where Cout > 64 (two dW passes) it
// shared each pass's tiles' dx out among the passes; giving every dx to
// the first pass instead ran those convs 25-28% slower (128 -> 128:
// 0.5127 -> 0.6543) and the one-pass convs 3-5% faster (no run-time
// modulo on the tile walk): 6.9966 -> 7.4919 a step. The ring dx takes
// the dx of a tile whole, over every chunk of e, in a launch of its own.

// f32: the FMA kernel below, one launch for dx and dW. dx and dW are
// bit-equal to #34/#35 and #36 (its dw_fma_body); da and db sum 8 x 16
// tiles where #35 sums 16 x 16 ones. 256 threads, 8 x 16 tiles (#36's);
// a block owns 32 of the forward's input channels (dx's outputs, the dW's
// rows), 32 of its output channels (one dW pass) and a split of the pixel
// tiles (every gridDim.z-th, kernels/conv3x3.py::dw_splits); the passes of
// one input tile and split share out their dx, the block of pass k taking
// the dx of every n-th tile over every output channel. dx: warp w holds
// input channels 4w..4w+3, lane 4 pixels of one row, in the order co, ky,
// kx with #35's blocked sum (conv3x3_bn.cuh::kDxBlock); dW: lane = input
// channel, warp w output channels 4w..4w+3. Partial dW go out per split
// and partial da/db rows per tile, each summed in a fixed order by a
// second launch. No float atomics: a run repeats its bits.

#include "conv3x3_dw_body.cuh"  // sum_dw_splits

namespace cltorch {
namespace {

// The operands as the conv bodies' dx view takes them: in = dy, y, s1, s2,
// w = the flipped weight [Cout, 3, 3, Cin], pa, pb, x, out = dx (null: no
// dx, da or db), partials = the per-tile rows of da and db, Cin = the
// forward's Cout, Cout = the forward's Cin.
ConvArgs<float> dx_view(const void* dy, const void* y, const void* s1, const void* s2,
                        const void* wdx, const void* a, const void* b, const void* x, void* dx,
                        void* part_ab, int B, int H, int W, int Cin, int Cout, int prologue) {
  ConvArgs<float> p{};
  p.in = static_cast<const float*>(dy);
  p.y = static_cast<const float*>(y);
  p.s1 = static_cast<const float*>(s1);
  p.s2 = static_cast<const float*>(s2);
  p.w = static_cast<const float*>(wdx);
  p.pa = static_cast<const float*>(a);
  p.pb = static_cast<const float*>(b);
  p.x = static_cast<const float*>(x);
  p.out = static_cast<float*>(dx);
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


// The f32 kernel's launch, then the fixed-order sums: the per-tile rows of
// da and db (with dx and the prologue) and the splits' dW.
int fma_launch(const ConvArgs<float>& p, void* out_ab, float* part_dw, void* dw, int splits,
               cudaStream_t st) {
  const int H = p.H, W = p.W, Ci = p.Cout, Co = p.Cin, B = p.batch;
  const int rows = B * ((H + kFfTH - 1) / kFfTH) * ((W + kTW - 1) / kTW);  // da, db rows
  const dim3 grid((Ci + kFfC - 1) / kFfC, (Co + kFfC - 1) / kFfC, splits);
  cudaError_t err = cudaFuncSetAttribute(conv3x3_bn_bwd_fused_fma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kFusedSmemFma);
  if (err != cudaSuccess) return (int)err;
  conv3x3_bn_bwd_fused_fma_kernel<<<grid, kFfThreads, kFusedSmemFma, st>>>(p, part_dw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (p.out != nullptr && p.prologue)
    reduce_rows_kernel<<<2 * Ci, kReduceThreads, 0, st>>>(p.partials, rows, 2 * Ci, 2 * Ci,
                                                          static_cast<float*>(out_ab));
  return sum_dw_splits(part_dw, dw, splits, Ci, Co, st);
}

}  // namespace
}  // namespace cltorch

// Plain C interface, loaded with ctypes; returns cudaGetLastError(). The
// wrapper (cl_tpu_torch/kernels/conv3x3.py::launch_conv_bwd_fused) checks
// the operands, all f32: x [B, H, W, Cin], y and dy [B, H, W, Cout],
// contiguous, 16-byte aligned; a, b [Cin] (read only with `prologue`); s1,
// s2 [Cout] or null (e = dy); wdx the flipped, transposed weight in the dx
// kernel's layout ([Cout, 3, 3, Cin]), and dx [B, H, W, Cin], both null
// where no dx is wanted (the stem: dx, da and db are then not computed);
// part_ab one row [2, Cin] per 8 x 16 pixel tile, out_ab [2, Cin] (da, db;
// written with dx and the prologue); part_dw splits * Cout * Cin * 9
// floats, dw [Cout, Cin, 3, 3], not rounded.
extern "C" {

int cltorch_conv3x3_bn_bwd_fused(const void* x, const void* a, const void* b, const void* y,
                                 const void* dy, const void* s1, const void* s2, const void* wdx,
                                 void* dx, void* part_ab, void* out_ab, void* part_dw, void* dw,
                                 int B, int H, int W, int Cin, int Cout, int prologue,
                                 int splits, void* stream) {
  using namespace cltorch;
  return fma_launch(
      dx_view(dy, y, s1, s2, wdx, a, b, x, dx, part_ab, B, H, W, Cin, Cout, prologue),
      out_ab, static_cast<float*>(part_dw), dw, splits, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
