// Fused BN·ReLU + 1x1 head + masked softmax cross-entropy on the packed
// body's RAW last-level output, forward and backward, alone and with the
// LwF distillation term of a frozen teacher in the same pass: the kernel
// templates (KD = false in head_ce_bn.cu, true in head_ce_kd_bn.cu, two
// translation units so that nvcc builds them in parallel). With BN = false
// the prologue is compiled out and the kernels take NHWC features x as
// they are: the KD head on plain features (head_ce_kd.cu).
//
// Replaces the TPU kernels cl_tpu/pallas/head_ce.py::_pkbn_fwd_kernel
// (launched at head_ce.py:571), ::_pkbn_bwd_kernel (:601),
// ::_pkbn_kd_fwd_kernel (:997) and ::_pkbn_kd_bwd_kernel (:1036), and with
// BN = false ::_kd_fwd_kernel (:784) and ::_kd_bwd_kernel (:815). The TPU
// kernels read a lane-packed [n, p*Cin] view and transpose it per tile to
// class-major; here y is NHWC [P, Cin] as it lies (the packed view is a
// reshape of the same memory), one pixel per thread, so per-lane vectors
// are per-channel ones and the per-lane sums come out folded to channels.
//
//   prologue:  t = y*s + sh in f32 (product and sum each rounded, as the
//              plain version and bn_relu do: no FMA), z = round(max(t, 0))
//              to y's type before the logit product (head_ce.py:491-493);
//              without BN, z = y
//   logits:    zW^T + b, W rounded to y's type, f32 sums, invalid -> -1e9
//   forward:   sum_p pix (logsumexp - picked)
//   backward:  g = gce*pix*(softmax - onehot), masked by valid; with KD
//              g += gkd*[old]*T*(p_new - p_old)*pix before any rounding
//              (:942-944); gc = round(g); dz = round(gc W) (:539-541);
//              du = [t > 0] dz with t the f32 pre-activation; dx =
//              round(du*s); dscale = sum du*y, dshift = sum du; dW = sum
//              gc (x) z; db = sum g (f32, unrounded); without BN, dx = dz
//              (_kd_bwd_kernel, :733-748)
//   KD:        the teacher's zt = round(max(yt*ts + tsh, 0)) Wt^T + bt is
//              NOT masked by valid; both logit sets are masked to old_valid
//              with -1e9 and divided by T; kd = T^2 sum_p pix sum_c p_old
//              (log p_old - log p_new) (_kd_sum_tile, :665-679)
//
// What bounds them on the H100: bytes. At the headline shape (2 M pixels
// x 32 bf16 channels, 19 classes) the forward reads y once (128 MiB,
// ~41 us at 3.35 TB/s); the backward reads y and writes dx (~83 us); the
// KD forms read the teacher's y as well. The logit products are 2*C*Cin
// = 1216 flops a pixel and logit pass, far below the byte bound on the
// tensor cores; here they run on f32 FMAs, one pixel a thread. The bf16
// backward without KD (#8) no longer runs here: head_ce_bn_mma.cuh moves
// its three products to mma.sync (what held this body at 18x its bound,
// and what that one does about each, is written there); the f32 #8, #7,
// the KD forms and #5/#6 stay on this template until they move onto it.
//
// Design: head_ce.cu's (a fixed grid of blocks of 128 threads walking
// tiles of 128 pixels, each tile staged by coalesced 16-byte loads into
// rows of odd 16-byte stride; one pixel's logits per thread in registers;
// per-block partials summed by a second launch in a fixed order: no float
// atomics, so a run repeats its bits). The BN·ReLU prologue runs in the
// staging loop, which writes z (and for the backward the raw y, needed for
// the f32 pre-activation test and dscale) to shared memory. The backward
// writes each pixel's du row to a shared f32 tile; after the block barrier
// one pass sums dW/db (register-tiled, as head_ce.cu) and another the
// per-channel du*y and du (each thread one channel over a stripe of rows).
// The partial row of a block holds C*(Cin+1) + 2*Cin floats: dW and db,
// then dscale and dshift (C*(Cin+1) without BN).
//
// Why the KD head on NHWC features (#9/#10) is this template with the
// prologue compiled out, and not head_ce.cu plus a teacher tile: the
// teacher's tile, its head, old_valid and the KD terms of one pixel
// (kd_pixel) exist here already and are held against #11/#12's plain
// versions; without the prologue, staging is a copy and dx = round(gc W),
// which is head_ce.cu's backward line for line.

#pragma once

#include "head_ce.cuh"

namespace cltorch {
namespace {

struct BnLayout {
  int row_bytes;    // Cin * sizeof(T)
  int chunks;       // 16-byte chunks per row
  int xs_stride;    // tile row stride in bytes (odd chunk count)
  int us_stride;    // du row stride in floats (odd)
  int gs_stride;    // g row stride in floats (odd)
  size_t xs_off, zt_off, ys_off, ds_off, us_off, gs_off, w_off, wt_off, vec_off, red_off, bytes;
};

// Shared memory: the student's z tile; with KD the teacher's z tile; for
// the backward the raw y tile (BN), the dx tile, du (BN) and g of the tile;
// then W (and Wt), the vectors b, valid, bt, old_valid [C] and s, sh, ts,
// tsh [Cin], and the block-sum scratch.
__host__ __device__ inline BnLayout bn_layout(int Cin, int C, int elem, bool kd, bool bwd,
                                              bool bn = true) {
  BnLayout L;
  L.row_bytes = Cin * elem;
  L.chunks = L.row_bytes / 16;
  const int sc = (L.chunks % 2 == 0) ? L.chunks + 1 : L.chunks;
  L.xs_stride = sc * 16;
  L.us_stride = (Cin % 2 == 0) ? Cin + 1 : Cin;
  L.gs_stride = (C % 2 == 0) ? C + 1 : C;
  const size_t tile = (size_t)kTile * L.xs_stride;
  L.xs_off = 0;
  L.zt_off = L.xs_off + tile;
  L.ys_off = L.zt_off + (kd ? tile : 0);
  L.ds_off = L.ys_off + (bwd && bn ? tile : 0);
  L.us_off = L.ds_off + (bwd ? tile : 0);
  L.gs_off = L.us_off + (bwd && bn ? (size_t)kTile * L.us_stride * 4 : 0);
  L.w_off = L.gs_off + (bwd ? (size_t)kTile * L.gs_stride * 4 : 0);
  L.wt_off = L.w_off + (size_t)C * Cin * 4;
  L.vec_off = L.wt_off + (kd ? (size_t)C * Cin * 4 : 0);
  L.red_off = L.vec_off + (size_t)(4 * C + 4 * Cin) * 4;
  L.bytes = L.red_off + 2 * kTile * 4;
  return L;
}

struct BnArgs {  // the operands, as the C interface receives them
  const void *y, *s, *sh, *w, *b, *yt, *ts, *tsh, *tw, *tb, *lbl, *valid, *ovalid;
};

// Stage one tile of raw y with the BN·ReLU prologue (without BN, z = y):
// z rows into zs, and the raw rows into ys unless it is null. Rows past
// `rows` are zero y.
template <typename T, bool BN = true>
__device__ __forceinline__ void stage_bn(const T* __restrict__ y, int64_t base, int rows,
                                         const BnLayout& L, const float* ss, const float* shs,
                                         unsigned char* zs, unsigned char* ys) {
  constexpr int kVec = 16 / sizeof(T);
  const unsigned char* src = reinterpret_cast<const unsigned char*>(y) + base * L.row_bytes;
  for (int i = threadIdx.x; i < kTile * L.chunks; i += blockDim.x) {
    const int r = i / L.chunks, c16 = i - r * L.chunks;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < rows) v = *reinterpret_cast<const uint4*>(src + (int64_t)r * L.row_bytes + c16 * 16);
    if (ys != nullptr) *reinterpret_cast<uint4*>(ys + r * L.xs_stride + c16 * 16) = v;
    if (!BN) {
      *reinterpret_cast<uint4*>(zs + r * L.xs_stride + c16 * 16) = v;
      continue;
    }
    uint4 zv;
    const T* yv = reinterpret_cast<const T*>(&v);
    T* zo = reinterpret_cast<T*>(&zv);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int k = c16 * kVec + j;
      const float t = __fadd_rn(__fmul_rn(to_f32(yv[j]), ss[k]), shs[k]);
      zo[j] = from_f32<T>(fmaxf(t, 0.f));
    }
    *reinterpret_cast<uint4*>(zs + r * L.xs_stride + c16 * 16) = zv;
  }
}

__device__ __forceinline__ void load_vec2(const float* __restrict__ a, const float* __restrict__ b,
                                          int n, float* as, float* bs) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    as[i] = a[i];
    bs[i] = b[i];
  }
}

// The KD term of one pixel from the student's logits z (already masked by
// valid) and the teacher's zt, both masked here to the old classes and
// divided by T. Without GRAD: sum_c p_old (log p_old - log p_new). With
// GRAD: zt[c] becomes T (p_new - p_old) on the old classes, 0 elsewhere
// (_kd_grad_tile before its pix factor), and 0 is returned.
template <int CMAX, bool GRAD>
__device__ __forceinline__ float kd_pixel(const float (&z)[CMAX], float (&zt)[CMAX],
                                          const float* ovs, int C, float temp) {
  float mo = -3.0e38f, mn = -3.0e38f;
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    if (c < C) {
      const bool o = ovs[c] > 0.f;
      mo = fmaxf(mo, (o ? zt[c] : kNegInf) / temp);
      mn = fmaxf(mn, (o ? z[c] : kNegInf) / temp);
    }
  }
  float so = 0.f, sn = 0.f;
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    if (c < C) {
      const bool o = ovs[c] > 0.f;
      so += expf((o ? zt[c] : kNegInf) / temp - mo);
      sn += expf((o ? z[c] : kNegInf) / temp - mn);
    }
  }
  if (GRAD) {
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      if (c < C) {
        const bool o = ovs[c] > 0.f;
        const float pn = expf((o ? z[c] : kNegInf) / temp - mn) / sn;
        const float po = expf((o ? zt[c] : kNegInf) / temp - mo) / so;
        zt[c] = o ? temp * (pn - po) : 0.f;
      }
    }
    return 0.f;
  }
  const float lso = logf(so), lsn = logf(sn);
  float kl = 0.f;
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    if (c < C) {
      const bool o = ovs[c] > 0.f;
      const float a = (o ? zt[c] : kNegInf) / temp - mo;
      const float lpn = (o ? z[c] : kNegInf) / temp - mn - lsn;
      kl += expf(a) / so * ((a - lso) - lpn);
    }
  }
  return kl;
}

template <typename T, int CMAX, bool KD, bool BN>
__global__ void __launch_bounds__(kTile)
head_ce_bn_fwd_kernel(BnArgs a, float temp, float* __restrict__ partials, int P, int Cin, int C,
                      int ignore_index) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BnLayout L = bn_layout(Cin, C, sizeof(T), KD, false, BN);
  unsigned char* xs = smem + L.xs_off;
  unsigned char* zts = smem + L.zt_off;
  float* ws = reinterpret_cast<float*>(smem + L.w_off);
  float* wts = reinterpret_cast<float*>(smem + L.wt_off);
  float* bs = reinterpret_cast<float*>(smem + L.vec_off);
  float *vs = bs + C, *bts = bs + 2 * C, *ovs = bs + 3 * C;
  float *ss = bs + 4 * C, *shs = ss + Cin, *tss = ss + 2 * Cin, *tshs = ss + 3 * Cin;
  float* red = reinterpret_cast<float*>(smem + L.red_off);
  const T* y = static_cast<const T*>(a.y);
  const T* yt = static_cast<const T*>(a.yt);
  const int* labels = static_cast<const int*>(a.lbl);
  load_head<T>(static_cast<const float*>(a.w), static_cast<const float*>(a.b),
               static_cast<const float*>(a.valid), Cin, C, ws, bs, vs);
  if (BN) load_vec2(static_cast<const float*>(a.s), static_cast<const float*>(a.sh), Cin, ss, shs);
  if (KD) {
    load_head<T>(static_cast<const float*>(a.tw), static_cast<const float*>(a.tb),
                 static_cast<const float*>(a.ovalid), Cin, C, wts, bts, ovs);
    if (BN)
      load_vec2(static_cast<const float*>(a.ts), static_cast<const float*>(a.tsh), Cin, tss, tshs);
  }

  const int ntiles = (P + kTile - 1) / kTile;
  float ce = 0.f, kd = 0.f;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t base = (int64_t)tile * kTile;
    const int rows = min(kTile, (int)(P - base));
    __syncthreads();  // previous tile's readers are done (and the head is loaded)
    stage_bn<T, BN>(y, base, rows, L, ss, shs, xs, nullptr);
    if (KD) stage_bn<T, BN>(yt, base, rows, L, tss, tshs, zts, nullptr);
    __syncthreads();
    const int r = threadIdx.x;
    if (r < rows) {
      float z[CMAX];
      const float m = row_logits<T, CMAX>(xs + r * L.xs_stride, ws, bs, vs, Cin, C, L.chunks, z);
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < CMAX; ++c)
        if (c < C) s += expf(z[c] - m);
      const float logz = m + logf(s);
      const int lbl = labels[base + r];
      const float pix = lbl != ignore_index ? 1.f : 0.f;
      const int lbl0 = lbl == ignore_index ? 0 : lbl;
      float picked = 0.f;
#pragma unroll
      for (int c = 0; c < CMAX; ++c)
        if (c < C && c == lbl0) picked = z[c];
      ce += (logz - picked) * pix;
      if (KD) {
        float zt[CMAX];
        row_logits<T, CMAX, false>(zts + r * L.xs_stride, wts, bts, nullptr, Cin, C, L.chunks,
                                   zt);
        kd += kd_pixel<CMAX, false>(z, zt, ovs, C, temp) * pix;
      }
    }
  }
  ce = block_sum(ce, red);
  if (KD) kd = block_sum(kd, red + kTile / 32);
  if (threadIdx.x == 0) {
    partials[(int64_t)blockIdx.x * (KD ? 2 : 1)] = ce;
    if (KD) partials[(int64_t)blockIdx.x * 2 + 1] = (temp * temp) * kd;
  }
}

template <typename T, int CMAX, bool KD, bool BN>
__global__ void __launch_bounds__(kTile)
head_ce_bn_bwd_kernel(BnArgs a, float temp, const float* __restrict__ cot, T* __restrict__ dx,
                      float* __restrict__ partials, int P, int Cin, int C, int ignore_index) {
  constexpr int kVec = 16 / sizeof(T);
  // dW is register-tiled as in head_ce.cu: thread t owns channels
  // [4*kg, 4*kg+4) of the classes cg, cg+CG, ... (kg = t % KG, cg = t / KG),
  // at most kRc of them, and db of those classes beside them.
  constexpr int kRc = (CMAX + 7) / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const BnLayout L = bn_layout(Cin, C, sizeof(T), KD, true, BN);
  unsigned char* xs = smem + L.xs_off;
  unsigned char* zts = smem + L.zt_off;
  unsigned char* ys = smem + L.ys_off;
  unsigned char* ds = smem + L.ds_off;
  float* us = reinterpret_cast<float*>(smem + L.us_off);
  float* gs = reinterpret_cast<float*>(smem + L.gs_off);
  float* ws = reinterpret_cast<float*>(smem + L.w_off);
  float* wts = reinterpret_cast<float*>(smem + L.wt_off);
  float* bs = reinterpret_cast<float*>(smem + L.vec_off);
  float *vs = bs + C, *bts = bs + 2 * C, *ovs = bs + 3 * C;
  float *ss = bs + 4 * C, *shs = ss + Cin, *tss = ss + 2 * Cin, *tshs = ss + 3 * Cin;
  float* red = reinterpret_cast<float*>(smem + L.red_off);
  const T* y = static_cast<const T*>(a.y);
  const T* yt = static_cast<const T*>(a.yt);
  const int* labels = static_cast<const int*>(a.lbl);
  load_head<T>(static_cast<const float*>(a.w), static_cast<const float*>(a.b),
               static_cast<const float*>(a.valid), Cin, C, ws, bs, vs);
  if (BN) load_vec2(static_cast<const float*>(a.s), static_cast<const float*>(a.sh), Cin, ss, shs);
  if (KD) {
    load_head<T>(static_cast<const float*>(a.tw), static_cast<const float*>(a.tb),
                 static_cast<const float*>(a.ovalid), Cin, C, wts, bts, ovs);
    if (BN)
      load_vec2(static_cast<const float*>(a.ts), static_cast<const float*>(a.tsh), Cin, tss, tshs);
  }
  const float gce = cot[0];
  const float gkd = KD ? cot[1] : 0.f;
  const int KG = Cin / 4, CG = kTile / KG;
  const int kg = threadIdx.x % KG, cg = threadIdx.x / KG;
  int n_rc = 0;  // classes this thread owns (0 for the threads past KG*CG)
  if (cg < CG) n_rc = min(kRc, (C - cg + CG - 1) / CG);
  // dscale/dshift: thread t sums channel sk over the rows sg, sg + n_grp, ...
  const int n_grp = kTile / Cin;
  const int sk = threadIdx.x % Cin, sg = threadIdx.x / Cin;

  float acc[kRc][4], dbacc[kRc];
#pragma unroll
  for (int i = 0; i < kRc; ++i) {
    dbacc[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  float dsc = 0.f, dsh = 0.f;

  const int ntiles = (P + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t base = (int64_t)tile * kTile;
    const int rows = min(kTile, (int)(P - base));
    __syncthreads();
    stage_bn<T, BN>(y, base, rows, L, ss, shs, xs, BN ? ys : nullptr);
    if (KD) stage_bn<T, BN>(yt, base, rows, L, tss, tshs, zts, nullptr);
    __syncthreads();
    const int r = threadIdx.x;
    if (r < rows) {
      float g[CMAX];
      const float m = row_logits<T, CMAX>(xs + r * L.xs_stride, ws, bs, vs, Cin, C, L.chunks, g);
      const int lbl = labels[base + r];
      const float pix = lbl != ignore_index ? 1.f : 0.f;
      const int lbl0 = lbl == ignore_index ? 0 : lbl;
      float zt[CMAX];
      if (KD) {
        row_logits<T, CMAX, false>(zts + r * L.xs_stride, wts, bts, nullptr, Cin, C, L.chunks,
                                   zt);
        kd_pixel<CMAX, true>(g, zt, ovs, C, temp);
      }
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        if (c < C) {
          g[c] = expf(g[c] - m);
          s += g[c];
        }
      }
      const float sp = gce * pix;
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        if (c < C) {
          const float p = g[c] / s;
          float gv = sp * (p - (c == lbl0 ? 1.f : 0.f));
          gv = vs[c] > 0.f ? gv : 0.f;
          if (KD) gv = gv + gkd * (zt[c] * pix);
          g[c] = gv;
          gs[r * L.gs_stride + c] = gv;
        }
      }
      // dz = round(round(g) W); du = [t > 0] dz; dx = round(du s), into
      // the dx tile; du into its f32 tile (without BN, dx = dz)
#pragma unroll
      for (int c = 0; c < CMAX; ++c)
        if (c < C) g[c] = round_to<T>(g[c]);
      const unsigned char* yrow = ys + r * L.xs_stride;
      unsigned char* drow = ds + r * L.xs_stride;
      float* urow = us + r * L.us_stride;
      for (int q = 0; q < L.chunks; ++q) {
        uint4 yraw = make_uint4(0, 0, 0, 0);
        if (BN) yraw = *reinterpret_cast<const uint4*>(yrow + q * 16);
        const T* yv = reinterpret_cast<const T*>(&yraw);
        uint4 oraw;
        T* out = reinterpret_cast<T*>(&oraw);
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
          for (int j = 0; j < 4; ++j) {
            if (!BN) {
              out[4 * j4 + j] = from_f32<T>(d[j]);
              continue;
            }
            const int k = k0 + 4 * j4 + j;
            const float t = __fadd_rn(__fmul_rn(to_f32(yv[4 * j4 + j]), ss[k]), shs[k]);
            const float du = t > 0.f ? round_to<T>(d[j]) : 0.f;
            urow[k] = du;
            out[4 * j4 + j] = from_f32<T>(__fmul_rn(du, ss[k]));
          }
        }
        *reinterpret_cast<uint4*>(drow + q * 16) = oraw;
      }
    }
    __syncthreads();
    // dW[c][k] += sum_r round(g[r][c]) z[r][k]; db[c] += sum_r g[r][c]
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
    // dscale[k] += sum_r du[r][k] y[r][k]; dshift[k] += sum_r du[r][k]
    if (BN && sg < n_grp) {
      for (int rr = sg; rr < rows; rr += n_grp) {
        const float du = us[rr * L.us_stride + sk];
        const float yf = to_f32(reinterpret_cast<const T*>(ys + rr * L.xs_stride)[sk]);
        dsc = fmaf(du, yf, dsc);
        dsh += du;
      }
    }
    unsigned char* dst = reinterpret_cast<unsigned char*>(dx) + base * L.row_bytes;
    for (int i = threadIdx.x; i < rows * L.chunks; i += blockDim.x) {
      const int rr = i / L.chunks, c16 = i - rr * L.chunks;
      *reinterpret_cast<uint4*>(dst + (int64_t)rr * L.row_bytes + c16 * 16) =
          *reinterpret_cast<const uint4*>(ds + rr * L.xs_stride + c16 * 16);
    }
  }
  const int n_ent = C * (Cin + 1) + (BN ? 2 * Cin : 0);
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
  if (!BN) return;
  // the row stripes of dscale/dshift, combined in a fixed order
  if (sg < n_grp) {
    red[(sg * 2 + 0) * Cin + sk] = dsc;
    red[(sg * 2 + 1) * Cin + sk] = dsh;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 2 * Cin; j += blockDim.x) {
    const int which = j / Cin, k = j - which * Cin;
    float v = 0.f;
    for (int grp = 0; grp < n_grp; ++grp) v += red[(grp * 2 + which) * Cin + k];
    part[C * (Cin + 1) + j] = v;
  }
}

// The kernel instances for C classes: CMAX is the least of 8, 16, 24, 32
// that holds C (the per-class loops are unrolled to CMAX and predicated).
template <typename T, bool KD, bool BN>
decltype(&head_ce_bn_fwd_kernel<T, 8, KD, BN>) bn_fwd_kernel_for(int C) {
  return C <= 8 ? head_ce_bn_fwd_kernel<T, 8, KD, BN>
       : C <= 16 ? head_ce_bn_fwd_kernel<T, 16, KD, BN>
       : C <= 24 ? head_ce_bn_fwd_kernel<T, 24, KD, BN> : head_ce_bn_fwd_kernel<T, 32, KD, BN>;
}

template <typename T, bool KD, bool BN>
decltype(&head_ce_bn_bwd_kernel<T, 8, KD, BN>) bn_bwd_kernel_for(int C) {
  return C <= 8 ? head_ce_bn_bwd_kernel<T, 8, KD, BN>
       : C <= 16 ? head_ce_bn_bwd_kernel<T, 16, KD, BN>
       : C <= 24 ? head_ce_bn_bwd_kernel<T, 24, KD, BN> : head_ce_bn_bwd_kernel<T, 32, KD, BN>;
}

template <typename T, bool KD, bool BN = true>
int launch_bn_fwd(const BnArgs& a, float temp, void* partials, void* out_ce, void* out_kd, int P,
                  int Cin, int C, int ignore_index, int max_blocks, cudaStream_t st) {
  const BnLayout L = bn_layout(Cin, C, sizeof(T), KD, false, BN);
  const int nblk = head_blocks(P, max_blocks);
  auto kern = bn_fwd_kernel_for<T, KD, BN>(C);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  float* part = static_cast<float*>(partials);
  kern<<<nblk, kTile, L.bytes, st>>>(a, temp, part, P, Cin, C, ignore_index);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int stride = KD ? 2 : 1;
  reduce_rows_kernel<<<1, kReduceThreads, 0, st>>>(part, nblk, stride, 1,
                                                   static_cast<float*>(out_ce));
  if (KD)
    reduce_rows_kernel<<<1, kReduceThreads, 0, st>>>(part + 1, nblk, stride, 1,
                                                     static_cast<float*>(out_kd));
  return (int)cudaGetLastError();
}

template <typename T, bool KD, bool BN = true>
int launch_bn_bwd(const BnArgs& a, float temp, const void* cot, void* dx, void* partials,
                  void* out, int P, int Cin, int C, int ignore_index, int max_blocks,
                  cudaStream_t st) {
  const BnLayout L = bn_layout(Cin, C, sizeof(T), KD, true, BN);
  const int nblk = head_blocks(P, max_blocks);
  auto kern = bn_bwd_kernel_for<T, KD, BN>(C);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<nblk, kTile, L.bytes, st>>>(a, temp, static_cast<const float*>(cot), static_cast<T*>(dx),
                                     static_cast<float*>(partials), P, Cin, C, ignore_index);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_ent = C * (Cin + 1) + (BN ? 2 * Cin : 0);
  reduce_rows_kernel<<<n_ent, kReduceThreads, 0, st>>>(static_cast<const float*>(partials), nblk,
                                                       n_ent, n_ent, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cltorch
