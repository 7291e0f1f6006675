"""k=2/s=2 transposed conv of the packed body and its backward (``csrc/upconv.cu``).

Counterpart of ``cl_tpu.pallas.upconv_pack.upconv2x2_packed`` with the
weights ``PackedUp`` gives it (``cl_tpu/models/unet.py:583-587``): every
output pixel is one tap, out[2h+a, 2w+c] = x[h, w]·K[:, :, a, c] + bias,
the product summed in f32, the f32 bias added, then one rounding to x's
dtype. ``K`` is the port's ``ConvTranspose2d`` weight [Cin, Cout, 2, 2]
(f32; rounded to x's dtype, as the JAX package rounds its kernel), so the
function is ``F.conv_transpose2d(x, K, bias, stride=2)`` with that rounding.
This differs from the standard body's ``Conv``, which rounds the bias to
the compute dtype first.

The backward (``_vjp_bwd``): dx = DY·Kgᵀ rounded once to x's dtype, with
DY the output cotangent regrouped as [pixels, 4·Cout]; dW = Xᵀ·DY summed in
f32 and rounded once to x's dtype (the JAX package rounds each packed block
and sums the blocks in bf16, ``upconv_pack.py:219``: a few bf16 ulps
apart); db = Σ DY over pixels and phases in f32.

On a CUDA tensor the wrappers launch the kernels, on a CPU tensor they run
the plain versions. ``LAUNCHES`` counts the kernel launches. The bf16
forward and dx run persistent wgmma kernels whose column tile, ring and
grid the wrapper picks from the shapes alone (``fwd_tile``, ``fwd_blocks``;
``dx_tile``, ``dx_blocks``); each forms its bf16 weight from the module's
f32 weight itself, so the wrapper issues one launch a call.
"""

from __future__ import annotations

import functools

import torch

from cl_tpu_torch.kernels import SPLIT_BLOCKS, build, one_wave_splits, resident_blocks

LAUNCHES = {"upconv_fwd": 0, "upconv_dx": 0, "upconv_dw": 0}


def gemm_weight(weight, dtype):
    """[Cin, Cout, 2, 2] -> Kg [Cin, 4·Cout] in ``dtype``, column
    (a·2 + c)·Cout + o."""
    cin, cout = weight.shape[:2]
    return weight.to(dtype).permute(0, 2, 3, 1).reshape(cin, 4 * cout).contiguous()


def _dy_gemm(dy):
    """[B, 2H, 2W, Cout] -> DY [B·H·W, 4·Cout], column (a·2 + c)·Cout + o."""
    B, H2, W2, cout = dy.shape
    return dy.reshape(B, H2 // 2, 2, W2 // 2, 2, cout).permute(0, 1, 3, 2, 4, 5) \
        .reshape(-1, 4 * cout)


def _dw_from_gemm(dkg, cout):
    """dKg [Cin, 4·Cout] -> dW [Cin, Cout, 2, 2]."""
    return dkg.reshape(-1, 2, 2, cout).permute(0, 3, 1, 2)


def upconv2x2_plain(x, weight, bias):
    B, H, W, cin = x.shape
    cout = weight.shape[1]
    kg = gemm_weight(weight, x.dtype).float()
    t = x.reshape(-1, cin).float() @ kg + bias.float().repeat(4)
    t = t.reshape(B, H, W, 2, 2, cout).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(B, 2 * H, 2 * W, cout).to(x.dtype)


def upconv2x2_dx_plain(dy, weight):
    cin, cout = weight.shape[:2]
    B, H2, W2, _ = dy.shape
    dx = _dy_gemm(dy.float()) @ gemm_weight(weight, dy.dtype).float().T
    return dx.reshape(B, H2 // 2, W2 // 2, cin).to(dy.dtype)


def upconv2x2_dw_plain(x, dy):
    """(dW [Cin, Cout, 2, 2] rounded to x's dtype, as f32; db [Cout] f32)."""
    cout = dy.shape[-1]
    dyg = _dy_gemm(dy.float())
    dkg = x.reshape(-1, x.shape[-1]).float().T @ dyg
    db = dyg.sum(0).reshape(4, cout).sum(0)
    return _dw_from_gemm(dkg, cout).to(x.dtype).float(), db


def _check_x(x, what):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: f32 or bf16 only, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what} needs a contiguous 16-byte-aligned NHWC tensor")


# The bf16 forward's persistent wgmma kernel (csrc/upconv.cu::UpFwd,
# upconv_fwd_wg_kernel): tiles of FWD_BM pixels, k-chunks of FWD_BK input
# channels, FWD_THREADS threads, a ring of 2 to FWD_MAX_STAGES stages, at
# most FWD_SMEM_MAX bytes of dynamic shared memory a block, registers for
# FWD_MIN_BLOCKS blocks an SM (its __launch_bounds__).
FWD_BM = 128
FWD_BK = 64
FWD_THREADS = 256
FWD_MAX_STAGES = 6
FWD_SMEM_MAX = 232448
FWD_MIN_BLOCKS = 2


def fwd_smem(bn, cin, stages):
    """Dynamic shared bytes of a forward launch, as ``UpFwd::smem``: 1024 of
    alignment, the block's Kgᵀ [BN][64] a k-chunk, the x stages [128][64],
    the out tile [128][BN + 8] bf16, the bias [BN] f32, the output offsets
    of the tile's 128 rows and BN / 8 column pieces (int64), an mbarrier a
    stage."""
    kc = -(-cin // FWD_BK)
    return (1024 + kc * bn * FWD_BK * 2 + stages * FWD_BM * FWD_BK * 2
            + FWD_BM * (bn + 8) * 2 + bn * 4 + (FWD_BM + bn // 8) * 8 + stages * 8)


@functools.lru_cache(maxsize=None)
def fwd_tile(cin, cout):
    """(BN, stages): the bf16 forward's column tile of 4·Cout and its ring.
    Two resident blocks an SM first (eight warps each: one block's products
    and copies run while the other's epilogue stores), then one; at that
    count the widest column tile (128 above 64 columns, else 64) with at
    least two stages, and the most stages (at most FWD_MAX_STAGES) that
    keep it. Raises where nothing fits."""
    bns = ([128] if 4 * cout > 64 else []) + [64]
    for want in (2, 1):
        for bn in bns:
            fits = [st for st in range(2, FWD_MAX_STAGES + 1)
                    if fwd_smem(bn, cin, st) <= FWD_SMEM_MAX
                    and resident_blocks(fwd_smem(bn, cin, st), FWD_MIN_BLOCKS) >= want]
            if fits:
                return bn, fits[-1]
    raise ValueError(f"upconv forward kernel: no tile fits {cin} -> {cout} channels in "
                     "shared memory")


def fwd_resources(bn, cin, stages):
    """(threads, dynamic shared bytes, resident blocks an SM) of a forward
    launch."""
    smem = fwd_smem(bn, cin, stages)
    return FWD_THREADS, smem, resident_blocks(smem, FWD_MIN_BLOCKS)


@functools.lru_cache(maxsize=None)
def fwd_blocks(cin, cout, pixels):
    """Persistent blocks a column tile of the bf16 forward walks the
    FWD_BM-pixel tiles with: one wave of resident blocks over the column
    tiles, each the same number of tiles. A function of the shapes alone."""
    bn, stages = fwd_tile(cin, cout)
    return one_wave_splits(-(-pixels // FWD_BM), -(-(4 * cout) // bn),
                           fwd_resources(bn, cin, stages)[2])


# The bf16 dx's persistent wgmma kernel (csrc/upconv.cu::UpDx,
# upconv_dx_wg_kernel): the forward's pixel tiles, k-chunks (here 64
# columns of 4·Cout), threads, ring bounds and shared-memory limit;
# registers for DX_MIN_BLOCKS blocks an SM.
DX_MIN_BLOCKS = 2


def dx_smem(bn, cout, stages, streamed=False):
    """Dynamic shared bytes of a dx launch, as ``UpDx::smem``: 1024 of
    alignment (the mbarriers live in it), the block's Kg slice [BN][64] a
    k-chunk of 4·Cout (``streamed``: a chunk a stage, ``smem_streamed``),
    the DY stages [128][64], the dx tile [128][BN] bf16."""
    kc = stages if streamed else -(-(4 * cout) // FWD_BK)
    return 1024 + kc * bn * FWD_BK * 2 + stages * FWD_BM * FWD_BK * 2 + FWD_BM * bn * 2


def dx_streamed(bn, cout, stages):
    """Whether the dx's Kg slice is streamed, a chunk a stage (the C
    launcher's rule): where the whole slice does not fit."""
    return dx_smem(bn, cout, stages) > FWD_SMEM_MAX


@functools.lru_cache(maxsize=None)
def dx_tile(cin, cout):
    """(BN, stages): the bf16 dx's column tile of Cin and its ring. The
    whole Kg slice resident first, then streamed; within each, two
    resident blocks an SM first, then one; at that count the widest column
    tile (128 above 64 input channels, else 64) with at least two stages,
    and the most stages (at most FWD_MAX_STAGES) that keep it."""
    bns = ([128] if cin > 64 else []) + [64]
    for streamed in (False, True):
        for want in (2, 1):
            for bn in bns:
                fits = [st for st in range(2, FWD_MAX_STAGES + 1)
                        if dx_smem(bn, cout, st, streamed) <= FWD_SMEM_MAX
                        and resident_blocks(dx_smem(bn, cout, st, streamed),
                                            DX_MIN_BLOCKS) >= want]
                if fits:
                    return bn, fits[-1]
    raise AssertionError("a streamed tile always fits")


def dx_resources(bn, cout, stages):
    """(threads, dynamic shared bytes, resident blocks an SM) of a dx
    launch."""
    smem = dx_smem(bn, cout, stages, dx_streamed(bn, cout, stages))
    return FWD_THREADS, smem, resident_blocks(smem, DX_MIN_BLOCKS)


@functools.lru_cache(maxsize=None)
def dx_blocks(cin, cout, pixels):
    """Persistent blocks a column tile of the bf16 dx walks the FWD_BM-pixel
    tiles with: one wave of resident blocks over the column tiles, each the
    same number of tiles. A function of the shapes alone."""
    bn, stages = dx_tile(cin, cout)
    return one_wave_splits(-(-pixels // FWD_BM), -(-cin // bn),
                           dx_resources(bn, cout, stages)[2])


def _check_bf16(cin, cout, what):
    if cin % 8 or cout % 4:
        raise ValueError(f"upconv bf16 {what} kernel needs Cin % 8 == 0 and Cout % 4 == 0 "
                         f"(16-byte pieces of x and dy rows), got Cin={cin} Cout={cout}")


def launch_upconv2x2(x, weight, bias):
    _check_x(x, "upconv kernel")
    B, H, W, cin = x.shape
    cout = weight.shape[1]
    if weight.shape != (cin, cout, 2, 2) or bias.shape != (cout,):
        raise ValueError(f"upconv kernel: weight [Cin, Cout, 2, 2] and bias [Cout] "
                         f"expected, got {tuple(weight.shape)} {tuple(bias.shape)}")
    bf16 = x.dtype == torch.bfloat16
    if bf16:  # the wgmma kernel forms Kgᵀ from the f32 weight itself
        _check_bf16(cin, cout, "forward")
        kg = weight.to(device=x.device, dtype=torch.float32).contiguous()
        schedule = (*fwd_tile(cin, cout), fwd_blocks(cin, cout, B * H * W))
    else:
        kg, schedule = gemm_weight(weight, x.dtype), (0, 0, 0)
    b = bias.to(device=x.device, dtype=torch.float32).contiguous()
    y = torch.empty(B, 2 * H, 2 * W, cout, dtype=x.dtype, device=x.device)
    err = build.library().cltorch_upconv_fwd(
        x.data_ptr(), kg.data_ptr(), b.data_ptr(), y.data_ptr(), B, H, W, cin, cout,
        *schedule, int(bf16), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "upconv_fwd")
    return y


def _check_dy(dy, x_shape, cout, dtype):
    _check_x(dy, "upconv backward kernel")
    B, H, W, _ = x_shape
    if dy.shape != (B, 2 * H, 2 * W, cout) or dy.dtype != dtype:
        raise ValueError(f"upconv backward kernel: dy {(B, 2 * H, 2 * W, cout)} of {dtype} "
                         f"expected, got {tuple(dy.shape)} {dy.dtype}")


def launch_upconv2x2_dx(dy, weight):
    cin, cout = weight.shape[:2]
    B, H2, W2, _ = dy.shape
    x_shape = (B, H2 // 2, W2 // 2, cin)
    _check_dy(dy, x_shape, cout, dy.dtype)
    bf16 = dy.dtype == torch.bfloat16
    if bf16:  # the wgmma kernel forms its Kg slice from the f32 weight itself
        _check_bf16(cin, cout, "dx")
        kg = weight.to(device=dy.device, dtype=torch.float32).contiguous()
        schedule = (*dx_tile(cin, cout), dx_blocks(cin, cout, B * (H2 // 2) * (W2 // 2)))
    else:
        kg, schedule = gemm_weight(weight, dy.dtype), (0, 0, 0)
    dx = torch.empty(x_shape, dtype=dy.dtype, device=dy.device)
    err = build.library().cltorch_upconv_dx(
        dy.data_ptr(), kg.data_ptr(), dx.data_ptr(), B, H2 // 2, W2 // 2, cin, cout,
        *schedule, int(bf16), torch.cuda.current_stream(dy.device).cuda_stream)
    build.check(err, "upconv_dx")
    return dx


def dw_splits(cin, cout, pixels):
    """Blocks the f32 dW kernel splits the pixels over: ~SPLIT_BLOCKS in
    all, at least one 16-pixel slice each (64 x 64 tiles). A function of
    the shapes alone, so the partial sums run in the same order on every
    call."""
    tiles = -(-cin // 64) * -(-(4 * cout) // 64)
    return max(1, min(-(-SPLIT_BLOCKS // tiles), -(-pixels // 16)))


# The bf16 dW ring kernel (csrc/upconv.cu::UpRing): slices of RING_BK
# pixels, a ring of RING_STAGES stages.
RING_BK = 64
RING_STAGES = 3


def dw_ring_tile(cin, cout):
    """(BM, BN): the ring kernel's tile of Cin x 4·Cout, the instance the C
    entry point launches: 64 rows up to Cin = 64 (no zero rows at level 0),
    else 128; 128 columns up to 4·Cout = 128, else 256."""
    return (64 if cin <= 64 else 128), (128 if 4 * cout <= 128 else 256)


def dw_ring_resources(bm, bn):
    """(threads, dynamic shared bytes, resident blocks an SM) of a ring
    instance, as UpRing sizes it: warps of 32 rows x bn/4 columns; each
    stage RING_BK pixels of x and of the dy gather, rows padded by 8 bf16;
    the warp rows' db sums in f32; two blocks an SM for the 64 x 128 tile
    and one for the others by the registers (``__launch_bounds__``), fewer
    if the shared memory says so."""
    rows = bm // 32
    smem = RING_STAGES * RING_BK * (bm + 8 + bn + 8) * 2 + rows * bn * 4
    return rows * 128, smem, resident_blocks(smem, 2 if (bm, bn) == (64, 128) else 1)


def dw_ring_splits(cin, cout, pixels):
    """Blocks the bf16 dW ring kernel splits the pixel slices over: one wave
    of resident blocks (``dw_ring_resources``) over the tiles, each block
    the same number of slices. A function of the shapes alone, so the
    partial sums run in the same order on every call."""
    bm, bn = dw_ring_tile(cin, cout)
    tiles = -(-cin // bm) * -(-(4 * cout) // bn)
    return one_wave_splits(-(-pixels // RING_BK), tiles, dw_ring_resources(bm, bn)[2])


def dw_partials_shapes(cin, cout, pixels, bf16):
    """The f32 partials the dW wrapper allocates: dW [splits, Cin, 4·Cout]
    and the column sums [splits, 4·Cout], splits from the ring kernel's
    picker in bf16 and ``dw_splits`` in f32."""
    splits = dw_ring_splits(cin, cout, pixels) if bf16 else dw_splits(cin, cout, pixels)
    return (splits, cin, 4 * cout), (splits, 4 * cout)


def launch_upconv2x2_dw(x, dy):
    _check_x(x, "upconv dW kernel")
    B, H, W, cin = x.shape
    cout = dy.shape[-1]
    _check_dy(dy, x.shape, cout, x.dtype)
    bf16 = x.dtype == torch.bfloat16
    w_shape, b_shape = dw_partials_shapes(cin, cout, B * H * W, bf16)
    f32 = dict(dtype=torch.float32, device=x.device)
    part_w = torch.empty(w_shape, **f32)
    part_b = torch.empty(b_shape, **f32)
    dkg = torch.empty(cin, 4 * cout, **f32)
    db = torch.empty(cout, **f32)
    err = build.library().cltorch_upconv_dw(
        x.data_ptr(), dy.data_ptr(), part_w.data_ptr(), part_b.data_ptr(), dkg.data_ptr(),
        db.data_ptr(), B, H, W, cin, cout, w_shape[0], *dw_ring_tile(cin, cout), int(bf16),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "upconv_dw")
    return _dw_from_gemm(dkg, cout).to(x.dtype).float(), db


class _UpConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        if x.is_cuda:
            LAUNCHES["upconv_fwd"] += 1
            return launch_upconv2x2(x, weight, bias)
        return upconv2x2_plain(x, weight, bias)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            if x.is_cuda:
                LAUNCHES["upconv_dx"] += 1
                dx = launch_upconv2x2_dx(dy, weight)
            else:
                dx = upconv2x2_dx_plain(dy, weight)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            if x.is_cuda:
                LAUNCHES["upconv_dw"] += 1
                dw, db = launch_upconv2x2_dw(x, dy)
            else:
                dw, db = upconv2x2_dw_plain(x, dy)
        return dx, dw, db


def upconv2x2(x, weight, bias):
    """NHWC [B, H, W, Cin] -> [B, 2H, 2W, Cout] in x's dtype."""
    return _UpConv.apply(x, weight, bias)
