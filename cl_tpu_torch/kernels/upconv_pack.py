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
the plain versions. ``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from cl_tpu_torch.kernels import SPLIT_BLOCKS, build

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


def launch_upconv2x2(x, weight, bias):
    _check_x(x, "upconv kernel")
    B, H, W, cin = x.shape
    cout = weight.shape[1]
    if weight.shape != (cin, cout, 2, 2) or bias.shape != (cout,):
        raise ValueError(f"upconv kernel: weight [Cin, Cout, 2, 2] and bias [Cout] "
                         f"expected, got {tuple(weight.shape)} {tuple(bias.shape)}")
    kg = gemm_weight(weight, x.dtype)
    if x.dtype == torch.bfloat16:  # the tensor-core kernel reads Kgᵀ
        kg = kg.T.contiguous()
    b = bias.to(device=x.device, dtype=torch.float32).contiguous()
    y = torch.empty(B, 2 * H, 2 * W, cout, dtype=x.dtype, device=x.device)
    err = build.library().cltorch_upconv_fwd(
        x.data_ptr(), kg.data_ptr(), b.data_ptr(), y.data_ptr(), B, H, W, cin, cout,
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream)
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
    kg = gemm_weight(weight, dy.dtype)
    dx = torch.empty(x_shape, dtype=dy.dtype, device=dy.device)
    err = build.library().cltorch_upconv_dx(
        dy.data_ptr(), kg.data_ptr(), dx.data_ptr(), B, H2 // 2, W2 // 2, cin, cout,
        int(dy.dtype == torch.bfloat16), torch.cuda.current_stream(dy.device).cuda_stream)
    build.check(err, "upconv_dx")
    return dx


def dw_splits(cin, cout, pixels, bf16):
    """Blocks the dW kernel splits the pixels over: ~SPLIT_BLOCKS in all,
    at least one pixel slice each. A function of the shapes alone,
    so the partial sums run in the same order on every call."""
    bm, bn, bk = (128, 64, 32) if bf16 else (64, 64, 16)
    tiles = -(-cin // bm) * -(-(4 * cout) // bn)
    return max(1, min(-(-SPLIT_BLOCKS // tiles), -(-pixels // bk)))


def launch_upconv2x2_dw(x, dy):
    _check_x(x, "upconv dW kernel")
    B, H, W, cin = x.shape
    cout = dy.shape[-1]
    _check_dy(dy, x.shape, cout, x.dtype)
    bf16 = x.dtype == torch.bfloat16
    splits = dw_splits(cin, cout, B * H * W, bf16)
    f32 = dict(dtype=torch.float32, device=x.device)
    part_w = torch.empty(splits, cin, 4 * cout, **f32)
    part_b = torch.empty(splits, 4 * cout, **f32)
    dkg = torch.empty(cin, 4 * cout, **f32)
    db = torch.empty(cout, **f32)
    err = build.library().cltorch_upconv_dw(
        x.data_ptr(), dy.data_ptr(), part_w.data_ptr(), part_b.data_ptr(), dkg.data_ptr(),
        db.data_ptr(), B, H, W, cin, cout, splits, int(bf16),
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
