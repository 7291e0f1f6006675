"""k=2/s=2 transposed conv of the packed body, forward (``csrc/upconv.cu``).

Counterpart of ``cl_tpu.pallas.upconv_pack.upconv2x2_packed`` with the
weights ``PackedUp`` gives it (``cl_tpu/models/unet.py:583-587``): every
output pixel is one tap, out[2h+a, 2w+c] = x[h, w]·K[:, :, a, c] + bias,
the product summed in f32, the f32 bias added, then one rounding to x's
dtype. ``K`` is the port's ``ConvTranspose2d`` weight [Cin, Cout, 2, 2]
(f32; rounded to x's dtype, as the JAX package rounds its kernel), so the
function is ``F.conv_transpose2d(x, K, bias, stride=2)`` with that rounding.
This differs from the standard body's ``Conv``, which rounds the bias to
the compute dtype first.

On a CUDA tensor ``upconv2x2`` launches the kernel, on a CPU tensor it
runs ``upconv2x2_plain``; the backward is a later slice and raises.
``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from cl_tpu_torch.kernels import backward_later, build

LAUNCHES = {"upconv_fwd": 0}


def gemm_weight(weight, dtype):
    """[Cin, Cout, 2, 2] -> Kg [Cin, 4·Cout] in ``dtype``, column
    (a·2 + c)·Cout + o."""
    cin, cout = weight.shape[:2]
    return weight.to(dtype).permute(0, 2, 3, 1).reshape(cin, 4 * cout).contiguous()


def upconv2x2_plain(x, weight, bias):
    B, H, W, cin = x.shape
    cout = weight.shape[1]
    kg = gemm_weight(weight, x.dtype).float()
    t = x.reshape(-1, cin).float() @ kg + bias.float().repeat(4)
    t = t.reshape(B, H, W, 2, 2, cout).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(B, 2 * H, 2 * W, cout).to(x.dtype)


def launch_upconv2x2(x, weight, bias):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"upconv kernel: f32 or bf16 only, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("upconv kernel needs a contiguous NHWC input")
    B, H, W, cin = x.shape
    cout = weight.shape[1]
    if weight.shape != (cin, cout, 2, 2) or bias.shape != (cout,):
        raise ValueError(f"upconv kernel: weight [Cin, Cout, 2, 2] and bias [Cout] "
                         f"expected, got {tuple(weight.shape)} {tuple(bias.shape)}")
    if x.data_ptr() % 16:
        raise ValueError("upconv kernel needs a 16-byte-aligned input")
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


class _UpConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        if x.is_cuda:
            LAUNCHES["upconv_fwd"] += 1
            return launch_upconv2x2(x, weight, bias)
        return upconv2x2_plain(x, weight, bias)

    @staticmethod
    def backward(ctx, dy):
        backward_later("upconv2x2_packed")


def upconv2x2(x, weight, bias):
    """NHWC [B, H, W, Cin] -> [B, 2H, 2W, Cout] in x's dtype."""
    return _UpConv.apply(x, weight, bias)
