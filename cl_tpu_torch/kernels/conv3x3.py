"""3×3 SAME conv with a BN·ReLU prologue and a batch-stats epilogue, forward
(``csrc/conv3x3_bn.cu``).

Counterpart of ``cl_tpu.pallas.conv3x3_v3.conv_bn_fused``: every conv of
the packed body. With ``prologue`` on, the input is first mapped to
t = relu(x·a + b) (the producer's deferred BatchNorm, per input channel,
in f32, rounded to x's dtype); else t = x. Then y = conv3x3_SAME(t, w)
summed in f32 and rounded to x's dtype, and the per-channel Σy and Σy² of
the ROUNDED y. The SAME padding is zero in t-space, never relu(b). The
TPU kernel returns per-lane sums of its packed view; these are per channel.

``w`` is the port's conv weight [Cout, Cin, 3, 3] (f32), rounded to x's
dtype as the JAX package rounds its kernel. Tensors are NHWC.

On a CUDA tensor ``conv_bn_fused`` launches the kernel, on a CPU tensor it
runs ``conv_bn_plain``; the backward is a later slice and raises.
``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cl_tpu_torch.kernels import backward_later, build

TILE = 16  # output tile of the kernel (rows and columns)

LAUNCHES = {"conv3x3_bn_fwd": 0}


def conv_bn_plain(x, w, a=None, b=None, prologue=False):
    t = torch.relu(x.float() * a + b).to(x.dtype) if prologue else x
    y = F.conv2d(t.float().permute(0, 3, 1, 2), w.to(x.dtype).float(), padding=1)
    y = y.to(x.dtype).permute(0, 2, 3, 1).contiguous()
    yf = y.float().reshape(-1, y.shape[-1])
    return y, yf.sum(0), (yf * yf).sum(0)


def launch_conv_bn(x, w, a=None, b=None, prologue=False):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv3x3_bn kernel: f32 or bf16 only, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("conv3x3_bn kernel needs a contiguous NHWC input")
    B, H, W, cin = x.shape
    cout = w.shape[0]
    if w.shape != (cout, cin, 3, 3):
        raise ValueError(f"conv3x3_bn kernel: weight [Cout, {cin}, 3, 3] expected, "
                         f"got {tuple(w.shape)}")
    if x.data_ptr() % 16:
        raise ValueError("conv3x3_bn kernel needs a 16-byte-aligned input")
    # the tensor-core kernel (bf16) reads [3, 3, Cout, Cin], the FMA one
    # (f32) [Cin, 3, 3, Cout]
    order = (2, 3, 0, 1) if x.dtype == torch.bfloat16 else (1, 2, 3, 0)
    wk = w.to(x.dtype).permute(*order).contiguous()
    if prologue:
        a = a.to(device=x.device, dtype=torch.float32).contiguous()
        b = b.to(device=x.device, dtype=torch.float32).contiguous()
        if a.shape != (cin,) or b.shape != (cin,):
            raise ValueError(f"conv3x3_bn kernel: prologue vectors of shape ({cin},)")
    else:
        a = b = wk  # not read
    y = torch.empty(B, H, W, cout, dtype=x.dtype, device=x.device)
    tiles = -(-H // TILE) * -(-W // TILE)
    partials = torch.empty(tiles * B, 2, cout, dtype=torch.float32, device=x.device)
    out = torch.empty(2, cout, dtype=torch.float32, device=x.device)
    err = build.library().cltorch_conv3x3_bn_fwd(
        x.data_ptr(), wk.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(),
        partials.data_ptr(), out.data_ptr(), B, H, W, cin, cout, int(prologue),
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "conv3x3_bn_fwd")
    return y, out[0], out[1]


class _ConvBN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, a, b, prologue):
        if x.is_cuda:
            LAUNCHES["conv3x3_bn_fwd"] += 1
            return launch_conv_bn(x, w, a, b, prologue)
        return conv_bn_plain(x, w, a, b, prologue)

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        backward_later("conv_bn_fused")


def conv_bn_fused(x, w, a=None, b=None, prologue=False):
    """(y [B, H, W, Cout], Σy [Cout], Σy² [Cout]) of the conv of
    t = relu(x·a + b) (``prologue``) or t = x, NHWC in x's dtype."""
    return _ConvBN.apply(x, w, a, b, prologue)
