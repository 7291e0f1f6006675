"""The gen-2 3×3 SAME conv of ``model.conv_impl=pallas|hybrid``
(``csrc/conv3x3_g2.cu``): the counterpart of ``cl_tpu/pallas/conv3x3.py``.

#40 (``_fwd_kernel``): y = conv3x3_SAME(x, w), no bias, NHWC, summed in
f32 and rounded once to x's dtype. ``conv3x3_g2`` is ``cl_tpu``'s
``conv3x3`` custom VJP (``conv3x3.py:328-349``): the forward is #40; the
backward casts dy to x's dtype, runs #40 on dy with the weight flipped in
space and its channels swapped for dx (``:340-344``, no gate of its own),
and #41 (``_dw_kernel``: Σ over pixels of x ★ dy in f32) for dW, rounded
once to the compute dtype (``.astype(w.dtype)``, ``:345``) before the f32
param sees it.

``conv3x3_hybrid`` is ``conv3x3_hybrid`` (``:390-414``): the forward and
dx are ``lax`` convs in the compute dtype outside any Pallas kernel (the
dx the conv of dy with the flipped, channel-swapped weight), so here
cuDNN's (``F.conv2d``, and cuDNN's input gradient of it, the same
function); dW is #41 rounded to the compute dtype where
``packed_gate.g2_supported`` admits the shape (``dw_profitable``), else
cuDNN's weight gradient in the compute dtype, as ``jax.vjp`` of the
``lax`` conv gives it (``:410``). A conv whose input needs no gradient
(the stem's image) gets no dx, as XLA drops it in ``cl_tpu``.

The TPU kernels' lane packing, piece DMAs and the dW's fold over the pack
factor are layout devices; the arithmetic is one f32 sum per output,
rounded once (``csrc/conv3x3_g2.cu``). ``w`` is the port's f32 conv weight
[Cout, Cin, 3, 3], rounded to x's dtype as ``cl_tpu`` rounds its kernel.

On a CUDA tensor the wrappers launch the kernels, on a CPU tensor they run
the plain versions. ``LAUNCHES`` counts the kernel launches: #40 as a
forward (``conv3x3_g2_fwd``) and as a dx (``conv3x3_g2_dx``), #41
(``conv3x3_g2_dw``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cl_tpu_torch.kernels import build
from cl_tpu_torch.kernels.conv3x3 import _check_nhwc, _flip_t, _kernel_weight, _stream, \
    dw_tiled_outputs
from cl_tpu_torch.models.packed_gate import g2_supported

LAUNCHES = {"conv3x3_g2_fwd": 0, "conv3x3_g2_dx": 0, "conv3x3_g2_dw": 0}


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _nchw(t):
    return t.float().permute(0, 3, 1, 2)


def conv3x3_g2_plain(x, w):
    """#40: y = conv3x3_SAME(x, w rounded to x's dtype) in f32, rounded
    once to x's dtype (NHWC)."""
    y = F.conv2d(_nchw(x), w.to(x.dtype).float(), padding=1)
    return y.to(x.dtype).permute(0, 2, 3, 1).contiguous()


def conv3x3_g2_dw_plain(x, dy):
    """#41: dW [Cout, Cin, 3, 3] = Σ over the batch of x ★ dy in f32, not
    rounded (the VJPs round it)."""
    return torch.nn.grad.conv2d_weight(_nchw(x), (dy.shape[-1], x.shape[-1], 3, 3), _nchw(dy),
                                       padding=1)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def launch_conv3x3_g2(x, w):
    """#40 on the card: y [B, H, W, Cout] = conv3x3_SAME(x, w) in x's dtype."""
    _check_nhwc(x, "conv3x3_g2 kernel")
    B, H, W, cin = x.shape
    cout = w.shape[0]
    if w.shape != (cout, cin, 3, 3):
        raise ValueError(f"conv3x3_g2 kernel: weight [Cout, {cin}, 3, 3] expected, "
                         f"got {tuple(w.shape)}")
    wk = _kernel_weight(w, x.dtype)
    y = torch.empty(B, H, W, cout, dtype=x.dtype, device=x.device)
    err = build.library().cltorch_conv3x3_g2_fwd(
        x.data_ptr(), wk.data_ptr(), y.data_ptr(), B, H, W, cin, cout,
        int(x.dtype == torch.bfloat16), _stream(x))
    build.check(err, "conv3x3_g2_fwd")
    return y


def launch_conv3x3_g2_dw(x, dy):
    """#41 on the card: dW [Cout, Cin, 3, 3] f32, not rounded: the ring body
    in bf16, the register-blocked FMA body in f32, their pixel tiles split
    over the blocks of ``conv3x3.dw_tile_splits``, whose partials are summed
    in a fixed order."""
    shape, (ci_t, co_t, splits), bf16, partials, dw = dw_tiled_outputs(x, dy, "conv3x3_g2_dw")
    err = build.library().cltorch_conv3x3_g2_dw(
        x.data_ptr(), dy.data_ptr(), partials.data_ptr(), dw.data_ptr(), *shape, splits, ci_t,
        co_t, bf16, _stream(x))
    build.check(err, "conv3x3_g2_dw")
    return dw


# ---------------------------------------------------------------------------
# autograd wrappers and public entries
# ---------------------------------------------------------------------------


def _conv3x3_g2(x, w, key):
    """#40 (``key`` counts the launch) or its plain version."""
    if x.is_cuda:
        LAUNCHES[key] += 1
        return launch_conv3x3_g2(x, w)
    return conv3x3_g2_plain(x, w)


def _conv3x3_g2_dw(x, dy):
    """#41 (counted) or its plain version."""
    if x.is_cuda:
        LAUNCHES["conv3x3_g2_dw"] += 1
        return launch_conv3x3_g2_dw(x, dy)
    return conv3x3_g2_dw_plain(x, dy)


class _Conv3x3G2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _conv3x3_g2(x, w, "conv3x3_g2_fwd")

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = _conv3x3_g2(dy, _flip_t(w), "conv3x3_g2_dx") if ctx.needs_input_grad[0] else None
        dw = _conv3x3_g2_dw(x, dy).to(x.dtype).float() if ctx.needs_input_grad[1] else None
        return dx, dw


def conv3x3_g2(x, w):
    """``cl_tpu.pallas.conv3x3.conv3x3``: y [B, H, W, Cout] =
    conv3x3_SAME(x, w) in x's dtype, NHWC; ``w`` the f32 param
    [Cout, Cin, 3, 3]."""
    return _Conv3x3G2.apply(x, w)


class _Conv3x3Hybrid(torch.autograd.Function):
    """x is NCHW (channels_last memory), as the standard body holds it."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return F.conv2d(x, w.to(x.dtype), padding=1)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dtype = x.dtype
        # NHWC memory for #41, seen as NCHW for cuDNN
        dy = dy.to(dtype).permute(0, 2, 3, 1).contiguous()
        dy_nchw = dy.permute(0, 3, 1, 2)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # cuDNN's dgrad: for the conv of dy with the flipped, channel-
            # swapped weight cuDNN picks FFT algorithms at baseline_2's
            # shapes, slower than its dgrad (PERF.md)
            dx = torch.nn.grad.conv2d_input(x.shape, w.to(dtype), dy_nchw, padding=1)
        if ctx.needs_input_grad[1]:
            _, cin, h, wid = x.shape
            if g2_supported(h, wid, cin, w.shape[0]):
                dw = _conv3x3_g2_dw(x.permute(0, 2, 3, 1).contiguous(), dy).to(dtype)
            else:
                dw = torch.nn.grad.conv2d_weight(x, tuple(w.shape), dy_nchw, padding=1)
            dw = dw.float()
        return dx, dw


def conv3x3_hybrid(x, w):
    """``cl_tpu.pallas.conv3x3.conv3x3_hybrid``: y = conv3x3_SAME(x, w) on
    cuDNN in x's dtype, x and y NCHW (channels_last memory); ``w`` the f32
    param [Cout, Cin, 3, 3]. Its backward: dx on cuDNN, dW through #41
    where the gen-2 gate admits the shape."""
    return _Conv3x3Hybrid.apply(x, w)
