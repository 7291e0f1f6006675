"""UNet encoder-decoder in PyTorch — the standard and packed bodies of
``cl_tpu.models.unet.UNet``.

Structure: ``depth`` encoder levels, each (3×3 SAME conv without bias →
norm → ReLU) × 2 then a 2×2 max pool; a bottleneck double conv; ``depth``
decoder levels, each a k2/s2 transposed conv with bias, concat
``[skip, up]`` and a double conv; a 1×1 ``head`` of width ``head_width``
(None: ``num_classes``, the padded head). Module names follow the flax
tree (``enc{l}.conv{i}``, ``enc{l}.bn{i}`` or ``enc{l}.gn{i}``,
``bottleneck``, ``up{l}``, ``dec{l}``, ``head``), so
``cl_tpu_torch.interop`` maps weights 1:1.

Grow-the-head (``model.padded_head=false``, ``cl_tpu``'s ``head_width``):
the head is as wide as the classes seen so far, and the logits are padded
to ``num_classes`` with −1e9 (``cl_tpu``'s ``_pad_logits``), so every
consumer (the losses on logits, the LwF teacher's logits, the eval, the
Fisher pass, predict) sees the global label space. ``expand_head`` grows
the head between tasks; ``expand_head_zeros`` grows an auxiliary copy
(the LwF teacher) with zero rows.

Layouts: the public input and output are NHWC, as in the JAX package; the
convs run on the NCHW view of that memory, which is PyTorch's
``channels_last``. Params are f32; each op casts its weights to the
compute ``dtype`` (flax's ``kernel.astype(dtype)``), and logits are upcast
to f32.

BatchNorm follows flax, not ``nn.BatchNorm2d``: train mode normalizes with
the biased batch variance AND updates ``running = 0.9·running +
0.1·batch`` with that biased variance (torch's BatchNorm2d would update
with the unbiased one); eps is 1e-5. GroupNorm (``norm="group"``) follows
flax's ``nn.GroupNorm`` likewise, not ``F.group_norm``: min(8, C) groups,
f32 statistics of each image and group as E[x] and E[x²] sums, var =
max(0, E[x²] − E[x]²), (x − mean)·(rsqrt(var + 1e-6)·scale) + bias in f32,
one cast to the compute dtype.

The packed body (``packed=True``, ``cl_tpu``'s ``UNet._packed_body``)
runs the leading ``packed_gate.packed_prefix`` levels through the packed
kernels over the SAME submodules, so both bodies share one state dict:
each level's BatchNorm is deferred (``deferred_bn``) and applied by its
consumer — the next conv's prologue, or ``bn_relu`` before the pool, the
up-conv and the head — and the decoder's first conv is split over the
[skip, up] operands. The deeper levels and the bottleneck run the
standard modules. Every packed op is an autograd Function whose backward
is the JAX package's custom VJP in a kernel of its own, so the packed body
trains under autograd. Each level's skip and pool are one op whose
backward takes both cotangents in one launch (``maxpool2x2_packed_tee``):
``model.pool_tee=false`` gives the same bits in JAX, so the port always
takes the tee.

``conv_impl`` (``model.conv_impl``) routes the standard body's convs as
``cl_tpu`` does (``packed_gate.double_conv_route``): under "v3" or "auto"
a DoubleConv whose two convs pass the gate at one pack factor runs both
through the gen-3 conv (``conv3x3.conv3x3``, kernel #30 and its dW #31),
each followed by ``packed_batch_norm`` (``cl_tpu``'s PackedBatchNorm);
else each conv the gate admits runs alone through the gen-3 conv and the
rest through cuDNN. Under "pallas" each conv that the gen-2 gate admits
(``packed_gate.g2_supported``: all but the stem at the presets) runs
forward, dx and dW through the gen-2 conv (``conv3x3_g2.conv3x3_g2``,
kernel #40 and its dW #41), the rest through cuDNN; under "hybrid" every
conv, the stem included, runs its forward and dx on cuDNN and its dW
through #41 where the gate admits the shape (``conv3x3_g2.conv3x3_hybrid``).
BatchNorm and ReLU follow each conv as on the "xla" route. The packed
body's deep region stays on cuDNN, as ``cl_tpu`` hard-codes there.

``upconv_impl`` (``model.upconv_impl``): under "matmul", and under
``conv_impl="pallas"``, the standard body's up-convs run as ``cl_tpu``'s
``UpConv2x2`` (``upconv2x2_matmul``: one product and a pixel shuffle, the
bias added after the product's rounding) over the same ``up{l}`` weights;
the packed body keeps its own up-convs, as ``cl_tpu`` does.

``remat`` (``train.remat``) is ``cl_tpu``'s per-level rematerialization
(``nn.remat`` on each ``PackedLevel`` and ``DoubleConv``): each level's
``packed_plain`` / ``packed_split`` and each standard ``DoubleConv`` runs
under ``torch.utils.checkpoint`` (``remat``), so only the levels'
inputs and outputs stay resident and the backward runs each level's
forward again; the pool tee, the up-convs and the head stay outside, as
in ``cl_tpu``. The recompute gives the same bits and must not move the
running statistics a second time (flax's ``nn.remat`` does not): every
running update is skipped while ``recomputing()``.

Under data parallelism (``set_data_parallel``: ``cl_tpu``'s ``dp_axis``)
every BatchNorm takes its statistics over the global batch: the deferred
BN's sums s1, s2 and its count n (``DeferredBatchNorm``'s psum), the
standard BatchNorm's E[x] and E[x²] with flax's arithmetic (a pmean of
both, var = max(0, E[x²] − E[x]²)), and ``packed_batch_norm``'s sums,
each through an all-reduce whose backward all-reduces the cotangent
(``sharding.all_reduce_sum``; ``_BnReluTrain``'s backward sums its folded
statistics over the group itself). The running statistics come from the
global ones, so they stay equal on every rank. With ``model.packed_unet``
the gen-3 packed-level route is off under DP, as ``cl_tpu``'s
``DoubleConv`` turns it off under ``dp_axis`` (``unet.py:314-315``).

Under spatial parallelism (``set_data_parallel`` with a
``sharding.SpatialParallel``) ``forward`` is ``parallel/spatial.py``'s
height-sharded forward over the same params, with ``cl_tpu``'s spatial
arithmetic (GroupNorm only; its own normalization order, no kernel).

``act_q`` (``model.conv_act_store=int8``) stores the saved activations of
every packed conv that ``packed_gate.q_supported`` admits (its input's
width over the level's P a multiple of 32) as int8 with row scales
(``conv3x3.conv_bn_fused_q``), as ``cl_tpu``'s ``PackedLevel._conv``
does: each conv keeps its own y as int8, and a level's conv1 keeps conv0's
int8 pair in place of its input. The forward is unchanged, bit for bit.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from cl_tpu_torch.kernels import conv3x3, conv3x3_g2, packed_eltwise, pool_pack, upconv_pack
from cl_tpu_torch.losses import NEG_INF
from cl_tpu_torch.models.packed_gate import (double_conv_route, packed_prefix, pick_pack,
                                             q_supported)
from cl_tpu_torch.parallel import spatial
from cl_tpu_torch.sharding import all_reduce_sum

BN_EPS = 1e-5
GN_EPS = 1e-6  # flax nn.GroupNorm's default
BN_MOMENTUM = 0.9  # flax convention: weight of the old running value

# Set in the thread that runs a rematerialized level's forward again
# inside the backward.
_REMAT = threading.local()


def recomputing() -> bool:
    """True while ``remat`` runs a level's forward again in the backward."""
    return getattr(_REMAT, "recompute", False)


@contextlib.contextmanager
def _recompute():
    prev = recomputing()
    _REMAT.recompute = True
    try:
        yield
    finally:
        _REMAT.recompute = prev


def _remat_contexts():
    return contextlib.nullcontext(), _recompute()


def remat(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant, so
    ``torch.autograd.grad`` works through it): nothing ``fn`` saves for
    the backward stays resident; the backward runs ``fn`` again under
    ``recomputing()``. No level draws random numbers, so no RNG state is
    kept."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             context_fn=_remat_contexts,
                                             preserve_rng_state=False)


@torch.no_grad()
def _update_running(bn, mu, var) -> None:
    """running = 0.9·running + 0.1·batch, once a forward: not in a
    rematerialized level's recompute."""
    if recomputing():
        return
    bn.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mu)
    bn.running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)


class Conv(nn.Module):
    """Conv (or k2/s2 transposed conv) with f32 params and compute in the
    input's dtype. ``weight`` is [O, I, kh, kw] ([I, O, 2, 2] transposed)."""

    def __init__(self, c_in: int, c_out: int, k: int, *, bias: bool,
                 transposed: bool = False):
        super().__init__()
        shape = (c_in, c_out, k, k) if transposed else (c_out, c_in, k, k)
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None
        self.transposed = transposed
        self.fan_in = c_in * k * k

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        if self.transposed:
            return F.conv_transpose2d(x, w, b, stride=2)
        return F.conv2d(x, w, b, padding=self.weight.shape[-1] // 2)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` semantics: see the
    module docstring. Statistics are f32 whatever the input dtype."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.dp = None  # sharding.DataParallel: statistics over the global batch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, training=False,
                                eps=BN_EPS)
        if self.dp is not None:
            return self._global(x)
        # No running buffers passed: the op normalizes with the biased
        # batch variance, updates nothing, and returns the batch mean and
        # 1/sqrt(var + eps) it computed (f32), so the running update
        # costs no second pass over x.
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, BN_EPS)
        with torch.no_grad():
            _update_running(self, mean, invstd.pow(-2) - BN_EPS)
        return y

    def _global(self, x: torch.Tensor) -> torch.Tensor:
        """flax's ``nn.BatchNorm(axis_name=...)`` on NCHW x: f32 E[x] and
        E[x²] of the rank's rows, their mean over the group (one
        differentiable all-reduce of both), var = max(0, E[x²] − E[x]²),
        then (x − mean)·(rsqrt(var + eps)·γ) + β in f32, cast to x's dtype."""
        xf = x.float()
        dims = (0, 2, 3)
        m = all_reduce_sum(torch.stack([xf.mean(dims), (xf * xf).mean(dims)]), self.dp)
        m = m / self.dp.world
        mean, var = m[0], torch.clamp_min(m[1] - m[0] * m[0], 0.0)
        _update_running(self, mean.detach(), var.detach())
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        shape = (1, -1, 1, 1)
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups=min(8, C), epsilon=1e-6)`` on NCHW x
    (channels_last memory): per image and group, the f32 sums of x and x²
    over (H, W, C/G) give E[x] and E[x²], var = max(0, E[x²] − E[x]²)
    (``use_fast_variance``), then y = (x − mean)·(rsqrt(var + eps)·scale)
    + bias in f32 and one cast to x's dtype (``_normalize``). Written as
    sums, not ``F.group_norm`` (a Welford variance, other rounding points,
    and on CUDA a weight in the input's dtype). Per image: no statistic
    crosses the batch, so data parallelism needs no collective here."""

    def __init__(self, c: int):
        super().__init__()
        self.groups = min(8, c)
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        g = self.groups
        # f32 (float64 stays float64, flax's promote_types(dtype, float32));
        # the NHWC view of channels_last memory
        xf = x.to(torch.promote_types(x.dtype, torch.float32)).permute(0, 2, 3, 1)
        xg = xf.reshape(b, h * w, g, c // g)
        n = h * w * (c // g)
        mean = xg.sum((1, 3)) / n
        var = torch.clamp_min((xg * xg).sum((1, 3)) / n - mean * mean, 0.0)
        mean = mean.repeat_interleave(c // g, dim=1)[:, None, None, :]
        mul = torch.rsqrt(var + GN_EPS).repeat_interleave(c // g, dim=1)[:, None, None, :]
        y = (xf - mean) * (mul * self.weight) + self.bias
        return y.to(x.dtype).permute(0, 3, 1, 2)


class _BnReluTrain(torch.autograd.Function):
    """``cl_tpu``'s ``_bn_relu_train``: z = relu(y·scale + shift) with the
    batch's own mu and var, and the train-mode BatchNorm backward in two
    passes (``unet.py:197-221``): the ReLU mask is (ŷ·γ + β) > 0 with
    ŷ = (y − mu)·r, and the statistics' paths are folded into dy, so mu
    and var get no cotangent."""

    @staticmethod
    def forward(ctx, y, mu, var, gamma, beta, dp=None):
        ctx.save_for_backward(y, mu, var, gamma, beta)
        ctx.dp = dp
        r = torch.rsqrt(var + BN_EPS)
        scale, shift = r * gamma, beta - (mu * r) * gamma
        return torch.relu(y.float() * scale + shift).to(y.dtype)

    @staticmethod
    def backward(ctx, dz):
        y, mu, var, gamma, beta = ctx.saved_tensors
        c = y.shape[-1]
        n = y.numel() // c
        r = torch.rsqrt(var + BN_EPS)
        yhat = (y.float() - mu) * r
        g = torch.where(yhat * gamma + beta > 0, dz.float(), 0.0)
        s1 = g.reshape(-1, c).sum(0)
        s2 = (g * yhat).reshape(-1, c).sum(0)
        f1, f2 = s1, s2
        if ctx.dp is not None:
            # the statistics are the global batch's: their folded paths
            # take every rank's sums and the global count; γ's and β's
            # gradients stay the rank's share
            f1, f2 = ctx.dp.all_reduce_(torch.stack([s1, s2]))
            n *= ctx.dp.world
        dy = ((r * gamma) * (g - (f1 + yhat * f2) / n)).to(y.dtype)
        return dy, None, None, s2, s1, None


def packed_batch_norm(bn: BatchNorm, y: torch.Tensor, train: bool) -> torch.Tensor:
    """``cl_tpu``'s ``PackedBatchNorm`` + ReLU on NHWC y, with ``bn``'s
    params and running statistics (the same state as the standard route):
    train mode takes mu and the fast biased variance Σy²/n − mu² from f32
    sums of y, updates the running statistics with them and applies
    through ``_BnReluTrain``; eval mode applies the running ones with
    ``cl_tpu``'s scale/shift association (``unet.py:259-264``), under
    plain autograd."""
    if not train:
        r = torch.rsqrt(bn.running_var + BN_EPS)
        scale = r * bn.weight
        shift = bn.bias - (bn.running_mean * r) * bn.weight
        return torch.relu(y.float() * scale + shift).to(y.dtype)
    with torch.no_grad():
        yf = y.float().reshape(-1, y.shape[-1])
        mu = yf.sum(0) / yf.shape[0]
        var = (yf * yf).sum(0) / yf.shape[0] - mu * mu
        bn.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mu)
        bn.running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
    return _BnReluTrain.apply(y, mu, var, bn.weight, bn.bias)


def deferred_bn(bn: BatchNorm, s1, s2, n: int, train: bool):
    """``cl_tpu``'s ``DeferredBatchNorm``: per-channel (scale, shift) of a
    BatchNorm whose application the consumer does. Train mode takes the
    batch statistics from the producer's sums (mu = Σy/n, biased var =
    Σy²/n − mu², f32) and updates the running ones; eval mode uses the
    running ones. Under ``bn.dp`` s1 and s2 are summed over the group
    through a differentiable all-reduce and n is the local count times
    the group's size (``cl_tpu``'s psum of s1, s2 and 1)."""
    if train:
        if bn.dp is not None:
            s1, s2 = all_reduce_sum(torch.stack([s1, s2]), bn.dp)
            n = n * bn.dp.world
        mu = s1 / n
        var = s2 / n - mu * mu
        _update_running(bn, mu.detach(), var.detach())
    else:
        mu, var = bn.running_mean, bn.running_var
    scale = torch.rsqrt(var + BN_EPS) * bn.weight
    return scale, bn.bias - mu * scale


def upconv2x2_matmul(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``cl_tpu``'s ``UpConv2x2`` (``unet.py:132-161``): the k2/s2 transposed
    conv as one product of x [B·H·W, Cin] and the weight [Cin, 4·Cout] in
    the compute dtype, a pixel shuffle, then the bias rounded to the dtype
    and added, so the result is rounded twice (``F.conv_transpose2d``
    adds the bias before its one rounding). ``weight`` is the port's
    [Cin, Cout, 2, 2], which holds ``interop``'s flipped flax kernel: output
    (2h + u, 2w + v) takes ``weight[:, :, u, v]``, and ``cl_tpu``'s own
    flip is undone by that mapping. x and the result are NCHW views of
    channels_last memory."""
    b, c, h, w = x.shape
    cout = weight.shape[1]
    rows = x.permute(0, 2, 3, 1).reshape(b * h * w, c)
    t = rows @ weight.to(x.dtype).permute(0, 2, 3, 1).reshape(c, 4 * cout)  # cols (u, v, co)
    y = t.reshape(b, h, w, 2, 2, cout).permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, cout)
    return (y + bias.to(x.dtype)).permute(0, 3, 1, 2)


class DoubleConv(nn.Module):
    """(conv3x3 → norm → ReLU) × 2: BatchNorm (``bn0`` / ``bn1``),
    GroupNorm (``gn0`` / ``gn1``, which never takes the packed level) or
    none."""

    def __init__(self, c_in: int, c_out: int, norm: str = "batch"):
        super().__init__()
        if norm not in ("batch", "group", "none"):
            raise ValueError(f"unknown model.norm {norm!r}")
        self.norm = norm
        self.conv0 = Conv(c_in, c_out, 3, bias=False)
        self.conv1 = Conv(c_out, c_out, 3, bias=False)
        self.bn0 = BatchNorm(c_out) if norm == "batch" else None
        self.bn1 = BatchNorm(c_out) if norm == "batch" else None
        if norm == "group":
            self.gn0, self.gn1 = GroupNorm(c_out), GroupNorm(c_out)
        # the gen-3 packed-level route; off under cl_tpu's dp_axis
        self.level_route = True

    def forward(self, x: torch.Tensor, conv_impl: str = "xla") -> torch.Tensor:
        """x is NCHW (channels_last memory); ``conv_impl`` routes the convs
        (``packed_gate.double_conv_route``)."""
        _, c_in, h, w = x.shape
        routes = double_conv_route(h, w, c_in, self.conv0.weight.shape[0], conv_impl,
                                   self.norm, level=self.level_route)
        if routes[0] == "packed":
            x = x.permute(0, 2, 3, 1).contiguous()
            for conv, bn in ((self.conv0, self.bn0), (self.conv1, self.bn1)):
                x = packed_batch_norm(bn, conv3x3.conv3x3(x, conv.weight), self.training)
            return x.permute(0, 3, 1, 2)
        norms = (self.bn0, self.bn1) if self.norm != "group" else (self.gn0, self.gn1)
        for conv, bn, route in ((self.conv0, norms[0], routes[0]),
                                (self.conv1, norms[1], routes[1])):
            if route == "v3":
                x = conv3x3.conv3x3(x.permute(0, 2, 3, 1).contiguous(),
                                    conv.weight).permute(0, 3, 1, 2)
            elif route == "g2":
                x = conv3x3_g2.conv3x3_g2(x.permute(0, 2, 3, 1).contiguous(),
                                          conv.weight).permute(0, 3, 1, 2)
            elif route == "hybrid":
                x = conv3x3_g2.conv3x3_hybrid(x, conv.weight)
            else:
                x = conv(x)
            if bn is not None:
                x = bn(x)
            x = F.relu(x)
        return x

    @staticmethod
    def _packed_conv(x, xq, w, a, b, prologue, p, act_q):
        """``PackedLevel._conv``: (y, Σy, Σy², (q, scale) or None), with
        int8 saved activations where ``act_q`` and ``q_supported`` at the
        input's width; ``xq`` is the producer conv's own pair for x."""
        if act_q and q_supported(x.shape[2], p):
            return conv3x3.conv_bn_fused_q(x, xq, w, a, b, prologue, p)
        return (*conv3x3.conv_bn_fused(x, w, a, b, prologue, p), None)

    def packed_plain(self, x: torch.Tensor, train: bool, p: int, act_q: bool = False):
        """``cl_tpu``'s ``PackedLevel`` in its ``stem`` and ``plain`` modes
        (the stem's channel padding is a TPU layout device): conv0 with the
        stats epilogue, its BatchNorm deferred into conv1's prologue, and
        conv1's BatchNorm deferred to the caller. x is NHWC (already
        applied); returns (y, scale, shift). ``p``: the body's pack factor.
        Under ``act_q`` conv0's int8 pair is conv1's saved input (conv0's
        own input, the image or the pool's output, has no int8 producer)."""
        n = x.shape[0] * x.shape[1] * x.shape[2]
        y, s1, s2, q0 = self._packed_conv(x, None, self.conv0.weight, None, None, False, p, act_q)
        sc, sh = deferred_bn(self.bn0, s1, s2, n, train)
        y, s1, s2, _ = self._packed_conv(y, q0, self.conv1.weight, sc, sh, True, p, act_q)
        return (y, *deferred_bn(self.bn1, s1, s2, n, train))

    def packed_split(self, skip: torch.Tensor, up: torch.Tensor, train: bool, p: int,
                     act_q: bool = False):
        """``PackedLevel`` in ``split`` mode, the decoder's entry: conv0 of
        the concat [skip, up] as two convs whose outputs are added with
        the sum's own statistics (the stats of a sum are not the sum of
        the stats), then conv1 as in ``packed_plain``. Under ``act_q`` each
        conv keeps its own y as int8; conv1's input comes from
        ``add_stats``, no int8 producer, and is kept as it is."""
        n = skip.shape[0] * skip.shape[1] * skip.shape[2]
        f = skip.shape[-1]
        ys, _, _, _ = self._packed_conv(skip, None, self.conv0.weight[:, :f], None, None, False,
                                        p, act_q)
        yu, _, _, _ = self._packed_conv(up, None, self.conv0.weight[:, f:], None, None, False,
                                        p, act_q)
        y, s1, s2 = packed_eltwise.add_stats(ys, yu)
        sc, sh = deferred_bn(self.bn0, s1, s2, n, train)
        y, s1, s2, _ = self._packed_conv(y, None, self.conv1.weight, sc, sh, True, p, act_q)
        return (y, *deferred_bn(self.bn1, s1, s2, n, train))


class UNet(nn.Module):
    """UNet(x: [B, H, W, 3]) -> logits [B, H, W, num_classes] (f32); a head
    narrower than ``num_classes`` (``head_width``) has its logits padded
    with −1e9."""

    def __init__(self, num_classes: int, base_channels: int = 32,
                 depth: int = 4, norm: str = "batch",
                 dtype: torch.dtype = torch.float32, packed: bool = False,
                 conv_impl: str = "xla", act_q: bool = False, upconv_impl: str = "xla",
                 remat: bool = False, head_width: int | None = None):
        super().__init__()
        c = base_channels
        self.num_classes = num_classes
        self.remat = remat
        self.dp = None
        self.base_channels = c
        self.conv_impl = conv_impl
        # the standard body's up-convs as cl_tpu's UpConv2x2 (unet.py:814)
        self.upconv_matmul = upconv_impl == "matmul" or conv_impl == "pallas"
        self.act_q = act_q
        self.depth = depth
        self.norm = norm
        self.dtype = dtype
        self.packed = packed
        c_in = 3
        for level in range(depth):
            setattr(self, f"enc{level}", DoubleConv(c_in, c * 2 ** level, norm))
            c_in = c * 2 ** level
        self.bottleneck = DoubleConv(c_in, c * 2 ** depth, norm)
        for level in reversed(range(depth)):
            feats = c * 2 ** level
            setattr(self, f"up{level}",
                    Conv(feats * 2, feats, 2, bias=True, transposed=True))
            setattr(self, f"dec{level}", DoubleConv(feats * 2, feats, norm))
        self.head = Conv(c, head_width or num_classes, 1, bias=True)

    def set_data_parallel(self, dp, *, per_shard: bool = True) -> "UNet":
        """Take every BatchNorm's statistics over ``dp``'s group (None: this
        process's batch). ``per_shard`` (``model.packed_unet``: ``cl_tpu``
        runs the model per shard with ``dp_axis`` set, else plain GSPMD on
        the global batch) turns the gen-3 packed-level route off under a
        group, as ``cl_tpu``'s ``DoubleConv`` does under ``dp_axis``. A
        ``sharding.SpatialParallel`` group sends every forward through the
        height-sharded one (``parallel/spatial.py``), which has no
        BatchNorm."""
        self.dp = dp
        for mod in self.modules():
            if isinstance(mod, BatchNorm):
                mod.dp = None if dp is None or dp.spatial else dp
            elif isinstance(mod, DoubleConv):
                mod.level_route = dp is None or not per_shard
        return self

    def _level(self, fn, *args):
        """One level's forward, rematerialized under ``remat`` where the
        backward will need it (cl_tpu's ``nn.remat`` on PackedLevel and
        DoubleConv; a forward without grad saves nothing anyway)."""
        if self.remat and torch.is_grad_enabled():
            return remat(fn, *args)
        return fn(*args)

    def forward(self, x: torch.Tensor, *, return_features: bool = False,
                packed_features: bool = False):
        """``return_features=True`` returns the pre-head activations
        [B, H, W, base_channels] in the compute dtype instead of logits:
        the operand of the fused head+CE kernel, which applies the head's
        own params itself. With ``packed_features`` too, the packed body
        returns its raw last-level output and that level's deferred
        BatchNorm, ``(y [B, H, W, base_channels], scale, shift)``, and
        skips the final BN·ReLU (the operands of
        ``head_ce.head_cross_entropy_packed_bn``, which applies it
        in-kernel; ``keep_packed`` in ``cl_tpu``). Where the packed body
        does not engage, the features come back plain, as in ``cl_tpu``.

        Under a height-sharded group (``self.dp.spatial``) the forward is
        ``spatial.spatial_apply``'s: the logits of this rank's rows of the
        whole batch ``x`` (``cl_tpu``'s ``spatial_apply_fn``, which the
        train, eval and Fisher steps and the LwF teacher all take)."""
        if self.dp is not None and self.dp.spatial:
            if return_features:
                raise ValueError("the spatial forward returns logits only: the fused head "
                                 "is off under train.spatial_parallel")
            return spatial.spatial_apply(self, x, self.dp, self.dtype)
        if self.packed_levels(x.shape[1], x.shape[2]) > 0:
            keep = return_features and packed_features
            z = self._packed_body(x.to(self.dtype).contiguous(), keep_raw=keep)
            if return_features:
                return z
            return self._logits(z.permute(0, 3, 1, 2))
        # NHWC memory seen as NCHW: channels_last for the convs.
        h = x.to(self.dtype).permute(0, 3, 1, 2)
        skips = []
        for level in range(self.depth):
            h = self._level(getattr(self, f"enc{level}"), h, self.conv_impl)
            skips.append(h)
            h = F.max_pool2d(h, 2, 2)
        h = self._level(self.bottleneck, h, self.conv_impl)
        for level in reversed(range(self.depth)):
            up = getattr(self, f"up{level}")
            h = upconv2x2_matmul(h, up.weight, up.bias) if self.upconv_matmul else up(h)
            h = torch.cat([skips[level], h], dim=1)
            h = self._level(getattr(self, f"dec{level}"), h, self.conv_impl)
        if return_features:
            return h.permute(0, 2, 3, 1)
        return self._logits(h)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """The head on NCHW features: f32 NHWC logits, padded to
        ``num_classes`` with −1e9 where the head is narrower (``cl_tpu``'s
        ``_pad_logits``)."""
        logits = self.head(h).float().permute(0, 2, 3, 1)
        pad = self.num_classes - logits.shape[-1]
        return F.pad(logits, (0, pad), value=NEG_INF) if pad > 0 else logits

    def packed_levels(self, h: int, w: int) -> int:
        """How many leading levels the packed body runs for an h × w input
        (``cl_tpu``'s engage rule); 0 = the standard body."""
        if not (self.packed and self.norm == "batch" and h == w):
            return 0
        return packed_prefix(h, self.base_channels, self.depth,
                             self.dtype.itemsize)

    def _packed_body(self, x: torch.Tensor, keep_raw: bool = False):
        """``cl_tpu``'s ``UNet._packed_body`` on NHWC x: levels below the
        prefix in the packed kernels, the deeper ones and the bottleneck
        through the standard modules (channels_last), the decoder packing
        the deep region's output on entry. Returns the pre-head
        activations [B, H, W, base_channels] (NHWC), or with ``keep_raw``
        the last conv's raw output and its deferred (scale, shift)."""
        prefix = self.packed_levels(x.shape[1], x.shape[2])
        train = self.training
        P = pick_pack(self.base_channels, self.base_channels)
        skips = []
        for level in range(prefix):
            y, sc, sh = self._level(getattr(self, f"enc{level}").packed_plain, x, train, P,
                                    self.act_q)
            z = packed_eltwise.bn_relu(y, sc, sh)
            # the pool's input is the skip
            z, x = pool_pack.maxpool2x2_tee(z)
            skips.append(z)

        h = x.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        deep_skips = []
        for level in range(prefix, self.depth):
            h = self._level(getattr(self, f"enc{level}"), h)
            deep_skips.append(h)
            h = F.max_pool2d(h, 2, 2)
        h = self._level(self.bottleneck, h)
        for level in reversed(range(prefix, self.depth)):
            h = getattr(self, f"up{level}")(h)
            h = torch.cat([deep_skips[level - prefix], h], dim=1)
            h = self._level(getattr(self, f"dec{level}"), h)

        below = h.permute(0, 2, 3, 1).contiguous()
        for level in reversed(range(prefix)):
            if level + 1 < prefix:
                below = packed_eltwise.bn_relu(y, sc, sh)
            up = getattr(self, f"up{level}")
            u = upconv_pack.upconv2x2(below, up.weight, up.bias)
            y, sc, sh = self._level(getattr(self, f"dec{level}").packed_split,
                                    skips[level], u, train, P, self.act_q)
        if keep_raw:
            return y, sc, sh
        return packed_eltwise.bn_relu(y, sc, sh)


def init_weights(model: UNet, generator: torch.Generator) -> None:
    """flax's default init from a seeded generator: lecun-normal conv
    kernels (truncated normal, variance 1/fan_in), zero biases, BN and GN
    scale 1 and shift 0. Not flax's bits: parity tests inject JAX
    variables."""
    # stddev of a standard normal truncated to [-2, 2]
    trunc_std = 0.87962566103423978
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Conv):
                std = math.sqrt(1.0 / mod.fan_in) / trunc_std
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (BatchNorm, GroupNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                if isinstance(mod, BatchNorm):
                    mod.running_mean.zero_()
                    mod.running_var.fill_(1.0)


def _grown_head(model: UNet, new_width: int, new_rows, new_bias) -> None:
    """Put a 1×1 head of ``new_width`` in place of ``model.head``: the old
    rows and bias first, bit for bit, then ``new_rows`` [k, Cin, 1, 1] and
    ``new_bias`` [k]; the old head's device, dtype and memory format
    kept. The head keeps its place among the model's params (the last)."""
    old = model.head
    w, b = old.weight.detach(), old.bias.detach()
    head = Conv(w.shape[1], new_width, 1, bias=True)
    with torch.no_grad():
        weight = torch.cat([w, new_rows.to(w)])
        if w.is_contiguous(memory_format=torch.channels_last):
            weight = weight.contiguous(memory_format=torch.channels_last)
        head.weight = nn.Parameter(weight, requires_grad=old.weight.requires_grad)
        head.bias = nn.Parameter(torch.cat([b, new_bias.to(b)]),
                                 requires_grad=old.bias.requires_grad)
    model.head = head


def expand_head(model: UNet, new_width: int, generator: torch.Generator) -> UNet:
    """Grow ``model``'s head to ``new_width`` classes in place (``cl_tpu``'s
    ``expand_head_params``, ``unet.py:836-861``): the old classes' rows and
    bias copied bit for bit, the new rows an untruncated normal ×
    sqrt(1/fan_in) drawn from ``generator`` (a CPU generator, so every
    device and every rank draws the same bits), the new bias zero. A
    width not above the head's is a no-op."""
    k = new_width - model.head.weight.shape[0]
    if k <= 0:
        return model
    cin = model.head.weight.shape[1]
    rows = torch.randn((k, cin, 1, 1), generator=generator, dtype=torch.float32)
    _grown_head(model, new_width, rows * math.sqrt(1.0 / cin), torch.zeros(k))
    return model


def expand_head_zeros(model: UNet, new_width: int) -> UNet:
    """Grow ``model``'s head to ``new_width`` with zero rows and bias, in
    place (``cl_tpu``'s ``expand_head_zeros`` on the LwF snapshot: no
    distillation signal on classes the snapshot never knew)."""
    k = new_width - model.head.weight.shape[0]
    if k > 0:
        cin = model.head.weight.shape[1]
        _grown_head(model, new_width, torch.zeros((k, cin, 1, 1)), torch.zeros(k))
    return model
