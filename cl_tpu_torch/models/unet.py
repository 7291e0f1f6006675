"""UNet encoder-decoder in PyTorch — the standard body of
``cl_tpu.models.unet.UNet`` (``_standard_body``).

Structure: ``depth`` encoder levels, each (3×3 SAME conv without bias → BN
→ ReLU) × 2 then a 2×2 max pool; a bottleneck double conv; ``depth``
decoder levels, each a k2/s2 transposed conv with bias, concat
``[skip, up]`` and a double conv; a 1×1 ``head`` of width ``num_classes``
(the padded head). Module names follow the flax tree (``enc{l}.conv{i}``,
``enc{l}.bn{i}``, ``bottleneck``, ``up{l}``, ``dec{l}``, ``head``), so
``cl_tpu_torch.interop`` maps weights 1:1.

Layouts: the public input and output are NHWC, as in the JAX package; the
convs run on the NCHW view of that memory, which is PyTorch's
``channels_last``. Params are f32; each op casts its weights to the
compute ``dtype`` (flax's ``kernel.astype(dtype)``), and logits are upcast
to f32.

BatchNorm follows flax, not ``nn.BatchNorm2d``: train mode normalizes with
the biased batch variance AND updates ``running = 0.9·running +
0.1·batch`` with that biased variance (torch's BatchNorm2d would update
with the unbiased one); eps is 1e-5.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax convention: weight of the old running value


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, training=False,
                                eps=BN_EPS)
        # No running buffers passed: the op normalizes with the biased
        # batch variance, updates nothing, and returns the batch mean and
        # 1/sqrt(var + eps) it computed (f32), so the running update
        # costs no second pass over x.
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, BN_EPS)
        with torch.no_grad():
            var = invstd.pow(-2) - BN_EPS
            self.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
            self.running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
        return y


class DoubleConv(nn.Module):
    """(conv3x3 → norm → ReLU) × 2."""

    def __init__(self, c_in: int, c_out: int, norm: str = "batch"):
        super().__init__()
        if norm not in ("batch", "none"):
            raise NotImplementedError(
                f"model.norm={norm!r}: GroupNorm comes with spatial "
                "parallelism in a later slice (ROADMAP Queue 1)")
        self.conv0 = Conv(c_in, c_out, 3, bias=False)
        self.conv1 = Conv(c_out, c_out, 3, bias=False)
        self.bn0 = BatchNorm(c_out) if norm == "batch" else None
        self.bn1 = BatchNorm(c_out) if norm == "batch" else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, bn in ((self.conv0, self.bn0), (self.conv1, self.bn1)):
            x = conv(x)
            if bn is not None:
                x = bn(x)
            x = F.relu(x)
        return x


class UNet(nn.Module):
    """UNet(x: [B, H, W, 3]) -> logits [B, H, W, num_classes] (f32)."""

    def __init__(self, num_classes: int, base_channels: int = 32,
                 depth: int = 4, norm: str = "batch",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = base_channels
        self.depth = depth
        self.dtype = dtype
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
        self.head = Conv(c, num_classes, 1, bias=True)

    def forward(self, x: torch.Tensor, *,
                return_features: bool = False) -> torch.Tensor:
        """``return_features=True`` returns the pre-head activations
        [B, H, W, base_channels] in the compute dtype instead of logits:
        the operand of the fused head+CE kernel, which applies the head's
        own params itself."""
        # NHWC memory seen as NCHW: channels_last for the convs.
        h = x.to(self.dtype).permute(0, 3, 1, 2)
        skips = []
        for level in range(self.depth):
            h = getattr(self, f"enc{level}")(h)
            skips.append(h)
            h = F.max_pool2d(h, 2, 2)
        h = self.bottleneck(h)
        for level in reversed(range(self.depth)):
            h = getattr(self, f"up{level}")(h)
            h = torch.cat([skips[level], h], dim=1)
            h = getattr(self, f"dec{level}")(h)
        if return_features:
            return h.permute(0, 2, 3, 1)
        return self.head(h).float().permute(0, 2, 3, 1)


def init_weights(model: UNet, generator: torch.Generator) -> None:
    """flax's default init from a seeded generator: lecun-normal conv
    kernels (truncated normal, variance 1/fan_in), zero biases, BN scale 1
    and shift 0. Not flax's bits: parity tests inject JAX variables."""
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
            elif isinstance(mod, BatchNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
