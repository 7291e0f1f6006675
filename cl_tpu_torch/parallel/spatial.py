"""The UNet forward on a height shard, with a halo exchange between ranks.

The counterpart of ``cl_tpu/parallel/spatial.py`` (``train.spatial_parallel``):
every rank of a group holds the whole batch and computes rows
``[r·H/n, (r+1)·H/n)`` of every level of the standard GroupNorm UNet, over
the same parameters as the port's ``UNet`` and with ``cl_tpu``'s
arithmetic (not the model's own GroupNorm, which is flax's):

  * each 3×3 conv first appends one neighbour row above and below its
    shard (``_halo_rows``); the top shard's top halo and the bottom
    shard's bottom halo are zeros, which is SAME padding exactly; the conv
    then pads W only (cuDNN, channels_last, the kernel cast to x's dtype,
    no bias);
  * the exchange is an autograd Function on all-reduce: each rank writes
    its first and last rows into its own slot of a zeroed
    ``[n, B, 2, W, C]`` buffer (f32: a bf16 value survives the trip and a
    sum with zeros exactly, and gloo has no bf16 sum everywhere), one
    all-reduce gives every rank its neighbours' rows; the backward sends
    each halo row's cotangent back to the rank that owns the row through
    the same kind of buffer, where it is added to that row's gradient
    (the transpose of ``ppermute``). All-reduce and barrier are the port's
    only collectives (``sharding.py``): gloo runs them on CUDA tensors,
    so two ranks can share one card;
  * GroupNorm takes global statistics (``_group_norm``): f32 sums s1, s2
    per (image, group) with min(8, C) groups, summed over the ranks
    through ``sharding.all_reduce_sum`` (whose backward all-reduces the
    cotangent), var = s2/n − mean², NOT clamped, then (g − mean)·rsqrt(var
    + 1e-6), ·scale + bias in f32, one cast to the input's dtype;
  * conv → GN → ReLU twice a level; the 2×2 max pool never crosses a shard
    (every shard's height stays even); the k2/s2 transposed conv and its
    bias, both in x's dtype, need no halo; the skip is concatenated first;
    the 1×1 head in x's dtype plus its bias, then f32.

The forward reads the model's ``conv_impl``, ``remat`` and ``packed`` not
at all, as ``cl_tpu``'s spatial forward reads neither (its convs are
``lax.conv``); the head is the model's at its own width, and its logits are
padded to ``num_classes`` with −1e9 as the model's own are. With no group
(a world of 1) the halo is plain zero padding: the one-rank reference of
the sharded forward. No kernel of the port runs here, as in ``cl_tpu``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cl_tpu_torch.losses import NEG_INF
from cl_tpu_torch.sharding import all_reduce_sum

GN_EPS = 1e-6


def _world(group) -> tuple[int, int]:
    return (1, 0) if group is None else (group.world, group.rank)


class _Halo(torch.autograd.Function):
    """edges [B, 2, W, C] (the shard's first and last rows) -> halos
    [B, 2, W, C]: the last row of the rank above and the first row of the
    rank below, zeros past the ends."""

    @staticmethod
    def forward(ctx, edges, group):
        ctx.group = group
        n, r = group.world, group.rank
        buf = edges.new_zeros((n,) + tuple(edges.shape), dtype=torch.float32)
        buf[r] = edges
        group.all_reduce_(buf)
        halo = torch.zeros_like(edges)
        if r > 0:
            halo[:, 0] = buf[r - 1, :, 1]
        if r < n - 1:
            halo[:, 1] = buf[r + 1, :, 0]
        return halo

    @staticmethod
    def backward(ctx, g):
        group = ctx.group
        n, r = group.world, group.rank
        buf = g.new_zeros((n,) + tuple(g.shape), dtype=torch.float32)
        if r > 0:  # the top halo is the rank above's last row
            buf[r - 1, :, 1] = g[:, 0]
        if r < n - 1:  # the bottom halo is the rank below's first row
            buf[r + 1, :, 0] = g[:, 1]
        group.all_reduce_(buf)
        return buf[r].to(g.dtype), None


def _halo_rows(x: torch.Tensor, group) -> torch.Tensor:
    """NHWC [B, h, W, C] -> [B, h + 2, W, C]: the neighbours' boundary rows
    around the shard, zero rows at the image's top and bottom."""
    if _world(group)[0] == 1:
        return F.pad(x, (0, 0, 0, 0, 1, 1))
    halo = _Halo.apply(torch.stack([x[:, 0], x[:, -1]], dim=1), group)
    return torch.cat([halo[:, :1], x, halo[:, 1:]], dim=1)


def _conv3x3(x: torch.Tensor, weight: torch.Tensor, group) -> torch.Tensor:
    """SAME 3×3 conv of an NCHW (channels_last) shard: the halo on H, zero
    padding on W."""
    xh = _halo_rows(x.permute(0, 2, 3, 1), group).permute(0, 3, 1, 2)
    return F.conv2d(xh, weight.to(x.dtype), padding=(0, 1))


def _group_norm(x: torch.Tensor, scale, bias, group) -> torch.Tensor:
    """GroupNorm of an NCHW (channels_last) shard with statistics over
    the whole image (``cl_tpu``'s ``_group_norm``)."""
    B, C, h, W = x.shape
    G = min(8, C)
    g = x.permute(0, 2, 3, 1).reshape(B, h * W, G, C // G)
    g = g.to(torch.promote_types(x.dtype, torch.float32))
    s = all_reduce_sum(torch.stack([g.sum((1, 3)), (g * g).sum((1, 3))]), group)
    n = h * W * (C // G) * _world(group)[0]
    mean = s[0] / n
    var = s[1] / n - mean * mean
    out = (g - mean[:, None, :, None]) * torch.rsqrt(var + GN_EPS)[:, None, :, None]
    out = out.reshape(B, h, W, C) * scale + bias
    return out.to(x.dtype).permute(0, 3, 1, 2)


def _double_conv(x: torch.Tensor, dc, group) -> torch.Tensor:
    for conv, gn in ((dc.conv0, dc.gn0), (dc.conv1, dc.gn1)):
        x = F.relu(_group_norm(_conv3x3(x, conv.weight, group), gn.weight, gn.bias, group))
    return x


def spatial_apply(model, x: torch.Tensor, group=None, dtype=None) -> torch.Tensor:
    """The UNet forward of ``model`` (the port's GroupNorm ``UNet``) on this
    rank's rows of ``x`` (NHWC [B, H, W, 3], the whole replicated batch):
    f32 logits [B, H/n, W, num_classes] of rows ``[r·H/n, (r+1)·H/n)``.
    ``group``: a ``sharding.SpatialParallel`` (None: one rank). ``dtype``:
    the compute dtype (None: the model's); params are cast per op."""
    if model.norm != "group":
        raise ValueError(f"the spatial forward needs model.norm='group', not {model.norm!r} "
                         "(BatchNorm's batch statistics are not sharded spatially)")
    n, r = _world(group)
    H = x.shape[1]
    if H % (n << model.depth):  # every level's shard height stays even
        raise ValueError(f"H={H} must divide by n*2^depth={n << model.depth}")
    rows = H // n
    h = x.to(dtype or model.dtype)[:, r * rows:(r + 1) * rows].contiguous().permute(0, 3, 1, 2)
    skips = []
    for level in range(model.depth):
        h = _double_conv(h, getattr(model, f"enc{level}"), group)
        skips.append(h)
        h = F.max_pool2d(h, 2, 2)
    h = _double_conv(h, model.bottleneck, group)
    for level in reversed(range(model.depth)):
        up = getattr(model, f"up{level}")
        h = F.conv_transpose2d(h, up.weight.to(h.dtype), stride=2) \
            + up.bias.to(h.dtype)[:, None, None]
        h = torch.cat([skips[level], h], dim=1)
        h = _double_conv(h, getattr(model, f"dec{level}"), group)
    head = model.head
    logits = (F.conv2d(h, head.weight.to(h.dtype)) + head.bias.to(h.dtype)[:, None, None])
    logits = logits.float().permute(0, 2, 3, 1)
    pad = model.num_classes - logits.shape[-1]
    return F.pad(logits, (0, pad), value=NEG_INF) if pad > 0 else logits
