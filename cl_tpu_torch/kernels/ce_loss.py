"""Masked softmax cross-entropy on materialized logits (``csrc/ce_loss.cu``).

The counterpart of ``cl_tpu.pallas.ce_loss.cross_entropy``: one pass per
pixel for mask → logsumexp → label pick → ignore mask → sum, and the
closed-form backward (softmax − onehot)·pix·valid/n as a second kernel,
written in the logits dtype. Pixel-major: logits [P, C] as they lie in
memory (the TPU kernel's class-major transpose is not carried over).

``cross_entropy`` runs the CUDA kernels on a CUDA tensor and the plain
PyTorch version (``ce_total_plain`` / ``ce_grad_plain``) on a CPU tensor;
nothing falls back from one to the other. ``LAUNCHES`` counts the kernel
launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cl_tpu_torch.kernels import build
from cl_tpu_torch.losses import NEG_INF
from cl_tpu_torch.sharding import pixel_count

MAX_CLASSES = 32
# Most blocks a launch uses, fixed so the sums run in the same order on
# every card; the length of the forward's partials buffer.
N_BLOCKS = 1024

LAUNCHES = {"ce_fwd": 0, "ce_bwd": 0}


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _masked(z, valid):
    return torch.where(valid > 0, z.float(), NEG_INF)


def ce_total_plain(z, labels, valid, ignore_index=255):
    """Σ over pixels of the masked softmax NLL (f32 scalar). z: [P, C]."""
    zm = _masked(z, valid)
    logz = torch.logsumexp(zm, dim=1)
    pix = labels != ignore_index
    lbl0 = torch.where(pix, labels, 0).long()
    picked = torch.where(F.one_hot(lbl0, zm.shape[1]).bool(), zm, 0.0).sum(1)
    return ((logz - picked) * pix).sum()


def ce_grad_plain(z, labels, valid, scale, ignore_index=255):
    """dz of scale · total, in z's dtype."""
    p = torch.softmax(_masked(z, valid), dim=1)
    pix = (labels != ignore_index).float()
    lbl0 = torch.where(labels != ignore_index, labels, 0).long()
    g = (scale * pix)[:, None] * (p - F.one_hot(lbl0, z.shape[1]).float())
    return torch.where(valid > 0, g, 0.0).to(z.dtype)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def _check_operands(z, labels, valid):
    P, C = z.shape
    if z.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ce kernel: logits must be f32 or bf16, got {z.dtype}")
    if C > MAX_CLASSES:
        raise ValueError(f"ce kernel takes C <= {MAX_CLASSES}, got {C}")
    if not z.is_contiguous():
        raise ValueError("ce kernel needs contiguous logits")
    for t, dt in ((labels, torch.int32), (valid, torch.float32)):
        if t.dtype != dt or not t.is_contiguous() or t.device != z.device:
            raise ValueError(f"ce kernel operand must be contiguous {dt} on {z.device}")
    return P, C


def launch_fwd(z, labels, valid, ignore_index=255):
    """Kernel forward: Σ masked NLL as a 0-d f32 tensor on z's device."""
    P, C = _check_operands(z, labels, valid)
    partials = torch.empty(N_BLOCKS, dtype=torch.float32, device=z.device)
    out = torch.empty((), dtype=torch.float32, device=z.device)
    err = build.library().cltorch_ce_fwd(
        z.data_ptr(), labels.data_ptr(), valid.data_ptr(), partials.data_ptr(),
        out.data_ptr(), P, C, int(ignore_index), int(z.dtype == torch.bfloat16),
        N_BLOCKS, torch.cuda.current_stream(z.device).cuda_stream)
    build.check(err, "ce_fwd")
    return out


def launch_bwd(z, labels, valid, scale, ignore_index=255):
    """Kernel backward: dz in z's dtype; ``scale`` is a 0-d f32 device tensor."""
    P, C = _check_operands(z, labels, valid)
    dz = torch.empty_like(z)
    scale = scale.to(torch.float32).contiguous()
    err = build.library().cltorch_ce_bwd(
        z.data_ptr(), labels.data_ptr(), valid.data_ptr(), scale.data_ptr(),
        dz.data_ptr(), P, C, int(ignore_index), int(z.dtype == torch.bfloat16),
        N_BLOCKS, torch.cuda.current_stream(z.device).cuda_stream)
    build.check(err, "ce_bwd")
    return dz


# ---------------------------------------------------------------------------
# autograd wrapper and public entry
# ---------------------------------------------------------------------------


class _CETotal(torch.autograd.Function):
    """UNNORMALIZED Σ NLL; the 1/n mean is applied outside, so the backward
    receives scale = 1/n as its incoming gradient."""

    @staticmethod
    def forward(ctx, z, labels, valid, ignore_index):
        ctx.save_for_backward(z, labels, valid)
        ctx.ignore_index = ignore_index
        if z.is_cuda:
            LAUNCHES["ce_fwd"] += 1
            return launch_fwd(z, labels, valid, ignore_index)
        return ce_total_plain(z, labels, valid, ignore_index)

    @staticmethod
    def backward(ctx, g):
        z, labels, valid = ctx.saved_tensors
        if z.is_cuda:
            LAUNCHES["ce_bwd"] += 1
            dz = launch_bwd(z, labels, valid, g, ctx.ignore_index)
        else:
            dz = ce_grad_plain(z, labels, valid, g, ctx.ignore_index)
        return dz, None, None, None


def cross_entropy(logits, labels, valid_classes, *, ignore_index=255, dp=None):
    """Kernel variant of ``cl_tpu_torch.losses.cross_entropy``: (mean NLL over
    non-ignored pixels, n_valid_pixels). ``logits`` [B, H, W, C] in f32 or
    bf16 (kept in its dtype: the kernel upcasts in registers). With ``dp``
    (``cl_tpu``'s ``cross_entropy_sharded``) n is the global batch's and
    the mean is this rank's share: its own total over that n."""
    C = logits.shape[-1]
    z = logits.reshape(-1, C)
    if not z.is_contiguous():
        z = z.contiguous()
    lbl = labels.reshape(-1).to(torch.int32)
    valid = valid_classes.to(device=z.device, dtype=torch.float32)
    n = pixel_count(labels, ignore_index, dp)
    total = _CETotal.apply(z, lbl, valid, int(ignore_index))
    return total / n, n
