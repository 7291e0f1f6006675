"""Fused 1×1-head + masked softmax cross-entropy (``csrc/head_ce.cu``).

The counterpart of ``cl_tpu.pallas.head_ce.head_cross_entropy``: the
train loss computes the head's logits per pixel inside the kernel, so the
[B, H, W, C] logits never reach device memory, and the backward recomputes
them and emits dx, dW and db in one pass. Pixel-major: features [P, Cin]
and labels [P] as they lie in memory (the TPU kernel's class-major
transpose is a TPU layout device and is not carried over).

``head_cross_entropy`` runs the CUDA kernels on a CUDA tensor and the
plain PyTorch version (``head_ce_total_plain`` / ``head_ce_grads_plain``,
the same arithmetic) on a CPU tensor; nothing falls back from one to the
other. ``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cl_tpu_torch.kernels import build
from cl_tpu_torch.losses import NEG_INF

MAX_CLASSES = 32
MAX_CIN = 64
# Most blocks a launch uses, fixed (not the card's SM count) so the sums
# run in the same order on every card; the rows of the partials buffer.
N_BLOCKS = 1024

LAUNCHES = {"head_ce_fwd": 0, "head_ce_bwd": 0}


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path, and the kernel's yardstick on the card)
# ---------------------------------------------------------------------------


def _logits_plain(x, w, b, valid):
    """[P, C] f32 masked logits: x · round(W)ᵀ + b with f32 accumulation."""
    wr = w.to(x.dtype).float()
    z = x.float() @ wr.T + b
    return torch.where(valid > 0, z, NEG_INF)


def head_ce_total_plain(x, w, b, labels, valid, ignore_index=255):
    """Σ over pixels of the masked softmax NLL (f32 scalar)."""
    z = _logits_plain(x, w, b, valid)
    logz = torch.logsumexp(z, dim=1)
    pix = labels != ignore_index
    lbl0 = torch.where(pix, labels, 0).long()
    picked = torch.where(F.one_hot(lbl0, z.shape[1]).bool(), z, 0.0).sum(1)
    return ((logz - picked) * pix).sum()


def head_ce_grads_plain(x, w, b, labels, valid, scale, ignore_index=255):
    """(dx in x's dtype, dW f32 [C, Cin], db f32 [C]) of scale · total."""
    z = _logits_plain(x, w, b, valid)
    p = torch.softmax(z, dim=1)
    pix = (labels != ignore_index).float()
    lbl0 = torch.where(labels != ignore_index, labels, 0).long()
    onehot = F.one_hot(lbl0, z.shape[1]).float()
    g = (scale * pix)[:, None] * (p - onehot)
    g = torch.where(valid > 0, g, 0.0)
    gc = g.to(x.dtype).float()
    dx = (gc @ w.to(x.dtype).float()).to(x.dtype)
    dw = gc.T @ x.float()
    db = g.sum(0)
    return dx, dw, db


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def _check_operands(x, w, labels, valid):
    P, cin = x.shape
    C = w.shape[0]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"head_ce kernel: features must be f32 or bf16, got {x.dtype}")
    if C > MAX_CLASSES or cin > MAX_CIN:
        raise ValueError(f"head_ce kernel takes C <= {MAX_CLASSES} and Cin <= "
                         f"{MAX_CIN}, got C={C} Cin={cin}")
    if (cin * x.element_size()) % 16:
        raise ValueError(f"head_ce kernel needs Cin*itemsize % 16 == 0, got Cin={cin}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("head_ce kernel needs contiguous 16-byte-aligned features")
    for t, dt in ((w, torch.float32), (labels, torch.int32), (valid, torch.float32)):
        if t.dtype != dt or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"head_ce kernel operand must be contiguous {dt} on {x.device}")
    return P, cin, C


def launch_fwd(x, w, b, labels, valid, ignore_index=255):
    """Kernel forward: Σ masked NLL as a 0-d f32 tensor on x's device."""
    P, cin, C = _check_operands(x, w, labels, valid)
    partials = torch.empty(N_BLOCKS, dtype=torch.float32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    err = build.library().cltorch_head_ce_fwd(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
        valid.data_ptr(), partials.data_ptr(), out.data_ptr(), P, cin, C,
        int(ignore_index), int(x.dtype == torch.bfloat16), N_BLOCKS,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "head_ce_fwd")
    return out


def launch_bwd(x, w, b, labels, valid, scale, ignore_index=255):
    """Kernel backward: (dx, dW, db); ``scale`` is a 0-d f32 device tensor."""
    P, cin, C = _check_operands(x, w, labels, valid)
    dx = torch.empty_like(x)
    partials = torch.empty(N_BLOCKS, C * (cin + 1), dtype=torch.float32,
                           device=x.device)
    dwb = torch.empty(C, cin + 1, dtype=torch.float32, device=x.device)
    scale = scale.to(torch.float32).contiguous()
    err = build.library().cltorch_head_ce_bwd(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
        valid.data_ptr(), scale.data_ptr(), dx.data_ptr(), partials.data_ptr(),
        dwb.data_ptr(), P, cin, C, int(ignore_index),
        int(x.dtype == torch.bfloat16), N_BLOCKS,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "head_ce_bwd")
    return dx, dwb[:, :cin], dwb[:, cin]


# ---------------------------------------------------------------------------
# autograd wrapper and public entry
# ---------------------------------------------------------------------------


class _HeadCETotal(torch.autograd.Function):
    """UNNORMALIZED Σ NLL of softmax(x·Wᵀ + b); the 1/n is applied outside,
    so the backward receives scale = 1/n as its incoming gradient."""

    @staticmethod
    def forward(ctx, x, w, b, labels, valid, ignore_index):
        ctx.save_for_backward(x, w, b, labels, valid)
        ctx.ignore_index = ignore_index
        if x.is_cuda:
            LAUNCHES["head_ce_fwd"] += 1
            return launch_fwd(x, w, b, labels, valid, ignore_index)
        return head_ce_total_plain(x, w, b, labels, valid, ignore_index)

    @staticmethod
    def backward(ctx, g):
        x, w, b, labels, valid = ctx.saved_tensors
        if x.is_cuda:
            LAUNCHES["head_ce_bwd"] += 1
            dx, dw, db = launch_bwd(x, w, b, labels, valid, g, ctx.ignore_index)
        else:
            dx, dw, db = head_ce_grads_plain(x, w, b, labels, valid, g,
                                             ctx.ignore_index)
        return dx, dw, db, None, None, None


def head_cross_entropy(features, head_kernel, head_bias, labels,
                       valid_classes, *, ignore_index=255):
    """Fused head+CE: (mean NLL over non-ignored pixels, n_valid_pixels).

    ``features`` are the pre-head activations [B, H, W, Cin] in the compute
    dtype; ``head_kernel`` the port's 1×1 head weight [width, Cin, 1, 1]
    (or [width, Cin]) and ``head_bias`` [width], f32; ``labels`` [B, H, W]
    int; ``valid_classes`` bool [C]. A head narrower than C is zero-padded
    to C (its dW/db come back at its own width), as in the JAX package."""
    cin = features.shape[-1]
    C = valid_classes.shape[0]
    w = head_kernel.reshape(head_kernel.shape[0], cin)
    width = w.shape[0]
    b = head_bias
    if width != C:
        w = F.pad(w, (0, 0, 0, C - width))
        b = F.pad(b, (0, C - width))
    x = features.reshape(-1, cin)
    if not x.is_contiguous():
        x = x.contiguous()
    lbl = labels.reshape(-1).to(torch.int32)
    valid = valid_classes.to(device=x.device, dtype=torch.float32)
    pix = labels != ignore_index
    n = pix.sum().float().clamp_min(1.0)
    total = _HeadCETotal.apply(x, w.contiguous(), b.contiguous(), lbl, valid,
                               int(ignore_index))
    return total / n, n
