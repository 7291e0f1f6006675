"""LwF distillation on materialized logits (``csrc/kd_loss.cu``).

The counterpart of ``cl_tpu.pallas.kd_loss.kd_loss``: one pass over the
student's and the frozen teacher's logits for scale by 1/T → mask to the
old classes → two log-softmaxes → KL → ignore mask → sum, and the closed
form backward (g/T)·pix·(p_new − p_old) as a second kernel, written in the
logits' dtype; the teacher's logits get no gradient. Pixel-major: logits
[P, C] as they lie in memory (the TPU kernel's class-major transpose is a
TPU layout device and is not carried over).

The arithmetic is ``kd_loss.py``'s, not ``losses.kd_loss``'s: the logits
are multiplied by 1/T in f32 and then masked, where ``losses`` masks and
then divides by T; the two agree bit for bit only where 1/T is exact.

``kd_loss`` runs the CUDA kernels on a CUDA tensor and the plain PyTorch
version (``kd_total_plain`` / ``kd_grad_plain``) on a CPU tensor; nothing
falls back from one to the other. ``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from cl_tpu_torch.kernels import build
from cl_tpu_torch.losses import NEG_INF
from cl_tpu_torch.sharding import pixel_count

MAX_CLASSES = 32
# Most blocks a launch uses, fixed so the sums run in the same order on
# every card; the length of the forward's partials buffer.
N_BLOCKS = 1024

LAUNCHES = {"kd_fwd": 0, "kd_bwd": 0}


def _inv_t(temperature: float) -> float:
    """1/T rounded to f32, as ``kd_loss.py:_prep`` hands it to the kernel."""
    return float(np.float32(1.0 / temperature))


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _log_probs(z, old_valid, temperature):
    """log_softmax of z·(1/T) masked to the old classes, f32 [P, C]."""
    zm = torch.where(old_valid > 0, z.float() * _inv_t(temperature), NEG_INF)
    return torch.log_softmax(zm, dim=1)


def kd_total_plain(new, old, old_valid, labels, temperature, ignore_index=255):
    """Σ over non-ignored pixels of KL(softmax(old/T) ‖ softmax(new/T)) over
    the old classes (f32 scalar); new, old: [P, C]."""
    ls_new = _log_probs(new, old_valid, temperature)
    ls_old = _log_probs(old, old_valid, temperature)
    kl = (ls_old.exp() * (ls_old - ls_new)).sum(1)
    return (kl * (labels != ignore_index)).sum()


def kd_grad_plain(new, old, old_valid, labels, scale, temperature, ignore_index=255):
    """d(g · total)/d new with ``scale`` = g/T: scale·pix·(p_new − p_old) on
    the old classes, 0 elsewhere, in new's dtype."""
    p_new = _log_probs(new, old_valid, temperature).exp()
    p_old = _log_probs(old, old_valid, temperature).exp()
    pix = (labels != ignore_index).float()
    g = (scale * pix)[:, None] * (p_new - p_old)
    return torch.where(old_valid > 0, g, 0.0).to(new.dtype)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def _check_operands(new, old, labels, old_valid):
    P, C = new.shape
    if new.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kd kernel: logits must be f32 or bf16, got {new.dtype}")
    if C > MAX_CLASSES:
        raise ValueError(f"kd kernel takes C <= {MAX_CLASSES}, got {C}")
    if old.shape != new.shape or old.dtype != new.dtype or old.device != new.device:
        raise ValueError("kd kernel: the teacher's logits must match the student's in "
                         "shape, dtype and device")
    if not new.is_contiguous() or not old.is_contiguous():
        raise ValueError("kd kernel needs contiguous logits")
    for t, dt in ((labels, torch.int32), (old_valid, torch.float32)):
        if t.dtype != dt or not t.is_contiguous() or t.device != new.device:
            raise ValueError(f"kd kernel operand must be contiguous {dt} on {new.device}")
    return P, C


def launch_fwd(new, old, old_valid, labels, temperature, ignore_index=255):
    """Kernel #13: the KL total as a 0-d f32 tensor on new's device."""
    P, C = _check_operands(new, old, labels, old_valid)
    partials = torch.empty(N_BLOCKS, dtype=torch.float32, device=new.device)
    out = torch.empty((), dtype=torch.float32, device=new.device)
    err = build.library().cltorch_kd_fwd(
        new.data_ptr(), old.data_ptr(), labels.data_ptr(), old_valid.data_ptr(),
        partials.data_ptr(), out.data_ptr(), P, C, int(ignore_index),
        int(new.dtype == torch.bfloat16), _inv_t(temperature), N_BLOCKS,
        torch.cuda.current_stream(new.device).cuda_stream)
    build.check(err, "kd_fwd")
    return out


def launch_bwd(new, old, old_valid, labels, scale, temperature, ignore_index=255):
    """Kernel #14: d new in new's dtype; ``scale`` = g/T, a 0-d f32 device
    tensor."""
    P, C = _check_operands(new, old, labels, old_valid)
    dnew = torch.empty_like(new)
    scale = scale.to(torch.float32).contiguous()
    err = build.library().cltorch_kd_bwd(
        new.data_ptr(), old.data_ptr(), labels.data_ptr(), old_valid.data_ptr(),
        scale.data_ptr(), dnew.data_ptr(), P, C, int(ignore_index),
        int(new.dtype == torch.bfloat16), _inv_t(temperature), N_BLOCKS,
        torch.cuda.current_stream(new.device).cuda_stream)
    build.check(err, "kd_bwd")
    return dnew


# ---------------------------------------------------------------------------
# autograd wrapper and public entry
# ---------------------------------------------------------------------------


class _KdTotal(torch.autograd.Function):
    """UNNORMALIZED Σ per-pixel KL; T²/n is applied outside, so the backward
    receives their product as its incoming gradient. The teacher's logits
    get no gradient."""

    @staticmethod
    def forward(ctx, new, old, old_valid, labels, temperature, ignore_index):
        ctx.save_for_backward(new, old, old_valid, labels)
        ctx.temperature, ctx.ignore_index = temperature, ignore_index
        if new.is_cuda:
            LAUNCHES["kd_fwd"] += 1
            return launch_fwd(new, old, old_valid, labels, temperature, ignore_index)
        return kd_total_plain(new, old, old_valid, labels, temperature, ignore_index)

    @staticmethod
    def backward(ctx, g):
        new, old, old_valid, labels = ctx.saved_tensors
        scale = g.float() / ctx.temperature
        if new.is_cuda:
            LAUNCHES["kd_bwd"] += 1
            dnew = launch_bwd(new, old, old_valid, labels, scale, ctx.temperature,
                              ctx.ignore_index)
        else:
            dnew = kd_grad_plain(new, old, old_valid, labels, scale, ctx.temperature,
                                 ctx.ignore_index)
        return dnew, None, None, None, None, None


def _rows(logits):
    z = logits.reshape(-1, logits.shape[-1])
    return z if z.is_contiguous() else z.contiguous()


def kd_loss(new_logits, old_logits, old_valid, labels, *, temperature, ignore_index=255,
            dp=None):
    """T²·KL(softmax(old/T) ‖ softmax(new/T)) averaged over non-ignored
    pixels, over the classes ``old_valid`` (bool [C]) marks: the kernel
    variant of ``losses.kd_loss`` (``cl_tpu.pallas.kd_loss.kd_loss``).
    ``new_logits`` and ``old_logits`` [B, H, W, C] of one dtype, f32 or
    bf16 (kept in it: the kernels upcast in registers); the gradient of
    ``new_logits`` comes back in its dtype, the teacher's is none. With
    ``dp`` (``cl_tpu``'s ``kd_loss_sharded``) the mean is this rank's
    share: its own total over the global pixel count."""
    t = float(temperature)
    new = _rows(new_logits)
    old = _rows(old_logits.detach())
    lbl = labels.reshape(-1).to(torch.int32)
    ov = old_valid.to(device=new.device, dtype=torch.float32)
    n = pixel_count(labels, ignore_index, dp)
    total = _KdTotal.apply(new, old, ov, lbl, t, int(ignore_index))
    return t * t * total / n
