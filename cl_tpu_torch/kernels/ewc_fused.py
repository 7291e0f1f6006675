"""EWC's penalty, its gradient and the Fisher accumulation over the flat
parameter vector (``csrc/ewc.cu``).

The counterpart of ``cl_tpu.pallas.ewc_fused``: ``penalty_flat`` is
Σ F(θ−θ*)² over flat f32 vectors (kernel #17) as an autograd Function
whose backward is (2g·F)·(θ−θ*) (#18, the cotangent g read from device
memory); ``sq_accumulate`` is the Fisher pass's acc += g², in place, f32
(#19). ``penalty`` is ``cl_tpu``'s (1/2)·weight·Σ over the stored tasks,
one #17 per task in ``separate`` mode. The vectors are not padded to a
chunk multiple: that was a VMEM device of the TPU kernel, not the function.

On a CUDA tensor each wrapper launches its kernel, on a CPU tensor it runs
the plain PyTorch version beside it (``penalty_plain``, ``grad_plain``,
``sq_acc_plain``); nothing falls back from one to the other. ``LAUNCHES``
counts the kernel launches.
"""

from __future__ import annotations

import torch

from cl_tpu_torch.kernels import build

# Most blocks of the penalty's first pass: the length of its partials
# buffer (the grid is a function of n alone, so the sum runs in one order).
N_BLOCKS = 1024

LAUNCHES = {"ewc_penalty": 0, "ewc_grad": 0, "ewc_sq_acc": 0}


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def penalty_plain(theta, anchor, fisher):
    """Σ F (θ−θ*)² (f32 scalar)."""
    d = theta - anchor
    return (fisher * d * d).sum()


def grad_plain(theta, anchor, fisher, g):
    """dθ of g · Σ F (θ−θ*)²: (2g·F)·(θ−θ*), the TPU kernel's order."""
    return (2.0 * g) * fisher * (theta - anchor)


def sq_acc_plain(acc, g):
    """acc += g², in place (f32)."""
    return acc.add_(g * g)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def _check(what, *vecs):
    n = vecs[0].shape[0]
    for v in vecs:
        if v.dtype != torch.float32 or v.dim() != 1 or v.shape[0] != n \
                or not v.is_contiguous() or v.device != vecs[0].device:
            raise ValueError(f"{what}: contiguous f32 vectors of one length on one "
                             f"device expected, got {v.dtype} {tuple(v.shape)} on {v.device}")
    # 16-byte loads only where every vector allows them (a row of a [T, n]
    # state at odd n does not); the scalar path takes any n
    vec = int(all(v.data_ptr() % 16 == 0 for v in vecs))
    return n, vec


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_penalty(theta, anchor, fisher):
    n, vec = _check("ewc penalty kernel", theta, anchor, fisher)
    partials = torch.empty(N_BLOCKS, dtype=torch.float32, device=theta.device)
    out = torch.empty((), dtype=torch.float32, device=theta.device)
    err = build.library().cltorch_ewc_penalty(
        theta.data_ptr(), anchor.data_ptr(), fisher.data_ptr(), n, vec, partials.data_ptr(),
        out.data_ptr(), N_BLOCKS, _stream(theta))
    build.check(err, "ewc_penalty")
    return out


def launch_grad(theta, anchor, fisher, g):
    n, vec = _check("ewc grad kernel", theta, anchor, fisher)
    g = g.to(device=theta.device, dtype=torch.float32).contiguous()
    if g.numel() != 1:
        raise ValueError(f"ewc grad kernel: a scalar cotangent expected, got {tuple(g.shape)}")
    out = torch.empty_like(theta)
    err = build.library().cltorch_ewc_grad(
        theta.data_ptr(), anchor.data_ptr(), fisher.data_ptr(), g.data_ptr(), out.data_ptr(),
        n, vec, _stream(theta))
    build.check(err, "ewc_grad")
    return out


def launch_sq_acc(acc, g):
    n, vec = _check("ewc sq_accumulate kernel", acc, g)
    err = build.library().cltorch_ewc_sq_acc(acc.data_ptr(), g.data_ptr(), n, vec, _stream(acc))
    build.check(err, "ewc_sq_acc")
    return acc


# ---------------------------------------------------------------------------
# autograd wrapper and public entries
# ---------------------------------------------------------------------------


class _PenaltyFlat(torch.autograd.Function):
    """Σ F(θ−θ*)²; the anchor and Fisher are frozen state, so only θ gets
    a gradient."""

    @staticmethod
    def forward(ctx, theta, anchor, fisher):
        ctx.save_for_backward(theta, anchor, fisher)
        if theta.is_cuda:
            LAUNCHES["ewc_penalty"] += 1
            return launch_penalty(theta, anchor, fisher)
        return penalty_plain(theta, anchor, fisher)

    @staticmethod
    def backward(ctx, g):
        theta, anchor, fisher = ctx.saved_tensors
        if theta.is_cuda:
            LAUNCHES["ewc_grad"] += 1
            return launch_grad(theta, anchor, fisher, g), None, None
        return grad_plain(theta, anchor, fisher, g), None, None


def penalty_flat(theta, anchor, fisher):
    """Σ F(θ−θ*)² over flat f32 vectors [n] (differentiable in θ)."""
    return _PenaltyFlat.apply(theta, anchor, fisher)


def penalty(theta, state, *, mode: str):
    """(1/2)·weight·Σ F(θ−θ*)², summed over the stored tasks in
    ``separate`` mode (one #17 per task, ``ewc_fused.py:119-135``).
    ``theta``: ``methods.ewc.flat_params(model)``; ``state``: an
    ``EWCState``. Exactly 0 before the first consolidation (weight 0)."""
    if mode == "online":
        total = penalty_flat(theta, state.anchor, state.fisher)
    elif mode == "separate":
        total = penalty_flat(theta, state.anchor[0], state.fisher[0])
        for t in range(1, state.anchor.shape[0]):
            total = total + penalty_flat(theta, state.anchor[t], state.fisher[t])
    else:
        raise ValueError(f"unknown ewc mode {mode!r}")
    return 0.5 * state.weight * total


def sq_accumulate(acc, g):
    """acc += g² in place over flat f32 vectors [n]; returns acc."""
    if acc.is_cuda:
        LAUNCHES["ewc_sq_acc"] += 1
        return launch_sq_acc(acc, g)
    return sq_acc_plain(acc, g)
