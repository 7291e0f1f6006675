"""Fused 1×1-head + masked softmax cross-entropy (``csrc/head_ce.cu``), its
form with the LwF distillation term of a frozen teacher on the same NHWC
features (``csrc/head_ce_kd.cu``), its packed form without a prologue
(``csrc/head_ce_pk.cu``), and its forms on the packed body's raw output
with the BN·ReLU prologue, alone (``csrc/head_ce_bn.cu``) and with the LwF
term (``csrc/head_ce_kd_bn.cu``; the last four from
``csrc/head_ce_bn.cuh``).

The counterparts of ``cl_tpu.pallas.head_ce.head_cross_entropy``,
``head_cross_entropy_kd``, ``head_cross_entropy_packed``,
``head_cross_entropy_packed_bn`` and ``head_cross_entropy_kd_packed_bn``:
the train loss computes the head's logits per pixel inside the kernel, so
the [B, H, W, C] logits (the teacher's too) never reach device memory, and
the backward recomputes them and emits every gradient in one pass.
Pixel-major: features [P, Cin] and labels [P] as they lie in memory (the
TPU kernels' lane packing and class-major transpose are TPU layout devices
and are not carried over: the packed forms take the NHWC raw output).

Each entry runs the CUDA kernels on a CUDA tensor and the plain PyTorch
version (``*_plain``, the same arithmetic) on a CPU tensor; nothing falls
back from one to the other. ``LAUNCHES`` counts the kernel launches. The
bf16 forward and backward of the packed head (#7, #8) run
``csrc/head_ce_bn_mma.cuh`` on the tensor cores over persistent grids the
wrapper picks from the shapes (``bn_fwd_blocks``, ``bn_bwd_blocks``).

Each entry's ``dp`` (a ``sharding.DataParallel``) gives its sharded form,
``cl_tpu``'s ``*_sharded``: the rank's kernel sums its own pixels and the
count n is the global batch's, so the returned means are the rank's
shares, its totals over the global n; the group's shares sum to the
global means, and so do their gradients.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from cl_tpu_torch import losses
from cl_tpu_torch.kernels import (SMEM_PER_SM, SMEM_RESERVED_PER_BLOCK, build,
                                  one_wave_splits, resident_blocks)
from cl_tpu_torch.kernels.packed_eltwise import bn_relu_bwd_plain, bn_relu_plain
from cl_tpu_torch.losses import NEG_INF
from cl_tpu_torch.sharding import pixel_count

MAX_CLASSES = 32
MAX_CIN = 64
# Most blocks a launch uses, fixed (not the card's SM count) so the sums
# run in the same order on every card; the rows of the partials buffer.
N_BLOCKS = 1024

# The bf16 #7 and #8 on the tensor cores (csrc/head_ce_bn_mma.cuh): #8's
# tiles of BN_BWD_TILE pixels (8 warps of 16 rows), a ring of
# BN_BWD_STAGES tiles; #7's ring of at most BN_FWD_MAX_STAGES tiles,
# BN_FWD_MIN_BLOCKS blocks an SM.
BN_BWD_TILE = 128
BN_BWD_THREADS = 256
BN_BWD_STAGES = 3
BN_FWD_MAX_STAGES = 6
BN_FWD_MIN_BLOCKS = 3


def bn_bwd_tile(cin, C):
    """(CIN16, CMAX): the bf16 #7 / #8 instance for Cin channels (rounded
    up to 16) and C classes (16 or 32)."""
    return -(-cin // 16) * 16, 16 if C <= 16 else 32


def bn_bwd_resources(cin16, cmax):
    """(threads, dynamic shared bytes, resident blocks an SM) of a #8
    instance, as ``HbLayout`` sizes it: the ring of y tiles [128][CIN16 +
    8] bf16 and their labels, W [CMAX][CIN16 + 8] bf16, eight g tiles
    [16][CMAX + 8] bf16, the f32 vectors; as ``__launch_bounds__`` fits
    the registers, three blocks an SM of the (16, 16) instance, two up to
    32 channels, one else, fewer if the shared memory says so."""
    row_y = cin16 + 8
    smem = (BN_BWD_STAGES * BN_BWD_TILE * (row_y * 2 + 4) + cmax * row_y * 2
            + 8 * 16 * (cmax + 8) * 2 + (2 * cin16 + 2 * cmax) * 4)
    min_blocks = 3 if (cin16, cmax) == (16, 16) else 2 if cin16 <= 32 else 1
    return BN_BWD_THREADS, smem, resident_blocks(smem, min_blocks)


@functools.lru_cache(maxsize=None)
def bn_bwd_blocks(P, cin, C):
    """Persistent blocks of the bf16 #8 (the rows of its partials): one
    wave of resident blocks over the 128-pixel tiles, each the same number
    of tiles. A function of the shapes alone, so the partial sums run in
    the same order on every call."""
    return one_wave_splits(-(-P // BN_BWD_TILE), 1,
                           bn_bwd_resources(*bn_bwd_tile(cin, C))[2])


def bn_fwd_tile(cin16):
    """Pixels a stage of #7's ring (``HfLayout::kTile``): 256 up to 32
    channels (two slabs of 16 rows a warp), else 128."""
    return 2 * BN_BWD_TILE if cin16 <= 32 else BN_BWD_TILE


def bn_fwd_resources(cin16, cmax):
    """(threads, dynamic shared bytes, resident blocks an SM) of a #7
    instance, as ``HfLayout`` sizes it: three blocks an SM
    (``__launch_bounds__``), each asking for a third of the SM's shared
    memory, so that exactly three are resident; its ring takes as many
    stages of that share as fit (``bn_fwd_stages``)."""
    smem = SMEM_PER_SM // BN_FWD_MIN_BLOCKS - SMEM_RESERVED_PER_BLOCK
    return BN_BWD_THREADS, smem, resident_blocks(smem, BN_FWD_MIN_BLOCKS)


def bn_fwd_stages(cin16, cmax):
    """Stages of #7's ring (``HfLayout::kStages``): as many y tiles
    [``bn_fwd_tile``][CIN16 + 8] bf16 and their labels as fit the block's
    share beside W [CMAX][CIN16 + 8] bf16, the f32 vectors and the eight
    warps' sums, at most BN_FWD_MAX_STAGES."""
    row_y, tile = cin16 + 8, bn_fwd_tile(cin16)
    fixed = cmax * row_y * 2 + (2 * cin16 + 2 * cmax) * 4 + BN_BWD_THREADS // 32 * 4
    stage = tile * (row_y * 2 + 4)
    return min(BN_FWD_MAX_STAGES, (bn_fwd_resources(cin16, cmax)[1] - fixed) // stage)


@functools.lru_cache(maxsize=None)
def bn_fwd_blocks(P, cin, C):
    """Persistent blocks of the bf16 #7 (the rows of its partials): one
    wave of resident blocks over its pixel tiles, each the same number of
    tiles, as ``bn_bwd_blocks``."""
    cin16, cmax = bn_bwd_tile(cin, C)
    return one_wave_splits(-(-P // bn_fwd_tile(cin16)), 1, bn_fwd_resources(cin16, cmax)[2])


def bn_fwd_partials_rows(P, cin, C, bf16, kd=False, prologue=True):
    """The rows of the partials the forward's wrapper allocates (and the
    blocks it passes to the C entry): the bf16 #7's schedule, else
    N_BLOCKS (the launch takes at most that many)."""
    return bn_fwd_blocks(P, cin, C) if bf16 and prologue and not kd else N_BLOCKS


def bn_bwd_partials_rows(P, cin, C, bf16, kd=False, prologue=True):
    """The rows of the partials the backward's wrapper allocates (and the
    blocks it passes to the C entry): the bf16 #8's schedule, else
    N_BLOCKS (the launch takes at most that many)."""
    return bn_bwd_blocks(P, cin, C) if bf16 and prologue and not kd else N_BLOCKS


LAUNCHES = {"head_ce_fwd": 0, "head_ce_bwd": 0, "head_ce_kd_fwd": 0, "head_ce_kd_bwd": 0,
            "head_ce_bn_fwd": 0, "head_ce_bn_bwd": 0, "head_ce_kd_bn_fwd": 0,
            "head_ce_kd_bn_bwd": 0, "head_ce_pk_fwd": 0, "head_ce_pk_bwd": 0}


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path, and the kernel's yardstick on the card)
# ---------------------------------------------------------------------------


def _logits_plain(x, w, b, valid):
    """[P, C] f32 logits x · round(W)ᵀ + b with f32 accumulation, masked
    to ``valid`` unless it is None."""
    wr = w.to(x.dtype).float()
    z = x.float() @ wr.T + b
    return z if valid is None else torch.where(valid > 0, z, NEG_INF)


def _nll_total(z, labels, ignore_index):
    """Σ over non-ignored pixels of logsumexp(z) − z[label] (f32 scalar)."""
    logz = torch.logsumexp(z, dim=1)
    pix = labels != ignore_index
    lbl0 = torch.where(pix, labels, 0).long()
    picked = torch.where(F.one_hot(lbl0, z.shape[1]).bool(), z, 0.0).sum(1)
    return ((logz - picked) * pix).sum()


def head_ce_total_plain(x, w, b, labels, valid, ignore_index=255):
    """Σ over pixels of the masked softmax NLL (f32 scalar)."""
    return _nll_total(_logits_plain(x, w, b, valid), labels, ignore_index)


def _ce_g(z, labels, valid, scale, ignore_index):
    """d(scale · Σ NLL)/dz, f32 [P, C], from masked logits z."""
    p = torch.softmax(z, dim=1)
    pix = (labels != ignore_index).float()
    lbl0 = torch.where(labels != ignore_index, labels, 0).long()
    onehot = F.one_hot(lbl0, z.shape[1]).float()
    g = (scale * pix)[:, None] * (p - onehot)
    return torch.where(valid > 0, g, 0.0)


def _grads_from_g(x, w, g):
    """(dx, dW, db) of the head from the logit cotangent g: g crosses the
    feature dtype before the products (the unfused path's dlogits store);
    db sums the unrounded g."""
    gc = g.to(x.dtype).float()
    dx = (gc @ w.to(x.dtype).float()).to(x.dtype)
    dw = gc.T @ x.float()
    db = g.sum(0)
    return dx, dw, db


def head_ce_grads_plain(x, w, b, labels, valid, scale, ignore_index=255):
    """(dx in x's dtype, dW f32 [C, Cin], db f32 [C]) of scale · total."""
    z = _logits_plain(x, w, b, valid)
    return _grads_from_g(x, w, _ce_g(z, labels, valid, scale, ignore_index))


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


def _head_args(head_kernel, head_bias, cin, C):
    """The 1×1 head [width, Cin, 1, 1] (or [width, Cin]) as W [C, Cin] and
    b [C], contiguous; a head narrower than C is zero-padded to C (its dW
    and db come back at its own width), as in the JAX package."""
    w = head_kernel.reshape(head_kernel.shape[0], cin)
    width = w.shape[0]
    b = head_bias
    if width != C:
        w = F.pad(w, (0, 0, 0, C - width))
        b = F.pad(b, (0, C - width))
    return w.contiguous(), b.contiguous()


def _rows(features):
    """NHWC features as the contiguous [P, Cin] the kernels take."""
    x = features.reshape(-1, features.shape[-1])
    return x if x.is_contiguous() else x.contiguous()


def _n_pix(labels, ignore_index, dp=None):
    return pixel_count(labels, ignore_index, dp)


def head_cross_entropy(features, head_kernel, head_bias, labels,
                       valid_classes, *, ignore_index=255, dp=None):
    """Fused head+CE: (mean NLL over non-ignored pixels, n_valid_pixels).

    ``features`` are the pre-head activations [B, H, W, Cin] in the compute
    dtype; ``head_kernel`` the port's 1×1 head weight [width, Cin, 1, 1]
    (or [width, Cin]) and ``head_bias`` [width], f32; ``labels`` [B, H, W]
    int; ``valid_classes`` bool [C]."""
    x = _rows(features)
    w, b = _head_args(head_kernel, head_bias, x.shape[1], valid_classes.shape[0])
    lbl = labels.reshape(-1).to(torch.int32)
    valid = valid_classes.to(device=x.device, dtype=torch.float32)
    n = _n_pix(labels, ignore_index, dp)
    total = _HeadCETotal.apply(x, w, b, lbl, valid, int(ignore_index))
    return total / n, n


# ---------------------------------------------------------------------------
# KD on NHWC features (#9/#10): plain versions
# ---------------------------------------------------------------------------


def _kd_g(logits, tlogits, old_valid, temperature):
    """d(kd_pix)/dz before the pix factor: T·(p_new − p_old) on the old
    classes, 0 elsewhere (``_kd_grad_tile``)."""
    ov = old_valid > 0
    t = temperature
    p_new = torch.softmax(torch.where(ov, logits, NEG_INF) / t, dim=1)
    p_old = torch.softmax(torch.where(ov, tlogits, NEG_INF) / t, dim=1)
    return torch.where(ov, t * (p_new - p_old), 0.0)


def head_ce_kd_total_plain(x, w, b, xt, tw, tb, labels, valid, old_valid, temperature,
                           ignore_index=255):
    """(Σ masked NLL, T²·Σ pix·KL) of the student's head on x (masked by
    valid) and the teacher's on xt (not masked by valid): ``_kd_fwd_kernel``
    (``head_ce.py:696-717``)."""
    z = _logits_plain(x, w, b, valid)
    zt = _logits_plain(xt, tw, tb, None)
    kd = losses.kd_sum(z, zt, old_valid > 0, labels != ignore_index,
                       temperature=temperature)
    return _nll_total(z, labels, ignore_index), kd


def head_ce_kd_grads_plain(x, w, b, xt, tw, tb, labels, valid, old_valid, gce, gkd,
                           temperature, ignore_index=255):
    """(dx in x's dtype, dW, db) of gce·Σ NLL + gkd·Σ KD: the KD term joins
    g before g is rounded (``_kd_bwd_kernel``, ``head_ce.py:720-760``)."""
    z = _logits_plain(x, w, b, valid)
    zt = _logits_plain(xt, tw, tb, None)
    pix = (labels != ignore_index).float()
    g = _ce_g(z, labels, valid, gce, ignore_index)
    g = g + gkd * (_kd_g(z, zt, old_valid, temperature) * pix[:, None])
    return _grads_from_g(x, w, g)


# ---------------------------------------------------------------------------
# BN·ReLU prologue (#7/#8) and KD (#11/#12): plain versions
# ---------------------------------------------------------------------------


def head_ce_bn_total_plain(y, scale, shift, w, b, labels, valid, ignore_index=255):
    """Σ masked NLL of the head on z = round(relu(y·scale + shift)): the
    ``bn_relu`` → head+CE composition (``head_ce.py:482-502``)."""
    return head_ce_total_plain(bn_relu_plain(y, scale, shift), w, b, labels,
                               valid, ignore_index)


def head_ce_bn_grads_plain(y, scale, shift, w, b, labels, valid, gscale,
                           ignore_index=255):
    """(dy in y's dtype, dscale, dshift, dW, db) of gscale · total: the
    head's dz rounded to the feature dtype, then the BN·ReLU backward with
    the f32 pre-activation test (``head_ce.py:505-549``)."""
    z = bn_relu_plain(y, scale, shift)
    dz, dw, db = head_ce_grads_plain(z, w, b, labels, valid, gscale, ignore_index)
    dy, dscale, dshift = bn_relu_bwd_plain(y, dz, scale, shift)
    return dy, dscale, dshift, dw, db


def head_ce_kd_bn_total_plain(y, scale, shift, w, b, yt, tscale, tshift, tw, tb,
                              labels, valid, old_valid, temperature,
                              ignore_index=255):
    """(Σ masked NLL, T²·Σ pix·KL) of the student's and the teacher's
    BN·ReLU'd heads (``head_ce.py:873-903``): the ``bn_relu`` → KD head
    composition."""
    return head_ce_kd_total_plain(bn_relu_plain(y, scale, shift), w, b,
                                  bn_relu_plain(yt, tscale, tshift), tw, tb, labels,
                                  valid, old_valid, temperature, ignore_index)


def head_ce_kd_bn_grads_plain(y, scale, shift, w, b, yt, tscale, tshift, tw, tb,
                              labels, valid, old_valid, gce, gkd, temperature,
                              ignore_index=255):
    """(dy, dscale, dshift, dW, db) of gce·Σ NLL + gkd·Σ KD: the KD head's
    dz, then the BN·ReLU backward (``head_ce.py:906-958``)."""
    dz, dw, db = head_ce_kd_grads_plain(
        bn_relu_plain(y, scale, shift), w, b, bn_relu_plain(yt, tscale, tshift), tw, tb,
        labels, valid, old_valid, gce, gkd, temperature, ignore_index)
    dy, dscale, dshift = bn_relu_bwd_plain(y, dz, scale, shift)
    return dy, dscale, dshift, dw, db


# ---------------------------------------------------------------------------
# KD and BN·ReLU prologue: CUDA launches
# ---------------------------------------------------------------------------


def _check_bn(y, scale, shift, w, labels, valid, teacher=None):
    """Checks of ``_check_operands`` plus the per-channel vectors (none
    without the BN·ReLU prologue: ``scale`` None), and the teacher's
    operands (yt, ts, tsh, tw, tb, old_valid) where given."""
    P, cin, C = _check_operands(y, w, labels, valid)
    vecs = [] if scale is None else [scale, shift]
    if teacher is not None:
        yt, ts, tsh, tw, tb, ov = teacher
        if yt.shape != y.shape or yt.dtype != y.dtype or not yt.is_contiguous() \
                or yt.data_ptr() % 16 or yt.device != y.device:
            raise ValueError("head_ce KD kernel: teacher features must match the "
                             "student's in shape, dtype and device, contiguous and "
                             "16-byte aligned")
        if tw.shape != w.shape or tb.shape != (C,):
            raise ValueError("head_ce KD kernel: teacher head must be [C, Cin] and [C]")
        if scale is not None:
            vecs += [ts, tsh]
        for t in (tw, tb, ov):
            if t.dtype != torch.float32 or not t.is_contiguous() or t.device != y.device:
                raise ValueError("head_ce KD kernel: teacher head and old_valid must "
                                 f"be contiguous f32 on {y.device}")
    for v in vecs:
        if v.shape != (cin,) or v.dtype != torch.float32 or not v.is_contiguous() \
                or v.device != y.device:
            raise ValueError(f"head_ce BN kernel: scale/shift must be contiguous f32 "
                             f"[{cin}] on {y.device}")
    return P, cin, C


def _entry(scale, teacher):
    """The C entry's stem: head_ce_bn, head_ce_kd_bn or, without the
    prologue, head_ce_kd or head_ce_pk."""
    if scale is None:
        return "head_ce_kd" if teacher is not None else "head_ce_pk"
    return "head_ce_kd_bn" if teacher is not None else "head_ce_bn"


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_bn_fwd(y, scale, shift, w, b, labels, valid, teacher, temperature,
                   ignore_index):
    P, cin, C = _check_bn(y, scale, shift, w, labels, valid, teacher)
    kd = teacher is not None
    rows = bn_fwd_partials_rows(P, cin, C, y.dtype == torch.bfloat16, kd, scale is not None)
    partials = torch.empty(rows, 2 if kd else 1, dtype=torch.float32, device=y.device)
    ce_t = torch.empty((), dtype=torch.float32, device=y.device)
    kd_t = torch.empty((), dtype=torch.float32, device=y.device) if kd else None
    yt, ts, tsh, tw, tb, ov = teacher if kd else (None,) * 6
    name = _entry(scale, teacher) + "_fwd"
    err = getattr(build.library(), "cltorch_" + name)(
        y.data_ptr(), _ptr(scale), _ptr(shift), w.data_ptr(), b.data_ptr(),
        _ptr(yt), _ptr(ts), _ptr(tsh), _ptr(tw), _ptr(tb), labels.data_ptr(),
        valid.data_ptr(), _ptr(ov), partials.data_ptr(), ce_t.data_ptr(), _ptr(kd_t),
        P, cin, C, int(ignore_index), int(y.dtype == torch.bfloat16), float(temperature),
        rows, torch.cuda.current_stream(y.device).cuda_stream)
    build.check(err, name)
    return ce_t, kd_t


def _launch_bn_bwd(y, scale, shift, w, b, labels, valid, teacher, cot, temperature,
                   ignore_index):
    """(dy, dscale, dshift, dW, db); without the prologue (``scale`` None)
    (dy, dW, db)."""
    P, cin, C = _check_bn(y, scale, shift, w, labels, valid, teacher)
    kd = teacher is not None
    dy = torch.empty_like(y)
    n_ent = C * (cin + 1) + (0 if scale is None else 2 * cin)
    rows = bn_bwd_partials_rows(P, cin, C, y.dtype == torch.bfloat16, kd, scale is not None)
    partials = torch.empty(rows, n_ent, dtype=torch.float32, device=y.device)
    out = torch.empty(n_ent, dtype=torch.float32, device=y.device)
    cot = cot.to(device=y.device, dtype=torch.float32).contiguous()
    yt, ts, tsh, tw, tb, ov = teacher if kd else (None,) * 6
    name = _entry(scale, teacher) + "_bwd"
    err = getattr(build.library(), "cltorch_" + name)(
        y.data_ptr(), _ptr(scale), _ptr(shift), w.data_ptr(), b.data_ptr(),
        _ptr(yt), _ptr(ts), _ptr(tsh), _ptr(tw), _ptr(tb), labels.data_ptr(),
        valid.data_ptr(), _ptr(ov), cot.data_ptr(), dy.data_ptr(), partials.data_ptr(),
        out.data_ptr(), P, cin, C, int(ignore_index), int(y.dtype == torch.bfloat16),
        float(temperature), rows, torch.cuda.current_stream(y.device).cuda_stream)
    build.check(err, name)
    dwb = out[:C * (cin + 1)].view(C, cin + 1)
    if scale is None:
        return dy, dwb[:, :cin], dwb[:, cin]
    stats = out[C * (cin + 1):]
    return dy, stats[:cin], stats[cin:], dwb[:, :cin], dwb[:, cin]


def launch_kd_fwd(x, w, b, xt, tw, tb, labels, valid, old_valid, temperature,
                  ignore_index=255):
    """Kernel #9: (Σ masked NLL, T²·Σ pix·KL), 0-d f32 tensors."""
    return _launch_bn_fwd(x, None, None, w, b, labels, valid,
                          (xt, None, None, tw, tb, old_valid), temperature, ignore_index)


def launch_kd_bwd(x, w, b, xt, tw, tb, labels, valid, old_valid, gce, gkd, temperature,
                  ignore_index=255):
    """Kernel #10: (dx, dW, db) of gce·Σ NLL + gkd·Σ KD; ``gce`` and ``gkd``
    0-d f32 device tensors."""
    return _launch_bn_bwd(x, None, None, w, b, labels, valid,
                          (xt, None, None, tw, tb, old_valid),
                          torch.stack([gce.reshape(()), gkd.reshape(())]), temperature,
                          ignore_index)


def launch_pk_fwd(x, w, b, labels, valid, ignore_index=255):
    """Kernel #5: Σ masked NLL as a 0-d f32 tensor on x's device."""
    return _launch_bn_fwd(x, None, None, w, b, labels, valid, None, 1.0, ignore_index)[0]


def launch_pk_bwd(x, w, b, labels, valid, gscale, ignore_index=255):
    """Kernel #6: (dx, dW, db) of gscale · total; ``gscale`` a 0-d f32
    device tensor."""
    return _launch_bn_bwd(x, None, None, w, b, labels, valid, None, gscale.reshape(1), 1.0,
                          ignore_index)


def launch_bn_fwd(y, scale, shift, w, b, labels, valid, ignore_index=255):
    """Kernel #7: Σ masked NLL as a 0-d f32 tensor on y's device."""
    return _launch_bn_fwd(y, scale, shift, w, b, labels, valid, None, 1.0,
                          ignore_index)[0]


def launch_bn_bwd(y, scale, shift, w, b, labels, valid, gscale, ignore_index=255):
    """Kernel #8: (dy, dscale, dshift, dW, db); ``gscale`` a 0-d f32 device
    tensor, the cotangent of the total."""
    return _launch_bn_bwd(y, scale, shift, w, b, labels, valid, None,
                          gscale.reshape(1), 1.0, ignore_index)


def launch_kd_bn_fwd(y, scale, shift, w, b, yt, tscale, tshift, tw, tb, labels,
                     valid, old_valid, temperature, ignore_index=255):
    """Kernel #11: (Σ masked NLL, T²·Σ pix·KL), 0-d f32 tensors."""
    return _launch_bn_fwd(y, scale, shift, w, b, labels, valid,
                          (yt, tscale, tshift, tw, tb, old_valid), temperature,
                          ignore_index)


def launch_kd_bn_bwd(y, scale, shift, w, b, yt, tscale, tshift, tw, tb, labels,
                     valid, old_valid, gce, gkd, temperature, ignore_index=255):
    """Kernel #12: (dy, dscale, dshift, dW, db) of gce·Σ NLL + gkd·Σ KD;
    ``gce`` and ``gkd`` 0-d f32 device tensors."""
    return _launch_bn_bwd(y, scale, shift, w, b, labels, valid,
                          (yt, tscale, tshift, tw, tb, old_valid),
                          torch.stack([gce.reshape(()), gkd.reshape(())]),
                          temperature, ignore_index)


# ---------------------------------------------------------------------------
# KD and BN·ReLU prologue: autograd wrappers and public entries
# ---------------------------------------------------------------------------


class _HeadCEKdTotal(torch.autograd.Function):
    """(Σ NLL, Σ KD) of the student's head on x and the frozen teacher's on
    xt; the backward takes (gce, gkd) and gives the teacher's operands no
    gradient."""

    @staticmethod
    def forward(ctx, x, w, b, xt, tw, tb, labels, valid, old_valid, temperature,
                ignore_index):
        ctx.save_for_backward(x, w, b, xt, tw, tb, labels, valid, old_valid)
        ctx.temperature, ctx.ignore_index = temperature, ignore_index
        args = (x, w, b, xt, tw, tb, labels, valid, old_valid, temperature, ignore_index)
        if x.is_cuda:
            LAUNCHES["head_ce_kd_fwd"] += 1
            return launch_kd_fwd(*args)
        return head_ce_kd_total_plain(*args)

    @staticmethod
    def backward(ctx, gce, gkd):
        saved = ctx.saved_tensors
        args = (*saved, gce, gkd, ctx.temperature, ctx.ignore_index)
        if saved[0].is_cuda:
            LAUNCHES["head_ce_kd_bwd"] += 1
            grads = launch_kd_bwd(*args)
        else:
            grads = head_ce_kd_grads_plain(*args)
        return (*grads,) + (None,) * 8


def head_cross_entropy_kd(features, head_kernel, head_bias, tfeatures, t_kernel, t_bias,
                          labels, valid_classes, old_valid, *, temperature,
                          ignore_index=255, dp=None):
    """Fused head + CE + LwF-KD on plain NHWC features: (ce_mean, kd_mean,
    n). ``features`` and ``tfeatures`` (the frozen teacher's) [B, H, W,
    Cin] in the compute dtype; the heads as ``head_cross_entropy`` takes
    them. ``kd_mean`` equals ``losses.kd_loss`` of the two materialized
    logit tensors, the student's masked by ``valid_classes``; α and the LwF
    weight are the caller's. The teacher's operands get no gradient."""
    x, xt = _rows(features), _rows(tfeatures.detach())
    cin, C = x.shape[1], valid_classes.shape[0]
    w, b = _head_args(head_kernel, head_bias, cin, C)
    tw, tb = _head_args(t_kernel, t_bias, cin, C)
    lbl = labels.reshape(-1).to(torch.int32)
    valid = valid_classes.to(device=x.device, dtype=torch.float32)
    ov = old_valid.to(device=x.device, dtype=torch.float32)
    n = _n_pix(labels, ignore_index, dp)
    ce_t, kd_t = _HeadCEKdTotal.apply(x, w, b, xt, tw.detach(), tb.detach(), lbl, valid, ov,
                                      float(temperature), int(ignore_index))
    return ce_t / n, kd_t / n, n


class _HeadCEPkTotal(torch.autograd.Function):
    """UNNORMALIZED Σ NLL of the packed head without a prologue (#5/#6):
    ``_HeadCETotal``'s arithmetic from ``head_ce_bn.cuh``'s kernels."""

    @staticmethod
    def forward(ctx, x, w, b, labels, valid, ignore_index):
        ctx.save_for_backward(x, w, b, labels, valid)
        ctx.ignore_index = ignore_index
        if x.is_cuda:
            LAUNCHES["head_ce_pk_fwd"] += 1
            return launch_pk_fwd(x, w, b, labels, valid, ignore_index)
        return head_ce_total_plain(x, w, b, labels, valid, ignore_index)

    @staticmethod
    def backward(ctx, g):
        x, w, b, labels, valid = ctx.saved_tensors
        if x.is_cuda:
            LAUNCHES["head_ce_pk_bwd"] += 1
            grads = launch_pk_bwd(x, w, b, labels, valid, g, ctx.ignore_index)
        else:
            grads = head_ce_grads_plain(x, w, b, labels, valid, g, ctx.ignore_index)
        return (*grads, None, None, None)


def head_cross_entropy_packed(features, head_kernel, head_bias, labels, valid_classes, *,
                              p=None, ignore_index=255, dp=None):
    """``cl_tpu.pallas.head_ce.head_cross_entropy_packed``: the fused
    head+CE on the packed body's features, (mean NLL over non-ignored
    pixels, n_valid_pixels), the head zero-padded to C. ``features`` are
    NHWC [B, H, W, Cin] in the compute dtype (the packed view
    [B, H, W/p, p·Cin] is a reshape of the same memory); ``p``, the pack
    factor of that view, is checked against the width and not otherwise
    used."""
    if p is not None and (p < 1 or features.shape[2] % p):
        raise ValueError(f"head_cross_entropy_packed: width {features.shape[2]} is not a "
                         f"multiple of p = {p}")
    x = _rows(features)
    w, b = _head_args(head_kernel, head_bias, x.shape[1], valid_classes.shape[0])
    lbl = labels.reshape(-1).to(torch.int32)
    valid = valid_classes.to(device=x.device, dtype=torch.float32)
    n = _n_pix(labels, ignore_index, dp)
    total = _HeadCEPkTotal.apply(x, w, b, lbl, valid, int(ignore_index))
    return total / n, n


class _HeadCEBnTotal(torch.autograd.Function):
    """UNNORMALIZED Σ NLL of the head on relu(y·scale + shift); its backward
    returns the gradients of y, scale, shift, W and b, so dscale and dshift
    flow back through ``deferred_bn`` into the conv's stats epilogue."""

    @staticmethod
    def forward(ctx, y, scale, shift, w, b, labels, valid, ignore_index):
        ctx.save_for_backward(y, scale, shift, w, b, labels, valid)
        ctx.ignore_index = ignore_index
        if y.is_cuda:
            LAUNCHES["head_ce_bn_fwd"] += 1
            return launch_bn_fwd(y, scale, shift, w, b, labels, valid, ignore_index)
        return head_ce_bn_total_plain(y, scale, shift, w, b, labels, valid, ignore_index)

    @staticmethod
    def backward(ctx, g):
        y, scale, shift, w, b, labels, valid = ctx.saved_tensors
        if y.is_cuda:
            LAUNCHES["head_ce_bn_bwd"] += 1
            grads = launch_bn_bwd(y, scale, shift, w, b, labels, valid, g,
                                  ctx.ignore_index)
        else:
            grads = head_ce_bn_grads_plain(y, scale, shift, w, b, labels, valid, g,
                                           ctx.ignore_index)
        return (*grads, None, None, None)


class _HeadCEKdBnTotal(torch.autograd.Function):
    """(Σ NLL, Σ KD) of the student's and the frozen teacher's BN·ReLU'd
    heads; the backward takes (gce, gkd) and gives the teacher's operands
    no gradient."""

    @staticmethod
    def forward(ctx, y, scale, shift, w, b, yt, tscale, tshift, tw, tb, labels,
                valid, old_valid, temperature, ignore_index):
        ctx.save_for_backward(y, scale, shift, w, b, yt, tscale, tshift, tw, tb,
                              labels, valid, old_valid)
        ctx.temperature, ctx.ignore_index = temperature, ignore_index
        args = (y, scale, shift, w, b, yt, tscale, tshift, tw, tb, labels, valid,
                old_valid, temperature, ignore_index)
        if y.is_cuda:
            LAUNCHES["head_ce_kd_bn_fwd"] += 1
            return launch_kd_bn_fwd(*args)
        return head_ce_kd_bn_total_plain(*args)

    @staticmethod
    def backward(ctx, gce, gkd):
        saved = ctx.saved_tensors
        args = (*saved, gce, gkd, ctx.temperature, ctx.ignore_index)
        if saved[0].is_cuda:
            LAUNCHES["head_ce_kd_bn_bwd"] += 1
            grads = launch_kd_bn_bwd(*args)
        else:
            grads = head_ce_kd_bn_grads_plain(*args)
        return (*grads,) + (None,) * 10


def head_cross_entropy_packed_bn(raw, scale, shift, head_kernel, head_bias,
                                 labels, valid_classes, *, ignore_index=255, dp=None):
    """Fused BN·ReLU + head + CE on the packed body's raw last-level output
    ``raw`` [B, H, W, Cin] (compute dtype) with its deferred per-channel
    ``scale``/``shift`` (f32 [Cin]): (mean NLL, n_valid_pixels), equal to
    ``head_cross_entropy(bn_relu(raw, scale, shift), ...)`` without
    materializing z or the logits."""
    y = _rows(raw)
    w, b = _head_args(head_kernel, head_bias, y.shape[1], valid_classes.shape[0])
    lbl = labels.reshape(-1).to(torch.int32)
    valid = valid_classes.to(device=y.device, dtype=torch.float32)
    n = _n_pix(labels, ignore_index, dp)
    total = _HeadCEBnTotal.apply(y, scale.contiguous(), shift.contiguous(), w, b,
                                 lbl, valid, int(ignore_index))
    return total / n, n


def head_cross_entropy_kd_packed_bn(raw, scale, shift, head_kernel, head_bias,
                                    traw, tscale, tshift, t_kernel, t_bias, labels,
                                    valid_classes, old_valid, *, temperature,
                                    ignore_index=255, dp=None):
    """Fused BN·ReLU + head + CE + LwF-KD on the student's and the teacher's
    packed raw outputs, each with its own deferred scale/shift: (ce_mean,
    kd_mean, n). ``kd_mean`` equals ``losses.kd_loss`` of the two
    materialized logit tensors; α and the LwF weight are the caller's. The
    teacher's operands get no gradient."""
    y, yt = _rows(raw), _rows(traw)
    cin, C = y.shape[1], valid_classes.shape[0]
    w, b = _head_args(head_kernel, head_bias, cin, C)
    tw, tb = _head_args(t_kernel, t_bias, cin, C)
    lbl = labels.reshape(-1).to(torch.int32)
    valid = valid_classes.to(device=y.device, dtype=torch.float32)
    ov = old_valid.to(device=y.device, dtype=torch.float32)
    n = _n_pix(labels, ignore_index, dp)
    ce_t, kd_t = _HeadCEKdBnTotal.apply(
        y, scale.contiguous(), shift.contiguous(), w, b, yt, tscale.contiguous(),
        tshift.contiguous(), tw.detach(), tb.detach(), lbl, valid, ov,
        float(temperature), int(ignore_index))
    return ce_t / n, kd_t / n, n
