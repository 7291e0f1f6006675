"""The packed body's elementwise passes and their backward
(``csrc/packed_eltwise.cu``).

Counterparts of ``cl_tpu.pallas.packed_eltwise.bn_relu_packed`` and
``add_stats_packed`` with their custom VJPs. The TPU kernels take a
lane-packed [B, H, W/p, p·C] view with per-lane vectors; here every tensor
is NHWC [B, H, W, C] (the same memory), the vectors are per channel and the
sums come back per channel, already folded over p.

- ``bn_relu(y, scale, shift)``: z = relu(y·scale + shift) in f32, in y's
  dtype (the deferred BatchNorm applied for a consumer without a
  prologue: the pool, the up-conv, the head). Backward: with
  t = y·scale + shift and du = [t > 0]·dz (f32), dy = du·scale rounded to
  the dtype, dscale = Σ du·y, dshift = Σ du (``_brp_bwd``).
- ``add_stats(a, b)``: (z, Σz, Σz²) with z = a + b rounded to the dtype
  and the sums over the rounded z (the decoder's split-conv entry).
  Backward: e = dz + dΣ + 2·z·dΣ² in f32, rounded once, for both operands
  (``_asp_bwd``, ``dy_eff_packed``).

On a CUDA tensor the wrappers launch the kernels, on a CPU tensor they run
the plain versions (``*_plain``, the same arithmetic). ``LAUNCHES`` counts
the kernel launches.
"""

from __future__ import annotations

import torch

from cl_tpu_torch.kernels import build

# Most blocks the add_stats and bn_relu backward kernels use, fixed so
# their sums run in the same order on every card; the rows of their
# partials buffer.
N_BLOCKS = 1024

LAUNCHES = {"bn_relu_fwd": 0, "add_stats_fwd": 0, "bn_relu_bwd": 0, "dy_eff": 0}


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def bn_relu_plain(y, scale, shift):
    return torch.relu(y.float() * scale + shift).to(y.dtype)


def add_stats_plain(a, b):
    z = (a.float() + b.float()).to(a.dtype)
    zf = z.float().reshape(-1, z.shape[-1])
    return z, zf.sum(0), (zf * zf).sum(0)


def bn_relu_bwd_plain(y, dz, scale, shift):
    yf = y.float()
    du = torch.where(yf * scale + shift > 0, dz.float(), 0.0)
    dy = (du * scale).to(y.dtype)
    du, yf = du.reshape(-1, y.shape[-1]), yf.reshape(-1, y.shape[-1])
    return dy, (du * yf).sum(0), du.sum(0)


def dy_eff_plain(dz, z, ds1, ds2):
    return (dz.float() + ds1 + 2.0 * z.float() * ds2).to(dz.dtype)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def _check(t, what):
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: f32 or bf16 only, got {t.dtype}")
    C = t.shape[-1]
    vec = 16 // t.element_size()
    if not t.is_contiguous() or t.data_ptr() % 16 or C % vec or C // vec > 256:
        raise ValueError(f"{what}: needs a contiguous 16-byte-aligned [..., C] "
                         f"tensor with C a multiple of {vec} and at most "
                         f"{256 * vec}, got {tuple(t.shape)}")
    return t.numel() // C, C


def _vec(v, C, device):
    v = v.to(device=device, dtype=torch.float32).contiguous()
    if v.shape != (C,):
        raise ValueError(f"per-channel vector of shape ({C},) expected, got {tuple(v.shape)}")
    return v


def launch_bn_relu(y, scale, shift):
    P, C = _check(y, "bn_relu kernel")
    s, b = _vec(scale, C, y.device), _vec(shift, C, y.device)
    z = torch.empty_like(y)
    err = build.library().cltorch_bn_relu_fwd(
        y.data_ptr(), s.data_ptr(), b.data_ptr(), z.data_ptr(), P, C,
        int(y.dtype == torch.bfloat16), torch.cuda.current_stream(y.device).cuda_stream)
    build.check(err, "bn_relu_fwd")
    return z


def launch_add_stats(a, b):
    P, C = _check(a, "add_stats kernel")
    if b.shape != a.shape or b.dtype != a.dtype or not b.is_contiguous() \
            or b.data_ptr() % 16:
        raise ValueError("add_stats kernel: operands must match in shape and dtype")
    z = torch.empty_like(a)
    partials = torch.empty(N_BLOCKS, 2, C, dtype=torch.float32, device=a.device)
    out = torch.empty(2, C, dtype=torch.float32, device=a.device)
    err = build.library().cltorch_add_stats_fwd(
        a.data_ptr(), b.data_ptr(), z.data_ptr(), partials.data_ptr(), out.data_ptr(),
        P, C, int(a.dtype == torch.bfloat16), N_BLOCKS,
        torch.cuda.current_stream(a.device).cuda_stream)
    build.check(err, "add_stats_fwd")
    return z, out[0], out[1]


def _same(t, like, what):
    if t.shape != like.shape or t.dtype != like.dtype or not t.is_contiguous() \
            or t.data_ptr() % 16:
        raise ValueError(f"{what}: operands must match in shape and dtype, "
                         "contiguous and 16-byte aligned")


def launch_bn_relu_bwd(y, dz, scale, shift):
    P, C = _check(y, "bn_relu backward kernel")
    _same(dz, y, "bn_relu backward kernel")
    s, b = _vec(scale, C, y.device), _vec(shift, C, y.device)
    dy = torch.empty_like(y)
    partials = torch.empty(N_BLOCKS, 2, C, dtype=torch.float32, device=y.device)
    out = torch.empty(2, C, dtype=torch.float32, device=y.device)
    err = build.library().cltorch_bn_relu_bwd(
        y.data_ptr(), dz.data_ptr(), s.data_ptr(), b.data_ptr(), dy.data_ptr(),
        partials.data_ptr(), out.data_ptr(), P, C, int(y.dtype == torch.bfloat16),
        N_BLOCKS, torch.cuda.current_stream(y.device).cuda_stream)
    build.check(err, "bn_relu_bwd")
    return dy, out[0], out[1]


def launch_dy_eff(dz, z, ds1, ds2):
    P, C = _check(dz, "dy_eff kernel")
    _same(z, dz, "dy_eff kernel")
    s1, s2 = _vec(ds1, C, dz.device), _vec(ds2, C, dz.device)
    e = torch.empty_like(dz)
    err = build.library().cltorch_dy_eff(
        dz.data_ptr(), z.data_ptr(), s1.data_ptr(), s2.data_ptr(), e.data_ptr(), P, C,
        int(dz.dtype == torch.bfloat16), torch.cuda.current_stream(dz.device).cuda_stream)
    build.check(err, "dy_eff")
    return e


# ---------------------------------------------------------------------------
# autograd wrappers and public entries
# ---------------------------------------------------------------------------


class _BnRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, scale, shift):
        ctx.save_for_backward(y, scale, shift)
        if y.is_cuda:
            LAUNCHES["bn_relu_fwd"] += 1
            return launch_bn_relu(y, scale, shift)
        return bn_relu_plain(y, scale, shift)

    @staticmethod
    def backward(ctx, dz):
        y, scale, shift = ctx.saved_tensors
        dz = dz.contiguous()
        if y.is_cuda:
            LAUNCHES["bn_relu_bwd"] += 1
            return launch_bn_relu_bwd(y, dz, scale, shift)
        return bn_relu_bwd_plain(y, dz, scale, shift)


class _AddStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        if a.is_cuda:
            LAUNCHES["add_stats_fwd"] += 1
            z, s1, s2 = launch_add_stats(a, b)
        else:
            z, s1, s2 = add_stats_plain(a, b)
        ctx.save_for_backward(z)
        return z, s1, s2

    @staticmethod
    def backward(ctx, dz, ds1, ds2):
        (z,) = ctx.saved_tensors
        dz = dz.contiguous()
        if z.is_cuda:
            LAUNCHES["dy_eff"] += 1
            e = launch_dy_eff(dz, z, ds1, ds2)
        else:
            e = dy_eff_plain(dz, z, ds1, ds2)
        return e, e


def bn_relu(y, scale, shift):
    """z = relu(y·scale + shift) on NHWC y; scale/shift f32 [C]."""
    return _BnRelu.apply(y, scale, shift)


def add_stats(a, b):
    """(z, Σz [C], Σz² [C]) with z = a + b rounded to a's dtype."""
    return _AddStats.apply(a, b)
