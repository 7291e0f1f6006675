"""2×2/stride-2 max pool of the packed body and its backward (``csrc/pool.cu``).

Counterparts of ``cl_tpu.pallas.pool_pack.maxpool2x2_packed`` and
``maxpool2x2_packed_tee``. The TPU kernels map one lane-packed view onto
the next; here both are NHWC [B, H, W, C] as they lie.

- ``maxpool2x2(x)``: the pool. Its backward routes dy to the FIRST maximum
  of each window: the top row if max(row 0) ≥ max(row 1), and within the
  row the first column if it is ≥ the second (``pool_pack.py:181-192``).
- ``maxpool2x2_tee(x) -> (x, pool(x))``: the encoder's skip and the pool in
  one op. Its backward takes the skip's and the pool's cotangents in one
  launch: the routed value is rounded to the dtype first, then d_skip is
  added in f32 and the sum rounded once (``pool_pack.py:98-104``), which
  is what autograd's add of the two cotangents gives on the plain path.
  The packed body takes the tee; the plain pool is what the tests hold
  the tee against.

On a CUDA tensor the wrappers launch the kernels, on a CPU tensor they run
the plain versions. ``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from cl_tpu_torch.kernels import build

LAUNCHES = {"maxpool_fwd": 0, "maxpool_bwd": 0}


def maxpool2x2_plain(x):
    B, H, W, C = x.shape
    return x.reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))


def maxpool2x2_bwd_plain(x, dy, dskip=None):
    """dx of the pool (plus ``dskip``, the tee's skip cotangent)."""
    B, H, W, C = x.shape
    v = x.float().reshape(B, H // 2, 2, W // 2, 2, C)
    q00, q01, q10, q11 = v[:, :, 0, :, 0], v[:, :, 0, :, 1], v[:, :, 1, :, 0], v[:, :, 1, :, 1]
    top = torch.maximum(q00, q01) >= torch.maximum(q10, q11)
    zero = torch.zeros((), dtype=x.dtype)
    dy = dy.to(x.dtype)
    d_top = torch.where(top, dy, zero)
    d_bot = torch.where(top, zero, dy)
    left_top, left_bot = q00 >= q01, q10 >= q11
    rows = [torch.stack([torch.where(left_top, d_top, zero), torch.where(left_top, zero, d_top)],
                        dim=3),
            torch.stack([torch.where(left_bot, d_bot, zero), torch.where(left_bot, zero, d_bot)],
                        dim=3)]
    dx = torch.stack(rows, dim=2).reshape(B, H, W, C)
    if dskip is not None:
        dx = (dx.float() + dskip.float()).to(x.dtype)
    return dx


def _check(x, what):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: f32 or bf16 only, got {x.dtype}")
    B, H, W, C = x.shape
    if H % 2 or W % 2 or (C * x.element_size()) % 16 or not x.is_contiguous() \
            or x.data_ptr() % 16:
        raise ValueError(f"{what} needs contiguous 16-byte-aligned NHWC "
                         f"with even H, W and C*itemsize % 16 == 0, got {tuple(x.shape)}")
    return B, H, W, C


def launch_maxpool2x2(x):
    B, H, W, C = _check(x, "maxpool kernel")
    y = torch.empty(B, H // 2, W // 2, C, dtype=x.dtype, device=x.device)
    err = build.library().cltorch_maxpool_fwd(
        x.data_ptr(), y.data_ptr(), B, H, W, C, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "maxpool_fwd")
    return y


def launch_maxpool2x2_bwd(x, dy, dskip=None):
    B, H, W, C = _check(x, "maxpool backward kernel")
    dy = dy.to(x.dtype).contiguous()
    if dy.shape != (B, H // 2, W // 2, C) or dy.data_ptr() % 16:
        raise ValueError(f"maxpool backward kernel: dy of shape {(B, H // 2, W // 2, C)}")
    if dskip is not None:
        dskip = dskip.to(x.dtype).contiguous()
        if dskip.shape != x.shape or dskip.data_ptr() % 16:
            raise ValueError("maxpool backward kernel: the skip cotangent must match x")
    dx = torch.empty_like(x)
    err = build.library().cltorch_maxpool_bwd(
        x.data_ptr(), dy.data_ptr(), None if dskip is None else dskip.data_ptr(),
        dx.data_ptr(), B, H, W, C, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "maxpool_bwd")
    return dx


def _pool(x):
    if x.is_cuda:
        LAUNCHES["maxpool_fwd"] += 1
        return launch_maxpool2x2(x)
    return maxpool2x2_plain(x)


def _pool_bwd(x, dy, dskip):
    if x.is_cuda:
        LAUNCHES["maxpool_bwd"] += 1
        return launch_maxpool2x2_bwd(x, dy, dskip)
    return maxpool2x2_bwd_plain(x, dy, dskip)


class _MaxPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _pool(x)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return _pool_bwd(x, dy, None)


class _MaxPoolTee(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x)
        return x, _pool(x)

    @staticmethod
    def backward(ctx, dskip, dy):
        (x,) = ctx.saved_tensors
        if dy is None:
            return dskip
        return _pool_bwd(x, dy, dskip)


def maxpool2x2(x):
    """[B, H, W, C] -> [B, H/2, W/2, C], max over each 2×2 window."""
    return _MaxPool.apply(x)


def maxpool2x2_tee(x):
    """(x, maxpool2x2(x)): the skip and the pool, one backward launch for
    both cotangents."""
    return _MaxPoolTee.apply(x)
