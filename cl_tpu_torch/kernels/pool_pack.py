"""2×2/stride-2 max pool of the packed body, forward (``csrc/pool.cu``).

Counterpart of ``cl_tpu.pallas.pool_pack.maxpool2x2_packed`` and of the
forward of ``maxpool2x2_packed_tee``, which returns the pool's input (the
encoder's skip) beside the pool: the two differ only in their backward.
The TPU kernel maps one lane-packed view onto the next; here both are
NHWC [B, H, W, C] as they lie.

On a CUDA tensor ``maxpool2x2`` launches the kernel, on a CPU tensor it
runs ``maxpool2x2_plain``; the backward is a later slice and raises.
``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from cl_tpu_torch.kernels import backward_later, build

LAUNCHES = {"maxpool_fwd": 0}


def maxpool2x2_plain(x):
    B, H, W, C = x.shape
    return x.reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))


def launch_maxpool2x2(x):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"maxpool kernel: f32 or bf16 only, got {x.dtype}")
    B, H, W, C = x.shape
    if H % 2 or W % 2 or (C * x.element_size()) % 16 or not x.is_contiguous() \
            or x.data_ptr() % 16:
        raise ValueError("maxpool kernel needs contiguous 16-byte-aligned NHWC "
                         f"with even H, W and C*itemsize % 16 == 0, got {tuple(x.shape)}")
    y = torch.empty(B, H // 2, W // 2, C, dtype=x.dtype, device=x.device)
    err = build.library().cltorch_maxpool_fwd(
        x.data_ptr(), y.data_ptr(), B, H, W, C, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "maxpool_fwd")
    return y


class _MaxPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        if x.is_cuda:
            LAUNCHES["maxpool_fwd"] += 1
            return launch_maxpool2x2(x)
        return maxpool2x2_plain(x)

    @staticmethod
    def backward(ctx, dy):
        backward_later("maxpool2x2_packed")


def maxpool2x2(x):
    """[B, H, W, C] -> [B, H/2, W/2, C], max over each 2×2 window."""
    return _MaxPool.apply(x)
