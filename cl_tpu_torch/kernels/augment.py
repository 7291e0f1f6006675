"""The augment kernels (``csrc/augment.cu``): the image's bilinear resize,
flip and normalization (#15) and the mask's nearest resize and flip (#16).

The counterpart of ``cl_tpu.pallas.augment`` (``train.pallas_augment``):
uint8 NHWC in, ``x`` [B, D, D, 3] in the compute dtype and ``y`` [B, D, D]
int32 out, with the half-pixel coefficients of ``data/resize.py``. The
plain versions, ``image_plain`` and ``mask_plain``, are the two halves of
the einsum augment that ``cl_tpu_torch.augment`` runs without the kernels
(``cl_tpu.augment.augment_jnp``): two products with the dense bilinear
matrix, the flip after the resize, then the normalization. The kernel
takes the same products as two two-tap passes, with the taps read from the
nonzeros of the same f32 matrix (``_taps``).

On a CUDA tensor ``augment_image`` / ``augment_mask`` launch their
kernels, on a CPU tensor they run the plain versions; nothing falls back
from one to the other. ``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cl_tpu_torch.data import resize as resize_lib
from cl_tpu_torch.kernels import build
from cl_tpu_torch.kernels.replay_gather import to_device

LAUNCHES = {"augment_image": 0, "augment_mask": 0}
MAX_SOURCE = 4096  # the kernel's intermediate row (S x 3 f32) in 48 KB of shared memory
MAX_BATCH = 65535  # the kernel's grid y


# The constants live on the device once, copied from pinned memory without
# waiting for the card: a blocking copy inside a step would stall it.
@functools.lru_cache(maxsize=32)
def _resize_constants(src: int, dst: int, device: torch.device):
    return (to_device(resize_lib.bilinear_matrix(src, dst), device),
            to_device(resize_lib.nearest_indices(src, dst).astype(np.int64), device))


@functools.lru_cache(maxsize=32)
def _norm_constants(mean: tuple, std: tuple, device: torch.device):
    return tuple(to_device(v, device) for v in _norm_values(mean, std))


def _norm_values(mean: tuple, std: tuple) -> tuple[np.ndarray, np.ndarray]:
    """255·mean and 255·std, each product rounded to f32 (``cl_tpu``'s
    ``jnp.asarray(mean, f32) * 255.0``)."""
    return (np.asarray(mean, np.float32) * np.float32(255.0),
            np.asarray(std, np.float32) * np.float32(255.0))


@functools.lru_cache(maxsize=32)
def _taps(src: int, dst: int, device: torch.device):
    """The bilinear matrix's nonzeros, row by row: (lo, hi) int32 [dst]
    source indices and (wlo, whi) f32 [dst] weights; a row with one nonzero
    (an edge clamp, or a sample on a source pixel) has hi = lo and whi = 0.
    Then the nearest indices, int32 [dst]."""
    r = resize_lib.bilinear_matrix(src, dst)
    lo, hi = np.zeros(dst, np.int32), np.zeros(dst, np.int32)
    wlo, whi = np.zeros(dst, np.float32), np.zeros(dst, np.float32)
    for o in range(dst):
        nz = np.flatnonzero(r[o])
        if not 1 <= len(nz) <= 2:
            raise ValueError(f"bilinear row {o} of {src}->{dst} has {len(nz)} nonzeros")
        lo[o] = hi[o] = nz[0]
        wlo[o] = r[o, nz[0]]
        if len(nz) == 2:
            hi[o], whi[o] = nz[1], r[o, nz[1]]
    nidx = resize_lib.nearest_indices(src, dst).astype(np.int32)
    return tuple(to_device(a, device) for a in (lo, hi, wlo, whi, nidx))


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def image_plain(image_u8, flip, *, out_size, mean, std, compute_dtype=torch.float32):
    """uint8 [B, S, S, 3] → bilinear resize (two products with the dense
    half-pixel matrix, vertical first) → flip → (x − 255·mean) / (255·std)
    → [B, D, D, 3] compute_dtype."""
    r, _ = _resize_constants(image_u8.shape[1], out_size, image_u8.device)
    x = image_u8.float()
    # Separable bilinear resize as two products (square images: Rv == Rh).
    x = torch.einsum("os,bstc->botc", r, x)
    x = torch.einsum("pt,botc->bopc", r, x)
    # Horizontal flip (after the resize, as the JAX package does).
    x = torch.where(flip.view(-1, 1, 1, 1), x.flip(2), x)
    mean_a, std_a = _norm_constants(tuple(mean), tuple(std), x.device)
    x = (x - mean_a) / std_a
    return x.to(compute_dtype).contiguous()


def mask_plain(mask, flip, *, out_size):
    """uint8 [B, S, S] → nearest resize → flip → int32 [B, D, D]."""
    _, nn_idx = _resize_constants(mask.shape[1], out_size, mask.device)
    y = mask[:, nn_idx][:, :, nn_idx].to(torch.int32)
    return torch.where(flip.view(-1, 1, 1), y.flip(2), y).contiguous()


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def _check(what, t, flip, channels):
    B, S = t.shape[0], t.shape[1]
    want = (B, S, S, 3) if channels else (B, S, S)
    if t.dtype != torch.uint8 or tuple(t.shape) != want or not t.is_contiguous():
        raise ValueError(f"{what} kernel: a contiguous uint8 {list(want)} tensor expected, "
                         f"got {t.dtype} {list(t.shape)}")
    if flip.dtype != torch.bool or tuple(flip.shape) != (B,) or flip.device != t.device:
        raise ValueError(f"{what} kernel: flip bool [{B}] on {t.device} expected")
    if not 1 <= B <= MAX_BATCH or not 1 <= S <= MAX_SOURCE:
        raise ValueError(f"{what} kernel: 1 <= B <= {MAX_BATCH} and 1 <= S <= {MAX_SOURCE}, "
                         f"got B={B}, S={S}")


def launch_image(image_u8, flip, *, out_size, mean, std, compute_dtype=torch.float32):
    _check("augment_image", image_u8, flip, channels=True)
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"augment_image kernel: f32 or bf16 output, got {compute_dtype}")
    B, S, D = image_u8.shape[0], image_u8.shape[1], int(out_size)
    lo, hi, wlo, whi, _ = _taps(S, D, image_u8.device)
    m, s = _norm_values(tuple(mean), tuple(std))
    flip = flip.contiguous()
    out = torch.empty((B, D, D, 3), dtype=compute_dtype, device=image_u8.device)
    err = build.library().cltorch_augment_image(
        image_u8.data_ptr(), flip.data_ptr(), lo.data_ptr(), hi.data_ptr(), wlo.data_ptr(),
        whi.data_ptr(), out.data_ptr(), B, S, D, *map(float, m), *map(float, s),
        int(compute_dtype == torch.bfloat16),
        torch.cuda.current_stream(image_u8.device).cuda_stream)
    build.check(err, "augment_image")
    return out


def launch_mask(mask, flip, *, out_size):
    _check("augment_mask", mask, flip, channels=False)
    B, S, D = mask.shape[0], mask.shape[1], int(out_size)
    nidx = _taps(S, D, mask.device)[4]
    flip = flip.contiguous()
    out = torch.empty((B, D, D), dtype=torch.int32, device=mask.device)
    err = build.library().cltorch_augment_mask(
        mask.data_ptr(), flip.data_ptr(), nidx.data_ptr(), out.data_ptr(), B, S, D,
        torch.cuda.current_stream(mask.device).cuda_stream)
    build.check(err, "augment_mask")
    return out


def augment_image(image_u8, flip, *, out_size, mean, std, compute_dtype=torch.float32):
    """#15: uint8 [B, S, S, 3] → normalized [B, D, D, 3] compute_dtype."""
    if image_u8.is_cuda:
        LAUNCHES["augment_image"] += 1
        return launch_image(image_u8, flip, out_size=out_size, mean=mean, std=std,
                            compute_dtype=compute_dtype)
    return image_plain(image_u8, flip, out_size=out_size, mean=mean, std=std,
                       compute_dtype=compute_dtype)


def augment_mask(mask, flip, *, out_size):
    """#16: uint8 [B, S, S] → int32 [B, D, D]."""
    if mask.is_cuda:
        LAUNCHES["augment_mask"] += 1
        return launch_mask(mask, flip, out_size=out_size)
    return mask_plain(mask, flip, out_size=out_size)
