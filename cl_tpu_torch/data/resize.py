"""Resize as sparse interpolation matrices / index maps (numpy).

This package's own copy of ``cl_tpu/data/resize.py``: the same half-pixel
(align_corners=False) coefficients, applied as two matrix multiplies
(out = Rv @ img @ Rh^T per channel) by ``cl_tpu_torch.augment``, so the
port resizes with exactly the coefficients of the JAX package.
"""

from __future__ import annotations

import numpy as np


def bilinear_matrix(src: int, dst: int) -> np.ndarray:
    """Dense [dst, src] f32 bilinear interpolation matrix, half-pixel convention.

    Each row has at most two non-zeros; edge samples clamp (replicate).
    Matches torchvision/PIL ``align_corners=False`` coefficient placement.
    """
    scale = src / dst
    pos = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    lo = np.floor(pos).astype(np.int64)
    w_hi = (pos - lo).astype(np.float64)
    lo_c = np.clip(lo, 0, src - 1)
    hi_c = np.clip(lo + 1, 0, src - 1)
    mat = np.zeros((dst, src), dtype=np.float64)
    rows = np.arange(dst)
    np.add.at(mat, (rows, lo_c), 1.0 - w_hi)
    np.add.at(mat, (rows, hi_c), w_hi)
    return mat.astype(np.float32)


def nearest_indices(src: int, dst: int) -> np.ndarray:
    """[dst] int32 source indices for nearest-neighbor resize (half-pixel).

    Used for masks (labels must never be interpolated).
    """
    scale = src / dst
    idx = np.floor((np.arange(dst, dtype=np.float64) + 0.5) * scale)
    return np.clip(idx, 0, src - 1).astype(np.int32)


def resize_bilinear_np(img: np.ndarray, dst: int) -> np.ndarray:
    """Reference numpy application (f32 in, f32 out). img: [H, W, C]."""
    rv = bilinear_matrix(img.shape[0], dst)
    rh = bilinear_matrix(img.shape[1], dst)
    # out[o, p, c] = sum_{s,t} Rv[o,s] img[s,t,c] Rh[p,t]
    return np.einsum("os,stc,pt->opc", rv, img.astype(np.float32), rh,
                     optimize=True)


def resize_nearest_np(mask: np.ndarray, dst: int) -> np.ndarray:
    """Nearest resize for [H, W] integer masks."""
    iv = nearest_indices(mask.shape[0], dst)
    ih = nearest_indices(mask.shape[1], dst)
    return mask[iv][:, ih]
