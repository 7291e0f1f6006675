"""Device-side augmentation: uint8 → resize → flip → normalize.

The counterpart of ``cl_tpu.augment.augment_jnp``: the bilinear resize is
two products with the half-pixel matrices of ``data/resize.py``, the mask
takes the nearest-neighbour indices, the horizontal flip comes after the
resize, then the image is normalized. In the JAX package this is plain
XLA outside any Pallas kernel, so it stays plain tensor code here too.
"""

from __future__ import annotations

import functools

import torch

from cl_tpu_torch.data import resize as resize_lib


# The constants live on the device once: a host → device copy per step
# would wait for the stream (a pageable blocking copy) and stall the
# step's launches behind the previous step's kernels.
@functools.lru_cache(maxsize=32)
def _resize_constants(src: int, dst: int, device: torch.device):
    rv = torch.from_numpy(resize_lib.bilinear_matrix(src, dst)).to(device)
    iv = torch.from_numpy(resize_lib.nearest_indices(src, dst).astype("int64"))
    return rv, iv.to(device)


@functools.lru_cache(maxsize=32)
def _norm_constants(mean: tuple, std: tuple, device: torch.device):
    return (torch.tensor(mean, dtype=torch.float32, device=device) * 255.0,
            torch.tensor(std, dtype=torch.float32, device=device) * 255.0)


def augment(
    image_u8: torch.Tensor,  # uint8 [B, S, S, 3]
    mask: torch.Tensor,      # uint8 [B, S, S]
    flip: torch.Tensor,      # bool  [B]
    *,
    out_size: int,
    mean: tuple[float, float, float],
    std: tuple[float, float, float],
    compute_dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (x [B, H, W, 3] compute_dtype normalized, y [B, H, W] int32)."""
    src = image_u8.shape[1]
    r, nn_idx = _resize_constants(src, out_size, image_u8.device)

    x = image_u8.float()
    # Separable bilinear resize as two products (square images: Rv == Rh).
    x = torch.einsum("os,bstc->botc", r, x)
    x = torch.einsum("pt,botc->bopc", r, x)
    y = mask[:, nn_idx][:, :, nn_idx].to(torch.int32)

    # Horizontal flip (after the resize, as the JAX package does).
    fl = flip.view(-1, 1, 1)
    y = torch.where(fl, y.flip(2), y)
    x = torch.where(fl[..., None], x.flip(2), x)

    mean_a, std_a = _norm_constants(tuple(mean), tuple(std), x.device)
    x = (x - mean_a) / std_a
    return x.to(compute_dtype).contiguous(), y.contiguous()
