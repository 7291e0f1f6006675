"""Device-side augmentation: uint8 → resize → flip → normalize.

The counterpart of ``cl_tpu.train._augment``: with ``use_kernels``
(``train.use_pallas`` and ``train.pallas_augment``) the image and the mask
go through the augment kernels #15 and #16 (``kernels/augment.py``,
``cl_tpu.pallas.augment``); otherwise through their plain versions, the
einsum resize of ``cl_tpu.augment.augment_jnp``: two products with the
half-pixel matrices of ``data/resize.py``, the nearest-neighbour indices
for the mask, the horizontal flip after the resize, then the
normalization.
"""

from __future__ import annotations

import torch

from cl_tpu_torch.kernels import augment as kernels


def augment(
    image_u8: torch.Tensor,  # uint8 [B, S, S, 3]
    mask: torch.Tensor,      # uint8 [B, S, S]
    flip: torch.Tensor,      # bool  [B]
    *,
    out_size: int,
    mean: tuple[float, float, float],
    std: tuple[float, float, float],
    compute_dtype: torch.dtype = torch.float32,
    use_kernels: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (x [B, H, W, 3] compute_dtype normalized, y [B, H, W] int32)."""
    image_fn, mask_fn = ((kernels.augment_image, kernels.augment_mask) if use_kernels
                         else (kernels.image_plain, kernels.mask_plain))
    x = image_fn(image_u8, flip, out_size=out_size, mean=mean, std=std,
                 compute_dtype=compute_dtype)
    return x, mask_fn(mask, flip, out_size=out_size)
