"""Masked per-pixel cross-entropy, plain PyTorch.

The counterpart of ``cl_tpu/losses.py`` (``mask_logits``,
``cross_entropy``): classes not yet seen get the logit −1e9, pixels with
the ignore label 255 drop out, and the mean runs over the remaining
pixels. All loss arithmetic is f32 even when the model computes in bf16.
This is the path of ``train.use_pallas=false``; the kernels of
``cl_tpu_torch.kernels`` compute the same function.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9


def mask_logits(logits: torch.Tensor, valid_classes: torch.Tensor) -> torch.Tensor:
    """Force logits of not-yet-seen classes to −1e9. valid_classes: bool [C]."""
    return torch.where(valid_classes.bool(), logits, NEG_INF)


def cross_entropy(
    logits: torch.Tensor,         # [B, H, W, C]
    labels: torch.Tensor,         # int [B, H, W], 255 = ignore
    valid_classes: torch.Tensor,  # bool [C]
    *,
    ignore_index: int = 255,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean masked softmax-CE. Returns (loss scalar f32, n_valid_pixels f32)."""
    logits = mask_logits(logits.float(), valid_classes)
    mask = labels != ignore_index
    safe_labels = torch.where(mask, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, safe_labels[..., None]).squeeze(-1)
    pixel_nll = (logz - picked) * mask
    n = mask.sum().float().clamp_min(1.0)
    return pixel_nll.sum() / n, n
