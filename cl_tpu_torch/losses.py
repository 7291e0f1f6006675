"""Masked per-pixel cross-entropy and LwF distillation, plain PyTorch.

The counterpart of ``cl_tpu/losses.py`` (``mask_logits``,
``cross_entropy``, ``kd_loss_jnp``): classes not yet seen get the logit
−1e9, pixels with the ignore label 255 drop out, and the mean runs over
the remaining pixels. All loss arithmetic is f32 even when the model
computes in bf16. This is the path of ``train.use_pallas=false``; the
kernels of ``cl_tpu_torch.kernels`` compute the same functions.
"""

from __future__ import annotations

import torch

from cl_tpu_torch.sharding import pixel_count

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
    dp=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean masked softmax-CE. Returns (loss scalar f32, n_valid_pixels f32).
    With ``dp`` (a ``sharding.DataParallel``) n is the global batch's and
    the loss is this rank's share of the global mean."""
    logits = mask_logits(logits.float(), valid_classes)
    mask = labels != ignore_index
    safe_labels = torch.where(mask, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, safe_labels[..., None]).squeeze(-1)
    pixel_nll = (logz - picked) * mask
    n = pixel_count(labels, ignore_index, dp)
    return pixel_nll.sum() / n, n


def kd_sum(new_logits, old_logits, old_valid, pix, *, temperature: float):
    """T² · Σ over pixels of pix · KL(softmax(old/T) ‖ softmax(new/T)), both
    logit sets masked to the old model's classes ``old_valid`` (bool [C])."""
    t = temperature
    new_m = mask_logits(new_logits.float(), old_valid) / t
    old_m = mask_logits(old_logits.float(), old_valid) / t
    kl = (torch.softmax(old_m, dim=-1)
          * (torch.log_softmax(old_m, dim=-1)
             - torch.log_softmax(new_m, dim=-1))).sum(-1)
    return (t * t) * (kl * pix).sum()


def kd_loss(
    new_logits: torch.Tensor,    # [B, H, W, C]
    old_logits: torch.Tensor,    # [B, H, W, C] from the frozen teacher
    old_valid: torch.Tensor,     # bool [C] classes the teacher knows
    labels: torch.Tensor,        # int [B, H, W], for the ignore mask
    *,
    temperature: float,
    ignore_index: int = 255,
    dp=None,
) -> torch.Tensor:
    """LwF distillation on materialized logits, averaged over non-ignored
    pixels (``kd_loss_jnp``); α and the LwF weight are the caller's. With
    ``dp``, this rank's share of the global mean."""
    mask = labels != ignore_index
    n = pixel_count(labels, ignore_index, dp)
    return kd_sum(new_logits, old_logits, old_valid, mask,
                  temperature=temperature) / n
