"""L5 — on-device confusion matrix, per-class IoU, mIoU, forgetting report.

The counterpart of ``cl_tpu/metrics.py``: the confusion matrix accumulates
on the device as f32 [C, C] by a one-hot product (a deterministic sum:
counts stay exact integers in f32), fetched once at the end of an eval;
IoU, mIoU and the forgetting report reduce in float64 on the host.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cl_tpu_torch.losses import mask_logits


def confusion_matrix_update(
    conf: torch.Tensor,           # f32 [C, C] running matrix
    logits: torch.Tensor,         # f32 [B, H, W, C]
    labels: torch.Tensor,         # int [B, H, W]
    valid_classes: torch.Tensor,  # bool [C]
    *,
    ignore_index: int = 255,
) -> torch.Tensor:
    """conf[t, p] += #pixels with true t predicted p. Ignored pixels drop out."""
    num_classes = conf.shape[0]
    pred = torch.argmax(mask_logits(logits, valid_classes), dim=-1)
    mask = labels != ignore_index
    t = torch.where(mask, labels, 0).reshape(-1).long()
    p = pred.reshape(-1)
    w = mask.reshape(-1).float()
    t1 = F.one_hot(t, num_classes).float() * w[:, None]
    p1 = F.one_hot(p, num_classes).float()
    return conf + t1.T @ p1


def iou_from_confusion(conf: np.ndarray) -> np.ndarray:
    """Per-class IoU = diag / (row + col − diag); NaN where class absent."""
    conf = np.asarray(conf, np.float64)
    diag = np.diag(conf)
    denom = conf.sum(axis=1) + conf.sum(axis=0) - diag
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(denom > 0, diag / denom, np.nan)


def miou(conf: np.ndarray, classes: list[int] | None = None) -> float:
    """Mean IoU over ``classes`` (default: all classes present)."""
    iou = iou_from_confusion(conf)
    if classes is not None:
        iou = iou[np.asarray(classes, np.int64)]
    return float(np.nanmean(iou))


def forgetting_report(miou_matrix: np.ndarray) -> dict:
    """From the lower-triangular [T, T] matrix M[t_eval_after, task] build the
    per-task mIoU decay report.

    forgetting[k] = max_{t>=k} M[t, k] − M[T−1, k] (standard CL definition).
    """
    T = miou_matrix.shape[0]
    final = miou_matrix[T - 1]
    forgetting = []
    for k in range(T - 1):
        peak = np.nanmax(miou_matrix[k:, k])
        forgetting.append(float(peak - final[k]))
    return {
        "miou_matrix": miou_matrix.tolist(),
        "final_per_task_miou": [float(v) for v in final],
        "mean_final_miou": float(np.nanmean(final)),
        "forgetting_per_task": forgetting,
        "mean_forgetting": float(np.mean(forgetting)) if forgetting else 0.0,
    }
