"""Class-incremental task splits and per-task label remapping.

Capability contract: SURVEY.md §2.1 "Dataset / task splits": split the global
label space into 2 or 5 tasks, remap labels per task, 255 = ignore.
This package's own copy of ``cl_tpu/data/tasks.py`` (numpy only), so the
port uses the *same* splits and remap as the JAX package.
"""

from __future__ import annotations

import numpy as np

IGNORE = 255
BACKGROUND = 0


def make_task_splits(num_classes: int, num_tasks: int) -> list[list[int]]:
    """Split foreground classes 1..C-1 into contiguous near-equal chunks.

    Background (0) is implicitly part of every task and is not listed.
    Example: C=21, T=2 -> [[1..10], [11..20]].
    """
    if num_tasks < 1:
        raise ValueError("num_tasks must be >= 1")
    fg = list(range(1, num_classes))
    if num_tasks > len(fg):
        raise ValueError(f"{num_tasks} tasks > {len(fg)} foreground classes")
    base, extra = divmod(len(fg), num_tasks)
    splits, start = [], 0
    for t in range(num_tasks):
        size = base + (1 if t < extra else 0)
        splits.append(fg[start:start + size])
        start += size
    return splits


def seen_classes(splits: list[list[int]], task_id: int) -> list[int]:
    """Cumulative class set after finishing ``task_id`` (incl. background)."""
    out = [BACKGROUND]
    for t in range(task_id + 1):
        out.extend(splits[t])
    return out


def remap_mask_for_task(mask: np.ndarray, task_classes: list[int]) -> np.ndarray:
    """Class-incremental remap: keep background + this task's classes with
    their *global* ids; everything else -> IGNORE.

    Global ids are kept (rather than compacting to 0..k) so that the padded
    1x1 head (SURVEY.md §7 hard parts) can use one fixed output width across
    all tasks; invalid logits are masked in the loss instead.
    """
    keep = np.isin(mask, [BACKGROUND] + list(task_classes))
    out = mask.copy()
    out[~keep] = IGNORE
    return out


def valid_class_mask(num_classes: int, classes: list[int]) -> np.ndarray:
    """Boolean [num_classes] mask of currently-valid logit columns."""
    m = np.zeros(num_classes, dtype=bool)
    m[np.asarray(classes, dtype=np.int64)] = True
    return m
