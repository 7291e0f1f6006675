"""Deterministic synthetic segmentation dataset (BASELINE.json:7 smoke data).

Seeded rectangles/ellipses rasterized onto a textured background; each shape's
class id paints the mask. Class-conditional colors make the task learnable.
Pure numpy and fully deterministic given (seed, index), so the torch-CPU
parity oracle consumes byte-identical data (SURVEY.md §4.6, §6 determinism).

This package's own copy of ``cl_tpu/data/synthetic.py``: the same seeded
stream, byte for byte.
"""

from __future__ import annotations

import numpy as np

from cl_tpu_torch.data import tasks as task_lib

_GOLDEN = 0.61803398875


def _class_color(class_id: int) -> np.ndarray:
    """Deterministic, well-separated uint8 RGB color per class (HSV walk)."""
    h = (class_id * _GOLDEN) % 1.0
    i = int(h * 6)
    f = h * 6 - i
    v, s = 0.9, 0.75
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    rgb = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)][i % 6]
    return (np.array(rgb) * 255).astype(np.uint8)


def generate_example(
    index: int,
    *,
    size: int,
    classes: list[int],
    seed: int,
    max_shapes: int = 4,
) -> tuple[np.ndarray, np.ndarray]:
    """Return (image uint8 [size,size,3], mask uint8 [size,size]).

    The mask holds global class ids; background is 0. Deterministic in
    (index, size, classes, seed).
    """
    rng = np.random.RandomState((seed * 1_000_003 + index) % (2**31 - 1))
    # Textured background: low-amplitude noise around a per-image base tone.
    base = rng.randint(16, 72, size=3)
    img = (base[None, None, :]
           + rng.randint(-12, 13, size=(size, size, 3))).clip(0, 255)
    img = img.astype(np.uint8)
    mask = np.zeros((size, size), dtype=np.uint8)

    yy, xx = np.mgrid[0:size, 0:size]
    n_shapes = rng.randint(1, max_shapes + 1)
    for _ in range(n_shapes):
        cls = int(classes[rng.randint(len(classes))])
        cy, cx = rng.randint(size // 8, size - size // 8, size=2)
        # max(1, ·): tiny test sizes (<10 px) can draw a 0 radius, which
        # divides by zero in the ellipse equation below.
        ry = max(1, rng.randint(size // 10, size // 3))
        rx = max(1, rng.randint(size // 10, size // 3))
        if rng.rand() < 0.5:  # ellipse
            inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
        else:  # rectangle
            inside = (np.abs(yy - cy) <= ry) & (np.abs(xx - cx) <= rx)
        color = _class_color(cls).astype(np.int16)
        jitter = rng.randint(-20, 21, size=3)
        img[inside] = np.clip(color + jitter, 0, 255).astype(np.uint8)
        mask[inside] = cls
    return img, mask


class SyntheticSegDataset:
    """Map-style dataset of synthetic (image, mask) pairs for one task.

    Labels are remapped class-incrementally (non-task classes -> 255) via
    ``tasks.remap_mask_for_task`` unless ``remap=False`` (used for eval sets
    where the full seen-class set is valid).
    """

    def __init__(
        self,
        *,
        num_images: int,
        size: int,
        task_classes: list[int],
        seed: int,
        split: str = "train",
        remap: bool = True,
        include_background_only: bool = False,
    ):
        self.num_images = num_images
        self.size = size
        self.task_classes = list(task_classes)
        # distinct streams for train/val and for different tasks
        self.seed = (seed * 7 + (0 if split == "train" else 10_007)
                     + 101 * sum(task_classes))
        self.remap = remap
        self.include_background_only = include_background_only

    def __len__(self) -> int:
        return self.num_images

    def __getitem__(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        img, mask = generate_example(
            i, size=self.size, classes=self.task_classes, seed=self.seed)
        if self.remap:
            mask = task_lib.remap_mask_for_task(mask, self.task_classes)
        return img, mask
