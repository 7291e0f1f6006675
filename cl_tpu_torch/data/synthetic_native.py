"""Native-rasterized synthetic dataset (``data.dataset=synthetic_native``).

This package's own copy of ``cl_tpu/data/synthetic_native.py``: the same
seed arithmetic, rasterizer (``cl_tpu_torch/native``, a byte-for-byte copy
of the JAX package's C++ source) and remap, so both packages read the same
bytes. The C++ library rasterizes straight into preallocated uint8
buffers, threaded over a batch (``get_batch``); without a C++ toolchain the
bit-identical Python reference (``native/pyref.py``) produces the same
bytes. ``backend`` says which one this dataset uses, and ``PRODUCED``
counts the images each backend produced in this process.
"""

from __future__ import annotations

import numpy as np

from cl_tpu_torch import native
from cl_tpu_torch.data import tasks as task_lib
from cl_tpu_torch.native import pyref

PRODUCED = {"native": 0, "pyref": 0}


class NativeSyntheticSegDataset:
    def __init__(self, *, num_images: int, size: int, task_classes: list[int],
                 seed: int, split: str = "train", remap: bool = True):
        self.num_images = num_images
        self.size = size
        self.task_classes = list(task_classes)
        self.seed = (seed * 7 + (0 if split == "train" else 10_007)
                     + 101 * sum(task_classes))
        self.remap = remap
        self.backend = native.backend()

    def __len__(self) -> int:
        return self.num_images

    def __getitem__(self, i: int):
        fn = native.rasterize if self.backend == "native" else pyref.rasterize
        img, mask = fn(self.seed, i, self.size, self.task_classes)
        PRODUCED[self.backend] += 1
        if self.remap:
            mask = task_lib.remap_mask_for_task(mask, self.task_classes)
        return img, mask

    def get_batch(self, indices):
        """Threaded batch path (the pipeline's and the device cache's fast
        path)."""
        if self.backend != "native":
            pairs = [self[int(i)] for i in indices]
            return (np.stack([p[0] for p in pairs]),
                    np.stack([p[1] for p in pairs]))
        imgs, masks = native.rasterize_batch(
            self.seed, indices, self.size, self.task_classes)
        PRODUCED["native"] += len(imgs)
        if self.remap:
            masks = np.stack([
                task_lib.remap_mask_for_task(m, self.task_classes)
                for m in masks])
        return imgs, masks
