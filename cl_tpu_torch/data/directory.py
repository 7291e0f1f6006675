"""Directory-layout dataset loader for real VOC-/Cityscapes-style data
(``data.dataset=voc_dir|cityscapes_dir``).

This package's own copy of ``cl_tpu/data/directory.py``: the same layout,
class filter, per-task cap, decode and squash, so both packages read the
same bytes (tested). Layout:

    {data_dir}/
      images/{split}/*.png|jpg     RGB images
      masks/{split}/*.png          uint8 class-id masks (255 = ignore)

Images are host-decoded to uint8 at ``source_size`` (PIL if available,
else raw .npy files), then follow the same device-side fused augmentation
path as synthetic data.

Aspect-ratio contract: non-square sources are SQUASHED to
``source_size``² — separate half-pixel coefficient maps per axis, the
same semantics as a torchvision ``Resize((S, S))`` (masks via nearest so
class ids survive). No letterboxing/cropping: the reference genre trains
on fixed square resize, and squashing keeps every labeled pixel
(tests/unit/test_directory.py::test_non_square_sources_squash_to_square).
"""

from __future__ import annotations

import os

import numpy as np

from cl_tpu_torch.config import Config
from cl_tpu_torch.data import resize as resize_lib
from cl_tpu_torch.data import tasks as task_lib


class DirectorySegDataset:
    def __init__(self, *, data_dir: str, split: str, source_size: int,
                 task_classes: list[int], remap: bool = True,
                 max_items: int = 0):
        img_dir = os.path.join(data_dir, "images", split)
        mask_dir = os.path.join(data_dir, "masks", split)
        if not os.path.isdir(img_dir):
            raise FileNotFoundError(f"no such dataset directory: {img_dir}")
        names = sorted(os.listdir(img_dir))
        self.items = []
        for n in names:
            stem = os.path.splitext(n)[0]
            for ext in (".png", ".npy"):
                mp = os.path.join(mask_dir, stem + ext)
                if os.path.exists(mp):
                    self.items.append((os.path.join(img_dir, n), mp))
                    break
        self.source_size = source_size
        self.task_classes = list(task_classes)
        self.remap = remap
        # keep only images containing this task's classes (class-incremental
        # filtering, SURVEY.md §3.1 "per-task class-filtered dataset")
        if task_classes:
            self.items = [it for it in self.items
                          if self._contains_task_class(it[1])]
        # Deterministic per-task cap (cfg.data.{train,val}_images_per_task):
        # the first N of the sorted, filtered list, as the synthetic
        # datasets have a fixed size per task.
        if max_items and len(self.items) > max_items:
            self.items = self.items[:max_items]

    def _load_mask(self, path: str) -> np.ndarray:
        if path.endswith(".npy"):
            return np.load(path).astype(np.uint8)
        from PIL import Image
        return np.asarray(Image.open(path), dtype=np.uint8)

    def _load_image(self, path: str) -> np.ndarray:
        if path.endswith(".npy"):
            return np.load(path).astype(np.uint8)
        from PIL import Image
        return np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)

    def _contains_task_class(self, mask_path: str) -> bool:
        m = self._load_mask(mask_path)
        return bool(np.isin(m, self.task_classes).any())

    def __len__(self) -> int:
        return len(self.items)

    def get_batch(self, indices):
        """Threaded decode of one batch (the reference DataLoader's
        num_workers analogue; PIL decode releases the GIL). Used by the
        pipeline fast path when present. The executor is created lazily
        and reused across batches (this is the hot host path)."""
        import numpy as np

        if len(indices) < 2:
            pairs = [self[int(i)] for i in indices]
        else:
            pairs = list(self._executor().map(
                lambda i: self[int(i)], indices))
        return (np.stack([p[0] for p in pairs]),
                np.stack([p[1] for p in pairs]))

    def _executor(self):
        ex = getattr(self, "_pool", None)
        if ex is None:
            import concurrent.futures as cf

            ex = self._pool = cf.ThreadPoolExecutor(max_workers=8)
        return ex

    def __getitem__(self, i: int):
        img_path, mask_path = self.items[i]
        img = self._load_image(img_path)
        mask = self._load_mask(mask_path)
        s = self.source_size
        if img.shape[:2] != (s, s):
            img = np.clip(resize_lib.resize_bilinear_np(
                img.astype(np.float32), s), 0, 255).astype(np.uint8)
            # nearest works for any aspect via two 1-D index maps
            iv = resize_lib.nearest_indices(mask.shape[0], s)
            ih = resize_lib.nearest_indices(mask.shape[1], s)
            mask = mask[iv][:, ih]
        if self.remap:
            mask = task_lib.remap_mask_for_task(mask, self.task_classes)
        return img, mask


def make_datasets(cfg: Config, task_id: int):
    splits = cfg.classes_per_task
    d = cfg.data
    mk = lambda split, cap: DirectorySegDataset(
        data_dir=d.data_dir, split=split, source_size=d.source_size,
        task_classes=splits[task_id], max_items=cap)
    return (mk("train", d.train_images_per_task),
            mk("val", d.val_images_per_task))
