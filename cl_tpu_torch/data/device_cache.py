"""Device-resident dataset cache: one bulk host → device copy per task, then
every epoch's batches are gathered on the device.

The counterpart of ``cl_tpu/data/device_cache.py`` (``data.device_cache``):
the task's decoded uint8 images and masks go to the card once, and each
step gathers its batch by index from them, following the same seeded
``pipeline.epoch_plan`` as the host pipeline, so the batches are bit for
bit the host pipeline's (tested). Research-scale sets are small next to
the card's memory: 128 images at 576² are 170 MB with their masks.

Single device, as in ``cl_tpu``'s single-device path.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from cl_tpu_torch.data import pipeline
from cl_tpu_torch.devices import resolve_device


def _decode(dataset, chunk: int) -> tuple[np.ndarray, np.ndarray]:
    """The whole dataset as uint8 (images [N, S, S, 3], masks [N, S, S]),
    decoded in chunks through ``get_batch`` where the dataset has it."""
    n = len(dataset)
    batched = getattr(dataset, "get_batch", None)
    imgs, msks = [], []
    for lo in range(0, n, chunk):
        idx = np.arange(lo, min(lo + chunk, n))
        if batched is not None:
            im, mk = batched(idx)
        else:
            pairs = [dataset[int(i)] for i in idx]
            im = np.stack([p[0] for p in pairs])
            mk = np.stack([p[1] for p in pairs])
        imgs.append(im)
        msks.append(mk.astype(np.uint8))
    return np.concatenate(imgs), np.concatenate(msks)


def upload(arrays, device: torch.device) -> list[torch.Tensor]:
    """Host arrays on ``device``: on CUDA each is staged in pinned memory
    and copied in one bulk ``non_blocking`` copy, and the stream is synced
    once at the end, so the copies land here (set-up time) and not inside
    the first step that reads them."""
    out = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    if device.type != "cuda":
        return out
    out = [t.pin_memory().to(device, non_blocking=True) for t in out]
    torch.cuda.current_stream(device).synchronize()
    return out


class DeviceDatasetCache:
    """``dataset`` decoded on the host (chunked) into two tensors on
    ``device`` (None: the card): ``images`` uint8 [N, S, S, 3] and ``masks``
    uint8 [N, S, S]."""

    def __init__(self, dataset, device: torch.device | str | None = None, *,
                 chunk: int = 32):
        self.n = len(dataset)
        self.device = resolve_device(device)
        self.images, self.masks = upload(_decode(dataset, chunk), self.device)

    def nbytes(self) -> int:
        return self.images.nbytes + self.masks.nbytes

    def batches(self, *, batch_size: int, epoch: int, seed: int, shuffle: bool,
                flip_prob: float, pad_final: bool = False,
                ignore_index: int = 255) -> Iterator[pipeline.HostBatch]:
        """Device-resident batches following the host epoch plan; with
        ``pad_final``, padding rows (idx −1) carry an all-ignore mask, as
        in the host pipeline's eval contract."""
        from cl_tpu_torch.data import cached_exec

        plan = cached_exec.build_plan(self.n, batch_size=batch_size, epoch=epoch, seed=seed,
                                      shuffle=shuffle, flip_prob=flip_prob,
                                      pad_final=pad_final, device=self.device)
        for s in range(plan.steps):
            yield cached_exec.gather_batch(self.images, self.masks, plan, s,
                                           ignore_index=ignore_index)
