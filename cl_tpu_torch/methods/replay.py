"""Replay buffer — a fixed-capacity episodic memory of past tasks' images.

The counterpart of ``cl_tpu/methods/replay.py``: a buffer of (image, mask)
pairs at source size, uint8, filled by reservoir sampling at the end of
each task; while later tasks train, ``method.replay_batch`` stored items
are mixed into each step's batch (``pipeline.replay_mix``). This is the
host-RAM buffer; the device-resident one is
``kernels.replay_gather.DeviceReplayBuffer``.

All sampling draws from one seeded ``np.random.RandomState`` in the same
calls and order as ``cl_tpu``'s, so both packages hold the same items and
sample them in the same order, and each reads the other's ``state_dict``.
"""

from __future__ import annotations

import numpy as np

from cl_tpu_torch.data.pipeline import HostBatch


class ReplayBuffer:
    def __init__(self, capacity: int, *, seed: int):
        self.capacity = int(capacity)
        self.images: list[np.ndarray] = []
        self.masks: list[np.ndarray] = []
        self.task_ids: list[int] = []
        self._seen = 0  # reservoir counter
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.images)

    def add_examples(self, dataset, n: int, *, task_id: int) -> None:
        """Reservoir-sample ``n`` items of ``dataset`` into the buffer."""
        take = self.rng.permutation(len(dataset))[:n]
        for i in take:
            img, mask = dataset[int(i)]
            img, mask = img.copy(), mask.astype(np.uint8)
            if len(self.images) < self.capacity:
                self.images.append(img)
                self.masks.append(mask)
                self.task_ids.append(task_id)
            else:
                j = self.rng.randint(0, self._seen + 1)
                if j < self.capacity:
                    self.images[j], self.masks[j] = img, mask
                    self.task_ids[j] = task_id
            self._seen += 1

    def sample(self, k: int, *, flip_prob: float) -> HostBatch | None:
        """k stored items drawn uniformly, with fresh flip decisions; None
        if the buffer is empty."""
        if not self.images:
            return None
        idx = self.rng.randint(0, len(self.images), size=k)
        return HostBatch(image=np.stack([self.images[i] for i in idx]),
                         mask=np.stack([self.masks[i] for i in idx]),
                         flip=(self.rng.rand(k) < flip_prob))

    def sample_or_current(self, k: int, batch: HostBatch, *,
                          flip_prob: float) -> HostBatch:
        """A replay sub-batch, or (task 0, empty buffer) k rows of the
        current batch, so the step's batch has one shape from the first
        step on."""
        got = self.sample(k, flip_prob=flip_prob)
        if got is not None:
            return got
        idx = self.rng.randint(0, batch.image.shape[0], size=k)
        return HostBatch(image=batch.image[idx], mask=batch.mask[idx],
                         flip=batch.flip[idx])

    def state_dict(self) -> dict:
        return {
            "capacity": self.capacity,
            "images": np.stack(self.images) if self.images else np.zeros((0,), np.uint8),
            "masks": np.stack(self.masks) if self.masks else np.zeros((0,), np.uint8),
            "task_ids": np.asarray(self.task_ids, np.int32),
            "seen": self._seen,
            "rng_state": self.rng.get_state(),
        }

    def load_state_dict(self, sd: dict) -> None:
        """Either buffer's format: the device buffer writes capacity-sized
        arrays with a ``count`` of live rows and no ``task_ids`` (−1)."""
        self.capacity = int(sd["capacity"])
        imgs, masks = np.asarray(sd["images"]), np.asarray(sd["masks"])
        n = int(sd["count"]) if "count" in sd else (imgs.shape[0] if imgs.ndim > 1 else 0)
        self.images = [imgs[i] for i in range(n)]
        self.masks = [masks[i] for i in range(n)]
        tids = sd.get("task_ids")
        self.task_ids = [int(t) for t in tids] if tids is not None else [-1] * n
        self._seen = int(sd["seen"])
        self.rng.set_state(sd["rng_state"])
