"""The device-resident replay buffer and its gather (``csrc/replay_gather.cu``).

The counterpart of ``cl_tpu/pallas/replay_gather.py``: ``gather(buffer,
idx)`` is ``buffer[idx]`` over rows of bytes (kernel #20), for any row
length; ``DeviceReplayBuffer`` keeps the uint8 images and masks (masks
filled with 255) on the device, fills slots by reservoir sampling and
gathers the sampled rows into the step's batch without a host round trip.

The buffer makes the same ``np.random.RandomState`` calls in the same order
as ``cl_tpu``'s (``add_examples``, ``sample_indices``, ``sample_flips``), so
it holds and samples the same items, and its ``state_dict`` has the same
format as the host ``methods.replay.ReplayBuffer``'s: either buffer loads
the other's. The sampled indices and flips are drawn on the host every
step and cross to the device from pinned memory with ``non_blocking``: a
pageable copy would make the step wait for the card.

On a CUDA tensor ``gather`` launches the kernel, on a CPU tensor it runs
the plain version (``gather_plain``, ``index_select``); nothing falls back
from one to the other. ``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from cl_tpu_torch.devices import resolve_device
from cl_tpu_torch.kernels import build

LAUNCHES = {"replay_gather": 0}
MAX_ROWS = 65535  # the kernel's grid y


def gather_plain(buffer, idx):
    """buffer [N, ...] → [k, ...] rows idx (plain PyTorch)."""
    return torch.index_select(buffer, 0, idx.long())


def _word_bytes(row_bytes, *ptrs):
    for w in (16, 4):
        if row_bytes % w == 0 and all(p % w == 0 for p in ptrs):
            return w
    return 1


def launch_gather(buffer, idx):
    if not buffer.is_contiguous() or buffer.dim() < 1:
        raise ValueError("replay gather kernel: a contiguous buffer [N, ...] expected")
    if idx.dtype != torch.int32 or idx.dim() != 1 or idx.device != buffer.device:
        raise ValueError(f"replay gather kernel: int32 indices [k] on {buffer.device} expected")
    k = idx.shape[0]
    if not 0 < k <= MAX_ROWS:
        raise ValueError(f"replay gather kernel: 1 <= k <= {MAX_ROWS} rows, got {k}")
    idx = idx.contiguous()
    out = torch.empty((k,) + tuple(buffer.shape[1:]), dtype=buffer.dtype, device=buffer.device)
    row_bytes = buffer[0].numel() * buffer.element_size() if buffer.shape[0] else 0
    err = build.library().cltorch_replay_gather(
        buffer.data_ptr(), idx.data_ptr(), out.data_ptr(), row_bytes, buffer.shape[0], k,
        _word_bytes(row_bytes, buffer.data_ptr(), out.data_ptr()),
        torch.cuda.current_stream(buffer.device).cuda_stream)
    build.check(err, "replay_gather")
    return out


def gather(buffer, idx):
    """``buffer[idx]``: buffer [N, ...] (any dtype), idx int32 [k] → [k, ...]."""
    if buffer.is_cuda:
        LAUNCHES["replay_gather"] += 1
        return launch_gather(buffer, idx)
    return gather_plain(buffer, idx)


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A small host array on ``device`` without waiting for the card:
    pinned, copied with ``non_blocking`` on the current stream."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class DeviceReplayBuffer:
    """Fixed-capacity replay store of uint8 images [capacity, S, S, 3] and
    masks [capacity, S, S] (255 where empty) on ``device`` (None: the card)."""

    def __init__(self, capacity: int, source_size: int, *, seed: int,
                 device: torch.device | str | None = None):
        self.capacity = int(capacity)
        self.device = resolve_device(device)
        S = int(source_size)
        self.images = torch.zeros((self.capacity, S, S, 3), dtype=torch.uint8, device=self.device)
        self.masks = torch.full((self.capacity, S, S), 255, dtype=torch.uint8, device=self.device)
        self.count = 0
        self._seen = 0
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return self.count

    def add_examples(self, dataset, n: int, *, task_id: int) -> None:
        """Reservoir sampling with the host buffer's RandomState calls (one
        randint per item past capacity); the kept items are written into
        their slots."""
        take = self.rng.permutation(len(dataset))[:n]
        imgs, msks, slots = [], [], []
        for i in take:
            if self.count < self.capacity:
                slot = self.count
                self.count += 1
            else:
                j = self.rng.randint(0, self._seen + 1)
                slot = j if j < self.capacity else None
            self._seen += 1
            if slot is None:
                continue
            img, mask = dataset[int(i)]
            imgs.append(img)
            msks.append(mask.astype(np.uint8))
            slots.append(slot)
        if not slots:
            return
        # in order, one row at a time: a slot drawn twice keeps the later
        # item, as in the host buffer
        im = torch.from_numpy(np.stack(imgs)).to(self.device)
        ms = torch.from_numpy(np.stack(msks)).to(self.device)
        for r, slot in enumerate(slots):
            self.images[slot].copy_(im[r])
            self.masks[slot].copy_(ms[r])

    def sample_indices(self, k: int) -> torch.Tensor | None:
        """k slot indices (int32 on the device), None if empty."""
        if self.count == 0:
            return None
        return to_device(self.rng.randint(0, self.count, size=k).astype(np.int32), self.device)

    def gather(self, indices: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return gather(self.images, indices), gather(self.masks, indices)

    def sample_flips(self, k: int, flip_prob: float) -> torch.Tensor:
        return to_device(self.rng.rand(k) < flip_prob, self.device)

    def state_dict(self) -> dict:
        return {
            "capacity": self.capacity,
            "images": self.images.cpu().numpy(),
            "masks": self.masks.cpu().numpy(),
            "count": self.count,
            "seen": self._seen,
            "rng_state": self.rng.get_state(),
        }

    def load_state_dict(self, sd: dict) -> None:
        """Either buffer's format: the host buffer writes n stacked rows and
        no ``count``; those are padded to capacity."""
        self.capacity = int(sd["capacity"])
        imgs, masks = np.asarray(sd["images"]), np.asarray(sd["masks"])
        if "count" in sd:
            self.count = int(sd["count"])
        else:
            self.count = imgs.shape[0] if imgs.ndim > 1 else 0
            S = self.images.shape[1]
            pad_i = np.zeros((self.capacity, S, S, 3), np.uint8)
            pad_m = np.full((self.capacity, S, S), 255, np.uint8)
            if self.count:
                pad_i[:self.count] = imgs
                pad_m[:self.count] = masks
            imgs, masks = pad_i, pad_m
        self.images = torch.from_numpy(np.ascontiguousarray(imgs)).to(self.device)
        self.masks = torch.from_numpy(np.ascontiguousarray(masks)).to(self.device)
        self._seen = int(sd["seen"])
        self.rng.set_state(sd["rng_state"])
