"""Host-side input pipeline: batching, seeded shuffling, prefetch to device.

The host decodes (here: rasterizes) to uint8; resize → flip → normalize
runs on the device (``cl_tpu_torch.augment``). Batches cross host → device
as uint8, put ahead of the step by a background thread.

``HostBatch``, ``epoch_plan``, ``batches``, ``train_batches``,
``replay_mix`` and ``val_batches`` are this package's own copies of
``cl_tpu/data/pipeline.py``:
the batch stream is bit-identical to the JAX package's (tested).
"""

from __future__ import annotations

import functools
import queue
import threading
from typing import Any, Iterator, NamedTuple

import numpy as np
import torch

from cl_tpu_torch.config import Config
from cl_tpu_torch.data import synthetic


class HostBatch(NamedTuple):
    """One batch: numpy on the host, or tensors once put on the device."""

    image: Any  # uint8 [B, S, S, 3]
    mask: Any   # uint8 [B, S, S] (remapped labels; 255 ignore)
    flip: Any   # bool  [B] horizontal-flip decision


def _epoch_order(n: int, *, seed: int, epoch: int, shuffle: bool) -> np.ndarray:
    if not shuffle:
        return np.arange(n)
    rng = np.random.RandomState((seed + 977 * epoch) % (2**31 - 1))
    return rng.permutation(n)


def epoch_plan(
    n: int,
    *,
    batch_size: int,
    epoch: int,
    seed: int,
    shuffle: bool,
    flip_prob: float,
    pad_final: bool = False,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """The seeded (indices, flips) stream for one epoch. Drops the trailing
    partial batch, except with ``pad_final=True`` (the eval contract), where
    the trailing batch is emitted full-size with padding slots marked
    idx=-1; consumers turn those rows' masks into pure ignore_index."""
    order = _epoch_order(n, seed=seed, epoch=epoch, shuffle=shuffle)
    flip_rng = np.random.RandomState((seed + 31 * epoch + 7) % (2**31 - 1))
    for b in range(n // batch_size):
        idx = order[b * batch_size:(b + 1) * batch_size]
        flip = (flip_rng.rand(batch_size) < flip_prob) if flip_prob > 0 else \
            np.zeros(batch_size, dtype=bool)
        yield idx, flip.astype(bool)
    rem = n % batch_size
    if pad_final and rem:
        idx = np.full(batch_size, -1, dtype=order.dtype)
        idx[:rem] = order[n - rem:]
        flip = (flip_rng.rand(batch_size) < flip_prob) if flip_prob > 0 else \
            np.zeros(batch_size, dtype=bool)
        yield idx, flip.astype(bool)


def batches(
    dataset,
    *,
    batch_size: int,
    epoch: int,
    seed: int,
    shuffle: bool,
    flip_prob: float,
    pad_final: bool = False,
    ignore_index: int = 255,
) -> Iterator[HostBatch]:
    """Deterministic host batch stream for one epoch (see epoch_plan).
    With ``pad_final``, padding rows (idx −1) carry an all-ignore mask.
    A dataset with ``get_batch`` (the native rasterizer's threaded batch,
    the directory loader's threaded decode) produces each batch in one
    call."""
    batched = getattr(dataset, "get_batch", None)
    for idx, flip in epoch_plan(len(dataset), batch_size=batch_size,
                                epoch=epoch, seed=seed, shuffle=shuffle,
                                flip_prob=flip_prob, pad_final=pad_final):
        pad = idx < 0
        safe = np.where(pad, 0, idx)
        if batched is not None:
            image, masks = batched(safe)
        else:
            imgs, masks = zip(*(dataset[int(i)] for i in safe))
            image, masks = np.stack(imgs), np.stack(masks)
        masks = masks.astype(np.uint8)  # a copy: never the dataset's arrays
        if pad.any():
            masks[pad] = ignore_index
        yield HostBatch(image=image, mask=masks, flip=flip)


@functools.lru_cache(maxsize=16)
def make_datasets(cfg: Config, task_id: int):
    """(train_ds, val_ds) for one task, by ``data.dataset`` as in
    ``cl_tpu``; memoized on the frozen config (directory datasets decode
    every mask for their class filter when they are built)."""
    splits = cfg.classes_per_task
    task_classes = splits[task_id]
    d = cfg.data
    if d.dataset == "synthetic":
        mk = lambda n, split: synthetic.SyntheticSegDataset(  # noqa: E731
            num_images=n, size=d.source_size, task_classes=task_classes,
            seed=d.shuffle_seed + task_id, split=split)
    elif d.dataset == "synthetic_native":
        from cl_tpu_torch.data.synthetic_native import NativeSyntheticSegDataset

        mk = lambda n, split: NativeSyntheticSegDataset(  # noqa: E731
            num_images=n, size=d.source_size, task_classes=task_classes,
            seed=d.shuffle_seed + task_id, split=split)
    elif d.dataset in ("voc_dir", "cityscapes_dir"):
        from cl_tpu_torch.data import directory

        return directory.make_datasets(cfg, task_id)
    else:
        raise ValueError(f"unknown dataset {d.dataset!r}")
    return (mk(d.train_images_per_task, "train"),
            mk(d.val_images_per_task, "val"))


def train_batches(cfg: Config, task_id: int, epoch: int) -> Iterator[HostBatch]:
    train_ds, _ = make_datasets(cfg, task_id)
    return batches(train_ds, batch_size=cfg.data.batch_size, epoch=epoch,
                   seed=cfg.data.shuffle_seed + 1000 * task_id, shuffle=True,
                   flip_prob=cfg.data.flip_prob)


def replay_mix(batch: HostBatch, replay_samples: HostBatch | None) -> HostBatch:
    """A host batch with a replay sub-batch appended (``cl_tpu``'s
    ``pipeline.replay_mix``)."""
    if replay_samples is None:
        return batch
    return HostBatch(*(np.concatenate([a, b]) for a, b in zip(batch, replay_samples)))


def val_batches(cfg: Config, task_id: int) -> Iterator[HostBatch]:
    _, val_ds = make_datasets(cfg, task_id)
    return batches(val_ds, batch_size=cfg.data.batch_size, epoch=0,
                   seed=cfg.data.shuffle_seed + 1000 * task_id, shuffle=False,
                   flip_prob=0.0, pad_final=True,
                   ignore_index=cfg.data.ignore_index)


# ---------------------------------------------------------------------------
# Device prefetch
# ---------------------------------------------------------------------------


def put_batch(batch: HostBatch, device: torch.device,
              stream: torch.cuda.Stream | None = None) -> HostBatch:
    """Host batch → tensors on ``device``. On CUDA the uint8 arrays are
    pinned and copied with ``non_blocking=True`` on ``stream``."""
    arrays = (batch.image, batch.mask, np.asarray(batch.flip, bool))
    if device.type != "cuda":
        return HostBatch(*(torch.from_numpy(np.ascontiguousarray(a))
                           for a in arrays))
    with torch.cuda.stream(stream):
        return HostBatch(*(torch.from_numpy(np.ascontiguousarray(a))
                           .pin_memory().to(device, non_blocking=True)
                           for a in arrays))


_SENTINEL = object()


def prefetch_to_device(it: Iterator[HostBatch], *, device: torch.device,
                       depth: int = 2) -> Iterator[HostBatch]:
    """Yield ``it``'s batches as tensors on ``device``, produced up to
    ``depth`` batches ahead by a background thread.

    On CUDA the thread copies on a side stream and records an event per
    batch; the consumer's stream waits on that event before it uses the
    batch, and each tensor is marked as used by the consumer's stream so
    the caching allocator does not hand its memory out early. Synchronous
    for ``depth <= 0``."""
    if depth <= 0:
        for item in it:
            yield put_batch(item, device)
        return

    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list[BaseException] = []
    stop = threading.Event()  # consumer abandoned the stream early

    def _feed(item) -> bool:
        """Stop-aware blocking put; the end sentinel must be delivered."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                dev = put_batch(item, device, side)
                ev = None
                if cuda:
                    ev = torch.cuda.Event()
                    ev.record(side)
                if not _feed((dev, ev)):
                    return
        except BaseException as e:  # surfaced in the consumer
            err.append(e)
        finally:
            _feed(_SENTINEL)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            batch, ev = item
            if cuda:
                cur = torch.cuda.current_stream(device)
                cur.wait_event(ev)
                for t in batch:
                    t.record_stream(cur)
            yield batch
    finally:
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        thread.join(timeout=5.0)
