"""Plan-driven epochs over the device-resident dataset cache.

The counterpart of ``cl_tpu/data/cached_exec.py``. With the dataset on the
card (``data/device_cache.py``), a step needs no host → device copy and no
host wait at all:

  * the host computes the whole epoch's (indices, flips[, pads]) from the
    shared seeded ``pipeline.epoch_plan`` (the same stream as the host
    pipeline's, so the batches are bit-identical) and uploads it once per
    epoch as [S, B] tensors (``build_plan``);
  * step ``s`` slices row ``s`` of the device-resident plan, gathers its
    batch from the cache (``index_select``), widens it with replay rows,
    and trains (``gather_batch``, ``widen_with_replay``);
  * the replay draws of the whole epoch are precomputed in the same
    ``RandomState`` call order as the per-step draws (``build_replay_plan``),
    so the sampled rows are those of the per-step paths; the buffer's rows
    are gathered by the replay-gather kernel #20 (``replay_gather.gather``),
    twice a step (images and masks), and, while the buffer is empty (task
    0), rows of the fresh batch are duplicated by ``index_select``.

Each function has a row form (``gather_batch_row``,
``widen_with_replay_row``) that takes one step's pre-sliced plan row, as
``cl_tpu``'s ``lax.scan`` body does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cl_tpu_torch.data import device_cache, pipeline
from cl_tpu_torch.devices import resolve_device
from cl_tpu_torch.kernels import replay_gather


class EpochPlan(NamedTuple):
    idx: torch.Tensor          # int32 [S, B] dataset rows per step
    flip: torch.Tensor         # bool  [S, B] horizontal-flip decisions
    pad: torch.Tensor | None   # bool  [S, B] padded (ignore) rows, eval only
    steps: int


def build_plan(n: int, *, batch_size: int, epoch: int, seed: int, shuffle: bool,
               flip_prob: float, pad_final: bool = False,
               device: torch.device | str | None = None) -> EpochPlan:
    """One epoch's (indices, flips[, pads]) as [S, B] tensors on ``device``
    (None: the card), copied from pinned memory without waiting for it."""
    device = resolve_device(device)
    rows = list(pipeline.epoch_plan(
        n, batch_size=batch_size, epoch=epoch, seed=seed, shuffle=shuffle,
        flip_prob=flip_prob, pad_final=pad_final))
    if not rows:  # a dataset smaller than the batch: a zero-step epoch, as
        #           in the host pipeline
        idx = np.zeros((0, batch_size), np.int64)
        flip = np.zeros((0, batch_size), bool)
    else:
        idx = np.stack([i for i, _ in rows])
        flip = np.stack([f for _, f in rows])
    pad = idx < 0
    put = replay_gather.to_device
    return EpochPlan(
        idx=put(np.where(pad, 0, idx).astype(np.int32), device),
        flip=put(flip, device),
        pad=put(pad, device) if pad_final else None,
        steps=len(rows),
    )


def build_replay_plan(buf, *, steps: int, k: int, batch_size: int, flip_prob: float,
                      device: torch.device | str | None = None):
    """The epoch's replay draws, in the per-step ``RandomState`` call order
    of ``ReplayBuffer.sample`` / ``DeviceReplayBuffer.sample_indices`` +
    ``sample_flips`` (buffer mode), or of the duplicate-fresh-rows draw
    (empty buffer, task 0).

    Returns ("batch", dup_idx [S, k], None) or ("buffer", idx [S, k],
    flips [S, k]), int32 and bool on ``device`` (None: the card)."""
    device = resolve_device(device)
    put = replay_gather.to_device
    if len(buf) == 0:
        dup = (np.stack([buf.rng.randint(0, batch_size, size=k) for _ in range(steps)])
               if steps else np.zeros((0, k), np.int64))
        return "batch", put(dup.astype(np.int32), device), None
    idxs, flips = [], []
    for _ in range(steps):
        idxs.append(buf.rng.randint(0, len(buf), size=k))
        flips.append(buf.rng.rand(k) < flip_prob)
    if not steps:  # zero-step epoch (dataset smaller than the batch)
        return ("buffer", put(np.zeros((0, k), np.int32), device),
                put(np.zeros((0, k), bool), device))
    return ("buffer", put(np.stack(idxs).astype(np.int32), device),
            put(np.stack(flips), device))


def replay_arrays(buf, device: torch.device | str | None = None):
    """(images, masks) on the device to gather replay rows from: the
    device-resident buffer's own tensors, or an upload of the host buffer,
    zero-padded to ``buf.capacity`` rows (as in ``cl_tpu``, where a
    constant shape spares a recompile; the padding rows are never sampled,
    the plan draws from ``len(buf)``), once per task. ``device`` None: the
    card."""
    if not isinstance(getattr(buf, "images", None), list):  # DeviceReplayBuffer
        return buf.images, buf.masks
    imgs, msks = np.stack(buf.images), np.stack(buf.masks)
    pad = buf.capacity - imgs.shape[0]
    if pad > 0:
        imgs = np.concatenate([imgs, np.zeros((pad,) + imgs.shape[1:], imgs.dtype)])
        msks = np.concatenate([msks, np.zeros((pad,) + msks.shape[1:], msks.dtype)])
    return tuple(device_cache.upload((imgs, msks), resolve_device(device)))


def gather_batch_row(images, masks, idx, flip, *, pad=None,
                     ignore_index: int | None = None) -> pipeline.HostBatch:
    """One step's batch from the cache and one plan row (idx int32 [B],
    flip bool [B]); with ``pad``, padded rows' masks become pure
    ignore_index (the eval padding contract)."""
    msk = masks.index_select(0, idx)
    if pad is not None:
        msk = torch.where(pad[:, None, None], ignore_index, msk)
    return pipeline.HostBatch(image=images.index_select(0, idx), mask=msk, flip=flip)


def gather_batch(images, masks, plan: EpochPlan, s: int, *,
                 ignore_index: int | None = None) -> pipeline.HostBatch:
    """Step ``s``'s batch on the device from the cache and row ``s`` of the
    plan."""
    return gather_batch_row(images, masks, plan.idx[s], plan.flip[s],
                            pad=None if plan.pad is None else plan.pad[s],
                            ignore_index=ignore_index)


def widen_with_replay_row(batch: pipeline.HostBatch, mode: str, r, rflip=None,
                          rep_images=None, rep_masks=None) -> pipeline.HostBatch:
    """``batch`` widened by one step's replay rows ``r`` (int32 [k]):
    "batch" mode duplicates rows of the fresh batch itself, flips included
    (the empty buffer's shape-keeping rows); "buffer" mode gathers the
    replay arrays' rows with kernel #20 and takes the planned flips."""
    if mode == "batch":
        extra = pipeline.HostBatch(*(t.index_select(0, r) for t in batch))
    else:
        extra = pipeline.HostBatch(replay_gather.gather(rep_images, r),
                                   replay_gather.gather(rep_masks, r), rflip)
    return pipeline.HostBatch(*(torch.cat([a, b]) for a, b in zip(batch, extra)))


def widen_with_replay(batch: pipeline.HostBatch, mode: str, rep_plan_idx, rep_plan_flip,
                      s: int, rep_images=None, rep_masks=None) -> pipeline.HostBatch:
    """Step ``s``'s replay rows, from the precomputed replay plan, appended
    to ``batch`` on the device."""
    return widen_with_replay_row(
        batch, mode, rep_plan_idx[s], None if rep_plan_flip is None else rep_plan_flip[s],
        rep_images, rep_masks)
