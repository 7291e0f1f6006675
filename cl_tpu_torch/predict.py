"""Batch inference API — the serving-side complement of train and eval.

The counterpart of ``cl_tpu/predict.py``. ``make_predict_step`` runs the
training path's device-side augmentation with flips off (the image's
kernel #15 under ``train.use_pallas`` and ``train.pallas_augment``; the
mask's half, #16, has nothing to do here), the eval-mode forward (the
packed body where it engages), the masked logits (``num_classes`` wide: a
grow-the-head model pads its narrower head's with −1e9) and the argmax to
uint8. ``predict_dataset`` streams any dataset through it,
padding the trailing batch, and returns class-id masks at the model's
output size. The CLI's ``predict`` mode restores the latest checkpoint and
writes the masks of the val split.
"""

from __future__ import annotations

import numpy as np
import torch

from cl_tpu_torch import train as train_lib
from cl_tpu_torch.config import Config
from cl_tpu_torch.data import tasks as task_lib
from cl_tpu_torch.devices import resolve_device
from cl_tpu_torch.kernels import augment as aug_kernels
from cl_tpu_torch.losses import mask_logits


def make_predict_step(cfg: Config, model, valid_classes: np.ndarray, device=None):
    """``step(image_u8) -> uint8 [B, D, D]``: the predicted class of every
    pixel among ``valid_classes`` (bool [C]); ``image_u8`` uint8 [B, S, S,
    3] on ``device`` (None = ``cuda``)."""
    device = resolve_device(device)
    train_lib.check_supported(cfg, device)
    train_lib._set_precision(device)
    d = cfg.data
    compute_dtype = train_lib._dtype(cfg)
    image_fn = aug_kernels.augment_image if train_lib.augment_kernels_on(cfg) \
        else aug_kernels.image_plain
    valid = torch.from_numpy(np.asarray(valid_classes, bool)).to(device)

    @torch.no_grad()
    def step(image_u8: torch.Tensor) -> torch.Tensor:
        flip = torch.zeros(image_u8.shape[0], dtype=torch.bool, device=image_u8.device)
        x = image_fn(image_u8, flip, out_size=d.image_size, mean=d.mean, std=d.std,
                     compute_dtype=compute_dtype)
        model.eval()
        return torch.argmax(mask_logits(model(x), valid), dim=-1).to(torch.uint8)

    return step


def predict_dataset(cfg: Config, model, dataset, *, batch_size: int = 0,
                    seen_task: int | None = None, device=None) -> np.ndarray:
    """uint8 [N, D, D] predicted class-id masks for every item of
    ``dataset``, among the classes seen up to ``seen_task`` (default: the
    last task)."""
    device = resolve_device(device)
    bs = batch_size or cfg.data.batch_size
    seen_task = cfg.train.num_tasks - 1 if seen_task is None else seen_task
    valid = task_lib.valid_class_mask(
        cfg.data.num_classes, task_lib.seen_classes(cfg.classes_per_task, seen_task))
    step = make_predict_step(cfg, model, valid, device)
    out = []
    n = len(dataset)
    for start in range(0, n, bs):
        idx = range(start, min(start + bs, n))
        imgs = np.stack([dataset[i][0] for i in idx])
        if imgs.shape[0] < bs:  # pad the trailing batch: one shape for every step
            imgs = np.concatenate([imgs, np.repeat(imgs[-1:], bs - imgs.shape[0], axis=0)])
        masks = step(torch.from_numpy(imgs).to(device)).cpu().numpy()
        out.append(masks[:len(idx)])
    return np.concatenate(out) if out else np.zeros(
        (0, cfg.data.image_size, cfg.data.image_size), np.uint8)


def restore_for_inference(cfg: Config, device=None):
    """(model, last task) from the latest per-task checkpoint: the model
    alone (params and BatchNorm buffers) on ``device``, under
    ``model.padded_head=false`` built at the last task's head width
    (``cl_tpu/predict.py:80-83``)."""
    from cl_tpu_torch import checkpoint as ckpt_lib

    device = resolve_device(device)
    last = ckpt_lib.latest_task(cfg)
    if last is None:
        raise FileNotFoundError(f"no checkpoints in {cfg.train.checkpoint_dir!r}")
    width = None if cfg.model.padded_head else train_lib.task_head_width(cfg, last)
    model = train_lib.init_state(cfg, train_lib.build_model(cfg, head_width=width), device)
    return ckpt_lib.restore_model(cfg, model, last), last
