"""L4 — training driver: Python task loop, one eager train step per batch.

The counterpart of ``cl_tpu/train.py`` for the configurations this slice
of the port runs: the fine-tune baseline (no EWC / LwF / replay), the
standard UNet body, the host pipeline, one device. Per task: epochs of
augment → forward → masked CE → backward → optimizer step, then an eval
of every seen task; the same JSONL events (``epoch``, ``eval``,
``task_done``, ``done``) and the same report as the JAX package.

The loss takes the JAX package's branches (``cl_tpu/train.py:433-515``):
the fused head+CE kernel when ``train.fused_head_ce`` resolves on, else
the CE kernel on materialized logits when ``train.use_pallas``, else the
plain ``losses.cross_entropy``. Entry points run on the card: ``device``
None means ``cuda``, and without CUDA they raise; the CPU runs only when
the caller passes ``device="cpu"``. A config that needs a part of the JAX
package not ported yet raises ``NotImplementedError`` (``check_supported``).
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from cl_tpu_torch import losses, metrics
from cl_tpu_torch.augment import augment
from cl_tpu_torch.config import Config
from cl_tpu_torch.data import pipeline
from cl_tpu_torch.data import tasks as task_lib
from cl_tpu_torch.kernels import ce_loss, head_ce
from cl_tpu_torch.models.unet import UNet, init_weights

_LATER = "comes in a later slice of the port (ROADMAP.md Queue 1)"


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``. Raises if CUDA is asked for and absent: the port
    never drops to the CPU unless the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("cl_tpu_torch runs on a CUDA device and none is "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def _dtype(cfg: Config) -> torch.dtype:
    if cfg.train.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown compute_dtype {cfg.train.compute_dtype!r}")
    return torch.bfloat16 if cfg.train.compute_dtype == "bfloat16" else torch.float32


def _packed_engages(cfg: Config) -> bool:
    """``cl_tpu.train.build_model``'s gate for the packed UNet body."""
    m = cfg.model
    return m.packed_unet and (m.packed_min_size == 0 or (
        cfg.data.image_size >= m.packed_min_size and m.base_channels <= 32))


def check_supported(cfg: Config, device: torch.device | None = None) -> None:
    """Raise ``NotImplementedError`` for a config this slice does not run,
    instead of running something else."""
    m, t, d, meth = cfg.model, cfg.train, cfg.data, cfg.method
    unported = []
    if _packed_engages(cfg):
        unported.append(
            f"model.packed_unet engages at image_size={d.image_size} "
            f"(packed_min_size={m.packed_min_size}): the packed body "
            "(pass model.packed_unet=false for the standard body)")
    if m.conv_impl != "xla":
        unported.append(f"model.conv_impl={m.conv_impl!r} (Pallas convs)")
    if m.upconv_impl != "xla":
        unported.append(f"model.upconv_impl={m.upconv_impl!r}")
    if m.norm == "group":
        unported.append("model.norm='group'")
    if not m.padded_head:
        unported.append("model.padded_head=false (the grow-the-head variant)")
    if t.use_pallas and t.pallas_augment:
        unported.append("train.pallas_augment (the augment kernel)")
    if meth.methods:
        unported.append(f"method.methods={meth.methods} (EWC / LwF / replay)")
    if d.device_cache:
        unported.append("data.device_cache (device-resident dataset)")
    if d.dataset != "synthetic":
        unported.append(f"data.dataset={d.dataset!r}")
    if t.checkpoint_dir or t.resume:
        unported.append("train.checkpoint_dir / train.resume (checkpoints)")
    if t.spatial_parallel:
        unported.append("train.spatial_parallel")
    if t.remat:
        unported.append("train.remat")
    if t.multihost:
        unported.append("train.multihost")
    if t.profile_dir:
        unported.append("train.profile_dir (profiler traces)")
    if (t.data_parallel and device is not None and device.type == "cuda"
            and torch.cuda.device_count() > 1):
        unported.append(
            f"data parallelism over {torch.cuda.device_count()} cards "
            "(pass train.data_parallel=false to train on one)")
    if unported:
        raise NotImplementedError(
            "not in this slice of the port: " + "; ".join(unported)
            + f" — each {_LATER}")
    _dtype(cfg)


def build_model(cfg: Config) -> UNet:
    """The UNet of ``cfg`` on the CPU, weights not yet initialized."""
    return UNet(num_classes=cfg.data.num_classes,
                base_channels=cfg.model.base_channels,
                depth=cfg.model.depth, norm=cfg.model.norm,
                dtype=_dtype(cfg))


def init_state(cfg: Config, model: UNet, device: torch.device) -> UNet:
    """Seeded init (``torch.Generator`` from ``train.seed``; flax's init
    scheme, not its bits), then the model moves to ``device`` with its
    convs in channels_last."""
    init_weights(model, torch.Generator().manual_seed(cfg.train.seed))
    return model.to(device=device, memory_format=torch.channels_last)


def build_optimizer(cfg: Config, model: UNet) -> torch.optim.Optimizer:
    """Adam or SGD with the defaults of ``optax.adam`` / ``optax.sgd``
    (weight decay added to the gradient first, as
    ``optax.add_decayed_weights`` does)."""
    t = cfg.train
    if t.optimizer == "adam":
        return torch.optim.Adam(model.parameters(), lr=t.lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=t.weight_decay)
    if t.optimizer == "sgd":
        return torch.optim.SGD(model.parameters(), lr=t.lr,
                               momentum=t.momentum, weight_decay=t.weight_decay)
    raise ValueError(f"unknown optimizer {t.optimizer!r}")


def _set_precision(device: torch.device) -> None:
    # f32 compute means f32: cuDNN would otherwise convolve f32 in TF32
    # (about three decimal digits), and baseline_1 ships f32 to stay
    # comparable with the JAX package.
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def fused_head_on(cfg: Config) -> bool:
    """``train.fused_head_ce``: "auto" = on where base_channels <= 32."""
    fh = str(cfg.train.fused_head_ce).lower()
    on = cfg.model.base_channels <= 32 if fh == "auto" else fh in ("true", "on", "1")
    return cfg.train.use_pallas and on


# ---------------------------------------------------------------------------
# Train and eval steps
# ---------------------------------------------------------------------------


def make_train_step(cfg: Config, model: UNet, opt: torch.optim.Optimizer,
                    device=None) -> Callable:
    """``step(batch, valid_classes) -> aux``: one optimizer step on
    ``model`` (updated in place). ``batch`` is a ``HostBatch`` of tensors
    on the device; ``aux`` holds 0-d device tensors (loss, ce, n_pix), so
    the step does not wait for the device."""
    device = resolve_device(device)
    check_supported(cfg, device)
    _set_precision(device)
    d = cfg.data
    compute_dtype = _dtype(cfg)
    use_fused_head = fused_head_on(cfg)
    use_kernels = cfg.train.use_pallas

    def loss_fn(x, y, valid_classes):
        if use_fused_head:
            feats = model(x, return_features=True)
            return head_ce.head_cross_entropy(
                feats, model.head.weight, model.head.bias, y, valid_classes,
                ignore_index=d.ignore_index)
        logits = model(x)
        if use_kernels:
            # The model's f32 logits are upcast compute-dtype head outputs,
            # so the downcast is lossless and halves the kernel's operand.
            return ce_loss.cross_entropy(logits.to(compute_dtype), y,
                                         valid_classes,
                                         ignore_index=d.ignore_index)
        return losses.cross_entropy(logits, y, valid_classes,
                                    ignore_index=d.ignore_index)

    def step(batch: pipeline.HostBatch, valid_classes: torch.Tensor) -> dict:
        x, y = augment(batch.image, batch.mask, batch.flip,
                       out_size=d.image_size, mean=d.mean, std=d.std,
                       compute_dtype=compute_dtype)
        model.train()
        ce, n_pix = loss_fn(x, y, valid_classes)
        opt.zero_grad(set_to_none=True)
        ce.backward()
        opt.step()
        ce = ce.detach()
        return {"loss": ce, "ce": ce, "n_pix": n_pix}

    return step


def make_eval_step(cfg: Config, model: UNet, device=None) -> Callable:
    """``step(conf, batch, valid_classes) -> conf``: eval-mode forward and
    confusion-matrix update on the device."""
    device = resolve_device(device)
    check_supported(cfg, device)
    _set_precision(device)
    d = cfg.data
    compute_dtype = _dtype(cfg)

    @torch.no_grad()
    def step(conf, batch: pipeline.HostBatch, valid_classes):
        x, y = augment(batch.image, batch.mask, batch.flip,
                       out_size=d.image_size, mean=d.mean, std=d.std,
                       compute_dtype=compute_dtype)
        model.eval()
        logits = model(x)
        return metrics.confusion_matrix_update(
            conf, logits, y, valid_classes, ignore_index=d.ignore_index)

    return step


def evaluate_task(cfg: Config, eval_step, task_id: int,
                  seen_valid: np.ndarray, device=None) -> dict:
    """mIoU of ``task_id``'s val set, predicting among all seen classes."""
    device = resolve_device(device)
    C = cfg.data.num_classes
    conf = torch.zeros((C, C), dtype=torch.float32, device=device)
    valid = torch.from_numpy(np.asarray(seen_valid, bool)).to(device)
    for batch in pipeline.prefetch_to_device(
            pipeline.val_batches(cfg, task_id), device=device,
            depth=cfg.data.prefetch_depth):
        conf = eval_step(conf, batch, valid)
    return eval_result(cfg, conf, task_id)


def eval_result(cfg: Config, conf: torch.Tensor, task_id: int) -> dict:
    """Finish an eval: fetch the confusion matrix, reduce to mIoU."""
    conf_np = conf.cpu().numpy()
    task_classes = [task_lib.BACKGROUND] + cfg.classes_per_task[task_id]
    return {
        "confusion": conf_np,
        "miou": metrics.miou(conf_np, task_classes),
        "per_class_iou": metrics.iou_from_confusion(conf_np).tolist(),
    }


# ---------------------------------------------------------------------------
# Full continual run
# ---------------------------------------------------------------------------


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def train(cfg: Config, init_variables=None, device=None) -> dict:
    """The public train API: ``train(cfg) -> report``.

    ``init_variables``: optional flax ``{'params', 'batch_stats'}`` tree of
    numpy arrays to start from instead of the seeded init (the parity tests
    give both packages the same weights). ``device``: None = ``cuda``."""
    from cl_tpu_torch.logging_utils import EventLogger

    device = resolve_device(device)
    check_supported(cfg, device)
    logger = EventLogger(cfg.train.log_path, cfg.train.tensorboard_dir)
    try:
        return _train_impl(cfg, logger, init_variables, device)
    finally:
        logger.close()
        pipeline.make_datasets.cache_clear()


def _train_impl(cfg: Config, logger, init_variables, device) -> dict:
    from cl_tpu_torch.interop import load_jax_variables

    model = init_state(cfg, build_model(cfg), device)
    if init_variables is not None:
        load_jax_variables(model, init_variables)
    opt = build_optimizer(cfg, model)
    train_step = make_train_step(cfg, model, opt, device)
    eval_step = make_eval_step(cfg, model, device)

    splits = cfg.classes_per_task
    T = cfg.train.num_tasks
    miou_matrix = np.full((T, T), np.nan)
    step_times: list[tuple[float, int]] = []  # (epoch seconds, steps)
    # Eval accounting as in the JAX package: the first eval pass (first
    # use: kernel build, cuDNN set-up) is reported apart from the rate.
    eval_times: list[tuple[float, int]] = []
    eval_overhead = {"compile_s": 0.0, "compile_passes": 0}

    def _eval_task(k, seen_valid):
        first = eval_overhead["compile_passes"] == 0
        t0 = time.perf_counter()
        r = evaluate_task(cfg, eval_step, k, seen_valid, device)
        r["n_images"] = len(pipeline.make_datasets(cfg, k)[1])
        exec_s = time.perf_counter() - t0
        if first:
            eval_overhead["compile_passes"] += 1
            eval_overhead["compile_s"] += exec_s
        else:
            eval_times.append((exec_s, int(r["n_images"])))
        return r

    for task_id in range(T):
        seen = task_lib.seen_classes(splits, task_id)
        seen_valid = task_lib.valid_class_mask(cfg.data.num_classes, seen)
        valid_dev = torch.from_numpy(seen_valid).to(device)
        t_task = time.perf_counter()

        for epoch in range(cfg.train.epochs_per_task):
            # Losses stay on the device during the epoch: fetching each
            # one would wait for the device every step.
            losses_dev = []
            batch_it = pipeline.prefetch_to_device(
                pipeline.train_batches(cfg, task_id, epoch), device=device,
                depth=cfg.data.prefetch_depth)
            t_ep = time.perf_counter()
            for batch in batch_it:
                losses_dev.append(train_step(batch, valid_dev)["loss"])
            # the fetch of the losses is the epoch's sync
            ep_loss = float(np.mean(torch.stack(losses_dev).cpu().numpy())) \
                if losses_dev else 0.0
            ep_time = time.perf_counter() - t_ep
            # Steady state only: the run's first epoch carries the kernel
            # build and first-use set-up.
            if not (epoch == 0 and task_id == 0):
                step_times.append((ep_time, len(losses_dev)))
            logger.log(event="epoch", task=task_id, epoch=epoch,
                       loss=ep_loss, steps=len(losses_dev))
            if cfg.train.eval_every_epoch:
                r = _eval_task(task_id, seen_valid)
                logger.log(event="epoch_eval", task=task_id, epoch=epoch,
                           miou=r["miou"])

        for k in range(task_id + 1):
            res = _eval_task(k, seen_valid)
            miou_matrix[task_id, k] = res["miou"]
            logger.log(event="eval", after_task=task_id, task=k,
                       miou=res["miou"])

        logger.log(event="task_done", task=task_id,
                   seconds=time.perf_counter() - t_task)
        if cfg.train.fail_after_task == task_id:
            raise RuntimeError(f"fault injection: fail_after_task={task_id}")

    report = metrics.forgetting_report(miou_matrix)
    report["config_hash"] = cfg.config_hash()
    report["device"] = device_name(device)
    if step_times:
        total_s = sum(t for t, _ in step_times)
        total_steps = sum(n for _, n in step_times)
        if total_s > 0 and total_steps > 0:
            report["images_per_sec_per_chip"] = float(
                cfg.data.batch_size * total_steps / total_s)
    if eval_times:
        e_s = sum(t for t, _ in eval_times)
        e_n = sum(n for _, n in eval_times)
        if e_s > 0 and e_n > 0:
            report["eval_images_per_sec_per_chip"] = float(e_n / e_s)
    if eval_overhead["compile_passes"]:
        report["eval_overhead_seconds"] = {
            "cache_build": 0.0,
            "compile_passes": eval_overhead["compile_passes"],
            "compile": round(eval_overhead["compile_s"], 3)}
    logger.log(event="done", **{k: v for k, v in report.items()
                                if k != "miou_matrix"})
    return report
