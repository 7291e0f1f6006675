"""L4 — training driver: Python task loop, one eager train step per batch.

The counterpart of ``cl_tpu/train.py`` for the configurations the port
runs so far: the fine-tune baseline and the three methods (EWC, LwF,
replay with the host or the device-resident buffer), the standard UNet
body (BatchNorm, GroupNorm or none) and the packed one
(``model.packed_unet`` at its engage sizes), the padded head or
grow-the-head (``model.padded_head=false``), one
device or a data-parallel group of them. Data comes from the host pipeline, or with ``data.device_cache``
from the task's dataset parked on the device and plan-driven epochs
(``data/device_cache.py``, ``data/cached_exec.py``): no host → device copy
and no host wait inside a step. Per task: epochs of (replay mix →) augment
(the augment kernels #15/#16 under ``train.pallas_augment``) → forward →
loss → backward → optimizer step, then an eval of every seen task and the
after-task hooks in ``cl_tpu``'s order (EWC's Fisher pass and
consolidation, the LwF snapshot, the replay buffer's fill), then with
``train.checkpoint_dir`` the task's checkpoint (``checkpoint.py``);
``train.resume`` goes on after the latest one. The same JSONL events
(``resumed``, ``epoch``, ``eval``, ``hbm_live_set``, ``task_done``,
``done``) and the same report as the JAX package; ``evaluate`` is the
public eval API.

The loss takes the JAX package's branches (``cl_tpu/train.py:391-515``):
on the packed body with the fused head and ``train.packed_head_ce`` (the
headline step), the packed BN·ReLU + head + CE kernels on the body's raw
output, or under LwF their KD form with the teacher's raw output; else
(and where the packed body does not engage) the fused head+CE kernel on
NHWC features when ``train.fused_head_ce`` resolves on, under LwF its KD
form with the teacher's features; else the CE kernel on materialized
logits when ``train.use_pallas``, under LwF with the KD kernel on both
logit tensors cast to the compute dtype; else the plain
``losses.cross_entropy`` (plus ``losses.kd_loss`` under LwF). EWC adds
λ·penalty on every route, through
the penalty kernels under ``train.use_pallas``. Entry points run on the
card: ``device`` None means ``cuda``, and without CUDA they raise; the CPU
runs only when the caller passes ``device="cpu"``. The port runs every
config ``cl_tpu`` runs; one whose train step ``cl_tpu`` fails raises
(``check_supported``), and no route drops to another loss.

Grow-the-head (``model.padded_head=false``, ``cl_tpu/train.py:1092-1103,
:1298-1303``): the model starts with a head as wide as task 0's classes
(``task_head_width``); at the start of each task whose classes reach past
it, ``expand_state`` grows the head (new rows from a generator seeded by
``train.seed`` and 500 + the task id), the EWC vectors and the LwF
teacher with zeros, and builds a fresh optimizer, and the loop rebuilds
its steps. The logits are padded to ``num_classes`` with −1e9 in the
model; the head kernels zero-pad a narrow head themselves.

``train.profile_dir`` traces epoch min(1, epochs_per_task − 1) of the
first task run with ``torch.profiler`` (CPU, and CUDA on a card) into a
Chrome / Perfetto trace there, one file a rank, logs ``profile`` and
leaves the epoch out of the rate (``cl_tpu/train.py:1307-1312,
:1396-1407``).

``train.remat`` rematerializes each UNet level (``models/unet.py``).
``train.data_parallel`` over a group of processes (``sharding.py``: one
per card, under ``torchrun``, spawned by ``train()`` over the visible
cards, or a group the caller initialized) runs ``cl_tpu``'s mesh routes:
the model built with the group (``build_model(cfg, dp)``: BatchNorm over
the global batch), each rank's rows of the same global batch, the loss
kernels' sharded forms (each rank's share of the global mean), the
gradient summed over the group in one flat all-reduce, then EWC's
replicated penalty's gradient added once on every rank; the eval's
confusion matrix and the Fisher's gradient summed likewise. The steps read
the group from ``model.dp``; rank 0 logs and writes the checkpoints.

``train.spatial_parallel`` over a group (``sharding.SpatialParallel``,
which takes precedence over data parallelism) runs ``cl_tpu``'s spatial
routes (``cl_tpu/train.py:1062-1186``): the model's forward height-sharded
(``parallel/spatial.py``) in the train, eval and Fisher steps and the LwF
teacher; the whole batch on every rank and the labels of the rank's rows;
no kernel route (the plain losses, KD, EWC penalty, augment and Fisher
accumulation, as ``cl_tpu`` runs there); the packed body, the device
replay buffer and the device cache turned off with ``cl_tpu``'s warnings
and events; ``ValueError`` unless ``model.norm=group`` and the image size
divides by n·2^depth. ``model.conv_impl`` and ``train.remat`` do not
reach the spatial forward, as in ``cl_tpu``; a grown head runs at its own
width. One process with the flag trains unsharded, with no check.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Callable

import numpy as np
import torch

from cl_tpu_torch import losses, metrics, sharding
from cl_tpu_torch.augment import augment
from cl_tpu_torch.config import Config
from cl_tpu_torch.data import cached_exec, pipeline
from cl_tpu_torch.data import tasks as task_lib
from cl_tpu_torch.data.device_cache import DeviceDatasetCache
from cl_tpu_torch.devices import resolve_device
from cl_tpu_torch.kernels import ce_loss, ewc_fused, head_ce, kd_loss, replay_gather
from cl_tpu_torch.methods import ewc as ewc_lib
from cl_tpu_torch.methods import lwf as lwf_lib
from cl_tpu_torch.methods.replay import ReplayBuffer
from cl_tpu_torch.models import packed_gate
from cl_tpu_torch.models.unet import UNet, expand_head, expand_head_zeros, init_weights

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
    """Raise for a config ``cl_tpu`` rejects or fails, instead of running
    something else: ``ValueError`` for an unknown option or a tuning
    variable ``cl_tpu`` cannot parse, ``NotImplementedError`` for a
    standard-body route whose train step ``cl_tpu`` fails. Unknown
    ``method.methods`` names are ignored, as ``cl_tpu`` ignores them (it
    only tests membership)."""
    m, meth = cfg.model, cfg.method
    if m.conv_impl not in ("xla", "v3", "auto", "pallas", "hybrid"):
        raise ValueError(f"unknown model.conv_impl {m.conv_impl!r}")
    if m.upconv_impl not in ("xla", "matmul"):
        raise ValueError(f"unknown model.upconv_impl {m.upconv_impl!r}")
    packed_gate.check_tuning()
    if meth.ewc_fisher_kind not in ("empirical", "true"):
        raise ValueError(f"unknown method.ewc_fisher_kind {meth.ewc_fisher_kind!r}")
    dtype = _dtype(cfg)
    packed = _packed_engages(cfg) and m.norm == "batch" and packed_gate.packed_prefix(
        cfg.data.image_size, m.base_channels, m.depth, dtype.itemsize) > 0
    if not packed:  # the standard body: the gen-3 routes (the gen-2 ones all run)
        why = packed_gate.standard_body_refusal(cfg.data.image_size, m.base_channels, m.depth,
                                                m.conv_impl, m.norm, dtype.itemsize)
        if why:
            raise NotImplementedError(
                f"model.conv_impl={m.conv_impl!r} at {cfg.data.image_size}² in "
                f"{cfg.train.compute_dtype}: cl_tpu fails this config's train step, so the "
                f"port refuses it: {why}")


def task_head_width(cfg: Config, task_id: int) -> int:
    """The grow-the-head width after ``task_id``'s classes are seen: the
    splits are contiguous global ids, so max(seen) + 1
    (``cl_tpu/train.py:91-95``)."""
    return max(task_lib.seen_classes(cfg.classes_per_task, task_id)) + 1


def build_model(cfg: Config, dp: sharding.DataParallel | None = None,
                head_width: int | None = None) -> UNet:
    """The UNet of ``cfg`` on the CPU, weights not yet initialized; with
    ``dp``, its BatchNorm over the group's global batch (``cl_tpu``'s
    model under a mesh, ``_pick_fwd_apply``). ``head_width`` None: the
    padded head, or under ``model.padded_head=false`` task 0's width."""
    if head_width is None and not cfg.model.padded_head:
        head_width = task_head_width(cfg, 0)
    model = UNet(num_classes=cfg.data.num_classes, head_width=head_width,
                 base_channels=cfg.model.base_channels,
                 depth=cfg.model.depth, norm=cfg.model.norm,
                 dtype=_dtype(cfg), packed=_packed_engages(cfg),
                 conv_impl=cfg.model.conv_impl,
                 act_q=cfg.model.conv_act_store == "int8",
                 upconv_impl=cfg.model.upconv_impl, remat=cfg.train.remat)
    return model.set_data_parallel(dp, per_shard=cfg.model.packed_unet)


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


def head_generator(cfg: Config, task_id: int) -> torch.Generator:
    """The CPU generator of the new head rows when the head grows for
    ``task_id``, seeded from ``train.seed`` and 500 + ``task_id``
    (``cl_tpu`` folds 500 + task_id into its state's key, ``train.py:924``;
    the bits differ, as the seeded init's do). On the CPU, so every
    device and every rank of a group draws the same rows."""
    seed = np.random.SeedSequence([cfg.train.seed, 500 + task_id]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(seed))


def expand_state(cfg: Config, state, new_width: int, task_id: int):
    """Grow-the-head's state surgery (``cl_tpu``'s ``_expand_state``,
    ``train.py:914-939``) on a ``checkpoint.TrainState``, in place: the
    model's head to ``new_width`` (``unet.expand_head``, rows from
    ``head_generator``), EWC's anchor and Fisher and the LwF teacher with
    zeros at the new rows, and a fresh optimizer for every param (Adam's
    moments zero and its step 0, SGD's momentum gone), as ``cl_tpu``'s
    ``tx.init(params)``. The caller rebuilds its steps: they hold the old
    optimizer. A width not above the head's changes nothing."""
    old = state.model.head.weight.shape[0]
    if new_width <= old:
        return state
    expand_head(state.model, new_width, head_generator(cfg, task_id))
    if state.ewc is not None:
        ewc_lib.expand_head_zeros(state.ewc, state.model, old)
    if state.lwf is not None:  # old_valid keeps its num_classes width
        expand_head_zeros(state.lwf.teacher, new_width)
    state.optimizer = build_optimizer(cfg, state.model)
    return state


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


def augment_kernels_on(cfg: Config, dp=None) -> bool:
    """The train, eval and Fisher steps augment through kernels #15/#16
    (``cl_tpu/train.py:59-69``: ``train.use_pallas`` and
    ``train.pallas_augment``), else through their plain versions. Under a
    group the kernels are off: ``cl_tpu``'s route under a mesh
    (``train.py:243``, ``:357``, ``:664-665``)."""
    return cfg.train.use_pallas and cfg.train.pallas_augment and dp is None


def _local(batch, dp):
    """This rank's rows of a global batch (the batch itself without a
    group)."""
    return batch if dp is None else dp.local(batch)


def packed_head_on(cfg: Config) -> bool:
    """The loss takes the packed BN·ReLU + head + CE (kernels #7/#8; under
    LwF their KD form, #11/#12): the fused head on the packed body with
    ``train.packed_head_ce`` (``cl_tpu/train.py:371-373`` and the body's
    gate)."""
    return fused_head_on(cfg) and _packed_engages(cfg) and cfg.train.packed_head_ce


# ---------------------------------------------------------------------------
# Train and eval steps
# ---------------------------------------------------------------------------


def make_train_step(cfg: Config, model: UNet, opt: torch.optim.Optimizer,
                    device=None, lwf: lwf_lib.LwFState | None = None,
                    ewc: ewc_lib.EWCState | None = None) -> Callable:
    """``step(batch, valid_classes) -> aux``: one optimizer step on
    ``model`` (updated in place). ``batch`` is a ``HostBatch`` of tensors
    on the device (under replay already widened by the replay rows);
    ``aux`` holds 0-d device tensors (loss, ce, n_pix, ``ewc_penalty``
    under EWC, kd under LwF), so the step does not wait for the device.
    ``lwf`` / ``ewc``: the ``methods.lwf.LwFState`` / ``methods.ewc.EWCState``
    when ``method.methods`` has the method; the step reads them at every
    call. Under ``model.dp`` (``build_model(cfg, dp)``) ``batch`` is this
    rank's rows of the global batch, and ``aux`` holds the global batch's
    losses on every rank."""
    device = resolve_device(device)
    check_supported(cfg, device)
    _set_precision(device)
    d, m = cfg.data, cfg.method
    dp = model.dp
    compute_dtype = _dtype(cfg)
    aug_kernels = augment_kernels_on(cfg, dp)
    # no kernel route under spatial parallelism: cl_tpu runs the plain
    # losses, KD and EWC penalty there (train.py:234, :253, :345)
    spatial = dp is not None and dp.spatial
    use_packed_head = packed_head_on(cfg) and not spatial
    use_fused_head = fused_head_on(cfg) and not spatial
    use_kernels = cfg.train.use_pallas and not spatial
    use_lwf = "lwf" in m.methods
    if use_lwf and lwf is None:
        raise ValueError("method.methods has lwf: pass "
                         "lwf=methods.lwf.make_lwf_state(model)")
    use_ewc = "ewc" in m.methods
    if use_ewc and ewc is None:
        raise ValueError("method.methods has ewc: pass "
                         "ewc=methods.ewc.make_ewc_state(model, mode=...)")
    ewc_penalty = ewc_fused.penalty if use_kernels else ewc_lib.penalty

    def loss_fn(x, y, valid_classes):
        """(ce, n_pix, weighted KD or None); under a group ce and KD are
        the rank's shares of the global means (the loss kernels' sharded
        forms, ``cl_tpu/train.py:254-335``) and n_pix the global count. The
        teacher runs first, as in ``cl_tpu``: its forward's transients are
        freed before the student's forward saves its activations."""
        ignore, temp = d.ignore_index, m.lwf_temperature
        if use_fused_head:
            hk, hb = model.head.weight, model.head.bias
            if use_lwf:
                tfeats = lwf_lib.old_features(lwf, x, packed=use_packed_head)
                thk, thb = lwf.teacher.head.weight, lwf.teacher.head.bias
            feats = model(x, return_features=True, packed_features=use_packed_head)
            # the packed body hands back its raw output and deferred BN where
            # it engaged; else NHWC features, and the loss takes the fused
            # head on them (cl_tpu/train.py:441, its `pk` test)
            if isinstance(feats, tuple):
                if use_lwf:
                    ce, kd_raw, n_pix = head_ce.head_cross_entropy_kd_packed_bn(
                        *feats, hk, hb, *tfeats, thk, thb, y, valid_classes,
                        lwf.old_valid, temperature=temp, ignore_index=ignore, dp=dp)
                    return ce, n_pix, lwf.weight * kd_raw
                return (*head_ce.head_cross_entropy_packed_bn(
                    *feats, hk, hb, y, valid_classes, ignore_index=ignore, dp=dp), None)
            if use_lwf:
                ce, kd_raw, n_pix = head_ce.head_cross_entropy_kd(
                    feats, hk, hb, tfeats, thk, thb, y, valid_classes, lwf.old_valid,
                    temperature=temp, ignore_index=ignore, dp=dp)
                return ce, n_pix, lwf.weight * kd_raw
            return (*head_ce.head_cross_entropy(feats, hk, hb, y, valid_classes,
                                                ignore_index=ignore, dp=dp), None)
        old = lwf_lib.old_logits(lwf, x) if use_lwf else None
        logits = model(x)
        if use_kernels:
            # The model's f32 logits are upcast compute-dtype head outputs,
            # so the downcast is lossless and halves the kernels' operands;
            # the teacher's likewise (cl_tpu/train.py:498-504).
            logits = logits.to(compute_dtype)
            ce, n_pix = ce_loss.cross_entropy(logits, y, valid_classes, ignore_index=ignore,
                                              dp=dp)
            if not use_lwf:
                return ce, n_pix, None
            kd = kd_loss.kd_loss(logits, old.to(compute_dtype), lwf.old_valid, y,
                                 temperature=temp, ignore_index=ignore, dp=dp)
            return ce, n_pix, lwf.weight * kd
        ce, n_pix = losses.cross_entropy(logits, y, valid_classes, ignore_index=ignore,
                                          dp=dp)
        if not use_lwf:
            return ce, n_pix, None
        kd = losses.kd_loss(logits, old, lwf.old_valid, y, temperature=temp,
                            ignore_index=ignore, dp=dp)
        return ce, n_pix, lwf.weight * kd

    def step(batch: pipeline.HostBatch, valid_classes: torch.Tensor) -> dict:
        x, y = augment(batch.image, batch.mask, batch.flip,
                       out_size=d.image_size, mean=d.mean, std=d.std,
                       compute_dtype=compute_dtype, use_kernels=aug_kernels)
        if dp is not None:  # under spatial, the labels of this rank's rows
            y = dp.output_rows(y)
        model.train()
        ce, n_pix, kd = loss_fn(x, y, valid_classes)
        opt.zero_grad(set_to_none=True)
        pen = ewc_penalty(ewc_lib.flat_params(model), ewc, mode=m.ewc_mode) if use_ewc else None
        if dp is not None:
            return dp_backward(ce, n_pix, kd, pen)
        # cl_tpu's order (train.py:404-420): ce, + λ·penalty, + α·kd
        total = ce
        aux = {"ce": ce.detach(), "n_pix": n_pix}
        if use_ewc:
            total = total + m.ewc_lambda * pen
            aux["ewc_penalty"] = pen.detach()
        if kd is not None:
            total = total + m.lwf_alpha * kd
            aux["kd"] = kd.detach()
        total.backward()
        opt.step()
        aux["loss"] = total.detach()
        return aux

    def dp_backward(ce, n_pix, kd, pen):
        """The data-parallel backward: the rank's shares' gradient, summed
        over the group in one flat all-reduce, then the replicated EWC
        penalty's gradient once on every rank (``cl_tpu/train.py:340-356``),
        then the step. The losses in ``aux`` are the global ones, in
        ``cl_tpu``'s order."""
        share = ce if kd is None else ce + m.lwf_alpha * kd
        share.backward()
        sharding.all_reduce_grads(model.parameters(), dp)
        if pen is not None:
            (m.ewc_lambda * pen).backward()
        opt.step()
        parts = torch.stack([ce.detach(), ce.detach() if kd is None else kd.detach()])
        ce_g, kd_g = dp.all_reduce_(parts)
        aux = {"ce": ce_g, "n_pix": n_pix}
        total = ce_g
        if pen is not None:
            total = total + m.ewc_lambda * pen.detach()
            aux["ewc_penalty"] = pen.detach()
        if kd is not None:
            total = total + m.lwf_alpha * kd_g
            aux["kd"] = kd_g
        aux["loss"] = total
        return aux

    return step


def make_eval_step(cfg: Config, model: UNet, device=None) -> Callable:
    """``step(conf, batch, valid_classes) -> conf``: eval-mode forward and
    confusion-matrix update on the device (under ``model.dp``, of this
    rank's rows: ``evaluate_task`` sums the matrices over the group)."""
    device = resolve_device(device)
    check_supported(cfg, device)
    _set_precision(device)
    d = cfg.data
    compute_dtype = _dtype(cfg)
    aug_kernels = augment_kernels_on(cfg, model.dp)

    @torch.no_grad()
    def step(conf, batch: pipeline.HostBatch, valid_classes):
        x, y = augment(batch.image, batch.mask, batch.flip,
                       out_size=d.image_size, mean=d.mean, std=d.std,
                       compute_dtype=compute_dtype, use_kernels=aug_kernels)
        model.eval()
        logits = model(x)
        if model.dp is not None:
            y = model.dp.output_rows(y)
        return metrics.confusion_matrix_update(
            conf, logits, y, valid_classes, ignore_index=d.ignore_index)

    return step


# ---------------------------------------------------------------------------
# Plan-driven steps over the device-resident dataset cache
# ---------------------------------------------------------------------------


def make_cached_train_step(train_step: Callable, dp=None) -> Callable:
    """``cstep(s, cache, plan, valid_classes, replay=None) -> aux``: step
    ``s`` of a plan-driven epoch (``cl_tpu``'s ``make_cached_train_step``):
    the batch gathered on the device from ``cache`` by row ``s`` of the
    device-resident ``plan``, widened by step ``s``'s replay rows
    (``replay``: ``(mode, idx, flips[, images, masks])`` of
    ``cached_exec.build_replay_plan`` / ``replay_arrays``), then
    ``train_step``. No host → device copy and no host wait. Under ``dp``
    every rank holds the whole cache and the same plan, gathers the
    global batch and trains on its rows (``cl_tpu``'s ``_constrain_batch``)."""

    def cstep(s, cache, plan, valid_classes, replay=None):
        batch = cached_exec.gather_batch(cache.images, cache.masks, plan, s)
        if replay is not None:
            batch = cached_exec.widen_with_replay(batch, replay[0], replay[1], replay[2], s,
                                                  *replay[3:])
        return train_step(_local(batch, dp), valid_classes)

    return cstep


def make_cached_eval_step(cfg: Config, eval_step: Callable, dp=None) -> Callable:
    """``cstep(conf, s, cache, plan, valid_classes) -> conf``: eval step
    ``s`` over the val cache (under ``dp`` on this rank's rows); the
    plan's padded rows carry an all-ignore mask."""
    ignore = cfg.data.ignore_index

    def cstep(conf, s, cache, plan, valid_classes):
        batch = cached_exec.gather_batch(cache.images, cache.masks, plan, s, ignore_index=ignore)
        return eval_step(conf, _local(batch, dp), valid_classes)

    return cstep


def make_cached_fisher_step(fisher_step: Callable, dp=None) -> Callable:
    """``cstep(acc, s, cache, plan, valid_classes, generator=None) -> acc``:
    Fisher step ``s`` over the train cache (under ``dp`` on this rank's
    rows)."""

    def cstep(acc, s, cache, plan, valid_classes, generator=None):
        batch = cached_exec.gather_batch(cache.images, cache.masks, plan, s)
        return fisher_step(acc, _local(batch, dp), valid_classes, generator)

    return cstep


def evaluate_task(cfg: Config, eval_step, task_id: int,
                  seen_valid: np.ndarray, device=None, cache=None, dp=None) -> dict:
    """mIoU of ``task_id``'s val set, predicting among all seen classes:
    from the host pipeline, or, given ``cache`` (the task's val set on the
    device), over the padded eval plan (``cl_tpu/train.py:1239-1296``).
    Under ``dp`` each rank evaluates its rows of every batch and the
    confusion matrices are summed over the group (integer counts in f32:
    the same matrix as one process's)."""
    device = resolve_device(device)
    C = cfg.data.num_classes
    conf = torch.zeros((C, C), dtype=torch.float32, device=device)
    valid = torch.from_numpy(np.asarray(seen_valid, bool)).to(device)
    if cache is not None:
        plan = cached_exec.build_plan(
            cache.n, batch_size=cfg.data.batch_size, epoch=0,
            seed=cfg.data.shuffle_seed + 1000 * task_id, shuffle=False, flip_prob=0.0,
            pad_final=True, device=device)
        cstep = make_cached_eval_step(cfg, eval_step, dp)
        for s in range(plan.steps):
            conf = cstep(conf, s, cache, plan, valid)
    else:
        for batch in pipeline.prefetch_to_device(
                (_local(b, dp) for b in pipeline.val_batches(cfg, task_id)), device=device,
                depth=cfg.data.prefetch_depth):
            conf = eval_step(conf, batch, valid)
    if dp is not None:
        dp.all_reduce_(conf)
    return eval_result(cfg, conf, task_id)


def evaluate(cfg: Config, model: UNet, task_id: int, seen_task: int | None = None,
             device=None) -> dict:
    """The public eval API (``cl_tpu/train.py:1530-1549``): the mIoU of
    ``task_id``'s val set through the host pipeline, predicting among the
    classes seen up to ``seen_task`` (default: ``task_id``). ``model`` on
    ``device`` (None = ``cuda``). Honors ``train.data_parallel`` as
    ``train()`` does: in a group (``sharding.join``) the val batches shard
    over it and ``model`` takes the group (``set_data_parallel``); with no
    group the eval runs on the one device."""
    device = resolve_device(device)
    dp = sharding.join(cfg, device)
    device = sharding.rank_device(device)
    model.set_data_parallel(dp, per_shard=cfg.model.packed_unet)
    eval_step = make_eval_step(cfg, model, device)
    seen_task = task_id if seen_task is None else seen_task
    seen_valid = task_lib.valid_class_mask(
        cfg.data.num_classes, task_lib.seen_classes(cfg.classes_per_task, seen_task))
    return evaluate_task(cfg, eval_step, task_id, seen_valid, device, dp=dp)


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
# EWC's Fisher pass and the replay mix
# ---------------------------------------------------------------------------


def fisher_generator(cfg: Config, task_id: int, device=None) -> torch.Generator:
    """The sampled Fisher's generator for the pass after ``task_id``, on
    ``device``, seeded from ``train.seed`` and the task id (``cl_tpu`` folds
    1000 + task_id into its state's key, ``cl_tpu/train.py:873-906``)."""
    seed = np.random.SeedSequence([cfg.train.seed, 1000 + task_id]).generate_state(1)[0]
    return torch.Generator(device=resolve_device(device)).manual_seed(int(seed))


def make_fisher_step(cfg: Config, model: UNet, device=None) -> Callable:
    """``step(acc, batch, valid_classes, generator=None) -> acc``: acc +=
    (∂CE/∂θ)² of one batch, the model in eval mode (``cl_tpu/train.py:773-819``).
    The labels are the batch's (``method.ewc_fisher_kind=empirical``) or,
    under ``true``, drawn from the model's softmax on ``generator``
    (``fisher_generator``; ``methods.ewc.sample_fisher_labels``). ``acc``: a
    flat f32 vector in ``flat_params`` order, updated in place by the
    accumulation kernel (#19) under ``train.use_pallas``, else by its plain
    version. The CE is the plain ``losses.cross_entropy``, as in
    ``cl_tpu``. Under ``model.dp`` ``batch`` is this rank's rows, and the
    squared gradient is the global batch's mean CE's, summed over the group
    before #19 squares it; the sampled labels are drawn over the global
    batch."""
    device = resolve_device(device)
    check_supported(cfg, device)
    _set_precision(device)
    d = cfg.data
    dp = model.dp
    compute_dtype = _dtype(cfg)
    aug_kernels = augment_kernels_on(cfg, dp)
    # #19's plain version under spatial parallelism (cl_tpu/train.py:778)
    use_kernel = cfg.train.use_pallas and not (dp is not None and dp.spatial)
    accumulate = ewc_fused.sq_accumulate if use_kernel else ewc_fused.sq_acc_plain
    sampled = cfg.method.ewc_fisher_kind == "true"

    def step(acc, batch: pipeline.HostBatch, valid_classes, generator=None):
        if sampled and generator is None:
            raise ValueError("method.ewc_fisher_kind=true: pass the pass's "
                             "generator (train.fisher_generator)")
        x, y = augment(batch.image, batch.mask, batch.flip,
                       out_size=d.image_size, mean=d.mean, std=d.std,
                       compute_dtype=compute_dtype, use_kernels=aug_kernels)
        if dp is not None:
            y = dp.output_rows(y)
        g = ewc_lib.fisher_batch_grads(model, x, y, valid_classes,
                                       ignore_index=d.ignore_index,
                                       generator=generator if sampled else None, dp=dp)
        return accumulate(acc, g)

    return step


def run_fisher_pass(cfg: Config, fisher_step, model: UNet, task_id: int,
                    seen_valid: np.ndarray, device=None, cache=None) -> torch.Tensor:
    """The mean of the squared gradients over up to
    ``method.ewc_fisher_batches`` batches of ``train_batches(cfg, task_id,
    10_000 + task_id)`` (``cl_tpu/train.py:885-911``): a flat f32 vector.
    Given ``cache`` (the task's train set on the device), the same batches
    come from the plan of that epoch, truncated to the Fisher's batches
    (``cl_tpu/train.py:1425-1446``). Under the sampled Fisher both paths
    draw from one ``fisher_generator(cfg, task_id)`` in the batches'
    order, so they draw the same labels. Under ``model.dp`` each rank
    steps through the same batches and feeds its rows."""
    device = resolve_device(device)
    dp = model.dp
    acc = torch.zeros(ewc_lib.n_params(model), dtype=torch.float32, device=device)
    valid = torch.from_numpy(np.asarray(seen_valid, bool)).to(device)
    gen = fisher_generator(cfg, task_id, device) \
        if cfg.method.ewc_fisher_kind == "true" else None
    if cache is not None:
        plan = cached_exec.build_plan(
            cache.n, batch_size=cfg.data.batch_size, epoch=10_000 + task_id,
            seed=cfg.data.shuffle_seed + 1000 * task_id, shuffle=True,
            flip_prob=cfg.data.flip_prob, device=device)
        n = min(plan.steps, cfg.method.ewc_fisher_batches)
        cstep = make_cached_fisher_step(fisher_step, dp)
        for s in range(n):
            acc = cstep(acc, s, cache, plan, valid, gen)
        return acc / max(n, 1)
    n = 0
    batch_it = pipeline.prefetch_to_device(
        (_local(b, dp) for b in pipeline.train_batches(cfg, task_id, 10_000 + task_id)),
        device=device, depth=cfg.data.prefetch_depth)
    try:
        for batch in batch_it:
            if n >= cfg.method.ewc_fisher_batches:
                break
            acc = fisher_step(acc, batch, valid, gen)
            n += 1
    finally:
        batch_it.close()  # the pass usually stops early: retire the prefetch now
    return acc / max(n, 1)


def device_replay_on(cfg: Config, dp=None) -> bool:
    """The device-resident replay buffer (``method.replay_device_resident``),
    off under a group without ``data.device_cache``: ``cl_tpu``'s route on
    a mesh (``train.py:1151-1160``), where the host buffer's draws are the
    same ``RandomState`` calls, so the result is the same; off under
    spatial parallelism (``train.py:1140-1150``)."""
    return cfg.method.replay_device_resident and (
        dp is None or (cfg.data.device_cache and not dp.spatial))


def make_replay_buffer(cfg: Config, device=None, dp=None):
    """The config's replay buffer: the device-resident one
    (``device_replay_on``), the host one, or None. Under ``dp`` every rank
    holds the whole buffer and makes the same draws."""
    if "replay" not in cfg.method.methods:
        return None
    seed = cfg.data.shuffle_seed + 999
    if device_replay_on(cfg, dp):
        return replay_gather.DeviceReplayBuffer(cfg.method.replay_capacity,
                                                cfg.data.source_size, seed=seed,
                                                device=resolve_device(device))
    return ReplayBuffer(cfg.method.replay_capacity, seed=seed)


def _device_replay_mix(buf: replay_gather.DeviceReplayBuffer, batch: pipeline.HostBatch,
                       k: int, *, flip_prob: float) -> pipeline.HostBatch:
    """Widen a device batch by k rows gathered from the device-resident
    buffer (kernel #20, once for the images and once for the masks); on an
    empty buffer (task 0), k rows of the batch itself, so the step has one
    shape from the first step on (``cl_tpu/train.py:941-961``)."""
    idx = buf.sample_indices(k)
    if idx is None:
        dup = replay_gather.to_device(
            buf.rng.randint(0, batch.image.shape[0], size=k).astype(np.int64),
            batch.image.device)
        extra = pipeline.HostBatch(*(t.index_select(0, dup) for t in batch))
    else:
        imgs, masks = buf.gather(idx)
        extra = pipeline.HostBatch(imgs, masks, buf.sample_flips(k, flip_prob))
    return pipeline.HostBatch(*(torch.cat([a, b]) for a, b in zip(batch, extra)))


def after_task(cfg: Config, task_id: int, model: UNet, *, ewc=None, fisher_step=None,
               lwf=None, replay=None, device=None, cache=None) -> None:
    """The after-task hooks in ``cl_tpu``'s order (``cl_tpu/train.py:1424-1464``):
    EWC's Fisher pass (over ``cache``, the task's train set on the device,
    where given) and consolidation and the LwF snapshot after every task
    but the last, then the replay buffer's fill with max(1, capacity // T)
    of the task's train images."""
    T = cfg.train.num_tasks
    seen_valid = task_lib.valid_class_mask(
        cfg.data.num_classes, task_lib.seen_classes(cfg.classes_per_task, task_id))
    if ewc is not None and task_id < T - 1:
        fisher_new = run_fisher_pass(cfg, fisher_step, model, task_id, seen_valid, device,
                                     cache)
        ewc_lib.ewc_after_task(ewc, model, fisher_new, mode=cfg.method.ewc_mode,
                               gamma=cfg.method.ewc_gamma, task_id=task_id)
    if lwf is not None and task_id < T - 1:
        lwf_lib.lwf_after_task(lwf, model, torch.from_numpy(seen_valid))
    if replay is not None:
        train_ds, _ = pipeline.make_datasets(cfg, task_id)
        replay.add_examples(train_ds, max(1, cfg.method.replay_capacity // T),
                            task_id=task_id)


# ---------------------------------------------------------------------------
# Full continual run
# ---------------------------------------------------------------------------


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def train(cfg: Config, init_variables=None, device=None) -> dict:
    """The public train API: ``train(cfg) -> report``.

    ``init_variables``: optional flax ``{'params', 'batch_stats'}`` tree of
    numpy arrays to start from instead of the seeded init (the parity tests
    give both packages the same weights). ``device``: None = ``cuda``.

    Under ``train.data_parallel`` the run is data-parallel over the group
    this process is in (``sharding.join``: the caller's, or the one
    ``torchrun`` names), or, with no group and more than one visible card,
    over every card: ``train()`` spawns one worker per card and returns
    rank 0's report. Every rank returns the same report; rank 0 alone
    logs and writes the checkpoints."""
    from cl_tpu_torch.logging_utils import EventLogger, NullLogger

    device = resolve_device(device)
    check_supported(cfg, device)
    if sharding.should_spawn(cfg, device):
        return sharding.spawn_cards(train, (cfg, init_variables))[0]
    dp = sharding.join(cfg, device)
    device = sharding.rank_device(device)
    logger = (EventLogger(cfg.train.log_path, cfg.train.tensorboard_dir)
              if dp is None or dp.rank == 0 else NullLogger())
    try:
        return _train_impl(cfg, logger, init_variables, device, dp)
    finally:
        logger.close()
        pipeline.make_datasets.cache_clear()


def _tensors(obj):
    """Every tensor of a module (params and buffers), a method state (its
    tensor and module fields) or a tuple of them."""
    if obj is None:
        return
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, torch.nn.Module):
        yield from obj.parameters()
        yield from obj.buffers()
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)
    elif hasattr(obj, "__dict__"):
        for v in vars(obj).values():
            if isinstance(v, (torch.Tensor, torch.nn.Module)):
                yield from _tensors(v)


def _live_set_mb(model, opt, ewc, lwf, caches: dict, rep_arrays: dict,
                device: torch.device) -> dict:
    """MB (1e6 bytes) of every long-lived device buffer by subsystem at a
    task boundary, with ``cl_tpu``'s keys (``_live_set_mb``,
    ``cl_tpu/train.py:994-1026``), read from the tensors' ``nbytes``: the
    params, the optimizer state, the BatchNorm statistics, the EWC and LwF
    state, the train and val caches (``caches``: the train cache by task
    id, the val caches by ("val", task id)) and the replay arrays the plan
    gathers from; on a card also ``cuda_memory_allocated_mb``, all the
    allocator holds (``torch.cuda.memory_allocated``)."""
    def mb(tensors) -> float:
        return sum(t.nbytes for t in tensors) / 1e6

    out = {
        "params_mb": mb(model.parameters()),
        "opt_state_mb": mb(v for st in opt.state.values() for v in st.values()
                           if isinstance(v, torch.Tensor)),
        "model_state_mb": mb(model.buffers()),
        "ewc_mb": mb(_tensors(ewc)),
        "lwf_teacher_mb": mb(_tensors(lwf)),
    }
    val = [c for k, c in caches.items() if isinstance(k, tuple)]
    out["train_cache_mb"] = sum(c.nbytes() for k, c in caches.items()
                                if not isinstance(k, tuple)) / 1e6
    out["val_caches_mb"] = sum(c.nbytes() for c in val) / 1e6
    out["val_caches_n"] = len(val)
    out["replay_arrays_mb"] = mb(_tensors(tuple(rep_arrays.values())))
    out["total_mb"] = sum(v for k, v in out.items() if k.endswith("_mb"))
    if device.type == "cuda":
        out["cuda_memory_allocated_mb"] = torch.cuda.memory_allocated(device) / 1e6
    return {k: (round(v, 1) if isinstance(v, float) else v) for k, v in out.items()}


def _start_profile(device: torch.device):
    """A running ``torch.profiler.profile``: CPU activity, and CUDA's on a
    card."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _finish_profile(prof, out_dir: str, task_id: int, epoch: int, dp=None) -> str:
    """Stop ``prof`` (the epoch's losses were fetched: the card is done)
    and write its Chrome / Perfetto trace into ``out_dir``, one file a rank
    under a group. Returns the file's path."""
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    rank = "" if dp is None else f"_rank{dp.rank}"
    path = os.path.join(out_dir, f"trace_task{task_id}_epoch{epoch}{rank}.json")
    prof.export_chrome_trace(path)
    return path


def _saved(ckpt_lib, dp) -> None:
    """Rank 0's checkpoints are on disk, and every rank waits for them: a
    barrier before any rank reads one."""
    ckpt_lib.wait_for_saves()
    if dp is not None:
        dp.barrier()


def _train_impl(cfg: Config, logger, init_variables, device, dp=None) -> dict:
    from cl_tpu_torch import checkpoint as ckpt_lib
    from cl_tpu_torch.interop import load_jax_variables

    d, m = cfg.data, cfg.method
    spatial = dp is not None and dp.spatial
    if spatial:
        # height-sharded training (cl_tpu/train.py:1062-1088): the batch
        # replicated, every level's H sharded; the packed body is off
        if cfg.model.norm != "group":
            raise ValueError("spatial_parallel needs model.norm='group' (BatchNorm batch "
                             "stats are not sharded spatially)")
        if d.image_size % (dp.world << cfg.model.depth):
            raise ValueError(f"spatial_parallel: image_size {d.image_size} must divide by "
                             f"n_devices*2^depth = {dp.world << cfg.model.depth}")
        if cfg.model.packed_unet:
            logger.log(event="packed_unet_disabled", reason="spatial_mesh")
            warnings.warn("model.packed_unet disabled under spatial_parallel (falling back "
                          "to the standard body)", stacklevel=2)
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                                     packed_unet=False))
    elif dp is not None:
        # cl_tpu/train.py:1070-1072, :1200-1204: the global batch, and with
        # replay the widened one, must divide over the group
        sharding.check_divisible(d.batch_size, dp.world)
        if "replay" in m.methods:
            sharding.check_divisible(d.batch_size + m.replay_batch, dp.world)
    grow = not cfg.model.padded_head
    if init_variables is not None and grow:
        raise ValueError("init_variables requires model.padded_head (the injected head "
                         "must be num_classes wide)")
    model = init_state(cfg, build_model(cfg, dp), device)
    if init_variables is not None:
        load_jax_variables(model, init_variables)
    T = cfg.train.num_tasks
    lwf = lwf_lib.make_lwf_state(model) if "lwf" in m.methods else None
    ewc = ewc_lib.make_ewc_state(model, mode=m.ewc_mode, max_tasks=max(T - 1, 1)) \
        if "ewc" in m.methods else None
    replay = make_replay_buffer(cfg, device, dp)
    dev_replay = isinstance(replay, replay_gather.DeviceReplayBuffer)
    if m.replay_device_resident and "replay" in m.methods and not dev_replay:
        logger.log(event="replay_device_resident_disabled",
                   reason="spatial_mesh" if spatial else "dp_mesh")
        if spatial:
            warnings.warn("method.replay_device_resident disabled under spatial_parallel "
                          "(falling back to the host buffer; result-identical)", stacklevel=2)
    # images/s per chip: cl_tpu divides by its data mesh's size, and under
    # spatial parallelism it has none (cl_tpu/train.py:1500)
    world = 1 if dp is None or spatial else dp.world
    # The device-resident dataset (data.device_cache): the task's train set
    # and each task's val set parked on the device, the plan-driven steps
    # over them (cl_tpu/train.py:1174-1199); under a group every rank holds
    # the whole cache. Under spatial parallelism the host pipeline feeds the
    # same stream (cl_tpu/train.py:1177-1186).
    dev_cache = d.device_cache
    if dev_cache and spatial:
        logger.log(event="device_cache_disabled", reason="spatial_mesh")
        warnings.warn("data.device_cache disabled under spatial_parallel (falling back to "
                      "the host pipeline; result-identical)", stacklevel=2)
        dev_cache = False
    state = ckpt_lib.TrainState(model, build_optimizer(cfg, model), ewc, lwf)

    def _build_steps():
        """The steps over the state's current optimizer: built at the start
        and again after every growth of the head (the train step holds the
        optimizer, which holds the params)."""
        ts = make_train_step(cfg, model, state.optimizer, device, lwf=lwf, ewc=ewc)
        return (ts, make_eval_step(cfg, model, device),
                make_fisher_step(cfg, model, device) if ewc is not None else None,
                make_cached_train_step(ts, dp) if dev_cache else None)

    train_step, eval_step, fisher_step, cached_step = _build_steps()
    caches: dict = {}      # task id -> train cache; ("val", task id) -> val cache
    rep_arrays: dict = {}  # task id -> the replay arrays of the plan (one task's)
    used_modes: set = set()  # replay modes of the plan-driven epochs so far

    def _train_cache(task_id):
        if task_id not in caches:
            caches[task_id] = DeviceDatasetCache(pipeline.make_datasets(cfg, task_id)[0],
                                                 device)
        return caches[task_id]

    splits = cfg.classes_per_task
    miou_matrix = np.full((T, T), np.nan)
    # train.resume: the latest task's checkpoint loads into the objects the
    # steps hold, and the loop goes on after it (cl_tpu/train.py:1206-1220);
    # under grow the state first takes the stored head's width
    start_task = 0
    if cfg.train.resume and cfg.train.checkpoint_dir:
        lt = ckpt_lib.latest_task(cfg) if grow else None
        if lt is not None:
            expand_state(cfg, state, task_head_width(cfg, lt), lt)
            train_step, eval_step, fisher_step, cached_step = _build_steps()
        restored = ckpt_lib.restore_latest(cfg, state, replay)
        if restored is not None:
            _, replay, last_task, miou_matrix = restored
            start_task = last_task + 1
            logger.log(event="resumed", task=last_task)
    step_times: list[tuple[float, int]] = []  # (epoch seconds, steps)
    # Eval accounting as in the JAX package: the first eval pass (first
    # use: kernel build, cuDNN set-up) and the val caches' builds are
    # reported apart from the rate.
    eval_times: list[tuple[float, int]] = []
    eval_overhead = {"cache_build_s": 0.0, "compile_s": 0.0, "compile_passes": 0}

    def _eval_task(k, seen_valid):
        first = eval_overhead["compile_passes"] == 0
        vcache = None
        if dev_cache:
            if ("val", k) not in caches:
                t0 = time.perf_counter()
                caches[("val", k)] = DeviceDatasetCache(pipeline.make_datasets(cfg, k)[1],
                                                        device)
                eval_overhead["cache_build_s"] += time.perf_counter() - t0
            vcache = caches[("val", k)]
        t0 = time.perf_counter()
        r = evaluate_task(cfg, eval_step, k, seen_valid, device, cache=vcache, dp=dp)
        r["n_images"] = len(pipeline.make_datasets(cfg, k)[1])
        exec_s = time.perf_counter() - t0
        if first:
            eval_overhead["compile_passes"] += 1
            eval_overhead["compile_s"] += exec_s
        else:
            eval_times.append((exec_s, int(r["n_images"])))
        return r

    for task_id in range(start_task, T):
        seen = task_lib.seen_classes(splits, task_id)
        seen_valid = task_lib.valid_class_mask(d.num_classes, seen)
        valid_dev = torch.from_numpy(seen_valid).to(device)
        t_task = time.perf_counter()
        w = task_head_width(cfg, task_id)
        if grow and model.head.weight.shape[0] < w:
            expand_state(cfg, state, w, task_id)
            train_step, eval_step, fisher_step, cached_step = _build_steps()
            logger.log(event="head_expanded", task=task_id, width=w)

        for epoch in range(cfg.train.epochs_per_task):
            # Losses stay on the device during the epoch: fetching each
            # one would wait for the device every step.
            losses_dev = []
            first_use = False
            # the profiler's trace of the first steady epoch of the run's
            # first task (cl_tpu/train.py:1307-1312)
            prof = _start_profile(device) if cfg.train.profile_dir and task_id == start_task \
                and epoch == min(1, cfg.train.epochs_per_task - 1) else None
            if dev_cache:
                # The epoch's plan and replay draws go to the device once
                # (cl_tpu/train.py:1316-1377); every step then slices its
                # row. cl_tpu runs epoch_scan=true as one lax.scan over the
                # plan, which it holds equal to this per-step loop; PyTorch
                # has no scan, so both values run the loop (a CUDA graph of
                # the step is later work).
                cache = _train_cache(task_id)
                plan = cached_exec.build_plan(
                    cache.n, batch_size=d.batch_size, epoch=epoch,
                    seed=d.shuffle_seed + 1000 * task_id, shuffle=True,
                    flip_prob=d.flip_prob, device=device)
                rep, mode = None, "none"
                if replay is not None:
                    mode, r_idx, r_flip = cached_exec.build_replay_plan(
                        replay, steps=plan.steps, k=m.replay_batch, batch_size=d.batch_size,
                        flip_prob=d.flip_prob, device=device)
                    rep = (mode, r_idx, r_flip)
                    if mode == "buffer":
                        if task_id not in rep_arrays:
                            rep_arrays.clear()  # the previous task's upload
                            rep_arrays[task_id] = cached_exec.replay_arrays(replay, device)
                        rep += tuple(rep_arrays[task_id])
                # the first epoch of each replay mode is left out of the
                # steady state, as cl_tpu leaves out each program's compile
                first_use = mode not in used_modes
                used_modes.add(mode)
                t_ep = time.perf_counter()
                for s in range(plan.steps):
                    losses_dev.append(cached_step(s, cache, plan, valid_dev, rep)["loss"])
            else:
                src = pipeline.train_batches(cfg, task_id, epoch)
                if replay is not None and not dev_replay:
                    # the host buffer's draws run in the prefetch thread, in
                    # the batches' order
                    src = (pipeline.replay_mix(b, replay.sample_or_current(
                        m.replay_batch, b, flip_prob=d.flip_prob)) for b in src)
                batch_it = pipeline.prefetch_to_device(
                    (_local(b, dp) for b in src), device=device, depth=d.prefetch_depth)
                t_ep = time.perf_counter()
                for batch in batch_it:
                    if dev_replay:
                        batch = _device_replay_mix(replay, batch, m.replay_batch,
                                                   flip_prob=d.flip_prob)
                    losses_dev.append(train_step(batch, valid_dev)["loss"])
            # the fetch of the losses is the epoch's sync
            ep_loss = float(np.mean(torch.stack(losses_dev).cpu().numpy())) \
                if losses_dev else 0.0
            ep_time = time.perf_counter() - t_ep
            # Steady state only: the run's first epoch (after a resume, its
            # first task's; under grow every task's, whose steps are new)
            # carries the kernel build and first-use set-up, and a profiled
            # epoch the tracer's cost (cl_tpu/train.py:1396-1401).
            if not (epoch == 0 and (task_id == start_task or grow)) and not first_use \
                    and prof is None:
                step_times.append((ep_time, len(losses_dev)))
            if prof is not None:
                _finish_profile(prof, cfg.train.profile_dir, task_id, epoch, dp)
                logger.log(event="profile", dir=cfg.train.profile_dir)
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
        after_task(cfg, task_id, model, ewc=ewc, fisher_step=fisher_step, lwf=lwf,
                   replay=replay, device=device,
                   cache=_train_cache(task_id) if dev_cache and ewc is not None else None)
        # free the finished task's train cache, and with data.val_cache_evict
        # every val cache: the next task trains with none of them on the
        # device, and each is rebuilt at the next boundary
        # (cl_tpu/train.py:1465-1474)
        caches.pop(task_id, None)
        if d.val_cache_evict:
            for key in [k for k in caches if isinstance(k, tuple)]:
                caches.pop(key)
        logger.log(event="hbm_live_set", task=task_id,
                   **_live_set_mb(model, state.optimizer, ewc, lwf, caches, rep_arrays,
                                  device))
        if cfg.train.checkpoint_dir and (dp is None or dp.rank == 0):
            ckpt_lib.save_task(cfg, state, replay, task_id, miou_matrix)
        logger.log(event="task_done", task=task_id,
                   seconds=time.perf_counter() - t_task)
        if cfg.train.fail_after_task == task_id:
            # the checkpoint goes to disk before the run dies, so a resume
            # finds this task complete
            _saved(ckpt_lib, dp)
            raise RuntimeError(f"fault injection: fail_after_task={task_id}")

    _saved(ckpt_lib, dp)  # the last task's checkpoint
    report = metrics.forgetting_report(miou_matrix)
    report["config_hash"] = cfg.config_hash()
    report["device"] = device_name(device)
    if dp is not None:
        report["spatial_parallel" if spatial else "data_parallel"] = dp.world
    if step_times:
        total_s = sum(t for t, _ in step_times)
        total_steps = sum(n for _, n in step_times)
        # images a step: the fresh batch and its replay rows, as cl_tpu
        # counts, per card (cl_tpu/train.py:1501-1510)
        gb = d.batch_size + (m.replay_batch if replay is not None else 0)
        if total_s > 0 and total_steps > 0:
            report["images_per_sec_per_chip"] = float(gb * total_steps / total_s / world)
    if eval_times:
        e_s = sum(t for t, _ in eval_times)
        e_n = sum(n for _, n in eval_times)
        if e_s > 0 and e_n > 0:
            report["eval_images_per_sec_per_chip"] = float(e_n / e_s / world)
    if eval_overhead["compile_passes"] or eval_overhead["cache_build_s"]:
        report["eval_overhead_seconds"] = {
            "cache_build": round(eval_overhead["cache_build_s"], 3),
            "compile_passes": eval_overhead["compile_passes"],
            "compile": round(eval_overhead["compile_s"], 3)}
    logger.log(event="done", **{k: v for k, v in report.items()
                                if k != "miou_matrix"})
    return report
