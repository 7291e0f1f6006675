"""Where a train step's device time goes, by ``torch.profiler``.

    python -m cl_tpu_torch.profile_step [--steps N] [section.key=value ...]

Builds the port's train step for the config (``preset=...`` and overrides,
as the CLI takes them), runs it on one prebuilt batch on the CUDA card —
warm-up steps first, then ``--steps`` timed steps without the profiler
(ms/step and images/s), then ``--steps`` steps inside a profiler window —
and prints the device time per step by kernel family and the top kernels,
the kernel launches per step, the profiled wall time per step, and the
share of that wall time in which no kernel ran (the device's idle share),
then one JSON line with the same numbers. The batch is made once, so host data work is outside the window.
Under a method (with ``train.num_tasks`` >= 2) task 0's after-task hooks
run first on the seeded init, as ``train()`` runs them (EWC's Fisher pass
over task 0's batches, a real Fisher; the LwF snapshot; the replay
buffer's fill), and the steps train task 1 (under
``model.padded_head=false`` after the head grows to task 1's width, as
``train()`` grows it); under the device-resident
replay buffer each step gathers its replay rows (kernel #20), under the
host buffer the batch is mixed once. The methods' kernels (EWC's and the
replay gather) are a family of their own. ``CL_TPU_FUSE_BWD=1`` and
``CL_TPU_DX_PIPE=1`` in the environment route the packed convs' backward
as they route ``cl_tpu``'s (``models/packed_gate.py``); their kernels are
families of their own.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

# kernel-name fragments -> family, first match wins
FAMILIES = (
    ("methods kernels (cl_tpu_torch)", ("ewc_penalty", "ewc_grad", "ewc_sq_acc",
                                        "replay_gather")),
    ("loss kernels (cl_tpu_torch)", ("head_ce", "ce_fwd_kernel", "ce_bwd_kernel",
                                     "kd_fwd_kernel", "kd_bwd_kernel")),
    # the gen-2 conv of model.conv_impl=pallas|hybrid (#40) and its dW (#41)
    ("gen-2 conv kernels (cl_tpu_torch)", ("conv3x3_g2",)),
    # the gen-3 plain conv (#30), its dW (#31), the two-pass dW (#33)
    ("gen-3 conv kernels (cl_tpu_torch)", ("conv3x3_v3",)),
    # model.conv_act_store=int8: the quantize (32q), dx (#38) and dW (#39)
    ("int8 conv kernels (cl_tpu_torch)", ("conv3x3_q_",)),
    # CL_TPU_FUSE_BWD: the one-pass conv backward's f32 kernel (#37; in
    # bf16 it runs #34/#35's and #36's kernels); CL_TPU_DX_PIPE's dx
    # (34p/35p) runs #34/#35's kernels: both counted with the packed body's
    ("one-pass conv backward (cl_tpu_torch)", ("conv3x3_bn_bwd_fused",)),
    ("packed body kernels (cl_tpu_torch)", ("conv3x3_bn", "conv3x3_dw", "bn_relu",
                                            "add_stats", "dy_eff", "maxpool", "upconv",
                                            "sum_splits")),
    ("fixed-order sums (cl_tpu_torch)", ("reduce_rows",)),
    ("batch norm", ("batch_norm", "batchnorm", "welford")),
    ("pool", ("max_pool", "pool")),
    ("optimizer", ("adam", "multi_tensor", "foreach")),
    ("conv (cuDNN / cuBLAS)", ("conv", "cudnn", "xmma", "gemm", "cutlass",
                               "implicit", "dgrad", "wgrad", "sm90", "nchw",
                               "nhwc")),
    ("reduction", ("reduce",)),
    ("copy / cat / cast", ("copy", "cat", "memcpy", "memset")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def _busy_us(events) -> float:
    """Length of the union of the kernels' [start, end) intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def build(cfg, device, batch_epoch: int = 0):
    """(model, optimizer, step, batch, valid) for ``cfg`` on ``device``
    from the seeded init: ``step(batch, valid)`` is ``make_train_step``'s,
    the batch one prebuilt batch of the task the step trains (see the
    module docstring for the methods)."""
    from cl_tpu_torch import train as tl
    from cl_tpu_torch.data import pipeline, tasks
    from cl_tpu_torch.kernels.replay_gather import DeviceReplayBuffer
    from cl_tpu_torch.methods import ewc as ewc_lib
    from cl_tpu_torch.methods import lwf as lwf_lib

    m, T = cfg.method, cfg.train.num_tasks
    model = tl.init_state(cfg, tl.build_model(cfg), device)
    opt = tl.build_optimizer(cfg, model)
    lwf = lwf_lib.make_lwf_state(model) if "lwf" in m.methods else None
    ewc = ewc_lib.make_ewc_state(model, mode=m.ewc_mode, max_tasks=max(T - 1, 1)) \
        if "ewc" in m.methods else None
    replay = tl.make_replay_buffer(cfg, device)
    task = 1 if m.methods and T > 1 else 0
    if task:
        fisher_step = tl.make_fisher_step(cfg, model, device) if ewc is not None else None
        tl.after_task(cfg, 0, model, ewc=ewc, fisher_step=fisher_step, lwf=lwf, replay=replay,
                      device=device)
        if not cfg.model.padded_head:
            from cl_tpu_torch.checkpoint import TrainState

            opt = tl.expand_state(cfg, TrainState(model, opt, ewc, lwf),
                                  tl.task_head_width(cfg, task), task).optimizer
    step = tl.make_train_step(cfg, model, opt, device, lwf=lwf, ewc=ewc)
    hb = next(iter(pipeline.train_batches(cfg, task, batch_epoch)))
    if isinstance(replay, DeviceReplayBuffer):
        train_step = step

        def step(batch, valid):
            return train_step(tl._device_replay_mix(replay, batch, m.replay_batch,
                                                    flip_prob=cfg.data.flip_prob), valid)
    elif replay is not None:
        hb = pipeline.replay_mix(hb, replay.sample_or_current(
            m.replay_batch, hb, flip_prob=cfg.data.flip_prob))
    valid = torch.from_numpy(tasks.valid_class_mask(
        cfg.data.num_classes, tasks.seen_classes(cfg.classes_per_task, task))).to(device)
    return model, opt, step, pipeline.put_batch(hb, device), valid


def profile(cfg, steps: int = 5, warmup: int = 3) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from cl_tpu_torch import train as tl

    device = tl.resolve_device("cuda")
    _, _, step, batch, valid = build(cfg, device)
    for _ in range(warmup):
        step(batch, valid)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(batch, valid)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / steps
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(batch, valid)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device events, less the ranges that user annotations (such as
    # "Optimizer.step#Adam.step") put on the device track
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and "#" not in e.name]
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    fams: dict[str, float] = {}
    for name, us in by_name.items():
        fams[family(name)] = fams.get(family(name), 0.0) + us
    total = sum(by_name.values())
    busy = _busy_us(kernels)
    return {
        "device": torch.cuda.get_device_name(device),
        "steps": steps,
        "ms_per_step": plain_ms,
        "images_per_s": cfg.data.batch_size * 1e3 / plain_ms,
        "profiled_wall_ms_per_step": wall_us / steps / 1e3,
        "device_ms_per_step": total / steps / 1e3,
        "kernels_per_step": len(kernels) / steps,
        "idle_share": (1.0 - busy / wall_us) if kernels else None,
        "families_ms_per_step": {k: v / steps / 1e3 for k, v in
                                 sorted(fams.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": [
            (name[:90], us / steps / 1e3) for name, us in
            sorted(by_name.items(), key=lambda kv: -kv[1])[:20]],
    }


def main(argv: list[str] | None = None) -> int:
    from cl_tpu_torch.config import parse_overrides

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    cfg = parse_overrides(args.overrides)
    res = profile(cfg, steps=args.steps)
    print(f"{res['device']}: {res['ms_per_step']:.3f} ms/step "
          f"({res['images_per_s']:.2f} images/s) unprofiled; profiled "
          f"{res['profiled_wall_ms_per_step']:.3f} ms/step wall, "
          f"{res['device_ms_per_step']:.3f} ms/step in kernels ({res['kernels_per_step']:.0f} "
          f"launches), idle share {res['idle_share']}")
    for fam, ms in res["families_ms_per_step"].items():
        print(f"  {fam:32s} {ms:8.3f} ms/step")
    for name, ms in res["top_kernels_ms_per_step"]:
        print(f"  {ms:8.3f}  {name}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
