"""Where a train step's device time goes, by ``torch.profiler``.

    python -m cl_tpu_torch.profile_step [--steps N] [section.key=value ...]

Builds the port's train step for the config (``preset=...`` and overrides,
as the CLI takes them), runs it on one prebuilt batch on the CUDA card —
warm-up steps first, then ``--steps`` timed steps without the profiler
(ms/step and images/s), then ``--steps`` steps inside a profiler window —
and prints the device time per step by kernel family and the top kernels,
the profiled wall time per step, and the share of that wall time in which
no kernel ran (the device's idle share), then one JSON line with the same
numbers. The batch is made once, so host data work is outside the window.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

# kernel-name fragments -> family, first match wins
FAMILIES = (
    ("loss kernels (cl_tpu_torch)", ("head_ce", "ce_fwd_kernel", "ce_bwd_kernel",
                                     "reduce_rows")),
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


def profile(cfg, steps: int = 5, warmup: int = 3) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from cl_tpu_torch import train as tl
    from cl_tpu_torch.data import pipeline, tasks

    device = tl.resolve_device("cuda")
    model = tl.init_state(cfg, tl.build_model(cfg), device)
    opt = tl.build_optimizer(cfg, model)
    step = tl.make_train_step(cfg, model, opt, device)
    batch = pipeline.put_batch(next(iter(pipeline.train_batches(cfg, 0, 0))),
                               device)
    valid = torch.from_numpy(tasks.valid_class_mask(
        cfg.data.num_classes,
        tasks.seen_classes(cfg.classes_per_task, 0))).to(device)
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
          f"{res['device_ms_per_step']:.3f} ms/step in kernels, idle share "
          f"{res['idle_share']}")
    for fam, ms in res["families_ms_per_step"].items():
        print(f"  {fam:32s} {ms:8.3f} ms/step")
    for name, ms in res["top_kernels_ms_per_step"]:
        print(f"  {ms:8.3f}  {name}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
