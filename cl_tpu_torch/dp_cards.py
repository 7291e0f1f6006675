"""Data parallelism against one process, on the cards.

    python -m cl_tpu_torch.dp_cards [--steps-only | --spatial]

With every visible card (NCCL, one spawned rank a card), for the headline
step (UNet-32, 512², batch 8, 19 classes, bf16, the packed body and head)
and the baseline_5 cut (EWC + LwF + host replay, 16 + n images over n
cards): one SGD
step data-parallel against the same step in one process on card 0 from the
same seeded init and global batch (``check``), then ``preset=baseline_5``
as it ships through ``train()`` spread over every card (one spawned worker
a card), its report. Prints the card's ``nvidia-smi`` line first and one
JSON line last; exits non-zero when a check fails.

``--spatial`` runs spatial parallelism (``train.spatial_parallel``) over
every card instead (``run_spatial``): the headline step with GroupNorm
(each rank 512 / n rows of every image) against the one-rank spatial step
on card 0 with ``check``'s gate, each rank's peak and images/s beside it,
the ranks' stitched logits against the one-rank forward
(``compare_logits``), then ``preset=baseline_5 model.norm=group
train.spatial_parallel=true train.num_tasks=2`` through ``train()`` over
every card, its report and each rank's peak.

``check`` holds the data-parallel step to the one-process one: the loss
within rtol 1e-5, every rank's params bit-equal, each rank's kernel
launches equal to the one process's (the after-task hooks' and the
step's), and each param's and BatchNorm buffer's update within 1e-2 of
its norm plus one f32 ulp per element, or, where larger, within twice the
gap of the one-process step on the global batch with its halves swapped
(the same sums in another order: in bf16 an activation whose rounding
flips moves the rest). ``chip_smoke.py`` phase 5w runs it with two ranks
on one card over gloo.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

HEADLINE = ["preset=baseline_1", "data.image_size=512", "data.source_size=576",
            "data.num_classes=19", "train.compute_dtype=bfloat16", "model.packed_unet=true",
            "data.dataset=synthetic"]
# the baseline_5 cut of chip_smoke.py phase 5m at 16 fresh images a step;
# the caller adds the replay rows (16 + k must divide over the ranks)
B5_CUT = ["preset=baseline_5", "data.batch_size=16", "data.train_images_per_task=32",
          "train.remat=false", "data.dataset=synthetic", "data.device_cache=false",
          "method.replay_device_resident=false"]
SGD = ["train.optimizer=sgd", "train.lr=0.05", "train.data_parallel=true"]


def _group(cfg, dev):
    """This process's group for ``cfg``: data-parallel or height-sharded
    (``train.spatial_parallel``) in a process group; with none, nothing,
    or under spatial parallelism the one-rank group (the sharded forward's
    reference)."""
    import torch.distributed as dist

    from cl_tpu_torch import sharding

    cls = sharding.SpatialParallel if cfg.train.spatial_parallel else sharding.DataParallel
    if dist.is_initialized():
        return cls(device=dev)
    return cls(device=dev, alone=True) if cfg.train.spatial_parallel else None


def dp_step(args, swap: bool = False, timed: int = 0, logits: bool = False) -> dict:
    """One SGD step of ``args`` on this process's card: in a process group
    data-parallel on its rows of the global batch (under
    ``train.spatial_parallel`` on its rows of every image), else one
    process on all of it. Under a method task 0's after-task hooks run
    first (the Fisher pass, the LwF snapshot, the buffer's fill) and the
    step trains task 1 on a replay-widened batch. ``swap``: one process on
    the global batch with its halves swapped. ``timed``: that many more
    steps after the first, timed. ``logits``: also ``spatial_logits``,
    first. Returns the aux, the launches of the hooks and of the step, the
    rows this process trained on, every state leaf after the step (on the
    host), the peak MiB of the step and the images/s of the timed steps."""
    from cl_tpu_torch import train as tl
    from cl_tpu_torch.config import parse_overrides
    from cl_tpu_torch.data import pipeline, tasks
    from cl_tpu_torch.kernels import read_launches, reset_launches
    from cl_tpu_torch.methods import ewc as ewc_lib
    from cl_tpu_torch.methods import lwf as lwf_lib

    first = {"logits": spatial_logits(args)} if logits else {}
    cfg = parse_overrides(args)
    m = cfg.method
    dev = torch.device("cuda", torch.cuda.current_device())
    dp = _group(cfg, dev)
    model = tl.init_state(cfg, tl.build_model(cfg, dp), dev)
    opt = tl.build_optimizer(cfg, model)
    lwf = lwf_lib.make_lwf_state(model) if "lwf" in m.methods else None
    ewc = ewc_lib.make_ewc_state(model, mode=m.ewc_mode, max_tasks=cfg.train.num_tasks - 1) \
        if "ewc" in m.methods else None
    replay = tl.make_replay_buffer(cfg, dev, dp)
    task = 1 if m.methods else 0
    torch.cuda.synchronize()
    reset_launches()
    if task:
        tl.after_task(cfg, 0, model, ewc=ewc, lwf=lwf, replay=replay, device=dev,
                      fisher_step=tl.make_fisher_step(cfg, model, dev) if ewc else None)
    torch.cuda.synchronize()
    hooks = read_launches()
    step = tl.make_train_step(cfg, model, opt, dev, lwf=lwf, ewc=ewc)
    hb = next(iter(pipeline.train_batches(cfg, task, 0)))
    if replay is not None:
        hb = pipeline.replay_mix(hb, replay.sample_or_current(m.replay_batch, hb,
                                                              flip_prob=cfg.data.flip_prob))
    if swap:
        half = len(hb.image) // 2
        hb = pipeline.HostBatch(*(np.concatenate([a[half:], a[:half]]) for a in hb))
    valid = torch.from_numpy(tasks.valid_class_mask(
        cfg.data.num_classes, tasks.seen_classes(cfg.classes_per_task, task))).to(dev)
    rows = hb if dp is None else dp.local(hb)
    batch = pipeline.put_batch(rows, dev)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    aux = step(batch, valid)
    torch.cuda.synchronize()
    out = {**first, "aux": {k: float(v) for k, v in aux.items()}, "hooks": hooks,
           "counts": read_launches(), "rows": len(rows.image),
           "leaves": {f"model/{k}": v.cpu() for k, v in model.state_dict().items()},
           "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20}
    if timed:
        t0 = time.perf_counter()
        for _ in range(timed):
            step(batch, valid)
        torch.cuda.synchronize()
        out["images_per_s"] = len(hb.image) * timed / (time.perf_counter() - t0)
    return out


def state_before(args) -> dict:
    """The params and BatchNorm buffers ``dp_step`` starts its step from
    (the seeded init: the hooks move none of them), on the host."""
    from cl_tpu_torch import train as tl
    from cl_tpu_torch.config import parse_overrides

    cfg = parse_overrides(args)
    model = tl.init_state(cfg, tl.build_model(cfg), torch.device("cpu"))
    return {f"model/{k}": v.detach().clone() for k, v in model.state_dict().items()}


def update_gap(got: dict, want: dict, before: dict) -> tuple[float, str | None]:
    """The largest (‖got − want‖ − ‖one f32 ulp of the leaf per element‖)
    / ‖want − before‖ over the params and BatchNorm buffers, and its leaf:
    1e-2 reads "each update within 1e-2 of its norm plus one ulp"."""
    worst, name = 0.0, None
    for k, b in before.items():
        w = want[k].double()
        e = torch.floor(torch.log2(torch.clamp(w.abs(), min=2.0 ** -126))) - 23
        excess = max(0.0, float((got[k].double() - w).norm()) - float(torch.exp2(e).norm()))
        norm = float((w - b.double()).norm())
        gap = (excess / norm if norm else float("inf")) if excess else 0.0
        if gap > worst:
            worst, name = gap, k
    return worst, name


def check(label: str, args, *, world: int, backend: str, init_method: str, devices,
          timed: int = 0) -> dict:
    """``dp_step`` over ``world`` spawned ranks against one process (this
    one, on its current card); prints the comparison, raises on a failed
    check, returns the numbers. ``timed``: each side also times that many
    steps and prints images/s beside its peak. Under
    ``train.spatial_parallel`` the ranks' stitched logits are held against
    the one rank's first (``compare_logits``)."""
    from cl_tpu_torch import sharding

    spatial = "train.spatial_parallel=true" in args
    one = dp_step(args, timed=timed, logits=spatial)
    torch.cuda.empty_cache()  # ranks that share this card need what this process cached
    ranks = sharding.spawn(dp_step, (args, False, timed, spatial), world=world,
                           backend=backend, init_method=init_method, devices=devices,
                           timeout=900)
    before = state_before(args)
    floor, floor_leaf = update_gap(dp_step(args, swap=True)["leaves"], one["leaves"], before)
    worst, leaf = max(update_gap(r["leaves"], one["leaves"], before) for r in ranks)
    same = all(torch.equal(v, r["leaves"][k]) for r in ranks[1:]
               for k, v in ranks[0]["leaves"].items())
    terms = {k: (one["aux"][k], [r["aux"][k] for r in ranks])
             for k in ("loss", "ce", "ewc_penalty", "kd", "n_pix") if k in one["aux"]}
    print(f"  {label}, {world} ranks ({backend}) on {[r['rows'] for r in ranks]} rows against "
          f"one process on {one['rows']}: " + ", ".join(f"{k} {a:.6e} / {b}"
                                                     for k, (a, b) in terms.items()))
    print(f"    worst update gap {worst:.3e} of its norm beyond one ulp ({leaf}); one process "
          f"with the halves swapped {floor:.3e} ({floor_leaf}); replicas bit-equal: {same}; "
          f"launches a rank: step { {k: v for k, v in one['counts'].items() if v} }, hooks "
          f"{ {k: v for k, v in one['hooks'].items() if v} }")
    if timed:
        print(f"    peak MiB of the step: ranks {[round(r['peak_mib']) for r in ranks]}, one "
              f"process {one['peak_mib']:.0f} (shares "
              f"{[round(r['peak_mib'] / one['peak_mib'], 4) for r in ranks]}); images/s of "
              f"{timed} steps: ranks {[round(r['images_per_s'], 3) for r in ranks]}, one "
              f"process {one['images_per_s']:.3f}")
    logit_errs = compare_logits(label, one["logits"], [r["logits"] for r in ranks]) \
        if spatial else None
    fails = [k for k, (a, b) in terms.items()
             if not all(np.isclose(v, a, rtol=1e-5, atol=1e-12) for v in b)]
    if worst > max(1e-2, 2 * floor):
        fails.append("updates")
    if not same:
        fails.append("replicas")
    for r, res in enumerate(ranks):
        for which in ("hooks", "counts"):
            if res[which] != one[which]:
                fails.append(f"rank {r}'s {which} launches")
    if fails:
        raise RuntimeError(f"data-parallel step against one process ({label}): {fails}")
    return {"worst": worst, "floor": floor, "loss": terms["loss"],
            "peak_mib": ([r["peak_mib"] for r in ranks], one["peak_mib"]),
            "images_per_s": ([r.get("images_per_s") for r in ranks], one.get("images_per_s")),
            "logits": logit_errs}


SPATIAL = ["model.norm=group", "train.spatial_parallel=true"]


def spatial_logits(args) -> dict:
    """This rank's rows of the seeded model's logits on task 0's first
    augmented batch through the height-sharded forward, in bf16 and in f32
    (``spatial.spatial_apply``; with no process group, the one-rank
    forward), on the host."""
    from cl_tpu_torch import train as tl
    from cl_tpu_torch.augment import augment
    from cl_tpu_torch.config import parse_overrides
    from cl_tpu_torch.data import pipeline
    from cl_tpu_torch.parallel import spatial

    cfg = parse_overrides(args)
    d = cfg.data
    dev = torch.device("cuda", torch.cuda.current_device())
    tl._set_precision(dev)  # f32 means f32 in a spawned rank too (no TF32)
    dp = _group(cfg, dev)
    model = tl.init_state(cfg, tl.build_model(cfg, dp), dev)
    b = pipeline.put_batch(next(iter(pipeline.train_batches(cfg, 0, 0))), dev)
    x, _ = augment(b.image, b.mask, b.flip, out_size=d.image_size, mean=d.mean, std=d.std,
                   compute_dtype=torch.float32, use_kernels=False)
    with torch.no_grad():
        return {dt: spatial.spatial_apply(model, x, dp, getattr(torch, dt)).cpu()
                for dt in ("bfloat16", "float32")}


def compare_logits(label: str, one: dict, ranks: list) -> dict:
    """The ranks' ``spatial_logits`` stitched along H against the one
    rank's: in f32 within 2e-4 (``cl_tpu``'s spatial forward test), in bf16
    no further from the one-rank f32 logits than twice the one-rank bf16
    logits are (sharding adds no error beyond bf16's own rounding)."""
    st = {dt: torch.cat([r[dt] for r in ranks], dim=1) for dt in one}
    err32 = float((st["float32"] - one["float32"]).abs().max())
    err16 = float((st["bfloat16"] - one["float32"]).abs().max())
    own16 = float((one["bfloat16"] - one["float32"]).abs().max())
    print(f"    stitched logits of {len(ranks)} ranks {tuple(st['float32'].shape)}: f32 max "
          f"|stitched - one rank| {err32:.3e} (tol 2e-4); bf16 max |stitched - one-rank f32| "
          f"{err16:.3e} against the one-rank bf16's own {own16:.3e} (tol twice that); max "
          f"|logit| {float(one['float32'].abs().max()):.3f}")
    finite = all(bool(torch.isfinite(t).all()) for t in st.values())
    if not (finite and err32 <= 2e-4 and err16 <= 2 * own16):
        raise RuntimeError(f"spatial forward against one rank ({label}): f32 {err32:.3e}, "
                           f"bf16 {err16:.3e} against {own16:.3e}, finite {finite}")
    return {"f32": err32, "bf16": err16, "bf16_one_rank": own16}


def train_with_peak(args) -> dict:
    """``train()`` of ``args`` on this process's card (in the caller's group)
    and the card's peak MiB over the run."""
    from cl_tpu_torch.config import parse_overrides
    from cl_tpu_torch.train import train

    torch.cuda.reset_peak_memory_stats()
    report = train(parse_overrides(args), device=torch.device("cuda", torch.cuda.current_device()))
    keys = ("images_per_sec_per_chip", "eval_images_per_sec_per_chip", "spatial_parallel",
            "final_per_task_miou", "mean_forgetting", "miou_matrix")
    return {**{k: report.get(k) for k in keys},
            "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20}


def run_spatial(n: int) -> dict:
    """Spatial parallelism over every card: the headline GroupNorm step
    and the stitched logits (``check``, each rank's peak and images/s
    beside one process's) over n NCCL ranks against one process on card 0,
    then ``preset=baseline_5
    model.norm=group train.spatial_parallel=true train.num_tasks=2``
    through ``train()`` over every card."""
    from cl_tpu_torch import sharding

    out = {}
    head = HEADLINE + SGD + SPATIAL
    out["step"] = check(f"headline GroupNorm, {512 // n} rows a rank", head, world=n,
                        backend="nccl", init_method=f"tcp://localhost:{sharding.free_port()}",
                        devices=[f"cuda:{r}" for r in range(n)], timed=3)
    t0 = time.perf_counter()
    b5 = ["preset=baseline_5", "train.num_tasks=2"] + SPATIAL
    ranks = sharding.spawn_cards(train_with_peak, (b5,))
    out["baseline_5"] = dict(ranks[0], seconds=time.perf_counter() - t0,
                             peak_mib=[r["peak_mib"] for r in ranks])
    print(f"  {' '.join(b5)} over {n} cards through train(): "
          + ", ".join(f"{k} {v}" for k, v in out["baseline_5"].items()))
    return out


def main(argv=None) -> int:
    from cl_tpu_torch import sharding
    from cl_tpu_torch.config import parse_overrides
    from cl_tpu_torch.train import train

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("dp_cards: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    n = torch.cuda.device_count()
    print(f"{n} cards: {smi.strip()}")
    if "--spatial" in argv:
        print(json.dumps({"cards": n, "spatial": run_spatial(n)},
                         default=lambda v: np.asarray(v).tolist()))
        return 0
    out = {"cards": n, "steps": {}}
    for label, args in (("headline, global batch 8", HEADLINE + SGD),
                        (f"baseline_5 cut, global batch 16 + {n}",
                         B5_CUT + SGD + [f"method.replay_batch={n}"])):
        out["steps"][label] = check(label, args, world=n, backend="nccl",
                                    init_method=f"tcp://localhost:{sharding.free_port()}",
                                    devices=[f"cuda:{r}" for r in range(n)])
    if "--steps-only" not in argv:
        t0 = time.perf_counter()
        report = train(parse_overrides(["preset=baseline_5"]))
        keys = ("images_per_sec_per_chip", "eval_images_per_sec_per_chip", "data_parallel",
                "final_per_task_miou", "mean_forgetting", "miou_matrix")
        out["baseline_5"] = {k: report.get(k) for k in keys}
        out["baseline_5"]["seconds"] = time.perf_counter() - t0
        print(f"  preset=baseline_5 as it ships over {report.get('data_parallel', 1)} cards: "
              + ", ".join(f"{k} {out['baseline_5'][k]}" for k in keys + ("seconds",)))
    print(json.dumps(out, default=lambda v: np.asarray(v).tolist()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
