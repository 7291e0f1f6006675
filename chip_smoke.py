#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``cl_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: compile every kernel of ``cl_tpu_torch/csrc`` from the checkout;
3. kernels against their plain PyTorch versions on the card, at the
   shapes the training paths give them and at small ragged ones (~10%
   ignore pixels, one masked class where there are more than two), with
   the tolerance printed;
4. the baseline_1 preset as it ships, through ``train()``: 16 steps and
   one eval (the fused head+CE kernels), then the same shape with
   ``train.fused_head_ce=false`` (the CE kernels) through
   ``make_train_step``, then one step on the card against one on the CPU
   from the same weights and batch;
5. full width: 512², batch 8, 19 classes, bf16, the standard body —
   images/s and peak memory, with the fused head and without;
6. kernel times against the plain version, one PyTorch library call for
   the same function, and the least time the card could take.

Each path resets the kernels' launch counts just before it runs and reads
them just after; a kernel of the path that was not launched fails the
run. The JSON line of kernel results, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}`` close the output. Without a CUDA device
the script prints no result and exits non-zero. It imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"float32": 67e12,      # f32 outside the tensor cores
            "bfloat16": 989e12}    # bf16 dense, tensor cores


def need(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# Phase 3 / 6: kernels against their plain versions
# ---------------------------------------------------------------------------


def make_case(kind, P, width, C, dtype_name, seed):
    """Seeded operands on the card (``kernel_bench.operands``: ~10% ignore
    pixels, the last class masked where C > 2). ``width`` is Cin for the
    head kernel."""
    import torch

    from cl_tpu_torch.kernel_bench import operands

    ops, scale = operands(kind, P, width, C, getattr(torch, dtype_name), seed)
    case = {"kind": kind, "P": P, "C": C, "dtype": dtype_name,
            "labels": ops[-2], "valid": ops[-1], "scale": scale}
    if kind == "head_ce":
        case.update(x=ops[0], w=ops[1], b=ops[2], Cin=width)
    else:
        case["z"] = ops[0]
    return case


def case_name(case, which):
    if case["kind"] == "head_ce":
        shape = f"P={case['P']},Cin={case['Cin']},C={case['C']}"
    else:
        shape = f"P={case['P']},C={case['C']}"
    return f"{case['kind']}_{which}[{shape},{case['dtype']}]"


def bf16_ulp(t):
    import torch

    mag = t.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def compare(case):
    """Kernel vs plain for fwd and bwd; returns {which: max_abs_err}."""
    import torch

    from cl_tpu_torch.kernels import ce_loss, head_ce

    lbl, valid, scale = case["labels"], case["valid"], case["scale"]
    bf16 = case["dtype"] == "bfloat16"
    if case["kind"] == "head_ce":
        args = (case["x"], case["w"], case["b"], lbl, valid)
        k_loss = head_ce.launch_fwd(*args)
        p_loss = head_ce.head_ce_total_plain(*args)
        k_grads = head_ce.launch_bwd(*args, scale)
        p_grads = head_ce.head_ce_grads_plain(*args, scale)
        grad_names = ("dx", "dW", "db")
    else:
        args = (case["z"], lbl, valid)
        k_loss = ce_loss.launch_fwd(*args)
        p_loss = ce_loss.ce_total_plain(*args)
        k_grads = (ce_loss.launch_bwd(*args, scale),)
        p_grads = (ce_loss.ce_grad_plain(*args, scale),)
        grad_names = ("dz",)
    torch.cuda.synchronize()
    name_f, name_b = case_name(case, "fwd"), case_name(case, "bwd")

    # The loss: f32 sums over P pixels in another order than torch's.
    loss_rtol = 1e-5 if not bf16 else 1e-4
    err = abs(k_loss.item() - p_loss.item())
    rel = err / max(abs(p_loss.item()), 1e-30)
    print(f"  {name_f}: loss kernel {k_loss.item():.9g} plain "
          f"{p_loss.item():.9g} rel err {rel:.3g} (tol {loss_rtol:g})")
    need(np.isfinite(k_loss.item()) and rel <= loss_rtol, f"{name_f} loss")
    errs = {"fwd": err, "bwd": 0.0}

    for gname, k, p in zip(grad_names, k_grads, p_grads):
        need(k.shape == p.shape and k.dtype == p.dtype,
             f"{name_b} {gname} shape/dtype {tuple(k.shape)} {k.dtype}")
        kf, pf = k.float(), p.float()
        diff = (kf - pf).abs()
        need(bool(torch.isfinite(kf).all()), f"{name_b} {gname} not finite")
        if gname == "dz" and bf16:
            # f32 math in another order: may land on the other side of
            # one bf16 rounding
            tol = bf16_ulp(torch.maximum(kf.abs(), pf.abs()))
            tol_txt = "1 bf16 ulp"
        elif gname == "dx" and bf16:
            # dx = round(g)·W: each g_c may round to the other bf16
            # neighbour (|g_c| <= scale·(p_c + onehot_c), so the sum moves
            # by at most 2^-8·scale·2·max_c|W_ck|), then dx rounds once more
            wmax = case["w"].to(case["x"].dtype).float().abs().max(0).values
            tol = (bf16_ulp(torch.maximum(kf.abs(), pf.abs()))
                   + 2.0 ** -7 * scale * wmax[None, :])
            tol_txt = "1 bf16 ulp + one bf16 rounding of each g·W term"
        elif bf16:
            # f32 sums over 2 M pixels in another order
            tol = 1e-3 * pf.abs().max()
            tol_txt = "1e-3 of max|plain|"
        else:
            tol = 1e-4 * pf.abs() + 1e-5 * pf.abs().max()
            tol_txt = "1e-4 rel + 1e-5 of max|plain|"
        ok = bool((diff <= tol).all())
        print(f"  {name_b}: {gname} max abs err {diff.max().item():.3g} "
              f"(max|plain| {pf.abs().max().item():.3g}; tol {tol_txt}) "
              f"{'ok' if ok else 'FAIL'}")
        need(ok, f"{name_b} {gname}")
        errs["bwd"] = max(errs["bwd"], diff.max().item())
    return errs


def bytes_ops(case, which):
    """Bytes the function must move (each input read once, each output
    written once) and its operations."""
    P, C = case["P"], case["C"]
    es = 2 if case["dtype"] == "bfloat16" else 4
    if case["kind"] == "head_ce":
        cin = case["Cin"]
        inputs = P * cin * es + P * 4 + C * cin * 4 + 2 * C * 4
        if which == "fwd":
            return inputs + 4, 2 * P * C * cin + 6 * P * C
        return inputs + P * cin * es + C * (cin + 1) * 4, \
            6 * P * C * cin + 8 * P * C
    inputs = P * C * es + P * 4 + C * 4
    if which == "fwd":
        return inputs + 4, 6 * P * C
    return inputs + P * C * es, 8 * P * C


def kernel_times(case):
    """{which: (ms, plain_ms, library_ms)} at the case's shapes."""
    import torch
    import torch.nn.functional as F

    from cl_tpu_torch.kernels import ce_loss, head_ce

    lbl, valid, scale = case["labels"], case["valid"], case["scale"]
    lbl64 = lbl.long()
    out = {}
    if case["kind"] == "head_ce":
        x, w, b = case["x"], case["w"], case["b"]
        args = (x, w, b, lbl, valid)
        wx, bx = w.to(x.dtype), b.to(x.dtype)
        lib_fwd = lambda: F.cross_entropy(F.linear(x, wx, bx), lbl64,  # noqa: E731
                                          ignore_index=255)
        xr, wr, br = (t.detach().clone().requires_grad_(True) for t in (x, wx, bx))
        lib_loss = F.cross_entropy(F.linear(xr, wr, br), lbl64, ignore_index=255)
        lib_bwd = lambda: torch.autograd.grad(lib_loss, (xr, wr, br),  # noqa: E731
                                              retain_graph=True)
        out["fwd"] = (time_ms(lambda: head_ce.launch_fwd(*args)),
                      time_ms(lambda: head_ce.head_ce_total_plain(*args)),
                      time_ms(lib_fwd))
        out["bwd"] = (time_ms(lambda: head_ce.launch_bwd(*args, scale)),
                      time_ms(lambda: head_ce.head_ce_grads_plain(*args, scale)),
                      time_ms(lib_bwd))
    else:
        z = case["z"]
        args = (z, lbl, valid)
        zr = z.detach().clone().requires_grad_(True)
        lib_loss = F.cross_entropy(zr, lbl64, ignore_index=255)
        out["fwd"] = (time_ms(lambda: ce_loss.launch_fwd(*args)),
                      time_ms(lambda: ce_loss.ce_total_plain(*args)),
                      time_ms(lambda: F.cross_entropy(z, lbl64, ignore_index=255)))
        out["bwd"] = (time_ms(lambda: ce_loss.launch_bwd(*args, scale)),
                      time_ms(lambda: ce_loss.ce_grad_plain(*args, scale)),
                      time_ms(lambda: torch.autograd.grad(lib_loss, zr,
                                                          retain_graph=True)))
    return out


# ---------------------------------------------------------------------------
# Phases 4 / 5: training paths
# ---------------------------------------------------------------------------


def reset_counts():
    from cl_tpu_torch.kernels import ce_loss, head_ce

    for d in (head_ce.LAUNCHES, ce_loss.LAUNCHES):
        for k in d:
            d[k] = 0


def read_counts() -> dict:
    from cl_tpu_torch.kernels import ce_loss, head_ce

    return {**head_ce.LAUNCHES, **ce_loss.LAUNCHES}


def run_steps(cfg, n_warm, n_timed, device, seed_batch=0):
    """make_train_step on one prebuilt batch; returns (counts, img/s,
    peak MiB, last loss). Counts cover exactly these steps."""
    import torch

    from cl_tpu_torch import train as tl
    from cl_tpu_torch.data import pipeline, tasks

    model = tl.init_state(cfg, tl.build_model(cfg), device)
    opt = tl.build_optimizer(cfg, model)
    step = tl.make_train_step(cfg, model, opt, device)
    hb = next(iter(pipeline.train_batches(cfg, 0, seed_batch)))
    batch = pipeline.put_batch(hb, device)
    valid = torch.from_numpy(tasks.valid_class_mask(
        cfg.data.num_classes, tasks.seen_classes(cfg.classes_per_task, 0))).to(device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for _ in range(n_warm):
        aux = step(batch, valid)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        aux = step(batch, valid)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    loss = aux["loss"].item()
    need(np.isfinite(loss), f"finite loss ({loss})")
    ips = cfg.data.batch_size * n_timed / dt
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    del model, opt, step
    return counts, ips, peak, loss


def agree_with_cpu(fused: str):
    """One step on the card (kernels) against one on the CPU (plain
    versions) from the same weights and batch: loss and params in f32."""
    import torch

    from cl_tpu_torch import train as tl
    from cl_tpu_torch.config import parse_overrides
    from cl_tpu_torch.data import pipeline
    from cl_tpu_torch.interop import export_jax_variables, load_jax_variables

    cfg = parse_overrides(["preset=smoke", "data.num_classes=3", "model.depth=3",
                           "train.optimizer=sgd", "train.lr=0.05",
                           f"train.fused_head_ce={fused}",
                           "train.data_parallel=false"])
    hb = next(iter(pipeline.train_batches(cfg, 0, 0)))
    valid = torch.ones(3, dtype=torch.bool)
    out = {}
    variables = None
    for dev in (torch.device("cpu"), torch.device("cuda")):
        model = tl.init_state(cfg, tl.build_model(cfg), dev)
        if variables is None:
            variables = export_jax_variables(model)
        load_jax_variables(model, variables)
        step = tl.make_train_step(cfg, model, tl.build_optimizer(cfg, model), dev)
        aux = step(pipeline.put_batch(hb, dev), valid.to(dev))
        out[dev.type] = (aux["loss"].item(), {
            k: v.detach().float().cpu() for k, v in model.state_dict().items()})
    (lc, pc), (lg, pg) = out["cpu"], out["cuda"]
    perr = max((pg[k] - pc[k]).abs().max().item() for k in pc)
    print(f"  fused_head_ce={fused}: loss cuda {lg:.7f} cpu {lc:.7f}; "
          f"max |param diff| {perr:.3g} (tol 1e-4)")
    need(abs(lg - lc) <= 1e-4 and perr <= 1e-4, f"card vs CPU step ({fused})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from cl_tpu_torch import train as tl
    from cl_tpu_torch.config import get_preset, parse_overrides
    from cl_tpu_torch.kernels import build

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] card: {smi} | torch {torch.__version__} | CUDA {torch.version.cuda} "
          f"| devices {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    lib_path = build.build(verbose=True)
    build.library()
    print(f"[2] build: {time.perf_counter() - t0:.1f} s -> {lib_path}")

    print("[3] kernels against their plain versions on the card")
    cases = [make_case("head_ce", 131072, 32, 2, "float32", 1),
             make_case("head_ce", 2097152, 32, 19, "bfloat16", 2),
             make_case("ce", 131072, 0, 2, "float32", 3),
             make_case("ce", 2097152, 0, 19, "bfloat16", 4)]
    errs = [compare(c) for c in cases]
    # ragged tails (P not a multiple of a tile) and the C <= 8 variants
    for extra in (make_case("head_ce", 1000, 8, 3, "float32", 5),
                  make_case("head_ce", 1000, 16, 5, "bfloat16", 6),
                  make_case("ce", 1000, 0, 3, "float32", 7),
                  make_case("ce", 1000, 0, 5, "bfloat16", 8)):
        compare(extra)

    print("[4] baseline_1 as it ships, through train()")
    cfg1 = get_preset("baseline_1")
    steps1 = (cfg1.data.train_images_per_task // cfg1.data.batch_size
              * cfg1.train.epochs_per_task)
    reset_counts()
    report = tl.train(cfg1)
    counts_b1 = read_counts()
    print(f"  report: {json.dumps({k: v for k, v in report.items() if k != 'miou_matrix'})}")
    print(f"  launches: {counts_b1} (steps {steps1})")
    need(all(np.isfinite(report["final_per_task_miou"])), "finite baseline_1 mIoU")
    need(counts_b1["head_ce_fwd"] == steps1 and counts_b1["head_ce_bwd"] == steps1,
         "head_ce launches == steps in baseline_1")
    need(counts_b1["ce_fwd"] == 0 and counts_b1["ce_bwd"] == 0,
         "no ce launches with the fused head")
    b1_ips = report.get("images_per_sec_per_chip")

    cfg1u = parse_overrides(["preset=baseline_1", "train.fused_head_ce=false"])
    counts_b1u, b1u_ips, _, _ = run_steps(cfg1u, 2, 6, torch.device("cuda"))
    print(f"  baseline_1 fused_head_ce=false, 8 steps: launches {counts_b1u}; "
          f"{b1u_ips:.1f} img/s")
    need(counts_b1u["ce_fwd"] == 8 and counts_b1u["ce_bwd"] == 8
         and counts_b1u["head_ce_fwd"] == 0, "ce launches == steps (baseline_1)")
    for fused in ("auto", "false"):
        agree_with_cpu(fused)

    print("[5] full width: 512², batch 8, 19 classes, bf16, standard body")
    full = ["preset=baseline_1", "data.image_size=512", "data.source_size=576",
            "data.num_classes=19", "train.compute_dtype=bfloat16",
            "model.packed_unet=false", "data.dataset=synthetic",
            "train.data_parallel=false"]
    counts_f, ips_f, peak_f, loss_f = run_steps(
        parse_overrides(full), 3, 10, torch.device("cuda"))
    print(f"  fused head: {ips_f:.2f} img/s, peak {peak_f:.0f} MiB, loss {loss_f:.4f}, "
          f"launches {counts_f}")
    need(counts_f["head_ce_fwd"] == 13 and counts_f["head_ce_bwd"] == 13,
         "head_ce launches == steps (full width)")
    counts_u, ips_u, peak_u, loss_u = run_steps(
        parse_overrides(full + ["train.fused_head_ce=false"]), 2, 5,
        torch.device("cuda"))
    print(f"  fused_head_ce=false: {ips_u:.2f} img/s, peak {peak_u:.0f} MiB, "
          f"loss {loss_u:.4f}, launches {counts_u}")
    need(counts_u["ce_fwd"] == 7 and counts_u["ce_bwd"] == 7,
         "ce launches == steps (full width)")

    print("[6] kernel times (median of 20, CUDA events)")
    launches = {  # the path each case's shape comes from
        0: counts_b1, 1: counts_f, 2: counts_b1u, 3: counts_u}
    replaces = {"head_ce_fwd": "cl_tpu/pallas/head_ce.py:165",
                "head_ce_bwd": "cl_tpu/pallas/head_ce.py:190",
                "ce_fwd": "cl_tpu/pallas/ce_loss.py:118",
                "ce_bwd": "cl_tpu/pallas/ce_loss.py:140"}
    kernels = []
    for i, case in enumerate(cases):
        times = kernel_times(case)
        for which in ("fwd", "bwd"):
            ms, plain_ms, lib_ms = times[which]
            nbytes, ops = bytes_ops(case, which)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_OPS[case["dtype"]] * 1e3
            key = f"{case['kind']}_{which}"
            entry = {
                "name": case_name(case, which), "route": "cuda",
                "source": f"cl_tpu_torch/csrc/{'head_ce' if case['kind'] == 'head_ce' else 'ce_loss'}.cu",
                "replaces": replaces[key], "launches": launches[i][key],
                "max_abs_err": errs[i][which], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": lib_ms}
            need(entry["launches"] > 0, f"{entry['name']} launched on its path")
            kernels.append(entry)
            print(f"  {entry['name']}: {ms:.4f} ms (plain {plain_ms:.4f}, library "
                  f"{lib_ms:.4f}, bound {entry['bound_ms']:.4f} by "
                  f"{entry['bound_by']}); launches {entry['launches']}")
    print(f"  images/s: baseline_1 train() {b1_ips}, baseline_1 unfused "
          f"{b1u_ips:.2f}, 512² bf16 fused {ips_f:.2f}, unfused {ips_u:.2f}")
    print(f"  total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
