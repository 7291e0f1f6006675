"""Time the packed body's kernels of two checkouts in turns on one card.

    python3 -m cl_tpu_torch.kernel_ab [--rounds N] [--f32] OLD_DIR NEW_DIR [KERNEL ...]

Each directory is a checkout's root (it holds ``chip_smoke.py`` and its
``cl_tpu_torch``). The turns run old, new, new, old (``--rounds N``: N
times over), each in a process of its own whose ``sys.path`` starts with
that checkout, so each version builds and launches its own kernels. Every turn times each kernel (default:
the five forward kernels; or any of ``chip_smoke.PACKED_PATH``'s names, the
backward ones too; or ``head_ce_bn_fwd`` / ``head_ce_bn_bwd``, the packed
head's forward #7 and backward #8; or the switches' ``conv3x3_bn_bwd_fused``
(#37), ``conv3x3_bn_dx_pipe`` / ``conv3x3_bn_dx_bn_pipe`` (34p/35p), the
int8 dx ``conv3x3_bn_dx_q`` (#38) and dW ``conv3x3_bn_dw_q`` (#39), the
two-pass dW ``conv3x3_dw_bn``
(#33), the gen-3 plain conv ``conv3x3_fwd`` (#30) and its dW
``conv3x3_dw`` (#31), the gen-2 plain conv ``conv3x3_g2_fwd`` (#40) and
its dx ``conv3x3_g2_dx`` and the gen-2 dW ``conv3x3_g2_dw`` (#41); or the
Fisher accumulation ``ewc_sq_acc`` (#19)) at every shape of that
checkout's 512² path (``chip_smoke.PACKED_PATH``, ``SWITCH_PATH``,
``Q_PATH``; #33 at level 3's two-pass shape of the 22 MiB budget,
``LEVEL3_TWO_PASS``, and with ``--f32`` at ``V3_SHAPES``; #30 and #31 at
``V3_SHAPES``; #40 and #41 at ``G2_SHAPES``; #19 at ``EWC_N``, f32, on
``chip_smoke.ewc_operands``; bf16, batch 8; #7 and #8 at
``HEAD_SHAPE`` on
``chip_smoke.bn_case``'s operands)
on that checkout's operands (``chip_smoke.packed_operands`` for a forward
kernel, ``bwd_operands`` for a backward one, whose launch is
``bwd_fns``'s; ``q_operands`` / ``q_fns`` for #38 and #39; ``--f32``: in
float32) with this file's ``time_ms``
(``chip_smoke.py`` times with it too), the same for both versions: the
median of 20 launches from CUDA events around each, once with the launches
queued back to back, once synchronised after each, and once queued behind
a card sleep (``time_ms_slept``: the host's issue then stays out of the
card's time); and for #37, 34p, #38, #39 and #19 the one PyTorch call that
computes the same function (``library``: cuDNN's ``convolution_backward``,
in f32 without TF32 as ``chip_smoke.py`` runs it, the dx alone for #38 and
the dW alone for #39; ``addcmul_``; ``F.conv2d`` for #30 and #40) behind a
card sleep in every turn; and the yardstick of each design (``yardstick``)
behind a card sleep in every turn: for #30 and #40 in bf16 the packed
conv's ring forward without the prologue (``conv3x3.launch_conv_bn``,
which also sums the statistics) on the same operands, for #38 and #39 the
dtype route's kernel of the same conv (#34/#35's ring dx,
``conv3x3.launch_conv_dx``, and #36's ring, ``launch_conv_dw``) on y =
deq(q, scale) and x = deq(xq) rounded to the dtype. Prints each turn's
build time (the first turn of a checkout builds its kernels), per kernel
and shape the two versions' medians over their turns and each turn's
card-sleep reading in the order run (their spread), the sums over one
packed step, and the card's ``nvidia-smi`` name and power limit. A name it
does not know is refused before any turn runs.

    python3 -m cl_tpu_torch.kernel_ab --bits [--f32] OLD_DIR NEW_DIR KERNEL ...

runs each kernel of each checkout once at every shape of ``shapes`` and,
for #38 and #39, of ``chip_smoke.Q_ODD`` (batch 3, #38 without the stem's
dx, as phase 3 runs them) on the same seeded operands, and prints whether
the two checkouts' outputs are equal bit for bit, shape by shape.

    python3 -m cl_tpu_torch.kernel_ab --host-issue OLD_DIR NEW_DIR

times instead, in the same turns, the host's issue of one headline step
(``HEADLINE``: 512², batch 8, bf16, the packed body and head) with each
checkout's ``chip_smoke.build_step`` and ``host_issue_ms`` (the median of
five steps issued while the card sleeps), three readings a turn.

    python3 -m cl_tpu_torch.kernel_ab --ptxas OLD_DIR NEW_DIR SOURCE [NAME]

compiles ``cl_tpu_torch/csrc/SOURCE`` of each checkout as the build does,
with ``-Xptxas -v``, and prints each kernel's registers and spilled bytes
(those whose name holds NAME) and any note that ptxas serialized their
``wgmma`` or injected a wait for it: no card is needed, only ``nvcc``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

FORWARD = ("conv3x3_bn_fwd", "bn_relu_fwd", "add_stats_fwd", "maxpool_fwd", "upconv_fwd")
HEADLINE = ["preset=baseline_1", "data.image_size=512", "data.source_size=576",
            "data.num_classes=19", "train.compute_dtype=bfloat16", "model.packed_unet=true",
            "data.dataset=synthetic", "train.data_parallel=false"]
BACKWARD = ("conv3x3_bn_dw", "conv3x3_bn_dx", "conv3x3_bn_dx_bn", "upconv_dx", "upconv_dw",
            "maxpool_bwd", "bn_relu_bwd", "dy_eff")
HEAD = ("head_ce_bn_fwd", "head_ce_bn_bwd")
OTHER = ("conv3x3_bn_bwd_fused", "conv3x3_bn_dx_pipe", "conv3x3_bn_dx_bn_pipe", "conv3x3_bn_dw_q",
         "conv3x3_dw_bn")
INT8 = ("conv3x3_bn_dx_q", "conv3x3_bn_dw_q")  # #38 and #39: chip_smoke.q_fns's kernels
GEN3 = ("conv3x3_dw", "conv3x3_fwd")  # the gen-3 conv's dW (#31) and plain conv (#30)
# the gen-2 conv's dW (#41), its plain conv (#40) as a forward and as a dx
GEN2 = ("conv3x3_g2_dw", "conv3x3_g2_fwd", "conv3x3_g2_dx")
PLAIN = ("conv3x3_fwd", "conv3x3_g2_fwd", "conv3x3_g2_dx")  # #30 and #40
SWITCHED = OTHER[:3]  # #37 and 34p/35p: chip_smoke.switch_fns's kernels
METHODS = ("ewc_sq_acc",)  # the Fisher pass's accumulation (#19)
# #19's length: baseline_5's flat parameters (UNet-32, depth 4), f32
EWC_N = 7763635
# The packed head's shape on the headline step: (pixels, Cin, classes),
# each kernel once a step, with bn_case's seed of chip_smoke's phase 3.
HEAD_SHAPE = (2097152, 32, 19)
HEAD_SEED = 2


def check_names(kernels) -> None:
    """Raise on a kernel name that is neither a forward nor a backward
    kernel of the packed path, nor the packed head's forward or backward,
    nor one of ``OTHER``'s, ``INT8``'s, ``GEN3``'s, ``GEN2``'s or ``METHODS``'s."""
    known = FORWARD + BACKWARD + HEAD + OTHER + INT8[:1] + GEN3 + GEN2 + METHODS
    unknown = [k for k in kernels if k not in known]
    if unknown:
        raise ValueError(f"kernel_ab: unknown kernel(s) {unknown}; known: {', '.join(known)}")


def shapes(smoke, kernel, dtype_name="bfloat16"):
    """[(shape, launches a step), ...] of one kernel on the headline step;
    #33 in f32, #30, #31, #40 and #41 at their phase-6 shapes, once each;
    #19 eight times, once a Fisher batch."""
    if kernel in METHODS:
        return [((EWC_N,), 8)]
    if kernel in HEAD:
        return [(HEAD_SHAPE, 1)]
    if kernel in GEN2:
        return [(shape, 1) for shape in smoke.G2_SHAPES[kernel]]
    if kernel in GEN3:
        return [(shape, 1) for shape in smoke.V3_SHAPES[kernel]]
    if kernel == "conv3x3_dw_bn":
        return [(shape, 1) for shape in smoke.V3_SHAPES[kernel]] if dtype_name == "float32" \
            else [smoke.LEVEL3_TWO_PASS[kernel][::2]]
    if kernel in INT8:
        return smoke.Q_PATH[kernel]
    return smoke.SWITCH_PATH[kernel] if kernel in OTHER else smoke.PACKED_PATH[kernel]


def dispatch(smoke, kernel, dtype_name="bfloat16"):
    """(launch, operands) of one kernel from the checkout's ``chip_smoke``
    module ``smoke``: ``operands(shape)`` makes its seeded operands on the
    card (batch 8), ``launch(*operands)`` runs it."""
    check_names([kernel])
    if kernel in METHODS:  # f32 whatever the flag: the Fisher is f32
        from cl_tpu_torch.kernels import ewc_fused

        def operands(shape):
            import torch

            grad = smoke.ewc_operands(shape[0], 0)[4]
            return torch.rand(shape[0], device="cuda"), grad
        return ewc_fused.launch_sq_acc, operands
    if kernel in HEAD:
        return lambda case: smoke.bn_fns(kernel, case)[0](), \
            lambda shape: (smoke.bn_case(*shape, dtype_name, HEAD_SEED),)
    if kernel in FORWARD:
        return smoke.packed_fns(kernel)[0], \
            lambda shape: smoke.packed_operands(kernel, shape, dtype_name)
    if kernel in ("conv3x3_dw_bn",) + GEN3:
        return smoke.v3_fns(kernel)[0], lambda shape: smoke.v3_operands(kernel, shape, dtype_name)
    if kernel in GEN2:
        return smoke.g2_fns(kernel)[0], lambda shape: smoke.g2_operands(kernel, shape, dtype_name)
    if kernel in INT8:
        return smoke.q_fns(kernel)[0], lambda shape: smoke.q_operands(shape, dtype_name)
    if kernel in OTHER:
        launch = smoke.switch_fns(kernel)[0]
        if kernel == "conv3x3_bn_bwd_fused":  # the stem (Cin 3) without dx
            fused = launch
            launch = lambda *ops: fused(*ops, need_dx=ops[0].shape[-1] != 3)  # noqa: E731
        return launch, lambda shape: smoke.bwd_operands("conv3x3_bn_dw", shape, dtype_name)
    return smoke.bwd_fns(kernel)[0], lambda shape: smoke.bwd_operands(kernel, shape, dtype_name)


def library(smoke, kernel):
    """The one PyTorch call that computes a kernel's function on its
    ``dispatch`` operands, timed beside it (never used by the port), or
    None: cuDNN's ``convolution_backward`` for #37 and 34p (and, the dx or
    the dW alone, for #38 and #39), ``addcmul_`` for #19, ``F.conv2d`` for
    #30 and #40 (of dy with the flipped, channel-swapped weight for #40's
    dx)."""
    if kernel in METHODS:
        return lambda acc, g: acc.addcmul_(g, g)
    if kernel in PLAIN:
        return (smoke.v3_fns if kernel == "conv3x3_fwd" else smoke.g2_fns)(kernel)[2]
    if kernel in INT8:
        return smoke.q_fns(kernel)[2]
    return smoke.switch_fns(kernel)[2] if kernel in SWITCHED else None


# What ``yardstick`` times, by kernel, as printed
YARDSTICK = {"conv3x3_fwd": "ring forward", "conv3x3_g2_fwd": "ring forward",
             "conv3x3_g2_dx": "ring forward", "conv3x3_bn_dx_q": "dtype ring dx",
             "conv3x3_bn_dw_q": "dtype ring dW"}


def yardstick(kernel, dtype_name):
    """The yardstick of a kernel's design, or None: ``prepare(*operands)``
    on its ``dispatch`` operands returns the call to time. #30 and #40 in
    bf16: the packed conv's ring forward without the prologue
    (``conv3x3.launch_conv_bn``, the statistics summed too) on the same
    conv, the weight flipped and channel-swapped for #40's dx. #38 and #39:
    the dtype route's kernel of the same conv on the same operands, y =
    deq(q, scale) and (xq mode) x = deq(xq) rounded to the dtype: #34/#35's
    ring dx (``launch_conv_dx``) and #36's ring (``launch_conv_dw``) in
    bf16, their FMA bodies in f32."""
    from cl_tpu_torch.kernels import conv3x3

    if kernel in INT8:
        launch = conv3x3.launch_conv_dx if kernel == "conv3x3_bn_dx_q" else conv3x3.launch_conv_dw

        def prepare(x_res, w, a, b, q, scale, dy, ds1, ds2, prologue, p):
            y = conv3x3.deq_rows(q, scale, p).to(dy.dtype)
            x = conv3x3.deq_rows(*x_res, p).to(dy.dtype) if isinstance(x_res, tuple) else x_res
            return lambda: launch(x, w, a, b, y, dy, ds1, ds2, prologue)
        return prepare
    if kernel not in PLAIN or dtype_name != "bfloat16":
        return None
    if kernel == "conv3x3_g2_dx":
        return lambda dy, w: lambda: conv3x3.launch_conv_bn(dy, conv3x3._flip_t(w))
    return lambda x, w: lambda: conv3x3.launch_conv_bn(x, w)


def time_ms(fn, reps: int = 20, warmup: int = 3, queued: bool = True) -> float:
    """Median device time of ``fn`` over ``reps`` launches, from CUDA events
    recorded around each. ``queued``: the launches are queued back to back
    and synchronised once, so the host runs ahead of the card as in a step
    and a wrapper's host work between its launches (checks, allocation,
    the fixed-order sum's second launch) is not counted; else each launch
    is synchronised, and that host work is counted."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        if not queued:
            end.synchronize()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def time_ms_slept(fn, reps: int = 20, warmup: int = 3, sleep_cycles: int = 40_000_000) -> float:
    """``time_ms`` queued, behind a card sleep of ``sleep_cycles`` (~20 ms):
    the host queues every launch while the card sleeps, so a wrapper's host
    work between launches is not counted even where a kernel is shorter
    than it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(sleep_cycles)
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def _use_checkout(root):
    sys.path = [root] + [p for p in sys.path if os.path.abspath(p or ".") !=
                         os.path.dirname(os.path.abspath(__file__))]


def _host_issue_worker(root):
    """One turn in checkout ``root``: {"host_issue_ms": [three readings]}
    of the headline step, as one JSON line."""
    _use_checkout(root)
    import chip_smoke
    import torch

    from cl_tpu_torch.config import parse_overrides

    _, _, step, batch, valid = chip_smoke.build_step(parse_overrides(HEADLINE),
                                                     torch.device("cuda"))
    for _ in range(3):
        step(batch, valid)
    torch.cuda.synchronize()
    print(json.dumps({"host_issue_ms": [chip_smoke.host_issue_ms(step, batch, valid)
                                        for _ in range(3)]}))


def _worker(root, kernels, dtype_name="bfloat16"):
    """One turn in checkout ``root``: {kernel: [[shape, n per step, queued
    ms, synchronised ms, slept ms, and the library's slept ms where
    ``library`` has one, then the yardstick's where ``yardstick`` has
    one], ...], "build_s": seconds} as one JSON line."""
    _use_checkout(root)
    import time

    import chip_smoke
    import torch

    from cl_tpu_torch.kernels import build

    # f32 library calls in f32, as chip_smoke.py times them (cuDNN's default is TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    build.build()
    build.library()
    out = {"build_s": time.perf_counter() - t0}
    for kernel in kernels:
        launch, operands = dispatch(chip_smoke, kernel, dtype_name)
        lib = library(chip_smoke, kernel)
        ring = yardstick(kernel, dtype_name)
        for shape, n in shapes(chip_smoke, kernel, dtype_name):
            ops = operands(shape)
            out.setdefault(kernel, []).append(
                [list(shape), n, time_ms(lambda: launch(*ops)),
                 time_ms(lambda: launch(*ops), queued=False),
                 time_ms_slept(lambda: launch(*ops))]
                + ([] if lib is None else [time_ms_slept(lambda: lib(*ops))])
                + ([] if ring is None else [time_ms_slept(ring(*ops))]))
    print(json.dumps(out))


def _bits_worker(root, out_path, dtype_name, kernels):
    """One checkout's outputs of each kernel at every shape of ``shapes``
    (and ``Q_ODD`` at batch 3 for #38 and #39) on the seeded operands, saved
    to ``out_path`` as {case: [output, ...]} on the host."""
    _use_checkout(root)
    import chip_smoke
    import torch

    outs = {}
    for kernel in kernels:
        launch, operands = dispatch(chip_smoke, kernel, dtype_name)
        cases = [(shape, 8) for shape, _ in shapes(chip_smoke, kernel, dtype_name)]
        if kernel in INT8:
            cases += [(shape, 3) for shape in chip_smoke.Q_ODD
                      if not (kernel == "conv3x3_bn_dx_q" and shape[1] == 3)]
        for shape, batch in cases:
            ops = chip_smoke.q_operands(shape, dtype_name, batch) if kernel in INT8 else \
                operands(shape)
            res = launch(*ops)
            res = res if isinstance(res, tuple) else (res,)
            outs[f"{kernel}{list(shape)} x{batch}"] = [None if r is None else r.cpu() for r in res]
    torch.save(outs, out_path)


def _bits(dirs, dtype_name, kernels) -> int:
    """Runs ``_bits_worker`` in each checkout and prints, case by case,
    whether every output is equal bit for bit; returns 0 when all are."""
    import tempfile

    import torch

    check_names(kernels)
    with tempfile.TemporaryDirectory() as tmp:
        got = {}
        for which, root in dirs.items():
            path = os.path.join(tmp, f"{which}.pt")
            subprocess.run([sys.executable, os.path.abspath(__file__), "--bits-worker", root,
                            path, dtype_name, *kernels], cwd=root, check=True)
            got[which] = torch.load(path)
    same_all = True
    for case, old in got["old"].items():
        new = got["new"][case]
        same = len(old) == len(new) and all(
            (u is None and v is None) or (u is not None and v is not None and torch.equal(u, v))
            for u, v in zip(old, new))
        same_all = same_all and same
        print(f"{case} {dtype_name}: {'bit-equal' if same else 'DIFFERENT'}")
    print(f"all bit-equal: {same_all}")
    return 0 if same_all else 1


def _ptxas(dirs, source, name):
    """Registers and spills of the kernels in ``source`` of each checkout,
    from ``nvcc -Xptxas -v`` with the build's flags."""
    import re
    import tempfile

    from cl_tpu_torch.kernels import build

    nvcc = build._nvcc()
    for which, root in dirs.items():
        src = os.path.join(root, "cl_tpu_torch", "csrc", source)
        if not os.path.exists(src):
            print(f"{which}: no {source}")
            continue
        with tempfile.TemporaryDirectory() as tmp:
            res = subprocess.run([nvcc, "-Xptxas=-v", *build.ARCH_FLAGS, *build.CFLAGS, "-c", src,
                                  "-o", os.path.join(tmp, "k.o")],
                                 capture_output=True, text=True, check=True)
        fn, spill = None, (0, 0)
        for line in (res.stdout + res.stderr).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = m.group(1)
                continue
            if ("serialized" in line or "wait is injected" in line) and name in line:
                print(f"{which}: {line.strip()}")  # ptxas held a kernel's wgmma back
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and fn is not None:
                spill = (int(m.group(1)), int(m.group(2)))
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and fn is not None and name in fn:
                print(f"{which}: {fn}: {m.group(1)} registers, spill stores {spill[0]} B, "
                      f"spill loads {spill[1]} B")
                fn = None


def main(argv) -> int:
    if argv[:1] == ["--worker"]:
        _worker(argv[2], argv[3:], argv[1])
        return 0
    if argv[:1] == ["--host-issue-worker"]:
        _host_issue_worker(argv[1])
        return 0
    if argv[:1] == ["--bits-worker"]:
        _bits_worker(argv[1], argv[2], argv[3], argv[4:])
        return 0
    if argv[:1] == ["--bits"]:
        argv = argv[1:]
        dtype_name = "float32" if argv[:1] == ["--f32"] else "bfloat16"
        argv = argv[1:] if dtype_name == "float32" else argv
        if len(argv) < 3:
            print(__doc__, file=sys.stderr)
            return 2
        return _bits({"old": os.path.abspath(argv[0]), "new": os.path.abspath(argv[1])},
                     dtype_name, argv[2:])
    if argv[:1] == ["--ptxas"]:
        if len(argv) not in (4, 5):
            print(__doc__, file=sys.stderr)
            return 2
        _ptxas({"old": os.path.abspath(argv[1]), "new": os.path.abspath(argv[2])}, argv[3],
               argv[4] if len(argv) == 5 else "")
        return 0
    rounds = 1
    if argv[:1] == ["--rounds"]:
        rounds, argv = int(argv[1]), argv[2:]
    host_issue = argv[:1] == ["--host-issue"]
    dtype_name = "float32" if argv[:1] == ["--f32"] else "bfloat16"
    argv = argv[1:] if host_issue or dtype_name == "float32" else argv
    if len(argv) < 2 or (host_issue and len(argv) > 2):
        print(__doc__, file=sys.stderr)
        return 2
    dirs = {"old": os.path.abspath(argv[0]), "new": os.path.abspath(argv[1])}
    kernels = argv[2:] or list(FORWARD)
    check_names(kernels)
    turns = {"old": [], "new": []}
    for which in ("old", "new", "new", "old") * rounds:
        worker = ["--host-issue-worker", dirs[which]] if host_issue else \
            ["--worker", dtype_name, dirs[which], *kernels]
        res = subprocess.run([sys.executable, os.path.abspath(__file__), *worker],
                             cwd=dirs[which], capture_output=True, text=True, check=True)
        turns[which].append(json.loads(res.stdout.strip().splitlines()[-1]))
        if "build_s" in turns[which][-1]:
            print(f"{which}: build and load {turns[which][-1]['build_s']:.1f} s")
        if host_issue:
            print(f"{which}: host issue of one headline step, ms: "
                  f"{turns[which][-1]['host_issue_ms']}")
    kernels = [] if host_issue else kernels
    for kernel in kernels:
        sums = {}
        for i, (shape, n, *_) in enumerate(turns["new"][0][kernel]):
            row = []
            for which in ("old", "new"):
                q, s, z = (float(np.median([t[kernel][i][j] for t in turns[which]]))
                           for j in (2, 3, 4))
                acc = sums.setdefault(which, [0.0, 0.0, 0.0])
                acc[0] += n * q
                acc[1] += n * s
                acc[2] += n * z
                row.append(f"{which} {q:.4f} (synchronised {s:.4f}, card sleep {z:.4f}; turns "
                           f"{' '.join(f'{t[kernel][i][4]:.4f}' for t in turns[which])})")
            if len(turns["new"][0][kernel][i]) > 5:  # the library, over all four turns
                lib = float(np.median([t[kernel][i][5] for w in ("old", "new")
                                       for t in turns[w]]))
                sums["library"] = sums.get("library", 0.0) + n * lib
                row.append(f"library (card sleep) {lib:.4f}")
            if len(turns["new"][0][kernel][i]) > 6:  # the yardstick, each checkout's
                for which in ("old", "new"):
                    ring = [t[kernel][i][6] for t in turns[which]]
                    sums[f"{which} {YARDSTICK[kernel]}"] = \
                        sums.get(f"{which} {YARDSTICK[kernel]}", 0.0) + n * float(np.median(ring))
                    row.append(f"{which} {YARDSTICK[kernel]} (card sleep) {np.median(ring):.4f} "
                               f"(turns {' '.join(f'{v:.4f}' for v in ring)})")
            print(f"{kernel}{shape} {dtype_name} x{n}/step: " + ", ".join(row))
        print(f"{kernel} per step: " + ", ".join(
            f"{w} {v[0]:.4f} ms (synchronised {v[1]:.4f}, card sleep {v[2]:.4f})"
            if isinstance(v, list) else f"{w} {v:.4f} ms (card sleep)"
            for w, v in sums.items()))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
