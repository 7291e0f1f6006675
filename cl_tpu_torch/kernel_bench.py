"""Device time of each loss kernel launch, by ``torch.profiler``.

    python -m cl_tpu_torch.kernel_bench [--reps N]

Runs the head+CE and CE kernels forward and backward on seeded operands
on the CUDA card, at the shapes of the baseline_1 step (131,072 pixels,
32 channels, 2 classes, f32) and of the 512² full-width step (2,097,152
pixels, 32 channels, 19 classes, bf16; also at 8 classes), and prints for
each case the mean device time of every CUDA kernel it launched and a
SHA-256 of its outputs (loss, dx, dW, db / dz). Run from two checkouts,
the hashes tell whether two versions of a kernel give the same bits.
"""

from __future__ import annotations

import argparse
import hashlib

import torch

CASES = (  # kind, pixels, Cin, classes, dtype
    ("head_ce", 131072, 32, 2, torch.float32),
    ("head_ce", 2097152, 32, 19, torch.bfloat16),
    ("head_ce", 2097152, 32, 8, torch.bfloat16),
    ("ce", 131072, 0, 2, torch.float32),
    ("ce", 2097152, 0, 19, torch.bfloat16),
)


def operands(kind, P, cin, C, dtype, seed):
    """Seeded operands on the card: ~10% ignore pixels, the last class
    masked where there are more than two."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    valid = torch.ones(C, device=dev)
    if C > 2:
        valid[C - 1] = 0.0
    n_allowed = C - 1 if C > 2 else C
    labels = torch.randint(0, n_allowed, (P,), generator=gen, device=dev,
                           dtype=torch.int32)
    labels[torch.rand(P, generator=gen, device=dev) < 0.1] = 255
    scale = 1.0 / (labels != 255).sum().float()
    if kind == "head_ce":
        x = torch.randn(P, cin, generator=gen, device=dev).to(dtype)
        w = torch.randn(C, cin, generator=gen, device=dev) * 0.2
        b = torch.randn(C, generator=gen, device=dev) * 0.1
        return (x, w, b, labels, valid), scale
    z = (torch.randn(P, C, generator=gen, device=dev) * 2).to(dtype)
    return (z, labels, valid), scale


def run(kind, args, scale):
    """One forward and one backward launch; returns the outputs."""
    from cl_tpu_torch.kernels import ce_loss, head_ce

    mod = head_ce if kind == "head_ce" else ce_loss
    grads = mod.launch_bwd(*args, scale)
    return (mod.launch_fwd(*args), *(grads if isinstance(grads, tuple) else (grads,)))


def digest(outs) -> str:
    h = hashlib.sha256()
    for t in outs:
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main(argv: list[str] | None = None) -> int:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from cl_tpu_torch.kernels import build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_bench needs a CUDA device")
    build.library()
    print(torch.cuda.get_device_name(0))
    for i, (kind, P, cin, C, dtype) in enumerate(CASES):
        ops, scale = operands(kind, P, cin, C, dtype, seed=i + 1)
        outs = run(kind, ops, scale)
        for _ in range(3):
            run(kind, ops, scale)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                run(kind, ops, scale)
            torch.cuda.synchronize()
        times: dict[str, list[float]] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and "kernel" in e.name:
                times.setdefault(e.name, []).append(e.time_range.elapsed_us())
        shape = f"P={P},Cin={cin},C={C}" if kind == "head_ce" else f"P={P},C={C}"
        print(f"{kind}[{shape},{str(dtype).split('.')[-1]}] outputs {digest(outs)}")
        for name, us in sorted(times.items()):
            print(f"  {sum(us) / len(us) / 1e3:.4f} ms mean of {len(us):3d}  {name[:80]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
