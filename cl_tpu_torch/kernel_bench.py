"""Device time of each loss kernel launch and of the conv kernels' that
the options route (the gen-3 conv, int8, the two backward switches), by
``torch.profiler``.

    python -m cl_tpu_torch.kernel_bench [--reps N]

Runs the head+CE and CE kernels and their LwF forms (the KD head on NHWC
features, #9/#10, and the KD on logits, #13/#14) forward and backward on
seeded operands on the CUDA card, at the shapes of the baseline_1 step
(131,072 pixels, 32 channels, 2 classes, f32) and of the 512² full-width
step (2,097,152 pixels, 32 channels, 19 classes, bf16; also at 8
classes); then the gen-3 plain conv (#30 forward and dx, #31 dW) at
baseline_2's 256² × 64 → 64, batch 8, f32 and bf16, and the two-pass
backward's dW (#33) at 64² × 256 → 256 with the prologue, f32; then the
int8 conv kernels of ``model.conv_act_store=int8`` (the quantize 32q, the
dx #38 and the dW #39 from int8 y and x, the prologue on) at the headline
step's 512² × 32 → 32, batch 8, bf16 and f32; then the one-pass conv
backward (#37, ``CL_TPU_FUSE_BWD``) and the pipelined dx (34p/35p,
``CL_TPU_DX_PIPE``) at the same shape, the prologue on (and off for 34p),
bf16 and f32, and the packed head without a prologue (#5/#6) at the
full width. It prints
for each case the mean device time of every CUDA kernel it launched and a
SHA-256 of its outputs (loss, dx, dW, db / dz; the KD forms' KD sum too;
the conv's y, dx and dW). Run from two checkouts, the hashes tell whether
two versions of a kernel give the same bits.
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
    ("head_ce_kd", 2097152, 32, 19, torch.bfloat16),
    ("kd", 2097152, 0, 19, torch.bfloat16),
    # the gen-3 conv: "pixels" is the batch-8 square's side, Cin -> C
    ("conv3x3", 256, 64, 64, torch.float32),
    ("conv3x3", 256, 64, 64, torch.bfloat16),
    ("conv3x3_dw_bn", 64, 256, 256, torch.float32),
    ("conv3x3_q", 512, 32, 32, torch.bfloat16),
    ("conv3x3_q", 512, 32, 32, torch.float32),
    ("conv3x3_bwd_fused", 512, 32, 32, torch.bfloat16),
    ("conv3x3_bwd_fused", 512, 32, 32, torch.float32),
    ("conv3x3_dx_pipe", 512, 32, 32, torch.bfloat16),
    ("conv3x3_dx_pipe", 512, 32, 32, torch.float32),
    ("head_ce_pk", 2097152, 32, 19, torch.bfloat16),
)
LWF_T = 2.0  # method.lwf_temperature's default


def operands(kind, P, cin, C, dtype, seed):
    """Seeded operands on the card: ~10% ignore pixels, the last class
    masked where there are more than two. The KD forms' operands
    (``kd_operands``) extend these."""
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
    if kind in ("head_ce", "head_ce_pk"):
        x = torch.randn(P, cin, generator=gen, device=dev).to(dtype)
        w = torch.randn(C, cin, generator=gen, device=dev) * 0.2
        b = torch.randn(C, generator=gen, device=dev) * 0.1
        return (x, w, b, labels, valid), scale
    z = (torch.randn(P, C, generator=gen, device=dev) * 2).to(dtype)
    return (z, labels, valid), scale


def kd_operands(kind, P, cin, C, dtype, seed):
    """The KD forms' operands: the student's of ``operands`` (the logits
    route's z as the student's logits), a teacher of its own (features and
    head, or logits), the first half of the classes old (at least two: over
    one class the KD is 0); the scale 1/n."""
    base_kind = "head_ce" if kind == "head_ce_kd" else "ce"
    ops, scale = operands(base_kind, P, cin, C, dtype, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 100)
    old_valid = torch.zeros(C, device="cuda")
    old_valid[:max(2, C // 2)] = 1.0
    if kind == "head_ce_kd":
        x, w, b, labels, valid = ops
        xt = torch.randn(P, cin, generator=gen, device="cuda").to(dtype)
        tw = torch.randn(C, cin, generator=gen, device="cuda") * 0.2
        tb = torch.randn(C, generator=gen, device="cuda") * 0.1
        return (x, w, b, xt, tw, tb, labels, valid, old_valid), scale
    z, labels, _ = ops
    old = (torch.randn(P, C, generator=gen, device="cuda") * 2).to(dtype)
    return (z, old, old_valid, labels), scale


def conv_operands(kind, H, cin, C, dtype, seed):
    """The gen-3 conv's operands on the card, batch 8: x, w and dy (#30,
    #31), or x, a, b and a materialized e (#33, the prologue on)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    x, dy = randn(8, H, H, cin).to(dtype), randn(8, H, H, C).to(dtype)
    if kind == "conv3x3":
        return (x, randn(C, cin, 3, 3) * (9 * cin) ** -0.5, dy), None
    if kind in ("conv3x3_bwd_fused", "conv3x3_dx_pipe"):  # x, w, a, b, y, dy, ds1, ds2
        return (x, randn(C, cin, 3, 3) * (9 * cin) ** -0.5, randn(cin).abs() + 0.5,
                randn(cin) * 0.5, randn(8, H, H, C).to(dtype), dy, randn(C) * 0.1,
                randn(C) * 0.05), None
    if kind == "conv3x3_q":  # y, the xq pair, w, a, b, dy, ds1, ds2 (P = 4)
        return (randn(8, H, H, C).to(dtype), x, randn(C, cin, 3, 3) * (9 * cin) ** -0.5,
                randn(cin).abs() + 0.5, randn(cin) * 0.5, dy, randn(C) * 0.1,
                randn(C) * 0.05), None
    return (x, randn(cin).abs() + 0.5, randn(cin) * 0.5, dy), None


def run(kind, args, scale):
    """One forward and one backward launch; returns the outputs."""
    from cl_tpu_torch.kernels import ce_loss, conv3x3, head_ce, kd_loss

    if kind == "conv3x3":  # #30 forward and dx, #31
        x, w, dy = args
        return (conv3x3.launch_conv3x3(x, w), conv3x3.launch_conv3x3(dy, conv3x3._flip_t(w)),
                conv3x3.launch_conv3x3_dw(x, dy))
    if kind == "conv3x3_dw_bn":  # #33
        return (conv3x3.launch_conv3x3_dw_bn(*args, True),)
    if kind == "conv3x3_q":  # 32q on y and on x, #38 and #39 in the xq mode
        y, x, w, a, b, dy, ds1, ds2 = args
        q, scale = conv3x3.launch_quant_rows(y, 4)
        xq = conv3x3.launch_quant_rows(x, 4)
        qargs = (xq, w, a, b, q, scale, dy, ds1, ds2, True, 4)
        return (q, scale, *conv3x3.launch_conv_dx_q(*qargs), conv3x3.launch_conv_dw_q(*qargs))
    if kind == "conv3x3_bwd_fused":  # #37 with the prologue
        return conv3x3.launch_conv_bwd_fused(*args, True)
    if kind == "conv3x3_dx_pipe":  # 35p, then 34p
        x, w, a, b, *rest = args
        return (*conv3x3.launch_conv_dx(*args, True, pipe=True),
                conv3x3.launch_conv_dx(x, w, None, None, *rest, False, pipe=True)[0])
    if kind == "head_ce_pk":  # #5, #6
        return (head_ce.launch_pk_fwd(*args), *head_ce.launch_pk_bwd(*args, scale.reshape(())))
    if kind == "head_ce_kd":
        s = scale.reshape(())
        return (*head_ce.launch_kd_fwd(*args, LWF_T),
                *head_ce.launch_kd_bwd(*args, s, s, LWF_T))
    if kind == "kd":
        return (kd_loss.launch_fwd(*args, LWF_T),
                kd_loss.launch_bwd(*args, scale / LWF_T, LWF_T))
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
        make = kd_operands if kind in ("head_ce_kd", "kd") else \
            conv_operands if kind.startswith("conv") else operands
        ops, scale = make(kind, P, cin, C, dtype, seed=i + 1)
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
        shape = f"8x{P}x{P},{cin}->{C}" if kind.startswith("conv") else \
            f"P={P},Cin={cin},C={C}" if cin else f"P={P},C={C}"
        print(f"{kind}[{shape},{str(dtype).split('.')[-1]}] outputs {digest(outs)}")
        for name, us in sorted(times.items()):
            print(f"  {sum(us) / len(us) / 1e3:.4f} ms mean of {len(us):3d}  {name[:80]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
