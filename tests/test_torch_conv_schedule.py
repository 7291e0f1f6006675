"""The bf16 packed conv's forward and dx block schedules, on the CPU.

The forward (#32) and the dx (#34, #35) run in bf16 on a ring body
(``csrc/conv3x3_ring_body.cuh::conv_ring_body``) whose instance, staging
and persistent grid the wrappers pick from the shapes alone
(``kernels/conv3x3.py::conv_ring_tile``, ``conv_ring_blocks``). A kernel
cannot run here, so these tests hold what surrounds it: the pickers are
pure and give at least one block, the walk they imply takes every (image,
16 x 16 pixel tile, channel tile) exactly once in one wave of resident
blocks, every choice fits the shared memory, the wrappers allocate the
partials the schedule implies (the dx's still one row a tile: the rows
34p/35p and #37 sum in the same order) and pass the schedule to the ring's
C entry point (f32 keeps the FMA body's entry points; the pipelined dx
34p/35p launches #34/#35's kernel with their arguments), the instances and
constants they mirror agree with the CUDA sources, and the dW pickers of
#36 and #37 give the values they gave before.
"""

import os
import re
from collections import Counter
from types import SimpleNamespace

import pytest
import torch

import chip_smoke
from cl_tpu_torch.kernels import SM_COUNT, build, conv3x3
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TILE = conv3x3.TILE
# The forward convs of the headline step at 512², batch 8 (H, Cin, Cout)
# and the ragged ones chip_smoke holds the kernels at (batch 3).
CONV_PATH = sorted({s[:3] for s, _ in chip_smoke.PACKED_PATH["conv3x3_bn_fwd"]})
CONV_RAGGED = list(chip_smoke.RING_CONV_ODD)
SHAPES = [(s, 8) for s in CONV_PATH] + [(s, 3) for s in CONV_RAGGED]
# (kernel Cin, kernel Cout, dx, stats) of each launch at a forward conv
# (H, Cin, Cout): the forward, and the dx with and without the stats term.
ROLES = [("fwd", False, False), ("dx", True, True), ("dx", True, False)]


def launch_of(shape, role):
    _, cin, cout = shape
    name, dx, stats = role
    return (cout, cin, dx, stats) if dx else (cin, cout, dx, stats)


def schedule(kin, kout, B, H, W, dx, stats):
    """The (block, stage) walk of one ring launch, as conv_ring_body takes
    it: block (bx, by) walks the pixel tiles bx, bx + blocks, ... of all B
    images for output channels [by COT, (by + 1) COT), each tile its input
    chunks of CK in order. Returns {(bx, by): [(image, tile, chunk), ...]}."""
    cot, ck, _ = conv3x3.conv_ring_tile(kin, kout, dx, stats)
    blocks = conv3x3.conv_ring_blocks(kin, kout, B, H, W, dx, stats)
    tiles = -(-H // TILE) * -(-W // TILE)
    nch = -(-kin // ck)
    walk = {}
    for bx in range(blocks):
        for by in range(-(-kout // cot)):
            stages = []
            for tile in range(bx, B * tiles, blocks):
                stages += [(tile // tiles, tile % tiles, c) for c in range(nch)]
            walk[(bx, by)] = stages
    return walk


@pytest.mark.parametrize("role", ROLES, ids=[f"{r[0]}{'_stats' * r[2]}" for r in ROLES])
@pytest.mark.parametrize("shape,batch", SHAPES)
def test_ring_picker_pure_fits_and_one_wave(shape, batch, role):
    H = shape[0]
    kin, kout, dx, stats = launch_of(shape, role)
    tile = conv3x3.conv_ring_tile(kin, kout, dx, stats)
    blocks = conv3x3.conv_ring_blocks(kin, kout, batch, H, H, dx, stats)
    assert tile == conv3x3.conv_ring_tile(kin, kout, dx, stats)
    assert blocks == conv3x3.conv_ring_blocks(kin, kout, batch, H, H, dx, stats)
    cot, ck, resident = tile
    assert cot in ((32, 64) if dx else (32, 64, 128)) and ck in (16, 32)
    assert ck == 16 or kin % 8 == 0  # 32-channel stages only by TMA
    assert resident or kin % 8 == 0  # streamed weights only by TMA
    threads, smem, per_sm = conv3x3.conv_ring_resources(cot, ck, dx, stats, resident, kin)
    assert threads == 256 and smem <= conv3x3.RING_CONV_SMEM_MAX and per_sm >= 1
    n_tiles = batch * (-(-H // TILE)) ** 2
    channel_tiles = -(-kout // cot)
    assert 1 <= blocks <= n_tiles
    assert channel_tiles * blocks <= max(SM_COUNT * per_sm, channel_tiles)


@pytest.mark.parametrize("role", ROLES, ids=[f"{r[0]}{'_stats' * r[2]}" for r in ROLES])
@pytest.mark.parametrize("shape,batch", SHAPES)
def test_ring_walk_covers_each_tile_once(shape, batch, role):
    H = shape[0]
    kin, kout, dx, stats = launch_of(shape, role)
    cot, ck, _ = conv3x3.conv_ring_tile(kin, kout, dx, stats)
    walk = schedule(kin, kout, batch, H, H, dx, stats)
    tiles = (-(-H // TILE)) ** 2
    nch = -(-kin // ck)
    taken = Counter((by, b, tile, c) for (_, by), stages in walk.items()
                    for b, tile, c in stages)
    want = {(by, b, tile, c) for by in range(-(-kout // cot)) for b in range(batch)
            for tile in range(tiles) for c in range(nch)}
    assert set(taken) == want and set(taken.values()) == {1}
    # each block the same number of tiles, give or take the last; a tile's
    # chunks consecutive and in order
    counts = [len(stages) // nch for stages in walk.values()]
    assert max(counts) - min(counts) <= 1
    for stages in walk.values():
        assert [c for _, _, c in stages] == list(range(nch)) * (len(stages) // nch)


def test_headline_tiles():
    # the forward takes Cout = 128 in one tile where its weights fit beside
    # the ring (64 -> 128), two tiles of 64 at 128 -> 128; every launch of
    # the headline step keeps its weights resident
    assert conv3x3.conv_ring_tile(64, 128, False, False) == (128, 32, True)
    assert conv3x3.conv_ring_tile(128, 128, False, False) == (64, 32, True)
    assert conv3x3.conv_ring_tile(3, 32, False, False) == (32, 16, True)  # the stem
    for shape in CONV_PATH:
        for role in ROLES:
            kin, kout, dx, stats = launch_of(shape, role)
            if dx and shape[1] == 3:
                continue  # the stem's dx: never launched
            assert conv3x3.conv_ring_tile(kin, kout, dx, stats)[2]


def test_ring_picker_refuses_what_does_not_fit():
    # a width that is not a multiple of 8 cannot stream its weights by TMA
    with pytest.raises(ValueError, match="no tile fits"):
        conv3x3.conv_ring_tile(1001, 64, False, False)
    assert conv3x3.conv_ring_tile(1000, 64, False, False)[2] is False


def _source(name):
    with open(os.path.join(build.CSRC, name)) as f:
        return f.read()


def test_instances_and_constants_agree_with_the_sources():
    ring = _source("conv3x3_ring.cu")
    body = _source("conv3x3_ring_body.cuh")
    instanced = {(False, int(cot), int(ck)) for cot, ck in re.findall(
        r"return CALL\(cltorch::kFwd, (\d+), (\d+), false\)", ring)}
    instanced |= {(True, int(cot), int(ck)) for cot, ck in re.findall(
        r"CLTORCH_CONV_RING_DX\(CALL, (\d+), (\d+)\)", ring)}
    picked = {(dx, *conv3x3.conv_ring_tile(kin, kout, dx, stats)[:2])
              for kin in (3, 5, 8, 12, 16, 24, 32, 40, 64, 128, 130, 512, 1000)
              for kout in (3, 5, 16, 32, 40, 64, 72, 128, 130, 512)
              for dx, stats in ((False, False), (True, True), (True, False))}
    assert picked == instanced
    assert int(re.search(r"kRingConvStages = (\d+);", body).group(1)) == \
        conv3x3.RING_CONV_STAGES
    assert int(re.search(r"kSmemMax = (\d+);", _source("conv3x3_tma.cuh")).group(1)) == \
        conv3x3.RING_CONV_SMEM_MAX
    assert "kRingConvThreads = 256;" in body


class _FakeLibrary:
    """Records the arguments of the C entry points instead of launching."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def entry(*args):
            self.calls[name] = args
            return 0
        return entry


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' launches on CPU tensors into a fake library, with every
    allocation's shape recorded."""
    lib = _FakeLibrary()
    allocated = []
    empty = torch.empty

    def recording_empty(*size, **kw):
        shape = tuple(size[0]) if len(size) == 1 and isinstance(size[0], (tuple, list)) \
            else tuple(size)
        allocated.append(shape)
        return empty(*size, **kw)

    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(torch, "empty", recording_empty)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    return lib, allocated


def _operands(shape, B, dtype, seed):
    H, cin, cout = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, H, H, cin, generator=g).to(dtype)
    y, dy = (torch.randn(B, H, H, cout, generator=g).to(dtype) for _ in range(2))
    w = torch.randn(cout, cin, 3, 3, generator=g)
    return x, w, y, dy


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(32, 3, 32), (20, 40, 72), (16, 64, 128), (12, 512, 40)])
def test_forward_wrapper_passes_the_schedule(fake_card, shape, dtype):
    lib, allocated = fake_card
    H, cin, cout = shape
    B = 2
    x, w, _, _ = _operands(shape, B, dtype, 0)
    conv3x3.launch_conv_bn(x, w, torch.ones(cin), torch.zeros(cin), True)
    bf16 = dtype == torch.bfloat16
    # bf16 launches the ring body with its schedule, f32 the FMA body's entry
    assert list(lib.calls) == ["cltorch_conv3x3_bn_ring" if bf16 else "cltorch_conv3x3_bn_fwd"]
    if bf16:
        args = lib.calls["cltorch_conv3x3_bn_ring"]
        assert args[0] == 0 and args[12:18] == (B, H, H, cin, cout, 1)
        cot, ck, resident, xbuf, blocks = args[18:23]
        assert (cot, ck, bool(resident)) == conv3x3.conv_ring_tile(cin, cout, False, False)
        assert xbuf == 0
        assert blocks == conv3x3.conv_ring_blocks(cin, cout, B, H, H, False, False)
        rows = blocks
    else:
        args = lib.calls["cltorch_conv3x3_bn_fwd"]
        assert args[7:14] == (B, H, H, cin, cout, 1, 0)
        rows = B * (-(-H // TILE)) ** 2
    assert (rows, 2, cout) in allocated
    assert conv3x3.conv_partials_shape(cin, cout, B, H, H, bf16) == (rows, 2, cout)


@pytest.mark.parametrize("stats", [True, False])
@pytest.mark.parametrize("prologue", [True, False])
@pytest.mark.parametrize("shape", [(32, 32, 32), (20, 40, 72), (16, 128, 64), (12, 40, 512)])
def test_dx_wrapper_keeps_one_partial_row_a_tile(fake_card, shape, prologue, stats):
    lib, allocated = fake_card
    H, cin, cout = shape
    B = 2
    x, w, y, dy = _operands(shape, B, torch.bfloat16, 1)
    ds = (torch.zeros(cout), torch.zeros(cout)) if stats else (None, None)
    conv3x3.launch_conv_dx(x, w, torch.ones(cin), torch.zeros(cin), y, dy, *ds, prologue)
    assert list(lib.calls) == ["cltorch_conv3x3_bn_ring"]
    args = lib.calls["cltorch_conv3x3_bn_ring"]
    assert args[0] == 1
    # the kernel reads Cout channels, writes Cin
    assert args[12:18] == (B, H, H, cout, cin, int(prologue))
    assert (args[3] is not None) == stats and (args[6] is not None) == prologue
    cot, ck, resident, xbuf, blocks = args[18:23]
    assert (cot, ck, bool(resident)) == conv3x3.conv_ring_tile(cout, cin, True, stats)
    assert bool(xbuf) == conv3x3.conv_ring_xbuf(cout, cin, True, stats, prologue)
    assert blocks == conv3x3.conv_ring_blocks(cout, cin, B, H, H, True, stats, prologue)
    rows = B * (-(-H // TILE)) ** 2 if prologue else 1
    assert (rows, 2, cin) in allocated
    assert conv3x3.dx_partials_shape(cin, B, H, H, prologue) == (rows, 2, cin)


# the arguments a dx launch allocates afresh (the kernel weight, dx, the
# partials, the sums), by entry point
_FRESH = {"cltorch_conv3x3_bn_ring": (5, 9, 10, 11), "cltorch_conv3x3_bn_dx": (4, 8, 9, 10)}


@pytest.mark.parametrize("e_bf16", [False, True])
@pytest.mark.parametrize("prologue", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pipelined_dx_keeps_its_entry(fake_card, dtype, prologue, e_bf16):
    # 34p/35p launch #34/#35's kernel with every argument the unpipelined
    # dx passes: the ring's dx in bf16 (the pipelined design), the FMA
    # body's dx in f32 (faster on the card than a pipelined FMA kernel)
    lib, allocated = fake_card
    shape = (16, 32, 32)
    x, w, y, dy = _operands(shape, 2, dtype, 2)
    args = (x, w, torch.ones(32), torch.zeros(32), y, dy, torch.zeros(32), torch.ones(32),
            prologue)
    name = "cltorch_conv3x3_bn_ring" if dtype == torch.bfloat16 else "cltorch_conv3x3_bn_dx"
    conv3x3.launch_conv_dx(*args, pipe=True, e_bf16=e_bf16)
    assert list(lib.calls) == [name]
    piped, piped_alloc = lib.calls.pop(name), list(allocated)
    allocated.clear()
    conv3x3.launch_conv_dx(*args, e_bf16=e_bf16)
    plain = lib.calls[name]
    assert len(piped) == len(plain) == len(build.SIGNATURES[name])
    assert [v for i, v in enumerate(piped) if i not in _FRESH[name]] == \
        [v for i, v in enumerate(plain) if i not in _FRESH[name]]
    assert piped_alloc == allocated
    # the bf16 chain only in bf16 (the ring's int before the stream)
    assert piped[-2] == (int(e_bf16) if dtype == torch.bfloat16 else 0)


def test_signatures_match_the_wrappers(fake_card):
    lib, _ = fake_card
    for dtype in (torch.bfloat16, torch.float32):
        x, w, y, dy = _operands((16, 32, 32), 2, dtype, 3)
        conv3x3.launch_conv_bn(x, w)
        conv3x3.launch_conv_dx(x, w, None, None, y, dy, None, None, False)
    for name in ("cltorch_conv3x3_bn_ring", "cltorch_conv3x3_bn_fwd", "cltorch_conv3x3_bn_dx"):
        assert len(lib.calls[name]) == len(build.SIGNATURES[name])


# #36's ring splits and #37's (and the first dW bodies') splits at the
# headline step's convs (batch 8), as they were before the forward and dx
# moved to their ring: (H, Cin, Cout) -> (dw_ring_splits, dw_splits bf16,
# dw_splits f32)
DW_BEFORE = {(512, 3, 32): (261, 264, 264), (512, 32, 32): (261, 264, 264),
             (256, 32, 64): (128, 132, 132), (256, 64, 64): (128, 66, 66),
             (128, 64, 128): (64, 33, 33), (128, 128, 128): (32, 17, 17)}


@pytest.mark.parametrize("shape", sorted(DW_BEFORE))
def test_dw_splits_unchanged(shape):
    H, cin, cout = shape
    assert (conv3x3.dw_ring_splits(cin, cout, 8, H, H),
            conv3x3.dw_splits(cin, cout, 8, H, H, True),
            conv3x3.dw_splits(cin, cout, 8, H, H, False)) == DW_BEFORE[shape]


def _cpu_bwd_operands(kernel, shape, dtype_name, batch=8, seed=0, stats=True):
    """chip_smoke.bwd_operands' recipe on the CPU (f32)."""
    H, cin, cout, prologue = shape
    g = torch.Generator().manual_seed(seed)

    def randn(*sh, scale=1.0):
        return torch.randn(*sh, generator=g) * scale

    x = randn(batch, H, H, cin)
    w = randn(cout, cin, 3, 3, scale=(9 * cin) ** -0.5)
    a, b = (randn(cin).abs() + 0.5, randn(cin) * 0.5 + 0.25) if prologue else (None, None)
    y, dy = randn(batch, H, H, cout), randn(batch, H, H, cout)
    return x, w, a, b, y, dy, randn(cout) * 0.1, randn(cout) * 0.05, prologue


def _drop_last_tap(x, w, *rest):
    # a wrong dx: the conv without its last tap
    w = w.clone()
    w[..., 2, 2] = 0
    return conv3x3.conv_dx_plain(x, w, *rest)


@pytest.mark.parametrize("kernel,prologue", [("conv3x3_bn_dx", False),
                                             ("conv3x3_bn_dx_bn", True)])
def test_f32_dx_float64_check_holds_a_right_dx_and_refuses_a_wrong_one(monkeypatch, kernel,
                                                                       prologue):
    # the check phase 3 runs on the f32 dx's known fault, with the plain
    # version on the CPU in the kernel's place
    assert chip_smoke.F32_DX_WIDE in chip_smoke.RING_CONV_ODD
    shape = (8, 8, 64, prologue)
    monkeypatch.setattr(chip_smoke, "bwd_operands", _cpu_bwd_operands)
    monkeypatch.setattr(chip_smoke, "bwd_fns", lambda k: (conv3x3.conv_dx_plain,
                                                          conv3x3.conv_dx_plain, None))
    out = chip_smoke.f32_dx_float64(kernel, shape, batch=2)
    assert out["kernel"] == out["plain"] and 0 < out["kernel"][1] < 9 * 64 + 4
    monkeypatch.setattr(chip_smoke, "bwd_fns", lambda k: (_drop_last_tap,
                                                          conv3x3.conv_dx_plain, None))
    with pytest.raises(RuntimeError, match="vs float64"):
        chip_smoke.f32_dx_float64(kernel, shape, batch=2)


def test_kernel_ab_host_issue_turns_take_two_checkouts():
    from cl_tpu_torch import kernel_ab
    from cl_tpu_torch.config import parse_overrides

    cfg = parse_overrides(kernel_ab.HEADLINE)
    assert (cfg.data.image_size, cfg.data.batch_size, cfg.model.packed_unet) == (512, 8, True)
    assert kernel_ab.main(["--host-issue", "old"]) == 2
    assert kernel_ab.main(["--host-issue", "old", "new", "conv3x3_bn_fwd"]) == 2


@pytest.mark.parametrize("kernel", ["conv3x3_fwd", "conv3x3_g2_fwd", "conv3x3_g2_dx"])
def test_kernel_ab_takes_the_plain_conv_with_its_library_call(kernel):
    # #30 and #40 (forward and dx) at their phase-3 lists, both dtypes, each
    # with F.conv2d beside it and, in bf16, the ring forward as the yardstick
    from cl_tpu_torch import kernel_ab

    kernel_ab.check_names([kernel])
    lists = chip_smoke.V3_SHAPES if kernel == "conv3x3_fwd" else chip_smoke.G2_SHAPES
    for dtype_name in ("bfloat16", "float32"):
        assert kernel_ab.shapes(chip_smoke, kernel, dtype_name) == \
            [(shape, 1) for shape in lists[kernel]]
        assert (kernel_ab.yardstick(kernel, dtype_name) is None) == (dtype_name == "float32")
    lib = kernel_ab.library(chip_smoke, kernel)
    assert lib is not None
    # on CPU operands the library call is F.conv2d of the plain conv's function
    g = torch.Generator().manual_seed(5)
    x = torch.randn(1, 8, 8, 8, generator=g)
    w = torch.randn(4, 8, 3, 3, generator=g)
    if kernel == "conv3x3_g2_dx":  # dy and the forward conv's weight [C_dy, C_dx]
        w = torch.randn(8, 4, 3, 3, generator=g)
        want = conv3x3.conv3x3_plain(x, conv3x3._flip_t(w))
    else:
        want = conv3x3.conv3x3_plain(x, w)
    got = lib(x, w).permute(0, 2, 3, 1)
    assert torch.allclose(got, want, atol=1e-5)
    assert kernel in kernel_ab.__doc__


@pytest.mark.parametrize("kernel", ["conv3x3_bn_dx_q", "conv3x3_bn_dw_q"])
def test_kernel_ab_takes_the_int8_backward_with_its_library_call_and_yardstick(
        monkeypatch, kernel):
    # #38 and #39 by name at Q_PATH, both dtypes, with cuDNN's dx or dW beside
    # them and the dtype route's kernel (#34/#35's ring dx, #36's ring) as the
    # yardstick, on y = deq(q, scale) and x = deq(xq) rounded to the dtype
    from cl_tpu_torch import kernel_ab

    kernel_ab.check_names([kernel])
    for dtype_name in ("bfloat16", "float32"):
        assert kernel_ab.shapes(chip_smoke, kernel, dtype_name) == chip_smoke.Q_PATH[kernel]
        launch, operands = kernel_ab.dispatch(chip_smoke, kernel, dtype_name)
        assert launch is chip_smoke.q_fns(kernel)[0] and callable(operands)
        assert kernel_ab.yardstick(kernel, dtype_name) is not None
    assert kernel_ab.library(chip_smoke, kernel) is not None
    assert kernel in kernel_ab.__doc__ and kernel in kernel_ab.YARDSTICK
    seen = []
    dtype_route = "launch_conv_dx" if kernel == "conv3x3_bn_dx_q" else "launch_conv_dw"
    monkeypatch.setattr(conv3x3, dtype_route, lambda *ops: seen.append(ops))
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, 8, 16, generator=g).to(torch.bfloat16)
    w = torch.randn(16, 16, 3, 3, generator=g)
    q, scale = conv3x3.quant_rows_plain(torch.randn(2, 8, 8, 16, generator=g), 4)
    dy = torch.randn(2, 8, 8, 16, generator=g).to(torch.bfloat16)
    for x_res in (x, conv3x3.quant_rows_plain(x, 4)):
        call = kernel_ab.yardstick(kernel, "bfloat16")(x_res, w, None, None, q, scale, dy, None,
                                                      None, False, 4)
        assert not seen  # prepared, not launched
        call()
        xs, ws, _, _, ys, dys = seen.pop()[:6]
        assert ws is w and dys is dy
        assert torch.equal(ys, conv3x3.deq_rows(q, scale, 4).to(torch.bfloat16))
        want_x = x if x_res is x else conv3x3.deq_rows(*x_res, 4).to(torch.bfloat16)
        assert torch.equal(xs, want_x)


def test_kernel_ab_int8_turns_and_bit_check(monkeypatch, capsys, tmp_path):
    # the int8 dx in the turns (old, new, new, old) with each checkout's
    # yardstick and its sum a step; --bits: each checkout's outputs
    # compared bit for bit
    import json
    import subprocess
    from types import SimpleNamespace

    from cl_tpu_torch import kernel_ab

    runs = []

    def fake_run(cmd, **kw):
        if cmd[0] == "nvidia-smi":
            return SimpleNamespace(stdout="NVIDIA H100 80GB HBM3, 700.00 W\n")
        if "--bits-worker" in cmd:
            root, path = cmd[cmd.index("--bits-worker") + 1:][:2]
            runs.append(os.path.basename(root))
            out = torch.arange(4.0) + (root.endswith("other") or 0)
            torch.save({"conv3x3_bn_dx_q[16] x8": [out, None]}, path)
            return SimpleNamespace(stdout="")
        runs.append(os.path.basename(cmd[cmd.index("--worker") + 2]))
        row = [[512, 32, 32, True, True], 1, 0.5, 0.6, 0.4 + 0.01 * len(runs), 0.3, 0.35]
        return SimpleNamespace(stdout=json.dumps({"conv3x3_bn_dx_q": [row], "build_s": 1.0}))

    monkeypatch.setattr(subprocess, "run", fake_run)
    dirs = [str(tmp_path / d) for d in ("old", "new", "other")]
    assert kernel_ab.main(["--rounds", "2", dirs[0], dirs[1], "conv3x3_bn_dx_q"]) == 0
    assert runs == ["old", "new", "new", "old"] * 2
    out = capsys.readouterr().out
    assert "new dtype ring dx (card sleep) 0.3500" in out and "library (card sleep) 0.3000" in out
    assert "new dtype ring dx 0.3500 ms (card sleep)" in out
    runs.clear()
    assert kernel_ab.main(["--bits", dirs[0], dirs[1], "conv3x3_bn_dx_q"]) == 0
    assert runs == ["old", "new"] and "all bit-equal: True" in capsys.readouterr().out
    assert kernel_ab.main(["--bits", dirs[0], dirs[2], "conv3x3_bn_dx_q"]) == 1
    assert "DIFFERENT" in capsys.readouterr().out
