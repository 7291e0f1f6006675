"""The weight-gradient kernels' block schedules, on the CPU.

The packed conv's dW (#36) and the up-conv's dW (#29) run in bf16 on ring
kernels (``csrc/conv3x3_dw_body.cuh::dw_ring_body``,
``csrc/upconv.cu::upconv_dw_ring_kernel``) whose tiles and pixel splits the
wrappers pick from the shapes alone (``kernels/conv3x3.py::dw_ring_tile`` /
``dw_ring_splits``, ``kernels/upconv_pack.py::dw_ring_tile`` /
``dw_ring_splits``). The gen-3 dW (#31), the two-pass dW (#33) and the
gen-2 dW (#41) run the same ring body in bf16 and the register-blocked FMA
body (``dw_reg_body``) in f32, with the tile and splits of
``conv3x3.dw_tile_splits`` (``dw_fma_tile`` / ``dw_fma_splits`` in f32).
A kernel cannot run here, so these tests hold what surrounds it: the pickers are pure and give at least one split, the blocks
they imply take every (channel tile, pixel tile) pair exactly once in one
wave of resident blocks, the wrappers allocate the partials they imply and
pass the tile the C entry points instance, the constants the pickers mirror
agree with the CUDA sources, and ``conv3x3.dw_splits`` still gives the
one-pass backward (#37) the splits it gave before. Also ``kernel_ab``'s
dispatch over the packed path's kernel names.
"""

import json
import math
import os
import re
from collections import Counter
from types import SimpleNamespace

import pytest
import torch

import chip_smoke
from cl_tpu_torch import kernel_ab
from cl_tpu_torch.kernels import SM_COUNT, build, conv3x3, conv3x3_g2, upconv_pack
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CSRC = build.CSRC

# Each conv of the headline step at 512², batch 8 (H, Cin, Cout), the
# stem included, and ragged ones past every tile.
CONV_PATH = [(512, 3, 32), (512, 32, 32), (256, 32, 64), (256, 64, 64), (128, 64, 128),
             (128, 128, 128)]
CONV_RAGGED = [(20, 40, 72), (24, 16, 12), (20, 64, 24), (20, 8, 40), (19, 3, 16)]
# #33's and #41's convs at their path shapes (batch 8; H, W, Cin, Cout):
# level 2's two-pass convs, baseline_2's 256² level and bottleneck, the
# 512² standard body; and ragged ones (batch 3) past every tile.
TILED_PATH = [(64, 64, 256, 256), (256, 256, 64, 64), (16, 16, 1024, 1024),
              (512, 512, 32, 32)]
TILED_RAGGED = [(19, 21, 3, 40), (20, 20, 40, 72), (12, 13, 6, 18), (20, 20, 72, 24),
                (20, 20, 24, 40), (6, 16, 16, 32), (32, 32, 8, 16)]
# Each up-conv of the step (H_in, Cin, Cout), and ragged ones.
UP_PATH = [(64, 256, 128), (128, 128, 64), (256, 64, 32)]
UP_RAGGED = [(20, 72, 20), (20, 40, 48), (20, 24, 6), (20, 12, 16), (7, 16, 16)]


def conv_schedule(cin, cout, B, H, W):
    """The blocks of a bf16 #36 launch and the (channel tile, pixel tile)
    pairs each takes, as the ring body walks them: {(bx, by, bz): [((bx,
    by), tile), ...]}, block bz taking tiles bz, bz + splits, ..."""
    ci_t, co_t = conv3x3.dw_ring_tile(cin, cout)
    splits = conv3x3.dw_ring_splits(cin, cout, B, H, W)
    n_tiles = B * -(-H // conv3x3.RING_TH) * -(-W // 16)
    return {(bx, by, bz): [((bx, by), tile) for tile in range(bz, n_tiles, splits)]
            for bx in range(-(-cin // ci_t)) for by in range(-(-cout // co_t))
            for bz in range(splits)}


def fma_schedule(cin, cout, B, H, W):
    """The same for an f32 #33 / #41 launch on the register-blocked body:
    (channel tile, pixel tile) pairs of TH x 16 pixel tiles."""
    ci_t, co_t = conv3x3.dw_fma_tile(cin, cout)
    th = conv3x3.dw_fma_resources(ci_t, co_t)[3]
    splits = conv3x3.dw_fma_splits(cin, cout, B, H, W)
    n_tiles = B * -(-H // th) * -(-W // 16)
    return {(bx, by, bz): [((bx, by), tile) for tile in range(bz, n_tiles, splits)]
            for bx in range(-(-cin // ci_t)) for by in range(-(-cout // co_t))
            for bz in range(splits)}


def upconv_schedule(cin, cout, pixels):
    """The same for a bf16 #29 launch: (tile, pixel slice) pairs, block bz
    taking slices bz, bz + splits, ..."""
    bm, bn = upconv_pack.dw_ring_tile(cin, cout)
    splits = upconv_pack.dw_ring_splits(cin, cout, pixels)
    n_slices = -(-pixels // upconv_pack.RING_BK)
    return {(bx, by, bz): [((bx, by), s) for s in range(bz, n_slices, splits)]
            for bx in range(-(-cin // bm)) for by in range(-(-(4 * cout) // bn))
            for bz in range(splits)}


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _constant(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


@pytest.mark.parametrize("shape", CONV_PATH + CONV_RAGGED)
@pytest.mark.parametrize("batch", [8, 3])
def test_conv_ring_splits_pure_and_one_wave(shape, batch):
    H, cin, cout = shape
    splits = conv3x3.dw_ring_splits(cin, cout, batch, H, H)
    assert splits == conv3x3.dw_ring_splits(cin, cout, batch, H, H)
    n_tiles = batch * -(-H // conv3x3.RING_TH) * -(-H // 16)
    assert 1 <= splits <= n_tiles
    ci_t, co_t = conv3x3.dw_ring_tile(cin, cout)
    blocks = conv3x3.dw_ring_resources(ci_t, co_t)[2]
    channel_tiles = -(-cin // ci_t) * -(-cout // co_t)
    # one wave of resident blocks, unless one split a channel tile is more
    assert channel_tiles * splits <= max(SM_COUNT * blocks, channel_tiles)


@pytest.mark.parametrize("shape", CONV_PATH + CONV_RAGGED)
def test_conv_ring_schedule_covers_each_pair_once(shape):
    H, cin, cout = shape
    batch = 8 if shape in CONV_PATH else 3
    schedule = conv_schedule(cin, cout, batch, H, H)
    ci_t, co_t = conv3x3.dw_ring_tile(cin, cout)
    n_tiles = batch * -(-H // conv3x3.RING_TH) * -(-H // 16)
    pairs = Counter(p for taken in schedule.values() for p in taken)
    want = {((bx, by), t) for bx in range(-(-cin // ci_t)) for by in range(-(-cout // co_t))
            for t in range(n_tiles)}
    assert set(pairs) == want and set(pairs.values()) == {1}
    # a block takes only its own channel tile, and each the same number of
    # rounds, give or take the last
    counts = [len(taken) for taken in schedule.values()]
    assert all(p[0] == (bx, by) for (bx, by, _), taken in schedule.items() for p in taken)
    assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("shape", TILED_PATH + TILED_RAGGED)
@pytest.mark.parametrize("batch", [8, 3])
def test_fma_splits_pure_and_one_wave(shape, batch):
    H, W, cin, cout = shape
    splits = conv3x3.dw_fma_splits(cin, cout, batch, H, W)
    assert splits == conv3x3.dw_fma_splits(cin, cout, batch, H, W)
    ci_t, co_t = conv3x3.dw_fma_tile(cin, cout)
    _, _, blocks, th = conv3x3.dw_fma_resources(ci_t, co_t)
    assert 1 <= splits <= batch * -(-H // th) * -(-W // 16)
    channel_tiles = -(-cin // ci_t) * -(-cout // co_t)
    assert channel_tiles * splits <= max(SM_COUNT * blocks, channel_tiles)


@pytest.mark.parametrize("shape", TILED_PATH + TILED_RAGGED)
def test_fma_schedule_covers_each_pair_once(shape):
    H, W, cin, cout = shape
    batch = 8 if shape in TILED_PATH else 3
    schedule = fma_schedule(cin, cout, batch, H, W)
    ci_t, co_t = conv3x3.dw_fma_tile(cin, cout)
    th = conv3x3.dw_fma_resources(ci_t, co_t)[3]
    n_tiles = batch * -(-H // th) * -(-W // 16)
    pairs = Counter(p for taken in schedule.values() for p in taken)
    want = {((bx, by), t) for bx in range(-(-cin // ci_t)) for by in range(-(-cout // co_t))
            for t in range(n_tiles)}
    assert set(pairs) == want and set(pairs.values()) == {1}
    counts = [len(taken) for taken in schedule.values()]
    assert all(p[0] == (bx, by) for (bx, by, _), taken in schedule.items() for p in taken)
    assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("bf16", [True, False])
def test_bottleneck_dw_takes_one_split(bf16):
    # 16² x 1024 -> 1024: more channel tiles than one wave holds, so one
    # split, written to dW itself (37.7 MB of partials otherwise)
    assert conv3x3.dw_tile_splits(1024, 1024, 8, 16, 16, bf16)[2] == 1


@pytest.mark.parametrize("shape", UP_PATH + UP_RAGGED)
@pytest.mark.parametrize("batch", [8, 3])
def test_upconv_ring_splits_pure_and_one_wave(shape, batch):
    H, cin, cout = shape
    pixels = batch * H * H
    splits = upconv_pack.dw_ring_splits(cin, cout, pixels)
    assert splits == upconv_pack.dw_ring_splits(cin, cout, pixels)
    assert 1 <= splits <= -(-pixels // upconv_pack.RING_BK)
    bm, bn = upconv_pack.dw_ring_tile(cin, cout)
    blocks = upconv_pack.dw_ring_resources(bm, bn)[2]
    tiles = -(-cin // bm) * -(-(4 * cout) // bn)
    assert tiles * splits <= max(SM_COUNT * blocks, tiles)


@pytest.mark.parametrize("shape", UP_PATH + UP_RAGGED)
def test_upconv_ring_schedule_covers_each_pair_once(shape):
    H, cin, cout = shape
    pixels = (8 if shape in UP_PATH else 3) * H * H
    schedule = upconv_schedule(cin, cout, pixels)
    bm, bn = upconv_pack.dw_ring_tile(cin, cout)
    n_slices = -(-pixels // upconv_pack.RING_BK)
    pairs = Counter(p for taken in schedule.values() for p in taken)
    want = {((bx, by), s) for bx in range(-(-cin // bm)) for by in range(-(-(4 * cout) // bn))
            for s in range(n_slices)}
    assert set(pairs) == want and set(pairs.values()) == {1}
    counts = [len(taken) for taken in schedule.values()]
    assert max(counts) - min(counts) <= 1


def test_level0_upconv_has_no_zero_rows():
    # Cin = 64 at level 0: a 64-row tile; levels 0 and 1 are one tile each
    assert upconv_pack.dw_ring_tile(64, 32) == (64, 128)
    assert -(-128 // upconv_pack.dw_ring_tile(128, 64)[0]) == 1
    assert conv3x3.dw_ring_tile(3, 32) == (16, 32)  # the stem's m16 tile


def _tiles_in_dispatch(src, a, b):
    return {(int(m.group(1)), int(m.group(2)))
            for m in re.finditer(rf"if \({a} == (\d+) && {b} == (\d+)\) return", src)}


def test_ring_tiles_are_instanced_and_constants_agree():
    body_src = _source("conv3x3_dw_body.cuh")
    up_src = _source("upconv.cu")
    # the dispatch lives beside the body; #36's, #31's, #33's and #41's
    # entry points and their info entries launch through it
    conv_tiles = _tiles_in_dispatch(_macro(body_src, "CLTORCH_RING_DISPATCH"), "ci_t", "co_t")
    for name, uses in (("conv3x3_bn_bwd.cu", 2), ("conv3x3_v3_dw.cu", 2), ("conv3x3_dw_bn.cu", 2),
                       ("conv3x3_g2.cu", 2)):
        assert _source(name).count("CLTORCH_RING_DISPATCH(") == uses, name
    up_tiles = _tiles_in_dispatch(up_src, "bm", "bn")
    shapes = [(ci, co) for ci in (1, 3, 8, 16, 24, 32, 40, 64, 128, 1024)
              for co in (3, 12, 16, 32, 40, 64, 128, 1024)]
    assert {conv3x3.dw_ring_tile(ci, co) for ci, co in shapes} == conv_tiles
    assert {upconv_pack.dw_ring_tile(ci, co) for ci, co in shapes} == up_tiles
    assert _constant(body_src, "kRingTH") == conv3x3.RING_TH
    assert _constant(body_src, "kRingStages") == conv3x3.RING_STAGES
    assert _constant(body_src, "kRawRow") == conv3x3.RING_RAW_ROW
    assert _constant(up_src, "kRingBK") == upconv_pack.RING_BK
    assert _constant(up_src, "kRingStagesUp") == upconv_pack.RING_STAGES


def _macro(src, name):
    """The text of the macro ``name``'s definition in ``src``."""
    lines = src[src.index(f"#define {name}("):].splitlines()
    n = next(i for i, line in enumerate(lines) if not line.endswith("\\"))
    return "\n".join(lines[:n + 1])


def _reg_tiles_in_dispatch(src):
    return {(int(m.group(1)), int(m.group(2)))
            for m in re.finditer(r"if \(ci_t == (\d+) && co_t == (\d+)\) return CALL\(\2\)", src)}


def test_fma_tiles_are_instanced_and_constants_agree():
    body_src = _source("conv3x3_dw_body.cuh")
    tiles = _reg_tiles_in_dispatch(_macro(body_src, "CLTORCH_REG_DISPATCH"))
    shapes = [(ci, co) for ci in (1, 3, 8, 16, 24, 32, 40, 64, 128, 1024)
              for co in (3, 12, 16, 32, 40, 64, 128, 1024)]
    assert {conv3x3.dw_fma_tile(ci, co) for ci, co in shapes} == tiles == {(32, 32), (32, 64)}
    for name in ("conv3x3_v3_dw.cu", "conv3x3_dw_bn.cu", "conv3x3_g2.cu"):
        assert _source(name).count("CLTORCH_REG_DISPATCH(") == 2, name
    assert _constant(body_src, "kRegCiT") == conv3x3.FMA_CI_T
    assert _constant(body_src, "kRegStages") == conv3x3.FMA_STAGES
    assert {64: _constant(body_src, "kRegTHWide"),
            32: _constant(body_src, "kRegTHNarrow")} == conv3x3.FMA_TH
    assert {64: _constant(body_src, "kRegBlocksWide"),
            32: _constant(body_src, "kRegBlocksNarrow")} == conv3x3.FMA_BLOCKS
    # threads: three kernel rows of CO_T / 16 warps
    assert [conv3x3.dw_fma_resources(32, co)[0] for co in (32, 64)] == [192, 384]


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
    f32 allocation's shape recorded."""
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(32, 3, 32), (16, 40, 72), (24, 64, 64)])
def test_conv_dw_wrapper_allocates_the_picked_partials(fake_card, shape, dtype):
    lib, allocated = fake_card
    H, cin, cout = shape
    B = 2
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, H, H, cin, generator=g).to(dtype)
    y, dy = (torch.randn(B, H, H, cout, generator=g).to(dtype) for _ in range(2))
    w = torch.randn(cout, cin, 3, 3, generator=g)
    conv3x3.launch_conv_dw(x, w, torch.ones(cin), torch.zeros(cin), y, dy, torch.zeros(cout),
                           torch.zeros(cout), True)
    args = lib.calls["cltorch_conv3x3_bn_dw"]
    splits, ci_t, co_t, is_bf16 = args[15:19]
    bf16 = dtype == torch.bfloat16
    want = conv3x3.dw_ring_splits(cin, cout, B, H, H) if bf16 else \
        conv3x3.dw_splits(cin, cout, B, H, H, False)
    assert splits == want and is_bf16 == int(bf16)
    assert (ci_t, co_t) == conv3x3.dw_ring_tile(cin, cout)
    assert (splits, cout, cin, 3, 3) in allocated
    assert conv3x3.dw_partials_shape(cin, cout, B, H, H, bf16) == (splits, cout, cin, 3, 3)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(16, 64, 32), (8, 72, 20), (8, 24, 6)])
def test_upconv_dw_wrapper_allocates_the_picked_partials(fake_card, shape, dtype):
    lib, allocated = fake_card
    H, cin, cout = shape
    B = 2
    g = torch.Generator().manual_seed(1)
    x = torch.randn(B, H, H, cin, generator=g).to(dtype)
    dy = torch.randn(B, 2 * H, 2 * H, cout, generator=g).to(dtype)
    upconv_pack.launch_upconv2x2_dw(x, dy)
    args = lib.calls["cltorch_upconv_dw"]
    splits, bm, bn, is_bf16 = args[11:15]
    bf16 = dtype == torch.bfloat16
    want = upconv_pack.dw_ring_splits(cin, cout, B * H * H) if bf16 else \
        upconv_pack.dw_splits(cin, cout, B * H * H)
    assert splits == want and is_bf16 == int(bf16)
    assert (bm, bn) == upconv_pack.dw_ring_tile(cin, cout)
    assert (splits, cin, 4 * cout) in allocated and (splits, 4 * cout) in allocated


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel", ["conv3x3_dw_bn", "conv3x3_g2_dw", "conv3x3_dw"])
@pytest.mark.parametrize("shape", [(16, 16, 3, 32), (16, 12, 40, 72), (24, 24, 64, 64),
                                   (8, 8, 72, 24)])
def test_tiled_dw_wrappers_pass_the_picked_tile(fake_card, shape, kernel, dtype):
    lib, allocated = fake_card
    H, W, cin, cout = shape
    B = 2
    g = torch.Generator().manual_seed(2)
    x = torch.randn(B, H, W, cin, generator=g).to(dtype)
    e = torch.randn(B, H, W, cout, generator=g).to(dtype)
    bf16 = dtype == torch.bfloat16
    if kernel == "conv3x3_dw_bn":
        conv3x3.launch_conv3x3_dw_bn(x, torch.ones(cin), torch.zeros(cin), e, True, e_bf16=True)
        args = lib.calls["cltorch_conv3x3_dw_bn"]
        (splits, ci_t, co_t, is_bf16), ew = args[12:16], args[16]
        assert ew == int(bf16)  # the bf16 chain only in bf16
    else:  # #41 and #31: x and dy
        launch = conv3x3_g2.launch_conv3x3_g2_dw if kernel == "conv3x3_g2_dw" else \
            conv3x3.launch_conv3x3_dw
        launch(x, e)
        args = lib.calls["cltorch_" + kernel]
        splits, ci_t, co_t, is_bf16 = args[9:13]
    assert list(lib.calls) == ["cltorch_" + kernel]
    assert len(args) == len(build.SIGNATURES["cltorch_" + kernel])
    want_tile = conv3x3.dw_ring_tile(cin, cout) if bf16 else conv3x3.dw_fma_tile(cin, cout)
    want_splits = conv3x3.dw_ring_splits(cin, cout, B, H, W) if bf16 else \
        conv3x3.dw_fma_splits(cin, cout, B, H, W)
    assert (ci_t, co_t) == want_tile and splits == want_splits and is_bf16 == int(bf16)
    assert conv3x3.dw_tile_splits(cin, cout, B, H, W, bf16) == (*want_tile, want_splits)
    assert (splits, cout, cin, 3, 3) in allocated and (cout, cin, 3, 3) in allocated


# conv3x3.dw_splits at the headline step's convs (batch 8), as f32 #37 and
# the first dW bodies (#36 in f32, #39) take them (bf16 #37 launches the
# ring dx and #36's ring): (H, Cin, Cout) -> (bf16, f32)
DW_SPLITS_BEFORE = {(512, 3, 32): (264, 264), (512, 32, 32): (264, 264),
                    (256, 32, 64): (132, 132), (256, 64, 64): (66, 66),
                    (128, 64, 128): (33, 33), (128, 128, 128): (17, 17)}


@pytest.mark.parametrize("shape", sorted(DW_SPLITS_BEFORE))
def test_dw_splits_unchanged_for_the_one_pass_backward(shape):
    H, cin, cout = shape
    assert (conv3x3.dw_splits(cin, cout, 8, H, H, True),
            conv3x3.dw_splits(cin, cout, 8, H, H, False)) == DW_SPLITS_BEFORE[shape]


@pytest.mark.parametrize("kernel", sorted(chip_smoke.PACKED_PATH))
def test_kernel_ab_dispatches_every_packed_path_kernel(kernel):
    launch, operands = kernel_ab.dispatch(chip_smoke, kernel)
    fns = chip_smoke.packed_fns(kernel) if kernel in kernel_ab.FORWARD else \
        chip_smoke.bwd_fns(kernel)
    assert launch is fns[0] and callable(operands)


def test_kernel_ab_names_cover_the_path_and_refuse_others():
    assert set(kernel_ab.FORWARD + kernel_ab.BACKWARD) == set(chip_smoke.PACKED_PATH)
    with pytest.raises(ValueError, match="unknown kernel"):
        kernel_ab.dispatch(chip_smoke, "upconv_dW")
    with pytest.raises(ValueError, match="unknown kernel"):
        kernel_ab.main(["old", "new", "conv3x3_bn_dw", "no_such_kernel"])


def test_kernel_ab_takes_the_fisher_accumulation():
    # #19 by name: f32 at baseline_5's flat parameters, eight a Fisher
    # pass, with addcmul_ beside it in every turn
    kernel_ab.check_names(["ewc_sq_acc", "conv3x3_bn_bwd_fused"])
    from cl_tpu_torch.kernels import ewc_fused

    for dtype_name in ("bfloat16", "float32"):
        launch, operands = kernel_ab.dispatch(chip_smoke, "ewc_sq_acc", dtype_name)
        assert launch is ewc_fused.launch_sq_acc and callable(operands)
        assert kernel_ab.shapes(chip_smoke, "ewc_sq_acc", dtype_name) == [((7763635,), 8)]
    acc, g = torch.ones(5), torch.arange(5.0)
    kernel_ab.library(chip_smoke, "ewc_sq_acc")(acc, g)
    assert torch.equal(acc, ewc_fused.sq_acc_plain(torch.ones(5), g))
    assert kernel_ab.library(chip_smoke, "conv3x3_bn_bwd_fused") is not None
    assert kernel_ab.library(chip_smoke, "conv3x3_bn_dw") is None


@pytest.mark.parametrize("rounds", [1, 3])
def test_kernel_ab_rounds_repeat_the_turns(monkeypatch, capsys, rounds):
    # --rounds N runs old, new, new, old N times over and prints every
    # turn's card-sleep reading beside each side's median
    import subprocess

    runs = []

    def fake_run(cmd, **kw):
        if cmd[0] == "nvidia-smi":
            return SimpleNamespace(stdout="NVIDIA H100 80GB HBM3, 700.00 W\n")
        which = "old" if cmd[-2].endswith("old") else "new"
        runs.append(which)
        slept = 0.03 + 0.001 * len(runs)
        row = [[7763635], 8, 0.05, 0.06, slept, 0.034]
        return SimpleNamespace(stdout=json.dumps({"ewc_sq_acc": [row], "build_s": 0.0}) + "\n")

    monkeypatch.setattr(subprocess, "run", fake_run)
    args = ["--rounds", str(rounds)] if rounds > 1 else []
    assert kernel_ab.main(args + ["/tmp/old", "/tmp/new", "ewc_sq_acc"]) == 0
    assert runs == ["old", "new", "new", "old"] * rounds
    out = capsys.readouterr().out
    for which in ("old", "new"):
        turns = [f"{0.03 + 0.001 * (i + 1):.4f}" for i, w in enumerate(runs) if w == which]
        assert f"turns {' '.join(turns)})" in out


@pytest.mark.parametrize("dtype_name", ["bfloat16", "float32"])
@pytest.mark.parametrize("kernel", kernel_ab.OTHER + kernel_ab.GEN3 + kernel_ab.GEN2)
def test_kernel_ab_dispatches_the_switch_and_gen3_gen2_kernels(kernel, dtype_name):
    launch, operands = kernel_ab.dispatch(chip_smoke, kernel, dtype_name)
    assert callable(launch) and callable(operands)
    got = kernel_ab.shapes(chip_smoke, kernel, dtype_name)
    assert got and all(n >= 1 for _, n in got)
    if kernel == "conv3x3_g2_dw":  # #41 at every phase-6 shape
        assert launch is chip_smoke.g2_fns(kernel)[0]
        assert [s for s, _ in got] == chip_smoke.G2_SHAPES[kernel]
    if kernel == "conv3x3_dw":  # #31 at every phase-6 shape, in both dtypes
        assert launch is chip_smoke.v3_fns(kernel)[0] is conv3x3.launch_conv3x3_dw
        assert [s for s, _ in got] == chip_smoke.V3_SHAPES[kernel]
    if kernel == "conv3x3_dw_bn":  # #33: V3_SHAPES in f32, level 3's in bf16
        want = chip_smoke.V3_SHAPES[kernel] if dtype_name == "float32" else \
            [chip_smoke.LEVEL3_TWO_PASS[kernel][0]]
        assert [s for s, _ in got] == want


def test_one_wave_splits_rounds():
    from cl_tpu_torch.kernels import one_wave_splits

    for n in (1, 7, 264, 1000, 16384):
        for tiles in (1, 4, 300):
            for blocks in (1, 2):
                s = one_wave_splits(n, tiles, blocks)
                assert 1 <= s <= n
                assert math.ceil(n / s) == math.ceil(n / max(1, SM_COUNT * blocks // tiles))
