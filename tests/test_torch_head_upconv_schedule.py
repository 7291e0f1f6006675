"""The bf16 packed head's schedules (#7, #8) and the up-conv's (#27, #28), on the CPU.

#7 and #8 run in bf16 on tensor-core bodies (``csrc/head_ce_bn_mma.cuh``)
over persistent grids whose blocks the wrapper picks from the shapes alone
(``kernels/head_ce.py::bn_bwd_tile``, ``bn_fwd_blocks``, ``bn_bwd_blocks``);
#27 and #28 in bf16 on persistent wgmma kernels (``csrc/upconv.cu::
upconv_fwd_wg_kernel``, ``upconv_dx_wg_kernel``) whose column tile, ring
and grid the wrapper picks (``kernels/upconv_pack.py::fwd_tile``,
``fwd_blocks``, ``dx_tile``, ``dx_blocks``). A kernel cannot run here, so
these tests hold what surrounds them: the pickers are pure and give at
least one block, the walk they imply takes every pixel tile (and for #27
and #28 every pixel tile of every column tile) exactly once in one wave of
resident blocks, shared memory fits at every shape the wrappers admit, the
head wrappers allocate one partial row a block and every wrapper passes
its schedule to the C entry points (the up-conv's the f32 weight, with no
host-side copy of it), the f32, KD and prologue-less head entries keep
their entry points, the instances and constants the pickers mirror agree
with the CUDA sources, and ``kernel_ab`` knows #7 and #8.
"""

import os
import re
from collections import Counter
from types import SimpleNamespace

import pytest
import torch

import chip_smoke
from cl_tpu_torch import kernel_ab
from cl_tpu_torch.kernels import (SM_COUNT, SMEM_PER_SM, SMEM_RESERVED_PER_BLOCK, build,
                                  head_ce, upconv_pack)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SMEM_MAX = 232448

# #8: the headline shape and the ragged ones chip_smoke holds the kernel at
HEAD_SHAPES = [kernel_ab.HEAD_SHAPE] + list(chip_smoke.BN_BWD_ODD)
# #27: the headline step's three launches (batch 8) and the ragged ones
# (batch 3), as (batch, H_in, Cin, Cout)
UP_SHAPES = [(8, *s) for s, _ in chip_smoke.PACKED_PATH["upconv_fwd"]] + \
    [(3, *s) for s in chip_smoke.UPCONV_FWD_ODD + chip_smoke.ODD["upconv_fwd"]]
# #28: the same for the dx
DX_SHAPES = [(8, *s) for s, _ in chip_smoke.PACKED_PATH["upconv_dx"]] + \
    [(3, *s) for s in chip_smoke.UPCONV_DX_ODD + chip_smoke.ODD["upconv_dx"]]


def _source(name):
    with open(os.path.join(build.CSRC, name)) as f:
        return f.read()


# ---------------------------------------------------------------------------
# #8
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P,cin,C", HEAD_SHAPES)
def test_head_picker_pure_fits_and_one_wave(P, cin, C):
    tile = head_ce.bn_bwd_tile(cin, C)
    blocks = head_ce.bn_bwd_blocks(P, cin, C)
    assert tile == head_ce.bn_bwd_tile(cin, C)
    assert blocks == head_ce.bn_bwd_blocks(P, cin, C)
    cin16, cmax = tile
    assert cin16 % 16 == 0 and cin <= cin16 < cin + 16 and cmax in (16, 32) and C <= cmax
    threads, smem, per_sm = head_ce.bn_bwd_resources(*tile)
    assert threads == 256 and smem <= SMEM_MAX and per_sm >= 1
    n_tiles = -(-P // head_ce.BN_BWD_TILE)
    assert 1 <= blocks <= min(n_tiles, SM_COUNT * per_sm)


@pytest.mark.parametrize("P,cin,C", HEAD_SHAPES)
def test_head_walk_covers_each_tile_once(P, cin, C):
    # block b walks the 128-pixel tiles b, b + blocks, ...; each takes
    # the same number of tiles, give or take the last
    blocks = head_ce.bn_bwd_blocks(P, cin, C)
    n_tiles = -(-P // head_ce.BN_BWD_TILE)
    walk = {b: list(range(b, n_tiles, blocks)) for b in range(blocks)}
    taken = Counter(tile for tiles in walk.values() for tile in tiles)
    assert set(taken) == set(range(n_tiles)) and set(taken.values()) == {1}
    counts = [len(tiles) for tiles in walk.values()]
    assert min(counts) >= 1 and max(counts) - min(counts) <= 1


def test_head_fits_every_admitted_shape():
    # every Cin the bf16 kernel takes (a multiple of 8 up to 64) and every C
    for cin in range(8, head_ce.MAX_CIN + 1, 8):
        for C in range(1, head_ce.MAX_CLASSES + 1):
            _, smem, per_sm = head_ce.bn_bwd_resources(*head_ce.bn_bwd_tile(cin, C))
            assert smem <= SMEM_MAX and per_sm >= 1
    # the headline: two blocks of eight warps an SM, one wave of 261
    assert head_ce.bn_bwd_tile(32, 19) == (32, 32)
    assert head_ce.bn_bwd_resources(32, 32) == (256, 45568, 2)
    assert head_ce.bn_bwd_blocks(*kernel_ab.HEAD_SHAPE) == 261


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


def _head_operands(P, cin, C, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    y = torch.randn(P, cin, generator=g).to(dtype)
    s, sh = torch.rand(cin, generator=g) + 0.5, torch.randn(cin, generator=g)
    w, b = torch.randn(C, cin, generator=g), torch.randn(C, generator=g)
    labels = torch.randint(0, C, (P,), generator=g, dtype=torch.int32)
    valid = torch.ones(C)
    return y, s, sh, w, b, labels, valid


# (name of the C entry, its argument index of max_blocks)
BWD_MAX_BLOCKS = len(build.SIGNATURES["cltorch_head_ce_bn_bwd"]) - 2


@pytest.mark.parametrize("P,cin,C", [(1000, 8, 2), (4099, 24, 19), (300017, 64, 32)])
def test_head_wrapper_passes_the_schedule(fake_card, P, cin, C):
    lib, allocated = fake_card
    y, s, sh, w, b, labels, valid = _head_operands(P, cin, C, torch.bfloat16)
    head_ce.launch_bn_bwd(y, s, sh, w, b, labels, valid, torch.tensor(0.5))
    args = lib.calls["cltorch_head_ce_bn_bwd"]
    assert len(args) == len(build.SIGNATURES["cltorch_head_ce_bn_bwd"])
    blocks = head_ce.bn_bwd_blocks(P, cin, C)
    n_ent = C * (cin + 1) + 2 * cin
    assert args[17:22] == (P, cin, C, 255, 1) and args[BWD_MAX_BLOCKS] == blocks
    # one partial row a block, as the kernel writes them
    assert (blocks, n_ent) in allocated and (head_ce.N_BLOCKS, n_ent) not in allocated
    assert head_ce.bn_bwd_partials_rows(P, cin, C, True) == blocks


def test_f32_kd_and_prologue_less_heads_keep_their_entries(fake_card):
    lib, allocated = fake_card
    P, cin, C = 1000, 32, 5
    y, s, sh, w, b, labels, valid = _head_operands(P, cin, C, torch.float32)
    gs = torch.tensor(0.25)
    # f32 #8: its entry, with the first body's N_BLOCKS
    head_ce.launch_bn_bwd(y, s, sh, w, b, labels, valid, gs)
    args = lib.calls["cltorch_head_ce_bn_bwd"]
    assert args[21] == 0 and args[BWD_MAX_BLOCKS] == head_ce.N_BLOCKS
    yb = y.to(torch.bfloat16)
    teacher = (yb, s, sh, w, b)
    ov = torch.ones(C)
    # #12 (KD with the prologue), #10 (KD on NHWC features), #6 (no
    # prologue): their own entries, N_BLOCKS partial rows, in bf16 too
    head_ce.launch_kd_bn_bwd(yb, s, sh, w, b, *teacher, labels, valid, ov, gs, gs, 2.0)
    head_ce.launch_kd_bwd(yb, w, b, yb, w, b, labels, valid, ov, gs, gs, 2.0)
    head_ce.launch_pk_bwd(yb, w, b, labels, valid, gs)
    # and the forwards: f32 #7, #11, #9, #5
    head_ce.launch_bn_fwd(y, s, sh, w, b, labels, valid)
    head_ce.launch_kd_bn_fwd(yb, s, sh, w, b, *teacher, labels, valid, ov, 2.0)
    head_ce.launch_kd_fwd(yb, w, b, yb, w, b, labels, valid, ov, 2.0)
    head_ce.launch_pk_fwd(yb, w, b, labels, valid)
    for name in ("cltorch_head_ce_kd_bn_bwd", "cltorch_head_ce_kd_bwd", "cltorch_head_ce_pk_bwd",
                 "cltorch_head_ce_bn_fwd", "cltorch_head_ce_kd_bn_fwd", "cltorch_head_ce_kd_fwd",
                 "cltorch_head_ce_pk_fwd"):
        args = lib.calls[name]
        assert len(args) == len(build.SIGNATURES[name])
        assert args[-2] == head_ce.N_BLOCKS
    assert lib.calls["cltorch_head_ce_bn_fwd"][20] == 0  # the f32 one
    for kd, prologue in ((True, True), (True, False), (False, False)):
        assert head_ce.bn_bwd_partials_rows(P, cin, C, True, kd, prologue) == head_ce.N_BLOCKS
        assert head_ce.bn_fwd_partials_rows(P, cin, C, True, kd, prologue) == head_ce.N_BLOCKS
    assert head_ce.bn_bwd_partials_rows(P, cin, C, False) == head_ce.N_BLOCKS
    assert head_ce.bn_fwd_partials_rows(P, cin, C, False) == head_ce.N_BLOCKS
    assert (head_ce.N_BLOCKS, 1) in allocated and (head_ce.N_BLOCKS, 2) in allocated


def test_head_instances_and_constants_agree_with_the_sources():
    cuh = _source("head_ce_bn_mma.cuh")
    cu = _source("head_ce_bn_mma.cu")
    instanced = {int(v) for v in re.findall(r"CLTORCH_HB\((\d+)\)", cu)}
    picked = {head_ce.bn_bwd_tile(cin, C) for cin in range(8, 65, 8) for C in range(1, 33)}
    assert {p[0] for p in picked} == instanced and {p[1] for p in picked} == {16, 32}
    assert "hb_launch<CIN16, 16>" in cu and "hb_launch<CIN16, 32>" in cu
    assert int(re.search(r"kHbTile = (\d+);", cuh).group(1)) == head_ce.BN_BWD_TILE
    assert int(re.search(r"kHbStages = (\d+);", cuh).group(1)) == head_ce.BN_BWD_STAGES
    assert int(re.search(r"kHbWarps = (\d+);", cuh).group(1)) * 32 == head_ce.BN_BWD_THREADS
    assert "kMinBlocks = CIN16 == 16 && CMAX == 16 ? 3 : CIN16 <= 32 ? 2 : 1;" in cuh
    assert head_ce.bn_bwd_resources(16, 16)[2] == 3 and head_ce.bn_bwd_resources(16, 32)[2] == 2
    # the C entry routes bf16 to the new body, f32 to the first
    entry = _source("head_ce_bn.cu")
    assert "if (is_bf16)\n    return head_ce_bn_bwd_mma(" in entry


# ---------------------------------------------------------------------------
# #7
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P,cin,C", HEAD_SHAPES)
def test_head_fwd_picker_pure_fits_and_one_wave(P, cin, C):
    cin16, cmax = head_ce.bn_bwd_tile(cin, C)
    blocks = head_ce.bn_fwd_blocks(P, cin, C)
    assert blocks == head_ce.bn_fwd_blocks(P, cin, C)
    assert head_ce.bn_fwd_resources(cin16, cmax) == head_ce.bn_fwd_resources(cin16, cmax)
    threads, smem, per_sm = head_ce.bn_fwd_resources(cin16, cmax)
    assert threads == 256 and smem <= SMEM_MAX and per_sm >= 1
    # the block asks for its share of the SM: exactly per_sm are resident
    assert (SMEM_PER_SM // (smem + SMEM_RESERVED_PER_BLOCK)) == per_sm
    # at least as many as #8's (no g tiles, no dx stage)
    assert per_sm >= head_ce.bn_bwd_resources(cin16, cmax)[2]
    tile = head_ce.bn_fwd_tile(cin16)
    n_tiles = -(-P // tile)
    assert 1 <= blocks <= min(n_tiles, SM_COUNT * per_sm)
    # the walk: block b takes tiles b, b + blocks, ..., each exactly once,
    # every block the same number give or take one
    walk = [list(range(b, n_tiles, blocks)) for b in range(blocks)]
    taken = Counter(tile for tiles in walk for tile in tiles)
    assert set(taken) == set(range(n_tiles)) and set(taken.values()) == {1}
    assert min(map(len, walk)) >= 1 and max(map(len, walk)) - min(map(len, walk)) <= 1


def test_head_fwd_fits_every_admitted_shape():
    for cin in range(8, head_ce.MAX_CIN + 1, 8):
        for C in range(1, head_ce.MAX_CLASSES + 1):
            cin16, cmax = head_ce.bn_bwd_tile(cin, C)
            _, smem, per_sm = head_ce.bn_fwd_resources(cin16, cmax)
            assert smem <= SMEM_MAX and per_sm == 3
            # the ring of at least #8's three stages, W, the vectors and the
            # warps' sums fit the share the block asks for
            stages, tile = head_ce.bn_fwd_stages(cin16, cmax), head_ce.bn_fwd_tile(cin16)
            assert head_ce.BN_BWD_STAGES <= stages <= head_ce.BN_FWD_MAX_STAGES
            assert tile in (128, 256) and tile // 16 % 8 == 0  # whole slabs for 8 warps
            layout = (stages * tile * ((cin16 + 8) * 2 + 4) + cmax * (cin16 + 8) * 2
                      + (2 * cin16 + 2 * cmax) * 4 + 8 * 4)
            assert layout <= smem
    # the headline: three blocks an SM of 76,800 B, a ring of three
    # 256-pixel stages, one wave of 391
    assert head_ce.bn_fwd_resources(32, 32) == (256, 76800, 3)
    assert head_ce.bn_fwd_stages(32, 32) == 3 and head_ce.bn_fwd_tile(32) == 256
    assert head_ce.bn_fwd_blocks(*kernel_ab.HEAD_SHAPE) == 391


@pytest.mark.parametrize("P,cin,C", [(1000, 8, 2), (4099, 24, 19), (300017, 64, 32)])
def test_head_fwd_wrapper_passes_the_schedule(fake_card, P, cin, C):
    lib, allocated = fake_card
    y, s, sh, w, b, labels, valid = _head_operands(P, cin, C, torch.bfloat16)
    head_ce.launch_bn_fwd(y, s, sh, w, b, labels, valid)
    args = lib.calls["cltorch_head_ce_bn_fwd"]
    assert len(args) == len(build.SIGNATURES["cltorch_head_ce_bn_fwd"])
    blocks = head_ce.bn_fwd_blocks(P, cin, C)
    assert args[16:21] == (P, cin, C, 255, 1) and args[-2] == blocks
    # one partial a block, as the kernel writes them
    assert (blocks, 1) in allocated and (head_ce.N_BLOCKS, 1) not in allocated
    assert head_ce.bn_fwd_partials_rows(P, cin, C, True) == blocks


def test_head_fwd_constants_agree_with_the_sources():
    cuh = _source("head_ce_bn_mma.cuh")
    cu = _source("head_ce_bn_mma.cu")
    instanced = {int(v) for v in re.findall(r"CLTORCH_HF\((\d+)\)", cu)}
    picked = {head_ce.bn_bwd_tile(cin, C) for cin in range(8, 65, 8) for C in range(1, 33)}
    assert {p[0] for p in picked} == instanced
    assert "hf_launch<CIN16, 16>" in cu and "hf_launch<CIN16, 32>" in cu
    assert f"kMinBlocks = {head_ce.BN_FWD_MIN_BLOCKS};" in cuh
    assert "kSmemPerSm = 233472, kSmemReservedPerBlock = 1024;" in cuh
    assert (SMEM_PER_SM, SMEM_RESERVED_PER_BLOCK) == (233472, 1024)
    assert f"kHfMaxStages = {head_ce.BN_FWD_MAX_STAGES};" in cuh
    assert "kFixed = CMAX * kRowY * 2 + (2 * CIN16 + 2 * CMAX) * 4 + kHbWarps * 4;" in cuh
    assert "kFit = (kSmem - kFixed) / (kStageY * 2 + kTile * 4);" in cuh
    assert "kTile = CIN16 <= 32 ? 2 * kHbTile : kHbTile;" in cuh
    assert [head_ce.bn_fwd_tile(c) for c in (16, 32, 48, 64)] == [256, 256, 128, 128]
    # the C entry routes bf16 to the new body, f32 to the first
    entry = _source("head_ce_bn.cu")
    assert "if (is_bf16)\n    return head_ce_bn_fwd_mma(" in entry
    assert "return launch_bn_fwd<float, false>(" in entry


# ---------------------------------------------------------------------------
# #27
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,H,cin,cout", UP_SHAPES)
def test_upconv_picker_pure_fits_and_one_wave(B, H, cin, cout):
    tile = upconv_pack.fwd_tile(cin, cout)
    pixels = B * H * H
    blocks = upconv_pack.fwd_blocks(cin, cout, pixels)
    assert tile == upconv_pack.fwd_tile(cin, cout)
    assert blocks == upconv_pack.fwd_blocks(cin, cout, pixels)
    bn, stages = tile
    assert bn in (64, 128) and 2 <= stages <= upconv_pack.FWD_MAX_STAGES
    threads, smem, per_sm = upconv_pack.fwd_resources(bn, cin, stages)
    assert threads == 256 and smem <= SMEM_MAX and per_sm >= 1
    col_tiles = -(-(4 * cout) // bn)
    n_tiles = -(-pixels // upconv_pack.FWD_BM)
    assert 1 <= blocks <= n_tiles
    assert blocks * col_tiles <= max(SM_COUNT * per_sm, col_tiles)


@pytest.mark.parametrize("B,H,cin,cout", UP_SHAPES)
def test_upconv_walk_covers_each_tile_once(B, H, cin, cout):
    # block (bx, by) walks the pixel tiles bx, bx + blocks, ... for the
    # columns [by BN, (by + 1) BN), each tile its k-chunks in order
    bn, _ = upconv_pack.fwd_tile(cin, cout)
    blocks = upconv_pack.fwd_blocks(cin, cout, B * H * H)
    n_tiles = -(-(B * H * H) // upconv_pack.FWD_BM)
    col_tiles = -(-(4 * cout) // bn)
    taken = Counter((tile, by) for bx in range(blocks) for by in range(col_tiles)
                    for tile in range(bx, n_tiles, blocks))
    assert set(taken) == {(t, by) for t in range(n_tiles) for by in range(col_tiles)}
    assert set(taken.values()) == {1}
    counts = [len(range(bx, n_tiles, blocks)) for bx in range(blocks)]
    assert min(counts) >= 1 and max(counts) - min(counts) <= 1


def test_upconv_headline_tiles():
    # two blocks an SM at each level: one column tile of 128 at level 0, two
    # at level 1, eight of 64 at level 2 (128 leaves room for one block)
    assert upconv_pack.fwd_tile(64, 32) == (128, 3)
    assert upconv_pack.fwd_tile(128, 64) == (128, 2)
    assert upconv_pack.fwd_tile(256, 128) == (64, 3)
    for cin, cout in ((64, 32), (128, 64), (256, 128)):
        assert upconv_pack.fwd_resources(*upconv_pack.fwd_tile(cin, cout)[:1], cin,
                                         upconv_pack.fwd_tile(cin, cout)[1])[2] == 2
    # a partial column tile: 4 x 40 = 160 columns over two tiles of 128
    assert upconv_pack.fwd_tile(40, 40)[0] == 128
    # where no tile leaves room for two blocks, one block an SM
    assert upconv_pack.fwd_resources(*upconv_pack.fwd_tile(1024, 512)[:1], 1024,
                                     upconv_pack.fwd_tile(1024, 512)[1])[2] == 1


def test_upconv_fits_every_admitted_shape():
    # every bf16 shape the wrapper admits up to 1024 channels gets a tile
    # that fits; the packed bodies' shapes at base 8 to 64 among them
    for cin in range(8, 1025, 8):
        for cout in range(4, 1025, 4):
            bn, stages = upconv_pack.fwd_tile(cin, cout)
            assert upconv_pack.fwd_smem(bn, cin, stages) <= SMEM_MAX
    with pytest.raises(ValueError, match="no tile fits"):
        upconv_pack.fwd_tile(4096, 1024)


@pytest.mark.parametrize("B,H,cin,cout", [(2, 16, 64, 32), (3, 20, 40, 40), (1, 9, 72, 8)])
def test_upconv_wrapper_passes_the_schedule(fake_card, B, H, cin, cout):
    lib, _ = fake_card
    g = torch.Generator().manual_seed(cin)
    w, bias = torch.randn(cin, cout, 2, 2, generator=g), torch.randn(cout, generator=g)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(B, H, H, cin, generator=g).to(dtype)
        upconv_pack.launch_upconv2x2(x, w, bias)
        args = lib.calls["cltorch_upconv_fwd"]
        assert len(args) == len(build.SIGNATURES["cltorch_upconv_fwd"])
        assert args[4:9] == (B, H, H, cin, cout)
        if dtype == torch.bfloat16:
            assert args[9:13] == (*upconv_pack.fwd_tile(cin, cout),
                                  upconv_pack.fwd_blocks(cin, cout, B * H * H), 1)
        else:
            assert args[9:13] == (0, 0, 0, 0)


def test_upconv_bf16_wrapper_refuses_what_the_kernel_cannot_take(fake_card):
    for cin, cout in ((12, 16), (16, 6)):
        x = torch.zeros(1, 4, 4, cin, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="Cin % 8 == 0"):
            upconv_pack.launch_upconv2x2(x, torch.zeros(cin, cout, 2, 2), torch.zeros(cout))


def test_upconv_constants_agree_with_the_sources():
    src = _source("upconv.cu")
    for name, value in (("kUfBM", upconv_pack.FWD_BM), ("kUfBK", upconv_pack.FWD_BK),
                        ("kUfThreads", upconv_pack.FWD_THREADS),
                        ("kUfMaxStages", upconv_pack.FWD_MAX_STAGES),
                        ("kUfSmemMax", upconv_pack.FWD_SMEM_MAX)):
        assert int(re.search(rf"{name} = (\d+);", src).group(1)) == value
    instanced = {int(v) for v in re.findall(r"CLTORCH_UP_FWD\((\d+)\)", src)}
    picked = {upconv_pack.fwd_tile(cin, cout)[0] for cin in range(8, 1025, 8)
              for cout in range(4, 1025, 4)}
    assert picked == instanced == {64, 128}
    assert f"kMinBlocks = {upconv_pack.FWD_MIN_BLOCKS};" in src
    assert ("1024 + kc * kWChunk + stages * kUfStage + kUfBM * kRowO * 2 + BN * 4 +\n"
            "           (kUfBM + BN / 8) * 8 + stages * 8") in src


# ---------------------------------------------------------------------------
# #28
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,H,cin,cout", DX_SHAPES)
def test_upconv_dx_picker_pure_fits_and_one_wave(B, H, cin, cout):
    tile = upconv_pack.dx_tile(cin, cout)
    pixels = B * H * H
    blocks = upconv_pack.dx_blocks(cin, cout, pixels)
    assert tile == upconv_pack.dx_tile(cin, cout)
    assert blocks == upconv_pack.dx_blocks(cin, cout, pixels)
    bn, stages = tile
    assert bn in (64, 128) and 2 <= stages <= upconv_pack.FWD_MAX_STAGES
    threads, smem, per_sm = upconv_pack.dx_resources(bn, cout, stages)
    assert threads == 256 and smem <= SMEM_MAX and per_sm >= 1
    col_tiles = -(-cin // bn)
    n_tiles = -(-pixels // upconv_pack.FWD_BM)
    assert 1 <= blocks <= n_tiles
    assert blocks * col_tiles <= max(SM_COUNT * per_sm, col_tiles)
    # block (bx, by) walks the pixel tiles bx, bx + blocks, ... for the
    # input channels [by BN, (by + 1) BN): every (tile, column tile) once
    taken = Counter((t, by) for bx in range(blocks) for by in range(col_tiles)
                    for t in range(bx, n_tiles, blocks))
    assert set(taken) == {(t, by) for t in range(n_tiles) for by in range(col_tiles)}
    assert set(taken.values()) == {1}
    counts = [len(range(bx, n_tiles, blocks)) for bx in range(blocks)]
    assert min(counts) >= 1 and max(counts) - min(counts) <= 1


def test_upconv_dx_headline_tiles():
    # two blocks an SM at each level, with a column tile of 64: level 2's
    # Kg (256 x 512) as four slices, two stages; level 1 two slices, four
    # stages; level 0 one, five stages; each exactly half the SM
    assert upconv_pack.dx_tile(256, 128) == (64, 2)
    assert upconv_pack.dx_tile(128, 64) == (64, 4)
    assert upconv_pack.dx_tile(64, 32) == (64, 5)
    for cin, cout in ((256, 128), (128, 64), (64, 32)):
        bn, stages = upconv_pack.dx_tile(cin, cout)
        assert upconv_pack.dx_resources(bn, cout, stages) == (256, 115712, 2)
        assert not upconv_pack.dx_streamed(bn, cout, stages)
    assert [upconv_pack.dx_blocks(cin, cout, 8 * h * h) for h, cin, cout in
            ((64, 256, 128), (128, 128, 64), (256, 64, 32))] == [64, 128, 256]
    # a column tile of 128 where it leaves room for two blocks
    assert upconv_pack.dx_tile(72, 24)[0] == 128
    # where the slice leaves room for one block only, one block an SM
    assert upconv_pack.dx_tile(8, 320) == (64, 3)
    assert upconv_pack.dx_resources(64, 320, 3)[2] == 1
    # where no slice fits whole (4·Cout above ~1400 at BN 64), it is
    # streamed, a chunk a stage, two blocks an SM
    for cin, cout in ((16, 384), (24, 400), (1024, 1024)):
        bn, stages = upconv_pack.dx_tile(cin, cout)
        assert upconv_pack.dx_streamed(bn, cout, stages)
        assert upconv_pack.dx_resources(bn, cout, stages)[2] == 2
    assert upconv_pack.dx_tile(1024, 1024) == (128, 2)


def test_upconv_dx_fits_every_admitted_shape():
    # every shape the forward admits, the dx admits, and its launch fits
    for cin in range(8, 1025, 8):
        for cout in list(range(4, 1025, 4)) + [4096]:
            upconv_pack.fwd_tile(cin, cout)
            bn, stages = upconv_pack.dx_tile(cin, cout)
            _, smem, per_sm = upconv_pack.dx_resources(bn, cout, stages)
            assert smem <= SMEM_MAX and per_sm >= 1
            assert smem == upconv_pack.dx_smem(bn, cout, stages,
                                               upconv_pack.dx_streamed(bn, cout, stages))


@pytest.mark.parametrize("B,H,cin,cout", [(2, 16, 64, 32), (3, 20, 40, 40), (1, 9, 72, 8)])
def test_upconv_dx_wrapper_passes_the_weight_and_schedule(fake_card, monkeypatch, B, H, cin,
                                                          cout):
    lib, allocated = fake_card
    copies = []
    gemm_weight = upconv_pack.gemm_weight
    monkeypatch.setattr(upconv_pack, "gemm_weight",
                        lambda *a: copies.append(a) or gemm_weight(*a))
    g = torch.Generator().manual_seed(cin)
    w = torch.randn(cin, cout, 2, 2, generator=g)
    for dtype in (torch.bfloat16, torch.float32):
        dy = torch.randn(B, 2 * H, 2 * H, cout, generator=g).to(dtype)
        del allocated[:]
        upconv_pack.launch_upconv2x2_dx(dy, w)
        args = lib.calls["cltorch_upconv_dx"]
        assert len(args) == len(build.SIGNATURES["cltorch_upconv_dx"])
        assert args[3:8] == (B, H, H, cin, cout)
        if dtype == torch.bfloat16:
            # the module's f32 weight as it lies, the picker's schedule, one
            # allocation (dx) and no Kg formed on the host
            assert args[1] == w.data_ptr() and not copies
            assert args[8:12] == (*upconv_pack.dx_tile(cin, cout),
                                  upconv_pack.dx_blocks(cin, cout, B * H * H), 1)
            assert allocated == [(B, H, H, cin)]
        else:
            assert args[8:12] == (0, 0, 0, 0) and len(copies) == 1


def test_upconv_dx_bf16_wrapper_refuses_what_the_kernel_cannot_take(fake_card):
    for cin, cout in ((12, 16), (16, 6)):
        dy = torch.zeros(1, 8, 8, cout, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="Cin % 8 == 0 and Cout % 4 == 0"):
            upconv_pack.launch_upconv2x2_dx(dy, torch.zeros(cin, cout, 2, 2))
    # f32 takes them (the FMA kernel has no such condition)
    upconv_pack.launch_upconv2x2_dx(torch.zeros(1, 8, 8, 6), torch.zeros(12, 6, 2, 2))


def test_upconv_dx_constants_agree_with_the_sources():
    src = _source("upconv.cu")
    instanced = {int(v) for v in re.findall(r"CLTORCH_UP_DX\((\d+)\)", src)}
    picked = {upconv_pack.dx_tile(cin, cout)[0] for cin in range(8, 1025, 8)
              for cout in range(4, 1025, 4)}
    assert picked == instanced == {64, 128}
    assert "struct UpDx {\n  static constexpr int kMinBlocks = 2;" in src
    assert upconv_pack.DX_MIN_BLOCKS == 2
    assert "return 1024 + kc * kWChunk + stages * kUfStage + kOut;" in src
    assert "return 1024 + stages * (kWChunk + kUfStage) + kOut;" in src
    assert "const int streamed = resident > kUfSmemMax;" in src
    assert "static constexpr int kOut = kUfBM * BN * 2;" in src
    # the bf16 entry forms Kg in the kernel; the f32 one keeps the FMA body
    assert "upconv_dx_kernel<float><<<" in src and "upconv_dx_mma_kernel" not in src


# ---------------------------------------------------------------------------
# kernel_ab
# ---------------------------------------------------------------------------


def test_kernel_ab_knows_the_head_forward():
    kernel_ab.check_names(["head_ce_bn_fwd", "head_ce_bn_bwd", "upconv_dx"])
    with pytest.raises(ValueError, match="unknown kernel"):
        kernel_ab.check_names(["head_ce_bn_fwdx"])
    calls = []
    smoke = SimpleNamespace(
        PACKED_PATH=chip_smoke.PACKED_PATH,
        bn_case=lambda *a: calls.append(("case", a)) or {"case": a},
        bn_fns=lambda k, case: (lambda: calls.append(("launch", k, case["case"])), None))
    assert kernel_ab.shapes(smoke, "head_ce_bn_fwd") == [(kernel_ab.HEAD_SHAPE, 1)]
    launch, operands = kernel_ab.dispatch(smoke, "head_ce_bn_fwd")
    launch(*operands(kernel_ab.HEAD_SHAPE))
    case = (*kernel_ab.HEAD_SHAPE, "bfloat16", kernel_ab.HEAD_SEED)
    assert calls == [("case", case), ("launch", "head_ce_bn_fwd", case)]
    assert "head_ce_bn_fwd" in kernel_ab.__doc__


def test_kernel_ab_knows_the_head_backward():
    kernel_ab.check_names(["head_ce_bn_bwd", "upconv_fwd"])
    with pytest.raises(ValueError, match="unknown kernel"):
        kernel_ab.check_names(["head_ce_bn_bwd", "head_ce_bn_bwdx"])
    # an unknown name is refused before any turn runs
    with pytest.raises(ValueError, match="unknown kernel"):
        kernel_ab.main(["old", "new", "nope"])
    calls = []
    smoke = SimpleNamespace(
        PACKED_PATH=chip_smoke.PACKED_PATH,
        bn_case=lambda *a: calls.append(("case", a)) or {"case": a},
        bn_fns=lambda k, case: (lambda: calls.append(("launch", k, case["case"])), None))
    assert kernel_ab.shapes(smoke, "head_ce_bn_bwd") == [(kernel_ab.HEAD_SHAPE, 1)]
    assert kernel_ab.shapes(smoke, "upconv_fwd") == chip_smoke.PACKED_PATH["upconv_fwd"]
    launch, operands = kernel_ab.dispatch(smoke, "head_ce_bn_bwd")
    launch(*operands(kernel_ab.HEAD_SHAPE))
    case = (*kernel_ab.HEAD_SHAPE, "bfloat16", kernel_ab.HEAD_SEED)
    assert calls == [("case", case), ("launch", "head_ce_bn_bwd", case)]
    # the headline's case is phase 3's (the seed of chip_smoke's bn_full)
    assert kernel_ab.HEAD_SEED == 2 and kernel_ab.HEAD_SHAPE == (2097152, 32, 19)
