"""The one-pass conv backward's (#37) launches and schedules, on the CPU.

In bf16 ``kernels/conv3x3.py::launch_conv_bwd_fused`` launches the ring dx
(#34/#35's kernel, ``csrc/conv3x3_ring.cu``; none for the stem) and #36's
ring (``csrc/conv3x3_bn_bwd.cu``), each with the schedule its shapes give
(``conv_ring_tile`` / ``conv_ring_blocks``, ``dw_ring_tile`` /
``dw_ring_splits``); in f32 the FMA kernel of ``csrc/conv3x3_bn_bwd_fused.cu``
with ``dw_splits``. A kernel cannot run here, so these tests hold what
surrounds them at every shape the switch phases launch #37 at: the pickers
are pure and give at least one split in one wave of resident blocks, the
blocks take every (channel tile, pixel tile) exactly once, the wrapper
passes each kernel the arguments its own wrapper would and allocates the
partials they imply, and the constants mirrored from the CUDA source
agree with it.
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

SRC = os.path.join(build.CSRC, "conv3x3_bn_bwd_fused.cu")
# (H, Cin, Cout) of every #37 launch the switch phases make: the headline
# step's convs and the ragged ones (the stem, Cin 3, without dx)
PATH = [(H, cin, cout) for (H, cin, cout, _), _ in chip_smoke.SWITCH_PATH["conv3x3_bn_bwd_fused"]]
ODD = [(H, cin, cout) for H, cin, cout, _ in chip_smoke.SWITCH_ODD["conv3x3_bn_bwd_fused"]]
# and the widths a packed level 3 or an odd config gives: Cout 256, a width
# not a multiple of 8, Cout <= 16, a ragged channel tile
MORE = [(64, 128, 256), (64, 256, 256), (20, 12, 40), (20, 40, 72), (19, 48, 8)]
SHAPES = PATH + ODD + MORE


def dw_schedule(cin, cout, B, H, W):
    """#36's blocks and the (channel tile, pixel tile) pairs each takes:
    {(bx, by, bz): [((bx, by), tile), ...]}, bz taking tiles bz, bz +
    splits, ..."""
    ci_t, co_t = conv3x3.dw_ring_tile(cin, cout)
    splits = conv3x3.dw_ring_splits(cin, cout, B, H, W)
    n_tiles = B * -(-H // conv3x3.RING_TH) * -(-W // 16)
    return {(bx, by, bz): [((bx, by), t) for t in range(bz, n_tiles, splits)]
            for bx in range(-(-cin // ci_t)) for by in range(-(-cout // co_t))
            for bz in range(splits)}


def dx_schedule(cin, cout, B, H, W, prologue):
    """The ring dx's blocks (a conv Cout -> Cin with e formed from y) and
    the (dx channel tile, 16 x 16 pixel tile) pairs each takes."""
    cot = conv3x3.conv_ring_tile(cout, cin, True, True)[0]
    blocks = conv3x3.conv_ring_blocks(cout, cin, B, H, W, True, True, prologue)
    n_tiles = B * -(-H // conv3x3.TILE) * -(-W // conv3x3.TILE)
    return {(bx, bz): [(bx, t) for t in range(bz, n_tiles, blocks)]
            for bx in range(-(-cin // cot)) for bz in range(blocks)}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("batch", [8, 3])
def test_routed_splits_pure_and_one_wave(shape, batch):
    H, cin, cout = shape
    splits = conv3x3.dw_ring_splits(cin, cout, batch, H, H)
    assert splits == conv3x3.dw_ring_splits(cin, cout, batch, H, H)
    assert 1 <= splits <= batch * -(-H // conv3x3.RING_TH) * -(-H // 16)
    ci_t, co_t = conv3x3.dw_ring_tile(cin, cout)
    channel_tiles = -(-cin // ci_t) * -(-cout // co_t)
    blocks = conv3x3.dw_ring_resources(ci_t, co_t)[2]
    # one wave of resident blocks, unless one split a channel tile is more
    assert channel_tiles * splits <= max(SM_COUNT * blocks, channel_tiles)
    if cin == 3:  # the stem: no dx
        return
    for prologue in (False, True):
        n = conv3x3.conv_ring_blocks(cout, cin, batch, H, H, True, True, prologue)
        assert n == conv3x3.conv_ring_blocks(cout, cin, batch, H, H, True, True, prologue)
        assert 1 <= n <= batch * (-(-H // 16)) ** 2
        cot, ck, resident = conv3x3.conv_ring_tile(cout, cin, True, True)
        xbuf = conv3x3.conv_ring_xbuf(cout, cin, True, True, prologue)
        per_sm = conv3x3.conv_ring_resources(cot, ck, True, True, resident, cout, xbuf)[2]
        tiles = -(-cin // cot)
        assert tiles * n <= max(SM_COUNT * per_sm, tiles)


@pytest.mark.parametrize("shape", SHAPES)
def test_routed_schedule_covers_each_pair_once(shape):
    H, cin, cout = shape
    batch = 8 if shape in PATH else 3
    ci_t, co_t = conv3x3.dw_ring_tile(cin, cout)
    n_tiles = batch * -(-H // conv3x3.RING_TH) * -(-H // 16)
    dw = dw_schedule(cin, cout, batch, H, H)
    pairs = Counter(p for taken in dw.values() for p in taken)
    assert pairs == Counter({((bx, by), t): 1 for bx in range(-(-cin // ci_t))
                             for by in range(-(-cout // co_t)) for t in range(n_tiles)})
    counts = [len(taken) for taken in dw.values()]
    assert max(counts) - min(counts) <= 1
    if cin == 3:
        return
    for prologue in (False, True):
        dx = dx_schedule(cin, cout, batch, H, H, prologue)
        cot = conv3x3.conv_ring_tile(cout, cin, True, True)[0]
        pairs = Counter(p for taken in dx.values() for p in taken)
        assert pairs == Counter({(bx, t): 1 for bx in range(-(-cin // cot))
                                 for t in range(batch * (-(-H // 16)) ** 2)})
        counts = [len(taken) for taken in dx.values()]
        assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("shape", SHAPES)
def test_routed_tiles_fit(shape):
    _, cin, cout = shape
    ci_t, co_t = conv3x3.dw_ring_tile(cin, cout)
    assert conv3x3.dw_ring_resources(ci_t, co_t)[2] >= 1
    if cin == 3:
        return
    cot, ck, resident = conv3x3.conv_ring_tile(cout, cin, True, True)
    for prologue in (False, True):
        xbuf = conv3x3.conv_ring_xbuf(cout, cin, True, True, prologue)
        _, smem, blocks = conv3x3.conv_ring_resources(cot, ck, True, True, resident, cout, xbuf)
        assert smem <= conv3x3.RING_CONV_SMEM_MAX and blocks >= 1


def _source():
    with open(SRC) as f:
        return f.read()


def test_fused_source_holds_the_f32_kernel_alone():
    src = _source()
    kernels = re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(", src)
    assert kernels == ["conv3x3_bn_bwd_fused_fma_kernel"]
    assert "bf16" not in re.sub(r"//.*", "", src)
    # the f32 tiles the wrapper sizes da's and db's rows by: 8 x 16
    assert int(re.search(r"constexpr int kFfTH = (\d+);", src).group(1)) == conv3x3.TILE // 2
    entry = src[src.index('extern "C" {'):]
    params = entry[entry.index("(") + 1:entry.index(")")]
    assert len(params.split(",")) == len(build.SIGNATURES["cltorch_conv3x3_bn_bwd_fused"])
    assert "cltorch_conv3x3_bn_bwd_fused_info" not in build.SIGNATURES


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


def _operands(H, cin, cout, dtype, prologue=True, seed=0):
    g = torch.Generator().manual_seed(seed)
    B = 2
    x = torch.randn(B, H, H, cin, generator=g).to(dtype)
    y, dy = (torch.randn(B, H, H, cout, generator=g).to(dtype) for _ in range(2))
    w = torch.randn(cout, cin, 3, 3, generator=g)
    return B, (x, w, torch.ones(cin), torch.zeros(cin), y, dy, torch.zeros(cout),
               torch.zeros(cout), prologue)


def _ints(name, args):
    """The integer arguments of an entry point's call: its shapes, schedule
    and flags (not its pointers)."""
    return [a for a, kind in zip(args, build.SIGNATURES[name]) if kind is build.I]


@pytest.mark.parametrize("prologue", [True, False])
@pytest.mark.parametrize("ew", [False, True])
@pytest.mark.parametrize("shape", [(32, 32, 32), (24, 40, 72), (40, 64, 128), (20, 12, 40)])
def test_fused_wrapper_launches_the_ring_dx_and_36s_ring(fake_card, shape, ew, prologue):
    lib, allocated = fake_card
    H, cin, cout = shape
    B, ops = _operands(H, cin, cout, torch.bfloat16, prologue)
    dx, da, db, dw = conv3x3.launch_conv_bwd_fused(*ops, e_bf16=ew)
    fused = dict(lib.calls)
    assert sorted(fused) == ["cltorch_conv3x3_bn_dw", "cltorch_conv3x3_bn_ring"]
    ring = fused["cltorch_conv3x3_bn_ring"]
    assert len(ring) == len(build.SIGNATURES["cltorch_conv3x3_bn_ring"])
    assert ring[0] == 1 and ring[-2] == int(ew)  # the dx, with the flag
    assert (dx.shape, dw.shape, da.shape, db.shape) == (ops[0].shape, (cout, cin, 3, 3),
                                                        (cin,), (cin,))
    if not prologue:
        assert not da.any() and not db.any()
    assert conv3x3.dx_partials_shape(cin, B, H, H, prologue) in allocated
    assert conv3x3.dw_partials_shape(cin, cout, B, H, H, True) in allocated
    # the same integer arguments (shapes, schedule, flags) as their own wrappers pass
    lib.calls.clear()
    conv3x3.launch_conv_dx(*ops, e_bf16=ew)
    conv3x3.launch_conv_dw(*ops, ew)
    assert sorted(lib.calls) == sorted(fused)
    for name, args in lib.calls.items():
        assert _ints(name, args) == _ints(name, fused[name]), name


def test_fused_wrapper_sends_the_stem_to_36s_ring(fake_card):
    lib, allocated = fake_card
    B, ops = _operands(32, 3, 32, torch.bfloat16, seed=1)
    dx, da, db, _ = conv3x3.launch_conv_bwd_fused(*ops, need_dx=False)
    assert dx is None and not da.any() and not db.any()
    assert list(lib.calls) == ["cltorch_conv3x3_bn_dw"]
    args = lib.calls["cltorch_conv3x3_bn_dw"]
    want = (conv3x3.dw_ring_splits(3, 32, B, 32, 32), *conv3x3.dw_ring_tile(3, 32), 1)
    assert args[15:19] == want


@pytest.mark.parametrize("need_dx", [True, False])
def test_fused_wrapper_f32_keeps_its_splits(fake_card, need_dx):
    lib, allocated = fake_card
    H, cin, cout = 24, 32, 64
    B, ops = _operands(H, cin, cout, torch.float32, seed=2)
    conv3x3.launch_conv_bwd_fused(*ops, need_dx=need_dx)
    assert list(lib.calls) == ["cltorch_conv3x3_bn_bwd_fused"]
    args = lib.calls["cltorch_conv3x3_bn_bwd_fused"]
    assert len(args) == len(build.SIGNATURES["cltorch_conv3x3_bn_bwd_fused"])
    splits = args[19]
    assert splits == conv3x3.dw_splits(cin, cout, B, H, H, False)
    assert (splits, cout, cin, 3, 3) in allocated
    rows = B * -(-H // 8) * -(-H // 16) if need_dx else 1  # 8 x 16 tiles in f32
    assert (rows, 2, cin) in allocated
