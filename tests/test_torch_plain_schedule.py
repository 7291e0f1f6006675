"""The plain conv's (#30, #40) schedules and launches, on the CPU.

``kernels/conv3x3.py::launch_plain`` (behind ``launch_conv3x3``, #30, and
``conv3x3_g2.launch_conv3x3_g2``, #40) launches one kernel of
``csrc/conv3x3_plain_body.cuh`` with the schedule ``plain_schedule`` gives:
in bf16 the ring body's kPlain MODE (``conv_plain_tile``: COT, CK, resident
weights; ``conv_plain_blocks``: one wave of persistent blocks), in f32 the
register-blocked FMA body (``plain_fma_tile``: COT). A kernel cannot run
here, so these tests hold what surrounds it at every conv the paths and
the phase-3 lists launch the plain conv at, each as a forward and as its
dx (the conv Cout -> Cin): the pickers are pure and fit the instance's
blocks an SM in one wave, the walk takes every (pixel tile, channel tile)
exactly once, the instances and constants of the CUDA sources agree with
the pickers, and both wrappers hand their entry point the schedule.
"""

import os
import re
from collections import Counter
from types import SimpleNamespace

import pytest
import torch

import chip_smoke
from cl_tpu_torch.kernels import SM_COUNT, build, conv3x3, conv3x3_g2
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _convs():
    """(B, H, W, Cin, Cout) of every plain conv of the lists and paths, each
    forward and dx."""
    fwd = {(8, H, H, ci, co) for H, ci, co in chip_smoke.V3_SHAPES["conv3x3_fwd"]}
    fwd |= {(3, H, H, ci, co) for H, ci, co in chip_smoke.V3_ODD["conv3x3_fwd"]}
    fwd |= {(8, *s) for k in ("conv3x3_g2_fwd", "conv3x3_g2_dx") for s in chip_smoke.G2_SHAPES[k]}
    fwd |= {(3, *s) for s in chip_smoke.G2_ODD}
    fwd |= {(8, H, H, ci, co) for H, ci, co in chip_smoke.v3_path_shapes()}
    fwd |= {(8, H, H, ci, co) for _, (H, ci, co) in chip_smoke.plain_path_convs()}
    fwd |= {(8, H, H, ci, co) for H, ci, co in chip_smoke.PLAIN_EXTRA}
    return sorted(fwd | {(B, H, W, co, ci) for B, H, W, ci, co in fwd})


CONVS = _convs()


def _tiles(B, H, W):
    return B * -(-H // conv3x3.TILE) * -(-W // conv3x3.TILE)


def test_the_convs_hold_the_paths():
    # 5g-c's gen-2 convs at the 512² standard body reach 512 channels at 32²
    # (its streamed-weights instance), baseline_2's 1024 at 16²
    assert (8, 32, 32, 512, 512) in CONVS and (8, 16, 16, 1024, 1024) in CONVS
    assert (8, 64, 64, 3, 32) in CONVS  # the plain loads of a narrow Cin
    assert {(8, H, H, ci, co) for _, (H, ci, co) in chip_smoke.plain_path_convs()} <= set(CONVS)


@pytest.mark.parametrize("conv", CONVS)
def test_plain_pickers_pure_fit_and_one_wave(conv):
    B, H, W, cin, cout = conv
    sched = conv3x3.plain_schedule(cin, cout, B, H, W, True)
    assert sched == conv3x3.plain_schedule(cin, cout, B, H, W, True)
    cot, ck, resident, blocks = sched
    assert cot in (32, 64, 128) and cot < 2 * max(32, cout) and ck in (16, 32)
    assert ck == 16 or (cin % 8 == 0 and cin > 16)  # 32 only for TMA widths past 16
    assert resident or cin % 8 == 0  # plain loads keep the weights resident
    _, smem, per_sm = conv3x3.conv_plain_resources(cot, ck, resident, cin)
    assert smem <= conv3x3.RING_CONV_SMEM_MAX and per_sm >= 1
    ctiles = -(-cout // cot)
    assert 1 <= blocks <= _tiles(B, H, W)
    assert ctiles * blocks <= max(SM_COUNT * per_sm, ctiles)  # one wave
    f32 = conv3x3.plain_schedule(cin, cout, B, H, W, False)
    assert f32 == conv3x3.plain_schedule(cin, cout, B, H, W, False)
    assert f32[0] in (32, 64) and f32[1:] == (0, 0, 0)
    _, smem32, per_sm32 = conv3x3.plain_fma_resources(f32[0])
    assert per_sm32 == conv3x3.PLAIN_FMA_BLOCKS[f32[0]]  # the shared memory allows them


@pytest.mark.parametrize("conv", CONVS)
def test_plain_walk_covers_each_pair_once(conv):
    B, H, W, cin, cout = conv
    cot, _, _, blocks = conv3x3.plain_schedule(cin, cout, B, H, W, True)
    n_tiles = _tiles(B, H, W)
    # block (bx, by) walks the pixel tiles bx, bx + blocks, ... of channel tile by
    taken = {(bx, by): [(by, t) for t in range(bx, n_tiles, blocks)]
             for bx in range(blocks) for by in range(-(-cout // cot))}
    pairs = Counter(p for walk in taken.values() for p in walk)
    assert pairs == Counter({(by, t): 1 for by in range(-(-cout // cot))
                             for t in range(n_tiles)})
    counts = [len(walk) for walk in taken.values()]
    assert max(counts) - min(counts) <= 1 and min(counts) >= 1
    # f32: one block a (pixel tile, channel tile, image), its grid
    cot32 = conv3x3.plain_schedule(cin, cout, B, H, W, False)[0]
    grid = (n_tiles // B, -(-cout // cot32), B)
    assert grid[0] * grid[2] == n_tiles and grid[1] * cot32 >= cout


def test_plain_picker_takes_the_measured_schedules():
    # the schedules the card ran fastest (PERF.md §6): two blocks an SM
    # with travelling weights over one with resident ones; the widest COT
    # and stage where few pixel tiles leave SMs without a block anyway
    want = {(256, 256, 64, 64): (64, 16, 1, 256), (256, 256, 128, 64): (64, 16, 0, 256),
            (256, 256, 64, 128): (128, 32, 1, 128), (64, 64, 256, 256): (128, 16, 0, 64),
            (16, 16, 1024, 1024): (64, 32, 0, 8), (16, 16, 1024, 512): (32, 32, 0, 8),
            (32, 32, 512, 512): (128, 16, 0, 32), (512, 512, 32, 32): (32, 32, 1, 256)}
    for (H, W, cin, cout), sched in want.items():
        assert conv3x3.plain_schedule(cin, cout, 8, H, W, True) == sched
    # a ragged Cout at few tiles: COT 32 (40 = 32 + 8)
    assert conv3x3.plain_schedule(64, 40, 8, 16, 16, True)[0] == 32
    assert conv3x3.plain_schedule(1024, 1024, 8, 16, 16, False)[0] == 32
    assert conv3x3.plain_schedule(64, 128, 8, 128, 128, False)[0] == 64
    with pytest.raises(ValueError, match="no tile fits"):  # plain loads: resident weights
        conv3x3.conv_plain_tile(4099, 32, 8)


def _source(name):
    with open(os.path.join(build.CSRC, name)) as f:
        return f.read()


def test_instances_and_constants_agree_with_the_sources():
    body = _source("conv3x3_plain_body.cuh")
    dispatch = body[body.index("#define CLTORCH_PLAIN_DISPATCH"):]
    ring = {(int(a), int(b)) for a, b in re.findall(r"return RING\((\d+), (\d+)\)", dispatch)}
    fma = {int(a) for a in re.findall(r"return FMA\((\d+)\)", dispatch)}
    picked = {conv3x3.conv_plain_tile(cin, cout, n)[:2]
              for cin in (3, 5, 8, 16, 24, 32, 64, 128, 256, 512, 1024)
              for cout in (16, 32, 40, 64, 128, 256, 512, 1024) for n in (8, 64, 2048)}
    assert picked == ring
    assert {conv3x3.plain_fma_tile(cout, 8, h, h) for cout in (16, 32, 64, 128, 1024)
            for h in (16, 64, 256)} == fma
    assert int(re.search(r"kPfCi = (\d+);", body).group(1)) == conv3x3.PLAIN_FMA_CI
    assert int(re.search(r"kPfStages = (\d+);", body).group(1)) == conv3x3.PLAIN_FMA_STAGES
    row = int(re.search(r"kPfRow = (\d+);", body).group(1))
    pad = int(re.search(r"kPfPlane = kWinH \* kPfRow \+ (\d+);", body).group(1))
    assert (conv3x3.TILE + 2) * row + pad == conv3x3.PLAIN_FMA_PLANE
    m = re.search(r"struct PlainFmaTile \{.*?kMinBlocks = COT == 64 \? (\d+) : (\d+);", body,
                  re.S)
    assert {64: int(m.group(1)), 32: int(m.group(2))} == conv3x3.PLAIN_FMA_BLOCKS
    m = re.search(r"struct PlainRing \{\s*static constexpr int kMinBlocks = COT == 128 \? "
                  r"(\d+) : (\d+);", body)
    assert (int(m.group(1)), int(m.group(2))) == (conv3x3.conv_plain_min_blocks(128),
                                                  conv3x3.conv_plain_min_blocks(64))
    assert int(re.search(r"kSmemMax = (\d+);", _source("conv3x3_tma.cuh")).group(1)) == \
        conv3x3.RING_CONV_SMEM_MAX
    assert "constexpr int kPfThreads = 128;" in body
    assert conv3x3.plain_fma_resources(64)[0] == 128
    # the ring's constants the plain smem formula mirrors
    ring_body = _source("conv3x3_ring_body.cuh")
    assert int(re.search(r"kPlainStages = (\d+);", ring_body).group(1)) == conv3x3.PLAIN_STAGES
    smem = ring_body[ring_body.index("conv_plain_smem(bool resident"):]
    assert ("kPlainStages * (Tile::kWinB + (resident ? 0 : Tile::kWchB)) + 8 * (kPlainStages + 3)"
            in smem)
    assert "S = PLAIN ? kPlainStages : kRingConvStages" in ring_body
    # both entries launch through the same runs, under their own names
    for src, name in (("conv3x3_bn.cu", "conv3x3_v3_plain"), ("conv3x3_g2.cu", "conv3x3_g2_plain")):
        text = _source(src)
        assert f"CLTORCH_PLAIN_KERNELS({name})" in text
        assert f"CLTORCH_PLAIN_RING_RUN({name}, COT, CK)" in text
        assert f"CLTORCH_PLAIN_FMA_RUN({name}, COT)" in text
    # the first bodies no longer instance the plain conv
    for src in ("conv3x3_bn.cu", "conv3x3_g2.cu"):
        assert not re.search(r"conv3x3_(v3|g2)_(mma_)?kernel\b", _source(src))


class _FakeLibrary:
    """Records the arguments of the C entry points instead of launching;
    returns ``err``."""

    def __init__(self, err=0):
        self.calls, self.err = [], err

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return self.err
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


WRAPPERS = [(conv3x3.launch_conv3x3, "cltorch_conv3x3_fwd"),
            (conv3x3_g2.launch_conv3x3_g2, "cltorch_conv3x3_g2_fwd")]


@pytest.mark.parametrize("wrapper,entry", WRAPPERS, ids=["v3", "g2"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("conv", [(2, 20, 20, 24, 40), (2, 16, 32, 64, 128), (1, 6, 16, 16, 32),
                                  (2, 16, 16, 3, 32), (1, 16, 16, 1024, 512)])
def test_wrappers_pass_the_schedule(fake_card, wrapper, entry, dtype, conv):
    lib, allocated = fake_card
    B, H, W, cin, cout = conv
    g = torch.Generator().manual_seed(cin + cout)
    x = torch.randn(B, H, W, cin, generator=g).to(dtype)
    w = torch.randn(cout, cin, 3, 3, generator=g)
    y = wrapper(x, w)
    assert [name for name, _ in lib.calls] == [entry]  # one launch, no reduce
    args = lib.calls[0][1]
    assert len(args) == len(build.SIGNATURES[entry])
    ints = [a for a, kind in zip(args, build.SIGNATURES[entry]) if kind is build.I]
    bf16 = dtype == torch.bfloat16
    assert ints == [B, H, W, cin, cout, int(bf16),
                    *conv3x3.plain_schedule(cin, cout, B, H, W, bf16)]
    assert y.shape == (B, H, W, cout) and y.dtype == dtype
    assert allocated == [(B, H, W, cout)]  # y alone: no partials
    # the weight as the body reads it: bf16 [3, 3, Cout, Cin], f32 [Cin, 3, 3, Cout]
    assert args[1] != x.data_ptr()


@pytest.mark.parametrize("wrapper,entry", WRAPPERS, ids=["v3", "g2"])
def test_wrappers_raise_on_a_failed_launch(monkeypatch, wrapper, entry):
    lib = _FakeLibrary(err=1)
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    x = torch.zeros(1, 16, 16, 8, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError):
        wrapper(x, torch.zeros(8, 8, 3, 3))
    assert [name for name, _ in lib.calls] == [entry]


def test_info_entry_signature():
    assert build.SIGNATURES["cltorch_conv3x3_plain_info"] == [build.I] * 5 + [build.P]
    src = _source("conv3x3_bn.cu")
    decl = src[src.index("int cltorch_conv3x3_plain_info("):]
    params = decl[decl.index("(") + 1:decl.index(")")]
    assert len(params.split(",")) == len(build.SIGNATURES["cltorch_conv3x3_plain_info"])
    for src, entry in (("conv3x3_bn.cu", "cltorch_conv3x3_fwd"),
                       ("conv3x3_g2.cu", "cltorch_conv3x3_g2_fwd")):
        text = _source(src)
        decl = text[text.index(f"int {entry}("):]
        params = decl[decl.index("(") + 1:decl.index(")")]
        assert len(params.split(",")) == len(build.SIGNATURES[entry])
