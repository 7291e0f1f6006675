"""The int8 conv backward's schedules and launches (#38, #39), on the CPU.

``kernels/conv3x3.py::launch_conv_dx_q`` (#38) launches, in bf16, the ring
body's kDxQ / kDxQX MODEs (``csrc/conv3x3_dx_q.cu``) with the schedule
``dx_q_schedule`` gives: the dx's pickers (``conv_ring_tile``,
``conv_ring_xbuf``, ``conv_ring_blocks``) at the int8 sizes (the int8 y
window and its rows' scales, the xq mode's int8 x tile), which follow the
scales' column grouping ``pack``. ``launch_conv_dw_q`` (#39) launches #36's
ring body (bf16) or the register-blocked FMA body (f32) as kDwQ
(``csrc/conv3x3_dw_q.cu``) with ``dw_q_tile_splits``' tile and splits. A
kernel cannot run here, so these tests hold what surrounds it at every
shape of ``chip_smoke.Q_PATH`` and ``Q_ODD`` and at the int8 convs of
phases 5q-b/c (128², base 32) and 5q-d (256², base 64, P = 2): the pickers
are pure, fit shared memory at the instance's blocks an SM and give one
wave, the walk takes every (pixel tile, channel tile) once, the instances
and constants of the CUDA sources agree with the pickers, and both wrappers
hand their entry point the schedule and ``pack``.
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


def _level_convs(H, c, cin0=3):
    """An int8 level's convs as ``Q_PATH`` lists them: (H, Cin, Cout,
    prologue, xq)."""
    return [(H, cin0, c, False, False), (H, c, c, True, True), (H, c, c, True, False),
            (H, c, c, False, False)]


# (shape, batch, pack) of every int8 launch the tests hold
CASES = ([(s, 8, chip_smoke.Q_P) for s, _ in chip_smoke.Q_PATH["conv3x3_bn_dw_q"]]
         + [(s, 3, chip_smoke.Q_P) for s in chip_smoke.Q_ODD]
         # 5q-b/c: baseline_1 at 128², base 32, level 0 int8 (pack 4)
         + [(s, 8, 4) for s in _level_convs(128, 32)]
         # 5q-d: baseline_2 at 256², base 64, pack 2, levels 0-2
         + [(s, 8, 2) for s in _level_convs(256, 64) + _level_convs(128, 128, 64)
            + _level_convs(64, 256, 128)]
         + [(s, 3, chip_smoke.Q_P_D) for s in chip_smoke.Q_D_SHAPES])
IDS = [f"{H}x{ci}-{co}{'p' if pro else ''}{'q' if xq else ''}b{B}p{p}"
       for (H, ci, co, pro, xq), B, p in CASES]
# #38's: the stem's dx is never launched
DX_CASES = [c for c in CASES if c[0][1] != 3]
DX_IDS = [i for c, i in zip(CASES, IDS) if c[0][1] != 3]


def _tiles(B, H, W, th):
    return B * -(-H // th) * -(-W // conv3x3.TILE)


def test_the_cases_hold_the_paths():
    shapes = {s for s, _, _ in CASES}
    assert {s for s, _ in chip_smoke.Q_PATH["conv3x3_bn_dx_q"]} <= shapes
    assert set(chip_smoke.Q_ODD) <= shapes
    assert (256, 64, 64, True, True) in shapes and (128, 32, 32, True, True) in shapes
    assert {p for _, _, p in CASES} == {2, 4}


@pytest.mark.parametrize("case", DX_CASES, ids=DX_IDS)
def test_dx_q_schedule_pure_fits_and_one_wave(case):
    (H, cin, cout, prologue, xq), B, pack = case
    for stats in (True, False):
        # the dx kernel reads the forward's Cout channels and writes its Cin
        sched = conv3x3.dx_q_schedule(cout, cin, B, H, H, stats, prologue, xq, pack)
        assert sched == conv3x3.dx_q_schedule(cout, cin, B, H, H, stats, prologue, xq, pack)
        cot, ck, resident, xbuf, blocks = sched
        assert cot in (32, 64) and ck in (16, 32) and resident in (0, 1) and xbuf in (0, 1)
        assert ck == 16 or (cout % 16 == 0 and cout > 16)  # 32 only on the int8 TMA rows
        assert resident or cout % 16 == 0  # plain loads keep the weights resident
        q = conv3x3.dx_q_mode(xq, prologue)
        assert q == (conv3x3.Q_X if xq and prologue else conv3x3.Q_Y)
        # the x tile only with the prologue's epilogue, and int8 rows of 16 bytes
        assert not xbuf or (prologue and cin % (16 if q == conv3x3.Q_X else 8) == 0)
        _, smem, per_sm = conv3x3.conv_ring_resources(cot, ck, True, stats, bool(resident),
                                                      cout, bool(xbuf), q, pack)
        assert smem <= conv3x3.RING_CONV_SMEM_MAX and per_sm >= 1
        ctiles = -(-cin // cot)
        assert 1 <= blocks <= _tiles(B, H, H, conv3x3.TILE)
        assert ctiles * blocks <= max(SM_COUNT * per_sm, ctiles)  # one wave
        # the int8 y window is no larger than the bf16 one it replaces at pack 4
        if stats and pack <= 4 and cout % 16 == 0:
            bf = conv3x3.conv_ring_smem(cot, ck, True, True, bool(resident), cout)
            q8 = conv3x3.conv_ring_smem(cot, ck, True, True, bool(resident), cout, q=conv3x3.Q_Y,
                                        pack=pack)
            assert q8 <= bf


@pytest.mark.parametrize("stats", [True, False], ids=["stats", "nostats"])
@pytest.mark.parametrize("case", DX_CASES, ids=DX_IDS)
def test_dx_q_walk_covers_each_pair_once(case, stats):
    (H, cin, cout, prologue, xq), B, pack = case
    cot, _, _, _, blocks = conv3x3.dx_q_schedule(cout, cin, B, H, H, stats, prologue, xq, pack)
    n_tiles = _tiles(B, H, H, conv3x3.TILE)
    # block (bx, by) walks the pixel tiles bx, bx + blocks, ... of channel tile by
    walks = [[(by, t) for t in range(bx, n_tiles, blocks)]
             for bx in range(blocks) for by in range(-(-cin // cot))]
    assert Counter(p for w in walks for p in w) == Counter(
        {(by, t): 1 for by in range(-(-cin // cot)) for t in range(n_tiles)})
    counts = [len(w) for w in walks]
    assert max(counts) - min(counts) <= 1 and min(counts) >= 1


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_dw_q_tile_splits_pure_fit_and_one_wave(case, bf16):
    (H, cin, cout, prologue, xq), B, pack = case
    got = conv3x3.dw_q_tile_splits(cin, cout, B, H, H, bf16, xq, pack)
    assert got == conv3x3.dw_q_tile_splits(cin, cout, B, H, H, bf16, xq, pack)
    ci_t, co_t, splits = got
    if bf16:
        assert (ci_t, co_t) in RING_TILES
        # the TMA tiles take the int8 rows only at 16-byte multiples
        assert ci_t == 16 or (cout % 16 == 0 and (not xq or cin % 16 == 0))
        assert ci_t <= conv3x3.dw_ring_tile(cin, cout)[0]
        _, smem, per_sm = conv3x3.dw_ring_resources(ci_t, co_t, True, xq, pack)
        th = conv3x3.RING_TH
    else:
        assert (ci_t, co_t) in REG_TILES and co_t <= conv3x3.dw_fma_tile(cin, cout)[1]
        _, smem, per_sm, th = conv3x3.dw_fma_resources(ci_t, co_t, True, xq, pack)
    assert smem <= conv3x3.RING_CONV_SMEM_MAX and per_sm >= 1
    ctiles = -(-cin // ci_t) * -(-cout // co_t)
    n_tiles = _tiles(B, H, H, th)
    assert 1 <= splits <= n_tiles
    assert ctiles * splits <= max(SM_COUNT * per_sm, ctiles)  # one wave
    # block z walks the pixel tiles z, z + splits, ...: each once, evenly
    walks = [list(range(z, n_tiles, splits)) for z in range(splits)]
    assert Counter(t for w in walks for t in w) == Counter(range(n_tiles))
    assert max(map(len, walks)) - min(map(len, walks)) <= 1


def test_dw_q_picker_narrows_where_the_int8_rows_or_the_shared_memory_say():
    # int8 widths that are not a multiple of 16: the 16-wide plain-load tile
    # (a bf16 x of 24 channels keeps its TMA tile)
    assert conv3x3.dw_q_tile_splits(24, 64, 8, 64, 64, True, False, 4)[0] == 32
    assert conv3x3.dw_q_tile_splits(24, 64, 8, 64, 64, True, True, 4)[0] == 16
    assert conv3x3.dw_q_tile_splits(64, 40, 8, 64, 64, True, False, 4)[0] == 16
    assert conv3x3.dw_q_tile_splits(72, 64, 8, 64, 64, True, True, 4)[0] == 16
    # the xq mode's raw slots at a wide pack leave no room for the 64-wide tile
    assert conv3x3.dw_q_tile_splits(64, 64, 8, 64, 64, True, True, 4)[:2] == (64, 64)
    assert conv3x3.dw_q_tile_splits(64, 64, 8, 64, 64, True, True, 8)[0] < 64
    # f32: CO_T 64 at pack 4, 32 where 64 no longer fits
    assert conv3x3.dw_q_tile_splits(64, 64, 8, 64, 64, False, True, 4)[1] == 64
    assert conv3x3.dw_q_tile_splits(64, 64, 8, 64, 64, False, True, 8)[1] == 32
    with pytest.raises(ValueError, match="no tile fits"):
        conv3x3.dw_q_tile_splits(64, 64, 8, 256, 256, False, True, 256)


def _source(name):
    with open(os.path.join(build.CSRC, name)) as f:
        return f.read()


def _pairs(text, pattern):
    return {(int(a), int(b)) for a, b in re.findall(pattern, text)}


RING_TILES = _pairs(_source("conv3x3_dw_body.cuh"), r"ci_t == (\d+) && co_t == (\d+)\) return "
                    r"CALL\(\d+, \d+\)")
REG_TILES = {(32, int(c)) for c in re.findall(r"ci_t == 32 && co_t == (\d+)\) return CALL\(\d+\);",
                                              _source("conv3x3_dw_body.cuh"))}


def test_instances_and_constants_agree_with_the_sources():
    dx = _source("conv3x3_dx_q.cu")
    instanced = _pairs(dx, r"CLTORCH_DX_Q_CASE\(CALL, (\d+), (\d+)\)")
    picked = {conv3x3.dx_q_schedule(kin, kout, 8, 64, 64, stats, pro, xq, pack)[:2]
              for kin in (3, 16, 24, 32, 48, 64, 128, 256, 512) for kout in (3, 16, 32, 64, 128)
              for stats in (True, False) for pro in (True, False) for xq in (True, False)
              for pack in (1, 2, 4)}
    assert picked == instanced
    # both dx MODEs, each with and without the prologue's epilogue
    assert "CALL(cltorch::kDxQ, COT, CK, false)" in dx
    assert "CALL(cltorch::kDxQX, COT, CK, true)" in dx and "CALL(cltorch::kDxQ, COT, CK, true)" in dx
    assert "(Cin & 15) == 0" in dx  # the windows by TMA where int8 rows are 16-byte multiples
    body = _source("conv3x3_ring_body.cuh")
    assert "MODE == kDxQ || MODE == kDxQX" in body
    # the int8 dx's products: wgmma at 64 output channels, mma.sync at 32
    assert "constexpr bool WG = PLAIN || (Q && COT == 64);" in body
    assert "kY8B = (kRingConvWin * CK + 127) / 128 * 128" in body
    assert "kX8B = kTH * kTW * COT" in body
    assert "(ConvRingTile<COT, CK>::kY8B + kWinH * pack * CK * 4 + 1023) / 1024 * 1024" in body
    assert "q == kQx ? Tile::kX8B + kTH * pack * COT * 4 : Tile::kXB" in body
    assert int(re.search(r"kQNone = (\d+), kQy = (\d+), kQx = (\d+)", body).group(3)) == \
        conv3x3.Q_X
    # #39: every tile the pickers give is instanced; the launch bounds the
    # smem formulas mirror
    dw = _source("conv3x3_dw_q.cu")
    assert "CLTORCH_RING_DISPATCH(CLTORCH_Q_RING_LAUNCH)" in dw
    assert "CLTORCH_REG_DISPATCH(CLTORCH_Q_REG_LAUNCH)" in dw
    assert int(re.search(r"kSmemMax = (\d+);", _source("conv3x3_tma.cuh")).group(1)) == \
        conv3x3.RING_CONV_SMEM_MAX
    assert "SmemMax = " not in dw + body
    # #38's info entry computes the launch's bytes as the launcher does
    dx = _source("conv3x3_dx_q.cu")
    info = dx[dx.index("int cltorch_conv3x3_dx_q_info("):]
    assert "conv_ring_smem<COT, CK>(true, stats != 0, resident != 0, EPI && xbuf != 0," in info
    dw_body = _source("conv3x3_dw_body.cuh")
    assert "static_assert(KIND != kDwQ" not in dw_body
    assert "kRingPix * CO_T +\n                            kRingTH * pack * CO_T * 4 + 1023) / " \
           "1024 * 1024" in dw_body
    assert "dw_ring_x8_bytes<CI_T>() + kRingWinH * pack * CI_T * 4" in dw_body
    assert "ysc(round(Tile::kPix * CO_T))" in dw_body
    assert "x8(ysc + round(Tile::kTH * pack * CO_T * 4))" in dw_body
    assert "bytes(xsc + (xq ? round((Tile::kTH + 2) * pack * kRegCiT * 4) : 0))" in dw_body
    picked_dw = {conv3x3.dw_q_tile_splits(ci, co, 8, 64, 64, bf, xq, p)[:2]
                 for ci in (3, 16, 24, 32, 64, 128, 256) for co in (3, 16, 32, 40, 64, 128)
                 for bf in (True,) for xq in (True, False) for p in (2, 4, 8)}
    assert picked_dw <= RING_TILES
    # the first bodies that served #38 and #39 are gone
    assert "conv3x3_mma_body" not in _source("conv3x3_body.cuh").split("#pragma once")[1]
    assert "dw_mma_body(" not in dw_body and "conv3x3_q_dw_fma_kernel" not in \
        _source("conv3x3_bn_bwd.cu")
    assert "conv3x3_q_dx_mma_kernel" not in _source("conv3x3_bn.cu")


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


def _q_operands(H, cin, cout, prologue, xq, B, pack, dtype):
    g = torch.Generator().manual_seed(H + cin + cout)
    x = torch.randn(B, H, H, cin, generator=g).to(dtype)
    w = torch.randn(cout, cin, 3, 3, generator=g)
    a, b = torch.rand(cin, generator=g) + 0.5, torch.randn(cin, generator=g)
    q, scale = conv3x3.quant_rows_plain(torch.randn(B, H, H, cout, generator=g).to(dtype), pack)
    dy = torch.randn(B, H, H, cout, generator=g).to(dtype)
    ds1, ds2 = torch.randn(cout, generator=g), torch.randn(cout, generator=g)
    x_res = conv3x3.quant_rows_plain(x, pack) if xq else x
    return x_res, w, a, b, q, scale, dy, ds1, ds2, prologue, pack


WRAPPED = [((16, 32, 32, True, True), 2, 4), ((16, 32, 32, True, False), 2, 2),
           ((16, 64, 64, False, False), 1, 4), ((24, 16, 3, True, True), 2, 4),
           ((12, 24, 40, True, False), 2, 4), ((16, 32, 64, True, True), 2, 2)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", WRAPPED, ids=[str(c) for c in WRAPPED])
def test_dx_q_wrapper_passes_the_schedule_and_pack(fake_card, case, dtype):
    lib, allocated = fake_card
    (H, cin, cout, prologue, xq), B, pack = case
    ops = _q_operands(H, cin, cout, prologue, xq, B, pack, dtype)
    conv3x3.launch_conv_dx_q(*ops)
    assert list(lib.calls) == ["cltorch_conv3x3_bn_dx_q"]
    args = lib.calls["cltorch_conv3x3_bn_dx_q"]
    assert len(args) == len(build.SIGNATURES["cltorch_conv3x3_bn_dx_q"])
    ints = [a for a, k in zip(args, build.SIGNATURES["cltorch_conv3x3_bn_dx_q"]) if k is build.I]
    bf16 = dtype == torch.bfloat16
    sched = conv3x3.dx_q_schedule(cout, cin, B, H, H, True, prologue, xq, pack) if bf16 else \
        (0, 0, 0, 0, 0)
    # the kernel reads Cout channels and writes Cin
    assert ints == [B, H, H, cout, cin, int(prologue), pack, int(bf16), *sched]
    assert (args[7] is not None) == xq and (args[6] is not None) == (not xq)
    rows = B * (-(-H // conv3x3.TILE)) ** 2 if prologue else 1
    assert (rows, 2, cin) in allocated and (B, H, H, cin) in allocated


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", WRAPPED, ids=[str(c) for c in WRAPPED])
def test_dw_q_wrapper_passes_the_tile_splits_and_pack(fake_card, case, dtype):
    lib, allocated = fake_card
    (H, cin, cout, prologue, xq), B, pack = case
    conv3x3.launch_conv_dw_q(*_q_operands(H, cin, cout, prologue, xq, B, pack, dtype))
    assert list(lib.calls) == ["cltorch_conv3x3_bn_dw_q"]
    args = lib.calls["cltorch_conv3x3_bn_dw_q"]
    assert len(args) == len(build.SIGNATURES["cltorch_conv3x3_bn_dw_q"])
    ints = [a for a, k in zip(args, build.SIGNATURES["cltorch_conv3x3_bn_dw_q"]) if k is build.I]
    bf16 = dtype == torch.bfloat16
    ci_t, co_t, splits = conv3x3.dw_q_tile_splits(cin, cout, B, H, H, bf16, xq, pack)
    assert ints == [B, H, H, cin, cout, int(prologue), pack, splits, ci_t, co_t, int(bf16), 0]
    assert (args[1] is not None) == xq and (args[0] is not None) == (not xq)
    assert (splits, cout, cin, 3, 3) in allocated and (cout, cin, 3, 3) in allocated


@pytest.mark.parametrize("case", WRAPPED, ids=[str(c) for c in WRAPPED])
def test_wrappers_without_the_stats_cotangents(fake_card, case):
    # e = dy (an eval-mode backward): null s1 / s2 and the dx's schedule
    # without the y window
    lib, _ = fake_card
    (H, cin, cout, prologue, xq), B, pack = case
    ops = list(_q_operands(H, cin, cout, prologue, xq, B, pack, torch.bfloat16))
    ops[7] = ops[8] = None
    conv3x3.launch_conv_dx_q(*ops)
    conv3x3.launch_conv_dw_q(*ops)
    dx, dw = lib.calls["cltorch_conv3x3_bn_dx_q"], lib.calls["cltorch_conv3x3_bn_dw_q"]
    assert dx[3] is None and dx[4] is None and dw[8] is None and dw[9] is None
    ints = [a for a, k in zip(dx, build.SIGNATURES["cltorch_conv3x3_bn_dx_q"]) if k is build.I]
    assert ints[-5:] == list(conv3x3.dx_q_schedule(cout, cin, B, H, H, False, prologue, xq,
                                                   pack))


def test_phase_3_reaches_every_instance_without_the_stats_cotangents():
    # chip_smoke.q_nostats_cases: each bf16 dx schedule and each dW tile the
    # headline step's int8 convs pick without the stats cotangents (prologue
    # and xq mode apart), and every 5q-c conv in both dtypes
    cases = chip_smoke.q_nostats_cases()
    assert len(cases) == len(set(cases))
    got_dx = {(s[3], s[4], conv3x3.dx_q_schedule(s[2], s[1], b, s[0], s[0], False, s[3], s[4],
                                                 chip_smoke.Q_P)[:4])
              for k, s, d, b in cases if k == "conv3x3_bn_dx_q" and d == "bfloat16"}
    got_dw = {(d, s[3], s[4], conv3x3.dw_q_tile_splits(s[1], s[2], b, s[0], s[0],
                                                       d == "bfloat16", s[4], chip_smoke.Q_P)[:2])
              for k, s, d, b in cases if k == "conv3x3_bn_dw_q"}
    for (H, cin, cout, prologue, xq), _ in chip_smoke.Q_PATH["conv3x3_bn_dw_q"]:
        if cin != 3:
            assert (prologue, xq, conv3x3.dx_q_schedule(cout, cin, 8, H, H, False, prologue, xq,
                                                        chip_smoke.Q_P)[:4]) in got_dx
        for d in ("bfloat16", "float32"):
            assert (d, prologue, xq, conv3x3.dw_q_tile_splits(cin, cout, 8, H, H, d == "bfloat16",
                                                              xq, chip_smoke.Q_P)[:2]) in got_dw
    assert set(chip_smoke.Q_C_SHAPES) == set(_level_convs(128, 32))
    for shape in chip_smoke.Q_C_SHAPES:
        for d in ("float32", "bfloat16"):
            assert ("conv3x3_bn_dw_q", shape, d, 8) in cases
            assert (("conv3x3_bn_dx_q", shape, d, 8) in cases) == (shape[1] != 3)


def test_info_entries_match_their_signatures():
    for src, entry in (("conv3x3_dx_q.cu", "cltorch_conv3x3_dx_q_info"),
                       ("conv3x3_dx_q.cu", "cltorch_conv3x3_bn_dx_q"),
                       ("conv3x3_dw_q.cu", "cltorch_conv3x3_dw_q_info"),
                       ("conv3x3_dw_q.cu", "cltorch_conv3x3_bn_dw_q")):
        text = _source(src)
        decl = text[text.index(f"int {entry}("):]
        params = decl[decl.index("(") + 1:decl.index(")")]
        assert len(params.split(",")) == len(build.SIGNATURES[entry]), entry
