"""3×3 SAME conv with a BN·ReLU prologue and a batch-stats epilogue, and its
backward (``csrc/conv3x3_bn.cu``, ``csrc/conv3x3_bn_bwd.cu``); and the
plain gen-3 conv of ``model.conv_impl=v3|auto`` with its backward.

Counterpart of ``cl_tpu.pallas.conv3x3_v3.conv_bn_fused``: every conv of
the packed body. With ``prologue`` on, the input is first mapped to
t = relu(x·a + b) (the producer's deferred BatchNorm, per input channel,
in f32, rounded to x's dtype); else t = x. Then y = conv3x3_SAME(t, w)
summed in f32 and rounded to x's dtype, and the per-channel Σy and Σy² of
the ROUNDED y. The SAME padding is zero in t-space, never relu(b). The
TPU kernel returns per-lane sums of its packed view; these are per channel.

The backward follows ``_cbf_bwd``'s fused branch (``conv3x3_v3.py:951-961``):
e = dy + dΣy + 2·y·dΣy² in f32, rounded to the dtype (e = dy when both
stats cotangents are None: autograd's cotangent of an unused sum), zero
outside the image; dt = conv(e, w flipped and transposed) in f32, NOT
rounded before the prologue's backward: u = x·a + b, dx = [u>0]·dt·a
rounded, da = Σ[u>0]·dt·x, db = Σ[u>0]·dt (without the prologue dx is dt
rounded); dW = Σ tᵀ★e with t recomputed, summed in f32 and rounded once to
the dtype (``dw.astype(w.dtype)``, w being of the compute dtype there).
dx is computed only where autograd needs it (not for the stem's image).
The branch is ``cl_tpu``'s (``packed_gate.conv_bwd_branch``, at the
conv's pack factor ``p``, read when the forward runs). Under
``CL_TPU_FUSE_BWD=1`` a conv whose one-pass tile fits takes the one-pass
backward (#37, ``_bwd_fused_kernel``, ``:938-950``): the same arithmetic
as the fused branch (e formed once, the f32 dt into the prologue's
backward, t recomputed, dW rounded once) from one launch that returns dx,
da, db (zeros without the prologue) and dW. Under ``CL_TPU_DX_PIPE=1``
the fused branch's dx is 34p/35p (launch keys of their own), the same
arithmetic in the same order, bit-equal to #34/#35: on the card their
kernels (the bf16 ring is the pipelined design). Where ``cl_tpu``'s
fused backward kernels find no tile the backward is its two-pass branch
(``:962-985``): e materialized (f32, rounded to the dtype), dt = the
plain conv (#30) of e, ROUNDED to the dtype, dW = #33 (the prologue
recomputed over the materialized e), and the prologue's backward in
torch on the rounded dt.

``conv3x3`` is ``cl_tpu.pallas.conv3x3_v3.conv3x3`` (and
``conv3x3_packed``, the same arithmetic): y = conv3x3_SAME(x, w) summed in
f32 and rounded to x's dtype, no prologue, no statistics (#30). Its VJP
(``:629-648``): dy cast to x's dtype, dx = #30 on dy with the flipped,
transposed weight, dW = Σ xᵀ★dy in f32 (#31, ``csrc/conv3x3_v3_dw.cu``:
#41's bodies) rounded once to the compute dtype.

``conv_bn_fused_q`` is ``cl_tpu.pallas.conv3x3_v3.conv_bn_fused_q``
(``:1800-1870``), the packed conv under ``model.conv_act_store=int8``: the
same forward (#32, every bit of y and the sums kept) and a quantize
kernel (32q) that stores y as int8 with one f32 scale per image row,
column mod p and channel (``_quant_rows``, ``:142-151``: the TPU's per
(image-row, lane) scale of its packed view, whose lane j·C + c holds the
columns w ≡ j mod p): m = max |y| over those W/p columns of the stored
y, q = clip(rint(y·(127/m)), ±127) (0 where m = 0), scale = m·float32(1/127).
The backward saves (q, scale) in place of y and, where the producer conv
threads its own pair in (``xq``), that pair in place of x. Its fused
branch (``_cbfq_bwd``, ``:1826-1863``) runs #38 (dx) and #39 (dW) with
these rounding points: e = round(dy + ds1 + 2·deq(y)·ds2) with deq(y) =
q·scale in f32, NOT rounded (``:1532-1540``, ``:1713-1715``); the dx
epilogue reads x as deq(xq) in f32, not rounded (``:1577-1579``); the dW's
t = round(relu(deq(xq)·a + b)) computed in f32 and rounded once
(``:1690-1696``); dW summed in f32 and rounded once. Where no tile fits
(``conv_bwd_branch`` without ``FUSE_BWD``, which ``_cbfq_bwd`` never
reads) it dequantizes y and x once, ROUNDED to the compute
dtype, and runs the two-pass backward on them (``:1836-1858``).

Under ``CL_TPU_E_BF16=1`` (``packed_gate.E_BF16``, read at each forward
as ``cl_tpu``'s ``_ew_dtype`` keys it, ``conv3x3_v3.py:670-683``: the flag
on and the chain's operand in bf16) the bf16 kernels run two chains in
bf16: the prologue's t = relu((x·a) + b) and the backward's e = (dy + ds1)
+ ((2·y)·ds2), with a, b, ds1 and ds2 rounded to bf16 first and every
product and sum rounded to bf16 (``prologue_t`` / ``dy_eff`` with
``e_bf16``). Every kernel that forms them takes the variant (#32, #33,
#34/#35, 34p/35p, #36, #37, #39 from x); f32 kernels never change, and
neither do the dx epilogue (f32 a and b), the two-pass branch's
materialized e, #38's e and #39's e from deq(y) or its t from deq(xq), whose
operands are f32. The variant's launches count under the key with
``_ebf16`` appended.

``w`` is the port's conv weight [Cout, Cin, 3, 3] (f32), rounded to x's
dtype as the JAX package rounds its kernel. Tensors are NHWC.

On a CUDA tensor the wrappers launch the kernels, on a CPU tensor they run
the plain versions. ``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from cl_tpu_torch.kernels import SM_COUNT, SPLIT_BLOCKS, build, one_wave_splits, resident_blocks
from cl_tpu_torch.models import packed_gate
from cl_tpu_torch.models.packed_gate import conv_bwd_branch, pick_pack

TILE = 16  # output tile of the kernels (rows and columns)
QMAX = 127.0  # the int8 saved activations' symmetric range

LAUNCHES = {"conv3x3_bn_fwd": 0, "conv3x3_bn_dx": 0, "conv3x3_bn_dx_bn": 0,
            "conv3x3_bn_dw": 0,
            # the gen-3 plain conv (#30) as a forward, as the dx of its VJP,
            # and as the two-pass backward's dt; its dW (#31); the two-pass
            # backward's dW with the prologue (#33)
            "conv3x3_fwd": 0, "conv3x3_dx": 0, "conv3x3_dt": 0, "conv3x3_dw": 0,
            "conv3x3_dw_bn": 0,
            # the int8 saved activations: the quantize after #32 (32q), the
            # dx (#38) and dW (#39) from int8
            "conv3x3_bn_quant": 0, "conv3x3_bn_dx_q": 0, "conv3x3_bn_dw_q": 0,
            # CL_TPU_DX_PIPE: the pipelined dx (34p, 35p); CL_TPU_FUSE_BWD:
            # the one-pass backward (#37)
            "conv3x3_bn_dx_pipe": 0, "conv3x3_bn_dx_bn_pipe": 0, "conv3x3_bn_bwd_fused": 0}
# CL_TPU_E_BF16: each kernel that takes the bf16 chains, launched with them
EBF16 = "_ebf16"
LAUNCHES.update({k + EBF16: 0 for k in (
    "conv3x3_bn_fwd", "conv3x3_bn_dx", "conv3x3_bn_dx_bn", "conv3x3_bn_dw", "conv3x3_dw_bn",
    "conv3x3_bn_dw_q", "conv3x3_bn_dx_pipe", "conv3x3_bn_dx_bn_pipe", "conv3x3_bn_bwd_fused")})


def _count(key, e_bf16):
    """One launch under ``key``, or its variant's key."""
    LAUNCHES[key + (EBF16 if e_bf16 else "")] += 1


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _bf16_chain(e_bf16, t):
    """Whether a chain on ``t`` runs in bf16: ``_ew_dtype``'s key."""
    return e_bf16 and t.dtype == torch.bfloat16


def prologue_t(x, a, b, prologue, e_bf16=False):
    """t: x through the BN·ReLU prologue (rounded to x's dtype), or x. With
    ``e_bf16`` and x in bf16, relu((x·a) + b) in bf16, op by op."""
    if not prologue:
        return x
    if _bf16_chain(e_bf16, x):
        return torch.relu(x * a.to(torch.bfloat16) + b.to(torch.bfloat16))
    return torch.relu(x.float() * a + b).to(x.dtype)


def _nchw(t):
    return t.float().permute(0, 3, 1, 2)


def conv3x3_plain(x, w):
    """#30: y = conv3x3_SAME(x, w) in f32, rounded to x's dtype (NHWC)."""
    y = F.conv2d(_nchw(x), w.to(x.dtype).float(), padding=1)
    return y.to(x.dtype).permute(0, 2, 3, 1).contiguous()


def conv_bn_plain(x, w, a=None, b=None, prologue=False, e_bf16=False):
    y = conv3x3_plain(prologue_t(x, a, b, prologue, e_bf16), w)
    yf = y.float().reshape(-1, y.shape[-1])
    return y, yf.sum(0), (yf * yf).sum(0)


def dy_eff(dy, y, ds1, ds2, e_bf16=False):
    """e = dy + ds1 + 2·y·ds2 in f32, rounded to dy's dtype; dy itself when
    both are None. With ``e_bf16`` and dy in bf16, (dy + ds1) + ((2·y)·ds2)
    in bf16, op by op (a missing one zero, as the kernels read it)."""
    if ds1 is None and ds2 is None:
        return dy
    if _bf16_chain(e_bf16, dy):
        s1, s2 = (torch.zeros(dy.shape[-1], dtype=torch.bfloat16, device=dy.device) if v is None
                  else v.to(torch.bfloat16) for v in (ds1, ds2))
        return (dy + s1) + (2.0 * y.to(torch.bfloat16)) * s2
    e = dy.float()
    if ds1 is not None:
        e = e + ds1
    if ds2 is not None:
        e = e + 2.0 * y.float() * ds2
    return e.to(dy.dtype)


def conv_dx_plain(x, w, a, b, y, dy, ds1, ds2, prologue, e_bf16=False):
    """(dx, da, db) of ``conv_bn_fused``; da, db None without the prologue."""
    e = dy_eff(dy, y, ds1, ds2, e_bf16)
    dt = F.conv_transpose2d(_nchw(e), w.to(x.dtype).float(), padding=1).permute(0, 2, 3, 1)
    if not prologue:
        return dt.to(x.dtype), None, None
    return prologue_bwd(x, a, b, dt)


def prologue_bwd(x, a, b, dt, dtype=None):
    """(dx, da, db) of t = relu(x·a + b) from dt (read in f32): u = x·a + b,
    du = [u > 0]·dt, dx = du·a rounded to ``dtype`` (None: x's), da = Σ du·x,
    db = Σ du."""
    xf = x.float()
    du = torch.where(xf * a + b > 0, dt.float(), 0.0)
    dx = (du * a).to(dtype or x.dtype)
    du, xf = du.reshape(-1, x.shape[-1]), xf.reshape(-1, x.shape[-1])
    return dx, (du * xf).sum(0), du.sum(0)


def conv_dw_plain(x, w, a, b, y, dy, ds1, ds2, prologue, e_bf16=False):
    """dW [Cout, Cin, 3, 3] rounded to x's dtype, as f32."""
    e = dy_eff(dy, y, ds1, ds2, e_bf16)
    return conv3x3_dw_bn_plain(x, a, b, e, prologue, e_bf16).to(x.dtype).float()


def conv_bwd_fused_plain(x, w, a, b, y, dy, ds1, ds2, prologue, e_bf16=False, need_dx=True):
    """#37: (dx or None, da, db, dW) of ``conv_bn_fused`` in one pass: the
    composition of ``conv_dx_plain`` and ``conv_dw_plain`` (the fused
    branch's arithmetic); da, db zeros without the prologue, dW rounded to
    x's dtype, as f32. ``need_dx`` off (the stem) skips dx, da and db."""
    zeros = torch.zeros(x.shape[-1], dtype=torch.float32, device=x.device)
    dx, da, db = conv_dx_plain(x, w, a, b, y, dy, ds1, ds2, prologue, e_bf16) if need_dx else \
        (None, None, None)
    return (dx, zeros if da is None else da, zeros if db is None else db,
            conv_dw_plain(x, w, a, b, y, dy, ds1, ds2, prologue, e_bf16))


def conv3x3_dw_plain(x, dy):
    """#31: dW [Cout, Cin, 3, 3] = Σ over the batch of x ★ dy, f32, not
    rounded (the VJP rounds it)."""
    return conv3x3_dw_bn_plain(x, None, None, dy, False)


def conv3x3_dw_bn_plain(x, a, b, e, prologue, e_bf16=False):
    """#33: dW [Cout, Cin, 3, 3] of t = prologue_t(x) against a materialized
    e, f32, not rounded."""
    t = prologue_t(x, a, b, prologue, e_bf16)
    return torch.nn.grad.conv2d_weight(_nchw(t), (e.shape[-1], x.shape[-1], 3, 3), _nchw(e),
                                       padding=1)


def quant_rows_plain(y, p):
    """32q: (q int8 [B, H, W, C], scale f32 [B, H, p, C]) of the stored y,
    one scale per image row, column mod ``p`` and channel. 127/m is an f32
    division (torch's ``scalar / tensor`` would multiply by a rounded
    reciprocal) and rint rounds half to even, as ``_quant_rows``."""
    B, H, W, C = y.shape
    yf = y.float().reshape(B, H, W // p, p, C)
    m = yf.abs().amax(dim=2)
    inv = torch.where(m > 0, torch.full_like(m, QMAX) / m, 0.0)
    q = torch.round(yf * inv[:, :, None]).clamp(-QMAX, QMAX).to(torch.int8)
    return q.reshape(B, H, W, C), m * (1.0 / QMAX)  # m·float32(1/127), not m / 127


def deq_rows(q, scale, p):
    """deq(v) = q·scale in f32 [B, H, W, C], not rounded."""
    B, H, W, C = q.shape
    return (q.float().reshape(B, H, W // p, p, C) * scale[:, :, None]).reshape(B, H, W, C)


def _x_f32(x_res, p):
    """The forward's input as the int8 backward reads it: x itself, or
    deq(xq) in f32 (not rounded) where ``x_res`` is the pair (xq, scale)."""
    return deq_rows(*x_res, p) if isinstance(x_res, tuple) else x_res


def conv_dx_q_plain(x_res, w, a, b, q, scale, dy, ds1, ds2, prologue, p):
    """#38: (dx, da, db) of ``conv_bn_fused_q`` from the int8 y (q, scale)
    and ``x_res`` (x, or the pair (xq, scale)); da, db None without the
    prologue. e takes deq(y) in f32 (rounding point 1), the epilogue deq(x)
    in f32 (point 2)."""
    e = dy_eff(dy, deq_rows(q, scale, p), ds1, ds2)
    dt = F.conv_transpose2d(_nchw(e), w.to(dy.dtype).float(), padding=1).permute(0, 2, 3, 1)
    if not prologue:
        return dt.to(dy.dtype), None, None
    return prologue_bwd(_x_f32(x_res, p), a, b, dt, dy.dtype)


def conv_dw_q_plain(x_res, w, a, b, q, scale, dy, ds1, ds2, prologue, p, e_bf16=False):
    """#39: dW [Cout, Cin, 3, 3] of ``conv_bn_fused_q``, rounded to the
    compute dtype, as f32: e from deq(y) in f32 (point 1); t from x (the
    bf16 chain under ``e_bf16``), or t = round(relu(deq(xq)·a + b))
    computed in f32 and rounded once (point 3); the sum in f32, rounded
    once."""
    e = dy_eff(dy, deq_rows(q, scale, p), ds1, ds2)
    t = prologue_t(_x_f32(x_res, p), a, b, prologue, e_bf16).to(dy.dtype)
    return conv3x3_dw_bn_plain(t, None, None, e, False).to(dy.dtype).float()


def _flip_t(w):
    """The dx conv's weight: w flipped in space, Cin and Cout swapped."""
    return w.flip(2, 3).transpose(0, 1)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def _check_nhwc(t, what):
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: f32 or bf16 only, got {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what} needs a contiguous 16-byte-aligned NHWC tensor")


def _vec(v, n, device, what):
    v = v.to(device=device, dtype=torch.float32).contiguous()
    if v.shape != (n,):
        raise ValueError(f"{what}: per-channel vector of shape ({n},), got {tuple(v.shape)}")
    return v


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _kernel_weight(w, dtype):
    """The forward conv's weight as the kernels read it: the tensor-core
    kernel (bf16) [3, 3, Cout, Cin], the FMA one (f32) [Cin, 3, 3, Cout]."""
    order = (2, 3, 0, 1) if dtype == torch.bfloat16 else (1, 2, 3, 0)
    return w.to(dtype).permute(*order).contiguous()


# The bf16 forward's and dx's ring body (csrc/conv3x3_ring_body.cuh): a
# 16 x 16 pixel tile, RING_CONV_STAGES raw stages of the 18 x 18 window.
RING_CONV_STAGES = 2
RING_CONV_WIN = (TILE + 2) ** 2
RING_CONV_SMEM_MAX = 232448  # a block's dynamic shared memory on the H100
# ``q`` of the ring's launch: the dx from bf16 y, from the int8 y (#38's
# kDxQ), from the int8 y and x (kDxQX: the xq mode with the prologue)
Q_NONE, Q_Y, Q_X = 0, 1, 2


def _up(n, m):
    """n rounded up to a multiple of m."""
    return -(-n // m) * m


def conv_ring_smem(cot, ck, dx, stats, resident, cin, xbuf=False, q=Q_NONE, pack=0):
    """Dynamic shared bytes of a ring launch, as ``conv_ring_smem`` in the
    CUDA body computes them: 1024 of alignment; the weights ([9][COT][CK]
    a chunk of CK input channels) of every chunk when resident; the stages,
    each the window's CK channels (x or dy; 1024-byte rounded) and, when
    not resident, its weight chunk; one y window where the dx forms e from
    a TMA copy of y (stats, Cin a multiple of 8, of 16 for int8): bf16, or
    (``q``) the int8 window (128-byte rounded) and its 18 rows' scales
    (``pack`` x CK floats a row), 1024-byte rounded; #35's 16 x 16 x COT x
    tile where it is copied in (``xbuf``): bf16, or (``q == Q_X``) int8
    with its 16 rows' scales; the f32 vectors and sums; five mbarriers."""
    win = -(-RING_CONV_WIN * ck * 2 // 1024) * 1024
    wch = 9 * cot * ck * 2
    nch = -(-cin // ck)
    stage = win + (0 if resident else wch)
    y_b = _up(_up(RING_CONV_WIN * ck, 128) + (TILE + 2) * pack * ck * 4, 1024) if q else win
    y_win = y_b if stats and cin % (16 if q else 8) == 0 else 0
    x_b = TILE * TILE * cot + TILE * pack * cot * 4 if q == Q_X else TILE * TILE * cot * 2
    floats = 2 * nch * ck + (2 * cot if dx else 0) + 32 * cot + (0 if dx else 2 * cot)
    return (1024 + (nch * wch if resident else 0) + RING_CONV_STAGES * stage + y_win
            + (x_b if xbuf else 0) + 4 * floats + 40)


def conv_ring_min_blocks(cot):
    """The instance's ``__launch_bounds__`` blocks an SM: two at 32 output
    channels, one else."""
    return 2 if cot == 32 else 1


@functools.lru_cache(maxsize=None)
def conv_ring_tile(cin, cout, dx, stats, q=Q_NONE, pack=0):
    """(COT, CK, resident): the ring instance for a launch whose kernel
    reads ``cin`` channels and writes ``cout`` (the dx's: the forward's Cout
    and Cin), ``stats`` whether the dx forms e from y (``q``: from the int8
    y, whose scales group the columns mod ``pack``). COT output channels
    a block: 32, 64, or for the forward 128 (the dx keeps 64 at most); CK
    input channels a stage: 32 where the window loads by TMA (Cin a
    multiple of 8; of 16 for the int8 y's rows) and is wider than 16, else
    16. The first (COT, CK), widest
    first, whose resident weights and ring fit the instance's blocks an SM,
    else the first that fits one; where no resident choice fits, the weights
    travel with each stage (TMA widths only). Raises where nothing fits."""
    tma = cin % (16 if q else 8) == 0
    cots = [32] if cout <= 32 else [64, 32] if cout <= 64 or dx else [128, 64, 32]
    cks = [32, 16] if tma and cin > 16 else [16]
    for resident in (True, False) if tma else (True,):
        fits = [(cot, ck) for cot in cots for ck in cks
                if conv_ring_smem(cot, ck, dx, stats, resident, cin, q=q, pack=pack)
                <= RING_CONV_SMEM_MAX]
        for cot, ck in fits:
            smem = conv_ring_smem(cot, ck, dx, stats, resident, cin, q=q, pack=pack)
            if resident_blocks(smem, conv_ring_min_blocks(cot)) == conv_ring_min_blocks(cot):
                return cot, ck, resident
        if fits:
            return (*fits[0], resident)
    raise ValueError(f"conv3x3_bn ring kernel: no tile fits a conv of {cin} -> {cout} "
                     "channels in shared memory")


def conv_ring_resources(cot, ck, dx, stats, resident, cin, xbuf=False, q=Q_NONE, pack=0):
    """(threads, dynamic shared bytes, resident blocks an SM) of a ring
    launch: 256 threads, and the blocks the shared memory and the
    instance's registers (``__launch_bounds__``) allow."""
    smem = conv_ring_smem(cot, ck, dx, stats, resident, cin, xbuf, q, pack)
    return 256, smem, resident_blocks(smem, conv_ring_min_blocks(cot))


@functools.lru_cache(maxsize=None)
def conv_ring_xbuf(cin, cout, dx, stats, prologue, q=Q_NONE, pack=0):
    """Whether the dx with the prologue (#35, #38) copies each tile's x in
    by TMA while the tile multiplies, for its epilogue: where x's rows are
    16-byte multiples (Cout a multiple of 8; of 16 for the int8 x of
    ``q == Q_X``) and the tile fits beside the ring without costing a
    resident block; else the epilogue reads x from global memory."""
    if not (dx and prologue and cout % (16 if q == Q_X else 8) == 0):
        return False
    cot, ck, resident = conv_ring_tile(cin, cout, dx, stats, q, pack)
    base = conv_ring_resources(cot, ck, dx, stats, resident, cin, False, q, pack)
    with_x = conv_ring_resources(cot, ck, dx, stats, resident, cin, True, q, pack)
    return with_x[1] <= RING_CONV_SMEM_MAX and with_x[2] == base[2]


@functools.lru_cache(maxsize=None)
def conv_ring_blocks(cin, cout, B, H, W, dx, stats, prologue=False, q=Q_NONE, pack=0):
    """Blocks a ring launch walks the 16 x 16 pixel tiles of its B images
    with, for each tile of COT output channels: one wave of resident blocks
    (``conv_ring_resources``), each the same number of tiles. A function of
    the shapes alone, so the forward's partial sums (one row a block) run
    in the same order on every call."""
    cot, ck, resident = conv_ring_tile(cin, cout, dx, stats, q, pack)
    xbuf = conv_ring_xbuf(cin, cout, dx, stats, prologue, q, pack)
    n_tiles = B * -(-H // TILE) * -(-W // TILE)
    blocks = conv_ring_resources(cot, ck, dx, stats, resident, cin, xbuf, q, pack)[2]
    return one_wave_splits(n_tiles, -(-cout // cot), blocks)


def dx_q_mode(xq, prologue):
    """``q`` of #38's ring instance: Q_X in the xq mode with the prologue
    (its epilogue reads deq(xq)), else Q_Y (without the prologue x is
    unread, and the xq mode takes kDxQ's instance)."""
    return Q_X if xq and prologue else Q_Y


def dx_q_schedule(cin, cout, B, H, W, stats, prologue, xq, pack):
    """(cot, ck, resident, xbuf, blocks): #38's bf16 ring schedule for a dx
    kernel reading ``cin`` channels (the forward's Cout) and writing
    ``cout``, the int8 y's scales grouping the columns mod ``pack``: the
    dx's pickers at the int8 sizes."""
    q = dx_q_mode(xq, prologue)
    cot, ck, resident = conv_ring_tile(cin, cout, True, stats, q, pack)
    return (cot, ck, int(resident),
            int(conv_ring_xbuf(cin, cout, True, stats, prologue, q, pack)),
            conv_ring_blocks(cin, cout, B, H, W, True, stats, prologue, q, pack))


# The plain conv's bodies (#30, #40: csrc/conv3x3_plain_body.cuh). bf16: the
# ring body's kPlain MODE, the forward's 16 x 16 tiles in a ring of
# PLAIN_STAGES stages, with no vectors and no sums in its shared memory.
PLAIN_STAGES = 3


def conv_plain_smem(cot, ck, resident, cin):
    """Dynamic shared bytes of a plain ring launch, as ``conv_plain_smem``
    in the CUDA body computes them: 1024 of alignment, the resident weights
    (every chunk's [9][COT][CK]) or none, PLAIN_STAGES stages (each the
    window's CK channels, 1024-byte rounded, and without resident weights
    its weight chunk), their mbarriers and three more."""
    win = -(-RING_CONV_WIN * ck * 2 // 1024) * 1024
    wch = 9 * cot * ck * 2
    nch = -(-cin // ck)
    return (1024 + (nch * wch if resident else 0)
            + PLAIN_STAGES * (win + (0 if resident else wch)) + 8 * (PLAIN_STAGES + 3))


def conv_plain_min_blocks(cot):
    """The plain ring instance's ``__launch_bounds__`` blocks an SM
    (``PlainRing``): two up to 64 output channels, one at 128."""
    return 1 if cot == 128 else 2


def conv_plain_resources(cot, ck, resident, cin):
    """(threads, dynamic shared bytes, resident blocks an SM) of a plain
    ring launch."""
    smem = conv_plain_smem(cot, ck, resident, cin)
    return 256, smem, resident_blocks(smem, conv_plain_min_blocks(cot))


@functools.lru_cache(maxsize=None)
def conv_plain_tile(cin, cout, n_tiles):
    """(COT, CK, resident): the bf16 plain ring instance for a conv of
    ``cin`` -> ``cout`` channels (the dx's: the forward's Cout -> Cin) over
    ``n_tiles`` 16 x 16 pixel tiles. COT output channels a block, the
    wgmma's N: 32, 64 or 128, the widest first up to Cout, but none whose
    channel tiles times the pixel tiles would give fewer blocks than half
    the SMs (the deep levels' few tiles), unless it is the narrowest; CK
    input channels a stage: 32 where the window loads by TMA (Cin a
    multiple of 8) and is wider than 16, else 16. Of the (COT, resident,
    CK) that fit shared memory, in that order (widest, resident weights,
    wider stages first), the first that holds the instance's blocks an SM,
    or the first at all where the blocks cannot fill the SMs at one an SM;
    else the first that fits. Resident weights where they fit, else the
    weights travel with each stage (TMA widths only): the card ran two
    blocks an SM with travelling weights faster than one with resident
    ones (PERF.md §6). Raises where nothing fits."""
    tma = cin % 8 == 0
    cots = [32] if cout <= 32 else [64, 32] if cout <= 64 else [128, 64, 32]
    cots = [c for c in cots if 2 * n_tiles * -(-cout // c) >= SM_COUNT] or cots[-1:]
    cks = [32, 16] if tma and cin > 16 else [16]
    fits = [(cot, ck, resident) for cot in cots for resident in ((True, False) if tma else (True,))
            for ck in cks if conv_plain_smem(cot, ck, resident, cin) <= RING_CONV_SMEM_MAX]
    for cot, ck, resident in fits:
        blocks = conv_plain_resources(cot, ck, resident, cin)[2]
        if n_tiles * -(-cout // cot) <= SM_COUNT or blocks == conv_plain_min_blocks(cot):
            return cot, ck, resident
    if fits:
        return fits[0]
    raise ValueError(f"conv3x3 plain ring kernel: no tile fits a conv of {cin} -> {cout} "
                     "channels in shared memory")


@functools.lru_cache(maxsize=None)
def conv_plain_blocks(cin, cout, B, H, W):
    """Blocks a plain ring launch walks the 16 x 16 pixel tiles of its B
    images with, for each tile of COT output channels: one wave of resident
    blocks, each the same number of tiles."""
    n_tiles = B * -(-H // TILE) * -(-W // TILE)
    cot, ck, resident = conv_plain_tile(cin, cout, n_tiles)
    blocks = conv_plain_resources(cot, ck, resident, cin)[2]
    return one_wave_splits(n_tiles, -(-cout // cot), blocks)


# f32: the register-blocked FMA body (``PlainFmaTile``): 128 threads, a 16 x
# 16 pixel tile for COT output channels; a ring of PLAIN_FMA_STAGES stages
# of PLAIN_FMA_CI input channels, each the window's channel planes
# (PLAIN_FMA_PLANE floats: 18 rows of 20) and their weights [CI][9][COT].
PLAIN_FMA_CI = 8
PLAIN_FMA_STAGES = 3
PLAIN_FMA_PLANE = (TILE + 2) * 20 + 4
PLAIN_FMA_BLOCKS = {64: 2, 32: 3}


def plain_fma_resources(cot):
    """(threads, dynamic shared bytes, resident blocks an SM) of an f32
    plain instance: the blocks its ``__launch_bounds__`` fits the registers
    to, fewer if the shared memory says so."""
    smem = PLAIN_FMA_STAGES * (PLAIN_FMA_CI * PLAIN_FMA_PLANE + PLAIN_FMA_CI * 9 * cot) * 4
    return 128, smem, resident_blocks(smem, PLAIN_FMA_BLOCKS[cot])


@functools.lru_cache(maxsize=None)
def plain_fma_tile(cout, B, H, W):
    """COT of the f32 plain instance: 64 (16 x 8 accumulators a thread)
    where Cout is wider than 32 and its blocks fill one wave of the card,
    else 32 (twice the blocks, for the small images of the deep levels)."""
    blocks64 = B * -(-H // TILE) * -(-W // TILE) * -(-cout // 64)
    return 64 if cout > 32 and blocks64 >= SM_COUNT * plain_fma_resources(64)[2] else 32


def plain_schedule(cin, cout, B, H, W, bf16):
    """(cot, ck, resident, blocks): the schedule the plain entry points
    (#30's ``cltorch_conv3x3_fwd``, #40's ``cltorch_conv3x3_g2_fwd``) take;
    f32 reads only cot."""
    if bf16:
        cot, ck, resident = conv_plain_tile(cin, cout, B * -(-H // TILE) * -(-W // TILE))
        return cot, ck, int(resident), conv_plain_blocks(cin, cout, B, H, W)
    return plain_fma_tile(cout, B, H, W), 0, 0, 0


def launch_plain(entry, x, w, what):
    """One launch of a plain conv entry point (``build.library()``'s
    ``entry``): y [B, H, W, Cout] = conv3x3_SAME(x, w) in x's dtype, with
    the schedule of ``plain_schedule``."""
    _check_nhwc(x, what)
    B, H, W, cin = x.shape
    cout = w.shape[0]
    if w.shape != (cout, cin, 3, 3):
        raise ValueError(f"{what}: weight [Cout, {cin}, 3, 3] expected, got {tuple(w.shape)}")
    bf16 = x.dtype == torch.bfloat16
    wk = _kernel_weight(w, x.dtype)
    y = torch.empty(B, H, W, cout, dtype=x.dtype, device=x.device)
    err = getattr(build.library(), entry)(
        x.data_ptr(), wk.data_ptr(), y.data_ptr(), B, H, W, cin, cout, int(bf16),
        *plain_schedule(cin, cout, B, H, W, bf16), _stream(x))
    build.check(err, what)
    return y


def conv_partials_shape(cin, cout, B, H, W, bf16):
    """The f32 partials [rows, 2, Cout] the forward's wrapper allocates: one
    row a block of the ring in bf16, one a 16 x 16 tile of each image in
    f32."""
    rows = conv_ring_blocks(cin, cout, B, H, W, False, False) if bf16 else \
        B * -(-H // TILE) * -(-W // TILE)
    return rows, 2, cout


def dx_partials_shape(cin, B, H, W, prologue):
    """The f32 partials [rows, 2, Cin] of the dx's da and db: one row a 16 x
    16 tile of each image with the prologue (the rows 34p/35p and #37 sum
    in the same order), else one unread row."""
    return (B * -(-H // TILE) * -(-W // TILE) if prologue else 1), 2, cin


def _launch_ring(dx, src, y, s1, s2, wk, a, b, x, out, partials, sums, prologue, e_bf16):
    """The bf16 ring body's launch (``csrc/conv3x3_ring.cu``) of the forward
    (``src`` = x, ``out`` = y) or the dx (``src`` = dy, ``out`` = dx), with
    the schedule its shapes give (``conv_ring_tile``, ``conv_ring_xbuf``,
    ``conv_ring_blocks``), the bf16 chains under ``e_bf16``; returns the
    entry point's error code."""
    B, H, W, cin = src.shape
    cout = out.shape[-1]
    stats = s1 is not None
    cot, ck, resident = conv_ring_tile(cin, cout, dx, stats)
    return build.library().cltorch_conv3x3_bn_ring(
        int(dx), src.data_ptr(), _ptr(y), _ptr(s1), _ptr(s2), wk.data_ptr(), _ptr(a), _ptr(b),
        _ptr(x), out.data_ptr(), partials.data_ptr(), sums.data_ptr(), B, H, W, cin, cout,
        int(prologue), cot, ck, int(resident),
        int(conv_ring_xbuf(cin, cout, dx, stats, prologue)),
        conv_ring_blocks(cin, cout, B, H, W, dx, stats, prologue), int(e_bf16), _stream(src))


def launch_conv_bn(x, w, a=None, b=None, prologue=False, e_bf16=False):
    _check_nhwc(x, "conv3x3_bn kernel")
    B, H, W, cin = x.shape
    cout = w.shape[0]
    if w.shape != (cout, cin, 3, 3):
        raise ValueError(f"conv3x3_bn kernel: weight [Cout, {cin}, 3, 3] expected, "
                         f"got {tuple(w.shape)}")
    bf16 = x.dtype == torch.bfloat16
    wk = _kernel_weight(w, x.dtype)
    if prologue:
        a, b = _vec(a, cin, x.device, "conv prologue"), _vec(b, cin, x.device, "conv prologue")
    else:
        a = b = wk  # not read
    y = torch.empty(B, H, W, cout, dtype=x.dtype, device=x.device)
    partials = torch.empty(conv_partials_shape(cin, cout, B, H, W, bf16), dtype=torch.float32,
                           device=x.device)
    out = torch.empty(2, cout, dtype=torch.float32, device=x.device)
    if bf16:
        err = _launch_ring(False, x, None, None, None, wk, a, b, None, y, partials, out,
                           prologue, e_bf16)
    else:
        err = build.library().cltorch_conv3x3_bn_fwd(
            x.data_ptr(), wk.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(),
            partials.data_ptr(), out.data_ptr(), B, H, W, cin, cout, int(prologue), 0,
            _stream(x))
    build.check(err, "conv3x3_bn_fwd")
    return y, out[0], out[1]


def _grad_operands(x, w, y, dy, ds1, ds2, what):
    _check_nhwc(x, what)
    B, H, W, cin = x.shape
    cout = w.shape[0]
    if w.shape != (cout, cin, 3, 3):
        raise ValueError(f"{what}: weight [Cout, {cin}, 3, 3] expected, got {tuple(w.shape)}")
    for t in (y, dy):
        _check_nhwc(t, what)
        if t.shape != (B, H, W, cout) or t.dtype != x.dtype:
            raise ValueError(f"{what}: y and dy of shape {(B, H, W, cout)} and {x.dtype}")
    return _stats_operands(ds1, ds2, cout, x.device, what)


def _stats_operands(ds1, ds2, cout, device, what):
    """The stats cotangents as the kernels read them: both None (e = dy),
    else both f32 [Cout], a missing one zero."""
    if ds1 is None and ds2 is None:
        return None, None
    zeros = torch.zeros(cout, dtype=torch.float32, device=device)
    return tuple(zeros if v is None else _vec(v, cout, device, what) for v in (ds1, ds2))


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch_conv_dx(x, w, a, b, y, dy, ds1, ds2, prologue, pipe=False, e_bf16=False):
    """(dx, da, db) on the card; da, db None without the prologue: the
    ring's dx in bf16, the FMA body in f32; ``e_bf16``: e with the bf16
    chain (bf16 only). ``pipe`` (34p/35p, ``CL_TPU_DX_PIPE``) launches the
    same kernels, bit-equal to #34/#35 as ``cl_tpu``'s pipelined dx is:
    the ring already overlaps the next tile's copies with the current
    tile's products, and the card ran #34/#35's f32 instances faster than a
    pipelined FMA kernel at every headline shape."""
    s1, s2 = _grad_operands(x, w, y, dy, ds1, ds2, "conv3x3_bn dx kernel")
    B, H, W, cin = x.shape
    cout = w.shape[0]
    # the dx conv reads Cout channels and writes Cin: the flipped, transposed
    # weight in the kernel layout of a conv Cout -> Cin
    bf16 = x.dtype == torch.bfloat16
    wdx = _kernel_weight(_flip_t(w), x.dtype)
    if prologue:
        a, b = _vec(a, cin, x.device, "conv prologue"), _vec(b, cin, x.device, "conv prologue")
    dx = torch.empty_like(x)
    partials = torch.empty(dx_partials_shape(cin, B, H, W, prologue), dtype=torch.float32,
                           device=x.device)
    out = torch.empty(2, cin, dtype=torch.float32, device=x.device)
    a, b = (a, b) if prologue else (None, None)
    if bf16:
        err = _launch_ring(True, dy, y, s1, s2, wdx, a, b, x, dx, partials, out, prologue,
                           e_bf16)
    else:
        err = build.library().cltorch_conv3x3_bn_dx(
            dy.data_ptr(), y.data_ptr(), _ptr(s1), _ptr(s2), wdx.data_ptr(), x.data_ptr(),
            _ptr(a), _ptr(b), dx.data_ptr(), partials.data_ptr(), out.data_ptr(), B, H, W, cout,
            cin, int(prologue), 0, _stream(x))
    build.check(err, "conv3x3_bn_dx_pipe" if pipe else "conv3x3_bn_dx")
    return (dx, out[0], out[1]) if prologue else (dx, None, None)


def dw_splits(cin, cout, B, H, W, bf16):
    """Blocks the first f32 dW body (#36 in f32) and the f32 one-pass
    backward (#37) split the pixel tiles over: ~SPLIT_BLOCKS in all, at
    least one tile each. A function of the shapes alone, so the
    partial sums run in the same order on every call."""
    n_tiles = B * -(-H // (TILE if bf16 else TILE // 2)) * -(-W // TILE)
    channel_tiles = -(-cin // 32) * -(-cout // 32)
    return max(1, min(-(-SPLIT_BLOCKS // channel_tiles), n_tiles))


# The bf16 #36 ring body (csrc/conv3x3_dw_body.cuh::RingTile): pixel tiles
# of RING_TH x 16, a ring of RING_STAGES raw stages.
RING_TH = 8
RING_STAGES = 3
RING_RAW_ROW = 256  # bytes a window row of a narrow x (Cin < 8) is copied into


def dw_ring_tile(cin, cout):
    """(CI_T, CO_T): the ring body's channel tile for a conv Cin -> Cout, the
    instance the C entry point launches. 16 input channels for the stem (one
    m16 of 3), else 32 or 64; 32 or 64 output channels. The tiles past 16
    input channels load by TMA, which needs both widths a multiple of 8
    (16-byte rows): other widths take 16."""
    ci_t, co_t = (16 if cin <= 16 else 32 if cin <= 32 else 64), (32 if cout <= 32 else 64)
    return (16 if cin % 8 or cout % 8 else ci_t), co_t


def dw_ring_wgmma(ci_t, co_t):
    """Whether the ring instance multiplies on wgmma (the 64 x 64 tile),
    else on mma.sync."""
    return (ci_t, co_t) == (64, 64)


def dw_ring_resources(ci_t, co_t, q=False, xq=False, pack=0):
    """(threads, dynamic shared bytes, resident blocks an SM) of a ring
    instance, as RingTile sizes it (``dw_ring_smem``). A warp per (tap, 32
    output channels) on mma.sync, three warpgroups on wgmma. Each stage the
    (RING_TH + 2) x 18 window of x and the RING_TH x 16 tiles of dy and y:
    with TMA (CI_T >= 32) as dense rows (the window rounded up to 1024
    bytes), with the stages' mbarriers and 1024 bytes of alignment; else in
    rows padded by 8 bf16, and for CI_T = 16 the window's raw rows of a
    narrow x (RING_RAW_ROW bytes each). #39 (``q``) with TMA holds the int8
    y tile and its RING_TH rows' scales (``pack`` x CO_T floats a row) in
    place of y, the stage 1024-byte rounded, and in the xq mode two raw
    slots of the int8 x window (128-byte rounded) and its RING_TH + 2 rows'
    scales. RING_STAGES such stages, then the per-channel vectors in f32;
    two blocks an SM for CO_T = 32 (CI_T <= 32) and one else by the
    registers (``__launch_bounds__``), fewer if the shared memory says so."""
    win, pix = (RING_TH + 2) * 18, RING_TH * 16
    threads = 384 if dw_ring_wgmma(ci_t, co_t) else 9 * co_t
    raw = 0
    if ci_t >= 32:
        kx = _up(win * ci_t * 2, 1024)
        stage = kx + 4 * pix * co_t
        if q:
            stage = _up(kx + 2 * pix * co_t + pix * co_t + RING_TH * pack * co_t * 4, 1024)
            raw = _up(win * ci_t, 128) + (RING_TH + 2) * pack * ci_t * 4 if xq else 0
        extra = RING_STAGES * 8 + 1024
    else:
        stage = 2 * (win * (ci_t + 8) + 2 * pix * (co_t + 8) + (RING_TH + 2) * RING_RAW_ROW // 2)
        extra = 0
    smem = RING_STAGES * stage + 2 * raw + 4 * (2 * ci_t + 2 * co_t) + extra
    return threads, smem, resident_blocks(smem, 2 if co_t == 32 and ci_t <= 32 else 1)


def dw_ring_splits(cin, cout, B, H, W, tile=None, q=False, xq=False, pack=0):
    """Blocks the bf16 ring body splits the pixel tiles over: one wave of
    resident blocks (``dw_ring_resources``) over the channel tiles, each
    block the same number of tiles. A function of the shapes alone, so the
    partial sums run in the same order on every call. ``tile``: the
    (CI_T, CO_T) launched (default ``dw_ring_tile``'s); ``q``, ``xq``,
    ``pack``: #39's sizes."""
    ci_t, co_t = tile or dw_ring_tile(cin, cout)
    n_tiles = B * -(-H // RING_TH) * -(-W // 16)
    channel_tiles = -(-cin // ci_t) * -(-cout // co_t)
    return one_wave_splits(n_tiles, channel_tiles, dw_ring_resources(ci_t, co_t, q, xq, pack)[2])


# The f32 register-blocked body of #31, #33 and #41
# (csrc/conv3x3_dw_body.cuh::RegTile): 32 input channels a tile, a ring of
# FMA_STAGES stages; pixel tiles of 8 (64-wide tile) or 4 (32-wide) rows x
# 16, with 1 or 3 resident blocks an SM.
FMA_CI_T = 32
FMA_STAGES = 3
FMA_TH = {64: 8, 32: 4}
FMA_BLOCKS = {64: 1, 32: 3}


def dw_fma_tile(cin, cout):
    """(CI_T, CO_T): the register-blocked body's channel tile for a conv
    Cin -> Cout, the instance the C entry points launch: 32 input channels,
    32 or 64 output channels."""
    return FMA_CI_T, (32 if cout <= 32 else 64)


def dw_fma_resources(ci_t, co_t, q=False, xq=False, pack=0):
    """(threads, dynamic shared bytes, resident blocks an SM, pixel tile
    rows) of a register-blocked instance, as RegTile sizes it
    (``dw_reg_smem``): three warps' rows (one per kernel row) of CO_T / 16
    warps; each stage the (TH + 2) x 18 window of x and the TH x 16 tile of
    e in f32, FMA_STAGES such stages and the prologue's a and b; #39
    (``q``) two raw slots (each the int8 y tile and its TH rows' scales,
    ``pack`` x CO_T floats a row, and in the xq mode the int8 x window and
    its TH + 2 rows' scales, each piece 128-byte rounded) and ds1, ds2; the
    blocks its ``__launch_bounds__`` fits the registers to, fewer if the
    shared memory says so."""
    th = FMA_TH[co_t]
    win = (th + 2) * 18
    stage = win * ci_t + th * 16 * co_t
    smem = (FMA_STAGES * stage + 2 * ci_t) * 4
    if q:
        raw = _up(th * 16 * co_t, 128) + _up(th * pack * co_t * 4, 128)
        if xq:
            raw += _up(win * ci_t, 128) + _up((th + 2) * pack * ci_t * 4, 128)
        smem += 2 * raw + 2 * co_t * 4
    return 6 * co_t, smem, resident_blocks(smem, FMA_BLOCKS[co_t]), th


def dw_fma_splits(cin, cout, B, H, W, tile=None, q=False, xq=False, pack=0):
    """Blocks the f32 register-blocked body splits the pixel tiles over: one
    wave of resident blocks (``dw_fma_resources``) over the channel tiles,
    each block the same number of tiles. A function of the shapes alone.
    ``tile``, ``q``, ``xq``, ``pack`` as ``dw_ring_splits``'."""
    ci_t, co_t = tile or dw_fma_tile(cin, cout)
    _, _, blocks, th = dw_fma_resources(ci_t, co_t, q, xq, pack)
    n_tiles = B * -(-H // th) * -(-W // 16)
    channel_tiles = -(-cin // ci_t) * -(-cout // co_t)
    return one_wave_splits(n_tiles, channel_tiles, blocks)


def dw_tile_splits(cin, cout, B, H, W, bf16):
    """(CI_T, CO_T, splits) of #31's, #33's and #41's dW: the ring body's in
    bf16, the register-blocked FMA body's in f32."""
    if bf16:
        return (*dw_ring_tile(cin, cout), dw_ring_splits(cin, cout, B, H, W))
    return (*dw_fma_tile(cin, cout), dw_fma_splits(cin, cout, B, H, W))


@functools.lru_cache(maxsize=None)
def dw_q_tile_splits(cin, cout, B, H, W, bf16, xq, pack):
    """(CI_T, CO_T, splits) of #39 (the int8 y; ``xq``: the int8 x too; the
    scales grouping the columns mod ``pack``). bf16: the ring body's tile
    of ``dw_ring_tile``, where its TMA stages take the int8 rows (Cout, and
    in the xq mode Cin, a multiple of 16) and fit shared memory at
    ``pack``, else the next narrower input tile (16 wide: plain loads form e
    and t, the other kinds' stages). f32: the register-blocked tile, CO_T 64
    or 32, the widest that fits. Raises where nothing fits."""
    if bf16:
        ci_t, co_t = dw_ring_tile(cin, cout)
        if cout % 16 or (xq and cin % 16):
            ci_t = 16
        for ci in [c for c in (64, 32, 16) if c <= ci_t]:
            if dw_ring_resources(ci, co_t, True, xq, pack)[1] <= RING_CONV_SMEM_MAX:
                return ci, co_t, dw_ring_splits(cin, cout, B, H, W, (ci, co_t), True, xq, pack)
    else:
        for co_t in (64, 32) if cout > 32 else (32,):
            if dw_fma_resources(FMA_CI_T, co_t, True, xq, pack)[1] <= RING_CONV_SMEM_MAX:
                return FMA_CI_T, co_t, dw_fma_splits(cin, cout, B, H, W, (FMA_CI_T, co_t), True,
                                                     xq, pack)
    raise ValueError(f"conv3x3_bn dw_q kernel: no tile fits a conv of {cin} -> {cout} channels "
                     f"at pack {pack} in shared memory")


def dw_partials_shape(cin, cout, B, H, W, bf16):
    """The f32 partials [splits, Cout, Cin, 3, 3] the #36 wrapper allocates:
    the ring body's splits in bf16, ``dw_splits`` (shared with #37) in f32."""
    splits = dw_ring_splits(cin, cout, B, H, W) if bf16 else dw_splits(cin, cout, B, H, W, bf16)
    return splits, cout, cin, 3, 3


def launch_conv_dw(x, w, a, b, y, dy, ds1, ds2, prologue, e_bf16=False):
    """dW [Cout, Cin, 3, 3] on the card, rounded to x's dtype, as f32: the
    ring body in bf16 (the bf16 chains under ``e_bf16``), the FMA body in
    f32."""
    s1, s2 = _grad_operands(x, w, y, dy, ds1, ds2, "conv3x3_bn dW kernel")
    B, H, W, cin = x.shape
    cout = w.shape[0]
    if prologue:
        a, b = _vec(a, cin, x.device, "conv prologue"), _vec(b, cin, x.device, "conv prologue")
    bf16 = x.dtype == torch.bfloat16
    partials = torch.empty(dw_partials_shape(cin, cout, B, H, W, bf16), dtype=torch.float32,
                           device=x.device)
    dw = torch.empty(cout, cin, 3, 3, dtype=torch.float32, device=x.device)
    err = build.library().cltorch_conv3x3_bn_dw(
        x.data_ptr(), _ptr(a if prologue else None), _ptr(b if prologue else None),
        dy.data_ptr(), y.data_ptr(), _ptr(s1), _ptr(s2), partials.data_ptr(), dw.data_ptr(),
        B, H, W, cin, cout, int(prologue), partials.shape[0], *dw_ring_tile(cin, cout),
        int(bf16), int(bf16 and e_bf16), _stream(x))
    build.check(err, "conv3x3_bn_dw")
    return dw.to(x.dtype).float()


def launch_conv_bwd_fused(x, w, a, b, y, dy, ds1, ds2, prologue, e_bf16=False, need_dx=True):
    """#37 on the card: (dx or None, da, db, dW); da, db zeros without the
    prologue, dW rounded to x's dtype, as f32; the bf16 chains under
    ``e_bf16``. In bf16 the ring dx (``launch_conv_dx``, #34/#35's kernel,
    no dx for the stem) and #36's ring (``launch_conv_dw``), which the card
    ran faster than a one-pass ring kernel over the headline step
    (csrc/conv3x3_bn_bwd_fused.cu); in f32 the FMA kernel, dx and dW from
    one launch (and the fixed-order sums of its partials) with
    ``dw_splits``."""
    s1, s2 = _grad_operands(x, w, y, dy, ds1, ds2, "conv3x3_bn one-pass backward kernel")
    B, H, W, cin = x.shape
    cout = w.shape[0]
    if x.dtype == torch.bfloat16:
        dx, da, db = launch_conv_dx(x, w, a, b, y, dy, ds1, ds2, prologue, e_bf16=e_bf16) \
            if need_dx else (None, None, None)
        dw = launch_conv_dw(x, w, a, b, y, dy, ds1, ds2, prologue, e_bf16)
        if da is None:
            da, db = torch.zeros(2, cin, dtype=torch.float32, device=x.device)
        return dx, da, db, dw
    wdx = _kernel_weight(_flip_t(w), x.dtype) if need_dx else None
    if prologue:
        a, b = _vec(a, cin, x.device, "conv prologue"), _vec(b, cin, x.device, "conv prologue")
    dx = torch.empty_like(x) if need_dx else None
    # da, db: one partial row per 8 x 16 pixel tile
    tiles = B * -(-H // (TILE // 2)) * -(-W // TILE)
    part_ab = torch.empty(tiles if need_dx and prologue else 1, 2, cin, dtype=torch.float32,
                          device=x.device)
    out_ab = torch.zeros(2, cin, dtype=torch.float32, device=x.device)
    splits = dw_splits(cin, cout, B, H, W, False)
    part_dw = torch.empty(splits, cout, cin, 3, 3, dtype=torch.float32, device=x.device)
    dw = torch.empty(cout, cin, 3, 3, dtype=torch.float32, device=x.device)
    err = build.library().cltorch_conv3x3_bn_bwd_fused(
        x.data_ptr(), _ptr(a if prologue else None), _ptr(b if prologue else None),
        y.data_ptr(), dy.data_ptr(), _ptr(s1), _ptr(s2), _ptr(wdx), _ptr(dx),
        part_ab.data_ptr(), out_ab.data_ptr(), part_dw.data_ptr(), dw.data_ptr(),
        B, H, W, cin, cout, int(prologue), splits, _stream(x))
    build.check(err, "conv3x3_bn_bwd_fused")
    return dx, out_ab[0], out_ab[1], dw.to(x.dtype).float()


def launch_conv3x3(x, w):
    """#30 on the card: y = conv3x3_SAME(x, w) in x's dtype, one launch of
    the plain conv's bodies (the ring's kPlain MODE in bf16, the
    register-blocked FMA body in f32) with ``plain_schedule``'s schedule."""
    return launch_plain("cltorch_conv3x3_fwd", x, w, "conv3x3_fwd")


def _dw_shape(x, e, what):
    """The dW kernels' shared checks: (B, H, W, Cin, Cout), bf16 flag."""
    _check_nhwc(x, what)
    _check_nhwc(e, what)
    B, H, W, cin = x.shape
    if e.shape[:3] != x.shape[:3] or e.dtype != x.dtype:
        raise ValueError(f"{what}: dy of shape {(B, H, W)} + [Cout] and {x.dtype} expected")
    return (B, H, W, cin, e.shape[-1]), x.dtype == torch.bfloat16


def dw_tiled_outputs(x, e, what):
    """#31's, #33's and #41's shared checks and outputs: (shape args, (CI_T,
    CO_T, splits) from ``dw_tile_splits``, bf16 flag, partials, dW)."""
    (B, H, W, cin, cout), bf16 = _dw_shape(x, e, what)
    tile = dw_tile_splits(cin, cout, B, H, W, bf16)
    partials = torch.empty(tile[2], cout, cin, 3, 3, dtype=torch.float32, device=x.device)
    dw = torch.empty(cout, cin, 3, 3, dtype=torch.float32, device=x.device)
    return (B, H, W, cin, cout), tile, int(bf16), partials, dw


def launch_conv3x3_dw(x, dy):
    """#31 on the card: dW [Cout, Cin, 3, 3] f32, not rounded: the ring body
    in bf16, the register-blocked FMA body in f32, with the tile and splits
    of ``dw_tile_splits``."""
    shape, (ci_t, co_t, splits), bf16, partials, dw = dw_tiled_outputs(x, dy, "conv3x3_dw")
    err = build.library().cltorch_conv3x3_dw(
        x.data_ptr(), dy.data_ptr(), partials.data_ptr(), dw.data_ptr(), *shape, splits, ci_t,
        co_t, bf16, _stream(x))
    build.check(err, "conv3x3_dw")
    return dw


def launch_conv3x3_dw_bn(x, a, b, e, prologue, e_bf16=False):
    """#33 on the card: dW [Cout, Cin, 3, 3] of prologue_t(x) against the
    materialized e, f32, not rounded; the bf16 prologue under ``e_bf16``.
    The ring body in bf16, the register-blocked FMA body in f32, with the
    tile and splits of ``dw_tile_splits``."""
    shape, (ci_t, co_t, splits), bf16, partials, dw = dw_tiled_outputs(x, e, "conv3x3_dw_bn")
    if prologue:
        a, b = (_vec(v, x.shape[-1], x.device, "conv3x3_dw_bn") for v in (a, b))
    err = build.library().cltorch_conv3x3_dw_bn(
        x.data_ptr(), a.data_ptr() if prologue else None, b.data_ptr() if prologue else None,
        e.data_ptr(), partials.data_ptr(), dw.data_ptr(), *shape, int(prologue), splits, ci_t,
        co_t, bf16, int(bf16 and e_bf16), _stream(x))
    build.check(err, "conv3x3_dw_bn")
    return dw


def launch_quant_rows(y, p):
    """32q on the card: (q int8 [B, H, W, C], scale f32 [B, H, p, C])."""
    _check_nhwc(y, "conv3x3_bn quantize kernel")
    B, H, W, C = y.shape
    if W % p:
        raise ValueError(f"conv3x3_bn quantize kernel: width {W} is not a multiple of p = {p}")
    q = torch.empty(B, H, W, C, dtype=torch.int8, device=y.device)
    scale = torch.empty(B, H, p, C, dtype=torch.float32, device=y.device)
    err = build.library().cltorch_conv3x3_bn_quant(
        y.data_ptr(), q.data_ptr(), scale.data_ptr(), B, H, W, C, p,
        int(y.dtype == torch.bfloat16), _stream(y))
    build.check(err, "conv3x3_bn_quant")
    return q, scale


def _check_q(q, scale, shape, p, what):
    """An int8 saved tensor of ``shape`` [B, H, W, C] and its scales."""
    B, H, W, C = shape
    if q.dtype != torch.int8 or tuple(q.shape) != tuple(shape) or not q.is_contiguous():
        raise ValueError(f"{what}: int8 {list(shape)} expected, got {q.dtype} {list(q.shape)}")
    if (scale.dtype != torch.float32 or tuple(scale.shape) != (B, H, p, C)
            or not scale.is_contiguous()):
        raise ValueError(f"{what}: f32 scales {[B, H, p, C]} expected, got {scale.dtype} "
                         f"{list(scale.shape)}")
    if q.data_ptr() % 16 or scale.data_ptr() % 16:  # the kernels' vector loads
        raise ValueError(f"{what}: int8 values and scales must be 16-byte aligned")


def _q_operands(x_res, w, q, scale, dy, ds1, ds2, p, what):
    """The int8 backward's shared checks: (x or None, xq, xs, s1, s2)."""
    _check_nhwc(dy, what)
    B, H, W, cout = dy.shape
    cin = w.shape[1]
    if w.shape != (cout, cin, 3, 3):
        raise ValueError(f"{what}: weight [{cout}, Cin, 3, 3] expected, got {tuple(w.shape)}")
    _check_q(q, scale, dy.shape, p, f"{what} (y)")
    if isinstance(x_res, tuple):
        _check_q(*x_res, (B, H, W, cin), p, f"{what} (x)")
        x, (xq, xs) = None, x_res
    else:
        _check_nhwc(x_res, what)
        if x_res.shape != (B, H, W, cin) or x_res.dtype != dy.dtype:
            raise ValueError(f"{what}: x of shape {(B, H, W, cin)} and {dy.dtype} expected")
        x, xq, xs = x_res, None, None
    return (x, xq, xs, *_stats_operands(ds1, ds2, cout, dy.device, what))


def launch_conv_dx_q(x_res, w, a, b, q, scale, dy, ds1, ds2, prologue, p):
    """#38 on the card: (dx, da, db); da, db None without the prologue. bf16
    runs the ring body (kDxQ, kDxQX) with ``dx_q_schedule``'s schedule, f32
    the FMA body."""
    x, xq, xs, s1, s2 = _q_operands(x_res, w, q, scale, dy, ds1, ds2, p, "conv3x3_bn dx_q kernel")
    B, H, W, cout = dy.shape
    cin = w.shape[1]
    bf16 = dy.dtype == torch.bfloat16
    wdx = _kernel_weight(_flip_t(w), dy.dtype)
    if prologue:
        a, b = _vec(a, cin, dy.device, "conv prologue"), _vec(b, cin, dy.device, "conv prologue")
    dx = torch.empty(B, H, W, cin, dtype=dy.dtype, device=dy.device)
    partials = torch.empty(dx_partials_shape(cin, B, H, W, prologue), dtype=torch.float32,
                           device=dy.device)
    out = torch.empty(2, cin, dtype=torch.float32, device=dy.device)
    sched = dx_q_schedule(cout, cin, B, H, W, s1 is not None, bool(prologue), xq is not None,
                          p) if bf16 else (0, 0, 0, 0, 0)
    err = build.library().cltorch_conv3x3_bn_dx_q(
        dy.data_ptr(), q.data_ptr(), scale.data_ptr(), _ptr(s1), _ptr(s2), wdx.data_ptr(),
        _ptr(x), _ptr(xq), _ptr(xs), _ptr(a if prologue else None),
        _ptr(b if prologue else None), dx.data_ptr(), partials.data_ptr(), out.data_ptr(),
        B, H, W, cout, cin, int(prologue), p, int(bf16), *sched, _stream(dy))
    build.check(err, "conv3x3_bn_dx_q")
    return (dx, out[0], out[1]) if prologue else (dx, None, None)


def launch_conv_dw_q(x_res, w, a, b, q, scale, dy, ds1, ds2, prologue, p, e_bf16=False):
    """#39 on the card: dW [Cout, Cin, 3, 3] rounded to the compute dtype,
    as f32; t from x with the bf16 prologue under ``e_bf16`` (not from
    deq(xq), an f32 operand). bf16 runs the ring body, f32 the
    register-blocked FMA body (kDwQ), with ``dw_q_tile_splits``'s tile and
    splits."""
    x, xq, xs, s1, s2 = _q_operands(x_res, w, q, scale, dy, ds1, ds2, p, "conv3x3_bn dw_q kernel")
    B, H, W, cout = dy.shape
    cin = w.shape[1]
    if prologue:
        a, b = _vec(a, cin, dy.device, "conv prologue"), _vec(b, cin, dy.device, "conv prologue")
    bf16 = dy.dtype == torch.bfloat16
    ci_t, co_t, splits = dw_q_tile_splits(cin, cout, B, H, W, bf16, xq is not None, p)
    partials = torch.empty(splits, cout, cin, 3, 3, dtype=torch.float32, device=dy.device)
    dw = torch.empty(cout, cin, 3, 3, dtype=torch.float32, device=dy.device)
    err = build.library().cltorch_conv3x3_bn_dw_q(
        _ptr(x), _ptr(xq), _ptr(xs), _ptr(a if prologue else None),
        _ptr(b if prologue else None), dy.data_ptr(), q.data_ptr(), scale.data_ptr(), _ptr(s1),
        _ptr(s2), partials.data_ptr(), dw.data_ptr(), B, H, W, cin, cout, int(prologue), p,
        splits, ci_t, co_t, int(bf16), int(bf16 and e_bf16 and x is not None), _stream(dy))
    build.check(err, "conv3x3_bn_dw_q")
    return dw.to(dy.dtype).float()


# ---------------------------------------------------------------------------
# autograd wrappers and public entries
# ---------------------------------------------------------------------------


def _conv3x3(x, w, key):
    """#30 (``key`` counts the launch) or its plain version."""
    if x.is_cuda:
        LAUNCHES[key] += 1
        return launch_conv3x3(x, w)
    return conv3x3_plain(x, w)


def _conv3x3_dw(x, dy):
    if x.is_cuda:
        LAUNCHES["conv3x3_dw"] += 1
        return launch_conv3x3_dw(x, dy)
    return conv3x3_dw_plain(x, dy)


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _conv3x3(x, w, "conv3x3_fwd")

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = _conv3x3(dy, _flip_t(w), "conv3x3_dx") if ctx.needs_input_grad[0] else None
        dw = _conv3x3_dw(x, dy).to(x.dtype).float() if ctx.needs_input_grad[1] else None
        return dx, dw


def conv3x3(x, w):
    """``cl_tpu.pallas.conv3x3_v3.conv3x3``: y [B, H, W, Cout] =
    conv3x3_SAME(x, w) in x's dtype, NHWC; ``w`` the f32 param
    [Cout, Cin, 3, 3]."""
    return _Conv3x3.apply(x, w)


def _two_pass_backward(need_dx, need_dw, prologue, x, w, a, b, y, dy, ds1, ds2, e_bf16=False):
    """``_cbf_bwd``'s two-pass branch: e materialized (in f32, rounded, also
    under ``e_bf16``: ``conv3x3_v3.py:961-963``), dt = #30 (rounded), dW =
    #33 (its prologue the bf16 chain under ``e_bf16``), the prologue's
    backward in torch on the rounded dt. Returns (dx, dW, da, db);
    ``need_dx`` asks for dx (or da, db)."""
    e = dy_eff(dy, y, ds1, ds2)
    dx = da = db = dw = None
    if need_dx:
        dt = _conv3x3(e, _flip_t(w), "conv3x3_dt")
        dx, da, db = prologue_bwd(x, a, b, dt) if prologue else (dt, None, None)
    if need_dw:
        if x.is_cuda:
            _count("conv3x3_dw_bn", e_bf16)
            dw = launch_conv3x3_dw_bn(x, a, b, e, prologue, e_bf16)
        else:
            dw = conv3x3_dw_bn_plain(x, a, b, e, prologue, e_bf16)
        dw = dw.to(x.dtype).float()
    return dx, dw, da, db


def _branch(x, w, prologue, p, fuse_bwd=None):
    """``conv_bwd_branch`` at the conv's packed view: ``cl_tpu``'s view pads
    the stem's 3 channels to 128 / p."""
    B, H, W, cin = x.shape
    cin_view = 128 // p if (p * cin) % 128 else cin
    return conv_bwd_branch(H, W, cin_view, w.shape[0], p, x.dtype.itemsize, prologue, fuse_bwd)


def _conv_bn(x, w, a, b, prologue, e_bf16):
    """#32 (counted) or its plain version: (y, Σy, Σy²)."""
    if x.is_cuda:
        _count("conv3x3_bn_fwd", e_bf16)
        return launch_conv_bn(x, w, a, b, prologue, e_bf16)
    return conv_bn_plain(x, w, a, b, prologue, e_bf16)


def _e_bf16(x):
    """``CL_TPU_E_BF16`` for a conv on x, read when its forward runs."""
    return packed_gate.E_BF16 and x.dtype == torch.bfloat16


class _ConvBN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, a, b, prologue, p):
        ctx.set_materialize_grads(False)
        ctx.prologue = prologue
        ctx.branch = _branch(x, w, prologue, p or pick_pack(x.shape[-1], w.shape[0]))
        ctx.dx_pipe = packed_gate.DX_PIPE
        ctx.e_bf16 = _e_bf16(x)
        y, s1, s2 = _conv_bn(x, w, a, b, prologue, ctx.e_bf16)
        ctx.save_for_backward(x, w, a, b, y)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        x, w, a, b, y = ctx.saved_tensors
        prologue, ew = ctx.prologue, ctx.e_bf16
        dy = torch.zeros_like(y) if dy is None else dy.to(y.dtype).contiguous()
        need_dx = ctx.needs_input_grad[0] or (prologue and any(ctx.needs_input_grad[2:4]))
        args = (x, w, a, b, y, dy, ds1, ds2, prologue)
        if ctx.branch == "two_pass":
            return (*_two_pass_backward(need_dx, ctx.needs_input_grad[1], prologue, x, w, a, b,
                                        y, dy, ds1, ds2, ew), None, None)
        if ctx.branch == "one_pass":
            if x.is_cuda:
                _count("conv3x3_bn_bwd_fused", ew)
                dx, da, db, dw = launch_conv_bwd_fused(*args, ew, need_dx=need_dx)
            else:
                dx, da, db, dw = conv_bwd_fused_plain(*args, ew, need_dx=need_dx)
            return (dx, dw if ctx.needs_input_grad[1] else None,
                    *((da, db) if prologue else (None, None)), None, None)
        dx = da = db = dw = None
        if need_dx:
            if x.is_cuda:
                _count(("conv3x3_bn_dx_bn" if prologue else "conv3x3_bn_dx")
                       + ("_pipe" if ctx.dx_pipe else ""), ew)
                dx, da, db = launch_conv_dx(*args, pipe=ctx.dx_pipe, e_bf16=ew)
            else:
                dx, da, db = conv_dx_plain(*args, ew)
        if ctx.needs_input_grad[1]:
            if x.is_cuda:
                _count("conv3x3_bn_dw", ew)
                dw = launch_conv_dw(*args, ew)
            else:
                dw = conv_dw_plain(*args, ew)
        return dx, dw, da, db, None, None


def conv_bn_fused(x, w, a=None, b=None, prologue=False, p=None):
    """(y [B, H, W, Cout], Σy [Cout], Σy² [Cout]) of the conv of
    t = relu(x·a + b) (``prologue``) or t = x, NHWC in x's dtype. ``p`` is
    the pack factor of ``cl_tpu``'s packed view (the level's; None = the
    conv's own), which decides its backward's branch."""
    return _ConvBN.apply(x, w, a, b, prologue, p)


def _quant_rows(y, p):
    """32q (counted) or its plain version."""
    if y.is_cuda:
        LAUNCHES["conv3x3_bn_quant"] += 1
        return launch_quant_rows(y, p)
    return quant_rows_plain(y, p)


class _ConvBNQ(torch.autograd.Function):
    """``conv_bn_fused_q``: the forward of ``_ConvBN`` and 32q; the backward
    from the int8 y and, in the xq mode, the int8 x (``x`` then unsaved)."""

    @staticmethod
    def forward(ctx, x, xq, xs, w, a, b, prologue, p):
        ctx.set_materialize_grads(False)
        ctx.prologue, ctx.p, ctx.dtype = prologue, p, x.dtype
        ctx.two_pass = _branch(x, w, prologue, p, fuse_bwd=False) == "two_pass"
        ctx.e_bf16 = _e_bf16(x)
        y, s1, s2 = _conv_bn(x, w, a, b, prologue, ctx.e_bf16)
        q, scale = _quant_rows(y, p)
        ctx.mark_non_differentiable(q, scale)
        # the saved tensors: (q, scale) in place of y; in the xq mode the
        # producer's pair in place of x, which must not be kept
        ctx.save_for_backward(None if xq is not None else x, xq, xs, w, a, b, q, scale)
        return y, s1, s2, q, scale

    @staticmethod
    def backward(ctx, dy, ds1, ds2, _dq, _dscale):
        x, xq, xs, w, a, b, q, scale = ctx.saved_tensors
        prologue, p, dtype = ctx.prologue, ctx.p, ctx.dtype
        dy = torch.zeros(q.shape, dtype=dtype, device=q.device) if dy is None else \
            dy.to(dtype).contiguous()
        need_dx = ctx.needs_input_grad[0] or (prologue and any(ctx.needs_input_grad[4:6]))
        need_dw = ctx.needs_input_grad[3]
        if ctx.two_pass:
            # no tile fits: dequantize y and x once, rounded to the compute
            # dtype, and take the two-pass backward on them (:1836-1858)
            x = x if xq is None else deq_rows(xq, xs, p).to(dtype)
            dx, dw, da, db = _two_pass_backward(need_dx, need_dw, prologue, x, w, a, b,
                                                deq_rows(q, scale, p).to(dtype), dy, ds1, ds2,
                                                ctx.e_bf16)
            return dx, None, None, dw, da, db, None, None
        args = (x if xq is None else (xq, xs), w, a, b, q, scale, dy, ds1, ds2, prologue, p)
        dx = da = db = dw = None
        if need_dx:
            if dy.is_cuda:
                LAUNCHES["conv3x3_bn_dx_q"] += 1
                dx, da, db = launch_conv_dx_q(*args)
            else:
                dx, da, db = conv_dx_q_plain(*args)
        if need_dw:
            ew = ctx.e_bf16 and xq is None  # t from the bf16 x, not from deq(xq)
            if dy.is_cuda:
                _count("conv3x3_bn_dw_q", ew)
                dw = launch_conv_dw_q(*args, ew)
            else:
                dw = conv_dw_q_plain(*args, ew)
        return dx, None, None, dw, da, db, None, None


def conv_bn_fused_q(x, xq, w, a, b, prologue, p):
    """``conv_bn_fused`` with int8 saved activations: (y, Σy, Σy², (q,
    scale)), y and the sums bit-equal to ``conv_bn_fused``'s; ``xq``, the
    producer conv's own (q, scale) of x or None, replaces x among the saved
    tensors. ``p``: the level's pack factor, which groups the scales'
    columns. Where autograd records nothing (the LwF teacher's and the
    eval's forwards) the quantize is skipped and the pair is None: nothing
    would read it, and every result is the same."""
    if not torch.is_grad_enabled():
        return (*conv_bn_fused(x, w, a, b, prologue, p), None)
    xq, xs = (None, None) if xq is None else xq
    y, s1, s2, q, scale = _ConvBNQ.apply(x, xq, xs, w, a, b, prologue, p)
    return y, s1, s2, (q, scale)
