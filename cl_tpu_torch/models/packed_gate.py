"""Which UNet levels run in the packed body, which convs of the standard
body take the gen-3 conv under ``model.conv_impl=v3|auto`` and the gen-2
conv under ``model.conv_impl=pallas|hybrid``, which backward
a packed conv takes and which packed convs store int8 saved activations
under ``model.conv_act_store=int8``: the integer arithmetic of the JAX package's
gates, copied so the port routes exactly where ``cl_tpu`` routes
(``cl_tpu.models.unet.packed_prefix``, ``DoubleConv`` / ``Conv3x3``, and
``conv3x3_v3._cbf_bwd``'s choice of its one-pass, fused or two-pass
backward).

Which levels run packed changes the arithmetic, not only the speed: a
packed level defers its last BatchNorm to the consumer, splits the
decoder's first conv over the two concat operands, and takes its batch
statistics from the stored (compute-dtype) conv output. So the port keeps
the TPU kernels' tiling limits here, as a gate, although its GPU kernels
do not need them.

The same holds for the gen-3 routes: the TPU kernels need a tile that
fits their VMEM budget, and ``cl_tpu`` gates a conv on ``supported()`` at
an itemsize of 2 but picks its tiles at the real one, so an f32 conv it
admitted can find no tile and fail its ``caller must gate on
supported()`` assert (``conv3x3_v3.py:218``); ``standard_body_refusal`` says where,
so the port refuses those configs instead of running them.

Sources: ``cl_tpu/pallas/conv3x3.py::pick_pack``,
``conv3x3_v3.py::_vmem_estimate / _pick_th / supported / profitable /
_geometry / _vmem_estimate_dx / _pick_th_dx / _pick_th_dw2 /
_vmem_estimate_bwdf / _pick_th_bwdf / _cbf_bwd``,
``cl_tpu/models/unet.py::packed_level_geometry`` and ``Conv3x3``,
``pool_pack.py::supported / _pick_th``, ``upconv_pack.py::geometry``, and
the gen-2 conv's ``conv3x3.py::supported / _pick_th / _SCRATCH_BUDGET /
_SCRATCH_HARD_LIMIT`` (``g2_supported``; ``dw_profitable``, the dW gate of
``conv_impl=hybrid``, is the same function).

The gen-2 gate, like the gen-3 one, sizes its tiles at an itemsize of 2
whatever the compute dtype, but the gen-2 conv has no later assert: every
shape it admits runs, in f32 too, so no gen-2 config is refused.

Of the JAX package's environment variables, the port reads the two that
choose a packed conv's backward, once at import, as ``conv3x3_v3`` reads
them: ``CL_TPU_FUSE_BWD=1`` (``FUSE_BWD``: the one-pass backward #37
first, where its tile fits) and ``CL_TPU_DX_PIPE=1`` (``DX_PIPE``: the
pipelined dx, whose third dy slot enters the dx tile's estimate); and
three of its tuning variables with ``cl_tpu``'s parsing
(``conv3x3_v3.py:70-85``): ``CL_TPU_CONV_BUDGET`` (``CONV_VMEM_BUDGET``,
the conv tiles' VMEM budget, which decides how many levels run packed and
which gen-3 routes and backward branches fit), ``CL_TPU_BWDF_BUDGET``
(``FUSED_VMEM_BUDGET``, the one-pass backward's) and ``CL_TPU_ROW_TARGET``
(``CONV_ROW_TARGET``, the dot rows a tile aims at, where the tile search
starts). ``cl_tpu``'s th sets no tile of the port's kernels: under these
three only the routes move (which levels are packed, which convs take the
gen-3 conv, which backward a packed conv takes), and each route runs the
port's own kernels, so the results differ from ``cl_tpu``'s by summation
order alone. The gates read the module attributes at call time (the
cached ones take them as arguments), so a caller may set them per run.
``CL_TPU_CAT_DOTS`` (``conv3x3_v3.py:109-116``) is a dot schedule: 0 and 1
move only the TPU's f32 summation order and nothing in the port, and any
other value ``cl_tpu`` rejects at import; the port raises it as
``ValueError`` from ``check_tuning`` (``train.check_supported``), not at
its own import. ``CL_TPU_E_BF16=1`` (``E_BF16``, ``conv3x3_v3._E_BF16``)
runs the bf16 packed convs' prologue and backward chains in bf16
(``kernels/conv3x3.py``, read at each conv's forward).
"""

from __future__ import annotations

import functools
import os

FUSE_BWD = os.environ.get("CL_TPU_FUSE_BWD", "0") == "1"  # conv3x3_v3._FUSE_BWD
DX_PIPE = os.environ.get("CL_TPU_DX_PIPE", "0") == "1"    # conv3x3_v3._DX_PIPE

_TUNING_ERRORS: list[str] = []  # values cl_tpu's int() would fail to parse at its import


def _env_int(name: str, default: int) -> int:
    """``int(os.environ.get(name, default))``, as ``conv3x3_v3`` parses
    it; a value it cannot parse is kept for ``check_tuning`` to raise."""
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        _TUNING_ERRORS.append(f"{name}={os.environ[name]!r} is not an integer")
        return default


CONV_VMEM_BUDGET = _env_int("CL_TPU_CONV_BUDGET", 20 * 1024 * 1024)  # conv3x3_v3._VMEM_BUDGET
CONV_ROW_TARGET = _env_int("CL_TPU_ROW_TARGET", 8192)                # conv3x3_v3._ROW_TARGET
FUSED_VMEM_BUDGET = _env_int("CL_TPU_BWDF_BUDGET", 64 * 1024 * 1024)  # ._VMEM_BUDGET_FUSED
CAT_DOTS = _env_int("CL_TPU_CAT_DOTS", 1)                            # conv3x3_v3._CAT_DOTS
E_BF16 = os.environ.get("CL_TPU_E_BF16", "0") == "1"                 # conv3x3_v3._E_BF16
POOL_VMEM_BUDGET = 10 * 1024 * 1024  # pool_pack._pick_th
G2_SCRATCH_BUDGET = 4 * 1024 * 1024      # conv3x3._SCRATCH_BUDGET
G2_SCRATCH_HARD_LIMIT = 8 * 1024 * 1024  # conv3x3._SCRATCH_HARD_LIMIT

def check_tuning() -> None:
    """Raise ``ValueError`` where ``cl_tpu`` rejects a tuning variable at
    its import: a value ``int()`` cannot parse, or ``CL_TPU_CAT_DOTS``
    outside {0, 1} (``conv3x3_v3.py:110-116``, its message)."""
    if _TUNING_ERRORS:
        raise ValueError("; ".join(_TUNING_ERRORS))
    if CAT_DOTS not in (0, 1):
        raise ValueError(
            f"CL_TPU_CAT_DOTS={CAT_DOTS} unsupported: 2 (all five pieces in "
            "one mixed-width dot) is rejected by Mosaic ('result/input offset "
            "mismatch on non-concat dimension' — mixed-width lane concat is "
            "unsupported); use 0 (five dots) or 1 (merged center dots, default)")


def pick_pack(c_in: int, c_out: int) -> int:
    """Spatial columns per 128-lane group (``conv3x3.pick_pack``)."""
    if c_out <= 32:
        p = 4
    elif c_out <= 64:
        p = 2
    else:
        p = 1
    while (p * c_in) % 128 and p <= 64:
        p *= 2
    return p


def _conv_vmem(th, wg, lanes, k, p, c_out, itemsize) -> int:
    rows = th * wg
    return (2 * (th + 4) * wg * lanes * itemsize
            + 2 * 3 * k * p * c_out * itemsize
            + 2 * th * wg * p * c_out * itemsize
            + 3 * rows * lanes * itemsize
            + rows * p * c_out * 4)


def _pick_rows(h, wg, fits) -> int:
    """The tile-height search the conv pickers share: h itself for small
    images, else the largest multiple-of-8 divisor of h at most ~8192 dot
    rows whose estimate fits the budget; 0 if none does."""
    if h <= 16:
        return h if fits(h) else 0
    th = min(h, max(8, (CONV_ROW_TARGET // max(1, wg)) // 8 * 8))
    while th >= 8:
        if h % th == 0 and fits(th):
            return th
        th -= 8
    return 0


def _conv_pick_th(h, wg, lanes, itemsize, k, p, c_out) -> int:
    """``conv3x3_v3._pick_th``."""
    return _pick_rows(h, wg, lambda th: _conv_vmem(
        th, wg, lanes, k, p, c_out, itemsize) <= CONV_VMEM_BUDGET)


def _dx_vmem(th, wg, lanes, k, out_lanes, itemsize, epilogue) -> int:
    """``conv3x3_v3._vmem_estimate_dx``: two dy slots, three under
    ``DX_PIPE``, and two y slots."""
    rows = th * wg
    dy_slots = 3 if DX_PIPE else 2
    est = ((dy_slots + 2) * (th + 4) * wg * lanes * itemsize
           + (th + 4) * wg * lanes * 4
           + 2 * 3 * k * out_lanes * itemsize
           + 2 * th * wg * out_lanes * itemsize
           + 3 * rows * lanes * itemsize
           + rows * out_lanes * 4)
    if epilogue:
        est += 2 * th * wg * out_lanes * itemsize + 3 * rows * out_lanes * 4
    return est


def _pick_th_dx(h, wg, lanes, k, out_lanes, itemsize, epilogue) -> int:
    """``conv3x3_v3._pick_th_dx``: the fused dx kernel's tile."""
    return _pick_rows(h, wg, lambda th: _dx_vmem(
        th, wg, lanes, k, out_lanes, itemsize, epilogue) <= CONV_VMEM_BUDGET)


def _pick_th_dw2(h, wg, lanes, k, p, c_out, itemsize) -> int:
    """``conv3x3_v3._pick_th_dw2``: the fused dW kernel's tile (the plain
    dW's footprint plus its dy and y blocks and the f32 dy_eff temp)."""
    def fits(th):
        extra = 4 * th * wg * p * c_out * itemsize + th * wg * p * c_out * 4
        return _conv_vmem(th, wg, lanes, k, p, c_out, itemsize) + extra <= CONV_VMEM_BUDGET

    return _pick_rows(h, wg, fits)


def _bwdf_vmem(th, wg, lanes, out_lanes, kdx, kdw, itemsize, prologue) -> int:
    """``conv3x3_v3._vmem_estimate_bwdf``: the one-pass backward's dy, y
    and x halo scratches, the f32 dy_eff temp, its dx weight and output
    blocks, both piece sets, the f32 dx accumulator and the dW one."""
    rows = th * wg
    est = (2 * 2 * (th + 4) * wg * lanes * itemsize
           + 2 * (th + 4) * wg * out_lanes * itemsize
           + (th + 4) * wg * lanes * 4
           + 2 * 3 * kdx * out_lanes * itemsize
           + 2 * th * wg * out_lanes * itemsize
           + 3 * rows * lanes * itemsize
           + 3 * rows * out_lanes * itemsize
           + rows * out_lanes * 4
           + 2 * 3 * kdw * lanes * 4)
    if prologue:
        est += 3 * rows * out_lanes * 4
    return est


def _pick_th_bwdf(h, wg, lanes, out_lanes, kdx, kdw, itemsize, prologue) -> int:
    """``conv3x3_v3._pick_th_bwdf``: the one-pass backward's tile, at the
    64 MiB budget (``_VMEM_BUDGET_FUSED``)."""
    return _pick_rows(h, wg, lambda th: _bwdf_vmem(
        th, wg, lanes, out_lanes, kdx, kdw, itemsize, prologue) <= FUSED_VMEM_BUDGET)


def conv_supported(h: int, w: int, c_in: int, c_out: int,
                   itemsize: int = 2, p: int | None = None) -> bool:
    """``conv3x3_v3.supported``."""
    p = p or pick_pack(c_in, c_out)
    lanes = p * c_in
    k = (p + 2) * c_in
    if lanes % 128 or w % p:
        return False
    wg = w // p
    if wg < 8 or wg & (wg - 1) or c_in % 8 or c_in < 8 or h < 2:
        return False
    if h > 16 and h % 8:
        return False
    return _conv_pick_th(h, wg, lanes, itemsize, k, p, c_out) > 0


def profitable(h: int, w: int, c_in: int, c_out: int) -> bool:
    """``conv3x3_v3.profitable``: the shapes ``model.conv_impl=auto`` routes."""
    return conv_supported(h, w, c_in, c_out) and h * w >= 256 * 256


def conv_tile(h: int, w: int, c_in: int, c_out: int, itemsize: int,
              p: int | None = None) -> int:
    """The tile height ``conv3x3_v3._geometry`` picks for one launch of the
    gen-3 conv (forward, or a dx as the conv Cout -> Cin), 0 where it finds
    none and asserts; ``p`` None = the launch's own pack factor."""
    p = p or pick_pack(c_in, c_out)
    if w % p:
        return 0
    return _conv_pick_th(h, w // p, p * c_in, itemsize, (p + 2) * c_in, p, c_out)


def _g2_pick_th(h: int, wg: int, lanes: int, n_pieces: int, itemsize: int) -> int:
    """``conv3x3._pick_th``: rows per grid tile of the gen-2 conv."""
    if h <= 16:
        return h
    th = min(h, max(8, (2048 // max(1, wg)) // 8 * 8))
    while th >= 8:
        if h % th == 0:
            scratch = 2 * n_pieces * (th + 8) * wg * lanes * itemsize
            if scratch <= G2_SCRATCH_BUDGET:
                return th
        th -= 8
    return 8


def g2_supported(h: int, w: int, c_in: int, c_out: int, itemsize: int = 2) -> bool:
    """``conv3x3.supported``: the shapes the gen-2 conv takes under
    ``model.conv_impl=pallas`` (forward, dx and dW), and whose dW it takes
    under ``=hybrid`` (``conv3x3.dw_profitable`` is this function)."""
    p = pick_pack(c_in, c_out)
    if (p * c_in) % 128 or w % p or (w // p) < 2:
        return False
    if h > 16 and h % 8:
        return False
    if c_in < 8 or h < 2:
        return False
    wg = w // p
    lanes = p * c_in
    n_pieces = -(-((p + 2) * c_in) // lanes)
    th = _g2_pick_th(h, wg, lanes, n_pieces, itemsize)
    rh = -(-(th + 2) // 8) * 8  # common.round_up(th + 2, 8)
    return 2 * n_pieces * rh * wg * lanes * itemsize <= G2_SCRATCH_HARD_LIMIT


def level_pack(h: int, w: int, c_in: int, features: int, conv_impl: str) -> int:
    """``cl_tpu.models.unet.packed_level_geometry``'s pack factor, or 0: a
    DoubleConv runs as a packed level where both convs pass the route's
    gate (at the gate's itemsize of 2) at one pack factor."""
    ok = profitable if conv_impl == "auto" else conv_supported
    if not (ok(h, w, c_in, features) and ok(h, w, features, features)):
        return 0
    p = pick_pack(c_in, features)
    return p if p == pick_pack(features, features) else 0


def double_conv_route(h: int, w: int, c_in: int, features: int, conv_impl: str,
                      norm: str, level: bool = True) -> tuple[str, str]:
    """Each conv's route in a standard-body DoubleConv (``unet.py:102-130,
    :314-349``): ``"packed"`` (the level through the gen-3 conv with
    PackedBatchNorm), ``"v3"`` (the conv alone through it), ``"g2"`` (the
    gen-2 conv: forward, dx and dW; ``conv_impl=pallas`` where
    ``g2_supported``), ``"hybrid"`` (cuDNN forward and dx, the gen-2 dW
    where ``g2_supported``, else cuDNN's: every conv under
    ``conv_impl=hybrid``, the stem included), ``"xla"`` (cuDNN). Cached
    per shape, budget and row target: the model asks at every forward. ``level``
    False leaves the packed level out (``cl_tpu``'s DoubleConv under
    ``dp_axis``): each conv takes its own route."""
    return _double_conv_route(h, w, c_in, features, conv_impl, norm, level, CONV_VMEM_BUDGET,
                              CONV_ROW_TARGET)


@functools.lru_cache(maxsize=None)
def _double_conv_route(h, w, c_in, features, conv_impl, norm, level, budget, row_target):
    if conv_impl == "hybrid":
        return "hybrid", "hybrid"
    if conv_impl == "pallas":
        return tuple("g2" if g2_supported(h, w, ci, features) else "xla"
                     for ci in (c_in, features))
    if conv_impl not in ("v3", "auto"):
        return "xla", "xla"
    if level and norm == "batch" and level_pack(h, w, c_in, features, conv_impl):
        return "packed", "packed"
    ok = profitable if conv_impl == "auto" else conv_supported
    return tuple("v3" if ok(h, w, ci, features) else "xla" for ci in (c_in, features))


def v3_launch_refusal(h: int, w: int, c_in: int, c_out: int, itemsize: int,
                      packed: bool) -> str | None:
    """Why ``cl_tpu`` fails a train step's launches of one gen-3 conv at the
    real itemsize, or None: the forward (and the dW, at the same tile), and
    the dx, a conv Cout -> Cin at its own pack factor, which on the packed
    level must also equal the level's (``_cp_bwd``'s view assert)."""
    p = pick_pack(c_in, c_out)
    if not conv_tile(h, w, c_in, c_out, itemsize):
        return (f"the forward {c_in} -> {c_out} at p = {p} finds no tile: "
                "`caller must gate on supported()` (conv3x3_v3.py:218)")
    p_dx = pick_pack(c_out, c_in)
    if not conv_tile(h, w, c_out, c_in, itemsize):
        return (f"the dx ({c_out} -> {c_in}) at p = {p_dx} finds no tile: "
                "`caller must gate on supported()` (conv3x3_v3.py:218)")
    if packed and p_dx != p:
        return (f"the dx's pack factor {p_dx} is not the level's {p}: `packed view "
                "mismatch` (conv3x3_v3.py:519)")
    return None


def standard_body_levels(image_size: int, base_channels: int, depth: int):
    """(name, H = W, Cin, features) of each DoubleConv of the standard body,
    in forward order."""
    levels = []
    c_in = 3
    for level in range(depth):
        feats = base_channels * 2 ** level
        levels.append((f"enc{level}", image_size // 2 ** level, c_in, feats))
        c_in = feats
    levels.append(("bottleneck", image_size // 2 ** depth, c_in, base_channels * 2 ** depth))
    for level in reversed(range(depth)):
        feats = base_channels * 2 ** level
        levels.append((f"dec{level}", image_size // 2 ** level, 2 * feats, feats))
    return levels


def standard_body_refusal(image_size: int, base_channels: int, depth: int,
                          conv_impl: str, norm: str, itemsize: int) -> str | None:
    """The first conv of the standard body whose gen-3 launches ``cl_tpu``
    fails (``v3_launch_refusal``), named by level and shape, or None."""
    for name, h, ci, feats in standard_body_levels(image_size, base_channels, depth):
        routes = double_conv_route(h, h, ci, feats, conv_impl, norm)
        for i, (route, cin_i) in enumerate(zip(routes, (ci, feats))):
            if route not in ("packed", "v3"):  # only the gen-3 conv asserts
                continue
            why = v3_launch_refusal(h, h, cin_i, feats, itemsize, route == "packed")
            if why:
                return (f"{name}.conv{i} ({route} route, [{h}, {h}, {cin_i}] -> {feats} "
                        f"channels, itemsize {itemsize}): {why}")
    return None


def conv_bwd_branch(h: int, w: int, c_in: int, c_out: int, p: int, itemsize: int,
                    prologue: bool, fuse_bwd: bool | None = None) -> str:
    """The backward ``conv3x3_v3._cbf_bwd`` takes for a packed conv
    (``:930-985``): ``"one_pass"`` (#37, asked first, only under
    ``FUSE_BWD``, where its tile fits the 64 MiB budget), ``"fused"`` (the
    fused dx #34/#35, pipelined under ``DX_PIPE``, and dW #36, where both
    find a tile) or ``"two_pass"`` (a materialized dy_eff, the plain conv
    for dt and the dW with the prologue). ``c_in`` is the channels of the
    conv's packed input view (the stem's 3 are padded to 128 / p).
    ``fuse_bwd`` None reads ``FUSE_BWD``; the int8 backward passes False
    (``_cbfq_bwd`` never reads it). Cached per shape, switch, budget and
    row target."""
    fuse = FUSE_BWD if fuse_bwd is None else bool(fuse_bwd)
    return _conv_bwd_branch(h, w, c_in, c_out, p, itemsize, bool(prologue), fuse, DX_PIPE,
                            CONV_VMEM_BUDGET, FUSED_VMEM_BUDGET, CONV_ROW_TARGET)


@functools.lru_cache(maxsize=None)
def _conv_bwd_branch(h, w, c_in, c_out, p, itemsize, prologue, fuse, dx_pipe, budget,
                     fused_budget, row_target):
    wg = w // p
    lanes, lanes_x = p * c_out, p * c_in
    kdx, kdw = (p + 2) * c_out, (p + 2) * c_in
    if fuse and _pick_th_bwdf(h, wg, lanes, lanes_x, kdx, kdw, itemsize, prologue) > 0:
        return "one_pass"
    th = _pick_th_dx(h, wg, lanes, kdx, lanes_x, itemsize, prologue)
    th_dw2 = _pick_th_dw2(h, wg, lanes_x, kdw, p, c_out, itemsize)
    return "fused" if th > 0 and th_dw2 > 0 else "two_pass"


def q_supported(w: int, p: int) -> bool:
    """Whether a packed conv of width ``w`` at pack factor ``p`` stores its
    saved activations as int8 under ``model.conv_act_store=int8``:
    ``conv3x3_v3.q_supported(wg)`` as the TPU runs it, wg = w / p a
    multiple of 32 (its int8 tiling; the interpret branch, always true, is
    not what ``cl_tpu`` runs on its chip). At P = 4: every packed level at
    512², only level 0 at 128²."""
    return w % p == 0 and (w // p) % 32 == 0


def _pool_pick_th(h, g, lanes, itemsize, units=10) -> int:
    ho = h // 2
    th = min(ho, max(1, 2048 // max(1, g)))
    while th >= 1:
        if ho % th == 0:
            need = units * (2 * th * g * lanes + th * g * lanes) * itemsize
            if need <= POOL_VMEM_BUDGET:
                return th
        th -= 1
    return 0


def pool_supported(h, g, lanes, c, itemsize=2) -> bool:
    """``pool_pack.supported``."""
    p = lanes // c
    if p == 1:
        return (h % 2 == 0 and h >= 2 and lanes == c and g % 2 == 0
                and _pool_pick_th(h, g, lanes, itemsize) > 0)
    return (h % 2 == 0 and h >= 2 and p % 2 == 0 and lanes % c == 0
            and g % 2 == 0 and _pool_pick_th(h, g, lanes, itemsize) > 0)


def upconv_supported(g_in, lanes_in, c_in, c_out, p_out) -> bool:
    """``upconv_pack.geometry(...) is not None``."""
    if lanes_in % c_in:
        return False
    p_in = lanes_in // c_in
    if 2 * p_in % p_out or (2 * p_in) // p_out not in (1, 2):
        return False
    return (p_out * c_out) % 128 == 0


def packed_prefix(image_size: int, base_channels: int, depth: int,
                  itemsize: int = 2) -> int:
    """How many leading UNet levels run packed (0 = the standard body);
    ``cl_tpu.models.unet.packed_prefix``."""
    P = pick_pack(base_channels, base_channels)
    k = 0
    for level in range(depth):
        h = image_size // (2 ** level)
        feats = base_channels * (2 ** level)
        c_in = 3 if level == 0 else feats // 2
        g = h // P
        first = 128 // P if level == 0 else c_in  # the stem's padded input
        convs_ok = (conv_supported(h, h, first, feats, itemsize, p=P)
                    and conv_supported(h, h, feats, feats, itemsize, p=P))
        split_ok = conv_supported(h, h, feats, feats, itemsize, p=P)
        pool_ok = pool_supported(h, g, P * feats, feats, itemsize)
        c_below, h_below = feats * 2, h // 2
        up_ok = upconv_supported(h_below // P, P * c_below, c_below, feats, P)
        if not (convs_ok and split_ok and pool_ok and up_ok):
            return k
        k = level + 1
    return k
