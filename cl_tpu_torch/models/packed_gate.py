"""Which UNet levels run in the packed body: the integer arithmetic of the
JAX package's packed-domain gate, copied so the port chooses exactly the
levels ``cl_tpu.models.unet.packed_prefix`` chooses.

Which levels run packed changes the arithmetic, not only the speed: a
packed level defers its last BatchNorm to the consumer, splits the
decoder's first conv over the two concat operands, and takes its batch
statistics from the stored (compute-dtype) conv output. So the port keeps
the TPU kernels' tiling limits here, as a gate, although its GPU kernels
do not need them.

Sources (at their default budgets; the JAX package's tuning environment
variables are not read): ``cl_tpu/pallas/conv3x3.py::pick_pack``,
``conv3x3_v3.py::_vmem_estimate / _pick_th / supported``,
``pool_pack.py::supported / _pick_th`` and
``upconv_pack.py::geometry``.
"""

from __future__ import annotations

CONV_VMEM_BUDGET = 20 * 1024 * 1024  # conv3x3_v3._VMEM_BUDGET
CONV_ROW_TARGET = 8192               # conv3x3_v3._ROW_TARGET
POOL_VMEM_BUDGET = 10 * 1024 * 1024  # pool_pack._pick_th


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


def _conv_pick_th(h, wg, lanes, itemsize, k, p, c_out) -> int:
    if h <= 16:
        fits = _conv_vmem(h, wg, lanes, k, p, c_out, itemsize) <= CONV_VMEM_BUDGET
        return h if fits else 0
    th = min(h, max(8, (CONV_ROW_TARGET // max(1, wg)) // 8 * 8))
    while th >= 8:
        if h % th == 0 and _conv_vmem(
                th, wg, lanes, k, p, c_out, itemsize) <= CONV_VMEM_BUDGET:
            return th
        th -= 8
    return 0


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
