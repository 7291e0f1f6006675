"""The port's packed UNet body against ``cl_tpu``'s, on the CPU.

Per module, each plain version of a packed kernel
(``cl_tpu_torch.kernels.*``) is held against its Pallas function run as
the JAX package's own tests run it (interpret mode on the CPU), on the
same numpy inputs; ``cl_tpu``'s per-lane sums are folded over p to
channels. f32 agrees to 1e-5 (the same f32 arithmetic, sums in another
order); bf16 to one bf16 ulp of the output (an f32 sum in another order
may round to the other neighbour) plus that f32 floor. Then the gate (``packed_prefix``) and
the whole packed UNet in eval and train mode, from the same variables.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_tpu.models import unet as junet
from cl_tpu.pallas import conv3x3_v3 as jconv
from cl_tpu.pallas import packed_eltwise as jelt
from cl_tpu.pallas import pool_pack as jpool
from cl_tpu.pallas import upconv_pack as jup
from cl_tpu_torch.interop import export_jax_variables, load_jax_variables
from cl_tpu_torch.kernels import conv3x3, packed_eltwise, pool_pack, upconv_pack
from cl_tpu_torch.models import packed_gate
from cl_tpu_torch.models.unet import UNet, init_weights
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _randn(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _pair(arr, dtype_name):
    """The same values as a JAX and a torch array of the dtype."""
    jd, td = DTYPES[dtype_name]
    return jnp.asarray(arr).astype(jd), torch.from_numpy(arr).to(td)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not isinstance(
        a, torch.Tensor) else a.float().numpy()


def _bf16_ulp(x):
    mag = np.maximum(np.abs(x), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _close(got, want, dtype_name):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    if dtype_name == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        # plus the f32 floor: near zero the f32 sum's own order error
        # (of the size of the terms, not of the result) dominates
        tol = _bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + 1e-5
        assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


def _close_sums(got, want, y, power, dtype_name):
    """Per-channel Σy (power 1) or Σy² (power 2) over the output y: 1e-5 of
    Σ|term| in f32; in bf16 each y may also sit one ulp off."""
    got, want = _f32(got), _f32(want)
    yf = _f32(y).reshape(-1, got.shape[0])
    tol = 1e-5 * (np.abs(yf) ** power).sum(0) + 1e-6
    if dtype_name == "bfloat16":
        ulp = _bf16_ulp(yf)
        tol = tol + (ulp if power == 1 else 2 * np.abs(yf) * ulp + ulp ** 2).sum(0)
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


def _fold(v_l, p):
    return np.asarray(v_l).reshape(p, -1).sum(0)


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size,base,depth,itemsize,want", [
    (512, 32, 4, 2, 3), (256, 32, 4, 2, 4), (128, 32, 4, 4, 3),
    (64, 32, 2, 4, 2), (32, 8, 3, 4, 0)])
def test_packed_prefix_measured(size, base, depth, itemsize, want):
    assert packed_gate.packed_prefix(size, base, depth, itemsize) == want
    assert junet.packed_prefix(size, base, depth, itemsize) == want


@pytest.mark.parametrize("size,base,depth", [
    (512, 32, 4), (512, 64, 4), (256, 64, 4), (128, 32, 3), (64, 16, 2),
    (128, 8, 3), (1024, 32, 5), (96, 32, 3), (24, 32, 2), (128, 128, 2)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_packed_prefix_equals_cl_tpu(size, base, depth, itemsize):
    assert packed_gate.packed_prefix(size, base, depth, itemsize) == \
        junet.packed_prefix(size, base, depth, itemsize)


def test_pick_pack_equals_cl_tpu():
    from cl_tpu.pallas.conv3x3 import pick_pack
    for c_in in (3, 8, 16, 24, 32, 48, 64, 128, 256):
        for c_out in (8, 16, 32, 64, 128, 256):
            assert packed_gate.pick_pack(c_in, c_out) == pick_pack(c_in, c_out)


# ---------------------------------------------------------------------------
# Kernels' plain versions against the Pallas functions (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("B,H,W,cin,cout,p", [
    (2, 8, 32, 32, 32, 4),    # border-heavy: 8 rows, 2 of them border
    (1, 16, 32, 32, 64, 4),   # a level's first conv, at the uniform p
])
def test_conv_bn_fused(B, H, W, cin, cout, p, prologue, dtype_name):
    rng = np.random.RandomState(cin + cout + H)
    x = _randn(rng, B, H, W, cin)
    w = _randn(rng, 3, 3, cin, cout, scale=(9 * cin) ** -0.5)  # flax layout
    a = (rng.rand(cin) + 0.5).astype(np.float32)
    b = (rng.rand(cin) * 0.5 + 0.25).astype(np.float32)  # relu(b) > 0
    jx, tx = _pair(x, dtype_name)
    jd = DTYPES[dtype_name][0]
    yj, s1j, s2j = jconv.conv_bn_fused(
        jx.reshape(B, H, W // p, p * cin), jnp.asarray(w).astype(jd),
        jnp.tile(jnp.asarray(a), p), jnp.tile(jnp.asarray(b), p), p, prologue)
    yt, s1t, s2t = conv3x3.conv_bn_plain(
        tx, torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(a), torch.from_numpy(b), prologue)
    _close(yt, yj.reshape(B, H, W, cout), dtype_name)
    _close_sums(s1t, _fold(s1j, p), yt, 1, dtype_name)
    _close_sums(s2t, _fold(s2j, p), yt, 2, dtype_name)


def test_conv_bn_fused_stem():
    """cl_tpu pads the RGB stem to 128/p channels; the port convolves the
    three channels as they are."""
    B, H, W, p, cout = 2, 8, 32, 4, 32
    rng = np.random.RandomState(3)
    x = _randn(rng, B, H, W, 3)
    w = _randn(rng, 3, 3, 3, cout, scale=27 ** -0.5)
    c_pad = 128 // p
    xp = np.pad(x, ((0, 0), (0, 0), (0, 0), (0, c_pad - 3)))
    wp = np.pad(w, ((0, 0), (0, 0), (0, c_pad - 3), (0, 0)))
    ones = jnp.ones((p * c_pad,), jnp.float32)
    yj, s1j, s2j = jconv.conv_bn_fused(
        jnp.asarray(xp).reshape(B, H, W // p, p * c_pad), jnp.asarray(wp),
        ones, ones * 0, p, False)
    yt, s1t, s2t = conv3x3.conv_bn_plain(
        torch.from_numpy(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
    _close(yt, yj.reshape(B, H, W, cout), "float32")
    _close_sums(s1t, _fold(s1j, p), yt, 1, "float32")
    _close_sums(s2t, _fold(s2j, p), yt, 2, "float32")


def test_conv_prologue_pads_zero_in_t_space():
    """A border pixel sees t = 0 outside the image, not relu(b)."""
    x = torch.zeros(1, 4, 4, 1)
    w = torch.ones(1, 1, 3, 3)
    a, b = torch.ones(1), torch.full((1,), 2.0)
    y, _, _ = conv3x3.conv_bn_plain(x, w, a, b, True)
    assert y[0, 0, 0, 0].item() == 8.0 and y[0, 1, 1, 0].item() == 18.0


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,p", [((2, 8, 32, 32), 4), ((1, 8, 16, 64), 2)])
def test_bn_relu(shape, p, dtype_name):
    rng = np.random.RandomState(p)
    y = _randn(rng, *shape)
    c = shape[-1]
    scale = _randn(rng, c)
    shift = _randn(rng, c)
    jy, ty = _pair(y, dtype_name)
    B, H, W, _ = shape
    zj = jelt.bn_relu_packed(jy.reshape(B, H, W // p, p * c), jnp.asarray(scale),
                             jnp.asarray(shift), p)
    zt = packed_eltwise.bn_relu_plain(ty, torch.from_numpy(scale),
                                      torch.from_numpy(shift))
    assert zt.dtype == ty.dtype
    _close(zt, zj.reshape(shape), dtype_name)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_add_stats(dtype_name):
    B, H, W, c, p = 2, 8, 32, 32, 4
    rng = np.random.RandomState(7)
    a, b = _randn(rng, B, H, W, c), _randn(rng, B, H, W, c)
    ja, ta = _pair(a, dtype_name)
    jb, tb = _pair(b, dtype_name)
    view = (B, H, W // p, p * c)
    zj, s1j, s2j = jelt.add_stats_packed(ja.reshape(view), jb.reshape(view))
    zt, s1t, s2t = packed_eltwise.add_stats_plain(ta, tb)
    # one rounding of an exact f32 sum: equal bit for bit
    np.testing.assert_array_equal(_f32(zt), _f32(zj.reshape(B, H, W, c)))
    _close_sums(s1t, _fold(s1j, p), zt, 1, "float32")
    _close_sums(s2t, _fold(s2j, p), zt, 2, "float32")


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("tee", [False, True])
def test_maxpool(tee, dtype_name):
    B, H, W, c, p = 2, 8, 32, 32, 4
    rng = np.random.RandomState(11)
    x = _randn(rng, B, H, W, c)
    x[0, 0, 0, :4] = x[0, 0, 1, :4]  # ties
    jx, tx = _pair(x, dtype_name)
    xp = jx.reshape(B, H, W // p, p * c)
    yt = pool_pack.maxpool2x2(tx)
    if tee:  # the forward of the tee: (its input, the pool)
        sj, yj = jpool.maxpool2x2_packed_tee(xp, c)
        np.testing.assert_array_equal(_f32(tx), _f32(sj.reshape(B, H, W, c)))
    else:
        yj = jpool.maxpool2x2_packed(xp, c)
    np.testing.assert_array_equal(_f32(yt), _f32(yj.reshape(B, H // 2, W // 2, c)))
    np.testing.assert_array_equal(
        _f32(yt), _f32(torch.nn.functional.max_pool2d(
            tx.float().permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,W,cin,cout,p", [
    (2, 4, 16, 64, 32, 4),    # into the 32-channel level (p_out = 4)
    (1, 4, 8, 128, 64, 4),    # into the 64-channel level
])
def test_upconv(B, H, W, cin, cout, p, dtype_name):
    rng = np.random.RandomState(cin)
    x = _randn(rng, B, H, W, cin)
    k = _randn(rng, 2, 2, cin, cout, scale=cin ** -0.5)  # flax ConvTranspose
    bias = _randn(rng, cout)
    jx, tx = _pair(x, dtype_name)
    jd = DTYPES[dtype_name][0]
    g_in, lanes_in = W // p, p * cin
    p_in, g_out, lanes_out = jup.geometry(H, g_in, lanes_in, cin, cout, p)
    wp = jup.pack_up_weights(jnp.flip(jnp.asarray(k).astype(jd), (0, 1)), p_in)
    yj = jup.upconv2x2_packed(jx.reshape(B, H, g_in, lanes_in), wp,
                              jnp.tile(jnp.asarray(bias), 2 * p_in),
                              (g_out, lanes_out))
    # the port's ConvTranspose2d weight, as interop maps the flax kernel
    wt = torch.from_numpy(np.ascontiguousarray(k[::-1, ::-1].transpose(2, 3, 0, 1)))
    yt = upconv_pack.upconv2x2_plain(tx, wt, torch.from_numpy(bias))
    _close(yt, yj.reshape(B, 2 * H, 2 * W, cout), dtype_name)
    # the function is torch's transposed conv with one rounding at the end
    ref = torch.nn.functional.conv_transpose2d(
        tx.float().permute(0, 3, 1, 2), wt.to(tx.dtype).float(),
        torch.from_numpy(bias), stride=2).to(tx.dtype).permute(0, 2, 3, 1)
    _close(yt, ref, dtype_name)


# ---------------------------------------------------------------------------
# The whole packed UNet
# ---------------------------------------------------------------------------

NUM_CLASSES, BASE = 3, 32


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _perturbed_variables(depth, rng):
    # the flax tree from the port's seeded init (flax's own init compiles
    # for ~20 s on the CPU); BN scale, shift and running stats drawn at
    # random so neither mode is near the identity
    seeded = UNet(NUM_CLASSES, BASE, depth)
    init_weights(seeded, torch.Generator().manual_seed(depth))
    variables = _tree_map(np.array, export_jax_variables(seeded))

    def perturb(tree, kind):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v, kind)
            elif kind == "stats":
                tree[k] = (rng.rand(*v.shape).astype(np.float32) + 0.5
                           if k == "var" else
                           rng.randn(*v.shape).astype(np.float32) * 0.1)
            elif k in ("scale", "bias"):
                tree[k] = (v + rng.randn(*v.shape) * 0.1).astype(np.float32)

    perturb(variables["params"], "params")
    perturb(variables["batch_stats"], "stats")
    return variables


@pytest.fixture(scope="module", params=[(64, 2, 2), (128, 4, 3)],
                ids=["64px-depth2", "128px-depth4"])
def packed_case(request):
    """(x, variables, JAX eval logits, JAX train logits, JAX batch_stats),
    each JAX output computed once, under ``jax.jit`` as ``cl_tpu``'s steps
    run it (in interpret mode the jitted apply takes about half the time of
    the op-by-op one)."""
    size, depth, prefix = request.param
    assert junet.packed_prefix(size, BASE, depth, 4) == prefix
    rng = np.random.RandomState(size)
    x = rng.randn(2, size, size, 3).astype(np.float32)
    variables = _perturbed_variables(depth, rng)
    jm = junet.UNet(num_classes=NUM_CLASSES, base_channels=BASE, depth=depth,
                    packed=True)
    ev = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(x)))
    tr, state = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    stats = dict(jax.tree_util.tree_leaves_with_path(state["batch_stats"]))
    return {"x": x, "depth": depth, "prefix": prefix, "variables": variables,
            "eval": ev, "train": np.asarray(tr), "stats": stats}


def _port(case):
    pm = UNet(NUM_CLASSES, BASE, case["depth"], packed=True).to(
        memory_format=torch.channels_last)
    load_jax_variables(pm, case["variables"])
    assert pm.packed_levels(*case["x"].shape[1:3]) == case["prefix"]
    return pm


def test_packed_unet_eval_logits(packed_case):
    pm = _port(packed_case).eval()
    with torch.no_grad():
        lt = pm(torch.from_numpy(packed_case["x"])).numpy()
    assert lt.shape == packed_case["eval"].shape
    np.testing.assert_allclose(lt, packed_case["eval"], rtol=1e-4, atol=1e-4)


def test_packed_unet_train_logits_and_batch_stats(packed_case):
    pm = _port(packed_case).train()
    with torch.no_grad():
        lt = pm(torch.from_numpy(packed_case["x"])).numpy()
    np.testing.assert_allclose(lt, packed_case["train"], rtol=1e-4, atol=1e-4)
    got = dict(jax.tree_util.tree_leaves_with_path(
        export_jax_variables(pm)["batch_stats"]))
    want = packed_case["stats"]
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_allclose(got[path], np.asarray(leaf), rtol=1e-5,
                                   atol=1e-5)


def test_packed_and_standard_bodies_differ_only_in_arithmetic(packed_case):
    """The same weights through the standard body: the same function up to
    the packed body's rounding and stats order (f32: close)."""
    pm = _port(packed_case).eval()
    sm = UNet(NUM_CLASSES, BASE, packed_case["depth"]).to(
        memory_format=torch.channels_last)
    sm.load_state_dict(pm.state_dict())
    sm.eval()
    x = torch.from_numpy(packed_case["x"])
    with torch.no_grad():
        np.testing.assert_allclose(pm(x).numpy(), sm(x).numpy(), rtol=1e-4,
                                   atol=1e-4)
