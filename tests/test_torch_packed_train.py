"""The port's packed-body backward against ``cl_tpu``'s, on the CPU.

Per module, each plain backward (``cl_tpu_torch.kernels.*``, what the
autograd Functions run on a CPU tensor) is held against ``jax.vjp`` of its
Pallas function, run in interpret mode as the JAX package's own tests run
it, on the same numpy inputs and cotangents, nonzero stats cotangents
included; ``cl_tpu``'s per-lane cotangents are folded over p to channels.
Tolerances:

- values the two compute with the same f32 operations and one rounding
  (the pool's routing, the BN·ReLU backward): bit for bit; dy_eff, which
  XLA's CPU backend contracts into an FMA: f32 1e-5, bf16 one ulp;
- dx of the convs: f32 1e-5, bf16 one ulp plus the f32 floor (an f32 sum
  in another order may round to the other neighbour);
- sums over pixels (dW, db, dscale, dshift, da, db): 1e-5 of Σ|term| (the
  same f32 terms summed in another order), plus in bf16 one ulp of the
  dW each rounds to once, and for the up-conv's bf16 dW and db what the
  JAX package's extra bf16 roundings add (see ``test_upconv_backward``).

Then one packed SGD train step from the same variables and batch against
``cl_tpu.train.make_train_step`` for ``train.fused_head_ce=false`` and for
``train.packed_head_ce=false``: loss, every param and batch stat within
1e-4. Each JAX output is computed once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_tpu import train as jax_train
from cl_tpu.config import parse_overrides as jax_parse
from cl_tpu.data import pipeline as jax_pipeline
from cl_tpu.data import tasks as jax_tasks
from cl_tpu.pallas import conv3x3_v3 as jconv
from cl_tpu.pallas import packed_eltwise as jelt
from cl_tpu.pallas import pool_pack as jpool
from cl_tpu.pallas import upconv_pack as jup
from cl_tpu_torch import train as port_train
from cl_tpu_torch.config import parse_overrides
from cl_tpu_torch.data import pipeline
from cl_tpu_torch.interop import export_jax_variables
from cl_tpu_torch.kernels import conv3x3, packed_eltwise, pool_pack, upconv_pack
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _randn(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _pair(arr, dtype_name):
    jd, td = DTYPES[dtype_name]
    return jnp.asarray(arr).astype(jd), torch.from_numpy(arr).to(td)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_ulp(x):
    mag = np.maximum(np.abs(x), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _fold(v_l, p):
    return np.asarray(v_l).reshape(p, -1).sum(0)


def _exact(got, want):
    np.testing.assert_array_equal(_f32(got), _f32(want))


def _close_rounded(got, want, dtype_name, scale=1.0):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    if dtype_name == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    else:
        tol = _bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + 1e-5 * scale
        assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


def _close_sum(got, want, terms, ulps=0.0, rel=1e-5):
    """A sum over pixels: ``rel`` of Σ|term| (+ ``ulps`` bf16 ulps of a
    value rounded to bf16)."""
    got, want, terms = _f32(got), _f32(want), np.asarray(terms, np.float32)
    assert got.shape == want.shape == terms.shape
    tol = rel * terms + 1e-6 + ulps * _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


# ---------------------------------------------------------------------------
# Conv (#34, #35, #36) against jax.vjp of conv_bn_fused
# ---------------------------------------------------------------------------

B, H, W, P = 2, 8, 32, 4  # border-heavy: 8 rows, 2 of them border


@pytest.fixture(scope="module", params=[
    (cin, cout, prologue, dt) for cin, cout in ((32, 32), (32, 64))
    for prologue in (False, True) for dt in ("float32", "bfloat16")],
    ids=lambda v: f"{v[0]}-{v[1]}-{'prologue' if v[2] else 'slim'}-{v[3]}")
def conv_case(request):
    cin, cout, prologue, dtype_name = request.param
    rng = np.random.RandomState(cin + cout + prologue)
    x = _randn(rng, B, H, W, cin)
    w = _randn(rng, 3, 3, cin, cout, scale=(9 * cin) ** -0.5)  # flax layout
    a = (rng.rand(cin) + 0.5).astype(np.float32)
    b = (rng.rand(cin) * 0.5 + 0.25).astype(np.float32)  # relu(b) > 0
    dy = _randn(rng, B, H, W, cout)
    ds1, ds2 = _randn(rng, cout, scale=0.5), _randn(rng, cout, scale=0.2)
    jd, td = DTYPES[dtype_name]
    itemsize = 4 if dtype_name == "float32" else 2
    wg = W // P
    # cl_tpu takes its fused backward (the branch the port follows) here
    assert jconv._pick_th_dx(H, wg, P * cout, (P + 2) * cout, P * cin, itemsize, prologue) > 0
    assert jconv._pick_th_dw2(H, wg, P * cin, (P + 2) * cin, P, cout, itemsize) > 0
    jx = jnp.asarray(x).astype(jd).reshape(B, H, W // P, P * cin)
    fn = lambda xp, k, al, bl: jconv.conv_bn_fused(xp, k, al, bl, P, prologue)  # noqa: E731
    (yj, _, _), vjp = jax.vjp(fn, jx, jnp.asarray(w).astype(jd), jnp.tile(jnp.asarray(a), P),
                              jnp.tile(jnp.asarray(b), P))
    dyj = jnp.asarray(dy).astype(jd).reshape(yj.shape)
    dxj, dwj, daj, dbj = vjp((dyj, jnp.tile(jnp.asarray(ds1), P), jnp.tile(jnp.asarray(ds2), P)))
    # the port's operands: its own y is the JAX y (same values, bit for bit
    # or within an ulp: the forward is held apart, test_torch_packed.py)
    tx = torch.from_numpy(x).to(td)
    args = (tx, torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), torch.from_numpy(a),
            torch.from_numpy(b), torch.from_numpy(_f32(yj).reshape(B, H, W, cout).copy()).to(td),
            torch.from_numpy(dy).to(td), torch.from_numpy(ds1), torch.from_numpy(ds2), prologue)
    return {"args": args, "dtype": dtype_name, "a": a, "p": P, "jax": {
        "dx": dxj.reshape(B, H, W, cin), "dw": _f32(dwj).transpose(3, 2, 0, 1),
        "da": _fold(daj, P), "db": _fold(dbj, P)}}


def test_conv_dx(conv_case):
    dx, _, _ = conv3x3.conv_dx_plain(*conv_case["args"])
    _close_rounded(dx, conv_case["jax"]["dx"], conv_case["dtype"],
              scale=max(1.0, float(conv_case["a"].max())))


def test_conv_dw(conv_case):
    x, w, a, b, y, dy, ds1, ds2, prologue = conv_case["args"]
    dw = conv3x3.conv_dw_plain(*conv_case["args"])
    terms = conv3x3.conv_dw_plain(conv3x3.prologue_t(x, a, b, prologue).float().abs(), w, None, None,
                                  y, conv3x3.dy_eff(dy, y, ds1, ds2).float().abs(), None, None,
                                  False)
    _close_sum(dw, conv_case["jax"]["dw"], terms,
               ulps=1.0 if conv_case["dtype"] == "bfloat16" else 0.0)


def test_conv_prologue_grads(conv_case):
    x, w, a, b, y, dy, ds1, ds2, prologue = conv_case["args"]
    _, da, db = conv3x3.conv_dx_plain(*conv_case["args"])
    if not prologue:
        assert da is None and db is None
        np.testing.assert_array_equal(conv_case["jax"]["da"], 0.0)
        return
    dt, _, _ = conv3x3.conv_dx_plain(x.float(), w, None, None, y.float(), dy.float(), ds1, ds2,
                                     False)
    du = torch.where(x.float() * a + b > 0, dt.abs(), 0.0).reshape(-1, x.shape[-1])
    _close_sum(da, conv_case["jax"]["da"], (du * x.float().abs().reshape(du.shape)).sum(0))
    _close_sum(db, conv_case["jax"]["db"], du.sum(0))


def test_conv_stem_dw():
    """cl_tpu pads the RGB stem to 128/p channels and drops the padded rows
    of dW; the port's dW has Cin = 3."""
    rng = np.random.RandomState(5)
    cout, c_pad = 32, 128 // P
    x = _randn(rng, B, H, W, 3)
    k0 = _randn(rng, 3, 3, 3, cout, scale=27 ** -0.5)
    dy = _randn(rng, B, H, W, cout)
    ds1, ds2 = _randn(rng, cout, scale=0.5), _randn(rng, cout, scale=0.2)
    xp = jnp.asarray(np.pad(x, ((0, 0), (0, 0), (0, 0), (0, c_pad - 3)))).reshape(
        B, H, W // P, P * c_pad)
    ones = jnp.ones((P * c_pad,), jnp.float32)

    def stem(k):
        kp = jnp.pad(k, ((0, 0), (0, 0), (0, c_pad - 3), (0, 0)))
        return jconv.conv_bn_fused(xp, kp, ones, ones * 0, P, False)

    (yj, _, _), vjp = jax.vjp(stem, jnp.asarray(k0))
    (dkj,) = vjp((jnp.asarray(dy).reshape(yj.shape), jnp.tile(jnp.asarray(ds1), P),
                  jnp.tile(jnp.asarray(ds2), P)))
    tx, w = torch.from_numpy(x), torch.from_numpy(k0.transpose(3, 2, 0, 1).copy())
    args = (tx, w, None, None, torch.from_numpy(_f32(yj).reshape(B, H, W, cout).copy()),
            torch.from_numpy(dy), torch.from_numpy(ds1), torch.from_numpy(ds2), False)
    e = conv3x3.dy_eff(*args[4:8])
    terms = conv3x3.conv_dw_plain(tx.abs(), w, None, None, args[4], e.abs(), None, None, False)
    _close_sum(conv3x3.conv_dw_plain(*args), _f32(dkj).transpose(3, 2, 0, 1), terms)


def test_conv_dx_pads_zero_in_e_space():
    """e is zero outside the image: a padded tap adds 0, not ds1, however
    large ds1 is (conv3x3_v3.py:1069-1070)."""
    x = torch.zeros(1, 4, 4, 1)
    w = torch.ones(1, 1, 3, 3)
    y = torch.zeros(1, 4, 4, 1)
    dy = torch.zeros(1, 4, 4, 1)
    dx, _, _ = conv3x3.conv_dx_plain(x, w, None, None, y, dy, torch.full((1,), 100.0),
                                     torch.zeros(1), False)
    assert dx[0, 0, 0, 0].item() == 400.0 and dx[0, 0, 1, 0].item() == 600.0
    assert dx[0, 1, 1, 0].item() == 900.0
    # and the same through the autograd Function, stats cotangent only
    xg = x.clone().requires_grad_(True)
    _, s1, _ = conv3x3.conv_bn_fused(xg, w)
    (100.0 * s1.sum()).backward()
    torch.testing.assert_close(xg.grad, dx, rtol=0, atol=0)


def test_conv_backward_skips_dx_without_input_grad():
    """The stem: the image needs no gradient, so no dx is formed (JAX drops
    it as dead code); the weight still gets its dW."""
    x = torch.randn(1, 4, 4, 3)
    w = torch.randn(8, 3, 3, 3, requires_grad=True)
    y, s1, _ = conv3x3.conv_bn_fused(x, w)
    (y.sum() + s1.sum()).backward()
    assert x.grad is None and w.grad is not None and torch.isfinite(w.grad).all()


# ---------------------------------------------------------------------------
# Eltwise (#24, #26) against jax.vjp of bn_relu_packed / add_stats_packed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,p", [((2, 8, 32, 32), 4), ((1, 8, 16, 64), 2)])
def test_bn_relu_backward(shape, p, dtype_name):
    rng = np.random.RandomState(p + 10)
    y, dz = _randn(rng, *shape), _randn(rng, *shape)
    c = shape[-1]
    scale, shift = _randn(rng, c), _randn(rng, c)
    jy, ty = _pair(y, dtype_name)
    jdz, tdz = _pair(dz, dtype_name)
    view = (shape[0], shape[1], shape[2] // p, p * c)
    _, vjp = jax.vjp(lambda v, s, b: jelt.bn_relu_packed(v, s, b, p), jy.reshape(view),
                     jnp.asarray(scale), jnp.asarray(shift))
    dyj, dsj, dbj = vjp(jdz.reshape(view))
    dy, ds, db = packed_eltwise.bn_relu_bwd_plain(ty, tdz, torch.from_numpy(scale),
                                                  torch.from_numpy(shift))
    assert dy.dtype == ty.dtype
    _exact(dy, dyj.reshape(shape))
    mask = (ty.float() * torch.from_numpy(scale) + torch.from_numpy(shift) > 0).float()
    du = (mask * tdz.float().abs()).reshape(-1, c)
    _close_sum(ds, dsj, (du * ty.float().abs().reshape(-1, c)).sum(0))
    _close_sum(db, dbj, du.sum(0))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_add_stats_backward(dtype_name):
    Bs, Hs, Ws, c, p = 2, 8, 32, 32, 4
    rng = np.random.RandomState(17)
    a, b, dz = (_randn(rng, Bs, Hs, Ws, c) for _ in range(3))
    ds1, ds2 = _randn(rng, c, scale=0.5), _randn(rng, c, scale=0.2)
    ja, ta = _pair(a, dtype_name)
    jb, tb = _pair(b, dtype_name)
    jdz, tdz = _pair(dz, dtype_name)
    view = (Bs, Hs, Ws // p, p * c)
    (zj, _, _), vjp = jax.vjp(jelt.add_stats_packed, ja.reshape(view), jb.reshape(view))
    daj, dbj = vjp((jdz.reshape(view), jnp.tile(jnp.asarray(ds1), p),
                    jnp.tile(jnp.asarray(ds2), p)))
    z, _, _ = packed_eltwise.add_stats_plain(ta, tb)
    e = packed_eltwise.dy_eff_plain(tdz, z, torch.from_numpy(ds1), torch.from_numpy(ds2))
    assert e.dtype == ta.dtype
    # XLA's CPU backend contracts 2·z·ds2 + (dz + ds1) into an FMA; the port
    # rounds the product first, as the card kernel does (bit for bit with
    # this plain version there): one f32 ulp apart before the rounding
    _close_rounded(e, daj.reshape(e.shape), dtype_name)
    _exact(daj, dbj)


# ---------------------------------------------------------------------------
# Pool (#22) against jax.vjp of maxpool2x2_packed(_tee)
# ---------------------------------------------------------------------------


def _tied(rng, Bs, Hs, Ws, c):
    x = _randn(rng, Bs, Hs, Ws, c)
    x[:, 1::2, ::3] = x[:, 0::2, ::3]  # the window's rows tie
    x[:, ::4, 1::2] = x[:, ::4, 0::2]  # its columns tie
    return x


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("tee", [False, True])
def test_maxpool_backward(tee, dtype_name):
    Bs, Hs, Ws, c, p = 2, 8, 32, 32, 4
    rng = np.random.RandomState(19)
    x = _tied(rng, Bs, Hs, Ws, c)
    dy, ds = _randn(rng, Bs, Hs // 2, Ws // 2, c), _randn(rng, Bs, Hs, Ws, c)
    jx, tx = _pair(x, dtype_name)
    jdy, tdy = _pair(dy, dtype_name)
    jds, tds = _pair(ds, dtype_name)
    xp = jx.reshape(Bs, Hs, Ws // p, p * c)
    pooled = (Bs, Hs // 2, Ws // (2 * p), p * c)
    if tee:
        _, vjp = jax.vjp(lambda v: jpool.maxpool2x2_packed_tee(v, c), xp)
        (dxj,) = vjp((jds.reshape(xp.shape), jdy.reshape(pooled)))
        dx = pool_pack.maxpool2x2_bwd_plain(tx, tdy, tds)
    else:
        _, vjp = jax.vjp(lambda v: jpool.maxpool2x2_packed(v, c), xp)
        (dxj,) = vjp(jdy.reshape(pooled))
        dx = pool_pack.maxpool2x2_bwd_plain(tx, tdy)
    assert dx.dtype == tx.dtype
    _exact(dx, dxj.reshape(Bs, Hs, Ws, c))


def test_maxpool_tie_rule():
    """The top row wins if max(row 0) >= max(row 1); in the row, the first
    column wins if it is >= the second (pool_pack.py:181-192)."""
    x = torch.tensor([[1.0, 1.0], [1.0, 1.0]]).reshape(1, 2, 2, 1)
    dy = torch.full((1, 1, 1, 1), 3.0)
    assert pool_pack.maxpool2x2_bwd_plain(x, dy).flatten().tolist() == [3.0, 0.0, 0.0, 0.0]
    x = torch.tensor([[0.0, 5.0], [5.0, 5.0]]).reshape(1, 2, 2, 1)
    assert pool_pack.maxpool2x2_bwd_plain(x, dy).flatten().tolist() == [0.0, 3.0, 0.0, 0.0]
    x = torch.tensor([[0.0, 4.0], [5.0, 5.0]]).reshape(1, 2, 2, 1)
    assert pool_pack.maxpool2x2_bwd_plain(x, dy).flatten().tolist() == [0.0, 0.0, 3.0, 0.0]


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_maxpool_tee_equals_pool_plus_skip(dtype_name):
    """The tee's one backward launch gives the same bits as the pool's dx
    plus the skip cotangent added by autograd, and is called once."""
    rng = np.random.RandomState(23)
    x = _tied(rng, 2, 8, 16, 16)
    dt = DTYPES[dtype_name][1]
    dy = torch.from_numpy(_randn(rng, 2, 4, 8, 16)).to(dt)
    ds = torch.from_numpy(_randn(rng, 2, 8, 16, 16)).to(dt)
    grads, launches = [], []
    for tee in (True, False):
        xt = torch.from_numpy(x).to(dt).requires_grad_(True)
        if tee:
            skip, pooled = pool_pack.maxpool2x2_tee(xt)
        else:
            skip, pooled = xt, pool_pack.maxpool2x2(xt)
        n = [0]
        pooled.grad_fn.register_hook(lambda *_: n.__setitem__(0, n[0] + 1))
        torch.autograd.backward([skip, pooled], [ds, dy])
        grads.append(xt.grad)
        launches.append(n[0])
    _exact(grads[0], grads[1])
    assert launches == [1, 1]


# ---------------------------------------------------------------------------
# Up-conv (#28, #29) against jax.vjp of upconv2x2_packed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bs,Hs,Ws,cin,cout,p", [
    (2, 4, 16, 64, 32, 4),    # into the 32-channel level (p_out = 4)
    (1, 4, 8, 128, 64, 4),    # into the 64-channel level
])
def test_upconv_backward(Bs, Hs, Ws, cin, cout, p, dtype_name):
    """dW: the JAX package rounds each of its p_in packed blocks (the
    pixels of one column phase w mod p_in) to bf16 and sums them in bf16
    (upconv_pack.py:219 and ``pack_up_weights``' VJP), the port sums in f32
    and rounds once: at most 2^-8 (bf16's unit roundoff) of each block and
    of each partial sum, 2^-7 of Σ|block| in all, and one ulp of the
    result, apart. db: the JAX package rounds each
    tile's sum to bf16 (:132): within 2^-8 of Σ|dy| apart."""
    rng = np.random.RandomState(cin + 1)
    x = _randn(rng, Bs, Hs, Ws, cin)
    k = _randn(rng, 2, 2, cin, cout, scale=cin ** -0.5)  # flax ConvTranspose
    bias = _randn(rng, cout)
    dy = _randn(rng, Bs, 2 * Hs, 2 * Ws, cout)
    jx, tx = _pair(x, dtype_name)
    jdy, tdy = _pair(dy, dtype_name)
    jd = DTYPES[dtype_name][0]
    g_in, lanes_in = Ws // p, p * cin
    p_in, g_out, lanes_out = jup.geometry(Hs, g_in, lanes_in, cin, cout, p)

    def up(xp, kern, bb):
        wp = jup.pack_up_weights(jnp.flip(kern.astype(jd), (0, 1)), p_in)
        return jup.upconv2x2_packed(xp, wp, jnp.tile(bb, 2 * p_in), (g_out, lanes_out))

    yj, vjp = jax.vjp(up, jx.reshape(Bs, Hs, g_in, lanes_in), jnp.asarray(k), jnp.asarray(bias))
    dxj, dkj, dbj = vjp(jdy.reshape(yj.shape))
    # the port's ConvTranspose2d weight, as interop maps the flax kernel
    wt = torch.from_numpy(np.ascontiguousarray(k[::-1, ::-1].transpose(2, 3, 0, 1)))
    dwj = np.ascontiguousarray(_f32(dkj)[::-1, ::-1].transpose(2, 3, 0, 1))
    dx = upconv_pack.upconv2x2_dx_plain(tdy, wt)
    dw, db = upconv_pack.upconv2x2_dw_plain(tx, tdy)
    _close_rounded(dx, dxj.reshape(Bs, Hs, Ws, cin), dtype_name)
    terms_w, terms_b = upconv_pack.upconv2x2_dw_plain(tx.float().abs(), tdy.float().abs())
    bf16 = dtype_name == "bfloat16"
    if bf16:
        blocks = sum(upconv_pack.upconv2x2_dw_plain(
            tx[:, :, d::p_in].float(), tdy.reshape(Bs, 2 * Hs, Ws // p_in, 2 * p_in, cout)[
                :, :, :, 2 * d:2 * d + 2].reshape(Bs, 2 * Hs, -1, cout).float())[0].abs()
            for d in range(p_in))
        terms_w = terms_w + blocks * (2.0 ** -7 / 1e-5)
    _close_sum(dw, dwj, terms_w, ulps=1.0 if bf16 else 0.0)
    _close_sum(db, dbj, terms_b, rel=2.0 ** -8 if bf16 else 1e-5)


# ---------------------------------------------------------------------------
# The autograd graph of the packed body
# ---------------------------------------------------------------------------


def test_packed_backward_runs_every_kernel_once_per_use():
    """One backward through the packed UNet (64², base 32, depth 2, prefix
    2) reaches each packed op's backward, and the tee once per level."""
    from cl_tpu_torch.models.unet import UNet, init_weights

    model = UNet(3, 32, 2, packed=True).to(memory_format=torch.channels_last)
    init_weights(model, torch.Generator().manual_seed(0))
    assert model.packed_levels(64, 64) == 2
    names = ("_ConvBN", "_BnRelu", "_AddStats", "_MaxPoolTee", "_UpConv")
    calls, done = {}, {}
    logits = model.train()(torch.randn(2, 64, 64, 3))
    seen, stack = set(), [logits.grad_fn]
    while stack:  # every node of the graph once
        fn = stack.pop()
        if fn is None or id(fn) in seen:
            continue
        seen.add(id(fn))
        name = type(fn).__name__.removesuffix("Backward")
        if name in names:
            calls[name] = calls.get(name, 0) + 1
            fn.register_hook(lambda *_, n=name: done.__setitem__(n, done.get(n, 0) + 1))
        stack.extend(nxt for nxt, _ in fn.next_functions)
    logits.square().mean().backward()
    # per packed level: 2 encoder convs, 3 decoder convs (the split pair)
    assert calls == {"_ConvBN": 10, "_BnRelu": 4, "_AddStats": 2, "_MaxPoolTee": 2,
                     "_UpConv": 2}, calls
    assert done == calls
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())


# ---------------------------------------------------------------------------
# One packed train step against cl_tpu's
# ---------------------------------------------------------------------------

ARGS = ["preset=smoke", "data.num_classes=3", "model.base_channels=32", "model.depth=2",
        "data.image_size=64", "data.source_size=80", "model.packed_min_size=0",
        "train.optimizer=sgd", "train.lr=0.05", "train.data_parallel=false"]
CPU = torch.device("cpu")


@pytest.fixture(scope="module", params=["train.fused_head_ce=false",
                                        "train.packed_head_ce=false"])
def packed_step(request):
    """The port's and cl_tpu's state after one SGD step from the same
    variables and batch, each computed once."""
    args = ARGS + [request.param]
    cfg, jcfg = parse_overrides(args), jax_parse(args)
    model = port_train.init_state(cfg, port_train.build_model(cfg), CPU)
    assert model.packed_levels(64, 64) == 2 and cfg.model.pool_tee
    variables = export_jax_variables(model)
    step = port_train.make_train_step(cfg, model, port_train.build_optimizer(cfg, model), CPU)

    jmodel = jax_train.build_model(jcfg)
    assert jmodel.packed and jmodel.pool_tee
    tx = jax_train.build_optimizer(jcfg)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = jax_train.TrainState(
        step=jnp.int32(0), params=params,
        model_state={"batch_stats": jax.tree.map(jnp.asarray, variables["batch_stats"])},
        opt_state=tx.init(params), ewc=None, lwf=None, rng=jax.random.PRNGKey(0))
    jstep = jax_train.make_train_step(jcfg, jmodel, tx, mesh=None)

    hb = next(iter(pipeline.train_batches(cfg, 0, 0)))
    valid = jax_tasks.valid_class_mask(3, jax_tasks.seen_classes(jcfg.classes_per_task, 0))
    aux = step(pipeline.put_batch(hb, CPU), torch.from_numpy(valid))
    state, jaux = jstep(state, jax_pipeline.HostBatch(*(jnp.asarray(a) for a in hb)),
                        jnp.asarray(valid))
    return {"loss": (aux["loss"].item(), float(jaux["loss"])),
            "n_pix": (float(aux["n_pix"]), float(jaux["n_pix"])),
            "before": dict(jax.tree_util.tree_leaves_with_path(variables)),
            "got": dict(jax.tree_util.tree_leaves_with_path(export_jax_variables(model))),
            "want": jax.tree_util.tree_leaves_with_path(
                {"params": state.params, **state.model_state})}


def test_packed_train_step_loss(packed_step):
    got, want = packed_step["loss"]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert packed_step["n_pix"][0] == packed_step["n_pix"][1]


def test_packed_train_step_params_and_batch_stats(packed_step):
    got, want = packed_step["got"], packed_step["want"]
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_allclose(got[path], np.asarray(leaf), rtol=1e-4, atol=1e-4,
                                   err_msg=str(path))


def test_packed_train_step_updates(packed_step):
    """The step's update of every leaf, (after - before), within 1e-2 of
    that update's norm plus one f32 ulp of the leaf per element: a wrong
    backward in one op moves the update of the leaves it feeds by far
    more, though it may hide under 1e-4 on the params themselves (a 1%
    error in dy_eff's 2·z·ds2 term fails here and passes there). Between
    two right f32 steps the updates differ by up to 4.3e-3 of their norm
    here, in the deep region's BatchNorm leaves, where the BN backward's
    mean subtraction cancels; the ulp covers a BN scale near 1.0 whose
    update is smaller than its ulp (at 128², depth 4)."""
    before, got = packed_step["before"], packed_step["got"]
    for path, leaf in packed_step["want"]:
        want = np.asarray(leaf, np.float64)
        want_d = want - before[path]
        got_d = np.asarray(got[path], np.float64) - before[path]
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 23)
        norm = np.linalg.norm(want_d)
        assert norm > 0, f"{path}: the step left it unchanged"
        assert np.linalg.norm(got_d - want_d) <= 1e-2 * norm + np.linalg.norm(ulp), (
            path, np.linalg.norm(got_d - want_d) / norm)
