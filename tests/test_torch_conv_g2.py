"""The port's gen-2 conv routes (``model.conv_impl=pallas|hybrid``) and the
matmul up-conv (``model.upconv_impl=matmul``) against ``cl_tpu``'s, on the
CPU.

- The gate: ``packed_gate.g2_supported`` equals
  ``cl_tpu.pallas.conv3x3.supported`` over a grid of shapes, at both
  itemsizes.
- #40 / #41: the gen-2 conv and its VJP (``conv3x3_g2.conv3x3_g2``: dx is
  #40 on dy with the flipped, channel-swapped weight, dW #41 rounded once
  to the compute dtype) against ``jax.vjp`` of
  ``cl_tpu.pallas.conv3x3.conv3x3`` in interpret mode, at
  ``tests/unit/test_pallas_conv.py``'s shapes (P = 4, 2, 1 at Cin 128, the
  6 × 16 odd-row case, 32² × 16 → 16 at P = 8). Tolerances, as #30/#31's:
  y and dx f32 1e-5 of Σ|term|, bf16 one ulp plus that f32 floor; dW 1e-5
  of Σ|term| plus, in bf16, one ulp of the value it rounds to once.
- ``conv3x3_hybrid``: cuDNN's forward and dx, #41 for dW where the gate
  admits the shape, cuDNN's dW in the compute dtype elsewhere (the stem),
  against ``jax.vjp`` of ``conv3x3_hybrid``.
- ``upconv2x2_matmul`` against ``cl_tpu.models.unet.UpConv2x2`` on the same
  variables (carried by ``interop``), forward and VJP, f32 (1e-5) and bf16
  (one ulp plus the f32 floor), and against the port's
  ``F.conv_transpose2d`` route in f32.
- One SGD step of a 64², base 32, depth 2 UNet under ``conv_impl=pallas``
  and under ``=hybrid`` against ``cl_tpu.train.make_train_step``: loss,
  params and batch stats within 1e-4, each leaf's update within 1e-2 of its
  norm plus one f32 ulp.
- Route parity: which conv takes which route, and every launch of #40 (as
  a forward and as a dx) and #41 by shape, against ``cl_tpu``'s
  ``jax.eval_shape`` trace of a train-mode gradient, the port on the
  ``meta`` device: baselines 1 and 2 under pallas and hybrid, f32 and bf16,
  and baseline_3 (the packed body) under pallas, where nothing is launched.
- ``cl_tpu``'s tuning variables: ``check_supported`` accepts all five at
  their defaults.
"""

import collections
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax.linen import module as flax_module

from cl_tpu import train as jax_train
from cl_tpu.config import parse_overrides as jax_parse
from cl_tpu.data import pipeline as jax_pipeline
from cl_tpu.data import tasks as jax_tasks
from cl_tpu.models import unet as junet
from cl_tpu.pallas import conv3x3 as jconv
from cl_tpu_torch import train as port_train
from cl_tpu_torch.config import parse_overrides
from cl_tpu_torch.data import pipeline
from cl_tpu_torch.interop import export_jax_variables, variables_to_torch_state_dict
from cl_tpu_torch.kernels import conv3x3_g2
from cl_tpu_torch.kernels.conv3x3 import _flip_t
from cl_tpu_torch.models import packed_gate
from cl_tpu_torch.models import unet as port_unet
from cl_tpu_torch.models.unet import DoubleConv
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CPU = torch.device("cpu")


def _randn(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_ulp(x):
    mag = np.maximum(np.abs(x), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _close(got, want, terms, dtype_name, rel=1e-5):
    """|got − want| <= rel·Σ|term| + 1e-6 (+ one bf16 ulp in bf16)."""
    got, want, terms = _f32(got), _f32(want), _f32(terms)
    assert got.shape == want.shape == terms.shape
    tol = rel * terms + 1e-6
    if dtype_name == "bfloat16":
        tol = tol + _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


def _flax_kernel(w):
    """The port's [Cout, Cin, 3, 3] weight in flax's [3, 3, Cin, Cout]."""
    return np.ascontiguousarray(_f32(w).transpose(2, 3, 1, 0))


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("itemsize", [2, 4])
def test_g2_gate_matches_cl_tpu(itemsize):
    """``g2_supported`` is ``conv3x3.supported`` on every shape of a grid
    that covers each branch (the stem, odd rows, p = 16, the scratch
    limit at 1024 channels)."""
    grid = itertools.product([2, 6, 15, 16, 24, 64, 256, 512], [2, 8, 16, 32, 64, 512],
                             [3, 8, 16, 24, 64, 128, 512, 1024], [16, 32, 64, 128, 1024])
    for h, w, ci, co in grid:
        assert packed_gate.g2_supported(h, w, ci, co, itemsize) == \
            jconv.supported(h, w, ci, co, itemsize), (h, w, ci, co)


# ---------------------------------------------------------------------------
# #40 / #41: the gen-2 conv and its VJP against conv3x3.conv3x3
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [
    (2, 8, 8, 128, 32),     # P = 4
    (2, 8, 8, 128, 64),     # P = 2
    (2, 8, 8, 128, 128),    # P = 1
    (1, 6, 16, 16, 32),     # odd rows: one whole-image tile, P = 8
    (1, 32, 32, 16, 16),    # P = 8, four row tiles of 8
], ids=lambda s: "x".join(map(str, s)))
def test_conv3x3_g2_and_vjp(shape, dtype_name):
    b, h, w, ci, co = shape
    assert packed_gate.g2_supported(h, w, ci, co)
    rng = np.random.RandomState(ci + co + h)
    x = _randn(rng, b, h, w, ci)
    wt = _randn(rng, co, ci, 3, 3, scale=(9 * ci) ** -0.5)  # the port's f32 param
    dy = _randn(rng, b, h, w, co)
    jd, td = DTYPES[dtype_name]
    yj, vjp = jax.vjp(jconv.conv3x3, jnp.asarray(x).astype(jd),
                      jnp.asarray(_flax_kernel(wt)).astype(jd))
    dxj, dkj = vjp(jnp.asarray(dy).astype(jd))

    tx = torch.from_numpy(x).to(td).requires_grad_(True)
    tw = torch.from_numpy(wt).requires_grad_(True)
    y = conv3x3_g2.conv3x3_g2(tx, tw)
    y.backward(torch.from_numpy(dy).to(td))
    assert y.dtype == td and tx.grad.dtype == td and tw.grad.dtype == torch.float32

    xa, wa, dya = (torch.from_numpy(v).abs() for v in (x, wt, dy))
    _close(y, yj, conv3x3_g2.conv3x3_g2_plain(xa, wa), dtype_name)
    _close(tx.grad, dxj, conv3x3_g2.conv3x3_g2_plain(dya, _flip_t(wa)), dtype_name)
    _close(tw.grad, _f32(dkj).transpose(3, 2, 0, 1), conv3x3_g2.conv3x3_g2_dw_plain(xa, dya),
           dtype_name)
    # the plain versions are what the Function ran
    torch.testing.assert_close(y, conv3x3_g2.conv3x3_g2_plain(tx.detach(), tw.detach()),
                               rtol=0, atol=0)


def test_conv3x3_g2_dw_rounds_once_to_the_compute_dtype():
    """dW is summed in f32 and rounded once to bf16 (``.astype(w.dtype)``,
    conv3x3.py:345): the param's gradient is that bf16 value; no dx is
    computed for an input that needs none."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(_randn(rng, 1, 8, 32, 32)).bfloat16()
    w = torch.from_numpy(_randn(rng, 32, 32, 3, 3, scale=0.06)).requires_grad_(True)
    dy = torch.from_numpy(_randn(rng, 1, 8, 32, 32)).bfloat16()
    keys = []
    orig = conv3x3_g2._conv3x3_g2
    try:
        conv3x3_g2._conv3x3_g2 = lambda xx, ww, key: keys.append(key) or orig(xx, ww, key)
        conv3x3_g2.conv3x3_g2(x, w).backward(dy)
    finally:
        conv3x3_g2._conv3x3_g2 = orig
    assert keys == ["conv3x3_g2_fwd"]
    want = conv3x3_g2.conv3x3_g2_dw_plain(x, dy)
    assert want.dtype == torch.float32
    torch.testing.assert_close(w.grad, want.bfloat16().float(), rtol=0, atol=0)
    assert not torch.equal(want, want.bfloat16().float())


# ---------------------------------------------------------------------------
# conv3x3_hybrid: cuDNN forward and dx, #41 dW where the gate admits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 8, 16, 32, 64), (2, 16, 16, 3, 32)],
                         ids=["gen2_dw", "fallback"])
def test_conv3x3_hybrid_and_vjp(shape, dtype_name):
    b, h, w, ci, co = shape
    supported = packed_gate.g2_supported(h, w, ci, co)
    assert supported == (ci != 3) == jconv.dw_profitable(h, w, ci, co)
    rng = np.random.RandomState(7 + ci)
    x = _randn(rng, b, h, w, ci)
    wt = _randn(rng, co, ci, 3, 3, scale=(9 * ci) ** -0.5)
    dy = _randn(rng, b, h, w, co)
    jd, td = DTYPES[dtype_name]
    yj, vjp = jax.vjp(jconv.conv3x3_hybrid, jnp.asarray(x).astype(jd),
                      jnp.asarray(_flax_kernel(wt)).astype(jd))
    dxj, dkj = vjp(jnp.asarray(dy).astype(jd))

    dws = []
    orig = conv3x3_g2._conv3x3_g2_dw
    tx = torch.from_numpy(x).to(td).permute(0, 3, 1, 2).requires_grad_(True)  # channels_last
    tw = torch.from_numpy(wt).requires_grad_(True)
    try:
        conv3x3_g2._conv3x3_g2_dw = lambda *a: dws.append(1) or orig(*a)
        y = conv3x3_g2.conv3x3_hybrid(tx, tw)
        y.backward(torch.from_numpy(dy).to(td).permute(0, 3, 1, 2))
    finally:
        conv3x3_g2._conv3x3_g2_dw = orig
    assert dws == ([1] if supported else [])
    assert y.dtype == td and tx.grad.dtype == td and tw.grad.dtype == torch.float32

    xa, wa, dya = (torch.from_numpy(v).abs() for v in (x, wt, dy))
    nhwc = (lambda t: t.permute(0, 2, 3, 1))  # noqa: E731
    _close(nhwc(y), yj, conv3x3_g2.conv3x3_g2_plain(xa, wa), dtype_name)
    _close(nhwc(tx.grad), dxj, conv3x3_g2.conv3x3_g2_plain(dya, _flip_t(wa)), dtype_name)
    _close(tw.grad, _f32(dkj).transpose(3, 2, 0, 1), conv3x3_g2.conv3x3_g2_dw_plain(xa, dya),
           dtype_name)


# ---------------------------------------------------------------------------
# UpConv2x2: the matmul up-conv
# ---------------------------------------------------------------------------


def _upconv_case(dtype_name, seed=5):
    B, H, W, ci, co = 2, 8, 8, 64, 32
    rng = np.random.RandomState(seed)
    x = _randn(rng, B, H, W, ci)
    dy = _randn(rng, B, 2 * H, 2 * W, co)
    kernel = _randn(rng, 2, 2, ci, co, scale=ci ** -0.5)
    bias = _randn(rng, co, scale=0.5)
    sd = variables_to_torch_state_dict({"params": {"up0": {"kernel": kernel, "bias": bias}}})
    return x, dy, kernel, bias, torch.from_numpy(sd["up0.weight"]), torch.from_numpy(
        sd["up0.bias"])


def _port_upconv(x, dy, weight, bias, td, fn):
    tx = torch.from_numpy(x).to(td).permute(0, 3, 1, 2).requires_grad_(True)
    tw, tb = weight.clone().requires_grad_(True), bias.clone().requires_grad_(True)
    y = fn(tx, tw, tb)
    y.backward(torch.from_numpy(dy).to(td).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1), tx.grad.permute(0, 2, 3, 1), tw.grad, tb.grad


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_upconv2x2_matmul_matches_cl_tpu(dtype_name):
    """Forward and VJP (x, kernel, bias) against ``cl_tpu``'s UpConv2x2 on
    the same variables, carried by the interop mapping (its kernel flip)."""
    x, dy, kernel, bias, weight, tbias = _upconv_case(dtype_name)
    jd, td = DTYPES[dtype_name]
    mod = junet.UpConv2x2(kernel.shape[-1], dtype=jd)
    params = {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}
    yj, vjp = jax.vjp(lambda xx, pp: mod.apply({"params": pp}, xx),
                      jnp.asarray(x).astype(jd), params)
    dxj, dpj = vjp(jnp.asarray(dy).astype(jd))
    y, dx, dw, db = _port_upconv(x, dy, weight, tbias, td, port_unet.upconv2x2_matmul)
    assert y.dtype == td and dx.dtype == td and dw.dtype == db.dtype == torch.float32
    # Σ|term| of each value: the same route in f32 on |operands|
    ya, dxa, dwa, dba = _port_upconv(np.abs(x), np.abs(dy), weight.abs(), tbias.abs(),
                                     torch.float32, port_unet.upconv2x2_matmul)
    _close(y, yj, ya, dtype_name)
    _close(dx, dxj, dxa, dtype_name)
    # the kernel's cotangent in flax's layout, through the same mapping
    dk = variables_to_torch_state_dict(
        {"params": {"up0": {"kernel": _f32(dpj["kernel"]), "bias": _f32(dpj["bias"])}}})
    _close(dw, dk["up0.weight"], dwa, dtype_name)
    if dtype_name == "float32":
        _close(db, dk["up0.bias"], dba, dtype_name)
        return
    # the bias cotangent is a sum over the 512 output pixels of the bf16 dy:
    # XLA's CPU reduces it in bf16 (1.21 from float64 here at |db| <= 40),
    # the port in f32 with one rounding (0.107), so cl_tpu is held at bf16's
    # roundoff of the sum, 2^-7 of Σ|term| (the up-conv dW's bf16 sums in
    # ROADMAP's weight-grad trap), and the port at one ulp of float64's sum
    # of the same bf16 dy
    _close(db, dk["up0.bias"], dba, dtype_name, rel=2.0 ** -7)
    db64 = torch.from_numpy(dy).bfloat16().double().sum((0, 1, 2))
    _close(db, db64, dba, dtype_name)


def test_upconv2x2_matmul_equals_conv_transpose_route():
    """In f32 the matmul route is the port's ``F.conv_transpose2d`` route
    (``Conv(transposed=True)``), the same sums in another order."""
    x, dy, _, _, weight, bias = _upconv_case("float32", seed=6)
    got = _port_upconv(x, dy, weight, bias, torch.float32, port_unet.upconv2x2_matmul)
    want = _port_upconv(x, dy, weight, bias, torch.float32,
                        lambda t, w, b: F.conv_transpose2d(t, w, b, stride=2))
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# One SGD step of a gen-2 UNet against cl_tpu's
# ---------------------------------------------------------------------------

def _args(impl):
    return ["preset=smoke", "data.num_classes=3", "model.base_channels=32", "model.depth=2",
            "data.image_size=64", "data.source_size=80", "model.packed_unet=false",
            f"model.conv_impl={impl}", "train.optimizer=sgd", "train.lr=0.05",
            "train.data_parallel=false"]


def _one_step(impl):
    """The port's and cl_tpu's state after one SGD step of UNet(base 32,
    depth 2, 64², conv_impl=impl) from the same variables and batch: under
    pallas 9 of the 10 convs through the gen-2 conv (not the stem) and the
    up-convs as UpConv2x2; under hybrid every conv with the gen-2 dW where
    the gate admits it."""
    args = _args(impl)
    cfg, jcfg = parse_overrides(args), jax_parse(args)
    model = port_train.init_state(cfg, port_train.build_model(cfg), CPU)
    assert model.packed_levels(64, 64) == 0 and model.conv_impl == impl
    assert model.upconv_matmul == (impl == "pallas")
    variables = export_jax_variables(model)
    step = port_train.make_train_step(cfg, model, port_train.build_optimizer(cfg, model), CPU)

    jmodel = jax_train.build_model(jcfg)
    assert not jmodel.packed and jmodel.conv_impl == impl
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
            "before": dict(jax.tree_util.tree_leaves_with_path(variables)),
            "got": dict(jax.tree_util.tree_leaves_with_path(export_jax_variables(model))),
            "want": jax.tree_util.tree_leaves_with_path(
                {"params": state.params, **state.model_state})}


@pytest.fixture(scope="module", params=["pallas", "hybrid"])
def g2_step(request):
    return _one_step(request.param)


def test_g2_train_step_loss_and_params(g2_step):
    got, want = g2_step["loss"]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert len(g2_step["got"]) == len(g2_step["want"])
    for path, leaf in g2_step["want"]:
        np.testing.assert_allclose(g2_step["got"][path], np.asarray(leaf), rtol=1e-4,
                                   atol=1e-4, err_msg=str(path))


def test_g2_train_step_updates(g2_step):
    """Each leaf's update within 1e-2 of its norm plus one f32 ulp per
    element (``test_torch_conv_v3.test_v3_train_step_updates``)."""
    before, got = g2_step["before"], g2_step["got"]
    for path, leaf in g2_step["want"]:
        want = np.asarray(leaf, np.float64)
        want_d = want - before[path]
        got_d = np.asarray(got[path], np.float64) - before[path]
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 23)
        norm = np.linalg.norm(want_d)
        assert norm > 0, f"{path}: the step left it unchanged"
        assert np.linalg.norm(got_d - want_d) <= 1e-2 * norm + np.linalg.norm(ulp), (
            path, np.linalg.norm(got_d - want_d) / norm)


# ---------------------------------------------------------------------------
# Route parity, conv by conv, against cl_tpu's trace
# ---------------------------------------------------------------------------


def _jax_routes(args):
    """cl_tpu's routes under ``jax.eval_shape`` of a train-mode gradient of
    the model: ({DoubleConv path: routes}, Counters of #40 forwards, #40 dx
    and #41 launches by (H, W, Cin, Cout), up-convs through UpConv2x2)."""
    jcfg = jax_parse(args)
    model = jax_train.build_model(jcfg)
    S, Bt = jcfg.data.image_size, jcfg.data.batch_size
    routes = {}
    fwd, dx, dw = (collections.Counter() for _ in range(3))
    ups = []
    names = ("conv3x3", "conv3x3_hybrid", "_conv_fwd_impl", "_conv_dw_impl")
    orig = {k: getattr(jconv, k) for k in names}

    def owner():
        stack = flax_module._context.module_stack
        mod = stack[-1] if stack else None
        return None if mod is None else "/".join(mod.path)

    def entry(route):
        def call(x, w):
            level, conv = owner().rsplit("/", 1)
            routes.setdefault(level, ["xla", "xla"])[int(conv[-1])] = route
            return orig["conv3x3" if route == "g2" else "conv3x3_hybrid"](x, w)
        return call

    def fwd_impl(x, w):
        b, h, wid, ci = x.shape
        (fwd if owner() is not None else dx)[(h, wid, ci, w.shape[-1])] += 1
        return orig["_conv_fwd_impl"](x, w)

    def dw_impl(x, dy):
        dw[(*x.shape[1:], dy.shape[-1])] += 1
        return orig["_conv_dw_impl"](x, dy)

    def intercept(next_fun, fargs, fkwargs, context):
        if isinstance(context.module, junet.UpConv2x2) and context.method_name == "__call__":
            ups.append(context.module.name)
        return next_fun(*fargs, **fkwargs)

    x = jax.ShapeDtypeStruct((Bt, S, S, 3), jnp.float32)
    variables = jax.eval_shape(lambda v: model.init(jax.random.PRNGKey(0), v), x)

    def loss(params, stats, xx):
        out, _ = model.apply({"params": params, "batch_stats": stats}, xx, train=True,
                             mutable=["batch_stats"])
        return out.sum()

    try:
        jconv.conv3x3, jconv.conv3x3_hybrid = entry("g2"), entry("hybrid")
        jconv._conv_fwd_impl, jconv._conv_dw_impl = fwd_impl, dw_impl
        with flax_module.intercept_methods(intercept):
            jax.eval_shape(jax.grad(loss), variables["params"], variables["batch_stats"], x)
    finally:
        for k, v in orig.items():
            setattr(jconv, k, v)
    return {k: tuple(v) for k, v in routes.items()}, fwd, dx, dw, sorted(set(ups))


def _port_routes(args):
    """The port's routes on the ``meta`` device (shapes only): the same
    five records, the DoubleConvs named by module."""
    cfg = parse_overrides(args)
    model = port_train.build_model(cfg).to("meta").to(memory_format=torch.channels_last)
    routes = {}
    counts = {k: collections.Counter() for k in ("conv3x3_g2_fwd", "conv3x3_g2_dx", "dw")}
    ups = []
    names = {}
    for name, mod in model.named_modules():
        if isinstance(mod, DoubleConv):
            names[id(mod.conv0.weight)] = (name, 0)
            names[id(mod.conv1.weight)] = (name, 1)
        elif name.startswith("up"):
            names[id(mod.weight)] = (name, None)
    orig = {k: getattr(conv3x3_g2, k)
            for k in ("conv3x3_g2", "conv3x3_hybrid", "_conv3x3_g2", "_conv3x3_g2_dw")}
    orig_up = port_unet.upconv2x2_matmul

    def entry(route):
        def call(x, w):
            name, i = names[id(w)]
            routes.setdefault(name, ["xla", "xla"])[i] = route
            return orig["conv3x3_g2" if route == "g2" else "conv3x3_hybrid"](x, w)
        return call

    def launch(x, w, key):
        counts[key][(x.shape[1], x.shape[2], w.shape[1], w.shape[0])] += 1
        return orig["_conv3x3_g2"](x, w, key)

    def launch_dw(x, dy):
        counts["dw"][(*x.shape[1:], dy.shape[-1])] += 1
        return orig["_conv3x3_g2_dw"](x, dy)

    def up(x, weight, bias):
        ups.append(names[id(weight)][0])
        return orig_up(x, weight, bias)

    S, Bt = cfg.data.image_size, cfg.data.batch_size
    try:
        conv3x3_g2.conv3x3_g2, conv3x3_g2.conv3x3_hybrid = entry("g2"), entry("hybrid")
        conv3x3_g2._conv3x3_g2, conv3x3_g2._conv3x3_g2_dw = launch, launch_dw
        port_unet.upconv2x2_matmul = up
        out = model.train()(torch.empty(Bt, S, S, 3, device="meta"))
        out.sum().backward()
    finally:
        for k, v in orig.items():
            setattr(conv3x3_g2, k, v)
        port_unet.upconv2x2_matmul = orig_up
    return ({k: tuple(v) for k, v in routes.items()}, counts["conv3x3_g2_fwd"],
            counts["conv3x3_g2_dx"], counts["dw"], sorted(set(ups)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("preset,impl", [("baseline_1", "pallas"), ("baseline_1", "hybrid"),
                                         ("baseline_2", "pallas"), ("baseline_2", "hybrid")])
def test_routes_match_cl_tpu(preset, impl, dtype):
    """Every conv's route, every launch of #40 (forward, dx) and #41 by
    shape, and the up-convs that take UpConv2x2, as ``cl_tpu`` traces them:
    under pallas 17 of the 18 convs (not the stem) forward, dx and dW;
    under hybrid every conv, with 17 #41 launches and no #40."""
    args = [f"preset={preset}", f"model.conv_impl={impl}", f"train.compute_dtype={dtype}",
            "train.data_parallel=false"]
    port_train.check_supported(parse_overrides(args), CPU)
    want, got = _jax_routes(args), _port_routes(args)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert g == w
    fwd, dx, dw = (sum(c.values()) for c in got[1:4])
    assert (fwd, dx, dw) == ((17, 17, 17) if impl == "pallas" else (0, 0, 17))
    assert got[4] == ([f"up{level}" for level in range(4)] if impl == "pallas" else [])


def test_routes_packed_body_ignores_pallas():
    """``preset=baseline_3 model.conv_impl=pallas``: the packed body
    engages, its deep region stays on ``xla`` and its up-convs are its own,
    so neither package launches #40 or #41 nor runs UpConv2x2."""
    args = ["preset=baseline_3", "model.conv_impl=pallas", "train.data_parallel=false"]
    cfg = parse_overrides(args)
    assert port_train.build_model(cfg).packed_levels(512, 512) > 0
    port_train.check_supported(cfg, CPU)
    want, got = _jax_routes(args), _port_routes(args)
    assert want == got == ({}, collections.Counter(), collections.Counter(),
                           collections.Counter(), [])


# ---------------------------------------------------------------------------
# cl_tpu's tuning variables
# ---------------------------------------------------------------------------


def test_tuning_variables_at_their_defaults_accepted(monkeypatch):
    """All five at what ``cl_tpu`` parses as its defaults (20 MiB, 64 MiB,
    8192, 1 and off) are accepted."""
    for name, value in (("CONV_VMEM_BUDGET", 20 * 1024 * 1024),
                        ("FUSED_VMEM_BUDGET", 64 * 1024 * 1024),
                        ("CONV_ROW_TARGET", 8192), ("CAT_DOTS", 1), ("E_BF16", False)):
        monkeypatch.setattr(packed_gate, name, value)
    port_train.check_supported(parse_overrides(["preset=smoke"]), CPU)
