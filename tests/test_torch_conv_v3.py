"""The port's gen-3 conv routes (``model.conv_impl=v3|auto``) and the packed
conv's two-pass backward against ``cl_tpu``'s, on the CPU.

- #30 / #31: the plain conv and its VJP (``conv3x3.conv3x3``: dx is #30 on
  dy with the flipped, transposed weight, dW #31 rounded once to the
  compute dtype) against ``cl_tpu.pallas.conv3x3_v3.conv3x3`` and its
  ``jax.vjp`` in interpret mode, at ``tests/unit/test_pallas_conv_v3.py``'s
  shapes. Tolerances: y and dx f32 1e-5 of Σ|term|, bf16 one ulp plus
  that f32 floor (an f32 sum in another order may round to the other
  neighbour); dW 1e-5 of Σ|term| plus, in bf16, one ulp of the value it
  rounds to once.
- The packed-level DoubleConv (both convs through #30, PackedBatchNorm)
  against ``cl_tpu``'s ``DoubleConv(conv_impl="v3")``: train mode
  (output, the VJP of the input and every param, running statistics) and
  eval mode, f32: 1e-5 (the same arithmetic in another sum order).
- One SGD step of a v3 UNet against ``cl_tpu.train.make_train_step``:
  loss, params and batch stats within 1e-4, each leaf's update within
  1e-2 of its norm plus one f32 ulp, as the packed train tests hold it.
- Route parity: which conv takes which route, and every launch of #30 and
  #31 (forward, dx, dW, by shape), for baselines 1 and 2 under v3 and
  auto, f32 and bf16, against ``cl_tpu``'s ``jax.eval_shape`` trace of a
  train-mode gradient; the port runs on the ``meta`` device (shapes
  only). ``preset=baseline_2 model.conv_impl=v3`` in f32 is refused by the
  port and asserts in ``cl_tpu``.
- The packed conv's two-pass backward: both packages' VMEM budgets
  lowered together until a small packed conv's fused backward finds no
  tile while its forward still does; ``conv_bn_fused``'s gradients
  against ``cl_tpu``'s, prologue on and off, f32 and bf16.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import module as flax_module

from cl_tpu import train as jax_train
from cl_tpu.config import parse_overrides as jax_parse
from cl_tpu.data import pipeline as jax_pipeline
from cl_tpu.data import tasks as jax_tasks
from cl_tpu.models import unet as junet
from cl_tpu.pallas import conv3x3_v3 as jconv
from cl_tpu_torch import train as port_train
from cl_tpu_torch.config import parse_overrides
from cl_tpu_torch.data import pipeline
from cl_tpu_torch.interop import export_jax_variables, load_jax_variables
from cl_tpu_torch.kernels import conv3x3
from cl_tpu_torch.models import packed_gate
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


def _close(got, want, terms, dtype_name, ulps=1.0, rel=1e-5):
    """|got − want| <= rel·Σ|term| (+ ``ulps`` bf16 ulps in bf16)."""
    got, want, terms = _f32(got), _f32(want), _f32(terms)
    assert got.shape == want.shape == terms.shape
    tol = rel * terms + 1e-6
    if dtype_name == "bfloat16":
        tol = tol + ulps * _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


def _flax_kernel(w):
    """The port's [Cout, Cin, 3, 3] weight in flax's [3, 3, Cin, Cout]."""
    return np.ascontiguousarray(_f32(w).transpose(2, 3, 1, 0))


# ---------------------------------------------------------------------------
# #30 / #31: the plain conv and its VJP against conv3x3_v3.conv3x3
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [
    (2, 8, 32, 32, 32),     # nh = 1, P = 4
    (1, 24, 32, 32, 32),    # nh = 3
    (1, 16, 64, 64, 64),    # P = 2
    (1, 16, 64, 64, 32),    # channel-halving (decoder entry)
], ids=lambda s: "x".join(map(str, s)))
def test_conv3x3_and_vjp(shape, dtype_name):
    b, h, w, ci, co = shape
    rng = np.random.RandomState(ci + co + h)
    x = _randn(rng, b, h, w, ci)
    wt = _randn(rng, co, ci, 3, 3, scale=(9 * ci) ** -0.5)  # the port's f32 param
    dy = _randn(rng, b, h, w, co)
    jd, td = DTYPES[dtype_name]
    jx = jnp.asarray(x).astype(jd)
    yj, vjp = jax.vjp(jconv.conv3x3, jx, jnp.asarray(_flax_kernel(wt)).astype(jd))
    dxj, dkj = vjp(jnp.asarray(dy).astype(jd))

    tx = torch.from_numpy(x).to(td).requires_grad_(True)
    tw = torch.from_numpy(wt).requires_grad_(True)
    y = conv3x3.conv3x3(tx, tw)
    y.backward(torch.from_numpy(dy).to(td))
    assert y.dtype == td and tx.grad.dtype == td and tw.grad.dtype == torch.float32

    xa, wa, dya = (torch.from_numpy(v).abs() for v in (x, wt, dy))
    _close(y, yj, conv3x3.conv3x3_plain(xa, wa), dtype_name)
    _close(tx.grad, dxj, conv3x3.conv3x3_plain(dya, conv3x3._flip_t(wa)), dtype_name)
    _close(tw.grad, _f32(dkj).transpose(3, 2, 0, 1), conv3x3.conv3x3_dw_plain(xa, dya),
           dtype_name)
    # the plain versions are what the Function ran
    torch.testing.assert_close(y, conv3x3.conv3x3_plain(tx.detach(), tw.detach()),
                               rtol=0, atol=0)


def test_conv3x3_dw_rounds_once_to_the_compute_dtype():
    """dW is summed in f32 and rounded once to bf16 (``.astype(w.dtype)``,
    conv3x3_v3.py:643): the param's gradient is that bf16 value."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(_randn(rng, 1, 8, 32, 32)).bfloat16()
    w = torch.from_numpy(_randn(rng, 32, 32, 3, 3, scale=0.06)).requires_grad_(True)
    dy = torch.from_numpy(_randn(rng, 1, 8, 32, 32)).bfloat16()
    conv3x3.conv3x3(x, w).backward(dy)
    want = conv3x3.conv3x3_dw_plain(x, dy)
    assert want.dtype == torch.float32
    torch.testing.assert_close(w.grad, want.bfloat16().float(), rtol=0, atol=0)
    assert not torch.equal(want, want.bfloat16().float())


# ---------------------------------------------------------------------------
# The packed-level DoubleConv with PackedBatchNorm
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def packed_level():
    """cl_tpu's DoubleConv(conv_impl="v3") on a packed level (dec-entry
    shape 64 -> 32 channels, 16 x 64), train and eval mode, from seeded
    variables with running statistics of their own. The seed is one whose
    pre-ReLU values all lie more than 1e-5 from 0 (checked in
    ``test_packed_level_train``): a value within the f32 rounding of 0 (a
    tie) may fall on either side in either package, and one flipped mask
    moves the dx of every pixel the convs spread it to."""
    B, H, W, ci, f = 2, 16, 64, 64, 32
    assert packed_gate.level_pack(H, W, ci, f, "v3") == 4
    rng = np.random.RandomState(12)
    x = _randn(rng, B, H, W, ci)
    dz = _randn(rng, B, H, W, f)
    mod = junet.DoubleConv(f, conv_impl="v3")
    variables = jax.tree.map(np.asarray, mod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    for i in range(2):
        variables["params"][f"bn{i}"]["scale"] = (rng.rand(f) + 0.5).astype(np.float32)
        variables["params"][f"bn{i}"]["bias"] = _randn(rng, f, scale=0.3)
        variables["batch_stats"][f"bn{i}"]["mean"] = _randn(rng, f, scale=0.1)
        variables["batch_stats"][f"bn{i}"]["var"] = (rng.rand(f) + 0.5).astype(np.float32)

    def train_fn(params, xx):
        return mod.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx,
                         train=True, mutable=["batch_stats"])

    (zj, stats_j), vjp = jax.vjp(train_fn, variables["params"], jnp.asarray(x))
    dparams_j, dx_j = vjp((jnp.asarray(dz), jax.tree.map(jnp.zeros_like, stats_j)))
    z_eval = mod.apply(variables, jnp.asarray(x), train=False)
    return {"x": x, "dz": dz, "variables": variables, "z": zj, "stats": stats_j,
            "dparams": dparams_j, "dx": dx_j, "z_eval": z_eval, "f": f, "ci": ci}


def _port_level(case):
    mod = DoubleConv(case["ci"], case["f"]).to(memory_format=torch.channels_last)
    load_jax_variables(mod, case["variables"])
    return mod


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def test_packed_level_train(packed_level):
    case = packed_level
    mod = _port_level(case).train()
    with torch.no_grad():  # no ties at the ReLUs (see the fixture)
        h = _nchw(case["x"])
        for conv, bn in ((mod.conv0, mod.bn0), (mod.conv1, mod.bn1)):
            t = bn(conv(h))
            assert t.abs().min() > 1e-5
            h = torch.relu(t)
    mod = _port_level(case).train()
    x = _nchw(case["x"]).requires_grad_(True)
    z = mod(x, "v3")
    z.backward(_nchw(case["dz"]))
    np.testing.assert_allclose(_f32(z.permute(0, 2, 3, 1)), _f32(case["z"]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_f32(x.grad.permute(0, 2, 3, 1)), _f32(case["dx"]), rtol=1e-5,
                               atol=1e-5)
    # the params' gradients are sums over the 2048 pixels: within 1e-5 of
    # the largest entry of each
    def sums_close(got, want, what):
        want = _f32(want)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max(),
                                   err_msg=what)

    for i in range(2):
        conv, bn = getattr(mod, f"conv{i}"), getattr(mod, f"bn{i}")
        sums_close(_flax_kernel(conv.weight.grad), case["dparams"][f"conv{i}"]["kernel"],
                   f"conv{i}")
        for leaf, name in (("weight", "scale"), ("bias", "bias")):
            sums_close(_f32(getattr(bn, leaf).grad), case["dparams"][f"bn{i}"][name],
                       f"bn{i}.{leaf}")
        for leaf, name in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(_f32(getattr(bn, leaf)),
                                       _f32(case["stats"]["batch_stats"][f"bn{i}"][name]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"bn{i}.{leaf}")


def test_packed_level_eval(packed_level):
    mod = _port_level(packed_level).eval()
    with torch.no_grad():
        z = mod(_nchw(packed_level["x"]), "v3")
    np.testing.assert_allclose(_f32(z.permute(0, 2, 3, 1)), _f32(packed_level["z_eval"]),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# One SGD step of a v3 UNet against cl_tpu's
# ---------------------------------------------------------------------------

ARGS = ["preset=smoke", "data.num_classes=3", "model.base_channels=32", "model.depth=2",
        "data.image_size=64", "data.source_size=80", "model.packed_unet=false",
        "model.conv_impl=v3", "train.optimizer=sgd", "train.lr=0.05",
        "train.data_parallel=false"]


@pytest.fixture(scope="module")
def v3_step():
    """The port's and cl_tpu's state after one SGD step of UNet(base 32,
    depth 2, 64², conv_impl="v3") from the same variables and batch: enc0's
    second conv, enc1 and the bottleneck on the per-conv route, both
    decoder levels on the packed-level route."""
    cfg, jcfg = parse_overrides(ARGS), jax_parse(ARGS)
    routes = [packed_gate.double_conv_route(h, h, ci, f, "v3", "batch") for h, ci, f in
              ((64, 3, 32), (32, 32, 64), (16, 64, 128), (32, 128, 64), (64, 64, 32))]
    assert routes == [("xla", "v3"), ("v3", "v3"), ("v3", "v3"), ("packed", "packed"),
                      ("packed", "packed")]
    model = port_train.init_state(cfg, port_train.build_model(cfg), CPU)
    assert model.packed_levels(64, 64) == 0 and model.conv_impl == "v3"
    variables = export_jax_variables(model)
    step = port_train.make_train_step(cfg, model, port_train.build_optimizer(cfg, model), CPU)

    jmodel = jax_train.build_model(jcfg)
    assert not jmodel.packed and jmodel.conv_impl == "v3"
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


def test_v3_train_step_loss_and_params(v3_step):
    got, want = v3_step["loss"]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert len(v3_step["got"]) == len(v3_step["want"])
    for path, leaf in v3_step["want"]:
        np.testing.assert_allclose(v3_step["got"][path], np.asarray(leaf), rtol=1e-4,
                                   atol=1e-4, err_msg=str(path))


def test_v3_train_step_updates(v3_step):
    """Each leaf's update within 1e-2 of its norm plus one f32 ulp per
    element (``test_torch_packed_train.test_packed_train_step_updates``)."""
    before, got = v3_step["before"], v3_step["got"]
    for path, leaf in v3_step["want"]:
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
    the model: ({DoubleConv path: routes}, Counter of #30 launches by
    (H, W, Cin, Cout), Counter of #31 launches)."""
    jcfg = jax_parse(args)
    model = jax_train.build_model(jcfg)
    S, Bt = jcfg.data.image_size, jcfg.data.batch_size
    routes, fwd, dw = {}, collections.Counter(), collections.Counter()
    orig = {k: getattr(jconv, k) for k in ("_conv_fwd_impl", "_fwd_packed", "_dw_packed")}

    def owner():
        stack = flax_module._context.module_stack
        mod = stack[-1] if stack else None
        return None if mod is None else "/".join(mod.path)

    def per_conv(x, w):  # Conv3x3's route: the module is the conv itself
        if owner() is not None:
            name = owner()
            level, conv = name.rsplit("/", 1)
            routes.setdefault(level, ["xla", "xla"])[int(conv[-1])] = "v3"
        return orig["_conv_fwd_impl"](x, w)

    def fwd_packed(xp, w, p_force=None):
        name = owner()
        if name is not None and not name.rsplit("/", 1)[-1].startswith("conv"):
            routes[name] = ["packed", "packed"]  # DoubleConv._packed
        b, h, wg, lanes = xp.shape
        fwd[(h, wg * lanes // w.shape[2], w.shape[2], w.shape[3])] += 1
        return orig["_fwd_packed"](xp, w, p_force)

    def dw_packed(xp, dyp4, c_in, p_force=None):
        b, h, wg, lanes = xp.shape
        dw[(h, wg * lanes // c_in, c_in, dyp4.shape[-1] // (lanes // c_in))] += 1
        return orig["_dw_packed"](xp, dyp4, c_in, p_force)

    x = jax.ShapeDtypeStruct((Bt, S, S, 3), jnp.float32)
    variables = jax.eval_shape(lambda v: model.init(jax.random.PRNGKey(0), v), x)

    def loss(params, stats, xx):
        out, _ = model.apply({"params": params, "batch_stats": stats}, xx, train=True,
                             mutable=["batch_stats"])
        return out.sum()

    try:
        jconv._conv_fwd_impl, jconv._fwd_packed, jconv._dw_packed = per_conv, fwd_packed, dw_packed
        jax.eval_shape(jax.grad(loss), variables["params"], variables["batch_stats"], x)
    finally:
        for k, v in orig.items():
            setattr(jconv, k, v)
    return {k: tuple(v) for k, v in routes.items()}, fwd, dw


def _port_routes(args):
    """The port's routes on the ``meta`` device (shapes only): the same
    three records, the DoubleConvs named by module."""
    cfg = parse_overrides(args)
    model = port_train.build_model(cfg).to("meta").to(memory_format=torch.channels_last)
    assert model.packed_levels(cfg.data.image_size, cfg.data.image_size) == 0
    routes, fwd, dw = {}, collections.Counter(), collections.Counter()
    names = {}
    for name, mod in model.named_modules():
        if isinstance(mod, DoubleConv):
            names[id(mod.conv0.weight)] = (name, 0)
            names[id(mod.conv1.weight)] = (name, 1)
    orig = (conv3x3.conv3x3, conv3x3.conv3x3_plain, conv3x3.conv3x3_dw_plain)
    bn_calls = []

    def entry(x, w):
        name, i = names[id(w)]
        routes.setdefault(name, ["xla", "xla"])[i] = "v3"
        return orig[0](x, w)

    def plain(x, w):
        fwd[(x.shape[1], x.shape[2], w.shape[1], w.shape[0])] += 1
        return orig[1](x, w)

    def dw_plain(x, dy):
        dw[(x.shape[1], x.shape[2], x.shape[-1], dy.shape[-1])] += 1
        return orig[2](x, dy)

    import cl_tpu_torch.models.unet as port_unet
    orig_bn = port_unet.packed_batch_norm

    def packed_bn(bn, y, train):
        bn_calls.append(bn)
        return orig_bn(bn, y, train)

    S, Bt = cfg.data.image_size, cfg.data.batch_size
    try:
        conv3x3.conv3x3, conv3x3.conv3x3_plain, conv3x3.conv3x3_dw_plain = entry, plain, dw_plain
        port_unet.packed_batch_norm = packed_bn
        out = model.train()(torch.empty(Bt, S, S, 3, device="meta"))
        out.sum().backward()
    finally:
        conv3x3.conv3x3, conv3x3.conv3x3_plain, conv3x3.conv3x3_dw_plain = orig
        port_unet.packed_batch_norm = orig_bn
    for name, mod in model.named_modules():
        if isinstance(mod, DoubleConv) and mod.bn0 in bn_calls:
            assert mod.bn1 in bn_calls
            routes[name] = ["packed", "packed"]
    return {k: tuple(v) for k, v in routes.items()}, fwd, dw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("preset,impl", [("baseline_1", "v3"), ("baseline_1", "auto"),
                                         ("baseline_2", "v3"), ("baseline_2", "auto")])
def test_routes_match_cl_tpu(preset, impl, dtype):
    """Every conv's route and every launch of #30 (forward, dx, the
    two-pass dt) and #31, by shape, as ``cl_tpu`` traces them."""
    args = [f"preset={preset}", f"model.conv_impl={impl}", f"train.compute_dtype={dtype}",
            "train.data_parallel=false"]
    if (preset, impl, dtype) == ("baseline_2", "v3", "float32"):
        # cl_tpu asserts at enc3.conv1's forward (32² x 512 -> 512 finds no
        # f32 tile); the port refuses the config before training
        with pytest.raises(AssertionError, match="caller must gate on supported"):
            _jax_routes(args)
        with pytest.raises(NotImplementedError, match=r"enc3\.conv1 .*conv3x3_v3\.py:218"):
            port_train.check_supported(parse_overrides(args), CPU)
        return
    port_train.check_supported(parse_overrides(args), CPU)
    want, got = _jax_routes(args), _port_routes(args)
    assert got[0] == want[0]
    assert got[1] == want[1] and got[2] == want[2]
    if impl == "auto":  # only the 256² level routes, and only at base 64
        assert set(want[0]) == ({"enc0", "dec0"} if preset == "baseline_2" else set())


# ---------------------------------------------------------------------------
# The packed conv's two-pass backward (#30 as dt, #33)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("prologue", [False, True], ids=["slim", "prologue"])
def test_two_pass_backward(prologue, dtype_name, monkeypatch):
    """Both VMEM budgets lowered to what the forward's tile needs: the
    forward (and the two-pass dt and dW, at the same tile) still fit, the
    fused dx and dW kernels do not, so both packages take the two-pass
    branch (``_cbf_bwd``, ``:962-985``)."""
    B, H, W, c, P = 2, 16, 32, 32, 4
    itemsize = 4 if dtype_name == "float32" else 2
    wg = W // P
    budget = packed_gate._conv_vmem(H, wg, P * c, (P + 2) * c, P, c, itemsize)
    monkeypatch.setattr(jconv, "_VMEM_BUDGET", budget)
    monkeypatch.setattr(packed_gate, "CONV_VMEM_BUDGET", budget)
    assert jconv._pick_th(H, wg, P * c, itemsize, (P + 2) * c, P, c) == H
    assert (jconv._pick_th_dx(H, wg, P * c, (P + 2) * c, P * c, itemsize, prologue) == 0
            or jconv._pick_th_dw2(H, wg, P * c, (P + 2) * c, P, c, itemsize) == 0)
    assert packed_gate.conv_bwd_branch(H, W, c, c, P, itemsize, prologue) == "two_pass"

    rng = np.random.RandomState(31 + prologue)
    x = _randn(rng, B, H, W, c)
    wt = _randn(rng, c, c, 3, 3, scale=(9 * c) ** -0.5)
    a = (rng.rand(c) + 0.5).astype(np.float32)
    b = (rng.rand(c) * 0.5 - 0.1).astype(np.float32)
    dy = _randn(rng, B, H, W, c)
    ds1, ds2 = _randn(rng, c, scale=0.5), _randn(rng, c, scale=0.2)
    jd, td = DTYPES[dtype_name]
    fn = lambda xp, k, al, bl: jconv.conv_bn_fused(xp, k, al, bl, P, prologue)  # noqa: E731
    (yj, _, _), vjp = jax.vjp(fn, jnp.asarray(x).astype(jd).reshape(B, H, wg, P * c),
                              jnp.asarray(_flax_kernel(wt)).astype(jd),
                              jnp.tile(jnp.asarray(a), P), jnp.tile(jnp.asarray(b), P))
    dxj, dkj, daj, dbj = vjp((jnp.asarray(dy).astype(jd).reshape(yj.shape),
                              jnp.tile(jnp.asarray(ds1), P), jnp.tile(jnp.asarray(ds2), P)))

    calls = []
    dw_bn = conv3x3.conv3x3_dw_bn_plain
    monkeypatch.setattr(conv3x3, "conv3x3_dw_bn_plain",
                        lambda *args: calls.append(1) or dw_bn(*args))
    tx = torch.from_numpy(x).to(td).requires_grad_(True)
    tw = torch.from_numpy(wt).requires_grad_(True)
    ta = torch.from_numpy(a).requires_grad_(prologue)
    tb = torch.from_numpy(b).requires_grad_(prologue)
    y, s1, s2 = conv3x3.conv_bn_fused(tx, tw, ta, tb, prologue, P)
    tdy, tds1, tds2 = torch.from_numpy(dy).to(td), torch.from_numpy(ds1), torch.from_numpy(ds2)
    torch.autograd.backward([y, s1, s2], [tdy, tds1, tds2])
    assert calls == [1]  # the port took the two-pass branch: #33 for dW

    # Σ|term| of each value, from the same plain versions on |operands|
    e = conv3x3.dy_eff(tdy, y.detach(), tds1, tds2)
    ea, wa = e.float().abs(), torch.from_numpy(wt).abs()
    t = conv3x3.prologue_t(tx.detach(), ta.detach(), tb.detach(), prologue)
    dt_terms = conv3x3.conv3x3_plain(ea, conv3x3._flip_t(wa))
    scale = float(a.max()) if prologue else 1.0
    _close(tx.grad, _f32(dxj).reshape(B, H, W, c), dt_terms * scale, dtype_name)
    _close(tw.grad, _f32(dkj).transpose(3, 2, 0, 1),
           conv3x3.conv3x3_dw_plain(t.float().abs(), ea), dtype_name)
    if prologue:
        du = torch.where(tx.detach().float() * ta.detach() + tb.detach() > 0, dt_terms, 0.0)
        du = du.reshape(-1, c)
        _close(ta.grad, _f32(daj).reshape(P, c).sum(0),
               (du * tx.detach().float().abs().reshape(-1, c)).sum(0), "float32")
        _close(tb.grad, _f32(dbj).reshape(P, c).sum(0), du.sum(0), "float32")
