"""The port's int8 saved activations (``model.conv_act_store=int8``,
``conv3x3.conv_bn_fused_q``) against ``cl_tpu``'s ``conv_bn_fused_q``, on
the CPU, ``cl_tpu`` in interpret mode as its own tests run it.

- The quantizer (32q): q and the scale bit for bit against
  ``_fwd_bn_impl(..., emit_q=True)``'s outputs read from the packed view
  ([b, h, wg, p·C] → [B, H, W, C], [b, h, 1, p·C] → [B, H, p, C]); the
  port's y, Σy and Σy² under ``conv_bn_fused_q`` bit for bit those of
  ``conv_bn_fused``; |deq(q) − y| ≤ scale/2 and all-zero rows give q = 0,
  scale = 0.
- The backward (#38, #39): dx, da, db and dW of ``conv_bn_fused_q``
  against ``jax.vjp`` of ``cl_tpu``'s, with the port's forward fed
  ``cl_tpu``'s y so both quantize the same values, both xq modes, prologue
  on and off, f32 and bf16, nonzero stats cotangents; and the fallback
  (dequantize, then the two-pass backward), forced in both packages.
  Tolerances, as the dtype path's tests hold them: 1e-5 of Σ|term| (f32
  sums in another order; ``cl_tpu``'s e = dy + ds1 + 2·deq(y)·ds2 may be
  contracted into an FMA by XLA's CPU, which moves it by an f32 ulp, as
  for #26), plus one bf16 ulp of each value rounded once in bf16.
- One packed SGD step at 128², base 32, depth 2 with int8 against
  ``cl_tpu.train.make_train_step``, ``cl_tpu``'s ``q_supported`` patched to
  its chip's rule (level 0 int8, level 1 in the compute dtype): loss,
  params and batch stats within 1e-4, each leaf's update within 1e-2 of
  its norm plus one f32 ulp; the convs that took the int8 route, in both.
- Which convs take the int8 route and how many int8 launches a step makes
  at 512² (the headline step, every packed conv) and at 128², against
  ``cl_tpu``'s ``jax.eval_shape`` trace; the port on the ``meta`` device.
- A level's conv1 keeps conv0's int8 pair, not its bf16 input.
"""

import collections

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
from cl_tpu_torch import train as port_train
from cl_tpu_torch.config import parse_overrides
from cl_tpu_torch.data import pipeline
from cl_tpu_torch.interop import export_jax_variables
from cl_tpu_torch.kernels import conv3x3
from cl_tpu_torch.models import packed_gate
from cl_tpu_torch.models.unet import DoubleConv
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CPU = torch.device("cpu")
B, H, W, C, P = 2, 8, 32, 32, 4  # wg = 8: cl_tpu's interpret mode admits any


def _chip_q_supported(wg):
    """``conv3x3_v3.q_supported`` as the TPU runs it."""
    return wg % 32 == 0


def _randn(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


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


def _packed(a, c):
    """[B, H, W, c] → cl_tpu's packed view [B, H, W/P, P·c]."""
    return a.reshape(a.shape[0], a.shape[1], a.shape[2] // P, P * c)


def _operands(rng):
    x = _randn(rng, B, H, W, C)
    w = _randn(rng, C, C, 3, 3, scale=(9 * C) ** -0.5)  # the port's [Cout, Cin, 3, 3]
    a = (rng.rand(C) + 0.5).astype(np.float32)
    b = (rng.rand(C) * 0.5 - 0.1).astype(np.float32)
    return x, w, a, b


def _jax_fwd_args(x, w, a, b, dtype_name):
    jd = DTYPES[dtype_name][0]
    return (jnp.asarray(_packed(x, C)).astype(jd),
            jnp.asarray(w.transpose(2, 3, 1, 0)).astype(jd),
            jnp.tile(jnp.asarray(a), P), jnp.tile(jnp.asarray(b), P))


# ---------------------------------------------------------------------------
# 32q: the quantizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("prologue", [False, True], ids=["slim", "prologue"])
def test_quantize_matches_cl_tpu(prologue, dtype_name):
    """q and the scale of ``cl_tpu``'s y bit for bit; the port's forward
    keeps every bit of the dtype path's, and its q is its y's."""
    td = DTYPES[dtype_name][1]
    x, w, a, b = _operands(np.random.RandomState(3 + prologue))
    xp, k, al, bl = _jax_fwd_args(x, w, a if prologue else np.ones(C, np.float32),
                                  b if prologue else np.zeros(C, np.float32), dtype_name)
    yj, _, _, yqj, yscj = jconv._fwd_bn_impl(xp, k, al, bl, P, prologue, emit_q=True)
    yj = torch.from_numpy(_f32(yj).reshape(B, H, W, C)).to(td)
    q, scale = conv3x3.quant_rows_plain(yj, P)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(yqj).reshape(B, H, W, C))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(yscj).reshape(B, H, P, C))

    tx, tw = torch.from_numpy(x).to(td), torch.from_numpy(w)
    ta, tb = (torch.from_numpy(a), torch.from_numpy(b)) if prologue else (None, None)
    y0, s10, s20 = conv3x3.conv_bn_fused(tx, tw, ta, tb, prologue, P)
    y1, s11, s21, (q1, sc1) = conv3x3.conv_bn_fused_q(tx, None, tw, ta, tb, prologue, P)
    for u, v in ((y1, y0), (s11, s10), (s21, s20)):
        assert torch.equal(u, v)
    q2, sc2 = conv3x3.quant_rows_plain(y1, P)
    assert torch.equal(q1, q2) and torch.equal(sc1, sc2)


def test_quantizer_contract():
    """|deq(q) − y| <= scale/2 (one rounding of y·127/m), the scale is
    m·float32(1/127), and an all-zero row group gives q = 0 and scale = 0."""
    rng = np.random.RandomState(4)
    y = torch.from_numpy(_randn(rng, 2, 3, 16, 8, scale=3.0))
    y[0, 1] = 0.0               # a whole row
    y[1, 2, 1::4, 5] = 0.0      # one (row, column mod 4, channel) group
    q, scale = conv3x3.quant_rows_plain(y, 4)
    deq = conv3x3.deq_rows(q, scale, 4)
    bound = scale[:, :, None].expand(2, 3, 4, 4, 8).reshape(2, 3, 16, 8) * 0.5
    assert torch.all((deq - y).abs() <= bound * (1 + 2 ** -20))
    m = y.abs().reshape(2, 3, 4, 4, 8).amax(2)
    assert torch.equal(scale, m * np.float32(1.0 / 127.0))
    assert q.abs().max() == 127 and torch.all(q[0, 1] == 0) and torch.all(scale[0, 1] == 0)
    assert torch.all(q[1, 2, 1::4, 5] == 0) and scale[1, 2, 1, 5] == 0


# ---------------------------------------------------------------------------
# #38 / #39: the backward against jax.vjp of conv_bn_fused_q
# ---------------------------------------------------------------------------


def _backward_case(xq_mode, prologue, dtype_name, monkeypatch, two_pass=False):
    """Gradients of both packages' ``conv_bn_fused_q`` from the same x, xq,
    weights and cotangents, the port's forward fed ``cl_tpu``'s y; with
    ``two_pass`` both take the fallback. Returns (port grads, cl_tpu grads
    folded to channels, Σ|term| of each)."""
    jd, td = DTYPES[dtype_name]
    rng = np.random.RandomState(11 + 2 * xq_mode + prologue)
    x, w, a, b = _operands(rng)
    dy = _randn(rng, B, H, W, C)
    ds1, ds2 = _randn(rng, C, scale=0.5), _randn(rng, C, scale=0.2)
    tx0 = torch.from_numpy(x).to(td)
    xq = conv3x3.quant_rows_plain(tx0, P) if xq_mode else None  # a producer's pair
    xq_j = None if xq is None else (jnp.asarray(_packed(xq[0].numpy(), C)),
                                    jnp.asarray(xq[1].numpy().reshape(B, H, 1, P * C)))
    xp, k, al, bl = _jax_fwd_args(x, w, a if prologue else np.ones(C, np.float32),
                                  b if prologue else np.zeros(C, np.float32), dtype_name)
    if two_pass:
        monkeypatch.setattr(jconv, "_pick_th_dx", lambda *a_, **k_: 0)
        monkeypatch.setattr(conv3x3, "conv_bwd_branch", lambda *a_, **k_: "two_pass")
    fn = lambda xp_, k_, al_, bl_: jconv.conv_bn_fused_q(  # noqa: E731
        xp_, xq_j, k_, al_, bl_, P, prologue)[:3]
    (yj, s1j, s2j), vjp = jax.vjp(fn, xp, k, al, bl)
    dxj, dkj, daj, dbj = vjp((_packed(jnp.asarray(dy), C).astype(jd),
                              jnp.tile(jnp.asarray(ds1), P), jnp.tile(jnp.asarray(ds2), P)))

    y_j = torch.from_numpy(_f32(yj).reshape(B, H, W, C)).to(td)
    monkeypatch.setattr(conv3x3, "conv_bn_plain",
                        lambda *_: (y_j.clone(), torch.zeros(C), torch.zeros(C)))
    calls = collections.Counter()
    for name in ("conv_dx_q_plain", "conv_dw_q_plain", "conv3x3_dw_bn_plain"):
        fn_ = getattr(conv3x3, name)
        monkeypatch.setattr(conv3x3, name,
                            lambda *args, f=fn_, n=name: calls.update([n]) or f(*args))
    tx = tx0.clone().requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    ta = torch.from_numpy(a).requires_grad_(True) if prologue else None
    tb = torch.from_numpy(b).requires_grad_(True) if prologue else None
    y, s1, s2, (q, scale) = conv3x3.conv_bn_fused_q(tx, xq, tw, ta, tb, prologue, P)
    tdy = torch.from_numpy(dy).to(td)
    torch.autograd.backward([y, s1, s2], [tdy, torch.from_numpy(ds1), torch.from_numpy(ds2)])
    if two_pass:
        assert calls == {"conv3x3_dw_bn_plain": 1}, calls
    else:
        # the dW's plain version sums through #33's
        assert calls == {"conv_dx_q_plain": 1, "conv_dw_q_plain": 1,
                         "conv3x3_dw_bn_plain": 1}, calls

    # Σ|term| of each value from the plain versions on |operands|
    y_used = conv3x3.deq_rows(q, scale, P)
    x_used = tx0.float() if xq is None else conv3x3.deq_rows(*xq, P)
    if two_pass:  # the fallback rounds both to the compute dtype
        y_used, x_used = y_used.to(td).float(), x_used.to(td).float()
    ea = conv3x3.dy_eff(tdy, y_used, torch.from_numpy(ds1), torch.from_numpy(ds2)).float().abs()
    dt_terms = conv3x3.conv3x3_plain(ea, conv3x3._flip_t(torch.from_numpy(w).abs()))
    t = conv3x3.prologue_t(x_used, torch.from_numpy(a), torch.from_numpy(b), prologue)
    got = {"dx": tx.grad, "dw": tw.grad}
    want = {"dx": _f32(dxj).reshape(B, H, W, C), "dw": _f32(dkj).transpose(3, 2, 0, 1)}
    terms = {"dx": dt_terms * (float(a.max()) if prologue else 1.0),
             "dw": conv3x3.conv3x3_dw_plain(t.to(td).float().abs(), ea)}
    if prologue:
        du = torch.where(x_used * torch.from_numpy(a) + torch.from_numpy(b) > 0, dt_terms, 0.0)
        du = du.reshape(-1, C)
        got.update(da=ta.grad, db=tb.grad)
        want.update(da=_f32(daj).reshape(P, C).sum(0), db=_f32(dbj).reshape(P, C).sum(0))
        terms.update(da=(du * x_used.abs().reshape(-1, C)).sum(0), db=du.sum(0))
    else:
        assert ta is None and not np.any(_f32(daj)) and not np.any(_f32(dbj))
    return got, want, terms


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("prologue", [False, True], ids=["slim", "prologue"])
@pytest.mark.parametrize("xq_mode", [False, True], ids=["x", "xq"])
def test_q_backward_matches_cl_tpu(xq_mode, prologue, dtype_name, monkeypatch):
    got, want, terms = _backward_case(xq_mode, prologue, dtype_name, monkeypatch)
    for k in got:
        _close(got[k], want[k], terms[k], "float32" if k in ("da", "db") else dtype_name)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("xq_mode", [False, True], ids=["x", "xq"])
def test_q_backward_fallback_matches_cl_tpu(xq_mode, dtype_name, monkeypatch):
    """Where no tile fits, both dequantize y and x rounded to the compute
    dtype and take the two-pass backward (``_cbfq_bwd``, ``:1836-1858``),
    forced as ``tests/unit/test_conv_q.py`` forces it."""
    got, want, terms = _backward_case(xq_mode, True, dtype_name, monkeypatch, two_pass=True)
    for k in got:
        _close(got[k], want[k], terms[k], "float32" if k in ("da", "db") else dtype_name)


def test_conv1_keeps_conv0_int8_pair_not_its_input():
    """Under ``act_q`` a level's conv1 saves conv0's (q, scale) in place of
    its bf16 input, and every conv its own y as int8: no saved tensor of
    either is a bf16 activation."""
    level = DoubleConv(32, 32)
    x = torch.randn(1, 8, 128, 32).to(torch.bfloat16).requires_grad_(True)
    assert packed_gate.q_supported(128, P)
    y, _, _ = level.packed_plain(x, True, P, act_q=True)
    conv1 = y.grad_fn
    assert type(conv1).__name__ == "_ConvBNQBackward"
    conv0 = next(fn for fn, _ in conv1.next_functions if type(fn).__name__ == "_ConvBNQBackward")
    act = tuple(x.shape)  # conv0's and conv1's inputs and outputs: 32 -> 32 channels
    saved1 = [t.dtype for t in conv1.saved_tensors if t is not None and tuple(t.shape) == act]
    assert saved1 == [torch.int8, torch.int8]  # conv0's q (conv1's x) and conv1's own q
    # conv0's own input, from no int8 producer, is the one activation kept
    # in the compute dtype; conv0's y only as int8
    saved0 = [t for t in conv0.saved_tensors if t is not None and tuple(t.shape) == act]
    assert [t.dtype for t in saved0] == [torch.bfloat16, torch.int8]
    assert saved0[0].data_ptr() == x.data_ptr()


# ---------------------------------------------------------------------------
# Routes and launches, against cl_tpu's trace
# ---------------------------------------------------------------------------


def _jax_q_routes(args, monkeypatch):
    """cl_tpu's packed convs under ``jax.eval_shape`` of a train-mode
    gradient, ``q_supported`` at its chip's rule: Counter of
    (route, H) with route "q" or "dtype"."""
    jcfg = jax_parse(args)
    model = jax_train.build_model(jcfg)
    S, Bt = jcfg.data.image_size, jcfg.data.batch_size
    seen = collections.Counter()
    fused, fused_q = jconv.conv_bn_fused, jconv.conv_bn_fused_q

    def count_dtype(xp, *rest):
        seen[("dtype", xp.shape[1])] += 1
        return fused(xp, *rest)

    def count_q(xp, *rest):
        seen[("q", xp.shape[1])] += 1
        return fused_q(xp, *rest)

    monkeypatch.setattr(jconv, "q_supported", _chip_q_supported)
    monkeypatch.setattr(jconv, "conv_bn_fused", count_dtype)
    monkeypatch.setattr(jconv, "conv_bn_fused_q", count_q)
    x = jax.ShapeDtypeStruct((Bt, S, S, 3), jnp.float32)
    variables = jax.eval_shape(lambda v: model.init(jax.random.PRNGKey(0), v), x)
    seen.clear()

    def loss(params, stats, xx):
        out, _ = model.apply({"params": params, "batch_stats": stats}, xx, train=True,
                             mutable=["batch_stats"])
        return out.sum()

    jax.eval_shape(jax.grad(loss), variables["params"], variables["batch_stats"], x)
    return seen


def _port_q_routes(args):
    """The port's packed convs on the ``meta`` device in one train step:
    the same Counter, and the int8 kernels' calls (the plain versions that
    stand for 32q, #38 and #39)."""
    cfg = parse_overrides(args)
    model = port_train.build_model(cfg).to("meta").to(memory_format=torch.channels_last)
    S, Bt = cfg.data.image_size, cfg.data.batch_size
    seen, calls = collections.Counter(), collections.Counter()
    orig = {n: getattr(conv3x3, n) for n in ("conv_bn_fused", "conv_bn_fused_q",
                                              "quant_rows_plain", "conv_dx_q_plain",
                                              "conv_dw_q_plain")}

    def wrap(name):
        def fn(*a, **k):
            if name in ("conv_bn_fused", "conv_bn_fused_q"):
                seen[("q" if name.endswith("_q") else "dtype", a[0].shape[1])] += 1
            else:
                calls[name] += 1
            return orig[name](*a, **k)
        return fn

    try:
        for name in orig:
            setattr(conv3x3, name, wrap(name))
        out = model.train()(torch.empty(Bt, S, S, 3, device="meta"))
        out.sum().backward()
    finally:
        for name, fn in orig.items():
            setattr(conv3x3, name, fn)
    return seen, calls


@pytest.mark.parametrize("args,n_q,n_dtype", [
    # the headline step's body: every packed conv at 512², 256², 128²
    (["preset=baseline_1", "data.image_size=512", "data.source_size=576",
      "data.num_classes=19", "train.compute_dtype=bfloat16", "data.batch_size=1"], 15, 0),
    # baseline_1 with the packed body forced: level 0 only
    (["preset=baseline_1", "model.packed_min_size=0", "data.batch_size=1"], 5, 10),
], ids=["512-bf16", "128-f32"])
def test_q_routes_match_cl_tpu(args, n_q, n_dtype, monkeypatch):
    args = args + ["model.conv_act_store=int8", "train.data_parallel=false"]
    want = _jax_q_routes(args, monkeypatch)
    got, calls = _port_q_routes(args)
    assert got == want
    assert sum(n for (r, _), n in got.items() if r == "q") == n_q
    assert sum(n for (r, _), n in got.items() if r == "dtype") == n_dtype
    # a step's int8 launches: 32q and #39 for every int8 conv, #38 for all
    # but the stem's (the image's dx is never launched)
    assert calls == {"quant_rows_plain": n_q, "conv_dx_q_plain": n_q - 1,
                     "conv_dw_q_plain": n_q}, calls


# ---------------------------------------------------------------------------
# One packed SGD step with int8 against cl_tpu's
# ---------------------------------------------------------------------------

ARGS = ["preset=smoke", "data.num_classes=3", "model.base_channels=32", "model.depth=2",
        "data.image_size=128", "data.source_size=160", "data.batch_size=2",
        "model.packed_min_size=0", "model.conv_act_store=int8", "train.optimizer=sgd",
        "train.lr=0.05", "train.data_parallel=false"]


@pytest.fixture(scope="module")
def q_step():
    """The port's and cl_tpu's state after one SGD step from the same
    variables and batch, each computed once, with the convs each package
    sent through the int8 route."""
    mp = pytest.MonkeyPatch()
    cfg, jcfg = parse_overrides(ARGS), jax_parse(ARGS)
    model = port_train.init_state(cfg, port_train.build_model(cfg), CPU)
    assert model.packed_levels(128, 128) == 2 and model.act_q
    variables = export_jax_variables(model)
    step = port_train.make_train_step(cfg, model, port_train.build_optimizer(cfg, model), CPU)

    routes = {"port": collections.Counter(), "cl_tpu": collections.Counter()}
    fused_q, port_q = jconv.conv_bn_fused_q, conv3x3.conv_bn_fused_q
    mp.setattr(jconv, "q_supported", _chip_q_supported)
    mp.setattr(jconv, "conv_bn_fused_q", lambda xp, *r: routes["cl_tpu"].update(
        [xp.shape[2] * P]) or fused_q(xp, *r))
    mp.setattr(conv3x3, "conv_bn_fused_q", lambda x, *r: routes["port"].update(
        [x.shape[2]]) or port_q(x, *r))
    try:
        jmodel = jax_train.build_model(jcfg)
        assert jmodel.packed and jmodel.act_q
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
    finally:
        mp.undo()
    return {"loss": (aux["loss"].item(), float(jaux["loss"])), "routes": routes,
            "before": dict(jax.tree_util.tree_leaves_with_path(variables)),
            "got": dict(jax.tree_util.tree_leaves_with_path(export_jax_variables(model))),
            "want": jax.tree_util.tree_leaves_with_path(
                {"params": state.params, **state.model_state})}


def test_q_step_routes(q_step):
    """Level 0's five convs (128 wide) take the int8 route in both
    packages, level 1's (64 wide: wg 16) the compute dtype's."""
    assert q_step["routes"]["port"] == q_step["routes"]["cl_tpu"] == {128: 5}


def test_q_step_loss_and_params(q_step):
    got, want = q_step["loss"]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    got = q_step["got"]
    assert len(got) == len(q_step["want"])
    for path, leaf in q_step["want"]:
        np.testing.assert_allclose(got[path], np.asarray(leaf), rtol=1e-4, atol=1e-4,
                                   err_msg=str(path))


def test_q_step_updates(q_step):
    """Each leaf's update, (after - before), within 1e-2 of its norm plus
    one f32 ulp of the leaf per element (as the packed train tests)."""
    before, got = q_step["before"], q_step["got"]
    for path, leaf in q_step["want"]:
        want = np.asarray(leaf, np.float64)
        want_d = want - before[path]
        got_d = np.asarray(got[path], np.float64) - before[path]
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 23)
        norm = np.linalg.norm(want_d)
        assert norm > 0, f"{path}: the step left it unchanged"
        assert np.linalg.norm(got_d - want_d) <= 1e-2 * norm + np.linalg.norm(ulp), (
            path, np.linalg.norm(got_d - want_d) / norm)
