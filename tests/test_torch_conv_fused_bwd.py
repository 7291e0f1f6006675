"""The packed conv's backward under ``CL_TPU_FUSE_BWD`` and ``CL_TPU_DX_PIPE``
and the packed head+CE without a prologue (#5/#6) against ``cl_tpu``'s, on
the CPU.

- Gate parity: for each setting of the two switches, the port's branch
  (``packed_gate.conv_bwd_branch``) equals the one ``cl_tpu``'s gates
  imply (``_pick_th_bwdf`` under ``_FUSE_BWD``, then ``_pick_th_dx`` with
  ``_DX_PIPE`` patched and ``_pick_th_dw2``), integer arithmetic only; the
  flips the switches cause at the presets' shapes are pinned.
- #37's plain version (``conv3x3.conv_bwd_fused_plain``) against
  ``jax.vjp`` of ``conv3x3_v3.conv_bn_fused`` with ``_FUSE_BWD`` on, in
  interpret mode, at p = 4 and p = 1, f32 and bf16, prologue on and off,
  at ``tests/test_torch_packed_train.py``'s tolerances: dx f32 1e-5, bf16
  one ulp plus the f32 floor; sums over pixels 1e-5 of Σ|term|, plus one
  bf16 ulp of the dW it rounds to once.
- A conv whose default branch is two-pass and whose ``FUSE_BWD`` branch is
  one-pass (the 20 MiB budget of both packages lowered): the port takes
  #37 and the fused rounding (the f32 dt into the prologue's backward).
- One packed SGD step with ``FUSE_BWD`` on both sides against
  ``cl_tpu.train.make_train_step``: loss, params and batch stats within
  1e-4, each leaf's update within 1e-2 of its norm plus one f32 ulp.
- #5/#6's plain versions against ``jax.vjp`` of
  ``head_ce.head_cross_entropy_packed`` (C = 19 with a head of 12 padded,
  ignore labels), at ``tests/test_torch_packed_head.py``'s tolerances; and
  ``head_cross_entropy_packed_bn(raw, s, sh)`` equal to
  ``head_cross_entropy_packed(bn_relu(raw, s, sh))`` bit for bit.
"""

import itertools

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
from cl_tpu.pallas import head_ce as jhead
from cl_tpu_torch import train as port_train
from cl_tpu_torch.config import parse_overrides
from cl_tpu_torch.data import pipeline
from cl_tpu_torch.interop import export_jax_variables
from cl_tpu_torch.kernels import conv3x3, head_ce, packed_eltwise
from cl_tpu_torch.models import packed_gate
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CPU = torch.device("cpu")
SWITCHES = [(False, False), (False, True), (True, False), (True, True)]


def _randn(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_ulp(x):
    mag = np.maximum(np.abs(x), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _close_rounded(got, want, dtype_name, scale=1.0):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    if dtype_name == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    else:
        tol = _bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + 1e-5 * scale
        assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


def _close_sum(got, want, terms, ulps=0.0):
    got, want, terms = _f32(got), _f32(want), _f32(terms)
    assert got.shape == want.shape == terms.shape
    tol = 1e-5 * terms + 1e-6 + ulps * _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


# ---------------------------------------------------------------------------
# Gate parity
# ---------------------------------------------------------------------------


def _jax_branch(h, w, c_in, c_out, p, itemsize, prologue, fuse):
    """The branch ``_cbf_bwd`` takes (``conv3x3_v3.py:930-961``), from its
    own tile pickers (``_DX_PIPE`` already patched by the caller)."""
    wg = w // p
    lanes, lanes_x = p * c_out, p * c_in
    kdx, kdw = (p + 2) * c_out, (p + 2) * c_in
    if fuse and jconv._pick_th_bwdf(h, wg, lanes, lanes_x, kdx, kdw, itemsize, prologue) > 0:
        return "one_pass"
    th = jconv._pick_th_dx(h, wg, lanes, kdx, lanes_x, itemsize, prologue)
    th_dw2 = jconv._pick_th_dw2(h, wg, lanes_x, kdw, p, c_out, itemsize)
    return "fused" if th > 0 and th_dw2 > 0 else "two_pass"


def _switch(monkeypatch, fuse, pipe):
    monkeypatch.setattr(packed_gate, "FUSE_BWD", fuse)
    monkeypatch.setattr(packed_gate, "DX_PIPE", pipe)
    monkeypatch.setattr(jconv, "_DX_PIPE", pipe)


@pytest.mark.parametrize("fuse,pipe", SWITCHES,
                         ids=[f"fuse{int(f)}-pipe{int(p)}" for f, p in SWITCHES])
def test_branch_matches_cl_tpu(fuse, pipe, monkeypatch):
    _switch(monkeypatch, fuse, pipe)
    seen = set()
    for h, c_in, c_out, itemsize, prologue in itertools.product(
            (16, 24, 32, 64, 128, 256, 512), (32, 64, 128, 256, 512), (32, 64, 128, 256, 512),
            (2, 4), (False, True)):
        p = packed_gate.pick_pack(c_in, c_out)
        want = _jax_branch(h, h, c_in, c_out, p, itemsize, prologue, fuse)
        got = packed_gate.conv_bwd_branch(h, h, c_in, c_out, p, itemsize, prologue)
        assert got == want, (h, c_in, c_out, itemsize, prologue, got, want)
        seen.add(got)
    # under FUSE_BWD every conv the fused branch would take runs one-pass
    assert seen == ({"one_pass", "two_pass"} if fuse else {"fused", "two_pass"})


# the headline body's 15 convs at 512², P = 4: (H, Cin of the packed view,
# Cout, prologue); the stem's 3 channels are viewed at 128 / P = 32
HEADLINE_CONVS = [(512, 32, 32, False), (512, 32, 32, True), (512, 32, 32, True),
                  (512, 32, 32, False), (512, 32, 32, False), (256, 32, 64, False),
                  (256, 64, 64, True), (256, 64, 64, True), (256, 64, 64, False),
                  (256, 64, 64, False), (128, 64, 128, False), (128, 128, 128, True),
                  (128, 128, 128, True), (128, 128, 128, False), (128, 128, 128, False)]


def test_branch_flips_at_the_presets(monkeypatch):
    """What the switches change at the presets' shapes, from ``cl_tpu``'s
    gates and the port's alike: under FUSE_BWD every headline conv takes
    #37 (15 a step); under DX_PIPE every one stays fused (its 14 dx, the
    stem's excluded, pipelined); level 2 of baseline_2 with
    ``model.packed_min_size=0`` (64², 256 -> 256 with the prologue, P = 2,
    f32) is two-pass by default and one-pass under FUSE_BWD; under
    DX_PIPE the third dy slot turns f32 256² 128 -> 128 and 512² 64 -> 64
    with the prologue from fused to two-pass."""
    def both(*args):
        fuse = packed_gate.FUSE_BWD
        want = _jax_branch(args[0], args[0], *args[1:], fuse)
        got = packed_gate.conv_bwd_branch(args[0], args[0], *args[1:])
        assert got == want, (args, got, want)
        return got

    for fuse, pipe in SWITCHES:
        _switch(monkeypatch, fuse, pipe)
        for itemsize in (2, 4):
            branches = [both(h, ci, co, 4, itemsize, pro) for h, ci, co, pro in HEADLINE_CONVS]
            assert branches == ["one_pass" if fuse else "fused"] * 15, (fuse, pipe, itemsize)
        b2 = both(64, 256, 256, 2, 4, True)
        assert b2 == ("one_pass" if fuse else "two_pass"), (fuse, pipe)
        for h, c, p in ((256, 128, 1), (512, 64, 2)):
            assert both(h, c, c, p, 4, True) == \
                ("one_pass" if fuse else "two_pass" if pipe else "fused"), (fuse, pipe, h)


def test_int8_backward_ignores_fuse_bwd(monkeypatch):
    """``_cbfq_bwd`` never reads ``_FUSE_BWD``: under the switch the int8
    conv keeps its own backward, and the dtype conv takes #37."""
    monkeypatch.setattr(packed_gate, "FUSE_BWD", True)
    calls = []
    plain = conv3x3.conv_bwd_fused_plain
    monkeypatch.setattr(conv3x3, "conv_bwd_fused_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    rng = np.random.RandomState(3)
    x = torch.from_numpy(_randn(rng, 1, 8, 32, 32))
    w = torch.from_numpy(_randn(rng, 32, 32, 3, 3, scale=0.06)).requires_grad_(True)
    y, s1, _, _ = conv3x3.conv_bn_fused_q(x, None, w, None, None, False, 4)
    (y.float().square().sum() + s1.sum()).backward()
    assert calls == [] and torch.isfinite(w.grad).all()
    w.grad = None
    y, s1, _ = conv3x3.conv_bn_fused(x, w, None, None, False, 4)
    (y.float().square().sum() + s1.sum()).backward()
    assert calls == [1] and torch.isfinite(w.grad).all()


# ---------------------------------------------------------------------------
# #37's plain version against jax.vjp of conv_bn_fused under _FUSE_BWD
# ---------------------------------------------------------------------------


def _jax_conv_grads(x, w, a, b, dy, ds1, ds2, p, prologue, dtype_name):
    """cl_tpu's y and (dx, dW, da, db) per channel from ``jax.vjp`` of
    ``conv_bn_fused`` on the packed view; ``w`` in the port's layout."""
    B, H, W, cin = x.shape
    cout = w.shape[0]
    jd = DTYPES[dtype_name][0]
    fn = lambda xp, k, al, bl: jconv.conv_bn_fused(xp, k, al, bl, p, prologue)  # noqa: E731
    (yj, _, _), vjp = jax.vjp(fn, jnp.asarray(x).astype(jd).reshape(B, H, W // p, p * cin),
                              jnp.asarray(w.transpose(2, 3, 1, 0)).astype(jd),
                              jnp.tile(jnp.asarray(a), p), jnp.tile(jnp.asarray(b), p))
    dxj, dkj, daj, dbj = vjp((jnp.asarray(dy).astype(jd).reshape(yj.shape),
                              jnp.tile(jnp.asarray(ds1), p), jnp.tile(jnp.asarray(ds2), p)))
    return (np.array(_f32(yj)).reshape(B, H, W, cout), _f32(dxj).reshape(B, H, W, cin),
            _f32(dkj).transpose(3, 2, 0, 1), _f32(daj).reshape(p, cin).sum(0),
            _f32(dbj).reshape(p, cin).sum(0))


def _conv_case(shape, prologue, dtype_name, seed):
    B, H, W, cin, cout = shape
    rng = np.random.RandomState(seed)
    x = _randn(rng, B, H, W, cin)
    w = _randn(rng, cout, cin, 3, 3, scale=(9 * cin) ** -0.5)
    a = (rng.rand(cin) + 0.5).astype(np.float32)
    b = (rng.rand(cin) * 0.5 - 0.1).astype(np.float32)  # some u <= 0
    dy = _randn(rng, B, H, W, cout)
    ds1, ds2 = _randn(rng, cout, scale=0.5), _randn(rng, cout, scale=0.2)
    if not prologue:
        a, b = np.ones(cin, np.float32), np.zeros(cin, np.float32)
    return x, w, a, b, dy, ds1, ds2


def _check_one_pass(got, want, ops, prologue, dtype_name):
    """got (port) and want (cl_tpu) as (dx, dW, da, db), each held at its
    tolerance with Σ|term| from the plain versions on |operands|."""
    tx, tw, ta, tb, ty, tdy, tds1, tds2 = ops
    dx, dw, da, db = got
    dxj, dwj, daj, dbj = want
    e = conv3x3.dy_eff(tdy, ty, tds1, tds2).float().abs()
    dt = conv3x3.conv3x3_plain(e, conv3x3._flip_t(tw.abs()))
    scale = float(ta.max()) if prologue else 1.0
    _close_rounded(dx, dxj, dtype_name, scale=scale)
    t = conv3x3.prologue_t(tx, ta, tb, prologue).float().abs()
    _close_sum(dw, dwj, conv3x3.conv3x3_dw_plain(t, e),
               ulps=1.0 if dtype_name == "bfloat16" else 0.0)
    if prologue:
        du = torch.where(tx.float() * ta + tb > 0, dt, 0.0).reshape(-1, tx.shape[-1])
        _close_sum(da, daj, (du * tx.float().abs().reshape(du.shape)).sum(0))
        _close_sum(db, dbj, du.sum(0))
    else:
        np.testing.assert_array_equal(_f32(da), 0.0)
        np.testing.assert_array_equal(daj, 0.0)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("prologue", [False, True], ids=["slim", "prologue"])
@pytest.mark.parametrize("shape,p", [((2, 8, 32, 32, 32), 4), ((1, 8, 8, 128, 128), 1)],
                         ids=["p4", "p1"])
def test_one_pass_backward_matches_cl_tpu(shape, p, prologue, dtype_name, monkeypatch):
    B, H, W, cin, cout = shape
    itemsize = 4 if dtype_name == "float32" else 2
    assert packed_gate.pick_pack(cin, cout) == p
    monkeypatch.setattr(jconv, "_FUSE_BWD", True)
    monkeypatch.setattr(packed_gate, "FUSE_BWD", True)
    assert packed_gate.conv_bwd_branch(H, W, cin, cout, p, itemsize, prologue) == "one_pass"
    x, w, a, b, dy, ds1, ds2 = _conv_case(shape, prologue, dtype_name, 37 + prologue + p)
    yj, *want = _jax_conv_grads(x, w, a, b, dy, ds1, ds2, p, prologue, dtype_name)
    td = DTYPES[dtype_name][1]
    # the port's operands with cl_tpu's y (the forward is held apart)
    ops = (torch.from_numpy(x).to(td), torch.from_numpy(w), torch.from_numpy(a),
           torch.from_numpy(b), torch.from_numpy(yj).to(td), torch.from_numpy(dy).to(td),
           torch.from_numpy(ds1), torch.from_numpy(ds2))
    dx, da, db, dw = conv3x3.conv_bwd_fused_plain(*ops, prologue)
    assert dx.dtype == td and dw.dtype == torch.float32
    _check_one_pass((dx, dw, da, db), want, ops, prologue, dtype_name)
    # without dx (the stem) the same dW, and no dx
    dx0, _, _, dw0 = conv3x3.conv_bwd_fused_plain(*ops, prologue, need_dx=False)
    assert dx0 is None and torch.equal(dw0, dw)

    # the autograd Function takes the one-pass branch: one call, its outputs
    calls = []
    plain = conv3x3.conv_bwd_fused_plain
    monkeypatch.setattr(conv3x3, "conv_bwd_fused_plain",
                        lambda *a_, **k_: calls.append(k_) or plain(*a_, **k_))
    tx = ops[0].clone().requires_grad_(True)
    tw = ops[1].clone().requires_grad_(True)
    ta, tb = (ops[2].clone().requires_grad_(prologue), ops[3].clone().requires_grad_(prologue))
    y, s1, s2 = conv3x3.conv_bn_fused(tx, tw, ta if prologue else None,
                                      tb if prologue else None, prologue, p)
    torch.autograd.backward([y, s1, s2], [ops[5], ops[6], ops[7]])
    assert calls == [{"need_dx": True}]
    assert tx.grad.dtype == td and torch.isfinite(tx.grad.float()).all()
    assert torch.isfinite(tw.grad).all() and (not prologue or torch.isfinite(ta.grad).all())


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_two_pass_conv_takes_one_pass_under_fuse_bwd(dtype_name, monkeypatch):
    """Both 20 MiB budgets lowered to what the forward's tile needs, so the
    fused dx and dW find no tile (the default branch is two-pass) while the
    one-pass tile, at its own 64 MiB budget, fits: under FUSE_BWD both
    packages take #37, and the port's gradients follow the fused rounding
    (dt into the prologue's backward in f32), not the two-pass one."""
    B, H, W, c, P = 2, 16, 32, 32, 4
    itemsize = 4 if dtype_name == "float32" else 2
    wg = W // P
    budget = packed_gate._conv_vmem(H, wg, P * c, (P + 2) * c, P, c, itemsize)
    monkeypatch.setattr(jconv, "_VMEM_BUDGET", budget)
    monkeypatch.setattr(packed_gate, "CONV_VMEM_BUDGET", budget)
    assert packed_gate.conv_bwd_branch(H, W, c, c, P, itemsize, True) == "two_pass"
    assert _jax_branch(H, W, c, c, P, itemsize, True, False) == "two_pass"
    monkeypatch.setattr(jconv, "_FUSE_BWD", True)
    monkeypatch.setattr(packed_gate, "FUSE_BWD", True)
    assert packed_gate.conv_bwd_branch(H, W, c, c, P, itemsize, True) == "one_pass"
    assert _jax_branch(H, W, c, c, P, itemsize, True, True) == "one_pass"

    x, w, a, b, dy, ds1, ds2 = _conv_case((B, H, W, c, c), True, dtype_name, 71)
    _, *want = _jax_conv_grads(x, w, a, b, dy, ds1, ds2, P, True, dtype_name)
    td = DTYPES[dtype_name][1]
    tx = torch.from_numpy(x).to(td).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    y, s1, s2 = conv3x3.conv_bn_fused(tx, tw, ta, tb, True, P)
    tdy, tds1, tds2 = torch.from_numpy(dy).to(td), torch.from_numpy(ds1), torch.from_numpy(ds2)
    torch.autograd.backward([y, s1, s2], [tdy, tds1, tds2])
    ops = (tx.detach(), tw.detach(), ta.detach(), tb.detach(), y.detach(), tdy, tds1, tds2)
    _check_one_pass((tx.grad, tw.grad, ta.grad, tb.grad), want, ops, True, dtype_name)
    fused = conv3x3.conv_dx_plain(*ops, True)
    two = conv3x3._two_pass_backward(True, False, True, *ops[:4], y.detach(), tdy, tds1, tds2)
    assert torch.equal(tx.grad, fused[0])
    if dtype_name == "bfloat16":  # the two-pass branch rounds dt first: other bits
        assert not torch.equal(tx.grad, two[0])


# ---------------------------------------------------------------------------
# One packed SGD step under FUSE_BWD against cl_tpu's
# ---------------------------------------------------------------------------

ARGS = ["preset=smoke", "data.num_classes=3", "model.base_channels=32", "model.depth=2",
        "data.image_size=64", "data.source_size=80", "model.packed_min_size=0",
        "train.optimizer=sgd", "train.lr=0.05", "train.data_parallel=false"]


@pytest.fixture(scope="module")
def fused_step():
    """The port's and cl_tpu's state after one SGD step with the one-pass
    backward on both sides, from the same variables and batch."""
    cfg, jcfg = parse_overrides(ARGS), jax_parse(ARGS)
    calls, jcalls = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconv, "_FUSE_BWD", True)
        mp.setattr(packed_gate, "FUSE_BWD", True)
        plain, jimpl = conv3x3.conv_bwd_fused_plain, jconv._bwd_fused_impl
        mp.setattr(conv3x3, "conv_bwd_fused_plain",
                   lambda *a, **k: calls.append(k["need_dx"]) or plain(*a, **k))
        mp.setattr(jconv, "_bwd_fused_impl", lambda *a: jcalls.append(1) or jimpl(*a))
        model = port_train.init_state(cfg, port_train.build_model(cfg), CPU)
        assert model.packed_levels(64, 64) == 2
        variables = export_jax_variables(model)
        step = port_train.make_train_step(cfg, model, port_train.build_optimizer(cfg, model),
                                          CPU)
        jmodel = jax_train.build_model(jcfg)
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
        jax.block_until_ready(state.params)
    return {"loss": (aux["loss"].item(), float(jaux["loss"])), "calls": calls,
            "jcalls": jcalls,
            "before": dict(jax.tree_util.tree_leaves_with_path(variables)),
            "got": dict(jax.tree_util.tree_leaves_with_path(export_jax_variables(model))),
            "want": jax.tree_util.tree_leaves_with_path(
                {"params": state.params, **state.model_state})}


def test_fused_step_takes_one_pass(fused_step):
    """Every packed conv of both bodies (2 levels: 2 encoder and 3 decoder
    convs each) takes #37; the stem's without dx."""
    assert fused_step["calls"] == [True] * 9 + [False]
    assert len(fused_step["jcalls"]) == 10


def test_fused_step_loss_and_params(fused_step):
    got, want = fused_step["loss"]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert len(fused_step["got"]) == len(fused_step["want"])
    for path, leaf in fused_step["want"]:
        np.testing.assert_allclose(fused_step["got"][path], np.asarray(leaf), rtol=1e-4,
                                   atol=1e-4, err_msg=str(path))


def test_fused_step_updates(fused_step):
    """Each leaf's update within 1e-2 of its norm plus one f32 ulp per
    element (``test_torch_packed_train.test_packed_train_step_updates``)."""
    before, got = fused_step["before"], fused_step["got"]
    for path, leaf in fused_step["want"]:
        want = np.asarray(leaf, np.float64)
        want_d = want - before[path]
        got_d = np.asarray(got[path], np.float64) - before[path]
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 23)
        norm = np.linalg.norm(want_d)
        assert norm > 0, f"{path}: the step left it unchanged"
        assert np.linalg.norm(got_d - want_d) <= 1e-2 * norm + np.linalg.norm(ulp), (
            path, np.linalg.norm(got_d - want_d) / norm)


# ---------------------------------------------------------------------------
# #5/#6: the packed head+CE without a prologue
# ---------------------------------------------------------------------------

HB, HH, HW, HCIN, HC, HP, WIDTH = 2, 8, 32, 32, 19, 4, 12
HVALID = np.arange(HC) < 10  # classes 10-18 masked; the head's 12 padded to 19


def _head_operands(seed, dtype_name):
    rng = np.random.RandomState(seed)
    jd, td = DTYPES[dtype_name]
    x = np.array(jnp.asarray(_randn(rng, HB, HH, HW, HCIN)).astype(jd).astype(jnp.float32))
    kern = _randn(rng, 1, 1, HCIN, WIDTH, scale=0.3)  # flax layout
    bias = _randn(rng, WIDTH, scale=0.1)
    labels = rng.randint(0, 10, (HB, HH, HW)).astype(np.int32)
    labels[rng.rand(HB, HH, HW) < 0.1] = 255
    return {"x": x, "kern": kern, "bias": bias, "labels": labels, "jd": jd, "td": td}


def _port_kernel(kern):
    """flax [1, 1, Cin, width] -> the port's [width, Cin, 1, 1]."""
    return torch.from_numpy(np.ascontiguousarray(kern[0, 0].T)).reshape(WIDTH, HCIN, 1, 1)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pk_case(request):
    dtype_name = request.param
    o = _head_operands(11, dtype_name)
    lbl, valid = jnp.asarray(o["labels"]), jnp.asarray(HVALID)

    def f(x, k, b):
        return jhead.head_cross_entropy_packed(x, k, b, lbl, valid, p=HP)[0]

    xp = jnp.asarray(o["x"]).astype(o["jd"]).reshape(HB, HH, HW // HP, HP * HCIN)
    loss, vjp = jax.vjp(f, xp, jnp.asarray(o["kern"]), jnp.asarray(o["bias"]))
    dx, dk, db = vjp(jnp.float32(1.0))
    return {"o": o, "dtype": dtype_name, "jax": {
        "loss": float(loss), "dx": _f32(dx).reshape(HB, HH, HW, HCIN),
        "dw": _f32(dk)[0, 0].T.reshape(WIDTH, HCIN, 1, 1), "db": _f32(db)}}


def _port_pk(o):
    x = torch.from_numpy(o["x"]).to(o["td"]).requires_grad_(True)
    k = _port_kernel(o["kern"]).requires_grad_(True)
    b = torch.from_numpy(o["bias"]).requires_grad_(True)
    loss, n = head_ce.head_cross_entropy_packed(x, k, b, torch.from_numpy(o["labels"]),
                                                torch.from_numpy(HVALID), p=HP)
    loss.backward()
    return loss, n, {"dx": x.grad, "dw": k.grad, "db": b.grad}


def test_packed_head_loss(pk_case):
    loss, n, _ = _port_pk(pk_case["o"])
    assert float(n) == float((pk_case["o"]["labels"] != 255).sum())
    np.testing.assert_allclose(loss.item(), pk_case["jax"]["loss"], rtol=1e-5)


def test_packed_head_grads(pk_case):
    """dx: f32 1e-5, bf16 two ulps (dx = round(gc·W), an f32 sum over
    classes in another order); dW, db: 1e-5 of Σ|term|, plus in bf16 2^-7
    of the largest term (one term whose rounded g flipped)."""
    o, want, dtype_name = pk_case["o"], pk_case["jax"], pk_case["dtype"]
    _, _, got = _port_pk(o)
    assert got["dx"].dtype == o["td"]
    gx, wx = _f32(got["dx"]), want["dx"]
    if dtype_name == "float32":
        np.testing.assert_allclose(gx, wx, rtol=1e-5, atol=1e-7)
    else:
        assert np.all(np.abs(gx - wx) <= 2 * _bf16_ulp(np.maximum(np.abs(gx), np.abs(wx)))
                      + 1e-7)
    x = torch.from_numpy(o["x"]).reshape(-1, HCIN)
    w, b = head_ce._head_args(_port_kernel(o["kern"]), torch.from_numpy(o["bias"]), HCIN, HC)
    lbl, valid = torch.from_numpy(o["labels"]).reshape(-1), torch.from_numpy(HVALID).float()
    n = float((o["labels"] != 255).sum())
    g = head_ce._ce_g(head_ce._logits_plain(x.to(o["td"]), w, b, valid), lbl, valid, 1.0 / n,
                      255)[:, :WIDTH]
    terms = {"dw": (g[:, :, None] * x[:, None, :]).abs().numpy()[..., None, None],
             "db": g.abs().numpy()}
    for name in ("dw", "db"):
        got_v, want_v = _f32(got[name]), want[name]
        tol = 1e-5 * terms[name].sum(0) + 1e-7
        if dtype_name == "bfloat16":
            tol = tol + 2.0 ** -7 * terms[name].max(0)
        assert got_v.shape == want_v.shape
        assert np.all(np.abs(got_v - want_v) <= tol), (name, np.abs(got_v - want_v).max())


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_packed_bn_equals_bn_relu_then_packed_head(dtype_name):
    """``head_cross_entropy_packed_bn(raw, s, sh)`` is
    ``head_cross_entropy_packed(bn_relu(raw, s, sh))`` bit for bit (the
    JAX package's docstring, ``head_ce.py:1128``): the loss and every
    gradient, raw's, scale's and shift's included."""
    o = _head_operands(13, dtype_name)
    rng = np.random.RandomState(14)
    s0, t0 = (rng.rand(HCIN) + 0.5).astype(np.float32), _randn(rng, HCIN, scale=0.5)
    lbl, valid = torch.from_numpy(o["labels"]), torch.from_numpy(HVALID)
    out = []
    for fused in (True, False):
        raw = torch.from_numpy(o["x"]).to(o["td"]).requires_grad_(True)
        s, t = torch.from_numpy(s0).requires_grad_(True), torch.from_numpy(t0).requires_grad_(True)
        k = _port_kernel(o["kern"]).requires_grad_(True)
        b = torch.from_numpy(o["bias"]).requires_grad_(True)
        if fused:
            loss, _ = head_ce.head_cross_entropy_packed_bn(raw, s, t, k, b, lbl, valid)
        else:
            z = packed_eltwise.bn_relu(raw, s, t)
            loss, _ = head_ce.head_cross_entropy_packed(z, k, b, lbl, valid, p=HP)
        loss.backward()
        out.append([loss, raw.grad, s.grad, t.grad, k.grad, b.grad])
    for name, u, v in zip(("loss", "draw", "dscale", "dshift", "dw", "db"), *out):
        assert torch.equal(u, v), name


def test_packed_head_checks_p():
    x = torch.zeros(1, 2, 6, 32)
    with pytest.raises(ValueError, match="multiple of p"):
        head_ce.head_cross_entropy_packed(x, torch.zeros(3, 32, 1, 1), torch.zeros(3),
                                          torch.zeros(1, 2, 6, dtype=torch.int32),
                                          torch.ones(3, dtype=torch.bool), p=4)
