"""The port's packed BN·ReLU + head + CE (#7/#8) and its KD form (#11/#12)
against ``cl_tpu``'s, on the CPU.

The plain versions (what the autograd Functions run on a CPU tensor) are
held against ``cl_tpu.pallas.head_ce.head_cross_entropy_packed_bn`` and
``head_cross_entropy_kd_packed_bn`` (``jax.vjp`` in interpret mode, as the
JAX package's own tests run them) on the same numpy inputs: the JAX
operand is the port's NHWC raw output reshaped to [B, H, W/p, p·Cin].
Tolerances:

- the losses: 1e-5 relative (f32 sums over pixels in another order);
- dx: f32 1e-5; bf16 two ulps of dx plus the f32 floor (the head's dz is
  an f32 sum over classes in another order and may round to the other
  bf16 neighbour, which dx = round(du·scale) carries);
- sums over pixels (dscale, dshift, dW, db): 1e-5 of Σ|term|, plus in
  bf16 2^-7 of the largest term (one term whose rounded factor flipped).

Then the plain #7/#8 against the port's own ``bn_relu`` → head+CE
composition (the same operations: bit for bit), the KD against
``losses.kd_loss`` on materialized logits, task 0's zero teacher, and one
packed SGD step with the packed head (the default
``train.packed_head_ce=true``) against ``cl_tpu.train.make_train_step``:
loss, params and batch stats within 1e-4, each leaf's update within 1e-2
of its norm plus one f32 ulp. Each JAX output is computed once per module.
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
from cl_tpu.pallas import head_ce as jhead
from cl_tpu_torch import losses
from cl_tpu_torch import train as port_train
from cl_tpu_torch.config import parse_overrides
from cl_tpu_torch.data import pipeline
from cl_tpu_torch.interop import export_jax_variables
from cl_tpu_torch.kernels import head_ce, packed_eltwise
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, H, W, CIN, C, P, T = 2, 8, 32, 32, 5, 4, 2.0
VALID = np.array([1, 1, 1, 1, 0], bool)      # class 4 outside valid
OLD_VALID = np.array([1, 1, 0, 0, 0], bool)  # a strict subset


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_ulp(x):
    mag = np.maximum(np.abs(x), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _close_dx(got, want, dtype_name):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    if dtype_name == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    else:
        tol = 2 * _bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + 1e-7
        assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


def _close_sum(got, want, terms, dtype_name):
    got, want, terms = _f32(got), _f32(want), np.asarray(terms, np.float32)
    assert got.shape == want.shape == terms.shape[1:], (got.shape, terms.shape)
    tol = 1e-5 * np.abs(terms).sum(0) + 1e-7
    if dtype_name == "bfloat16":
        tol = tol + 2.0 ** -7 * np.abs(terms).max(0)
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


def _operands(seed, dtype_name):
    """Seeded numpy operands: raw NHWC features, BN vectors (some shifts
    negative, so some pre-activations are <= 0), head, ignore labels."""
    rng = np.random.RandomState(seed)
    raw = rng.randn(B, H, W, CIN).astype(np.float32)
    scale = (rng.rand(CIN) + 0.5).astype(np.float32)
    shift = (rng.randn(CIN) * 0.5).astype(np.float32)
    kern = (rng.randn(1, 1, CIN, C) * 0.3).astype(np.float32)   # flax layout
    bias = (rng.randn(C) * 0.1).astype(np.float32)
    labels = rng.randint(0, C - 1, (B, H, W)).astype(np.int32)  # valid classes
    labels[rng.rand(B, H, W) < 0.1] = 255
    jd, td = DTYPES[dtype_name]
    raw = np.array(jnp.asarray(raw).astype(jd).astype(jnp.float32))  # representable
    return {"raw": raw, "scale": scale, "shift": shift, "kern": kern, "bias": bias,
            "labels": labels, "jd": jd, "td": td}


def _port_head(kern):
    """flax [1, 1, Cin, C] -> the port's [C, Cin, 1, 1]."""
    return torch.from_numpy(np.ascontiguousarray(kern[0, 0].T)).reshape(C, CIN, 1, 1)


def _leaf(arr, requires_grad=True, dtype=None):
    t = torch.from_numpy(np.array(arr, np.float32))
    if dtype is not None:
        t = t.to(dtype)
    return t.requires_grad_(requires_grad)


# ---------------------------------------------------------------------------
# #7/#8 against head_cross_entropy_packed_bn
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def bn_case(request):
    dtype_name = request.param
    o = _operands(3, dtype_name)
    jd = o["jd"]
    packed = jnp.asarray(o["raw"]).astype(jd).reshape(B, H, W // P, P * CIN)
    lbl, valid = jnp.asarray(o["labels"]), jnp.asarray(VALID)

    def f(r, s, t, k, b):
        return jhead.head_cross_entropy_packed_bn(r, s, t, k, b, lbl, valid, p=P)[0]

    loss, vjp = jax.vjp(f, packed, jnp.asarray(o["scale"]), jnp.asarray(o["shift"]),
                        jnp.asarray(o["kern"]), jnp.asarray(o["bias"]))
    dr, ds, dt, dk, db = vjp(jnp.float32(1.0))
    return {"o": o, "dtype": dtype_name, "jax": {
        "loss": float(loss), "dx": _f32(dr).reshape(B, H, W, CIN), "dscale": _f32(ds),
        "dshift": _f32(dt), "dw": _f32(dk)[0, 0].T.reshape(C, CIN, 1, 1), "db": _f32(db)}}


def _port_bn(o, fused=True):
    """The port's loss and gradients through autograd on the CPU: the
    packed head (#7/#8's plain versions) or the bn_relu → head+CE
    composition."""
    raw = _leaf(o["raw"], dtype=o["td"])
    s, t = _leaf(o["scale"]), _leaf(o["shift"])
    k, b = _leaf(_port_head(o["kern"]).numpy()), _leaf(o["bias"])
    lbl, valid = torch.from_numpy(o["labels"]), torch.from_numpy(VALID)
    if fused:
        loss, n = head_ce.head_cross_entropy_packed_bn(raw, s, t, k, b, lbl, valid)
    else:
        z = packed_eltwise.bn_relu(raw, s, t)
        loss, n = head_ce.head_cross_entropy(z, k, b, lbl, valid)
    loss.backward()
    return loss, {"dx": raw.grad, "dscale": s.grad, "dshift": t.grad, "dw": k.grad,
                  "db": b.grad}, n


def _bn_terms(o, grads):
    """Per-pixel terms of each pixel sum (for the tolerance of a sum taken
    in another order): du·y, du, gc ⊗ z, g."""
    y = torch.from_numpy(o["raw"]).to(o["td"]).float().reshape(-1, CIN)
    s, t = torch.from_numpy(o["scale"]), torch.from_numpy(o["shift"])
    dx = grads["dx"].float().reshape(-1, CIN)
    du = dx / s  # |du| up to a rounding, on the pixels where t > 0
    z = torch.relu(y * s + t)
    n = float((o["labels"] != 255).sum())
    logits = head_ce._logits_plain(z.to(o["td"]), _port_head(o["kern"]).reshape(C, CIN),
                                   torch.from_numpy(o["bias"]), torch.from_numpy(VALID).float())
    g = head_ce._ce_g(logits, torch.from_numpy(o["labels"]).reshape(-1),
                      torch.from_numpy(VALID).float(), 1.0 / n, 255)
    return {"dscale": (du * y).numpy(), "dshift": du.numpy(),
            "dw": (g[:, :, None] * z[:, None, :]).numpy()[..., None, None],
            "db": g.numpy()}


def test_packed_bn_loss(bn_case):
    loss, _, n = _port_bn(bn_case["o"])
    assert float(n) == float((bn_case["o"]["labels"] != 255).sum())
    np.testing.assert_allclose(loss.item(), bn_case["jax"]["loss"], rtol=1e-5)


def test_packed_bn_grads(bn_case):
    o, want, dtype_name = bn_case["o"], bn_case["jax"], bn_case["dtype"]
    _, got, _ = _port_bn(o)
    assert got["dx"].dtype == o["td"]
    _close_dx(got["dx"], want["dx"], dtype_name)
    terms = _bn_terms(o, got)
    for name in ("dscale", "dshift", "dw", "db"):
        _close_sum(got[name], want[name], terms[name], dtype_name)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_packed_bn_equals_bn_relu_then_head(dtype_name):
    """The port's own composition, the same operations: loss, dx, dW and db
    bit for bit; dscale and dshift within one f32 ulp of each term (JAX's
    promise at head_ce.py:470-477; the plain versions meet it exactly)."""
    o = _operands(5, dtype_name)
    lf, gf, _ = _port_bn(o, fused=True)
    lc, gc, _ = _port_bn(o, fused=False)
    assert lf.item() == lc.item()
    for name in ("dx", "dw", "db"):
        np.testing.assert_array_equal(_f32(gf[name]), _f32(gc[name]), err_msg=name)
    terms = _bn_terms(o, gc)
    for name in ("dscale", "dshift"):
        ulp = np.spacing(np.abs(terms[name]).astype(np.float32)).sum(0)
        assert np.all(np.abs(_f32(gf[name]) - _f32(gc[name])) <= ulp), name


# ---------------------------------------------------------------------------
# #11/#12 against head_cross_entropy_kd_packed_bn
# ---------------------------------------------------------------------------


def _teacher(seed, dtype_name):
    rng = np.random.RandomState(seed)
    jd = DTYPES[dtype_name][0]
    traw = np.array(jnp.asarray(rng.randn(B, H, W, CIN).astype(np.float32)).astype(jd)
                    .astype(jnp.float32))
    return {"traw": traw, "tscale": (rng.rand(CIN) + 0.5).astype(np.float32),
            "tshift": (rng.randn(CIN) * 0.5).astype(np.float32),
            "tkern": (rng.randn(1, 1, CIN, C) * 0.3).astype(np.float32),
            "tbias": (rng.randn(C) * 0.1).astype(np.float32)}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def kd_case(request):
    dtype_name = request.param
    o = _operands(7, dtype_name)
    o.update(_teacher(8, dtype_name))
    jd = o["jd"]
    view = (B, H, W // P, P * CIN)
    jraw = jnp.asarray(o["raw"]).astype(jd).reshape(view)
    jtraw = jnp.asarray(o["traw"]).astype(jd).reshape(view)
    lbl, valid, ov = (jnp.asarray(o["labels"]), jnp.asarray(VALID), jnp.asarray(OLD_VALID))

    def f(r, s, t, k, b):
        ce, kd, _ = jhead.head_cross_entropy_kd_packed_bn(
            r, s, t, k, b, jtraw, jnp.asarray(o["tscale"]), jnp.asarray(o["tshift"]),
            jnp.asarray(o["tkern"]), jnp.asarray(o["tbias"]), lbl, valid, ov, p=P,
            temperature=T)
        return ce, kd

    (ce, kd), vjp = jax.vjp(f, jraw, jnp.asarray(o["scale"]), jnp.asarray(o["shift"]),
                            jnp.asarray(o["kern"]), jnp.asarray(o["bias"]))
    dr, ds, dt, dk, db = vjp((jnp.float32(1.0), jnp.float32(0.7)))
    return {"o": o, "dtype": dtype_name, "jax": {
        "ce": float(ce), "kd": float(kd), "dx": _f32(dr).reshape(B, H, W, CIN),
        "dscale": _f32(ds), "dshift": _f32(dt), "dw": _f32(dk)[0, 0].T.reshape(C, CIN, 1, 1),
        "db": _f32(db)}}


def _port_kd(o, old_valid=OLD_VALID):
    raw = _leaf(o["raw"], dtype=o["td"])
    s, t = _leaf(o["scale"]), _leaf(o["shift"])
    k, b = _leaf(_port_head(o["kern"]).numpy()), _leaf(o["bias"])
    traw = torch.from_numpy(o["traw"]).to(o["td"])
    tk = _port_head(o["tkern"])
    ce, kd, n = head_ce.head_cross_entropy_kd_packed_bn(
        raw, s, t, k, b, traw, torch.from_numpy(o["tscale"]), torch.from_numpy(o["tshift"]),
        tk, torch.from_numpy(o["tbias"]), torch.from_numpy(o["labels"]),
        torch.from_numpy(VALID), torch.from_numpy(old_valid), temperature=T)
    (ce + 0.7 * kd).backward()
    return ce, kd, n, {"dx": raw.grad, "dscale": s.grad, "dshift": t.grad, "dw": k.grad,
                       "db": b.grad}


def test_packed_kd_losses(kd_case):
    ce, kd, _, _ = _port_kd(kd_case["o"])
    np.testing.assert_allclose(ce.item(), kd_case["jax"]["ce"], rtol=1e-5)
    np.testing.assert_allclose(kd.item(), kd_case["jax"]["kd"], rtol=1e-5)
    assert kd.item() > 0


def test_packed_kd_grads(kd_case):
    o, want, dtype_name = kd_case["o"], kd_case["jax"], kd_case["dtype"]
    _, _, _, got = _port_kd(o)
    _close_dx(got["dx"], want["dx"], dtype_name)
    # the KD term's cotangent joins g: the CE terms bound it no more, so
    # the sums' terms come from the port's own dx and dW factors
    y = torch.from_numpy(o["raw"]).to(o["td"]).float().reshape(-1, CIN)
    s = torch.from_numpy(o["scale"])
    du = got["dx"].float().reshape(-1, CIN) / s
    z = torch.relu(y * s + torch.from_numpy(o["shift"]))
    gmax = (1.0 + 0.7 * T) / float((o["labels"] != 255).sum())  # |g| bound per class
    g = torch.full((y.shape[0], C), gmax)
    terms = {"dscale": (du * y).numpy(), "dshift": du.numpy(),
             "dw": (g[:, :, None] * z[:, None, :]).numpy()[..., None, None], "db": g.numpy()}
    for name in ("dscale", "dshift", "dw", "db"):
        _close_sum(got[name], want[name], terms[name], dtype_name)


def test_packed_kd_equals_kd_loss_on_logits(kd_case):
    """ce and kd against the CE and ``losses.kd_loss`` of the two
    materialized logit tensors."""
    o = kd_case["o"]
    ce, kd, n, _ = _port_kd(o)
    td = o["td"]

    def logits(raw, sc, sh, kern, bias):
        z = packed_eltwise.bn_relu_plain(torch.from_numpy(raw).to(td), torch.from_numpy(sc),
                                         torch.from_numpy(sh))
        return head_ce._logits_plain(z.reshape(-1, CIN), _port_head(kern).reshape(C, CIN),
                                     torch.from_numpy(bias), None).reshape(B, H, W, C)

    new = logits(o["raw"], o["scale"], o["shift"], o["kern"], o["bias"])
    old = logits(o["traw"], o["tscale"], o["tshift"], o["tkern"], o["tbias"])
    lbl, valid = torch.from_numpy(o["labels"]), torch.from_numpy(VALID)
    ce_ref, n_ref = losses.cross_entropy(new, lbl, valid)
    # the student's logits enter the KD masked by valid, as in the kernel
    kd_ref = losses.kd_loss(losses.mask_logits(new, valid), old, torch.from_numpy(OLD_VALID),
                            lbl, temperature=T)
    assert n.item() == n_ref.item()
    np.testing.assert_allclose(ce.item(), ce_ref.item(), rtol=1e-5)
    np.testing.assert_allclose(kd.item(), kd_ref.item(), rtol=1e-5)


def test_task0_zero_teacher_kd_is_exactly_zero():
    """Task 0: a zero teacher (raw, BN vectors and head all zero), no old
    class, weight 0: the loss is finite, the KD exactly 0 (uniform
    softmaxes on both sides) and every gradient finite."""
    o = _operands(9, "bfloat16")
    o.update({"traw": np.zeros((B, H, W, CIN), np.float32),
              "tscale": np.zeros(CIN, np.float32), "tshift": np.zeros(CIN, np.float32),
              "tkern": np.zeros((1, 1, CIN, C), np.float32), "tbias": np.zeros(C, np.float32)})
    ce, kd, _, grads = _port_kd(o, old_valid=np.zeros(C, bool))
    assert kd.item() == 0.0 and np.isfinite(ce.item())
    assert (0.0 * kd).item() == 0.0
    for name, g in grads.items():
        assert bool(torch.isfinite(g.float()).all()), name


# ---------------------------------------------------------------------------
# One packed SGD step with the packed head against cl_tpu's
# ---------------------------------------------------------------------------

ARGS = ["preset=smoke", "data.num_classes=3", "model.base_channels=32", "model.depth=2",
        "data.image_size=64", "data.source_size=80", "model.packed_min_size=0",
        "train.optimizer=sgd", "train.lr=0.05", "train.data_parallel=false"]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def headline_step():
    """The port's and cl_tpu's state after one SGD step with the packed
    head+CE, from the same variables and batch, each computed once."""
    cfg, jcfg = parse_overrides(ARGS), jax_parse(ARGS)
    assert port_train.packed_head_on(cfg) and jcfg.train.packed_head_ce
    model = port_train.init_state(cfg, port_train.build_model(cfg), CPU)
    assert model.packed_levels(64, 64) == 2
    variables = export_jax_variables(model)
    step = port_train.make_train_step(cfg, model, port_train.build_optimizer(cfg, model), CPU)

    jmodel = jax_train.build_model(jcfg)
    tx = jax_train.build_optimizer(jcfg)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = jax_train.TrainState(
        step=jnp.int32(0), params=params,
        model_state={"batch_stats": jax.tree.map(jnp.asarray, variables["batch_stats"])},
        opt_state=tx.init(params), ewc=None, lwf=None, rng=jax.random.PRNGKey(0))
    jstep = jax_train.make_train_step(jcfg, jmodel, tx, mesh=None)

    calls = []
    real = head_ce.head_cross_entropy_packed_bn
    head_ce.head_cross_entropy_packed_bn = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        hb = next(iter(pipeline.train_batches(cfg, 0, 0)))
        valid = jax_tasks.valid_class_mask(3, jax_tasks.seen_classes(jcfg.classes_per_task, 0))
        aux = step(pipeline.put_batch(hb, CPU), torch.from_numpy(valid))
    finally:
        head_ce.head_cross_entropy_packed_bn = real
    state, jaux = jstep(state, jax_pipeline.HostBatch(*(jnp.asarray(a) for a in hb)),
                        jnp.asarray(valid))
    return {"calls": len(calls), "loss": (aux["loss"].item(), float(jaux["loss"])),
            "n_pix": (float(aux["n_pix"]), float(jaux["n_pix"])),
            "before": dict(jax.tree_util.tree_leaves_with_path(variables)),
            "got": dict(jax.tree_util.tree_leaves_with_path(export_jax_variables(model))),
            "want": jax.tree_util.tree_leaves_with_path(
                {"params": state.params, **state.model_state})}


def check_step(res):
    """Loss within 1e-4; every param and batch stat within 1e-4; each
    leaf's update (after - before) within 1e-2 of its norm plus one f32
    ulp of the leaf per element (``test_torch_packed_train.py``)."""
    got_l, want_l = res["loss"]
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4, atol=1e-4)
    assert res["n_pix"][0] == res["n_pix"][1]
    before, got = res["before"], res["got"]
    assert len(got) == len(res["want"])
    for path, leaf in res["want"]:
        want = np.asarray(leaf, np.float64)
        np.testing.assert_allclose(got[path], want, rtol=1e-4, atol=1e-4, err_msg=str(path))
        want_d = want - before[path]
        got_d = np.asarray(got[path], np.float64) - before[path]
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 23)
        norm = np.linalg.norm(want_d)
        assert norm > 0, f"{path}: the step left it unchanged"
        assert np.linalg.norm(got_d - want_d) <= 1e-2 * norm + np.linalg.norm(ulp), (
            path, np.linalg.norm(got_d - want_d) / norm)


def test_headline_step_takes_the_packed_head(headline_step):
    assert headline_step["calls"] == 1


def test_headline_step_matches_cl_tpu(headline_step):
    check_step(headline_step)
