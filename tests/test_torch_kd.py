"""LwF off the packed head, in the port against ``cl_tpu``'s, on the CPU:
the KD on materialized logits (#13/#14), the KD head on NHWC features
(#9/#10), and one LwF step on each route that takes them.

- #13/#14's plain versions (what ``kernels.kd_loss.kd_loss`` runs on a CPU
  tensor) against ``cl_tpu.pallas.kd_loss.kd_loss`` in interpret mode, the
  value and ``jax.vjp``'s cotangent of the new logits, f32 and bf16, C ∈
  {3, 5, 19}, ragged P with ~10% ignore pixels, T = 2 and T = 3 (1/3 is not
  exact, so the multiply-then-mask order of ``kd_loss.py`` shows), two old
  classes or none. Tolerances: the value 1e-5 relative (f32 sums in another
  order); the cotangent in f32 1e-5 relative plus 1e-7, in bf16 one bf16
  ulp plus the f32 floor (an f32 value in another order may round to the
  other neighbour).
- #9/#10's plain versions against ``jax.vjp`` of
  ``cl_tpu.pallas.head_ce.head_cross_entropy_kd``, f32 and bf16, Cin ∈ {8,
  32, 64}, a class masked by ``valid``, a teacher unlike the student: (ce,
  kd, n), dx, dW and db with the tolerances of
  ``test_torch_packed_head.py``'s #11/#12 tests; a zero teacher on task 0
  gives a KD of exactly 0; the teacher gets no gradient.
- One LwF SGD step per route against ``cl_tpu.train.make_train_step`` from
  the same student, a perturbed teacher with its own BatchNorm statistics,
  weight 1 and ``old_valid`` = task 0's classes: the KD head on NHWC
  features with the packed body on and ``train.packed_head_ce=false``
  (64², base 32, depth 2), with the body off by config (``preset=smoke``,
  32², base 8) and where it declines at run time (the same with
  ``model.packed_min_size=0``); the KD on logits (``train.fused_head_ce=
  false``) in f32 and in bf16. Loss, the KD term, params and batch
  statistics within 1e-4, each leaf's update within 1e-2 of its norm
  (``test_torch_packed_head.check_step``); the bf16 step's tolerances are
  derived from bf16's unit roundoff (``check_bf16_step``).
Each ``cl_tpu`` output is computed once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_tpu.pallas import head_ce as jhead
from cl_tpu.pallas import kd_loss as jkd
from cl_tpu_torch import losses
from cl_tpu_torch.kernels import ce_loss, head_ce, kd_loss

from test_torch_lwf import lwf_step_against_cl_tpu
from test_torch_packed_head import _bf16_ulp, _close_dx, _close_sum, _f32, check_step
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
def _representable(a, dtype_name):
    """``a`` rounded through the dtype and back to f32 (both packages then
    see the same values)."""
    return np.array(jnp.asarray(a).astype(DTYPES[dtype_name][0]).astype(jnp.float32))


def _labels(rng, shape, n_classes):
    labels = rng.randint(0, n_classes, shape).astype(np.int32)
    labels[rng.rand(*shape) < 0.1] = 255
    return labels


# ---------------------------------------------------------------------------
# #13/#14 against cl_tpu.pallas.kd_loss.kd_loss
# ---------------------------------------------------------------------------

KD_CASES = [(dt, C, T, "two") for dt in ("float32", "bfloat16") for C in (3, 5, 19)
            for T in (3.0,)] + [(dt, 5, 2.0, ov) for dt in ("float32", "bfloat16")
                                for ov in ("two", "none")]


@pytest.fixture(scope="module", params=KD_CASES, ids=lambda c: f"{c[0]}-C{c[1]}-T{c[2]:g}-{c[3]}")
def logits_case(request):
    """Ragged P (2·7·9 = 126 pixels, not a multiple of a tile), ~10% ignore
    pixels, old_valid the first two classes or none; cl_tpu's value and
    cotangent of the new logits for a cotangent of 0.7."""
    dtype_name, C, T, ov = request.param
    rng = np.random.RandomState(C * 10 + int(T))
    shape = (2, 7, 9)
    new = _representable(rng.randn(*shape, C) * 2, dtype_name)
    old = _representable(rng.randn(*shape, C) * 2, dtype_name)
    labels = _labels(rng, shape, C)
    old_valid = np.zeros(C, bool)
    if ov == "two":
        old_valid[:2] = True
    jd = DTYPES[dtype_name][0]
    jold, jlbl, jov = jnp.asarray(old).astype(jd), jnp.asarray(labels), jnp.asarray(old_valid)
    val, vjp = jax.vjp(lambda z: jkd.kd_loss(z, jold, jov, jlbl, temperature=T),
                       jnp.asarray(new).astype(jd))
    (dnew,) = vjp(jnp.float32(0.7))
    return {"dtype": dtype_name, "T": T, "new": new, "old": old, "labels": labels,
            "old_valid": old_valid, "jax": (float(val), dnew)}


def _port_kd_loss(c):
    td = DTYPES[c["dtype"]][1]
    new = torch.from_numpy(c["new"]).to(td).requires_grad_(True)
    old = torch.from_numpy(c["old"]).to(td)
    loss = kd_loss.kd_loss(new, old, torch.from_numpy(c["old_valid"]),
                           torch.from_numpy(c["labels"]), temperature=c["T"])
    (0.7 * loss).backward()
    return loss, new.grad


def test_kd_on_logits_value(logits_case):
    loss, _ = _port_kd_loss(logits_case)
    want = logits_case["jax"][0]
    if not logits_case["old_valid"].any():
        assert loss.item() == want == 0.0
    else:
        assert want > 0
        np.testing.assert_allclose(loss.item(), want, rtol=1e-5)


def test_kd_on_logits_gradient(logits_case):
    _, got = _port_kd_loss(logits_case)
    want = logits_case["jax"][1]
    assert got.dtype == DTYPES[logits_case["dtype"]][1]
    assert str(want.dtype) == logits_case["dtype"]
    got, want = _f32(got), _f32(want)
    if not logits_case["old_valid"].any():
        assert not got.any() and not want.any()
    elif logits_case["dtype"] == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    else:
        tol = _bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + 1e-7
        assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()
    assert not got[..., ~logits_case["old_valid"]].any()  # 0 outside old_valid


def test_kd_on_logits_gives_the_teacher_no_gradient():
    new = torch.randn(2, 3, 3, 4, requires_grad=True)
    old = torch.randn(2, 3, 3, 4, requires_grad=True)
    ov = torch.tensor([True, True, False, False])
    loss = kd_loss.kd_loss(new, old, ov, torch.zeros(2, 3, 3, dtype=torch.long),
                           temperature=2.0)
    loss.backward()
    assert old.grad is None and new.grad is not None
    # at T = 2 (1/T exact) the kernels' arithmetic is losses.kd_loss's
    np.testing.assert_allclose(loss.item(), losses.kd_loss(
        new, old, ov, torch.zeros(2, 3, 3), temperature=2.0).item(), rtol=1e-6)


# ---------------------------------------------------------------------------
# #9/#10 against head_cross_entropy_kd
# ---------------------------------------------------------------------------

B, H, W, C, T = 2, 8, 8, 5, 2.0
VALID = np.array([1, 1, 1, 1, 0], bool)      # class 4 outside valid
OLD_VALID = np.array([1, 1, 0, 0, 0], bool)  # a strict subset


def _head_operands(seed, cin, dtype_name, zero_teacher=False):
    rng = np.random.RandomState(seed)
    o = {"x": _representable(rng.randn(B, H, W, cin), dtype_name),
         "kern": (rng.randn(1, 1, cin, C) * 0.3).astype(np.float32),
         "bias": (rng.randn(C) * 0.1).astype(np.float32),
         "xt": _representable(rng.randn(B, H, W, cin) * 1.5, dtype_name),
         "tkern": (rng.randn(1, 1, cin, C) * 0.3).astype(np.float32),
         "tbias": (rng.randn(C) * 0.1).astype(np.float32),
         "labels": _labels(rng, (B, H, W), C - 1), "cin": cin, "dtype": dtype_name}
    if zero_teacher:
        for k in ("xt", "tkern", "tbias"):
            o[k] = np.zeros_like(o[k])
    return o


@pytest.fixture(scope="module", params=[(dt, cin) for dt in ("float32", "bfloat16")
                                        for cin in (8, 32, 64)],
                ids=lambda p: f"{p[0]}-Cin{p[1]}")
def head_case(request):
    dtype_name, cin = request.param
    o = _head_operands(cin, cin, dtype_name)
    jd = DTYPES[dtype_name][0]
    lbl, valid, ov = jnp.asarray(o["labels"]), jnp.asarray(VALID), jnp.asarray(OLD_VALID)
    jxt = jnp.asarray(o["xt"]).astype(jd)

    def f(x, k, b):
        ce, kd, n = jhead.head_cross_entropy_kd(
            x, k, b, jxt, jnp.asarray(o["tkern"]), jnp.asarray(o["tbias"]), lbl, valid, ov,
            temperature=T)
        return ce, kd, n

    (ce, kd, n), vjp = jax.vjp(f, jnp.asarray(o["x"]).astype(jd), jnp.asarray(o["kern"]),
                               jnp.asarray(o["bias"]))
    dx, dk, db = vjp((jnp.float32(1.0), jnp.float32(0.7), jnp.float32(0.0)))
    return {"o": o, "jax": {"ce": float(ce), "kd": float(kd), "n": float(n),
                            "dx": _f32(dx), "dw": _f32(dk)[0, 0].T, "db": _f32(db)}}


def _port_head_kd(o, old_valid=OLD_VALID):
    td = DTYPES[o["dtype"]][1]
    cin = o["cin"]
    x = torch.from_numpy(o["x"]).to(td).requires_grad_(True)
    k = torch.from_numpy(np.ascontiguousarray(o["kern"][0, 0].T)).reshape(C, cin, 1, 1)
    k.requires_grad_(True)
    b = torch.from_numpy(o["bias"]).requires_grad_(True)
    xt = torch.from_numpy(o["xt"]).to(td).requires_grad_(True)
    tk = torch.from_numpy(np.ascontiguousarray(o["tkern"][0, 0].T)).reshape(C, cin, 1, 1)
    tk.requires_grad_(True)
    tb = torch.from_numpy(o["tbias"]).requires_grad_(True)
    ce, kd, n = head_ce.head_cross_entropy_kd(
        x, k, b, xt, tk, tb, torch.from_numpy(o["labels"]), torch.from_numpy(VALID),
        torch.from_numpy(old_valid), temperature=T)
    (ce + 0.7 * kd).backward()
    return ce, kd, n, {"dx": x.grad, "dw": k.grad.reshape(C, cin), "db": b.grad,
                       "teacher": (xt.grad, tk.grad, tb.grad)}


def test_kd_head_losses(head_case):
    ce, kd, n, _ = _port_head_kd(head_case["o"])
    want = head_case["jax"]
    assert n.item() == want["n"] == float((head_case["o"]["labels"] != 255).sum())
    np.testing.assert_allclose(ce.item(), want["ce"], rtol=1e-5)
    np.testing.assert_allclose(kd.item(), want["kd"], rtol=1e-5)
    assert kd.item() > 0


def test_kd_head_grads(head_case):
    o, want = head_case["o"], head_case["jax"]
    _, _, _, got = _port_head_kd(o)
    assert got["dx"].dtype == DTYPES[o["dtype"]][1]
    assert got["teacher"] == (None, None, None)  # the teacher gets no gradient
    _close_dx(got["dx"], want["dx"], o["dtype"])
    # |g| per class is at most (1 + 0.7·T)/n: the terms of the sums over pixels
    x = torch.from_numpy(o["x"]).reshape(-1, o["cin"])
    gmax = (1.0 + 0.7 * T) / float((o["labels"] != 255).sum())
    g = torch.full((x.shape[0], C), gmax)
    terms = {"dw": (g[:, :, None] * x[:, None, :]).numpy(), "db": g.numpy()}
    for name in ("dw", "db"):
        _close_sum(got[name], want[name], terms[name], o["dtype"])


def test_kd_head_equals_kd_loss_on_logits():
    """ce and kd against the CE and ``losses.kd_loss`` of the two
    materialized logit tensors (the student's masked by valid)."""
    o = _head_operands(3, 32, "float32")
    ce, kd, n, _ = _port_head_kd(o)

    def logits(x, kern, bias):
        return head_ce._logits_plain(torch.from_numpy(x).reshape(-1, 32),
                                     torch.from_numpy(np.ascontiguousarray(kern[0, 0].T)),
                                     torch.from_numpy(bias), None).reshape(B, H, W, C)

    new, old = logits(o["x"], o["kern"], o["bias"]), logits(o["xt"], o["tkern"], o["tbias"])
    lbl, valid = torch.from_numpy(o["labels"]), torch.from_numpy(VALID)
    ce_ref, n_ref = losses.cross_entropy(new, lbl, valid)
    kd_ref = losses.kd_loss(losses.mask_logits(new, valid), old, torch.from_numpy(OLD_VALID),
                            lbl, temperature=T)
    assert n.item() == n_ref.item()
    np.testing.assert_allclose(ce.item(), ce_ref.item(), rtol=1e-6)
    np.testing.assert_allclose(kd.item(), kd_ref.item(), rtol=1e-6)


def test_kd_head_task0_zero_teacher_is_exactly_zero():
    """Task 0: a zero teacher and no old class: the KD is exactly 0, the CE
    and every gradient finite, and the gradients those of the CE alone."""
    o = _head_operands(4, 32, "bfloat16", zero_teacher=True)
    ce, kd, _, grads = _port_head_kd(o, old_valid=np.zeros(C, bool))
    assert kd.item() == 0.0 and np.isfinite(ce.item())
    td = DTYPES["bfloat16"][1]
    x = torch.from_numpy(o["x"]).to(td).requires_grad_(True)
    k = torch.from_numpy(np.ascontiguousarray(o["kern"][0, 0].T)).reshape(C, 32, 1, 1)
    k.requires_grad_(True)
    b = torch.from_numpy(o["bias"]).requires_grad_(True)
    ce_only, _ = head_ce.head_cross_entropy(x, k, b, torch.from_numpy(o["labels"]),
                                            torch.from_numpy(VALID))
    ce_only.backward()
    assert ce_only.item() == ce.item()
    for name, t in (("dx", x.grad), ("dw", k.grad.reshape(C, 32)), ("db", b.grad)):
        assert torch.equal(grads[name], t), name


# ---------------------------------------------------------------------------
# One LwF SGD step per route against cl_tpu's
# ---------------------------------------------------------------------------

SMOKE = ["preset=smoke", "data.num_classes=3", "train.optimizer=sgd", "train.lr=0.05",
         "train.data_parallel=false", "train.num_tasks=2", "method.methods=lwf"]
PACKED = ["preset=smoke", "data.num_classes=3", "model.base_channels=32", "model.depth=2",
          "data.image_size=64", "data.source_size=80", "model.packed_min_size=0",
          "train.optimizer=sgd", "train.lr=0.05", "train.data_parallel=false",
          "train.num_tasks=2", "method.methods=lwf"]
ROUTES = {  # route: (overrides, the port's loss entry it takes)
    "nhwc-head-packed-body": (PACKED + ["train.packed_head_ce=false"], "head_kd"),
    "nhwc-head-body-off": (SMOKE, "head_kd"),
    "nhwc-head-body-declines": (SMOKE + ["model.packed_min_size=0"], "head_kd"),
    "logits-f32": (SMOKE + ["train.fused_head_ce=false"], "logits_kd"),
    "logits-bf16": (SMOKE + ["train.fused_head_ce=false", "train.compute_dtype=bfloat16"],
                    "logits_kd"),
}


WATCH = {"head_kd": (head_ce, "head_cross_entropy_kd"),
         "head": (head_ce, "head_cross_entropy"),
         "packed_kd": (head_ce, "head_cross_entropy_kd_packed_bn"),
         "logits_kd": (kd_loss, "kd_loss"),
         "logits_ce": (ce_loss, "cross_entropy")}


@pytest.fixture(scope="module", params=list(ROUTES))
def route_step(request):
    args, entry = ROUTES[request.param]
    return {"route": request.param, "entry": entry, **lwf_step_against_cl_tpu(args, WATCH)}


def test_route_takes_its_kd_kernels(route_step):
    """One call of the route's KD entry, none of another loss; on the
    logits route the CE kernel once, and both logit tensors reach the KD
    kernel in the compute dtype (``cl_tpu/train.py:498-504``)."""
    calls = {k: len(v) for k, v in route_step["calls"].items()}
    assert calls[route_step["entry"]] == 1 and calls["packed_kd"] == 0
    assert calls["head"] == 0  # the KD form, never the CE alone
    assert calls["logits_ce"] == (route_step["entry"] == "logits_kd")
    if route_step["entry"] == "logits_kd":
        dt = torch.bfloat16 if route_step["route"] == "logits-bf16" else torch.float32
        assert route_step["calls"]["logits_kd"] == [(dt, dt)]


def test_route_keeps_the_kd_term(route_step):
    """aux["kd"] is there, nonzero and equal to cl_tpu's on every route
    (the fused-head and kernel-CE branches once returned none under LwF)."""
    assert route_step["has_kd"]
    got, want = route_step["kd"]
    assert want > 0 and got > 0
    # bf16: 4u, u = 2^-8 (check_bf16_step)
    rtol = 1e-4 if route_step["route"] != "logits-bf16" else 4 * 2.0 ** -8
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6)


def test_route_step_matches_cl_tpu(route_step):
    if route_step["route"] == "logits-bf16":
        check_bf16_step(route_step)
    else:
        check_step(route_step)


def check_bf16_step(route_step):
    """The KD on bf16 logits (both logit tensors cast to the compute dtype,
    ``cl_tpu/train.py:498-504``: ``test_route_takes_its_kd_kernels`` pins
    the dtypes the kernel gets). The two packages round each activation to
    bf16 at the same places but convolve in other orders, so an activation
    may sit one bf16 ulp (2u, unit roundoff u = 2^-8) from the other's.
    The loss and the KD term are means of many such values: within 4u
    relative. The logits' gradient reaches the head's kernel and bias
    through one product with the features, whose ulp flips average out
    over the pixels: each of their updates within 2u of its norm. The
    deeper leaves' gradients come back through every bf16 convolution of
    the backward; their drift (up to ~40% of an update at the bottleneck,
    whose updates are ~1e-4) is the two packages' bf16 convolutions, not
    the loss route, and the f32 routes hold those leaves."""
    u = 2.0 ** -8
    got_l, want_l = route_step["loss"]
    np.testing.assert_allclose(got_l, want_l, rtol=4 * u)
    assert route_step["n_pix"][0] == route_step["n_pix"][1]
    before, got = route_step["before"], route_step["got"]
    heads = [(path, leaf) for path, leaf in route_step["want"]
             if "'head'" in jax.tree_util.keystr(path)]
    assert len(heads) == 2
    for path, leaf in heads:
        want = np.asarray(leaf, np.float64)
        want_d, got_d = want - before[path], np.asarray(got[path], np.float64) - before[path]
        norm = np.linalg.norm(want_d)
        assert norm > 0, f"{path}: the step left it unchanged"
        assert np.linalg.norm(got_d - want_d) <= 2 * u * norm, (
            path, np.linalg.norm(got_d - want_d) / norm)
