"""``CL_TPU_E_BF16=1`` in the port against ``cl_tpu`` under ``_E_BF16``, on
the CPU: the bf16 elementwise chains of the packed conv (the prologue's t =
relu((x·a) + b) and the backward's e = (dy + ds1) + ((2·y)·ds2), each op
rounded to bf16, the vectors rounded first), ``cl_tpu`` in interpret mode
(``jax.vjp`` of ``conv_bn_fused`` / ``conv_bn_fused_q``, jitted once per
route and flag, its module globals set while it traces).

- Exact probes, bit for bit against ``cl_tpu``: the weight is the 3×3
  identity on the centre tap, so y = t and the dx conv returns e (dx = e,
  or round([u>0]·e·a) with the prologue); in a "t_pixel" probe x is zero
  but at one pixel and b < 0 (t = 0 elsewhere), in an "e_pixel" probe dy is
  zero but at one pixel and ds1 = ds2 = 0, so every dW entry is one f32
  product, rounded once. The fused branch (#32, #34, #35, #36), the
  one-pass #37 (``FUSE_BWD``), the two-pass branch (#33's t in bf16, its
  materialized e in f32) and #39 in x mode (t in bf16) and xq mode (t from
  deq(xq) in f32), each through the port's autograd Function. Each probe
  also shows that the flag changed some bits in both packages (in the xq
  mode: y, while dW keeps every bit). Where ``cl_tpu``'s f32 e from
  deq(y) or the materialized e would be an FMA on XLA's CPU, ds2 = 0 (and
  in the xq mode a is a power of two), so the f32 chains are exact too.
- Random operands (a random weight) under the flag, the port's plain
  versions fed ``cl_tpu``'s y, at the tolerances of the kernels' existing
  tests (``test_torch_conv_fused_bwd.py``, ``test_torch_conv_v3.py``,
  ``test_torch_conv_q.py``).
- f32 under the flag keeps every bit of f32 without it.
- The wrappers hand each bf16 entry point ``ew_bf16`` = 1 under the flag
  and 0 in f32 and in #39's xq mode (a fake library on CPU tensors).
- One bf16 SGD step of ``test_torch_packed_head.py``'s config (64², base
  32, depth 2) under the flag in both packages: the gap between them at
  most twice the gap of their default bf16 steps (the loss, and the worst
  leaf's update relative to its norm), and the port's flag step unlike its
  default one.
- ``check_supported`` accepts the flag and ``train()`` runs a step under
  it; unknown ``method.methods`` names are ignored, as ``cl_tpu`` ignores
  them.
- ``chip_smoke.py``'s phase 5u counts (each kernel's launches moved to its
  variant's key, #39's xq mode kept) and ``kernel_ab``'s dispatch of the
  variants' kernels that phase 6 times.
"""

import contextlib
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cl_tpu import train as jax_train
from cl_tpu.config import parse_overrides as jax_parse
from cl_tpu.data import pipeline as jax_pipeline
from cl_tpu.data import tasks as jax_tasks
from cl_tpu.pallas import conv3x3_v3 as jconv
from cl_tpu_torch import kernel_ab
from cl_tpu_torch import train as port_train
from cl_tpu_torch.config import parse_overrides
from cl_tpu_torch.data import pipeline
from cl_tpu_torch.data import tasks as task_lib
from cl_tpu_torch.interop import export_jax_variables
from cl_tpu_torch.kernels import build, conv3x3
from cl_tpu_torch.methods import ewc as ewc_lib
from cl_tpu_torch.models import packed_gate
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
BF = torch.bfloat16
B, H, W, C, P = 1, 8, 32, 32, 4  # P = pick_pack(32, 32): wg 8
PIX = (0, 3, 13)  # the probes' one pixel: all nine taps inside the image


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _bf16_ulp(x):
    mag = np.maximum(np.abs(x), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _close(got, want, terms, ulps=1.0):
    """|got − want| <= 1e-5·Σ|term| + 1e-6 + ``ulps`` bf16 ulps."""
    got, want, terms = _f32(got), _f32(want), _f32(terms)
    assert got.shape == want.shape == terms.shape
    tol = 1e-5 * terms + 1e-6 + ulps * _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


def _packed(a):
    """[B, H, W, c] → cl_tpu's packed view [B, H, W/P, P·c]."""
    return a.reshape(a.shape[0], a.shape[1], a.shape[2] // P, P * a.shape[3])


@contextlib.contextmanager
def _globals(mod, **values):
    saved = {k: getattr(mod, k) for k in values}
    for k, v in values.items():
        setattr(mod, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(mod, k, v)


def _two_pass_budget():
    """The 20 MiB budget lowered to what the forward's tile needs: the
    fused dx and dW find no tile, and the prologue conv takes the two-pass
    backward in both packages (``test_torch_conv_fused_bwd.py``'s)."""
    budget = packed_gate._conv_vmem(H, W // P, P * C, (P + 2) * C, P, C, 2)
    with _globals(packed_gate, CONV_VMEM_BUDGET=budget):
        assert packed_gate.conv_bwd_branch(H, W, C, C, P, 2, True) == "two_pass"
    return budget


# ---------------------------------------------------------------------------
# cl_tpu's side: one jitted vjp per route and flag
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("prologue", "flag", "fuse", "budget"))
def _jax_conv(xp, k, al, bl, dyp, d1, d2, *, prologue, flag, fuse, budget):
    """(y, dx, dk, da, db) of ``conv_bn_fused`` on the packed view, traced
    with ``_E_BF16`` = ``flag``, ``_FUSE_BWD`` = ``fuse`` and, where given,
    ``_VMEM_BUDGET`` = ``budget``."""
    with _globals(jconv, _E_BF16=flag, _FUSE_BWD=fuse,
                  _VMEM_BUDGET=budget or jconv._VMEM_BUDGET):
        (y, _, _), vjp = jax.vjp(lambda *a: jconv.conv_bn_fused(*a, P, prologue), xp, k, al, bl)
        return (y, *vjp((dyp, d1, d2)))


@functools.partial(jax.jit, static_argnames=("prologue", "flag"))
def _jax_conv_q(xp, xq, k, al, bl, dyp, d1, d2, *, prologue, flag):
    """(y, dx, dk, da, db) of ``conv_bn_fused_q``, ``xq`` the producer's
    (q, scale) in the packed view or None."""
    with _globals(jconv, _E_BF16=flag):
        fn = lambda *a: jconv.conv_bn_fused_q(a[0], xq, *a[1:], P, prologue)[:3]  # noqa: E731
        (y, _, _), vjp = jax.vjp(fn, xp, k, al, bl)
        return (y, *vjp((dyp, d1, d2)))


def _jax_grads(ops, prologue, flag, branch="fused", xq=None):
    """cl_tpu's (y, dx, dW, da, db) in the port's layouts, as f32 numpy."""
    x, w, a, b, dy, ds1, ds2 = ops
    args = (jnp.asarray(_packed(x)).astype(jnp.bfloat16),
            jnp.asarray(w.transpose(2, 3, 1, 0)).astype(jnp.bfloat16),
            jnp.tile(jnp.asarray(a), P), jnp.tile(jnp.asarray(b), P),
            jnp.asarray(_packed(dy)).astype(jnp.bfloat16),
            jnp.tile(jnp.asarray(ds1), P), jnp.tile(jnp.asarray(ds2), P))
    if branch == "int8":
        xq_j = None if xq is None else (jnp.asarray(_packed(xq[0].numpy())),
                                        jnp.asarray(xq[1].numpy().reshape(B, H, 1, P * C)))
        out = _jax_conv_q(args[0], xq_j, *args[1:], prologue=prologue, flag=flag)
    else:
        out = _jax_conv(*args, prologue=prologue, flag=flag, fuse=branch == "one_pass",
                        budget=_two_pass_budget() if branch == "two_pass" else None)
    y, dx, dk, da, db = (_f32(v) for v in out)
    return (y.reshape(B, H, W, C), dx.reshape(B, H, W, C), dk.transpose(3, 2, 0, 1),
            da.reshape(P, C).sum(0), db.reshape(P, C).sum(0))


# ---------------------------------------------------------------------------
# The port's side: the autograd Function under the same switches
# ---------------------------------------------------------------------------


def _port_grads(ops, prologue, flag, branch="fused", xq=None):
    """The port's (y, dx, dW, da, db) through ``conv_bn_fused`` (or
    ``conv_bn_fused_q``: ``branch`` "int8") on CPU tensors, with
    ``packed_gate.E_BF16`` = ``flag``."""
    x, w, a, b, dy, ds1, ds2 = (torch.from_numpy(v) for v in ops)
    tx = x.to(BF).requires_grad_(True)
    tw = w.requires_grad_(True)
    ta = a.clone().requires_grad_(True) if prologue else None
    tb = b.clone().requires_grad_(True) if prologue else None
    switches = dict(E_BF16=flag, FUSE_BWD=branch == "one_pass")
    if branch == "two_pass":
        switches["CONV_VMEM_BUDGET"] = _two_pass_budget()
    with _globals(packed_gate, **switches):
        if branch == "int8":
            y, s1, s2, _ = conv3x3.conv_bn_fused_q(tx, xq, tw, ta, tb, prologue, P)
        else:
            y, s1, s2 = conv3x3.conv_bn_fused(tx, tw, ta, tb, prologue, P)
        torch.autograd.backward([y, s1, s2], [dy.to(BF), ds1, ds2])
    zeros = torch.zeros(C)
    return tuple(_f32(v) for v in (y, tx.grad, tw.grad, ta.grad if prologue else zeros,
                                   tb.grad if prologue else zeros))


def _identity():
    w = np.zeros((C, C, 3, 3), np.float32)
    w[np.arange(C), np.arange(C), 1, 1] = 1.0
    return w


def _operands(kind, seed, ds2=True, pow2_a=False):
    """(x, w, a, b, dy, ds1, ds2) numpy f32: ``kind`` "identity" (random x,
    b partly negative), "t_pixel" (x zero but at PIX, b < 0) or "e_pixel"
    (dy zero but at PIX, ds1 = ds2 = 0), all with the identity weight, or
    "random" (a random weight). ``ds2`` False zeroes ds2; ``pow2_a`` draws
    a from {1/2, 1, 2}."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, C).astype(np.float32)
    a = (2.0 ** rng.randint(-1, 2, C) if pow2_a else rng.rand(C) + 0.5).astype(np.float32)
    b = (rng.rand(C) * 0.5 - 0.1).astype(np.float32)
    dy = rng.randn(B, H, W, C).astype(np.float32)
    ds1 = (rng.randn(C) * 0.5).astype(np.float32)
    ds2 = (rng.randn(C) * 0.2).astype(np.float32) if ds2 else np.zeros(C, np.float32)
    w = _identity() if kind != "random" else \
        (rng.randn(C, C, 3, 3) * (9 * C) ** -0.5).astype(np.float32)
    if kind == "t_pixel":
        x[:] = 0.0
        x[PIX] = 2.0 + np.abs(rng.randn(C))
        b = -(rng.rand(C) + 0.1).astype(np.float32)
    if kind == "e_pixel":
        dy[:] = 0.0
        dy[PIX] = rng.randn(C)
        ds1[:] = ds2[:] = 0.0
    return x, w, a, b, dy, ds1, ds2


# ---------------------------------------------------------------------------
# Exact probes
# ---------------------------------------------------------------------------

# (branch, prologue, kind, exact outputs among y, dx, dW, xq mode)
PROBES = {
    "fused-slim-identity": ("fused", False, "identity", ("y", "dx"), False),      # #34
    "fused-prologue-identity": ("fused", True, "identity", ("y", "dx"), False),   # #32, #35
    "fused-prologue-t_pixel": ("fused", True, "t_pixel", ("y", "dx", "dW"), False),  # #36
    "fused-prologue-e_pixel": ("fused", True, "e_pixel", ("y", "dx", "dW"), False),
    "one_pass-prologue-identity": ("one_pass", True, "identity", ("y", "dx"), False),  # #37
    "one_pass-prologue-t_pixel": ("one_pass", True, "t_pixel", ("y", "dx", "dW"), False),
    "one_pass-prologue-e_pixel": ("one_pass", True, "e_pixel", ("y", "dx", "dW"), False),
    "two_pass-prologue-identity": ("two_pass", True, "identity", ("y", "dx"), False),
    "two_pass-prologue-t_pixel": ("two_pass", True, "t_pixel", ("y", "dx", "dW"), False),  # #33
    "two_pass-prologue-e_pixel": ("two_pass", True, "e_pixel", ("y", "dx", "dW"), False),
    "int8-x-t_pixel": ("int8", True, "t_pixel", ("y", "dx", "dW"), False),        # #39 x
    "int8-x-e_pixel": ("int8", True, "e_pixel", ("y", "dx", "dW"), False),
    "int8-xq-t_pixel": ("int8", True, "t_pixel", ("y", "dx", "dW"), True),        # #39 xq
}
NAMES = ("y", "dx", "dW")


@pytest.fixture(scope="module")
def probes():
    """Per probe: {(package, flag): (y, dx, dW)}, each computed once."""
    out = {}
    for i, (pid, (branch, prologue, kind, _, xq_mode)) in enumerate(PROBES.items()):
        # the f32 e of the two-pass branch and of the int8 one: no ds2 (an
        # FMA on XLA's CPU would move it); the xq mode's f32 t: a power of 2
        f32_e = branch in ("two_pass", "int8")
        ops = _operands(kind, 100 + i, ds2=not f32_e, pow2_a=xq_mode)
        xq = conv3x3.quant_rows_plain(torch.from_numpy(ops[0]).to(BF), P) if xq_mode else None
        res = {}
        for flag in (False, True):
            res[("cl_tpu", flag)] = _jax_grads(ops, prologue, flag, branch, xq)[:3]
            res[("port", flag)] = _port_grads(ops, prologue, flag, branch, xq)[:3]
        out[pid] = res
    return out


@pytest.mark.parametrize("pid", list(PROBES))
def test_exact_probe(probes, pid):
    _, _, _, exact, xq_mode = PROBES[pid]
    res = probes[pid]
    for i, name in enumerate(NAMES):
        if name in exact:
            np.testing.assert_array_equal(res[("port", True)][i], res[("cl_tpu", True)][i],
                                          err_msg=f"{pid}: {name}")
    for pkg in ("port", "cl_tpu"):
        changed = [name for i, name in enumerate(NAMES) if name in exact and not np.array_equal(
            res[(pkg, True)][i], res[(pkg, False)][i])]
        if xq_mode:  # t from deq(xq) stays f32: only the forward's y moves
            assert changed == ["y"], (pkg, changed)
        else:
            assert changed, f"{pid}: the flag changed no bit in {pkg}"


# ---------------------------------------------------------------------------
# Random operands under the flag, at the existing kernels' tolerances
# ---------------------------------------------------------------------------


def _torch_ops(ops, yj):
    """The port's operands with cl_tpu's y (the forward is held apart)."""
    x, w, a, b, dy, ds1, ds2 = (torch.from_numpy(v) for v in ops)
    return x.to(BF), w, a, b, torch.from_numpy(yj).to(BF), dy.to(BF), ds1, ds2


def _terms(tops, prologue, q=None):
    """Σ|term| of dx (times max a), dW, da and db from the plain versions on
    |operands|: e = |dy_eff| (with deq(y) for the int8 path)."""
    tx, tw, ta, tb, ty, tdy, tds1, tds2 = tops
    y_used = ty if q is None else conv3x3.deq_rows(*q, P)
    e = conv3x3.dy_eff(tdy, y_used, tds1, tds2).float().abs()
    dt = conv3x3.conv3x3_plain(e, conv3x3._flip_t(tw.abs()))
    t = conv3x3.prologue_t(tx, ta, tb, prologue).float().abs()
    du = torch.where(tx.float() * ta + tb > 0, dt, 0.0).reshape(-1, C)
    return (dt * (float(ta.max()) if prologue else 1.0), conv3x3.conv3x3_dw_plain(t, e),
            (du * tx.float().abs().reshape(du.shape)).sum(0), du.sum(0))


@pytest.mark.parametrize("branch,prologue", [("fused", True), ("fused", False),
                                             ("one_pass", True), ("two_pass", True),
                                             ("int8", True)],
                         ids=["32-35-36", "34", "37", "33", "39"])
def test_random_operands(branch, prologue):
    """Under the flag: the forward's y (#32) at one bf16 ulp + 1e-5
    (``test_torch_packed.py``); the fused and one-pass dx at one bf16 ulp +
    1e-5·max a (``test_torch_conv_fused_bwd.py``), the two-pass and int8 dx
    at 1e-5 of Σ|term|·max a + 1e-6 + one bf16 ulp
    (``test_torch_conv_v3.py``, ``test_torch_conv_q.py``); dW 1e-5 of
    Σ|term| + 1e-6 + one bf16 ulp, da and db 1e-5 of Σ|term| + 1e-6."""
    ops = _operands("random", 7 + len(branch) + prologue, ds2=branch not in ("two_pass", "int8"))
    if not prologue:
        ops = (*ops[:2], np.ones(C, np.float32), np.zeros(C, np.float32), *ops[4:])
    yj, dxj, dwj, daj, dbj = _jax_grads(ops, prologue, True, branch)
    tops = _torch_ops(ops, yj)
    tx, tw, ta, tb, ty, tdy, tds1, tds2 = tops
    y, _, _ = conv3x3.conv_bn_plain(tx, tw, ta, tb, prologue, True)
    _close(y, yj, torch.full(y.shape, 0.9))  # 1e-5·0.9 + 1e-6 = 1e-5
    args = (*tops, prologue)
    q = None
    if branch == "fused":
        dx, da, db = conv3x3.conv_dx_plain(*args, True)
        dw = conv3x3.conv_dw_plain(*args, True)
    elif branch == "one_pass":
        dx, da, db, dw = conv3x3.conv_bwd_fused_plain(*args, True)
    elif branch == "two_pass":
        dx, dw, da, db = conv3x3._two_pass_backward(True, True, True, *tops, True)
        dw = dw.to(BF).float()
    else:
        q = conv3x3.quant_rows_plain(ty, P)
        qargs = (tx, tw, ta, tb, *q, tdy, tds1, tds2, prologue, P)
        dx, da, db = conv3x3.conv_dx_q_plain(*qargs)
        dw = conv3x3.conv_dw_q_plain(*qargs, True)
    dx_terms, dw_terms, da_terms, db_terms = _terms(tops, prologue, q)
    if branch in ("fused", "one_pass"):
        scale = float(ta.max()) if prologue else 1.0
        _close(dx, dxj, torch.full(dx.shape, scale - 0.1))  # 1e-5·max a
    else:
        _close(dx, dxj, dx_terms)
    _close(dw, dwj, dw_terms)
    if prologue:
        _close(da, daj, da_terms, ulps=0.0)
        _close(db, dbj, db_terms, ulps=0.0)


# ---------------------------------------------------------------------------
# f32 never changes; the wrappers pass the flag
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("branch", ["fused", "one_pass", "two_pass", "int8"])
def test_f32_unchanged_by_the_flag(branch):
    """An f32 conv keeps every bit of y, dx, dW, da and db under the flag."""
    ops = _operands("random", 31)
    x, w, a, b, dy, ds1, ds2 = (torch.from_numpy(v) for v in ops)
    runs = []
    for flag in (False, True):
        tx, tw = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        ta, tb = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        switches = dict(E_BF16=flag, FUSE_BWD=branch == "one_pass")
        if branch == "two_pass":
            switches["CONV_VMEM_BUDGET"] = packed_gate._conv_vmem(
                H, W // P, P * C, (P + 2) * C, P, C, 4)
        with _globals(packed_gate, **switches):
            if branch == "two_pass":
                assert packed_gate.conv_bwd_branch(H, W, C, C, P, 4, True) == "two_pass"
            if branch == "int8":
                y, s1, s2, _ = conv3x3.conv_bn_fused_q(tx, None, tw, ta, tb, True, P)
            else:
                y, s1, s2 = conv3x3.conv_bn_fused(tx, tw, ta, tb, True, P)
            torch.autograd.backward([y, s1, s2], [dy, ds1, ds2])
        runs.append((y, tx.grad, tw.grad, ta.grad, tb.grad))
    for u, v in zip(*runs):
        assert torch.equal(u, v)


class _FakeLibrary:
    """Records the arguments of the C entry points instead of launching."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def entry(*args):
            self.calls[name] = args
            return 0
        return entry


@pytest.mark.parametrize("dtype", [BF, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("flag", [False, True], ids=["off", "on"])
def test_wrappers_pass_the_flag(monkeypatch, flag, dtype):
    """Each bf16 entry point of the chain's kernels gets ``ew_bf16`` (the
    int before the stream) = 1 under the flag, else 0; f32 launches and
    #39's xq mode pass 0; #37 launches the ring dx and #36's ring in bf16,
    its f32 kernel takes no flag; every call has its signature's arity."""
    lib = _FakeLibrary()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    x, w, a, b, dy, ds1, ds2 = (torch.from_numpy(v) for v in _operands("random", 5))
    x, y, dy = x.to(dtype), dy.to(dtype), dy.to(dtype)
    args = (x, w, a, b, y, dy, ds1, ds2, True)
    bf16 = dtype == BF
    want = int(flag and bf16)
    conv3x3.launch_conv_bn(x, w, a, b, True, flag)
    conv3x3.launch_conv_dw(*args, flag)
    conv3x3.launch_conv3x3_dw_bn(x, a, b, dy, True, flag)
    q = conv3x3.quant_rows_plain(y, P)
    conv3x3.launch_conv_dw_q(x, w, a, b, *q, dy, ds1, ds2, True, P, flag)
    got = {"cltorch_conv3x3_bn_dw": want, "cltorch_conv3x3_dw_bn": want,
           "cltorch_conv3x3_bn_dw_q": want}
    if bf16:
        got["cltorch_conv3x3_bn_ring"] = want
    for name, ew in got.items():
        call = lib.calls.pop(name)
        assert len(call) == len(build.SIGNATURES[name]) and call[-2] == ew, name
    # #37: in bf16 the ring dx and #36's ring, each with the flag; in f32
    # its FMA kernel, whose entry takes none
    lib.calls.clear()
    conv3x3.launch_conv_bwd_fused(*args, flag)
    names = ["cltorch_conv3x3_bn_ring", "cltorch_conv3x3_bn_dw"] if bf16 else \
        ["cltorch_conv3x3_bn_bwd_fused"]
    assert sorted(lib.calls) == sorted(names)
    for name in names:
        call = lib.calls.pop(name)
        assert len(call) == len(build.SIGNATURES[name]), name
        splits = conv3x3.dw_splits(x.shape[3], w.shape[0], *x.shape[:3], False)
        assert call[-2] == (want if bf16 else splits), name
    conv3x3.launch_conv_dw_q(x, w, a, b, *q, dy, ds1, ds2, True, P, flag)
    conv3x3.launch_conv_dw_q(q, w, a, b, *q, dy, ds1, ds2, True, P, flag)  # the xq mode
    assert lib.calls["cltorch_conv3x3_bn_dw_q"][-2] == 0
    # 34p/35p: #34/#35's kernel, the ring's dx in bf16, the FMA body's in f32
    conv3x3.launch_conv_dx(*args, pipe=True, e_bf16=flag)
    name = "cltorch_conv3x3_bn_ring" if bf16 else "cltorch_conv3x3_bn_dx"
    call = lib.calls.pop(name)
    assert len(call) == len(build.SIGNATURES[name]) and call[-2] == want
    if bf16:
        conv3x3.launch_conv_dx(*args, e_bf16=flag)
        call = lib.calls["cltorch_conv3x3_bn_ring"]
        assert call[0] == 1 and call[-2] == want


# ---------------------------------------------------------------------------
# One bf16 SGD step under the flag against cl_tpu's
# ---------------------------------------------------------------------------

ARGS = ["preset=smoke", "data.num_classes=3", "model.base_channels=32", "model.depth=2",
        "data.image_size=64", "data.source_size=80", "model.packed_min_size=0",
        "train.optimizer=sgd", "train.lr=0.05", "train.data_parallel=false",
        "train.compute_dtype=bfloat16"]


def _steps(flag):
    """Both packages' one SGD step of ARGS from the same variables and
    batch, the flag on both sides: (loss gap, worst leaf's update gap
    relative to its norm, the port's leaves)."""
    cfg, jcfg = parse_overrides(ARGS), jax_parse(ARGS)
    model = port_train.init_state(cfg, port_train.build_model(cfg), CPU)
    assert model.packed_levels(64, 64) == 2
    variables = export_jax_variables(model)
    jmodel = jax_train.build_model(jcfg)
    tx = jax_train.build_optimizer(jcfg)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = jax_train.TrainState(
        step=jnp.int32(0), params=params,
        model_state={"batch_stats": jax.tree.map(jnp.asarray, variables["batch_stats"])},
        opt_state=tx.init(params), ewc=None, lwf=None, rng=jax.random.PRNGKey(0))
    hb = next(iter(pipeline.train_batches(cfg, 0, 0)))
    valid = jax_tasks.valid_class_mask(3, jax_tasks.seen_classes(jcfg.classes_per_task, 0))
    with _globals(packed_gate, E_BF16=flag), _globals(jconv, _E_BF16=flag):
        step = port_train.make_train_step(cfg, model, port_train.build_optimizer(cfg, model),
                                          CPU)
        loss = step(pipeline.put_batch(hb, CPU), torch.from_numpy(valid))["loss"].item()
        jstep = jax_train.make_train_step(jcfg, jmodel, tx, mesh=None)
        state, jaux = jstep(state, jax_pipeline.HostBatch(*(jnp.asarray(v) for v in hb)),
                            jnp.asarray(valid))
    before = dict(jax.tree_util.tree_leaves_with_path(variables))
    got = dict(jax.tree_util.tree_leaves_with_path(export_jax_variables(model)))
    worst = 0.0
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            {"params": state.params, **state.model_state}):
        want_d = np.asarray(leaf, np.float64) - before[path]
        got_d = np.asarray(got[path], np.float64) - before[path]
        assert np.linalg.norm(want_d) > 0, path
        worst = max(worst, np.linalg.norm(got_d - want_d) / np.linalg.norm(want_d))
    return abs(loss - float(jaux["loss"])), worst, got


@pytest.fixture(scope="module")
def bf16_steps():
    return {flag: _steps(flag) for flag in (False, True)}


def test_bf16_step_under_the_flag_matches_cl_tpu(bf16_steps):
    (loss0, upd0, _), (loss1, upd1, _) = bf16_steps[False], bf16_steps[True]
    assert loss1 <= 2 * loss0, (loss1, loss0)
    assert upd1 <= 2 * upd0, (upd1, upd0)


def test_bf16_step_under_the_flag_is_its_own(bf16_steps):
    got0, got1 = bf16_steps[False][2], bf16_steps[True][2]
    assert any(not np.array_equal(got0[k], got1[k]) for k in got0)


# ---------------------------------------------------------------------------
# check_supported
# ---------------------------------------------------------------------------


def test_check_supported_accepts_the_flag(monkeypatch):
    """``check_supported`` accepts ``CL_TPU_E_BF16=1`` and ``train()`` runs
    one bf16 step on the packed body under it, through the bf16 chains."""
    monkeypatch.setattr(packed_gate, "E_BF16", True)
    cfg = parse_overrides(["preset=smoke", "model.packed_min_size=0", "model.base_channels=32",
                           "model.depth=2", "data.image_size=64", "data.source_size=80",
                           "data.train_images_per_task=4", "data.val_images_per_task=4",
                           "train.compute_dtype=bfloat16", "train.data_parallel=false"])
    port_train.check_supported(cfg, CPU)
    calls = []
    plain = conv3x3.conv_dw_plain
    monkeypatch.setattr(conv3x3, "conv_dw_plain",
                        lambda *a: calls.append(a[-1]) or plain(*a))
    report = port_train.train(cfg, device="cpu")
    assert np.isfinite(report["final_per_task_miou"]).all()
    assert calls and all(calls)  # every packed dW took the bf16 chains


def _one_step(methods):
    """The port's one EWC step (an anchor near the params, a positive
    Fisher, weight 1) under ``method.methods``: (loss, state leaves)."""
    cfg = parse_overrides(["preset=smoke", f"method.methods={methods}"])
    port_train.check_supported(cfg, CPU)
    model = port_train.init_state(cfg, port_train.build_model(cfg), CPU)
    g = torch.Generator().manual_seed(7)
    ewc = ewc_lib.make_ewc_state(model, mode=cfg.method.ewc_mode)
    with torch.no_grad():
        theta = ewc_lib.flat_params(model)
        ewc.anchor.copy_(theta + 0.01 * torch.randn(theta.shape, generator=g))
        ewc.fisher.copy_(torch.rand(theta.shape, generator=g) + 0.5)
        ewc.weight.fill_(1.0)
    step = port_train.make_train_step(cfg, model, port_train.build_optimizer(cfg, model), CPU,
                                      ewc=ewc)
    valid = torch.from_numpy(task_lib.valid_class_mask(
        cfg.data.num_classes, task_lib.seen_classes(cfg.classes_per_task, 0)))
    aux = step(pipeline.put_batch(next(iter(pipeline.train_batches(cfg, 0, 0))), CPU), valid)
    assert aux["ewc_penalty"].item() > 0
    return aux["loss"].item(), {k: v.clone() for k, v in model.state_dict().items()}


def test_unknown_method_names_are_ignored():
    """``method.methods=ewc,foo`` builds the step of ``method.methods=ewc``
    (``cl_tpu`` only tests membership: ``cl_tpu/train.py:131``, ``:232``,
    ``:1142``)."""
    assert "foo" in parse_overrides(["method.methods=ewc,foo"]).method.methods
    assert "foo" in jax_parse(["method.methods=ewc,foo"]).method.methods
    loss_a, leaves_a = _one_step("ewc")
    loss_b, leaves_b = _one_step("ewc,foo")
    assert loss_a == loss_b
    assert leaves_a.keys() == leaves_b.keys()
    for k in leaves_a:
        assert torch.equal(leaves_a[k], leaves_b[k]), k


# ---------------------------------------------------------------------------
# chip_smoke's variant counts and kernel_ab's names
# ---------------------------------------------------------------------------


def test_phase_5u_counts_move_to_the_variants():
    """``chip_smoke.ebf16_want``: every conv kernel's launches under its
    variant's key, the defaults' zero, #39's xq-mode launches (t from
    deq(xq), f32) kept; each key a launch counter of ``conv3x3``."""
    per_step = {"conv3x3_bn_fwd": 15, "conv3x3_bn_dw_q": 15, "conv3x3_bn_dx_q": 14,
                "bn_relu_fwd": 5}
    want = chip_smoke.ebf16_want(per_step, steps=2)
    xq = sum(n for sh, n in chip_smoke.Q_PATH["conv3x3_bn_dw_q"] if sh[4])
    assert xq == 3
    assert want["conv3x3_bn_fwd"] == 0 and want["conv3x3_bn_fwd_ebf16"] == 30
    assert want["conv3x3_bn_dw_q"] == 2 * xq and want["conv3x3_bn_dw_q_ebf16"] == 30 - 2 * xq
    assert want["conv3x3_bn_dx_q"] == 28 and want["bn_relu_fwd"] == 10
    assert all(want[k + chip_smoke.EBF16] == 0 for k in chip_smoke.EBF16_KERNELS
               if k not in ("conv3x3_bn_fwd", "conv3x3_bn_dw_q"))
    assert chip_smoke.EBF16 == conv3x3.EBF16
    assert set(chip_smoke.EBF16_KERNELS) == {k[:-len(conv3x3.EBF16)] for k in conv3x3.LAUNCHES
                                             if k.endswith(conv3x3.EBF16)}
    for base, shapes in chip_smoke.EBF16_PATH.items():
        assert chip_smoke.EBF16_ENTRY[base] in [sh for sh, _ in shapes], base


@pytest.mark.parametrize("kernel", kernel_ab.OTHER)
def test_kernel_ab_dispatches_the_variants_kernels(kernel):
    """``kernel_ab`` times #37, 34p/35p, #39 and #33 at their paths' shapes
    with ``chip_smoke``'s launches (parent against change, flag off)."""
    launch, operands = kernel_ab.dispatch(chip_smoke, kernel)
    assert callable(launch) and callable(operands)
    assert kernel_ab.shapes(chip_smoke, kernel) == chip_smoke.EBF16_PATH[kernel]
    if kernel == "conv3x3_bn_dw_q":
        assert launch is chip_smoke.q_fns(kernel)[0]
    elif kernel == "conv3x3_dw_bn":
        assert launch is chip_smoke.v3_fns(kernel)[0]
