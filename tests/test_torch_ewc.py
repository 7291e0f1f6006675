"""EWC in the port against ``cl_tpu``'s, on the CPU.

The penalty (#17's plain version, and the plain ``methods.ewc.penalty``)
against ``cl_tpu.pallas.ewc_fused.penalty`` in interpret mode and
``cl_tpu.methods.ewc.penalty``, online and separate, fed the same state
through ``interop.ewc_state_from_jax``: within 1e-6 relative (f32 sums in
another order: the port's flat order is ``model.parameters()``, ``cl_tpu``'s
``jax.tree.leaves``). Its gradient (#18's plain version) against
``jax.grad``, with a weight other than 1. The Fisher accumulation (#19's
plain version) against ``ewc_fused.sq_accumulate``. The Fisher pass through
the packed body in eval mode against ``cl_tpu.train.run_fisher_pass``, and
against a float64 run of the same function. ``ewc_after_task`` in both
modes. The gates: which EWC configs run and which raise. (One packed step
with all three methods is ``test_torch_methods_step.py``.)
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_tpu import train as jax_train
from cl_tpu.config import parse_overrides as jax_parse
from cl_tpu.data import tasks as jax_tasks
from cl_tpu.methods import ewc as jax_ewc
from cl_tpu.pallas import ewc_fused as jax_ewc_fused
from cl_tpu_torch import train as port_train
from cl_tpu_torch.augment import augment
from cl_tpu_torch.config import parse_overrides
from cl_tpu_torch.data import pipeline
from cl_tpu_torch.interop import (ewc_state_from_jax, export_jax_variables,
                                  flat_from_params_tree, load_jax_variables,
                                  torch_state_dict_to_variables)
from cl_tpu_torch.kernels import ewc_fused
from cl_tpu_torch.methods import ewc
from cl_tpu_torch.models.unet import UNet
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
CPU = torch.device("cpu")
SMOKE = ["preset=smoke", "data.num_classes=3", "model.depth=2", "train.data_parallel=false",
         "train.num_tasks=3", "method.methods=ewc"]
PACKED = ["preset=smoke", "data.num_classes=3", "model.base_channels=32", "model.depth=2",
          "data.image_size=64", "data.source_size=80", "model.packed_min_size=0",
          "train.data_parallel=false", "train.num_tasks=2"]


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def params_tree_from_flat(model, flat):
    """A vector in ``model.parameters()`` order as a flax ``params`` tree
    (the inverse of ``interop.flat_from_params_tree``)."""
    sd, off = {}, 0
    for name, p in model.named_parameters():
        sd[name] = flat[off:off + p.numel()].reshape(p.shape)
        off += p.numel()
    return torch_state_dict_to_variables(sd)["params"]


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v))
            for p, v in jax.tree_util.tree_leaves_with_path(tree)]


def _ewc_trees(params, seed, T=None, fisher_scale=1.0):
    """An anchor near ``params`` and a positive Fisher (numpy trees; a
    leading task axis of T when T is given)."""
    rng = np.random.RandomState(seed)

    def anchor(p):
        shape = p.shape if T is None else (T,) + p.shape
        return (p + rng.randn(*shape) * 0.2 * (np.abs(p).mean() or 0.1)).astype(np.float32)

    def fisher(p):
        shape = p.shape if T is None else (T,) + p.shape
        return (fisher_scale * (rng.rand(*shape) + 0.5)).astype(np.float32)

    return _tree_map(anchor, params), _tree_map(fisher, params)


@pytest.fixture(scope="module")
def smoke_model():
    cfg = parse_overrides(SMOKE)
    model = port_train.init_state(cfg, port_train.build_model(cfg), CPU)
    return model, export_jax_variables(model)["params"]


def _jax_state(params, mode, weight, seed=1):
    anchor, fisher = _ewc_trees(params, seed, T=None if mode == "online" else 2)
    return jax_ewc.EWCState(anchor=anchor, fisher=fisher, weight=np.float32(weight),
                            n_tasks=np.int32(1))


# ---------------------------------------------------------------------------
# #17 / #18 / #19: the plain versions against cl_tpu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["online", "separate"])
def test_penalty_matches_cl_tpu(smoke_model, mode):
    model, params = smoke_model
    state = _jax_state(params, mode, 1.0)
    jstate = jax.tree.map(jnp.asarray, state)
    jparams = jax.tree.map(jnp.asarray, params)
    want_pallas = float(jax_ewc_fused.penalty(jparams, jstate, mode=mode))
    want_tree = float(jax_ewc.penalty(jparams, jstate, mode=mode))
    st = ewc_state_from_jax(model, state, mode=mode)
    theta = ewc.flat_params(model)
    got_kernel = ewc_fused.penalty(theta, st, mode=mode).item()
    got_plain = ewc.penalty(theta, st, mode=mode).item()
    assert want_pallas > 0
    for got in (got_kernel, got_plain):
        np.testing.assert_allclose(got, want_pallas, rtol=1e-6)
        np.testing.assert_allclose(got, want_tree, rtol=1e-6)


@pytest.mark.parametrize("mode", ["online", "separate"])
def test_penalty_gradient_matches_jax_grad(smoke_model, mode):
    """The backward (2g·F)·(θ−θ*) with the cotangent g = weight/2 ≠ 1/2."""
    model, params = smoke_model
    state = _jax_state(params, mode, 0.7, seed=2)
    jstate = jax.tree.map(jnp.asarray, state)
    want = jax.grad(lambda p: jax_ewc_fused.penalty(p, jstate, mode=mode))(
        jax.tree.map(jnp.asarray, params))
    st = ewc_state_from_jax(model, state, mode=mode)
    model.zero_grad(set_to_none=True)
    ewc_fused.penalty(ewc.flat_params(model), st, mode=mode).backward()
    got = params_tree_from_flat(model, torch.cat([p.grad.reshape(-1) for p in model.parameters()]))
    model.zero_grad(set_to_none=True)
    for (pa, a), (pb, b) in zip(_leaves(got), _leaves(want)):
        assert pa == pb
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12, err_msg=pa)


def test_sq_accumulate_matches_cl_tpu(smoke_model):
    model, params = smoke_model
    rng = np.random.RandomState(4)
    acc = _tree_map(lambda p: rng.rand(*p.shape).astype(np.float32), params)
    g = _tree_map(lambda p: (rng.randn(*p.shape) * 1e-2).astype(np.float32), params)
    want = jax_ewc_fused.sq_accumulate(jax.tree.map(jnp.asarray, acc),
                                       jax.tree.map(jnp.asarray, g))
    flat = flat_from_params_tree(model, acc)
    out = ewc_fused.sq_accumulate(flat, flat_from_params_tree(model, g))
    assert out is flat  # in place
    # one f32 ulp: XLA's CPU contracts acc + g·g into an FMA, the port rounds
    # g² first, as the kernel does
    for (pa, a), (pb, b) in zip(_leaves(params_tree_from_flat(model, flat)), _leaves(want)):
        assert pa == pb
        np.testing.assert_allclose(a, b, rtol=2.0 ** -23, err_msg=pa)


def test_carry_maps_each_leaf_through_the_interop(smoke_model):
    """The flat order is ``model.parameters()``; each entry is its leaf's
    value after the interop's mapping (the up-convs' kernel flip
    included): the round trip returns every leaf bit for bit."""
    model, params = smoke_model
    flat = flat_from_params_tree(model, params)
    torch.testing.assert_close(flat, ewc.flat_params(model), rtol=0, atol=0)
    for (pa, a), (pb, b) in zip(_leaves(params_tree_from_flat(model, flat)), _leaves(params)):
        assert pa == pb
        np.testing.assert_array_equal(a, b, err_msg=pa)


# ---------------------------------------------------------------------------
# ewc_after_task
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["online", "separate"])
def test_ewc_after_task_matches_cl_tpu(smoke_model, mode):
    """Two consolidations (task 0 then task 1, γ = 0.5): anchor, Fisher,
    weight and count as in ``cl_tpu``; the anchor in the state's own
    storage, unmoved when the params move."""
    model, params = copy.deepcopy(smoke_model[0]), smoke_model[1]
    jst = jax_ewc.make_ewc_state(jax.tree.map(jnp.asarray, params), mode=mode, max_tasks=2)
    st = ewc.make_ewc_state(model, mode=mode, max_tasks=2)
    assert float(st.weight) == 0.0 and st.n_tasks == 0
    rng = np.random.RandomState(5)
    for task_id in (0, 1):
        new = _tree_map(lambda p: rng.rand(*p.shape).astype(np.float32), params)
        jst = jax_ewc.ewc_after_task(jst, jax.tree.map(jnp.asarray, params),
                                     jax.tree.map(jnp.asarray, new), mode=mode, gamma=0.5,
                                     task_id=task_id)
        ewc.ewc_after_task(st, model, flat_from_params_tree(model, new), mode=mode,
                           gamma=0.5, task_id=task_id)
    want = ewc_state_from_jax(model, jax.tree.map(np.asarray, jst), mode=mode)
    torch.testing.assert_close(st.anchor, want.anchor, rtol=0, atol=0)
    torch.testing.assert_close(st.fisher, want.fisher, rtol=1e-7, atol=0)
    assert float(st.weight) == float(want.weight) == 1.0
    assert st.n_tasks == want.n_tasks == 2
    ptrs = {p.data_ptr() for p in model.parameters()}
    assert st.anchor.data_ptr() not in ptrs
    before = st.anchor.clone()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    torch.testing.assert_close(st.anchor, before, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The Fisher pass through the packed body in eval mode
# ---------------------------------------------------------------------------


def _random_stats(model, seed):
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(torch.from_numpy(rng.rand(*t.shape).astype(np.float32) + 0.5))
            elif name.endswith("running_mean"):
                t.copy_(torch.from_numpy(rng.randn(*t.shape).astype(np.float32) * 0.1))


@pytest.fixture(scope="module")
def fisher_pass():
    """The port's Fisher pass (f32, packed body, eval mode), cl_tpu's, and
    the squared gradient of the same batch in float64 on the standard
    body, each once. One batch (``method.ewc_fisher_batches=1``)."""
    args = PACKED + ["method.methods=ewc", "method.ewc_fisher_batches=1"]
    cfg, jcfg = parse_overrides(args), jax_parse(args)
    model = port_train.init_state(cfg, port_train.build_model(cfg), CPU)
    assert model.packed_levels(64, 64) == 2
    _random_stats(model, 3)
    variables = export_jax_variables(model)
    seen = jax_tasks.valid_class_mask(3, jax_tasks.seen_classes(jcfg.classes_per_task, 0))

    got = port_train.run_fisher_pass(cfg, port_train.make_fisher_step(cfg, model, CPU),
                                     model, 0, seen, CPU)
    grads_left = [p.grad for p in model.parameters()]

    # float64, the standard body: the same function, another implementation
    m64 = UNet(3, 32, 2, dtype=torch.float64)
    load_jax_variables(m64, variables)
    m64 = m64.double()
    hb = next(iter(pipeline.train_batches(cfg, 0, 10_000)))
    b = pipeline.put_batch(hb, CPU)
    x, y = augment(b.image, b.mask, b.flip, out_size=64, mean=cfg.data.mean, std=cfg.data.std)
    g64 = ewc.fisher_batch_grads(m64, x.double(), y, torch.from_numpy(seen))
    want64 = g64.double() ** 2
    # the same with every input moved by one f32 ulp at random: the
    # Fisher's own sensitivity to f32 rounding
    x64 = x.double()
    ulp = torch.exp2(torch.floor(torch.log2(x64.abs().clamp_min(2.0 ** -126))) - 23)
    sign = torch.from_numpy(np.random.RandomState(9).choice([-1.0, 1.0], size=tuple(x.shape)))
    moved64 = ewc.fisher_batch_grads(m64, x64 + ulp * sign, y, torch.from_numpy(seen)) ** 2

    params = jax.tree.map(jnp.asarray, variables["params"])
    tx = jax_train.build_optimizer(jcfg)
    state = jax_train.TrainState(
        step=jnp.int32(0), params=params,
        model_state={"batch_stats": jax.tree.map(jnp.asarray, variables["batch_stats"])},
        opt_state=tx.init(params), ewc=None, lwf=None, rng=jax.random.PRNGKey(0))
    want = jax_train.run_fisher_pass(
        jcfg, jax_train.make_fisher_step(jcfg, jax_train.build_model(jcfg)), state, 0, seen)
    return {"model": model, "got": got, "want": jax.tree.map(np.asarray, want),
            "f64": want64, "moved64": moved64, "before": variables, "after": export_jax_variables(model),
            "grads_left": grads_left}


def _check_fisher(got, want):
    """Each leaf within 2e-4 of its norm. The Fisher of the levels below
    the first is a sum over pixels that cancels to ~1e-3 of its terms, so
    f32 rounding anywhere upstream moves it by ~1e-4 of a leaf's norm
    (``test_fisher_tolerance_is_its_conditioning``): two f32 computations
    that add in other orders land that far apart."""
    for (pa, a), (pb, b) in zip(_leaves(got), _leaves(want)):
        assert pa == pb
        norm = np.linalg.norm(b)
        assert norm > 0, pa
        assert np.linalg.norm(a - b) <= 2e-4 * norm, (pa, np.linalg.norm(a - b) / norm)


def test_fisher_pass_matches_cl_tpu(fisher_pass):
    _check_fisher(params_tree_from_flat(fisher_pass["model"], fisher_pass["got"]),
                  fisher_pass["want"])


def test_fisher_pass_matches_float64(fisher_pass):
    """The same function in float64 on the standard body, cl_tpu aside."""
    model = fisher_pass["model"]
    _check_fisher(params_tree_from_flat(model, fisher_pass["got"].double()),
                  params_tree_from_flat(model, fisher_pass["f64"]))


def test_fisher_tolerance_is_its_conditioning(fisher_pass):
    """One f32 ulp of input noise moves the float64 Fisher by more than a
    tenth of the tolerance on some leaf, and by less than the tolerance
    on every leaf."""
    model = fisher_pass["model"]
    worst = max(np.linalg.norm(a - b) / np.linalg.norm(b) for (_, a), (_, b) in zip(
        _leaves(params_tree_from_flat(model, fisher_pass["moved64"])),
        _leaves(params_tree_from_flat(model, fisher_pass["f64"]))))
    assert 2e-5 < worst < 2e-4, worst


def test_fisher_pass_moves_no_param_no_statistic_no_grad(fisher_pass):
    """Eval mode: the running statistics are read, not updated; the
    gradients come from ``torch.autograd.grad``: no ``.grad`` is set."""
    for (pa, a), (pb, b) in zip(_leaves(fisher_pass["after"]), _leaves(fisher_pass["before"])):
        assert pa == pb
        np.testing.assert_array_equal(a, b, err_msg=pa)
    assert all(g is None for g in fisher_pass["grads_left"])
    assert torch.isfinite(fisher_pass["got"]).all() and (fisher_pass["got"] >= 0).all()


# ---------------------------------------------------------------------------
# The gates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [
    ["preset=baseline_5", "data.batch_size=8", "method.replay_batch=1", "train.remat=false",
     "train.data_parallel=false", "data.dataset=synthetic", "data.device_cache=false"],
    ["preset=baseline_3", "data.dataset=synthetic", "data.device_cache=false"],
])
def test_methods_presets_run(args):
    cfg = parse_overrides(args)
    port_train.check_supported(cfg, CPU)
    assert "ewc" in cfg.method.methods


def test_sampled_fisher_raises():
    """The sampled Fisher (``method.ewc_fisher_kind=true``) runs since the
    checkpoint slice; a kind that is neither raises."""
    port_train.check_supported(parse_overrides(SMOKE + ["method.ewc_fisher_kind=true"]), CPU)
    cfg = parse_overrides(SMOKE + ["method.ewc_fisher_kind=sampled"])
    with pytest.raises(ValueError, match="ewc_fisher_kind"):
        port_train.check_supported(cfg, CPU)


def test_ewc_step_needs_its_state(smoke_model):
    cfg = parse_overrides(SMOKE)
    model = smoke_model[0]
    with pytest.raises(ValueError, match="make_ewc_state"):
        port_train.make_train_step(cfg, model, port_train.build_optimizer(cfg, model), CPU)
