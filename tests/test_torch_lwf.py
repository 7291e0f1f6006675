"""LwF in the port against ``cl_tpu``'s, on the CPU.

One packed SGD step with ``method.methods=lwf`` on the packed KD head
(#11/#12's plain versions) against ``cl_tpu.train.make_train_step``, from
the same student, a teacher that is a perturbed copy with its own BatchNorm
statistics, weight 1 and ``old_valid`` = task 0's classes: loss, the KD
term, params and batch stats within 1e-4, each leaf's update within 1e-2
of its norm plus one f32 ulp. Then a 2-task ``train()`` with
``train.use_pallas=false`` (the KD on materialized logits) against
``cl_tpu.train.train`` from the same ``init_variables``: final per-task
mIoU within 0.5 points. The teacher snapshot shares no storage with the
student, and the gate: which LwF routes run. Where the
packed head is asked for and the packed body does not engage, the step
takes the fused head on NHWC features, as ``cl_tpu``'s does.
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
from cl_tpu.methods import lwf as jax_lwf
from cl_tpu_torch import config
from cl_tpu_torch import train as port_train
from cl_tpu_torch.config import parse_overrides
from cl_tpu_torch.data import pipeline
from cl_tpu_torch.interop import export_jax_variables, load_jax_variables
from cl_tpu_torch.kernels import head_ce
from cl_tpu_torch.methods import lwf

from test_torch_packed_head import check_step
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PACKED = ["preset=smoke", "data.num_classes=3", "model.base_channels=32", "model.depth=2",
          "data.image_size=64", "data.source_size=80", "model.packed_min_size=0",
          "train.optimizer=sgd", "train.lr=0.05", "train.data_parallel=false",
          "train.num_tasks=2", "method.methods=lwf"]
CPU = torch.device("cpu")


def _teacher_variables(variables, seed):
    """A perturbed copy of ``variables`` with BatchNorm statistics of its
    own (a teacher that differs from the student everywhere)."""
    rng = np.random.RandomState(seed)

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        if name.endswith("['var']"):
            return (rng.rand(*a.shape) + 0.5).astype(np.float32)
        if name.endswith("['mean']"):
            return (rng.randn(*a.shape) * 0.1).astype(np.float32)
        scale = np.abs(a).mean() if np.abs(a).mean() > 0 else 0.1
        return (a + rng.randn(*a.shape) * 0.2 * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(perturb, variables)


def lwf_step_against_cl_tpu(args, watch):
    """The port's and cl_tpu's state after one LwF step of ``args`` from the
    same student, a teacher that is a perturbed copy with its own BatchNorm
    statistics, weight 1 and old_valid = task 0's classes (two or more);
    ``watch`` ({name: (module, function name)}) records the dtypes of the
    first two operands of each call of the port's loss entries."""
    cfg, jcfg = parse_overrides(args), jax_parse(args)
    model = port_train.init_state(cfg, port_train.build_model(cfg), CPU)
    variables = export_jax_variables(model)
    tvars = _teacher_variables(variables, 11)
    n_cls = cfg.data.num_classes
    old_valid = jax_tasks.valid_class_mask(n_cls,
                                           jax_tasks.seen_classes(jcfg.classes_per_task, 0))
    valid = jax_tasks.valid_class_mask(n_cls, jax_tasks.seen_classes(jcfg.classes_per_task, 1))
    assert 2 <= old_valid.sum() < valid.sum()

    state_t = lwf.make_lwf_state(model)
    load_jax_variables(state_t.teacher, tvars)
    state_t.old_valid.copy_(torch.from_numpy(old_valid))
    state_t.weight = 1.0
    step = port_train.make_train_step(cfg, model, port_train.build_optimizer(cfg, model), CPU,
                                      lwf=state_t)

    jmodel = jax_train.build_model(jcfg)
    tx = jax_train.build_optimizer(jcfg)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jl = jax_lwf.LwFState(
        old_params=jax.tree.map(jnp.asarray, tvars["params"]),
        old_model_state={"batch_stats": jax.tree.map(jnp.asarray, tvars["batch_stats"])},
        old_valid=jnp.asarray(old_valid), weight=jnp.float32(1.0))
    state = jax_train.TrainState(
        step=jnp.int32(0), params=params,
        model_state={"batch_stats": jax.tree.map(jnp.asarray, variables["batch_stats"])},
        opt_state=tx.init(params), ewc=None, lwf=jl, rng=jax.random.PRNGKey(0))
    jstep = jax_train.make_train_step(jcfg, jmodel, tx, mesh=None)

    calls = {name: [] for name in watch}
    real = {name: getattr(mod, fn) for name, (mod, fn) in watch.items()}

    def counted(name):
        def f(*a, **k):
            calls[name].append(tuple(t.dtype for t in a[:2]))  # the operands' dtypes
            return real[name](*a, **k)
        return f

    for name, (mod, fn) in watch.items():
        setattr(mod, fn, counted(name))
    try:
        hb = next(iter(pipeline.train_batches(cfg, 1, 0)))
        aux = step(pipeline.put_batch(hb, CPU), torch.from_numpy(valid))
    finally:
        for name, (mod, fn) in watch.items():
            setattr(mod, fn, real[name])
    state, jaux = jstep(state, jax_pipeline.HostBatch(*(jnp.asarray(a) for a in hb)),
                        jnp.asarray(valid))
    return {"calls": calls, "has_kd": "kd" in aux,
            "loss": (aux["loss"].item(), float(jaux["loss"])),
            "kd": (aux["kd"].item() if "kd" in aux else None, float(jaux["kd"])),
            "n_pix": (float(aux["n_pix"]), float(jaux["n_pix"])),
            "teacher": (export_jax_variables(state_t.teacher), tvars),
            "before": dict(jax.tree_util.tree_leaves_with_path(variables)),
            "got": dict(jax.tree_util.tree_leaves_with_path(export_jax_variables(model))),
            "want": jax.tree_util.tree_leaves_with_path(
                {"params": state.params, **state.model_state})}


@pytest.fixture(scope="module")
def lwf_step():
    """The port's and cl_tpu's state after one LwF step on the packed KD
    head, each computed once."""
    assert port_train.packed_head_on(parse_overrides(PACKED))
    return lwf_step_against_cl_tpu(
        PACKED, {"packed_kd": (head_ce, "head_cross_entropy_kd_packed_bn")})


def test_lwf_step_takes_the_packed_kd_head(lwf_step):
    assert len(lwf_step["calls"]["packed_kd"]) == 1


def test_lwf_step_kd_term(lwf_step):
    got, want = lwf_step["kd"]
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_lwf_step_matches_cl_tpu(lwf_step):
    check_step(lwf_step)


def test_lwf_step_leaves_the_teacher_as_it_was(lwf_step):
    """Eval mode, no gradient: the teacher's params and running statistics
    come out of the step bit for bit as they went in."""
    got, want = lwf_step["teacher"]
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                jax.tree_util.tree_leaves_with_path(want)):
        assert pa == pb
        np.testing.assert_array_equal(a, b, err_msg=str(pa))


# ---------------------------------------------------------------------------
# The snapshot
# ---------------------------------------------------------------------------


def test_snapshot_copies_and_does_not_alias():
    cfg = parse_overrides(["preset=smoke", "data.num_classes=3", "train.num_tasks=2",
                           "method.methods=lwf", "train.use_pallas=false",
                           "train.data_parallel=false"])
    model = port_train.init_state(cfg, port_train.build_model(cfg), CPU)
    state = lwf.make_lwf_state(model)
    assert state.weight == 0.0 and not state.old_valid.any()
    assert all(float(t.abs().sum()) == 0 for t in state.teacher.state_dict().values())
    assert not state.teacher.training
    assert not any(p.requires_grad for p in state.teacher.parameters())
    seen = torch.tensor([True, True, False])
    lwf.lwf_after_task(state, model, seen)
    assert state.weight == 1.0 and state.old_valid.tolist() == [True, True, False]
    student_ptrs = {t.data_ptr() for t in model.state_dict().values()}
    teacher = state.teacher.state_dict()
    assert not student_ptrs & {t.data_ptr() for t in teacher.values()}
    frozen = {k: v.clone() for k, v in teacher.items()}
    for k, v in model.state_dict().items():
        assert torch.equal(v, frozen[k]), k
    step = port_train.make_train_step(cfg, model, port_train.build_optimizer(cfg, model), CPU,
                                      lwf=state)
    hb = next(iter(pipeline.train_batches(cfg, 1, 0)))
    aux = step(pipeline.put_batch(hb, CPU), torch.ones(3, dtype=torch.bool))
    assert aux["kd"].item() > 0
    moved = [k for k, v in model.state_dict().items() if not torch.equal(v, frozen[k])]
    assert moved, "the step left the student unchanged"
    for k, v in state.teacher.state_dict().items():
        assert torch.equal(v, frozen[k]), f"{k}: the teacher changed with the student"


# ---------------------------------------------------------------------------
# A 2-task train() against cl_tpu.train.train
# ---------------------------------------------------------------------------


def test_two_task_lwf_train_matches_jax(monkeypatch):
    args = ["preset=smoke", "data.num_classes=3", "train.data_parallel=false",
            "train.num_tasks=2", "method.methods=lwf", "train.use_pallas=false"]
    cfg, jcfg = parse_overrides(args), jax_parse(args)
    variables = export_jax_variables(
        port_train.init_state(cfg, port_train.build_model(cfg), CPU))

    def injected_init_state(cfg_, model, tx):
        # cl_tpu's train() replaces the fresh init by init_variables at
        # once; skipping flax's own init saves seconds of CPU compile.
        jvars = jax.tree.map(jnp.asarray, variables)
        params = jvars["params"]
        return jax_train.TrainState(
            step=jnp.int32(0), params=params,
            model_state={"batch_stats": jvars["batch_stats"]},
            opt_state=tx.init(params), ewc=None,
            lwf=jax_lwf.make_lwf_state(jvars, cfg_.data.num_classes),
            rng=jax.random.PRNGKey(cfg_.train.seed))

    monkeypatch.setattr(jax_train, "init_state", injected_init_state)
    snapshots = []
    real = lwf.lwf_after_task
    monkeypatch.setattr(lwf, "lwf_after_task",
                        lambda *a: snapshots.append(1) or real(*a))
    want = jax_train.train(jcfg, init_variables=variables)
    got = port_train.train(cfg, init_variables=variables, device="cpu")

    assert snapshots == [1]  # after task 0 only
    assert got["config_hash"] == want["config_hash"]
    final = np.asarray(got["final_per_task_miou"])
    assert final.shape == (2,) and np.all(np.isfinite(final))
    np.testing.assert_allclose(final, want["final_per_task_miou"], atol=0.005)
    assert np.all(np.isfinite(got["forgetting_per_task"]))


# ---------------------------------------------------------------------------
# The gates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [
    PACKED,                                                      # the packed KD head
    ["preset=smoke", "method.methods=lwf", "train.use_pallas=false"],  # KD on logits, plain
    ["preset=smoke", "method.methods=lwf,replay", "train.use_pallas=false",
     "data.device_cache=true"],                                  # plan-driven replay
    # the KD head on NHWC features (#9/#10) and the KD on logits (#13/#14)
    ["preset=smoke", "method.methods=lwf"],                      # fused head, NHWC
    PACKED + ["train.packed_head_ce=false"],
    ["preset=smoke", "method.methods=lwf", "train.fused_head_ce=false"],
    ["preset=smoke", "method.methods=lwf,replay", "train.fused_head_ce=false",
     "data.device_cache=true"],
    # with EWC's sampled Fisher (runs since the checkpoint slice)
    ["preset=smoke", "method.methods=ewc,lwf", "train.use_pallas=false",
     "method.ewc_fisher_kind=true"],
    # the grow-the-head variant (runs since the variants' slice)
    ["preset=smoke", "method.methods=lwf", "model.padded_head=false"],
])
def test_lwf_routes_that_run(args):
    port_train.check_supported(parse_overrides(args), CPU)


def test_packed_head_without_the_packed_body_takes_the_nhwc_head():
    """The packed head asks for the packed body's raw output; where the
    body does not engage (32², base 8, ``model.packed_min_size=0``), the
    step takes the fused head+CE on NHWC features (#1/#2's plain versions)
    as ``cl_tpu``'s does (``cl_tpu/train.py:441``), and matches its step
    as the standard body's steps do (``test_torch_train.py``)."""
    args = ["preset=smoke", "model.packed_min_size=0", "train.data_parallel=false",
            "train.optimizer=sgd", "train.lr=0.05"]
    cfg, jcfg = config.parse_overrides(args), jax_parse(args)
    assert port_train.packed_head_on(cfg) and jcfg.train.packed_head_ce
    model = port_train.init_state(cfg, port_train.build_model(cfg), CPU)
    assert model.packed_levels(32, 32) == 0
    variables = export_jax_variables(model)
    step = port_train.make_train_step(cfg, model, port_train.build_optimizer(cfg, model), CPU)
    tx = jax_train.build_optimizer(jcfg)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = jax_train.TrainState(
        step=jnp.int32(0), params=params,
        model_state={"batch_stats": jax.tree.map(jnp.asarray, variables["batch_stats"])},
        opt_state=tx.init(params), ewc=None, lwf=None, rng=jax.random.PRNGKey(0))
    jstep = jax_train.make_train_step(jcfg, jax_train.build_model(jcfg), tx, mesh=None)

    calls = {"nhwc": 0, "packed": 0}
    real = (head_ce.head_cross_entropy, head_ce.head_cross_entropy_packed_bn)
    head_ce.head_cross_entropy = lambda *a, **k: calls.__setitem__(
        "nhwc", calls["nhwc"] + 1) or real[0](*a, **k)
    head_ce.head_cross_entropy_packed_bn = lambda *a, **k: calls.__setitem__(
        "packed", calls["packed"] + 1) or real[1](*a, **k)
    try:
        hb = next(iter(pipeline.train_batches(cfg, 0, 0)))
        valid = np.ones(cfg.data.num_classes, bool)
        aux = step(pipeline.put_batch(hb, CPU), torch.from_numpy(valid))
    finally:
        head_ce.head_cross_entropy, head_ce.head_cross_entropy_packed_bn = real
    state, jaux = jstep(state, jax_pipeline.HostBatch(*(jnp.asarray(a) for a in hb)),
                        jnp.asarray(valid))
    assert calls == {"nhwc": 1, "packed": 0}
    # the standard body's step gate (test_torch_train.py): loss, params and
    # batch statistics within 1e-4
    np.testing.assert_allclose(aux["loss"].item(), float(jaux["loss"]), rtol=1e-4, atol=1e-4)
    assert float(aux["n_pix"]) == float(jaux["n_pix"])
    got = dict(jax.tree_util.tree_leaves_with_path(export_jax_variables(model)))
    want = jax.tree_util.tree_leaves_with_path({"params": state.params, **state.model_state})
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_allclose(got[path], np.asarray(leaf), rtol=1e-4, atol=1e-4,
                                   err_msg=str(path))


def test_lwf_step_needs_its_state():
    cfg = parse_overrides(PACKED)
    model = port_train.init_state(cfg, port_train.build_model(cfg), CPU)
    with pytest.raises(ValueError, match="make_lwf_state"):
        port_train.make_train_step(cfg, model, port_train.build_optimizer(cfg, model), CPU)
