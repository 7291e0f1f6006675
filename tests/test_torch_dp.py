"""Data parallelism in the port (``cl_tpu_torch/sharding.py``), on the CPU
over gloo: one group of 4 processes and one of 2, each spawned once for
the module (a ``file://`` store under the module's temporary directory,
so xdist workers never share a port) and running every check of its group
inside it; the results come back to this process, which holds them
against ``cl_tpu`` and against the port's own one-process runs.

* 4 ranks: the smoke preset's DP step (SGD) against ``cl_tpu``'s mesh step
  from the same weights on 4 of ``conftest``'s 8 virtual devices, at
  ``tests/dp/test_mesh.py``'s tolerances (loss rtol 1e-5, params atol
  1e-3); the eval's confusion matrix against ``cl_tpu``'s mesh eval,
  exactly.
* 2 ranks, each against the port's one-process run on the concatenated
  batch: the packed step (64², base 32), also under ``train.remat``
  (bit-equal to DP without it); the methods step (EWC's penalty counted
  once, the KD summed, a replay-widened batch of 4 + 2); one sampled
  Fisher step (the labels drawn over the global batch); the eval's
  confusion matrix (``evaluate_task``, and ``evaluate``); ``train()`` over 2 tasks with the device cache and the
  device replay buffer (mIoU within 0.5 points); ``check_divisible``
  refusing 8 + 1 over 2 ranks; ``train.data_parallel=false`` in a group
  refused.
* 2 ranks, grow-the-head: one SGD step of task 1 after the head grows
  (3 → 5 of 5 classes; EWC and LwF re-laid, a fresh optimizer) against one
  process: every rank draws the new rows from the same seeded generator,
  so the replicas stay bit-equal.
* Replicas are bit-equal across ranks. ``train.multihost=true`` with no
  group raises.

The module's top-level imports are torch-only: the spawned workers import
it and must load neither JAX nor ``cl_tpu``.
"""

import numpy as np
import pytest
import torch

from cl_tpu_torch import sharding
from cl_tpu_torch import train as port_train
from cl_tpu_torch.config import parse_overrides
from cl_tpu_torch.data import pipeline
from cl_tpu_torch.data import tasks as task_lib
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from test_torch_remat import PACKED, methods_state

CPU = torch.device("cpu")
SGD = ["train.data_parallel=true", "train.optimizer=sgd", "train.lr=0.05"]
# tests/dp/test_mesh.py's config: the smoke preset, SGD at lr 0.1
SMOKE = ["preset=smoke", "train.data_parallel=true", "train.optimizer=sgd", "train.lr=0.1"]
PACKED_DP = [a for a in PACKED if a != "train.data_parallel=false"] + SGD
METHODS_DP = PACKED_DP + ["train.num_tasks=2", "method.methods=ewc,lwf,replay",
                          "method.replay_batch=2"]
FISHER_DP = PACKED_DP + ["train.num_tasks=2", "method.methods=ewc",
                         "method.ewc_fisher_kind=true"]
GROW_DP = ["preset=smoke", "data.num_classes=5", "train.num_tasks=2",
           "model.padded_head=false", "method.methods=ewc,lwf"] + SGD
TRAIN_DP = ["preset=smoke", "data.num_classes=3", "train.num_tasks=2", "model.depth=3",
            "method.methods=replay", "method.replay_batch=2", "data.device_cache=true",
            "method.replay_device_resident=true", "train.data_parallel=true"]


def _valid(cfg, task):
    return torch.from_numpy(task_lib.valid_class_mask(
        cfg.data.num_classes, task_lib.seen_classes(cfg.classes_per_task, task)))


def _leaves(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def _local(batch, dp):
    return batch if dp is None else dp.local(batch)


def step_run(args, dp, variables=None, n_steps=1):
    """``n_steps`` of ``args``'s train step on task 0's first batch (this
    rank's rows of it under ``dp``): (aux of the last step, the state
    before, the state after)."""
    cfg = parse_overrides(args)
    model = port_train.init_state(cfg, port_train.build_model(cfg, dp), CPU)
    if variables is not None:
        from cl_tpu_torch.interop import load_jax_variables

        load_jax_variables(model, variables)
    before = _leaves(model)
    step = port_train.make_train_step(cfg, model, port_train.build_optimizer(cfg, model), CPU)
    batch = pipeline.put_batch(_local(next(iter(pipeline.train_batches(cfg, 0, 0))), dp), CPU)
    for _ in range(n_steps):
        aux = step(batch, _valid(cfg, 0))
    return {k: float(v) for k, v in aux.items()}, before, _leaves(model)


def methods_run(dp):
    """One SGD step of task 1 with EWC, LwF and a 4 + 2 replay-widened
    batch (``test_torch_remat.methods_state``'s seeded states)."""
    cfg = parse_overrides(METHODS_DP)
    model = port_train.init_state(cfg, port_train.build_model(cfg, dp), CPU)
    ewc, lwf, buf = methods_state(cfg, model)
    before = _leaves(model)
    step = port_train.make_train_step(cfg, model, port_train.build_optimizer(cfg, model), CPU,
                                      lwf=lwf, ewc=ewc)
    fresh = next(iter(pipeline.train_batches(cfg, 1, 0)))
    hb = pipeline.replay_mix(fresh, buf.sample_or_current(2, fresh, flip_prob=0.5))
    assert len(hb.image) == 6
    aux = step(pipeline.put_batch(_local(hb, dp), CPU), _valid(cfg, 1))
    return {k: float(v) for k, v in aux.items()}, before, _leaves(model)


def grow_run(dp):
    """One SGD step of task 1 with EWC and LwF after the head grows from
    task 0's width to task 1's (``train.expand_state``)."""
    from cl_tpu_torch.checkpoint import TrainState

    cfg = parse_overrides(GROW_DP)
    model = port_train.init_state(cfg, port_train.build_model(cfg, dp), CPU)
    ewc, lwf, _ = methods_state(cfg, model)
    state = TrainState(model, port_train.build_optimizer(cfg, model), ewc, lwf)
    port_train.expand_state(cfg, state, port_train.task_head_width(cfg, 1), 1)
    assert model.head.weight.shape[0] == 5
    before = _leaves(model)
    step = port_train.make_train_step(cfg, model, state.optimizer, CPU, lwf=lwf, ewc=ewc)
    hb = next(iter(pipeline.train_batches(cfg, 1, 0)))
    aux = step(pipeline.put_batch(_local(hb, dp), CPU), _valid(cfg, 1))
    return {k: float(v) for k, v in aux.items()}, before, _leaves(model)


def fisher_run(dp):
    """One sampled-Fisher step on task 0's first Fisher batch: the flat
    squared gradient."""
    cfg = parse_overrides(FISHER_DP)
    model = port_train.init_state(cfg, port_train.build_model(cfg, dp), CPU)
    fstep = port_train.make_fisher_step(cfg, model, CPU)
    acc = torch.zeros(sum(p.numel() for p in model.parameters()))
    hb = next(iter(pipeline.train_batches(cfg, 0, 10_000)))
    return fstep(acc, pipeline.put_batch(_local(hb, dp), CPU), _valid(cfg, 0),
                 port_train.fisher_generator(cfg, 0, CPU))


def eval_run(args, dp, variables=None, public=False):
    """``evaluate_task``'s confusion matrix of task 0 through the host
    pipeline, from the seeded init or ``variables``; ``public``: through
    ``train.evaluate``, which joins the process's group itself."""
    cfg = parse_overrides(args)
    model = port_train.init_state(cfg, port_train.build_model(cfg, None if public else dp),
                                  CPU)
    if variables is not None:
        from cl_tpu_torch.interop import load_jax_variables

        load_jax_variables(model, variables)
    if public:
        return port_train.evaluate(cfg, model, 0, device=CPU)["confusion"]
    step = port_train.make_eval_step(cfg, model, CPU)
    seen = task_lib.valid_class_mask(cfg.data.num_classes,
                                     task_lib.seen_classes(cfg.classes_per_task, 0))
    return port_train.evaluate_task(cfg, step, 0, seen, CPU, dp=dp)["confusion"]


def refusal(fn, *args):
    try:
        fn(*args)
    except (ValueError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def four_ranks(variables):
    dp = sharding.DataParallel()
    return {"step": step_run(SMOKE, dp, variables), "conf": eval_run(SMOKE, dp, variables)}


def two_ranks():
    dp = sharding.DataParallel()
    out = {"packed": step_run(PACKED_DP, dp, n_steps=2),
           "packed_remat": step_run(PACKED_DP + ["train.remat=true"], dp, n_steps=2),
           "methods": methods_run(dp), "grow": grow_run(dp), "fisher": fisher_run(dp),
           "conf": eval_run(PACKED_DP, dp), "conf_public": eval_run(PACKED_DP, dp, public=True)}
    report = port_train.train(parse_overrides(TRAIN_DP), device=CPU)
    out["train"] = {k: report[k] for k in ("miou_matrix", "final_per_task_miou",
                                           "data_parallel")}
    out["refuse_9_over_2"] = refusal(port_train.train, parse_overrides(
        TRAIN_DP + ["data.batch_size=8", "method.replay_batch=1"]), None, CPU)
    out["refuse_no_dp"] = refusal(sharding.join, parse_overrides(
        TRAIN_DP + ["train.data_parallel=false"]), CPU)
    return out


def spawn_group(tmp_path_factory, fn, args, world):
    store = tmp_path_factory.mktemp("dp_store") / "store"
    return sharding.spawn(fn, args, world=world, backend="gloo",
                          init_method=f"file://{store}", devices=[CPU] * world, timeout=600)


@pytest.fixture(scope="module")
def smoke_variables():
    from cl_tpu_torch.interop import export_jax_variables

    cfg = parse_overrides(SMOKE)
    model = port_train.init_state(cfg, port_train.build_model(cfg), CPU)
    with torch.no_grad():  # running statistics unlike the init's
        model.train()(torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(3)))
    return export_jax_variables(model)


@pytest.fixture(scope="module")
def group4(tmp_path_factory, smoke_variables):
    return spawn_group(tmp_path_factory, four_ranks, (smoke_variables,), 4)


@pytest.fixture(scope="module")
def group2(tmp_path_factory):
    return spawn_group(tmp_path_factory, two_ranks, (), 2)


@pytest.fixture(scope="module")
def cl_tpu_mesh(eight_devices, smoke_variables):
    """``cl_tpu``'s mesh step and mesh eval on 4 virtual devices, from the
    same variables and batch (``tests/dp/test_mesh.py``'s)."""
    import jax
    import jax.numpy as jnp

    from cl_tpu import sharding as jax_sharding
    from cl_tpu import train as jax_train
    from cl_tpu.config import parse_overrides as jax_parse
    from cl_tpu.data import pipeline as jax_pipeline

    jcfg = jax_parse(SMOKE)
    model = jax_train.build_model(jcfg)
    tx = jax_train.build_optimizer(jcfg)
    mesh = jax_sharding.make_mesh(eight_devices[:4])
    params = jax.tree.map(jnp.asarray, smoke_variables["params"])
    ms = {"batch_stats": jax.tree.map(jnp.asarray, smoke_variables["batch_stats"])}
    state = jax_train.TrainState(step=jnp.int32(0), params=params, model_state=ms,
                                 opt_state=tx.init(params), ewc=None, lwf=None,
                                 rng=jax.random.PRNGKey(0))
    valid = jnp.asarray(task_lib.valid_class_mask(
        jcfg.data.num_classes, task_lib.seen_classes(jcfg.classes_per_task, 0)))
    hb = next(iter(jax_pipeline.train_batches(jcfg, 0, epoch=0)))
    C = jcfg.data.num_classes
    conf = jnp.zeros((C, C), jnp.float32)
    for vb in jax_pipeline.val_batches(jcfg, 0):
        conf = jax_train.make_eval_step(jcfg, model, mesh=mesh)(
            conf, state.params, state.model_state,
            jax_pipeline.HostBatch(*(jnp.asarray(a) for a in vb)), valid)
    state, aux = jax_train.make_train_step(jcfg, model, tx, mesh=mesh)(
        state, jax_pipeline.HostBatch(*(jnp.asarray(a) for a in hb)), valid)
    return {"loss": float(aux["loss"]), "conf": np.asarray(conf),
            "leaves": jax.tree_util.tree_leaves_with_path(
                {"params": state.params, **state.model_state})}


def one_process(key):
    """The port's one-process run of a 2-rank check, on the whole batch."""
    if key in ("packed", "packed_remat"):
        return step_run(PACKED_DP + (["train.remat=true"] if key == "packed_remat" else []),
                        None, n_steps=2)
    if key == "methods":
        return methods_run(None)
    if key == "grow":
        return grow_run(None)
    if key == "fisher":
        return fisher_run(None)
    if key in ("conf", "conf_public"):
        return eval_run(PACKED_DP, None, public=key == "conf_public")
    raise KeyError(key)


def check_update(got, want, before, name):
    """loss rtol 1e-5; each leaf's update within 1e-2 of its norm plus one
    f32 ulp per element (the card checks' tolerance)."""
    np.testing.assert_allclose(got[0]["loss"], want[0]["loss"], rtol=1e-5, err_msg=name)
    for k, b in before.items():
        w = want[2][k].double()
        dw = (w - b.double()).numpy()
        dg = (got[2][k].double() - b.double()).numpy()
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w.numpy()), 2.0 ** -126))) - 23)
        assert np.linalg.norm(dg - dw) <= 1e-2 * np.linalg.norm(dw) + np.linalg.norm(ulp), (
            name, k, np.linalg.norm(dg - dw), np.linalg.norm(dw))


def test_multihost_without_a_group_raises():
    cfg = parse_overrides(["preset=smoke", "train.multihost=true"])
    with pytest.raises(RuntimeError, match="multihost"):
        sharding.join(cfg, CPU)
    assert sharding.join(parse_overrides(["preset=smoke"]), CPU) is None


def test_check_divisible():
    sharding.check_divisible(8, 4)
    with pytest.raises(ValueError, match="not divisible"):
        sharding.check_divisible(9, 2)


def test_smoke_step_matches_cl_tpu_mesh(group4, cl_tpu_mesh):
    aux = group4[0]["step"][0]
    np.testing.assert_allclose(aux["loss"], cl_tpu_mesh["loss"], rtol=1e-5)
    got = _as_flax(group4[0]["step"][2])
    assert len(got) == len(cl_tpu_mesh["leaves"])
    for path, leaf in cl_tpu_mesh["leaves"]:
        np.testing.assert_allclose(got[path], np.asarray(leaf), atol=1e-3, err_msg=str(path))


def test_smoke_eval_matches_cl_tpu_mesh(group4, cl_tpu_mesh):
    for r in range(4):
        np.testing.assert_array_equal(group4[r]["conf"], cl_tpu_mesh["conf"])


def _as_flax(state_dict):
    """A port state dict as flax leaves by path (``interop``'s mapping)."""
    import jax

    from cl_tpu_torch.interop import export_jax_variables

    cfg = parse_overrides(SMOKE)
    model = port_train.build_model(cfg)
    model.load_state_dict(state_dict)
    return dict(jax.tree_util.tree_leaves_with_path(export_jax_variables(model)))


@pytest.mark.parametrize("world", [2, 4])
def test_replicas_bit_equal(world, group2, group4):
    res = group2 if world == 2 else group4
    keys = [k for k in res[0] if isinstance(res[0][k], tuple)]
    assert keys
    for key in keys:
        for r in range(1, world):
            for k, v in res[0][key][2].items():
                assert torch.equal(v, res[r][key][2][k]), (key, r, k)
            assert res[0][key][0] == res[r][key][0], key


@pytest.mark.parametrize("key", ["packed", "packed_remat", "methods", "grow"])
def test_step_matches_one_process(key, group2):
    want = one_process(key)
    got = group2[0][key]
    check_update(got, want, want[1], key)
    if key in ("methods", "grow"):
        for term in ("ewc_penalty", "kd", "ce"):
            np.testing.assert_allclose(got[0][term], want[0][term], rtol=1e-5, err_msg=term)
        assert want[0]["ewc_penalty"] > 0 and want[0]["kd"] > 0
    assert got[0]["n_pix"] == want[0]["n_pix"]


def test_remat_under_dp_is_bit_equal(group2):
    a, b = group2[0]["packed"], group2[0]["packed_remat"]
    assert a[0] == b[0]
    for k in a[2]:
        assert torch.equal(a[2][k], b[2][k]), k


def test_sampled_fisher_matches_one_process(group2):
    want = one_process("fisher")
    for r in range(2):
        got = group2[r]["fisher"]
        assert float(want.abs().max()) > 0
        assert float((got - want).norm()) <= 2e-4 * float(want.norm())
    assert torch.equal(group2[0]["fisher"], group2[1]["fisher"])


@pytest.mark.parametrize("key", ["conf", "conf_public"])
def test_eval_confusion_matches_one_process(key, group2):
    """``evaluate_task`` under a group, and the public ``evaluate``, which
    joins the group itself: the one process's confusion matrix exactly."""
    want = one_process(key)
    assert want.sum() > 0
    for r in range(2):
        np.testing.assert_array_equal(group2[r][key], want)


def test_train_matches_one_process(group2):
    cfg = parse_overrides(TRAIN_DP)
    want = port_train.train(cfg, device=CPU)
    assert "data_parallel" not in want
    for r in range(2):
        got = group2[r]["train"]
        assert got["data_parallel"] == 2
        np.testing.assert_allclose(got["final_per_task_miou"], want["final_per_task_miou"],
                                   atol=5e-3)
        np.testing.assert_array_equal(got["miou_matrix"], group2[0]["train"]["miou_matrix"])


@pytest.mark.parametrize("key", ["refuse_9_over_2", "refuse_no_dp"])
def test_refusals_in_a_group(key, group2):
    msg = group2[0][key]
    assert msg is not None
    assert ("not divisible" if key == "refuse_9_over_2" else "data_parallel=false") in msg
