"""Spatial parallelism in the port (``train.spatial_parallel``,
``cl_tpu_torch/parallel/spatial.py``) against ``cl_tpu.parallel.spatial``
and the port's own unsharded runs, on the CPU over gloo: one group of 2
processes and one of 4, each spawned once for the module (a ``file://``
store under the module's temporary directory), every check of its group
run inside it; ``cl_tpu``'s side is computed once per module on 2 and 4 of
``conftest``'s 8 virtual devices (``make_space_mesh``). It mirrors every
case of ``tests/dp/test_spatial.py``:

* the forward (base 8, depth 4, 128², f32) stitched from the ranks against
  ``cl_tpu``'s ``spatial_apply`` and against the port's unsharded
  GroupNorm ``UNet``, atol 2e-4 (the tolerance of ``cl_tpu``'s own test:
  the global statistics sum in another order);
* the gradients of the CE (depth 2, 64²) against ``jax.grad`` of
  ``cl_tpu``'s spatial loss, atol 1e-4 (``cl_tpu``'s);
* the halo rows exact, zeros at the image's edges (the ``arange`` case);
* H that does not divide by n·2^depth raising "divide"; BatchNorm raising
  "norm"; bf16 through ``train()`` finite;
* one SGD step of ``train.spatial_parallel=true`` against
  ``cl_tpu.train.make_train_step(..., spatial_mesh=...)`` from the same
  weights: loss rtol 1e-5, params atol 1e-4 (``tests/dp/test_spatial.py``'s
  and ``tests/dp/test_mesh.py``'s);
* ``train()`` over 2 ranks against one process, mIoU within 5e-3
  (``cl_tpu``'s test);
* one process with ``train.spatial_parallel=true`` training unsharded,
  bit-equal to ``spatial_parallel=false``;
* replicas bit-equal across the ranks.

Beyond ``cl_tpu``'s cases, as ``cl_tpu``'s spatial forward ignores
``model.conv_impl`` and ``train.remat`` and takes the head's own width: the
step with ``model.conv_impl=hybrid train.remat=true`` bit-equal to the
plain one; a methods step (EWC, LwF on the spatial teacher) after the head
grows (``model.padded_head=false``) and a sampled-Fisher step against one
process (each update within 1e-2 of its norm plus one ulp, the DP tests'
tolerance; the Fisher within 2e-4 of its norm); the eval's confusion matrix
against one process's (at most 0.2% of the pixels move: a logit that sums
in another order can flip an argmax).

The module's top-level imports are torch-only: the spawned workers import
it and must load neither JAX nor ``cl_tpu``.
"""

import warnings

import numpy as np
import pytest
import torch

from cl_tpu_torch import losses, sharding
from cl_tpu_torch import train as port_train
from cl_tpu_torch.config import parse_overrides
from cl_tpu_torch.data import pipeline
from cl_tpu_torch.data import tasks as task_lib
from cl_tpu_torch.interop import load_jax_variables, torch_state_dict_to_variables
from cl_tpu_torch.models.unet import UNet, init_weights
from cl_tpu_torch.parallel import spatial
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from test_torch_dp import check_update, eval_run, step_run
from test_torch_remat import methods_state

CPU = torch.device("cpu")
FWD = (4, 8, 4, 128)    # classes, base, depth, size: cl_tpu's forward test
GRAD = (4, 8, 2, 64)    # its gradient test
SGD = ["train.optimizer=sgd", "train.lr=0.05"]
STEP = ["preset=smoke", "model.norm=group", "model.depth=2", "data.num_classes=3",
        "train.spatial_parallel=true"] + SGD
# cl_tpu's train() test (tests/dp/test_spatial.py:82-97)
TRAIN = ["preset=smoke", "model.norm=group", "model.depth=2", "data.num_classes=5",
         "train.num_tasks=2", "method.methods=ewc", "data.train_images_per_task=8",
         "data.image_size=32", "data.source_size=40"]
GROW = STEP[:3] + ["data.num_classes=5", "train.num_tasks=2", "model.padded_head=false",
                   "method.methods=ewc,lwf", "train.spatial_parallel=true"] + SGD
FISHER = STEP + ["train.num_tasks=2", "method.methods=ewc", "method.ewc_fisher_kind=true"]


def _unet(classes, base, depth):
    model = UNet(classes, base_channels=base, depth=depth, norm="group")
    init_weights(model, torch.Generator().manual_seed(0))
    return model


def _inputs(classes, size, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, size, size, 3).astype(np.float32)
    y = rng.randint(0, classes, (2, size, size)).astype(np.int64)
    return x, y


def forward_rows(sp, variables):
    classes, base, depth, size = FWD
    model = _unet(classes, base, depth)
    load_jax_variables(model, variables)
    with torch.no_grad():
        return spatial.spatial_apply(model, torch.from_numpy(_inputs(classes, size)[0]), sp)


def grads(sp, variables):
    """The gradient of the CE of the whole batch, summed over the ranks (the
    rank's share of the global mean, as the train step takes it), as a flax
    tree."""
    classes, base, depth, size = GRAD
    model = _unet(classes, base, depth)
    load_jax_variables(model, variables)
    x, y = (torch.from_numpy(a) for a in _inputs(classes, size))
    logits = spatial.spatial_apply(model, x, sp)
    y = y if sp is None else sp.output_rows(y)
    ce, _ = losses.cross_entropy(logits, y, torch.ones(classes, dtype=torch.bool), dp=sp)
    ce.backward()
    if sp is not None:
        sharding.all_reduce_grads(model.parameters(), sp)
    return torch_state_dict_to_variables(
        {n: p.grad for n, p in model.named_parameters()})["params"]


def halo(sp):
    """``_halo_rows`` of this rank's two rows of 1..8 (one column pair)."""
    x = torch.arange(1, 9, dtype=torch.float32).reshape(1, 8, 1, 1).repeat(1, 1, 2, 1)
    return spatial._halo_rows(sp.output_rows(x), sp)[0, :, 0, 0]


def refusal(fn, *args, **kw):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            fn(*args, **kw)
    except ValueError as e:
        return str(e)
    return None


def methods_grow_run(sp):
    """One SGD step of task 1 with EWC and LwF after the head grows from
    task 0's width to task 1's; the teacher is the student's deep copy, so
    it runs the spatial forward too."""
    from cl_tpu_torch.checkpoint import TrainState

    cfg = parse_overrides(GROW)
    model = port_train.init_state(cfg, port_train.build_model(cfg, sp), CPU)
    ewc, lwf, _ = methods_state(cfg, model)
    state = TrainState(model, port_train.build_optimizer(cfg, model), ewc, lwf)
    port_train.expand_state(cfg, state, port_train.task_head_width(cfg, 1), 1)
    assert model.head.weight.shape[0] == 5
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = port_train.make_train_step(cfg, model, state.optimizer, CPU, lwf=lwf, ewc=ewc)
    hb = next(iter(pipeline.train_batches(cfg, 1, 0)))
    valid = torch.from_numpy(task_lib.valid_class_mask(
        cfg.data.num_classes, task_lib.seen_classes(cfg.classes_per_task, 1)))
    aux = step(pipeline.put_batch(hb, CPU), valid)
    return ({k: float(v) for k, v in aux.items()}, before,
            {k: v.clone() for k, v in model.state_dict().items()})


def fisher_run(sp):
    cfg = parse_overrides(FISHER)
    model = port_train.init_state(cfg, port_train.build_model(cfg, sp), CPU)
    fstep = port_train.make_fisher_step(cfg, model, CPU)
    acc = torch.zeros(sum(p.numel() for p in model.parameters()))
    hb = next(iter(pipeline.train_batches(cfg, 0, 10_000)))
    valid = torch.from_numpy(task_lib.valid_class_mask(
        cfg.data.num_classes, task_lib.seen_classes(cfg.classes_per_task, 0)))
    return fstep(acc, pipeline.put_batch(hb, CPU), valid,
                 port_train.fisher_generator(cfg, 0, CPU))


def _train(args):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        report = port_train.train(parse_overrides(args), device=CPU)
    return {k: report.get(k) for k in ("miou_matrix", "final_per_task_miou",
                                       "spatial_parallel", "data_parallel")}


def group_run(fwd_vars, grad_vars, step_vars):
    """Every check of one group, on this rank."""
    torch.set_num_threads(1)  # the ranks share the cores
    sp = sharding.join(parse_overrides(STEP), CPU)
    assert isinstance(sp, sharding.SpatialParallel)
    out = {"fwd": forward_rows(sp, fwd_vars), "grads": grads(sp, grad_vars),
           "step": step_run(STEP, sp, step_vars),
           "divide": refusal(spatial.spatial_apply, _unet(2, 8, 4), torch.zeros(1, 80, 80, 3),
                             sp)}
    if sp.world == 4:
        out["halo"] = halo(sp)
        out["divide_train"] = refusal(port_train.train, parse_overrides(
            STEP + ["model.depth=4"]), device=CPU)
        return out
    out["step_variants"] = step_run(STEP + ["model.conv_impl=hybrid", "train.remat=true"], sp,
                                    step_vars)
    out["grow"] = methods_grow_run(sp)
    out["fisher"] = fisher_run(sp)
    out["conf"] = eval_run(STEP, sp)
    out["train"] = _train(TRAIN + ["train.spatial_parallel=true"])
    out["bf16"] = _train(["preset=smoke", "model.norm=group", "model.depth=2",
                          "data.image_size=32", "data.source_size=40",
                          "train.compute_dtype=bfloat16", "train.spatial_parallel=true"])
    out["norm"] = refusal(port_train.train, parse_overrides(
        ["preset=smoke", "train.spatial_parallel=true"]), device=CPU)
    return out


def _moved(variables, seed):
    """``variables`` with every GroupNorm scale and bias moved by seeded
    noise, so the affine part is not the identity."""
    rng = np.random.RandomState(seed)

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        a = np.array(tree, np.float32)
        if path[-2].startswith("gn"):
            a = a + rng.uniform(-0.3, 0.3, a.shape).astype(np.float32)
        return a

    return walk(variables)


@pytest.fixture(scope="module")
def variables():
    from cl_tpu_torch.interop import export_jax_variables

    def v(classes, base, depth):
        return _moved(export_jax_variables(_unet(classes, base, depth)), 5)

    cfg = parse_overrides(STEP)
    step_model = port_train.init_state(cfg, port_train.build_model(cfg), CPU)
    return {"fwd": v(*FWD[:3]), "grad": v(*GRAD[:3]),
            "step": _moved(export_jax_variables(step_model), 6)}


def _spawn(tmp_path_factory, variables, world):
    store = tmp_path_factory.mktemp("spatial_store") / "store"
    return sharding.spawn(group_run, (variables["fwd"], variables["grad"], variables["step"]),
                          world=world, backend="gloo", init_method=f"file://{store}",
                          devices=[CPU] * world, timeout=600)


@pytest.fixture(scope="module")
def groups(tmp_path_factory, variables):
    return {2: _spawn(tmp_path_factory, variables, 2), 4: _spawn(tmp_path_factory, variables, 4)}


@pytest.fixture(scope="module")
def cl_tpu_side(eight_devices, variables):
    """``cl_tpu``'s spatial forward, gradients and SGD step on 2 and 4
    virtual devices, from the same weights and inputs."""
    import jax
    import jax.numpy as jnp

    from cl_tpu import losses as jax_losses
    from cl_tpu import train as jax_train
    from cl_tpu.config import parse_overrides as jax_parse
    from cl_tpu.data import pipeline as jax_pipeline
    from cl_tpu.parallel import spatial as jax_spatial

    out = {}
    fp = jax.tree.map(jnp.asarray, variables["fwd"]["params"])
    gp = jax.tree.map(jnp.asarray, variables["grad"]["params"])
    x_f = jnp.asarray(_inputs(FWD[0], FWD[3])[0])
    x_g, y_g = (jnp.asarray(a) for a in _inputs(GRAD[0], GRAD[3]))
    jcfg = jax_parse(STEP)
    jmodel = jax_train.build_model(jcfg)
    tx = jax_train.build_optimizer(jcfg)
    hb = next(iter(jax_pipeline.train_batches(jcfg, 0, epoch=0)))
    valid = jnp.asarray(task_lib.valid_class_mask(
        jcfg.data.num_classes, task_lib.seen_classes(jcfg.classes_per_task, 0)))
    for n in (2, 4):
        mesh = jax_spatial.make_space_mesh(n, devices=eight_devices[:n])

        def loss_sp(p):
            logits = jax_spatial.spatial_apply(p, x_g, mesh, depth=GRAD[2])
            return jax_losses.cross_entropy(logits, y_g, jnp.ones(GRAD[0], bool))[0]

        params = jax.tree.map(jnp.asarray, variables["step"]["params"])
        state = jax_train.TrainState(step=jnp.int32(0), params=params, model_state={},
                                     opt_state=tx.init(params), ewc=None, lwf=None,
                                     rng=jax.random.PRNGKey(0))
        state, aux = jax_train.make_train_step(jcfg, jmodel, tx, spatial_mesh=mesh)(
            state, jax_pipeline.HostBatch(*(jnp.asarray(a) for a in hb)), valid)
        # jitted: shard_map run op by op takes minutes on the CPU
        fwd = jax.jit(lambda p, x: jax_spatial.spatial_apply(p, x, mesh, depth=FWD[2]))
        out[n] = {"fwd": np.asarray(fwd(fp, x_f)),
                  "grads": jax.tree_util.tree_leaves_with_path(jax.jit(jax.grad(loss_sp))(gp)),
                  "loss": float(aux["loss"]),
                  "leaves": jax.tree_util.tree_leaves_with_path({"params": state.params})}
    return out


def _flax_leaves(tree):
    import jax

    return dict(jax.tree_util.tree_leaves_with_path(tree))


@pytest.mark.parametrize("world", [2, 4])
def test_forward_matches_cl_tpu_and_unsharded(world, groups, cl_tpu_side, variables):
    got = torch.cat([r["fwd"] for r in groups[world]], dim=1).numpy()
    np.testing.assert_allclose(got, cl_tpu_side[world]["fwd"], atol=2e-4)
    classes, base, depth, size = FWD
    model = _unet(classes, base, depth)
    load_jax_variables(model, variables["fwd"])
    with torch.no_grad():
        ref = model(torch.from_numpy(_inputs(classes, size)[0])).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4)
    assert np.abs(ref).max() > 0.1


@pytest.mark.parametrize("world", [2, 4])
def test_grads_match_cl_tpu(world, groups, cl_tpu_side, variables):
    ref = _flax_leaves(grads(None, variables["grad"]))  # the one-rank forward's
    for r in range(world):
        got = _flax_leaves(groups[world][r]["grads"])
        assert len(got) == len(cl_tpu_side[world]["grads"]) == len(ref)
        for path, leaf in cl_tpu_side[world]["grads"]:
            np.testing.assert_allclose(got[path], np.asarray(leaf), atol=1e-4, err_msg=str(path))
            np.testing.assert_allclose(got[path], ref[path], atol=1e-4, err_msg=str(path))


def test_halo_rows_zero_at_edges(groups):
    shards = [r["halo"].numpy() for r in groups[4]]
    # rank r's rows: [halo_top, row, row, halo_bottom]
    np.testing.assert_array_equal(shards[0], [0, 1, 2, 3])
    np.testing.assert_array_equal(shards[1], [2, 3, 4, 5])
    np.testing.assert_array_equal(shards[2], [4, 5, 6, 7])
    np.testing.assert_array_equal(shards[3], [6, 7, 8, 0])


@pytest.mark.parametrize("world,key", [(2, "divide"), (4, "divide"), (4, "divide_train")])
def test_indivisible_height_raises(world, key, groups):
    msg = groups[world][0][key]
    assert msg is not None and "divide" in msg


def test_batchnorm_raises(groups):
    msg = groups[2][0]["norm"]
    assert msg is not None and "norm" in msg


def test_bf16_runs(groups):
    res = groups[2][0]["bf16"]
    assert res["spatial_parallel"] == 2
    assert np.isfinite(res["final_per_task_miou"]).all()


@pytest.mark.parametrize("world", [2, 4])
def test_step_matches_cl_tpu(world, groups, cl_tpu_side):
    aux, _, after = groups[world][0]["step"]
    np.testing.assert_allclose(aux["loss"], cl_tpu_side[world]["loss"], rtol=1e-5)
    got = _flax_leaves(torch_state_dict_to_variables(after))
    assert len(got) == len(cl_tpu_side[world]["leaves"])
    for path, leaf in cl_tpu_side[world]["leaves"]:
        np.testing.assert_allclose(got[path], np.asarray(leaf), atol=1e-4, err_msg=str(path))


def test_step_ignores_conv_impl_and_remat(groups):
    """``cl_tpu``'s spatial forward reads neither ``model.conv_impl`` nor
    ``train.remat``: the step under ``hybrid`` and remat is bit-equal."""
    a, b = groups[2][0]["step"], groups[2][0]["step_variants"]
    assert a[0] == b[0]
    for k in a[2]:
        assert torch.equal(a[2][k], b[2][k]), k


def test_grown_head_methods_step_matches_one_process(groups):
    want = methods_grow_run(None)
    for r in range(2):
        got = groups[2][r]["grow"]
        check_update(got, want, want[1], "grow")
        for term in ("ewc_penalty", "kd", "ce"):
            np.testing.assert_allclose(got[0][term], want[0][term], rtol=1e-5, err_msg=term)
    assert want[0]["ewc_penalty"] > 0 and want[0]["kd"] > 0


def test_sampled_fisher_matches_one_process(groups):
    want = fisher_run(None)
    assert float(want.abs().max()) > 0
    for r in range(2):
        assert float((groups[2][r]["fisher"] - want).norm()) <= 2e-4 * float(want.norm())
    assert torch.equal(groups[2][0]["fisher"], groups[2][1]["fisher"])


def test_eval_confusion_matches_one_process(groups):
    want = eval_run(STEP, None)
    for r in range(2):
        got = groups[2][r]["conf"]
        assert got.sum() == want.sum() > 0
        assert np.abs(got - want).sum() <= 2e-3 * want.sum()
    np.testing.assert_array_equal(groups[2][0]["conf"], groups[2][1]["conf"])


def test_train_matches_one_process(groups):
    want = _train(TRAIN + ["train.data_parallel=false"])
    for r in range(2):
        got = groups[2][r]["train"]
        assert got["spatial_parallel"] == 2 and got["data_parallel"] is None
        np.testing.assert_allclose(got["final_per_task_miou"], want["final_per_task_miou"],
                                   atol=5e-3)
    np.testing.assert_array_equal(groups[2][0]["train"]["miou_matrix"],
                                  groups[2][1]["train"]["miou_matrix"])


def test_one_process_trains_unsharded(tmp_path):
    """One device with ``train.spatial_parallel=true`` trains unsharded, with
    no norm check (``cl_tpu/train.py:1062``): BatchNorm, every bit of the
    report equal to ``spatial_parallel=false``'s, and no spatial event."""
    import json

    base = ["preset=smoke", "data.num_classes=3", "train.num_tasks=2"]
    log = tmp_path / "run.jsonl"
    got = _train(base + ["train.spatial_parallel=true", f"train.log_path={log}"])
    want = _train(base)
    np.testing.assert_array_equal(got["miou_matrix"], want["miou_matrix"])
    assert got["spatial_parallel"] is None
    events = {json.loads(line)["event"] for line in log.read_text().splitlines()}
    assert not events & {"packed_unet_disabled", "device_cache_disabled"}


@pytest.mark.parametrize("world", [2, 4])
def test_replicas_bit_equal(world, groups):
    res = groups[world]
    keys = [k for k in res[0] if isinstance(res[0][k], tuple)]
    assert keys
    for key in keys:
        for r in range(1, world):
            assert res[0][key][0] == res[r][key][0], key
            for k, v in res[0][key][2].items():
                assert torch.equal(v, res[r][key][2][k]), (key, r, k)
