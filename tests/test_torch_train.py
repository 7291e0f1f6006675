"""The port's data pipeline, augment, metrics, optimizer and train step
against the JAX package, on the CPU at a small size (UNet base 8, depth 3,
32², 3 classes).

The train step starts both packages from the same weights and batch and
compares the loss and every updated param within 1e-4 (the same f32
arithmetic; sums in another order), for the fused head+CE branch and for
``train.fused_head_ce=false`` (the CE kernel on materialized logits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_tpu import augment as jax_augment
from cl_tpu import metrics as jax_metrics
from cl_tpu import train as jax_train
from cl_tpu.config import parse_overrides as jax_parse
from cl_tpu.data import pipeline as jax_pipeline
from cl_tpu.data import tasks as jax_tasks
from cl_tpu_torch import augment as port_augment
from cl_tpu_torch import metrics as port_metrics
from cl_tpu_torch import train as port_train
from cl_tpu_torch.config import parse_overrides
from cl_tpu_torch.data import pipeline
from cl_tpu_torch.interop import export_jax_variables

ARGS = ["preset=smoke", "data.num_classes=3", "model.depth=3",
        "train.data_parallel=false", "data.train_images_per_task=8"]
CPU = torch.device("cpu")


def test_train_batch_stream_bit_equal():
    args = ARGS + ["data.batch_size=3", "data.val_images_per_task=5"]
    cfg, jcfg = parse_overrides(args), jax_parse(args)
    for epoch in (0, 1):
        a = list(pipeline.train_batches(cfg, 0, epoch))
        b = list(jax_pipeline.train_batches(jcfg, 0, epoch))
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            for u, v in zip(x, y):
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)
    a = list(pipeline.val_batches(cfg, 0))
    b = list(jax_pipeline.val_batches(jcfg, 0))
    assert len(a) == len(b) == 2  # the padded final batch included
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


def test_prefetch_yields_the_stream_in_order():
    cfg = parse_overrides(ARGS + ["data.batch_size=2"])
    host = list(pipeline.train_batches(cfg, 0, 0))
    dev = list(pipeline.prefetch_to_device(
        pipeline.train_batches(cfg, 0, 0), device=CPU, depth=2))
    assert len(dev) == len(host) == 4
    for h, d in zip(host, dev):
        for u, v in zip(h, d):
            np.testing.assert_array_equal(v.numpy(), u)


def test_augment_matches_jax():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (3, 40, 40, 3)).astype(np.uint8)
    mask = rng.randint(0, 3, (3, 40, 40)).astype(np.uint8)
    flip = np.array([True, False, True])
    kw = dict(out_size=32, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225))
    xj, yj = jax_augment.augment_jnp(jnp.asarray(img), jnp.asarray(mask),
                                     jnp.asarray(flip), **kw)
    xt, yt = port_augment.augment(torch.from_numpy(img), torch.from_numpy(mask),
                                  torch.from_numpy(flip), **kw)
    assert xt.shape == (3, 32, 32, 3) and yt.dtype == torch.int32
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5, atol=1e-5)


def test_confusion_matrix_equal():
    rng = np.random.RandomState(2)
    logits = rng.randn(2, 8, 8, 4).astype(np.float32)
    labels = rng.randint(0, 4, (2, 8, 8)).astype(np.int32)
    labels[0, :2] = 255
    valid = np.array([True, True, False, True])
    conf0 = rng.randint(0, 5, (4, 4)).astype(np.float32)
    cj = jax_metrics.confusion_matrix_update(
        jnp.asarray(conf0), jnp.asarray(logits), jnp.asarray(labels),
        jnp.asarray(valid))
    ct = port_metrics.confusion_matrix_update(
        torch.from_numpy(conf0), torch.from_numpy(logits),
        torch.from_numpy(labels), torch.from_numpy(valid))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert port_metrics.miou(ct.numpy(), [0, 1]) == jax_metrics.miou(
        np.asarray(cj), [0, 1])


def _jax_state(jcfg, variables, tx):
    params = jax.tree.map(jnp.asarray, variables["params"])
    return jax_train.TrainState(
        step=jnp.int32(0), params=params,
        model_state={"batch_stats": jax.tree.map(jnp.asarray,
                                                 variables["batch_stats"])},
        opt_state=tx.init(params), ewc=None, lwf=None,
        rng=jax.random.PRNGKey(0))


@pytest.mark.parametrize("fused", ["auto", "false"])
def test_one_train_step_matches_jax(fused):
    # SGD: Adam's first step is lr·g/(|g|+1e-8), so a parameter whose
    # gradient is ~1e-8 moves by ±lr on rounding noise alone;
    # test_optimizer_matches_optax holds Adam to optax on equal gradients.
    args = ARGS + [f"train.fused_head_ce={fused}", "train.optimizer=sgd",
                   "train.lr=0.05"]
    cfg, jcfg = parse_overrides(args), jax_parse(args)
    assert port_train.fused_head_on(cfg) == (fused == "auto")

    model = port_train.init_state(cfg, port_train.build_model(cfg), CPU)
    variables = export_jax_variables(model)
    opt = port_train.build_optimizer(cfg, model)
    step = port_train.make_train_step(cfg, model, opt, CPU)

    jmodel = jax_train.build_model(jcfg)
    tx = jax_train.build_optimizer(jcfg)
    state = _jax_state(jcfg, variables, tx)
    jstep = jax_train.make_train_step(jcfg, jmodel, tx, mesh=None)

    hb = next(iter(pipeline.train_batches(cfg, 0, 0)))
    valid = jax_tasks.valid_class_mask(3, jax_tasks.seen_classes(
        jcfg.classes_per_task, 0))
    aux = step(pipeline.put_batch(hb, CPU), torch.from_numpy(valid))
    state, jaux = jstep(state, jax_pipeline.HostBatch(
        *(jnp.asarray(a) for a in hb)), jnp.asarray(valid))

    np.testing.assert_allclose(aux["loss"].item(), float(jaux["loss"]),
                               rtol=1e-4, atol=1e-4)
    assert float(aux["n_pix"]) == float(jaux["n_pix"])
    got = dict(jax.tree_util.tree_leaves_with_path(
        export_jax_variables(model)))
    want = jax.tree_util.tree_leaves_with_path(
        {"params": state.params, **state.model_state})
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_allclose(got[path], np.asarray(leaf), rtol=1e-4,
                                   atol=1e-4, err_msg=str(path))


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_optimizer_matches_optax(name):
    """Three updates from the same gradients: torch.optim as built by
    build_optimizer against optax as built by cl_tpu's build_optimizer
    (weight decay on, so the decayed-weights term is covered too)."""
    args = ["preset=smoke", f"train.optimizer={name}", "train.lr=0.01",
            "train.weight_decay=0.001"]
    rng = np.random.RandomState(3)
    p0 = rng.randn(5, 4).astype(np.float32)
    grads = [rng.randn(5, 4).astype(np.float32) for _ in range(3)]

    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    holder = torch.nn.Module()
    holder.w = w
    opt = port_train.build_optimizer(parse_overrides(args), holder)
    tx = jax_train.build_optimizer(jax_parse(args))
    pj = jnp.asarray(p0)
    sj = tx.init(pj)
    for g in grads:
        w.grad = torch.from_numpy(g.copy())
        opt.step()
        upd, sj = tx.update(jnp.asarray(g), sj, pj)
        pj = pj + upd
        # torch and optax order Adam's bias corrections differently:
        # f32 rounding apart
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(pj),
                                   rtol=1e-5, atol=1e-6)
