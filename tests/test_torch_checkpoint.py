"""Per-task checkpoints and resume, the eval / predict / plot modes, and
EWC's sampled Fisher in the port, on the CPU.

Resume (after ``cl_tpu``'s ``tests/test_checkpoint.py``): a run killed by
``train.fail_after_task=0`` and resumed ends bit-equal to the uninterrupted
run, every leaf of the last ``state.pt`` (params, BatchNorm buffers, Adam's
moments and step, EWC's anchor and Fisher, the teacher) and the mIoU
matrix, on the host pipeline, on the device cache, across the two replay
buffer types, and with the sampled Fisher; the refusal across configs,
the async barrier, stale markers. Against ``cl_tpu`` on the same weights:
``evaluate``, ``predict_dataset``, ``plots``, and the Fisher's gradient on
the sampled labels. The draw itself by its distribution.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_tpu import plots as jax_plots
from cl_tpu import predict as jax_predict
from cl_tpu import train as jax_train
from cl_tpu.config import parse_overrides as jax_parse
from cl_tpu.methods import ewc as jax_ewc
from cl_tpu_torch import checkpoint as ckpt
from cl_tpu_torch import plots, predict
from cl_tpu_torch import train as port_train
from cl_tpu_torch.augment import augment
from cl_tpu_torch.config import parse_overrides
from cl_tpu_torch.data import pipeline, tasks
from cl_tpu_torch.interop import export_jax_variables, torch_state_dict_to_variables
from cl_tpu_torch.methods import ewc
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
CACHED = ["data.device_cache=true", "method.replay_device_resident=true"]


def _args(d, extra=()):
    return ["preset=smoke", "data.num_classes=5", "train.num_tasks=2",
            "method.methods=ewc,lwf,replay", f"train.checkpoint_dir={d}",
            "train.epochs_per_task=1", "data.train_images_per_task=8",
            "train.data_parallel=false", *extra]


def _train(d, extra=()):
    return port_train.train(parse_overrides(_args(d, extra)), device=CPU)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _last_state(d, T=2):
    return dict(_leaves(torch.load(os.path.join(d, f"task_{T - 1}", "state.pt"),
                                   weights_only=True)))


def _assert_same_run(got_dir, got, want_dir, want):
    """Every leaf of the last state.pt bit-equal, and the mIoU matrix."""
    a, b = _last_state(got_dir), _last_state(want_dir)
    assert a.keys() == b.keys()
    tensors = 0
    for k in b:
        if isinstance(b[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
            tensors += 1
        else:
            assert a[k] == b[k], k
    # params and buffers, Adam's two moments and step a param, the EWC
    # anchor, Fisher and weight, the teacher's params and buffers
    assert any(k.startswith("/ewc/fisher") for k in b) and any("/lwf/teacher" in k for k in b)
    assert any(k.endswith("/step") for k in b) and tensors > 100
    np.testing.assert_array_equal(np.asarray(got["miou_matrix"]),
                                  np.asarray(want["miou_matrix"]))


@pytest.fixture(scope="module")
def full(tmp_path_factory):
    """The uninterrupted run on the host pipeline with the host buffer,
    its JSONL log kept."""
    d = str(tmp_path_factory.mktemp("full") / "ckpt")
    log = os.path.join(os.path.dirname(d), "run.jsonl")
    return d, _train(d, [f"train.log_path={log}"]), log


@pytest.mark.parametrize("fail_extra,resume_extra", [
    ([], []),                                         # the host pipeline
    (CACHED, CACHED),                                 # the device cache, device buffer
    ([], CACHED),                                     # host buffer -> device buffer
    (CACHED, ["train.log_path=other.jsonl"]),         # device buffer -> host buffer
], ids=["host", "device_cache", "host_to_device_buffer", "device_to_host_buffer"])
def test_fail_then_resume_equals_the_uninterrupted_run(full, tmp_path, monkeypatch,
                                                       fail_extra, resume_extra):
    """The resume passes the hash check with another log path, without the
    fault injection and with ``data.device_cache`` or the buffer's
    residency toggled (``Config._HASH_EXCLUDE``)."""
    monkeypatch.chdir(tmp_path)
    d = str(tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="fault injection"):
        _train(d, fail_extra + ["train.fail_after_task=0"])
    assert ckpt.latest_task(parse_overrides(_args(d))) == 0
    resumed = _train(d, resume_extra + ["train.resume=true"])
    _assert_same_run(d, resumed, full[0], full[1])


def test_resume_logs_the_task_it_resumed(tmp_path):
    d = str(tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="fault injection"):
        _train(d, ["train.fail_after_task=0"])
    log = str(tmp_path / "run.jsonl")
    _train(d, ["train.resume=true", f"train.log_path={log}"])
    events = plots.load_events(log)
    assert [e["task"] for e in events if e["event"] == "resumed"] == [0]
    assert [e["task"] for e in events if e["event"] == "task_done"] == [1]
    # the resumed task's mIoU row is the only one this run evaluated
    assert {e["after_task"] for e in events if e["event"] == "eval"} == {1}


def test_refuses_cross_config_resume(tmp_path):
    d = str(tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="fault injection"):
        _train(d, ["train.fail_after_task=0"])
    with pytest.raises(ValueError, match="config hash"):
        _train(d, ["train.lr=0.9", "train.resume=true"])


def _state(cfg):
    model = port_train.init_state(cfg, port_train.build_model(cfg), CPU)
    from cl_tpu_torch.methods import lwf

    return ckpt.TrainState(model, port_train.build_optimizer(cfg, model),
                           ewc.make_ewc_state(model, mode="online"), lwf.make_lwf_state(model))


def test_async_save_clones_before_returning_and_restores_in_place(tmp_path):
    """``save_task`` returns before the write (``latest_task`` is the
    barrier) with the state already copied: params changed in place after
    it returns are not in the checkpoint. Restore loads into the objects
    the steps hold (the same teacher, the same EWC tensors)."""
    cfg = parse_overrides(_args(str(tmp_path / "ckpt")))
    st = _state(cfg)
    with torch.no_grad():
        st.lwf.teacher.head.weight.add_(1.0)
        st.ewc.fisher.fill_(0.5)
    st.lwf.weight = 1.0
    saved = {k: v.clone() for k, v in st.model.state_dict().items()}
    teacher_head = st.lwf.teacher.head.weight.clone()
    d = ckpt.save_task(cfg, st, None, 0, np.full((2, 2), np.nan))
    with torch.no_grad():
        for p in st.model.parameters():
            p.add_(1.0)
    assert ckpt.latest_task(cfg) == 0  # the barrier
    assert os.path.exists(os.path.join(d, "meta.json"))
    fresh = _state(cfg)
    teacher, fisher = fresh.lwf.teacher, fresh.ewc.fisher
    _, _, t, miou = ckpt.restore_task(cfg, fresh, None, 0)
    assert t == 0 and np.isnan(miou).all()
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    assert fresh.lwf.teacher is teacher and fresh.ewc.fisher is fisher
    assert torch.equal(teacher.head.weight, teacher_head) and bool((fisher == 0.5).all())
    assert fresh.lwf.weight == 1.0
    ckpt.wait_for_saves()  # idempotent


def test_stale_meta_removed_and_errors_do_not_leak(tmp_path, monkeypatch):
    """A reused directory's old meta.json does not mark a failed save
    complete; the failure raises once from ``wait_for_saves``."""
    cfg = parse_overrides(_args(str(tmp_path / "ckpt")))
    st, miou = _state(cfg), np.full((2, 2), np.nan)
    d = ckpt.save_task(cfg, st, None, 0, miou, block=True)
    assert os.path.exists(os.path.join(d, "meta.json"))

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_write", boom)
    ckpt.save_task(cfg, st, None, 0, miou)
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait_for_saves()
    assert not os.path.exists(os.path.join(d, "meta.json"))
    monkeypatch.undo()
    ckpt.wait_for_saves()  # clean
    assert ckpt.latest_task(cfg) is None
    ckpt.save_task(cfg, st, None, 0, miou, block=True)
    assert ckpt.latest_task(cfg) == 0


def test_fresh_run_invalidates_stale_later_tasks(tmp_path):
    """Saving task t de-marks a previous run's task_{k>t}; a user's
    ``task_old`` beside them is left alone."""
    cfg = parse_overrides(_args(str(tmp_path / "ckpt")))
    st, miou = _state(cfg), np.full((2, 2), np.nan)
    ckpt.save_task(cfg, st, None, 0, miou, block=True)   # run A
    ckpt.save_task(cfg, st, None, 1, miou, block=True)
    os.makedirs(tmp_path / "ckpt" / "task_old")
    assert ckpt.latest_task(cfg) == 1
    ckpt.save_task(cfg, st, None, 0, miou, block=True)   # run B
    assert ckpt.latest_task(cfg) == 0


# ---------------------------------------------------------------------------
# The sampled Fisher
# ---------------------------------------------------------------------------


def test_sampled_fisher_resumes_bit_equal_and_its_two_paths_agree(tmp_path):
    """``method.ewc_fisher_kind=true``: fail and resume equal the
    uninterrupted run; its Fisher differs from the empirical one; the
    Fisher pass over the device cache equals the host pipeline's."""
    true = ["method.ewc_fisher_kind=true"]
    want = _train(str(tmp_path / "full"), true)
    d = str(tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="fault injection"):
        _train(d, true + CACHED + ["train.fail_after_task=0"])
    _assert_same_run(d, _train(d, true + ["train.resume=true"]), str(tmp_path / "full"), want)
    empirical = _train(str(tmp_path / "emp"))
    fa = _last_state(str(tmp_path / "full"))["/ewc/fisher"]
    fb = _last_state(str(tmp_path / "emp"))["/ewc/fisher"]
    assert empirical is not None and not torch.equal(fa, fb)

    cfg = parse_overrides(_args(d, true))
    model = port_train.init_state(cfg, port_train.build_model(cfg), CPU)
    seen = tasks.valid_class_mask(5, tasks.seen_classes(cfg.classes_per_task, 0))
    step = port_train.make_fisher_step(cfg, model, CPU)
    from cl_tpu_torch.data.device_cache import DeviceDatasetCache

    cache = DeviceDatasetCache(pipeline.make_datasets(cfg, 0)[0], CPU)
    host = port_train.run_fisher_pass(cfg, step, model, 0, seen, CPU)
    cached = port_train.run_fisher_pass(cfg, step, model, 0, seen, CPU, cache=cache)
    assert torch.equal(host, cached) and bool((host > 0).any())
    with pytest.raises(ValueError, match="generator"):
        step(torch.zeros_like(host), next(iter(pipeline.train_batches(cfg, 0, 0))),
             torch.from_numpy(seen))


def _draw_case(shape, C, seed):
    rng = np.random.RandomState(seed)
    logits = torch.from_numpy((rng.randn(*shape, C) * 2).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, C, size=shape).astype(np.int32))
    y[torch.from_numpy(rng.rand(*shape) < 0.1)] = 255
    valid = torch.ones(C, dtype=torch.bool)
    valid[C // 2:C // 2 + 3] = False
    return logits, y, valid


def test_sampled_labels_by_their_distribution():
    """No masked class is drawn, 255 stays, one seed draws the same labels,
    and 2¹⁶ draws at four pixels fit their softmax (χ², p > 1e-3)."""
    from scipy.stats import chisquare

    logits, y, valid = _draw_case((2, 16, 16), 11, 0)
    draw = lambda s: ewc.sample_fisher_labels(  # noqa: E731
        logits, y, valid, torch.Generator().manual_seed(s))
    a = draw(5)
    assert a.dtype == y.dtype and torch.equal(a, draw(5)) and not torch.equal(a, draw(6))
    assert torch.equal(a[y == 255], y[y == 255])
    assert not bool(torch.isin(a[y != 255], torch.nonzero(~valid).flatten()).any())
    n = 1 << 16
    pix = logits[0, 0, :4]                                  # four pixels' logits
    reps = pix[None, None].expand(n, 1, 4, 11).contiguous()
    got = ewc.sample_fisher_labels(reps, torch.zeros(n, 1, 4, dtype=torch.int32), valid,
                                   torch.Generator().manual_seed(1))
    p = torch.softmax(torch.where(valid, pix.double(), -np.inf), dim=-1).numpy()
    for j in range(4):
        counts = np.bincount(got[:, 0, j].numpy(), minlength=11)
        assert counts[~valid.numpy()].sum() == 0
        obs, exp = counts[valid.numpy()], n * p[j][valid.numpy()]
        assert chisquare(obs, exp).pvalue > 1e-3, (j, obs, exp)


@pytest.fixture(scope="module")
def same_weights():
    """The port's smoke model after one short run's training and cl_tpu's
    TrainState holding the same weights."""
    args = ["preset=smoke", "data.num_classes=5", "train.num_tasks=2",
            "train.data_parallel=false", "data.val_images_per_task=6"]
    cfg, jcfg = parse_overrides(args), jax_parse(args)
    model = port_train.init_state(cfg, port_train.build_model(cfg), CPU)
    rng = np.random.RandomState(4)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(torch.from_numpy(rng.rand(*t.shape).astype(np.float32) + 0.5))
            elif name.endswith("running_mean"):
                t.copy_(torch.from_numpy(rng.randn(*t.shape).astype(np.float32) * 0.1))
            elif t.is_floating_point():
                t.add_(torch.from_numpy(rng.randn(*t.shape).astype(np.float32) * 0.05))
    v = export_jax_variables(model)
    params = jax.tree.map(jnp.asarray, v["params"])
    tx = jax_train.build_optimizer(jcfg)
    state = jax_train.TrainState(
        step=jnp.int32(0), params=params,
        model_state={"batch_stats": jax.tree.map(jnp.asarray, v["batch_stats"])},
        opt_state=tx.init(params), ewc=None, lwf=None, rng=jax.random.PRNGKey(0))
    return cfg, jcfg, model, state


@pytest.mark.parametrize("task_id,seen_task", [(0, None), (0, 1), (1, 1)])
def test_evaluate_matches_cl_tpu(same_weights, task_id, seen_task):
    cfg, jcfg, model, state = same_weights
    got = port_train.evaluate(cfg, model, task_id, seen_task, device=CPU)
    want = jax_train.evaluate(jcfg, state, task_id, seen_task)
    np.testing.assert_array_equal(got["confusion"], np.asarray(want["confusion"]))
    np.testing.assert_allclose(got["miou"], want["miou"], atol=1e-6)


def test_predict_dataset_matches_cl_tpu(same_weights):
    """The masks agree except at pixels whose top two logits lie within
    1e-5 (f32 sums in another order may swap them); those are counted."""
    cfg, jcfg, model, state = same_weights
    _, val_ds = pipeline.make_datasets(cfg, 1)
    got = predict.predict_dataset(cfg, model, val_ds, batch_size=4, device=CPU)
    want = np.asarray(jax_predict.predict_dataset(jcfg, state, val_ds, batch_size=4))
    assert got.shape == want.shape == (6, 32, 32) and got.dtype == np.uint8
    imgs = torch.from_numpy(np.stack([val_ds[i][0] for i in range(len(val_ds))]))
    x, _ = augment(imgs, torch.zeros(imgs.shape[:3], dtype=torch.uint8),
                   torch.zeros(len(val_ds), dtype=torch.bool), out_size=32,
                   mean=cfg.data.mean, std=cfg.data.std)
    with torch.no_grad():
        top2 = model.eval()(x).topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1] <= 1e-5).numpy()
    differ = got != want
    assert not (differ & ~near).any(), int((differ & ~near).sum())
    assert differ.sum() <= near.sum() < got.size // 100
    assert set(np.unique(got)) <= set(range(5))


def test_plots_match_cl_tpu(full, tmp_path):
    events = plots.load_events(full[2])
    got = plots.miou_matrix_from_events(events)
    np.testing.assert_array_equal(got, jax_plots.miou_matrix_from_events(events))
    np.testing.assert_array_equal(got, np.asarray(full[1]["miou_matrix"]))
    ours = plots.plot_run(full[2], str(tmp_path / "port"))
    theirs = jax_plots.plot_run(full[2], str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs] == [
        "loss_curves.png", "miou_heatmap.png", "forgetting_curves.png"]
    assert all(os.path.getsize(p) > 0 for p in ours)


def test_fisher_grads_on_sampled_labels_match_cl_tpu(same_weights):
    """``fisher_batch_grads`` with a generator draws from its own forward's
    logits: it equals ``fisher_batch_grads`` on the labels
    ``sample_fisher_labels`` draws from the eval-mode logits, bit for bit,
    and both match ``cl_tpu``'s ``fisher_batch_grads(kind="empirical")`` fed
    the same labels, within 2e-4 of each leaf's norm (the Fisher's
    tolerance, ``tests/test_torch_ewc.py``)."""
    cfg, jcfg, model, state = same_weights
    b = pipeline.put_batch(next(iter(pipeline.train_batches(cfg, 1, 0))), CPU)
    x, y = augment(b.image, b.mask, b.flip, out_size=32, mean=cfg.data.mean, std=cfg.data.std)
    valid = torch.from_numpy(tasks.valid_class_mask(5, tasks.seen_classes(
        cfg.classes_per_task, 1)))
    with torch.no_grad():
        logits = model.eval()(x)
    labels = ewc.sample_fisher_labels(logits, y, valid, torch.Generator().manual_seed(3))
    assert not torch.equal(labels, y)
    g = ewc.fisher_batch_grads(model, x, labels, valid)
    assert torch.equal(g, ewc.fisher_batch_grads(model, x, y, valid,
                                                 generator=torch.Generator().manual_seed(3)))
    apply = jax_train.build_model(jcfg).apply
    want = jax.jit(lambda p, ms, *a: jax_ewc.fisher_batch_grads(
        apply, p, ms, *a, kind="empirical", rng=None, ignore_index=255, square=False))(
        state.params, state.model_state, jnp.asarray(x), jnp.asarray(labels.numpy()),
        jnp.asarray(valid.numpy()))
    sd, off = {}, 0
    for name, p in model.named_parameters():
        sd[name] = g[off:off + p.numel()].reshape(p.shape)
        off += p.numel()
    got = torch_state_dict_to_variables(sd)["params"]
    pairs = zip(jax.tree_util.tree_leaves_with_path(got),
                jax.tree_util.tree_leaves_with_path(want))
    for (pa, a), (pb, w) in pairs:
        assert pa == pb
        a, w = np.asarray(a), np.asarray(w)
        assert np.linalg.norm(a - w) <= 2e-4 * np.linalg.norm(w), (
            jax.tree_util.keystr(pa), np.linalg.norm(a - w) / np.linalg.norm(w))


def test_meta_json_is_cl_tpu_s_layout(full):
    with open(os.path.join(full[0], "task_1", "meta.json")) as f:
        meta = json.load(f)
    assert meta["task_id"] == 1
    assert meta["config_hash"] == jax_parse(_args(full[0])).config_hash()
    np.testing.assert_array_equal(np.asarray(meta["miou_matrix"], float),
                                  np.asarray(full[1]["miou_matrix"]))
    assert sorted(os.listdir(os.path.join(full[0], "task_1"))) == [
        "meta.json", "replay.pkl", "state.pt"]
