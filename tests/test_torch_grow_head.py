"""Grow-the-head (``model.padded_head=false``) in the port against
``cl_tpu``'s head expansion (``cl_tpu/train.py:914-939``,
``cl_tpu/models/unet.py:836-877``), on the CPU.

* ``expand_head`` keeps the old classes' logits bit for bit
  (``tests/unit/test_head_expand.py``), draws the new rows untruncated at
  sqrt(1/fan_in) with a zero bias, and keeps the device, dtype and memory
  format; the zero expansions of the flat EWC vectors (online and
  separate) and of the LwF teacher equal ``cl_tpu``'s ``expand_head_zeros``
  carried across by ``interop``, bit for bit; ``old_valid`` stays
  ``num_classes`` wide; the optimizer is a fresh one after growth.
* One SGD step of task 1 after growth with EWC, LwF and a replay-widened
  batch (the fused head on NHWC features, the losses on logits padded with
  −1e9, and the packed KD head at 64², base 32), against ``cl_tpu``'s step
  after its ``_expand_state``: the same pre-growth state on both sides (a
  perturbed anchor, a positive Fisher, a perturbed teacher), each side's
  own surgery, then ``cl_tpu``'s
  drawn head rows carried across (the draws' bits differ by design). Loss,
  penalty, KD and every param within 1e-4, each update within 1e-2 of its
  norm plus one f32 ulp.
* ``train()`` over 2 tasks (``data.num_classes=5``: widths 3, then 5 from
  task 1's ``head_expanded``) with all three methods; its fail-and-resume
  bit-equal to the unbroken run (every leaf of the last ``state.pt``, the
  mIoU matrix); ``eval`` / ``predict`` from a grow checkpoint at the stored
  width; ``init_variables`` refused under grow.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_tpu import train as jax_train
from cl_tpu.config import parse_overrides as jax_parse
from cl_tpu.data import pipeline as jax_pipeline
from cl_tpu.methods import ewc as jax_ewc
from cl_tpu.methods import lwf as jax_lwf
from cl_tpu.models import unet as jax_unet
from cl_tpu_torch import checkpoint as ckpt
from cl_tpu_torch import cli
from cl_tpu_torch import predict as port_predict
from cl_tpu_torch import train as port_train
from cl_tpu_torch.config import parse_overrides
from cl_tpu_torch.data import pipeline
from cl_tpu_torch.data import tasks as task_lib
from cl_tpu_torch.interop import ewc_state_from_jax, export_jax_variables, load_jax_variables
from cl_tpu_torch.methods import ewc as ewc_lib
from cl_tpu_torch.methods import lwf as lwf_lib
from cl_tpu_torch.methods.replay import ReplayBuffer
from cl_tpu_torch.models.unet import UNet, expand_head, init_weights

from test_torch_checkpoint import _args, _assert_same_run, _last_state
from test_torch_ewc import _ewc_trees
from test_torch_lwf import _teacher_variables
from test_torch_packed_head import check_step
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
GROW = ["model.padded_head=false"]


def _valid(n, cfg, task):
    return task_lib.valid_class_mask(n, task_lib.seen_classes(cfg.classes_per_task, task))


# ---------------------------------------------------------------------------
# The surgery
# ---------------------------------------------------------------------------


def test_expand_head_keeps_old_class_logits_exactly():
    small = UNet(5, base_channels=8, depth=2, head_width=3)
    init_weights(small, torch.Generator().manual_seed(0))
    small = small.to(memory_format=torch.channels_last).eval()
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 16, 16, 3).astype(np.float32))
    with torch.no_grad():
        before = small(x)
        old_w = small.head.weight.detach().clone()
        expand_head(small, 5, torch.Generator().manual_seed(1))
        after = small(x)
    assert before.shape == after.shape == (2, 16, 16, 5)
    assert torch.all(before[..., 3:] == -1e9)  # the narrow head's logits, padded
    assert torch.equal(after[..., :3], before[..., :3])
    assert torch.all(after[..., 3:] > -1e8)
    w = small.head.weight
    assert w.shape == (5, 8, 1, 1) and w.dtype == torch.float32 and w.requires_grad
    assert torch.equal(w[:3], old_w) and torch.equal(small.head.bias[3:], torch.zeros(2))
    assert w.is_contiguous(memory_format=torch.channels_last)
    assert [n for n, _ in small.named_parameters()][-2:] == ["head.weight", "head.bias"]
    # the new rows: untruncated N(0, 1/fan_in) (cl_tpu's lecun_normal
    # without the truncation) on a CPU generator, so every device draws them
    big = UNet(5, base_channels=64, depth=1, head_width=1)
    init_weights(big, torch.Generator().manual_seed(4))  # no row of uninitialized memory
    expand_head(big, 5, torch.Generator().manual_seed(3))
    rows = big.head.weight[1:].detach().numpy().ravel() * np.sqrt(64)
    assert abs(rows.std() - 1) < 0.15 and np.abs(rows).max() > 2.0
    again = UNet(5, base_channels=64, depth=1, head_width=1)
    again.load_state_dict({k: v for k, v in big.state_dict().items() if "head" not in k},
                          strict=False)
    again.head.weight.data.copy_(big.head.weight[:1])
    expand_head(again, 5, torch.Generator().manual_seed(3))
    assert torch.equal(again.head.weight, big.head.weight)


@pytest.fixture(scope="module")
def narrow():
    """The grow config (5 classes, 2 tasks), a smoke model of it with a head
    of 3 (task 0's width) and its flax tree."""
    cfg = parse_overrides(["preset=smoke", "data.num_classes=5", "train.num_tasks=2"] + GROW)
    model = port_train.init_state(cfg, port_train.build_model(cfg), CPU)
    assert model.head.weight.shape[0] == port_train.task_head_width(cfg, 0) == 3
    variables = export_jax_variables(model)
    return cfg, model, variables


@pytest.mark.parametrize("mode", ["online", "separate"])
def test_ewc_vectors_expand_with_zeros_as_cl_tpu(narrow, mode):
    cfg, model, variables = narrow
    T = None if mode == "online" else 2
    anchor, fisher = _ewc_trees(variables["params"], 5, T=T)
    jstate = jax_ewc.EWCState(anchor=anchor, fisher=fisher, weight=np.float32(1.0),
                              n_tasks=np.int32(1))
    port = ewc_state_from_jax(model, jstate, mode=mode)
    grown = UNet(5, base_channels=8, depth=4, head_width=3)
    grown.load_state_dict(model.state_dict())
    expand_head(grown, 5, torch.Generator().manual_seed(0))
    ewc_lib.expand_head_zeros(port, grown, 3)

    def zeros5(tree):  # cl_tpu's expand_head_zeros, under a task axis too
        if T is None:
            return jax_unet.expand_head_zeros(tree, 5)
        return jax.tree.map(lambda *s: np.stack(s), *[jax_unet.expand_head_zeros(
            jax.tree.map(lambda a, t=t: a[t], tree), 5) for t in range(T)])

    want = ewc_state_from_jax(grown, jstate._replace(anchor=zeros5(anchor),
                                                     fisher=zeros5(fisher)), mode=mode)
    n = ewc_lib.n_params(grown)
    assert port.anchor.shape == ((n,) if T is None else (T, n))
    assert torch.equal(port.anchor, want.anchor) and torch.equal(port.fisher, want.fisher)
    assert int((port.fisher == 0).sum()) == (1 if T is None else T) * 2 * (8 + 1)


def test_teacher_expands_with_zeros_and_old_valid_stays_num_classes_wide(narrow):
    """``old_valid`` spans ``num_classes`` (5) under a head of 3, before and
    after growth (the KD kernels take a [C] mask); the teacher's head takes
    zero rows, as ``cl_tpu``'s snapshot does."""
    cfg, model, variables = narrow
    student = copy.deepcopy(model)
    st = lwf_lib.make_lwf_state(student)
    assert st.old_valid.shape == (5,) and st.teacher.head.weight.shape[0] == 3
    tvars = _teacher_variables(variables, 4)
    load_jax_variables(st.teacher, tvars)
    port_train.expand_state(cfg, ckpt.TrainState(student, None, None, st), 5, 1)
    assert st.old_valid.shape == (5,) and student.head.weight.shape[0] == 5
    assert not any(p.requires_grad for p in st.teacher.parameters())
    got = export_jax_variables(st.teacher)
    want = jax_unet.expand_head_zeros(tvars["params"], 5)
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        np.testing.assert_array_equal(dict(jax.tree_util.tree_leaves_with_path(
            got["params"]))[path], np.asarray(leaf), err_msg=str(path))


def test_optimizer_is_fresh_after_growth(narrow):
    """``cl_tpu`` re-initializes the optimizer for every param
    (``tx.init(params)``): Adam's moments and step start over, and the new
    optimizer holds the grown head."""
    cfg, _, variables = narrow
    model = port_train.init_state(cfg, port_train.build_model(cfg), CPU)
    load_jax_variables(model, variables)
    state = ckpt.TrainState(model, port_train.build_optimizer(cfg, model))
    step = port_train.make_train_step(cfg, model, state.optimizer, CPU)
    batch = pipeline.put_batch(next(iter(pipeline.train_batches(cfg, 0, 0))), CPU)
    step(batch, torch.from_numpy(_valid(5, cfg, 0)))
    old_opt = state.optimizer
    assert all(float(s["step"]) == 1 for s in old_opt.state.values())
    port_train.expand_state(cfg, state, 5, 1)
    assert state.optimizer is not old_opt and not state.optimizer.state
    held = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert held == {id(p) for p in model.parameters()} and id(model.head.weight) in held
    step = port_train.make_train_step(cfg, model, state.optimizer, CPU)
    step(batch, torch.from_numpy(_valid(5, cfg, 1)))
    assert all(float(s["step"]) == 1 for s in state.optimizer.state.values())
    assert state.optimizer.state[model.head.weight]["exp_avg"].shape == (5, 8, 1, 1)


# ---------------------------------------------------------------------------
# The task-1 step after growth against cl_tpu's
# ---------------------------------------------------------------------------

STEP = ["preset=smoke", "data.num_classes=5", "train.num_tasks=2", "train.data_parallel=false",
        "method.methods=ewc,lwf,replay", "method.replay_batch=1", "train.optimizer=sgd",
        "train.lr=0.05"] + GROW


def _grow_step(extra):
    args = STEP + extra
    cfg, jcfg = parse_overrides(args), jax_parse(args)
    model = port_train.init_state(cfg, port_train.build_model(cfg), CPU)
    variables = export_jax_variables(model)
    tvars = _teacher_variables(variables, 11)
    anchor, fisher = _ewc_trees(variables["params"], 21, fisher_scale=1e-3)
    jewc = jax_ewc.EWCState(anchor=anchor, fisher=fisher, weight=np.float32(1.0),
                            n_tasks=np.int32(1))
    old_valid = _valid(5, cfg, 0)
    valid = _valid(5, cfg, 1)
    w1 = port_train.task_head_width(cfg, 1)
    assert w1 == 5 and model.head.weight.shape[0] == 3

    # cl_tpu: the same state at width 3, then its surgery
    tx = jax_train.build_optimizer(jcfg)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jl = jax_lwf.LwFState(
        old_params=jax.tree.map(jnp.asarray, tvars["params"]),
        old_model_state={"batch_stats": jax.tree.map(jnp.asarray, tvars["batch_stats"])},
        old_valid=jnp.asarray(old_valid), weight=jnp.float32(1.0))
    state = jax_train.TrainState(
        step=jnp.int32(0), params=params,
        model_state={"batch_stats": jax.tree.map(jnp.asarray, variables["batch_stats"])},
        opt_state=tx.init(params), ewc=jax.tree.map(jnp.asarray, jewc), lwf=jl,
        rng=jax.random.PRNGKey(0))
    state = jax_train._expand_state(jcfg, state, tx, w1, 1)

    # the port: the same state at width 3, then its own surgery
    st_l = lwf_lib.make_lwf_state(model)
    load_jax_variables(st_l.teacher, tvars)
    st_l.old_valid.copy_(torch.from_numpy(old_valid))
    st_l.weight = 1.0
    st_e = ewc_state_from_jax(model, jewc, mode="online")
    pstate = port_train.expand_state(cfg, ckpt.TrainState(
        model, port_train.build_optimizer(cfg, model), st_e, st_l), w1, 1)
    want_e = ewc_state_from_jax(model, state.ewc, mode="online")
    assert torch.equal(st_e.anchor, want_e.anchor) and torch.equal(st_e.fisher, want_e.fisher)
    teacher = dict(jax.tree_util.tree_leaves_with_path(export_jax_variables(st_l.teacher)))
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            {"params": state.lwf.old_params, **state.lwf.old_model_state}):
        np.testing.assert_array_equal(teacher[path], np.asarray(leaf), err_msg=str(path))
    # the params after growth: the same except the drawn rows, which are
    # carried across from cl_tpu
    grown = export_jax_variables(model)
    hk, jhk = grown["params"]["head"]["kernel"], np.asarray(state.params["head"]["kernel"])
    np.testing.assert_array_equal(hk[..., :3], jhk[..., :3])
    assert not np.array_equal(hk[..., 3:], jhk[..., 3:])
    after = {"params": jax.tree.map(np.asarray, state.params),
             "batch_stats": jax.tree.map(np.asarray, state.model_state["batch_stats"])}
    load_jax_variables(model, after)

    buf = ReplayBuffer(8, seed=cfg.data.shuffle_seed + 999)
    buf.add_examples(pipeline.make_datasets(cfg, 0)[0], 4, task_id=0)
    fresh = next(iter(pipeline.train_batches(cfg, 1, 0)))
    hb = pipeline.replay_mix(fresh, buf.sample_or_current(1, fresh, flip_prob=0.5))
    step = port_train.make_train_step(cfg, model, pstate.optimizer, CPU, lwf=st_l, ewc=st_e)
    aux = step(pipeline.put_batch(hb, CPU), torch.from_numpy(valid))
    jmodel = jax_train.build_model(jcfg, head_width=w1)
    state, jaux = jax_train.make_train_step(jcfg, jmodel, tx, mesh=None)(
        state, jax_pipeline.HostBatch(*(jnp.asarray(a) for a in hb)), jnp.asarray(valid))
    return {"loss": (aux["loss"].item(), float(jaux["loss"])),
            "ewc_penalty": (aux["ewc_penalty"].item(), float(jaux["ewc_penalty"])),
            "kd": (aux["kd"].item(), float(jaux["kd"])),
            "n_pix": (float(aux["n_pix"]), float(jaux["n_pix"])),
            "before": dict(jax.tree_util.tree_leaves_with_path(after)),
            "got": dict(jax.tree_util.tree_leaves_with_path(export_jax_variables(model))),
            "want": jax.tree_util.tree_leaves_with_path(
                {"params": state.params, **state.model_state})}


@pytest.mark.parametrize("extra", [
    [],                                   # the fused head (+ KD) on NHWC features
    ["train.fused_head_ce=false"],        # the losses on logits padded with −1e9
    ["model.base_channels=32", "model.depth=2", "data.image_size=64",
     "data.source_size=80", "model.packed_min_size=0"],  # the packed KD head
], ids=["fused_head", "logits", "packed_head"])
def test_task1_step_after_growth_matches_cl_tpu(extra):
    res = _grow_step(extra)
    for key in ("ewc_penalty", "kd"):
        got, want = res[key]
        assert want > 0, key
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6, err_msg=key)
    check_step(res)


# ---------------------------------------------------------------------------
# train(), resume, eval and predict under grow
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def grow_run(tmp_path_factory):
    """The unbroken 2-task grow run with all three methods, its log kept."""
    d = str(tmp_path_factory.mktemp("grow") / "ckpt")
    log = os.path.join(os.path.dirname(d), "run.jsonl")
    report = port_train.train(parse_overrides(_args(d, GROW + [f"train.log_path={log}"])),
                              device=CPU)
    return d, report, log


def test_train_grows_the_head_once(grow_run):
    d, report, log = grow_run
    with open(log) as f:
        events = [json.loads(line) for line in f]
    grown = [(e["task"], e["width"]) for e in events if e["event"] == "head_expanded"]
    assert grown == [(1, 5)]
    assert np.isfinite(report["final_per_task_miou"]).all()
    # task 0 trained and saved at width 3; the last state at 5, with Adam's
    # moments and EWC's vectors at the stored width
    first = _last_state(d, T=1)
    last = _last_state(d)
    assert first["/model/head.weight"].shape == (3, 8, 1, 1)
    assert last["/model/head.weight"].shape == (5, 8, 1, 1)
    assert last["/lwf/teacher/head.weight"].shape == (5, 8, 1, 1)
    assert last["/lwf/old_valid"].shape == (5,)
    cfg = parse_overrides(_args(d, GROW))
    n5 = ewc_lib.n_params(port_train.build_model(cfg, head_width=5))
    assert last["/ewc/anchor"].shape == (n5,) and first["/ewc/anchor"].shape == (n5 - 2 * 9,)
    moments = [v.shape for k, v in last.items() if k.endswith("/exp_avg")]
    assert (5, 8, 1, 1) in moments and (5,) in moments


def test_resume_under_grow_is_bit_equal(grow_run, tmp_path, monkeypatch):
    """``tests/unit/test_head_expand.py``'s resume, here bit for bit: the
    resumed run builds at the latest task's width before the restore."""
    monkeypatch.chdir(tmp_path)
    d = str(tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="fault injection"):
        port_train.train(parse_overrides(_args(d, GROW + ["train.fail_after_task=0"])),
                         device=CPU)
    resumed = port_train.train(parse_overrides(_args(d, GROW + ["train.resume=true"])),
                               device=CPU)
    _assert_same_run(d, resumed, grow_run[0], grow_run[1])


def test_eval_and_predict_read_the_stored_width(grow_run, tmp_path):
    d, report, _ = grow_run
    cfg = parse_overrides(_args(d, GROW))
    model, last = port_predict.restore_for_inference(cfg, CPU)
    assert last == 1 and model.head.weight.shape[0] == 5
    out = cli.run_eval(cfg, device=CPU)
    np.testing.assert_array_equal(out["per_task_miou"], np.asarray(report["miou_matrix"])[1])
    pred = cli.run_predict(cfg, device=CPU)
    masks = np.load(pred["out"])
    assert masks.shape == (cfg.data.val_images_per_task, 32, 32) and masks.max() < 5
    # a checkpoint of task 0 alone restores at task 0's width
    d0 = str(tmp_path / "ckpt0")
    with pytest.raises(RuntimeError, match="fault injection"):
        port_train.train(parse_overrides(_args(d0, GROW + ["train.fail_after_task=0"])),
                         device=CPU)
    cfg0 = parse_overrides(_args(d0, GROW))
    model0, last0 = port_predict.restore_for_inference(cfg0, CPU)
    assert last0 == 0 and model0.head.weight.shape[0] == 3
    assert cli.run_eval(cfg0, device=CPU)["task"] == 0
    assert np.load(cli.run_predict(cfg0, device=CPU)["out"]).max() < 3


def test_init_variables_under_grow_raises(narrow):
    cfg, _, variables = narrow
    with pytest.raises(ValueError, match="padded_head"):
        port_train.train(cfg, init_variables=variables, device=CPU)
