"""Per-level rematerialization (``train.remat``) in the port, on the CPU.

``cl_tpu`` holds ``nn.remat`` to be a schedule, not arithmetic
(``tests/unit/test_remat.py``); the port's ``torch.utils.checkpoint`` runs
each level's forward again in the backward, so it must give the same bits
and must not move the BatchNorm running statistics twice. Each case runs
two Adam steps with ``train.remat`` off and on from the same seeded init
and batch: the losses, every param and BatchNorm buffer and Adam's moments
bit-equal, with every rematerialized level recomputed once a step. Cases:
the standard body, the packed body (64², base 32), the packed body with
int8 saved activations (128², where level 0 stores int8), the methods step
(EWC + LwF + replay on the packed body), and one Fisher pass (eval mode,
``torch.autograd.grad``). Once, a remat step is held against ``cl_tpu``'s
``UNet(remat=True)`` step at the packed-parity tolerance.
"""

import numpy as np
import pytest
import torch

from cl_tpu_torch import train as port_train
from cl_tpu_torch.config import parse_overrides
from cl_tpu_torch.data import pipeline
from cl_tpu_torch.data import tasks as task_lib
from cl_tpu_torch.methods import ewc as ewc_lib
from cl_tpu_torch.methods import lwf as lwf_lib
from cl_tpu_torch.methods.replay import ReplayBuffer
from cl_tpu_torch.models import unet
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
PACKED = ["preset=smoke", "data.num_classes=3", "model.base_channels=32", "model.depth=2",
          "data.image_size=64", "data.source_size=80", "model.packed_min_size=0",
          "train.data_parallel=false"]
CASES = {
    "standard": (["preset=smoke", "data.num_classes=3", "model.depth=3",
                  "train.data_parallel=false"], 0),
    "packed": (PACKED, 2),
    "packed_int8": ([a for a in PACKED if not a.startswith(("data.image_size",
                                                             "data.source_size"))]
                    + ["data.image_size=128", "data.source_size=160", "data.batch_size=2",
                       "model.conv_act_store=int8"], 2),
    "methods": (PACKED + ["train.num_tasks=2", "method.methods=ewc,lwf,replay",
                          "method.replay_batch=2"], 2),
}


class Recomputes:
    """Counts the recomputes of rematerialized levels (entries into
    ``unet._recompute``)."""

    def __init__(self, monkeypatch):
        self.n = 0
        real = unet._recompute

        def counted():
            self.n += 1
            return real()
        monkeypatch.setattr(unet, "_recompute", counted)


def methods_state(cfg, model):
    """EWC (an anchor near the params, a positive Fisher, weight 1), LwF (a
    teacher unlike the student, task 0's classes old) and a host replay
    buffer holding task 0's images, all from fixed seeds."""
    g = torch.Generator().manual_seed(7)
    ewc = ewc_lib.make_ewc_state(model, mode="online")
    with torch.no_grad():
        theta = ewc_lib.flat_params(model)
        ewc.anchor.copy_(theta + 0.01 * torch.randn(theta.shape, generator=g))
        ewc.fisher.copy_(1e-3 * (torch.rand(theta.shape, generator=g) + 0.5))
        ewc.weight.fill_(1.0)
    lwf = lwf_lib.make_lwf_state(model)
    lwf_lib.lwf_after_task(lwf, model, torch.from_numpy(task_lib.valid_class_mask(
        cfg.data.num_classes, task_lib.seen_classes(cfg.classes_per_task, 0))))
    with torch.no_grad():
        for p in lwf.teacher.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g) * (p.abs().mean() + 0.1))
    buf = ReplayBuffer(8, seed=cfg.data.shuffle_seed + 999)
    buf.add_examples(pipeline.make_datasets(cfg, 0)[0], 4, task_id=0)
    return ewc, lwf, buf


def two_steps(args, remat):
    """Two Adam steps of ``args`` with ``train.remat`` set: (losses, every
    state leaf by name)."""
    cfg = parse_overrides(args + [f"train.remat={str(remat).lower()}"])
    model = port_train.init_state(cfg, port_train.build_model(cfg), CPU)
    assert model.remat == remat
    opt = port_train.build_optimizer(cfg, model)
    methods = bool(cfg.method.methods)
    ewc = lwf = None
    task = 0
    batch = next(iter(pipeline.train_batches(cfg, 0, 0)))
    if methods:
        ewc, lwf, buf = methods_state(cfg, model)
        task = 1
        batch = next(iter(pipeline.train_batches(cfg, 1, 0)))
        batch = pipeline.replay_mix(batch, buf.sample_or_current(
            cfg.method.replay_batch, batch, flip_prob=cfg.data.flip_prob))
    step = port_train.make_train_step(cfg, model, opt, CPU, lwf=lwf, ewc=ewc)
    valid = torch.from_numpy(task_lib.valid_class_mask(
        cfg.data.num_classes, task_lib.seen_classes(cfg.classes_per_task, task)))
    dev = pipeline.put_batch(batch, CPU)
    losses = [step(dev, valid)["loss"].item() for _ in range(2)]
    leaves = {f"model/{k}": v.clone() for k, v in model.state_dict().items()}
    names = {id(p): n for n, p in model.named_parameters()}
    for p, st in opt.state.items():
        for k, v in st.items():
            leaves[f"adam/{names[id(p)]}/{k}"] = v.clone()
    return losses, leaves


def assert_leaves_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("case", sorted(CASES))
def test_remat_is_bit_equal(case, monkeypatch):
    args, packed_levels = CASES[case]
    cfg = parse_overrides(args)
    model = port_train.build_model(cfg)
    size = cfg.data.image_size
    assert model.packed_levels(size, size) == packed_levels
    if case == "packed_int8":
        assert model.act_q
    losses0, leaves0 = two_steps(args, False)
    rec = Recomputes(monkeypatch)
    losses1, leaves1 = two_steps(args, True)
    # every level recomputed once a step: the packed levels' two
    # PackedLevels each and the DoubleConvs of the rest, bottleneck included
    depth = cfg.model.depth
    levels = 2 * packed_levels + 2 * (depth - packed_levels) + 1
    assert rec.n == 2 * levels
    assert losses0 == losses1
    assert_leaves_equal(leaves0, leaves1)


def test_running_statistics_move_once():
    """One step from the seeded init: running = 0.9·init + 0.1·batch, so a
    second move would leave every running mean 0.81·init + 0.19·batch; the
    remat run's equal the plain run's, and the packed level's differ from
    their init."""
    _, a = two_steps(PACKED, False)
    _, b = two_steps(PACKED, True)
    for k in a:
        if "running" in k:
            assert torch.equal(a[k], b[k]), k
    assert not torch.equal(b["model/enc0.bn0.running_mean"], torch.zeros(32))


def test_fisher_pass_is_bit_equal(monkeypatch):
    """One Fisher pass over task 0's batches (eval mode, the gradient by
    ``torch.autograd.grad`` through the rematerialized levels): the same
    bits, no param's ``.grad`` touched, the running statistics unmoved."""
    args = PACKED + ["train.num_tasks=2", "method.methods=ewc",
                     "method.ewc_fisher_batches=2"]
    out = []
    rec = Recomputes(monkeypatch)
    for remat in (False, True):
        cfg = parse_overrides(args + [f"train.remat={str(remat).lower()}"])
        model = port_train.init_state(cfg, port_train.build_model(cfg), CPU)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        seen = task_lib.valid_class_mask(cfg.data.num_classes,
                                         task_lib.seen_classes(cfg.classes_per_task, 0))
        fisher = port_train.run_fisher_pass(cfg, port_train.make_fisher_step(cfg, model, CPU),
                                            model, 0, seen, CPU)
        assert all(p.grad is None for p in model.parameters())
        assert_leaves_equal(before, model.state_dict())
        out.append(fisher)
    assert rec.n == 2 * 5  # two batches, five levels each
    assert float(out[0].abs().max()) > 0
    assert torch.equal(out[0], out[1])


@pytest.fixture(scope="module")
def remat_step_vs_cl_tpu():
    """One packed SGD step with ``train.remat=true`` in the port and in
    ``cl_tpu`` (``UNet(remat=True)``), from the same variables and batch,
    each once."""
    import jax
    import jax.numpy as jnp

    from cl_tpu import train as jax_train
    from cl_tpu.config import parse_overrides as jax_parse
    from cl_tpu.data import pipeline as jax_pipeline
    from cl_tpu_torch.interop import export_jax_variables

    args = PACKED + ["train.remat=true", "train.optimizer=sgd", "train.lr=0.05"]
    cfg, jcfg = parse_overrides(args), jax_parse(args)
    model = port_train.init_state(cfg, port_train.build_model(cfg), CPU)
    variables = export_jax_variables(model)
    step = port_train.make_train_step(cfg, model, port_train.build_optimizer(cfg, model), CPU)
    jmodel = jax_train.build_model(jcfg)
    assert jmodel.remat and model.remat
    tx = jax_train.build_optimizer(jcfg)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = jax_train.TrainState(
        step=jnp.int32(0), params=params,
        model_state={"batch_stats": jax.tree.map(jnp.asarray, variables["batch_stats"])},
        opt_state=tx.init(params), ewc=None, lwf=None, rng=jax.random.PRNGKey(0))
    hb = next(iter(pipeline.train_batches(cfg, 0, 0)))
    valid = task_lib.valid_class_mask(3, task_lib.seen_classes(cfg.classes_per_task, 0))
    aux = step(pipeline.put_batch(hb, CPU), torch.from_numpy(valid))
    state, jaux = jax_train.make_train_step(jcfg, jmodel, tx, mesh=None)(
        state, jax_pipeline.HostBatch(*(jnp.asarray(a) for a in hb)), jnp.asarray(valid))
    return {"loss": (aux["loss"].item(), float(jaux["loss"])),
            "n_pix": (float(aux["n_pix"]), float(jaux["n_pix"])),
            "before": dict(jax.tree_util.tree_leaves_with_path(variables)),
            "got": dict(jax.tree_util.tree_leaves_with_path(export_jax_variables(model))),
            "want": jax.tree_util.tree_leaves_with_path(
                {"params": state.params, **state.model_state})}


def test_remat_step_matches_cl_tpu(remat_step_vs_cl_tpu):
    from test_torch_packed_head import check_step

    check_step(remat_step_vs_cl_tpu)
    assert np.isfinite(remat_step_vs_cl_tpu["loss"][0])
