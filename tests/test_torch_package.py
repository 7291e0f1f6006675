"""Package rules of the port: it imports nothing of JAX or of ``cl_tpu``,
its entry points run on the card unless told ``device="cpu"``, configs it
cannot run raise ``NotImplementedError``, and its config hashes equal the
JAX package's."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import cl_tpu.config as jax_config
from cl_tpu_torch import config
from cl_tpu_torch import train as port_train
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import pkgutil, importlib, sys
import cl_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(cl_tpu_torch.__path__, "cl_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "cl_tpu", "reference_impl"))
print(len(mods), bad)
"""


def test_port_imports_no_jax_and_no_cl_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 15 and bad == "[]", out.stdout


@pytest.mark.parametrize("name", sorted(config.PRESETS))
def test_config_hash_equals_jax_package(name):
    assert config.get_preset(name).config_hash() == \
        jax_config.get_preset(name).config_hash()
    args = [f"preset={name}", "train.lr=0.01", "method.methods=ewc,lwf",
            "data.flip_prob=0.25"]
    assert config.parse_overrides(args).config_hash() == \
        jax_config.parse_overrides(args).config_hash()


def test_entry_points_need_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config.parse_overrides(["preset=smoke", "data.train_images_per_task=4"])
    for call in (lambda: port_train.train(cfg),
                 lambda: port_train.make_eval_step(cfg, None),
                 lambda: port_train.resolve_device("cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    report = port_train.train(cfg, device="cpu")
    assert report["device"] == "cpu"
    assert len(report["final_per_task_miou"]) == 1


@pytest.mark.parametrize("override", [
    "model.norm=group",
    "model.padded_head=false data.num_classes=5 train.num_tasks=2 "
    "method.methods=ewc,lwf,replay",
    "train.profile_dir=trace train.epochs_per_task=2",
])
def test_configs_the_variants_slice_made_runnable(override, tmp_path, monkeypatch):
    """Refused until the variants' slice: GroupNorm, grow-the-head with the
    three methods, and the profiler's trace (one epoch traced, its file
    written, the ``profile`` event logged, the epoch left out of the
    rate) train on the CPU."""
    import json

    monkeypatch.chdir(tmp_path)
    cfg = config.parse_overrides(["preset=smoke", *override.split(),
                                  f"train.log_path={tmp_path / 'run.jsonl'}"])
    port_train.check_supported(cfg, torch.device("cpu"))
    report = port_train.train(cfg, device="cpu")
    assert np.isfinite(report["final_per_task_miou"]).all()
    events = [json.loads(line) for line in open(tmp_path / "run.jsonl")]
    if cfg.train.profile_dir:
        assert [e["dir"] for e in events if e["event"] == "profile"] == ["trace"]
        with open(tmp_path / "trace" / "trace_task0_epoch1.json") as f:
            assert json.load(f)["traceEvents"]
        # epoch 0 carries the first use and epoch 1 the tracer: no steady epoch
        assert "images_per_sec_per_chip" not in report
    if not cfg.model.padded_head:
        assert [(e["task"], e["width"]) for e in events
                if e["event"] == "head_expanded"] == [(1, 5)]


@pytest.mark.parametrize("override", ["train.remat=true", "train.multihost=true"])
def test_configs_the_dp_slice_made_runnable(override):
    """Refused until the data-parallel slice: ``train.remat`` trains on the
    CPU; ``train.multihost`` joins the process group the environment names,
    and with none named it raises instead of training one replica."""
    cfg = config.parse_overrides(["preset=smoke", *override.split()])
    port_train.check_supported(cfg, torch.device("cpu"))
    if override == "train.multihost=true":
        with pytest.raises(RuntimeError, match="no process group is named"):
            port_train.train(cfg, device="cpu")
        return
    report = port_train.train(cfg, device="cpu")
    assert np.isfinite(report["final_per_task_miou"]).all()


@pytest.mark.parametrize("override", [
    pytest.param("method.methods=ewc method.ewc_fisher_kind=true", id="method.methods=ewc"),
    "train.checkpoint_dir=ckpt",
    "train.resume=true",
])
def test_configs_the_checkpoint_slice_made_runnable(override, tmp_path, monkeypatch):
    """The three configs refused until the checkpoint slice train on the
    CPU: the sampled Fisher; a checkpoint after the task (here under the
    test's directory); ``train.resume`` without a checkpoint directory
    trains from the start, as in ``cl_tpu``."""
    monkeypatch.chdir(tmp_path)
    cfg = config.parse_overrides(["preset=smoke", "train.num_tasks=2", "data.num_classes=3",
                                  *override.split()])
    port_train.check_supported(cfg, torch.device("cpu"))
    report = port_train.train(cfg, device="cpu")
    assert np.isfinite(report["final_per_task_miou"]).all()
    assert os.path.exists(tmp_path / "ckpt" / "task_1" / "meta.json") == \
        ("checkpoint_dir" in override)


@pytest.mark.parametrize("override", [
    "model.packed_min_size=0",          # the packed head asked for, the body declines
    "method.methods=lwf,replay",        # LwF on the NHWC fused head (#9/#10)
    "method.methods=lwf train.fused_head_ce=false",  # KD on logits (#13/#14)
])
def test_configs_the_lwf_slice_made_runnable(override):
    """The three configs that raised before LwF's routes off the packed head
    were ported train on the CPU (the plain versions of #1/#2, #9/#10 and
    #13/#14)."""
    cfg = config.parse_overrides(["preset=smoke", *override.split()])
    report = port_train.train(cfg, device="cpu")
    assert np.isfinite(report["final_per_task_miou"]).all()


@pytest.mark.parametrize("impl", ["v3", "auto"])
def test_conv_impl_v3_and_auto_train(impl):
    """``model.conv_impl=v3`` and ``=auto``, refused until the gen-3 conv's
    slice, train on the CPU (the plain versions of #30/#31): at 64², base
    32, depth 2, v3 takes both routes (enc0's second conv, enc1 and the
    bottleneck per conv, the decoder levels packed); auto routes nothing
    below 256²."""
    cfg = config.parse_overrides(["preset=smoke", "model.base_channels=32", "model.depth=2",
                                  "data.image_size=64", "data.source_size=80",
                                  f"model.conv_impl={impl}"])
    port_train.check_supported(cfg, torch.device("cpu"))
    report = port_train.train(cfg, device="cpu")
    assert np.isfinite(report["final_per_task_miou"]).all()


@pytest.mark.parametrize("override", ["model.upconv_impl=matmul", "model.conv_impl=hybrid",
                                      "model.conv_impl=pallas"])
def test_gen2_routes_train(override):
    """The three configs refused until the gen-2 conv's slice train on the
    CPU at the smoke size (the plain versions of #40/#41; the matmul
    up-conv): at 32², base 8, 13 of the 18 convs pass the gen-2 gate (the
    encoder's first convs do not: the stem's 3 channels, and below it fewer
    than two column groups of p)."""
    cfg = config.parse_overrides(["preset=smoke", override])
    port_train.check_supported(cfg, torch.device("cpu"))
    report = port_train.train(cfg, device="cpu")
    assert np.isfinite(report["final_per_task_miou"]).all()


def test_conv_impl_v3_refused_where_cl_tpu_fails():
    """``preset=baseline_2 model.conv_impl=v3`` in f32: ``cl_tpu`` admits
    enc3's convs at the gate's itemsize of 2 and finds no f32 tile, so the
    port refuses the config before training; in bf16 it runs."""
    cpu = torch.device("cpu")
    with pytest.raises(NotImplementedError, match="enc3.conv1"):
        port_train.check_supported(
            config.parse_overrides(["preset=baseline_2", "model.conv_impl=v3"]), cpu)
    port_train.check_supported(config.parse_overrides(
        ["preset=baseline_2", "model.conv_impl=v3", "train.compute_dtype=bfloat16"]), cpu)


@pytest.mark.parametrize("override", ["train.pallas_augment=true", "data.device_cache=true",
                                      "data.dataset=synthetic_native"])
def test_data_path_configs_run(override):
    """The three configs the data path's slice made runnable train on the
    CPU (the augment kernels' plain versions, the device-resident dataset
    and its plan, the native rasterizer)."""
    cfg = config.parse_overrides(["preset=smoke", "model.depth=2", override])
    port_train.check_supported(cfg, torch.device("cpu"))
    report = port_train.train(cfg, device="cpu")
    assert np.isfinite(report["final_per_task_miou"]).all()


def test_baselines_2_to_4_as_shipped_are_supported():
    """Baselines 2, 3 and 4 pass ``check_supported`` as they ship, and since
    the data-parallel slice baseline_5 too (``train.remat``,
    ``train.data_parallel``)."""
    cpu = torch.device("cpu")
    for name in ("baseline_2", "baseline_3", "baseline_4", "baseline_5"):
        port_train.check_supported(config.get_preset(name), cpu)


_PACKED = ["preset=smoke", "model.base_channels=32", "model.depth=2",
           "data.image_size=64", "data.source_size=80", "model.packed_min_size=0"]


def _packed_model(cfg):
    model = port_train.init_state(cfg, port_train.build_model(cfg),
                                  torch.device("cpu"))
    assert model.packed and model.packed_levels(64, 64) == 2
    return model


def test_eval_step_accepts_the_packed_body():
    from cl_tpu_torch.data import pipeline, tasks

    cfg = config.parse_overrides(_PACKED)
    model = _packed_model(cfg)
    step = port_train.make_eval_step(cfg, model, device="cpu")
    valid = torch.from_numpy(tasks.valid_class_mask(
        cfg.data.num_classes, tasks.seen_classes(cfg.classes_per_task, 0)))
    conf = torch.zeros(2, 2)
    for hb in pipeline.val_batches(cfg, 0):
        conf = step(conf, pipeline.put_batch(hb, torch.device("cpu")), valid)
    assert conf.sum().item() == cfg.data.val_images_per_task * 64 * 64
    # the headline config (the packed head+CE, kernels #7/#8) builds its
    # train step, as do the two loss branches that skip the packed head
    assert port_train.packed_head_on(cfg)
    port_train.make_train_step(cfg, model, port_train.build_optimizer(cfg, model),
                               device="cpu")
    for head in ("train.packed_head_ce=false", "train.fused_head_ce=false"):
        cfg = config.parse_overrides(_PACKED + [head])
        port_train.make_train_step(cfg, model, port_train.build_optimizer(cfg, model),
                                   device="cpu")


@pytest.mark.parametrize("head", ["train.packed_head_ce=false", "train.fused_head_ce=false"])
def test_train_runs_the_packed_body(head):
    cfg = config.parse_overrides(_PACKED + [head])
    report = port_train.train(cfg, device="cpu")
    assert report["device"] == "cpu"
    assert np.isfinite(report["final_per_task_miou"]).all()


def test_backward_through_the_packed_body_raises():
    """The packed body's backward kernels exist now: ``.backward()`` through
    it runs and gives every param a finite gradient."""
    cfg = config.parse_overrides(_PACKED)
    model = _packed_model(cfg).train()
    logits = model(torch.randn(2, 64, 64, 3))
    logits.square().mean().backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.shape == p.shape, name
        assert bool(torch.isfinite(p.grad).all()), name
    assert any(p.grad.abs().sum() > 0 for p in model.parameters())


def test_packed_model_exports_the_standard_tree():
    import jax

    from cl_tpu_torch.interop import export_jax_variables

    cfg = config.parse_overrides(_PACKED)
    packed = export_jax_variables(_packed_model(cfg))
    standard = export_jax_variables(port_train.init_state(
        cfg, port_train.build_model(config.parse_overrides(
            _PACKED + ["model.packed_unet=false"])), torch.device("cpu")))
    assert jax.tree_util.tree_structure(packed) == \
        jax.tree_util.tree_structure(standard)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(packed),
                                jax.tree_util.tree_leaves_with_path(standard)):
        assert pa == pb and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_baseline_1_as_shipped_is_supported():
    cfg = config.get_preset("baseline_1")
    port_train.check_supported(cfg, torch.device("cpu"))
    assert port_train.fused_head_on(cfg)
    assert not port_train.fused_head_on(config.get_preset("baseline_2"))


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """A 2-task smoke run through ``cli.main`` on the CPU, with its
    checkpoints and its JSONL log."""
    from cl_tpu_torch import cli

    root = tmp_path_factory.mktemp("cli")
    args = ["preset=smoke", "train.num_tasks=2", "data.num_classes=3",
            f"train.checkpoint_dir={root / 'ckpt'}", f"train.log_path={root / 'run.jsonl'}"]
    assert cli.main(args, device="cpu") == 0
    return root, args


@pytest.mark.parametrize("mode", ["eval", "predict", "plot"])
def test_cli_modes_beyond_train_run(cli_run, mode, capsys):
    """Each mode runs from the train run's checkpoint or log on the CPU and
    prints one JSON line, as ``cl_tpu.cli``'s does."""
    from cl_tpu_torch import cli

    root, args = cli_run
    capsys.readouterr()
    assert cli.main([mode, *args], device="cpu") == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    if mode == "eval":
        assert out["task"] == 1 and len(out["per_task_miou"]) == 2
        assert np.isfinite(out["per_task_miou"]).all()
    elif mode == "predict":
        masks = np.load(out["out"])
        assert out["out"] == str(root / "ckpt" / "predictions" / "task1_val_masks.npy")
        assert masks.shape == (4, 32, 32) and masks.dtype == np.uint8 and masks.max() <= 2
    else:
        assert [os.path.basename(p) for p in out["written"]] == [
            "loss_curves.png", "miou_heatmap.png", "forgetting_curves.png"]


def test_conv_act_store_int8_trains(monkeypatch):
    """``model.conv_act_store=int8`` trains on the CPU (the plain versions of
    32q, #38 and #39) and finishes its task, with level 0's packed convs
    (128 wide, P = 4: wg 32) on the int8 route and level 1's not."""
    from cl_tpu_torch.kernels import conv3x3

    widths = []
    fused_q = conv3x3.conv_bn_fused_q
    monkeypatch.setattr(conv3x3, "conv_bn_fused_q",
                        lambda x, *rest: widths.append((x.shape[2], torch.is_grad_enabled()))
                        or fused_q(x, *rest))
    cfg = config.parse_overrides(["preset=smoke", "model.packed_min_size=0",
                                  "model.conv_act_store=int8", "model.base_channels=32",
                                  "model.depth=2", "data.image_size=128",
                                  "data.source_size=160"])
    report = port_train.train(cfg, device="cpu")
    assert np.isfinite(report["final_per_task_miou"]).all()
    steps = cfg.data.train_images_per_task // cfg.data.batch_size
    # five int8 convs a train step; the evals (no grad) skip the quantize
    assert [w for w, grad in widths if grad] == [128] * 5 * steps
    assert {w for w, _ in widths} == {128}
