"""Package rules of the port: it imports nothing of JAX or of ``cl_tpu``,
its entry points run on the card unless told ``device="cpu"``, configs it
cannot run raise ``NotImplementedError``, and its config hashes equal the
JAX package's."""

import os
import subprocess
import sys

import pytest
import torch

import cl_tpu.config as jax_config
from cl_tpu_torch import config
from cl_tpu_torch import train as port_train

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
    "model.packed_min_size=0",          # the packed body engages
    "model.conv_impl=v3",
    "model.upconv_impl=matmul",
    "model.norm=group",
    "model.padded_head=false",
    "train.pallas_augment=true",
    "method.methods=ewc",
    "method.methods=lwf,replay",
    "data.device_cache=true",
    "data.dataset=synthetic_native",
    "train.checkpoint_dir=ckpt",
    "train.resume=true",
    "train.spatial_parallel=true",
    "train.remat=true",
    "train.profile_dir=trace",
])
def test_unported_configs_raise(override):
    cfg = config.parse_overrides(["preset=smoke", override])
    with pytest.raises(NotImplementedError, match="later slice"):
        port_train.train(cfg, device="cpu")


def test_baseline_1_as_shipped_is_supported():
    cfg = config.get_preset("baseline_1")
    port_train.check_supported(cfg, torch.device("cpu"))
    assert port_train.fused_head_on(cfg)
    assert not port_train.fused_head_on(config.get_preset("baseline_2"))


def test_cli_modes_beyond_train_raise():
    from cl_tpu_torch import cli

    for mode in ("eval", "predict", "plot"):
        with pytest.raises(NotImplementedError, match="later slice"):
            cli.main([mode, "preset=smoke"])
