"""L0 — typed frozen configs, the preset ladder, and ``section.key=value``
overrides.

This package's own copy of ``cl_tpu/config.py``: the same dataclasses,
fields, defaults and presets, so that ``config_hash()`` of a config is the
same in both packages (tested for every preset). Fields that select a part
of the JAX package this port does not have yet are kept, so a config reads
the same in both; ``cl_tpu_torch.train.check_supported`` raises on the
values it cannot run.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import typing
from typing import Any


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset + input-pipeline configuration (L1)."""

    dataset: str = "synthetic"  # synthetic | synthetic_native | voc_dir | cityscapes_dir
    data_dir: str = ""  # directory layout root for *_dir datasets
    num_classes: int = 2  # global label-space size incl. background
    image_size: int = 128  # square H=W after resize
    source_size: int = 160  # decoded size before device-side resize
    train_images_per_task: int = 64
    val_images_per_task: int = 16
    batch_size: int = 8  # global batch
    flip_prob: float = 0.5
    mean: tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: tuple[float, float, float] = (0.229, 0.224, 0.225)
    ignore_index: int = 255
    shuffle_seed: int = 1234
    prefetch_depth: int = 2  # batches put on the device ahead of the step
    # Device-resident dataset cache with plan-driven epochs (JAX package
    # only so far).
    device_cache: bool = False
    epoch_scan: bool = True
    val_cache_evict: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """UNet configuration (L2)."""

    base_channels: int = 32  # 32 = UNet-small, 64 = UNet-64ch
    depth: int = 4  # encoder levels
    norm: str = "batch"  # batch | group | none
    # The 1x1 head always has num_classes outputs; classes not yet seen are
    # masked in loss and eval. False = grow the head per task.
    padded_head: bool = True
    conv_impl: str = "xla"  # xla | v3 | auto | pallas | hybrid
    # Packed-domain UNet body; engages only at image_size >= packed_min_size
    # and base_channels <= 32 (0 forces it everywhere).
    packed_unet: bool = True
    packed_min_size: int = 256
    pool_tee: bool = True
    upconv_impl: str = "xla"  # xla | matmul
    conv_act_store: str = "dtype"  # dtype | int8


@dataclasses.dataclass(frozen=True)
class MethodConfig:
    """Continual-learning method configuration (L3)."""

    # Any subset of {"ewc", "lwf", "replay"}; empty = finetune baseline.
    methods: tuple[str, ...] = ()
    ewc_lambda: float = 100.0
    ewc_mode: str = "online"  # online (consolidated) | separate (per-task)
    ewc_gamma: float = 1.0  # online-EWC decay of old Fisher
    ewc_fisher_batches: int = 8  # batches used for the Fisher pass
    ewc_fisher_kind: str = "empirical"  # empirical (label grad) | true (sampled)
    lwf_alpha: float = 1.0
    lwf_temperature: float = 2.0
    replay_capacity: int = 64  # total images in buffer
    replay_batch: int = 4  # replay samples mixed into each step's batch
    replay_device_resident: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-driver configuration (L4)."""

    num_tasks: int = 1
    epochs_per_task: int = 2
    lr: float = 1e-3
    optimizer: str = "adam"  # adam | sgd
    momentum: float = 0.9
    weight_decay: float = 0.0
    compute_dtype: str = "float32"  # float32 | bfloat16 (params stay f32)
    remat: bool = False  # per-level rematerialization
    seed: int = 0
    checkpoint_dir: str = ""  # empty = no checkpointing
    resume: bool = False
    log_path: str = ""  # JSONL event log; empty = stdout only
    tensorboard_dir: str = ""  # optional TB scalar mirror; empty = off
    profile_dir: str = ""  # profiler trace output; empty = off
    fail_after_task: int = -1  # test-only fault injection
    # Also evaluate the CURRENT task's val set after every epoch.
    eval_every_epoch: bool = False
    data_parallel: bool = True  # shard batch over all visible devices
    spatial_parallel: bool = False  # shard image height over devices
    multihost: bool = False
    use_pallas: bool = True  # hand-written kernels; False = plain fallbacks
    pallas_augment: bool = False  # augment kernel (JAX package only so far)
    # Fused 1x1-head + CE kernel: "auto" = on where base_channels <= 32;
    # "true"/"false" force it.
    fused_head_ce: str = "auto"
    packed_head_ce: bool = True


@dataclasses.dataclass(frozen=True)
class Config:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    method: MethodConfig = dataclasses.field(default_factory=MethodConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    # Operational fields that don't change the training trajectory: a
    # resume with another log path or without the fault-injection flag
    # must still match the stored hash. Same set as the JAX package.
    _HASH_EXCLUDE = {
        "train": ("checkpoint_dir", "resume", "log_path", "profile_dir",
                  "tensorboard_dir", "fail_after_task", "multihost",
                  "eval_every_epoch"),
        "data": ("device_cache", "epoch_scan"),
        "method": ("replay_device_resident",),
    }

    def config_hash(self) -> str:
        """Stable hash stored in logs and reports."""
        d = self.to_dict()
        for section, keys in self._HASH_EXCLUDE.items():
            for k in keys:
                d[section].pop(k, None)
        blob = json.dumps(d, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:12]

    def replace(self, **sections) -> "Config":
        return dataclasses.replace(self, **sections)

    @property
    def classes_per_task(self) -> list[list[int]]:
        """Class-incremental split of the label space: class 0 (background)
        belongs to every task; foreground classes 1..C-1 are split into
        contiguous, near-equal chunks, one per task."""
        from cl_tpu_torch.data import tasks

        return tasks.make_task_splits(self.data.num_classes, self.train.num_tasks)


# ---------------------------------------------------------------------------
# Preset ladder — the same presets as cl_tpu/config.py
# ---------------------------------------------------------------------------


def _preset_baseline_1() -> Config:
    """UNet-small (32ch) binary seg, single task, 128² synthetic."""
    return Config(
        data=DataConfig(dataset="synthetic", num_classes=2, image_size=128,
                        source_size=160, batch_size=8),
        model=ModelConfig(base_channels=32),
        method=MethodConfig(methods=()),
        train=TrainConfig(num_tasks=1, epochs_per_task=2),
    )


def _preset_baseline_2() -> Config:
    """UNet-64ch single-task 21-class VOC-style, 256²."""
    return Config(
        data=DataConfig(dataset="synthetic_native", num_classes=21, image_size=256,
                        source_size=320, batch_size=8,
                        train_images_per_task=128, val_images_per_task=32,
                        device_cache=True),
        model=ModelConfig(base_channels=64),
        method=MethodConfig(methods=()),
        train=TrainConfig(num_tasks=1, epochs_per_task=2),
    )


def _preset_baseline_3() -> Config:
    """2-task class-incremental, 512², EWC Fisher regularization."""
    return Config(
        data=DataConfig(dataset="synthetic_native", num_classes=21, image_size=512,
                        source_size=576, batch_size=8,
                        train_images_per_task=128, val_images_per_task=32,
                        device_cache=True),
        model=ModelConfig(base_channels=32),
        method=MethodConfig(methods=("ewc",), ewc_lambda=3e4),
        train=TrainConfig(num_tasks=2, epochs_per_task=2),
    )


def _preset_baseline_4() -> Config:
    """5-task incremental 19-class Cityscapes-style, LwF + replay, 512²."""
    return Config(
        data=DataConfig(dataset="synthetic_native", num_classes=19, image_size=512,
                        source_size=576, batch_size=8,
                        train_images_per_task=128, val_images_per_task=32,
                        device_cache=True),
        model=ModelConfig(base_channels=32),
        method=MethodConfig(methods=("lwf", "replay"),
                            replay_device_resident=True),
        train=TrainConfig(num_tasks=5, epochs_per_task=2),
    )


def _preset_baseline_5() -> Config:
    """Full continual (EWC+LwF+replay), data-parallel, bf16, 512²."""
    return Config(
        data=DataConfig(dataset="synthetic_native", num_classes=19, image_size=512,
                        source_size=576, batch_size=64,
                        train_images_per_task=256, val_images_per_task=64,
                        device_cache=True),
        model=ModelConfig(base_channels=32),
        method=MethodConfig(methods=("ewc", "lwf", "replay"),
                            ewc_lambda=3e4,
                            replay_batch=8, replay_device_resident=True),
        train=TrainConfig(num_tasks=5, epochs_per_task=2,
                          compute_dtype="bfloat16", data_parallel=True,
                          remat=True),
    )


PRESETS = {
    "baseline_1": _preset_baseline_1,
    "baseline_2": _preset_baseline_2,
    "baseline_3": _preset_baseline_3,
    "baseline_4": _preset_baseline_4,
    "baseline_5": _preset_baseline_5,
    # tiny smoke preset for tests
    "smoke": lambda: Config(
        data=DataConfig(num_classes=2, image_size=32, source_size=40,
                        batch_size=4, train_images_per_task=8,
                        val_images_per_task=4),
        model=ModelConfig(base_channels=8),
        train=TrainConfig(num_tasks=1, epochs_per_task=1),
    ),
}


def get_preset(name: str) -> Config:
    try:
        return PRESETS[name]()
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}") from None


# ---------------------------------------------------------------------------
# `python -m cl_tpu_torch.cli preset=baseline_1 train.lr=3e-4`
# ---------------------------------------------------------------------------

_SECTIONS = {"data": DataConfig, "model": ModelConfig,
             "method": MethodConfig, "train": TrainConfig}


def _coerce(value: str, target_type: Any):
    origin = typing.get_origin(target_type)
    if origin is tuple:
        inner = typing.get_args(target_type)[0]
        if value == "":
            return ()
        return tuple(_coerce(v, inner) for v in value.split(","))
    if target_type is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if target_type is int:
        return int(value)
    if target_type is float:
        return float(value)
    return value


def parse_overrides(argv: list[str], base: Config | None = None) -> Config:
    """Parse ``section.key=value`` overrides, plus ``preset=NAME``."""
    cfg = base or Config()
    # preset first, wherever it appears
    for arg in argv:
        if arg.startswith("preset="):
            cfg = get_preset(arg.split("=", 1)[1])
    updates: dict[str, dict[str, Any]] = {}
    for arg in argv:
        if arg.startswith("preset="):
            continue
        if "=" not in arg or "." not in arg.split("=", 1)[0]:
            raise ValueError(f"expected section.key=value, got {arg!r}")
        key, value = arg.split("=", 1)
        section, field_name = key.split(".", 1)
        if section not in _SECTIONS:
            raise ValueError(f"unknown config section {section!r}")
        hints = typing.get_type_hints(_SECTIONS[section])
        if field_name not in hints:
            raise ValueError(f"unknown field {key!r}")
        updates.setdefault(section, {})[field_name] = _coerce(
            value, hints[field_name])
    replacements: dict[str, Any] = {}
    for section, kv in updates.items():
        replacements[section] = dataclasses.replace(getattr(cfg, section), **kv)
    return cfg.replace(**replacements) if replacements else cfg
