"""L0 — command-line entry point of the port (the public train / eval API).

Usage:
    python -m cl_tpu_torch.cli preset=baseline_1 [section.key=value ...] \\
        [train.checkpoint_dir=/tmp/ckpt]
    python -m cl_tpu_torch.cli eval preset=baseline_1 train.checkpoint_dir=/tmp/ckpt
    python -m cl_tpu_torch.cli predict preset=baseline_1 train.checkpoint_dir=/tmp/ckpt
    python -m cl_tpu_torch.cli plot preset=baseline_1 train.log_path=/tmp/run.jsonl

Runs on the CUDA device and prints one JSON line (the JSONL events of a
training run go to stdout as they happen). Same presets, overrides and
modes as ``python -m cl_tpu.cli``:

* ``train`` (the default): ``train()``; with ``train.checkpoint_dir`` a
  checkpoint after every task, and ``train.resume=true`` goes on after the
  latest one;
* ``eval``: restores the latest checkpoint's model and reports the mIoU of
  every task seen so far, without training;
* ``predict``: restores it and writes the predicted masks of the last
  task's val split to ``<checkpoint_dir>/predictions/task{t}_val_masks.npy``;
* ``plot``: renders the curves of a run's JSONL log (matplotlib) into
  ``<checkpoint_dir or the log's directory>/plots/``.

Each mode's function takes ``device`` (None = the card); the command line
never sets it.

Data parallelism (``train.data_parallel``, as in ``preset=baseline_5``):
``train`` spreads over every visible card by itself (one spawned worker
per card, rank 0's report printed), or one process per card under
``torchrun --nproc_per_node=N -m cl_tpu_torch.cli ...``, each process
joining the group the environment names; ``eval`` shards the val batches
over that group. ``predict`` and ``plot`` run in one process.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from cl_tpu_torch.config import PRESETS, parse_overrides


def run_eval(cfg, device=None) -> dict:
    """mIoU of every task up to the latest checkpoint's, predicting among
    the classes seen up to it."""
    from cl_tpu_torch import predict as predict_lib
    from cl_tpu_torch import train as train_lib

    if not cfg.train.checkpoint_dir:
        raise SystemExit("eval needs train.checkpoint_dir=<dir>")
    try:
        model, last = predict_lib.restore_for_inference(cfg, device)
    except FileNotFoundError as e:
        raise SystemExit(str(e)) from None
    per_task = [train_lib.evaluate(cfg, model, k, seen_task=last, device=device)["miou"]
                for k in range(last + 1)]
    return {"task": last, "per_task_miou": per_task, "mean_miou": float(np.mean(per_task))}


def run_predict(cfg, device=None) -> dict:
    """Predicted masks of the last checkpointed task's val split, written
    to ``<checkpoint_dir>/predictions/``."""
    from cl_tpu_torch import predict as predict_lib
    from cl_tpu_torch.data import pipeline

    if not cfg.train.checkpoint_dir:
        raise SystemExit("predict needs train.checkpoint_dir=<dir>")
    model, last = predict_lib.restore_for_inference(cfg, device)
    _, val_ds = pipeline.make_datasets(cfg, last)
    masks = predict_lib.predict_dataset(cfg, model, val_ds, seen_task=last, device=device)
    out_dir = os.path.join(cfg.train.checkpoint_dir, "predictions")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"task{last}_val_masks.npy")
    np.save(path, masks)
    return {"task": last, "n_images": int(masks.shape[0]),
            "classes_present": sorted(int(c) for c in np.unique(masks)), "out": path}


def run_plot(cfg, device=None) -> dict:
    """The curves of ``train.log_path`` into ``<checkpoint_dir>/plots/``,
    or beside the log. Host only: ``device`` is accepted and unused."""
    from cl_tpu_torch import plots

    if not cfg.train.log_path:
        raise SystemExit("plot needs train.log_path=<run.jsonl>")
    base = cfg.train.checkpoint_dir or os.path.dirname(os.path.abspath(cfg.train.log_path))
    return {"written": plots.plot_run(cfg.train.log_path, os.path.join(base, "plots"))}


def run_train(cfg, device=None) -> dict:
    from cl_tpu_torch.train import train

    report = train(cfg, device=device)
    return {k: v for k, v in report.items() if k != "miou_matrix"}


MODES = {"train": run_train, "eval": run_eval, "predict": run_predict, "plot": run_plot}


def main(argv: list[str] | None = None, device=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in ("-h", "--help"):
        print(__doc__)
        print("presets:", ", ".join(sorted(PRESETS)))
        return 0
    mode = "train"
    if argv and argv[0] in MODES:
        mode, argv = argv[0], argv[1:]
    cfg = parse_overrides(argv)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        if mode in ("predict", "plot"):
            raise SystemExit(f"{mode} runs in one process: launch it without torchrun")
        from cl_tpu_torch import sharding
        from cl_tpu_torch.devices import resolve_device

        # join the group first: the card of this process is LOCAL_RANK's
        dp = sharding.join(cfg, resolve_device(device))
        try:
            out = MODES[mode](cfg, device)
        finally:
            sharding.leave()
        if dp is None or dp.rank == 0:
            print(json.dumps(out, default=float))
        return 0
    print(json.dumps(MODES[mode](cfg, device), default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
