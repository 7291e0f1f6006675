"""L5 — matplotlib training curves from the JSONL event log.

The port's own copy of ``cl_tpu/plots.py`` (the port imports nothing of
``cl_tpu``). The structured JSONL log (``logging_utils.py``, the same
events as ``cl_tpu``'s) is the source of truth; this module renders it
after (or during) a run:

  * loss_curves.png        — per-task training-loss curve over epochs
  * miou_heatmap.png       — the lower-triangular mIoU matrix
                             M[eval-after-task, task] (forgetting report)
  * forgetting_curves.png  — each task's mIoU trajectory as later tasks
                             are learned (the per-task decay the reference
                             prints as numbers)

Pure host-side post-processing: no torch, no card; matplotlib is imported
inside ``plot_run``, so the module imports without it.
"""

from __future__ import annotations

import json
import os

import numpy as np


def load_events(log_path: str) -> list[dict]:
    events = []
    with open(log_path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # tolerate a truncated final line from a crash
    return events


def miou_matrix_from_events(events: list[dict]) -> np.ndarray:
    """Rebuild the [T, T] mIoU matrix from ``eval`` events (NaN below =
    not-yet-seen tasks), matching train.py's ``miou_matrix``."""
    evals = [e for e in events if e.get("event") == "eval"]
    if not evals:
        return np.zeros((0, 0))
    T = max(int(e["after_task"]) for e in evals) + 1
    m = np.full((T, T), np.nan)
    for e in evals:
        m[int(e["after_task"]), int(e["task"])] = float(e["miou"])
    return m


def _save(fig, out_dir: str, name: str) -> str:
    path = os.path.join(out_dir, name)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    return path


def plot_run(log_path: str, out_dir: str) -> list[str]:
    """Render all curves for one run's JSONL log; returns written paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    events = load_events(log_path)
    written = []

    # ---- loss curves: one line per task, x = epoch -------------------
    epochs = [e for e in events if e.get("event") == "epoch"]
    if epochs:
        fig, ax = plt.subplots(figsize=(6, 4))
        tasks = sorted({int(e["task"]) for e in epochs})
        for t in tasks:
            es = [e for e in epochs if int(e["task"]) == t]
            ax.plot([int(e["epoch"]) for e in es],
                    [float(e["loss"]) for e in es],
                    marker="o", label=f"task {t}")
        ax.set_xlabel("epoch")
        ax.set_ylabel("train loss")
        ax.set_title("training loss per task")
        ax.legend()
        ax.grid(True, alpha=0.3)
        written.append(_save(fig, out_dir, "loss_curves.png"))
        plt.close(fig)

    m = miou_matrix_from_events(events)
    if m.size:
        T = m.shape[0]

        # ---- mIoU-matrix heatmap ------------------------------------
        fig, ax = plt.subplots(figsize=(4 + 0.4 * T, 3.5 + 0.4 * T))
        im = ax.imshow(m, vmin=0.0, vmax=1.0, cmap="viridis")
        for i in range(T):
            for j in range(i + 1):
                if np.isfinite(m[i, j]):
                    ax.text(j, i, f"{m[i, j]:.3f}", ha="center",
                            va="center",
                            color="w" if m[i, j] < 0.6 else "k",
                            fontsize=9)
        ax.set_xlabel("evaluated task")
        ax.set_ylabel("after training task")
        ax.set_xticks(range(T))
        ax.set_yticks(range(T))
        ax.set_title("per-task mIoU matrix")
        fig.colorbar(im, ax=ax, shrink=0.8)
        written.append(_save(fig, out_dir, "miou_heatmap.png"))
        plt.close(fig)

        # ---- forgetting curves: task k's mIoU as training advances ---
        fig, ax = plt.subplots(figsize=(6, 4))
        for k in range(T):
            ys = m[k:, k]
            ax.plot(range(k, T), ys, marker="o", label=f"task {k}")
        ax.set_xlabel("after training task")
        ax.set_ylabel("mIoU")
        ax.set_xticks(range(T))
        ax.set_title("per-task mIoU trajectory (forgetting)")
        ax.legend()
        ax.grid(True, alpha=0.3)
        written.append(_save(fig, out_dir, "forgetting_curves.png"))
        plt.close(fig)

    return written
