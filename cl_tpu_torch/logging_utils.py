"""L5 — structured JSONL event logging (SURVEY.md §5.5).

One JSON line per event (epoch, eval, task_done, resumed, done); stdout
mirror. Replaces the reference's print-based logging.
"""

from __future__ import annotations

import json
import sys
import time


class EventLogger:
    """JSONL event log + optional TensorBoard scalar mirror (SURVEY.md
    §5.5). TB is best-effort: missing writer packages degrade silently to
    JSONL-only."""

    _SCALAR_KEYS = ("loss", "miou", "seconds", "steps")

    def __init__(self, path: str = "", tensorboard_dir: str = ""):
        self.path = path
        if path:
            import os

            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
        self._fh = open(path, "a") if path else None
        self._tb = None
        self._tb_step = 0
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            except Exception:
                pass

    def log(self, **event) -> None:
        event.setdefault("t", round(time.time(), 3))
        line = json.dumps(event, default=float)
        print(line, file=sys.stdout, flush=True)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._tb is not None:
            tag = event.get("event", "event")
            for k in self._SCALAR_KEYS:
                if isinstance(event.get(k), (int, float)):
                    self._tb.add_scalar(f"{tag}/{k}", event[k],
                                        self._tb_step)
            self._tb_step += 1

    def close(self) -> None:
        if self._fh:
            self._fh.close()
        if self._tb is not None:
            self._tb.flush()
