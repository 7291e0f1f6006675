"""L0 — command-line entry point of the port (train only so far).

Usage:
    python -m cl_tpu_torch.cli preset=baseline_1 [section.key=value ...]

Trains on the CUDA device and prints the report as one JSON line (the
JSONL events go to stdout as they happen). Same presets and overrides as
``python -m cl_tpu.cli``. The ``eval``, ``predict`` and ``plot`` modes
come in a later slice of the port.
"""

from __future__ import annotations

import json
import sys

from cl_tpu_torch.config import PRESETS, parse_overrides


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in ("-h", "--help"):
        print(__doc__)
        print("presets:", ", ".join(sorted(PRESETS)))
        return 0
    if argv and argv[0] in ("eval", "predict", "plot"):
        raise NotImplementedError(
            f"'{argv[0]}' needs checkpoints, which come in a later slice of "
            "the port (ROADMAP.md Queue 1); this CLI trains only")
    if argv and argv[0] == "train":
        argv = argv[1:]
    cfg = parse_overrides(argv)
    from cl_tpu_torch.train import train

    report = train(cfg)
    print(json.dumps({k: v for k, v in report.items()
                      if k != "miou_matrix"}, default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
