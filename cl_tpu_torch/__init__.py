"""cl_tpu_torch — the PyTorch / CUDA port of cl_tpu for one NVIDIA H100.

A second package beside ``cl_tpu`` (the JAX reference, which it never
imports). Each module mirrors the ``cl_tpu`` module of the same name, so a
reader can find each counterpart. Entry points run on the card
(``device=None`` resolves to ``cuda`` and raises without it); the tests
pass ``device="cpu"``, where every kernel wrapper takes its plain PyTorch
version.

Layer map:
  L0 config.py          — frozen dataclass configs + presets (own copy)
  L1 data/              — synthetic task datasets, host pipeline, prefetch
  L2 models/unet.py     — UNet (standard and packed bodies), NHWC at the
                          interface, channels_last inside, bf16-capable;
                          models/packed_gate.py chooses the packed levels
  L3 methods/           — LwF (the frozen teacher and its snapshot), EWC
                          (flat anchor and Fisher, the Fisher pass's
                          gradient), the host replay buffer; the
                          device-resident buffer is kernels/replay_gather.py
  L4 train.py           — task loop, train/eval steps, ``evaluate``;
                          predict.py, the batch inference API
  L5 metrics.py         — on-device confusion matrix, mIoU, forgetting;
                          checkpoint.py, per-task checkpoints and resume;
                          plots.py, curves from the JSONL log
  L0 cli.py             — the train / eval / predict / plot modes
Hand-written CUDA kernels live in csrc/, their wrappers and plain
versions in kernels/.
"""

__version__ = "0.1.0"
