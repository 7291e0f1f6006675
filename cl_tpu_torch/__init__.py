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
  L2 models/unet.py     — UNet (standard body), NHWC at the interface,
                          channels_last inside, bf16-capable
  L4 train.py           — task loop, train/eval steps
  L5 metrics.py         — on-device confusion matrix, mIoU, forgetting
Hand-written CUDA kernels live in csrc/, their wrappers and plain
versions in kernels/.
"""

__version__ = "0.1.0"
