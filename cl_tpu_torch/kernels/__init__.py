"""Wrappers of the hand-written CUDA kernels, each beside its plain PyTorch version."""

PACKED_BACKWARD_LATER = (
    "the packed UNet body's backward kernels come in a later slice of the "
    "port (ROADMAP.md Queue 1); train with model.packed_unet=false")


def backward_later(what: str):
    """The backward of a forward-only kernel: raise instead of letting
    autograd run something other than the JAX package's backward."""
    raise NotImplementedError(f"backward of {what}: {PACKED_BACKWARD_LATER}")
