"""Wrappers of the hand-written CUDA kernels, each beside its plain PyTorch version."""

# Blocks a sum over pixels is split over (the dW kernels): two per SM of an
# H100 SXM. Fixed, not read from the card, so the partial sums run in the
# same order on every card.
SPLIT_BLOCKS = 2 * 132
